"""EAR blocks of 14-16 atoms on the port's fast path, against the JAX
package on the CPU.

The EAR two-pass scan packs the signal, the CSF column and the E EAR
columns into kernel 1's Grams, which hold ``ops/prep.MAX_RHS`` = 15 rhs
columns: it takes at most 13 EAR atoms (``f32scan.ROW4_HOIST_MAX_E``).
Wider EAR blocks (the fast path takes up to 16) scan the full grid
(``fit._onepass_step4``: kernels 8 and 5 on a card, their plain versions
here), as the JAX package scans them with its one-pass
``df4_candidates`` (on the CPU by its ``twopass_ear_mode`` "auto", on a
TPU when the rhs pack's assertion fails). Both packages' row budgets are
lowered to 16 so that a 72-atom dictionary meets the two-pass condition
(N > 2 R); 17 EAR atoms take the general path."""

import dataclasses

import numpy as np
import pytest
import torch

from microstructure_fingerprinting_tpu import MFModel as JMFModel
from microstructure_fingerprinting_tpu import config as jconfig
from microstructure_fingerprinting_tpu import testing as jtesting
from microstructure_fingerprinting_tpu.utils.scheme import b_values

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import config as tconfig
from microstructure_fingerprinting_torch.models import fit as tfit
from microstructure_fingerprinting_torch.ops import interp as tinterp

torch.set_num_threads(2)
N_ATOM, N_VOX, R = 72, 8, 16


@pytest.fixture
def rows(monkeypatch):
    """Row budgets R on both packages (the JAX EAR mode left "auto")."""
    monkeypatch.setitem(jconfig.DEFAULTS, "solver", dataclasses.replace(
        jconfig.DEFAULTS["solver"], twopass_rows=R, twopass_rows_ear=R))
    monkeypatch.setitem(tconfig.DEFAULTS, "solver", dataclasses.replace(
        tconfig.DEFAULTS["solver"], twopass_rows=R, twopass_rows_ear=R))


@pytest.fixture(scope="module")
def wl():
    """tests/test_torch_ear_fit.py's 72-atom workload (40 sequences), 8
    voxels."""
    return jtesting.make_fit_workload(num_atom=N_ATOM, n_vox=N_VOX,
                                      n_shells=3, dirs_per_shell=12, n_b0=4)


def _dear(E):
    return np.linspace(0.8e-9, 2.6e-9, E)


def _sig_ear(sch, E):
    TE, b = sch[:, 6], b_values(sch)
    return np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * _dear(E)[None])


def _inputs(wl, E):
    """A 2 x 2 x 2 volume of (2, CSF, EAR) voxels: the workload's signals
    with EAR atom 0 (the farthest from the CSF column) planted at several
    weights, and a dictionary of E EAR atoms."""
    sch = wl["sch_mat"]
    sig, dpar, dperp = jtesting.make_dictionary(sch, N_ATOM)
    dic = {"dictionary": sig, "sch_mat": sch,
           "orientation": np.array([0.0, 0.0, 1.0]), "num_atom": N_ATOM,
           "fasc_propnames": ["dpar", "dperp"], "dpar": dpar,
           "dperp": dperp, "T2_csf": 2.0, "DIFF_csf": 3.0e-9,
           "T2_ear": 0.8, "DIFF_ear": _dear(E)}
    amp = np.array([60.0, 30.0, 120.0, 60.0, 90.0, 45.0, 75.0, 35.0])
    data = wl["y"] + amp[:, None] * _sig_ear(sch, E)[:, 0][None, :]
    shape, S = (2, 2, 2), sch.shape[0]
    ones = np.ones(shape)
    return (dic, data.reshape(shape + (S,)), ones, 2 * ones,
            wl["peaks"].reshape(shape + (6,)), ones, ones)


def _counted(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("E", [14, 15, 16])
def test_wide_ear_fit_matches_jax(wl, rows, monkeypatch, E):
    """MFModel.fit (device="cpu") vs the JAX MFModel.fit (engine="fast")
    with 14, 15 and 16 EAR atoms (the JAX one-pass scan unrolls its E
    sweeps: each E compiles for about a minute): the port scans the full grid (never the
    two-pass), the maps are named alike, MSE within 1e-9 max||y||^2 / S,
    R^2 within 1e-6, the fascicle IDs and their property maps equal, and
    every EAR index equal or an equal-objective tie (both objectives at
    most 2e-9 ||y||^2: the signals are noiseless), where D_ear is equal
    the fractions agree to rtol 1e-5; the planted fascicles are
    recovered."""
    dic, data, mask, numfasc, peaks, csf_mask, ear_mask = _inputs(wl, E)
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=csf_mask,
              ear_mask=ear_mask, verbose=0, batch_size=N_VOX)
    fj = JMFModel(dic).fit(data, mask, numfasc, engine="fast", **kw)
    calls = []
    _counted(monkeypatch, tfit, "_twopass_step4", calls)
    _counted(monkeypatch, tfit, "_onepass_step4", calls)
    ft = mft.MFModel(dic).fit(data, mask, numfasc, device="cpu", **kw)
    assert calls and set(calls) == {"_onepass_step4"}
    assert ft.param_names == fj.param_names
    S = dic["sch_mat"].shape[0]
    ysq = np.sum(data ** 2, axis=-1)
    np.testing.assert_allclose(ft.MSE, fj.MSE, rtol=0,
                               atol=1e-9 * ysq.max() / S)
    np.testing.assert_allclose(ft.R2, fj.R2, rtol=0, atol=1e-6)
    same = ft.D_ear == fj.D_ear
    tie = 2e-9 * ysq[~same]
    assert np.all(ft.MSE[~same] * S <= tie)
    assert np.all(fj.MSE[~same] * S <= tie)
    for p in ft.param_names:
        a, b = getattr(ft, p), getattr(fj, p)
        if p.startswith("peak") or (p.endswith(("_f0", "_f1"))
                                    and not p.startswith("frac")):
            assert np.array_equal(a, b), p              # IDs -> properties
        elif p not in ("MSE", "R2"):
            np.testing.assert_allclose(a[same], b[same], rtol=1e-5, atol=0,
                                       err_msg=p)
    got = np.stack([ft.dpar_f0.reshape(-1), ft.dpar_f1.reshape(-1)], axis=1)
    assert np.array_equal(got, dic["dpar"][wl["gt_ids"]])


@pytest.mark.parametrize("E,route", [(13, "_twopass_step4"),
                                     (14, "_onepass_step4"),
                                     (16, "_onepass_step4")])
def test_ear_route_by_width(wl, rows, monkeypatch, E, route):
    """``run_bucket_fast`` of the (2, CSF, EAR) bucket: 13 EAR atoms take
    the two-pass (its rhs pack holds 1 + 1 + 13 columns), 14 and 16 the
    full-grid re-scan, and each recovers the planted fascicles."""
    sch = wl["sch_mat"]
    sig_ear = _sig_ear(sch, E)
    y = wl["y"] + 60.0 * sig_ear[:, 0][None, :]
    mt = tinterp.MultiShellInterp.from_numpy(wl["msinterp"])
    _x, ys_t, _c = mt.device_tables("cpu", torch.float32)
    calls = []
    _counted(monkeypatch, tfit, "_twopass_step4", calls)
    _counted(monkeypatch, tfit, "_onepass_step4", calls)
    got = tfit.run_bucket_fast(mt, wl["plan"], ys_t,
                               wl["peaks"].reshape(N_VOX, 6), y,
                               wl["sig_csf"], 2, True, batch=N_VOX,
                               sig_ear=sig_ear, ear_on=True)
    assert calls and set(calls) == {route}
    assert np.array_equal(got[1][:, :2], wl["gt_ids"])


class _Routed(Exception):
    pass


def test_seventeen_ear_atoms_take_the_general_path(wl, monkeypatch):
    """17 EAR atoms are more than the fast path takes: MFModel.fit hands
    the bucket to ``run_bucket`` (the general path) with the EAR block
    on, and never to ``run_bucket_fast``."""
    dic, data, mask, numfasc, peaks, csf_mask, ear_mask = _inputs(wl, 17)
    seen = []

    def general(*a, **k):
        seen.append(a[8] if len(a) > 8 else k.get("ear_on"))
        raise _Routed

    def fast(*a, **k):
        raise AssertionError("17 EAR atoms reached run_bucket_fast")

    monkeypatch.setattr(tfit, "run_bucket", general)
    monkeypatch.setattr(tfit, "run_bucket_fast", fast)
    with pytest.raises(_Routed):
        mft.MFModel(dic).fit(data, mask, numfasc, device="cpu", peaks=peaks,
                             pgse_scheme=dic["sch_mat"], csf_mask=csf_mask,
                             ear_mask=ear_mask, verbose=0,
                             batch_size=N_VOX)
    assert seen == [True]
