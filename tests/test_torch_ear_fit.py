"""The port's EAR slice vs the JAX package on the CPU: the 2-fascicle +
CSF + EAR bucket (two-pass scan at ``twopass_rows_ear``, overflow tiers,
4-column double-float finalize), the fascicle-free CSF + EAR and EAR-only
buckets, and ``MFModel.fit`` with EAR maps end to end.

Both packages get the same float32 knot tables, signals and directions.
The JAX side runs its device-finalize path (its EAR two-pass forced on
with ``twopass_ear_mode = "always"``, the port's only EAR path) and its
float64 host refine. The JAX programs of the 72-atom workload are the
suite's most expensive compiles; the workload and the JAX results are
shared through module fixtures, and the model-level fit reuses their
shapes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu import MFModel as JMFModel
from microstructure_fingerprinting_tpu import config as jconfig
from microstructure_fingerprinting_tpu import testing as jtesting
from microstructure_fingerprinting_tpu.models import fit as jfit
from microstructure_fingerprinting_tpu.ops import interp as jinterp
from microstructure_fingerprinting_tpu.utils.scheme import b_values

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import config as tconfig
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models import fit as tfit
from microstructure_fingerprinting_torch.ops import f32scan as tf32scan
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.utils import nifti as tnifti

torch.set_num_threads(2)
DEAR = np.linspace(0.8e-9, 2.6e-9, 4)


def _set_rows(R):
    """Two-pass row budgets R (both, and the EAR one) on both packages,
    the JAX EAR two-pass forced on; returns the saved configurations."""
    saved = (jconfig.DEFAULTS["solver"], tconfig.DEFAULTS["solver"])
    jconfig.DEFAULTS["solver"] = dataclasses.replace(
        saved[0], twopass_rows=R, twopass_rows_ear=R,
        twopass_ear_mode="always")
    tconfig.DEFAULTS["solver"] = dataclasses.replace(
        saved[1], twopass_rows=R, twopass_rows_ear=R)
    return saved


@pytest.fixture
def rows():
    saved = []

    def set_rows(R):
        saved.append(_set_rows(R))
    yield set_rows
    if saved:
        jconfig.DEFAULTS["solver"], tconfig.DEFAULTS["solver"] = saved[0]


def _sig_ear(sch):
    TE, b = sch[:, 6], b_values(sch)
    return np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * DEAR[None])


def _run(ms, plan, peaks, y, csf, sig_ear, batch):
    """(JAX device finalize, JAX float64 host refine, port)."""
    ys32 = jnp.asarray(ms.ys, jnp.float32)
    kw = dict(batch=batch, sig_ear=sig_ear, ear_on=True)
    dev = jfit.run_bucket_fast(ms, plan, ys32, peaks, y, csf, 2, True,
                               device_finalize=True, **kw)
    host = jfit.run_bucket_fast(ms, plan, ys32, peaks, y, csf, 2, True,
                                device_finalize=False, **kw)
    mt = tinterp.MultiShellInterp.from_numpy(ms)
    _x, ys_t, _c = mt.device_tables("cpu", torch.float32)
    got = tfit.run_bucket_fast(mt, plan, ys_t, peaks, y, csf, 2, True, **kw)
    return dev, host, got


def _check(ref, got, ysq, ids=True, tol=2e-9):
    """Objectives within ``tol`` max||y||^2 and R^2 within 1e-6 (the
    tolerances of tests/test_fit.py's two-pass tests); with ``ids`` the
    fascicle IDs equal (the EAR ID may differ only in an equal-objective
    tie, which the objective check holds)."""
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=tol * ysq.max())
    np.testing.assert_allclose(got[4], ref[4], rtol=0, atol=1e-6)
    if ids:
        assert np.array_equal(ref[1][:, :3], got[1][:, :3])


@pytest.fixture(scope="module")
def bucket():
    """tests/test_fit.py's two-pass workload (72 atoms, 8 voxels) with 4
    EAR atoms, at R = 16: the signals of that test (no EAR component),
    and the same signals with planted EAR atoms; the JAX results of both
    (the second reuses the first's compiled programs)."""
    saved = _set_rows(16)
    try:
        wl = jtesting.make_fit_workload(num_atom=72, n_vox=8, n_shells=3,
                                        dirs_per_shell=12, n_b0=4)
        sig_ear = _sig_ear(wl["sch_mat"])
        # EAR atom 0 (the farthest from the CSF column) at several weights
        eids = np.zeros(8, int)
        amp = np.array([60.0, 30.0, 120.0, 60.0, 90.0, 45.0, 75.0, 35.0])
        y_e = wl["y"] + amp[:, None] * sig_ear[:, eids].T
        out = {}
        for name, y in (("no EAR component", wl["y"]), ("planted EAR", y_e)):
            out[name] = (y,) + _run(wl["msinterp"], wl["plan"],
                                    wl["peaks"].reshape(8, 6), y,
                                    wl["sig_csf"], sig_ear, 8)
    finally:
        jconfig.DEFAULTS["solver"], tconfig.DEFAULTS["solver"] = saved
    return wl, eids, out


@pytest.mark.parametrize("signals", ["no EAR component", "planted EAR"])
def test_ear_bucket_matches_jax(bucket, signals):
    """run_bucket_fast(ear_on=True) at R = 16 (two-pass, overflow tiers as
    needed) vs the JAX device finalize and the JAX float64 host refine;
    the planted fascicle pairs are recovered, and with a planted EAR atom
    the EAR index too, on both sides. (On this 40-sequence scheme the CSF
    column and the EAR exponentials of the larger diffusivities are so
    nearly collinear that another EAR atom with a CSF weight reproduces
    such a signal below the scans' 1e-10 ||y||^2 resolution: the planted
    atom is the one farthest from the CSF column.)"""
    wl, eids, out = bucket
    y, dev, host, got = out[signals]
    ysq = np.sum(y ** 2, axis=1)
    for ref in (dev, host):
        _check(ref, got, ysq)
    assert np.array_equal(got[1][:, :2], wl["gt_ids"])
    assert got[0].shape == (8, 4) and got[1].shape == (8, 4)
    if signals == "planted EAR":
        assert np.array_equal(got[1][:, 3], eids)
        for ref in (dev, host):
            assert np.array_equal(ref[1], got[1])


def test_ear_full_grid_branch_matches_twopass(bucket, rows):
    """Dictionaries with N <= 2 * twopass_rows take kernel 5 on the full
    grid: at R = 128 the 72-atom bucket agrees with its two-pass
    (R = 16) results above, which are held against the JAX package."""
    rows(128)
    wl, _eids, out = bucket
    sig_ear = _sig_ear(wl["sch_mat"])
    mt = tinterp.MultiShellInterp.from_numpy(wl["msinterp"])
    _x, ys_t, _c = mt.device_tables("cpu", torch.float32)
    for y, _dev, _host, twopass in out.values():
        got = tfit.run_bucket_fast(mt, wl["plan"], ys_t,
                                   wl["peaks"].reshape(8, 6), y,
                                   wl["sig_csf"], 2, True, batch=8,
                                   sig_ear=sig_ear, ear_on=True)
        _check(twopass, got, np.sum(y ** 2, axis=1))


def test_ear_overflow_tiers_match_jax(rows, rng, monkeypatch):
    """Duplicated atoms with R = 8 and batch 2: EAR voxels overflow R,
    then 2R, and end on the R = N tier. Held against the JAX device
    finalize (the same guarded scans): every ID equal, objectives within
    2e-9 max||y||^2, R^2 within 1e-6. Against the JAX float64 host refine
    the same, except that the device scans' 100-eps pivot guards exclude
    supports whose CSF/EAR pivot falls below them: in the one voxel where
    the unguarded float64 enumeration selects another support the port's
    objective may sit above it (by 3.6e-9 ||y||^2 here), held at 1e-8."""
    rows(8)
    sch = jtesting.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    sig, _, _ = jtesting.make_dictionary(sch, num_atom=6)
    sig = np.tile(sig, (1, 12))                       # 72 cols, 12x each
    ms = jinterp.init_PGSE_multishell_interp(sig, sch,
                                             np.array([0.0, 0.0, 1.0]))
    plan = jinterp.plan_target_scheme(ms, sch)
    n = 6
    peaks = rng.randn(n, 2, 3)
    peaks /= np.linalg.norm(peaks, axis=2, keepdims=True)
    csf = np.exp(-sch[:, 6] / 2.0) * np.exp(-b_values(sch) * 3.0e-9)
    sig_ear = _sig_ear(sch)
    y = np.broadcast_to(300 * (0.6 * sig[:, 2] + 0.4 * csf)
                        + 30 * sig_ear[:, 1], (n, sch.shape[0])).copy()
    budgets = []
    orig = tf32scan.df4_twopass

    def spy(*a, **k):
        budgets.append(k["R"])
        return orig(*a, **k)

    monkeypatch.setattr(tf32scan, "df4_twopass", spy)
    dev, host, got = _run(ms, plan, peaks.reshape(n, 6), y, csf, sig_ear, 2)
    assert {8, 16, 72} <= set(budgets)
    ysq = np.sum(y ** 2, axis=1)
    _check(dev, got, ysq)
    assert np.array_equal(dev[1], got[1])
    # the float64 host refine enumerates without the pivot guards: where
    # it selects other fascicles (one voxel here) the port's objective may
    # sit above it by the guards' share; everywhere else 2e-9
    same = np.all(host[1][:, :3] == got[1][:, :3], axis=1)
    assert same.sum() >= n - 1
    _check(tuple(np.asarray(x)[same] for x in host),
           tuple(np.asarray(x)[same] for x in got), ysq[same])
    np.testing.assert_allclose(got[2], host[2], rtol=0, atol=1e-8 * ysq.max())
    np.testing.assert_allclose(got[4], host[4], rtol=0, atol=1e-6)


@pytest.mark.parametrize("csf_on", [True, False])
def test_trivial_ear_buckets_match_jax(rng, csf_on):
    """Fascicle-free CSF + EAR and EAR-only voxels: run_bucket_trivial
    equals the JAX function bit for bit (both are the same float64
    closed-form case analysis in NumPy)."""
    sch = jtesting.make_dense_scheme(n_shells=3, dirs_per_shell=12, n_b0=4)
    sig_ear = _sig_ear(sch)
    csf = np.exp(-sch[:, 6] / 2.0) * np.exp(-b_values(sch) * 3.0e-9)
    n = 12
    w = np.abs(rng.randn(n, 2)) * 100
    y = w[:, :1] * csf[None] * csf_on + w[:, 1:] * sig_ear[:, rng.randint(
        0, 4, n)].T + rng.randn(n, sch.shape[0])
    y[0] = -y[0]                                      # no feasible weight
    ref = jfit.run_bucket_trivial(y, csf, sig_ear, csf_on, True)
    got = tfit.run_bucket_trivial(y, csf, sig_ear, csf_on, True)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b)
    assert got[1].shape == (n, 1 + csf_on)


def _model_inputs():
    """An 18-voxel volume with a 72-atom dictionary and 4 EAR atoms: 8
    (2, csf, ear) voxels with EAR atom 0 planted at several weights (the
    atom farthest from the CSF column, so the fractions are well
    conditioned), 4 (2, csf), 3 (0, csf, ear) and 3 (0, ear) voxels."""
    wl = jtesting.make_fit_workload(num_atom=72, n_vox=12, n_shells=3,
                                    dirs_per_shell=12, n_b0=4)
    sch = wl["sch_mat"]
    sig, dpar, dperp = jtesting.make_dictionary(sch, 72)
    dic = {"dictionary": sig, "sch_mat": sch,
           "orientation": np.array([0.0, 0.0, 1.0]), "num_atom": 72,
           "fasc_propnames": ["dpar", "dperp"], "dpar": dpar,
           "dperp": dperp, "T2_csf": 2.0, "DIFF_csf": 3.0e-9,
           "T2_ear": 0.8, "DIFF_ear": DEAR}
    sig_ear = _sig_ear(sch)
    csf = wl["sig_csf"]
    S = sch.shape[0]
    eids = np.zeros(8, int)
    amp = np.array([60.0, 30.0, 120.0, 60.0, 90.0, 45.0, 75.0, 35.0])
    data = np.zeros((18, S))
    data[:8] = wl["y"][:8] + amp[:, None] * sig_ear[:, eids].T
    data[8:12] = wl["y"][8:]
    data[12:15] = (np.array([50.0, 120.0, 300.0])[:, None] * csf
                   + 40 * sig_ear[:, [1, 2, 3]].T)
    data[15:] = np.array([80.0, 30.0, 60.0])[:, None] * sig_ear[:, [0, 3, 2]].T
    peaks = np.zeros((18, 6))
    peaks[:12] = wl["peaks"].reshape(12, 6)
    numfasc = np.array([2] * 12 + [0] * 6, float)
    csf_mask = np.array([1] * 15 + [0] * 3, float)
    ear_mask = np.array([1] * 8 + [0] * 4 + [1] * 6, float)
    shape = (3, 3, 2)
    return (dic, data.reshape(shape + (S,)), np.ones(shape),
            numfasc.reshape(shape), peaks.reshape(shape + (6,)),
            csf_mask.reshape(shape), ear_mask.reshape(shape), wl, eids)


def test_ear_model_fit_matches_jax(rows, tmp_path):
    """MFModel.fit (device="cpu", R = 16) vs the JAX MFModel.fit
    (engine="fast", its float64 host refine) on a volume holding every
    ported EAR bucket: maps named alike, MSE within 1e-9 max||y||^2 / S,
    R^2 within 1e-6, fascicle IDs and their property maps equal. In the
    voxels whose EAR index is equal (all but equal-objective ties, see
    test_ear_bucket_matches_jax) D_ear is equal and the fractions
    (frac_ear included) and M0 agree to rtol 1e-5; the fascicle-free
    voxels are the same float64 solve on both sides. write_nifti maps,
    frac_ear and D_ear included, reload identically."""
    rows(16)
    (dic, data, mask, numfasc, peaks, csf_mask, ear_mask, wl,
     eids) = _model_inputs()
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=csf_mask,
              ear_mask=ear_mask, verbose=0, batch_size=8)
    fj = JMFModel(dic).fit(data, mask, numfasc, engine="fast", **kw)
    ft = mft.MFModel(dic).fit(data, mask, numfasc, device="cpu", **kw)
    assert ft.param_names == fj.param_names
    assert {"frac_ear", "D_ear"} <= set(ft.param_names)
    S = dic["sch_mat"].shape[0]
    ysq = np.sum(data ** 2, axis=-1)
    same = ft.D_ear == fj.D_ear
    assert same.reshape(-1)[8:].all() and same.mean() >= 0.75
    np.testing.assert_allclose(ft.MSE, fj.MSE, rtol=0,
                               atol=1e-9 * ysq.max() / S)
    for p in ft.param_names:
        a, b = getattr(ft, p), getattr(fj, p)
        if p.startswith("peak") or (p.endswith(("_f0", "_f1"))
                                    and not p.startswith("frac")):
            assert np.array_equal(a, b), p              # IDs -> properties
        elif p == "R2":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        elif p != "MSE":
            np.testing.assert_allclose(a[same], b[same], rtol=1e-5, atol=0,
                                       err_msg=p)
    # the planted EAR atom, or an objective at the planted one's (0)
    d_ear, mse = ft.D_ear.reshape(-1)[:8], ft.MSE.reshape(-1)[:8]
    other = d_ear != DEAR[eids]
    assert np.all(mse[other] * S <= 2e-9 * ysq.reshape(-1)[:8][other])
    assert not ft.D_ear.reshape(-1)[8:12].any()
    got = np.stack([ft.dpar_f0.reshape(-1)[:12],
                    ft.dpar_f1.reshape(-1)[:12]], axis=1)
    assert np.array_equal(got, dic["dpar"][wl["gt_ids"]])
    files = ft.write_nifti(str(tmp_path / "mf.nii.gz"), affine=np.eye(4))
    assert len(files) == len(ft.param_names)
    for fname, p in zip(files, ft.param_names):
        assert os.path.basename(fname) == "mf_%s.nii.gz" % p
        assert np.array_equal(tnifti.load(fname).get_fdata(),
                              getattr(ft, p))


def test_make_ear_matches_the_benchmark():
    """testing.make_ear builds the EAR block and signals as the JAX
    package's benchmark does (bench.py: 10 diffusivities, T2 0.8, 35 x
    atom 4 added)."""
    wl = ttesting.make_fit_workload(num_atom=16, n_vox=3, n_shells=2,
                                    dirs_per_shell=8, n_b0=2)
    sig_ear, y_ear = ttesting.make_ear(wl)
    sch = wl["sch_mat"]
    TE, b = sch[:, 6], b_values(sch)
    Dear = np.linspace(0.8e-9, 2.6e-9, 10)
    want = np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * Dear[None])
    assert np.array_equal(sig_ear, want)
    assert np.array_equal(y_ear, wl["y"] + 35 * want[:, 4][None, :])
