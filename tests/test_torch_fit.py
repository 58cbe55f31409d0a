"""The port's fit slice vs the JAX package on the CPU: the 2-fascicle +
CSF bucket (two-pass scan, overflow tiers, double-float finalize) and
``MFModel.fit`` end to end, including ``write_nifti``.

Both packages get the same float32 knot tables, signals and directions;
the JAX side runs its device-finalize path and its float64 host refine.
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
from microstructure_fingerprinting_torch.models import fit as tfit
from microstructure_fingerprinting_torch.ops import f32scan as tf32scan
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.utils import nifti as tnifti

torch.set_num_threads(2)


@pytest.fixture
def rows(monkeypatch):
    """Set the two-pass row budget R on both packages."""
    def set_rows(R):
        for cfg in (jconfig, tconfig):
            monkeypatch.setitem(cfg.DEFAULTS, "solver", dataclasses.replace(
                cfg.DEFAULTS["solver"], twopass_rows=R))
    return set_rows


def _both(ms, plan, peaks, y, csf, batch):
    """(JAX device finalize, JAX float64 host refine, port) results."""
    ys32 = jnp.asarray(ms.ys, jnp.float32)
    dev = jfit.run_bucket_fast(ms, plan, ys32, peaks, y, csf, 2, True,
                               batch=batch, device_finalize=True)
    host = jfit.run_bucket_fast(ms, plan, ys32, peaks, y, csf, 2, True,
                                batch=batch, device_finalize=False)
    mt = tinterp.MultiShellInterp.from_numpy(ms)
    _x, ys_t, _c = mt.device_tables("cpu", torch.float32)
    got = tfit.run_bucket_fast(mt, plan, ys_t, peaks, y, csf, 2, True,
                               batch=batch)
    return dev, host, got


def _check(ref, got, ysq):
    """Atom IDs equal, objectives within 2e-9 max||y||^2, R^2 within
    1e-6 (the tolerances of tests/test_fit.py's two-pass tests)."""
    assert np.array_equal(ref[1], got[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=2e-9 * ysq.max())
    np.testing.assert_allclose(got[4], ref[4], rtol=0, atol=1e-6)


@pytest.mark.parametrize("R", [16, 128])
def test_bucket_matches_jax(rows, R):
    """run_bucket_fast on tests/test_fit.py's two-pass workload (72
    atoms) vs the JAX device finalize and the JAX float64 host refine:
    R = 16 runs the two-pass scan, R = 128 (N <= 2R) the full-grid
    re-scan."""
    rows(R)
    wl = jtesting.make_fit_workload(num_atom=72, n_vox=8, n_shells=3,
                                    dirs_per_shell=12, n_b0=4)
    y = wl["y"]
    dev, host, got = _both(wl["msinterp"], wl["plan"],
                           wl["peaks"].reshape(8, 6), y, wl["sig_csf"], 8)
    ysq = np.sum(y ** 2, axis=1)
    for ref in (dev, host):
        _check(ref, got, ysq)
    assert np.array_equal(got[1][:, :2], wl["gt_ids"])
    np.testing.assert_allclose(got[0], host[0], rtol=1e-5,
                               atol=1e-6 * np.abs(host[0]).max())


def test_bucket_overflow_tiers_match_jax(rows, rng, monkeypatch):
    """Duplicated atoms with R = 8 (tests/test_fit.py's overflow case):
    voxels overflow R, then 2R, and end on the R = N tier; results match
    the JAX package."""
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
    y = np.broadcast_to(300 * (0.6 * sig[:, 2][None] + 0.4 * csf[None]),
                        (n, sch.shape[0])).copy()
    budgets = []
    orig = tf32scan.df3_twopass

    def spy(*a, **k):
        budgets.append(k["R"])
        return orig(*a, **k)

    monkeypatch.setattr(tf32scan, "df3_twopass", spy)
    dev, host, got = _both(ms, plan, peaks.reshape(n, 6), y, csf, 2)
    assert {8, 16, 72} <= set(budgets)
    ysq = np.sum(y ** 2, axis=1)
    for ref in (dev, host):
        _check(ref, got, ysq)


def _model_inputs():
    """A 12-voxel volume: 8 planted 2-fascicle + CSF voxels and 4
    CSF-only voxels, with a 72-atom dictionary."""
    wl = jtesting.make_fit_workload(num_atom=72, n_vox=8, n_shells=3,
                                    dirs_per_shell=12, n_b0=4)
    sch = wl["sch_mat"]
    sig, dpar, dperp = jtesting.make_dictionary(sch, 72)
    dic = {"dictionary": sig, "sch_mat": sch,
           "orientation": np.array([0.0, 0.0, 1.0]), "num_atom": 72,
           "fasc_propnames": ["dpar", "dperp"], "dpar": dpar,
           "dperp": dperp, "T2_csf": 2.0, "DIFF_csf": 3.0e-9}
    S = sch.shape[0]
    shape = (3, 2, 2)
    data = np.zeros((12, S))
    data[:8] = wl["y"]
    data[8:] = np.array([50.0, 120.0, 300.0, 80.0])[:, None] * wl["sig_csf"]
    peaks = np.zeros((12, 6))
    peaks[:8] = wl["peaks"].reshape(8, 6)
    numfasc = np.array([2] * 8 + [0] * 4, float)
    return (dic, data.reshape(shape + (S,)), np.ones(shape),
            numfasc.reshape(shape), peaks.reshape(shape + (6,)), wl)


def test_model_fit_matches_jax(rows, tmp_path):
    """MFModel.fit (device="cpu", R = 16) vs the JAX MFModel.fit
    (engine="fast") on the same volume: IDs and property maps equal,
    fractions and M0 to rtol 1e-5, MSE within 1e-9 max||y||^2 / S, R^2
    within 1e-6; write_nifti maps reload identically."""
    rows(16)
    dic, data, mask, numfasc, peaks, wl = _model_inputs()
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=1,
              verbose=0, batch_size=8)
    fj = JMFModel(dic).fit(data, mask, numfasc, engine="fast", **kw)
    ft = mft.MFModel(dic).fit(data, mask, numfasc, device="cpu", **kw)
    assert ft.param_names == fj.param_names
    S = dic["sch_mat"].shape[0]
    ysq_max = np.max(np.sum(data ** 2, axis=-1))
    for p in ft.param_names:
        a, b = getattr(ft, p), getattr(fj, p)
        if p.startswith("peak") or p.endswith(("_f0", "_f1")) and \
                not p.startswith("frac"):
            assert np.array_equal(a, b), p              # IDs -> properties
        elif p == "MSE":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * ysq_max / S)
        elif p == "R2":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=p)
    dpar = dic["dpar"]
    got = np.stack([ft.dpar_f0.reshape(-1)[:8], ft.dpar_f1.reshape(-1)[:8]],
                   axis=1)
    assert np.array_equal(got, dpar[wl["gt_ids"]])
    files = ft.write_nifti(str(tmp_path / "mf.nii.gz"), affine=np.eye(4))
    assert len(files) == len(ft.param_names)
    for fname, p in zip(files, ft.param_names):
        assert os.path.basename(fname) == "mf_%s.nii.gz" % p
        assert np.array_equal(tnifti.load(fname).get_fdata(),
                              getattr(ft, p))


def test_model_fit_unported_buckets_raise():
    """The buckets that raised before the general path was ported now
    fit (each bucket is held against the JAX package in
    tests/test_torch_general.py): one fascicle without CSF, with the maps
    of ``run_bucket`` on its voxels; an EAR block of more than 16 atoms,
    with and without CSF. A mesh of two slots, which raised before it
    was ported, fits as the serial fit does (tests/test_torch_mesh.py
    holds meshes against the JAX package), and CUDA asked for without a
    card raises."""
    dic, data, mask, numfasc, peaks, wl = _model_inputs()
    model = mft.MFModel(dic, device="cpu")
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], verbose=0,
              batch_size=8)
    fit = model.fit(data, mask, np.minimum(numfasc, 1), **kw)
    mt = tinterp.MultiShellInterp.from_numpy(wl["msinterp"])
    plan = wl["plan"]
    S = dic["sch_mat"].shape[0]
    w, ind, _obj, mse, r2 = tfit.run_bucket(
        mt.device_tables("cpu", torch.float32),
        tfit.plan_tensors(plan, torch.float32, "cpu"), wl["peaks"][:, 0], data.reshape(-1, S)[:8], None,
        None, 1, False, False, batch=8, refine=True, ms_host=mt,
        plan_host=plan, topm=16)
    assert np.array_equal(fit.MSE.reshape(-1)[:8], mse)
    assert np.array_equal(fit.R2.reshape(-1)[:8], r2)
    assert np.array_equal(fit.dpar_f0.reshape(-1)[:8],
                          dic["dpar"][ind[:, 0]] * (w[:, 0] > 0))
    assert np.all(r2 > 0.9)
    ear = mft.MFModel(dict(dic, T2_ear=0.8,
                           DIFF_ear=np.linspace(0.8e-9, 2.6e-9, 17)),
                      device="cpu")
    for csf in (1, 0):
        fit = ear.fit(data, mask, numfasc, csf_mask=csf, ear_mask=1, **kw)
        assert {"frac_ear", "D_ear"} <= set(fit.param_names)
        assert np.all(np.isfinite(fit.MSE)) and np.all(fit.MSE >= 0)
    ser = model.fit(data, mask, numfasc, csf_mask=1, **kw)
    par = model.fit(data, mask, numfasc, csf_mask=1, parallel=True,
                    mesh_shape=(2, 1), **kw)
    for p in ser.param_names:
        assert np.array_equal(getattr(par, p), getattr(ser, p)), p
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            model.fit(data, mask, numfasc, csf_mask=1, device="cuda", **kw)


def test_model_fit_one_fascicle_bucket_fits(rows):
    """The one-fascicle + CSF bucket, which raised before it was ported,
    fits: numfasc 1 on the 2-fascicle + CSF volume gives the maps of one
    fascicle, equal to run_bucket_fast's on the same voxels (the bucket
    itself is held against the JAX package in test_torch_buckets.py)."""
    rows(16)
    dic, data, mask, numfasc, peaks, wl = _model_inputs()
    one = np.minimum(numfasc, 1)
    fit = mft.MFModel(dic, device="cpu").fit(
        data, mask, one, peaks=peaks[..., :3], pgse_scheme=dic["sch_mat"],
        csf_mask=1, verbose=0, batch_size=8)
    assert "frac_f0" in fit.param_names and "frac_f1" not in fit.param_names
    mt = tinterp.MultiShellInterp.from_numpy(wl["msinterp"])
    _x, ys_t, _c = mt.device_tables("cpu", torch.float32)
    S = dic["sch_mat"].shape[0]
    w, ind, _obj, mse, r2 = tfit.run_bucket_fast(
        mt, wl["plan"], ys_t, wl["peaks"][:, 0], data.reshape(-1, S)[:8],
        wl["sig_csf"], 1, True, batch=8)
    assert np.array_equal(fit.MSE.reshape(-1)[:8], mse)
    assert np.array_equal(fit.R2.reshape(-1)[:8], r2)
    assert np.array_equal(fit.dpar_f0.reshape(-1)[:8],
                          dic["dpar"][ind[:, 0]] * (w[:, 0] > 0))


def test_parallel_on_one_device_fits_as_batched(rows):
    """``fit(parallel=True)`` with a single visible device takes the
    batched path, as the JAX package does: the same maps as
    ``parallel=False``, also with a mesh of one device."""
    rows(16)
    dic, data, mask, numfasc, peaks, _wl = _model_inputs()
    model = mft.MFModel(dic, device="cpu")
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=1,
              verbose=0, batch_size=8)
    ref = model.fit(data, mask, numfasc, **kw)
    for extra in (dict(parallel=True),
                  dict(parallel=True, mesh_shape=(1, 1))):
        got = model.fit(data, mask, numfasc, **kw, **extra)
        assert got.param_names == ref.param_names
        for p in ref.param_names:
            assert np.array_equal(getattr(got, p), getattr(ref, p)), p


def test_parallel_on_several_devices_raises(monkeypatch):
    """With more than one CUDA device in sight, ``parallel=True`` asks for
    the sharded fit before any work: a (4, 1) mesh of one data slot a
    card (the mesh stub raises there, as this machine has no card); a
    ``mesh_shape`` that does not fill the cards raises ValueError."""
    from microstructure_fingerprinting_torch.parallel import mesh as tmesh
    dic, data, mask, numfasc, peaks, _wl = _model_inputs()
    model = mft.MFModel(dic, device="cpu")
    monkeypatch.setattr(tconfig, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    asked = []

    class Built(Exception):
        pass

    def stub(*a, **k):
        asked.append((a, k))
        raise Built

    monkeypatch.setattr(tmesh, "build_mesh", stub)
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=1,
              verbose=0, parallel=True, device="cuda")
    with pytest.raises(Built):
        model.fit(data, mask, numfasc, **kw)
    assert asked == [((4, 1), dict(devices=[torch.device("cuda", i)
                                            for i in range(4)]))]
    with pytest.raises(ValueError, match="does not fill 4 devices"):
        model.fit(data, mask, numfasc, mesh_shape=(3, 1), **kw)


@pytest.mark.parametrize("extra,item", [(dict(mesh_shape=(1, 2)), "item 6")])
def test_unported_fit_arguments_raise(extra, item):
    """``mesh_shape=`` (ROADMAP ``item``, ported) is accepted: without
    ``parallel=True`` it is ignored, as in the JAX package, and with it
    the (1, 2) mesh splits the scan's atoms over two slots; both fit as
    the serial fit does, bit for bit (``engine="xla"``, ``topm=`` and
    ``refine=True`` fit: see test_default_fit_arguments_are_accepted)."""
    dic, data, mask, numfasc, peaks, _wl = _model_inputs()
    model = mft.MFModel(dic, device="cpu")
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=1, verbose=0,
              batch_size=8)
    ser = model.fit(data, mask, numfasc, **kw)
    for par in (False, True):
        got = model.fit(data, mask, numfasc, parallel=par, **kw, **extra)
        for p in ser.param_names:
            assert np.array_equal(getattr(got, p), getattr(ser, p)), p


def test_default_fit_arguments_are_accepted(rows):
    """The JAX package's defaults (``refine=None``, ``topm=16``,
    ``engine="auto"``, ``mesh_shape=None``) and the fast path's names
    (``"fast"``, ``"pallas"``, ``refine=False``) fit as no argument does;
    ``engine="xla"`` with another ``topm`` and ``refine=True`` fits every
    voxel by the general path, recovering the planted atoms; an unknown
    engine is a ValueError."""
    rows(16)
    dic, data, mask, numfasc, peaks, _wl = _model_inputs()
    model = mft.MFModel(dic, device="cpu")
    kw = dict(peaks=peaks, pgse_scheme=dic["sch_mat"], csf_mask=1,
              verbose=0, batch_size=8)
    ref = model.fit(data, mask, numfasc, **kw)
    for extra in (dict(refine=None, topm=16, engine="auto",
                       mesh_shape=None),
                  dict(engine="pallas", refine=False), dict(engine="fast")):
        got = model.fit(data, mask, numfasc, **kw, **extra)
        assert np.array_equal(got.MSE, ref.MSE)
    got = model.fit(data, mask, numfasc, engine="xla", topm=4, refine=True,
                    **kw)
    assert np.array_equal(got.dpar_f0, ref.dpar_f0)
    assert np.array_equal(got.dpar_f1, ref.dpar_f1)
    with pytest.raises(ValueError, match="engine"):
        model.fit(data, mask, numfasc, engine="triton", **kw)
