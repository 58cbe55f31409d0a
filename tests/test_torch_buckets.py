"""The port's remaining fast-path buckets vs the JAX package on the CPU:
one fascicle + CSF, one fascicle + CSF + EAR, two fascicles without CSF.

Held at each level: the top-M pools (``nnls._tile_topm`` /
``_merge_topm``, NaN and tie order), the [N1, N2] double-float scan
(``dfscan.df2_candidates``), kernel 3's plain version on the [N, E, 1]
grid against the JAX ``df3_candidates``, ``run_bucket_fast`` per bucket
against the JAX device finalize and the JAX float64 host refine, and
``MFModel.fit`` on a volume mixing every bucket with fascicles, its
maps and its verbose lines. Both packages get the same float32 knot
tables, signals and directions (72 atoms, 3 shells x 12 directions + 4
b0, the shapes the JAX suite already compiles).
"""

import contextlib
import dataclasses
import io
import itertools
import re

import numpy as np
import pytest
import scipy.optimize
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu import MFModel as JMFModel
from microstructure_fingerprinting_tpu import config as jconfig
from microstructure_fingerprinting_tpu.models import fit as jfit
from microstructure_fingerprinting_tpu.ops import dfscan as jdfscan
from microstructure_fingerprinting_tpu.ops import interp as jinterp
from microstructure_fingerprinting_tpu.ops import nnls as jnnls
from microstructure_fingerprinting_tpu.utils.scheme import b_values

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import config as tconfig
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models import fit as tfit
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.ops import nnls as tnnls
from microstructure_fingerprinting_torch.ops import rescan as trescan

torch.set_num_threads(2)
DEAR = np.linspace(0.8e-9, 2.6e-9, 4)
#: the buckets of this slice: (K, csf, ear)
BUCKETS = [(1, True, False), (1, True, True), (2, False, False)]


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _sig_ear(sch):
    TE, b = sch[:, 6], b_values(sch)
    return np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * DEAR[None])


@pytest.fixture(scope="module")
def wl():
    """The 72-atom workload of tests/test_fit.py's two-pass tests, 16
    voxels, with its JAX and port interpolators (identical tables) and
    rotated float32 blocks of every voxel."""
    w = ttesting.make_fit_workload(num_atom=72, n_vox=16, n_shells=3,
                                   dirs_per_shell=12, n_b0=4)
    ms = jinterp.init_PGSE_multishell_interp(
        w["dictionary"], w["sch_mat"], np.array([0.0, 0.0, 1.0]))
    w["jms"], w["jplan"] = ms, jinterp.plan_target_scheme(ms, w["sch_mat"])
    w["tms"] = tinterp.MultiShellInterp.from_numpy(ms)
    rotate, perm = tinterp.make_grouped_rotation_paired(w["tms"],
                                                        w["jplan"])
    _x, ys, _c = w["tms"].device_tables("cpu", torch.float32)
    w["D"] = rotate(ys, _t(w["peaks"]).float()).numpy()      # perm'd order
    w["perm"] = perm
    w["sig_ear"] = _sig_ear(w["sch_mat"])
    return w


# ---------------------------------------------------------------------------
# top-M pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 3, 8])
def test_topm_pools_match_jax(rng, M):
    """_tile_topm and _merge_topm pick and order what the JAX functions
    do, bit for bit: lax.top_k's total order in a tile (a NaN with its
    sign bit set first, one without last, -0 before +0), the merge's
    lexsort with every NaN last, ties to the lowest rank."""
    x = np.float32(rng.rand(3, 8))
    x[0] = [0.5, np.nan, -np.nan, 0.5, -0.0, 0.0, np.inf, 0.1]
    x[1, [2, 5]] = x[1, 0]
    g = np.arange(8)[None] * 3 + 1
    tj = jnnls._tile_topm(jnp.asarray(x), jnp.asarray(g), M)
    tt = tnnls._tile_topm(_t(x), _t(g), M)
    v0 = np.float32(np.tile([np.nan, 0.2, 0.5, np.inf, 0.1, 0.0, 1.0, 0.3],
                            (3, 1))[:, :M])
    f0 = np.int32(np.tile([5, 1, 9, 0, 4, 7, 8, 2], (3, 1))[:, :M])
    mj = jnnls._merge_topm(jnp.asarray(v0), jnp.asarray(f0), *tj, M)
    mt = tnnls._merge_topm(_t(v0), _t(f0), *tt, M)
    for a, b in zip(tj + mj, tt + mt):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        assert np.array_equal(a.view(np.int32), b.numpy().view(np.int32))


# ---------------------------------------------------------------------------
# the [N1, N2] double-float scan
# ---------------------------------------------------------------------------

def _df2_inputs(wl, grid, duplicated):
    """(A1, A2, y) float32: the workload's first rotated block against the
    CSF column (grid "csf", N2 = 1) or the second block ("grid"), the
    atoms tiled from 6 columns where ``duplicated`` (every column 12
    times, exact ties everywhere)."""
    D = wl["D"][:8]
    A1, A2 = D[:, 0], D[:, 1]
    if duplicated:
        A1, A2 = np.tile(A1[:, :, :6], (1, 1, 12)), np.tile(A2[:, :, 6:12],
                                                            (1, 1, 12))
    if grid == "csf":
        A2 = np.broadcast_to(wl["sig_csf"][wl["perm"]][None, :, None],
                             (8, A1.shape[1], 1))
    y = wl["y"][:8][:, wl["perm"]]
    return (np.ascontiguousarray(A1, np.float32),
            np.ascontiguousarray(A2, np.float32), np.float32(y))


@pytest.mark.parametrize("grid,M,duplicated", list(itertools.product(
    ["csf", "grid"], [1, 4], [False, True])))
def test_df2_candidates_matches_jax(wl, grid, M, duplicated):
    """df2_candidates vs the JAX function: equal candidates (first-minimum
    order of the flat rank, also through the exact ties of a dictionary
    whose atoms repeat 12 times), residuals of the normalized problem
    within 1e-6, ||y||^2 to rtol 1e-6."""
    A1, A2, y = _df2_inputs(wl, grid, duplicated)
    cj, vj, qj = jdfscan.df2_candidates(jnp.asarray(A1), jnp.asarray(A2),
                                        jnp.asarray(y), M=M)
    ct, vt, qt = tdfscan.df2_candidates(_t(A1), _t(A2), _t(y), M=M)
    assert ct.shape == (8, M, 2) and ct.dtype == torch.int32
    assert np.array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-6)


def test_df2_candidates_singular_pair(wl):
    """A column shared by both blocks (two fascicles along one direction):
    det12 = 0 exactly on the shared pair, whose 2-variable case analysis
    then falls to one atom, as the reference's float64 one does. The
    port's pool equals a float64 exhaustive enumeration by that case
    analysis (the reference's, ``nnls.lsqnonneg_2var``) and no residual is
    negative. (The JAX package sums the cross products in float32, so its
    two Grams of the same column can part by an ulp: det12 is then ~1e-7
    instead of 0 and the pair's residual can come out as a large negative
    number, which it selects: not held here.)"""
    A1, A2, y = _df2_inputs(wl, "grid", False)
    A2 = np.concatenate([A2, A1[:, :, 10:14]], axis=2)
    ct, vt, _q = tdfscan.df2_candidates(_t(A1), _t(A2), _t(y), M=4)
    assert float(vt.min()) >= -1e-6
    for b in range(8):
        a1 = A1[b].astype(np.float64)
        a2 = A2[b].astype(np.float64)
        a1 /= np.linalg.norm(a1, axis=0)
        a2 /= np.linalg.norm(a2, axis=0)
        yy = y[b] / np.linalg.norm(y[b].astype(np.float64))
        with np.errstate(invalid="ignore", divide="ignore"):  # det = 0
            _w1, _w2, res = tnnls.lsqnonneg_2var(
                1.0, np.sum(a1 * a1, 0)[:, None], a1.T @ a2,
                np.sum(a2 * a2, 0)[None, :], (yy @ a1)[:, None],
                (yy @ a2)[None, :])
        best = np.unravel_index(np.argmin(res), res.shape)
        assert tuple(ct[b, 0].tolist()) == best
        np.testing.assert_allclose(float(vt[b, 0]), res[best], atol=1e-6)


def _scan13_inputs(w, sig_ear, n):
    """Kernel 3's operands for the first n voxels of workload ``w``: the
    first rotated block, the EAR block (the second axis) and the CSF
    column (the fixed third block), float32, in the rotation's order."""
    rotate, perm = tinterp.make_grouped_rotation_paired(w["msinterp"],
                                                        w["plan"])
    _x, ys, _c = w["msinterp"].device_tables("cpu", torch.float32)
    A1 = rotate(ys, _t(w["peaks"][:n]).float())[:, 0].contiguous().numpy()
    S, E = A1.shape[1], sig_ear.shape[1]
    csf = np.float32(np.broadcast_to(
        w["sig_csf"][perm][None, :, None], (n, S, 1)))
    ear = np.float32(np.broadcast_to(sig_ear[perm][None], (n, S, E)))
    return A1, ear, csf, perm


def _scan13_both(A1, ear, csf, y):
    """[i1, e] and residual of the JAX df3_candidates and of kernel 3's
    plain version on the full grid."""
    cj, vj, _q = jdfscan.df3_candidates(
        jnp.asarray(A1), jnp.asarray(ear), jnp.asarray(csf), jnp.asarray(y),
        M=1)
    rr, ri, _ys = trescan.row_scan_df3(_t(A1), _t(ear), _t(csf), _t(y))
    ct, vt = trescan.candidates_from_rows(
        rr, ri, segments=trescan.n_segments(ear.shape[2]))
    return (np.asarray(cj)[:, 0], np.asarray(vj)[:, 0], ct[:, 0].numpy(),
            vt[:, 0].numpy())


def test_scan13_kernel3_grid_matches_jax_df3(wl):
    """One fascicle + CSF + EAR: kernel 3's plain version on the full
    [72, E, 1] grid (the EAR atoms as the second axis, CSF the fixed
    third block) vs the JAX df3_candidates the JAX package scans this
    bucket with. With EAR atom 0 planted: [i1, e] equal, residuals of the
    normalized problem within 2e-9. Without an EAR component every EAR
    sweep fits the signal alike (the CSF column and the EAR atoms are
    nearly collinear on this scheme, so the scans' own residual values
    of these supports are not resolved): i1 equal, and where e differs
    the two supports' float64 objectives lie within 2e-9 ||y||^2 (an
    equal-objective tie)."""
    A1, ear, csf, perm = _scan13_inputs(wl, wl["sig_ear"], 8)
    mix = ttesting.make_mixed(wl, [(8, 1, True)], wl["sig_ear"],
                              ear_atom=0, ear_amp=60.0)

    def objective(b, i1, e, y):
        A = np.stack([A1[b, :, i1], ear[b, :, e], csf[b, :, 0]], axis=1)
        y64 = y[b].astype(np.float64)
        rn = scipy.optimize.nnls(A.astype(np.float64), y64)[1]
        return rn * rn / (y64 @ y64)

    for planted in (True, False):
        y = mix["y"] - (0.0 if planted else 60.0) * wl["sig_ear"][:, 0][None]
        y = np.float32(y[:, perm])
        cj, vj, ct, vt = _scan13_both(A1, ear, csf, y)
        assert np.array_equal(ct[:, 0], cj[:, 0])
        assert np.array_equal(ct[:, 0], mix["gt_ids"][:, 0])
        if planted:
            assert np.array_equal(ct, cj) and not ct[:, 1].any()
            np.testing.assert_allclose(vt, vj, rtol=0, atol=2e-9)
        for b in np.flatnonzero(ct[:, 1] != cj[:, 1]):
            assert abs(objective(b, *ct[b], y)
                       - objective(b, *cj[b], y)) <= 2e-9


def test_scan13_kernel3_grid_matches_jax_df3_full_scheme():
    """The same scan at the flagship's protocol (552 sequences) and EAR
    block (10 atoms, EAR atom 4 planted at 35 as ``testing.make_ear``
    does), 72 atoms: kernel 3's plain version picks JAX df3_candidates'
    [i1, e] on every voxel, the planted one, residuals within 2e-9."""
    w = ttesting.make_fit_workload(num_atom=72, n_vox=8)
    sig_ear, _y = ttesting.make_ear(w)
    A1, ear, csf, perm = _scan13_inputs(w, sig_ear, 8)
    mix = ttesting.make_mixed(w, [(8, 1, True)], sig_ear)
    cj, vj, ct, vt = _scan13_both(A1, ear, csf,
                                  np.float32(mix["y"][:, perm]))
    assert np.array_equal(ct, cj)
    assert np.array_equal(ct[:, 0], mix["gt_ids"][:, 0])
    assert np.all(ct[:, 1] == 4)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=2e-9)


# ---------------------------------------------------------------------------
# run_bucket_fast, per bucket
# ---------------------------------------------------------------------------

def _check(ref, got, ysq, ear):
    """Atom IDs equal (the EAR ID: or an equal-objective tie), objectives
    within 2e-9 max||y||^2, R^2 within 1e-6 (tests/test_torch_fit.py)."""
    n_fix = ref[1].shape[1] - int(ear)
    assert np.array_equal(ref[1][:, :n_fix], got[1][:, :n_fix])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=2e-9 * ysq.max())
    np.testing.assert_allclose(got[4], ref[4], rtol=0, atol=1e-6)


@pytest.mark.parametrize("K,csf,ear", BUCKETS)
def test_bucket_matches_jax(wl, K, csf, ear):
    """run_bucket_fast for each new bucket vs the JAX run_bucket_fast with
    its device finalize and with its float64 host refine: C = K + csf +
    ear columns in the canonical layout, the planted atoms recovered
    (with EAR: EAR atom 0, the one farthest from the CSF column on this
    40-sequence scheme), weights to rtol 1e-5 of the host refine's."""
    mix = ttesting.make_mixed(wl, [(8, K, csf)],
                              wl["sig_ear"] if ear else None, ear_atom=0,
                              ear_amp=60.0)
    y, peaks = mix["y"], mix["peaks"][:, :3 * K]
    kw = dict(batch=8, sig_ear=wl["sig_ear"] if ear else None, ear_on=ear)
    ys32 = jnp.asarray(wl["jms"].ys, jnp.float32)
    refs = [jfit.run_bucket_fast(wl["jms"], wl["jplan"], ys32, peaks, y,
                                 wl["sig_csf"], K, csf, device_finalize=f,
                                 **kw) for f in (True, False)]
    _x, ys_t, _c = wl["tms"].device_tables("cpu", torch.float32)
    got = tfit.run_bucket_fast(wl["tms"], wl["jplan"], ys_t, peaks, y,
                               wl["sig_csf"], K, csf, **kw)
    C = K + csf + ear
    assert got[0].shape == (8, C) and got[1].shape == (8, C)
    ysq = np.sum(y ** 2, axis=1)
    for ref in refs:
        assert np.asarray(ref[1]).shape == (8, C)
        _check(ref, got, ysq, ear)
    assert np.array_equal(got[1][:, :K], mix["gt_ids"][:, :K])
    if csf:
        assert not got[1][:, K].any()                    # csf index 0
    if ear:
        assert not got[1][:, -1].any()                   # EAR atom 0
    host = refs[1]
    np.testing.assert_allclose(got[0], host[0], rtol=1e-5,
                               atol=1e-6 * np.abs(host[0]).max())


def test_bucket_guard():
    """run_bucket_fast raises for the buckets the fast path does not
    cover (one fascicle without CSF, EAR without CSF, three fascicles),
    naming the general path's ROADMAP item, before any work."""
    for K, csf, ear in ((1, False, False), (2, False, True), (3, True,
                                                             False)):
        with pytest.raises(NotImplementedError, match="item 4"):
            tfit.run_bucket_fast(None, None, torch.zeros(1, 1, 1), None,
                                 np.zeros((1, 1)), None, K, csf,
                                 ear_on=ear)


# ---------------------------------------------------------------------------
# MFModel.fit on a mixed volume
# ---------------------------------------------------------------------------

def _dictionary(wl):
    sig, dpar, dperp = ttesting.make_dictionary(wl["sch_mat"], 72)
    return {"dictionary": sig, "sch_mat": wl["sch_mat"],
            "orientation": np.array([0.0, 0.0, 1.0]), "num_atom": 72,
            "fasc_propnames": ["dpar", "dperp"], "dpar": dpar,
            "dperp": dperp, "T2_csf": 2.0, "DIFF_csf": 3.0e-9}


def _times_out(text):
    """Printed lines with every time left out."""
    return [re.sub(r" in \S+ (second\(s\)|sec)\.$", " in T \\1.", line)
            for line in text.splitlines()]


@pytest.fixture(scope="module")
def mixed_fits(wl):
    """A 16-voxel 4 x 2 x 2 volume: 3 CSF-only voxels, 5 (1, csf), 4
    (2, csf) and 4 (2) voxels (csf_mask 0 on those), fitted by both
    packages at verbose=3 (JAX engine="fast", R = 16 on both)."""
    mix = ttesting.make_mixed(wl, [(3, 0, True), (5, 1, True),
                                   (4, 2, True), (4, 2, False)], seed=3)
    shape = (4, 2, 2)
    S = wl["sch_mat"].shape[0]
    vol = dict(data=mix["y"].reshape(shape + (S,)), mask=np.ones(shape),
               numfasc=mix["numfasc"].reshape(shape).astype(float),
               dpar=_dictionary(wl)["dpar"])
    kw = dict(peaks=mix["peaks"].reshape(shape + (6,)),
              pgse_scheme=wl["sch_mat"],
              csf_mask=mix["csf_mask"].reshape(shape).astype(float),
              verbose=3, batch_size=8)
    saved = (jconfig.DEFAULTS["solver"], tconfig.DEFAULTS["solver"])
    jconfig.DEFAULTS["solver"] = dataclasses.replace(saved[0],
                                                     twopass_rows=16)
    tconfig.DEFAULTS["solver"] = dataclasses.replace(saved[1],
                                                     twopass_rows=16)
    out = {}
    try:
        for name, make, extra in (
                ("jax", lambda: JMFModel(_dictionary(wl)),
                 dict(engine="fast")),
                ("port", lambda: mft.MFModel(_dictionary(wl)),
                 dict(device="cpu"))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fit = make().fit(vol["data"], vol["mask"], vol["numfasc"],
                                 **kw, **extra)
            out[name] = (fit, buf.getvalue())
    finally:
        jconfig.DEFAULTS["solver"], tconfig.DEFAULTS["solver"] = saved
    vol["kw"] = kw
    return mix, vol, out


def test_mixed_model_fit_matches_jax(mixed_fits):
    """MFModel.fit (device="cpu") vs the JAX MFModel.fit on a volume
    holding 0, 1 and 2 fascicles with and without CSF: the same maps;
    IDs and property maps equal, fractions and M0 to rtol 1e-5, MSE
    within 1e-9 max||y||^2 / S, R^2 within 1e-6; the planted atoms
    recovered in every voxel with fascicles."""
    mix, vol, out = mixed_fits
    fj, ft = out["jax"][0], out["port"][0]
    assert ft.param_names == fj.param_names
    S = vol["data"].shape[-1]
    ysq_max = np.max(np.sum(vol["data"] ** 2, axis=-1))
    for p in ft.param_names:
        a, b = getattr(ft, p), getattr(fj, p)
        if p.startswith("peak") or (p.endswith(("_f0", "_f1"))
                                    and not p.startswith("frac")):
            assert np.array_equal(a, b), p
        elif p == "MSE":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * ysq_max / S)
        elif p == "R2":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=p)
    got = np.stack([ft.dpar_f0.reshape(-1), ft.dpar_f1.reshape(-1)], axis=1)
    want = np.where(mix["gt_ids"] >= 0, vol["dpar"][mix["gt_ids"]], 0.0)
    assert np.array_equal(got, want)
    assert np.all(ft.R2.reshape(-1)[mix["numfasc"] > 0] >= 1 - 1e-6)


def test_fit_verbose_lines_match_jax(mixed_fits):
    """At verbose=3 the port prints the JAX package's lines, in its order
    (model, estimation start, per-bucket "Config", "dispatched", "pulled"
    and "Voxel i/n" progress lines at the MAX_PROG_LINES / DFT_DISP_ITVL
    cadence, "Estimation performed", the fit object's map list), times
    left out, and the fast-path buckets' counts of certified, re-scored
    and fallback voxels on their "pulled" lines."""
    _mix, _vol, out = mixed_fits
    lj, lt = _times_out(out["jax"][1]), _times_out(out["port"][1])
    # the port's fast-path buckets add their exact selection's counts to
    # the "pulled in" line (models/fit.CERTIFY), which the JAX package
    # does not have
    note = re.compile(r"; voxels certified: \d+, re-scored: \d+, "
                      r"fallback: \d+")
    assert sum(bool(note.search(line)) for line in lt) == 3
    lt = [note.sub("", line) for line in lt]
    assert lt == lj
    assert any(line.startswith("Voxel 1/16 (") for line in lt)
    assert sum(line.startswith("Config K=") for line in lt) == 4


def test_fit_dispatches_every_bucket_before_the_host_solve(wl, mixed_fits,
                                                           monkeypatch):
    """MFModel.fit queues every fast-path bucket (``run_bucket_fast(...,
    defer=True)``) before it runs the fascicle-free host solve
    (``run_bucket_trivial``) and before it pulls any bucket, as the JAX
    package does; the maps are the mixed fit's, bit for bit."""
    _mix, vol, out = mixed_fits
    events = []
    fast, trivial = tfit.run_bucket_fast, tfit.run_bucket_trivial

    def fast_spy(*a, **k):
        assert k["defer"] is True
        events.append("dispatch")
        finish = fast(*a, **k)
        return lambda: events.append("pull") or finish()

    monkeypatch.setattr(tfit, "run_bucket_fast", fast_spy)
    monkeypatch.setattr(tfit, "run_bucket_trivial", lambda *a, **k:
                        events.append("host solve") or trivial(*a, **k))
    monkeypatch.setitem(tconfig.DEFAULTS, "solver", dataclasses.replace(
        tconfig.DEFAULTS["solver"], twopass_rows=16))
    fit = mft.MFModel(_dictionary(wl)).fit(
        vol["data"], vol["mask"], vol["numfasc"],
        **dict(vol["kw"], verbose=0), device="cpu")
    assert events == ["dispatch"] * 3 + ["host solve"] + ["pull"] * 3
    want = out["port"][0]
    for p in want.param_names:
        assert np.array_equal(getattr(fit, p), getattr(want, p)), p


def test_fit_solves_the_host_bucket_before_the_rescores(wl, mixed_fits,
                                                        monkeypatch):
    """With the fast path's exact selection (each deferred bucket's
    ``finish.drain``), MFModel.fit runs the fascicle-free host solve
    after every bucket is queued and before the first bucket's host
    re-score, so that it runs while the card works; then the re-scores,
    then the pulls. The maps are the mixed fit's, bit for bit."""
    _mix, vol, out = mixed_fits
    events = []
    fast, trivial = tfit.run_bucket_fast, tfit.run_bucket_trivial

    def fast_spy(*a, **k):
        events.append("dispatch")
        finish = fast(*a, **k)

        def pull():
            events.append("pull")
            return finish()
        pull.drain = lambda: events.append("re-score") or finish.drain()
        return pull

    monkeypatch.setattr(tfit, "run_bucket_fast", fast_spy)
    monkeypatch.setattr(tfit, "run_bucket_trivial", lambda *a, **k:
                        events.append("host solve") or trivial(*a, **k))
    monkeypatch.setitem(tconfig.DEFAULTS, "solver", dataclasses.replace(
        tconfig.DEFAULTS["solver"], twopass_rows=16))
    fit = mft.MFModel(_dictionary(wl)).fit(
        vol["data"], vol["mask"], vol["numfasc"],
        **dict(vol["kw"], verbose=0), device="cpu")
    assert events == (["dispatch"] * 3 + ["host solve"] + ["re-score"] * 3
                      + ["pull"] * 3)
    want = out["port"][0]
    for p in want.param_names:
        assert np.array_equal(getattr(fit, p), getattr(want, p)), p
