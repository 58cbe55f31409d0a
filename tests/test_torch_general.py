"""The port's general path (``engine='xla'``) vs the JAX package on the
CPU: the closed-form solvers, the tiled exhaustive scans of 1-4 blocks
and their top-M candidate pools, the gather-and-lerp rotation, the fit
steps and ``run_bucket`` per bucket, and ``MFModel.fit`` on the golden
fixture.

The same inputs, drawn from seeded NumPy generators, go to both
packages. On the float64 route (float64 tables and signals on both
sides) the selected ids are equal, ties resolved alike, and weights and
objectives agree to rtol 1e-12; on the float32 route (the production
arithmetic) ids are equal or an equal-objective tie within 1e-6 ||y||^2
and weights agree to rtol 1e-5. Shapes are the ones the JAX suite
already compiles (tests/test_nnls.py: B 4, S 40, N1/N2 <= 50, N3 <= 3;
40 atoms on 3 shells x 12 directions + 4 b0, EAR blocks of 17 atoms).
"""

import os

import numpy as np
import pytest
import scipy.optimize
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.models import fit as jfit
from microstructure_fingerprinting_tpu.ops import interp as jinterp
from microstructure_fingerprinting_tpu.ops import nnls as jnnls
from microstructure_fingerprinting_tpu.utils.scheme import b_values

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models import fit as tfit
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.ops import nnls as tnnls

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_fit.npz")
#: EAR diffusivities of the general path's EAR blocks: 17 atoms, one
#: more than the fast path takes; on this 40-sequence scheme the widest
#: atoms are nearly collinear with the CSF column, where a float32
#: 4-block sweep is rounding noise in either package, so the float32
#: route takes 17 atoms up to 1.5e-9
DEAR = {"float64": np.linspace(0.8e-9, 2.6e-9, 17),
        "float32": np.linspace(0.8e-9, 1.5e-9, 17)}
#: the general path's buckets: (K, csf, ear)
BUCKETS = [(1, False, False), (1, False, True), (2, False, True),
           (2, True, True)]
DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x)


# ---------------------------------------------------------------------------
# closed-form solvers
# ---------------------------------------------------------------------------

def _grams(rng, n, k):
    """n random k-column Gram systems (G[r][c], Y[r], y'y), a quarter of
    them with two equal columns (det 0) and a few entries NaN."""
    A = rng.randn(n, 12, k)
    A[: n // 4, :, k - 1] = A[: n // 4, :, 0]
    y = rng.randn(n, 12)
    G = np.einsum("nsa,nsb->abn", A, A)
    Y = np.einsum("nsa,ns->an", A, y)
    y_sq = np.einsum("ns,ns->n", y, y)
    G[0, 0, -3:] = np.nan
    Y[k - 1, -6:-4] = np.nan
    return G, Y, y_sq


def _solver_args(rng, kind):
    if kind == "sweep4":
        n = 64
        g = np.tanh(rng.randn(6, n))
        g[5, :8] = 1.0                                  # det of {3, 4} = 0
        Yv = rng.randn(4, n) * 0.6
        return (g[0], g[1], g[2], g[3], g[4], g[5], Yv[0], Yv[1], Yv[2],
                Yv[3], tnnls._det_tol(torch.float64))
    k = int(kind[0])
    G, Y, y_sq = _grams(rng, 64, k)
    if k == 1:
        return (y_sq, G[0, 0], Y[0])
    if k == 2:
        return (y_sq, G[0, 0], G[0, 1], G[1, 1], Y[0], Y[1])
    if k == 3:
        return (y_sq, G[0, 0], G[1, 1], G[2, 2], G[0, 1], G[0, 2], G[1, 2],
                Y[0], Y[1], Y[2])
    return (y_sq, tuple(tuple(G[a, b] for b in range(4)) for a in range(4)),
            tuple(Y))


def _to_torch(args):
    if isinstance(args, tuple):
        return tuple(_to_torch(a) for a in args)
    return _t(args) if isinstance(args, np.ndarray) else args


@pytest.mark.parametrize("kind", ["1var", "2var", "3var", "4var", "sweep4"])
def test_solver_forms_bitwise(kind):
    """Each closed-form solver's NumPy form equals the JAX package's
    ``xp=np`` form bit for bit in float64, on random Grams, on Grams of
    two equal columns (det 0) and with NaN entries; its torch form (the
    device scans') equals its NumPy form bit for bit."""
    args = _solver_args(np.random.RandomState(7), kind)
    name = ("_nnls4_sweep_res" if kind == "sweep4"
            else "lsqnonneg_" + kind)
    with np.errstate(all="ignore"):
        ref = getattr(jnnls, name)(*args, xp=np)
        got = getattr(tnnls, name)(*args)
    dev = getattr(tnnls, name)(*_to_torch(args), xp=tnnls.TORCH)
    ref, got, dev = ((r,) if kind == "sweep4" else r
                     for r in (ref, got, dev))
    for r, g, d in zip(ref, got, dev):
        assert np.array_equal(np.asarray(r), g, equal_nan=True)
        assert d.dtype == torch.float64
        assert np.array_equal(g, d.numpy(), equal_nan=True)


# ---------------------------------------------------------------------------
# the batched scans and their candidate pools
# ---------------------------------------------------------------------------

def _blocks(k, dt, seed=141414):
    """Blocks of tests/test_nnls.py's shapes: [50, 45, 3] for K <= 3, the
    4-block [50, 45, 1, 6] (2 fascicles + CSF + EAR), B 4, S 40."""
    rng = np.random.RandomState(seed)
    sizes = {1: [50], 2: [50, 45], 3: [50, 45, 3], 4: [50, 45, 1, 6]}[k]
    blocks = tuple(rng.randn(4, 40, n).astype(dt) for n in sizes)
    return blocks, rng.randn(4, 40).astype(dt)


def _objective(blocks, y, b, ind):
    """Exact (float64) NNLS objective of voxel b on the support ``ind``."""
    A = np.stack([np.float64(blk[b, :, i]) for blk, i in zip(blocks, ind)],
                 axis=1)
    return scipy.optimize.nnls(A, np.float64(y[b]))[1] ** 2


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_exhaustive_batched_matches_jax(k, dtype):
    """``exhaustive_nnls_blocks`` (``exhaustive_{1,2,3,4}_batched``) vs
    the JAX package's on the same blocks: float64 ids equal, weights and
    objectives to rtol 1e-12; float32 ids equal or an equal-objective
    tie within 1e-6 ||y||^2, weights to rtol 1e-5."""
    blocks, y = _blocks(k, DTYPES[dtype][0])
    wj, ij, oj = (_np(x) for x in jnnls.exhaustive_nnls_blocks(blocks, y))
    wt, it, ot = (_np(x) for x in tnnls.exhaustive_nnls_blocks(
        tuple(_t(b) for b in blocks), _t(y)))
    assert it.dtype == np.int32 and wt.dtype == blocks[0].dtype
    if dtype == "float64":
        assert np.array_equal(it, ij)
        np.testing.assert_allclose(wt, wj, rtol=1e-12, atol=0)
        np.testing.assert_allclose(ot, oj, rtol=1e-12, atol=0)
        return
    ysq = np.sum(np.float64(y) ** 2, axis=1)
    same = np.all(it == ij, axis=1)
    np.testing.assert_allclose(wt[same], wj[same], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-6 * ysq.max())
    for b in np.flatnonzero(~same):
        assert abs(_objective(blocks, y, b, it[b])
                   - _objective(blocks, y, b, ij[b])) <= 1e-6 * ysq[b]


def _cands_both(blocks, y, M):
    cj = np.asarray(jnnls.exhaustive_candidates_blocks(blocks, y, M=M))
    ct = tnnls.exhaustive_candidates_blocks(tuple(_t(b) for b in blocks),
                                            _t(y), M=M).numpy()
    return cj, ct


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_candidates_match_jax(k):
    """Float64 top-M pools: ``exhaustive_candidates_blocks`` gives the
    JAX package's (B, M, K) sets in its order (k = 1 also with M larger
    than the block, where the last index repeats), and
    ``exhaustive_{2,3,4}_candidates`` its flat ranks and residuals (rtol
    1e-12)."""
    blocks, y = _blocks(k, np.float64)
    for M in ((8, 64) if k == 1 else (8,)):
        cj, ct = _cands_both(blocks, y, M)
        assert ct.dtype == np.int32 and ct.shape == (4, M, k)
        assert np.array_equal(ct, cj)
    if k == 1:
        assert np.all(ct[:, 50:, 0] == ct[:, 49:50, 0])
        return
    fn = "exhaustive_%d_candidates" % k
    fj, vj = getattr(jnnls, fn)(*blocks, y, M=8)
    ft, vt = getattr(tnnls, fn)(*(_t(b) for b in blocks), _t(y), M=8)
    assert np.array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-12,
                               atol=0)


# ---------------------------------------------------------------------------
# the rotation, the fit steps and run_bucket per bucket
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wl():
    """A 40-atom workload (3 shells x 12 directions + 4 b0, 8 voxels)
    with both packages' interpolators (identical tables) and a 17-atom
    EAR block."""
    w = ttesting.make_fit_workload(num_atom=40, n_vox=8, n_shells=3,
                                   dirs_per_shell=12, n_b0=4)
    ms = jinterp.init_PGSE_multishell_interp(
        w["dictionary"], w["sch_mat"], np.array([0.0, 0.0, 1.0]))
    w["jms"], w["jplan"] = ms, jinterp.plan_target_scheme(ms, w["sch_mat"])
    w["tms"] = tinterp.MultiShellInterp.from_numpy(ms)
    sch = w["sch_mat"]
    TE, b = sch[:, 6], b_values(sch)
    w["sig_ear"] = {k: np.exp(-TE / 0.8)[:, None] * np.exp(-b[:, None] * d)
                    for k, d in DEAR.items()}
    return w


def _tables(wl, dtype):
    """((xs, ys, cnt), plan) of both packages in ``dtype``."""
    nd, td = DTYPES[dtype]
    ms, plan = wl["jms"], wl["jplan"]
    jt = (jnp.asarray(ms.xs, nd), jnp.asarray(ms.ys, nd),
          jnp.asarray(ms.cnt))
    jp = (jnp.asarray(plan.gdir, nd), jnp.asarray(plan.shell_lo),
          jnp.asarray(plan.shell_hi), jnp.asarray(plan.wG, nd))
    tt = wl["tms"].device_tables("cpu", td)
    tp = (torch.as_tensor(plan.gdir, dtype=td), _t(plan.shell_lo).long(),
          _t(plan.shell_hi).long(), torch.as_tensor(plan.wG, dtype=td))
    return jt, jp, tt, tp


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_eval_rotation_batch_matches_jax(wl, dtype):
    """The gather-and-lerp rotation of every voxel's two directions,
    (B, K, Nseq, N), vs the JAX ``eval_rotation_batch``: to 8 ulp of the
    tables' dtype (the JAX package sums |g . n| in another order, and a
    segment's slope carries that ulp of x into the value)."""
    jt, jp, tt, tp = _tables(wl, dtype)
    nd, td = DTYPES[dtype]
    ref = np.asarray(jinterp.eval_rotation_batch(
        *jt, *jp, jnp.asarray(wl["peaks"], nd)))
    got = tinterp.eval_rotation_batch(*tt, *tp,
                                      torch.as_tensor(wl["peaks"], dtype=td))
    assert got.shape == ref.shape == (8, 2, 40, 40) and got.dtype == td
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=8 * np.finfo(nd).eps * np.abs(ref).max())


def _bucket(wl, K, csf, ear, dtype, noise=0.0):
    """8 voxels of bucket (K, csf, ear): planted atoms, EAR atom 0 at 60
    (the EAR atom farthest from the CSF column on this scheme), plus
    Gaussian noise of standard deviation ``noise`` (seeded)."""
    mix = ttesting.make_mixed(wl, [(8, K, csf)],
                              wl["sig_ear"][dtype] if ear else None,
                              ear_atom=0, ear_amp=60.0)
    y = mix["y"] + noise * np.random.RandomState(5).randn(*mix["y"].shape)
    return y, mix["peaks"][:, :3 * K], mix


def _bucket_args(wl, K, csf, ear, y, peaks, dtype):
    nd, _td = DTYPES[dtype]
    S = y.shape[1]
    csf_sig = wl["sig_csf"] if csf else np.zeros(S)
    ear_sig = wl["sig_ear"][dtype] if ear else np.zeros((S, 1))
    pk = peaks.reshape(-1, K, 3)
    return ((jnp.asarray(pk, nd), jnp.asarray(y, nd),
             jnp.asarray(csf_sig, nd), jnp.asarray(ear_sig, nd)),
            tuple(_t(np.asarray(a, nd)) for a in (pk, y, csf_sig, ear_sig)))


def _close(w, obj, mse, r2, w_ref, obj_ref, mse_ref, r2_ref, ysq, S):
    """The float64 route's tolerances of test_fit_steps_match_jax_x64."""
    np.testing.assert_allclose(w, w_ref, rtol=1e-8, atol=0)
    assert np.all(np.abs(obj - obj_ref) <= 1e-12 * ysq)
    assert np.all(np.abs(mse - mse_ref) <= 1e-12 * ysq / S)
    np.testing.assert_allclose(r2, r2_ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("K,csf,ear", BUCKETS)
def test_fit_steps_match_jax_x64(wl, K, csf, ear):
    """Float64 route, per bucket, on noisy signals: ``fit_step`` (ids
    equal; weights to rtol 1e-8: the Cramer solves carry the two
    packages' different summation orders up by the Gram's condition
    number, large where the CSF column and the EAR atoms of this
    40-sequence scheme are nearly collinear; objectives and MSE to 1e-12
    ||y||^2: an objective is ||y||^2 (1 - ...), so those orders part it
    by eps ||y||^2; R^2 to 1e-12), ``fit_step_candidates``
    (equal (B, M, C) sets, but for the EAR slot of a 4-block pool) and
    ``run_bucket`` with and without the float64 refine equal the JAX
    package's."""
    y, peaks, _mix = _bucket(wl, K, csf, ear, "float64", noise=2.0)
    ysq = np.sum(y ** 2, axis=1)
    S = y.shape[1]
    jt, jp, tt, tp = _tables(wl, "float64")
    ja, ta = _bucket_args(wl, K, csf, ear, y, peaks, "float64")
    st = dict(K=K, csf_on=csf, ear_on=ear)
    ref = jfit.fit_step(*jt, *jp, *ja, **st)
    got = tfit.fit_step(*tt, *tp, *ta, **st)
    assert np.array_equal(got["ind"].numpy(), np.asarray(ref["ind"]))
    _close(got["w"].numpy(), got["min_obj"].numpy(), got["mse"].numpy(),
           got["r2"].numpy(), *(np.asarray(ref[k]) for k in
                                ("w", "min_obj", "mse", "r2")), ysq, S)
    cj = np.asarray(jfit.fit_step_candidates(*jt, *jp, *ja, M=8, **st))
    ct = tfit.fit_step_candidates(*tt, *tp, *ta, M=8, **st).numpy()
    # four blocks: a pool entry's EAR atom is the sweep that won its
    # (i1, i2) point, an exact tie wherever the EAR weight is 0, and the
    # refine re-enumerates it
    n_fix = 3 if K + csf + ear == 4 else K + csf + ear
    assert np.array_equal(ct[..., :n_fix], cj[..., :n_fix])

    args = (peaks, y, wl["sig_csf"] if csf else None,
            wl["sig_ear"]["float64"] if ear else None, K, csf, ear)
    for refine in (False, True):
        kw = dict(batch=8, refine=refine, topm=8)
        if refine:
            kw.update(ms_host=wl["jms"], plan_host=wl["jplan"])
        rj = jfit.run_bucket(jt, jp, *args, **kw)
        if refine:
            kw.update(ms_host=wl["tms"])
        rt = tfit.run_bucket(tt, tp, *args, **kw)
        assert np.array_equal(rt[1], np.asarray(rj[1]))
        _close(*(rt[:1] + rt[2:]),
               *(np.asarray(x) for x in rj[:1] + rj[2:]), ysq, S)


@pytest.mark.parametrize("K,csf,ear", BUCKETS)
def test_run_bucket_float32_matches_jax(wl, K, csf, ear):
    """Float32 route (the card's arithmetic), per bucket: ``run_bucket``
    with the top-16 pool and the float64 refine, in 3-voxel chunks (pad
    rows replicate voxel 0), vs the JAX package's: ids equal or an
    equal-objective tie within 1e-6 ||y||^2, weights to rtol 1e-5; the
    planted atoms are recovered."""
    y, peaks, mix = _bucket(wl, K, csf, ear, "float32")
    jt, jp, tt, tp = _tables(wl, "float32")
    args = (peaks, y, wl["sig_csf"] if csf else None,
            wl["sig_ear"]["float32"] if ear else None, K, csf, ear)
    kw = dict(batch=3, refine=True, topm=16, plan_host=wl["jplan"])
    rj = jfit.run_bucket(jt, jp, *args, ms_host=wl["jms"], **kw)
    rt = tfit.run_bucket(tt, tp, *args, ms_host=wl["tms"], **kw)
    ysq = np.sum(y ** 2, axis=1)
    same = np.all(rt[1] == np.asarray(rj[1]), axis=1)
    np.testing.assert_allclose(rt[0][same], np.asarray(rj[0])[same],
                               rtol=1e-5, atol=1e-6 * np.abs(rt[0]).max())
    np.testing.assert_allclose(rt[2], np.asarray(rj[2]), rtol=0,
                               atol=1e-6 * ysq.max())
    assert np.all(np.abs(rt[2] - np.asarray(rj[2])) <= 1e-6 * ysq)
    assert np.array_equal(rt[1][:, :K], mix["gt_ids"][:, :K])


# ---------------------------------------------------------------------------
# MFModel.fit on the golden fixture
# ---------------------------------------------------------------------------

@pytest.mark.skipif(not os.path.isfile(GOLDEN),
                    reason="golden fixture not generated")
@pytest.mark.parametrize("extra", [{}, {"engine": "xla"}],
                         ids=["default", "xla"])
def test_golden_fit_maps(tmp_path, extra):
    """The port's MFModel.fit (device="cpu") on tests/golden/golden_fit.npz
    (23 voxels in ten buckets, four of them on the general path by
    default and every bucket with fascicles under engine="xla") gives
    every map within 1e-5 x max(1, max|map|) of the fixture, the check of
    tests/test_golden.py; the maps written reload exactly. The default
    arguments, but for 8-voxel chunks: the CPU twins evaluate every pad
    voxel, and the chunk does not change a voxel's result."""
    g = np.load(GOLDEN, allow_pickle=False)
    dic = {
        "dictionary": g["dictionary"], "sch_mat": g["sch_mat"],
        "orientation": g["orientation"], "num_atom": g["dictionary"].shape[1],
        "num_ear": g["DIFF_ear"].size, "fasc_propnames": ["dpar", "dperp"],
        "dpar": g["dpar"], "dperp": g["dperp"], "T2_csf": 2.0,
        "DIFF_csf": 3.0e-9, "T2_ear": 0.8, "DIFF_ear": g["DIFF_ear"],
    }
    fit = mft.MFModel(dic, device="cpu").fit(
        g["data"], g["mask"], g["numfasc"], peaks=g["peaks"],
        pgse_scheme=g["sch_mat"], csf_mask=g["csf_mask"],
        ear_mask=g["ear_mask"], verbose=0, batch_size=8, **extra)
    names = [str(p) for p in g["param_names"]]
    assert fit.param_names == names
    for p in names:
        scale = max(1.0, float(np.max(np.abs(g["map_" + p]))))
        np.testing.assert_allclose(getattr(fit, p), g["map_" + p], rtol=0,
                                   atol=1e-5 * scale, err_msg=p)
    files = fit.write_nifti(str(tmp_path / "g"), affine=np.eye(4))
    assert len(files) == len(names)
    for fname, p in zip(files, names):
        back = mft.utils.nifti.load(fname).get_fdata()
        assert np.array_equal(back, getattr(fit, p)), p
