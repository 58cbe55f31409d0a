"""The EAR slice's kernel modules vs the JAX package on the CPU: prep with
12 rhs columns (kernel 1), the 4-block interval row pass (kernel 4), the
double-float 4-block re-scan (kernel 5), the EAR two-pass composition and
the 1-, 2- and 4-column finalize.

Each kernel's plain PyTorch version (what a wrapper runs for CPU tensors)
is held against the JAX function with its Pallas kernel in interpret
mode, at the shapes the JAX suite already compiles
(``tests/test_f32scan.py``). The CUDA kernels are held against these plain
versions on the card (the ``cuda``-marked test below, and
``chip_smoke.py``)."""

import numpy as np
import pytest
import scipy.optimize
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.ops import dfscan as jdfscan
from microstructure_fingerprinting_tpu.ops import f32scan as jf32scan
from microstructure_fingerprinting_tpu.ops import pallas_dfscan as jpdf
from microstructure_fingerprinting_tpu.ops import pallas_prep as jprep

from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import f32scan as tf32scan
from microstructure_fingerprinting_torch.ops import prep as tprep
from microstructure_fingerprinting_torch.ops import rescan as trescan

torch.set_num_threads(2)
EPS32 = float(np.finfo(np.float32).eps)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _corr_problem(rng, B, S, N1, N2, N3, N4):
    """tests/test_f32scan.py's fingerprint-like EAR family: correlated
    fascicle blocks, positive CSF/EAR columns and signal."""
    base = np.abs(rng.randn(B, S, 1))
    mk = lambda n: np.float32(
        0.9 * base + 0.1 * (np.abs(rng.randn(B, S, n)) + 0.05))
    A1, A2 = mk(N1), mk(N2)
    a3 = np.float32(np.abs(rng.randn(B, S, N3)) + 0.05)
    a4 = np.float32(np.abs(rng.randn(B, S, N4)) + 0.05)
    y = np.float32(np.abs(rng.randn(B, S)))
    return A1, A2, a3, a4, y


def _obj64(args, cand):
    """float64 NNLS objective (unit-normalized columns and signal) of each
    voxel's candidate (i1, i2, i3, i4), by scipy's active-set solver."""
    A1, A2, a3, a4, y = (np.asarray(x, np.float64) for x in args)
    out = []
    for b, (i1, i2, i3, i4) in enumerate(np.asarray(cand)[:, 0]):
        M = np.stack([A1[b, :, i1], A2[b, :, i2], a3[b, :, i3],
                      a4[b, :, i4]], axis=1)
        M /= np.linalg.norm(M, axis=0)
        out.append(scipy.optimize.nnls(M, y[b] / np.linalg.norm(y[b]))[1]
                   ** 2)
    return np.array(out)


def _same_or_tie(args, ct, cj, tol=1e-9):
    """Candidates equal in (i1, i2); where the EAR slot differs, the two
    supports' float64 objectives tie (an unused EAR block leaves every
    ear atom at the same objective)."""
    assert np.array_equal(ct[:, :, :2], cj[:, :, :2])
    diff = np.any(ct != cj, axis=(1, 2))
    if diff.any():
        sub = [np.asarray(x)[diff] for x in args]
        np.testing.assert_allclose(_obj64(sub, ct[diff]),
                                   _obj64(sub, cj[diff]), rtol=0, atol=tol)


def _row_problem(rng, B=2, S=36, N1=96, N2=128, n4=5):
    """tests/test_f32scan.py's rowmin_4 family (corr 0.9, positive)."""
    A1 = np.abs(rng.randn(B, S, N1)) + 0.05
    A2 = np.abs(rng.randn(B, S, N2)) + 0.05
    base = np.abs(rng.randn(B, S, 1))
    A1 = 0.9 * base + 0.1 * A1
    A2 = 0.9 * base + 0.1 * A2
    a3 = np.abs(rng.randn(B, S, 1)) + 0.05
    y = np.abs(rng.randn(B, S))
    a4 = np.abs(rng.randn(B, S, n4)) + 0.05
    f = np.float32
    return f(A1), f(A2), f(a3), f(a4), f(y)


# ---------------------------------------------------------------------------
# kernel 1 with the EAR path's 12 rhs columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,tile,planes", [(200, 128, "xr"),
                                           (700, 512, "ra")])
def test_prep_twelve_rhs_matches_jax(rng, N, tile, planes):
    """prep twin vs JAX prep_block(interpret=True) with the signal, the
    CSF column and 10 EAR columns packed (gram rows 1..12), with the
    tolerances of the 2-rhs test (tests/test_torch_kernels.py): the
    JAX package sums norms in float32, so q123 agrees on >= 99% of the
    entries, the bf16 x plane bit for bit, gram rows 0-12 to 4 eps and
    the unused rows 13-15 are zero on both sides."""
    B, S = 2, 36
    A = np.float32(np.abs(rng.randn(B, S, N)) + 0.05)
    cols = np.float32(np.abs(rng.randn(12, B, S)) + 0.05)
    cols /= np.linalg.norm(cols, axis=2, keepdims=True)
    rq, rr, ra, _ = jprep.pack_rhs([jnp.asarray(c) for c in cols])
    Ap, Np = jprep.pad_block(jnp.asarray(A), tile)
    oj = jprep.prep_block(Ap, rq, rr, ra, tile, interpret=True,
                          planes=planes)
    rqt, rrt, rat, _ = tprep.pack_rhs([_t(c) for c in cols])
    assert np.array_equal(np.asarray(rq), rqt.numpy())
    assert np.array_equal(np.asarray(ra, np.float32), rat.float().numpy())
    Apt, _ = tprep.pad_block(_t(A), tile)
    ot = tprep.prep_block(Apt, rqt, rrt, rat, tile, planes=planes, n_rhs=12)
    qj, qt = np.asarray(oj[0]), ot[0].numpy()
    assert qj.shape == qt.shape == (B, Np // tile, S, 3 * tile)
    assert (qj == qt).mean() >= 0.99
    if "x" in planes:
        assert np.array_equal(np.asarray(oj[1], np.float32),
                              ot[1].float().numpy())
    gj, gt = np.asarray(oj[4]), ot[4].numpy()
    np.testing.assert_allclose(gt[:, :13], gj[:, :13], rtol=0,
                               atol=4 * EPS32)
    assert not gt[:, 13:].any() and not gj[:, 13:].any()
    with pytest.raises(ValueError, match="at most 15"):
        tprep.pack_rhs([_t(cols[0])] * 16)


# ---------------------------------------------------------------------------
# kernel 4: the 4-block interval row pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N2,colcap", [(128, 512), (200, 128)])
def test_rowmin4_matches_jax(rng, N2, colcap):
    """rowmin_4 (prep + row-pass twin) vs JAX rowmin_4(pallas=True,
    interpret=True, colmin=True) on tests/test_f32scan.py's shapes;
    colcap = 128 at N2 = 200 runs two column blocks. Tolerance of that
    file: finite pattern >= 99%, atol 1e-5 on lo/up/upf/lo_col."""
    args = _row_problem(rng, N2=N2)
    rj = jf32scan.rowmin_4(*[jnp.asarray(x) for x in args], pallas=True,
                           interpret=True, colmin=True, colcap=colcap)
    rt = tf32scan.rowmin_4(*[_t(x) for x in args], colmin=True,
                           colcap=colcap)
    for x0, x1 in zip(rj, rt):
        x0, x1 = np.asarray(x0), x1.numpy()
        assert x0.shape == x1.shape
        pat = np.isfinite(x0) == np.isfinite(x1)
        assert pat.mean() >= 0.99, "support pattern diverged"
        m = pat & np.isfinite(x0)
        assert m.any()
        np.testing.assert_allclose(x1[m], x0[m], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# kernel 5: the double-float 4-block re-scan
# ---------------------------------------------------------------------------

def _tie_problem(rng, B, S, N1, N2, N3, N4):
    """The same winning column twice in A2 (indices 7 and 90), with an
    EAR component so that i4 is pinned."""
    A1 = np.float32(np.abs(rng.randn(B, S, N1)) + 0.05)
    A2 = np.float32(np.abs(rng.randn(B, S, N2)) + 0.05)
    A2[:, :, 90] = A2[:, :, 7]
    a3 = np.float32(np.abs(rng.randn(B, S, N3)) + 0.05)
    a4 = np.float32(np.abs(rng.randn(B, S, N4)) + 0.05)
    y = np.stack([0.7 * A1[b, :, 11] + 0.2 * A2[b, :, 7] + 0.1 * a4[b, :, 2]
                  for b in range(B)]).astype(np.float32)
    return A1, A2, a3, a4, y


def _uncorr_problem(rng, B, S, N1, N2, N3, N4):
    mk = lambda n: np.float32(np.abs(rng.randn(B, S, n)) + 0.05)
    return (mk(N1), mk(N2), mk(N3), mk(N4),
            np.float32(np.abs(rng.randn(B, S))))


@pytest.mark.parametrize("case,shape", [
    ("production", (2, 40, 72, 140, 1, 6)),
    ("duplicate column", (2, 40, 72, 140, 1, 6)),
    ("N3 = 2", (2, 24, 48, 48, 2, 3))])
def test_rescan4_matches_jax(rng, case, shape):
    """row_scan_df4 twin + candidates_from_rows_df4 vs JAX
    row_scan_df4(interpret=True) + candidates_from_rows_df4 on the three
    cases of tests/test_f32scan.py: the production N3 = 1 shape with
    column blocking, a duplicated winning column (the first in
    (i1, i2, i3, i4) order wins: i2 = 7), and N3 = 2. Same segment
    layout, top-1 (i1, i2, i3, i4) equal, values to rtol 1e-6 atol 1e-9.
    The duplicated-column signal is noiseless, so its residual is 0: the
    port's float64-summed cross products resolve it below 1e-9, the JAX
    package's float32 sums to ~5e-8, and each is held to its own bound."""
    B, S, N1, N2, N3, N4 = shape
    make = {"production": _corr_problem, "duplicate column": _tie_problem,
            "N3 = 2": _uncorr_problem}[case]
    args = make(rng, B, S, N1, N2, N3, N4)
    rr, ri, ysq = jpdf.row_scan_df4(*[jnp.asarray(x) for x in args],
                                    interpret=True)
    segs = jpdf.n_segments_df4(N2)
    assert trescan.n_segments_df4(N2) == segs
    cj, vj = jpdf.candidates_from_rows_df4(rr, ri, 1, N3 * N4, N4, N2,
                                           segments_total=segs)
    rrt, rit, ysqt = trescan.row_scan_df4(*[_t(x) for x in args])
    assert rrt.shape == tuple(rr.shape) and rit.shape == tuple(ri.shape)
    ct, vt = trescan.candidates_from_rows_df4(rrt, rit, N3 * N4, N4, N2,
                                              segments_total=segs)
    assert np.array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_allclose(ysqt.numpy(), np.asarray(ysq), rtol=1e-6)
    if case == "duplicate column":
        assert np.all(ct.numpy()[:, 0, 1] == 7)
        assert np.abs(vt.numpy()).max() <= 1e-9
        assert np.abs(np.asarray(vj)).max() <= 1e-7
    else:
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6,
                                   atol=1e-9)


def test_rescan4_on_kernel8_order_operands_matches_jax(rng, monkeypatch):
    """``rescan.row_scan_df4`` on operands summed as kernel 8 sums them
    (float64 cross products sample after sample,
    ``testing.fdot_sample_order``) against JAX row_scan_df4
    (interpret=True) on the production case's shape (its program is
    compiled once in this module): top-1 (i1, i2, i3, i4) equal, values
    to rtol 1e-6 atol 1e-9, as ``test_rescan4_matches_jax``."""
    B, S, N1, N2, N3, N4 = 2, 40, 72, 140, 1, 6
    args = _corr_problem(rng, B, S, N1, N2, N3, N4)
    rr, ri, _ysq = jpdf.row_scan_df4(*[jnp.asarray(x) for x in args],
                                     interpret=True)
    segs = jpdf.n_segments_df4(N2)
    cj, vj = jpdf.candidates_from_rows_df4(rr, ri, 1, N3 * N4, N4, N2,
                                           segments_total=segs)
    ops, segw, _yn = trescan.row_scan_df4_operands(*[_t(x) for x in args])
    monkeypatch.setattr(tdfscan, "fdot", ttesting.fdot_sample_order)
    ops_k, segw_k, _yn = trescan.row_scan_df4_operands(
        *[_t(x) for x in args])
    monkeypatch.undo()
    assert segw_k == segw
    rrt, rit = trescan.rescan4_rows(*ops_k, n2=N2, n3=N3, n4=N4, segw=segw)
    ct, vt = trescan.candidates_from_rows_df4(
        rrt.reshape(B, -1), rit.reshape(B, -1), N3 * N4, N4, N2,
        segments_total=segs)
    assert np.array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6,
                               atol=1e-9)


def test_candidates_from_rows_df4_tie_order():
    """Equal minima resolve to the smallest global flat rank
    i1 * (N2 * NS) + i2 * NS + s, whatever their segment; +inf everywhere
    gives the smallest rank among the +inf entries."""
    NS, N4, N2 = 4, 2, 10                          # n1p = 3, 2 segments
    res = torch.tensor([[5.0, 1.0, 1.0, 1.0, 7.0, 9.0]])
    flat = torch.tensor([[0, 30, 9, 2, 3, 4]], dtype=torch.int32)
    cand, vals = trescan.candidates_from_rows_df4(res, flat, NS, N4, N2, 2)
    # the 1.0 entries rank (row 1, 30), (row 2, 9), (row 0, 2) -> row 0
    assert vals.item() == 1.0
    assert cand.tolist() == [[[0, 0, 1, 0]]]
    cand, vals = trescan.candidates_from_rows_df4(
        torch.full((1, 6), np.inf), flat, NS, N4, N2, 2)
    assert cand.tolist() == [[[0, 0, 0, 0]]] and vals.item() == np.inf


# ---------------------------------------------------------------------------
# the EAR two-pass composition and the finalize
# ---------------------------------------------------------------------------

def test_df4_twopass_matches_jax(rng):
    """Port two-pass (kernel-path row pass, df4 re-scan) with column
    pruning (N2 = 140 > R = 64) vs JAX df4_twopass(fused=False) and the
    JAX one-pass df4_candidates (tests/test_f32scan.py's pruning cases):
    a random correlated signal, then planted pairs recovered through both
    pruned bands; ok equal, (i1, i2) index-exact, values to rtol 1e-5.
    Neither signal uses the EAR block at its optimum, so every ear atom
    ties: the port's exact sweeps tie exactly and keep the first, the
    JAX package's float32 cross sums split the tie by rounding; where the
    EAR slot differs the float64 objectives must tie."""
    B, S, N1, N2, N3, N4 = 2, 40, 72, 140, 1, 6
    A1, A2, a3, a4, y = _corr_problem(rng, B, S, N1, N2, N3, N4)
    i1s = rng.randint(0, N1, B)
    i2s = rng.randint(0, N2, B)
    yp = np.float32(np.stack([0.6 * A1[b, :, i1s[b]] + 0.3 * A2[b, :, i2s[b]]
                              + 0.1 * a3[b, :, 0] for b in range(B)]))
    for yy in (y, yp):
        ja = [jnp.asarray(x) for x in (A1, A2, a3, a4, yy)]
        cj, vj, _q, okj = jf32scan.df4_twopass(*ja, M=1, R=64, fused=False)
        c1, v1, _ = jdfscan.df4_candidates(*ja, M=1)
        ct, vt, _qt, okt = tf32scan.df4_twopass(
            *[_t(x) for x in (A1, A2, a3, a4, yy)], R=64)
        okt = okt.numpy()
        assert np.array_equal(np.asarray(okj), okt) and okt.all()
        ct, vt = ct.numpy(), vt.numpy()
        args = (A1, A2, a3, a4, yy)
        _same_or_tie(args, ct, np.asarray(cj))
        _same_or_tie(args, ct, np.asarray(c1))
        np.testing.assert_allclose(vt, np.asarray(v1), rtol=1e-5, atol=1e-7)
    assert np.array_equal(ct[:, 0, 0], i1s)
    assert np.array_equal(ct[:, 0, 1], i2s)


@pytest.mark.parametrize("C", [1, 2, 4])
def test_df_nnls_cols_matches_jax(rng, C):
    """df_nnls_cols with 1, 2 and 4 columns (the EAR finalize is C = 4)
    vs the JAX function on float32 columns: the same supports, weights
    to 1e-6 relative, residuals to 2e-9 ||y||^2."""
    B, S = 8, 40
    cols = np.float32(np.abs(rng.randn(B, S, C)) + 0.05)
    w0 = np.float32(rng.rand(B, C))
    w0[1, 0] = 0.0
    y = np.float32(np.einsum("bsc,bc->bs", cols, w0)
                   + 0.01 * rng.randn(B, S))
    y[2] = -y[2]                                   # all-zero weights
    wj, rj = jdfscan.df_nnls_cols(jnp.asarray(cols), jnp.asarray(y))
    wt, rt = tdfscan.df_nnls_cols(_t(cols), _t(y))
    wj, wt = np.asarray(wj), wt.numpy()
    assert np.array_equal(wt == 0, wj == 0) and np.all(wt >= 0)
    np.testing.assert_allclose(wt, wj, rtol=1e-6, atol=1e-6 * np.abs(wj).max())
    ysq = np.sum(y.astype(np.float64) ** 2, axis=1)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=2e-9 * ysq.max())


# ---------------------------------------------------------------------------
# kernels 1, 4 and 5 against their plain versions (on a card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_ear_kernels_match_plain_versions(rng):
    """On the card, by ``testing.kernel_agreement``: prep with 12 rhs
    columns on both block shapes, the EAR row pass (two column blocks)
    and the EAR re-scan against their plain versions, the re-scan's first
    flat index and the top-1 exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    agree = ttesting.kernel_agreement
    A1, A2, a3, a4, y = (_t(x).cuda() for x in
                         _corr_problem(rng, 2, 40, 160, 700, 1, 10))
    cols = [y / y.norm(dim=1, keepdim=True)] + [
        c / c.norm(dim=1, keepdim=True) for c in (a3[:, :, 0], *a4.unbind(2))]
    rq, rr, ra, _ = tprep.pack_rhs(cols)
    for A, tile, planes in ((A1, 128, "xr"), (A2, 512, "ra")):
        Ap = tprep.pad_block(A, tile)[0].contiguous()
        k = tprep.prep_block(Ap, rq, rr, ra, tile, planes, n_rhs=12)
        p = tprep.prep_block_twin(Ap, rq, rr, ra, tile, planes, n_rhs=12)
        for x1, x0 in zip(k, p):
            if x0 is not None:
                assert agree(x1, x0)[0], agree(x1, x0)
    ops, nr, _ = tf32scan.rowmin_4_operands(A1, A2, a3, a4, y)
    kw = dict(n1=160, n2=700, n3=1, n4=10, nr=nr)
    for x0, x1 in zip(tf32scan.rowmin4_twin(*ops, **kw),
                      tf32scan.rowmin4_rows(*ops, **kw)):
        assert agree(x1, x0)[0], agree(x1, x0)
    ops, segw, _ = trescan.row_scan_df4_operands(A1, A2, a3, a4, y)
    kw = dict(n2=700, n3=1, n4=10, segw=segw)
    rk, ik = trescan.rescan4_rows(*ops, **kw)
    rp, ip = trescan.rescan4_twin(*ops, **kw)
    assert agree(rk, rp)[0], agree(rk, rp)
    assert agree(ik, ip, exact=True)[0], agree(ik, ip, exact=True)
    seg = trescan.n_segments_df4(700)
    top = lambda r, i: trescan.candidates_from_rows_df4(
        r.reshape(2, -1), i.reshape(2, -1), 10, 10, 700, seg)[0]
    assert torch.equal(top(rk, ik), top(rp, ip))
