"""Kernel 7, the double-float finalize (``csrc/finalize.cu``), as far as
the CPU sees it.

``dfscan.df_nnls_cols`` launches the kernel on CUDA tensors and runs its
plain version, ``df_nnls_cols_twin``, on CPU tensors; so does the fit's
whole finalize stage, ``dfscan.finalize_top1`` (the winner's columns read
from the rotated blocks, the solve and R^2; plain version
``finalize_top1_plain``). Here: the port's function against the JAX
``df_nnls_cols`` on voxels built to reach every branch of the solver for
C = 1-4 (each support that can win, planted: both weights positive, each
one clipped, the 3-column Cramer support and its fallbacks, all 15
supports of 4 columns, the empty one), and on columns whose largest
|value| sits one float32 ulp above or below a power of two (the scale
exp2(ceil(log2(m))) there); ``finalize_top1``'s plain version against
the JAX ``_finalize_top1`` on the five fast-path buckets; the kernel's
choice among the 4-column supports (a butterfly over the lanes,
``testing.df_lanes_first_min``) against ``_df_nnls4``'s sequential fold,
exact ties planted; the dispatch on CPU tensors. The ``cuda`` tests hold
the kernel against its plain versions on a card, the scale cases and the
gathered form bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.models import fit as jfit
from microstructure_fingerprinting_tpu.ops import dfscan as jdfscan

from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.models import fit as tfit
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import kernels

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _planted(rng, C, reps=3, S=40):
    """Voxels whose NNLS support is planted: for every non-empty support
    (mask 1 .. 2^C - 1) ``reps`` voxels y = cols @ w + 0.01 noise with
    w > 0.5 on the support and -0.3 off it, then ``reps`` voxels of -y
    (the empty support). Returns (cols, y, planted masks)."""
    masks = np.repeat(np.arange(1, 2 ** C), reps)
    B = masks.size + reps
    cols = np.abs(rng.randn(B, S, C)) + 0.05
    w = np.where((masks[:, None] >> np.arange(C)) & 1,
                 rng.rand(masks.size, C) + 0.5, -0.3)
    y = np.einsum("bsc,bc->bs", cols[:masks.size], w)
    y = np.concatenate([y, -np.abs(y[:reps])]) + 0.01 * rng.randn(B, S)
    return (np.float32(cols), np.float32(y),
            np.concatenate([masks, np.zeros(reps, int)]))


def _scale_edges(rng, C, S=40):
    """Voxels whose largest |column| and |y| are 2^k (1 + 2^-23) and
    2^k (1 - 2^-23) (float32 neighbours of 2^k), k in -6, -1, 0, 3, 10:
    where log2 of a float32 can round onto the integer k."""
    out_c, out_y = [], []
    for k in (-6, -1, 0, 3, 10):
        for u in (1 + 2.0 ** -23, 1 - 2.0 ** -23):
            top = np.float32(2.0 ** k * u)
            cols = np.float32(rng.rand(S, C) * 0.9 * top)
            y = np.float32(cols @ (rng.rand(C) + 0.2))
            y = np.float32(y / np.abs(y).max() * top)
            cols[rng.randint(S, size=C), np.arange(C)] = top
            out_c.append(cols)
            out_y.append(y)
    return np.stack(out_c), np.stack(out_y)


def _support(w):
    return (w > 0).astype(int) @ (1 << np.arange(w.shape[1]))


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_planted_supports_match_jax(rng, C):
    """Every support that can win does win where it was planted, and the
    port's df_nnls_cols equals the JAX function there: the same supports
    (zero pattern), weights to 1e-6 relative, residuals to 2e-9 ||y||^2
    (``tests/test_torch_ear_kernels.py``'s tolerances)."""
    cols, y, masks = _planted(rng, C)
    wt, rt = tdfscan.df_nnls_cols(_t(cols), _t(y))
    wj, rj = jdfscan.df_nnls_cols(jnp.asarray(cols), jnp.asarray(y))
    wt, wj = wt.numpy(), np.asarray(wj)
    assert np.array_equal(_support(wt), masks)
    assert np.array_equal(wt == 0, wj == 0) and np.all(wt >= 0)
    np.testing.assert_allclose(wt, wj, rtol=1e-6,
                               atol=1e-6 * np.abs(wj).max())
    ysq = np.sum(y.astype(np.float64) ** 2, axis=1)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=2e-9 * ysq.max())


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_scale_at_powers_of_two_matches_jax(rng, C):
    """Largest values one ulp above and below powers of two: the port's
    weights and residuals against the JAX function's, as above."""
    cols, y = _scale_edges(rng, C)
    wt, rt = tdfscan.df_nnls_cols(_t(cols), _t(y))
    wj, rj = jdfscan.df_nnls_cols(jnp.asarray(cols), jnp.asarray(y))
    wt, wj = wt.numpy(), np.asarray(wj)
    assert np.array_equal(wt == 0, wj == 0)
    np.testing.assert_allclose(wt, wj, rtol=1e-6,
                               atol=1e-6 * np.abs(wj).max())
    ysq = np.sum(y.astype(np.float64) ** 2, axis=1)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=2e-9 * ysq.max())


def test_cpu_dispatch_runs_the_plain_version(rng):
    """On CPU tensors df_nnls_cols is df_nnls_cols_twin, bit for bit, and
    launches nothing; more than 4 columns raise."""
    cols, y, _m = _planted(rng, 3)
    kernels.reset_counts()
    w0, r0 = tdfscan.df_nnls_cols(_t(cols), _t(y))
    w1, r1 = tdfscan.df_nnls_cols_twin(_t(cols), _t(y))
    assert torch.equal(w0.view(torch.int32), w1.view(torch.int32))
    assert torch.equal(r0.view(torch.int32), r1.view(torch.int32))
    assert kernels.LAUNCHES["finalize"] == 0
    with pytest.raises(ValueError):
        tdfscan.df_nnls_cols(_t(np.zeros((2, 8, 5), np.float32)),
                             _t(np.zeros((2, 8), np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_cuda_finalize_matches_plain_version(rng, C):
    """On the card: the planted voxels by ``testing.kernel_agreement``
    (the float64 sums of the Gram take another order than cuBLAS's), the
    scale cases bit for bit (a scale that parted from torch's log2 on the
    card would move their last bits); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cols, y, _m = _planted(rng, C)
    cuda = lambda x: _t(x).cuda()
    kernels.reset_counts()
    wk, rk = tdfscan.df_nnls_cols(cuda(cols), cuda(y))
    assert kernels.LAUNCHES["finalize"] == 1
    wp, rp = tdfscan.df_nnls_cols_twin(cuda(cols), cuda(y))
    assert ttesting.kernel_agreement(wk, wp)[0]
    assert ttesting.kernel_agreement(rk, rp)[0]
    cols, y = _scale_edges(rng, C)
    wk, rk = tdfscan.df_nnls_cols(cuda(cols), cuda(y))
    wp, rp = tdfscan.df_nnls_cols_twin(cuda(cols), cuda(y))
    assert ttesting.kernel_agreement(wk, wp, exact=True)[0]
    assert ttesting.kernel_agreement(rk, rp, exact=True)[0]


#: the fast path's buckets (K fascicles, CSF, EAR): the (1, CSF) and
#: (2, no CSF) df2 scans, the flagship, the EAR two-pass, (1, CSF, EAR)
FAST = [(1, True, False), (2, False, False), (2, True, False),
        (2, True, True), (1, True, True)]
#: kernel 7's R^2 against the plain version's: the same float64 values
#: summed in another order
R2_TOL = 1e-12


def _winners(rng, K, csf, ear, B=12, S=40, N=10, E=5):
    """Rotated blocks D (B, K, S, N), the CSF signature (S,), the EAR
    signatures (S, E), winners cand (B, K [+ 1]) (the EAR atom last) and
    signals on them: positive weights, 0.01 noise, one voxel negated (its
    empty support wins)."""
    D = np.float32(np.abs(rng.randn(B, K, S, N)) + 0.05)
    sig_csf = np.float32(np.abs(rng.randn(S)) + 0.1)
    sig_ear = np.float32(np.abs(rng.randn(S, E)) + 0.1)
    ids = rng.randint(0, N, size=(B, K))
    e = rng.randint(0, E, size=B)
    y = sum((rng.rand(B, 1) + 0.2) * D[np.arange(B), k][np.arange(B), :,
                                                        ids[:, k]]
            for k in range(K))
    if csf:
        y = y + 0.5 * sig_csf
    if ear:
        y = y + 0.3 * sig_ear[:, e].T
    y = np.float32(y + 0.01 * rng.randn(B, S))
    y[3] = -y[3]
    cand = np.concatenate([ids] + ([e[:, None]] if ear else []), axis=1)
    return D, sig_csf, sig_ear, y, cand.astype(np.int32)


@pytest.mark.parametrize("K, csf, ear", FAST)
def test_finalize_top1_matches_jax(rng, K, csf, ear):
    """``finalize_top1_plain`` (what ``fit._finalize_top1`` runs on CPU
    tensors) against the JAX ``_finalize_top1`` on the five fast-path
    buckets, on the same float32 inputs: the same supports, weights to
    1e-6 relative, residuals to 2e-9 ||y||^2 (this file's tolerances),
    R^2 to 1e-5 (the JAX function sums it in float32). The port's R^2 is
    float64: to R2_TOL it is the JAX ``_r_squared`` in float64 on the
    winner's columns and the port's weights."""
    D, sig_csf, sig_ear, y, cand = _winners(rng, K, csf, ear)
    wt, rt, r2t = tdfscan.finalize_top1_plain(
        _t(D), _t(sig_csf), _t(sig_ear), _t(y), _t(cand), csf, ear, K)
    wj, rj, r2j = jfit._finalize_top1(
        *(jnp.asarray(x) for x in (D, sig_csf, sig_ear, y, cand)),
        csf_on=csf, ear_on=ear, K=K)
    B = y.shape[0]
    cols = [D[np.arange(B), k][np.arange(B), :, cand[:, k]]
            for k in range(K)]
    if csf:
        cols.append(np.broadcast_to(sig_csf, y.shape))
    if ear:
        cols.append(sig_ear[:, cand[:, -1]].T)
    y_rec = np.einsum("cbs,bc->bs", np.float64(cols), np.float64(wt.numpy()))
    r2_64 = np.asarray(jfit._r_squared(jnp.asarray(np.float64(y)),
                                       jnp.asarray(y_rec)))
    assert r2t.dtype == torch.float64
    np.testing.assert_allclose(r2t.numpy(), r2_64, rtol=0, atol=R2_TOL)
    np.testing.assert_allclose(r2t.numpy(), np.asarray(r2j), rtol=0,
                               atol=1e-5)
    wt, wj = wt.numpy(), np.asarray(wj)
    assert wt.shape == (y.shape[0], K + csf + ear)
    assert np.array_equal(wt == 0, wj == 0) and np.all(wt >= 0)
    assert (wt == 0).all(axis=1)[3]
    np.testing.assert_allclose(wt, wj, rtol=1e-6,
                               atol=1e-6 * np.abs(wj).max())
    ysq = np.sum(y.astype(np.float64) ** 2, axis=1)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=2e-9 * ysq.max())


def _fold(hi, lo):
    """``_df_nnls4``'s rule on a table of residuals: from slot 0 (y'y),
    the first slot strictly less under ``_df_lt`` than the best so far."""
    out = np.zeros(hi.shape[0], np.int64)
    for b in range(hi.shape[0]):
        best = 0
        for m in range(1, 16):
            if hi[b, m] < hi[b, best] or (hi[b, m] == hi[b, best]
                                          and lo[b, m] < lo[b, best]):
                best = m
        out[b] = best
    return out


def test_lane_reduction_is_the_fold(rng):
    """The butterfly that picks kernel 7's 4-column support equals the
    sequential fold on tables of residuals drawn from a few values (exact
    ties in hi and in lo everywhere, equal values at +0 and -0),
    infeasible supports (inf, 0), the empty support winning, and y'y of NaN
    (nothing improves on it) or with a NaN lo."""
    B = 4000
    hi = np.float32(rng.choice([0.25, 0.5, 0.5, 1.0, 2.0, np.inf],
                               size=(B, 16)))
    lo = np.float32(rng.choice([-1e-9, -0.0, 0.0, 1e-9], size=(B, 16)))
    lo[np.isinf(hi)] = 0.0
    hi[:200, 0] = 0.1                       # the empty support wins
    hi[200:300, 1:] = np.inf                # nothing feasible
    hi[300:400, 0] = np.nan                 # y'y of a NaN signal
    lo[400:500, 0] = np.nan
    got = ttesting.df_lanes_first_min(_t(hi), _t(lo)).numpy()
    want = _fold(hi, lo)
    assert np.array_equal(got, want)
    ties = [(hi[b] == hi[b, want[b]]) & (lo[b] == lo[b, want[b]])
            for b in range(B)]
    assert sum(t.sum() > 1 for t in ties) > B // 10
    assert (want == 0).sum() >= 300 and (want > 0).sum() > B // 2


def test_lane_reduction_picks_df_nnls4s_winner(rng):
    """On planted 4-column voxels, with duplicated columns (supports that
    tie exactly) and voxels whose empty support wins, the butterfly's pick
    among ``_df_nnls4_supports`` (the supports kernel 7 solves a lane
    each) is ``_df_nnls4``'s result, weights and residual bit for bit."""
    cols, y, _m = _planted(rng, 4)
    dup = cols.copy()
    dup[:, :, 1] = dup[:, :, 0]
    dup[:, :, 3] = dup[:, :, 2]
    cols, y = np.concatenate([cols, dup]), np.concatenate([y, y])
    G, p, w_y, _sc, _sy = tdfscan._df_system(_t(cols), _t(y))
    sup = tdfscan._df_nnls4_supports(w_y, G, p)
    hi = torch.stack([w_y[0]] + [r[0] for _w, r in sup], dim=1)
    lo = torch.stack([w_y[1]] + [r[1] for _w, r in sup], dim=1)
    win = ttesting.df_lanes_first_min(hi, lo)
    zero = torch.zeros_like(w_y[0])
    ws = [[(zero, zero)] * 4] + [w for w, _r in sup]
    w_want, r_want = tdfscan._df_nnls4(w_y, G, p)
    bits = lambda x: x.contiguous().view(torch.int32)
    for b in range(len(y)):
        m = int(win[b])
        assert bits(hi[b, m]) == bits(r_want[0][b])
        assert bits(lo[b, m]) == bits(r_want[1][b])
        for i in range(4):
            assert bits(ws[m][i][0][b]) == bits(w_want[i][0][b])
            assert bits(ws[m][i][1][b]) == bits(w_want[i][1][b])
    tied = [int(((hi[b] == hi[b, win[b]]) & (lo[b] == lo[b, win[b]])).sum())
            for b in range(len(y))]
    assert max(tied) > 1 and (win == 0).any()


def test_finalize_top1_cpu_dispatch(rng):
    """On CPU tensors ``finalize_top1`` (and ``fit._finalize_top1``) is
    ``finalize_top1_plain`` bit for bit and launches nothing; a CPU D with
    a CUDA-bound call is refused before any launch (the wrapper checks its
    shapes)."""
    D, sig_csf, sig_ear, y, cand = (_t(x) for x in _winners(rng, 2, True,
                                                            True))
    kernels.reset_counts()
    a = tdfscan.finalize_top1(D, sig_csf, sig_ear, y, cand, True, True, 2)
    b = tdfscan.finalize_top1_plain(D, sig_csf, sig_ear, y, cand, True, True,
                                    2)
    c = tfit._finalize_top1(D, sig_csf, sig_ear, y, cand, True, True, 2)
    for x, u, v in zip(a, b, c):
        assert torch.equal(x, u) and torch.equal(x, v)
    assert kernels.LAUNCHES["finalize"] == 0
    with pytest.raises(ValueError, match="1 to 4 columns"):
        tdfscan._finalize_top1_cuda(D, sig_csf, sig_ear, y, cand, True, True,
                                    3)
    with pytest.raises(ValueError, match="cand must be"):
        tdfscan._finalize_top1_cuda(D, sig_csf, sig_ear, y, cand[:, :2],
                                    True, True, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("K, csf, ear", FAST)
def test_cuda_finalize_top1_matches_plain_version(rng, K, csf, ear):
    """On the card: ``finalize_top1`` is one launch of kernel 7, its
    weights and residuals bit for bit the plain version's, R^2 within
    R2_TOL; a winner tensor that is a strided slice (as the fit passes
    ``cand[:, 0]``) gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [_t(x).cuda() for x in _winners(rng, K, csf, ear, B=37, S=75,
                                            N=20)]
    kernels.reset_counts()
    wk, rk, r2k = tdfscan.finalize_top1(*args, csf, ear, K)
    assert kernels.LAUNCHES["finalize"] == 1
    wp, rp, r2p = tdfscan.finalize_top1_plain(*args, csf, ear, K)
    assert ttesting.kernel_agreement(wk, wp, exact=True)[0]
    assert ttesting.kernel_agreement(rk, rp, exact=True)[0]
    assert float((r2k - r2p).abs().max()) <= R2_TOL
    cand = args[4].long()
    args[4] = torch.stack([cand, cand], dim=1)[:, 0]
    w2, r2, q2 = tdfscan.finalize_top1(*args, csf, ear, K)
    assert torch.equal(w2, wk) and torch.equal(r2, rk)
    assert torch.equal(q2, r2k)
