"""Kernel 7, the double-float finalize (``csrc/finalize.cu``), as far as
the CPU sees it.

``dfscan.df_nnls_cols`` launches the kernel on CUDA tensors and runs its
plain version, ``df_nnls_cols_twin``, on CPU tensors. Here: the port's
function against the JAX ``df_nnls_cols`` on voxels built to reach every
branch of the solver for C = 1-4 (each support that can win, planted:
both weights positive, each one clipped, the 3-column Cramer support and
its fallbacks, all 15 supports of 4 columns, the empty one), and on
columns whose largest |value| sits one float32 ulp above or below a power
of two (the scale exp2(ceil(log2(m))) there); the dispatch on CPU
tensors. The ``cuda`` test holds the kernel against its plain version on
a card, the scale cases bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.ops import dfscan as jdfscan

from microstructure_fingerprinting_torch import testing as ttesting
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
