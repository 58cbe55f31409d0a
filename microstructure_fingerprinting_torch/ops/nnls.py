"""Column normalization helpers of the exhaustive-NNLS scans.

PyTorch counterpart of ``_pad_cols``, ``_normalize_block`` and
``_normalize_y`` in ``microstructure_fingerprinting_tpu/ops/nnls.py``.

On unit-normalized atoms and signal every Gram entry is an O(1)
correlation with a unit diagonal, so the float32 scans work at eps-level
absolute error; weights and objectives are rescaled on the way out.
Squared norms are accumulated in float64 and rounded once to float32:
the result then does not depend on the reduction order, so the CPU and
the GPU agree bit for bit (the JAX float32 reduction can differ from it
by ~1 ulp of the norm).
"""

import math

import torch
import torch.nn.functional as F


def sumsq_f32(x, dim):
    """Sum of squares along ``dim``, accumulated in float64, rounded once
    to float32."""
    x64 = x.double()
    return (x64 * x64).sum(dim=dim).float()


def sqrt_f32(x):
    """Correctly rounded float32 square root (PyTorch's CPU float32 sqrt
    is off by 1 ulp for ~1% of inputs; the float64 one, rounded, is
    exact — as the CUDA kernels' __fsqrt_rn)."""
    return torch.sqrt(x.double()).float()


def _pad_cols(A, mult):
    """Pad the trailing (atom) axis of (B, S, N) to a multiple of
    ``mult`` with zero columns. Returns (A_padded, N)."""
    N = A.shape[-1]
    Np = int(math.ceil(N / mult) * mult)
    if Np == N:
        return A, N
    return F.pad(A, (0, Np - N)), N


def _normalize_block(A):
    """Scale each atom column of (B, S, N) to unit l2 norm.
    Returns (A_hat, norms (B, N)); zero columns keep norm 1."""
    an = sqrt_f32(sumsq_f32(A, 1))
    an_safe = torch.where(an > 0, an, torch.ones_like(an))
    return A / an_safe[:, None, :], an_safe


def _normalize_y(y):
    """Unit-normalize (B, S) signals. Returns (y_hat, norm, safe norm)."""
    yn = sqrt_f32(sumsq_f32(y, 1))
    yn_safe = torch.where(yn > 0, yn, torch.ones_like(yn))
    return y / yn_safe[:, None], yn, yn_safe
