"""Column normalization helpers of the exhaustive-NNLS scans, their
top-M candidate pools, and the closed-form float64 host solvers of the
fascicle-free buckets.

PyTorch counterpart of ``_pad_cols``, ``_normalize_block``,
``_normalize_y``, ``_tile_topm``, ``_merge_topm``, ``lsqnonneg_1var`` and
``lsqnonneg_2var`` in ``microstructure_fingerprinting_tpu/ops/nnls.py``
(the two solvers in their NumPy form, bit for bit).

On unit-normalized atoms and signal every Gram entry is an O(1)
correlation with a unit diagonal, so the float32 scans work at eps-level
absolute error; weights and objectives are rescaled on the way out.
Squared norms are accumulated in float64 and rounded once to float32:
the result then does not depend on the reduction order, so the CPU and
the GPU agree bit for bit (the JAX float32 reduction can differ from it
by ~1 ulp of the norm).
"""

import math

import numpy as np
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


# ---------------------------------------------------------------------------
# Top-M candidate pools, in the JAX package's order
# ---------------------------------------------------------------------------

def _total_order_key(x):
    """int32 keys of float32 values in IEEE total order: -NaN < -inf <
    ... < -0 < +0 < ... < inf < +NaN (the order ``lax.top_k`` ranks by on
    the CPU)."""
    i = x.float().contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def _tile_topm(res_flat, gflat, M):
    """The M smallest residuals of each row of (B, L) ``res_flat`` and
    their ``gflat`` ranks, as ``lax.top_k(-res_flat, M)`` picks them: by
    total order (a NaN with its sign bit set first, one without last),
    ties to the lowest position. Returns (vals (B, M), flats (B, M)
    int32)."""
    key = _total_order_key(res_flat)
    if M == 1:
        idx = torch.argmin(key, dim=1, keepdim=True)   # first minimum
    else:
        idx = torch.sort(key, dim=1, stable=True)[1][:, :M]
    return (torch.gather(res_flat, 1, idx),
            torch.gather(gflat.expand(res_flat.shape[0], -1), 1,
                         idx).to(torch.int32))


def _merge_topm(vals, flats, tile_vals, tile_flats, M):
    """Merge a running top-M pool with a tile's, as the JAX package's
    ``lexsort((flats, vals))``: by residual with every NaN last (of either
    sign, and equal among themselves), ties to the lowest flat rank."""
    allv = torch.cat([vals, tile_vals], dim=1)
    allf = torch.cat([flats.to(torch.int32), tile_flats.to(torch.int32)],
                     dim=1)
    order = torch.sort(allf, dim=1, stable=True)[1]
    for key in (lambda v: torch.where(torch.isnan(v), math.inf, v),
                torch.isnan):
        k = key(torch.gather(allv, 1, order)).float()
        order = torch.gather(order, 1, torch.sort(k, dim=1, stable=True)[1])
    order = order[:, :M]
    return torch.gather(allv, 1, order), torch.gather(allf, 1, order)


# ---------------------------------------------------------------------------
# Closed-form float64 host solvers (NumPy; the fascicle-free buckets)
# ---------------------------------------------------------------------------

def lsqnonneg_1var(y_sq, a_sq, a_y):
    """1-variable NNLS from precomputed scalars: w = max(a'y, 0) / a'a.
    Returns (w, res); every argument broadcasts elementwise."""
    pos = a_y >= 0
    w = np.where(pos, a_y / a_sq, 0.0)
    res = np.where(pos, y_sq - w * a_y, y_sq)
    return w, res


def lsqnonneg_2var(y_sq, A11, A12, A22, Y1, Y2):
    """2-variable NNLS from precomputed Gram scalars: the reference's
    sign-case analysis with its ``elif`` priority, branchless. Returns
    (w1, w2, res) with NaN residuals (degenerate Grams) set to +inf."""
    w1D = np.asarray(A22 * Y1 - A12 * Y2)
    w2D = np.asarray(A11 * Y2 - A12 * Y1)
    Det = A11 * A22 - A12 * A12
    w1_full = w1D / Det
    w2_full = w2D / Det
    res_full = (y_sq + w1_full * w1_full * A11 + w2_full * w2_full * A22
                + 2 * (w1_full * w2_full * A12 - w1_full * Y1
                       - w2_full * Y2))
    w1_only = Y1 / A11
    res1_only = y_sq - Y1 * w1_only
    w2_only = Y2 / A22
    res2_only = y_sq - Y2 * w2_only

    case1 = (w1D > 0) & (w2D > 0)
    case2 = ~case1 & (w1D >= 0) & (w2D <= 0)
    case3 = ~case1 & ~case2 & (w1D <= 0) & (w2D >= 0)
    case4 = ~case1 & ~case2 & ~case3 & (w1D < 0) & (w2D < 0)
    take1 = (case2 & (Y1 >= 0)) | (case4 & (Y1 > 0))
    take2 = (case3 & (Y2 >= 0)) | (case4 & (Y1 <= 0) & (Y2 > 0))

    w1 = np.where(case1, w1_full, np.where(take1, w1_only, 0.0))
    w2 = np.where(case1, w2_full, np.where(take2, w2_only, 0.0))
    res = np.where(case1, res_full,
                   np.where(take1, res1_only,
                            np.where(take2, res2_only, y_sq)))
    return w1, w2, np.where(np.isnan(res), np.inf, res)
