"""Exhaustive combinatorial NNLS: column normalization, the top-M
candidate pools, the closed-form small solvers and the batched scans of
1-4 sub-dictionaries (the general path).

PyTorch counterpart of ``microstructure_fingerprinting_tpu/ops/nnls.py``
up to ``exhaustive_nnls_blocks``: ``_pad_cols``, ``_normalize_block``,
``_normalize_y``, ``_tile_topm``, ``_merge_topm``, ``_sanitize``,
``lsqnonneg_{1,2,3,4}var``, ``_solve_posdef_cramer``, the 4-block sweep
(``_sub1_res``, ``_sub2_res``, ``_nnls4_sweep_res``, ``_det_tol``,
``_scan4_grid``), ``exhaustive_{1,2,3,4}_batched``,
``exhaustive_{2,3,4}_candidates``, ``exhaustive_candidates_blocks`` and
``exhaustive_nnls_blocks``, and the reference-compatible single-problem
API after it (``solve_exhaustive_posweights`` and its family,
``lsqnonneg_2var_opt``, ``nnls_underdetermined``: NumPy in and out,
float64 on the host, as in the JAX package). The closed-form solvers
have one body over an array module: NumPy (bit for bit the JAX
package's ``xp=np`` form) or ``TORCH``.

On unit-normalized atoms and signal every Gram entry is an O(1)
correlation with a unit diagonal, so the float32 scans work at eps-level
absolute error; weights and objectives are rescaled on the way out.
Squared norms are accumulated in float64 and rounded once to float32:
the result then does not depend on the reduction order, so the CPU and
the GPU agree bit for bit (the JAX float32 reduction can differ from it
by ~1 ulp of the norm).
"""

import math
import warnings
from itertools import islice

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


def _norm(x, dim):
    """l2 norm along ``dim``: in float64 for float64 ``x`` (the x64
    route), else by ``sumsq_f32`` and ``sqrt_f32``."""
    if x.dtype == torch.float64:
        return torch.sqrt(torch.sum(x * x, dim=dim))
    return sqrt_f32(sumsq_f32(x, dim))


def _normalize_block(A):
    """Scale each atom column of (B, S, N) to unit l2 norm.
    Returns (A_hat, norms (B, N)); zero columns keep norm 1."""
    an = _norm(A, 1)
    an_safe = torch.where(an > 0, an, torch.ones_like(an))
    return A / an_safe[:, None, :], an_safe


def _normalize_y(y):
    """Unit-normalize (B, S) signals. Returns (y_hat, norm, safe norm)."""
    yn = _norm(y, 1)
    yn_safe = torch.where(yn > 0, yn, torch.ones_like(yn))
    return y / yn_safe[:, None], yn, yn_safe


# ---------------------------------------------------------------------------
# Top-M candidate pools, in the JAX package's order
# ---------------------------------------------------------------------------

def _total_order_key(x):
    """Integer keys of float values in IEEE total order: -NaN < -inf <
    ... < -0 < +0 < ... < inf < +NaN (the order ``lax.top_k`` ranks by on
    the CPU): int64 keys of float64 values, int32 keys of the rest
    (rounded to float32)."""
    if x.dtype == torch.float64:
        i = x.contiguous().view(torch.int64)
        return torch.where(i < 0, i ^ 0x7FFFFFFFFFFFFFFF, i)
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
        k = key(torch.gather(allv, 1, order)).to(allv.dtype)
        order = torch.gather(order, 1, torch.sort(k, dim=1, stable=True)[1])
    order = order[:, :M]
    return torch.gather(allv, 1, order), torch.gather(allf, 1, order)


# ---------------------------------------------------------------------------
# Closed-form small NNLS subproblems (branchless, elementwise)
# ---------------------------------------------------------------------------
#
# One body per solver, over an array module ``xp``: NumPy (the default;
# the float64 host refine and the fascicle-free closed forms) or
# ``TORCH`` (the device scans). The bodies are the JAX package's,
# operation for operation, so the NumPy form equals its ``xp=np`` form
# bit for bit.

# Tolerance of the Cramer sign tests in the 3-variable solver
# (reference mf_utils.py:480-482)
_EPS = 2.2204e-16
_TOL3 = 100 * _EPS

_TILE_N1 = 128  # candidate-grid tile along the first sub-dictionary axis


class _TorchNS:
    """The NumPy names the solvers use, for torch tensors."""
    inf = math.inf
    isnan = staticmethod(torch.isnan)
    isfinite = staticmethod(torch.isfinite)
    where = staticmethod(torch.where)
    zeros_like = staticmethod(torch.zeros_like)
    asarray = staticmethod(torch.as_tensor)

    @staticmethod
    def minimum(a, b):
        if torch.is_tensor(b):
            return torch.minimum(a, b)
        return torch.clamp(a, max=b)

    @staticmethod
    def full_like(a, value, dtype=None):
        return torch.full_like(a, value,
                               dtype=torch.bool if dtype is bool else dtype)


#: the array module of the device scans
TORCH = _TorchNS()


def _sanitize(res, xp=np):
    """NaN residuals (degenerate Gram) never win the argmin, matching the
    reference where `nan < min_obj` is always False."""
    return xp.where(xp.isnan(res), xp.inf, res)


def lsqnonneg_1var(y_sq, a_sq, a_y, xp=np):
    """1-variable NNLS from precomputed scalars: w = max(a'y, 0) / a'a.
    Returns (w, res); every argument broadcasts elementwise."""
    pos = a_y >= 0
    w = xp.where(pos, a_y / a_sq, 0.0)
    res = xp.where(pos, y_sq - w * a_y, y_sq)
    return w, res


def lsqnonneg_2var(y_sq, A11, A12, A22, Y1, Y2, xp=np):
    """2-variable NNLS from precomputed Gram scalars: the reference's
    sign-case analysis with its ``elif`` priority, branchless. Returns
    (w1, w2, res) with NaN residuals (degenerate Grams) set to +inf."""
    w1D = xp.asarray(A22 * Y1 - A12 * Y2)
    w2D = xp.asarray(A11 * Y2 - A12 * Y1)

    # full-support (relaxed) solution
    Det = A11 * A22 - A12 * A12
    w1_full = w1D / Det
    w2_full = w2D / Det
    res_full = (y_sq + w1_full * w1_full * A11 + w2_full * w2_full * A22
                + 2 * (w1_full * w2_full * A12 - w1_full * Y1
                       - w2_full * Y2))

    # single-column candidates
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

    w1 = xp.where(case1, w1_full, xp.where(take1, w1_only, 0.0))
    w2 = xp.where(case1, w2_full, xp.where(take2, w2_only, 0.0))
    res = xp.where(case1, res_full,
                   xp.where(take1, res1_only,
                            xp.where(take2, res2_only, y_sq)))
    return w1, w2, _sanitize(res, xp)


def lsqnonneg_3var(y_sq, A11, A22, A33, A12, A13, A23, Y1, Y2, Y3, xp=np):
    """3-variable NNLS via Cramer + 2-variable fallback chain (reference
    mf_utils.py:548-593): the full-support solution when the three
    Cramer determinants are >= -_TOL3, else the best of the three
    2-column subproblems, first strictly better in the order (12), (13),
    (23). Returns (w1, w2, w3, res)."""
    D1 = (Y1 * (A22 * A33 - A23 * A23) - Y2 * (A12 * A33 - A23 * A13)
          + Y3 * (A12 * A23 - A22 * A13))
    D2 = (-Y1 * (A12 * A33 - A13 * A23) + Y2 * (A11 * A33 - A13 * A13)
          - Y3 * (A11 * A23 - A12 * A13))
    D3 = (Y1 * (A12 * A23 - A13 * A22) - Y2 * (A11 * A23 - A12 * A13)
          + Y3 * (A11 * A22 - A12 * A12))
    full = (D1 >= -_TOL3) & (D2 >= -_TOL3) & (D3 >= -_TOL3)

    D = (A11 * (A22 * A33 - A23 * A23)
         - A12 * (A12 * A33 - A23 * A13)
         + A13 * (A12 * A23 - A22 * A13))
    w1f, w2f, w3f = D1 / D, D2 / D, D3 / D
    res_f = (y_sq
             + w1f * w1f * A11 + w2f * w2f * A22 + w3f * w3f * A33
             + 2 * (w1f * w2f * A12 + w1f * w3f * A13 + w2f * w3f * A23
                    - w1f * Y1 - w2f * Y2 - w3f * Y3))

    w12a, w12b, r12 = lsqnonneg_2var(y_sq, A11, A12, A22, Y1, Y2, xp)
    w13a, w13b, r13 = lsqnonneg_2var(y_sq, A11, A13, A33, Y1, Y3, xp)
    w23a, w23b, r23 = lsqnonneg_2var(y_sq, A22, A23, A33, Y2, Y3, xp)

    # fallback chain: start with (12); (13) wins if strictly better; then (23)
    fb_w1, fb_w2, fb_w3, fb_r = w12a, w12b, xp.zeros_like(w12a), r12
    take13 = r13 < fb_r
    fb_w1 = xp.where(take13, w13a, fb_w1)
    fb_w2 = xp.where(take13, 0.0, fb_w2)
    fb_w3 = xp.where(take13, w13b, fb_w3)
    fb_r = xp.where(take13, r13, fb_r)
    take23 = r23 < fb_r
    fb_w1 = xp.where(take23, 0.0, fb_w1)
    fb_w2 = xp.where(take23, w23a, fb_w2)
    fb_w3 = xp.where(take23, w23b, fb_w3)
    fb_r = xp.where(take23, r23, fb_r)

    w1 = xp.where(full, w1f, fb_w1)
    w2 = xp.where(full, w2f, fb_w2)
    w3 = xp.where(full, w3f, fb_w3)
    res = xp.where(full, _sanitize(res_f, xp), fb_r)
    return w1, w2, w3, res


def _solve_posdef_cramer(G_rows, Y):
    """Solve a k x k symmetric system by explicit Cramer (k <= 4).

    ``G_rows``: tuple of k tuples of scalars (broadcastable arrays);
    ``Y``: tuple of k scalars. Returns (w tuple, det).
    """
    k = len(Y)
    if k == 1:
        return (Y[0] / G_rows[0][0],), G_rows[0][0]
    if k == 2:
        det = G_rows[0][0] * G_rows[1][1] - G_rows[0][1] * G_rows[1][0]
        w1 = (Y[0] * G_rows[1][1] - G_rows[0][1] * Y[1]) / det
        w2 = (G_rows[0][0] * Y[1] - Y[0] * G_rows[1][0]) / det
        return (w1, w2), det

    def det3(m):
        return (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
                - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
                + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))

    if k == 3:
        det = det3(G_rows)
        ws = []
        for j in range(3):
            mj = [[(Y[r] if c == j else G_rows[r][c]) for c in range(3)]
                  for r in range(3)]
            ws.append(det3(mj) / det)
        return tuple(ws), det

    def det4(m):
        total = 0.0
        for c in range(4):
            minor = [[m[r][cc] for cc in range(4) if cc != c]
                     for r in range(1, 4)]
            term = m[0][c] * det3(minor)
            total = total + (term if c % 2 == 0 else -term)
        return total

    det = det4(G_rows)
    ws = []
    for j in range(4):
        mj = [[(Y[r] if c == j else G_rows[r][c]) for c in range(4)]
              for r in range(4)]
        ws.append(det4(mj) / det)
    return tuple(ws), det


def lsqnonneg_4var(y_sq, G, Y, xp=np):
    """4-variable NNLS by exhaustive support enumeration (15 supports).

    ``G``: 4 x 4 nested tuple of Gram scalars (broadcastable arrays),
    ``Y``: tuple of 4 correlation scalars. Each support's unconstrained
    LS solution (Cramer) is a candidate iff all its weights are >= 0 and
    finite; its residual is the full quadratic form y'y - 2 w'Y_S +
    w'G_S w. The optimum is the feasible candidate of least residual, the
    first in support order on a tie (the empty support gives y'y).
    Returns (w1, w2, w3, w4, res).
    """
    zeros = xp.zeros_like(y_sq + G[0][0] * 0.0)
    best_res = y_sq + zeros
    best_w = [zeros, zeros, zeros, zeros]
    for mask in range(1, 16):
        S = [i for i in range(4) if mask >> i & 1]
        G_S = tuple(tuple(G[r][c] for c in S) for r in S)
        Y_S = tuple(Y[i] for i in S)
        w_S, _det = _solve_posdef_cramer(G_S, Y_S)
        feas = xp.full_like(best_res, True, dtype=bool)
        res = y_sq + zeros
        for a, (wa, ya) in enumerate(zip(w_S, Y_S)):
            feas = feas & (wa >= 0) & xp.isfinite(wa)
            res = res - 2.0 * wa * ya
            for b_, wb in enumerate(w_S):
                res = res + wa * wb * G_S[a][b_]
        res = _sanitize(xp.where(feas, res, xp.inf), xp)
        better = res < best_res
        new_w = [zeros] * 4
        for wi, i in zip(w_S, S):
            new_w[i] = wi
        best_w = [xp.where(better, new_w[i], best_w[i]) for i in range(4)]
        best_res = xp.where(better, res, best_res)
    return best_w[0], best_w[1], best_w[2], best_w[3], best_res


def _sub1_res(Y, xp=np):
    """Support {a}: unit-diagonal 1-var LS residual; infeasible -> +inf."""
    return xp.where(Y >= 0, 1.0 - Y * Y, xp.inf)


def _sub2_res(g, Ya, Yb, tol, xp=np):
    """Support {a, b}: unit-diagonal 2-var LS residual via one division;
    sign checks on the Cramer numerators (det > 0)."""
    det = 1.0 - g * g
    na = Ya - g * Yb
    nb = Yb - g * Ya
    feas = (det > tol) & (na >= 0) & (nb >= 0)
    res = 1.0 - (na * Ya + nb * Yb) / xp.where(feas, det, 1.0)
    return xp.where(feas, res, xp.inf)


def _nnls4_sweep_res(G12, g13, g14, g23, g24, g34, Y1, Y2, Y3, Y4,
                     tol, xp=np):
    """Exact 4-variable NNLS residual over an (i1, i2) grid with columns 3
    and 4 fixed (one sweep). All blocks are unit-normalized (diagonal 1).

    Shapes (broadcast): G12 per point (..., T, N2); g13, g14, Y1 per row
    (..., T, 1); g23, g24, Y2 per column (..., 1, N2); g34, Y3, Y4 per
    voxel (..., 1, 1). Residuals are relative to ||y||^2 = 1: the least
    over the 15 non-empty supports of the feasible (w >= 0)
    unconstrained LS solution, and the empty support (1).
    """
    inf = xp.inf
    # supports inside the fixed {3, 4} block: per-voxel constants
    det_f = 1.0 - g34 * g34
    det_f_ok = det_f > tol
    det_f_s = xp.where(det_f_ok, det_f, 1.0)
    uf3 = (Y3 - g34 * Y4) / det_f_s
    uf4 = (Y4 - g34 * Y3) / det_f_s
    r_fix = xp.minimum(_sub1_res(Y3, xp), _sub1_res(Y4, xp))
    r_fix = xp.minimum(r_fix, _sub2_res(g34, Y3, Y4, tol, xp))

    def schur_fixed(g_a3, g_a4, Ya):
        """Schur pieces for one grid variable a against the fixed block:
        reduced diag/rhs + the {a, 3, 4} support residual."""
        t3 = (g_a3 - g34 * g_a4) / det_f_s
        t4 = (g_a4 - g34 * g_a3) / det_f_s
        gaa = 1.0 - (g_a3 * t3 + g_a4 * t4)
        ba = Ya - (g_a3 * uf3 + g_a4 * uf4)
        ok = det_f_ok & (gaa > tol)
        wa = ba / xp.where(ok, gaa, 1.0)
        w3 = uf3 - wa * t3
        w4 = uf4 - wa * t4
        feas = ok & (wa >= 0) & (w3 >= 0) & (w4 >= 0)
        r = 1.0 - (wa * Ya + w3 * Y3 + w4 * Y4)
        r134 = xp.where(feas, r, inf)
        return t3, t4, gaa, ba, r134

    t13, t14, g11_h, b1_h, r134 = schur_fixed(g13, g14, Y1)   # per row
    t23, t24, g22_h, b2_h, r234 = schur_fixed(g23, g24, Y2)   # per column

    # supports holding exactly one grid variable
    r_row = xp.minimum(_sub1_res(Y1, xp), _sub2_res(g13, Y1, Y3, tol, xp))
    r_row = xp.minimum(r_row, _sub2_res(g14, Y1, Y4, tol, xp))
    r_row = xp.minimum(r_row, r134)                            # (.., T, 1)
    r_col = xp.minimum(_sub1_res(Y2, xp), _sub2_res(g23, Y2, Y3, tol, xp))
    r_col = xp.minimum(r_col, _sub2_res(g24, Y2, Y4, tol, xp))
    r_col = xp.minimum(r_col, r234)                            # (.., 1, N2)

    def solve2(gaa, gbb, gab, ba, bb):
        """Reduced 2 x 2 SPD solve; returns (wa, wb, feasible)."""
        det = gaa * gbb - gab * gab
        na = ba * gbb - bb * gab
        nb = bb * gaa - ba * gab
        ok = (det > tol) & (gaa > tol)
        dets = xp.where(ok, det, 1.0)
        return na / dets, nb / dets, ok & (na >= 0) & (nb >= 0)

    # support {1, 2}
    r12 = _sub2_res(G12, Y1, Y2, tol, xp)

    # support {1, 2, 3}: Schur-eliminate variable 3
    g12_3 = G12 - g13 * g23
    w1, w2, ok = solve2(1.0 - g13 * g13, 1.0 - g23 * g23, g12_3,
                        Y1 - g13 * Y3, Y2 - g23 * Y3)
    w3 = Y3 - g13 * w1 - g23 * w2
    r123 = xp.where(ok & (w3 >= 0),
                    1.0 - (w1 * Y1 + w2 * Y2 + w3 * Y3), inf)

    # support {1, 2, 4}: Schur-eliminate variable 4
    g12_4 = G12 - g14 * g24
    w1, w2, ok = solve2(1.0 - g14 * g14, 1.0 - g24 * g24, g12_4,
                        Y1 - g14 * Y4, Y2 - g24 * Y4)
    w4 = Y4 - g14 * w1 - g24 * w2
    r124 = xp.where(ok & (w4 >= 0),
                    1.0 - (w1 * Y1 + w2 * Y2 + w4 * Y4), inf)

    # support {1, 2, 3, 4}: Schur-eliminate the fixed {3, 4} block
    g12_34 = G12 - (t13 * g23 + t14 * g24)
    w1, w2, ok = solve2(g11_h, g22_h, g12_34, b1_h, b2_h)
    w3 = uf3 - (w1 * t13 + w2 * t23)
    w4 = uf4 - (w1 * t14 + w2 * t24)
    r1234 = xp.where(ok & det_f_ok & (w3 >= 0) & (w4 >= 0),
                     1.0 - (w1 * Y1 + w2 * Y2 + w3 * Y3 + w4 * Y4), inf)

    res = xp.minimum(xp.minimum(r12, r123), xp.minimum(r124, r1234))
    res = xp.minimum(res, r_row)
    res = xp.minimum(res, r_col)
    res = xp.minimum(res, r_fix)     # includes broadcast to (.., T, N2)
    res = xp.minimum(res, 1.0)       # empty support
    return _sanitize(res, xp)


def _det_tol(dt):
    """Pivot floor of the 4-block sweeps: 100 eps of the scan's dtype."""
    return 100.0 * float(torch.finfo(dt).eps)


# ---------------------------------------------------------------------------
# Batched exhaustive scans (the general path's device scans)
# ---------------------------------------------------------------------------
#
# Plain torch, as the JAX package's are plain XLA. Gram products and
# correlations are summed in float64 and rounded once to the scan's dtype
# (``_dot``), as the port's column norms are: the result then does not
# depend on the reduction order, so the CPU and the card agree. The
# candidate grid is
# evaluated branchlessly by the solvers above one first-block tile of
# _TILE_N1 atoms at a time (the cross Gram of a tile is (B, tile, N2)),
# and reduced with a first-minimum argmin inside a tile and a strict `<`
# across tiles, so the first candidate in the reference loop order wins
# every tie. Residuals are sanitized (NaN -> +inf) and padded first-block
# atoms masked to +inf before every reduction: torch.argmin takes a NaN
# for the minimum.

def _dot64(spec, a, b):
    """einsum of ``spec`` in float64."""
    return torch.einsum(spec, a.double(), b.double())


def _dot(spec, a, b):
    """einsum of ``spec`` summed in float64, rounded once to a's dtype."""
    return _dot64(spec, a, b).to(a.dtype)


def _take(x, idx):
    """x[b, idx[b]] for (B, N) x and (B,) idx."""
    return torch.gather(x, 1, idx[:, None].long())[:, 0]


def _tile_argmin(res, *vals):
    """First minimum of each row of (B, L) ``res``: (loc, value, each of
    ``vals`` (B, L) at loc)."""
    loc = torch.argmin(res, dim=1)
    return (loc, _take(res, loc)) + tuple(_take(v, loc) for v in vals)


def _valid_rows(st, tile, N1, device):
    """(1, tile, 1) mask of the tile's first-block atoms below N1."""
    i1 = st + torch.arange(tile, device=device)
    return (i1 < N1)[None, :, None]


def exhaustive_1_batched(A1, y):
    """K=1 exhaustive NNLS over a voxel batch.

    A1: (B, S, N1), y: (B, S). Returns (w (B,1), ind (B,1) int32,
    min_obj (B,)).
    """
    A1h, an1 = _normalize_block(A1)
    yh, yn, yn_safe = _normalize_y(y)
    y_sq = yn * yn
    ones = torch.ones_like(an1)
    Y1 = _dot("bs,bsn->bn", yh, A1h)
    w, res = lsqnonneg_1var(torch.ones_like(y_sq)[:, None], ones, Y1,
                            xp=TORCH)
    ind, res_best, w_best = _tile_argmin(res, w)
    # the reference keeps w=0/ind=0 when nothing improves ||y||^2
    improves = res_best < 1.0
    ind = torch.where(improves, ind, 0)
    w_best = torch.where(improves, w_best * yn_safe / _take(an1, ind), 0.0)
    min_obj = torch.clamp(res_best, max=1.0) * y_sq
    return w_best[:, None], ind[:, None].to(torch.int32), min_obj


def _scan_tiles_2(A1p, A2, a11p, a22, Y1p, Y2, y_sq, N1, tile):
    """Tiled candidate scan for the 2-sub-dictionary case.

    Returns (best_res (B,), best_flat (B,), best_w1, best_w2) with flat
    candidate index i1 * N2 + i2 in reference row-major order.
    """
    B, S, N1p = A1p.shape
    N2 = A2.shape[2]
    dev = A2.device
    best_res = y_sq                               # objective with w = 0
    best_flat = torch.zeros(B, dtype=torch.int64, device=dev)
    best_w1 = torch.zeros(B, dtype=A2.dtype, device=dev)
    best_w2 = torch.zeros(B, dtype=A2.dtype, device=dev)
    for st in range(0, N1p, tile):
        G12 = _dot("bst,bsn->btn", A1p[:, :, st:st + tile], A2)
        w1, w2, res = lsqnonneg_2var(y_sq[:, None, None],
                                     a11p[:, st:st + tile, None], G12,
                                     a22[:, None, :],
                                     Y1p[:, st:st + tile, None],
                                     Y2[:, None, :], xp=TORCH)
        res = torch.where(_valid_rows(st, tile, N1, dev), res, math.inf)
        loc, val, w1v, w2v = _tile_argmin(
            res.reshape(B, -1), w1.expand_as(res).reshape(B, -1),
            w2.expand_as(res).reshape(B, -1))
        better = val < best_res  # strict: earlier candidate wins ties
        best_res = torch.where(better, val, best_res)
        best_flat = torch.where(better, st * N2 + loc, best_flat)
        best_w1 = torch.where(better, w1v, best_w1)
        best_w2 = torch.where(better, w2v, best_w2)
    return best_res, best_flat, best_w1, best_w2


def exhaustive_2_batched(A1, A2, y, tile=_TILE_N1):
    """K=2 exhaustive NNLS over a voxel batch.

    A1: (B, S, N1), A2: (B, S, N2), y: (B, S).
    Returns (w (B,2), ind (B,2) int32, min_obj (B,)).
    """
    N2 = A2.shape[2]
    A2h, an2 = _normalize_block(A2)
    yh, yn, yn_safe = _normalize_y(y)
    y_sq = yn * yn
    a22 = torch.ones_like(an2)
    Y2 = _dot("bs,bsn->bn", yh, A2h)
    A1p, N1 = _pad_cols(A1, tile)
    A1h, an1 = _normalize_block(A1p)
    a11p = torch.ones_like(an1)
    Y1p = _dot("bs,bsn->bn", yh, A1h)
    best_res, best_flat, w1, w2 = _scan_tiles_2(
        A1h, A2h, a11p, a22, Y1p, Y2, torch.ones_like(y_sq), N1,
        min(tile, A1p.shape[2]))
    i1 = best_flat // N2
    i2 = best_flat % N2
    w1 = w1 * yn_safe / _take(an1, i1)
    w2 = w2 * yn_safe / _take(an2, i2)
    w = torch.stack([w1, w2], dim=1)
    ind = torch.stack([i1, i2], dim=1).to(torch.int32)
    return w, ind, best_res * y_sq


def _blocks3(A1, A2, A3, y, tile):
    """Normalized blocks, correlations and small Grams of the 3-block
    scans; the first block padded to a multiple of ``tile``."""
    A2h, an2 = _normalize_block(A2)
    A3h, an3 = _normalize_block(A3)
    yh, yn, yn_safe = _normalize_y(y)
    A1p, N1 = _pad_cols(A1, tile)
    A1h, an1 = _normalize_block(A1p)
    return dict(
        A=(A1h, A2h, A3h), an=(an1, an2, an3), yn=yn, yn_safe=yn_safe,
        N1=N1, tile=min(tile, A1h.shape[2]),
        Y=tuple(_dot("bs,bsn->bn", yh, a) for a in (A1h, A2h, A3h)),
        G13=_dot("bsn,bsm->bnm", A1h, A3h), G23=_dot("bsn,bsm->bnm", A2h, A3h))


def _scan_grid3(m):
    """Yield (i3, st, w1, w2, w3, res) over the 3-block candidate grid in
    the reference loop order (i3 outer, i1 tiles, i2), res (B, tile, N2)
    with padded first-block atoms at +inf."""
    A1h, A2h, _A3h = m["A"]
    Y1p, Y2, Y3 = m["Y"]
    B, N1p = Y1p.shape
    N3 = Y3.shape[1]
    tile, dev, dt = m["tile"], Y1p.device, Y1p.dtype
    one = torch.ones(B, 1, 1, dtype=dt, device=dev)
    for i3 in range(N3):
        # the small block's index is the same for every voxel: a slice
        A23 = m["G23"][:, :, i3]
        Y3i = Y3[:, i3]
        for st in range(0, N1p, tile):
            G12 = _dot("bst,bsn->btn", A1h[:, :, st:st + tile], A2h)
            w1, w2, w3, res = lsqnonneg_3var(
                one, torch.ones(B, tile, 1, dtype=dt, device=dev),
                torch.ones(B, 1, A2h.shape[2], dtype=dt, device=dev), one,
                G12, m["G13"][:, st:st + tile, i3, None], A23[:, None, :],
                Y1p[:, st:st + tile, None], Y2[:, None, :],
                Y3i[:, None, None], xp=TORCH)
            res = torch.where(_valid_rows(st, tile, m["N1"], dev), res,
                              math.inf)
            yield i3, st, w1, w2, w3, res


def exhaustive_3_batched(A1, A2, A3, y, tile=_TILE_N1):
    """K=3 exhaustive NNLS over a voxel batch.

    Candidate order matches the reference loops (i3 outer, i1, i2 inner,
    mf_utils.py:540-547) for identical tie-breaking.
    Returns (w (B,3), ind (B,3) int32, min_obj (B,)).
    """
    m = _blocks3(A1, A2, A3, y, tile)
    B, N1p = m["Y"][0].shape
    N2 = A2.shape[2]
    dt, dev = m["Y"][0].dtype, y.device
    best_res = torch.ones(B, dtype=dt, device=dev)
    best_flat = torch.zeros(B, dtype=torch.int64, device=dev)
    bw = [torch.zeros(B, dtype=dt, device=dev) for _ in range(3)]
    for i3, st, w1, w2, w3, res in _scan_grid3(m):
        flat_w = [w.expand_as(res).reshape(B, -1) for w in (w1, w2, w3)]
        loc, val, *wv = _tile_argmin(res.reshape(B, -1), *flat_w)
        # reference loop order (i3, i1, i2) -> flat rank
        gflat = (i3 * N1p + st) * N2 + loc
        better = val < best_res
        best_res = torch.where(better, val, best_res)
        best_flat = torch.where(better, gflat, best_flat)
        bw = [torch.where(better, v, b) for v, b in zip(wv, bw)]
    i3 = best_flat // (N1p * N2)
    rem = best_flat % (N1p * N2)
    i1 = rem // N2
    i2 = rem % N2
    an1, an2, an3 = m["an"]
    ys = m["yn_safe"]
    w = torch.stack([bw[0] * ys / _take(an1, i1), bw[1] * ys / _take(an2, i2),
                     bw[2] * ys / _take(an3, i3)], dim=1)
    ind = torch.stack([i1, i2, i3], dim=1).to(torch.int32)
    return w, ind, best_res * (m["yn"] * m["yn"])


# ---------------------------------------------------------------------------
# 4-block configuration (2 fascicles + CSF + EAR): Schur-complement sweeps
# ---------------------------------------------------------------------------
#
# For each fixed pair of small-block atoms (i3, i4) — a "sweep", N3 * N4
# of them — the 4 x 4 Gram has a constant 2 x 2 trailing block, so the
# 15-support enumeration collapses to a few Schur-complement closed forms
# with per-row (i1) and per-column (i2) precomputation.
#
# The sweeps run in float64 on the blocks' float64 products whatever the
# scan's dtype, and their residuals are rounded to it before the tile is
# reduced. Where the CSF column and an EAR atom are nearly collinear (the
# widest of 20 EAR atoms against CSF on the 552-sequence protocol) the
# {1, 2, 3, 4} Schur complement carries float32 rounding up by the
# inverse of the {CSF, EAR} determinant, into spurious negative
# residuals that crowd the true support out of the top-M pool. The
# guards keep the scan dtype's tolerance (_det_tol).

def _scan4_grid(A1, A2, A3, A4, y, tile, reduce_tile, carry):
    """Shared tile scan for the 4-block configuration.

    Normalizes the blocks, precomputes the small Grams, then scans i1
    tiles; in each tile the N3 * N4 sweeps are reduced point-wise with a
    strict first minimum in (i3, i4) order, giving the reference
    itertools.product tie-breaking. Each tile's (res (B, tile * N2),
    flat (B, tile * N2) reference ranks) go to ``reduce_tile(carry, res,
    flat)``, which returns the next carry.

    Returns (carry, meta) where meta carries the normalization state.
    """
    B, S, _ = A1.shape
    N2, N3, N4 = A2.shape[2], A3.shape[2], A4.shape[2]
    dt, dev = A1.dtype, A1.device
    tol = _det_tol(dt)
    NS = N3 * N4
    A2h, an2 = _normalize_block(A2)
    A3h, an3 = _normalize_block(A3)
    A4h, an4 = _normalize_block(A4)
    yh, yn, yn_safe = _normalize_y(y)
    Y2 = _dot64("bs,bsn->bn", yh, A2h)
    Y3 = _dot64("bs,bsn->bn", yh, A3h)
    Y4 = _dot64("bs,bsn->bn", yh, A4h)
    G34 = _dot64("bsn,bsm->bnm", A3h, A4h)
    G23 = _dot64("bsn,bsm->bnm", A2h, A3h)
    G24 = _dot64("bsn,bsm->bnm", A2h, A4h)
    A1p, N1 = _pad_cols(A1, tile)
    A1h, an1 = _normalize_block(A1p)
    tile = min(tile, A1h.shape[2])
    N1p = A1h.shape[2]
    Y1p = _dot64("bs,bsn->bn", yh, A1h)
    G13p = _dot64("bsn,bsm->bnm", A1h, A3h)
    G14p = _dot64("bsn,bsm->bnm", A1h, A4h)

    r = lambda x: x[:, :, None]            # (B, tile) per row
    c = lambda x: x[:, None, :]            # (B, N2)  per column
    e = lambda x: x[:, None, None]         # (B,)     per voxel
    i2 = torch.arange(N2, device=dev)[None, :]
    for st in range(0, N1p, tile):
        Y1t = r(Y1p[:, st:st + tile])
        G13t = G13p[:, st:st + tile]
        G14t = G14p[:, st:st + tile]
        G12 = _dot64("bst,bsn->btn", A1h[:, :, st:st + tile], A2h)

        best = torch.full((B, tile, N2), math.inf, dtype=torch.float64,
                          device=dev)
        best_s = torch.zeros((B, tile, N2), dtype=torch.int64, device=dev)
        for s in range(NS):
            i3, i4 = divmod(s, N4)
            res_s = _nnls4_sweep_res(
                G12, r(G13t[:, :, i3]), r(G14t[:, :, i4]),
                c(G23[:, :, i3]), c(G24[:, :, i4]), e(G34[:, i3, i4]),
                Y1t, c(Y2), e(Y3[:, i3]), e(Y4[:, i4]), tol, xp=TORCH)
            upd = res_s < best              # strict: first (i3, i4) wins
            best = torch.where(upd, res_s, best)
            best_s = torch.where(upd, s, best_s)

        i1 = st + torch.arange(tile, device=dev)[:, None]
        best = torch.where((i1 < N1)[None], best.to(dt), math.inf)
        flat = (i1 * N2 + i2)[None] * NS + best_s   # reference product rank
        carry = reduce_tile(carry, best.reshape(B, -1), flat.reshape(B, -1))

    meta = dict(an=(an1, an2, an3, an4), yn=yn, yn_safe=yn_safe,
                N1=N1, N1p=N1p, NS=NS, dims=(N2, N3, N4),
                A=(A1h, A2h, A3h, A4h), yh=yh)
    return carry, meta


def exhaustive_4_batched(A1, A2, A3, A4, y, tile=_TILE_N1):
    """K=4 exhaustive NNLS over a voxel batch (Schur-complement sweeps over
    the two small trailing blocks).

    Candidate ranking follows the reference itertools.product order
    (i1, i2, i3, i4 lexicographic; mf_utils.py:637) with strict-improvement
    tie-breaking. Returns (w (B,4), ind (B,4) int32, min_obj (B,)).
    """
    B = y.shape[0]
    dt, dev = A1.dtype, A1.device

    def reduce_tile(carry, res, flat):
        best_res, best_flat = carry
        _loc, val, fl = _tile_argmin(res, flat)
        better = val < best_res
        return (torch.where(better, val, best_res),
                torch.where(better, fl, best_flat))

    init = (torch.ones(B, dtype=dt, device=dev),
            torch.zeros(B, dtype=torch.int64, device=dev))
    (best_res, best_flat), meta = _scan4_grid(A1, A2, A3, A4, y, tile,
                                              reduce_tile, init)
    N2, N3, N4 = meta["dims"]
    NS = meta["NS"]
    pt = best_flat // NS
    s = best_flat % NS
    idx = (pt // N2, pt % N2, s // N4, s % N4)
    ind = torch.stack(idx, dim=1).to(torch.int32)

    # weights of the single winning combination: gather its columns and
    # re-solve the 4-variable support enumeration once per voxel (in
    # float64, as the sweeps)
    cols = [torch.gather(Ah, 2, ii[:, None, None].expand(
        -1, Ah.shape[1], 1))[:, :, 0] for Ah, ii in zip(meta["A"], idx)]
    G = tuple(tuple(_dot64("bs,bs->b", cols[a], cols[b]) for b in range(4))
              for a in range(4))
    Yv = tuple(_dot64("bs,bs->b", meta["yh"], cols[a]) for a in range(4))
    w1, w2, w3, w4, _res = lsqnonneg_4var(
        torch.ones(B, dtype=torch.float64, device=dev), G, Yv, xp=TORCH)
    yn_safe = meta["yn_safe"]
    ws = [wj.to(dt) * yn_safe / _take(an, ii)
          for wj, an, ii in zip((w1, w2, w3, w4), meta["an"], idx)]
    return torch.stack(ws, dim=1), ind, best_res * (meta["yn"] * meta["yn"])


# ---------------------------------------------------------------------------
# Top-M candidate scans (for float64 host re-scoring of the float32 scans)
# ---------------------------------------------------------------------------
#
# The float32 scan resolves residual gaps down to ~1e-7 relative; real
# fingerprint dictionaries hold atom pairs closer than that. These
# variants keep the M best candidates per voxel, merged tile by tile by
# (residual, candidate rank) so the reference tie-breaking holds, and
# leave the exact selection to the float64 re-scorer
# (models/refine.py).

def _pool_init(B, M, dt, dev):
    return (torch.full((B, M), math.inf, dtype=dt, device=dev),
            torch.zeros((B, M), dtype=torch.int32, device=dev))


def _pool_add(pool, res, gflat, M):
    """Merge a tile's (B, L) residuals and their ranks (1 or B, L) into
    the running top-M pool."""
    tv, tf = _tile_topm(res, gflat, M)
    return _merge_topm(pool[0], pool[1], tv, tf, M)


def exhaustive_2_candidates(A1, A2, y, M=8, tile=_TILE_N1):
    """Top-M candidate flats for the K=2 scan. Returns (flats (B, M) int32,
    vals (B, M) normalized residuals); flat = i1 * N2 + i2."""
    B = y.shape[0]
    N2 = A2.shape[2]
    dt, dev = A1.dtype, A1.device
    A2h, _an2 = _normalize_block(A2)
    yh, _yn, _yn_safe = _normalize_y(y)
    Y2 = _dot("bs,bsn->bn", yh, A2h)
    A1p, N1 = _pad_cols(A1, tile)
    A1h, _an1 = _normalize_block(A1p)
    tile = min(tile, A1p.shape[2])
    Y1p = _dot("bs,bsn->bn", yh, A1h)
    one = torch.ones(B, 1, 1, dtype=dt, device=dev)
    i2 = torch.arange(N2, device=dev)[None, :]
    pool = _pool_init(B, M, dt, dev)
    for st in range(0, A1p.shape[2], tile):
        G12 = _dot("bst,bsn->btn", A1h[:, :, st:st + tile], A2h)
        _w1, _w2, res = lsqnonneg_2var(
            one, torch.ones(B, tile, 1, dtype=dt, device=dev), G12,
            torch.ones(B, 1, N2, dtype=dt, device=dev),
            Y1p[:, st:st + tile, None], Y2[:, None, :], xp=TORCH)
        res = torch.where(_valid_rows(st, tile, N1, dev), res, math.inf)
        i1 = st + torch.arange(tile, device=dev)[:, None]
        pool = _pool_add(pool, res.reshape(B, -1),
                         (i1 * N2 + i2).reshape(1, -1), M)
    vals, flats = pool
    return flats, vals


def exhaustive_3_candidates(A1, A2, A3, y, M=8, tile=_TILE_N1):
    """Top-M candidates for the K=3 scan; flat = ((i3*N1p)+i1)*N2+i2 with
    N1p the padded N1 (decode with the same padding)."""
    m = _blocks3(A1, A2, A3, y, tile)
    B, N1p = m["Y"][0].shape
    N2 = A2.shape[2]
    dev = y.device
    i2 = torch.arange(N2, device=dev)[None, :]
    tile_i1 = torch.arange(m["tile"], device=dev)[:, None]
    pool = _pool_init(B, M, m["Y"][0].dtype, dev)
    for i3, st, _w1, _w2, _w3, res in _scan_grid3(m):
        gflat = (i3 * N1p + st + tile_i1) * N2 + i2
        pool = _pool_add(pool, res.reshape(B, -1), gflat.reshape(1, -1), M)
    vals, flats = pool
    return flats, vals


def exhaustive_4_candidates(A1, A2, A3, A4, y, M=8, tile=_TILE_N1):
    """Top-M candidates for the 4-block scan, in reference product order.

    Returns (flats (B, M) int32, vals (B, M)) with
    flat = ((i1 * N2 + i2) * N3 + i3) * N4 + i4. Each (i1, i2) grid point
    contributes its best (i3, i4); the float64 re-scorer re-enumerates the
    small blocks exactly (models/refine.py), so the pool only needs to
    contain the optimal (i1, i2) pair.
    """
    B = y.shape[0]

    def reduce_tile(pool, res, flat):
        return _pool_add(pool, res, flat, M)

    pool, _meta = _scan4_grid(A1, A2, A3, A4, y, tile, reduce_tile,
                              _pool_init(B, M, A1.dtype, A1.device))
    vals, flats = pool
    return flats, vals


def exhaustive_candidates_blocks(blocks, y, M=8, tile=_TILE_N1):
    """Top-M candidate subdictionary indices for 1-4 blocks.

    Returns ind (B, M, K) int32 (per-subdictionary indices, reference
    candidate order preserved within the top set).
    """
    k = len(blocks)
    if k == 1:
        A1h, _ = _normalize_block(blocks[0])
        yh, _, _ = _normalize_y(y)
        Y1 = _dot("bs,bsn->bn", yh, A1h)
        res = 1.0 - torch.where(Y1 >= 0, Y1 * Y1, 0.0)
        N1 = blocks[0].shape[2]
        M_eff = min(M, N1)
        # as lax.top_k(-res, M_eff): ties to the lower index
        _v, idx = _tile_topm(res, torch.arange(N1, device=y.device)[None],
                             M_eff)
        if M_eff < M:
            idx = torch.cat([idx, idx[:, -1:].expand(-1, M - M_eff)], dim=1)
        return idx[:, :, None].to(torch.int32)
    if k == 2:
        N2 = blocks[1].shape[2]
        flats, _ = exhaustive_2_candidates(blocks[0], blocks[1], y, M=M,
                                           tile=tile)
        return torch.stack([flats // N2, flats % N2], dim=2).to(torch.int32)
    if k == 3:
        N2 = blocks[1].shape[2]
        N1p = int(math.ceil(blocks[0].shape[2] / tile) * tile)
        flats, _ = exhaustive_3_candidates(blocks[0], blocks[1], blocks[2],
                                           y, M=M, tile=tile)
        i3 = flats // (N1p * N2)
        rem = flats % (N1p * N2)
        return torch.stack([rem // N2, rem % N2, i3], dim=2).to(torch.int32)
    if k == 4:
        N2, N3, N4 = (blocks[1].shape[2], blocks[2].shape[2],
                      blocks[3].shape[2])
        flats, _ = exhaustive_4_candidates(*blocks, y, M=M, tile=tile)
        i4 = flats % N4
        rem = flats // N4
        i3 = rem % N3
        rem = rem // N3
        return torch.stack([rem // N2, rem % N2, i3, i4],
                           dim=2).to(torch.int32)
    raise NotImplementedError("candidates supported for 1-4 blocks")


def exhaustive_nnls_blocks(blocks, y):
    """Dispatch the batched exhaustive solve on a tuple of (B, S, Nk) blocks.

    Returns (w (B, K), ind_subdic (B, K) int32, min_obj (B,)).
    """
    k = len(blocks)
    if k == 1:
        return exhaustive_1_batched(blocks[0], y)
    if k == 2:
        return exhaustive_2_batched(blocks[0], blocks[1], y)
    if k == 3:
        return exhaustive_3_batched(blocks[0], blocks[1], blocks[2], y)
    if k == 4:
        return exhaustive_4_batched(*blocks, y)
    raise NotImplementedError(
        "Batched exhaustive NNLS supports up to 4 sub-dictionaries.")


# ---------------------------------------------------------------------------
# Reference-compatible public API (single problem, NumPy in/out)
# ---------------------------------------------------------------------------

def solve_exhaustive_posweights(A, y, dicsizes, printmsg=None):
    """Solves NNLS with 1-sparsity constraints combinatorially.

    Drop-in equivalent of the reference dispatcher (mf_utils.py:115-214):
    same arguments, validation, and 5-tuple return
    ``(w_nneg, ind_atoms_subdic, ind_atoms_totdic, min_obj, y_recons)``.
    Solved in float64 on the host, as in the JAX package: K in {1, 2, 3,
    4} by the closed-form grid scans, K > 4 by the combinatorial loop.
    """
    if printmsg is not None:
        print(printmsg, end="")

    # --- Check inputs (reference semantics, mf_utils.py:157-195) ---
    assert isinstance(A, np.ndarray), "A should be a NumPy ndarray"
    assert A.ndim == 2, "A should be a 2D array"
    assert not np.any(np.all(A == 0, axis=0)), "All-zero columns detected in A"
    A = A.astype(np.float64, copy=False)
    assert isinstance(y, np.ndarray), "y should be a NumPy ndarray"
    y = np.array(y, dtype=np.float64)  # writeable copy
    assert A.size > 0 and y.size > 0, "A and y should not be empty arrays"
    msg = ("Number of rows in A (%d) should match number of elements in y"
           " (%d)" % (A.shape[0], y.size))
    assert A.shape[0] == y.size, msg
    assert isinstance(dicsizes, np.ndarray), ("dicsizes should be a "
                                              "NumPy ndarray")
    assert np.all(dicsizes > 0), "All entries of dicsizes should be > 0"
    dicsizes = dicsizes.astype(np.int64, copy=False)
    msg = ("Number of columns of A (%d) does not equal sum of size of "
           "sub-matrices in diclengths array (%d)"
           % (A.shape[1], np.sum(dicsizes)))
    assert A.shape[1] == np.sum(dicsizes), msg

    Nvars = dicsizes.size
    if Nvars > 4:
        return _solve_exhaustive_posweights_general(A, y, dicsizes)
    # float64 on the host: bit-comparable to the reference's float64
    # kernels, and no host-device round trip a call. Batched device
    # execution lives in MFModel.fit / exhaustive_nnls_blocks.
    return _solve_exhaustive_host(A, y, dicsizes)


def _solve_exhaustive_host(A, y, dicsizes):
    """Vectorized float64 exhaustive solve on the host (K <= 4).

    Same closed-form case analysis as the device kernels (lsqnonneg_*
    with xp=numpy), evaluated over the full candidate grid in float64;
    candidate ranking and strict-improvement tie-breaking match the
    reference loop orders (mf_utils.py:252-273, 329-386, 540-601, 637).
    """
    K = dicsizes.size
    st = np.zeros(K, dtype=np.int64)
    st[1:] = np.cumsum(dicsizes)[:-1]
    blocks = [A[:, st[k]:st[k] + dicsizes[k]] for k in range(K)]
    y_sq = float(y @ y)
    Yk = [b.T @ y for b in blocks]
    dk = [np.einsum("sn,sn->n", b, b) for b in blocks]

    if K == 1:
        w, res = lsqnonneg_1var(y_sq, dk[0], Yk[0], xp=np)
        i = int(np.argmin(_sanitize(res, np)))
        w_out = np.array([w[i]])
        ind = np.array([i], dtype=np.int32)
        min_obj = float(res[i])
    elif K == 2:
        G12 = blocks[0].T @ blocks[1]
        w1, w2, res = lsqnonneg_2var(
            y_sq, dk[0][:, None], G12, dk[1][None, :],
            Yk[0][:, None], Yk[1][None, :], xp=np)
        flat = int(np.argmin(res))
        i1, i2 = divmod(flat, int(dicsizes[1]))
        w_out = np.array([w1[i1, i2], w2[i1, i2]])
        ind = np.array([i1, i2], dtype=np.int32)
        min_obj = float(res[i1, i2])
    elif K == 3:
        G12 = blocks[0].T @ blocks[1]
        G13 = blocks[0].T @ blocks[2]
        G23 = blocks[1].T @ blocks[2]
        N1, N2, N3 = (int(n) for n in dicsizes)
        # reference init (mf_utils.py:536): w=0 at indices (0,0,0) unless a
        # candidate strictly beats ||y||^2
        best = (y_sq, 0, (0.0, 0.0, 0.0, 0, 0))
        for i3 in range(N3):                      # reference order: i3 outer
            w1, w2, w3, res = lsqnonneg_3var(
                y_sq, dk[0][:, None], dk[1][None, :], dk[2][i3],
                G12, G13[:, i3][:, None], G23[None, :, i3],
                Yk[0][:, None], Yk[1][None, :], Yk[2][i3], xp=np)
            flat = int(np.argmin(res))
            i1, i2 = divmod(flat, N2)
            if res[i1, i2] < best[0]:
                best = (float(res[i1, i2]), i3,
                        (w1[i1, i2], w2[i1, i2], w3[i1, i2], i1, i2))
        min_obj, i3, (w1v, w2v, w3v, i1, i2) = best
        w_out = np.array([w1v, w2v, w3v])
        ind = np.array([i1, i2, i3], dtype=np.int32)
    else:  # K == 4: Schur sweeps over the small trailing blocks
        N1, N2, N3, N4 = (int(n) for n in dicsizes)
        nb = [b / np.sqrt(d)[None, :] for b, d in zip(blocks, dk)]
        yn = y / np.sqrt(y_sq) if y_sq > 0 else y
        Ykn = [b.T @ yn for b in nb]
        G12 = nb[0].T @ nb[1]
        G13, G14 = nb[0].T @ nb[2], nb[0].T @ nb[3]
        G23, G24 = nb[1].T @ nb[2], nb[1].T @ nb[3]
        G34 = nb[2].T @ nb[3]
        tol = 100 * np.finfo(np.float64).eps
        best_res = np.full((N1, N2), y_sq)
        best_s = np.zeros((N1, N2), dtype=np.int64)
        for s in range(N3 * N4):
            i3, i4 = divmod(s, N4)
            res_s = _nnls4_sweep_res(
                G12, G13[:, i3][:, None], G14[:, i4][:, None],
                G23[None, :, i3], G24[None, :, i4], G34[i3, i4],
                Ykn[0][:, None], Ykn[1][None, :], Ykn[2][i3], Ykn[3][i4],
                tol, xp=np) * y_sq
            upd = res_s < best_res
            best_res[upd] = res_s[upd]
            best_s[upd] = s
        flat = int(np.argmin(best_res))           # product order (i1-major)
        i1, i2 = divmod(flat, N2)
        i3, i4 = divmod(int(best_s[i1, i2]), N4)
        cols = np.stack([blocks[0][:, i1], blocks[1][:, i2],
                         blocks[2][:, i3], blocks[3][:, i4]], axis=1)
        G = cols.T @ cols
        Yc = cols.T @ y
        w1, w2, w3, w4, min_obj = lsqnonneg_4var(
            y_sq, tuple(tuple(G[a, b_] for b_ in range(4))
                        for a in range(4)), tuple(Yc), xp=np)
        w_out = np.array([w1, w2, w3, w4])
        ind = np.array([i1, i2, i3, i4], dtype=np.int32)
        min_obj = float(min_obj)

    ind_totdic = (st + ind).astype(np.int32)
    y_recons = A[:, ind_totdic] @ w_out
    return (w_out, ind, ind_totdic, min_obj, y_recons)


def solve_exhaustive_posweights_1(A, y):
    """1-sub-dictionary exhaustive NNLS (reference mf_utils.py:218-278
    signature): returns scalars (w, ind_subdic, ind_totdic, min_obj) plus
    y_recons, like the Numba kernel. Solved in float64 on the host, like
    the dispatcher: a float32 device scan would degrade the selection to
    float32 grade."""
    A = np.asarray(A, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    w, ind, ind_tot, min_obj, y_recons = _solve_exhaustive_host(
        A, y, np.array([A.shape[1]], dtype=np.int64))
    return (float(w[0]), int(ind[0]), int(ind_tot[0]), float(min_obj),
            y_recons)


def solve_exhaustive_posweights_2(A, y, diclengths):
    """2-sub-dictionary exhaustive NNLS (reference mf_utils.py:284-392
    signature). float64 host solve (see solve_exhaustive_posweights_1)."""
    A = np.asarray(A, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    w, ind_subdic, ind_totdic, min_obj, y_recons = _solve_exhaustive_host(
        A, y, np.asarray(diclengths[:2], dtype=np.int64))
    return (w, ind_subdic, ind_totdic, float(min_obj), y_recons)


def solve_exhaustive_posweights_3(A, y, diclengths):
    """3-sub-dictionary exhaustive NNLS (reference mf_utils.py:466-607
    signature). float64 host solve (see solve_exhaustive_posweights_1)."""
    A = np.asarray(A, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    w, ind_subdic, ind_totdic, min_obj, y_recons = _solve_exhaustive_host(
        A, y, np.asarray(diclengths[:3], dtype=np.int64))
    return (w, ind_subdic, ind_totdic, float(min_obj), y_recons)


def lsqnonneg_2var_opt(y_sq, A11, A12, A22, Y1, Y2):
    """2-variable NNLS from precomputed scalars (reference
    mf_utils.py:399-459 signature): returns (w (2,), resnorm)."""
    w1, w2, res = lsqnonneg_2var(y_sq, A11, A12, A22, Y1, Y2, xp=np)
    return np.array([w1, w2], dtype=np.float64), float(res)


def solve_exhaustive_posweights_4up(A, y, diclengths):
    """Host combinatorial path for >= 4 sub-dictionaries (same contract as
    reference mf_utils.py:612-657, which runs one scipy.optimize.nnls per
    atom combination; here combinations are solved in vectorized chunks)."""
    return _solve_exhaustive_posweights_general(A, y, diclengths)


def _solve_exhaustive_posweights_general(A, y, diclengths, chunk=2048):
    """General K-sub-dictionary exhaustive NNLS (host, vectorized).

    Covers the K > 4 dispatch branch (reference mf_utils.py:612-657 calls
    scipy.optimize.nnls once per atom combination; here whole chunks of
    combinations are solved at once). Uses the support-enumeration identity:
    the NNLS optimum over K columns equals the minimum over the 2^K - 1
    non-empty supports S of the unconstrained least-squares solution on S,
    restricted to solutions with non-negative weights. Each support is a
    batched ``np.linalg.solve`` on the (chunk, |S|, |S|) Gram stack.
    Combination order is lexicographic (i1-major) and improvement is strict,
    so tie-breaking matches itertools.product + ``<``.
    """
    K = diclengths.size
    starts = np.concatenate([[0], np.cumsum(diclengths)[:-1]]).astype(np.int64)
    y_sq = float(y @ y)

    best_obj = y_sq
    best_w = np.zeros(K)
    best_combo = np.zeros(K, dtype=np.int64)

    supports = [np.flatnonzero([m >> i & 1 for i in range(K)])
                for m in range(1, 1 << K)]

    combo_iter = np.ndindex(*diclengths)  # lexicographic = product order
    while True:
        combos = np.array(list(islice(combo_iter, chunk)), dtype=np.int64)
        if combos.size == 0:
            break
        n = combos.shape[0]
        cols = A[:, combos + starts[None, :]]          # (S, n, K)
        # unit-normalize columns so the determinant guard below is
        # scale-invariant (like the K <= 4 paths): without it, supports of
        # well-conditioned but small-magnitude columns (diag ~ 1e-6) would
        # be wrongly rejected, and huge columns could mask true collinearity
        nrm = np.sqrt(np.einsum("snk,snk->nk", cols, cols))   # (n, K)
        nrm = np.where(nrm > 0, nrm, 1.0)
        colsn = cols / nrm[None, :, :]
        G = np.einsum("snk,snl->nkl", colsn, colsn)    # (n, K, K) unit diag
        b = np.einsum("snk,s->nk", colsn, y)           # (n, K)

        obj = np.full(n, y_sq)
        w_opt = np.zeros((n, K))
        for S in supports:
            GS = G[:, S[:, None], S[None, :]]
            bS = b[:, S]
            ok = np.abs(np.linalg.det(GS)) > (_EPS * 100) ** len(S)
            GS_safe = np.where(ok[:, None, None], GS, np.eye(len(S)))
            wS = np.linalg.solve(GS_safe, bS[:, :, None])[:, :, 0]
            feas = ok & np.all(wS >= 0, axis=1) & np.all(np.isfinite(wS),
                                                         axis=1)
            # full quadratic form: robust to inexact solves on
            # near-collinear supports
            r = (y_sq - 2 * np.einsum("nk,nk->n", wS, bS)
                 + np.einsum("nk,nkl,nl->n", wS, GS, wS))
            r = np.where(feas, r, np.inf)
            upd = r < obj
            if np.any(upd):
                obj[upd] = r[upd]
                w_full = np.zeros((int(upd.sum()), K))
                w_full[:, S] = wS[upd] / nrm[upd][:, S]  # raw-scale weights
                w_opt[upd] = w_full
        j = int(np.argmin(obj))                        # first minimum
        if obj[j] < best_obj:
            best_obj = float(obj[j])
            best_w = w_opt[j]
            best_combo = combos[j]

    totdic = starts + best_combo
    y_recons = A[:, totdic] @ best_w
    return (best_w, best_combo, totdic, best_obj, y_recons)


def nnls_underdetermined(X, y, max_outer=None):
    """Active-set NNLS for wide ("underdetermined") systems.

    Lawson-Hanson/FNNLS-style algorithm with the reference's return
    contract (mf_utils.py:663-760): a 3-tuple of the non-negative
    solution, the passive-set indices, and the gradient-based optimality
    vector A'y - A'Ax.
    ``max_outer`` caps the outer active-set passes (default 30 * n); hitting
    the cap emits a RuntimeWarning and returns the current feasible iterate.
    """
    (m, n) = X.shape
    Xty = np.dot(X.T, y)
    # Lawson-Hanson scaled tolerance: robust when the passive set saturates
    # the row rank (wide systems), where the reference's fixed 10*eps can
    # cycle on numerically-singular normal equations.
    tol = 10 * _EPS * max(np.linalg.norm(X, 1), 1.0) * max(m, n)
    if max_outer is None:
        max_outer = 30 * n

    passive = np.zeros(n, bool)  # True = passive (positive), False = active
    passive_idx = np.zeros(0, dtype=np.int64)
    trial = np.zeros(n, np.float64)   # unconstrained solve on passive set
    sol = np.zeros(n, np.float64)     # current feasible iterate
    grad = Xty.copy()                 # optimality vector A'y - A'A sol

    def _solve_passive():
        idx = np.where(passive)[0]
        rhs = Xty[idx]
        if idx.size == 1:
            trial[idx] = rhs / np.sum(X[:, idx] ** 2)
        elif idx.size > 0:
            gram = X[:, idx].T @ X[:, idx]
            trial[idx] = np.linalg.lstsq(gram, rhs, rcond=None)[0]
        return idx

    outer = 0
    while (np.any(~passive) and np.any(grad[~passive] > tol)
           and outer < max_outer):
        outer += 1
        t = np.argmax(grad[~passive])
        t = np.where(~passive)[0][t]
        passive[t] = True
        trial[t] = 0
        passive_idx = _solve_passive()
        inner = 0
        while np.any(trial[passive] <= tol) and inner < max_outer:
            inner += 1
            clipped = (trial <= tol) & passive
            with np.errstate(divide="ignore", invalid="ignore"):
                steps = sol[clipped] / (sol[clipped] - trial[clipped])
            steps[~np.isfinite(steps)] = 0.0
            alpha = np.min(steps)
            sol += alpha * (trial - sol)
            dropped = passive & (np.abs(sol) < tol)
            passive[dropped] = False
            trial[dropped] = 0
            passive_idx = _solve_passive()
        sol[:] = trial
        grad = Xty - np.dot(X.T, np.dot(X[:, passive_idx],
                                        sol[passive_idx]))
    if outer >= max_outer:
        warnings.warn(
            "nnls_underdetermined hit its iteration cap (%d outer passes) "
            "before reaching optimality; the returned solution is feasible "
            "but may be suboptimal (ill-conditioned or cycling system)."
            % max_outer, RuntimeWarning)
    return sol, passive_idx, grad
