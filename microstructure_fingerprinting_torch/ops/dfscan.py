"""Double-float Gram primitives and the exact small NNLS finalize.

PyTorch counterpart of the parts of
``microstructure_fingerprinting_tpu/ops/dfscan.py`` that the ported
buckets run:

  * ``quantize2`` / ``quantize3``: exact int8 level decompositions of
    normalized columns (X = s1*Q1 + s2*Q2 [+ s3*Q3] + R);
  * ``df_gram`` / ``df_gram_tile``: exact-product Grams combined
    error-free into (hi, lo) pairs;
  * ``df2_candidates``: the [N1, N2] scan of one fascicle + CSF and of
    two fascicles without CSF, in plain torch as the JAX package runs it
    in plain XLA;
  * the df helpers and ``_two_var_cases`` shared with the re-scans
    (``ops/rescan.py``), and the 4-block sub-support residuals
    ``_sub1_df``/``_sub2_df``/``_sub3_df`` of the EAR re-scan's hoists;
  * ``df_nnls_cols``: the winner's weights, objective and residual with
    double-float values and f32 decision booleans (the device finalize),
    for 1 to 4 columns.

Sums over the sequence axis: integer level products are exact in any
order and are computed as float64 matmuls (exact below 2^53; int8
matmul on the CPU would wrap around in int8). Floating cross products
are exact float64 products of float32 values, accumulated in float64 and
rounded once to float32 — the CUDA kernels accumulate the same way, so
kernel and twin agree independently of summation order. (The JAX
package accumulates them in float32; the two differ by ~1 ulp of the
~1e-4-sized cross terms, far below the scans' resolution.)
"""

import math

import numpy as np
import torch

from . import df32
from . import nnls as mfn

_S1 = 2.0 ** -7
_S2 = 2.0 ** -15
_S3 = 2.0 ** -23
#: conditioning floor for double-float-evaluated determinants of
#: normalized Grams: the one value the re-scan's plain version and its
#: CUDA kernel (which receives it as an argument) both use
_TOL_DET = 1e-12
#: relative determinant / pivot guard of the 4-block family: 100 float32 eps
_TOL = float(np.float32(100 * 1.1920929e-07))
#: Cramer sign tolerance of the 3-variable solver: 100 float64 eps, as
#: the reference's (mf_utils.py:480-482) and the JAX package's
#: ops/nnls._TOL3
_TOL3 = 100 * 2.2204e-16


def idot(contract, x, y):
    """Exact integer contraction of int8-valued tensors, as float64."""
    return torch.einsum(contract, x.double(), y.double())


def fdot(contract, x, y):
    """float32 contraction accumulated in float64, rounded once."""
    return torch.einsum(contract, x.double(), y.double()).float()


def _round_levels(X, scale):
    return torch.clamp(torch.round(X / scale), -127, 127)


def quantize2(X):
    """Two-level int8 decomposition X = s1*Q1 + s2*Q2 + R (exact).
    Returns (Q1 int8, Q2 int8, R f32, a f32) with a = s1*Q1 + s2*Q2."""
    X = X.float()
    Q1 = _round_levels(X, _S1).to(torch.int8)
    A1 = Q1.float() * _S1
    R1 = X - A1
    Q2 = _round_levels(R1, _S2).to(torch.int8)
    a = A1 + Q2.float() * _S2
    R = X - a
    return Q1, Q2, R, a


def quantize3(X):
    """Three-level int8 decomposition X = s1*Q1 + s2*Q2 + s3*Q3 + R
    (exact; |R| <= ~2^-24). Returns (Q1, Q2, Q3, R, a)."""
    Q1, Q2, R2, a2 = quantize2(X)
    Q3 = _round_levels(R2, _S3).to(torch.int8)
    a = a2 + Q3.float() * _S3
    R = X.float() - a
    return Q1, Q2, Q3, R, a


def df_gram(qa, qb, contract):
    """Double-float Gram block from two quantize2 operands (einsum spec
    ``contract`` over the sequence axis). Returns (hi, lo)."""
    Q1a, Q2a, Ra, aa = qa
    Q1b, Q2b, Rb, ab = qb
    t11 = idot(contract, Q1a, Q1b)
    t12 = idot(contract, Q1a, Q2b) + idot(contract, Q2a, Q1b)
    t22 = idot(contract, Q2a, Q2b)
    v_a = t11.float() * 2.0 ** -14
    v_b = t12.float() * 2.0 ** -22
    v_c = t22.float() * 2.0 ** -30
    # exact identity: A'B = a'b + A'R_b + R_a'b  (A = a + R_a, B = b + R_b)
    c1 = fdot(contract, aa + Ra, Rb)
    c2 = fdot(contract, Ra, ab)
    return df32.df_from_sum(v_a, v_b, v_c, c1, c2)


def df_gram_tile(qa_t, qb, n2):
    """Double-float Gram of one (B, S, T) tile against a (B, S, N2)
    quantize2 block. Returns (hi, lo) of shape (B, T, N2)."""
    del n2  # the JAX signature's static width; the shapes carry it here
    return df_gram(qa_t, qb, "bst,bsn->btn")


def df2_candidates(A1, A2, y, M=8, tile=256):
    """Top-M candidates for [N1, N2] with double-float selection: the
    supports {1}, {2}, {1, 2} and the empty one, by the reference's
    2-variable case analysis with compensated residual values. It serves
    one fascicle + CSF (the CSF column as the second axis) and two
    fascicles without CSF.

    A1 (B, S, N1), A2 (B, S, N2), y (B, S). The N1 axis is scanned in
    ``tile``-atom tiles; a float32 (B, tile, N2) tensor of the chain is
    410 MB at B = 512, tile = 256, N2 = 782 (the float64 Gram products
    twice that). Candidates are merged tile by tile in the first-minimum
    order of the flat rank i1 * N2 + i2 (``nnls._tile_topm`` /
    ``_merge_topm``), which does not depend on the tile. Returns (cand
    (B, M, 2) int32 [i1, i2], res (B, M) residuals of the normalized
    problem, y_sq (B,) raw ||y||^2)."""
    B, S, N1 = A1.shape
    N2 = A2.shape[2]
    A1p, _ = mfn._pad_cols(A1.float(), tile)
    A1h, _an1 = mfn._normalize_block(A1p)
    A2h, _an2 = mfn._normalize_block(A2.float())
    yh, yn, _ys = mfn._normalize_y(y.float())
    N1p = A1h.shape[2]
    tile = min(tile, N1p)

    qA1 = quantize2(A1h)
    qA2 = quantize2(A2h)
    qy = quantize2(yh)
    vec, diag = "bsn,bs->bn", "bsn,bsn->bn"
    d1 = df_gram(qA1, qA1, diag)
    d2 = df_gram(qA2, qA2, diag)
    p_ = df_gram(qA1, qy, vec)
    q_ = df_gram(qA2, qy, vec)
    w_ = df_gram(qy, qy, "bs,bs->b")
    w_ = (w_[0][:, None], w_[1][:, None])

    Rp2 = _mul(p_, p_)
    res1_row = _val(_add(_mul(d1, w_), _neg(Rp2))) / _val(d1)
    Cq2 = _mul(q_, q_)
    res2_col = _val(_add(_mul(d2, w_), _neg(Cq2))) / _val(d2)
    wf = _val(w_)[:, :, None]
    wv = (w_[0][:, :, None], w_[1][:, :, None])
    d2c = (d2[0][:, None, :], d2[1][:, None, :])
    qc = (q_[0][:, None, :], q_[1][:, None, :])
    d2w_q2 = _add(_mul(d2c, wv), _neg(_mul(qc, qc)))
    d2cf, qcf = _val(d2c), _val(qc)
    i2 = torch.arange(N2, device=y.device)

    vals = torch.full((B, M), math.inf, device=y.device)
    flats = torch.zeros((B, M), dtype=torch.int32, device=y.device)
    for st in range(0, N1p, tile):
        sl = slice(st, st + tile)
        rowd = lambda x: (x[0][:, sl, None], x[1][:, sl, None])
        aa = df_gram_tile(tuple(x[:, :, sl] for x in qA1), qA2, N2)
        d1t, pt, Rp2t = rowd(d1), rowd(p_), rowd(Rp2)
        num12 = _accumulate([
            _mul(d1t, d2w_q2), _neg(_mul(Rp2t, d2c)),
            _scale(_mul(aa, _mul(pt, qc)), 2.0),
            _neg(_mul(_mul(aa, aa), wv))])
        af, d1tf, ptf = _val(aa), _val(d1t), _val(pt)
        det12 = d1tf * d2cf - af * af
        w1D = d2cf * ptf - af * qcf
        w2D = d1tf * qcf - af * ptf
        res, _ = _two_var_cases(num12 / det12, w1D, w2D, ptf, qcf,
                                res1_row[:, sl, None], res2_col[:, None, :],
                                wf)
        i1 = torch.arange(st, st + tile, device=y.device)[:, None]
        res = torch.where(i1 < N1, res, math.inf)
        gflat = (i1 * N2 + i2[None, :]).reshape(1, -1)
        tv, tf = mfn._tile_topm(res.reshape(B, -1), gflat, M)
        vals, flats = mfn._merge_topm(vals, flats, tv, tf, M)
    cand = torch.stack([flats // N2, flats % N2], dim=2).to(torch.int32)
    return cand, vals, yn * yn


def _mul(x, y):
    return df32.df_mul(x, y)


def _add(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = df32.df_add(out, x)
    return out


def _neg(x):
    return df32.df_neg(x)


def _scale(x, k):
    return (x[0] * k, x[1] * k)  # k a power of two (exact)


def _val(x):
    return x[0] + x[1]


def _accumulate(terms):
    """Compensated sum of df terms -> f32 value."""
    hi = terms[0][0]
    lo = terms[0][1]
    for t in terms[1:]:
        hi, e = df32.two_sum(hi, t[0])
        lo = lo + (e + t[1])
    return hi + lo


def _sanit(x):
    return torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)


def _where(c, x, y):
    """jnp.where: tensors and python scalars broadcast; a python float
    takes the float32 of the tensors (or the default float32)."""
    return torch.where(c, x, y)


def _dfm(*dfs):
    out = dfs[0]
    for d in dfs[1:]:
        out = _mul(out, d)
    return out


# ---------------------------------------------------------------------------
# 4-block (2 fascicles + CSF + EAR) sub-supports, double-float values and
# float32 feasibility booleans (support enumeration)
# ---------------------------------------------------------------------------

def _sub1_df(d, p, w):
    """Support {a}: res = (d*w - p^2)/d, feasible iff p >= 0."""
    num = _val(_add(_mul(d, w), _neg(_mul(p, p))))
    res = num / _val(d)
    return _where(_val(p) >= 0, res, float("inf"))


def _sub2_df(dA, dB, g, pA, pB, w):
    """Support {a, b}: bordered 3x3 det / det2 with df-accurate
    determinant and weight-sign numerators, guarded at _TOL * dA * dB."""
    det2 = _val(_add(_mul(dA, dB), _neg(_mul(g, g))))
    num = _accumulate([
        _dfm(dA, dB, w), _neg(_dfm(g, g, w)),
        _scale(_dfm(g, pA, pB), 2.0),
        _neg(_dfm(dA, pB, pB)), _neg(_dfm(dB, pA, pA))])
    n1 = _accumulate([_mul(dB, pA), _neg(_mul(g, pB))])
    n2 = _accumulate([_mul(dA, pB), _neg(_mul(g, pA))])
    feas = ((det2 > _TOL * _val(dA) * _val(dB))
            & (n1 >= 0) & (n2 >= 0))
    return _where(feas, num / _where(feas, det2, 1.0), float("inf"))


def _sub3_df(dA, dB, dC, gAB, gAC, gBC, pA, pB, pC, w):
    """Support {a, b, c}: bordered 4x4 det / det3 through the
    quadratic-in-gAB expansion, float32 feasibility."""
    U1 = _add(_mul(pB, pB), _neg(_mul(dB, w)))
    U2 = _scale(_add(_mul(dB, pC), _neg(_mul(gBC, pB))), 2.0)
    U3 = _add(_mul(dB, _add(_mul(dC, w), _neg(_mul(pC, pC)))),
              _neg(_mul(dC, _mul(pB, pB))),
              _scale(_dfm(gBC, pB, pC), 2.0),
              _neg(_mul(_mul(gBC, gBC), w)))
    U4 = _add(_mul(gBC, gBC), _neg(_mul(dB, dC)))
    V1 = _scale(_add(_mul(gBC, w), _neg(_mul(pB, pC))), 2.0)
    V2 = _scale(_add(_mul(dC, pB), _neg(_mul(gBC, pC))), 2.0)
    C2 = _add(_mul(pC, pC), _neg(_mul(dC, w)))
    det4 = _accumulate([
        _dfm(gAC, gAC, U1), _dfm(gAC, pA, U2), _mul(dA, U3),
        _dfm(pA, pA, U4),
        _mul(gAB, _add(_mul(gAC, V1), _mul(pA, V2))),
        _mul(_mul(gAB, gAB), C2)])
    det3, D1, D2, D3 = _det3_cramer_df(gAB, dA, dB, dC, gAC, gBC,
                                       pA, pB, pC)
    feas = ((det3 > _TOL * _val(dA) * _val(dB) * _val(dC))
            & (D1 >= 0) & (D2 >= 0) & (D3 >= 0))
    return _where(feas, det4 / _where(feas, det3, 1.0), float("inf"))


def _det3_cramer_df(gAB, dA, dB, dC, gAC, gBC, pA, pB, pC):
    """3x3 Gram determinant and the three Cramer numerators, each a
    compensated sum of df products collapsed to float32."""
    X = _add(_mul(dB, dC), _neg(_mul(gBC, gBC)))
    Z = _add(_mul(gAB, dC), _neg(_mul(gBC, gAC)))
    W = _add(_mul(gAB, gBC), _neg(_mul(dB, gAC)))
    Y = _add(_mul(dA, dC), _neg(_mul(gAC, gAC)))
    V = _add(_mul(dA, gBC), _neg(_mul(gAC, gAB)))
    T = _add(_mul(dA, dB), _neg(_mul(gAB, gAB)))
    det3 = _accumulate([_mul(dA, X), _neg(_mul(gAB, Z)), _mul(gAC, W)])
    D1 = _accumulate([_mul(pA, X), _neg(_mul(pB, Z)), _mul(pC, W)])
    D2 = _accumulate([_neg(_mul(pA, Z)), _mul(pB, Y), _neg(_mul(pC, V))])
    D3 = _accumulate([_mul(pA, W), _neg(_mul(pB, V)), _mul(pC, T)])
    return det3, D1, D2, D3


def _two_var_cases(res_full, w1D, w2D, Y1, Y2, res1, res2, y_sq):
    """Reference 2-variable NNLS case selection with externally supplied
    (compensated) residual values; decision booleans in f32."""
    case1 = (w1D > 0) & (w2D > 0)
    case2 = ~case1 & (w1D >= 0) & (w2D <= 0)
    case3 = ~case1 & ~case2 & (w1D <= 0) & (w2D >= 0)
    case4 = ~case1 & ~case2 & ~case3 & (w1D < 0) & (w2D < 0)
    take1 = (case2 & (Y1 >= 0)) | (case4 & (Y1 > 0))
    take2 = (case3 & (Y2 >= 0)) | (case4 & (Y1 <= 0) & (Y2 > 0))
    res = _where(case1, _sanit(res_full),
                 _where(take1, res1, _where(take2, res2, y_sq)))
    return res, case1


# ---------------------------------------------------------------------------
# Exact small NNLS over gathered columns (the device finalize)
# ---------------------------------------------------------------------------

def _df_div(x, y):
    """Double-float division (one Newton correction)."""
    q0 = x[0] / y[0]
    p, e = df32.two_prod(q0, y[0])
    r_hi = (x[0] - p) - e + x[1] - q0 * y[1]
    q1 = r_hi / y[0]
    return df32.fast_two_sum(q0, q1)


def _df_det2(dA, dB, g):
    return _add(_mul(dA, dB), _neg(_mul(g, g)))


def _df_det3(m):
    """df determinant of a 3x3 nested df tuple list."""
    t1 = _mul(m[0][0], _add(_mul(m[1][1], m[2][2]),
                            _neg(_mul(m[1][2], m[2][1]))))
    t2 = _mul(m[0][1], _add(_mul(m[1][0], m[2][2]),
                            _neg(_mul(m[1][2], m[2][0]))))
    t3 = _mul(m[0][2], _add(_mul(m[1][0], m[2][1]),
                            _neg(_mul(m[1][1], m[2][0]))))
    return _add(t1, _neg(t2), t3)


def _df_det4(m):
    """df determinant of a 4x4 nested df tuple list (cofactor row 0)."""
    out = None
    for c in range(4):
        minor = [[m[r][cc] for cc in range(4) if cc != c]
                 for r in range(1, 4)]
        term = _mul(m[0][c], _df_det3(minor))
        if c % 2 == 1:
            term = _neg(term)
        out = term if out is None else _add(out, term)
    return out


def _df_cramer(G_S, Y_S):
    """df Cramer solve of a k x k symmetric system (k <= 4), unguarded
    like the reference; callers reject non-finite weights. Returns
    (w list of df, det df)."""
    k = len(Y_S)
    if k == 1:
        return [_df_div(Y_S[0], G_S[0][0])], G_S[0][0]
    if k == 2:
        det = _df_det2(G_S[0][0], G_S[1][1], G_S[0][1])
        n1 = _add(_mul(Y_S[0], G_S[1][1]), _neg(_mul(G_S[0][1], Y_S[1])))
        n2 = _add(_mul(G_S[0][0], Y_S[1]), _neg(_mul(Y_S[0], G_S[0][1])))
        return [_df_div(n1, det), _df_div(n2, det)], det
    detf = _df_det3 if k == 3 else _df_det4
    det = detf(G_S)
    ws = []
    for j in range(k):
        mj = [[(Y_S[r] if c == j else G_S[r][c]) for c in range(k)]
              for r in range(k)]
        ws.append(_df_div(detf(mj), det))
    return ws, det


def _df_quadres(w_y, G_S, Y_S, w_S):
    """Full quadratic-form residual y'y - 2 w'Y + w'G w in df."""
    terms = [w_y]
    k = len(Y_S)
    for a in range(k):
        terms.append(_scale(_mul(w_S[a], Y_S[a]), -2.0))
        terms.append(_mul(_mul(w_S[a], w_S[a]), G_S[a][a]))
        for b in range(a + 1, k):
            terms.append(_scale(_mul(_mul(w_S[a], w_S[b]), G_S[a][b]), 2.0))
    out = terms[0]
    for t in terms[1:]:
        out = _add(out, t)
    return out


def _df_where(c, x, y):
    return (_where(c, x[0], y[0]), _where(c, x[1], y[1]))


def _nan2inf(x):
    nan = torch.isnan(x[0])
    return (_where(nan, float("inf"), x[0]), _where(nan, 0.0, x[1]))


def _df_nnls2(w_y, dA, dB, g, pA, pB):
    """df mirror of the 2-variable NNLS (same case priority as
    ops/nnls.lsqnonneg_2var). Returns (w1 df, w2 df, res df)."""
    zero = (torch.zeros_like(w_y[0]), torch.zeros_like(w_y[1]))
    w1D = _add(_mul(dB, pA), _neg(_mul(g, pB)))
    w2D = _add(_mul(dA, pB), _neg(_mul(g, pA)))
    det = _df_det2(dA, dB, g)
    w1f = _df_div(w1D, det)
    w2f = _df_div(w2D, det)
    res_f = _df_quadres(w_y, ((dA, g), (g, dB)), (pA, pB), (w1f, w2f))
    w1o = _df_div(pA, dA)
    res1 = _df_quadres(w_y, ((dA,),), (pA,), (w1o,))
    w2o = _df_div(pB, dB)
    res2 = _df_quadres(w_y, ((dB,),), (pB,), (w2o,))

    c1 = (_val(w1D) > 0) & (_val(w2D) > 0)
    c2 = ~c1 & (_val(w1D) >= 0) & (_val(w2D) <= 0)
    c3 = ~c1 & ~c2 & (_val(w1D) <= 0) & (_val(w2D) >= 0)
    c4 = ~c1 & ~c2 & ~c3 & (_val(w1D) < 0) & (_val(w2D) < 0)
    t1 = (c2 & (_val(pA) >= 0)) | (c4 & (_val(pA) > 0))
    t2 = (c3 & (_val(pB) >= 0)) | (c4 & (_val(pA) <= 0) & (_val(pB) > 0))

    w1 = _df_where(c1, w1f, _df_where(t1, w1o, zero))
    w2 = _df_where(c1, w2f, _df_where(t2, w2o, zero))
    res = _df_where(c1, _nan2inf(res_f),
                    _df_where(t1, res1, _df_where(t2, res2, w_y)))
    return w1, w2, res


def _df_lt(a, b):
    """Lexicographic a < b on df pairs (hi, then lo)."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def _df_nnls3(w_y, G, p):
    """df mirror of the 3-variable NNLS (Cramer sign test + 2-subset
    fallback chain with first-strictly-better priority).
    Returns (w list of 3 df, res df)."""
    zero = (torch.zeros_like(w_y[0]), torch.zeros_like(w_y[1]))
    det = _df_det3(G)
    nums = []
    for j in range(3):
        mj = [[(p[r] if c == j else G[r][c]) for c in range(3)]
              for r in range(3)]
        nums.append(_df_det3(mj))
    D1, D2, D3 = nums
    w1f = _df_div(D1, det)
    w2f = _df_div(D2, det)
    w3f = _df_div(D3, det)
    full = ((_val(D1) >= -_TOL3) & (_val(D2) >= -_TOL3)
            & (_val(D3) >= -_TOL3))
    res_f = _nan2inf(_df_quadres(w_y, G, p, (w1f, w2f, w3f)))

    a12, b12, r12 = _df_nnls2(w_y, G[0][0], G[1][1], G[0][1], p[0], p[1])
    a13, b13, r13 = _df_nnls2(w_y, G[0][0], G[2][2], G[0][2], p[0], p[2])
    a23, b23, r23 = _df_nnls2(w_y, G[1][1], G[2][2], G[1][2], p[1], p[2])

    fb_w, fb_r = [a12, b12, zero], r12
    take13 = _df_lt(r13, fb_r)
    fb_w = [_df_where(take13, x, y) for x, y in zip([a13, zero, b13], fb_w)]
    fb_r = _df_where(take13, r13, fb_r)
    take23 = _df_lt(r23, fb_r)
    fb_w = [_df_where(take23, x, y) for x, y in zip([zero, a23, b23], fb_w)]
    fb_r = _df_where(take23, r23, fb_r)

    w = [_df_where(full, x, y) for x, y in zip([w1f, w2f, w3f], fb_w)]
    return w, _df_where(full, res_f, fb_r)


def _df_nnls4(w_y, G, p):
    """df mirror of the 4-variable NNLS: exhaustive support enumeration
    in ascending mask order with strict-improvement updates.
    Returns (w list of 4 df, res df)."""
    zero = (torch.zeros_like(w_y[0]), torch.zeros_like(w_y[1]))
    best_w = [zero, zero, zero, zero]
    best_r = w_y
    for mask in range(1, 16):
        S = [i for i in range(4) if mask >> i & 1]
        G_S = tuple(tuple(G[r][c] for c in S) for r in S)
        Y_S = tuple(p[i] for i in S)
        w_S, _det = _df_cramer(G_S, Y_S)
        feas = torch.ones_like(w_y[0], dtype=torch.bool)
        for wa in w_S:
            va = _val(wa)
            feas = feas & (va >= 0) & torch.isfinite(va)
        res = _df_quadres(w_y, G_S, Y_S, w_S)
        rv = _where(feas & ~torch.isnan(res[0]), res[0], float("inf"))
        res = (rv, _where(torch.isfinite(rv), res[1], 0.0))
        better = _df_lt(res, best_r)
        new_w = [zero] * 4
        for wi, i in zip(w_S, S):
            new_w[i] = wi
        best_w = [_df_where(better, x, y) for x, y in zip(new_w, best_w)]
        best_r = _df_where(better, res, best_r)
    return best_w, best_r


def df_nnls_cols(cols, y):
    """Exact small NNLS across gathered columns (C <= 4: the fascicle
    atoms, then the CSF and EAR columns where present).

    cols (B, S, C) f32 raw-scale columns; y (B, S) raw. Returns
    (w (B, C) f32 raw-scale weights, res (B,) f32 raw residual).
    Columns and signal are scaled by per-column powers of two (exact),
    one packed df Gram of [cols | y] gives G, A'y and y'y, and the
    closed-form solver runs with double-float values.
    """
    B, S, C = cols.shape
    if not 1 <= C <= 4:
        raise ValueError("df_nnls_cols takes 1 to 4 columns, got %d" % C)
    cols = cols.float()
    y = y.float()

    def pow2(m):
        return torch.exp2(torch.ceil(torch.log2(torch.clamp(m, min=1e-30))))

    sc = pow2(cols.abs().amax(dim=1))                       # (B, C)
    sy = pow2(y.abs().amax(dim=1))                          # (B,)
    cs = cols / sc[:, None, :]
    ys = y / sy[:, None]
    z = torch.cat([cs, ys[:, :, None]], dim=2)              # (B, S, C+1)
    qz = quantize2(z)
    Mh, Ml = df_gram(qz, qz, "bsi,bsj->bij")
    G = [[(Mh[:, i, j], Ml[:, i, j]) for j in range(C)] for i in range(C)]
    p = [(Mh[:, i, C], Ml[:, i, C]) for i in range(C)]
    w_y = (Mh[:, C, C], Ml[:, C, C])
    if C == 1:
        w0 = _df_div(p[0], G[0][0])
        pos = _val(p[0]) >= 0
        res = _df_quadres(w_y, ((G[0][0],),), (p[0],), (w0,))
        w_list = [(_where(pos, w0[0], 0.0), _where(pos, w0[1], 0.0))]
        res = _df_where(pos, res, w_y)
    elif C == 2:
        w1, w2, res = _df_nnls2(w_y, G[0][0], G[1][1], G[0][1], p[0], p[1])
        w_list = [w1, w2]
    elif C == 3:
        w_list, res = _df_nnls3(w_y, G, p)
    else:
        w_list, res = _df_nnls4(w_y, G, p)
    # undo the power-of-two scalings (exact)
    w = torch.stack([_val(wi) for wi in w_list], dim=1)
    w = w * (sy[:, None] / sc)
    return w, _val(res) * (sy * sy)

