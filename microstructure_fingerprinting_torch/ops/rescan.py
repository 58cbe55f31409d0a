"""Kernel 3: the double-float re-scan for [N1, N2, 1].

Counterpart of ``microstructure_fingerprinting_tpu/ops/pallas_dfscan.py``
(``row_scan_df3`` -> ``_kernel``/``_df_gram_ps``, ``n_segments``,
``candidates_from_rows``). Per (voxel, i1, i2):

    P       = [Q1a|Q2a]' [Q1b|Q2b]       exact int8 level products
    c1, c2  = A1h' Rb, Ra' ab            f32 cross products (float64 sums)
    (hi,lo) = error-free combine         double-float Gram g12
    res     = compensated bordered determinants + reference case logic
    out     = per-(row, segment) minimum residual + first-minimum i2

All per-row (i1) / per-column (i2) double-float factors are hoisted here
and arrive pre-split (df32.presplit). ``row_scan_df3`` dispatches the
per-point scan on the device of its inputs: CUDA tensors launch
``csrc/rescan3.cu`` (or raise), CPU tensors run ``rescan3_twin``.
"""

import math

import torch
import torch.nn.functional as F

from . import df32
from . import dfscan
from . import kernels
from . import nnls as mfn

_LANE = 128
_SEGMENTS = 8
#: columns per partial minimum written by the CUDA kernel; every segment
#: width (N2B / 8 with N2B a multiple of 128) is a multiple of it
CHUNK = 16
_INF = float("inf")


def _round_up(x, m):
    return int(math.ceil(x / m) * m)


def col_blocks(N2):
    """(NB, N2B): column blocks of at most ~512 columns, 128-aligned, NB
    dividing the segment count (the row pass and the re-scan share it)."""
    N2p = _round_up(N2, _LANE)
    NB = 1
    while N2p // NB > 512 and NB < _SEGMENTS:
        NB *= 2
    return NB, _round_up(int(math.ceil(N2p / NB)), _LANE)


def n_segments(N2, segments=_SEGMENTS):
    """Total per-row segment count of ``row_scan_df3``'s output."""
    return col_blocks(N2)[0] * segments


def candidates_from_rows(row_res, row_i2, segments=_SEGMENTS):
    """Top-1 (row, segment) minimum -> ((B, 1, 2) [i1, i2] candidates,
    (B, 1) residual values). The first minimum of the flattened
    segment-major (B, n_seg * N1p) array wins ties, as ``lax.top_k``
    does in the JAX package."""
    n1p = row_res.shape[1] // segments
    flat = torch.argmin(row_res, dim=1, keepdim=True)
    i1 = flat % n1p
    i2 = torch.gather(row_i2, 1, flat).long()
    return (torch.stack([i1, i2], dim=2),
            torch.gather(row_res, 1, flat))


def _ps_stack(dfs):
    comps = []
    for x in dfs:
        comps.extend(df32.presplit(x))
    return torch.stack(comps, dim=1)


def _hoists(A1h, A2h, A3h, yh):
    """Per-row / per-column / per-voxel double-float factors of the
    compensated chain. Returns (qA1, qA2, row_pack (B, 38, N1p),
    col_pack (B, 58, N2), vox (B, 24))."""
    qA1 = dfscan.quantize2(A1h)
    qA2 = dfscan.quantize2(A2h)
    qA3 = dfscan.quantize2(A3h)
    qy = dfscan.quantize2(yh)

    vec, diag = "bsn,bs->bn", "bsn,bsn->bn"
    g = dfscan.df_gram
    d1 = g(qA1, qA1, diag)
    d2 = g(qA2, qA2, diag)
    d3 = g(qA3, qA3, diag)
    p_ = g(qA1, qy, vec)
    q_ = g(qA2, qy, vec)
    r3 = g(qA3, qy, vec)
    b_ = g(qA1, qA3, "bsn,bsm->bn")
    c_ = g(qA2, qA3, "bsn,bsm->bn")
    w_ = g(qy, qy, "bs,bs->b")
    w_ = (w_[0][:, None], w_[1][:, None])

    mul, add, neg, sc = (dfscan._mul, dfscan._add, dfscan._neg,
                         dfscan._scale)
    val, acc = dfscan._val, dfscan._accumulate

    C2v = add(mul(r3, r3), neg(mul(d3, w_)))
    d3w_r2 = neg(C2v)

    Rb2 = mul(b_, b_)
    Rbp = mul(b_, p_)
    Rp2 = mul(p_, p_)
    res1_row = val(add(mul(d1, w_), neg(Rp2))) / val(d1)
    det13 = add(mul(d1, d3), neg(Rb2))
    num13 = acc([
        mul(mul(d1, d3), w_), neg(mul(mul(d1, r3), r3)),
        neg(mul(Rb2, w_)), sc(mul(mul(b_, p_), r3), 2.0),
        neg(mul(d3, Rp2))])
    res13_row = num13 / val(det13)
    w1D_13 = acc([mul(d3, p_), neg(mul(b_, r3))])
    w2D_13 = acc([mul(d1, r3), neg(mul(b_, p_))])
    r3v = val(r3)
    res3_only = val(w_) - r3v * r3v / val(d3)
    res13_row, _ = dfscan._two_var_cases(
        res13_row, w1D_13, w2D_13, val(p_), val(r3),
        res1_row, res3_only, val(w_))

    Cq2 = mul(q_, q_)
    Cc2 = mul(c_, c_)
    Ccq = mul(c_, q_)
    U1 = add(Cq2, neg(mul(d2, w_)))
    U2 = sc(add(mul(d2, r3), neg(Ccq)), 2.0)
    U3 = add(mul(d2, d3w_r2), neg(mul(d3, Cq2)),
             sc(mul(Ccq, r3), 2.0), neg(mul(Cc2, w_)))
    U4 = add(Cc2, neg(mul(d2, d3)))
    V1 = sc(add(mul(c_, w_), neg(mul(q_, r3))), 2.0)
    V2 = sc(add(mul(d3, q_), neg(mul(c_, r3))), 2.0)
    X1c = add(mul(d2, w_), neg(Cq2))
    res2_col = val(X1c) / val(d2)
    det23 = add(mul(d2, d3), neg(Cc2))
    num23 = acc([
        mul(mul(d2, d3), w_), neg(mul(mul(d2, r3), r3)),
        neg(mul(Cc2, w_)), sc(mul(Ccq, r3), 2.0), neg(mul(d3, Cq2))])
    res23_col = num23 / val(det23)
    w1D_23 = acc([mul(d3, q_), neg(mul(c_, r3))])
    w2D_23 = acc([mul(d2, r3), neg(mul(c_, q_))])
    res23_col, _ = dfscan._two_var_cases(
        res23_col, w1D_23, w2D_23, val(q_), val(r3),
        res2_col, res3_only, val(w_))

    wf = val(w_)
    rowD2a = add(mul(r3, b_), neg(mul(d3, p_)))        # r b - d3 p
    rowEG = add(mul(p_, b_), neg(mul(d1, r3)))         # p b - d1 r
    colB = add(mul(c_, r3), neg(mul(q_, d3)))          # c r - q d3
    colC = add(mul(q_, c_), neg(mul(r3, d2)))          # q c - r d2

    row_pack = torch.cat([
        _ps_stack([Rb2, Rbp, d1, Rp2, b_, p_, rowD2a, rowEG, det13]),
        torch.stack([res1_row, res13_row], dim=1)], dim=1).float()
    col_pack = torch.cat([
        _ps_stack([U1, U2, U3, U4, V1, V2, X1c, d2, q_, c_,
                   det23, colB, colC, Ccq]),
        torch.stack([res2_col, res23_col], dim=1)], dim=1).float()
    vox = []
    for x in (C2v, w_, d3, r3):
        vox.extend(df32.presplit(x))
    vox = torch.stack([v[:, 0] for v in vox] + [wf[:, 0]], dim=1).float()
    vox = F.pad(vox, (0, 24 - vox.shape[1]))
    return qA1, qA2, row_pack, col_pack, vox


def rescan3_twin(q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack,
                 vox, n2, segw):
    """Plain PyTorch version of the re-scan kernel: per-(row, segment)
    minimum residual and first-minimum global i2 over valid columns.
    Returns (res (B, n_seg, N1p) f32, idx (B, n_seg, N1p) int32)."""
    e = "bsi,bsj->bij"
    t11 = dfscan.idot(e, q1a, q1b)
    t12 = dfscan.idot(e, q1a, q2b) + dfscan.idot(e, q2a, q1b)
    t22 = dfscan.idot(e, q2a, q2b)
    g_hi, g_lo = df32.df_from_sum(
        t11.float() * 2.0 ** -14, t12.float() * 2.0 ** -22,
        t22.float() * 2.0 ** -30, dfscan.fdot(e, a1h, rb),
        dfscan.fdot(e, ra, ab))
    gh, gl = df32.split(g_hi)
    a_ps = (g_hi, g_lo, gh, gl)                            # (B, N1p, N2pb)

    rows = lambda k: tuple(row_pack[:, 4 * k + i][:, :, None]
                           for i in range(4))
    cols = lambda k: tuple(col_pack[:, 4 * k + i][:, None, :]
                           for i in range(4))
    (Rb2, Rbp, d1p, Rp2, b_p, p_p, rowD2a, rowEG, rowF) = (
        rows(k) for k in range(9))
    res1_row = row_pack[:, 36][:, :, None]
    res13_row = row_pack[:, 37][:, :, None]
    (U1, U2, U3, U4, V1, V2, X1c, d2p, q_p, c_p,
     colA, colB, colC, colH) = (cols(k) for k in range(14))
    res2_col = col_pack[:, 56][:, None, :]
    res23_col = col_pack[:, 57][:, None, :]
    vv = lambda k: vox[:, k][:, None, None]
    C2v = tuple(vv(k) for k in range(4))
    wv = tuple(vv(4 + k) for k in range(4))
    d3v = tuple(vv(8 + k) for k in range(4))
    r3v = tuple(vv(12 + k) for k in range(4))
    wf = vv(16)
    pf, qf = p_p[0], q_p[0]
    mps, two_sum, fts, pre = (df32.mul_ps, df32.two_sum, df32.fast_two_sum,
                              df32.presplit)
    nps = lambda t: (-t[0], -t[1])
    tol = dfscan._TOL_DET

    def acc(parts):
        hi, lo = parts[0]
        for p, e_ in parts[1:]:
            hi, s = two_sum(hi, p)
            lo = lo + (s + e_)
        return hi + lo

    # support {1,2,3}: compensated bordered 4x4
    m1 = mps(b_p, V1)
    m2 = mps(p_p, V2)
    s_hi, s_e = two_sum(m1[0], m2[0])
    s_ps = pre(fts(s_hi, s_e + m1[1] + m2[1]))
    a2 = mps(a_ps, a_ps)
    a2_ps = pre(fts(a2[0], a2[1]))
    det4 = acc([mps(Rb2, U1), mps(Rbp, U2), mps(d1p, U3), mps(Rp2, U4),
                mps(a_ps, s_ps), mps(a2_ps, C2v)])
    bc = mps(b_p, c_p)
    bc_ps = pre(fts(bc[0], bc[1]))
    m_abc = mps(a_ps, bc_ps)
    detG3 = acc([mps(d1p, colA), nps(mps(Rb2, d2p)),
                 (2.0 * m_abc[0], 2.0 * m_abc[1]), nps(mps(a2_ps, d3v))])
    ok3 = detG3 > tol
    res123 = dfscan._sanit(dfscan._where(
        ok3, det4 / dfscan._where(ok3, detG3, 1.0), _INF))

    # full-support feasibility (Cramer numerator signs, double-float)
    D1 = acc([mps(p_p, colA), mps(a_ps, colB), mps(b_p, colC)])
    D2 = acc([mps(a_ps, rowD2a), mps(rowEG, c_p), mps(rowF, q_p)])
    pc = mps(p_p, c_p)
    bq = mps(b_p, q_p)
    s3_hi, s3_e = two_sum(pc[0], bq[0])
    pcbq_ps = pre(fts(s3_hi, s3_e + pc[1] + bq[1]))
    D3 = acc([mps(a_ps, pcbq_ps), nps(mps(rowEG, d2p)),
              nps(mps(d1p, colH)), nps(mps(a2_ps, r3v))])
    full = (D1 >= -tol) & (D2 >= -tol) & (D3 >= -tol)

    # support {1,2}: compensated bordered 3x3
    m3 = mps(p_p, q_p)
    pq_ps = pre(fts(m3[0], m3[1]))
    ap_q = mps(a_ps, pq_ps)
    num12 = acc([mps(d1p, X1c), nps(mps(Rp2, d2p)),
                 (2.0 * ap_q[0], 2.0 * ap_q[1]), nps(mps(a2_ps, wv))])
    det12 = acc([mps(d1p, d2p), nps(a2)])
    ok12 = det12 > tol
    res12full = dfscan._sanit(dfscan._where(
        ok12, num12 / dfscan._where(ok12, det12, 1.0), _INF))
    w1D = acc([mps(d2p, p_p), nps(mps(a_ps, q_p))])
    w2D = acc([mps(d1p, q_p), nps(mps(a_ps, p_p))])
    res12 = dfscan._two_var_cases(res12full, w1D, w2D, pf, qf,
                                  res1_row, res2_col, wf)[0]

    # fallback chain (reference priority: 12, then 13, then 23)
    fb = res12
    fb = torch.where(res13_row < fb, res13_row, fb)
    fb = torch.where(res23_col < fb, res23_col, fb)
    res = torch.where(full, res123, fb)

    B, N1p, N2pb = res.shape
    col = torch.arange(N2pb, device=res.device)
    res = torch.where(col[None, None, :] < n2, res, _INF)
    res = res.reshape(B, N1p, N2pb // segw, segw)
    rmin = res.amin(dim=3)
    big = 2 ** 30
    colr = col.reshape(N2pb // segw, segw)[None, None]
    idx = torch.where(res == rmin[..., None], colr, big).amin(dim=3)
    idx = torch.where(torch.isfinite(rmin), idx, 0)
    return (rmin.transpose(1, 2).contiguous(),
            idx.transpose(1, 2).to(torch.int32).contiguous())


def _rescan3_cuda(q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack,
                  vox, n2, segw):
    B, S, N1p = q1a.shape
    N2pb = q1b.shape[2]
    c = kernels.check
    for t, n in ((q1a, "q1a"), (q2a, "q2a")):
        c(t, torch.int8, (B, S, N1p), n)
    for t, n in ((a1h, "a1h"), (ra, "ra")):
        c(t, torch.float32, (B, S, N1p), n)
    for t, n in ((q1b, "q1b"), (q2b, "q2b")):
        c(t, torch.int8, (B, S, N2pb), n)
    for t, n in ((rb, "rb"), (ab, "ab")):
        c(t, torch.float32, (B, S, N2pb), n)
    c(row_pack, torch.float32, (B, 38, N1p), "row_pack")
    c(col_pack, torch.float32, (B, 58, N2pb), "col_pack")
    c(vox, torch.float32, (B, 24), "vox")
    if segw % CHUNK or N1p % 32 or N2pb % 64:
        raise ValueError("unsupported re-scan tiling (segment width %d, "
                         "N1p %d, N2pb %d)" % (segw, N1p, N2pb))
    nch = N2pb // CHUNK
    cmin = torch.empty(B, N1p, nch, dtype=torch.float32, device=q1a.device)
    cidx = torch.empty(B, N1p, nch, dtype=torch.int32, device=q1a.device)
    kernels.launch("rescan3", q1a, q2a, a1h, ra, q1b, q2b, rb, ab,
                   row_pack, col_pack, vox, cmin, cidx,
                   B, S, N1p, N2pb, n2, dfscan._TOL_DET)
    # fold the 16-column chunks into segments: the first chunk holding
    # the segment minimum holds its first-minimum column
    k = segw // CHUNK
    cmin = cmin.reshape(B, N1p, nch // k, k)
    cidx = cidx.reshape(B, N1p, nch // k, k)
    rmin = cmin.amin(dim=3)
    idx = torch.where(cmin == rmin[..., None], cidx, 2 ** 30).amin(dim=3)
    idx = torch.where(torch.isfinite(rmin), idx, 0)
    return (rmin.transpose(1, 2).contiguous(),
            idx.transpose(1, 2).to(torch.int32).contiguous())


def rescan3_rows(*ops, n2, segw):
    """Kernel 3 dispatch on the device of the operands."""
    if ops[0].is_cuda:
        return _rescan3_cuda(*ops, n2=n2, segw=segw)
    return rescan3_twin(*ops, n2=n2, segw=segw)


def row_scan_df3_operands(A1, A2, a3, y, segments=_SEGMENTS):
    """Normalize, quantize and hoist for the re-scan. Returns (kernel
    operands tuple, segment width, y norm)."""
    B, S, N1 = A1.shape
    N2 = A2.shape[2]
    A1p, _ = mfn._pad_cols(A1.float(), _LANE)
    A1h, _ = mfn._normalize_block(A1p)
    A2h, _ = mfn._normalize_block(A2.float())
    A3h, _ = mfn._normalize_block(a3.float())
    yh, yn, _ = mfn._normalize_y(y.float())
    qA1, qA2, row_pack, col_pack, vox = _hoists(A1h, A2h, A3h, yh)
    NB, N2B = col_blocks(N2)
    padc = lambda x: F.pad(x, (0, NB * N2B - N2)).contiguous()
    ops = (qA1[0].contiguous(), qA1[1].contiguous(), A1h.contiguous(),
           qA1[2].contiguous(), padc(qA2[0]), padc(qA2[1]), padc(qA2[2]),
           padc(qA2[3]), row_pack.contiguous(), padc(col_pack),
           vox.contiguous())
    return ops, N2B // segments, yn


def row_scan_df3(A1, A2, a3, y, segments=_SEGMENTS):
    """Per-(row, segment) best candidate for [N1, N2, 1] with
    double-float selection. Returns (row_res (B, n_seg*N1p),
    row_i2 (B, n_seg*N1p), y_sq (B,)); consume with
    ``candidates_from_rows`` (segments = ``n_segments(N2)``)."""
    N1, N2 = A1.shape[2], A2.shape[2]
    ops, segw, yn = row_scan_df3_operands(A1, A2, a3, y, segments)
    res, idx = rescan3_rows(*ops, n2=N2, segw=segw)
    B, n_seg, N1p = res.shape
    row = torch.arange(N1p, device=res.device)[None, None, :]
    res = torch.where(row < N1, res, _INF)
    return (res.reshape(B, n_seg * N1p), idx.reshape(B, n_seg * N1p),
            yn * yn)
