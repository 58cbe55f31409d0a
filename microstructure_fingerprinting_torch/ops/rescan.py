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
and arrive pre-split (df32.presplit): the plain version multiplies by
Dekker's forms on the split halves, the CUDA kernel reads (hi, lo) only
and takes each product's error by a fused multiply-add, the same float
for every product above 2^-101. ``row_scan_df3`` dispatches the
per-point scan on the device of its inputs: CUDA tensors launch
``csrc/rescan3.cu`` (or raise), CPU tensors run ``rescan3_twin``.

Kernel 3's operands come from kernel 10 (``csrc/df3hoist.cu``): the JAX
function's prologue (quantize, Grams, the compensated chain, packs) in
one launch on CUDA tensors (``df3_hoist``), its plain version
``df3_hoist_twin`` (``_hoists``) on CPU tensors. Likewise kernel 5, the
4-block (EAR) re-scan (``row_scan_df4``), is fed by kernel 8
(``csrc/df4hoist.cu``, ``df4_hoist``; plain version ``df4_hoist_twin``,
``_df4_hoists``).
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


def col_blocks(N2, cap=512, nb_max=_SEGMENTS):
    """(NB, N2B): NB column blocks (a power of two below ``nb_max``,
    doubled while a block would exceed ``cap`` columns) of N2B columns,
    128-aligned. The defaults are the [N1, N2, 1] scans' (NB divides the
    re-scan's segment count); the EAR row pass takes (colcap, 16) and the
    EAR re-scan (256, 16), as in the JAX package."""
    N2p = _round_up(N2, _LANE)
    NB = 1
    while N2p // NB > cap and NB < nb_max:
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


def _acc(parts):
    """Compensated sum of (main, err) partials -> f32 value."""
    hi, lo = parts[0]
    for p, e_ in parts[1:]:
        hi, s = df32.two_sum(hi, p)
        lo = lo + (s + e_)
    return hi + lo


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
    acc = _acc

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


# ---------------------------------------------------------------------------
# kernel 10: the re-scan's operands (the prologue of row_scan_df3)
# ---------------------------------------------------------------------------

def df3_hoist_twin(A1h, A2h, A3h, yh, n2pb):
    """Plain PyTorch version of kernel 10: the re-scan's operands from the
    normalized blocks A1h (B, S, N1p), A2h (B, S, N2), A3h (B, S, 1) and
    yh (B, S), the columns zero-padded to ``n2pb``: (q1a, q2a, a1h = A1h,
    ra, q1b, q2b, rb, ab, row_pack (B, 38, N1p), col_pack (B, 58, n2pb),
    vox (B, 24)), the packs in ``_hoists``' layout."""
    N2 = A2h.shape[2]
    qA1, qA2, row_pack, col_pack, vox = _hoists(A1h, A2h, A3h, yh)
    padc = lambda x: F.pad(x, (0, n2pb - N2)).contiguous()
    return (qA1[0].contiguous(), qA1[1].contiguous(), A1h.contiguous(),
            qA1[2].contiguous(), padc(qA2[0]), padc(qA2[1]), padc(qA2[2]),
            padc(qA2[3]), row_pack.contiguous(), padc(col_pack),
            vox.contiguous())


def df3_hoist_shapes(A1h, A2h, A3h, n2pb):
    """Raises ValueError unless kernel 10 takes the shapes: N3 = 1, N1p a
    multiple of dfscan.HOIST_ATOMS, 1 <= N2 <= n2pb, n2pb a multiple of
    dfscan.HOIST_BLOCK (every shape kernel 3 takes on the card: 128 x 128
    to 782 x 782, and 782 x E, whose columns ``col_blocks`` pads to a
    multiple of 128)."""
    N1p, N2, N3 = A1h.shape[2], A2h.shape[2], A3h.shape[2]
    if (N3 != 1 or N1p % dfscan.HOIST_ATOMS or not 1 <= N2 <= n2pb
            or n2pb % dfscan.HOIST_BLOCK):
        raise ValueError("unsupported re-scan hoist shape (N1p %d, N2 %d, "
                         "N3 %d, N2pb %d)" % (N1p, N2, N3, n2pb))


def _df3_hoist_cuda(A1h, A2h, A3h, yh, n2pb):
    A1h, A2h, A3h, yh = (x.contiguous() for x in (A1h, A2h, A3h, yh))
    B, S, N1p = A1h.shape
    N2 = A2h.shape[2]
    c = kernels.check
    c(A1h, torch.float32, (B, S, N1p), "A1h")
    c(A2h, torch.float32, (B, S, N2), "A2h")
    c(A3h, torch.float32, (B, S, A3h.shape[2]), "A3h")
    c(yh, torch.float32, (B, S), "yh")
    df3_hoist_shapes(A1h, A2h, A3h, n2pb)
    new = lambda *shape, dt=torch.float32: torch.empty(
        *shape, dtype=dt, device=A1h.device)
    q1a, q2a = (new(B, S, N1p, dt=torch.int8) for _ in range(2))
    ra = new(B, S, N1p)
    q1b, q2b = (new(B, S, n2pb, dt=torch.int8) for _ in range(2))
    rb, ab = new(B, S, n2pb), new(B, S, n2pb)
    row_pack, col_pack, vox = new(B, 38, N1p), new(B, 58, n2pb), new(B, 24)
    chunks = dfscan.hoist_chunks(B, S, 2, A1h.device)
    kernels.launch("df3hoist", A1h, A2h, A3h, yh, q1a, q2a, ra, q1b, q2b,
                   rb, ab, row_pack, col_pack, vox, chunks, B, S, N1p, N2,
                   n2pb)
    return (q1a, q2a, A1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox)


def df3_hoist(A1h, A2h, A3h, yh, n2pb):
    """Kernel 10 dispatch on the device of the blocks: CUDA tensors launch
    ``csrc/df3hoist.cu`` (or raise), CPU tensors run ``df3_hoist_twin``."""
    fn = _df3_hoist_cuda if A1h.is_cuda else df3_hoist_twin
    return fn(A1h, A2h, A3h, yh, n2pb)


def df3_normalized(A1, A2, a3, y):
    """The re-scan's inputs to kernel 10, in torch: (A1h (rows
    zero-padded to a multiple of 128), A2h, A3h, yh, the columns' padded
    width n2pb, y norm)."""
    A1p, _ = mfn._pad_cols(A1.float(), _LANE)
    A1h, _ = mfn._normalize_block(A1p)
    A2h, _ = mfn._normalize_block(A2.float())
    A3h, _ = mfn._normalize_block(a3.float())
    yh, yn, _ = mfn._normalize_y(y.float())
    NB, N2B = col_blocks(A2.shape[2])
    return A1h, A2h, A3h, yh, NB * N2B, yn


def _df3_operands(hoist, A1, A2, a3, y, segments):
    *blocks, n2pb, yn = df3_normalized(A1, A2, a3, y)
    N2B = col_blocks(A2.shape[2])[1]
    return hoist(*blocks, n2pb), N2B // segments, yn


def row_scan_df3_operands(A1, A2, a3, y, segments=_SEGMENTS):
    """Normalize (torch), then quantize and hoist for the re-scan: kernel
    10 on CUDA tensors, its plain version on CPU tensors. Returns (kernel
    operands tuple, segment width, y norm)."""
    return _df3_operands(df3_hoist, A1, A2, a3, y, segments)


def row_scan_df3_operands_plain(A1, A2, a3, y, segments=_SEGMENTS):
    """``row_scan_df3_operands`` with the hoists in plain torch on any
    device (kernel 10's plain version): the reference a card holds the
    kernel against."""
    return _df3_operands(df3_hoist_twin, A1, A2, a3, y, segments)


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


# ---------------------------------------------------------------------------
# kernel 5: the double-float 4-block (EAR) re-scan
# ---------------------------------------------------------------------------

#: column tile of csrc/rescan4.cu: one partial (minimum, first flat index)
#: per row and TN4 columns; every EAR column block (N2B, a multiple of 128)
#: is a multiple of it
TN4 = 32


def df4_pack_sizes(n3, n4):
    """Entries of the 4-block re-scan's packs that the kernel reads, and
    how many of them, from the front, are (hi, lo, hh, hl) quadruples
    (``_df4_hoists``' layout): {"row": (n, quad), "col": (n, quad),
    "vox": n}."""
    nx, ns = n3 + n4, n3 * n4
    return {"row": (12 + 12 * nx + 20 * ns + 1, 12 + 12 * nx + 16 * ns),
            "col": (16 + 24 * nx + 4 * n3 + 13 * ns + 1,
                    16 + 24 * nx + 4 * n3 + 12 * ns),
            "vox": 4 + 6 * nx + 5 * ns}


# The staged layout of csrc/rescan4.cu (its PackMap and VoxMap): the kernel
# multiplies by fused multiply-add and never reads the split halves hh, hl,
# so shared memory holds (hi, lo) of each quadruple and the single floats.

def short_slots(n, quad):
    """Slots of a row or column pack of n entries, quad of them quadruples."""
    return quad // 2 + (n - quad)


def short_slot(e, quad):
    """Slot of pack entry e: hi or lo of a quadruple, or a single float."""
    if e < quad:
        if e % 4 >= 2:
            raise ValueError("entry %d is a split half: not staged" % e)
        return e // 4 * 2 + e % 4
    return quad // 2 + (e - quad)


def short_entry(s, quad):
    """Pack entry held by slot s."""
    return s // 2 * 4 + s % 2 if s < quad // 2 else quad + (s - quad // 2)


def vox_slots(n, nx):
    return n - 2 - 2 * nx


def vox_slot(e, nx):
    """Slot of voxel entry e: w's (hi, lo), per extra column x
    (hi, lo, dX, rX), then the per-sweep floats."""
    if e >= 4 + 6 * nx:
        return e - 2 - 2 * nx
    base, k = (0, e) if e < 4 else (2 + (e - 4) // 6 * 4, (e - 4) % 6)
    if k in (2, 3):
        raise ValueError("entry %d is a split half: not staged" % e)
    return base + (k if k < 2 else k - 2)


def vox_entry(s, nx):
    if s < 2:
        return s
    if s < 2 + 4 * nx:
        x, k = divmod(s - 2, 4)
        return 4 + 6 * x + (k if k < 2 else k + 2)
    return s + 2 + 2 * nx


def n_segments_df4(N2, segments=1):
    """Total per-row segment count of ``row_scan_df4``'s output."""
    return col_blocks(N2, 256, 16)[0] * segments


def df4_cell_segments(N2):
    """Segments a column block of ``row_scan_df4`` so that each is one
    ``TN4``-column tile of its kernel: the finest (row, segment) minima
    it writes."""
    return col_blocks(N2, 256, 16)[1] // TN4


def candidates_from_rows_df4(row_res, row_flat, NS, N4, N2, segments_total):
    """Top-1 from ``row_scan_df4``'s per-(row, segment) minima in the
    reference's (i1, i2, i3, i4) first-minimum product order: the
    smallest value, then among the entries equal to it the smallest
    global flat rank i1 * (N2 * NS) + i2 * NS + s. Returns
    (cand (B, 1, 4) int64 [i1, i2, i3, i4], vals (B, 1))."""
    B, L = row_res.shape
    n1p = L // segments_total
    pos_i1 = (torch.arange(L, device=row_res.device) % n1p)[None, :]
    gflat = pos_i1 * (N2 * NS) + row_flat.long()
    vals = row_res.amin(dim=1, keepdim=True)
    g = torch.where(row_res == vals, gflat, 2 ** 62).amin(dim=1,
                                                           keepdim=True)
    i1, rest = g // (N2 * NS), g % (N2 * NS)
    i2, s = rest // NS, rest % NS
    return torch.stack([i1, i2, s // N4, s % N4], dim=2), vals


def _df4_hoists(A1h, A2h, A3h, A4h, yh):
    """Normalized blocks -> (qA1, qA2, row_pack rows, col_pack rows,
    vox entries): the voxel/row/column LDL' factors, the hoisted
    sub-support minima and the presplit products of the 4-block
    re-scan, in the pack layout of the JAX package's ``row_scan_df4``."""
    B = A1h.shape[0]
    N1p, N2 = A1h.shape[2], A2h.shape[2]
    N3, N4 = A3h.shape[2], A4h.shape[2]
    NS, nx = N3 * N4, N3 + N4
    qA1, qA2, qA3, qA4, qy = (dfscan.quantize2(x)
                              for x in (A1h, A2h, A3h, A4h, yh))
    diag, vec, cross = "bsn,bsn->bn", "bsn,bs->bn", "bsn,bsm->bnm"
    dfg = dfscan.df_gram
    d1 = dfg(qA1, qA1, diag)
    d2 = dfg(qA2, qA2, diag)
    d3 = dfg(qA3, qA3, diag)                      # (B, N3)
    d4 = dfg(qA4, qA4, diag)                      # (B, N4)
    p_ = dfg(qA1, qy, vec)
    q_ = dfg(qA2, qy, vec)
    r3 = dfg(qA3, qy, vec)
    r4 = dfg(qA4, qy, vec)
    b3 = dfg(qA1, qA3, cross)                     # (B, N1p, N3)
    b4 = dfg(qA1, qA4, cross)
    c3 = dfg(qA2, qA3, cross)                     # (B, N2, N3)
    c4 = dfg(qA2, qA4, cross)
    g34 = dfg(qA3, qA4, cross)                    # (B, N3, N4)
    w0 = dfg(qy, qy, "bs,bs->b")
    w_ = (w0[0][:, None], w0[1][:, None])         # (B, 1)

    mul, add, neg, sc = (dfscan._mul, dfscan._add, dfscan._neg,
                         dfscan._scale)
    val, dfm = dfscan._val, dfscan._dfm
    tol = dfscan._TOL
    one_df = lambda x: (torch.ones_like(x[0]), torch.zeros_like(x[0]))
    safe_recip = lambda x, ok: dfscan._df_div(
        one_df(x), dfscan._df_where(ok, x, one_df(x)))
    ax = lambda x, sh: (x[0].reshape(sh), x[1].reshape(sh))
    cut = lambda x, *ix: (x[0][ix], x[1][ix])

    # ---- voxel/row/col LDL' hoists (order csf, ear, fasc1, fasc2) ----
    d3e, r3e = ax(d3, (B, 1, N3, 1)), ax(r3, (B, 1, N3, 1))
    d4e, r4e = ax(d4, (B, 1, 1, N4)), ax(r4, (B, 1, 1, N4))
    ge = ax(g34, (B, 1, N3, N4))
    w4 = ax(w0, (B, 1, 1, 1))
    invd3 = dfscan._df_div(one_df(d3e), d3e)
    L43 = mul(ge, invd3)
    D4h = add(d4e, neg(mul(ge, L43)))
    ok34 = val(D4h) > tol * val(d4e)
    invD4h = safe_recip(D4h, ok34)
    t4 = add(r4e, neg(mul(L43, r3e)))
    rho34 = add(w4, neg(mul(mul(r3e, r3e), invd3)),
                neg(mul(mul(t4, t4), invD4h)))

    d1e, p1e = ax(d1, (B, N1p, 1, 1)), ax(p_, (B, N1p, 1, 1))
    b3e = ax(b3, (B, N1p, N3, 1))
    b4e = (b4[0][:, :, None, :], b4[1][:, :, None, :])
    d2e, q2e = ax(d2, (B, N2, 1, 1)), ax(q_, (B, N2, 1, 1))
    c3e = ax(c3, (B, N2, N3, 1))
    c4e = (c4[0][:, :, None, :], c4[1][:, :, None, :])

    L13 = mul(b3e, invd3)
    e4r = add(b4e, neg(mul(L43, b3e)))
    L14 = mul(e4r, invD4h)
    D1h = add(d1e, neg(mul(b3e, L13)), neg(mul(e4r, L14)))
    rowok = val(D1h) > tol * val(d1e)
    invD1h = safe_recip(D1h, rowok)
    pi1 = add(p1e, neg(mul(L13, r3e)), neg(mul(L14, t4)))
    kap1 = mul(pi1, invD1h)
    rho1 = add(rho34, neg(mul(pi1, kap1)))        # (B, N1p, N3, N4)

    L23 = mul(c3e, invd3)
    e4c = add(c4e, neg(mul(L43, c3e)))
    L24 = mul(e4c, invD4h)
    d2r = add(d2e, neg(mul(c3e, L23)), neg(mul(e4c, L24)))
    q2r = add(q2e, neg(mul(L23, r3e)), neg(mul(L24, t4)))

    u3f = val(mul(r3e, invd3))                    # (B, 1, N3, 1)
    u4f = val(mul(t4, invD4h))                    # (B, 1, N3, N4)
    L43f = val(L43)

    # hoisted sub-support minima (folded into every sweep)
    S1, S2, S3 = dfscan._sub1_df, dfscan._sub2_df, dfscan._sub3_df
    r_fix = torch.minimum(S1(d3e, r3e, w4), S1(d4e, r4e, w4))
    r_fix = torch.minimum(r_fix, S2(d3e, d4e, ge, r3e, r4e, w4))
    r_fix = torch.broadcast_to(r_fix[:, 0], (B, N3, N4))
    r_row = torch.minimum(S2(d1e, d3e, b3e, p1e, r3e, w4),
                          S2(d1e, d4e, b4e, p1e, r4e, w4))
    r_row = torch.minimum(r_row, S3(d1e, d3e, d4e, b3e, b4e, ge, p1e, r3e,
                                    r4e, w4))
    r_row = torch.broadcast_to(r_row, (B, N1p, N3, N4))
    r_col = torch.minimum(S2(d2e, d3e, c3e, q2e, r3e, w4),
                          S2(d2e, d4e, c4e, q2e, r4e, w4))
    r_col = torch.minimum(r_col, S3(d2e, d3e, d4e, c3e, c4e, ge, q2e, r3e,
                                    r4e, w4))
    r_col = torch.broadcast_to(r_col, (B, N2, N3, N4))
    res1_row = S1(d1, p_, w_)                     # (B, N1p)
    res2_col = S1(d2, q_, w_)                     # (B, N2)

    # ---- presplit packing (layout read by the kernel and the twin) ----
    ps = df32.presplit
    p2 = mul(p_, p_)
    q2sq = mul(q_, q_)
    d2w = mul(d2, w_)
    xs_d = ([cut(d3, slice(None), slice(i, i + 1)) for i in range(N3)]
            + [cut(d4, slice(None), slice(i, i + 1)) for i in range(N4)])
    xs_r = ([cut(r3, slice(None), slice(i, i + 1)) for i in range(N3)]
            + [cut(r4, slice(None), slice(i, i + 1)) for i in range(N4)])
    xs_b = ([cut(b3, slice(None), slice(None), i) for i in range(N3)]
            + [cut(b4, slice(None), slice(None), i) for i in range(N4)])
    xs_c = ([cut(c3, slice(None), slice(None), i) for i in range(N3)]
            + [cut(c4, slice(None), slice(None), i) for i in range(N4)])
    sw = lambda z, i3, i4: cut(z, slice(None), slice(None), i3, i4)

    rows = list(ps(d1)) + list(ps(p_)) + list(ps(p2))
    for x in range(nx):
        bX = xs_b[x]
        rows += list(ps(bX)) + list(ps(mul(bX, bX))) + list(ps(mul(bX, p_)))
    for s in range(NS):
        i3, i4 = divmod(s, N4)
        for z in (e4r, kap1, invD1h, rho1):
            rows += list(ps(sw(z, i3, i4)))
    rows.append(res1_row)
    for s in range(NS):
        i3, i4 = divmod(s, N4)
        rows += [rowok[:, :, i3, i4].float(), val(L13)[:, :, i3, 0],
                 val(L14)[:, :, i3, i4]]
    for s in range(NS):
        i3, i4 = divmod(s, N4)
        rows.append(r_row[:, :, i3, i4])

    cols = list(ps(d2)) + list(ps(q_)) + list(ps(q2sq)) + list(ps(d2w))
    for x in range(nx):
        dX, rX, cX = xs_d[x], xs_r[x], xs_c[x]
        U2X = sc(add(mul(d2, rX), neg(mul(cX, q_))), 2.0)
        U3X = add(mul(d2, add(mul(dX, w_), neg(mul(rX, rX)))),
                  neg(mul(dX, q2sq)), sc(dfm(cX, q_, rX), 2.0),
                  neg(mul(mul(cX, cX), w_)))
        U4X = add(mul(cX, cX), neg(mul(d2, dX)))
        V1X = sc(add(mul(cX, w_), neg(mul(q_, rX))), 2.0)
        V2X = sc(add(mul(dX, q_), neg(mul(cX, rX))), 2.0)
        for z in (U2X, U3X, U4X, V1X, V2X, cX):
            cols += list(ps(z))
    for i3 in range(N3):
        cols += list(ps(sw(L23, i3, 0)))
    for s in range(NS):
        i3, i4 = divmod(s, N4)
        for z in (L24, d2r, q2r):
            cols += list(ps(sw(z, i3, i4)))
    cols.append(res2_col)
    for s in range(NS):
        i3, i4 = divmod(s, N4)
        cols.append(r_col[:, :, i3, i4])

    vox = [v[:, 0] for v in ps(w_)]
    for x in range(nx):
        dX, rX = xs_d[x], xs_r[x]
        C2X = add(mul(rX, rX), neg(mul(dX, w_)))
        vox += [v[:, 0] for v in ps(C2X)]
        vox += [val(dX)[:, 0], val(rX)[:, 0]]
    for s in range(NS):
        i3, i4 = divmod(s, N4)
        vox += [ok34[:, 0, i3, i4].float(), u3f[:, 0, i3, 0],
                u4f[:, 0, i3, i4], L43f[:, 0, i3, i4]]
    for s in range(NS):
        i3, i4 = divmod(s, N4)
        vox.append(r_fix[:, i3, i4])
    return qA1, qA2, rows, cols, vox


def rescan4_twin(q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack,
                 vox, n2, n3, n4, segw):
    """Plain PyTorch version of the 4-block re-scan kernel (the JAX
    package's ``_df4_kernel``): per point the {1,2} base with the
    hoisted row/column/empty minima, the {1,2,X} bordered determinants,
    and the NS {1,2,3,4} LDL' sweeps, the first strictly smaller sweep
    winning; per (row, segment) the minimum and its first flat index
    i2 * NS + s (0 where the minimum is +inf).
    Returns (res (B, n_seg, N1p) f32, flat (B, n_seg, N1p) int32)."""
    NS, nx = n3 * n4, n3 + n4
    INF = _INF
    mps, two_sum, fts, pre = (df32.mul_ps, df32.two_sum,
                              df32.fast_two_sum, df32.presplit)
    tol = dfscan._TOL
    sanit = dfscan._sanit
    e = "bsi,bsj->bij"
    t11 = dfscan.idot(e, q1a, q1b)
    t12 = dfscan.idot(e, q1a, q2b) + dfscan.idot(e, q2a, q1b)
    t22 = dfscan.idot(e, q2a, q2b)
    g_hi, g_lo = df32.df_from_sum(
        t11.float() * 2.0 ** -14, t12.float() * 2.0 ** -22,
        t22.float() * 2.0 ** -30, dfscan.fdot(e, a1h, rb),
        dfscan.fdot(e, ra, ab))
    a_ps = pre((g_hi, g_lo))                              # (B, N1p, N2pb)

    rp = lambda i: tuple(row_pack[:, i + k][:, :, None] for k in range(4))
    rf = lambda i: row_pack[:, i][:, :, None]
    cp = lambda i: tuple(col_pack[:, i + k][:, None, :] for k in range(4))
    cf = lambda i: col_pack[:, i][:, None, :]
    vp = lambda i: tuple(vox[:, i + k][:, None, None] for k in range(4))
    vf = lambda i: vox[:, i][:, None, None]
    r_ldl = 12 + 12 * nx
    r_res1 = r_ldl + 16 * NS
    r_ok = r_res1 + 1
    r_row0 = r_ok + 3 * NS
    c_x0 = 16
    c_l23 = c_x0 + 24 * nx
    c_ldl = c_l23 + 4 * n3
    c_res2 = c_ldl + 12 * NS
    c_col0 = c_res2 + 1
    v_x0 = 4
    v_s0 = v_x0 + 6 * nx
    v_fix0 = v_s0 + 4 * NS

    d1, p_, p2 = rp(0), rp(4), rp(8)
    d2, q_, q2, d2w = cp(0), cp(4), cp(8), cp(12)
    w_ = vp(0)
    d1f, pf = d1[0], p_[0]
    d2f, qf = d2[0], q_[0]
    wf = w_[0]
    af = a_ps[0]

    a2 = mps(a_ps, a_ps)
    a2_ps = pre(fts(a2[0], a2[1]))
    pq = mps(p_, q_)
    pq_ps = pre(fts(pq[0], pq[1]))

    # ---- base: {1,2} (unconstrained-sign feasibility), row/col/empty ----
    apq = mps(a_ps, pq_ps)
    t_a2w = mps(a2_ps, w_)
    t_d1q2 = mps(d1, q2)
    t_p2d2 = mps(p2, d2)
    num12 = _acc([mps(d1, d2w), (-t_a2w[0], -t_a2w[1]),
                  (2.0 * apq[0], 2.0 * apq[1]),
                  (-t_d1q2[0], -t_d1q2[1]), (-t_p2d2[0], -t_p2d2[1])])
    det2 = d1f * d2f - af * af
    n1w = d2f * pf - af * qf
    n2w = d1f * qf - af * pf
    feas12 = (det2 > tol * d1f * d2f) & (n1w >= 0) & (n2w >= 0)
    r12 = torch.where(feas12, num12 / torch.where(feas12, det2, 1.0), INF)
    base = torch.minimum(sanit(r12), rf(r_res1))
    base = torch.minimum(base, cf(c_res2))
    base = torch.minimum(base, wf)

    U1_ps = pre(df32.df_add((q2[0], q2[1]), (-d2w[0], -d2w[1])))

    # ---- supports {1,2,X} per extra column X (i3's first, then i4's) ----
    r1x = []
    for x in range(nx):
        bX, bX2, bXp = rp(12 + 12 * x), rp(16 + 12 * x), rp(20 + 12 * x)
        U2X, U3X, U4X = (cp(c_x0 + 24 * x + 4 * j) for j in range(3))
        V1X, V2X, cX = (cp(c_x0 + 24 * x + 4 * j) for j in range(3, 6))
        C2X = vp(v_x0 + 6 * x)
        dXf = vf(v_x0 + 6 * x + 4)
        rXf = vf(v_x0 + 6 * x + 5)
        m1 = mps(bX, V1X)
        m2 = mps(p_, V2X)
        s_hi, s_e = two_sum(m1[0], m2[0])
        s_ps = pre(fts(s_hi, s_e + m1[1] + m2[1]))
        det4 = _acc([mps(bX2, U1_ps), mps(bXp, U2X), mps(d1, U3X),
                     mps(p2, U4X), mps(a_ps, s_ps), mps(a2_ps, C2X)])
        bf, cfX = bX[0], cX[0]
        det3 = (d1f * (d2f * dXf - cfX * cfX) - af * (af * dXf - cfX * bf)
                + bf * (af * cfX - d2f * bf))
        D1 = (pf * (d2f * dXf - cfX * cfX) - qf * (af * dXf - cfX * bf)
              + rXf * (af * cfX - d2f * bf))
        D2 = (-pf * (af * dXf - bf * cfX) + qf * (d1f * dXf - bf * bf)
              - rXf * (d1f * cfX - af * bf))
        D3 = (pf * (af * cfX - bf * d2f) - qf * (d1f * cfX - bf * af)
              + rXf * (d1f * d2f - af * af))
        feas = ((det3 > tol * d1f * d2f * dXf)
                & (D1 >= 0) & (D2 >= 0) & (D3 >= 0))
        r1x.append(sanit(torch.where(
            feas, det4 / torch.where(feas, det3, 1.0), INF)))

    # ---- sweeps: {1,2,3,4} LDL' finish + per-sweep folds ----
    best = torch.full_like(af, INF)
    best_s = torch.zeros(af.shape, dtype=torch.int64, device=af.device)
    for s in range(NS):
        i3, i4 = divmod(s, n4)
        b3ps = rp(12 + 12 * i3)
        L23 = cp(c_l23 + 4 * i3)
        e4r, kap1, invD1h, rho1 = (rp(r_ldl + 16 * s + 4 * j)
                                   for j in range(4))
        L24, d2r, q2r = (cp(c_ldl + 12 * s + 4 * j) for j in range(3))
        ok34s, u3fs, u4fs, L43fs = (vf(v_s0 + 4 * s + j) for j in range(4))
        rowoks = rf(r_ok + 3 * s)
        L13fs = rf(r_ok + 3 * s + 1)
        L14fs = rf(r_ok + 3 * s + 2)

        m1 = mps(b3ps, L23)
        m2 = mps(e4r, L24)
        hi, er = two_sum(af, -m1[0])
        lo = a_ps[1] + er - m1[1]
        hi, er = two_sum(hi, -m2[0])
        NUM = fts(hi, lo + er - m2[1])
        NUM_ps = pre(NUM)
        n2d = mps(NUM_ps, NUM_ps)
        n2_ps = pre(fts(n2d[0], n2d[1]))
        tD = mps(n2_ps, invD1h)
        hi, er = two_sum(d2r[0], -tD[0])
        D2h = fts(hi, d2r[1] + er - tD[1])
        pointok = D2h[0] > tol * d2f
        D2hs = (torch.where(pointok, D2h[0], 1.0),
                torch.where(pointok, D2h[1], 0.0))
        uK = mps(NUM_ps, kap1)
        hi, er = two_sum(q2r[0], -uK[0])
        pi2 = fts(hi, q2r[1] + er - uK[1])
        pi2_ps = pre(pi2)
        p2q = mps(pi2_ps, pi2_ps)
        p2q_df = fts(p2q[0], p2q[1])
        # double-float division (dfscan._df_div, inlined)
        q0 = p2q_df[0] / D2hs[0]
        pdiv, ediv = df32.two_prod(q0, D2hs[0])
        r_hi = (p2q_df[0] - pdiv) - ediv + p2q_df[1] - q0 * D2hs[1]
        div = fts(q0, r_hi / D2hs[0])
        hi, er = two_sum(rho1[0], -div[0])
        res1234 = hi + (rho1[1] + er - div[1])
        pi2f = pi2[0]
        wb2 = pi2f / D2hs[0]
        L21f = NUM[0] * invD1h[0]
        wb1 = kap1[0] - L21f * wb2
        we4 = u4fs - L14fs * wb1 - L24[0] * wb2
        we3 = u3fs - L43fs * we4 - L13fs * wb1 - L23[0] * wb2
        feasF = ((ok34s > 0.5) & (rowoks > 0.5) & pointok
                 & (pi2f >= 0) & (wb1 >= 0) & (we4 >= 0) & (we3 >= 0))
        r1234 = torch.where(feasF, sanit(res1234), INF)

        res_s = torch.minimum(base, r1x[i3])
        res_s = torch.minimum(res_s, r1x[n3 + i4])
        res_s = torch.minimum(res_s, r1234)
        res_s = torch.minimum(res_s, rf(r_row0 + s))
        res_s = torch.minimum(res_s, cf(c_col0 + s))
        res_s = torch.minimum(res_s, vf(v_fix0 + s))
        res_s = sanit(res_s)
        upd = res_s < best
        best = torch.where(upd, res_s, best)
        best_s = torch.where(upd, s, best_s)

    # ---- per-(row, segment) minima and first flat index ----
    B, N1p, N2pb = best.shape
    col = torch.arange(N2pb, device=best.device)
    best = torch.where(col[None, None, :] < n2, best, INF)
    gflat = col[None, None, :] * NS + best_s
    best = best.reshape(B, N1p, N2pb // segw, segw)
    rmin = best.amin(dim=3)
    idx = torch.where(best == rmin[..., None],
                      gflat.reshape(B, N1p, N2pb // segw, segw),
                      2 ** 30).amin(dim=3)
    idx = torch.where(torch.isfinite(rmin), idx, 0)
    return (rmin.transpose(1, 2).contiguous(),
            idx.transpose(1, 2).to(torch.int32).contiguous())


def _rescan4_cuda(q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack,
                  vox, n2, n3, n4, segw):
    B, S, N1p = q1a.shape
    N2pb = q1b.shape[2]
    NR, NC, NV = row_pack.shape[1], col_pack.shape[1], vox.shape[1]
    c = kernels.check
    for t, n in ((q1a, "q1a"), (q2a, "q2a")):
        c(t, torch.int8, (B, S, N1p), n)
    for t, n in ((a1h, "a1h"), (ra, "ra")):
        c(t, torch.float32, (B, S, N1p), n)
    for t, n in ((q1b, "q1b"), (q2b, "q2b")):
        c(t, torch.int8, (B, S, N2pb), n)
    for t, n in ((rb, "rb"), (ab, "ab")):
        c(t, torch.float32, (B, S, N2pb), n)
    c(row_pack, torch.float32, (B, NR, N1p), "row_pack")
    c(col_pack, torch.float32, (B, NC, N2pb), "col_pack")
    c(vox, torch.float32, (B, NV), "vox")
    if segw % TN4 or N1p % 32 or N2pb % TN4:
        raise ValueError("unsupported re-scan tiling (segment width %d, "
                         "N1p %d, N2pb %d)" % (segw, N1p, N2pb))
    nch = N2pb // TN4
    cmin = torch.empty(B, N1p, nch, dtype=torch.float32, device=q1a.device)
    cidx = torch.empty(B, N1p, nch, dtype=torch.int32, device=q1a.device)
    kernels.launch("rescan4", q1a, q2a, a1h, ra, q1b, q2b, rb, ab,
                   row_pack, col_pack, vox, cmin, cidx,
                   B, S, N1p, N2pb, n2, n3, n4, NR, NC, NV, dfscan._TOL)
    # fold the column tiles into segments: the first tile holding the
    # segment minimum holds its first flat index
    k = segw // TN4
    cmin = cmin.reshape(B, N1p, nch // k, k)
    cidx = cidx.reshape(B, N1p, nch // k, k)
    rmin = cmin.amin(dim=3)
    idx = torch.where(cmin == rmin[..., None], cidx, 2 ** 30).amin(dim=3)
    idx = torch.where(torch.isfinite(rmin), idx, 0)
    return (rmin.transpose(1, 2).contiguous(),
            idx.transpose(1, 2).to(torch.int32).contiguous())


def rescan4_rows(*ops, n2, n3, n4, segw):
    """Kernel 5 dispatch on the device of the operands."""
    fn = _rescan4_cuda if ops[0].is_cuda else rescan4_twin
    return fn(*ops, n2=n2, n3=n3, n4=n4, segw=segw)


# ---------------------------------------------------------------------------
# kernel 8: the 4-block re-scan's operands (the prologue of row_scan_df4)
# ---------------------------------------------------------------------------

#: EAR columns kernel 8 takes at most (csrc/df4hoist.cu kMaxE)
DF4_HOIST_MAX_E = 16
#: floats of kernel 8's voxel scratch (csrc/df4hoist.cu kScr): (w, d3, r3,
#: 1/d3) in double-float, then 15 double-float factors an EAR column
DF4_VOX_SCRATCH = 8 + 30 * DF4_HOIST_MAX_E
#: kernel 8's chunks of the voxel's small columns (csrc/df4hoist.cu kSK,
#: ColChunk): samples a chunk, and floats a chunk (levels of 32 columns,
#: R and a of 40, a row a sample)
DF4_CHUNK = 32
DF4_COL_CHUNK = DF4_CHUNK * (2 * 32 + 2 * 40 * 4) // 4


def df4_pack_rows(n3, n4):
    """(NR, NC, NV): the sizes of the 4-block re-scan's row pack, column
    pack and voxel vector, ``df4_pack_sizes`` padded to multiples of 8."""
    s = df4_pack_sizes(n3, n4)
    return tuple(_round_up(n, 8) for n in (s["row"][0], s["col"][0],
                                           s["vox"]))


def df4_hoist_twin(A1h, A2h, A3h, A4h, yh, n2pb):
    """Plain PyTorch version of kernel 8: the 4-block re-scan's operands
    from the normalized blocks A1h (B, S, N1p), A2h (B, S, N2), A3h,
    A4h and yh (B, S), the columns zero-padded to ``n2pb``: (q1a, q2a,
    a1h = A1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox), the packs
    in ``_df4_hoists``' layout, padded with zero entries to multiples of
    8."""
    N2 = A2h.shape[2]
    qA1, qA2, rows, cols, vox = _df4_hoists(A1h, A2h, A3h, A4h, yh)
    pack = lambda xs: F.pad(torch.stack(xs, dim=1).float(),
                            (0, 0, 0, -len(xs) % 8))
    padc = lambda x: F.pad(x, (0, n2pb - N2)).contiguous()
    vox = torch.stack(vox, dim=1).float()
    return (qA1[0].contiguous(), qA1[1].contiguous(), A1h.contiguous(),
            qA1[2].contiguous(), padc(qA2[0]), padc(qA2[1]), padc(qA2[2]),
            padc(qA2[3]), pack(rows).contiguous(), padc(pack(cols)),
            F.pad(vox, (0, -vox.shape[1] % 8)).contiguous())


def df4_hoist_shapes(A1h, A2h, A3h, A4h, n2pb):
    """Raises ValueError unless kernel 8 takes the shapes: N3 = 1,
    1 <= N4 <= DF4_HOIST_MAX_E, N1p a multiple of dfscan.HOIST_ATOMS,
    1 <= N2 <= n2pb (every shape kernel 5 takes on the card)."""
    N1p, N2 = A1h.shape[2], A2h.shape[2]
    N3, N4 = A3h.shape[2], A4h.shape[2]
    if (N3 != 1 or not 1 <= N4 <= DF4_HOIST_MAX_E
            or N1p % dfscan.HOIST_ATOMS or not 1 <= N2 <= n2pb):
        raise ValueError("unsupported 4-block hoist shape (N1p %d, N2 %d, "
                         "N3 %d, N4 %d, N2pb %d)" % (N1p, N2, N3, N4, n2pb))


def _df4_hoist_cuda(A1h, A2h, A3h, A4h, yh, n2pb):
    A1h, A2h, A3h, A4h, yh = (x.contiguous() for x in (A1h, A2h, A3h, A4h,
                                                        yh))
    B, S, N1p = A1h.shape
    N2, N3, N4 = A2h.shape[2], A3h.shape[2], A4h.shape[2]
    c = kernels.check
    c(A1h, torch.float32, (B, S, N1p), "A1h")
    c(A2h, torch.float32, (B, S, N2), "A2h")
    c(A3h, torch.float32, (B, S, N3), "A3h")
    c(A4h, torch.float32, (B, S, N4), "A4h")
    c(yh, torch.float32, (B, S), "yh")
    df4_hoist_shapes(A1h, A2h, A3h, A4h, n2pb)
    NR, NC, NV = df4_pack_rows(N3, N4)
    new = lambda *shape, dt=torch.float32: torch.empty(
        *shape, dtype=dt, device=A1h.device)
    q1a, q2a = (new(B, S, N1p, dt=torch.int8) for _ in range(2))
    ra = new(B, S, N1p)
    q1b, q2b = (new(B, S, n2pb, dt=torch.int8) for _ in range(2))
    rb, ab = new(B, S, n2pb), new(B, S, n2pb)
    row_pack, col_pack, vox = new(B, NR, N1p), new(B, NC, n2pb), new(B, NV)
    scr = new(B, DF4_VOX_SCRATCH)
    cols = new(B, -(-S // DF4_CHUNK) * DF4_COL_CHUNK)
    kernels.launch("df4hoist", A1h, A2h, A3h, A4h, yh, q1a, q2a, ra, q1b,
                   q2b, rb, ab, row_pack, col_pack, vox, scr, cols, B, S, N1p,
                   N2, n2pb, N4, NR, NC, NV, dfscan._TOL)
    return (q1a, q2a, A1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox)


def df4_hoist(A1h, A2h, A3h, A4h, yh, n2pb):
    """Kernel 8 dispatch on the device of the blocks: CUDA tensors launch
    ``csrc/df4hoist.cu`` (or raise), CPU tensors run ``df4_hoist_twin``."""
    fn = _df4_hoist_cuda if A1h.is_cuda else df4_hoist_twin
    return fn(A1h, A2h, A3h, A4h, yh, n2pb)


def df4_normalized(A1, A2, a3, a4, y):
    """The 4-block re-scan's inputs to kernel 8, in torch: (A1h (rows
    zero-padded to a multiple of 128), A2h, A3h, A4h, yh, the columns'
    padded width n2pb, y norm)."""
    A1p, _ = mfn._pad_cols(A1.float(), _LANE)
    A1h, _ = mfn._normalize_block(A1p)
    A2h, _ = mfn._normalize_block(A2.float())
    A3h, _ = mfn._normalize_block(a3.float())
    A4h, _ = mfn._normalize_block(a4.float())
    yh, yn, _ = mfn._normalize_y(y.float())
    NB, N2B = col_blocks(A2.shape[2], 256, 16)
    return A1h, A2h, A3h, A4h, yh, NB * N2B, yn


def _df4_operands(hoist, A1, A2, a3, a4, y, segments):
    *blocks, n2pb, yn = df4_normalized(A1, A2, a3, a4, y)
    N2B = col_blocks(A2.shape[2], 256, 16)[1]
    return hoist(*blocks, n2pb), N2B // segments, yn


def row_scan_df4_operands(A1, A2, a3, a4, y, segments=1):
    """Normalize (torch), then quantize and hoist for the 4-block
    re-scan: kernel 8 on CUDA tensors, its plain version on CPU tensors.
    Returns (kernel operands tuple, segment width, y norm)."""
    return _df4_operands(df4_hoist, A1, A2, a3, a4, y, segments)


def row_scan_df4_operands_plain(A1, A2, a3, a4, y, segments=1):
    """``row_scan_df4_operands`` with the hoists in plain torch on any
    device (kernel 8's plain version): the reference a card holds the
    kernel against."""
    return _df4_operands(df4_hoist_twin, A1, A2, a3, a4, y, segments)


def row_scan_df4(A1, A2, a3, a4, y, segments=1):
    """Per-(row, segment) best candidate for [N1, N2, N3, N4] with
    double-float selection. Returns (row_res (B, n_seg*N1p),
    row_flat (B, n_seg*N1p) [= i2 * NS + s], y_sq (B,)); consume with
    ``candidates_from_rows_df4`` (segments_total =
    ``n_segments_df4(N2, segments)``)."""
    N1, N2 = A1.shape[2], A2.shape[2]
    N3, N4 = a3.shape[2], a4.shape[2]
    ops, segw, yn = row_scan_df4_operands(A1, A2, a3, a4, y, segments)
    res, idx = rescan4_rows(*ops, n2=N2, n3=N3, n4=N4, segw=segw)
    B, n_seg, N1p = res.shape
    row = torch.arange(N1p, device=res.device)[None, None, :]
    res = torch.where(row < N1, res, _INF)
    return (res.reshape(B, n_seg * N1p), idx.reshape(B, n_seg * N1p),
            yn * yn)
