"""Double-float Gram primitives and the exact small NNLS finalize.

PyTorch counterpart of the parts of
``microstructure_fingerprinting_tpu/ops/dfscan.py`` that the ported
buckets run:

  * ``quantize2`` / ``quantize3``: exact int8 level decompositions of
    normalized columns (X = s1*Q1 + s2*Q2 [+ s3*Q3] + R);
  * ``df_gram`` / ``df_gram_tile``: exact-product Grams combined
    error-free into (hi, lo) pairs;
  * ``df2_candidates``: the [N1, N2] scan of one fascicle + CSF and of
    two fascicles without CSF, and ``df3_candidates``, the [N1, N2, 1]
    scan that is the local scan of the atoms-axis sharded scan
    (``parallel/mesh.py``), in plain torch as the JAX package runs them
    in plain XLA;
  * the df helpers and ``_two_var_cases`` shared with the re-scans
    (``ops/rescan.py``), and the 4-block sub-support residuals
    ``_sub1_df``/``_sub2_df``/``_sub3_df`` of the EAR re-scan's hoists;
  * ``df_nnls_cols``: the winner's weights, objective and residual with
    double-float values and f32 decision booleans (the device finalize),
    for 1 to 4 columns, and ``finalize_top1``, the fit's whole finalize
    stage around it.

Two of these run hand-written kernels on CUDA tensors, the plain code
on CPU tensors (the JAX package runs both as plain XLA): ``df2_candidates``
at M = 1 launches kernel 9 (``csrc/df2hoist.cu``: ``df2_scan_operands``,
the hoists) and kernel 6 (``csrc/df2scan.cu``: ``df2_rows``; then
``df2_top1_from_rows``), ``df_nnls_cols`` kernel 7 (``csrc/finalize.cu``);
their plain versions are ``df2_hoist_twin``, ``df2_rows_twin`` /
``df2_candidates_plain`` and ``df_nnls_cols_twin``. The fit's finalize,
``finalize_top1`` (the winner's columns, ``df_nnls_cols`` and R^2: the
JAX package's ``models/fit._finalize_top1``), is kernel 7 alone on CUDA
tensors, ``finalize_top1_plain`` on CPU tensors. A failed build or
launch raises.

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
import torch.nn.functional as F

from . import df32
from . import kernels
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

    On CUDA tensors M = 1 is kernels 9 and 6 (``csrc/df2hoist.cu``,
    ``csrc/df2scan.cu``), the top-1 of ``df2_candidates_plain`` (by
    ``df2_scan_operands``, ``df2_rows`` and ``df2_top1_from_rows``); any
    other call is ``df2_candidates_plain``.
    Returns (cand (B, M, 2) int32 [i1, i2], res (B, M) residuals of the
    normalized problem, y_sq (B,) raw ||y||^2)."""
    if M == 1 and A1.is_cuda:
        return df2_row_minima(A1, A2, y, tile)[:3]
    return df2_candidates_plain(A1, A2, y, M, tile)


def df2_row_minima(A1, A2, y, tile=256):
    """The df2 scan's top-1 by its per-row minima, on any device: kernels
    9 and 6 on CUDA tensors (``df2_candidates`` at M = 1 there), their
    plain versions elsewhere. Returns (cand (B, 1, 2) int32, res (B, 1),
    y_sq (B,), row_val (B, N1p) the least residual of each row)."""
    ops, yn = df2_scan_operands(A1, A2, y, tile)
    rows = df2_rows if A1.is_cuda else df2_rows_twin
    row_val, row_i2 = rows(*ops, n1=A1.shape[2], n2=A2.shape[2])
    cand, vals = df2_top1_from_rows(row_val, row_i2, A2.shape[2], tile)
    return cand, vals, yn * yn, row_val


def df2_candidates_plain(A1, A2, y, M=8, tile=256):
    """``df2_candidates`` in plain torch, any M.

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
    A1h, A2h, yh, yn = df2_normalized(A1, A2, y, tile)
    qA1, qA2, rows, cols, w_ = _df2_hoists(A1h, A2h, yh)
    N1p = qA1[0].shape[2]
    tile = min(tile, N1p)
    col = lambda x: (x[0][:, None, :], x[1][:, None, :])
    colh = tuple(col(x) for x in cols[:3]) + (cols[3][:, None, :],)
    wv = (w_[0][:, :, None], w_[1][:, :, None])
    wf = _val(w_)[:, :, None]
    i2 = torch.arange(N2, device=y.device)

    vals = torch.full((B, M), math.inf, device=y.device)
    flats = torch.zeros((B, M), dtype=torch.int32, device=y.device)
    for st in range(0, N1p, tile):
        sl = slice(st, st + tile)
        rowd = lambda x: (x[0][:, sl, None], x[1][:, sl, None])
        aa = df_gram_tile(tuple(x[:, :, sl] for x in qA1), qA2, N2)
        rowh = tuple(rowd(x) for x in rows[:3]) + (rows[3][:, sl, None],)
        res = _df2_res(aa, rowh, colh, wv, wf)
        i1 = torch.arange(st, st + tile, device=y.device)[:, None]
        res = torch.where(i1 < N1, res, math.inf)
        gflat = (i1 * N2 + i2[None, :]).reshape(1, -1)
        tv, tf = mfn._tile_topm(res.reshape(B, -1), gflat, M)
        vals, flats = mfn._merge_topm(vals, flats, tv, tf, M)
    cand = torch.stack([flats // N2, flats % N2], dim=2).to(torch.int32)
    return cand, vals, yn * yn


def df2_normalized(A1, A2, y, tile=256):
    """The df2 scan's normalization, rows padded with zero atoms to a
    multiple of ``tile``. Returns (A1h, A2h, yh, y norm)."""
    A1p, _ = mfn._pad_cols(A1.float(), tile)
    A1h, _an1 = mfn._normalize_block(A1p)
    A2h, _an2 = mfn._normalize_block(A2.float())
    yh, yn, _ys = mfn._normalize_y(y.float())
    return A1h, A2h, yh, yn


def _df2_hoists(A1h, A2h, yh):
    """The df2 scan's quantize2 and per-row / per-column double-float
    factors of the normalized blocks. Returns (qA1, qA2, rows (d1, p,
    p^2, res1), cols (d2, q, d2 w - q^2, res2), w (hi, lo of (B, 1)))."""
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
    d2w_q2 = _add(_mul(d2, w_), _neg(_mul(q_, q_)))
    return (qA1, qA2, (d1, p_, Rp2, res1_row), (d2, q_, d2w_q2, res2_col),
            w_)


def _df2_res(aa, row, col, wv, wf):
    """The residual of the points of Gram ``aa`` (hi, lo): the
    compensated bordered 3x3 determinant of {1, 2} and the reference's
    2-variable case analysis over the single-atom residuals. ``row`` =
    (d1, p, p^2, res1) and ``col`` = (d2, q, d2 w - q^2, res2) broadcast
    against ``aa``, as do wv (y'y, hi and lo) and wf (its value)."""
    d1t, pt, Rp2t, res1 = row
    d2c, qc, d2w_q2, res2 = col
    num12 = _accumulate([
        _mul(d1t, d2w_q2), _neg(_mul(Rp2t, d2c)),
        _scale(_mul(aa, _mul(pt, qc)), 2.0),
        _neg(_mul(_mul(aa, aa), wv))])
    af, d1tf, ptf = _val(aa), _val(d1t), _val(pt)
    d2cf, qcf = _val(d2c), _val(qc)
    det12 = d1tf * d2cf - af * af
    w1D = d2cf * ptf - af * qcf
    w2D = d1tf * qcf - af * ptf
    res, _ = _two_var_cases(num12 / det12, w1D, w2D, ptf, qcf, res1, res2,
                            wf)
    return res


#: column tile of csrc/df2scan.cu (a grid with N2 = 1 takes its narrow
#: path, which needs rows in multiples of DF2_NARROW)
DF2_TN = 64
DF2_NARROW = 128


def df2_hoist_twin(A1h, A2h, yh, n2pb):
    """Plain PyTorch version of kernel 9: the df2 scan's operands from the
    normalized blocks A1h (B, S, N1p), A2h (B, S, N2) and yh (B, S), the
    columns zero-padded to ``n2pb``: (q1a, q2a, a1h, ra int8/f32
    (B, S, N1p) with a1h = a + R of quantize2; q1b, q2b, rb, ab
    (B, S, n2pb); row_pack (B, 8, N1p) = d1, p, p^2 (hi, lo each), res1,
    0; col_pack (B, 8, n2pb) = d2, q, d2 w - q^2 (hi, lo each), res2, 0;
    vox (B, 4) = w (hi, lo), its value, 0)."""
    N2 = A2h.shape[2]
    qA1, qA2, rows, cols, w_ = _df2_hoists(A1h, A2h, yh)
    pack = lambda h: torch.stack([h[0][0], h[0][1], h[1][0], h[1][1],
                                  h[2][0], h[2][1], h[3],
                                  torch.zeros_like(h[3])], dim=1)
    wf = _val(w_)
    vox = torch.cat([w_[0], w_[1], wf, torch.zeros_like(wf)], dim=1)
    padc = lambda x: F.pad(x, (0, n2pb - N2)).contiguous()
    return (qA1[0].contiguous(), qA1[1].contiguous(),
            (qA1[3] + qA1[2]).contiguous(), qA1[2].contiguous(),
            padc(qA2[0]), padc(qA2[1]), padc(qA2[2]), padc(qA2[3]),
            pack(rows).contiguous(), padc(pack(cols)), vox.contiguous())


#: kernels 8-12 take the row blocks' width N1p a multiple of it
#: (csrc/hoist.cuh kAtoms)
HOIST_ATOMS = 128
#: atoms a block of the atom launch of kernels 9 and 10 (csrc/hoist.cuh
#: kBA): their column blocks' width N2pb is a multiple of it (kernel 9's
#: [N, 1] grid, N2pb = 1, has none)
HOIST_BLOCK = 64
#: the strided parts every float64 Gram sum of kernels 9 and 10 runs in
#: (csrc/hoist.cuh kParts; testing.fdot_hoist_order)
HOIST_PARTS = 4
#: samples a chunk of the voxel's small columns that the voxel launch of
#: kernels 9 and 10 writes and their atom launch copies (csrc/hoist.cuh kSK,
#: ColChunk), and floats a chunk of one column: int32 levels (q1, q2),
#: float64 (R, a)
HOIST_CHUNK = 32
HOIST_CHUNK_COL = HOIST_CHUNK * (2 * 4 + 2 * 8) // 4


def hoist_chunks(B, S, n_cols, device):
    """The scratch of the voxel launch of kernels 9 and 10: (B, its chunks
    of ``n_cols`` small columns)."""
    return torch.empty(B, -(-S // HOIST_CHUNK) * n_cols * HOIST_CHUNK_COL,
                       dtype=torch.float32, device=device)


def df2_hoist_shapes(A1h, A2h, n2pb):
    """Raises ValueError unless kernel 9 takes the shapes: N1p a multiple
    of HOIST_ATOMS, 1 <= N2 <= n2pb, n2pb = 1 or a multiple of
    HOIST_BLOCK (every shape ``df2_cols`` gives)."""
    N1p, N2 = A1h.shape[2], A2h.shape[2]
    if (N1p % HOIST_ATOMS or not 1 <= N2 <= n2pb
            or (n2pb > 1 and n2pb % HOIST_BLOCK)):
        raise ValueError("unsupported df2 hoist shape (N1p %d, N2 %d, "
                         "N2pb %d)" % (N1p, N2, n2pb))


def _df2_hoist_cuda(A1h, A2h, yh, n2pb):
    A1h, A2h, yh = (x.contiguous() for x in (A1h, A2h, yh))
    B, S, N1p = A1h.shape
    N2 = A2h.shape[2]
    c = kernels.check
    c(A1h, torch.float32, (B, S, N1p), "A1h")
    c(A2h, torch.float32, (B, S, N2), "A2h")
    c(yh, torch.float32, (B, S), "yh")
    df2_hoist_shapes(A1h, A2h, n2pb)
    new = lambda *shape, dt=torch.float32: torch.empty(
        *shape, dtype=dt, device=A1h.device)
    q1a, q2a = (new(B, S, N1p, dt=torch.int8) for _ in range(2))
    a1h, ra = new(B, S, N1p), new(B, S, N1p)
    q1b, q2b = (new(B, S, n2pb, dt=torch.int8) for _ in range(2))
    rb, ab = new(B, S, n2pb), new(B, S, n2pb)
    row_pack, col_pack, vox = new(B, 8, N1p), new(B, 8, n2pb), new(B, 4)
    chunks = hoist_chunks(B, S, 1, A1h.device)
    kernels.launch("df2hoist", A1h, A2h, yh, q1a, q2a, a1h, ra, q1b, q2b,
                   rb, ab, row_pack, col_pack, vox, chunks, B, S, N1p, N2,
                   n2pb)
    return (q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox)


def df2_hoist(A1h, A2h, yh, n2pb):
    """Kernel 9 dispatch on the device of the blocks: CUDA tensors launch
    ``csrc/df2hoist.cu`` (or raise), CPU tensors run ``df2_hoist_twin``."""
    fn = _df2_hoist_cuda if A1h.is_cuda else df2_hoist_twin
    return fn(A1h, A2h, yh, n2pb)


def df2_cols(N2):
    """Kernel 6's column width: N2 = 1 on its narrow path, else N2 padded
    to a multiple of DF2_TN."""
    return N2 if N2 == 1 else int(math.ceil(N2 / DF2_TN) * DF2_TN)


def df2_scan_operands(A1, A2, y, tile=256):
    """Normalize (torch), then quantize and hoist for the df2 scan, as
    ``df2_candidates_plain`` does: kernel 9 on CUDA tensors, its plain
    version on CPU tensors. Rows are padded to a multiple of ``tile``
    (zero atoms), columns to one of DF2_TN where N2 > 1. Returns (kernel
    operands (``df2_hoist_twin``'s), y norm (B,))."""
    A1h, A2h, yh, yn = df2_normalized(A1, A2, y, tile)
    return df2_hoist(A1h, A2h, yh, df2_cols(A2.shape[2])), yn


def df2_scan_operands_plain(A1, A2, y, tile=256):
    """``df2_scan_operands`` with the hoists in plain torch on any device
    (kernel 9's plain version): the reference a card holds the kernel
    against."""
    A1h, A2h, yh, yn = df2_normalized(A1, A2, y, tile)
    return df2_hoist_twin(A1h, A2h, yh, df2_cols(A2.shape[2])), yn


def df2_rows_twin(q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack,
                  vox, n1, n2):
    """Plain PyTorch version of kernel 6: per row i1 of the [N1p, n2]
    grid the least residual in IEEE total order (``nnls._tile_topm``'s
    order) and its first i2; rows past n1 give (+inf, 0). Returns
    (row_val (B, N1p) f32, row_i2 (B, N1p) int32)."""
    e = "bsi,bsj->bij"
    t11 = idot(e, q1a, q1b)
    t12 = idot(e, q1a, q2b) + idot(e, q2a, q1b)
    t22 = idot(e, q2a, q2b)
    aa = df32.df_from_sum(
        t11.float() * 2.0 ** -14, t12.float() * 2.0 ** -22,
        t22.float() * 2.0 ** -30, fdot(e, a1h, rb), fdot(e, ra, ab))
    aa = (aa[0][:, :, :n2], aa[1][:, :, :n2])
    rows = lambda k: (row_pack[:, k][:, :, None],
                      row_pack[:, k + 1][:, :, None])
    cols = lambda k: (col_pack[:, k, :n2][:, None, :],
                      col_pack[:, k + 1, :n2][:, None, :])
    res = _df2_res(
        aa, (rows(0), rows(2), rows(4), row_pack[:, 6][:, :, None]),
        (cols(0), cols(2), cols(4), col_pack[:, 6, :n2][:, None, :]),
        (vox[:, 0][:, None, None], vox[:, 1][:, None, None]),
        vox[:, 2][:, None, None])
    j = torch.argmin(mfn._total_order_key(res), dim=2, keepdim=True)
    val = torch.gather(res, 2, j)[:, :, 0]
    row = torch.arange(val.shape[1], device=val.device)[None, :]
    return (torch.where(row < n1, val, math.inf),
            torch.where(row < n1, j[:, :, 0], 0).to(torch.int32))


def df2_rows(q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox,
             n1, n2):
    """Kernel 6 on CUDA operands of ``df2_scan_operands``: what
    ``df2_rows_twin`` returns."""
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
    c(row_pack, torch.float32, (B, 8, N1p), "row_pack")
    c(col_pack, torch.float32, (B, 8, N2pb), "col_pack")
    c(vox, torch.float32, (B, 4), "vox")
    if ((N2pb == 1 and (n2 != 1 or N1p % DF2_NARROW))
            or (N2pb > 1 and (N1p % 32 or N2pb % DF2_TN))):
        raise ValueError("unsupported df2 scan tiling (N1p %d, N2pb %d, "
                         "n2 %d)" % (N1p, N2pb, n2))
    row_val = torch.empty(B, N1p, dtype=torch.float32, device=q1a.device)
    row_i2 = torch.empty(B, N1p, dtype=torch.int32, device=q1a.device)
    kernels.launch("df2scan", q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack,
                   col_pack, vox, row_val, row_i2, B, S, N1p, N2pb, n1, n2)
    return row_val, row_i2


def df2_top1_from_rows(row_val, row_i2, n2, tile=256):
    """The top-1 of ``df2_candidates_plain`` from the per-row minima: in
    each ``tile``-row tile the first row of least total-order key (so
    the first (i1, i2) of the tile, as ``nnls._tile_topm``), then the
    tiles merged into the empty pool (+inf, rank 0) as
    ``nnls._merge_topm`` merges them (every NaN last, ties to the lowest
    flat rank i1 * n2 + i2). Returns (cand (B, 1, 2) int32, vals (B, 1))."""
    B, N1p = row_val.shape
    T = N1p // tile
    rv = row_val.reshape(B, T, tile)
    r = torch.argmin(mfn._total_order_key(rv), dim=2, keepdim=True)
    tv = torch.gather(rv, 2, r)[:, :, 0]
    ti2 = torch.gather(row_i2.reshape(B, T, tile), 2, r)[:, :, 0].long()
    ti1 = r[:, :, 0] + tile * torch.arange(T, device=r.device)[None, :]
    vals = torch.full((B, 1), math.inf, device=row_val.device)
    flats = torch.zeros((B, 1), dtype=torch.int32, device=row_val.device)
    vals, flats = mfn._merge_topm(vals, flats, tv,
                                  (ti1 * n2 + ti2).to(torch.int32), 1)
    cand = torch.stack([flats // n2, flats % n2], dim=2).to(torch.int32)
    return cand, vals


def df3_candidates(A1, A2, a3, y, M=8, tile=256):
    """Top-M candidates for [N1, N2, 1] with double-float selection: the
    supports {1, 2, 3} (a compensated bordered 4x4 determinant, Cramer
    signs of df accuracy, the ``_TOL_DET`` floor) and the fallback chain
    {1, 2}, {1, 3}, {2, 3} of the reference (mf_utils.py:548-593), in
    plain torch as the JAX package runs it in plain XLA. It is the exact
    top-M of the whole grid in first-minimum order (kernel 3 keeps a
    champion per row and segment instead), so it is the local scan of
    ``parallel/mesh.sharded_df3_candidates``.

    A1 (B, S, N1), A2 (B, S, N2), a3 (B, S, 1), y (B, S); the N1 axis in
    ``tile``-atom tiles, merged in the order of the flat rank i1 * N2 +
    i2 as in ``df2_candidates``. Returns (cand (B, M, 2) int32 [i1, i2],
    res (B, M) residuals of the normalized problem, y_sq (B,) raw
    ||y||^2)."""
    B, S, N1 = A1.shape
    N2 = A2.shape[2]
    A1p, _ = mfn._pad_cols(A1.float(), tile)
    A1h, _an1 = mfn._normalize_block(A1p)
    A2h, _an2 = mfn._normalize_block(A2.float())
    A3h, _an3 = mfn._normalize_block(a3.float())
    yh, yn, _ys = mfn._normalize_y(y.float())
    N1p = A1h.shape[2]
    tile = min(tile, N1p)

    qA1 = quantize2(A1h)
    qA2 = quantize2(A2h)
    qA3 = quantize2(A3h)
    qy = quantize2(yh)
    vec, diag = "bsn,bs->bn", "bsn,bsn->bn"
    d1 = df_gram(qA1, qA1, diag)                   # (B, N1p) df
    d2 = df_gram(qA2, qA2, diag)
    d3 = df_gram(qA3, qA3, diag)                   # (B, 1)
    p_ = df_gram(qA1, qy, vec)                     # Y1 (B, N1p)
    q_ = df_gram(qA2, qy, vec)                     # Y2 (B, N2)
    r_ = df_gram(qA3, qy, vec)                     # Y3 (B, 1)
    b_ = df_gram(qA1, qA3, "bsn,bsm->bn")          # g13 (B, N1p)
    c_ = df_gram(qA2, qA3, "bsn,bsm->bn")          # g23 (B, N2)
    w_ = df_gram(qy, qy, "bs,bs->b")               # y'y (B,)
    w_ = (w_[0][:, None], w_[1][:, None])

    # ---- voxel scalars ----
    C2v = _add(_mul(r_, r_), _neg(_mul(d3, w_)))       # r^2 - d3 w
    d3w_r2 = _neg(C2v)                                 # d3 w - r^2
    res3_only = _val(w_) - _val(r_) ** 2 / _val(d3)

    # ---- per-row (i1) df factors ----
    Rb2 = _mul(b_, b_)
    Rbp = _mul(b_, p_)
    Rp2 = _mul(p_, p_)
    res1_row = _val(_add(_mul(d1, w_), _neg(Rp2))) / _val(d1)
    det13 = _add(_mul(d1, d3), _neg(_mul(b_, b_)))
    num13 = _accumulate([
        _mul(_mul(d1, d3), w_), _neg(_mul(_mul(d1, r_), r_)),
        _neg(_mul(Rb2, w_)), _scale(_mul(_mul(b_, p_), r_), 2.0),
        _neg(_mul(d3, Rp2))])
    w1D_13 = _accumulate([_mul(d3, p_), _neg(_mul(b_, r_))])
    w2D_13 = _accumulate([_mul(d1, r_), _neg(_mul(b_, p_))])
    res13_row, _ = _two_var_cases(
        num13 / _val(det13), w1D_13, w2D_13, _val(p_), _val(r_),
        res1_row, res3_only, _val(w_))

    # ---- per-column (i2) df factors ----
    Cq2 = _mul(q_, q_)
    Cc2 = _mul(c_, c_)
    Ccq = _mul(c_, q_)
    U1 = _add(Cq2, _neg(_mul(d2, w_)))                 # q^2 - d2 w
    U2 = _scale(_add(_mul(d2, r_), _neg(Ccq)), 2.0)    # 2 (d2 r - c q)
    U3 = _add(_mul(d2, d3w_r2), _neg(_mul(d3, Cq2)),
              _scale(_mul(Ccq, r_), 2.0), _neg(_mul(Cc2, w_)))
    U4 = _add(Cc2, _neg(_mul(d2, d3)))                 # c^2 - d2 d3
    V1 = _scale(_add(_mul(c_, w_), _neg(_mul(q_, r_))), 2.0)
    V2 = _scale(_add(_mul(d3, q_), _neg(_mul(c_, r_))), 2.0)
    res2_col = _val(_add(_mul(d2, w_), _neg(Cq2))) / _val(d2)
    det23 = _add(_mul(d2, d3), _neg(Cc2))
    num23 = _accumulate([
        _mul(_mul(d2, d3), w_), _neg(_mul(_mul(d2, r_), r_)),
        _neg(_mul(Cc2, w_)), _scale(_mul(Ccq, r_), 2.0),
        _neg(_mul(d3, Cq2))])
    w1D_23 = _accumulate([_mul(d3, q_), _neg(_mul(c_, r_))])
    w2D_23 = _accumulate([_mul(d2, r_), _neg(_mul(c_, q_))])
    res23_col, _ = _two_var_cases(
        num23 / _val(det23), w1D_23, w2D_23, _val(q_), _val(r_),
        res2_col, res3_only, _val(w_))

    wf = _val(w_)[:, :, None]
    cold = lambda x: (x[0][:, None, :], x[1][:, None, :])
    vox = lambda x: (x[0][:, :, None], x[1][:, :, None])
    d2c, cc, qc = cold(d2), cold(c_), cold(q_)
    U1c, U2c, U3c, U4c = cold(U1), cold(U2), cold(U3), cold(U4)
    V1c, V2c = cold(V1), cold(V2)
    det23c = cold(det23)
    wv, rv, d3vv, C2vv = vox(w_), vox(r_), vox(d3), vox(C2v)
    qcf = _val(qc)
    r23c = res23_col[:, None, :]
    i2 = torch.arange(N2, device=y.device)

    vals = torch.full((B, M), math.inf, device=y.device)
    flats = torch.zeros((B, M), dtype=torch.int32, device=y.device)
    for st in range(0, N1p, tile):
        sl = slice(st, st + tile)
        rowd = lambda x: (x[0][:, sl, None], x[1][:, sl, None])
        aa = df_gram_tile(tuple(x[:, :, sl] for x in qA1), qA2, N2)
        d1t, bt, pt = rowd(d1), rowd(b_), rowd(p_)
        Rb2t, Rbpt, Rp2t = rowd(Rb2), rowd(Rbp), rowd(Rp2)

        # ---- support {1,2,3}: bordered 4x4 det, compensated ----
        qaa = _mul(aa, aa)
        det4 = _accumulate([
            _mul(Rb2t, U1c), _mul(Rbpt, U2c), _mul(d1t, U3c),
            _mul(Rp2t, U4c),
            _mul(aa, _add(_mul(bt, V1c), _mul(pt, V2c))),
            _mul(qaa, C2vv)])
        btcc = _mul(bt, cc)
        Zac = _add(_mul(aa, d3vv), _neg(btcc))         # a d3 - b c
        Wac = _add(_mul(aa, cc), _neg(_mul(d2c, bt)))  # a c - d2 b
        Vg = _add(_mul(d1t, cc), _neg(_mul(bt, aa)))   # d1 c - b a
        detG3a = _accumulate([
            _mul(d1t, det23c), _neg(_mul(qaa, d3vv)),
            _scale(_mul(aa, btcc), 2.0), _neg(_mul(Rb2t, d2c))])
        ok3 = detG3a > _TOL_DET
        res123 = torch.where(ok3, det4 / torch.where(ok3, detG3a, 1.0),
                             math.inf)
        # full-support feasibility: Cramer numerator signs, df-accurate
        D1 = _accumulate([_mul(pt, det23c), _neg(_mul(qc, Zac)),
                          _mul(rv, Wac)])
        D2 = _accumulate([_neg(_mul(pt, Zac)), _mul(qc, rowd(det13)),
                          _neg(_mul(rv, Vg))])
        D3 = _accumulate([_mul(pt, Wac), _neg(_mul(qc, Vg)),
                          _mul(rv, _add(_mul(d1t, d2c), _neg(qaa)))])
        full = (D1 >= -_TOL_DET) & (D2 >= -_TOL_DET) & (D3 >= -_TOL_DET)

        # ---- support {1,2}: bordered 3x3 det, compensated ----
        num12 = _accumulate([
            _mul(d1t, _add(_mul(d2c, wv), _neg(_mul(qc, qc)))),
            _neg(_mul(Rp2t, d2c)),
            _scale(_mul(aa, _mul(pt, qc)), 2.0),
            _neg(_mul(_mul(aa, aa), wv))])
        det12 = _accumulate([_mul(d1t, d2c), _neg(qaa)])
        w1D_12 = _accumulate([_mul(d2c, pt), _neg(_mul(aa, qc))])
        w2D_12 = _accumulate([_mul(d1t, qc), _neg(_mul(aa, pt))])
        res12, _ = _two_var_cases(num12 / det12, w1D_12, w2D_12, _val(pt),
                                  qcf, res1_row[:, sl, None],
                                  res2_col[:, None, :], wf)

        # fallback chain (reference priority: 12, then 13, then 23)
        res13_t = res13_row[:, sl, None].expand_as(res12)
        fb = torch.where(res13_t < res12, res13_t, res12)
        r23 = r23c.expand_as(fb)
        fb = torch.where(r23 < fb, r23, fb)

        res = torch.where(full, _sanit(res123), fb)
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


def _df_nnls4_supports(w_y, G, p):
    """The 15 non-empty supports of the 4-variable NNLS in ascending mask
    order: each one's weights (a list of 4 df, zero off the support) and
    its residual df, infinite (with a zero lo) unless every weight is
    finite and >= 0 and the residual a number. Kernel 7 solves them on
    lanes 1-15 of a warp (``csrc/finalize.cu``)."""
    zero = (torch.zeros_like(w_y[0]), torch.zeros_like(w_y[1]))
    out = []
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
        new_w = [zero] * 4
        for wi, i in zip(w_S, S):
            new_w[i] = wi
        out.append((new_w, res))
    return out


def _df_nnls4(w_y, G, p):
    """df mirror of the 4-variable NNLS: exhaustive support enumeration
    in ascending mask order with strict-improvement updates from the
    empty support (y'y). Returns (w list of 4 df, res df)."""
    zero = (torch.zeros_like(w_y[0]), torch.zeros_like(w_y[1]))
    best_w = [zero, zero, zero, zero]
    best_r = w_y
    for new_w, res in _df_nnls4_supports(w_y, G, p):
        better = _df_lt(res, best_r)
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
    closed-form solver runs with double-float values. CUDA tensors launch
    kernel 7 (``csrc/finalize.cu``) on the block, CPU tensors run
    ``df_nnls_cols_twin``.
    """
    if cols.is_cuda:
        return _df_nnls_cols_cuda(cols, y)
    return df_nnls_cols_twin(cols, y)


def _n_cols(C):
    if not 1 <= C <= 4:
        raise ValueError("df_nnls_cols takes 1 to 4 columns, got %d" % C)
    return C


def _finalize_launch(B, S, C, y, cols=None, gathered=None):
    """Kernel 7 on the columns of the block ``cols`` (B, S, C), or, with
    ``gathered`` = (D, cand, csf, ear, K, csf_on, ear_on), on the winner's
    columns it reads itself (and then R^2 too). Returns (w, res, r2 or
    None)."""
    y = y.float().contiguous()
    kernels.check(y, torch.float32, (B, S), "y")
    dev = y.device
    w = torch.empty(B, C, dtype=torch.float32, device=dev)
    res = torch.empty(B, dtype=torch.float32, device=dev)
    # the 3-variable Cramer tolerance as torch compares it: in float32
    tol3 = float(np.float32(-_TOL3))
    if cols is not None:
        kernels.launch("finalize", cols, None, None, None, None, y, w, res,
                       None, B, S, C, 0, 0, 0, 0, *([0] * 9), tol3)
        return w, res, None
    D, cand, csf, ear, K, csf_on, ear_on = gathered
    r2 = torch.empty(B, dtype=torch.float64, device=dev)
    strides = (tuple(D.stride()) + tuple(cand.stride())
               + ((csf.stride(0),) if csf_on else (0,))
               + (tuple(ear.stride()) if ear_on else (0, 0)))
    if max(strides) >= 2 ** 31:
        raise ValueError("finalize_top1: a stride of 2^31 elements or more")
    kernels.launch("finalize", None, D, cand, csf if csf_on else None,
                   ear if ear_on else None, y, w, res, r2, B, S, C, K,
                   int(csf_on), int(ear_on), cand.shape[1], *strides, tol3)
    return w, res, r2


def _df_nnls_cols_cuda(cols, y):
    B, S, C = cols.shape
    _n_cols(C)
    cols = cols.float().contiguous()
    kernels.check(cols, torch.float32, (B, S, C), "cols")
    return _finalize_launch(B, S, C, y, cols=cols)[:2]


def _df_system(cols, y):
    """The double-float system of ``df_nnls_cols``: the columns and the
    signal scaled by powers of two, ``quantize2``'d, and one packed df Gram
    of [cols | y]. Returns (G (C x C nested df), p = A'y (C df), y'y df,
    the columns' scales (B, C), the signal's (B,))."""
    B, S, C = cols.shape
    _n_cols(C)
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
    return G, p, (Mh[:, C, C], Ml[:, C, C]), sc, sy


def df_nnls_cols_twin(cols, y):
    """Plain PyTorch version of ``df_nnls_cols`` (kernel 7)."""
    C = cols.shape[2]
    G, p, w_y, sc, sy = _df_system(cols, y)
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


# ---------------------------------------------------------------------------
# The fit's finalize of the scan winner
# ---------------------------------------------------------------------------

def r_squared(y, y_rec):
    """Pearson correlation squared between measured and predicted signal,
    with the reference's guards (num_seq > 1, non-zero stds): the JAX
    package's ``models/fit._r_squared``."""
    n = y.shape[-1]
    yc = y - y.mean(dim=-1, keepdim=True)
    rc = y_rec - y_rec.mean(dim=-1, keepdim=True)
    num = (yc * rc).sum(dim=-1)
    den = torch.sqrt((yc * yc).sum(dim=-1) * (rc * rc).sum(dim=-1))
    ok = (den > 0) & (n > 1)
    r = torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                    torch.zeros_like(den))
    return r * r


def finalize_top1(D, sig_csf, sig_ear, y, cand, csf_on=False, ear_on=False,
                  K=2):
    """Double-float finalize of the scan winner (the JAX package's
    ``models/fit._finalize_top1``).

    D (B, K', S, N) rotated fascicle blocks (raw scale, K' >= K); sig_csf
    (S,) and sig_ear (S, E), each used only when its flag is set; y (B, S)
    raw; cand (B, C') winner, the fascicle indices first and, with
    ``ear_on``, the EAR atom last. Returns (w (B, C), obj (B,), r2 (B,)
    float64) for the columns (fascicle 1[, fascicle 2][, CSF][, EAR]),
    C = K + csf_on + ear_on. CUDA tensors launch kernel 7 once, which reads
    the winner's columns itself and computes R^2; CPU tensors run
    ``finalize_top1_plain``."""
    if y.is_cuda:
        return _finalize_top1_cuda(D, sig_csf, sig_ear, y, cand, csf_on,
                                   ear_on, K)
    return finalize_top1_plain(D, sig_csf, sig_ear, y, cand, csf_on, ear_on,
                               K)


def _finalize_top1_cuda(D, sig_csf, sig_ear, y, cand, csf_on, ear_on, K):
    B, S = y.shape
    C = _n_cols(K + int(csf_on) + int(ear_on))
    if D.dtype != torch.float32 or D.dim() != 4 or (
            D.shape[0], D.shape[2]) != (B, S) or D.shape[1] < K:
        raise ValueError("D must be float32 (B, >= K, S, N), got %s %s"
                         % (D.dtype, tuple(D.shape)))
    if cand.dim() != 2 or cand.shape[0] != B or (
            cand.shape[1] < K + int(ear_on)):
        raise ValueError("cand must be (B, >= K + ear_on), got %s"
                         % (tuple(cand.shape),))
    for name, t, shape, on in (("sig_csf", sig_csf, (S,), csf_on),
                               ("sig_ear", sig_ear, None, ear_on)):
        if on and (t is None or t.dtype != torch.float32 or t.shape[0] != S
                   or (shape is not None and tuple(t.shape) != shape)):
            raise ValueError("%s must be float32 with %d samples" % (name,
                                                                     S))
    if cand.dtype != torch.int64:
        cand = cand.long()
    return _finalize_launch(B, S, C, y, gathered=(D, cand, sig_csf, sig_ear,
                                                  K, csf_on, ear_on))


def winner_columns(D, sig_csf, sig_ear, cand, csf_on=False, ear_on=False,
                   K=2):
    """The winner's columns as a (B, S, C) block, ``finalize_top1``'s
    arguments: fascicle k's atom ``cand[:, k]`` of D[:, k], then the CSF
    signature and the EAR signature ``sig_ear[:, cand[:, -1]]`` where
    their flags are set."""
    B, S = D.shape[0], D.shape[2]
    cand = cand.long()
    cols = [torch.gather(D[:, k], 2,
                         cand[:, None, k:k + 1].expand(B, S, 1))
            for k in range(K)]
    if csf_on:
        cols.append(sig_csf[None, :, None].expand(B, S, 1))
    if ear_on:
        cols.append(sig_ear.t()[cand[:, -1]][:, :, None])
    return torch.cat(cols, dim=2)


def finalize_top1_plain(D, sig_csf, sig_ear, y, cand, csf_on=False,
                        ear_on=False, K=2):
    """Plain PyTorch version of ``finalize_top1``: the winner's columns
    gathered (``winner_columns``), ``df_nnls_cols_twin`` and R^2 in
    float64."""
    cols = winner_columns(D, sig_csf, sig_ear, cand, csf_on, ear_on, K)
    w, res = df_nnls_cols_twin(cols, y)
    # R^2 of a near-perfect fit is 1 - O(1e-7) and float32 sums would
    # round it by a few ulp: evaluate it in float64 (B x S work)
    y_rec = (cols.double() * w.double()[:, None, :]).sum(dim=2)
    return w, res, r_squared(y.double(), y_rec)
