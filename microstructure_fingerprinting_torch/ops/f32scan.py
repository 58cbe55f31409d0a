"""Two-pass exact candidate scan for [N1, N2, 1]: f32 interval row pass
(kernel 2) + double-float re-scan of the selected sub-grid (kernel 3).

PyTorch counterpart of ``microstructure_fingerprinting_tpu/ops/f32scan.py``
(``rowmin_3`` with ``pallas=True``, ``_select_rows``, ``_select_in_band``,
``df3_twopass``):

  pass 1  ``rowmin_3``: the prep kernel (ops/prep.py) normalizes and
          quantizes both rotated blocks and hoists their Grams; the row
          pass kernel (``csrc/rowmin3.cu``) forms every (i1, i2) Gram
          entry exactly (int8 level products + bf16 corrections, summed
          in the TPU kernel's fixed order) and bounds the residuals of the
          supports {1,2} and {1,2,3} by progressive-elimination chains
          with the radius KERR * (1 + s + s^2). Per-row [lo, up] minima
          and per-column lo minima come back as per-block partials folded
          here with ``amin``.
  select  rows (and columns) whose lower bound can still beat the global
          upper bound, index-ascending, index 0 forced; ``ok`` is False
          when more than R - 1 qualify.
  pass 2  ``rescan.row_scan_df3`` on the gathered R rows (x R columns).
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import df32
from . import dfscan
from . import kernels
from . import nnls as mfn
from . import prep as pp
from . import rescan
from ..utils.profiling import stage

_EPS = float(np.float32(1.1920929e-07))
_TOL = float(np.float32(100 * 1.1920929e-07))
#: per-candidate f32 error radius = KERR * (1 + s + s^2), calibrated on the
#: exact-Gram error model (the Gram's fixed sum order below is part of it)
KERR = float(np.float32(8 * 1.1920929e-07))
_INF = float("inf")
_PTILE = 128       # rows per tile
#: block tile of csrc/rowmin3.cu (rows x columns): it writes one partial
#: row minimum per TN columns and one partial column minimum per TM rows
TM, TN = 32, 64


def _w(c, x, y):
    return dfscan._where(c, x, y)


def _interval(feas, stab, res, ws):
    """(lo, up) for one support of the K=3 case logic: feasible ->
    res +- KERR*(1+ws); unstable pivot -> [-KERR, +inf); infeasible ->
    no contribution."""
    err = KERR * (1.0 + ws)
    res = dfscan._sanit(res)
    lo = _w(feas, res - err, _w(stab, _INF, -KERR))
    up = _w(feas, res + err, _INF)
    return lo, up


def _sub1(d, p, w):
    """Support {a} (diagonal ~1 after normalization): interval."""
    wa = p / d
    return _interval(wa >= 0, torch.ones_like(wa, dtype=torch.bool),
                     w - p * wa, torch.abs(wa))


def _sub2(dA, dB, g, pA, pB, w):
    """Support {a, b}, eliminating a (diag ~1) then b; no determinant
    gate (the K=3 case logic keeps the unguarded reference branch)."""
    invA = 1.0 / dA
    piv = dB - g * g * invA
    stab = piv > _EPS * dB
    invP = _w(stab, 1.0 / _w(stab, piv, 1.0), 0.0)
    t = pB - g * pA * invA
    wb = t * invP
    wa = (pA - g * wb) * invA
    feas = stab & (piv > 0.0 * dB) & (wa >= 0) & (wb >= 0)
    res = w - pA * pA * invA - t * wb
    return _interval(feas, stab, res, torch.abs(wa) + torch.abs(wb))


def _fold(lo, up, lo2, up2):
    return torch.minimum(lo, lo2), torch.minimum(up, up2)


def _gram3_hi(qa, qb, contract):
    """Exact-rounded f32 Gram from two quantize3 decompositions (the
    small rhs x rhs Grams): integer level products grouped by scale plus
    the two bf16 corrections, combined error-free."""
    Q1a, Q2a, Q3a, Ra, aa = qa
    Q1b, Q2b, Q3b, Rb, ab = qb
    ei = lambda x, y: dfscan.idot(contract, x, y)
    bf = lambda x: x.to(torch.bfloat16).float()
    t11 = ei(Q1a, Q1b)
    t12 = ei(Q1a, Q2b) + ei(Q2a, Q1b)
    t22 = ei(Q2a, Q2b) + ei(Q1a, Q3b) + ei(Q3a, Q1b)
    t23 = ei(Q2a, Q3b) + ei(Q3a, Q2b)
    t33 = ei(Q3a, Q3b)
    c1 = dfscan.fdot(contract, bf(aa + Ra), bf(Rb))
    c2 = dfscan.fdot(contract, bf(Ra), bf(ab))
    return df32.df_from_sum(
        t11.float() * 2.0 ** -14, t12.float() * 2.0 ** -22,
        t22.float() * 2.0 ** -30, c1, c2,
        t23.float() * 2.0 ** -38, t33.float() * 2.0 ** -46)[0]


def _untile(X):
    """(B, nt, S, T) -> (B, S, nt*T)."""
    B, nt, S, T = X.shape
    return X.permute(0, 2, 1, 3).reshape(B, S, nt * T)


def _levels(q123):
    """(B, nt, S, 3T) int8 packs -> three (B, S, nt*T) level tensors."""
    T = q123.shape[3] // 3
    return [_untile(q123[..., l * T:(l + 1) * T]) for l in range(3)]


def _gram_hi(q123, a1bf, rabf, qb3, rbbf, abbf):
    """Exact Gram (rounded to f32) of the row pass: the nine int8 level
    products grouped by scale, two bf16 corrections, and the fixed
    ascending sum v_a + (v_b + (v_c + (c1 + (c2 + (v_d + v_e)))))."""
    Qa = _levels(q123)
    Qb = _levels(qb3)
    P = lambda i, j: dfscan.idot("bsi,bsj->bij", Qa[i], Qb[j])
    t11 = P(0, 0)
    t12 = P(0, 1) + P(1, 0)
    t22 = P(1, 1) + P(0, 2) + P(2, 0)
    t23 = P(1, 2) + P(2, 1)
    t33 = P(2, 2)
    v_a = t11.float() * 2.0 ** -14
    v_b = t12.float() * 2.0 ** -22
    v_c = t22.float() * 2.0 ** -30
    v_d = t23.float() * 2.0 ** -38
    v_e = t33.float() * 2.0 ** -46
    c1 = dfscan.fdot("bsi,bsj->bij", _untile(a1bf).float(),
                     _untile(rbbf).float())
    c2 = dfscan.fdot("bsi,bsj->bij", _untile(rabf).float(),
                     _untile(abbf).float())
    return v_a + (v_b + (v_c + (c1 + (c2 + (v_d + v_e)))))


def rowmin3_twin(q123, a1bf, rabf, qb3, rbbf, abbf, row_pack, col_pack,
                 vox, n1, n2):
    """Plain PyTorch version of the row-pass kernel.

    Returns (lo_row (B, N1p), up_row (B, N1p), lo_col (B, N2pb)): per-row
    minima over valid columns folded with the row-support seeds
    (row_pack rows 9, 10), and per-column lo minima over valid rows."""
    a = _gram_hi(q123, a1bf, rabf, qb3, rbbf, abbf)       # (B, N1p, N2pb)
    rp = lambda i: row_pack[:, i][:, :, None]
    (d1t, invd1t, kap_pt, rho1t, kap_bt, d1pt, invd1pt, kap_ppt,
     rho13t, lo_rt, up_rt, stab1t) = (rp(i) for i in range(12))
    cp = lambda i: col_pack[:, i][:, None, :]
    d2c, qc, cc, d2pc, q2pc, kapcc = (cp(i) for i in range(6))
    u3v = vox[:, 0][:, None, None]
    invd3v = vox[:, 1][:, None, None]
    KER = KERR

    # support {1,2}
    pivA = d2c - a * a * invd1t
    stabA = pivA > _EPS * d2c
    invA = _w(stabA, 1.0 / _w(stabA, pivA, 1.0), 0.0)
    tA = qc - a * kap_pt
    w2 = tA * invA
    w1 = kap_pt - a * invd1t * w2
    feas12 = stabA & (torch.minimum(w1, w2) > 0)
    res12 = dfscan._sanit(rho1t - tA * w2)
    s12 = w1 + w2
    err12 = KER * (1.0 + s12 + s12 * s12)
    lo = _w(feas12, res12 - err12, _w(stabA, _INF, -KER))
    up = _w(feas12, res12 + err12, _INF)

    # support {1,2,3}
    ap = a - kap_bt * cc
    pivB = d2pc - ap * ap * invd1pt
    stabB = (stab1t > 0.5) & (pivB > _EPS * d2c)
    invB = _w(stabB, 1.0 / _w(stabB, pivB, 1.0), 0.0)
    tB = q2pc - ap * kap_ppt
    w2f = tB * invB
    w1f = kap_ppt - ap * invd1pt * w2f
    w3f = u3v - kap_bt * w1f - kapcc * w2f
    tolw = _TOL * invd3v * invd1pt * invB
    feas123 = stabB & (torch.minimum(torch.minimum(w1f, w2f), w3f) >= -tolw)
    res123 = dfscan._sanit(rho13t - tB * w2f)
    s123 = torch.abs(w1f) + torch.abs(w2f) + torch.abs(w3f)
    err123 = KER * (1.0 + s123 + s123 * s123)
    lo = torch.minimum(lo, _w(feas123, res123 - err123,
                              _w(stabB, _INF, -KER)))
    up = torch.minimum(up, _w(feas123, res123 + err123, _INF))

    B, N1p, N2pb = a.shape
    col = torch.arange(N2pb, device=a.device)[None, None, :]
    row = torch.arange(N1p, device=a.device)[None, :, None]
    lo = _w(col < n2, lo, _INF)
    up = _w(col < n2, up, _INF)
    lo_row = torch.minimum(lo_rt[:, :, 0], lo.amin(dim=2))
    up_row = torch.minimum(up_rt[:, :, 0], up.amin(dim=2))
    lo_col = _w(row < n1, lo, _INF).amin(dim=1)
    return lo_row, up_row, lo_col


def _rowmin3_cuda(q123, a1bf, rabf, qb3, rbbf, abbf, row_pack, col_pack,
                  vox, n1, n2):
    B, nt, S, T3 = q123.shape
    T = T3 // 3
    NB, N2B = qb3.shape[1], qb3.shape[3] // 3
    N1p, N2pb = nt * T, NB * N2B
    if T % TM or N2B % TN:
        raise ValueError("row tile %d / column block %d not multiples of "
                         "the kernel tile %dx%d" % (T, N2B, TM, TN))
    c = kernels.check
    c(q123, torch.int8, (B, nt, S, 3 * T), "q123")
    c(a1bf, torch.bfloat16, (B, nt, S, T), "a1bf")
    c(rabf, torch.bfloat16, (B, nt, S, T), "rabf")
    c(qb3, torch.int8, (B, NB, S, 3 * N2B), "qb3")
    c(rbbf, torch.bfloat16, (B, NB, S, N2B), "rbbf")
    c(abbf, torch.bfloat16, (B, NB, S, N2B), "abbf")
    c(row_pack, torch.float32, (B, 16, N1p), "row_pack")
    c(col_pack, torch.float32, (B, 8, N2pb), "col_pack")
    c(vox, torch.float32, (B, 8), "vox")
    dev = q123.device
    # blocks run in no order: each writes its own partial minima
    part_row = torch.empty(B, N2pb // TN, 2, N1p, dtype=torch.float32,
                           device=dev)
    part_col = torch.empty(B, N1p // TM, N2pb, dtype=torch.float32,
                           device=dev)
    kernels.launch("rowmin3", q123, a1bf, rabf, qb3, rbbf, abbf, row_pack,
                   col_pack, vox, part_row, part_col,
                   B, S, N1p, T, NB, N2B, n1, n2)
    lo_row = torch.minimum(row_pack[:, 9], part_row[:, :, 0].amin(dim=1))
    up_row = torch.minimum(row_pack[:, 10], part_row[:, :, 1].amin(dim=1))
    return lo_row, up_row, part_col.amin(dim=1)


def rowmin3_rows(q123, a1bf, rabf, qb3, rbbf, abbf, row_pack, col_pack,
                 vox, n1, n2):
    """Kernel 2 dispatch: CUDA tensors launch ``csrc/rowmin3.cu`` (or
    raise), CPU tensors run ``rowmin3_twin``."""
    if q123.is_cuda:
        return _rowmin3_cuda(q123, a1bf, rabf, qb3, rbbf, abbf, row_pack,
                             col_pack, vox, n1, n2)
    return rowmin3_twin(q123, a1bf, rabf, qb3, rbbf, abbf, row_pack,
                        col_pack, vox, n1, n2)


def rowmin_3_operands(A1, A2, a3, y):
    """Prep (kernel 1, twice) and the hoisted chain prefixes of the row
    pass. Returns (kernel operands tuple, (lo_c_sup, upf))."""
    N2 = A2.shape[2]
    NB, N2B = rescan.col_blocks(N2)
    A3h, _ = mfn._normalize_block(a3)
    yh, _yn, _ys = mfn._normalize_y(y)
    rhs_q, rhs_r, rhs_a, q3s = pp.pack_rhs([yh, A3h[:, :, 0]])
    A1p, _ = pp.pad_block(A1.float(), _PTILE)
    A2p = F.pad(A2.float(), (0, NB * N2B - N2))
    q123_t, a1bf_t, rabf_t, _x, gramA = pp.prep_block(
        A1p, rhs_q, rhs_r, rhs_a, _PTILE, planes="xr", n_rhs=2)
    qb3, _x2, rbbf, abbf, gramB = pp.prep_block(
        A2p, rhs_q, rhs_r, rhs_a, N2B, planes="ra", n_rhs=2)
    d1, p_, b_ = gramA[:, 0], gramA[:, 1], gramA[:, 2]     # (B, N1p)
    d2, q_, c_ = gramB[:, 0], gramB[:, 1], gramB[:, 2]     # (B, N2pb)
    d3 = _gram3_hi(q3s[1], q3s[1], "bs,bs->b")
    r_ = _gram3_hi(q3s[1], q3s[0], "bs,bs->b")
    w_ = _gram3_hi(q3s[0], q3s[0], "bs,bs->b")

    e1 = lambda x: x[:, None]
    d3e, re, we = e1(d3), e1(r_), e1(w_)
    # per-row intervals of the block-1 supports {1}, {1,3}
    lo_row, up_row = _sub1(d1, p_, we)
    lo_row, up_row = _fold(lo_row, up_row, *_sub2(d1, d3e, b_, p_, re, we))
    # block-1-free floor: supports {2}, {2,3}, {3}, {}
    _lo3, up3 = _sub1(d3e, re, we)
    upf = torch.minimum(up3[:, 0], w_ + KERR)
    loc_, upc_ = _sub1(d2, q_, we)
    loc2, upc2 = _sub2(d2, d3e, c_, q_, re, we)
    upf = torch.minimum(upf, torch.minimum(upc_, upc2).amin(dim=1))
    lo_c_sup = torch.minimum(loc_, loc2)

    # hoists of the per-point progressive chains
    invd1 = 1.0 / d1
    kap_p = p_ * invd1
    rho1 = we - p_ * kap_p
    invd3 = 1.0 / d3e
    kap_b = b_ * invd3
    d1p = d1 - b_ * kap_b
    stab1 = d1p > _EPS * d1
    invd1p = _w(stab1, 1.0 / _w(stab1, d1p, 1.0), 0.0)
    p1p = p_ - kap_b * re
    kap_pp = p1p * invd1p
    rho13 = (we - re * re * invd3) - p1p * kap_pp
    u3 = re * invd3
    d2p = d2 - c_ * c_ * invd3
    q2p = q_ - c_ * (re * invd3)
    kap_c = c_ * invd3

    rowv = [d1, invd1, kap_p, rho1, kap_b, d1p, invd1p, kap_pp, rho13,
            lo_row, up_row, stab1.float()]
    row_pack = F.pad(torch.stack(rowv, dim=1), (0, 0, 0, 4)).contiguous()
    col_pack = F.pad(torch.stack([d2, q_, c_, d2p, q2p, kap_c], dim=1),
                     (0, 0, 0, 2)).contiguous()
    vox = F.pad(torch.stack([u3[:, 0], invd3[:, 0]], dim=1),
                (0, 6)).contiguous()                       # (B, 8)
    ops = (q123_t, a1bf_t, rabf_t, qb3, rbbf, abbf, row_pack, col_pack,
           vox)
    return ops, (lo_c_sup, upf)


def rowmin_3(A1, A2, a3, y, colmin=False):
    """f32 per-row residual intervals for [N1, N2, 1].

    A1 (B, S, N1), A2 (B, S, N2), a3 (B, S, 1), y (B, S). Returns
    (lo (B, N1), up (B, N1), up_floor (B,)) — per-row interval bounds of
    min_{i2} over the supports containing block 1, and the per-voxel
    upper bound of the block-1-free supports — plus, with ``colmin``, the
    per-column lower bounds lo_col (B, N2)."""
    N1, N2 = A1.shape[2], A2.shape[2]
    with stage("prep", A1.device):
        ops, (lo_c_sup, upf) = rowmin_3_operands(A1, A2, a3, y)
    with stage("row pass", A1.device):
        lo, up, lo_col = rowmin3_rows(*ops, n1=N1, n2=N2)
    row = torch.arange(lo.shape[1], device=lo.device)[None, :]
    lo = _w(row < N1, lo, _INF)[:, :N1]
    up = _w(row < N1, up, _INF)[:, :N1]
    if not colmin:
        return lo, up, upf
    return lo, up, upf, torch.minimum(lo_col[:, :N2], lo_c_sup[:, :N2])


def _select_rows(lo, up, up_floor, R):
    """Rows whose block-1 lower bound can still beat the global upper
    bound U = min(min_rows up, up_floor), index-ascending, row 0 forced.
    Returns (rows (B, R) int64, ok (B,) bool)."""
    U = torch.minimum(up.amin(dim=1), up_floor)[:, None]
    return _select_in_band(lo, U, R)


def _select_in_band(lo, U, R):
    """Indices with lo <= U, ascending, then the out-of-band indices
    ascending as filler; index 0 forced in. ``ok`` is False when more
    than R - 1 indices are in band (counted before forcing index 0).
    Requires N >= R. Returns (sel (B, R) int64, ok (B,) bool)."""
    in_band = lo <= U
    ok = in_band.sum(dim=1) <= R - 1
    ib = in_band.clone()
    ib[:, 0] = True
    N = lo.shape[1]
    idx = torch.arange(N, device=lo.device)
    # stable ascending sort on (out-of-band, index) keys
    key = (~ib).long() * N + idx[None, :]
    sel = torch.sort(key, dim=1).indices[:, :R]
    return sel, ok


def _gather_cols(A, sel):
    """A[b, :, sel[b]] -> (B, S, R)."""
    return torch.gather(A, 2, sel[:, None, :].expand(-1, A.shape[1], -1))


def df3_twopass(A1, A2, a3, y, M=1, R=128):
    """Two-pass exact top-1 for [N1, N2, 1]: f32 interval row pass ->
    double-float re-scan of the in-band rows (and, when N2 > R, columns).
    Returns (cand (B, 1, 2) int64, res (B, 1), y_sq (B,), ok (B,) bool).
    Where ``ok`` is False the caller re-solves the voxel with a larger
    R (the selection guarantee covers in-budget voxels only)."""
    if M != 1:
        raise NotImplementedError("df3_twopass computes the top-1 only")
    N2 = A2.shape[2]
    prune_cols = N2 > R
    if prune_cols:
        lo, up, up_floor, lo_col = rowmin_3(A1, A2, a3, y, colmin=True)
    else:
        lo, up, up_floor = rowmin_3(A1, A2, a3, y)
    with stage("selection", A1.device):
        rows, ok = _select_rows(lo, up, up_floor, R)
        A1_sel = _gather_cols(A1, rows)
        if prune_cols:
            U = torch.minimum(up.amin(dim=1), up_floor)[:, None]
            cols, ok_c = _select_in_band(lo_col, U, R)
            ok = ok & ok_c
            A2_sel = _gather_cols(A2, cols)
            n2_sel = R
        else:
            A2_sel = A2
            n2_sel = N2
    with stage("re-scan", A1.device):
        rr, ri, y_sq = rescan.row_scan_df3(A1_sel, A2_sel, a3, y)
        cand, vals = rescan.candidates_from_rows(
            rr, ri, segments=rescan.n_segments(n2_sel))
    loc = torch.clamp(cand[:, :, 0], 0, R - 1)
    i1 = torch.gather(rows, 1, loc)
    i2 = cand[:, :, 1]
    if prune_cols:
        i2 = torch.gather(cols, 1, torch.clamp(i2, 0, R - 1))
    return torch.stack([i1, i2], dim=2), vals, y_sq, ok
