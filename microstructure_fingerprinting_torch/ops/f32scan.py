"""Two-pass exact candidate scans: f32 interval row pass (kernel 2 for
[N1, N2, 1], kernel 4 for the EAR configuration [N1, N2, N3, N4]) +
double-float re-scan of the selected sub-grid (kernels 3 and 5).

PyTorch counterpart of ``microstructure_fingerprinting_tpu/ops/f32scan.py``
(``rowmin_3`` and ``rowmin_4`` with ``pallas=True``, ``_select_rows``,
``_select_in_band``, ``df3_twopass``, ``df4_twopass``). For [N1, N2, 1]:

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

The EAR scan has the same shape: ``rowmin_4`` (prep with the signal, the
CSF and the EAR columns as rhs, then ``csrc/rowmin4.cu``) bounds every
support containing {1, 2} by LDL chains with three-zone pivot guards and
the radius KERR4 for the full supports; ``rescan.row_scan_df4`` re-ranks
the selected sub-grid. Kernel 4's operands after prep (the small Grams,
the floor, the column lows, the row-level supports and the chain
prefixes) come from kernel 11 (``csrc/row4hoist.cu``, ``row4_hoist``) on
CUDA tensors, from its plain version ``row4_hoist_twin`` on CPU tensors.
Kernel 2's come from kernel 12 (``csrc/row3hoist.cu``, ``row3_hoist``;
plain version ``row3_hoist_twin``) in the same way. Both row passes take
their rhs columns (the signal, the CSF and the EAR columns) normalized
and packed for kernel 1 by kernel 13 (``ops/prep.rhs_prep``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import df32
from . import dfscan
from . import kernels
from . import prep as pp
from . import rescan
from ..utils.profiling import stage

_EPS = float(np.float32(1.1920929e-07))
_TOL = float(np.float32(100 * 1.1920929e-07))
#: per-candidate f32 error radius = KERR * (1 + s + s^2), calibrated on the
#: exact-Gram error model (the Gram's fixed sum order below is part of it)
KERR = float(np.float32(8 * 1.1920929e-07))
#: the radius of the longer 4-block LDL chains (EAR row pass)
KERR4 = float(np.float32(12 * 1.1920929e-07))
_INF = float("inf")
_PTILE = 128       # rows per tile
#: block tile of csrc/rowmin3.cu (rows x columns): it writes one partial
#: row minimum per TN columns and one partial column minimum per TM rows
TM, TN = 32, 64
#: rows of kernel 1's Grams, the diagonal and one a rhs column
#: (csrc/row4hoist.cu and csrc/row3hoist.cu kGramRows)
GRAM_ROWS = 1 + pp.MAX_RHS


def _w(c, x, y):
    return dfscan._where(c, x, y)


def _interval(feas, stab, res, ws, excl=False):
    """(lo, up) for one support: feasible -> res +- KERR*(1+ws); unstable
    pivot -> [-KERR, +inf) (``excl``: no contribution, for the
    det-guarded 4-block family, whose mirrored df scan excludes such
    supports); infeasible -> no contribution."""
    err = KERR * (1.0 + ws)
    res = dfscan._sanit(res)
    lo = _w(feas, res - err, _w(stab, _INF, _INF if excl else -KERR))
    up = _w(feas, res + err, _INF)
    return lo, up


def _sub1(d, p, w):
    """Support {a} (diagonal ~1 after normalization): interval."""
    wa = p / d
    return _interval(wa >= 0, torch.ones_like(wa, dtype=torch.bool),
                     w - p * wa, torch.abs(wa))


def _sub2(dA, dB, g, pA, pB, w, det_tol=0.0):
    """Support {a, b}, eliminating a (diag ~1) then b. ``det_tol`` is the
    relative determinant cutoff of the mirrored df semantics: 0 for the
    K=3 case logic (unguarded reference branch), _TOL for the 4-block
    enumeration."""
    invA = 1.0 / dA
    piv = dB - g * g * invA
    stab = piv > _EPS * dB
    invP = _w(stab, 1.0 / _w(stab, piv, 1.0), 0.0)
    t = pB - g * pA * invA
    wb = t * invP
    wa = (pA - g * wb) * invA
    feas = stab & (piv > det_tol * dB) & (wa >= 0) & (wb >= 0)
    res = w - pA * pA * invA - t * wb
    return _interval(feas, stab, res, torch.abs(wa) + torch.abs(wb),
                     excl=det_tol > 0)


def _sub3(dA, dB, dC, gAB, gAC, gBC, pA, pB, pC, w, det_tol):
    """Support {a, b, c}, progressive elimination a -> b -> c; the gate
    pivB * pivC > det_tol * dB * dC mirrors det3 > det_tol * dA*dB*dC."""
    invA = 1.0 / dA
    pivB = dB - gAB * gAB * invA
    stabB = pivB > _EPS * dB
    invB = _w(stabB, 1.0 / _w(stabB, pivB, 1.0), 0.0)
    gBC_r = gBC - gAB * gAC * invA
    tB = pB - gAB * pA * invA
    pivC = dC - gAC * gAC * invA - gBC_r * gBC_r * invB
    stabC = pivC > _EPS * dC
    invC = _w(stabC, 1.0 / _w(stabC, pivC, 1.0), 0.0)
    tC = pC - gAC * pA * invA - gBC_r * tB * invB
    wc = tC * invC
    wb = (tB - gBC_r * wc) * invB
    wa = (pA - gAB * wb - gAC * wc) * invA
    stab = stabB & stabC
    feas = (stab & (pivB * pivC > det_tol * dB * dC)
            & (wa >= 0) & (wb >= 0) & (wc >= 0))
    res = w - pA * pA * invA - tB * tB * invB - tC * wc
    return _interval(feas, stab, res,
                     torch.abs(wa) + torch.abs(wb) + torch.abs(wc),
                     excl=det_tol > 0)


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


def row3_hoist_twin(gramA, gramB, yh, A3h):
    """Plain PyTorch version of kernel 12: the hoists of the [N1, N2, 1]
    row pass from kernel 1's Grams gramA (B, 16, N1p) and gramB
    (B, 16, N2pb) and the normalized rhs columns yh (B, S) and A3h
    (B, S, 1): the small Grams, the block-1 row intervals, the
    block-1-free floor, the per-column lows and the chain prefixes that
    ``rowmin3_twin`` reads. Returns (row_pack (B, 16, N1p), col_pack
    (B, 8, N2pb), vox (B, 8), lo_c_sup (B, N2pb), upf (B,))."""
    d1, p_, b_ = gramA[:, 0], gramA[:, 1], gramA[:, 2]     # (B, N1p)
    d2, q_, c_ = gramB[:, 0], gramB[:, 1], gramB[:, 2]     # (B, N2pb)
    q3s = [dfscan.quantize3(c.float()) for c in (yh, A3h[:, :, 0])]
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
    return row_pack, col_pack, vox, lo_c_sup, upf


#: floats of kernel 12's voxel scratch (csrc/row3hoist.cu kScr): w, d3,
#: r3, 1 / d3
ROW3_VOX_SCRATCH = 4


def row3_hoist_shapes(gramA, gramB, A3h):
    """Raises ValueError unless kernel 12 takes the shapes: N3 = 1, N1p
    and N2pb positive multiples of dfscan.HOIST_ATOMS (every shape
    kernel 2 takes on the card)."""
    N1p, N2pb, N3 = gramA.shape[2], gramB.shape[2], A3h.shape[2]
    if (N3 != 1 or N1p < 1 or N2pb < 1 or N1p % dfscan.HOIST_ATOMS
            or N2pb % dfscan.HOIST_ATOMS):
        raise ValueError("unsupported row-pass hoist shape (N1p %d, N2pb "
                         "%d, N3 %d)" % (N1p, N2pb, N3))


def _row3_hoist_cuda(gramA, gramB, yh, A3h):
    yh, A3h = yh.contiguous(), A3h.contiguous()
    B, S = yh.shape
    N1p, N2pb = gramA.shape[2], gramB.shape[2]
    c = kernels.check
    c(gramA, torch.float32, (B, GRAM_ROWS, N1p), "gramA")
    c(gramB, torch.float32, (B, GRAM_ROWS, N2pb), "gramB")
    c(yh, torch.float32, (B, S), "yh")
    c(A3h, torch.float32, (B, S, A3h.shape[2]), "A3h")
    row3_hoist_shapes(gramA, gramB, A3h)
    new = lambda *shape: torch.empty(*shape, dtype=torch.float32,
                                     device=gramA.device)
    row_pack, col_pack, vox = new(B, 16, N1p), new(B, 8, N2pb), new(B, 8)
    lo_c_sup, upf = new(B, N2pb), new(B)
    scr, part = new(B, ROW3_VOX_SCRATCH), new(B, N2pb // dfscan.HOIST_ATOMS)
    kernels.launch("row3hoist", gramA, gramB, yh, A3h, row_pack, col_pack,
                   vox, lo_c_sup, scr, part, upf, B, S, N1p, N2pb, _EPS, KERR)
    return row_pack, col_pack, vox, lo_c_sup, upf


def row3_hoist(gramA, gramB, yh, A3h):
    """Kernel 12 dispatch on the device of the Grams: CUDA tensors launch
    ``csrc/row3hoist.cu`` (or raise), CPU tensors run
    ``row3_hoist_twin``."""
    fn = _row3_hoist_cuda if gramA.is_cuda else row3_hoist_twin
    return fn(gramA, gramB, yh, A3h)


def rowmin_3_prep(A1, A2, a3, y, rhs=pp.rhs_prep):
    """The rhs columns' normalization and pack (kernel 13, or ``rhs``)
    and kernel 1 (twice, with 2 rhs columns) of the [N1, N2, 1] row pass.
    Returns (the row pass's level and plane operands (q123, a1bf, rabf,
    qb3, rbbf, abbf), kernel 12's inputs (gramA, gramB, yh, A3h))."""
    N2 = A2.shape[2]
    NB, N2B = rescan.col_blocks(N2)
    rhs_q, rhs_r, rhs_a, yh, A3h, _A4h = rhs(y, a3)
    A1p, _ = pp.pad_block(A1.float(), _PTILE)
    A2p = F.pad(A2.float(), (0, NB * N2B - N2))
    q123_t, a1bf_t, rabf_t, _x, gramA = pp.prep_block(
        A1p, rhs_q, rhs_r, rhs_a, _PTILE, planes="xr", n_rhs=2)
    qb3, _x2, rbbf, abbf, gramB = pp.prep_block(
        A2p, rhs_q, rhs_r, rhs_a, N2B, planes="ra", n_rhs=2)
    return ((q123_t, a1bf_t, rabf_t, qb3, rbbf, abbf),
            (gramA, gramB, yh, A3h))


def _row3_operands(rhs, hoist, A1, A2, a3, y):
    planes, ins = rowmin_3_prep(A1, A2, a3, y, rhs)
    row_pack, col_pack, vox, lo_c_sup, upf = hoist(*ins)
    return planes + (row_pack, col_pack, vox), (lo_c_sup, upf)


def rowmin_3_operands(A1, A2, a3, y):
    """The rhs pack (kernel 13), prep (kernel 1, twice) and the hoists
    of the row pass (kernel 12): kernels on CUDA tensors, their plain
    versions on CPU tensors. Returns (kernel operands tuple, (lo_c_sup,
    upf))."""
    return _row3_operands(pp.rhs_prep, row3_hoist, A1, A2, a3, y)


def rowmin_3_operands_plain(A1, A2, a3, y):
    """``rowmin_3_operands`` with the rhs pack and the hoists in plain
    torch on any device (kernels 13 and 12's plain versions; kernel 1
    stays): the reference a card holds those kernels against."""
    return _row3_operands(pp.rhs_prep_twin, row3_hoist_twin, A1, A2, a3, y)


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


# ---------------------------------------------------------------------------
# kernel 4: the 4-block (EAR) interval row pass
# ---------------------------------------------------------------------------

#: block tile of csrc/rowmin4.cu (the Gram tile of csrc/gram_hi.cuh, shared
#: with kernel 2): one partial row minimum per TN columns, one partial
#: column minimum per TM rows
TM4, TN4 = TM, TN


def _rowmin4_body(a, rowv, colv, voxv, n3, n4):
    """Per-point math of the 4-block interval row pass (the JAX
    package's ``_rowmin4_body``): the fold of the feasibility-cased
    intervals of every support containing {1, 2} — {1,2}, {1,2,X} for the
    n3 + n4 single extra columns X (i3's first), {1,2,i3,i4} for the
    n3 * n4 pairs — from the Gram tile ``a`` and the hoisted chain
    prefixes, with three-zone pivot guards: include (> 2 TOL diag), shell
    ((0.5..2) TOL diag: the sound [-KERR, +inf)) and exclude.

    ``rowv(i)``/``colv(i)``/``voxv(i)`` return pack row i broadcastable
    against ``a``; layouts (zone flags z* in {0, 0.5, 1}):
      rows: [invd1, p1] + per X [L1X, invd1pX, kap_ppX, rho1X, zX]
            + per s [L14, invD1h, kap1, rho1f, zr]
      cols: [d2, q2] + per X [kap_cX, d2pX, q2pX, cX]
            + per s [e4c, L24, d2r, q2r]
      vox:  [w] + per X [uX] + per s [u4, L43, z34]
    Returns (lo, up)."""
    TOL = float(100 * 1.1920929e-07)
    nx, ns = n3 + n4, n3 * n4
    invd1, p1 = rowv(0), rowv(1)
    d2c, qc = colv(0), colv(1)
    w_ = voxv(0)

    def zone(piv):
        return _w(piv > 2 * TOL * d2c, 1.0,
                  _w(piv > 0.5 * TOL * d2c, 0.5, 0.0))

    def fold(lo, up, z, feas_w, res, err):
        feas = (z > 0.75) & feas_w
        lo_s = _w(feas, res - err, _w(z == 0.5, -KERR, _INF))
        return (torch.minimum(lo, lo_s),
                torch.minimum(up, _w(feas, res + err, _INF)))

    def inv(z, piv):
        return _w(z > 0.25, 1.0 / _w(z > 0.25, piv, 1.0), 0.0)

    # support {1,2}
    pivA = d2c - a * a * invd1
    zA = zone(pivA)
    invA = inv(zA, pivA)
    tA = qc - a * (p1 * invd1)
    w2 = tA * invA
    w1 = (p1 - a * w2) * invd1
    res12 = dfscan._sanit(w_ - p1 * (p1 * invd1) - tA * w2)
    s12 = w1 + w2
    err12 = KERR * (1.0 + s12 + s12 * s12)
    lo = torch.full_like(a, _INF)
    up = torch.full_like(a, _INF)
    lo, up = fold(lo, up, zA, torch.minimum(w1, w2) >= 0, res12, err12)

    # supports {1,2,X}: chain X -> 1 -> 2 (prefixes hoisted)
    for x in range(nx):
        L1x, invd1px, kap_ppx, rho1x, zx = (rowv(2 + 5 * x + j)
                                            for j in range(5))
        kap_cx, d2px, q2px, cxc = (colv(2 + 4 * x + j) for j in range(4))
        ux = voxv(1 + x)
        ap = a - L1x * cxc
        pivB = d2px - ap * ap * invd1px
        zB = torch.minimum(zx, zone(pivB))
        invB = inv(zB, pivB)
        tB = q2px - ap * kap_ppx
        w2t = tB * invB
        w1t = kap_ppx - ap * invd1px * w2t
        w3t = ux - L1x * w1t - kap_cx * w2t
        res3 = dfscan._sanit(rho1x - tB * w2t)
        err3 = KERR * (1.0 + w1t + w2t + w3t)
        lo, up = fold(lo, up, zB,
                      torch.minimum(torch.minimum(w1t, w2t), w3t) >= 0,
                      res3, err3)

    # full supports {1, 2, i3, i4}: LDL finish per (i3, i4) pair
    r0, c0, v0 = 2 + 5 * nx, 2 + 4 * nx, 1 + nx
    for s in range(ns):
        i3 = s // n4
        L13 = rowv(2 + 5 * i3)
        kap_c3 = colv(2 + 4 * i3)
        c3c = colv(2 + 4 * i3 + 3)
        u3 = voxv(1 + i3)
        L14, invD1h, kap1, rho1f, zr = (rowv(r0 + 5 * s + j)
                                        for j in range(5))
        e4c, L24, d2r, q2r = (colv(c0 + 4 * s + j) for j in range(4))
        u4, L43, z34 = (voxv(v0 + 3 * s + j) for j in range(3))
        NUM = a - L13 * c3c - L14 * e4c
        D2h = d2r - NUM * NUM * invD1h
        zF = torch.minimum(torch.minimum(z34, zr), zone(D2h))
        invF = inv(zF, D2h)
        pi2 = q2r - NUM * kap1
        w2f = pi2 * invF
        w1f = kap1 - NUM * invD1h * w2f
        w4f = u4 - L14 * w1f - L24 * w2f
        w3f = u3 - L43 * w4f - L13 * w1f - kap_c3 * w2f
        resF = dfscan._sanit(rho1f - pi2 * w2f)
        errF = KERR4 * (1.0 + w1f + w2f + w3f + w4f)
        lo, up = fold(lo, up, zF,
                      torch.minimum(torch.minimum(w1f, w2f),
                                    torch.minimum(w3f, w4f)) >= 0,
                      resF, errF)
    return lo, up


def rowmin4_twin(q123, a1bf, rabf, qb3, rbbf, abbf, row_pack, col_pack,
                 vox, n1, n2, n3, n4, nr):
    """Plain PyTorch version of the 4-block row-pass kernel.

    Returns (lo_row (B, N1p), up_row (B, N1p), lo_col (B, N2pb)): per-row
    minima over valid columns folded with the row-level supports
    (row_pack rows ``nr``, ``nr + 1``), and per-column lo minima over
    valid rows."""
    a = _gram_hi(q123, a1bf, rabf, qb3, rbbf, abbf)       # (B, N1p, N2pb)
    lo, up = _rowmin4_body(a, lambda i: row_pack[:, i][:, :, None],
                           lambda i: col_pack[:, i][:, None, :],
                           lambda i: vox[:, i][:, None, None], n3, n4)
    B, N1p, N2pb = a.shape
    col = torch.arange(N2pb, device=a.device)[None, None, :]
    row = torch.arange(N1p, device=a.device)[None, :, None]
    lo = _w(col < n2, lo, _INF)
    up = _w(col < n2, up, _INF)
    lo_row = torch.minimum(row_pack[:, nr], lo.amin(dim=2))
    up_row = torch.minimum(row_pack[:, nr + 1], up.amin(dim=2))
    # padded rows carry zero chain prefixes whose shell-zone -KERR values
    # must not reach the column minima
    lo_col = _w(row < n1, lo, _INF).amin(dim=1)
    return lo_row, up_row, lo_col


def _rowmin4_cuda(q123, a1bf, rabf, qb3, rbbf, abbf, row_pack, col_pack,
                  vox, n1, n2, n3, n4, nr):
    B, nt, S, T3 = q123.shape
    T = T3 // 3
    NB, N2B = qb3.shape[1], qb3.shape[3] // 3
    N1p, N2pb = nt * T, NB * N2B
    NR, NC, NV = row_pack.shape[1], col_pack.shape[1], vox.shape[1]
    if T % TM4 or N2B % TN4:
        raise ValueError("row tile %d / column block %d not multiples of "
                         "the kernel tile %dx%d" % (T, N2B, TM4, TN4))
    c = kernels.check
    c(q123, torch.int8, (B, nt, S, 3 * T), "q123")
    c(a1bf, torch.bfloat16, (B, nt, S, T), "a1bf")
    c(rabf, torch.bfloat16, (B, nt, S, T), "rabf")
    c(qb3, torch.int8, (B, NB, S, 3 * N2B), "qb3")
    c(rbbf, torch.bfloat16, (B, NB, S, N2B), "rbbf")
    c(abbf, torch.bfloat16, (B, NB, S, N2B), "abbf")
    c(row_pack, torch.float32, (B, NR, N1p), "row_pack")
    c(col_pack, torch.float32, (B, NC, N2pb), "col_pack")
    c(vox, torch.float32, (B, NV), "vox")
    dev = q123.device
    # blocks run in no order: each writes its own partial minima
    part_row = torch.empty(B, N2pb // TN4, 2, N1p, dtype=torch.float32,
                           device=dev)
    part_col = torch.empty(B, N1p // TM4, N2pb, dtype=torch.float32,
                           device=dev)
    kernels.launch("rowmin4", q123, a1bf, rabf, qb3, rbbf, abbf, row_pack,
                   col_pack, vox, part_row, part_col,
                   B, S, N1p, T, NB, N2B, n1, n2, n3, n4, NR, NC, NV, nr)
    lo_row = torch.minimum(row_pack[:, nr], part_row[:, :, 0].amin(dim=1))
    up_row = torch.minimum(row_pack[:, nr + 1],
                           part_row[:, :, 1].amin(dim=1))
    return lo_row, up_row, part_col.amin(dim=1)


def rowmin4_rows(q123, a1bf, rabf, qb3, rbbf, abbf, row_pack, col_pack,
                 vox, n1, n2, n3, n4, nr):
    """Kernel 4 dispatch: CUDA tensors launch ``csrc/rowmin4.cu`` (or
    raise), CPU tensors run ``rowmin4_twin``."""
    fn = _rowmin4_cuda if q123.is_cuda else rowmin4_twin
    return fn(q123, a1bf, rabf, qb3, rbbf, abbf, row_pack, col_pack, vox,
              n1, n2, n3, n4, nr)


def _pack8(xs):
    """Stack (B, N) vectors as rows of a (B, 8k, N) pack."""
    p = torch.stack(xs, dim=1)
    return F.pad(p, (0, 0, 0, -len(xs) % 8)).contiguous()


def _rhs_cols(yh, A3h, A4h):
    """The row pass's rhs columns: the signal, then the N3 and N4 fixed
    columns (kernel 1's gram rows 1, 2 .. 1 + N3, 2 + N3 ..)."""
    return ([yh] + [A3h[:, :, i] for i in range(A3h.shape[2])]
            + [A4h[:, :, i] for i in range(A4h.shape[2])])


def row4_pack_rows(n3, n4):
    """(nr, NR, NC, NV): the row-level supports' entry nr of the 4-block
    row pass's row pack (its chain prefixes before it), and the sizes of
    the row pack (with the two row-level entries), the column pack and
    the voxel vector, each padded to a multiple of 8 (``_pack8``)."""
    nx, ns = n3 + n4, n3 * n4
    nr = 2 + 5 * nx + 5 * ns
    pad8 = lambda n: n + -n % 8
    return nr, pad8(nr + 2), pad8(2 + 4 * nx + 4 * ns), pad8(1 + nx + 3 * ns)


def row4_hoist_twin(gramA, gramB, yh, A3h, A4h):
    """Plain PyTorch version of kernel 11: the hoists of the 4-block row
    pass from kernel 1's Grams gramA (B, 16, N1p) and gramB (B, 16, N2pb)
    and the normalized rhs columns yh (B, S), A3h (B, S, N3), A4h
    (B, S, N4): the block-1-free floor, the per-column lows of the
    block-2 supports, the row-level supports and the chain prefixes of
    ``_rowmin4_body``. Returns (row_pack (B, NR, N1p), col_pack
    (B, NC, N2pb), vox_pack (B, NV), lo_c_sup (B, N2pb), upf (B,)),
    sized by ``row4_pack_rows``."""
    B = gramA.shape[0]
    N3, N4 = A3h.shape[2], A4h.shape[2]
    d1, p_ = gramA[:, 0], gramA[:, 1]                      # (B, N1p)
    b3 = gramA[:, 2:2 + N3].transpose(1, 2)                # (B, N1p, N3)
    b4 = gramA[:, 2 + N3:2 + N3 + N4].transpose(1, 2)
    d2, q_ = gramB[:, 0], gramB[:, 1]                      # (B, N2pb)
    c3 = gramB[:, 2:2 + N3].transpose(1, 2)
    c4 = gramB[:, 2 + N3:2 + N3 + N4].transpose(1, 2)
    gs = lambda qa, qb: _gram3_hi(qa, qb, "bs,bs->b")
    q3s = [dfscan.quantize3(c.float()) for c in _rhs_cols(yh, A3h, A4h)]
    qy3, qa3s, qa4s = q3s[0], q3s[1:1 + N3], q3s[1 + N3:]
    d3 = torch.stack([gs(q, q) for q in qa3s], 1)          # (B, N3)
    d4 = torch.stack([gs(q, q) for q in qa4s], 1)
    r3 = torch.stack([gs(q, qy3) for q in qa3s], 1)
    r4 = torch.stack([gs(q, qy3) for q in qa4s], 1)
    g34 = torch.stack([torch.stack([gs(q3c, q4c) for q4c in qa4s], 1)
                       for q3c in qa3s], 1)                # (B, N3, N4)
    w_ = gs(qy3, qy3)                                      # (B,)
    N1w, N2w = d1.shape[1], d2.shape[1]

    d3e = d3.reshape(B, 1, N3, 1)
    d4e = d4.reshape(B, 1, 1, N4)
    r3e = r3.reshape(B, 1, N3, 1)
    r4e = r4.reshape(B, 1, 1, N4)
    ge = g34.reshape(B, 1, N3, N4)
    w4 = w_.reshape(B, 1, 1, 1)

    # ---- block-1-free floor (upper bounds only) ----
    upf = w_ + KERR
    for _lo, up_s in (_sub1(d3e, r3e, w4), _sub1(d4e, r4e, w4),
                      _sub2(d3e, d4e, ge, r3e, r4e, w4, _TOL)):
        upf = torch.minimum(upf, up_s.reshape(B, -1).amin(dim=1))
    d2e = d2.reshape(B, N2w, 1, 1)
    q2e = q_.reshape(B, N2w, 1, 1)
    c3e = c3.reshape(B, N2w, N3, 1)
    c4e = c4[:, :, None, :]
    # per-column lows of the block-1-free, block-2-containing supports
    # ({2}, {2,i3}, {2,i4}, {2,i3,i4}): they pin i2, so column-band
    # selection must see them; their up side is the floor
    lo_c_sup = torch.full((B, N2w), _INF, dtype=torch.float32,
                          device=d2.device)
    for lo_s, up_s in (_sub1(d2e, q2e, w4),
                       _sub2(d2e, d3e, c3e, q2e, r3e, w4, _TOL),
                       _sub2(d2e, d4e, c4e, q2e, r4e, w4, _TOL),
                       _sub3(d2e, d3e, d4e, c3e, c4e, ge, q2e, r3e, r4e,
                             w4, _TOL)):
        upf = torch.minimum(upf, up_s.reshape(B, -1).amin(dim=1))
        lo_c_sup = torch.minimum(lo_c_sup,
                                 lo_s.reshape(B, N2w, -1).amin(dim=2))

    # ---- row-level supports {1}, {1,i3}, {1,i4}, {1,i3,i4} ----
    d1e = d1[:, :, None, None]
    p1e = p_[:, :, None, None]
    b3e = b3[:, :, :, None]
    b4e = b4[:, :, None, :]
    lo_r, up_r = _sub1(d1, p_, w_[:, None])
    for lo_s, up_s in (_sub2(d1e, d3e, b3e, p1e, r3e, w4, _TOL),
                       _sub2(d1e, d4e, b4e, p1e, r4e, w4, _TOL),
                       _sub3(d1e, d3e, d4e, b3e, b4e, ge, p1e, r3e,
                             r4e, w4, _TOL)):
        lo_r = torch.minimum(lo_r, lo_s.reshape(B, N1w, -1).amin(dim=2))
        up_r = torch.minimum(up_r, up_s.reshape(B, N1w, -1).amin(dim=2))

    # ---- chain-prefix hoists for the per-point support enumeration ----
    NS = N3 * N4
    # voxel-level: eliminate 3 then 4
    eps = torch.full_like(d3[:, :1], _EPS)
    invd3v = 1.0 / torch.maximum(d3, eps)                  # (B, N3)
    invd4v = 1.0 / torch.maximum(d4, eps)                  # (B, N4)
    L43 = g34 * invd3v[:, :, None]                         # (B, N3, N4)
    D4h = d4[:, None, :] - g34 * L43
    stab34 = D4h > _TOL * d4[:, None, :]
    invD4h = _w(stab34, 1.0 / _w(stab34, D4h, 1.0), 0.0)
    t4 = r4[:, None, :] - L43 * r3[:, :, None]
    rho34 = (w_[:, None, None] - r3[:, :, None] * r3[:, :, None]
             * invd3v[:, :, None] - t4 * t4 * invD4h)      # (B, N3, N4)
    u3 = r3 * invd3v                                       # (B, N3)
    u4o = r4 * invd4v                                      # (B, N4)
    u4 = t4 * invD4h

    # rows: single-extra {1,2,X} chain pieces (X = i3's then i4's)
    def x_chain(bX, rX, invdX):
        L1x = bX * invdX[:, None, :]                       # (B, N1, Nx)
        d1px = d1[:, :, None] - bX * L1x
        stabx = d1px > _EPS * d1[:, :, None]
        invd1px = _w(stabx, 1.0 / _w(stabx, d1px, 1.0), 0.0)
        p1x = p_[:, :, None] - L1x * rX[:, None, :]
        kap_ppx = p1x * invd1px
        rho1x = (w_[:, None, None]
                 - rX[:, None, :] * rX[:, None, :] * invdX[:, None, :]
                 - p1x * kap_ppx)
        return L1x, invd1px, kap_ppx, rho1x, stabx

    L13, invd1p3, kap_pp3, rho13, stab3r = x_chain(b3, r3, invd3v)
    L14o, invd1p4, kap_pp4, rho14, stab4r = x_chain(b4, r4, invd4v)

    # rows: per-pair LDL pieces (order 3 -> 4 -> 1 -> 2)
    e4r = b4[:, :, None, :] - L43[:, None] * b3[:, :, :, None]
    L14 = e4r * invD4h[:, None]                            # (B, N1, N3, N4)
    D1h = (d1[:, :, None, None] - b3[:, :, :, None] * L13[:, :, :, None]
           - e4r * L14)
    stabr = (stab3r[:, :, :, None]
             & (D1h > _TOL * d1[:, :, None, None]))
    invD1h = _w(stabr, 1.0 / _w(stabr, D1h, 1.0), 0.0)
    pi1 = (p_[:, :, None, None]
           - L13[:, :, :, None] * r3[:, None, :, None] - L14 * t4[:, None])
    kap1 = pi1 * invD1h
    rho1f = rho34[:, None] - pi1 * kap1                    # (B, N1, N3, N4)

    # cols
    def x_cols(cX, rX, invdX):
        kap_cx = cX * invdX[:, None, :]                    # (B, N2, Nx)
        d2px = d2[:, :, None] - cX * kap_cx
        q2px = q_[:, :, None] - kap_cx * rX[:, None, :]
        return kap_cx, d2px, q2px

    kap_c3, d2p3, q2p3 = x_cols(c3, r3, invd3v)
    kap_c4, d2p4, q2p4 = x_cols(c4, r4, invd4v)
    e4cc = c4[:, :, None, :] - L43[:, None] * c3[:, :, :, None]
    L24 = e4cc * invD4h[:, None]                           # (B, N2, N3, N4)
    d2r = (d2[:, :, None, None]
           - c3[:, :, :, None] * kap_c3[:, :, :, None] - e4cc * L24)
    q2r = (q_[:, :, None, None]
           - kap_c3[:, :, :, None] * r3[:, None, :, None] - L24 * t4[:, None])

    rows = [1.0 / d1, p_]
    for i3 in range(N3):
        rows += [L13[:, :, i3], invd1p3[:, :, i3], kap_pp3[:, :, i3],
                 rho13[:, :, i3], stab3r[:, :, i3].float()]
    for i4 in range(N4):
        rows += [L14o[:, :, i4], invd1p4[:, :, i4], kap_pp4[:, :, i4],
                 rho14[:, :, i4], stab4r[:, :, i4].float()]
    for s in range(NS):
        i3, i4 = divmod(s, N4)
        rows += [L14[:, :, i3, i4], invD1h[:, :, i3, i4],
                 kap1[:, :, i3, i4], rho1f[:, :, i3, i4],
                 stabr[:, :, i3, i4].float()]
    cols = [d2, q_]
    for i3 in range(N3):
        cols += [kap_c3[:, :, i3], d2p3[:, :, i3], q2p3[:, :, i3],
                 c3[:, :, i3]]
    for i4 in range(N4):
        cols += [kap_c4[:, :, i4], d2p4[:, :, i4], q2p4[:, :, i4],
                 c4[:, :, i4]]
    for s in range(NS):
        i3, i4 = divmod(s, N4)
        cols += [e4cc[:, :, i3, i4], L24[:, :, i3, i4],
                 d2r[:, :, i3, i4], q2r[:, :, i3, i4]]
    vox = [w_] + [u3[:, i3] for i3 in range(N3)] + [u4o[:, i4]
                                                    for i4 in range(N4)]
    for s in range(NS):
        i3, i4 = divmod(s, N4)
        vox += [u4[:, i3, i4], L43[:, i3, i4], stab34[:, i3, i4].float()]

    row_pack = _pack8(rows + [lo_r, up_r])                 # (B, NR, N1p)
    col_pack = _pack8(cols)                                # (B, NC, N2pb)
    vox_pack = torch.stack(vox, dim=1)
    vox_pack = F.pad(vox_pack, (0, -len(vox) % 8)).contiguous()  # (B, NV)
    return row_pack, col_pack, vox_pack, lo_c_sup, upf


#: EAR columns kernel 11 takes at most (csrc/row4hoist.cu kMaxE): kernel
#: 1's Grams hold pp.MAX_RHS rhs columns, the signal and CSF among them
ROW4_HOIST_MAX_E = pp.MAX_RHS - 2
#: floats of kernel 11's voxel scratch (csrc/row4hoist.cu kScr): w, d3,
#: r3, 1/d3, then 8 factors an EAR column
ROW4_VOX_SCRATCH = 4 + 8 * ROW4_HOIST_MAX_E


def row4_hoist_shapes(gramA, gramB, A3h, A4h):
    """Raises ValueError unless kernel 11 takes the shapes: N3 = 1,
    1 <= N4 <= ROW4_HOIST_MAX_E, N1p and N2pb multiples of
    dfscan.HOIST_ATOMS (every shape kernel 4 takes on the card)."""
    N1p, N2pb = gramA.shape[2], gramB.shape[2]
    N3, N4 = A3h.shape[2], A4h.shape[2]
    if (N3 != 1 or not 1 <= N4 <= ROW4_HOIST_MAX_E
            or N1p % dfscan.HOIST_ATOMS or N2pb % dfscan.HOIST_ATOMS):
        raise ValueError("unsupported row-pass hoist shape (N1p %d, N2pb "
                         "%d, N3 %d, N4 %d)" % (N1p, N2pb, N3, N4))


def _row4_hoist_cuda(gramA, gramB, yh, A3h, A4h):
    yh, A3h, A4h = (x.contiguous() for x in (yh, A3h, A4h))
    B, S = yh.shape
    N1p, N2pb = gramA.shape[2], gramB.shape[2]
    N3, N4 = A3h.shape[2], A4h.shape[2]
    c = kernels.check
    c(gramA, torch.float32, (B, GRAM_ROWS, N1p), "gramA")
    c(gramB, torch.float32, (B, GRAM_ROWS, N2pb), "gramB")
    c(yh, torch.float32, (B, S), "yh")
    c(A3h, torch.float32, (B, S, N3), "A3h")
    c(A4h, torch.float32, (B, S, N4), "A4h")
    row4_hoist_shapes(gramA, gramB, A3h, A4h)
    nr, NR, NC, NV = row4_pack_rows(N3, N4)
    new = lambda *shape: torch.empty(*shape, dtype=torch.float32,
                                     device=gramA.device)
    row_pack, col_pack, vox = new(B, NR, N1p), new(B, NC, N2pb), new(B, NV)
    lo_c_sup, upf = new(B, N2pb), new(B)
    scr, part = new(B, ROW4_VOX_SCRATCH), new(B, N2pb // dfscan.HOIST_ATOMS)
    kernels.launch("row4hoist", gramA, gramB, yh, A3h, A4h, row_pack,
                   col_pack, vox, lo_c_sup, scr, part, upf, B, S, N1p, N2pb,
                   N4, NR, NC, NV, nr, _EPS, _TOL, KERR)
    return row_pack, col_pack, vox, lo_c_sup, upf


def row4_hoist(gramA, gramB, yh, A3h, A4h):
    """Kernel 11 dispatch on the device of the Grams: CUDA tensors launch
    ``csrc/row4hoist.cu`` (or raise), CPU tensors run
    ``row4_hoist_twin``."""
    fn = _row4_hoist_cuda if gramA.is_cuda else row4_hoist_twin
    return fn(gramA, gramB, yh, A3h, A4h)


def rowmin_4_prep(A1, A2, a3, a4, y, colcap=512, rhs=pp.rhs_prep):
    """The rhs columns' normalization and pack (kernel 13, or ``rhs``)
    and kernel 1 (twice, with 1 + N3 + N4 rhs columns) of the 4-block row
    pass. Returns (the row pass's level and plane operands (q123, a1bf,
    rabf, qb3, rbbf, abbf), kernel 11's inputs (gramA, gramB, yh, A3h,
    A4h))."""
    N2 = A2.shape[2]
    NB, N2B = rescan.col_blocks(N2, colcap, 16)
    rhs_q, rhs_r, rhs_a, yh, A3h, A4h = rhs(y, a3, a4)
    n_rhs = 1 + A3h.shape[2] + A4h.shape[2]
    A1p, _ = pp.pad_block(A1.float(), _PTILE)
    A2p = F.pad(A2.float(), (0, NB * N2B - N2))
    q123_t, a1bf_t, rabf_t, _x, gramA = pp.prep_block(
        A1p, rhs_q, rhs_r, rhs_a, _PTILE, planes="xr", n_rhs=n_rhs)
    qb3, _x2, rbbf, abbf, gramB = pp.prep_block(
        A2p, rhs_q, rhs_r, rhs_a, N2B, planes="ra", n_rhs=n_rhs)
    return ((q123_t, a1bf_t, rabf_t, qb3, rbbf, abbf),
            (gramA, gramB, yh, A3h, A4h))


def _row4_operands(rhs, hoist, A1, A2, a3, a4, y, colcap):
    planes, ins = rowmin_4_prep(A1, A2, a3, a4, y, colcap, rhs)
    row_pack, col_pack, vox_pack, lo_c_sup, upf = hoist(*ins)
    nr = row4_pack_rows(a3.shape[2], a4.shape[2])[0]
    return planes + (row_pack, col_pack, vox_pack), nr, (lo_c_sup, upf)


def rowmin_4_operands(A1, A2, a3, a4, y, colcap=512):
    """The rhs pack (kernel 13), prep (kernel 1, twice, with 1 + N3 + N4
    rhs columns) and the hoists of the 4-block row pass (kernel 11):
    kernels on CUDA tensors, their plain versions on CPU tensors. Returns
    (kernel operands tuple, nr, (lo_c_sup, upf))."""
    return _row4_operands(pp.rhs_prep, row4_hoist, A1, A2, a3, a4, y,
                          colcap)


def rowmin_4_operands_plain(A1, A2, a3, a4, y, colcap=512):
    """``rowmin_4_operands`` with the rhs pack and the hoists in plain
    torch on any device (kernels 13 and 11's plain versions; kernel 1
    stays): the reference a card holds those kernels against."""
    return _row4_operands(pp.rhs_prep_twin, row4_hoist_twin, A1, A2, a3,
                          a4, y, colcap)


def rowmin_4(A1, A2, a3, a4, y, colmin=False, colcap=512):
    """f32 per-row residual intervals for [N1, N2, N3, N4] (the EAR
    configuration), the JAX package's ``rowmin_4(pallas=True)``.

    A1 (B, S, N1), A2 (B, S, N2), a3 (B, S, N3), a4 (B, S, N4), y (B, S).
    Returns (lo (B, N1), up (B, N1), up_floor (B,)) and, with ``colmin``,
    the per-column lower bounds lo_col (B, N2) folded with the
    {2}, {2,i3}, {2,i4}, {2,i3,i4} column supports. ``colcap`` caps the
    column block width of the row-pass kernel."""
    N1, N2, N3, N4 = A1.shape[2], A2.shape[2], a3.shape[2], a4.shape[2]
    with stage("prep", A1.device):
        ops, nr, (lo_c_sup, upf) = rowmin_4_operands(A1, A2, a3, a4, y,
                                                     colcap)
    with stage("row pass", A1.device):
        lo, up, lo_col = rowmin4_rows(*ops, n1=N1, n2=N2, n3=N3, n4=N4,
                                      nr=nr)
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


def _cells(rr, n_seg, segw, rows, cols, n2_sel, lo, lo_col):
    """What ``models/certify.certify`` reads of a two-pass scan: the
    re-scan's (segment, row) minima ``rr`` (B, n_seg * R), the scanned
    rows' and columns' atoms and the least interval lower bound of every
    row and column that the row pass pruned (+inf where it pruned
    none)."""
    B, N1 = lo.shape
    out_r = torch.ones((B, N1), dtype=torch.bool, device=lo.device)
    out_r.scatter_(1, rows, False)
    lo_out = torch.where(out_r, lo, _INF).amin(dim=1)
    if cols is not None:
        out_c = torch.ones_like(lo_col, dtype=torch.bool)
        out_c.scatter_(1, cols, False)
        lo_out = torch.minimum(lo_out,
                               torch.where(out_c, lo_col, _INF).amin(dim=1))
    return dict(cellv=rr, n1p=rr.shape[1] // n_seg, segw=segw, n2=n2_sel,
                rows=rows, cols=cols, lo_out=lo_out)


def df3_twopass(A1, A2, a3, y, M=1, R=128, cells=False):
    """Two-pass exact top-1 for [N1, N2, 1]: f32 interval row pass ->
    double-float re-scan of the in-band rows (and, when N2 > R, columns).
    Returns (cand (B, 1, 2) int64, res (B, 1), y_sq (B,), ok (B,) bool).
    Where ``ok`` is False the caller re-solves the voxel with a larger
    R (the selection guarantee covers in-budget voxels only). With
    ``cells`` a fifth item holds what ``models/certify`` reads of the
    scan (``_cells``)."""
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
        n_seg = rescan.n_segments(n2_sel)
        cand, vals = rescan.candidates_from_rows(rr, ri, segments=n_seg)
    loc = torch.clamp(cand[:, :, 0], 0, R - 1)
    i1 = torch.gather(rows, 1, loc)
    i2 = cand[:, :, 1]
    if prune_cols:
        i2 = torch.gather(cols, 1, torch.clamp(i2, 0, R - 1))
    out = (torch.stack([i1, i2], dim=2), vals, y_sq, ok)
    if not cells:
        return out
    segw = rescan.col_blocks(n2_sel)[1] // rescan._SEGMENTS
    return out + (_cells(rr, n_seg, segw, rows, cols if prune_cols else None,
                         n2_sel, lo, lo_col if prune_cols else None),)


def df4_twopass(A1, A2, a3, a4, y, M=1, R=128, cells=False):
    """Two-pass exact top-1 for [N1, N2, N3, N4] (the EAR configuration):
    4-block f32 interval row pass -> double-float re-scan of the in-band
    rows (and, when N2 > R, columns). Returns (cand (B, 1, 4) int64
    [i1, i2, i3, i4], res (B, 1), y_sq (B,), ok (B,) bool); where ``ok``
    is False the caller re-solves the voxel with a larger R.

    Soundness: the winner's row and column each satisfy lo <= U; the
    supports that pin neither index ({3}, {4}, {3,4}, empty) resolve to
    (0, 0) in first-minimum order, and index 0 is forced into both
    selections; index-ascending subsets keep the (i1, i2, i3, i4)
    first-minimum tie order. With ``cells`` the re-scan writes one
    minimum a (row, ``rescan.TN4``-column tile) and a fifth item holds
    what ``models/certify`` reads of the scan (``_cells``); the winner
    does not depend on the tiling."""
    if M != 1:
        raise NotImplementedError("df4_twopass computes the top-1 only")
    N2, N3, N4 = A2.shape[2], a3.shape[2], a4.shape[2]
    prune_cols = N2 > R
    if prune_cols:
        lo, up, up_floor, lo_col = rowmin_4(A1, A2, a3, a4, y, colmin=True)
    else:
        lo, up, up_floor = rowmin_4(A1, A2, a3, a4, y)
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
    segs = rescan.df4_cell_segments(n2_sel) if cells else 1
    with stage("re-scan", A1.device):
        rr, rf, y_sq = rescan.row_scan_df4(A1_sel, A2_sel, a3, a4, y,
                                           segments=segs)
        n_seg = rescan.n_segments_df4(n2_sel, segs)
        cand, vals = rescan.candidates_from_rows_df4(
            rr, rf, N3 * N4, N4, n2_sel, segments_total=n_seg)
    loc = torch.clamp(cand[:, :, 0], 0, R - 1)
    i1 = torch.gather(rows, 1, loc)
    i2 = cand[:, :, 1]
    if prune_cols:
        i2 = torch.gather(cols, 1, torch.clamp(i2, 0, R - 1))
    out = (torch.cat([i1[:, :, None], i2[:, :, None], cand[:, :, 2:]],
                     dim=2), vals, y_sq, ok)
    if not cells:
        return out
    segw = rescan.col_blocks(n2_sel, 256, 16)[1] // segs
    return out + (_cells(rr, n_seg, segw, rows, cols if prune_cols else None,
                         n2_sel, lo, lo_col if prune_cols else None),)
