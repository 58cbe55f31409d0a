"""The re-scans' Gram tile (``csrc/gram_df.cuh``) and kernel 3's fused
chain (``csrc/rescan3.cu``), as far as the CPU sees them.

The CUDA tile computes the two float32 cross products on the float64
tensor cores, which sum the samples in another order than the plain
version (8 samples an ``mma``, chunks of 32, zeros beyond S), builds its
int8 ``mma`` operands with byte permutes and hands each point's value to
the thread that holds its accumulators; kernel 3 multiplies double-float
values by fused multiply-add on the (hi, lo) halves of its packs. Here:
the plain re-scans in the tensor cores' order select the same indices as
in their own order and agree with it by the rule that holds the kernels;
the tile's constants, lane mapping and permute selectors, read from the
source text, do what its notes say and match the wrappers' checks; and
kernel 3's chain in fused form equals the plain version bit for bit."""

import os
import re

import numpy as np
import pytest
import torch

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import df32
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import rescan as trescan

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(mft.__file__), "csrc")
SM_BYTES = 227 * 1024           # shared memory of an SM that blocks can use


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rand_problem(rng, B, S, N1, N2, corr=0.9, positive=True):
    """tests/test_torch_kernels.py's problem family."""
    A1 = rng.randn(B, S, N1)
    A2 = rng.randn(B, S, N2)
    if positive:
        A1, A2 = np.abs(A1) + 0.05, np.abs(A2) + 0.05
    if corr > 0:
        base = (np.abs(rng.randn(B, S, 1)) if positive
                else rng.randn(B, S, 1))
        A1 = corr * base + (1 - corr) * A1
        A2 = corr * base + (1 - corr) * A2
    a3 = np.abs(rng.randn(B, S, 1)) + 0.05
    y = rng.randn(B, S)
    if positive:
        y = np.abs(y)
    f = np.float32
    return f(A1), f(A2), f(a3), f(y)


# ---------------------------------------------------------------------------
# (a) the plain re-scans in the tensor cores' summation order
# ---------------------------------------------------------------------------

def _fdot_mma_order(order, chunk=32, step=8):
    """``dfscan.fdot`` for "bsi,bsj->bij" as the tile sums it: the samples
    in ``order``, padded with zeros to whole chunks, ``step`` at a time
    (an mma's depth) onto one float64 accumulator, chunk after chunk,
    rounded once."""
    def fdot(contract, x, y):
        assert contract == "bsi,bsj->bij"
        x, y = x.double()[:, order], y.double()[:, order]
        pad = -x.shape[1] % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
        acc = torch.zeros(x.shape[0], x.shape[2], y.shape[2],
                          dtype=torch.float64)
        for s in range(0, x.shape[1], step):
            acc = acc + torch.einsum(contract, x[:, s:s + step],
                                     y[:, s:s + step])
        return acc.float()
    return fdot


def _rescan_case(rng, kernel):
    """(plain re-scan as a function of nothing, first-minimum extractor)
    on a small problem: kernel 3 at [70, 60, 1], kernel 5 at
    [40, 60, 1, 3]."""
    if kernel == 3:
        args = _rand_problem(rng, B=3, S=40, N1=70, N2=60)
        ops, segw, _ = trescan.row_scan_df3_operands(*[_t(x) for x in args])
        return lambda: trescan.rescan3_twin(*ops, n2=60, segw=segw)
    A1, A2, a3, y = _rand_problem(rng, B=2, S=36, N1=40, N2=60)
    a4 = np.float32(np.abs(rng.randn(2, 36, 3)) + 0.05)
    ops, segw, _ = trescan.row_scan_df4_operands(
        *[_t(x) for x in (A1, A2, a3, a4, y)])
    return lambda: trescan.rescan4_twin(*ops, n2=60, n3=1, n4=3, segw=segw)


@pytest.mark.parametrize("kernel,shuffle", [(3, False), (3, True),
                                            (5, False), (5, True)])
def test_rescan_in_tensor_core_order(rng, monkeypatch, kernel, shuffle):
    """c1 = A1h' Rb and c2 = Ra' ab are float64 sums of exact float32
    products (48 bits each, so the sum is not exact and depends on the
    order in its last bits). Summed as the tile does (8 samples an mma,
    chunks of 32, zeros beyond S), also from shuffled samples, the plain
    re-scan gives the same first-minimum i2 (kernel 3) or flat rank
    (kernel 5) on every row and residuals inside
    ``testing.kernel_agreement``."""
    plain = _rescan_case(rng, kernel)
    res0, idx0 = plain()
    S = 40 if kernel == 3 else 36
    order = torch.from_numpy(rng.permutation(S)) if shuffle \
        else torch.arange(S)
    monkeypatch.setattr(tdfscan, "fdot", _fdot_mma_order(order))
    res1, idx1 = plain()
    assert torch.equal(idx1, idx0)
    ok, n_diff, _n, err, tol = ttesting.kernel_agreement(res1, res0)
    assert ok, (n_diff, err, tol)
    assert torch.isfinite(res0).any()


def test_cross_products_part_only_by_an_ulp(rng):
    """The cross products themselves: in the tile's order and in the plain
    version's they are equal or neighbouring float32 values, never more
    (the float64 sums differ by parts in 10^16)."""
    A1, A2, _a3, _y = _rand_problem(rng, B=2, S=552, N1=64, N2=64, corr=0.0,
                                    positive=False)
    x, r = _t(A1), _t(A2 * np.float32(2.0 ** -15))
    c0 = tdfscan.fdot("bsi,bsj->bij", x, r)
    c1 = _fdot_mma_order(torch.arange(552))("bsi,bsj->bij", x, r)
    ulp = torch.abs(torch.nextafter(c0, torch.full_like(c0, np.inf)) - c0)
    assert bool(((c1 - c0).abs() <= ulp).all())
    assert ttesting.kernel_agreement(c1, c0)[0]


# ---------------------------------------------------------------------------
# (b) the tile's constants, lane mapping and permute selectors
# ---------------------------------------------------------------------------

def _tile_constants():
    text = _src("gram_df.cuh")
    line = re.search(r"constexpr int (kDfTM = .*?);", text).group(1)
    c = {k: int(v) for k, v in re.findall(r"(kDf\w+) = (\d+)", line)}
    pads = re.search(r"QA = kDfTM \+ (\d+), QB = TN \+ (\d+);\s*"
                     r"static constexpr int FA = kDfTM \+ (\d+), "
                     r"FB = TN \+ (\d+);", text).groups()
    c["qpad_a"], c["qpad_b"], c["fpad_a"], c["fpad_b"] = map(int, pads)
    return c


def _tile_bytes(c, TN):
    """sizeof(GramDfSmem<TN>): kDfBufs chunks of 2 + 2 level planes and
    2 + 2 float planes, rows padded."""
    q = 2 * (c["kDfTM"] + c["qpad_a"]) + 2 * (TN + c["qpad_b"])
    f = 2 * (c["kDfTM"] + c["fpad_a"]) + 2 * (TN + c["fpad_b"])
    return c["kDfBufs"] * c["kDfSK"] * (q + 4 * f)


def _kernel_tn(name):
    return int(re.search(r"TN = (\d+)", _src(name)).group(1))


def test_wrapper_tiles_are_the_kernels():
    """The wrappers' shape checks (``ops/rescan.py``: N1p % 32 and
    N2pb % 64 for kernel 3, TN4 for kernel 5, CHUNK columns a partial
    minimum) are the tile sizes of the sources; a chunk is one int8 mma
    depth and whole float64 mma depths."""
    c = _tile_constants()
    assert c["kDfTM"] == 32 and c["kDfThreads"] == 256
    assert c["kDfSK"] == 32 and c["kDfSK"] % 8 == 0
    assert _kernel_tn("rescan3.cu") == 64
    assert _kernel_tn("rescan4.cu") == trescan.TN4 == 32
    assert int(re.search(r"CH = (\d+)", _src("rescan3.cu")).group(1)) \
        == trescan.CHUNK
    wrapper = open(trescan.__file__).read()
    assert "segw % CHUNK or N1p % 32 or N2pb % 64" in wrapper
    assert "segw % TN4 or N1p % 32 or N2pb % TN4" in wrapper
    launcher = _src("rescan3.cu")
    assert "N1p % TM || N2pb % TN" in launcher
    assert "cudaErrorMisalignedAddress" in launcher
    assert "cudaErrorMisalignedAddress" in _src("rescan4.cu")


@pytest.mark.parametrize("TN", [32, 64])
def test_shared_memory_fits_two_blocks(TN):
    """The tile's buffers with each kernel's own arrays leave two blocks
    an SM (1 KB a block is the system's); staged rows are 16-byte aligned
    for the copies, and the row strides put the four sample groups of a
    fragment load on distinct banks."""
    c = _tile_constants()
    tile = _tile_bytes(c, TN)
    if TN == 64:                      # kernel 3: struct Smem of rescan3.cu
        text = _src("rescan3.cu")
        nrow, ncol = (int(v) for v in re.search(
            r"kRowQuads = (\d+), kColQuads = (\d+)", text).groups())
        assert (4 * nrow + 2, 4 * ncol + 2) == (38, 58)   # _hoists' packs
        own = 4 * ((2 * nrow + 2) * 32 + (2 * ncol + 2) * TN + 24
                   + 32 * (TN + 1))
        assert 4 * 32 * (TN + 1) <= tile                  # glo lies over it
    else:                             # kernel 5 at E = 10: its packs
        sizes = trescan.df4_pack_sizes(1, 10)
        own = 4 * (trescan.short_slots(*sizes["row"]) * 32
                   + trescan.short_slots(*sizes["col"]) * TN
                   + trescan.vox_slots(sizes["vox"], 11))
        assert 4 * (2 * 11 * 256 + 2 * 32 * (TN + 1)) <= tile
    assert 2 * (tile + own + 1024) <= SM_BYTES
    for width, fpad, qpad in ((c["kDfTM"], c["fpad_a"], c["qpad_a"]),
                              (TN, c["fpad_b"], c["qpad_b"])):
        fstride, qstride = 4 * (width + fpad), width + qpad
        assert fstride % 16 == 0 and qstride % 16 == 0
        # float fragments: samples kq = 0..3, 8 consecutive words each
        assert sorted((kq * fstride // 4) % 32 for kq in range(4)) \
            == [0, 8, 16, 24]
        # level fragments: samples kq = 0..3 (the mma's k index 4 kq + u
        # takes sample kq + 4 u), 4 consecutive words each
        assert "pack2x4(&f.q1a[kq][wa], 4 * Sm::QA" in _src("gram_df.cuh")
        starts = sorted((kq * qstride // 4) % 32 for kq in range(4))
        assert all(b - a >= 4 for a, b in zip(starts, starts[1:]))
        assert starts[0] + 32 - starts[-1] >= 4


def _c_expr(text, pattern):
    """The C integer expression matched by ``pattern`` as a Python one."""
    return re.search(pattern, text).group(1).replace("/", "//")


@pytest.mark.parametrize("TN", [32, 64])
def test_mma_layout_covers_the_tile_once(TN):
    """The tile's lane mapping, read from the source: every point of the
    32 x TN tile belongs to exactly one (thread, accumulator), and the
    column a lane loads as B-fragment column g is the column its
    accumulators report for mma column g (so the products land where
    ``GramDfAt`` says)."""
    text = _src("gram_df.cuh")
    ra0 = _c_expr(text, r"const int ra0 = (.+?);")
    cb0 = _c_expr(text, r"const int cb0 = (.+?);")
    j0 = _c_expr(text, r"at = \{ra0, (.+?)\};")
    col = _c_expr(text, r"int col\(int n, int e\) const \{ return (.+?); \}")
    row = _c_expr(text, r"int row\(int mt\) const \{ return (.+?); \}")
    NT = TN // 32
    seen = np.zeros((32, TN), dtype=int)
    for tid in range(256):
        env = {"warp": tid // 32, "g": tid % 32 // 4, "kq": tid % 4,
               "NT": NT, "TN": TN}
        env["ra0"] = eval(ra0, {}, env)
        at = {"i0": env["ra0"], "j0": eval(j0, {}, env)}
        for mt in range(2):
            for n in range(NT):
                for e in range(2):
                    i = eval(row, {}, dict(at, mt=mt))
                    j = eval(col, {}, dict(at, n=n, e=e, TN=TN))
                    seen[i, j] += 1
                    # the lane that loads mma column 2 kq + e of tile n
                    src = dict(env, g=2 * env["kq"] + e)
                    assert eval(cb0, {}, src) + n == j
    assert np.all(seen == 1)


def _byte_perm(x, y, sel):
    """CUDA ``__byte_perm`` for selectors without the sign-replicate bit."""
    src = [(x >> (8 * i)) & 0xff for i in range(4)] \
        + [(y >> (8 * i)) & 0xff for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 0x7] << (8 * i) for i in range(4))


def test_operand_packing_selectors(rng):
    """``pack2x4`` and ``pack1x4`` (``mma_sync.cuh``) with the selectors
    the tile passes them: from 4 words (4 neighbouring points of one
    sample each) they give the 4 samples of the lane's two points
    (bytes at, at + 1) or one point (byte at), lowest sample in the
    lowest byte."""
    tile, mma = _src("gram_df.cuh"), _src("mma_sync.cuh")
    m = re.search(r"sel_a = \(g & 1\) \? (0x\w+)u : (0x\w+)u", tile)
    pair_sel = {2: int(m.group(1), 16), 0: int(m.group(2), 16)}
    m = re.search(r"sel_b = NT == 2 \? sel_a : (0x\w+)u \+ (0x\w+)u \* "
                  r"\(cb0 & 3\)", tile)
    one_sel = {at: int(m.group(1), 16) + int(m.group(2), 16) * at
               for at in range(4)}
    body2 = mma[mma.index("void pack2x4"):mma.index("int pack1x4")]
    lo_sel, hi_sel = (int(v, 16) for v in re.findall(
        r"__byte_perm\(t0, t2, (0x\w+)\)", body2))
    body1 = mma[mma.index("int pack1x4"):]
    (one_out,) = (int(v, 16) for v in re.findall(
        r"__byte_perm\(t0, t2, (0x\w+)\)", body1))
    pts = rng.randint(0, 256, size=(4, 4))          # [sample][point]
    w = [sum(int(pts[u, p]) << (8 * p) for p in range(4)) for u in range(4)]
    want = lambda p: sum(int(pts[u, p]) << (8 * u) for u in range(4))
    for at, sel in pair_sel.items():
        t0, t2 = _byte_perm(w[0], w[1], sel), _byte_perm(w[2], w[3], sel)
        assert (_byte_perm(t0, t2, lo_sel), _byte_perm(t0, t2, hi_sel)) \
            == (want(at), want(at + 1))
    for at, sel in one_sel.items():
        t0, t2 = _byte_perm(w[0], w[1], sel), _byte_perm(w[2], w[3], sel)
        assert _byte_perm(t0, t2, one_out) == want(at)


def test_tile_holds_no_scalar_path():
    """One tile: its cross products are float64 ``mma``, its level
    products int8 ``mma``, its copies ``cp.async``; kernel 3 names no
    Dekker product."""
    tile, mma, k3 = (_src(n) for n in ("gram_df.cuh", "mma_sync.cuh",
                                       "rescan3.cu"))
    for word in ("__dp4a", "presplit", "pack4"):
        assert word not in tile
    assert "mma_f64(" in tile and "mma_s8(" in tile and "cp_async<16>" in tile
    assert "m16n8k8.row.col.f64" in mma and "m16n8k32.row.col.s32.s8" in mma
    for word in ("mul_ps", "two_prod", "presplit", "load_ps", "PS "):
        assert word not in k3
    assert "mul_df_fma" in k3
    # the Dekker forms left the device header with their last user
    for word in ("P2 mul_ps(", "PS presplit(", "struct PS", "int pack4(",
                 "P2 two_prod(", "P2 split("):
        assert word not in _src("df32.cuh")


# ---------------------------------------------------------------------------
# (c) kernel 3's chain with fused products
# ---------------------------------------------------------------------------

def _mul_df_fma(x, y):
    """``mf::mul_df_fma`` of (hi, lo) pairs: the error of the rounded
    product as one fused multiply-add gives it (the float64 product of two
    float32 values is exact), the cross terms in ``mul_ps``'s order."""
    p = x[0] * y[0]
    e = (x[0].double() * y[0].double() - p.double()).float()
    return p, e + (x[0] * y[1] + x[1] * y[0])


def _rescan3_fused(q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack,
                   vox):
    """Kernel 3's chain as ``csrc/rescan3.cu`` runs it, per grid point:
    (hi, lo) of each pack entry only (entries 4 k and 4 k + 1), every
    product fused, every sum in the kernel's order. Returns the residual
    of every point (B, N1p, N2pb)."""
    e = "bsi,bsj->bij"
    t11 = tdfscan.idot(e, q1a, q1b)
    t12 = tdfscan.idot(e, q1a, q2b) + tdfscan.idot(e, q2a, q1b)
    t22 = tdfscan.idot(e, q2a, q2b)
    a_ = df32.df_from_sum(
        t11.float() * 2.0 ** -14, t12.float() * 2.0 ** -22,
        t22.float() * 2.0 ** -30, tdfscan.fdot(e, a1h, rb),
        tdfscan.fdot(e, ra, ab))
    rowdf = lambda k: (row_pack[:, 4 * k][:, :, None],
                       row_pack[:, 4 * k + 1][:, :, None])
    coldf = lambda k: (col_pack[:, 4 * k][:, None, :],
                       col_pack[:, 4 * k + 1][:, None, :])
    voxdf = lambda k: (vox[:, 4 * k][:, None, None],
                       vox[:, 4 * k + 1][:, None, None])
    Rb2, Rbp, d1p, Rp2, b_p, p_p, rowD2a, rowEG, rowF = (
        rowdf(k) for k in range(9))
    res1_row = row_pack[:, 36][:, :, None]
    res13_row = row_pack[:, 37][:, :, None]
    (U1, U2, U3, U4, V1, V2, X1c, d2p, q_p, c_p,
     colA, colB, colC, colH) = (coldf(k) for k in range(14))
    res2_col = col_pack[:, 56][:, None, :]
    res23_col = col_pack[:, 57][:, None, :]
    C2v, wv, d3v, r3v = (voxdf(k) for k in range(4))
    wf = vox[:, 16][:, None, None]
    mul, two_sum, fts = _mul_df_fma, df32.two_sum, df32.fast_two_sum
    neg = lambda t: (-t[0], -t[1])
    twice = lambda t: (2.0 * t[0], 2.0 * t[1])
    acc, tol, inf = trescan._acc, tdfscan._TOL_DET, float("inf")

    m1, m2 = mul(b_p, V1), mul(p_p, V2)
    s_hi, s_e = two_sum(m1[0], m2[0])
    s_ = fts(s_hi, s_e + m1[1] + m2[1])
    a2 = mul(a_, a_)
    a2_ = fts(a2[0], a2[1])
    det4 = acc([mul(Rb2, U1), mul(Rbp, U2), mul(d1p, U3), mul(Rp2, U4),
                mul(a_, s_), mul(a2_, C2v)])
    bc = mul(b_p, c_p)
    m_abc = mul(a_, fts(bc[0], bc[1]))
    detG3 = acc([mul(d1p, colA), neg(mul(Rb2, d2p)), twice(m_abc),
                 neg(mul(a2_, d3v))])
    ok3 = detG3 > tol
    res123 = tdfscan._sanit(tdfscan._where(
        ok3, det4 / tdfscan._where(ok3, detG3, 1.0), inf))
    D1 = acc([mul(p_p, colA), mul(a_, colB), mul(b_p, colC)])
    D2 = acc([mul(a_, rowD2a), mul(rowEG, c_p), mul(rowF, q_p)])
    pc, bq = mul(p_p, c_p), mul(b_p, q_p)
    s3_hi, s3_e = two_sum(pc[0], bq[0])
    pcbq_ = fts(s3_hi, s3_e + pc[1] + bq[1])
    D3 = acc([mul(a_, pcbq_), neg(mul(rowEG, d2p)), neg(mul(d1p, colH)),
              neg(mul(a2_, r3v))])
    full = (D1 >= -tol) & (D2 >= -tol) & (D3 >= -tol)
    m3 = mul(p_p, q_p)
    ap_q = mul(a_, fts(m3[0], m3[1]))
    num12 = acc([mul(d1p, X1c), neg(mul(Rp2, d2p)), twice(ap_q),
                 neg(mul(a2_, wv))])
    det12 = acc([mul(d1p, d2p), neg(a2)])
    ok12 = det12 > tol
    res12full = tdfscan._sanit(tdfscan._where(
        ok12, num12 / tdfscan._where(ok12, det12, 1.0), inf))
    w1D = acc([mul(d2p, p_p), neg(mul(a_, q_p))])
    w2D = acc([mul(d1p, q_p), neg(mul(a_, p_p))])
    res12 = tdfscan._two_var_cases(res12full, w1D, w2D, p_p[0], q_p[0],
                                   res1_row, res2_col, wf)[0]
    fb = res12
    fb = torch.where(res13_row < fb, res13_row, fb)
    fb = torch.where(res23_col < fb, res23_col, fb)
    return torch.where(full, res123, fb)


@pytest.mark.parametrize("corr,positive,N2", [(0.9, True, 60),
                                              (0.0, False, 60),
                                              (0.95, True, 140)])
def test_fused_chain_equals_plain_version(rng, corr, positive, N2):
    """Kernel 3's chain with fused products on the (hi, lo) halves equals
    ``rescan3_twin`` (Dekker products on presplit quadruples) bit for bit:
    the row minima of the fused residuals are the plain version's, and so
    are the first-minimum columns. Every product's magnitude is far above
    2^-101, below which the two forms could part."""
    args = _rand_problem(rng, B=3, S=40, N1=70, N2=N2, corr=corr,
                         positive=positive)
    ops, segw, _ = trescan.row_scan_df3_operands(*[_t(x) for x in args])
    res = _rescan3_fused(*ops)
    B, N1p, N2pb = res.shape
    col = torch.arange(N2pb)
    res = torch.where(col[None, None, :] < N2, res, float("inf"))
    res = res.reshape(B, N1p, N2pb // segw, segw)
    rmin = res.amin(dim=3)
    idx = torch.where(res == rmin[..., None],
                      col.reshape(N2pb // segw, segw)[None, None],
                      2 ** 30).amin(dim=3)
    idx = torch.where(torch.isfinite(rmin), idx, 0)
    r0, i0 = trescan.rescan3_twin(*ops, n2=N2, segw=segw)
    bits = lambda x: x.contiguous().view(torch.int32)
    assert torch.equal(bits(rmin.transpose(1, 2)), bits(r0))
    assert torch.equal(idx.transpose(1, 2).to(torch.int32), i0)
    assert torch.isfinite(r0).any()


def test_kernel3_split_halves_are_recomputable(rng):
    """The halves hh, hl that kernel 3 no longer stages are ``split(hi)``
    bit for bit in all 9 + 14 + 4 quadruples of its packs."""
    args = _rand_problem(rng, B=2, S=36, N1=40, N2=60)
    ops, _segw, _ = trescan.row_scan_df3_operands(*[_t(x) for x in args])
    row_pack, col_pack, vox = ops[8], ops[9], ops[10]
    assert (row_pack.shape[1], col_pack.shape[1], vox.shape[1]) \
        == (38, 58, 24)
    bits = lambda x: x.contiguous().view(torch.int32)
    for pack, quads in ((row_pack, 9), (col_pack, 14),
                        (vox[:, :, None], 4)):
        for k in range(quads):
            hh, hl = df32.split(pack[:, 4 * k])
            assert torch.equal(bits(hh), bits(pack[:, 4 * k + 2]))
            assert torch.equal(bits(hl), bits(pack[:, 4 * k + 3]))
