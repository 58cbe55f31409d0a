"""The row passes' Gram tile (``csrc/gram_hi.cuh``), as far as the CPU sees it.

The CUDA tile computes the two bf16 corrections on the float64 tensor
cores, which sum the samples in another order than the plain version
(8 samples an ``mma``, chunks of 32, zeros beyond S), and builds its int8
``mma`` operands with byte permutes. Here: the plain version does not
depend on that order or padding at the resolution of the rule that holds
the kernel to it, the wrapper's tile constants are the kernel's, and the
tile's lane mapping and permute constants do what its notes say."""

import os
import re

import numpy as np
import pytest
import torch

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import f32scan as tf32scan

torch.set_num_threads(2)
CUH = os.path.join(os.path.dirname(mft.__file__), "csrc", "gram_hi.cuh")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _gram_operands(rng, B=2, S=36, N1=160, N2=96):
    """Row-pass operands of tests/test_torch_kernels.py's problem family
    (positive, correlated columns); the six Gram packs of kernel 1."""
    base = np.abs(rng.randn(B, S, 1))
    A1 = 0.9 * base + 0.1 * (np.abs(rng.randn(B, S, N1)) + 0.05)
    A2 = 0.9 * base + 0.1 * (np.abs(rng.randn(B, S, N2)) + 0.05)
    a3 = np.abs(rng.randn(B, S, 1)) + 0.05
    y = np.abs(rng.randn(B, S))
    ops, _ = tf32scan.rowmin_3_operands(*[_t(np.float32(x))
                                          for x in (A1, A2, a3, y)])
    return ops[:6]


def _fdot_in_order(order, block):
    """``dfscan.fdot`` for "bsi,bsj->bij" that adds the samples in
    ``order``, ``block`` at a time onto one float64 accumulator (the
    tensor cores' way), rounded once."""
    def fdot(contract, x, y):
        assert contract == "bsi,bsj->bij"
        x, y = x.double()[:, order], y.double()[:, order]
        acc = torch.zeros(x.shape[0], x.shape[2], y.shape[2],
                          dtype=torch.float64)
        for s in range(0, x.shape[1], block):
            acc = acc + torch.einsum(contract, x[:, s:s + block],
                                     y[:, s:s + block])
        return acc.float()
    return fdot


@pytest.mark.parametrize("shuffle,block", [(False, 4), (False, 8),
                                           (True, 1), (True, 8)])
def test_corrections_do_not_depend_on_summation_order(rng, monkeypatch,
                                                      shuffle, block):
    """c1 = <x, r_b> and c2 = <r_a, a_b> are float64 sums of exact bf16
    products: summed in blocks of 4 or 8 samples (an mma's) or in a
    shuffled order they equal the plain version's einsum by
    ``testing.kernel_agreement``, and so does the Gram built on them."""
    packs = _gram_operands(rng)
    S = packs[0].shape[2]
    order = torch.from_numpy(rng.permutation(S)) if shuffle \
        else torch.arange(S)
    plain = tf32scan._gram_hi(*packs)
    x, rb = (tf32scan._untile(packs[1]).float(),
             tf32scan._untile(packs[4]).float())
    ra, ab = (tf32scan._untile(packs[2]).float(),
              tf32scan._untile(packs[5]).float())
    fdot = _fdot_in_order(order, block)
    for u, v in ((x, rb), (ra, ab)):
        ok, n_diff, _n, err, tol = ttesting.kernel_agreement(
            fdot("bsi,bsj->bij", u, v), tdfscan.fdot("bsi,bsj->bij", u, v))
        assert ok, (n_diff, err, tol)
    monkeypatch.setattr(tdfscan, "fdot", fdot)
    ok, n_diff, _n, err, tol = ttesting.kernel_agreement(
        tf32scan._gram_hi(*packs), plain)
    assert ok, (n_diff, err, tol)
    assert torch.isfinite(plain).all() and float(plain.max()) > 0.5


def test_zero_samples_leave_the_gram_unchanged(rng):
    """Samples padded with zeros to a multiple of 32 (the tile's chunk)
    leave ``_gram_hi`` bitwise unchanged: a zero product adds exactly 0."""
    packs = _gram_operands(rng)
    S = packs[0].shape[2]
    pad = -S % 32
    assert pad > 0
    padded = [torch.nn.functional.pad(p, (0, 0, 0, pad)) for p in packs]
    assert padded[0].shape[2] % 32 == 0
    assert torch.equal(tf32scan._gram_hi(*padded), tf32scan._gram_hi(*packs))


def _constants(text):
    line = re.search(r"constexpr int (kHiTM = .*?);", text).group(1)
    return {k: int(v) for k, v in re.findall(r"(kHi\w+) = (\d+)", line)}


def test_wrapper_tile_is_the_kernels():
    """``ops/f32scan.TM, TN`` (the wrappers' shape checks and partial
    outputs) are ``kHiTM``, ``kHiTN`` of the tile's source."""
    with open(CUH) as f:
        c = _constants(f.read())
    assert (tf32scan.TM, tf32scan.TN) == (c["kHiTM"], c["kHiTN"])
    assert (tf32scan.TM4, tf32scan.TN4) == (c["kHiTM"], c["kHiTN"])
    # 8 warps of 16 x 16 points, chunks of whole int8 mma depths
    assert c["kHiThreads"] // 32 * 256 == c["kHiTM"] * c["kHiTN"]
    assert c["kHiSK"] % 32 == 0


def test_mma_layout_covers_the_tile_once():
    """The tile's lane mapping (rows ra0 + mt, columns wc * 16 +
    2 (2 kq + e) + n of the warp's 16 x 16 points) gives every point of
    the 32 x 64 tile to exactly one (thread, register): the hand-over to
    the callers' ownership then fills every entry."""
    seen = np.zeros((32, 64), dtype=int)
    for tid in range(256):
        lane, warp = tid % 32, tid // 32
        g, kq = lane // 4, lane % 4
        ra0 = (warp // 4) * 16 + 2 * g
        for mt in range(2):
            for n in range(2):
                for e in range(2):
                    col = (warp % 4) * 16 + 2 * (2 * kq + e) + n
                    seen[ra0 + mt, col] += 1
    assert np.all(seen == 1)


def _byte_perm(x, y, sel):
    """CUDA ``__byte_perm`` for selectors without the sign-replicate bit."""
    src = [(x >> (8 * i)) & 0xff for i in range(4)] \
        + [(y >> (8 * i)) & 0xff for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 0x7] << (8 * i) for i in range(4))


def test_operand_packing_selectors(rng):
    """``pack2x4`` of the tile: from 4 words (4 neighbouring points of one
    sample each) its permutes give, for the two points at bytes ``at``,
    ``at + 1``, the 4 samples of each, lowest sample in the lowest byte.
    The selectors are read from the source."""
    with open(CUH) as f:
        text = f.read()
    m = re.search(r"sel = \(g & 1\) \? (0x\w+)u : (0x\w+)u", text)
    sel_at = {2: int(m.group(1), 16), 0: int(m.group(2), 16)}
    # pack2x4 lives in the header both Gram tiles share
    with open(os.path.join(os.path.dirname(CUH), "mma_sync.cuh")) as f:
        mma = f.read()
    body = mma[mma.index("void pack2x4"):mma.index("// The same for one")]
    lo_sel, hi_sel = (int(v, 16) for v in re.findall(
        r"__byte_perm\(t0, t2, (0x\w+)\)", body))
    pts = rng.randint(0, 256, size=(4, 4))          # [sample][point]
    w = [sum(int(pts[u, p]) << (8 * p) for p in range(4)) for u in range(4)]
    for at, sel in sel_at.items():
        t0, t2 = _byte_perm(w[0], w[1], sel), _byte_perm(w[2], w[3], sel)
        lo, hi = _byte_perm(t0, t2, lo_sel), _byte_perm(t0, t2, hi_sel)
        want = lambda p: sum(int(pts[u, p]) << (8 * u) for u in range(4))
        assert (lo, hi) == (want(at), want(at + 1))
