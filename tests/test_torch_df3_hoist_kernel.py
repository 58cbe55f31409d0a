"""Kernel 10, the re-scan's prologue (``csrc/df3hoist.cu``), as far as the
CPU sees it.

On a card ``rescan.row_scan_df3_operands`` normalizes in torch and
launches kernel 10 (``df3_hoist``: a voxel launch for the signal and the
CSF column, then an atom launch) for the quantize, the Grams, the
compensated chain and the packs that kernel 3 reads; on the CPU it runs
the plain version ``df3_hoist_twin`` (``_hoists`` and the packing that
``row_scan_df3_operands`` did itself before the kernel), bit for bit
``row_scan_df3_operands_plain``. The kernel sums its float64 cross
products in ``dfscan.HOIST_PARTS`` strided parts, the voxel's small Grams
in its voxel launch and the atoms' in its atom launch, where the plain
version's einsum takes another order: summed in either launch's order or
both (``testing.fdot_hoist_order``) the plain version's operands agree by
``testing.kernel_agreement`` (levels exactly), kernel 3's plain version
picks the same top-1, and the re-scan's top-1 is the JAX package's. Its
padded columns are zeros, not the chain's value of a zero column. The
pack layout read from the source is ``_hoists``' and ``rescan3.cu``'s;
the voxel launch's scratch and vox read-back are the sources'. The
``cuda`` test holds the kernel against its plain version on a card at
every shape the wrapper takes.
"""
import inspect
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.ops import pallas_dfscan as jpdf

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import kernels
from microstructure_fingerprinting_torch.ops import nnls as tnnls
from microstructure_fingerprinting_torch.ops import rescan as trescan

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(mft.__file__), "csrc")
NAMES = ("q1a", "q2a", "a1h", "ra", "q1b", "q2b", "rb", "ab", "row_pack",
         "col_pack", "vox")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _problem(rng, B=2, S=40, N1=72, N2=140):
    """Seeded float32 (A1, A2, a3, y): correlated fascicle blocks, a
    positive CSF column, an all-zero atom in A1 (res1 = 0/0)."""
    base = np.abs(rng.randn(B, S, 1))
    mk = lambda n: np.float32(
        0.9 * base + 0.1 * (np.abs(rng.randn(B, S, n)) + 0.05))
    A1, A2 = mk(N1), mk(N2)
    A1[:, :, 5] = 0.0
    a3 = np.float32(np.abs(rng.randn(B, S, 1)) + 0.05)
    y = np.float32(np.abs(rng.randn(B, S)))
    return tuple(_t(x) for x in (A1, A2, a3, y))


def _parent_operands(A1, A2, a3, y, segments=8):
    """The operands as ``row_scan_df3_operands`` built them before kernel
    10: the normalization, ``_hoists`` and the column padding in one
    function."""
    N2 = A2.shape[2]
    A1p, _ = tnnls._pad_cols(A1.float(), 128)
    A1h, _ = tnnls._normalize_block(A1p)
    A2h, _ = tnnls._normalize_block(A2.float())
    A3h, _ = tnnls._normalize_block(a3.float())
    yh, yn, _ = tnnls._normalize_y(y.float())
    qA1, qA2, row_pack, col_pack, vox = trescan._hoists(A1h, A2h, A3h, yh)
    NB, N2B = trescan.col_blocks(N2)
    padc = lambda x: F.pad(x, (0, NB * N2B - N2)).contiguous()
    ops = (qA1[0].contiguous(), qA1[1].contiguous(), A1h.contiguous(),
           qA1[2].contiguous(), padc(qA2[0]), padc(qA2[1]), padc(qA2[2]),
           padc(qA2[3]), row_pack.contiguous(), padc(col_pack),
           vox.contiguous())
    return ops, N2B // segments, yn


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("N2", [10, 140, 256])
def test_cpu_dispatch_runs_the_plain_version(rng, N2):
    """On CPU tensors row_scan_df3_operands is the operands it built
    before kernel 10 and row_scan_df3_operands_plain, bit for bit (NaN
    included: the zero atom's and the padded rows' res1 and res13), and
    row_scan_df3 launches nothing."""
    args = _problem(rng, N2=N2)
    kernels.reset_counts()
    got, segw, yn = trescan.row_scan_df3_operands(*args)
    for want, segw_p, yn_p in (_parent_operands(*args),
                               trescan.row_scan_df3_operands_plain(*args)):
        assert segw == segw_p and _same_bits(yn, yn_p)
        assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert bool(torch.isnan(got[8][:, 36:38, 5]).all())
    assert bool(torch.isnan(got[8][:, 36:38, 72:]).all())
    trescan.row_scan_df3(*args)
    assert kernels.LAUNCHES["df3hoist"] == 0
    assert kernels.LAUNCHES["rescan3"] == 0


@pytest.mark.parametrize("N2", [10, 140, 256])
def test_padding_is_zero(rng, N2):
    """What the kernel must write where the plain version pads: the
    columns past N2 of the column planes and of col_pack are zeros (F.pad
    after the chain), at the width kernel 3 tiles (col_blocks); the
    voxel vector's entries past w's value (entry 16) are zeros."""
    ops, segw, _yn = trescan.row_scan_df3_operands(*_problem(rng, N2=N2))
    NB, N2B = trescan.col_blocks(N2)
    n2pb = ops[4].shape[2]
    assert n2pb == NB * N2B and segw == N2B // 8
    assert (ops[8].shape[1], ops[9].shape[1], ops[10].shape[1]) == (38, 58,
                                                                    24)
    for k in (4, 5, 6, 7, 9):
        assert ops[k].shape[2] == n2pb
        assert not ops[k][:, :, N2:].any()
    assert ops[9][:, :, :N2].any(dim=1).all()
    assert not ops[10][:, 17:].any()
    assert (ops[10][:, 16] > 0).all()                  # w's value


def test_wrapper_rejects_unsupported_shapes():
    """Kernel 10 takes N3 = 1, N1p a multiple of 128 and 1 <= N2 <= N2pb
    (every shape kernel 3 takes: 128 x 128, 256 x 256, 782 x 782 and the
    782 x E grid of the (1, CSF, EAR) bucket); the wrapper raises on
    others before any launch."""
    z = lambda *s: torch.zeros(s)
    for ok in ((z(2, 8, 128), z(2, 8, 128), z(2, 8, 1), 128),
               (z(2, 8, 896), z(2, 8, 782), z(2, 8, 1), 1024),
               (z(2, 8, 896), z(2, 8, 10), z(2, 8, 1), 128)):
        trescan.df3_hoist_shapes(*ok)
    for bad in ((z(2, 8, 896), z(2, 8, 782), z(2, 8, 2), 1024),
                (z(2, 8, 100), z(2, 8, 782), z(2, 8, 1), 1024),
                (z(2, 8, 896), z(2, 8, 782), z(2, 8, 1), 768),
                (z(2, 8, 896), z(2, 8, 0), z(2, 8, 1), 128)):
        with pytest.raises(ValueError, match="unsupported re-scan hoist"):
            trescan.df3_hoist_shapes(*bad)


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _names(text):
    return [n.strip().strip("_") for n in text.split(",") if n.strip()]


def _constants(text):
    """``constexpr int a = ..., b = ...;`` declarations of C text."""
    env = {}
    for decl in re.findall(r"constexpr int ([^;]+);", text):
        for part in decl.split(","):
            name, expr = part.split("=")
            try:
                env[name.strip()] = eval(expr, {}, dict(env))
            except (NameError, SyntaxError):   # another header's constant
                pass
    return env


def test_layout_is_the_sources():
    """The packs kernel 10 writes are ``_hoists``' entry for entry (its
    quadruple lists name the same values in the same order), and the
    entries kernel 3 reads (``rowdf(k)``, ``coldf(k)``, ``voxdf(k)``) are
    the ones ``rescan3_twin`` reads at the same places; both sources
    agree on the pack sizes, which are the plain version's."""
    writer, reader = _src("df3hoist.cu"), _src("rescan3.cu")
    hoists = inspect.getsource(trescan._hoists)
    stacks = re.findall(r"_ps_stack\(\[([^\]]+)\]\)", hoists)
    vox = re.search(r"for x in \(([^)]+)\):", hoists).group(1)
    for arr, want in (("rq", stacks[0]), ("cq", stacks[1]), ("vq", vox)):
        got = re.search(r"const P2 %s\[\w+\] = \{([^}]+)\};" % arr, writer,
                        re.S).group(1)
        assert _names(got) == _names(want), arr
    twin = inspect.getsource(trescan.rescan3_twin)
    for kind, n in (("row", 9), ("col", 14), ("vox", 4)):
        read = dict((int(k), v) for v, k in re.findall(
            r"(\w+) = %sdf\((\d+)\)" % kind, reader))
        assert sorted(read) == list(range(n)), kind
        if kind == "vox":
            names = re.findall(r"(\w+) = tuple\(vv\((?:\d+ \+ )?k\)", twin)
        else:
            lst = re.search(r"\(([^()]+)\) = \(\s*%ss\(k\) for k in "
                            r"range\(%d\)\)" % (kind, n), twin, re.S)
            names = _names(lst.group(1))
        assert [read[k] for k in range(n)] == names, kind
    cw, cr = _constants(writer), _constants(reader)
    for name in ("kRowQuads", "kColQuads", "kVox", "kRowPack", "kColPack"):
        assert cw[name] == cr[name], name
    assert (cw["kRowPack"], cw["kColPack"], cw["kVox"]) == (38, 58, 24)
    assert "sm.vox[16]" in reader and "vx[4 * kVoxQuads] = wf" in writer
    assert "res1_row = sm.row[2 * kRowQuads]" in reader
    assert "rp[(size_t)(4 * kRowQuads) * st] = res1;" in writer
    assert "res2_col = sm.col[2 * kColQuads]" in reader
    assert "cp[(size_t)(4 * kColQuads) * st] = res2;" in writer
    assert int(re.search(r"kAtoms = (\d+);", _src("hoist.cuh")).group(1)) \
        == tdfscan.HOIST_ATOMS


def _order(case, *widths):
    """``testing.fdot_hoist_order`` of ``case``: the voxel launch's order
    alone, the atom launch's alone, or both (the kernel's)."""
    parts = tdfscan.HOIST_PARTS
    return ttesting.fdot_hoist_order(set(widths),
                                     None if case == "voxel" else parts,
                                     None if case == "atoms" else parts)


def _top1(rr, ri, B, N2):
    return trescan.candidates_from_rows(
        rr.reshape(B, -1), ri.reshape(B, -1),
        segments=trescan.n_segments(N2))


@pytest.mark.parametrize("case", ["voxel", "atoms", "both"])
@pytest.mark.parametrize("N2", [10, 140])
def test_kernel_summation_order(rng, monkeypatch, N2, case):
    """c1 and c2 of every Gram are float64 sums of exact products whose
    last bits depend on the order. Summed in the kernel's orders (the
    voxel launch's small Grams, the atom launch's Grams, or both, in
    strided parts) the plain version's operands agree with the einsum
    order's by ``testing.kernel_agreement``, levels exactly, and kernel
    3's plain version picks the same row minima, first indices and top-1
    from both."""
    args = _problem(rng, S=64, N2=N2)
    ops0, segw, _yn = trescan.row_scan_df3_operands(*args)
    monkeypatch.setattr(tdfscan, "fdot", _order(case, 128, N2))
    ops1, _segw, _yn = trescan.row_scan_df3_operands(*args)
    monkeypatch.undo()
    for name, a, b in zip(NAMES, ops1, ops0):
        ok, n_diff, _n, err, tol = ttesting.kernel_agreement(
            a, b, a.dtype == torch.int8)
        assert ok, (name, n_diff, err, tol)
    r0, i0 = trescan.rescan3_rows(*ops0, n2=N2, segw=segw)
    r1, i1 = trescan.rescan3_rows(*ops1, n2=N2, segw=segw)
    assert ttesting.kernel_agreement(r1, r0)[0] and torch.equal(i1, i0)
    assert torch.equal(_top1(r1, i1, 2, N2)[0], _top1(r0, i0, 2, N2)[0])


def test_rescan_on_kernel10_order_operands_matches_jax(rng, monkeypatch):
    """The re-scan on operands summed as kernel 10 sums them (float64
    cross products in strided parts, ``testing.fdot_hoist_order``)
    against JAX row_scan_df3(interpret=True) on the first shape of
    ``tests/test_torch_kernels.py::test_rescan_matches_jax`` (a program
    the suite compiles there): top-1 (i1, i2) equal, values to rtol 1e-5
    atol 1e-7, that test's tolerance."""
    B, S, N1, N2 = 3, 40, 70, 60
    A1 = np.float32(rng.randn(B, S, N1))
    A2 = np.float32(rng.randn(B, S, N2))
    a3 = np.float32(np.abs(rng.randn(B, S, 1)) + 0.05)
    y = np.float32(rng.randn(B, S))
    rr, ri, _ysq = jpdf.row_scan_df3(*[jnp.asarray(x) for x in
                                       (A1, A2, a3, y)], interpret=True)
    cj, vj = jpdf.candidates_from_rows(rr, ri, 1,
                                       segments=jpdf.n_segments(N2))
    monkeypatch.setattr(tdfscan, "fdot", _order("both", 128, N2))
    ops, segw, _yn = trescan.row_scan_df3_operands(
        *[_t(x) for x in (A1, A2, a3, y)])
    monkeypatch.undo()
    rrt, rit = trescan.rescan3_rows(*ops, n2=N2, segw=segw)
    row = torch.arange(rrt.shape[2])[None, None, :]
    rrt = torch.where(row < N1, rrt, float("inf"))
    ct, vt = _top1(rrt, rit, B, N2)
    assert np.array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-7)


def test_voxel_scratch_layout_is_the_sources():
    """The voxel launch's scratch and what the atom launch reads back: the
    chunks of the small columns (``ColChunk``: int2 levels and float64
    (R, a) of kSK samples a column) are ``dfscan.hoist_chunks``' size for
    kernel 10's two columns and kernel 9's one; the parts, the chunk and
    the atom block are the wrappers' constants (``HOIST_PARTS``,
    ``HOIST_CHUNK``, ``HOIST_BLOCK``: a divisor of every row and column
    width the wrappers take); the atom launch reads vox's (hi, lo) of each
    quadruple in the voxel launch's order, and w's value."""
    hoist, k10, k9 = _src("hoist.cuh"), _src("df3hoist.cu"), _src("df2hoist.cu")
    c = _constants(hoist)
    assert (c["kParts"], c["kSK"], c["kBA"]) == (
        tdfscan.HOIST_PARTS, tdfscan.HOIST_CHUNK, tdfscan.HOIST_BLOCK)
    assert c["kSK"] % c["kParts"] == 0 and c["kStreamThreads"] == (
        c["kParts"] * c["kBA"])
    chunk = re.search(r"struct alignas\(16\) ColChunk \{\s*int2 q\[C\]\[kSK\];"
                      r"\s*double2 ra\[C\]\[kSK\];\s*\};", hoist)
    assert chunk is not None
    assert tdfscan.HOIST_CHUNK_COL * 4 == c["kSK"] * (8 + 16)
    for text, cols in ((k10, 2), (k9, 1)):
        assert "ColChunk<%d>* cc = reinterpret_cast<ColChunk<%d>*>(chunks)" \
            % (cols, cols) in text
    for fn, cols in ((trescan._df3_hoist_cuda, 2),
                     (tdfscan._df2_hoist_cuda, 1)):
        assert "hoist_chunks(B, S, %d, A1h.device)" % cols in \
            inspect.getsource(fn)
    assert tdfscan.hoist_chunks(3, 70, 2, "cpu").shape == (
        3, 3 * 2 * tdfscan.HOIST_CHUNK_COL)
    assert tdfscan.HOIST_ATOMS % tdfscan.HOIST_BLOCK == 0
    assert all(trescan.col_blocks(n)[1] % tdfscan.HOIST_BLOCK == 0
               for n in (1, 10, 128, 140, 256, 782))
    # vox: the voxel launch's quadruples {C2v, w, d3, r3}, read back
    quads = _names(re.search(r"const P2 vq\[\w+\] = \{([^}]+)\};", k10).group(1))
    reads = re.findall(r"(\w+)\{vx\[(\d+)\], vx\[(\d+)\]\}", k10)
    assert [r[0] for r in reads] == quads
    assert [(int(r[1]), int(r[2])) for r in reads] == [
        (4 * k, 4 * k + 1) for k in range(len(quads))]
    assert "wf(vx[4 * kVoxQuads])" in k10


@pytest.mark.cuda
def test_cuda_df3_hoist_matches_plain_version(rng):
    """On the card, with padded rows and columns, at every shape the
    wrapper takes (the two-pass 128 x 128, the overflow tiers 256 x 256
    and 782 x 782, the narrow 782 x 10 grid) and at a column block of two
    segments' width: every operand by ``testing.kernel_agreement``
    (levels exactly, NaN bits included) and bit for bit the plain version
    summed in the kernel's order, kernel 3 fed either operand set agrees
    and picks the same top-1, and row_scan_df3_operands launches kernel
    10 once (its two launches counted together)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for N1, N2 in ((128, 128), (256, 256), (782, 782), (782, 10),
                   (200, 300)):
        args = tuple(x.cuda() for x in _problem(rng, B=4, S=64, N1=N1,
                                                N2=N2))
        kernels.reset_counts()
        ops_k, segw, _yn = trescan.row_scan_df3_operands(*args)
        assert kernels.LAUNCHES["df3hoist"] == 1
        ops_p, _segw, _yn = trescan.row_scan_df3_operands_plain(*args)
        for a, b in zip(ops_k, ops_p):
            assert ttesting.kernel_agreement(a, b, a.dtype == torch.int8)[0]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tdfscan, "fdot", _order("both", ops_k[0].shape[2],
                                                N2))
            ops_o, _segw, _yn = trescan.row_scan_df3_operands_plain(*args)
        assert all(_same_bits(a, b) for a, b in zip(ops_k, ops_o))
        nan = torch.isnan(ops_p[8])
        assert nan.any()
        assert torch.equal(ops_k[8][nan].view(torch.int32),
                           ops_p[8][nan].view(torch.int32))
        rk, ik = trescan.rescan3_rows(*ops_k, n2=N2, segw=segw)
        rp, ip = trescan.rescan3_rows(*ops_p, n2=N2, segw=segw)
        assert ttesting.kernel_agreement(rk, rp)[0] and torch.equal(ik, ip)
        assert torch.equal(_top1(rk, ik, 4, N2)[0], _top1(rp, ip, 4, N2)[0])
