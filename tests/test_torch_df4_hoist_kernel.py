"""Kernel 8, the 4-block re-scan's prologue (``csrc/df4hoist.cu``), as far
as the CPU sees it.

On a card ``rescan.row_scan_df4_operands`` normalizes in torch and
launches kernel 8 (``df4_hoist``) for the quantize, the Grams, the LDL'
hoists and the packs that kernel 5 reads; on the CPU it runs the plain
version ``df4_hoist_twin`` (``_df4_hoists``), bit for bit
``row_scan_df4_operands_plain``. The kernel sums its float64 cross
products in sample order, where the plain version's einsum takes another
order: summed in the kernel's order (``testing.fdot_sample_order``) the
plain version's operands agree by ``testing.kernel_agreement`` (levels
and 0/1 flags exactly) and kernel 5's plain version picks the same
top-1. Its padded columns are zeros, not the chain's value of a zero
column. The pack layout read from the source is ``rescan4.cu``'s and
``rescan.df4_pack_sizes``'; the wrapper's sizes are the source's. The
``cuda`` test holds the kernel against its plain version on a card;
``tests/test_torch_ear_kernels.py`` holds the re-scan on operands in the
kernel's order against the JAX package.
"""

import os
import re

import numpy as np
import pytest
import torch

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import kernels
from microstructure_fingerprinting_torch.ops import rescan as trescan

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(mft.__file__), "csrc")
NAMES = ("q1a", "q2a", "a1h", "ra", "q1b", "q2b", "rb", "ab", "row_pack",
         "col_pack", "vox")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _problem(rng, B=2, S=40, N1=72, N2=140, N4=6):
    """Seeded float32 (A1, A2, a3, a4, y): correlated fascicle blocks,
    positive CSF / EAR columns, an all-zero atom in A1 (res1 = 0/0)."""
    base = np.abs(rng.randn(B, S, 1))
    mk = lambda n: np.float32(
        0.9 * base + 0.1 * (np.abs(rng.randn(B, S, n)) + 0.05))
    A1, A2 = mk(N1), mk(N2)
    A1[:, :, 5] = 0.0
    a3 = np.float32(np.abs(rng.randn(B, S, 1)) + 0.05)
    a4 = np.float32(np.abs(rng.randn(B, S, N4)) + 0.05)
    y = np.float32(np.abs(rng.randn(B, S)))
    return tuple(_t(x) for x in (A1, A2, a3, a4, y))


def _flags(n4):
    """Pack entries that hold 0/1 flags: rowok a sweep, ok34 a sweep."""
    nx, ns = 1 + n4, n4
    r_ok = 12 + 12 * nx + 16 * ns + 1
    v_s0 = 4 + 6 * nx
    return ([r_ok + 3 * s for s in range(ns)],
            [v_s0 + 4 * s for s in range(ns)])


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("N2", [140, 256])
def test_cpu_dispatch_runs_the_plain_version(rng, N2):
    """On CPU tensors row_scan_df4_operands is
    row_scan_df4_operands_plain, bit for bit (NaN included), and
    row_scan_df4 launches nothing."""
    args = _problem(rng, N2=N2)
    kernels.reset_counts()
    got, segw, yn = trescan.row_scan_df4_operands(*args)
    want, segw_p, yn_p = trescan.row_scan_df4_operands_plain(*args)
    assert segw == segw_p and _same_bits(yn, yn_p)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert bool(torch.isnan(got[8][:, 12 + 12 * 7 + 16 * 6, 5]).all())
    trescan.row_scan_df4(*args)
    assert kernels.LAUNCHES["df4hoist"] == 0
    assert kernels.LAUNCHES["rescan4"] == 0


@pytest.mark.parametrize("N2", [140, 256])
def test_padding_is_zero(rng, N2):
    """What the kernel must write where the plain version pads: the
    columns past N2 of the column planes and of col_pack are zeros (F.pad
    after the chain), as are the entries past each pack's size; the
    rows past N1 are zero atoms that run the chain (res1 = 0/0, every
    sub-support infeasible)."""
    N4 = 6
    ops, _segw, _yn = trescan.row_scan_df4_operands(*_problem(rng, N2=N2,
                                                              N4=N4))
    s = trescan.df4_pack_sizes(1, N4)
    NR, NC, NV = trescan.df4_pack_rows(1, N4)
    assert (ops[8].shape[1], ops[9].shape[1], ops[10].shape[1]) == (NR, NC,
                                                                    NV)
    n2pb = ops[4].shape[2]
    NB, N2B = trescan.col_blocks(N2, 256, 16)
    assert n2pb == NB * N2B
    for k in (4, 5, 6, 7, 9):
        assert not ops[k][:, :, N2:].any()
    assert ops[9][:, :, :N2].any(dim=1).all()
    assert not ops[8][:, s["row"][0]:].any()
    assert not ops[9][:, s["col"][0]:].any()
    assert not ops[10][:, s["vox"]:].any()
    r_row0 = s["row"][0] - N4
    zero_rows = ops[8][:, :, 72:]
    assert bool(torch.isnan(zero_rows[:, s["row"][1]]).all())
    assert bool(torch.isinf(zero_rows[:, r_row0:s["row"][0]]).all())


@pytest.mark.parametrize("N2,N4", [(140, 6), (256, 10)])
def test_kernel_summation_order(rng, monkeypatch, N2, N4):
    """c1 and c2 of every Gram are float64 sums of exact products whose
    last bits depend on the order. Summed in the kernel's order (sample
    after sample) the plain version's operands agree with the einsum
    order's by ``testing.kernel_agreement``, levels and flags exactly,
    and kernel 5's plain version picks the same row minima, first flat
    indices and top-1 from both."""
    args = _problem(rng, S=64, N2=N2, N4=N4)
    ops0, segw, _yn = trescan.row_scan_df4_operands(*args)
    monkeypatch.setattr(tdfscan, "fdot", ttesting.fdot_sample_order)
    ops1, _segw, _yn = trescan.row_scan_df4_operands(*args)
    monkeypatch.undo()
    rows, vox = _flags(N4)
    for name, a, b in zip(NAMES, ops1, ops0):
        exact = a.dtype == torch.int8
        ok, n_diff, _n, err, tol = ttesting.kernel_agreement(a, b, exact)
        assert ok, (name, n_diff, err, tol)
    assert torch.equal(ops1[8][:, rows], ops0[8][:, rows])
    assert torch.equal(ops1[10][:, vox], ops0[10][:, vox])
    kw = dict(n2=N2, n3=1, n4=N4, segw=segw)
    r0, i0 = trescan.rescan4_twin(*ops0, **kw)
    r1, i1 = trescan.rescan4_twin(*ops1, **kw)
    assert ttesting.kernel_agreement(r1, r0)[0] and torch.equal(i1, i0)
    seg = trescan.n_segments_df4(N2)
    top = lambda r, i: trescan.candidates_from_rows_df4(
        r.reshape(2, -1), i.reshape(2, -1), N4, N4, N2, seg)[0]
    assert torch.equal(top(r1, i1), top(r0, i0))


def _c_ints(text, env):
    """Evaluate ``const int a = ..., b = ...;`` declarations of C text
    (integer arithmetic only) into ``env``."""
    for decl in re.findall(r"const int ([^;]+);", text):
        for part in decl.split(","):
            name, expr = part.split("=")
            env[name.strip()] = eval(expr.replace("/", "//"), {}, env)
    return env


def _offsets(path, n4):
    """The pack layout offsets of a source (its "// pack layout offsets"
    block) at n3 = 1."""
    with open(os.path.join(CSRC, path)) as f:
        text = f.read()
    block = text[text.index("// pack layout offsets"):]
    block = block[:block.index("\n\n")]
    env = _c_ints(block, {"n3": 1, "n4": n4, "nx": 1 + n4, "ns": n4})
    return {k: v for k, v in env.items() if k not in ("n3", "n4", "nx",
                                                       "ns")}


@pytest.mark.parametrize("n4", [1, 10, 16])
def test_layout_is_the_sources(n4):
    """The kernel's pack offsets are kernel 5's (the reader's), entry for
    entry; its sizes are ``df4_pack_sizes``'; the launcher's checks (NR,
    NC, NV: the sizes padded to 8) are ``df4_pack_rows``; its block width
    and largest EAR count are the wrapper's."""
    with open(os.path.join(CSRC, "df4hoist.cu")) as f:
        text = f.read()
    writer, reader = _offsets("df4hoist.cu", n4), _offsets("rescan4.cu", n4)
    assert {k: writer[k] for k in reader} == reader
    s = trescan.df4_pack_sizes(1, n4)
    assert (writer["nrow"], writer["ncol"], writer["nvox"]) == (
        s["row"][0], s["col"][0], s["vox"])
    assert (writer["r_res1"], writer["c_res2"]) == (s["row"][1],
                                                     s["col"][1])
    launcher = text[text.index('extern "C" int mf_df4hoist'):]
    env = _c_ints(launcher[:launcher.index("const auto pad8")],
                  {"n4": n4})
    assert (env["nrow"], env["ncol"], env["nvox"]) == (
        s["row"][0], s["col"][0], s["vox"])
    assert "(n + 7) / 8 * 8" in launcher
    assert tuple((n + 7) // 8 * 8 for n in (env["nrow"], env["ncol"],
                                            env["nvox"])) == \
        trescan.df4_pack_rows(1, n4)
    assert int(re.search(r"kMaxE = (\d+);", text).group(1)) == \
        trescan.DF4_HOIST_MAX_E
    with open(os.path.join(CSRC, "hoist.cuh")) as f:
        assert int(re.search(r"kAtoms = (\d+);", f.read()).group(1)) == \
            tdfscan.HOIST_ATOMS


def test_wrapper_rejects_unsupported_shapes():
    """Kernel 8 takes N3 = 1, 1 <= N4 <= 16, N1p a multiple of 128 and
    N2 <= N2pb (every shape kernel 5 takes); the wrapper raises on
    others before any launch."""
    z = lambda *s: torch.zeros(s)
    ok = (z(2, 8, 896), z(2, 8, 782), z(2, 8, 1), z(2, 8, 10), 1024)
    trescan.df4_hoist_shapes(*ok)
    for bad in ((z(2, 8, 896), z(2, 8, 782), z(2, 8, 2), z(2, 8, 3), 1024),
                (z(2, 8, 896), z(2, 8, 782), z(2, 8, 1), z(2, 8, 17), 1024),
                (z(2, 8, 100), z(2, 8, 782), z(2, 8, 1), z(2, 8, 10), 1024),
                (z(2, 8, 896), z(2, 8, 782), z(2, 8, 1), z(2, 8, 10), 768)):
        with pytest.raises(ValueError, match="unsupported 4-block hoist"):
            trescan.df4_hoist_shapes(*bad)


@pytest.mark.cuda
def test_cuda_df4_hoist_matches_plain_version(rng):
    """On the card, at the EAR width N4 = 10 with padded rows and
    columns: every operand by ``testing.kernel_agreement`` (levels and
    flags exactly, NaN bits included), kernel 5 fed either operand set
    agrees and picks the same top-1, and row_scan_df4_operands launches
    kernel 8 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = tuple(x.cuda() for x in _problem(rng, B=4, S=64, N1=200,
                                            N2=300, N4=10))
    kernels.reset_counts()
    ops_k, segw, _yn = trescan.row_scan_df4_operands(*args)
    assert kernels.LAUNCHES["df4hoist"] == 1
    ops_p, _segw, _yn = trescan.row_scan_df4_operands_plain(*args)
    rows, vox = _flags(10)
    for a, b in zip(ops_k, ops_p):
        assert ttesting.kernel_agreement(a, b, a.dtype == torch.int8)[0]
    assert torch.equal(ops_k[8][:, rows], ops_p[8][:, rows])
    assert torch.equal(ops_k[10][:, vox], ops_p[10][:, vox])
    nan = torch.isnan(ops_p[8])
    assert torch.equal(ops_k[8][nan].view(torch.int32),
                       ops_p[8][nan].view(torch.int32))
    kw = dict(n2=300, n3=1, n4=10, segw=segw)
    rk, ik = trescan.rescan4_rows(*ops_k, **kw)
    rp, ip = trescan.rescan4_rows(*ops_p, **kw)
    assert ttesting.kernel_agreement(rk, rp)[0] and torch.equal(ik, ip)
