"""Kernel 11, the hoists of the 4-block (EAR) row pass
(``csrc/row4hoist.cu``), as far as the CPU sees it.

On a card ``f32scan.rowmin_4_operands`` runs kernel 1 twice and then
kernel 11 (``row4_hoist``) for the small Grams, the block-1-free floor,
the column lows, the row-level supports and the chain prefixes that
kernel 4 reads; on the CPU it runs the plain version ``row4_hoist_twin``
(the code ``rowmin_4_operands`` ran itself before the kernel, which
re-quantizes the rhs columns as ``prep.pack_rhs`` does), bit for bit
``rowmin_4_operands_plain``. The kernel sums the small Grams' float64
corrections in sample order, where the plain version's einsum takes
another order: summed in the kernel's order (``testing.fdot_sample_order``)
the plain version's outputs agree by ``testing.kernel_agreement`` (flags
exactly), kernel 4's plain version gives the same bounds, the row pass
is the JAX package's and ``df4_twopass`` selects the same. The pack
layout read from the source is ``rowmin4.cu``'s and ``row4_pack_rows``'.
The ``cuda`` test holds the kernel against its plain version on a card.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.ops import f32scan as jf32scan

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import f32scan as tf32scan
from microstructure_fingerprinting_torch.ops import kernels
from microstructure_fingerprinting_torch.ops import nnls as tnnls
from microstructure_fingerprinting_torch.ops import prep as tprep

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(mft.__file__), "csrc")
NAMES = ("row_pack", "col_pack", "vox", "lo_c_sup", "upf")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _row_problem(rng, B=2, S=36, N1=96, N2=128, n4=5):
    """``tests/test_torch_ear_kernels.py``'s rowmin_4 family (corr 0.9,
    positive; its shapes, whose JAX programs that file compiles)."""
    A1 = np.abs(rng.randn(B, S, N1)) + 0.05
    A2 = np.abs(rng.randn(B, S, N2)) + 0.05
    base = np.abs(rng.randn(B, S, 1))
    A1 = 0.9 * base + 0.1 * A1
    A2 = 0.9 * base + 0.1 * A2
    a3 = np.abs(rng.randn(B, S, 1)) + 0.05
    y = np.abs(rng.randn(B, S))
    a4 = np.abs(rng.randn(B, S, n4)) + 0.05
    f = np.float32
    return tuple(_t(f(x)) for x in (A1, A2, a3, a4, y))


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


def _hoist_inputs(args, colcap=512):
    """Kernel 11's inputs as ``rowmin_4_operands`` hands them over."""
    return tf32scan.rowmin_4_prep(*args, colcap)[1]


def _flags(n4):
    """Entries of the packs that hold 0/1 flags: (row entries, vox
    entries): stab3r, stab4r and stabr of every pair; stab34."""
    nx = 1 + n4
    rows = [2 + 5 * x + 4 for x in range(nx)]
    rows += [2 + 5 * nx + 5 * s + 4 for s in range(n4)]
    return rows, [1 + nx + 3 * s + 2 for s in range(n4)]


def _outputs(args, colcap=512):
    ops, nr, (lo_c, upf) = tf32scan.rowmin_4_operands(*args,
                                                      colcap=colcap)
    return (ops[6], ops[7], ops[8], lo_c, upf), nr, ops


@pytest.mark.parametrize("N2,n4,colcap", [(128, 5, 512), (200, 10, 128),
                                          (128, 1, 512)])
def test_cpu_dispatch_runs_the_plain_version(rng, N2, n4, colcap):
    """On CPU tensors rowmin_4_operands is rowmin_4_operands_plain, bit
    for bit, the row-level entry nr is where the plain version's row
    pack holds it, the rhs columns the twin quantizes are pack_rhs's
    (its levels and planes, bit for bit), and rowmin_4 launches
    nothing."""
    args = _row_problem(rng, N2=N2, n4=n4)
    kernels.reset_counts()
    got, nr, ops = _outputs(args, colcap)
    want_ops, nr_p, (lo_p, upf_p) = tf32scan.rowmin_4_operands_plain(
        *args, colcap=colcap)
    assert nr == nr_p == tf32scan.row4_pack_rows(1, n4)[0]
    assert all(_same_bits(a, b) for a, b in zip(ops, want_ops))
    assert _same_bits(got[3], lo_p) and _same_bits(got[4], upf_p)
    # row_pack entries nr, nr + 1 are the row-level [lo, up]
    lo_r, up_r = got[0][:, nr], got[0][:, nr + 1]
    assert (lo_r <= up_r).all() and torch.isfinite(lo_r).any()
    yh = tnnls._normalize_y(args[4])[0]
    cols = tf32scan._rhs_cols(yh, tnnls._normalize_block(args[2])[0],
                              tnnls._normalize_block(args[3])[0])
    q3s = tprep.pack_rhs(cols)[3]
    assert all(_same_bits(a, b) for q, c in zip(q3s, cols)
               for a, b in zip(q, tdfscan.quantize3(c.float())))
    tf32scan.rowmin_4(*args, colmin=True, colcap=colcap)
    assert kernels.LAUNCHES["row4hoist"] == 0
    assert kernels.LAUNCHES["rowmin4"] == 0


def test_pack_sizes_and_padding(rng):
    """The packs' sizes are ``row4_pack_rows``' (nr + 2 row entries, the
    column and voxel entries, each padded to 8), the padding entries are
    zeros, the flags are 0 or 1, and the padded atoms (rows past N1,
    columns past N2: zero Grams) run the chain, the padded columns'
    lows and floor terms +inf."""
    n4 = 5
    args = _row_problem(rng, N1=96, N2=200, n4=n4)
    (rp, cp, vx, lo_c, upf), nr, _ops = _outputs(args, 128)
    nr_, NR, NC, NV = tf32scan.row4_pack_rows(1, n4)
    assert (rp.shape[1], cp.shape[1], vx.shape[1]) == (NR, NC, NV)
    nx, ns = 1 + n4, n4
    assert not rp[:, nr + 2:].any()
    assert not cp[:, 2 + 4 * nx + 4 * ns:].any()
    assert not vx[:, 1 + nx + 3 * ns:].any()
    rows, vox = _flags(n4)
    for f in (rp[:, rows], vx[:, vox]):
        assert ((f == 0) | (f == 1)).all()
    assert torch.isinf(rp[:, 0, 96:]).all()            # 1 / d1 = 1 / 0
    assert torch.isinf(lo_c[:, 200:]).all()
    assert torch.isfinite(lo_c[:, :200]).any()
    assert torch.isfinite(upf).all()


def test_wrapper_rejects_unsupported_shapes():
    """Kernel 11 takes N3 = 1, 1 <= N4 <= 13 (kernel 1's Grams hold 15
    rhs columns) and N1p, N2pb multiples of 128 (every shape kernel 4
    takes on the card); the wrapper raises on others before any
    launch."""
    z = lambda *s: torch.zeros(s)
    assert tf32scan.ROW4_HOIST_MAX_E == tprep.MAX_RHS - 2 == 13
    for ok in ((z(2, 16, 896), z(2, 16, 1024), z(2, 8, 1), z(2, 8, 10)),
               (z(2, 16, 128), z(2, 16, 128), z(2, 8, 1), z(2, 8, 13))):
        tf32scan.row4_hoist_shapes(*ok)
    for bad in ((z(2, 16, 896), z(2, 16, 1024), z(2, 8, 2), z(2, 8, 5)),
                (z(2, 16, 896), z(2, 16, 1024), z(2, 8, 1), z(2, 8, 14)),
                (z(2, 16, 896), z(2, 16, 1024), z(2, 8, 1), z(2, 8, 0)),
                (z(2, 16, 100), z(2, 16, 1024), z(2, 8, 1), z(2, 8, 10)),
                (z(2, 16, 896), z(2, 16, 1000), z(2, 8, 1), z(2, 8, 10))):
        with pytest.raises(ValueError, match="unsupported row-pass hoist"):
            tf32scan.row4_hoist_shapes(*bad)


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _c_ints(text, env):
    """Evaluate the ``const int a = ..., b = ...;`` declarations of C text
    whose values follow from ``env`` (integer arithmetic only); the
    others are skipped."""
    for decl in re.findall(r"const int ([^;]+);", text):
        for part in decl.split(","):
            name, expr = part.split("=", 1)
            try:
                env[name.strip()] = eval(expr.replace("/", "//"), {},
                                         dict(env))
            except (NameError, SyntaxError, TypeError):
                pass
    return env


@pytest.mark.parametrize("n4", [1, 10, 13])
def test_layout_is_the_sources(n4):
    """The offsets kernel 11 writes at (its "pack layout offsets") are
    the ones kernel 4 reads at, its sizes are ``row4_pack_rows``', the
    launcher's checks (NR, NC, NV) are those sizes padded to 8, and its
    largest EAR count and Gram rows are the wrapper's."""
    base = {"n3": 1, "n4": n4, "nx": 1 + n4, "ns": n4}
    text = _src("row4hoist.cu")
    block = text[text.index("// pack layout offsets"):]
    writer = _c_ints(block[:block.index("\n\n")], dict(base))
    reader = _c_ints(_src("rowmin4.cu"), dict(base))
    for k in ("r0", "c0", "v0", "nrow", "ncol", "nvox"):
        assert writer[k] == reader[k], k
    nr, NR, NC, NV = tf32scan.row4_pack_rows(1, n4)
    assert (writer["nrow"], writer["ncol"], writer["nvox"]) == (
        nr, NC - (-writer["ncol"] % 8), NV - (-writer["nvox"] % 8))
    launcher = text[text.index('extern "C" int mf_row4hoist'):]
    env = _c_ints(launcher[:launcher.index("const auto pad8")],
                  {"n4": n4})
    assert (env["nrow"], env["ncol"], env["nvox"]) == (
        writer["nrow"], writer["ncol"], writer["nvox"])
    assert "NR != pad8(nrow + 2)" in launcher
    assert "(n + 7) / 8 * 8" in launcher
    assert tuple((n + 7) // 8 * 8 for n in (nr + 2, env["ncol"],
                                            env["nvox"])) == (NR, NC, NV)
    assert int(re.search(r"kMaxE = (\d+);", text).group(1)) == \
        tf32scan.ROW4_HOIST_MAX_E
    assert int(re.search(r"kGramRows = (\d+);", text).group(1)) == \
        tf32scan.GRAM_ROWS
    # the entries inside each group, in the order kernel 4 reads them
    reads = _src("rowmin4.cu")
    for group in ("L1x = Rx[0], invd1px = Rx[TM], kap_ppx = Rx[2 * TM]",
                  "rho1x = Rx[3 * TM], zx = Rx[4 * TM]",
                  "kap_cx = Cx[0], d2px = Cx[TN], q2px = Cx[2 * TN]",
                  "cxc = Cx[3 * TN]",
                  "L14 = Rs[0], invD1h = Rs[TM], kap1 = Rs[2 * TM]",
                  "rho1f = Rs[3 * TM], zr = Rs[4 * TM]",
                  "e4c = Cs[0], L24 = Cs[TN], d2r = Cs[2 * TN]",
                  "q2r = Cs[3 * TN]",
                  "u4 = svox[v0 + 3 * s], L43 = svox[v0 + 3 * s + 1]",
                  "z34 = svox[v0 + 3 * s + 2]"):
        assert group in reads, group
    for group in ("row3[5] = {x3.L1x, x3.invd1px, x3.kap_ppx, x3.rho1x,",
                  "pairs[5] = {L14, invD1h, kap1, sub(v.rho34, mul(pi1, "
                  "kap1)),",
                  "col4[4] = {kap_c4, sub(d2, mul(c4, kap_c4)),",
                  "pairs[4] = {\n        e4cc, L24,",
                  "vx[v0 + 3 * j] = v.u4;",
                  "vx[v0 + 3 * j + 1] = v.L43;",
                  "vx[v0 + 3 * j + 2] = v.stab34 ? 1.0f : 0.0f;"):
        assert group in text, group
    with open(os.path.join(CSRC, "hoist.cuh")) as f:
        assert int(re.search(r"kAtoms = (\d+);", f.read()).group(1)) == \
            tdfscan.HOIST_ATOMS


def _kernel_order_hoist(monkeypatch):
    """``row4_hoist_twin`` with the small Grams' float64 sums in kernel
    11's order (sample after sample)."""
    def hoist(*a):
        with monkeypatch.context() as m:
            m.setattr(tdfscan, "fdot", ttesting.fdot_sample_order)
            return tf32scan.row4_hoist_twin(*a)
    return hoist


@pytest.mark.parametrize("N2,n4,colcap", [(128, 5, 512), (200, 10, 128)])
def test_kernel_summation_order(rng, monkeypatch, N2, n4, colcap):
    """The small Grams' corrections are float64 sums of exact bf16
    products whose last bits depend on the order. Summed in the kernel's
    order the plain version's outputs agree with the einsum order's by
    ``testing.kernel_agreement``, flags exactly, and kernel 4's plain
    version gives the same row and column bounds from both."""
    args = _row_problem(rng, N2=N2, n4=n4)
    ins = _hoist_inputs(args, colcap)
    out0 = tf32scan.row4_hoist_twin(*ins)
    out1 = _kernel_order_hoist(monkeypatch)(*ins)
    for name, a, b in zip(NAMES, out1, out0):
        ok, n_diff, _n, err, tol = ttesting.kernel_agreement(a, b)
        assert ok, (name, n_diff, err, tol)
    rows, vox = _flags(n4)
    assert torch.equal(out1[0][:, rows], out0[0][:, rows])
    assert torch.equal(out1[2][:, vox], out0[2][:, vox])
    _got, nr, ops = _outputs(args, colcap)
    kw = dict(n1=96, n2=N2, n3=1, n4=n4, nr=nr)
    b0 = tf32scan.rowmin4_rows(*ops, **kw)
    b1 = tf32scan.rowmin4_rows(*(ops[:6] + tuple(out1[:3])), **kw)
    for a, b in zip(b1, b0):
        assert ttesting.kernel_agreement(a, b)[0]


@pytest.mark.parametrize("N2,colcap", [(128, 512), (200, 128)])
def test_row_pass_on_kernel11_order_matches_jax(rng, monkeypatch, N2,
                                                colcap):
    """``rowmin_4`` with the hoists summed as kernel 11 sums them against
    JAX rowmin_4(pallas=True, interpret=True, colmin=True) on the shapes
    of ``tests/test_torch_ear_kernels.py::test_rowmin4_matches_jax``
    (programs the suite compiles there), at that test's tolerance:
    finite pattern >= 99%, atol 1e-5 on lo, up, upf and lo_col."""
    args = _row_problem(rng, N2=N2)
    rj = jf32scan.rowmin_4(*[jnp.asarray(x.numpy()) for x in args],
                           pallas=True, interpret=True, colmin=True,
                           colcap=colcap)
    monkeypatch.setattr(tf32scan, "row4_hoist",
                        _kernel_order_hoist(monkeypatch))
    rt = tf32scan.rowmin_4(*args, colmin=True, colcap=colcap)
    for x0, x1 in zip(rj, rt):
        x0, x1 = np.asarray(x0), x1.numpy()
        assert x0.shape == x1.shape
        pat = np.isfinite(x0) == np.isfinite(x1)
        assert pat.mean() >= 0.99, "support pattern diverged"
        m = pat & np.isfinite(x0)
        assert m.any()
        np.testing.assert_allclose(x1[m], x0[m], rtol=0, atol=1e-5)


def test_twopass_selection_unchanged(rng, monkeypatch):
    """``df4_twopass`` with kernel 11's summation order selects what it
    selects with the einsum order: the same candidates, values and ok,
    with column pruning (N2 = 200 > R = 64)."""
    args = _row_problem(rng, N1=96, N2=200, n4=5)
    c0, v0, _q0, ok0 = tf32scan.df4_twopass(*args, R=64)
    monkeypatch.setattr(tf32scan, "row4_hoist",
                        _kernel_order_hoist(monkeypatch))
    c1, v1, _q1, ok1 = tf32scan.df4_twopass(*args, R=64)
    assert ok0.any()
    assert torch.equal(ok1, ok0) and torch.equal(c1, c0)
    assert _same_bits(v1, v0)


@pytest.mark.cuda
def test_cuda_row4_hoist_matches_plain_version(rng):
    """On the card, at the EAR width N4 = 10 with padded rows and two
    column blocks: every output by ``testing.kernel_agreement`` (flags
    exactly, NaN bits included), kernel 4 fed either operand set gives
    the same bounds, and rowmin_4_operands launches kernel 11 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = tuple(x.cuda() for x in _row_problem(rng, B=4, S=64, N1=200,
                                                N2=300, n4=10))
    kernels.reset_counts()
    ops_k, nr, (lo_k, upf_k) = tf32scan.rowmin_4_operands(*args,
                                                           colcap=256)
    assert kernels.LAUNCHES["row4hoist"] == 1
    ops_p, _nr, (lo_p, upf_p) = tf32scan.rowmin_4_operands_plain(
        *args, colcap=256)
    outs_k = (ops_k[6], ops_k[7], ops_k[8], lo_k, upf_k)
    outs_p = (ops_p[6], ops_p[7], ops_p[8], lo_p, upf_p)
    for a, b in zip(outs_k, outs_p):
        assert ttesting.kernel_agreement(a, b)[0]
        nan = torch.isnan(b)
        assert torch.equal(a[nan].view(torch.int32),
                           b[nan].view(torch.int32))
    rows, vox = _flags(10)
    assert torch.equal(outs_k[0][:, rows], outs_p[0][:, rows])
    assert torch.equal(outs_k[2][:, vox], outs_p[2][:, vox])
    kw = dict(n1=200, n2=300, n3=1, n4=10, nr=nr)
    bk = tf32scan.rowmin4_rows(*ops_k, **kw)
    bp = tf32scan.rowmin4_rows(*ops_p, **kw)
    for a, b in zip(bk, bp):
        assert ttesting.kernel_agreement(a, b)[0]
