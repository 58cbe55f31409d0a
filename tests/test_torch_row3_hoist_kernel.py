"""Kernel 12, the hoists of the [N1, N2, 1] (flagship) row pass
(``csrc/row3hoist.cu``), as far as the CPU sees it.

On a card ``f32scan.rowmin_3_operands`` runs kernel 13 (the rhs columns),
kernel 1 twice and then kernel 12 (``row3_hoist``) for the small Grams,
the block-1 row intervals, the block-1-free floor, the column lows and
the chain prefixes that kernel 2 reads; on the CPU it runs the plain
version ``row3_hoist_twin`` (the code ``rowmin_3_operands`` ran itself
before the kernel), bit for bit ``rowmin_3_operands_plain``. The packs
are the JAX package's (``rowmin_3(pallas=True, _prep_only=True)``). The
kernel sums the small Grams' float64 corrections in sample order, where
the plain version's einsum takes another order: summed in the kernel's
order (``testing.fdot_sample_order``) the plain version's outputs agree
by ``testing.kernel_agreement`` (the flag exactly), kernel 2's plain
version gives the same bounds, the row pass is the JAX package's and
``df3_twopass`` selects the same. The pack layout read from the source
is ``rowmin3.cu``'s. The ``cuda`` test holds the kernel against its
plain version on a card.
"""

import inspect
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
from microstructure_fingerprinting_torch.ops import prep as tprep

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(mft.__file__), "csrc")
NAMES = ("row_pack", "col_pack", "vox", "lo_c_sup", "upf")
#: row_pack entry of the 0/1 flag stab1
STAB1 = 11


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _row_problem(rng, B=2, S=36, N1=160, N2=96):
    """``tests/test_torch_kernels.py``'s rowmin_3 family (corr 0.9,
    positive; its shapes, whose JAX programs that file compiles)."""
    A1 = np.abs(rng.randn(B, S, N1)) + 0.05
    A2 = np.abs(rng.randn(B, S, N2)) + 0.05
    base = np.abs(rng.randn(B, S, 1))
    A1 = 0.9 * base + 0.1 * A1
    A2 = 0.9 * base + 0.1 * A2
    a3 = np.abs(rng.randn(B, S, 1)) + 0.05
    y = np.abs(rng.randn(B, S))
    f = np.float32
    return tuple(f(x) for x in (A1, A2, a3, y))


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return a.dtype == b.dtype and torch.equal(a, b)


def _outputs(args):
    ops, (lo_c, upf) = tf32scan.rowmin_3_operands(*args)
    return (ops[6], ops[7], ops[8], lo_c, upf), ops


@pytest.mark.parametrize("N2", [96, 700])
def test_cpu_dispatch_runs_the_plain_version(rng, N2):
    """On CPU tensors rowmin_3_operands is rowmin_3_operands_plain, bit
    for bit, kernel 12's inputs are what rowmin_3_prep hands over (the
    rhs columns normalized as pack_rhs's caller normalized them), and
    rowmin_3 launches nothing."""
    args = tuple(_t(x) for x in _row_problem(rng, N2=N2))
    kernels.reset_counts()
    got, ops = _outputs(args)
    want_ops, (lo_p, upf_p) = tf32scan.rowmin_3_operands_plain(*args)
    assert all(_same_bits(a, b) for a, b in zip(ops, want_ops))
    assert _same_bits(got[3], lo_p) and _same_bits(got[4], upf_p)
    planes, (gA, gB, yh, A3h) = tf32scan.rowmin_3_prep(*args)
    assert all(_same_bits(a, b) for a, b in zip(planes, ops[:6]))
    out = tf32scan.row3_hoist_twin(gA, gB, yh, A3h)
    assert all(_same_bits(a, b) for a, b in zip(out, got))
    assert _same_bits(yh, tprep.rhs_prep_twin(args[3], args[2])[3])
    tf32scan.rowmin_3(*args, colmin=True)
    for name in ("rhsprep", "prep_block", "row3hoist", "rowmin3"):
        assert kernels.LAUNCHES[name] == 0, name


def test_pack_sizes_and_padding(rng):
    """The packs are (B, 16, N1p), (B, 8, N2pb) and (B, 8) with 12, 6 and
    2 entries used and zeros after, stab1 is 0 or 1, the padded atoms
    (rows past N1, columns past N2: zero Grams) run the chain (1 / d1 =
    inf), and the padded columns' lows are -KERR (the {2, 3} support on a
    zero column: an unstable pivot, [-KERR, +inf) under the K = 3 case
    logic; rowmin_3 cuts them off)."""
    B, N1, N2 = 2, 160, 300
    args = tuple(_t(x) for x in _row_problem(rng, B=B, N1=N1, N2=N2))
    (rp, cp, vx, lo_c, upf), _ops = _outputs(args)
    N1p, N2pb = rp.shape[2], cp.shape[2]
    assert (rp.shape, cp.shape, vx.shape) == ((B, 16, N1p), (B, 8, N2pb),
                                              (B, 8))
    assert N1p % tdfscan.HOIST_ATOMS == 0 and N2pb % tdfscan.HOIST_ATOMS == 0
    assert not rp[:, 12:].any() and not cp[:, 6:].any()
    assert not vx[:, 2:].any()
    f = rp[:, STAB1]
    assert ((f == 0) | (f == 1)).all() and f[:, :N1].any()
    assert torch.isinf(rp[:, 1, N1:]).all()            # 1 / d1 = 1 / 0
    assert torch.isfinite(rp[:, 1, :N1]).all()
    assert (lo_c[:, N2:] == -tf32scan.KERR).all()
    assert torch.isfinite(lo_c[:, :N2]).any()
    assert torch.isfinite(upf).all() and torch.isfinite(vx[:, :2]).all()


def test_wrapper_rejects_unsupported_shapes():
    """Kernel 12 takes N3 = 1 and N1p, N2pb positive multiples of 128
    (every shape kernel 2 takes on the card); the wrapper raises on
    others before any launch."""
    z = lambda *s: torch.zeros(s)
    for ok in ((z(2, 16, 896), z(2, 16, 1024), z(2, 8, 1)),
               (z(2, 16, 128), z(2, 16, 128), z(2, 8, 1))):
        tf32scan.row3_hoist_shapes(*ok)
    for bad in ((z(2, 16, 896), z(2, 16, 1024), z(2, 8, 2)),
                (z(2, 16, 100), z(2, 16, 1024), z(2, 8, 1)),
                (z(2, 16, 896), z(2, 16, 1000), z(2, 8, 1)),
                (z(2, 16, 0), z(2, 16, 128), z(2, 8, 1))):
        with pytest.raises(ValueError, match="unsupported row-pass hoist"):
            tf32scan.row3_hoist_shapes(*bad)


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_layout_is_the_sources():
    """The pack sizes kernel 12 writes are the strides kernel 2 reads
    and the twin's; the entries kernel 2 reads (``srow[i]``, ``scol[j]``,
    ``vox``) sit where kernel 12 and the twin write them; the Gram rows
    and the atoms a block are the wrappers'."""
    text, reads = _src("row3hoist.cu"), _src("rowmin3.cu")
    sizes = dict(re.findall(r"(k\w+) = (\d+)", text))
    assert (sizes["kRowPack"], sizes["kColPack"], sizes["kVox"]) == (
        "16", "8", "8")
    assert (sizes["kRowUsed"], sizes["kColUsed"]) == ("12", "6")
    assert "row_pack[((size_t)b * 16 + k / TM)" in reads
    assert "col_pack[((size_t)b * 8 + k / TN)" in reads
    assert "vox[(size_t)b * 8 + 0]" in reads and "vox[(size_t)b * 8 + 1]" \
        in reads
    assert int(sizes["kGramRows"]) == tf32scan.GRAM_ROWS
    # the twin's row entries, the kernel's, and what kernel 2 reads
    twin = inspect.getsource(tf32scan.row3_hoist_twin)
    rowv = re.search(r"rowv = \[(.*?)\]", twin, re.S).group(1)
    twin_rows = [n.strip().replace(".float()", "") for n in rowv.split(",")]
    kern = re.search(r"rows\[kRowUsed\] = \{(.*?)\};", text, re.S).group(1)
    kern_rows = [n.strip() for n in kern.split(",")]
    alias = {"acc.lo": "lo_row", "acc.up": "up_row",
             "stab1 ? 1.0f : 0.0f": "stab1"}
    assert [alias.get(n, n) for n in kern_rows] == twin_rows
    for name, i in re.findall(r"(\w+)t = srow\[(\d+)\]", reads):
        assert twin_rows[int(i)] == name, name
    assert "stab1t = srow[%d][i] > 0.5f" % STAB1 in reads
    cols = re.search(r"torch.stack\(\[(d2, .*?)\], dim=1\)", twin).group(1)
    twin_cols = [n.strip() for n in cols.split(",")]
    col_names = {"d2c": "d2", "qc": "q_", "cc": "c_", "d2pc": "d2p",
                 "q2pc": "q2p", "kapcc": "kap_c"}
    for name, j in re.findall(r"(\w+) = scol\[(\d+)\]", reads):
        assert twin_cols[int(j)] == col_names[name], name
    assert "vx[0] = u3;" in text and "vx[1] = invd3;" in text
    assert "u3v = vox[(size_t)b * 8 + 0]" in reads
    with open(os.path.join(CSRC, "hoist.cuh")) as f:
        assert int(re.search(r"kAtoms = (\d+);", f.read()).group(1)) == \
            tdfscan.HOIST_ATOMS


@pytest.mark.parametrize("N2", [96, 700])
def test_twin_packs_match_jax(rng, N2):
    """``row3_hoist_twin``'s packs (through rowmin_3_operands) against
    the JAX rowmin_3(pallas=True, interpret=True, _prep_only=True) on the
    same float32 inputs. The JAX package sums the norms of the rhs and
    atom columns in float32, the port in float64 rounded once, so a
    norm, and every value built on it, may sit an ulp or two away; the
    hoists then divide by pivots of ~0.1-1. Tolerance: the same inf/NaN
    entries, the 0/1 flag equal, finite entries within 1e-5 of each
    other (the row pass's error radius KERR is ~1e-6 per unit weight:
    its own tests hold its bounds to 1e-5)."""
    args = _row_problem(rng, N2=N2)
    oj = jf32scan.rowmin_3(*[jnp.asarray(x) for x in args], pallas=True,
                           interpret=True, _prep_only=True)
    (rp, cp, vx, _lo, _upf), _ops = _outputs(tuple(_t(x) for x in args))
    B = rp.shape[0]
    for name, j, t in (("row_pack", oj[6], rp), ("col_pack", oj[7], cp),
                       ("vox", np.asarray(oj[8]).reshape(B, 8), vx)):
        j, t = np.asarray(j, np.float32), t.numpy()
        assert j.shape == t.shape, name
        assert np.array_equal(np.isnan(j), np.isnan(t)), name
        assert np.array_equal(np.isinf(j), np.isinf(t)), name
        fin = np.isfinite(j)
        assert np.array_equal(j[~fin & ~np.isnan(j)],
                              t[~fin & ~np.isnan(t)]), name
        np.testing.assert_allclose(t[fin], j[fin], rtol=0, atol=1e-5,
                                   err_msg=name)
    assert np.array_equal(np.asarray(oj[6])[:, STAB1], rp[:, STAB1].numpy())


def _kernel_order_hoist(monkeypatch):
    """``row3_hoist_twin`` with the small Grams' float64 sums in kernel
    12's order (sample after sample)."""
    def hoist(*a):
        with monkeypatch.context() as m:
            m.setattr(tdfscan, "fdot", ttesting.fdot_sample_order)
            return tf32scan.row3_hoist_twin(*a)
    return hoist


@pytest.mark.parametrize("N2", [96, 700])
def test_kernel_summation_order(rng, monkeypatch, N2):
    """The small Grams' corrections are float64 sums of exact bf16
    products whose last bits depend on the order. Summed in the kernel's
    order the plain version's outputs agree with the einsum order's by
    ``testing.kernel_agreement``, the flag exactly, and kernel 2's plain
    version gives the same row and column bounds from both."""
    args = tuple(_t(x) for x in _row_problem(rng, N2=N2))
    planes, ins = tf32scan.rowmin_3_prep(*args)
    out0 = tf32scan.row3_hoist_twin(*ins)
    out1 = _kernel_order_hoist(monkeypatch)(*ins)
    for name, a, b in zip(NAMES, out1, out0):
        ok, n_diff, _n, err, tol = ttesting.kernel_agreement(a, b)
        assert ok, (name, n_diff, err, tol)
    assert torch.equal(out1[0][:, STAB1], out0[0][:, STAB1])
    kw = dict(n1=160, n2=N2)
    b0 = tf32scan.rowmin3_rows(*(planes + out0[:3]), **kw)
    b1 = tf32scan.rowmin3_rows(*(planes + out1[:3]), **kw)
    for a, b in zip(b1, b0):
        assert ttesting.kernel_agreement(a, b)[0]


@pytest.mark.parametrize("N2", [96, 700])
def test_row_pass_on_kernel12_order_matches_jax(rng, monkeypatch, N2):
    """``rowmin_3`` with the hoists summed as kernel 12 sums them against
    JAX rowmin_3(pallas=True, interpret=True, colmin=True) on the shapes
    of ``tests/test_torch_kernels.py::test_rowmin3_matches_jax`` (programs
    the suite compiles there), at that test's tolerance: finite pattern
    >= 99%, atol 1e-5 on lo, up, upf and lo_col."""
    args = _row_problem(rng, N2=N2)
    rj = jf32scan.rowmin_3(*[jnp.asarray(x) for x in args], pallas=True,
                           interpret=True, colmin=True)
    monkeypatch.setattr(tf32scan, "row3_hoist",
                        _kernel_order_hoist(monkeypatch))
    rt = tf32scan.rowmin_3(*[_t(x) for x in args], colmin=True)
    for x0, x1 in zip(rj, rt):
        x0, x1 = np.asarray(x0), x1.numpy()
        assert x0.shape == x1.shape
        pat = np.isfinite(x0) == np.isfinite(x1)
        assert pat.mean() >= 0.99, "support pattern diverged"
        m = pat & np.isfinite(x0)
        assert m.any()
        np.testing.assert_allclose(x1[m], x0[m], rtol=0, atol=1e-5)


def test_twopass_selection_unchanged(rng, monkeypatch):
    """``df3_twopass`` with kernel 12's summation order selects what it
    selects with the einsum order: the same candidates, values and ok,
    with column pruning (N2 = 140 > R = 64)."""
    args = tuple(_t(x) for x in _row_problem(rng, B=4, S=40, N1=150,
                                             N2=140))
    c0, v0, _q0, ok0 = tf32scan.df3_twopass(*args, R=64)
    monkeypatch.setattr(tf32scan, "row3_hoist",
                        _kernel_order_hoist(monkeypatch))
    c1, v1, _q1, ok1 = tf32scan.df3_twopass(*args, R=64)
    assert ok0.any()
    assert torch.equal(ok1, ok0) and torch.equal(c1, c0)
    assert _same_bits(v1, v0)


@pytest.mark.cuda
def test_cuda_row3_hoist_matches_plain_version(rng):
    """On the card, with padded rows and two column blocks, the CSF
    column shared by every voxel (stride 0, as the fit passes it): every
    output by ``testing.kernel_agreement`` (the flag exactly, NaN bits
    included), kernel 2 fed either operand set gives the same bounds, and
    rowmin_3_operands launches kernels 13 and 12 once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    A1, A2, a3, y = (_t(x).cuda() for x in _row_problem(rng, B=4, S=64,
                                                         N1=200, N2=300))
    a3 = a3[:1].expand(4, -1, -1)
    kernels.reset_counts()
    ops_k, (lo_k, upf_k) = tf32scan.rowmin_3_operands(A1, A2, a3, y)
    assert kernels.LAUNCHES["row3hoist"] == 1
    assert kernels.LAUNCHES["rhsprep"] == 1
    ops_p, (lo_p, upf_p) = tf32scan.rowmin_3_operands_plain(A1, A2, a3, y)
    outs_k = (ops_k[6], ops_k[7], ops_k[8], lo_k, upf_k)
    outs_p = (ops_p[6], ops_p[7], ops_p[8], lo_p, upf_p)
    for a, b in zip(outs_k, outs_p):
        assert ttesting.kernel_agreement(a, b)[0]
        nan = torch.isnan(b)
        assert torch.equal(a[nan].view(torch.int32),
                           b[nan].view(torch.int32))
    assert torch.equal(outs_k[0][:, STAB1], outs_p[0][:, STAB1])
    kw = dict(n1=200, n2=300)
    bk = tf32scan.rowmin3_rows(*ops_k, **kw)
    bp = tf32scan.rowmin3_rows(*ops_p, **kw)
    for a, b in zip(bk, bp):
        assert ttesting.kernel_agreement(a, b)[0]
