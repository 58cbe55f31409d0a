"""Kernel 6, the df2 scan (``csrc/df2scan.cu``), as far as the CPU sees it.

On a card ``dfscan.df2_candidates(M=1)`` is ``df2_scan_operands`` (the
hoists, in torch), the kernel (per row i1 its least residual in total
order and first i2) and ``df2_top1_from_rows`` (the first minimum across
rows). Here the same route with the kernel's plain version
(``df2_rows_twin``) must equal ``df2_candidates_plain`` at M = 1 bit for
bit, on both shapes the fit runs ([N, N] and [N, 1]), through ties,
singular pairs, all-zero atoms and rows past N1; and the JAX
``df2_candidates`` on the same seeded inputs (candidates equal, values
within 1e-6 as ``tests/test_torch_buckets.py`` holds the plain version).
The kernel sums its float64 cross products in another order than the
einsum: the tile's (``mma`` steps) and, on [N, 1], sample order; in
both the plain version picks the same rows and values within
``testing.kernel_agreement``. The wrapper's tiling is read from the
source. The ``cuda`` test holds the kernel against its plain version on
a card.

Kernel 9 (``csrc/df2hoist.cu``) builds kernel 6's operands on the card
(``df2_scan_operands``: normalization in torch, then ``df2_hoist``); on
the CPU the plain version ``df2_hoist_twin`` runs, bit for bit
``df2_scan_operands_plain``. Its float64 sums run in sample order
(``testing.fdot_sample_order``): the plain version in that order agrees
with the einsum order's and the route on such operands still matches
the JAX ``df2_candidates``. Its padded columns are zeros and its pack
sizes are kernel 6's.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.ops import dfscan as jdfscan
from microstructure_fingerprinting_tpu.ops import interp as jinterp

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import dfscan as tdfscan
from microstructure_fingerprinting_torch.ops import interp as tinterp
from microstructure_fingerprinting_torch.ops import kernels

torch.set_num_threads(2)
CU = os.path.join(os.path.dirname(mft.__file__), "csrc", "df2scan.cu")
SM_BYTES = 227 * 1024           # shared memory of an SM that blocks can use


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _problem(rng, case, N2, B=8, S=48, N1=32):
    """Seeded float32 (A1, A2, y): correlated positive atoms (a smooth
    dictionary's), then the case's defect."""
    base = np.abs(rng.randn(B, S, 1))
    A1 = 0.9 * base + 0.1 * (np.abs(rng.randn(B, S, N1)) + 0.05)
    A2 = 0.9 * base + 0.1 * (np.abs(rng.randn(B, S, N2)) + 0.05)
    y = np.abs(rng.randn(B, S))
    if case == "duplicated":            # exact ties everywhere
        A1 = np.tile(A1[:, :, :8], (1, 1, N1 // 8))
        A2 = np.tile(A2[:, :, :1], (1, 1, N2)) if N2 < 8 else \
            np.tile(A2[:, :, :4], (1, 1, N2 // 4))
    elif case == "singular":            # det12 = 0 on the shared pairs
        A2 = np.concatenate([A2[:, :, :N2 - 4], A1[:, :, 10:14]], axis=2) \
            if N2 > 4 else A1[:, :, 10:10 + N2]
    elif case == "zero_atom":           # 0/0 in res1_row: a NaN residual
        A1[:, :, 5] = 0.0
    elif case == "exact_fit":           # y in the span of a pair
        y = 0.7 * A1[:, :, 3] + 0.2 * A2[:, :, N2 - 1]
    return np.float32(A1), np.float32(A2), np.float32(y)


def _route(A1, A2, y, tile):
    """df2_candidates(M=1) as the card runs it, with the kernel's plain
    version: (cand, vals, y_sq, per-row values, per-row i2)."""
    ops, yn = tdfscan.df2_scan_operands(A1, A2, y, tile)
    rv, ri = tdfscan.df2_rows_twin(*ops, n1=A1.shape[2], n2=A2.shape[2])
    cand, vals = tdfscan.df2_top1_from_rows(rv, ri, A2.shape[2], tile)
    return cand, vals, yn * yn, rv, ri


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("N2", [28, 1])
@pytest.mark.parametrize("case,N1,tile", [
    ("plain", 32, 256), ("duplicated", 32, 256), ("singular", 32, 256),
    ("zero_atom", 32, 256), ("zero_atom", 40, 8), ("exact_fit", 24, 256),
    ("plain", 40, 16)])
def test_route_equals_df2_candidates(rng, case, N1, tile, N2):
    """The kernel's route (operand builder, per-row minima, first minimum
    across rows) equals ``df2_candidates_plain(M=1)`` bit for bit:
    candidates, residuals and ||y||^2. Rows past N1 (the padding to a
    multiple of ``tile``, zero atoms) never win; with tiles of 8 or 16
    rows the merge across several tiles is exercised. An all-zero atom
    gives res1_row = 0/0: on this CPU the NaN carries its sign bit, ranks
    first in its tile and so empties the tile (as in
    ``nnls._tile_topm``); the route must do the same."""
    A1, A2, y = (_t(x) for x in _problem(rng, case, N2, N1=N1))
    cp, vp, qp = tdfscan.df2_candidates_plain(A1, A2, y, 1, tile)
    cr, vr, qr, rv, _ri = _route(A1, A2, y, tile)
    assert cr.shape == (8, 1, 2) and cr.dtype == torch.int32
    assert torch.equal(cr, cp)
    assert _same_bits(vr, vp) and _same_bits(qr, qp)
    assert bool(torch.isinf(rv[:, N1:]).all())
    if case == "zero_atom":
        assert bool(torch.isnan(rv[:, 5]).all())


def test_cpu_dispatch_runs_the_plain_version(rng):
    """On CPU tensors df2_candidates(M=1) is df2_candidates_plain: no
    launch, the same values."""
    A1, A2, y = (_t(x) for x in _problem(rng, "plain", 28))
    kernels.reset_counts()
    got = tdfscan.df2_candidates(A1, A2, y, M=1)
    want = tdfscan.df2_candidates_plain(A1, A2, y, 1)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES["df2scan"] == 0


@pytest.fixture(scope="module")
def wl_blocks():
    """The fit's inputs at a small size: a 32-atom workload (3 shells x
    12 directions + 4 b0, 8 voxels) rotated to its voxels' two directions
    by the port's grouped rotation on the JAX package's tables, the
    signals and the CSF column in the rotation's sequence order."""
    w = ttesting.make_fit_workload(num_atom=32, n_vox=8, n_shells=3,
                                   dirs_per_shell=12, n_b0=4)
    ms = jinterp.init_PGSE_multishell_interp(
        w["dictionary"], w["sch_mat"], np.array([0.0, 0.0, 1.0]))
    tms = tinterp.MultiShellInterp.from_numpy(ms)
    rotate, perm = tinterp.make_grouped_rotation_paired(
        tms, jinterp.plan_target_scheme(ms, w["sch_mat"]))
    _x, ys, _c = tms.device_tables("cpu", torch.float32)
    D = rotate(ys, _t(w["peaks"]).float()).numpy()
    return D, np.float32(w["y"][:, perm]), np.float32(w["sig_csf"][perm])


@pytest.mark.parametrize("N2,duplicated", [(28, False), (28, True),
                                           (1, False), (1, True)])
def test_route_matches_jax(wl_blocks, N2, duplicated):
    """The route against the JAX ``df2_candidates(M=1)`` on the same
    float32 inputs, the fit's ([N, N]: the two rotated blocks; [N, 1]:
    the first against the CSF column; with ``duplicated`` every atom 4
    times): equal candidates (first-minimum order of the flat rank, also
    through exact ties), residuals of the normalized problem within
    1e-6, ||y||^2 to rtol 1e-6 (the tolerances of
    ``tests/test_torch_buckets.py::test_df2_candidates_matches_jax``: the
    JAX package sums its cross products in float32)."""
    D, y, csf = wl_blocks
    A1, A2 = D[:, 0], D[:, 1, :, :N2]
    if duplicated:
        A1, A2 = np.tile(A1[:, :, :8], (1, 1, 4)), np.tile(
            A2[:, :, 8:15] if N2 > 1 else A2, (1, 1, 4 if N2 > 1 else 1))
    if N2 == 1:
        A2 = np.broadcast_to(csf[None, :, None], (8, csf.size, 1))
    A1, A2 = (np.ascontiguousarray(x, np.float32) for x in (A1, A2))
    cj, vj, qj = jdfscan.df2_candidates(jnp.asarray(A1), jnp.asarray(A2),
                                        jnp.asarray(y), M=1)
    ct, vt, qt, _rv, _ri = _route(_t(A1), _t(A2), _t(y), 256)
    assert np.array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-6)


def _sums_in_order(step):
    """``dfscan.fdot`` for "bsi,bsj->bij" in the kernel's order: ``step``
    samples at a time onto one float64 accumulator (8, the float64 mma's
    depth, in chunks of 32 zero-padded samples, for the tile; 1, sample
    after sample, for the [N, 1] path), rounded once."""
    def fdot(contract, x, y):
        assert contract == "bsi,bsj->bij"
        x, y = x.double(), y.double()
        pad = -x.shape[1] % (32 if step == 8 else 1)
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
        acc = torch.zeros(x.shape[0], x.shape[2], y.shape[2],
                          dtype=torch.float64)
        for s in range(0, x.shape[1], step):
            acc = acc + torch.einsum(contract, x[:, s:s + step],
                                     y[:, s:s + step])
        return acc.float()
    return fdot


@pytest.mark.parametrize("N2,step", [(28, 8), (1, 1)])
def test_kernel_summation_order(rng, monkeypatch, N2, step):
    """c1 = A1h' Rb and c2 = Ra' ab are float64 sums of exact products
    whose last bits depend on the order. In the kernel's order (the
    tile's mma steps on [N, N], sample order on the narrow [N, 1] path)
    the plain version picks the same i2 on every row and the same top-1,
    with row minima inside ``testing.kernel_agreement``."""
    A1, A2, y = (_t(x) for x in _problem(rng, "plain", N2, S=64, N1=40))
    ops, _yn = tdfscan.df2_scan_operands(A1, A2, y)
    rv0, ri0 = tdfscan.df2_rows_twin(*ops, n1=40, n2=N2)
    monkeypatch.setattr(tdfscan, "fdot", _sums_in_order(step))
    rv1, ri1 = tdfscan.df2_rows_twin(*ops, n1=40, n2=N2)
    c0, _v0 = tdfscan.df2_top1_from_rows(rv0, ri0, N2)
    c1, _v1 = tdfscan.df2_top1_from_rows(rv1, ri1, N2)
    assert torch.equal(ri1, ri0) and torch.equal(c1, c0)
    ok, n_diff, _n, err, tol = ttesting.kernel_agreement(rv1, rv0)
    assert ok, (n_diff, err, tol)


def _const(name):
    with open(CU) as f:
        return int(re.search(r"\b%s = (\d+)" % name, f.read()).group(1))


def test_wrapper_tiling_is_the_kernels(rng):
    """The wrapper's constants and operand shapes are the source's: TN
    columns a tile, kNarrow rows a block of the [N, 1] path, kPack
    entries a row or column pack, kVox of the voxel vector; the [N, N]
    block's shared memory (the Gram tile's buffers at TN = 64, the packs
    and the residual tile) leaves two blocks an SM."""
    assert _const("TN") == tdfscan.DF2_TN == 64
    assert _const("kNarrow") == tdfscan.DF2_NARROW
    A1, A2, y = (_t(x) for x in _problem(rng, "plain", 28, B=2, N1=40))
    for a2, n2pb in ((A2, 64), (A2[:, :, :1], 1)):
        ops, _yn = tdfscan.df2_scan_operands(A1, a2, y)
        assert ops[4].shape[2] == n2pb
        assert ops[8].shape == (2, _const("kPack"), 256)
        assert ops[9].shape == (2, _const("kPack"), n2pb)
        assert ops[10].shape == (2, _const("kVox"))
        assert 256 % tdfscan.DF2_NARROW == 0
    TM, TN = 32, 64
    gram = 2 * 32 * ((2 * (TM + 16) + 2 * (TN + 16))
                     + 4 * (2 * (TM + 8) + 2 * (TN + 8)))
    own = 4 * (8 * TM + 8 * TN + TM * (TN + 1))
    assert 4 * TM * (TN + 1) <= gram
    assert 2 * (gram + own + 1024) <= SM_BYTES


@pytest.mark.cuda
def test_cuda_df2_kernel_matches_plain_version(rng):
    """On the card, both shapes: per-row minima by
    ``testing.kernel_agreement``, first i2 and the top-1 candidates
    exact, against the plain version on the same operands; and
    df2_candidates(M=1) launches the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for N2 in (300, 1):
        A1, A2, y = (_t(x).cuda() for x in
                     _problem(rng, "plain", N2, B=4, S=64, N1=200))
        ops, _yn = tdfscan.df2_scan_operands(A1, A2, y)
        rk, ik = tdfscan.df2_rows(*ops, n1=200, n2=N2)
        rp, ip = tdfscan.df2_rows_twin(*ops, n1=200, n2=N2)
        assert ttesting.kernel_agreement(rk, rp)[0]
        assert torch.equal(ik, ip)
        kernels.reset_counts()
        ck, _vk, _qk = tdfscan.df2_candidates(A1, A2, y, M=1)
        cp, _vp, _qp = tdfscan.df2_candidates_plain(A1, A2, y, 1)
        assert kernels.LAUNCHES["df2scan"] == 1
        assert torch.equal(ck, cp)


# ---------------------------------------------------------------------------
# kernel 9: the df2 scan's operands (csrc/df2hoist.cu)
# ---------------------------------------------------------------------------

OPS = ("q1a", "q2a", "a1h", "ra", "q1b", "q2b", "rb", "ab", "row_pack",
       "col_pack", "vox")


@pytest.mark.parametrize("N2", [28, 1])
def test_df2_hoist_cpu_dispatch_runs_the_plain_version(rng, N2):
    """On CPU tensors df2_scan_operands is df2_scan_operands_plain bit
    for bit (the all-zero atom's NaN included), with no launch."""
    A1, A2, y = (_t(x) for x in _problem(rng, "zero_atom", N2))
    kernels.reset_counts()
    got, yn = tdfscan.df2_scan_operands(A1, A2, y)
    want, yn_p = tdfscan.df2_scan_operands_plain(A1, A2, y)
    assert _same_bits(yn, yn_p)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert bool(torch.isnan(got[8][:, 6, 5]).all())
    assert kernels.LAUNCHES["df2hoist"] == 0


@pytest.mark.parametrize("N2", [28, 1])
def test_df2_hoist_padding_is_zero(rng, N2):
    """What kernel 9 must write where the plain version pads: the
    columns past N2 of the column planes and col_pack, each pack's 8th
    entry and vox's 4th are zeros; a1h is a + R, the normalized atoms
    themselves."""
    A1, A2, y = (_t(x) for x in _problem(rng, "plain", N2))
    ops, _yn = tdfscan.df2_scan_operands(A1, A2, y)
    A1h, _A2h, _yh, _yn = tdfscan.df2_normalized(A1, A2, y)
    assert ops[4].shape[2] == tdfscan.df2_cols(N2) == (1 if N2 == 1 else 64)
    for k in (4, 5, 6, 7, 9):
        assert not ops[k][:, :, N2:].any()
    assert not ops[8][:, 7].any() and not ops[9][:, 7].any()
    assert not ops[10][:, 3].any()
    assert _same_bits(ops[2], A1h)


@pytest.mark.parametrize("N2", [28, 1])
def test_df2_hoist_summation_order(rng, monkeypatch, N2):
    """Summed as kernel 9 sums (sample after sample), the plain
    version's operands agree with the einsum order's by
    ``testing.kernel_agreement`` (levels exactly), and kernel 6's plain
    version picks the same i2 on every row and the same top-1."""
    A1, A2, y = (_t(x) for x in _problem(rng, "plain", N2, S=64, N1=40))
    ops0, _yn = tdfscan.df2_scan_operands(A1, A2, y)
    monkeypatch.setattr(tdfscan, "fdot", ttesting.fdot_sample_order)
    ops1, _yn = tdfscan.df2_scan_operands(A1, A2, y)
    monkeypatch.undo()
    for name, a, b in zip(OPS, ops1, ops0):
        ok, n_diff, _n, err, tol = ttesting.kernel_agreement(
            a, b, a.dtype == torch.int8)
        assert ok, (name, n_diff, err, tol)
    rv0, ri0 = tdfscan.df2_rows_twin(*ops0, n1=40, n2=N2)
    rv1, ri1 = tdfscan.df2_rows_twin(*ops1, n1=40, n2=N2)
    assert torch.equal(ri1, ri0)
    assert ttesting.kernel_agreement(rv1, rv0)[0]
    assert torch.equal(tdfscan.df2_top1_from_rows(rv1, ri1, N2)[0],
                       tdfscan.df2_top1_from_rows(rv0, ri0, N2)[0])


def test_df2_hoist_layout_is_the_sources():
    """Kernel 9 writes kernel 6's pack sizes; its block width divides
    every row padding the route makes (the 256-row tile) as kernel 6's
    narrow block does; the wrapper raises on a width it does not take."""
    with open(os.path.join(os.path.dirname(CU), "df2hoist.cu")) as f:
        text = f.read()
    const = lambda t, n: int(re.search(r"\b%s = (\d+)" % n, t).group(1))
    assert (const(text, "kPack"), const(text, "kVox")) == (
        _const("kPack"), _const("kVox"))
    with open(os.path.join(os.path.dirname(CU), "hoist.cuh")) as f:
        assert const(f.read(), "kAtoms") == tdfscan.HOIST_ATOMS
    assert 256 % tdfscan.HOIST_ATOMS == 0 and 256 % tdfscan.DF2_NARROW == 0
    assert [tdfscan.df2_cols(n) for n in (1, 2, 64, 65, 782)] == [
        1, 64, 64, 128, 832]
    z = lambda *s: torch.zeros(s)
    tdfscan.df2_hoist_shapes(z(2, 8, 1024), z(2, 8, 782), 832)
    for bad in ((z(2, 8, 1000), z(2, 8, 782), 832),
                (z(2, 8, 1024), z(2, 8, 782), 768)):
        with pytest.raises(ValueError, match="unsupported df2 hoist"):
            tdfscan.df2_hoist_shapes(*bad)


@pytest.mark.parametrize("N2", [28, 1])
def test_route_on_kernel9_order_operands_matches_jax(wl_blocks, monkeypatch,
                                                     N2):
    """The route on operands summed as kernel 9 sums them against the
    JAX ``df2_candidates(M=1)`` on ``test_route_matches_jax``'s inputs
    (its programs are compiled once in this module): equal candidates,
    residuals within 1e-6."""
    D, y, csf = wl_blocks
    A1, A2 = D[:, 0], D[:, 1, :, :N2]
    if N2 == 1:
        A2 = np.broadcast_to(csf[None, :, None], (8, csf.size, 1))
    A1, A2 = (np.ascontiguousarray(x, np.float32) for x in (A1, A2))
    cj, vj, _qj = jdfscan.df2_candidates(jnp.asarray(A1), jnp.asarray(A2),
                                         jnp.asarray(y), M=1)
    monkeypatch.setattr(tdfscan, "fdot", ttesting.fdot_sample_order)
    ops, _yn = tdfscan.df2_scan_operands(_t(A1), _t(A2), _t(y))
    monkeypatch.undo()
    rv, ri = tdfscan.df2_rows_twin(*ops, n1=A1.shape[2], n2=N2)
    ct, vt = tdfscan.df2_top1_from_rows(rv, ri, N2)
    assert np.array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
def test_cuda_df2_hoist_matches_plain_version(rng):
    """On the card, both shapes: every operand of kernel 9 by
    ``testing.kernel_agreement`` (levels exactly, NaN bits included)
    against its plain version, kernel 6 fed either set picks the same
    i2 on every row; df2_candidates(M=1) launches kernel 9 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for N2 in (300, 1):
        A1, A2, y = (_t(x).cuda() for x in
                     _problem(rng, "zero_atom", N2, B=4, S=64, N1=200))
        ops_k, _yn = tdfscan.df2_scan_operands(A1, A2, y)
        ops_p, _yn = tdfscan.df2_scan_operands_plain(A1, A2, y)
        for a, b in zip(ops_k, ops_p):
            assert ttesting.kernel_agreement(a, b, a.dtype == torch.int8)[0]
        nan = torch.isnan(ops_p[8])
        assert torch.equal(ops_k[8][nan].view(torch.int32),
                           ops_p[8][nan].view(torch.int32))
        rk, ik = tdfscan.df2_rows(*ops_k, n1=200, n2=N2)
        rp, ip = tdfscan.df2_rows(*ops_p, n1=200, n2=N2)
        assert ttesting.kernel_agreement(rk, rp)[0] and torch.equal(ik, ip)
        kernels.reset_counts()
        tdfscan.df2_candidates(A1, A2, y, M=1)
        assert kernels.LAUNCHES["df2hoist"] == 1
