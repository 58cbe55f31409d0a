"""Kernel 13, the row passes' rhs columns normalized and packed
(``csrc/rhsprep.cu``), as far as the CPU sees it.

On a card ``prep.rhs_prep`` normalizes the signal and the CSF and EAR
columns of every voxel and writes kernel 1's rhs packs and the
normalized columns that kernels 11 and 12 read, in one launch; on the
CPU it runs the plain version ``rhs_prep_twin`` (``nnls._normalize_y``,
``_normalize_block`` and ``pack_rhs``, the code the row passes ran
before the kernel). The plain version is held against the JAX package's
normalization and ``pack_rhs`` at 2 and 12 columns, a zero column among
them. The ``cuda`` test holds the kernel against its plain version on a
card.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from microstructure_fingerprinting_tpu.ops import nnls as jnnls
from microstructure_fingerprinting_tpu.ops import pallas_prep as jprep

import microstructure_fingerprinting_torch as mft
from microstructure_fingerprinting_torch import testing as ttesting
from microstructure_fingerprinting_torch.ops import kernels
from microstructure_fingerprinting_torch.ops import nnls as tnnls
from microstructure_fingerprinting_torch.ops import prep as tprep

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(mft.__file__), "csrc")
OUTS = ("rhs_q", "rhs_r", "rhs_a", "yh", "A3h", "A4h")
EPS32 = float(np.finfo(np.float32).eps)


def _columns(rng, B, S, n4, zero=True):
    """Raw float32 rhs columns: a signal of scale ~400, one CSF column,
    n4 EAR columns; the CSF column of voxel 1 zero where ``zero``."""
    y = np.float32(400 * np.abs(rng.randn(B, S)))
    a3 = np.float32(np.abs(rng.randn(B, S, 1)) + 0.05)
    a4 = np.float32(np.abs(rng.randn(B, S, n4)) * 0.3) if n4 else None
    if zero:
        a3[1] = 0.0
    return y, a3, a4


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _same_bits(a, b):
    if a is None or b is None:
        return a is None and b is None
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype in bits:
        return a.dtype == b.dtype and torch.equal(a.view(bits[a.dtype]),
                                                  b.view(bits[b.dtype]))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n4", [0, 10])
def test_twin_matches_jax(rng, n4):
    """``rhs_prep_twin`` against the JAX package's ``_normalize_y``,
    ``_normalize_block`` and ``pack_rhs`` on the same float32 columns (2
    columns: the signal and the CSF column; 12: with 10 EAR columns),
    with a zero column (norm 0: it stays zero). The JAX package sums the
    squares in float32, the port in float64 rounded once, so a norm may
    sit an ulp away and move each value of its column by ~1-2 ulp.
    Tolerance: the norms within 1 ulp of each other; the normalized
    columns within 3 float32 ulp of 1 (they are at most 1 in magnitude),
    and bit for bit where the two norms are equal (the same IEEE
    quotient), the zero column zero in both; the levels and planes,
    which quantize those values, equal wherever the values are, and the
    lanes past the columns zero in both."""
    _twin_matches_jax(*_columns(rng, 3, 40, n4))


def _twin_matches_jax(y, a3, a4, norm_ulps=1):
    """``rhs_prep_twin`` against the JAX package on the same float32
    columns (B, S), (B, S, 1), (B, S, n4) or None: see
    ``test_twin_matches_jax`` for the tolerances, the norms within
    ``norm_ulps`` float32 ulp and the normalized columns within
    ``norm_ulps + 2``."""
    B, S = y.shape
    n4 = 0 if a4 is None else a4.shape[2]
    raw = np.concatenate([y[:, :, None], a3] + ([a4] if n4 else []), 2)
    yj = jnnls._normalize_y(jnp.asarray(y))[0]
    a3j = jnnls._normalize_block(jnp.asarray(a3))[0]
    cols_j = [yj, a3j[:, :, 0]]
    if n4:
        a4j = jnnls._normalize_block(jnp.asarray(a4))[0]
        cols_j += [a4j[:, :, i] for i in range(n4)]
    oj = jprep.pack_rhs([c.astype(jnp.float32) for c in cols_j])
    ot = tprep.rhs_prep_twin(_t(y), _t(a3), _t(a4))
    n = 2 + n4
    xj = np.stack([np.asarray(c, np.float32) for c in cols_j], axis=2)
    xt = torch.cat([ot[3][:, :, None], ot[4]]
                   + ([ot[5]] if n4 else []), dim=2).numpy()
    assert xj.shape == xt.shape == (B, S, n)
    nj = np.asarray(jnp.sqrt(jnp.sum(jnp.asarray(raw) ** 2, axis=1)))
    nt = tnnls.sqrt_f32(tnnls.sumsq_f32(_t(raw), 1)).numpy()
    assert nj.dtype == nt.dtype == np.float32
    assert np.all(np.abs(nt - nj) <= norm_ulps * np.spacing(nj))
    np.testing.assert_allclose(xt, xj, rtol=0,
                               atol=(norm_ulps + 2) * EPS32)
    zero = ~raw.any(axis=1)
    assert zero[1, 1] == (not a3[1].any())
    assert not xt[np.broadcast_to(zero[:, None, :], xt.shape)].any()
    assert not xj[np.broadcast_to(zero[:, None, :], xj.shape)].any()
    same = np.broadcast_to((nj == nt)[:, None, :], xj.shape)
    assert same.any()
    assert np.array_equal(xj[same], xt[same])
    qj = np.asarray(oj[0]).reshape(B, S, 3, 128)
    qt = ot[0].numpy().reshape(B, S, 3, 128)
    for lvl in range(3):
        assert np.array_equal(qj[..., lvl, :n][same], qt[..., lvl, :n][same])
    for k in (1, 2):
        pj = np.asarray(oj[k].astype(jnp.float32))
        pt = ot[k].float().numpy()
        assert np.array_equal(pj[..., :n][same], pt[..., :n][same])
        assert not pj[..., n:].any() and not pt[..., n:].any()
    assert not qj[..., n:].any() and not qt[..., n:].any()


def _tile():
    """Kernel 13's sample tile (csrc/rhsprep.cu kST)."""
    with open(os.path.join(CSRC, "rhsprep.cu")) as f:
        return int(re.search(r"\bkST = (\d+)\b", f.read()).group(1))


def _edge_columns(rng, S, n_cols, shared):
    """Raw columns at S samples, 2 or 15 columns, the CSF column of voxel
    1 zero; with ``shared`` the fixed columns are one voxel's, broadcast
    (batch stride 0, as the fit passes them)."""
    y, a3, a4 = _columns(rng, 3, S, n_cols - 2, zero=not shared)
    if shared:
        a3 = np.broadcast_to(a3[:1], a3.shape)
        a4 = None if a4 is None else np.broadcast_to(a4[:1], a4.shape)
    return y, a3, a4


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("n_cols", [2, 15])
@pytest.mark.parametrize("where", ["1", "tile-1", "tile+1", "552"])
def test_twin_matches_jax_at_tile_edges(rng, where, n_cols, shared):
    """The plain version against the JAX package (``_twin_matches_jax``)
    at sample counts that do not fill kernel 13's sample tile (1, tile -
    1, tile + 1, and the protocol's 552), 2 and 15 columns, the fixed
    columns per voxel or shared by every voxel. The JAX package sums the
    S squares in float32 by a tree of ceil(log2 S) levels, so its norm
    may sit up to about ceil(log2 S) / 2 ulp from the correctly rounded
    one (the square root halves the sum's relative error), one more for
    the roundings: the norms within ceil(ceil(log2 S) / 2) + 1 ulp; bit
    for bit where equal, as in ``test_twin_matches_jax``."""
    S = {"1": 1, "tile-1": _tile() - 1, "tile+1": _tile() + 1,
         "552": 552}[where]
    ulps = max(1, -(-int(np.ceil(np.log2(S))) // 2) + 1)
    _twin_matches_jax(*_edge_columns(rng, S, n_cols, shared),
                      norm_ulps=ulps)


@pytest.mark.parametrize("n4", [0, 10])
def test_cpu_dispatch_runs_the_twin(rng, n4):
    """On CPU tensors ``rhs_prep`` is ``rhs_prep_twin`` bit for bit and
    launches nothing; the twin is the row passes' former sequence
    (normalize, then ``pack_rhs`` of the signal, the CSF and the EAR
    columns); its packs are (B, S, 384) int8 and (B, S, 128) bf16."""
    B, S = 2, 24
    y, a3, a4 = (_t(x) for x in _columns(rng, B, S, n4))
    kernels.reset_counts()
    got = tprep.rhs_prep(y, a3, a4)
    want = tprep.rhs_prep_twin(y, a3, a4)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCHES["rhsprep"] == 0
    yh = tnnls._normalize_y(y)[0]
    A3h = tnnls._normalize_block(a3)[0]
    cols = [yh, A3h[:, :, 0]]
    if n4:
        A4h = tnnls._normalize_block(a4)[0]
        cols += [A4h[:, :, i] for i in range(n4)]
        assert _same_bits(got[5], A4h)
    else:
        assert got[5] is None
    packs = tprep.pack_rhs(cols)[:3]
    assert all(_same_bits(a, b) for a, b in zip(got[:3], packs))
    assert _same_bits(got[3], yh) and _same_bits(got[4], A3h)
    assert (got[0].shape, got[1].shape, got[2].shape) == (
        (B, S, 384), (B, S, 128), (B, S, 128))
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.bfloat16


def test_wrapper_rejects_and_takes_shared_columns(rng):
    """Kernel 13 takes the signal and 1 .. 14 fixed columns (kernel 1's
    Grams hold 15 rhs columns); the wrapper raises on more, and on CPU
    tensors, before any launch. A column shared by every voxel (stride
    0, as the fit passes the CSF and EAR blocks) reaches the kernel
    without a copy; a voxel block that is not contiguous is copied."""
    y, a3, a4 = (_t(x) for x in _columns(rng, 2, 16, 14))
    with pytest.raises(ValueError, match="fixed columns"):
        tprep._rhs_prep_cuda(y, a3, a4)
    with pytest.raises(TypeError, match="CUDA"):
        tprep._rhs_prep_cuda(y, a3, a4[:, :, :13])
    shared = a3[:1].expand(2, -1, -1)
    assert tprep._voxel_contiguous(shared) is shared
    ear = a4[0][None].expand(2, -1, -1)
    assert tprep._voxel_contiguous(ear) is ear
    t = a4.transpose(1, 2).contiguous().transpose(1, 2)
    c = tprep._voxel_contiguous(t)
    assert c is not t and c.is_contiguous() and torch.equal(c, t)
    # the kernel's own limit is the wrapper's
    with open(os.path.join(CSRC, "rhsprep.cu")) as f:
        text = f.read()
    assert int(re.search(r"kMaxCols = (\d+);", text).group(1)) == \
        tprep.MAX_RHS
    assert int(re.search(r"kLane = (\d+);", text).group(1)) == tprep._LANE


def test_pack_vectors_are_the_sources():
    """Kernel 13 writes the packs in 16-byte vectors: a sample's row of
    levels (3 x 128 int8) and of each plane (128 bf16) holds whole
    vectors, the live lanes 0 .. MAX_RHS - 1 fill the first vector of a
    level and the first two of a plane (its kQVec, kPVec), it takes every
    column a call takes (kMaxCols), and its norms launch writes
    RHS_NORM_PAD divisors a voxel (kNormPad), room for all of them."""
    with open(os.path.join(CSRC, "rhsprep.cu")) as f:
        text = f.read()
    assert "kQVec = 3 * kLane / 16, kPVec = kLane * 2 / 16;" in text
    pad = int(re.search(r"kNormPad = (\d+);", text).group(1))
    assert pad == tprep.RHS_NORM_PAD >= tprep.MAX_RHS
    assert tprep.MAX_RHS <= 16 <= tprep._LANE
    assert (3 * tprep._LANE) % 16 == 0 and (2 * tprep._LANE) % 16 == 0
    assert int(re.search(r"kMaxCols = (\d+);", text).group(1)) == \
        tprep.MAX_RHS
    assert 1 <= _tile() <= 552


@pytest.mark.cuda
def test_cuda_rhs_prep_at_tile_edges(rng):
    """On the card, at S = 1, tile - 1, tile + 1 and 552, 2 and 15
    columns, the fixed columns per voxel or shared: every output of
    kernel 13 equals its plain version (``testing.kernel_agreement``, the
    int8 levels exactly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for S in (1, _tile() - 1, _tile() + 1, 552):
        for n_cols in (2, 15):
            for shared in (False, True):
                y, a3, a4 = (None if x is None else torch.as_tensor(
                    np.ascontiguousarray(x[:1]) if shared and x.ndim == 3
                    else x).cuda() for x in _edge_columns(rng, S, n_cols,
                                                          shared))
                if shared:
                    a3 = a3.expand(3, -1, -1)
                    a4 = None if a4 is None else a4.expand(3, -1, -1)
                k = tprep.rhs_prep(y, a3, a4)
                p = tprep.rhs_prep_twin(y, a3, a4)
                for name, a, b in zip(OUTS, k, p):
                    if b is None:
                        assert a is None, name
                        continue
                    assert ttesting.kernel_agreement(
                        a, b, exact=a.dtype == torch.int8)[0], (S, name)


@pytest.mark.cuda
def test_cuda_rhs_prep_matches_plain_version(rng):
    """On the card, at 2 and 12 columns with a zero column and the fixed
    columns shared by every voxel (stride 0): every output by
    ``testing.kernel_agreement``, the int8 levels exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n4 in (0, 10):
        y, a3, a4 = (None if x is None else x.cuda() for x in
                     (_t(v) for v in _columns(rng, 4, 96, n4)))
        for fixed in ((a3, a4), (a3[1:2].expand(4, -1, -1),
                                 None if a4 is None
                                 else a4[:1].expand(4, -1, -1))):
            kernels.reset_counts()
            k = tprep.rhs_prep(y, *fixed)
            assert kernels.LAUNCHES["rhsprep"] == 1
            p = tprep.rhs_prep_twin(y, *fixed)
            for name, a, b in zip(OUTS, k, p):
                if b is None:
                    assert a is None, name
                    continue
                ok = ttesting.kernel_agreement(
                    a, b, exact=a.dtype == torch.int8)[0]
                assert ok, name
