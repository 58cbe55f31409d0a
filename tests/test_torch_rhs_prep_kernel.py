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
    B, S = 3, 40
    y, a3, a4 = _columns(rng, B, S, n4)
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
    assert np.all(np.abs(nt - nj) <= np.spacing(nj))
    np.testing.assert_allclose(xt, xj, rtol=0, atol=3 * EPS32)
    assert not xt[1, :, 1].any() and not xj[1, :, 1].any()
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
