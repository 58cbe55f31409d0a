"""Fused error-free products against Dekker's, on the CPU.

``csrc/df32.cuh`` gives kernel 5 ``two_prod_fma`` and ``mul_df_fma``: the
error of a rounded float32 product by one fused multiply-add,
``fma(a, b, -fl(a * b))``, where the plain version (``ops/df32.py``) uses
Dekker's products on split halves. For float32 ``a, b`` the float64 product
is exact, so ``float32(float64(a) * float64(b) - float64(p))`` is what the
fused multiply-add returns. Here the plain version's ``two_prod`` and
``mul_ps`` (through ``presplit``) are held bitwise against that form in
the magnitude ranges the re-scan sees, and the range below which the two
part (the error term falls under the smallest subnormal, 2^-149) is
found, so that the source note can state it."""

import numpy as np
import pytest
import torch

from microstructure_fingerprinting_torch.ops import df32

torch.set_num_threads(2)
N = 100000


def _draw(rng, lo, hi, n=N):
    """Signed float32 values with exponents uniform in [lo, hi)."""
    m = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
    return np.float32(m * 2.0 ** rng.uniform(lo, hi, n))


def _fma_err(a, b):
    """(p, e) as ``two_prod_fma``: p = fl(a b), e = fma(a, b, -p)."""
    p = a * b
    assert p.dtype == np.float32
    e = (a.astype(np.float64) * b.astype(np.float64)
         - p.astype(np.float64)).astype(np.float32)
    return p, e


def _mul_df_fma(x, y):
    """``mul_df_fma`` of (hi, lo) pairs in numpy float32."""
    p, e = _fma_err(x[0], y[0])
    return p, e + (x[0] * y[1] + x[1] * y[0])


def _bits(x):
    return np.asarray(x).view(np.int32)


def _t(x):
    return torch.from_numpy(x)


def _df(rng, lo, hi):
    """A double-float value: hi in the range, |lo| <= ulp(hi) / 2."""
    hi_ = _draw(rng, lo, hi)
    lo_ = np.float32(hi_ * rng.uniform(-0.5, 0.5, hi_.shape) * 2.0 ** -23)
    return hi_, lo_


# exponent ranges of the two factors: Gram entries and hoisted factors
# (|x| in [2^-40, 2]), factors times small residuals (products down to
# 1e-28 ~ 2^-93), and exact zeros
RANGES = [("unit", (-3, 1), (-3, 1)), ("wide", (-40, 1), (-40, 1)),
          ("residual", (-40, 1), (-53, -40)), ("1e-28", (-50, -43),
                                               (-50, -43))]


@pytest.mark.parametrize("name,ra,rb", RANGES, ids=[r[0] for r in RANGES])
def test_two_prod_equals_fused_form(rng, name, ra, rb):
    a, b = _draw(rng, *ra), _draw(rng, *rb)
    a[:8] = [0.0, -0.0, 1.0, -1.0, 0.0, 3.0, -0.0, 0.5]
    p, e = _fma_err(a, b)
    pt, et = df32.two_prod(_t(a), _t(b))
    assert np.array_equal(_bits(pt.numpy()), _bits(p))
    assert np.array_equal(_bits(et.numpy()), _bits(e))
    # the pair is the exact product
    assert np.array_equal(p.astype(np.float64) + e.astype(np.float64),
                          a.astype(np.float64) * b.astype(np.float64))


@pytest.mark.parametrize("name,ra,rb", RANGES, ids=[r[0] for r in RANGES])
def test_mul_ps_equals_fused_form(rng, name, ra, rb):
    x, y = _df(rng, *ra), _df(rng, *rb)
    p, e = _mul_df_fma(x, y)
    xs = df32.presplit((_t(x[0]), _t(x[1])))
    ys = df32.presplit((_t(y[0]), _t(y[1])))
    pt, et = df32.mul_ps(xs, ys)
    assert np.array_equal(_bits(pt.numpy()), _bits(p))
    assert np.array_equal(_bits(et.numpy()), _bits(e))


def test_forms_part_only_in_the_underflow_range(rng):
    """The error term a b - fl(a b) is a multiple of ulp(a) ulp(b) >=
    2^-46 |a b| / 4: representable, and the two forms equal, for every
    |a b| >= 2^-101. Below, Dekker's partial products round (or the split
    halves underflow) and the forms part: on this draw somewhere in
    [2^-120, 2^-101), never above."""
    a, b = _draw(rng, -75, -45, 4 * N), _draw(rng, -75, -45, 4 * N)
    _p, e = _fma_err(a, b)
    _pt, et = df32.two_prod(_t(a), _t(b))
    differ = _bits(et.numpy()) != _bits(e)
    mag = np.abs(a.astype(np.float64) * b.astype(np.float64))
    assert not differ[mag >= 2.0 ** -101].any()
    assert (mag >= 2.0 ** -101).sum() > 1000
    assert differ.any()
    top = mag[differ].max()
    assert 2.0 ** -120 <= top < 2.0 ** -101, np.log2(top)
    # far above what the re-scan multiplies: products of residuals, 1e-28
    assert top < 1e-30
