"""Error-free float32 transforms (double-float building blocks).

PyTorch counterpart of ``microstructure_fingerprinting_tpu/ops/df32.py``.
Every helper is a chain of separate elementwise float32 tensor ops, so
nothing is contracted into a fused multiply-add and the results are
bitwise those of the JAX functions on float32 inputs. The CUDA kernels
mirror them with ``__fadd_rn``/``__fmul_rn`` (``csrc/df32.cuh``).

  * two_sum(a, b)        -> (s, e) with s + e == a + b exactly
  * split(a)             -> (ah, al), a == ah + al, 12/12-bit halves
  * two_prod_presplit    -> (p, e) with p + e == a * b exactly
  * df values are (hi, lo) pairs with |lo| <= ulp(hi)
"""

import torch

# 2^12 + 1 (Dekker split for f32)
_SPLITTER = 4097.0


def two_sum(a, b):
    """Knuth two-sum: exact (s, e) with s = fl(a+b), s + e = a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker two-sum, valid when |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a == ah + al with 12-bit-mantissa halves."""
    c = _SPLITTER * a
    ah = c - (c - a)
    al = a - ah
    return ah, al


def two_prod(a, b):
    """Exact product: (p, e) with p = fl(a*b), p + e = a * b."""
    ah, al = split(a)
    bh, bl = split(b)
    return two_prod_presplit(a, ah, al, b, bh, bl)


def two_prod_presplit(a, ah, al, b, bh, bl):
    """two_prod with both operands pre-split."""
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_from_sum(*vals):
    """Exact (hi, lo) sum of a few f32 values via a two_sum cascade."""
    hi = vals[0]
    lo = torch.zeros_like(hi)
    for v in vals[1:]:
        hi, e = two_sum(hi, v)
        lo = lo + e
    return hi, lo


def df_add(x, y):
    """(hi, lo) + (hi, lo) -> (hi, lo) (Dekker add, ~1 ulp^2 error)."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return fast_two_sum(s, e)


def df_neg(x):
    return (-x[0], -x[1])


def df_mul(x, y):
    """(hi, lo) * (hi, lo) -> (hi, lo), dropping the lo*lo term."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(p, e)


def presplit(x):
    """df (hi, lo) -> (hi, lo, hi_h, hi_l) with the hi half Dekker-split."""
    hh, hl = split(x[0])
    return (x[0], x[1], hh, hl)


def mul_ps(x, y):
    """Product of two presplit df values -> (main, err) partial pair."""
    p = x[0] * y[0]
    e = ((x[2] * y[2] - p) + x[2] * y[3] + x[3] * y[2]) + x[3] * y[3]
    e = e + (x[0] * y[1] + x[1] * y[0])
    return p, e


def compensated_dot_pairs(pairs):
    """Compensated sum of exact products: (hi, lo) ~= sum x_i * y_i."""
    hi = None
    lo = None
    for x, y in pairs:
        p, e = two_prod(x, y)
        if hi is None:
            hi, lo = p, e
        else:
            hi, s = two_sum(hi, p)
            lo = lo + (s + e)
    return hi, lo
