// Double-float arithmetic in Dekker's forms, for kernels 6 (df2scan.cu) and
// 7 (finalize.cu).
//
// Device mirror of the helpers that ops/df32.py and ops/dfscan.py compose:
// split, two_prod, df_mul, _df_div, _val, _scale. Every operation is the
// explicitly rounded intrinsic of df32.cuh, in the plain version's order, so
// a kernel built from these equals its plain version bit for bit, signed
// zeros and products below 2^-101 included (where the fused form of
// df32.cuh's mul_df_fma can part from Dekker's). Kernels 6 and 7 multiply a
// few dozen times a point against hundreds of Gram multiply-adds, so the
// 17 operations of a Dekker product against the fused form's 3 cost them
// little.
#pragma once

#include "df32.cuh"

namespace mf {

// df32.split: a == hi + lo with 12-bit halves
__device__ __forceinline__ P2 dekker_split(float a) {
  const float c = mul(4097.0f, a);
  const float hi = sub(c, sub(c, a));
  return {hi, sub(a, hi)};
}

// df32.two_prod: p + e == a * b exactly
__device__ __forceinline__ P2 dekker_prod(float a, float b) {
  const P2 as = dekker_split(a), bs = dekker_split(b);
  const float p = mul(a, b);
  const float e = add(add(add(sub(mul(as.p, bs.p), p), mul(as.p, bs.e)),
                          mul(as.e, bs.p)),
                      mul(as.e, bs.e));
  return {p, e};
}

// df32.df_mul: (hi, lo) * (hi, lo) -> (hi, lo), the lo * lo term dropped
__device__ __forceinline__ P2 df_mul(P2 x, P2 y) {
  const P2 t = dekker_prod(x.p, y.p);
  return fast_two_sum(t.p, add(t.e, add(mul(x.p, y.e), mul(x.e, y.p))));
}

// dfscan._df_div: double-float quotient, one Newton correction
__device__ __forceinline__ P2 df_div(P2 x, P2 y) {
  const float q0 = dv(x.p, y.p);
  const P2 t = dekker_prod(q0, y.p);
  const float r = sub(add(sub(sub(x.p, t.p), t.e), x.e), mul(q0, y.e));
  return fast_two_sum(q0, dv(r, y.p));
}

// dfscan._val: the float32 value of a double-float
__device__ __forceinline__ float val(P2 x) { return add(x.p, x.e); }

// dfscan._scale: times k, a power of two (exact)
__device__ __forceinline__ P2 scale(P2 x, float k) {
  return {mul(x.p, k), mul(x.e, k)};
}

// dfscan._df_lt: a < b, lexicographic on (hi, lo)
__device__ __forceinline__ bool df_lt(P2 a, P2 b) {
  return a.p < b.p || (a.p == b.p && a.e < b.e);
}

// ops/nnls._total_order_key: IEEE total order as a signed integer
// (-NaN < -inf < ... < -0 < +0 < ... < inf < +NaN)
__device__ __forceinline__ int total_key(float v) {
  const int k = __float_as_int(v);
  return k < 0 ? k ^ 0x7fffffff : k;
}

}  // namespace mf
