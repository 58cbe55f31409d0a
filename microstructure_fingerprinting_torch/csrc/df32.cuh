// Error-free float32 transforms for the kernels of this package.
//
// Device mirror of ops/df32.py. Every operation is an explicitly rounded
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), which nvcc never
// contracts into a fused multiply-add; the library is also built with
// --fmad=false. A contracted a*b + c would make the two_sum error terms
// wrong, and the double-float residuals with them. Products of double-float
// values take their error term by an explicit fused multiply-add (below);
// the Dekker forms on split halves live on in ops/df32.py, where the plain
// versions use them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mf {

constexpr float kEps = 1.1920929e-07f;
constexpr float kInf = __builtin_huge_valf();

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }

// NaN-propagating minimum (jnp.minimum / torch.minimum semantics)
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_to_inf(float x) { return x != x ? kInf : x; }

// (main, error) partial pair
struct P2 {
  float p, e;
};

__device__ __forceinline__ P2 two_sum(float a, float b) {
  float s = add(a, b);
  float bb = sub(s, a);
  float e = add(sub(a, sub(s, bb)), sub(b, bb));
  return {s, e};
}

__device__ __forceinline__ P2 fast_two_sum(float a, float b) {
  float s = add(a, b);
  return {s, sub(b, sub(s, a))};
}

__device__ __forceinline__ P2 neg(P2 x) { return {-x.p, -x.e}; }

// double-float sum (Dekker add): ops/df32.df_add
__device__ __forceinline__ P2 df_add(P2 x, P2 y) {
  const P2 t = two_sum(x.p, y.p);
  return fast_two_sum(t.p, add(t.e, add(x.e, y.e)));
}

// compensated sum of (main, err) partials -> f32 value
template <int N>
__device__ __forceinline__ float acc(const P2 (&parts)[N]) {
  float hi = parts[0].p, lo = parts[0].e;
  #pragma unroll
  for (int k = 1; k < N; ++k) {
    P2 t = two_sum(hi, parts[k].p);
    hi = t.p;
    lo = add(lo, add(t.e, parts[k].e));
  }
  return add(hi, lo);
}

// exact (hi, lo) sum of a few f32 values via a two_sum cascade
template <int N>
__device__ __forceinline__ P2 df_from_sum(const float (&v)[N]) {
  float hi = v[0], lo = 0.0f;
  #pragma unroll
  for (int k = 1; k < N; ++k) {
    P2 t = two_sum(hi, v[k]);
    hi = t.p;
    lo = add(lo, t.e);
  }
  return {hi, lo};
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }

// the reference's 2-variable NNLS case selection (dfscan._two_var_cases),
// kernels 3 and 10
__device__ __forceinline__ float two_var_cases(float res_full, float w1D,
                                               float w2D, float Y1, float Y2,
                                               float res1, float res2,
                                               float y_sq) {
  const bool case1 = (w1D > 0.0f) && (w2D > 0.0f);
  const bool case2 = !case1 && (w1D >= 0.0f) && (w2D <= 0.0f);
  const bool case3 = !case1 && !case2 && (w1D <= 0.0f) && (w2D >= 0.0f);
  const bool case4 = !case1 && !case2 && !case3 && (w1D < 0.0f) && (w2D < 0.0f);
  const bool take1 = (case2 && Y1 >= 0.0f) || (case4 && Y1 > 0.0f);
  const bool take2 = (case3 && Y2 >= 0.0f) ||
                     (case4 && Y1 <= 0.0f && Y2 > 0.0f);
  return case1 ? nan_to_inf(res_full)
               : (take1 ? res1 : (take2 ? res2 : y_sq));
}

// ---- products (kernels 3 and 5) ----
// The H100's float32 pipe has a fused multiply-add, which the TPU's vector
// unit did not offer to the kernel: fma(a, b, -fl(a * b)) is the exact error
// of the rounded product in one operation, where the Dekker forms of
// ops/df32.py spend 13 (mul_ps, on presplit halves) or 17 (two_prod). By
// Dekker's theorem both give the same float whenever the error term a * b - fl(a * b)
// is representable, i.e. a multiple of 2^-149: for |a * b| >= 2^-101
// (~4e-31) always; the forms can part only on products below that
// (tests/test_torch_df32_fma.py finds the line). __fmaf_rn is explicit, so
// --fmad=false (which only stops contraction) leaves it alone. These need
// no split halves: a double-float value is its (hi, lo) pair, held in a P2.

// exact product of two floats: p + e == a * b
__device__ __forceinline__ P2 two_prod_fma(float a, float b) {
  const float p = mul(a, b);
  return {p, __fmaf_rn(a, b, -p)};
}

// product of two double-float values (hi, lo) -> (main, err): ops/df32.mul_ps
// with the fused error term; the cross terms in mul_ps's order
__device__ __forceinline__ P2 mul_df_fma(P2 x, P2 y) {
  const P2 t = two_prod_fma(x.p, y.p);
  return {t.p, add(t.e, add(mul(x.p, y.e), mul(x.e, y.p)))};
}

}  // namespace mf
