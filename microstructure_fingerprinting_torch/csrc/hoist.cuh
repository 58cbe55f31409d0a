// The shared skeleton of kernel 9 (df2hoist.cu), and the Gram sums, put_ps
// and tmin of kernel 8 (df4hoist.cu, a design of its own): the operand
// preparation of the double-float scans, one pass over the samples.
//
// Both prologues (ops/rescan.df4_hoist_twin, ops/dfscan.df2_hoist_twin)
// quantise every normalised atom of the two blocks into int8 levels and
// float32 planes (dfscan.quantize2), sum each atom's double-float Grams with
// itself and with the voxel's few small columns (the signal y and, for
// kernel 8, the CSF and EAR columns: dfscan.df_gram), and run a short
// double-float chain per atom. A block owns kAtoms atoms of one voxel, a
// thread one atom. Each tile of kTile samples of the small columns is
// quantised once into shared memory; then every thread streams its atom's
// samples from device memory (coalesced across the warp: the atom axis is
// the contiguous one), quantises each in registers, writes its levels and
// planes once and adds its products to the Grams. The int8 level products go
// into exact int32 sums (t11, t12, t22); the two float32 cross products are
// float64 sums of exact products (a fused multiply-add adds an exact product
// with one rounding, as an add of the product would), rounded once to
// float32 at the end: the plain version's values, summed in sample order
// where its einsum takes another order (testing.kernel_agreement). The
// voxel's own Grams (among the small columns) are summed the same way, one
// Gram a thread, so that every block of a voxel holds the same bits.
//
// Everything after the sums mirrors the plain version operation for
// operation in Dekker's forms (df_dekker.cuh), NaN and zero signs included.
//
// Kernel 10 (df3hoist.cu) takes the same skeleton; the plain float32 hoists
// of the interval row passes, kernels 11 (row4hoist.cu) and 12
// (row3hoist.cu), and the rhs columns' pack, kernel 13 (rhsprep.cu), share
// the second half of this file (kernel 11 its quantize3 and Gram sums, in
// a voxel launch of its own).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "df_dekker.cuh"

namespace mf {
namespace hoist {

// atoms (threads) a block; the row blocks need N1p to be a multiple of it
constexpr int kAtoms = 128;
// samples of the small columns staged at a time
constexpr int kTile = 32;
// dfscan._S1, _S2: the level scales 2^-7 and 2^-15
constexpr float kS1 = 0.0078125f, kS2 = 3.0517578125e-05f;

// quantize2 of one value: x = s1 q1 + s2 q2 + r, a = s1 q1 + s2 q2
struct Level {
  int q1, q2;
  float r, a;
};

// dfscan._round_levels: torch.clamp(torch.round(x / scale), -127, 127)
// (rintf rounds half to even, as torch.round)
__device__ __forceinline__ int round_level(float x, float scale) {
  return __float2int_rz(fminf(fmaxf(rintf(dv(x, scale)), -127.0f), 127.0f));
}

// dfscan.quantize2, operation for operation
__device__ __forceinline__ Level quantize2(float x) {
  const int q1 = round_level(x, kS1);
  const float a1 = mul(__int2float_rn(q1), kS1);
  const int q2 = round_level(sub(x, a1), kS2);
  const float a = add(a1, mul(__int2float_rn(q2), kS2));
  return {q1, q2, sub(x, a), a};
}

// the running sums of one Gram g(qa, qb) (dfscan.df_gram): the exact level
// products and the float64 cross products c1 = (a_a + R_a)' R_b, c2 = R_a' a_b
struct Gram {
  int t11, t12, t22;
  double c1, c2;
};

__device__ __forceinline__ Gram gram_zero() { return {0, 0, 0, 0.0, 0.0}; }

// one sample of g(qa, qb): qa's levels, a + R and R; qb's levels, R and a
__device__ __forceinline__ void gram_step(Gram& g, int qa1, int qa2,
                                          double apr, double ra, int2 qb,
                                          double rb, double ab) {
  g.t11 += qa1 * qb.x;
  g.t12 += qa1 * qb.y + qa2 * qb.x;
  g.t22 += qa2 * qb.y;
  g.c1 = __fma_rn(apr, rb, g.c1);
  g.c2 = __fma_rn(ra, ab, g.c2);
}

// df_gram's combine: the level sums scaled (exactly) and the cross sums
// rounded once, added error-free (df32.df_from_sum)
__device__ __forceinline__ P2 gram_value(const Gram& g) {
  const float v[5] = {mul(__int2float_rn(g.t11), 6.103515625e-05f),
                      mul(__int2float_rn(g.t12), 2.384185791015625e-07f),
                      mul(__int2float_rn(g.t22), 9.313225746154785e-10f),
                      __double2float_rn(g.c1), __double2float_rn(g.c2)};
  return df_from_sum(v);
}

// df32.presplit of x into entries e .. e + 3 of a pack: hi, lo and the
// Dekker halves of hi
__device__ __forceinline__ void put_ps(float* pack, size_t stride, int e,
                                       P2 x) {
  const P2 h = dekker_split(x.p);
  pack[(size_t)e * stride] = x.p;
  pack[(size_t)(e + 1) * stride] = x.e;
  pack[(size_t)(e + 2) * stride] = h.p;
  pack[(size_t)(e + 3) * stride] = h.e;
}

// torch.minimum on the card: a NaN operand wins (the first one first), else
// the device min (CUDA's fminf, which torch's kernel calls)
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// ---------------------------------------------------------------------------
// The plain float32 hoists of the interval row passes (kernels 11 and 12,
// csrc/row4hoist.cu and csrc/row3hoist.cu) and the rhs columns' levels
// (kernel 13, csrc/rhsprep.cu): quantize3, the small f32scan._gram3_hi
// Grams among the voxel's rhs columns, and the support intervals of
// f32scan._interval, _sub1 and _sub2.
// ---------------------------------------------------------------------------

// dfscan._S3 = 2^-23
constexpr float kS3 = 1.1920928955078125e-07f;

// x.to(torch.bfloat16).float(): round to nearest even
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dfscan.quantize3 of one value, operation for operation: levels (q1, q2,
// q3), the residual r and the quantised part a (x = a + r exactly)
struct Level3 {
  int q1, q2, q3;
  float r, a;
};

__device__ __forceinline__ Level3 quantize3(float x) {
  const Level l = quantize2(x);
  const int q3 = round_level(l.r, kS3);
  const float a = add(l.a, mul(__int2float_rn(q3), kS3));
  return {l.q1, l.q2, q3, sub(x, a), a};
}

// quantize3 of one value as f32scan._gram3_hi multiplies it: the levels
// (q1, q2, q3) and the bf16 planes (bf(a + R), bf(R), bf(a))
__device__ __forceinline__ void quantize3_planes(float x, int4& q, float4& v) {
  const Level3 l = quantize3(x);
  q = make_int4(l.q1, l.q2, l.q3, 0);
  v = make_float4(bf16r(add(l.a, l.r)), bf16r(l.r), bf16r(l.a), 0.0f);
}

// the running sums of f32scan._gram3_hi(qa, qb): level products grouped by
// scale (exact in int32) and the two float64 correction sums
struct Gram3 {
  int t11, t12, t22, t23, t33;
  double c1, c2;
};

__device__ __forceinline__ void gram3_step(Gram3& g, int4 qa, float4 va,
                                           int4 qb, float4 vb) {
  g.t11 += qa.x * qb.x;
  g.t12 += qa.x * qb.y + qa.y * qb.x;
  g.t22 += qa.y * qb.y + qa.x * qb.z + qa.z * qb.x;
  g.t23 += qa.y * qb.z + qa.z * qb.y;
  g.t33 += qa.z * qb.z;
  g.c1 = __fma_rn((double)va.x, (double)vb.y, g.c1);
  g.c2 = __fma_rn((double)va.y, (double)vb.z, g.c2);
}

// df32.df_from_sum(v_a, v_b, v_c, c1, c2, v_d, v_e)[0]: the running float32
// sum in that order
__device__ __forceinline__ float gram3_value(const Gram3& g) {
  float h = mul(__int2float_rn(g.t11), 0x1p-14f);
  h = add(h, mul(__int2float_rn(g.t12), 0x1p-22f));
  h = add(h, mul(__int2float_rn(g.t22), 0x1p-30f));
  h = add(h, __double2float_rn(g.c1));
  h = add(h, __double2float_rn(g.c2));
  h = add(h, mul(__int2float_rn(g.t23), 0x1p-38f));
  return add(h, mul(__int2float_rn(g.t33), 0x1p-46f));
}

// a tile of the voxel's small columns, quantize3'd for _gram3_hi
template <int C>
struct Tile3 {
  int4 q[C][kTile];
  float4 v[C][kTile];
};

// The voxel's small Grams, one a thread in sample order so that every block
// of a voxel holds the same bits: ``cols(c, s)`` is sample s of small column
// c < nc (C at most), quantised a tile at a time into shared memory;
// thread t < nv sums the Gram of the columns ``pair(t)`` and returns its
// value (other threads return a value of no use). Every thread of the
// block takes part.
template <int C, class Cols, class Pair>
__device__ __forceinline__ float small_grams(Tile3<C>& tile, const Cols& cols,
                                             int nc, int S, const Pair& pair,
                                             int nv) {
  const int tid = threadIdx.x;
  const int2 pr = pair(tid < nv ? tid : 0);
  Gram3 g = {0, 0, 0, 0, 0, 0.0, 0.0};
  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int kn = min(kTile, S - s0);
    __syncthreads();  // the last tile is consumed
    for (int e = tid; e < nc * kTile; e += kAtoms) {
      const int c = e / kTile, t = e % kTile;
      if (t < kn) quantize3_planes(cols(c, s0 + t), tile.q[c][t], tile.v[c][t]);
    }
    __syncthreads();
    if (tid < nv) {
      #pragma unroll 1
      for (int t = 0; t < kn; ++t) {
        gram3_step(g, tile.q[pr.x][t], tile.v[pr.x][t], tile.q[pr.y][t],
                   tile.v[pr.y][t]);
      }
    }
  }
  return gram3_value(g);
}

// the scalars the plain versions pass as python floats (f32scan._EPS,
// _TOL, KERR)
struct Consts {
  float eps, tol, kerr;
};

struct Interval {
  float lo, up;
};

// f32scan._fold
__device__ __forceinline__ void fold(Interval& acc, Interval s) {
  acc.lo = tmin(acc.lo, s.lo);
  acc.up = tmin(acc.up, s.up);
}

// f32scan._interval
__device__ __forceinline__ Interval interval(bool feas, bool stab, float res,
                                             float ws, bool excl,
                                             const Consts& k) {
  const float err = mul(k.kerr, add(1.0f, ws));
  res = nan_to_inf(res);
  return {feas ? sub(res, err) : (stab ? kInf : (excl ? kInf : -k.kerr)),
          feas ? add(res, err) : kInf};
}

// f32scan._sub1: support {a}
__device__ __forceinline__ Interval sub1(float d, float p, float w,
                                         const Consts& k) {
  const float wa = dv(p, d);
  return interval(wa >= 0.0f, true, sub(w, mul(p, wa)), fabsf(wa), false, k);
}

// f32scan._sub2: support {a, b}, with the determinant cutoff ``det_tol``
// (0 for the [N1, N2, 1] case logic, _TOL for the 4-block enumeration)
__device__ __forceinline__ Interval sub2(float dA, float dB, float g, float pA,
                                         float pB, float w, float det_tol,
                                         const Consts& k) {
  const float invA = dv(1.0f, dA);
  const float piv = sub(dB, mul(mul(g, g), invA));
  const bool stab = piv > mul(k.eps, dB);
  const float invP = stab ? dv(1.0f, piv) : 0.0f;
  const float t = sub(pB, mul(mul(g, pA), invA));
  const float wb = mul(t, invP);
  const float wa = mul(sub(pA, mul(g, wb)), invA);
  const bool feas =
      stab && piv > mul(det_tol, dB) && wa >= 0.0f && wb >= 0.0f;
  const float res = sub(sub(w, mul(mul(pA, pA), invA)), mul(t, wb));
  return interval(feas, stab, res, add(fabsf(wa), fabsf(wb)), det_tol > 0.0f,
                  k);
}

// A minimum over the column blocks of a voxel: its partials (B, nparts)
// folded, a thread a voxel (a minimum is exact in any order, and a NaN
// wins as torch.minimum's does)
template <class T>
__global__ void fold_min(const T* __restrict__ part, T* __restrict__ out,
                         int B, int nparts) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* pb = part + (size_t)b * nparts;
  T m = pb[0];
  for (int t = 1; t < nparts; ++t) m = tmin(m, pb[t]);
  out[b] = m;
}

// a tile of the voxel's small columns, quantised: levels (q1, q2) and (R, a)
// as float64 (exact)
template <int C>
struct Tile {
  int2 q[C][kTile];
  double2 ra[C][kTile];
};

// where an atom's quantize2 goes: pointers at (voxel, sample 0, atom), the
// samples ``stride`` floats apart; r always, the others where not null:
// the levels, a, and a + R (what kernel 6 reads as its row block)
struct AtomOut {
  int8_t* q1;
  int8_t* q2;
  float* r;
  float* a;
  float* apr;
  size_t stride;
};

// The block's pass over the samples. ``cols(c, s)`` is sample s of the
// voxel's column c < nc (C at most); ``pair(t)`` the (qa, qb) columns of the
// voxel Gram that thread t < nv sums into ``vg``. A thread with ``live`` owns
// an atom: ``atom[s * astride]`` is its sample s where ``real``; where not
// (a padded column) it writes zeros and sums nothing. Its Grams: ``self``
// with itself, g[c] with column c.
template <int C, class Cols, class Pair>
__device__ __forceinline__ void stream(Tile<C>& tile, const Cols& cols,
                                       int nc, int S, const Pair& pair,
                                       int nv, Gram& vg, const float* atom,
                                       size_t astride, bool live, bool real,
                                       const AtomOut& out, Gram& self,
                                       Gram (&g)[C]) {
  const int tid = threadIdx.x;
  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int kn = min(kTile, S - s0);
    __syncthreads();  // the last tile is consumed
    for (int e = tid; e < nc * kTile; e += kAtoms) {
      const int c = e / kTile, k = e % kTile;
      if (k < kn) {
        const Level l = quantize2(cols(c, s0 + k));
        tile.q[c][k] = make_int2(l.q1, l.q2);
        tile.ra[c][k] = make_double2((double)l.r, (double)l.a);
      }
    }
    __syncthreads();
    if (tid < nv) {
      const int2 p = pair(tid);
      #pragma unroll 1
      for (int k = 0; k < kn; ++k) {
        const double2 va = tile.ra[p.x][k], vb = tile.ra[p.y][k];
        const int2 qa = tile.q[p.x][k];
        // a + R in float32, as the plain version adds the planes
        const float apr = add((float)va.y, (float)va.x);
        gram_step(vg, qa.x, qa.y, (double)apr, va.x, tile.q[p.y][k], vb.x,
                  vb.y);
      }
    }
    if (!live) continue;
    if (!real) {
      #pragma unroll 1
      for (int k = 0; k < kn; ++k) {
        const size_t o = (size_t)(s0 + k) * out.stride;
        out.q1[o] = 0;
        out.q2[o] = 0;
        out.r[o] = 0.0f;
        if (out.a) out.a[o] = 0.0f;
        if (out.apr) out.apr[o] = 0.0f;
      }
      continue;
    }
    float xn = atom[(size_t)s0 * astride];
    #pragma unroll 1
    for (int k = 0; k < kn; ++k) {
      const float x = xn;
      if (k + 1 < kn) xn = atom[(size_t)(s0 + k + 1) * astride];
      const Level l = quantize2(x);
      const float apr = add(l.a, l.r);
      const size_t o = (size_t)(s0 + k) * out.stride;
      out.q1[o] = (int8_t)l.q1;
      out.q2[o] = (int8_t)l.q2;
      out.r[o] = l.r;
      if (out.a) out.a[o] = l.a;
      if (out.apr) out.apr[o] = apr;
      const double dapr = (double)apr, dr = (double)l.r;
      gram_step(self, l.q1, l.q2, dapr, dr, make_int2(l.q1, l.q2), dr,
                (double)l.a);
      #pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < nc) {
          const double2 vb = tile.ra[c][k];
          gram_step(g[c], l.q1, l.q2, dapr, dr, tile.q[c][k], vb.x, vb.y);
        }
      }
    }
  }
}

}  // namespace hoist
}  // namespace mf
