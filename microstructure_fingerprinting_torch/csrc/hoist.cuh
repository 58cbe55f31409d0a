// The shared skeleton of kernels 8 (df4hoist.cu) and 9 (df2hoist.cu): the
// operand preparation of the double-float scans, one pass over the samples.
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
#pragma once

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
