// The double-float Gram tile of the re-scans (kernels 3 and 5).
//
// Device counterpart of microstructure_fingerprinting_tpu/ops/pallas_dfscan.py
// _df_gram_ps. A 256-thread block owns a 32-row x TN-column tile of the
// (i1, i2) grid of one voxel; thread (ty, tx) = (tid / 16, tid % 16) owns the
// 2 x (TN / 16) points at rows ty * 2 + r and columns tx + 16 c. Per point:
// the exact int8 [Q1|Q2] level products (4 samples per __dp4a, int32) and
// the two true-f32 cross products A1h' Rb and Ra' ab (exact float64 products,
// float64 sums rounded once, so independent of summation order), combined
// error-free into (hi, lo) and Dekker-split (presplit). 16-sequence chunks of
// both operands are staged in shared memory.
#pragma once

#include <stdint.h>

#include "df32.cuh"

namespace mf {

constexpr int kDfTM = 32, kDfSK = 16, kDfThreads = 256;

template <int TN>
struct GramDfSmem {
  // int8 levels packed 4 sequence samples per int32 (the __dp4a operand)
  int sq1a[kDfSK / 4][kDfTM], sq2a[kDfSK / 4][kDfTM];
  int sq1b[kDfSK / 4][TN], sq2b[kDfSK / 4][TN];
  float sa1h[kDfSK][kDfTM], sra[kDfSK][kDfTM], srb[kDfSK][TN], sab[kDfSK][TN];
};

// a[r][c]: the presplit double-float Gram entry of the thread's point
// (row0 + ty*2 + r, col0 + tx + 16c) of voxel b. Operands (B, S, N1p) of the
// rows (q1a, q2a int8; a1h, ra f32) and (B, S, N2pb) of the columns (q1b,
// q2b int8; rb, ab f32). Begins and ends with a block barrier.
template <int TN>
__device__ __forceinline__ void gram_df_tile(
    const int8_t* __restrict__ q1a, const int8_t* __restrict__ q2a,
    const float* __restrict__ a1h, const float* __restrict__ ra,
    const int8_t* __restrict__ q1b, const int8_t* __restrict__ q2b,
    const float* __restrict__ rb, const float* __restrict__ ab, int b, int S,
    int N1p, int N2pb, int row0, int col0, GramDfSmem<TN>& sm,
    PS (&a)[2][TN / 16]) {
  constexpr int TM = kDfTM, SK = kDfSK, G = SK / 4, CN = TN / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  int t11[2][CN] = {}, t12[2][CN] = {}, t22[2][CN] = {};
  double c1[2][CN] = {}, c2[2][CN] = {};
  const size_t abase = (size_t)b * S * N1p + row0;
  const size_t bbase = (size_t)b * S * N2pb + col0;
  for (int s0 = 0; s0 < S; s0 += SK) {
    __syncthreads();
    for (int k = tid; k < G * TM; k += kDfThreads) {
      const int g = k / TM, i = k % TM, s = s0 + 4 * g;
      const size_t o = abase + (size_t)s * N1p + i;
      sm.sq1a[g][i] = pack4(q1a + o, (size_t)N1p, S - s);
      sm.sq2a[g][i] = pack4(q2a + o, (size_t)N1p, S - s);
    }
    for (int k = tid; k < G * TN; k += kDfThreads) {
      const int g = k / TN, j = k % TN, s = s0 + 4 * g;
      const size_t o = bbase + (size_t)s * N2pb + j;
      sm.sq1b[g][j] = pack4(q1b + o, (size_t)N2pb, S - s);
      sm.sq2b[g][j] = pack4(q2b + o, (size_t)N2pb, S - s);
    }
    for (int k = tid; k < SK * TM; k += kDfThreads) {
      const int sl = k / TM, i = k % TM, s = s0 + sl;
      const bool in = s < S;
      const size_t o = abase + (size_t)s * N1p + i;
      sm.sa1h[sl][i] = in ? a1h[o] : 0.0f;
      sm.sra[sl][i] = in ? ra[o] : 0.0f;
    }
    for (int k = tid; k < SK * TN; k += kDfThreads) {
      const int sl = k / TN, j = k % TN, s = s0 + sl;
      const bool in = s < S;
      const size_t o = bbase + (size_t)s * N2pb + j;
      sm.srb[sl][j] = in ? rb[o] : 0.0f;
      sm.sab[sl][j] = in ? ab[o] : 0.0f;
    }
    __syncthreads();
    #pragma unroll
    for (int g = 0; g < G; ++g) {
      int qa1[2], qa2[2], qb1[CN], qb2[CN];
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        qa1[r] = sm.sq1a[g][ty * 2 + r];
        qa2[r] = sm.sq2a[g][ty * 2 + r];
      }
      #pragma unroll
      for (int c = 0; c < CN; ++c) {
        qb1[c] = sm.sq1b[g][tx + 16 * c];
        qb2[c] = sm.sq2b[g][tx + 16 * c];
      }
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        #pragma unroll
        for (int c = 0; c < CN; ++c) {
          t11[r][c] = __dp4a(qa1[r], qb1[c], t11[r][c]);
          t12[r][c] = __dp4a(qa2[r], qb1[c],
                             __dp4a(qa1[r], qb2[c], t12[r][c]));
          t22[r][c] = __dp4a(qa2[r], qb2[c], t22[r][c]);
        }
      }
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int sl = 4 * g + u;
        double xa[2], xr[2], xb[CN], xab[CN];
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          xa[r] = (double)sm.sa1h[sl][ty * 2 + r];
          xr[r] = (double)sm.sra[sl][ty * 2 + r];
        }
        #pragma unroll
        for (int c = 0; c < CN; ++c) {
          xb[c] = (double)sm.srb[sl][tx + 16 * c];
          xab[c] = (double)sm.sab[sl][tx + 16 * c];
        }
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          #pragma unroll
          for (int c = 0; c < CN; ++c) {
            // f32 x f32 products are exact in double: fma == mul + add
            c1[r][c] = fma(xa[r], xb[c], c1[r][c]);
            c2[r][c] = fma(xr[r], xab[c], c2[r][c]);
          }
        }
      }
    }
  }
  __syncthreads();

  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    #pragma unroll
    for (int c = 0; c < CN; ++c) {
      const float gv[5] = {
          mul((float)t11[r][c], 6.103515625e-05f),
          mul((float)t12[r][c], 2.384185791015625e-07f),
          mul((float)t22[r][c], 9.313225746154785e-10f),
          __double2float_rn(c1[r][c]), __double2float_rn(c2[r][c])};
      a[r][c] = presplit(df_from_sum(gv));
    }
  }
}

}  // namespace mf
