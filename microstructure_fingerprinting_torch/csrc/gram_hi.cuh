// The exact Gram tile of the f32 interval row passes (kernels 2 and 4).
//
// Device counterpart of microstructure_fingerprinting_tpu/ops/f32scan.py
// _gram_hi. A 256-thread block owns a 32-row x 64-column tile of the
// (i1, i2) grid of one voxel; thread (ty, tx) = (tid / 16, tid % 16) owns the
// 2 x 4 points at rows ty * 2 + r and columns tx + 16 c. Per point: the nine
// int8 level products of the three-level packs of kernel 1, grouped by scale
// (exact in int32, 4 samples per __dp4a), and the two bf16 corrections
// (exact products, float64 sums rounded once), summed in the TPU kernel's
// fixed order v_a + (v_b + (v_c + (c1 + (c2 + (v_d + v_e))))), the order
// KERR and KERR4 were calibrated on. 16-sequence chunks of both operands are
// staged in shared memory; every loaded value feeds 2-4 points.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "df32.cuh"

namespace mf {

constexpr int kHiTM = 32, kHiTN = 64, kHiSK = 16, kHiThreads = 256;

struct GramHiSmem {
  // int8 levels packed 4 sequence samples per int32 (the __dp4a operand)
  int sqa[3][kHiSK / 4][kHiTM];
  int sqb[3][kHiSK / 4][kHiTN];
  double sxa[kHiSK][kHiTM], sra[kHiSK][kHiTM];
  double srb[kHiSK][kHiTN], sab[kHiSK][kHiTN];
};

// a[r][c]: the rounded Gram entry of the thread's point (row0 + ty*2 + r,
// col0 + tx + 16c) of voxel b. Operands are kernel 1's packs: q123/a1bf/rabf
// (B, nt, S, 3T | T) of the row block, qb3/rbbf/abbf (B, NB, S, 3N2B | N2B)
// of the column block. Begins and ends with a block barrier.
__device__ __forceinline__ void gram_hi_tile(
    const int8_t* __restrict__ q123, const __nv_bfloat16* __restrict__ a1bf,
    const __nv_bfloat16* __restrict__ rabf, const int8_t* __restrict__ qb3,
    const __nv_bfloat16* __restrict__ rbbf,
    const __nv_bfloat16* __restrict__ abbf, int b, int S, int nt, int T,
    int NB, int N2B, int row0, int col0, GramHiSmem& sm, float (&a)[2][4]) {
  constexpr int TM = kHiTM, TN = kHiTN, SK = kHiSK, G = SK / 4;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ta = row0 / T, ia = row0 % T;         // row tile of the packs
  const int cb = col0 / N2B, jb = col0 % N2B;     // column block

  int t11[2][4] = {}, t12[2][4] = {}, t22[2][4] = {}, t23[2][4] = {},
      t33[2][4] = {};
  double c1[2][4] = {}, c2[2][4] = {};

  const size_t abase = ((size_t)b * nt + ta) * S;
  const size_t bbase = ((size_t)b * NB + cb) * S;
  for (int s0 = 0; s0 < S; s0 += SK) {
    __syncthreads();
    for (int k = tid; k < 3 * G * TM; k += kHiThreads) {
      const int l = k / (G * TM), g = (k / TM) % G, i = k % TM;
      const int s = s0 + 4 * g;
      sm.sqa[l][g][i] = pack4(q123 + (abase + s) * 3 * T + l * T + ia + i,
                              (size_t)3 * T, S - s);
    }
    for (int k = tid; k < 3 * G * TN; k += kHiThreads) {
      const int l = k / (G * TN), g = (k / TN) % G, j = k % TN;
      const int s = s0 + 4 * g;
      sm.sqb[l][g][j] = pack4(qb3 + (bbase + s) * 3 * N2B + l * N2B + jb + j,
                              (size_t)3 * N2B, S - s);
    }
    for (int k = tid; k < SK * TM; k += kHiThreads) {
      const int sl = k / TM, i = k % TM, s = s0 + sl;
      const bool in = s < S;
      sm.sxa[sl][i] = in ? (double)bf(a1bf[(abase + s) * T + ia + i]) : 0.0;
      sm.sra[sl][i] = in ? (double)bf(rabf[(abase + s) * T + ia + i]) : 0.0;
    }
    for (int k = tid; k < SK * TN; k += kHiThreads) {
      const int sl = k / TN, j = k % TN, s = s0 + sl;
      const bool in = s < S;
      sm.srb[sl][j] = in ? (double)bf(rbbf[(bbase + s) * N2B + jb + j]) : 0.0;
      sm.sab[sl][j] = in ? (double)bf(abbf[(bbase + s) * N2B + jb + j]) : 0.0;
    }
    __syncthreads();
    #pragma unroll
    for (int g = 0; g < G; ++g) {
      int qa[2][3], qb[4][3];
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        #pragma unroll
        for (int l = 0; l < 3; ++l) qa[r][l] = sm.sqa[l][g][ty * 2 + r];
      }
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        #pragma unroll
        for (int l = 0; l < 3; ++l) qb[c][l] = sm.sqb[l][g][tx + 16 * c];
      }
      // the nine level products, 4 samples per __dp4a (exact in int32),
      // grouped by scale as the TPU kernel's int32 sums
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        #pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int* x = qa[r];
          const int* q = qb[c];
          t11[r][c] = __dp4a(x[0], q[0], t11[r][c]);
          t12[r][c] = __dp4a(x[1], q[0], __dp4a(x[0], q[1], t12[r][c]));
          t22[r][c] = __dp4a(x[2], q[0], __dp4a(x[0], q[2],
                              __dp4a(x[1], q[1], t22[r][c])));
          t23[r][c] = __dp4a(x[2], q[1], __dp4a(x[1], q[2], t23[r][c]));
          t33[r][c] = __dp4a(x[2], q[2], t33[r][c]);
        }
      }
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int sl = 4 * g + u;
        double xa[2], ra[2], rb[4], ab[4];
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          xa[r] = sm.sxa[sl][ty * 2 + r];
          ra[r] = sm.sra[sl][ty * 2 + r];
        }
        #pragma unroll
        for (int c = 0; c < 4; ++c) {
          rb[c] = sm.srb[sl][tx + 16 * c];
          ab[c] = sm.sab[sl][tx + 16 * c];
        }
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          #pragma unroll
          for (int c = 0; c < 4; ++c) {
            // bf16 x bf16 products are exact in double: fma == mul + add
            c1[r][c] = fma(xa[r], rb[c], c1[r][c]);
            c2[r][c] = fma(ra[r], ab[c], c2[r][c]);
          }
        }
      }
    }
  }
  __syncthreads();

  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v_a = mul((float)t11[r][c], 6.103515625e-05f);
      const float v_b = mul((float)t12[r][c], 2.384185791015625e-07f);
      const float v_c = mul((float)t22[r][c], 9.313225746154785e-10f);
      const float v_d = mul((float)t23[r][c], 3.637978807091713e-12f);
      const float v_e = mul((float)t33[r][c], 1.4210854715202004e-14f);
      const float cf1 = __double2float_rn(c1[r][c]);
      const float cf2 = __double2float_rn(c2[r][c]);
      a[r][c] = add(v_a, add(v_b, add(v_c, add(cf1, add(cf2, add(v_d, v_e))))));
    }
  }
}

}  // namespace mf
