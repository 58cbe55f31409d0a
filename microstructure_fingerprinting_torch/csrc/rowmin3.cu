// Kernel 2: f32 interval row pass for the [N1, N2, 1] configuration.
//
// Replaces the TPU kernel microstructure_fingerprinting_tpu/ops/f32scan.py
// (rowmin_3(pallas=True) -> _rowmin3_kernel, _gram_hi). For every voxel b
// and grid point (i1, i2): the exact Gram entry from the three-level int8
// packs of kernel 1 (nine level products grouped by scale, exact in int32)
// plus two bf16 corrections, summed in the TPU kernel's fixed order
// v_a + (v_b + (v_c + (c1 + (c2 + (v_d + v_e))))) (part of the error model
// KERR was calibrated on); then progressive-elimination residual intervals
// for the supports {1,2} and {1,2,3}. Out: per (row, 64-column tile) the
// [lo, up] minima over valid columns, and per (32-row tile, column) the lo
// minimum over valid rows. The TPU kernel folded these across its
// sequential grid in a revisited output block; blocks here run in no order,
// so each writes its own partials and ops/f32scan.py folds them (amin).
//
// What bounds it on an H100: the Gram's operations. It is
// 9 * S * N1p * N2pb int8 products per voxel (~4.5 G at N1 = N2 = 782,
// S = 552) plus 2 * S * N1p * N2pb float64 correction products, against ~70
// float32 chain operations per point. The design is the tile of gram_hi.cuh
// (shared with kernel 4): a 256-thread block owns 32 rows x 64 columns, and
// both kinds of product run on the tensor cores (mma.sync: float64 m16n8k8
// for the corrections, int8 m16n8k32 for the levels), from 32-sample chunks
// copied ahead with cp.async. The tile hands each thread its 2 x 4 points,
// on which the chains below run on CUDA cores. The bf16 corrections are
// exact products accumulated in float64 and rounded once, equal to the plain
// PyTorch version whatever the order. Warpgroup mma (wgmma) fed by TMA, and
// chains that run in the mma layout, are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "df32.cuh"
#include "gram_hi.cuh"

namespace {

constexpr int TM = mf::kHiTM, TN = mf::kHiTN, kThreads = mf::kHiThreads;
constexpr float kKerr = 8.0f * 1.1920929e-07f;
constexpr float kTol = 100.0f * 1.1920929e-07f;

__global__ void __launch_bounds__(kThreads, 2)
rowmin3_kernel(const int8_t* __restrict__ q123,
               const __nv_bfloat16* __restrict__ a1bf,
               const __nv_bfloat16* __restrict__ rabf,
               const int8_t* __restrict__ qb3,
               const __nv_bfloat16* __restrict__ rbbf,
               const __nv_bfloat16* __restrict__ abbf,
               const float* __restrict__ row_pack,
               const float* __restrict__ col_pack,
               const float* __restrict__ vox, float* __restrict__ part_row,
               float* __restrict__ part_col, int S, int N1p, int T, int NB,
               int N2B, int n1, int n2) {
  __shared__ mf::GramHiSmem gsm;
  __shared__ float srow[12][TM];
  __shared__ float scol[6][TN];
  __shared__ float red_lo[TM][17], red_up[TM][17], red_c[16][TN + 1];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const int N2pb = NB * N2B, nt = N1p / T;

  for (int k = tid; k < 12 * TM; k += kThreads) {
    srow[k / TM][k % TM] = row_pack[((size_t)b * 16 + k / TM) * N1p + row0 + k % TM];
  }
  for (int k = tid; k < 6 * TN; k += kThreads) {
    scol[k / TN][k % TN] = col_pack[((size_t)b * 8 + k / TN) * N2pb + col0 + k % TN];
  }

  float g[2][4];
  mf::gram_hi_tile(q123, a1bf, rabf, qb3, rbbf, abbf, b, S, nt, T, NB, N2B,
                   row0, col0, gsm, g);

  const float u3v = vox[(size_t)b * 8 + 0];
  const float invd3v = vox[(size_t)b * 8 + 1];
  float lo_r[2] = {mf::kInf, mf::kInf}, up_r[2] = {mf::kInf, mf::kInf};
  float lo_c[4] = {mf::kInf, mf::kInf, mf::kInf, mf::kInf};
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = ty * 2 + r;
    const float invd1t = srow[1][i], kap_pt = srow[2][i], rho1t = srow[3][i];
    const float kap_bt = srow[4][i], invd1pt = srow[6][i];
    const float kap_ppt = srow[7][i], rho13t = srow[8][i];
    const bool stab1t = srow[11][i] > 0.5f;
    const bool row_ok = row0 + i < n1;
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const float d2c = scol[0][j], qc = scol[1][j], cc = scol[2][j];
      const float d2pc = scol[3][j], q2pc = scol[4][j], kapcc = scol[5][j];
      const float a = g[r][c];

      // support {1,2}
      const float pivA = mf::sub(d2c, mf::mul(mf::mul(a, a), invd1t));
      const bool stabA = pivA > mf::mul(mf::kEps, d2c);
      const float invA = stabA ? mf::dv(1.0f, pivA) : 0.0f;
      const float tA = mf::sub(qc, mf::mul(a, kap_pt));
      const float w2 = mf::mul(tA, invA);
      const float w1 = mf::sub(kap_pt, mf::mul(mf::mul(a, invd1t), w2));
      const bool feas12 = stabA && (w1 > 0.0f) && (w2 > 0.0f);
      const float res12 = mf::nan_to_inf(mf::sub(rho1t, mf::mul(tA, w2)));
      const float s12 = mf::add(w1, w2);
      const float err12 = mf::mul(kKerr, mf::add(mf::add(1.0f, s12),
                                                 mf::mul(s12, s12)));
      float lo = feas12 ? mf::sub(res12, err12) : (stabA ? mf::kInf : -kKerr);
      float up = feas12 ? mf::add(res12, err12) : mf::kInf;

      // support {1,2,3}
      const float ap = mf::sub(a, mf::mul(kap_bt, cc));
      const float pivB = mf::sub(d2pc, mf::mul(mf::mul(ap, ap), invd1pt));
      const bool stabB = stab1t && (pivB > mf::mul(mf::kEps, d2c));
      const float invB = stabB ? mf::dv(1.0f, pivB) : 0.0f;
      const float tB = mf::sub(q2pc, mf::mul(ap, kap_ppt));
      const float w2f = mf::mul(tB, invB);
      const float w1f = mf::sub(kap_ppt, mf::mul(mf::mul(ap, invd1pt), w2f));
      const float w3f = mf::sub(mf::sub(u3v, mf::mul(kap_bt, w1f)),
                                mf::mul(kapcc, w2f));
      const float tolw = mf::mul(mf::mul(mf::mul(kTol, invd3v), invd1pt), invB);
      const bool feas123 = stabB && (w1f >= -tolw) && (w2f >= -tolw) &&
                           (w3f >= -tolw);
      const float res123 = mf::nan_to_inf(mf::sub(rho13t, mf::mul(tB, w2f)));
      const float s123 = mf::add(mf::add(fabsf(w1f), fabsf(w2f)), fabsf(w3f));
      const float err123 = mf::mul(kKerr, mf::add(mf::add(1.0f, s123),
                                                  mf::mul(s123, s123)));
      lo = mf::jmin(lo, feas123 ? mf::sub(res123, err123)
                                : (stabB ? mf::kInf : -kKerr));
      up = mf::jmin(up, feas123 ? mf::add(res123, err123) : mf::kInf);

      if (col0 + j >= n2) {
        lo = mf::kInf;
        up = mf::kInf;
      }
      lo_r[r] = mf::jmin(lo_r[r], lo);
      up_r[r] = mf::jmin(up_r[r], up);
      lo_c[c] = mf::jmin(lo_c[c], row_ok ? lo : mf::kInf);
    }
  }

  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    red_lo[ty * 2 + r][tx] = lo_r[r];
    red_up[ty * 2 + r][tx] = up_r[r];
  }
  #pragma unroll
  for (int c = 0; c < 4; ++c) red_c[ty][tx + 16 * c] = lo_c[c];
  __syncthreads();
  if (tid < 2 * TM) {
    const int i = tid % TM;
    float (*red)[17] = tid < TM ? red_lo : red_up;
    float m = red[i][0];
    for (int k = 1; k < 16; ++k) m = mf::jmin(m, red[i][k]);
    part_row[(((size_t)b * (N2pb / TN) + blockIdx.x) * 2 + tid / TM) * N1p +
             row0 + i] = m;
  } else if (tid < 2 * TM + TN) {
    const int j = tid - 2 * TM;
    float m = red_c[0][j];
    for (int k = 1; k < 16; ++k) m = mf::jmin(m, red_c[k][j]);
    part_col[((size_t)b * (N1p / TM) + blockIdx.y) * N2pb + col0 + j] = m;
  }
}

}  // namespace

extern "C" int mf_rowmin3(const int8_t* q123, const __nv_bfloat16* a1bf,
                          const __nv_bfloat16* rabf, const int8_t* qb3,
                          const __nv_bfloat16* rbbf,
                          const __nv_bfloat16* abbf, const float* row_pack,
                          const float* col_pack, const float* vox,
                          float* part_row, float* part_col, int B, int S,
                          int N1p, int T, int NB, int N2B, int n1, int n2,
                          cudaStream_t stream) {
  if (T % TM || N2B % TN || N1p % T) return (int)cudaErrorInvalidValue;
  if (!mf::gram_hi_aligned(q123, a1bf, rabf, qb3, rbbf, abbf)) {
    return (int)cudaErrorMisalignedAddress;
  }
  dim3 grid(NB * N2B / TN, N1p / TM, B);
  rowmin3_kernel<<<grid, kThreads, 0, stream>>>(
      q123, a1bf, rabf, qb3, rbbf, abbf, row_pack, col_pack, vox, part_row,
      part_col, S, N1p, T, NB, N2B, n1, n2);
  return (int)cudaGetLastError();
}
