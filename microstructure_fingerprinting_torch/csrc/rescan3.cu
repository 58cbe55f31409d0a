// Kernel 3: double-float re-scan for the [N1, N2, 1] configuration.
//
// Replaces the TPU kernel microstructure_fingerprinting_tpu/ops/pallas_dfscan.py
// (row_scan_df3 -> _kernel, _df_gram_ps). For every voxel b and grid point
// (i1, i2): the double-float Gram g12 = exact int8 [Q1|Q2] level products +
// the two true-f32 cross products A1h' Rb and Ra' ab, combined error-free
// (gram_df.cuh, shared with kernel 5); then the compensated bordered
// determinants of the supports {1,2,3} and {1,2}, the Cramer-sign
// feasibility tests against tol_det (ops/dfscan._TOL_DET, passed in), the
// 2-variable case logic and the 12 -> 13 -> 23 fallback chain, exactly as
// the TPU kernel orders them. Out: per (row, 16-column chunk) the minimum
// residual (NaN-propagating) and its first column; ops/rescan.py folds
// chunks into the 8 segments per column block.
//
// What bounds it on an H100: operations. The Gram is 2 float64 and 4 int8
// multiply-adds per sample and point, on the tensor cores since the tile's
// redesign; the chain is ~520 explicitly rounded float32 operations per
// point (a fused multiply-add counted as 2; ~760 with Dekker products), a
// dependent run of two_sum / product steps. The design, for this card:
//   * a 256-thread block owns 32 rows x 64 columns, two blocks an SM; the
//     Gram tile leaves its entries in the mma layout, the block passes them
//     through shared memory, and thread (ty, tx) = (tid / 16, tid % 16) runs
//     the chain on the 2 x 4 points at rows ty * 2 + r, columns tx + 16 c;
//   * every product of double-float values is mf::mul_df_fma (df32.cuh):
//     the error of the rounded product by one fused multiply-add instead of
//     the Dekker form on split halves. Every add, subtract and divide
//     keeps its place and order, so the result is the plain version's
//     (ops/rescan.rescan3_twin, which multiplies by Dekker's forms) bit for
//     bit unless a product is below 2^-101 ~ 4e-31
//     (tests/test_torch_df32_fma.py; this kernel's products are far above);
//   * the packs keep their layout in device memory, (hi, lo, hh, hl) a
//     double-float value, but the kernel never reads the halves hh, hl: it
//     stages (hi, lo) only, 20 of the 38 row entries and 30 of the 58
//     column entries, by cp.async under the Gram tile's first chunk.
// The cross products are float64 sums of exact products in the tensor
// cores' order, rounded once: equal to the plain version's except where the
// two orders round to neighbouring float32 values (gram_df.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "df32.cuh"
#include "gram_df.cuh"

namespace {

constexpr int TM = mf::kDfTM, TN = 64, CH = 16, kThreads = mf::kDfThreads;
// pack entries (ops/rescan._hoists): NQ double-float quadruples
// (hi, lo, hh, hl), then 2 single floats; staged: (hi, lo) and the floats
constexpr int kRowQuads = 9, kColQuads = 14, kVox = 24;
constexpr int kRowPack = 4 * kRowQuads + 2, kColPack = 4 * kColQuads + 2;
constexpr int kRowSlots = 2 * kRowQuads + 2, kColSlots = 2 * kColQuads + 2;

using mf::P2;
using mf::mul_df_fma;
using mf::neg;

// pack entry held by staged slot s of a pack with nq quadruples
__device__ __forceinline__ int pack_entry(int s, int nq) {
  return s < 2 * nq ? (s >> 1) * 4 + (s & 1) : s + 2 * nq;
}

// The block's shared memory: the Gram tile's buffers, which hold the low
// parts of the finished tile afterwards; the staged packs; the tile of the
// high parts, then of the residuals.
struct alignas(16) Smem {
  union {
    mf::GramDfSmem<TN> gram;
    float glo[TM][TN + 1];
  };
  float row[kRowSlots][TM];
  float col[kColSlots][TN];
  float vox[kVox];
  float res[TM][TN + 1];
};

__device__ __forceinline__ P2 twice(P2 x) {
  return {mf::mul(2.0f, x.p), mf::mul(2.0f, x.e)};
}

// two blocks an SM: at most 128 registers a thread
__global__ void __launch_bounds__(kThreads, 2)
rescan3_kernel(const int8_t* __restrict__ q1a, const int8_t* __restrict__ q2a,
               const float* __restrict__ a1h, const float* __restrict__ ra,
               const int8_t* __restrict__ q1b, const int8_t* __restrict__ q2b,
               const float* __restrict__ rb, const float* __restrict__ ab,
               const float* __restrict__ row_pack,
               const float* __restrict__ col_pack,
               const float* __restrict__ vox, float* __restrict__ cmin,
               int* __restrict__ cidx, int S, int N1p, int N2pb, int n2,
               float tol_det) {
  extern __shared__ __align__(16) unsigned char dyn[];
  Smem& sm = *reinterpret_cast<Smem*>(dyn);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;

  // the (hi, lo) and single-float entries of the packs, 16 bytes a copy;
  // they join the Gram tile's first chunk of copies
  for (int k = tid; k < kRowSlots * (TM / 4); k += kThreads) {
    const int s = k / (TM / 4), part = 4 * (k % (TM / 4));
    mf::copy16_async(&sm.row[s][part],
                     row_pack + ((size_t)b * kRowPack +
                                 pack_entry(s, kRowQuads)) * N1p + row0 + part);
  }
  for (int k = tid; k < kColSlots * (TN / 4); k += kThreads) {
    const int s = k / (TN / 4), part = 4 * (k % (TN / 4));
    mf::copy16_async(&sm.col[s][part],
                     col_pack + ((size_t)b * kColPack +
                                 pack_entry(s, kColQuads)) * N2pb + col0 + part);
  }
  if (tid < kVox / 4) {
    mf::copy16_async(&sm.vox[4 * tid], vox + (size_t)b * kVox + 4 * tid);
  }

  {
    P2 g[2][TN / 32][2];
    const mf::GramDfAt<TN> at = mf::gram_df_tile<TN>(
        q1a, q2a, a1h, ra, q1b, q2b, rb, ab, b, S, N1p, N2pb, row0, col0,
        sm.gram, g);
    // from the mma layout to the chain's ownership
    #pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      #pragma unroll
      for (int n = 0; n < TN / 32; ++n) {
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          sm.res[at.row(mt)][at.col(n, e)] = g[mt][n][e].p;
          sm.glo[at.row(mt)][at.col(n, e)] = g[mt][n][e].e;
        }
      }
    }
  }
  __syncthreads();

  // double-float value k of the voxel vector
  auto voxdf = [&](int k) { return P2{sm.vox[4 * k], sm.vox[4 * k + 1]}; };
  const P2 C2v = voxdf(0), wv = voxdf(1), d3v = voxdf(2), r3v = voxdf(3);
  const float wf = sm.vox[16];

  #pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const int i = ty * 2 + r;
    #pragma unroll 1
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      // double-float value k of the row / column pack
      auto rowdf = [&](int k) {
        return P2{sm.row[2 * k][i], sm.row[2 * k + 1][i]};
      };
      auto coldf = [&](int k) {
        return P2{sm.col[2 * k][j], sm.col[2 * k + 1][j]};
      };
      const P2 Rb2 = rowdf(0), Rbp = rowdf(1), d1p = rowdf(2), Rp2 = rowdf(3);
      const P2 b_p = rowdf(4), p_p = rowdf(5), rowD2a = rowdf(6);
      const P2 rowEG = rowdf(7), rowF = rowdf(8);
      const float res1_row = sm.row[2 * kRowQuads][i];
      const float res13_row = sm.row[2 * kRowQuads + 1][i];
      const P2 U1 = coldf(0), U2 = coldf(1), U3 = coldf(2), U4 = coldf(3);
      const P2 V1 = coldf(4), V2 = coldf(5), X1c = coldf(6), d2p = coldf(7);
      const P2 q_p = coldf(8), c_p = coldf(9), colA = coldf(10);
      const P2 colB = coldf(11), colC = coldf(12), colH = coldf(13);
      const float res2_col = sm.col[2 * kColQuads][j];
      const float res23_col = sm.col[2 * kColQuads + 1][j];

      const P2 a_ = {sm.res[i][j], sm.glo[i][j]};

      // support {1,2,3}: compensated bordered 4x4
      const P2 m1 = mul_df_fma(b_p, V1), m2 = mul_df_fma(p_p, V2);
      const P2 s_t = mf::two_sum(m1.p, m2.p);
      const P2 s_ =
          mf::fast_two_sum(s_t.p, mf::add(mf::add(s_t.e, m1.e), m2.e));
      const P2 a2 = mul_df_fma(a_, a_);
      const P2 a2_ = mf::fast_two_sum(a2.p, a2.e);
      const P2 det4_parts[6] = {mul_df_fma(Rb2, U1), mul_df_fma(Rbp, U2),
                                mul_df_fma(d1p, U3), mul_df_fma(Rp2, U4),
                                mul_df_fma(a_, s_),  mul_df_fma(a2_, C2v)};
      const float det4 = mf::acc(det4_parts);
      const P2 bc = mul_df_fma(b_p, c_p);
      const P2 bc_ = mf::fast_two_sum(bc.p, bc.e);
      const P2 m_abc = mul_df_fma(a_, bc_);
      const P2 g3_parts[4] = {mul_df_fma(d1p, colA),
                              neg(mul_df_fma(Rb2, d2p)), twice(m_abc),
                              neg(mul_df_fma(a2_, d3v))};
      const float detG3 = mf::acc(g3_parts);
      const bool ok3 = detG3 > tol_det;
      const float res123 =
          mf::nan_to_inf(ok3 ? mf::dv(det4, detG3) : mf::kInf);

      // full-support feasibility (Cramer numerator signs, double-float)
      const P2 D1_parts[3] = {mul_df_fma(p_p, colA), mul_df_fma(a_, colB),
                              mul_df_fma(b_p, colC)};
      const float D1 = mf::acc(D1_parts);
      const P2 D2_parts[3] = {mul_df_fma(a_, rowD2a), mul_df_fma(rowEG, c_p),
                              mul_df_fma(rowF, q_p)};
      const float D2 = mf::acc(D2_parts);
      const P2 pc = mul_df_fma(p_p, c_p), bq = mul_df_fma(b_p, q_p);
      const P2 s3 = mf::two_sum(pc.p, bq.p);
      const P2 pcbq_ =
          mf::fast_two_sum(s3.p, mf::add(mf::add(s3.e, pc.e), bq.e));
      const P2 D3_parts[4] = {mul_df_fma(a_, pcbq_),
                              neg(mul_df_fma(rowEG, d2p)),
                              neg(mul_df_fma(d1p, colH)),
                              neg(mul_df_fma(a2_, r3v))};
      const float D3 = mf::acc(D3_parts);
      const bool full = (D1 >= -tol_det) && (D2 >= -tol_det) &&
                        (D3 >= -tol_det);

      // support {1,2}: compensated bordered 3x3
      const P2 m3 = mul_df_fma(p_p, q_p);
      const P2 pq_ = mf::fast_two_sum(m3.p, m3.e);
      const P2 ap_q = mul_df_fma(a_, pq_);
      const P2 n12_parts[4] = {mul_df_fma(d1p, X1c),
                               neg(mul_df_fma(Rp2, d2p)), twice(ap_q),
                               neg(mul_df_fma(a2_, wv))};
      const float num12 = mf::acc(n12_parts);
      const P2 d12_parts[2] = {mul_df_fma(d1p, d2p), neg(a2)};
      const float det12 = mf::acc(d12_parts);
      const bool ok12 = det12 > tol_det;
      const float res12full =
          mf::nan_to_inf(ok12 ? mf::dv(num12, det12) : mf::kInf);
      const P2 w1_parts[2] = {mul_df_fma(d2p, p_p),
                              neg(mul_df_fma(a_, q_p))};
      const P2 w2_parts[2] = {mul_df_fma(d1p, q_p),
                              neg(mul_df_fma(a_, p_p))};
      const float w1D = mf::acc(w1_parts), w2D = mf::acc(w2_parts);
      const float res12 = mf::two_var_cases(res12full, w1D, w2D, p_p.p,
                                            q_p.p, res1_row, res2_col, wf);

      // fallback chain (reference priority: 12, then 13, then 23)
      float fb = res12;
      fb = res13_row < fb ? res13_row : fb;
      fb = res23_col < fb ? res23_col : fb;
      const float res = full ? res123 : fb;
      sm.res[i][j] = col0 + j < n2 ? res : mf::kInf;
    }
  }
  __syncthreads();

  // per (row, 16-column chunk): minimum and its first column
  if (tid < TM * (TN / CH)) {
    const int i = tid / (TN / CH), ch = tid % (TN / CH);
    float m = sm.res[i][ch * CH];
    for (int k = 1; k < CH; ++k) m = mf::jmin(m, sm.res[i][ch * CH + k]);
    int first = 1 << 30;
    for (int k = CH - 1; k >= 0; --k) {
      if (sm.res[i][ch * CH + k] == m) first = col0 + ch * CH + k;
    }
    const size_t o = ((size_t)b * N1p + row0 + i) * (N2pb / CH) +
                     col0 / CH + ch;
    cmin[o] = m;
    cidx[o] = first;
  }
}

}  // namespace

extern "C" int mf_rescan3(const int8_t* q1a, const int8_t* q2a,
                          const float* a1h, const float* ra,
                          const int8_t* q1b, const int8_t* q2b,
                          const float* rb, const float* ab,
                          const float* row_pack, const float* col_pack,
                          const float* vox, float* cmin, int* cidx, int B,
                          int S, int N1p, int N2pb, int n2,
                          float tol_det, cudaStream_t stream) {
  if (N1p % TM || N2pb % TN) return (int)cudaErrorInvalidValue;
  if (!mf::gram_df_aligned(q1a, q2a, a1h, ra, q1b, q2b, rb, ab) ||
      (((uintptr_t)row_pack | (uintptr_t)col_pack | (uintptr_t)vox) & 15)) {
    return (int)cudaErrorMisalignedAddress;
  }
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      rescan3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N2pb / TN, N1p / TM, B);
  rescan3_kernel<<<grid, kThreads, smem, stream>>>(
      q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox, cmin,
      cidx, S, N1p, N2pb, n2, tol_det);
  return (int)cudaGetLastError();
}
