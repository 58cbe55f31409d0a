// Kernel 3: double-float re-scan for the [N1, N2, 1] configuration.
//
// Replaces the TPU kernel microstructure_fingerprinting_tpu/ops/pallas_dfscan.py
// (row_scan_df3 -> _kernel, _df_gram_ps). For every voxel b and grid point
// (i1, i2): the double-float Gram g12 = exact int8 [Q1|Q2] level products +
// the two true-f32 cross products A1h' Rb and Ra' ab, combined error-free
// and Dekker-split; then the compensated bordered determinants of the
// supports {1,2,3} and {1,2}, the Cramer-sign feasibility tests against
// tol_det (ops/dfscan._TOL_DET, passed in), the 2-variable case logic and the 12 -> 13 -> 23 fallback chain,
// exactly as the TPU kernel orders them. Out: per (row, 16-column chunk)
// the minimum residual (NaN-propagating) and its first column;
// ops/rescan.py folds chunks into the 8 segments per column block.
//
// What bounds it on an H100: the per-point compensated chain, ~400 float32
// operations per grid point, evaluated with explicitly rounded intrinsics
// (never contracted). The Gram is small by comparison (4 int8 products,
// one __dp4a per 4 samples each, and 2 float64 products per sequence
// sample). The design: a 256-thread block owns 32 rows x 64 columns, each
// thread accumulates the Grams of its 2 x 4 points with the tile of
// gram_df.cuh (shared with kernel 5), then
// runs the chain point by point with the hoisted row / column factors read
// from shared memory, and the block reduces its residual tile per chunk. The
// cross products are exact float64 products accumulated in float64 and
// rounded once (order-independent, equal to the plain PyTorch version).
#include <cuda_runtime.h>
#include <stdint.h>

#include "df32.cuh"
#include "gram_df.cuh"

namespace {

constexpr int TM = mf::kDfTM, TN = 64, CH = 16, kThreads = mf::kDfThreads;

using mf::P2;
using mf::PS;
using mf::mul_ps;
using mf::neg;

__device__ __forceinline__ P2 twice(P2 x) {
  return {mf::mul(2.0f, x.p), mf::mul(2.0f, x.e)};
}

// reference 2-variable NNLS case selection (dfscan._two_var_cases)
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
  return case1 ? mf::nan_to_inf(res_full)
               : (take1 ? res1 : (take2 ? res2 : y_sq));
}

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
  __shared__ mf::GramDfSmem<TN> gsm;
  __shared__ float srow[38][TM];
  __shared__ float scol[58][TN];
  __shared__ float svox[24];
  __shared__ float sres[TM][TN + 1];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;

  for (int k = tid; k < 38 * TM; k += kThreads) {
    srow[k / TM][k % TM] = row_pack[((size_t)b * 38 + k / TM) * N1p + row0 + k % TM];
  }
  for (int k = tid; k < 58 * TN; k += kThreads) {
    scol[k / TN][k % TN] = col_pack[((size_t)b * 58 + k / TN) * N2pb + col0 + k % TN];
  }
  if (tid < 24) svox[tid] = vox[(size_t)b * 24 + tid];

  PS g[2][4];
  mf::gram_df_tile<TN>(q1a, q2a, a1h, ra, q1b, q2b, rb, ab, b, S, N1p, N2pb,
                       row0, col0, gsm, g);

  const PS C2v = {svox[0], svox[1], svox[2], svox[3]};
  const PS wv = {svox[4], svox[5], svox[6], svox[7]};
  const PS d3v = {svox[8], svox[9], svox[10], svox[11]};
  const PS r3v = {svox[12], svox[13], svox[14], svox[15]};
  const float wf = svox[16];

  #pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const int i = ty * 2 + r;
    #pragma unroll 1
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      auto rowps = [&](int k) {
        return PS{srow[4 * k][i], srow[4 * k + 1][i], srow[4 * k + 2][i],
                  srow[4 * k + 3][i]};
      };
      auto colps = [&](int k) {
        return PS{scol[4 * k][j], scol[4 * k + 1][j], scol[4 * k + 2][j],
                  scol[4 * k + 3][j]};
      };
      const PS Rb2 = rowps(0), Rbp = rowps(1), d1p = rowps(2), Rp2 = rowps(3);
      const PS b_p = rowps(4), p_p = rowps(5), rowD2a = rowps(6);
      const PS rowEG = rowps(7), rowF = rowps(8);
      const float res1_row = srow[36][i], res13_row = srow[37][i];
      const PS U1 = colps(0), U2 = colps(1), U3 = colps(2), U4 = colps(3);
      const PS V1 = colps(4), V2 = colps(5), X1c = colps(6), d2p = colps(7);
      const PS q_p = colps(8), c_p = colps(9), colA = colps(10);
      const PS colB = colps(11), colC = colps(12), colH = colps(13);
      const float res2_col = scol[56][j], res23_col = scol[57][j];

      const PS a_ps = g[r][c];

      // support {1,2,3}: compensated bordered 4x4
      const P2 m1 = mul_ps(b_p, V1), m2 = mul_ps(p_p, V2);
      const P2 s_t = mf::two_sum(m1.p, m2.p);
      const PS s_ps = mf::presplit(
          mf::fast_two_sum(s_t.p, mf::add(mf::add(s_t.e, m1.e), m2.e)));
      const P2 a2 = mul_ps(a_ps, a_ps);
      const PS a2_ps = mf::presplit(mf::fast_two_sum(a2.p, a2.e));
      const P2 det4_parts[6] = {mul_ps(Rb2, U1), mul_ps(Rbp, U2),
                                mul_ps(d1p, U3), mul_ps(Rp2, U4),
                                mul_ps(a_ps, s_ps), mul_ps(a2_ps, C2v)};
      const float det4 = mf::acc(det4_parts);
      const P2 bc = mul_ps(b_p, c_p);
      const PS bc_ps = mf::presplit(mf::fast_two_sum(bc.p, bc.e));
      const P2 m_abc = mul_ps(a_ps, bc_ps);
      const P2 g3_parts[4] = {mul_ps(d1p, colA), neg(mul_ps(Rb2, d2p)),
                              twice(m_abc), neg(mul_ps(a2_ps, d3v))};
      const float detG3 = mf::acc(g3_parts);
      const bool ok3 = detG3 > tol_det;
      const float res123 =
          mf::nan_to_inf(ok3 ? mf::dv(det4, detG3) : mf::kInf);

      // full-support feasibility (Cramer numerator signs, double-float)
      const P2 D1_parts[3] = {mul_ps(p_p, colA), mul_ps(a_ps, colB),
                              mul_ps(b_p, colC)};
      const float D1 = mf::acc(D1_parts);
      const P2 D2_parts[3] = {mul_ps(a_ps, rowD2a), mul_ps(rowEG, c_p),
                              mul_ps(rowF, q_p)};
      const float D2 = mf::acc(D2_parts);
      const P2 pc = mul_ps(p_p, c_p), bq = mul_ps(b_p, q_p);
      const P2 s3 = mf::two_sum(pc.p, bq.p);
      const PS pcbq_ps = mf::presplit(
          mf::fast_two_sum(s3.p, mf::add(mf::add(s3.e, pc.e), bq.e)));
      const P2 D3_parts[4] = {mul_ps(a_ps, pcbq_ps), neg(mul_ps(rowEG, d2p)),
                              neg(mul_ps(d1p, colH)), neg(mul_ps(a2_ps, r3v))};
      const float D3 = mf::acc(D3_parts);
      const bool full = (D1 >= -tol_det) && (D2 >= -tol_det) &&
                        (D3 >= -tol_det);

      // support {1,2}: compensated bordered 3x3
      const P2 m3 = mul_ps(p_p, q_p);
      const PS pq_ps = mf::presplit(mf::fast_two_sum(m3.p, m3.e));
      const P2 ap_q = mul_ps(a_ps, pq_ps);
      const P2 n12_parts[4] = {mul_ps(d1p, X1c), neg(mul_ps(Rp2, d2p)),
                               twice(ap_q), neg(mul_ps(a2_ps, wv))};
      const float num12 = mf::acc(n12_parts);
      const P2 d12_parts[2] = {mul_ps(d1p, d2p), neg(a2)};
      const float det12 = mf::acc(d12_parts);
      const bool ok12 = det12 > tol_det;
      const float res12full =
          mf::nan_to_inf(ok12 ? mf::dv(num12, det12) : mf::kInf);
      const P2 w1_parts[2] = {mul_ps(d2p, p_p), neg(mul_ps(a_ps, q_p))};
      const P2 w2_parts[2] = {mul_ps(d1p, q_p), neg(mul_ps(a_ps, p_p))};
      const float w1D = mf::acc(w1_parts), w2D = mf::acc(w2_parts);
      const float res12 = two_var_cases(res12full, w1D, w2D, p_p.hi, q_p.hi,
                                        res1_row, res2_col, wf);

      // fallback chain (reference priority: 12, then 13, then 23)
      float fb = res12;
      fb = res13_row < fb ? res13_row : fb;
      fb = res23_col < fb ? res23_col : fb;
      const float res = full ? res123 : fb;
      sres[i][j] = col0 + j < n2 ? res : mf::kInf;
    }
  }
  __syncthreads();

  // per (row, 16-column chunk): minimum and its first column
  if (tid < TM * (TN / CH)) {
    const int i = tid / (TN / CH), ch = tid % (TN / CH);
    float m = sres[i][ch * CH];
    for (int k = 1; k < CH; ++k) m = mf::jmin(m, sres[i][ch * CH + k]);
    int first = 1 << 30;
    for (int k = CH - 1; k >= 0; --k) {
      if (sres[i][ch * CH + k] == m) first = col0 + ch * CH + k;
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
  dim3 grid(N2pb / TN, N1p / TM, B);
  rescan3_kernel<<<grid, kThreads, 0, stream>>>(
      q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox, cmin,
      cidx, S, N1p, N2pb, n2, tol_det);
  return (int)cudaGetLastError();
}
