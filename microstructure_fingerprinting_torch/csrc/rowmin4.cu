// Kernel 4: f32 interval row pass for the EAR configuration [N1, N2, N3, N4].
//
// Replaces the TPU kernel microstructure_fingerprinting_tpu/ops/f32scan.py
// (rowmin_4(pallas=True) -> _rowmin4_kernel, _rowmin4_body). For every voxel b
// and grid point (i1, i2): the exact Gram entry of kernel 2 (gram_hi.cuh, the
// same fixed sum order KERR4 was calibrated on), then the fold of the
// feasibility-cased residual intervals of every support containing {1, 2}:
// {1,2}, {1,2,X} for the nx = n3 + n4 single extra columns (i3's first) and
// {1,2,i3,i4} for the ns = n3 * n4 pairs, by LDL chains whose per-row,
// per-column and per-voxel prefixes are hoisted (ops/f32scan.py). Three-zone
// pivot guards: include (> 2 TOL diag), shell ((0.5..2) TOL diag -> the sound
// [-KERR, +inf)), exclude. Out: per (row, 64-column tile) the [lo, up]
// minima over valid columns, and per (32-row tile, column) the lo minimum
// over valid rows; blocks run in no order, so ops/f32scan.py folds the
// partials (amin) and the row-level supports in once per row.
//
// What bounds it on an H100: operations, about half in the Gram (9 int8
// and 2 float64 correction products per sample and point, on the tensor
// cores through the tile of gram_hi.cuh, shared with kernel 2) and half in
// the ~22 support chains per point at E = 10 (~1,000 float32 operations,
// all explicitly rounded, on CUDA cores). The design: kernel 2's 32 x 64
// tile for the Gram, which hands each thread its 2 x 4 points; the chain
// prefixes of the tile's rows and columns (up to 2 + 5 * 17 + 5 * 16 + 2
// floats per row and 2 + 4 * 17 + 4 * 16 per column at E <= 16) are staged
// once per block in dynamic shared memory, beyond the 48 KB static limit;
// the support loops are rolled and run from shared memory, with each
// thread's eight Gram entries in registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "df32.cuh"
#include "gram_hi.cuh"

namespace {

constexpr int TM = mf::kHiTM, TN = mf::kHiTN, kThreads = mf::kHiThreads;
constexpr float kKerr = 8.0f * 1.1920929e-07f;
constexpr float kKerr4 = 12.0f * 1.1920929e-07f;
constexpr float kTol = 100.0f * 1.1920929e-07f;
constexpr float kTolIn = 2.0f * kTol, kTolOut = 0.5f * kTol;

// pivot zone: 1 include, 0.5 shell, 0 exclude
__device__ __forceinline__ float zone(float piv, float d2c) {
  return piv > mf::mul(kTolIn, d2c)
             ? 1.0f
             : (piv > mf::mul(kTolOut, d2c) ? 0.5f : 0.0f);
}

__device__ __forceinline__ float inv_in(float z, float piv) {
  return z > 0.25f ? mf::dv(1.0f, piv) : 0.0f;
}

// include-and-feasible -> [res - err, res + err]; shell -> [-KERR, inf);
// exclude / infeasible -> no contribution
__device__ __forceinline__ void fold(float& lo, float& up, float z,
                                     bool feas_w, float res, float err) {
  const bool feas = (z > 0.75f) && feas_w;
  const float lo_s =
      feas ? mf::sub(res, err) : (z == 0.5f ? -kKerr : mf::kInf);
  lo = mf::jmin(lo, lo_s);
  up = mf::jmin(up, feas ? mf::add(res, err) : mf::kInf);
}

__global__ void __launch_bounds__(kThreads, 2)
rowmin4_kernel(const int8_t* __restrict__ q123,
               const __nv_bfloat16* __restrict__ a1bf,
               const __nv_bfloat16* __restrict__ rabf,
               const int8_t* __restrict__ qb3,
               const __nv_bfloat16* __restrict__ rbbf,
               const __nv_bfloat16* __restrict__ abbf,
               const float* __restrict__ row_pack,
               const float* __restrict__ col_pack,
               const float* __restrict__ vox, float* __restrict__ part_row,
               float* __restrict__ part_col, int S, int N1p, int T, int NB,
               int N2B, int n1, int n2, int n3, int n4, int NR, int NC,
               int NV, int nrow, int ncol, int nvox) {
  extern __shared__ float dyn[];
  float* srow = dyn;                  // [nrow][TM]
  float* scol = srow + nrow * TM;     // [ncol][TN]
  float* svox = scol + ncol * TN;     // [nvox]
  __shared__ mf::GramHiSmem gsm;
  __shared__ float red_lo[TM][17], red_up[TM][17], red_c[16][TN + 1];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const int N2pb = NB * N2B, nt = N1p / T;
  const int nx = n3 + n4, ns = n3 * n4;
  const int r0 = 2 + 5 * nx, c0 = 2 + 4 * nx, v0 = 1 + nx;

  for (int k = tid; k < nrow * TM; k += kThreads) {
    srow[k] = row_pack[((size_t)b * NR + k / TM) * N1p + row0 + k % TM];
  }
  for (int k = tid; k < ncol * TN; k += kThreads) {
    scol[k] = col_pack[((size_t)b * NC + k / TN) * N2pb + col0 + k % TN];
  }
  for (int k = tid; k < nvox; k += kThreads) svox[k] = vox[(size_t)b * NV + k];

  float g[2][4];
  mf::gram_hi_tile(q123, a1bf, rabf, qb3, rbbf, abbf, b, S, nt, T, NB, N2B,
                   row0, col0, gsm, g);

  float lo_r[2] = {mf::kInf, mf::kInf}, up_r[2] = {mf::kInf, mf::kInf};
  float lo_c[4] = {mf::kInf, mf::kInf, mf::kInf, mf::kInf};
  const float w_ = svox[0];
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = ty * 2 + r;
    const float* R = srow + i;        // R[k * TM]: row-pack entry k
    const bool row_ok = row0 + i < n1;
    const float invd1 = R[0], p1 = R[TM];
    const float kp = mf::mul(p1, invd1);
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const float* C = scol + j;      // C[k * TN]: column-pack entry k
      const float a = g[r][c];
      const float d2c = C[0], qc = C[TN];
      float lo = mf::kInf, up = mf::kInf;

      // support {1,2}
      {
        const float pivA = mf::sub(d2c, mf::mul(mf::mul(a, a), invd1));
        const float zA = zone(pivA, d2c);
        const float invA = inv_in(zA, pivA);
        const float tA = mf::sub(qc, mf::mul(a, kp));
        const float w2 = mf::mul(tA, invA);
        const float w1 = mf::mul(mf::sub(p1, mf::mul(a, w2)), invd1);
        const float res12 = mf::nan_to_inf(
            mf::sub(mf::sub(w_, mf::mul(p1, kp)), mf::mul(tA, w2)));
        const float s12 = mf::add(w1, w2);
        const float err12 =
            mf::mul(kKerr, mf::add(mf::add(1.0f, s12), mf::mul(s12, s12)));
        fold(lo, up, zA, mf::jmin(w1, w2) >= 0.0f, res12, err12);
      }

      // supports {1,2,X}: chain X -> 1 -> 2
      #pragma unroll 1
      for (int x = 0; x < nx; ++x) {
        const float* Rx = R + (2 + 5 * x) * TM;
        const float* Cx = C + (2 + 4 * x) * TN;
        const float L1x = Rx[0], invd1px = Rx[TM], kap_ppx = Rx[2 * TM];
        const float rho1x = Rx[3 * TM], zx = Rx[4 * TM];
        const float kap_cx = Cx[0], d2px = Cx[TN], q2px = Cx[2 * TN];
        const float cxc = Cx[3 * TN];
        const float ux = svox[1 + x];
        const float ap = mf::sub(a, mf::mul(L1x, cxc));
        const float pivB = mf::sub(d2px, mf::mul(mf::mul(ap, ap), invd1px));
        const float zB = mf::jmin(zx, zone(pivB, d2c));
        const float invB = inv_in(zB, pivB);
        const float tB = mf::sub(q2px, mf::mul(ap, kap_ppx));
        const float w2t = mf::mul(tB, invB);
        const float w1t = mf::sub(kap_ppx, mf::mul(mf::mul(ap, invd1px), w2t));
        const float w3t =
            mf::sub(mf::sub(ux, mf::mul(L1x, w1t)), mf::mul(kap_cx, w2t));
        const float res3 = mf::nan_to_inf(mf::sub(rho1x, mf::mul(tB, w2t)));
        const float err3 = mf::mul(
            kKerr, mf::add(mf::add(mf::add(1.0f, w1t), w2t), w3t));
        fold(lo, up, zB, mf::jmin(mf::jmin(w1t, w2t), w3t) >= 0.0f, res3,
             err3);
      }

      // full supports {1, 2, i3, i4}: LDL finish per pair
      #pragma unroll 1
      for (int s = 0; s < ns; ++s) {
        const int i3 = s / n4;
        const float L13 = R[(2 + 5 * i3) * TM];
        const float kap_c3 = C[(2 + 4 * i3) * TN];
        const float c3c = C[(5 + 4 * i3) * TN];
        const float u3 = svox[1 + i3];
        const float* Rs = R + (r0 + 5 * s) * TM;
        const float* Cs = C + (c0 + 4 * s) * TN;
        const float L14 = Rs[0], invD1h = Rs[TM], kap1 = Rs[2 * TM];
        const float rho1f = Rs[3 * TM], zr = Rs[4 * TM];
        const float e4c = Cs[0], L24 = Cs[TN], d2r = Cs[2 * TN];
        const float q2r = Cs[3 * TN];
        const float u4 = svox[v0 + 3 * s], L43 = svox[v0 + 3 * s + 1];
        const float z34 = svox[v0 + 3 * s + 2];
        const float NUM =
            mf::sub(mf::sub(a, mf::mul(L13, c3c)), mf::mul(L14, e4c));
        const float D2h = mf::sub(d2r, mf::mul(mf::mul(NUM, NUM), invD1h));
        const float zF = mf::jmin(mf::jmin(z34, zr), zone(D2h, d2c));
        const float invF = inv_in(zF, D2h);
        const float pi2 = mf::sub(q2r, mf::mul(NUM, kap1));
        const float w2f = mf::mul(pi2, invF);
        const float w1f = mf::sub(kap1, mf::mul(mf::mul(NUM, invD1h), w2f));
        const float w4f =
            mf::sub(mf::sub(u4, mf::mul(L14, w1f)), mf::mul(L24, w2f));
        const float w3f = mf::sub(
            mf::sub(mf::sub(u3, mf::mul(L43, w4f)), mf::mul(L13, w1f)),
            mf::mul(kap_c3, w2f));
        const float resF = mf::nan_to_inf(mf::sub(rho1f, mf::mul(pi2, w2f)));
        const float errF = mf::mul(
            kKerr4,
            mf::add(mf::add(mf::add(mf::add(1.0f, w1f), w2f), w3f), w4f));
        fold(lo, up, zF,
             mf::jmin(mf::jmin(w1f, w2f), mf::jmin(w3f, w4f)) >= 0.0f, resF,
             errF);
      }

      if (col0 + j >= n2) {
        lo = mf::kInf;
        up = mf::kInf;
      }
      lo_r[r] = mf::jmin(lo_r[r], lo);
      up_r[r] = mf::jmin(up_r[r], up);
      // padded rows carry zero chain prefixes whose shell-zone -KERR values
      // must not reach the column minima
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

extern "C" int mf_rowmin4(const int8_t* q123, const __nv_bfloat16* a1bf,
                          const __nv_bfloat16* rabf, const int8_t* qb3,
                          const __nv_bfloat16* rbbf,
                          const __nv_bfloat16* abbf, const float* row_pack,
                          const float* col_pack, const float* vox,
                          float* part_row, float* part_col, int B, int S,
                          int N1p, int T, int NB, int N2B, int n1, int n2,
                          int n3, int n4, int NR, int NC, int NV, int nr,
                          cudaStream_t stream) {
  const int nx = n3 + n4, ns = n3 * n4;
  // pack entries the kernel reads (the row pack also holds the row-level
  // lo/up at nr, nr + 1, folded in by the caller)
  const int nrow = 2 + 5 * nx + 5 * ns, ncol = 2 + 4 * nx + 4 * ns;
  const int nvox = 1 + nx + 3 * ns;
  if (T % TM || N2B % TN || N1p % T || n3 < 1 || n4 < 1 || nr != nrow ||
      NR < nrow + 2 || NC < ncol || NV < nvox) {
    return (int)cudaErrorInvalidValue;
  }
  if (!mf::gram_hi_aligned(q123, a1bf, rabf, qb3, rbbf, abbf)) {
    return (int)cudaErrorMisalignedAddress;
  }
  const int smem = (nrow * TM + ncol * TN + nvox) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rowmin4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(NB * N2B / TN, N1p / TM, B);
  rowmin4_kernel<<<grid, kThreads, smem, stream>>>(
      q123, a1bf, rabf, qb3, rbbf, abbf, row_pack, col_pack, vox, part_row,
      part_col, S, N1p, T, NB, N2B, n1, n2, n3, n4, NR, NC, NV, nrow, ncol,
      nvox);
  return (int)cudaGetLastError();
}
