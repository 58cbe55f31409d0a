// Kernel 5: double-float re-scan for the EAR configuration [N1, N2, N3, N4].
//
// Replaces the TPU kernel microstructure_fingerprinting_tpu/ops/pallas_dfscan.py
// (row_scan_df4 -> _df4_kernel). For every voxel b and grid point (i1, i2):
// the double-float Gram entry of kernel 3 (gram_df.cuh), then the support
// enumeration with compensated values and float32 feasibility booleans:
// the {1,2} base (unconstrained-sign feasibility) with the hoisted row,
// column and empty-support minima; {1,2,X} per extra column X (i3's first)
// by the quadratic-in-g12 bordered determinant; and for each of the
// ns = n3 * n4 (i3, i4) sweeps the {1,2,3,4} LDL' finish in (csf, ear,
// fasc1, fasc2) order, folded with the sweep's hoisted sub-support minima.
// A sweep replaces the point's best only when strictly smaller, so the
// first sweep wins ties. Out: per (row, 32-column tile) the minimum and the
// first flat index i2 * ns + s holding it; ops/rescan.py folds the tiles
// into segments and candidates_from_rows_df4 takes the first minimum in
// (i1, i2, i3, i4) order.
//
// What bounds it on an H100: the per-point chains, roughly 160 float32
// operations for the base and 215 per extra column and per sweep (~4,700
// at E = 10), all explicitly rounded intrinsics of df32.cuh (never
// contracted; the double-float division inlined as the TPU kernel writes
// it). The Gram (4 int8 products by __dp4a and 2 float64 products per
// sample) is small beside it. The TPU kernel unrolled the ns sweeps over
// whole (tile, N2B) temporaries in 100 MB of VMEM; here each thread runs
// its 2 x 2 points one at a time with the sweep loop rolled, keeping
// best/best_s in registers and the point's nx extra-column residuals in a
// per-thread slice of shared memory. The row and column packs (345 and 415
// floats per row and column at E = 10) are staged once per 32 x 32 block in
// dynamic shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "df32.cuh"
#include "gram_df.cuh"

namespace {

constexpr int TM = mf::kDfTM, TN = 32, CN = TN / 16;
constexpr int kThreads = mf::kDfThreads;

using mf::P2;
using mf::PS;
using mf::mul_ps;

__device__ __forceinline__ P2 twice(P2 x) {
  return {mf::mul(2.0f, x.p), mf::mul(2.0f, x.e)};
}

__global__ void __launch_bounds__(kThreads, 1)
rescan4_kernel(const int8_t* __restrict__ q1a, const int8_t* __restrict__ q2a,
               const float* __restrict__ a1h, const float* __restrict__ ra,
               const int8_t* __restrict__ q1b, const int8_t* __restrict__ q2b,
               const float* __restrict__ rb, const float* __restrict__ ab,
               const float* __restrict__ row_pack,
               const float* __restrict__ col_pack,
               const float* __restrict__ vox, float* __restrict__ cmin,
               int* __restrict__ cidx, int S, int N1p, int N2pb, int n2,
               int n3, int n4, int NR, int NC, int NV, int nrow, int ncol,
               int nvox, float tol) {
  extern __shared__ float dyn[];
  float* srow = dyn;                      // [nrow][TM]
  float* scol = srow + nrow * TM;         // [ncol][TN]
  float* svox = scol + ncol * TN;         // [nvox]
  float* sr1x = svox + nvox;              // [nx][kThreads]
  __shared__ mf::GramDfSmem<TN> gsm;
  __shared__ float sres[TM][TN + 1];
  __shared__ int sidx[TM][TN + 1];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const int nx = n3 + n4, ns = n3 * n4;

  // pack layout offsets (ops/rescan._df4_hoists)
  const int r_ldl = 12 + 12 * nx, r_res1 = r_ldl + 16 * ns;
  const int r_ok = r_res1 + 1, r_row0 = r_ok + 3 * ns;
  const int c_x0 = 16, c_l23 = c_x0 + 24 * nx, c_ldl = c_l23 + 4 * n3;
  const int c_res2 = c_ldl + 12 * ns, c_col0 = c_res2 + 1;
  const int v_x0 = 4, v_s0 = v_x0 + 6 * nx, v_fix0 = v_s0 + 4 * ns;

  for (int k = tid; k < nrow * TM; k += kThreads) {
    srow[k] = row_pack[((size_t)b * NR + k / TM) * N1p + row0 + k % TM];
  }
  for (int k = tid; k < ncol * TN; k += kThreads) {
    scol[k] = col_pack[((size_t)b * NC + k / TN) * N2pb + col0 + k % TN];
  }
  for (int k = tid; k < nvox; k += kThreads) svox[k] = vox[(size_t)b * NV + k];

  PS g[2][CN];
  mf::gram_df_tile<TN>(q1a, q2a, a1h, ra, q1b, q2b, rb, ab, b, S, N1p, N2pb,
                       row0, col0, gsm, g);

  const PS w_ = {svox[0], svox[1], svox[2], svox[3]};
  const float wf = w_.hi;
  float* r1x = sr1x + tid;                // r1x[x * kThreads]

  #pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const int i = ty * 2 + r;
    const float* R = srow + i;            // R[k * TM]: row-pack entry k
    auto rp = [&](int k) {
      return PS{R[k * TM], R[(k + 1) * TM], R[(k + 2) * TM], R[(k + 3) * TM]};
    };
    #pragma unroll 1
    for (int c = 0; c < CN; ++c) {
      const int j = tx + 16 * c;
      const float* C = scol + j;          // C[k * TN]: column-pack entry k
      auto cp = [&](int k) {
        return PS{C[k * TN], C[(k + 1) * TN], C[(k + 2) * TN],
                  C[(k + 3) * TN]};
      };
      const PS a_ps = g[r][c];
      const PS d1 = rp(0), p_ = rp(4), p2 = rp(8);
      const PS d2 = cp(0), q_ = cp(4), q2 = cp(8), d2w = cp(12);
      const float d1f = d1.hi, pf = p_.hi, d2f = d2.hi, qf = q_.hi;
      const float af = a_ps.hi;

      const P2 a2 = mul_ps(a_ps, a_ps);
      const PS a2_ps = mf::presplit(mf::fast_two_sum(a2.p, a2.e));
      const P2 pq = mul_ps(p_, q_);
      const PS pq_ps = mf::presplit(mf::fast_two_sum(pq.p, pq.e));

      // ---- base: {1,2} (unconstrained-sign feasibility), row/col/empty
      float base;
      {
        const P2 apq = mul_ps(a_ps, pq_ps);
        const P2 parts[5] = {mul_ps(d1, d2w), mf::neg(mul_ps(a2_ps, w_)),
                             twice(apq), mf::neg(mul_ps(d1, q2)),
                             mf::neg(mul_ps(p2, d2))};
        const float num12 = mf::acc(parts);
        const float det2 = mf::sub(mf::mul(d1f, d2f), mf::mul(af, af));
        const float n1w = mf::sub(mf::mul(d2f, pf), mf::mul(af, qf));
        const float n2w = mf::sub(mf::mul(d1f, qf), mf::mul(af, pf));
        const bool feas12 = (det2 > mf::mul(mf::mul(tol, d1f), d2f)) &&
                            (n1w >= 0.0f) && (n2w >= 0.0f);
        const float r12 = feas12 ? mf::dv(num12, det2) : mf::kInf;
        base = mf::jmin(mf::nan_to_inf(r12), R[r_res1 * TM]);
        base = mf::jmin(base, C[c_res2 * TN]);
        base = mf::jmin(base, wf);
      }
      // U1 = q^2 - d2*w (column-level, X-independent)
      const PS U1_ps = mf::presplit(mf::df_add({q2.hi, q2.lo},
                                               {-d2w.hi, -d2w.lo}));

      // ---- supports {1,2,X} per extra column X (i3's first, then i4's)
      #pragma unroll 1
      for (int x = 0; x < nx; ++x) {
        const PS bX = rp(12 + 12 * x), bX2 = rp(16 + 12 * x);
        const PS bXp = rp(20 + 12 * x);
        const int cx = c_x0 + 24 * x;
        const PS U2X = cp(cx), U3X = cp(cx + 4), U4X = cp(cx + 8);
        const PS V1X = cp(cx + 12), V2X = cp(cx + 16), cX = cp(cx + 20);
        const int vx = v_x0 + 6 * x;
        const PS C2X = {svox[vx], svox[vx + 1], svox[vx + 2], svox[vx + 3]};
        const float dXf = svox[vx + 4], rXf = svox[vx + 5];
        const P2 m1 = mul_ps(bX, V1X), m2 = mul_ps(p_, V2X);
        const P2 st = mf::two_sum(m1.p, m2.p);
        const PS s_ps = mf::presplit(
            mf::fast_two_sum(st.p, mf::add(mf::add(st.e, m1.e), m2.e)));
        const P2 parts[6] = {mul_ps(bX2, U1_ps), mul_ps(bXp, U2X),
                             mul_ps(d1, U3X), mul_ps(p2, U4X),
                             mul_ps(a_ps, s_ps), mul_ps(a2_ps, C2X)};
        const float det4 = mf::acc(parts);
        const float bf = bX.hi, cfX = cX.hi;
        using mf::add;
        using mf::mul;
        using mf::sub;
        const float det3 =
            add(sub(mul(d1f, sub(mul(d2f, dXf), mul(cfX, cfX))),
                    mul(af, sub(mul(af, dXf), mul(cfX, bf)))),
                mul(bf, sub(mul(af, cfX), mul(d2f, bf))));
        const float D1 =
            add(sub(mul(pf, sub(mul(d2f, dXf), mul(cfX, cfX))),
                    mul(qf, sub(mul(af, dXf), mul(cfX, bf)))),
                mul(rXf, sub(mul(af, cfX), mul(d2f, bf))));
        const float D2 =
            sub(add(mul(-pf, sub(mul(af, dXf), mul(bf, cfX))),
                    mul(qf, sub(mul(d1f, dXf), mul(bf, bf)))),
                mul(rXf, sub(mul(d1f, cfX), mul(af, bf))));
        const float D3 =
            add(sub(mul(pf, sub(mul(af, cfX), mul(bf, d2f))),
                    mul(qf, sub(mul(d1f, cfX), mul(bf, af)))),
                mul(rXf, sub(mul(d1f, d2f), mul(af, af))));
        const bool feas = (det3 > mul(mul(mul(tol, d1f), d2f), dXf)) &&
                          (D1 >= 0.0f) && (D2 >= 0.0f) && (D3 >= 0.0f);
        r1x[x * kThreads] = mf::nan_to_inf(feas ? mf::dv(det4, det3)
                                                : mf::kInf);
      }

      // ---- sweeps: {1,2,3,4} LDL' finish + per-sweep folds ----
      float best = mf::kInf;
      int best_s = 0;
      #pragma unroll 1
      for (int s = 0; s < ns; ++s) {
        const int i3 = s / n4, i4 = s - i3 * n4;
        const PS b3ps = rp(12 + 12 * i3);
        const PS L23 = cp(c_l23 + 4 * i3);
        const int rl = r_ldl + 16 * s, cl = c_ldl + 12 * s;
        const PS e4r = rp(rl), kap1 = rp(rl + 4), invD1h = rp(rl + 8);
        const PS rho1 = rp(rl + 12);
        const PS L24 = cp(cl), d2r = cp(cl + 4), q2r = cp(cl + 8);
        const float ok34s = svox[v_s0 + 4 * s], u3fs = svox[v_s0 + 4 * s + 1];
        const float u4fs = svox[v_s0 + 4 * s + 2];
        const float L43fs = svox[v_s0 + 4 * s + 3];
        const float rowoks = R[(r_ok + 3 * s) * TM];
        const float L13fs = R[(r_ok + 3 * s + 1) * TM];
        const float L14fs = R[(r_ok + 3 * s + 2) * TM];

        const P2 m1 = mul_ps(b3ps, L23), m2 = mul_ps(e4r, L24);
        P2 t = mf::two_sum(af, -m1.p);
        const float lo = mf::sub(mf::add(a_ps.lo, t.e), m1.e);
        t = mf::two_sum(t.p, -m2.p);
        const P2 NUM = mf::fast_two_sum(t.p, mf::sub(mf::add(lo, t.e), m2.e));
        const PS NUM_ps = mf::presplit(NUM);
        const P2 n2d = mul_ps(NUM_ps, NUM_ps);
        const PS n2_ps = mf::presplit(mf::fast_two_sum(n2d.p, n2d.e));
        const P2 tD = mul_ps(n2_ps, invD1h);
        t = mf::two_sum(d2r.hi, -tD.p);
        const P2 D2h =
            mf::fast_two_sum(t.p, mf::sub(mf::add(d2r.lo, t.e), tD.e));
        const bool pointok = D2h.p > mf::mul(tol, d2f);
        const float D2hs_hi = pointok ? D2h.p : 1.0f;
        const float D2hs_lo = pointok ? D2h.e : 0.0f;
        const P2 uK = mul_ps(NUM_ps, kap1);
        t = mf::two_sum(q2r.hi, -uK.p);
        const P2 pi2 =
            mf::fast_two_sum(t.p, mf::sub(mf::add(q2r.lo, t.e), uK.e));
        const PS pi2_ps = mf::presplit(pi2);
        const P2 p2q = mul_ps(pi2_ps, pi2_ps);
        const P2 p2q_df = mf::fast_two_sum(p2q.p, p2q.e);
        // double-float division (dfscan._df_div, inlined)
        const float q0 = mf::dv(p2q_df.p, D2hs_hi);
        const P2 pe = mf::two_prod(q0, D2hs_hi);
        const float r_hi =
            mf::sub(mf::add(mf::sub(mf::sub(p2q_df.p, pe.p), pe.e), p2q_df.e),
                    mf::mul(q0, D2hs_lo));
        const P2 div = mf::fast_two_sum(q0, mf::dv(r_hi, D2hs_hi));
        t = mf::two_sum(rho1.hi, -div.p);
        const float res1234 =
            mf::add(t.p, mf::sub(mf::add(rho1.lo, t.e), div.e));
        const float pi2f = pi2.p;
        const float wb2 = mf::dv(pi2f, D2hs_hi);
        const float L21f = mf::mul(NUM.p, invD1h.hi);
        const float wb1 = mf::sub(kap1.hi, mf::mul(L21f, wb2));
        const float we4 =
            mf::sub(mf::sub(u4fs, mf::mul(L14fs, wb1)), mf::mul(L24.hi, wb2));
        const float we3 = mf::sub(
            mf::sub(mf::sub(u3fs, mf::mul(L43fs, we4)), mf::mul(L13fs, wb1)),
            mf::mul(L23.hi, wb2));
        const bool feasF = (ok34s > 0.5f) && (rowoks > 0.5f) && pointok &&
                           (pi2f >= 0.0f) && (wb1 >= 0.0f) && (we4 >= 0.0f) &&
                           (we3 >= 0.0f);
        const float r1234 = feasF ? mf::nan_to_inf(res1234) : mf::kInf;

        float res_s = mf::jmin(base, r1x[i3 * kThreads]);
        res_s = mf::jmin(res_s, r1x[(n3 + i4) * kThreads]);
        res_s = mf::jmin(res_s, r1234);
        res_s = mf::jmin(res_s, R[(r_row0 + s) * TM]);
        res_s = mf::jmin(res_s, C[(c_col0 + s) * TN]);
        res_s = mf::jmin(res_s, svox[v_fix0 + s]);
        res_s = mf::nan_to_inf(res_s);
        if (res_s < best) {
          best = res_s;
          best_s = s;
        }
      }
      const int col = col0 + j;
      sres[i][j] = col < n2 ? best : mf::kInf;
      sidx[i][j] = col * ns + best_s;
    }
  }
  __syncthreads();

  // per (row, column tile): minimum and the first flat index holding it
  // (flat indices grow with the column)
  if (tid < TM) {
    const int i = tid;
    float m = sres[i][0];
    for (int k = 1; k < TN; ++k) m = fminf(m, sres[i][k]);
    int first = 1 << 30;
    for (int k = TN - 1; k >= 0; --k) {
      if (sres[i][k] == m) first = sidx[i][k];
    }
    const size_t o = ((size_t)b * N1p + row0 + i) * (N2pb / TN) + col0 / TN;
    cmin[o] = m;
    cidx[o] = first;
  }
}

}  // namespace

extern "C" int mf_rescan4(const int8_t* q1a, const int8_t* q2a,
                          const float* a1h, const float* ra,
                          const int8_t* q1b, const int8_t* q2b,
                          const float* rb, const float* ab,
                          const float* row_pack, const float* col_pack,
                          const float* vox, float* cmin, int* cidx, int B,
                          int S, int N1p, int N2pb, int n2, int n3, int n4,
                          int NR, int NC, int NV, float tol,
                          cudaStream_t stream) {
  const int nx = n3 + n4, ns = n3 * n4;
  const int nrow = 12 + 12 * nx + 20 * ns + 1;
  const int ncol = 16 + 24 * nx + 4 * n3 + 13 * ns + 1;
  const int nvox = 4 + 6 * nx + 5 * ns;
  if (N1p % TM || N2pb % TN || n3 < 1 || n4 < 1 || NR < nrow ||
      NC < ncol || NV < nvox) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem =
      (nrow * TM + ncol * TN + nvox + nx * kThreads) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rescan4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N2pb / TN, N1p / TM, B);
  rescan4_kernel<<<grid, kThreads, smem, stream>>>(
      q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox, cmin,
      cidx, S, N1p, N2pb, n2, n3, n4, NR, NC, NV, nrow, ncol, nvox, tol);
  return (int)cudaGetLastError();
}
