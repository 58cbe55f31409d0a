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
// What bounds it on an H100: the per-point chains of explicitly rounded
// float32 operations (about 120 for the base, 173 per extra column and 145
// per sweep, a fused multiply-add counted as 2: ~3,500 at E = 10; ~4,700
// with Dekker products), each a long dependent run of two_sum /
// fast_two_sum / product steps, so the float32 pipe waits on its own
// latency unless many chains are in flight; and the Gram tile, shared with
// kernel 3 (gram_df.cuh: 4 int8 and 2 float64 multiply-adds per sample and
// point, on the tensor cores). The design, for this card:
//   * every product of double-float values is mul_df_fma / two_prod_fma of
//     df32.cuh: the error of the rounded product by one fused multiply-add
//     instead of the Dekker form on presplit halves. Every add, subtract and
//     divide keeps its place and order, so the result is the plain
//     version's (ops/rescan.rescan4_twin) bit for bit unless a product is
//     below ~4e-31;
//   * the packs keep their layout in device memory, (hi, lo, hh, hl) a
//     double-float value, but the kernel never reads the halves hh, hl: it
//     stages (hi, lo) only (PackMap below; ops/rescan.py holds the same map
//     for the CPU tests), 193 + 213 entries a 32 x 32 block at E = 10
//     instead of 345 + 415, so two blocks share an SM (128 registers a
//     thread, no spills);
//   * a thread owns the 2 x 2 points that the Gram tile's mma layout leaves
//     it (two neighbouring rows, two neighbouring columns) and runs the two
//     columns of a row through the loops together:
//     two independent chains whose latencies hide under each other (with one
//     block an SM the same code is slower than the Dekker kernel was: the
//     chains are bound by latency, not by their operation count);
//   * the packs are copied with cp.async before the Gram tile starts and
//     join its first chunk of copies;
//   * the sweep loop stays rolled (the TPU kernel unrolled the ns sweeps
//     over whole tiles in 100 MB of VMEM), best/best_s in registers and the
//     point's nx extra-column residuals in a per-thread slice of shared
//     memory, which lies over the Gram tile's buffers (free by then), as
//     does the tile of results: two blocks an SM still fit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "df32.cuh"
#include "gram_df.cuh"

namespace {

constexpr int TM = mf::kDfTM, TN = 32, CN = TN / 16;
constexpr int kThreads = mf::kDfThreads;
static_assert(CN == 2 && TN / 32 == 1,
              "a thread owns 2 x 2 points: at.row(r), at.col(0, c)");

// Bytes of the region that first holds the Gram tile's buffers and then the
// per-thread extra-column residuals [CN][nx][kThreads] and the tile of
// results (minimum and flat index, [TM][TN + 1] each).
__host__ __device__ inline int scratch_bytes(int nx) {
  const int after =
      (CN * nx * kThreads + 2 * TM * (TN + 1)) * (int)sizeof(float);
  const int gram = (int)sizeof(mf::GramDfSmem<TN>);
  return ((after > gram ? after : gram) + 15) & ~15;
}

using mf::P2;
using mf::mul_df_fma;

__device__ __forceinline__ P2 twice(P2 x) {
  return {mf::mul(2.0f, x.p), mf::mul(2.0f, x.e)};
}

// The staged (short) layout of a row or column pack. The pack's first
// `quad` entries are (hi, lo, hh, hl) quadruples, of which (hi, lo) are
// staged; the other n - quad entries are single floats.
struct PackMap {
  int quad, n;
  __host__ __device__ int slots() const { return quad / 2 + (n - quad); }
  // slot of pack entry e: hi or lo of a quadruple, or a single float
  __device__ int slot(int e) const {
    return e < quad ? (e >> 2) * 2 + (e & 3) : quad / 2 + (e - quad);
  }
  // pack entry held by slot s
  __device__ int entry(int s) const {
    return s < quad / 2 ? (s >> 1) * 4 + (s & 1) : quad + (s - quad / 2);
  }
};

// The voxel vector: the quadruple w, then per extra column x the quadruple
// C2X and two floats, then 5 ns floats; staged as w's (hi, lo), per x
// (hi, lo, dX, rX), and the floats.
struct VoxMap {
  int nx, n;
  __host__ __device__ int slots() const { return n - 2 - 2 * nx; }
  __device__ int slot(int e) const {
    if (e < 4) return e;
    if (e < 4 + 6 * nx) {
      const int x = (e - 4) / 6, k = (e - 4) % 6;
      return 2 + 4 * x + (k < 2 ? k : k - 2);
    }
    return e - 2 - 2 * nx;
  }
  __device__ int entry(int s) const {
    if (s < 2) return s;
    if (s < 2 + 4 * nx) {
      const int x = (s - 2) / 4, k = (s - 2) % 4;
      return 4 + 6 * x + (k < 2 ? k : k + 2);
    }
    return s + 2 + 2 * nx;
  }
};

// what a column's chain carries from the base through the loops
struct Chain {
  const float* C;     // C[slot * TN]: the column's staged pack
  P2 a_, a2_, U1;     // Gram entry, its square, q^2 - d2 w
  float d2f, qf, base, best;
  int best_s;
};

// two blocks an SM: at most 128 registers a thread
__global__ void __launch_bounds__(kThreads, 2)
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
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const int nx = n3 + n4, ns = n3 * n4;

  // pack layout offsets (ops/rescan._df4_hoists)
  const int r_ldl = 12 + 12 * nx, r_res1 = r_ldl + 16 * ns;
  const int r_ok = r_res1 + 1, r_row0 = r_ok + 3 * ns;
  const int c_x0 = 16, c_l23 = c_x0 + 24 * nx, c_ldl = c_l23 + 4 * n3;
  const int c_res2 = c_ldl + 12 * ns, c_col0 = c_res2 + 1;
  const int v_x0 = 4, v_s0 = v_x0 + 6 * nx, v_fix0 = v_s0 + 4 * ns;
  const PackMap rmap = {r_res1, nrow}, cmap = {c_res2, ncol};
  const VoxMap vmap = {nx, nvox};

  extern __shared__ __align__(16) unsigned char dyn[];
  mf::GramDfSmem<TN>& gsm = *reinterpret_cast<mf::GramDfSmem<TN>*>(dyn);
  float* sr1x = reinterpret_cast<float*>(dyn);    // [CN][nx][kThreads]
  float (*sres)[TN + 1] =
      reinterpret_cast<float (*)[TN + 1]>(sr1x + CN * nx * kThreads);
  int (*sidx)[TN + 1] = reinterpret_cast<int (*)[TN + 1]>(sres + TM);
  float* srow = reinterpret_cast<float*>(dyn + scratch_bytes(nx));
                                              // [rmap.slots()][TM]
  float* scol = srow + rmap.slots() * TM;     // [cmap.slots()][TN]
  float* svox = scol + cmap.slots() * TN;     // [vmap.slots()]

  // the packs, 16 bytes a copy: they join the Gram tile's first chunk
  for (int k = tid; k < rmap.slots() * (TM / 4); k += kThreads) {
    const int s = k / (TM / 4), part = 4 * (k % (TM / 4));
    mf::copy16_async(srow + s * TM + part,
                     row_pack + ((size_t)b * NR + rmap.entry(s)) * N1p +
                         row0 + part);
  }
  for (int k = tid; k < cmap.slots() * (TN / 4); k += kThreads) {
    const int s = k / (TN / 4), part = 4 * (k % (TN / 4));
    mf::copy16_async(scol + s * TN + part,
                     col_pack + ((size_t)b * NC + cmap.entry(s)) * N2pb +
                         col0 + part);
  }
  for (int s = tid; s < vmap.slots(); s += kThreads) {
    mf::copy4_async(svox + s, vox + (size_t)b * NV + vmap.entry(s));
  }

  P2 g[2][1][CN];
  const mf::GramDfAt<TN> at = mf::gram_df_tile<TN>(
      q1a, q2a, a1h, ra, q1b, q2b, rb, ab, b, S, N1p, N2pb, row0, col0, gsm,
      g);

  auto vf = [&](int e) { return svox[vmap.slot(e)]; };
  auto vp = [&](int e) { return P2{vf(e), vf(e + 1)}; };
  const P2 w_ = vp(0);
  const float wf = w_.p;
  float* r1x = sr1x + tid;       // r1x[(c * nx + x) * kThreads]

  #pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const int i = at.row(r);
    const float* R = srow + i;
    // row-pack entry e (a single float), the double-float value at e
    auto rf = [&](int e) { return R[rmap.slot(e) * TM]; };
    auto rp = [&](int e) { return P2{rf(e), rf(e + 1)}; };
    const P2 d1 = rp(0), p_ = rp(4), p2 = rp(8);
    const float d1f = d1.p, pf = p_.p;
    // the row's CN columns run through the loops together: independent
    // chains, so one's latency hides under the other's
    Chain ch[CN];
    #pragma unroll
    for (int c = 0; c < CN; ++c) {
      Chain& k = ch[c];
      k.C = scol + at.col(0, c);
      auto cf = [&](int e) { return k.C[cmap.slot(e) * TN]; };
      auto cp = [&](int e) { return P2{cf(e), cf(e + 1)}; };
      k.a_ = r ? g[1][0][c] : g[0][0][c];
      const P2 d2 = cp(0), q_ = cp(4), q2 = cp(8), d2w = cp(12);
      const float d2f = d2.p, qf = q_.p, af = k.a_.p;
      k.d2f = d2f;
      k.qf = qf;
      const P2 a2 = mul_df_fma(k.a_, k.a_);
      k.a2_ = mf::fast_two_sum(a2.p, a2.e);
      const P2 pq = mul_df_fma(p_, q_);
      const P2 pq_ = mf::fast_two_sum(pq.p, pq.e);

      // ---- base: {1,2} (unconstrained-sign feasibility), row/col/empty
      const P2 apq = mul_df_fma(k.a_, pq_);
      const P2 parts[5] = {mul_df_fma(d1, d2w),
                           mf::neg(mul_df_fma(k.a2_, w_)), twice(apq),
                           mf::neg(mul_df_fma(d1, q2)),
                           mf::neg(mul_df_fma(p2, d2))};
      const float num12 = mf::acc(parts);
      const float det2 = mf::sub(mf::mul(d1f, d2f), mf::mul(af, af));
      const float n1w = mf::sub(mf::mul(d2f, pf), mf::mul(af, qf));
      const float n2w = mf::sub(mf::mul(d1f, qf), mf::mul(af, pf));
      const bool feas12 = (det2 > mf::mul(mf::mul(tol, d1f), d2f)) &&
                          (n1w >= 0.0f) && (n2w >= 0.0f);
      const float r12 = feas12 ? mf::dv(num12, det2) : mf::kInf;
      k.base = mf::jmin(mf::nan_to_inf(r12), rf(r_res1));
      k.base = mf::jmin(k.base, cf(c_res2));
      k.base = mf::jmin(k.base, wf);
      // U1 = q^2 - d2*w (column-level, X-independent)
      k.U1 = mf::df_add(q2, mf::neg(d2w));
      k.best = mf::kInf;
      k.best_s = 0;
    }

    // ---- supports {1,2,X} per extra column X (i3's first, then i4's)
    #pragma unroll 1
    for (int x = 0; x < nx; ++x) {
      const P2 bX = rp(12 + 12 * x), bX2 = rp(16 + 12 * x);
      const P2 bXp = rp(20 + 12 * x);
      const int cx = c_x0 + 24 * x;
      const int vx = v_x0 + 6 * x;
      const P2 C2X = vp(vx);
      const float dXf = vf(vx + 4), rXf = vf(vx + 5);
      const float bf = bX.p;
      #pragma unroll
      for (int c = 0; c < CN; ++c) {
        const Chain& k = ch[c];
        auto cp = [&](int e) {
          return P2{k.C[cmap.slot(e) * TN], k.C[cmap.slot(e + 1) * TN]};
        };
        const float af = k.a_.p, d2f = k.d2f, qf = k.qf;
        const P2 U2X = cp(cx), U3X = cp(cx + 4), U4X = cp(cx + 8);
        const P2 V1X = cp(cx + 12), V2X = cp(cx + 16), cX = cp(cx + 20);
        const P2 m1 = mul_df_fma(bX, V1X), m2 = mul_df_fma(p_, V2X);
        const P2 st = mf::two_sum(m1.p, m2.p);
        const P2 s_ =
            mf::fast_two_sum(st.p, mf::add(mf::add(st.e, m1.e), m2.e));
        const P2 parts[6] = {mul_df_fma(bX2, k.U1), mul_df_fma(bXp, U2X),
                             mul_df_fma(d1, U3X),   mul_df_fma(p2, U4X),
                             mul_df_fma(k.a_, s_),  mul_df_fma(k.a2_, C2X)};
        const float det4 = mf::acc(parts);
        const float cfX = cX.p;
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
        r1x[(c * nx + x) * kThreads] =
            mf::nan_to_inf(feas ? mf::dv(det4, det3) : mf::kInf);
      }
    }

    // ---- sweeps: {1,2,3,4} LDL' finish + per-sweep folds ----
    #pragma unroll 1
    for (int s = 0; s < ns; ++s) {
      const int i3 = s / n4, i4 = s - i3 * n4;
      const P2 b3 = rp(12 + 12 * i3);
      const int rl = r_ldl + 16 * s, cl = c_ldl + 12 * s;
      const P2 e4r = rp(rl), kap1 = rp(rl + 4), invD1h = rp(rl + 8);
      const P2 rho1 = rp(rl + 12);
      const float ok34s = vf(v_s0 + 4 * s), u3fs = vf(v_s0 + 4 * s + 1);
      const float u4fs = vf(v_s0 + 4 * s + 2);
      const float L43fs = vf(v_s0 + 4 * s + 3);
      const float rowoks = rf(r_ok + 3 * s);
      const float L13fs = rf(r_ok + 3 * s + 1);
      const float L14fs = rf(r_ok + 3 * s + 2);
      const float rrow = rf(r_row0 + s), rfix = vf(v_fix0 + s);
      #pragma unroll
      for (int c = 0; c < CN; ++c) {
        Chain& k = ch[c];
        auto cf = [&](int e) { return k.C[cmap.slot(e) * TN]; };
        auto cp = [&](int e) { return P2{cf(e), cf(e + 1)}; };
        const float af = k.a_.p, d2f = k.d2f;
        const P2 L23 = cp(c_l23 + 4 * i3);
        const P2 L24 = cp(cl), d2r = cp(cl + 4), q2r = cp(cl + 8);

        const P2 m1 = mul_df_fma(b3, L23), m2 = mul_df_fma(e4r, L24);
        P2 t = mf::two_sum(af, -m1.p);
        const float lo = mf::sub(mf::add(k.a_.e, t.e), m1.e);
        t = mf::two_sum(t.p, -m2.p);
        const P2 NUM =
            mf::fast_two_sum(t.p, mf::sub(mf::add(lo, t.e), m2.e));
        const P2 n2d = mul_df_fma(NUM, NUM);
        const P2 n2_ = mf::fast_two_sum(n2d.p, n2d.e);
        const P2 tD = mul_df_fma(n2_, invD1h);
        t = mf::two_sum(d2r.p, -tD.p);
        const P2 D2h =
            mf::fast_two_sum(t.p, mf::sub(mf::add(d2r.e, t.e), tD.e));
        const bool pointok = D2h.p > mf::mul(tol, d2f);
        const float D2hs_hi = pointok ? D2h.p : 1.0f;
        const float D2hs_lo = pointok ? D2h.e : 0.0f;
        const P2 uK = mul_df_fma(NUM, kap1);
        t = mf::two_sum(q2r.p, -uK.p);
        const P2 pi2 =
            mf::fast_two_sum(t.p, mf::sub(mf::add(q2r.e, t.e), uK.e));
        const P2 p2q = mul_df_fma(pi2, pi2);
        const P2 p2q_df = mf::fast_two_sum(p2q.p, p2q.e);
        // double-float division (dfscan._df_div, inlined)
        const float q0 = mf::dv(p2q_df.p, D2hs_hi);
        const P2 pe = mf::two_prod_fma(q0, D2hs_hi);
        const float r_hi = mf::sub(
            mf::add(mf::sub(mf::sub(p2q_df.p, pe.p), pe.e), p2q_df.e),
            mf::mul(q0, D2hs_lo));
        const P2 div = mf::fast_two_sum(q0, mf::dv(r_hi, D2hs_hi));
        t = mf::two_sum(rho1.p, -div.p);
        const float res1234 =
            mf::add(t.p, mf::sub(mf::add(rho1.e, t.e), div.e));
        const float pi2f = pi2.p;
        const float wb2 = mf::dv(pi2f, D2hs_hi);
        const float L21f = mf::mul(NUM.p, invD1h.p);
        const float wb1 = mf::sub(kap1.p, mf::mul(L21f, wb2));
        const float we4 = mf::sub(mf::sub(u4fs, mf::mul(L14fs, wb1)),
                                  mf::mul(L24.p, wb2));
        const float we3 = mf::sub(
            mf::sub(mf::sub(u3fs, mf::mul(L43fs, we4)),
                    mf::mul(L13fs, wb1)),
            mf::mul(L23.p, wb2));
        const bool feasF = (ok34s > 0.5f) && (rowoks > 0.5f) && pointok &&
                           (pi2f >= 0.0f) && (wb1 >= 0.0f) &&
                           (we4 >= 0.0f) && (we3 >= 0.0f);
        const float r1234 = feasF ? mf::nan_to_inf(res1234) : mf::kInf;

        float res_s = mf::jmin(k.base, r1x[(c * nx + i3) * kThreads]);
        res_s = mf::jmin(res_s, r1x[(c * nx + n3 + i4) * kThreads]);
        res_s = mf::jmin(res_s, r1234);
        res_s = mf::jmin(res_s, rrow);
        res_s = mf::jmin(res_s, cf(c_col0 + s));
        res_s = mf::jmin(res_s, rfix);
        res_s = mf::nan_to_inf(res_s);
        if (res_s < k.best) {
          k.best = res_s;
          k.best_s = s;
        }
      }
    }
    #pragma unroll
    for (int c = 0; c < CN; ++c) {
      const int j = at.col(0, c), col = col0 + j;
      sres[i][j] = col < n2 ? ch[c].best : mf::kInf;
      sidx[i][j] = col * ns + ch[c].best_s;
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
  if (!mf::gram_df_aligned(q1a, q2a, a1h, ra, q1b, q2b, rb, ab) ||
      (((uintptr_t)row_pack | (uintptr_t)col_pack) & 15)) {
    return (int)cudaErrorMisalignedAddress;
  }
  const PackMap rmap = {nrow - 1 - 4 * ns, nrow};
  const PackMap cmap = {ncol - 1 - ns, ncol};
  const VoxMap vmap = {nx, nvox};
  // CN * nx * kThreads residuals lie over the Gram buffers (scratch_bytes)
  const int smem = scratch_bytes(nx) + (rmap.slots() * TM + cmap.slots() * TN +
                                        vmap.slots()) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rescan4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N2pb / TN, N1p / TM, B);
  rescan4_kernel<<<grid, kThreads, smem, stream>>>(
      q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox, cmin,
      cidx, S, N1p, N2pb, n2, n3, n4, NR, NC, NV, nrow, ncol, nvox, tol);
  return (int)cudaGetLastError();
}
