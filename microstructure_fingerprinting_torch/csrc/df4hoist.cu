// Kernel 8: the prologue of the double-float 4-block (EAR) re-scan.
//
// Counterpart of the JAX package's row_scan_df4 before its pallas_call
// (microstructure_fingerprinting_tpu/ops/pallas_dfscan.py:686-860: quantise,
// Grams, LDL' hoists, packs; XLA fuses them into the jit of the kernel) and
// of its plain version here, ops/rescan.df4_hoist_twin (_df4_hoists). From
// the normalised blocks A1h (B, S, N1p), A2h (B, S, N2), A3h (B, S, 1),
// A4h (B, S, N4) and yh (B, S) it writes kernel 5's operands: the int8
// levels and float32 planes of both blocks (q1a, q2a, ra; q1b, q2b, rb, ab,
// the columns past N2 zero), row_pack (B, NR, N1p), col_pack (B, NC, N2pb)
// (zero past N2, as the plain version pads after its chain) and vox (B, NV),
// in the layout that kernel 5 reads (csrc/rescan4.cu; ops/rescan
// .df4_pack_sizes). a1h is A1h itself.
//
// What bounds it on an H100: bytes. Each block reads its atoms once and
// writes their levels, planes and packs once (~2 GB a 512-voxel chunk at
// R = 256); per atom and sample 2 + N4 Grams of 4 int32 multiply-adds and 2
// float64 fused multiply-adds; per atom a chain of ~1,700 float32 operations
// for each of the N4 sweeps. The plain version unrolls the N4 sweeps and
// the 1 + N4 extra columns in Python, each double-float operation several
// torch kernels of a few microseconds: ~16,000 kernels a call. The design,
// for this card (the skeleton in hoist.cuh):
//   * one launch a call: blocks 0 .. N1p/128 - 1 own 128 rows of A1 of one
//     voxel, the next ones 128 columns of A2; a thread one atom;
//   * every block sums the voxel's 3 + 3 N4 small Grams (w, d3, r3, d4, r4,
//     g34), one a thread in sample order, so all blocks of a voxel agree,
//     then computes the voxel's LDL' factors and the parts of the
//     {1, 2, 3, 4}-less sub-supports that do not depend on the atom (the
//     expansion of dfscan._sub3_df in B = CSF, C = EAR column) into shared
//     memory, one EAR column a thread; the first block writes vox;
//   * the atom's own Grams stay in registers through the pass; the EAR ones
//     go to shared memory for the chain, which runs one sweep at a time and
//     writes each pack entry straight to device memory (coalesced: the atom
//     axis is the pack's contiguous one).
// Every operation mirrors the plain version's, in Dekker's forms and its
// operand order (a Dekker product's error term depends on it), the
// minimum as torch.minimum (hoist::tmin): bit for bit, NaN included (an
// all-zero padded atom gives res1 = 0/0), but for the float64 cross sums'
// order (testing.kernel_agreement).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hoist.cuh"

namespace {

using mf::df_add;
using mf::df_div;
using mf::df_mul;
using mf::neg;
using mf::P2;
using mf::scale;
using mf::val;
using mf::hoist::kAtoms;

// the most EAR columns a call takes
constexpr int kMaxE = 16;

// dfscan._sub1_df: support {a}
__device__ float sub1(P2 d, P2 p, P2 w) {
  const float num = val(df_add(df_mul(d, w), neg(df_mul(p, p))));
  const float res = mf::dv(num, val(d));
  return val(p) >= 0.0f ? res : mf::kInf;
}

// dfscan._sub2_df: support {a, b}
__device__ float sub2(P2 dA, P2 dB, P2 g, P2 pA, P2 pB, P2 w, float tol) {
  const float det2 = val(df_add(df_mul(dA, dB), neg(df_mul(g, g))));
  const P2 nt[5] = {df_mul(df_mul(dA, dB), w), neg(df_mul(df_mul(g, g), w)),
                    scale(df_mul(df_mul(g, pA), pB), 2.0f),
                    neg(df_mul(df_mul(dA, pB), pB)),
                    neg(df_mul(df_mul(dB, pA), pA))};
  const float num = mf::acc(nt);
  const P2 n1t[2] = {df_mul(dB, pA), neg(df_mul(g, pB))};
  const P2 n2t[2] = {df_mul(dA, pB), neg(df_mul(g, pA))};
  const float n1 = mf::acc(n1t), n2 = mf::acc(n2t);
  const bool feas = det2 > mf::mul(mf::mul(tol, val(dA)), val(dB)) &&
                    n1 >= 0.0f && n2 >= 0.0f;
  return feas ? mf::dv(num, det2) : mf::kInf;
}

// The voxel's values for EAR column j: its Grams, the LDL' factors of
// ops/rescan._df4_hoists and the parts of dfscan._sub3_df with B = the CSF
// column, C = EAR column j (U1 .. V2, C2 and _det3_cramer_df's X), which
// every atom's {A, 3, 4} support shares.
struct VoxJ {
  P2 d4, r4, g34, L43, invD4h, t4, rho34;
  P2 U1, U2, U3, U4, V1, V2, C2, X;
};

__device__ VoxJ vox_factors(P2 w, P2 d3, P2 r3, P2 invd3, P2 d4, P2 r4,
                            P2 g34, float tol, bool& ok34, float& u4f) {
  const P2 one = {1.0f, 0.0f};
  VoxJ v;
  v.d4 = d4;
  v.r4 = r4;
  v.g34 = g34;
  v.L43 = df_mul(g34, invd3);
  const P2 D4h = df_add(d4, neg(df_mul(g34, v.L43)));
  ok34 = val(D4h) > mf::mul(tol, val(d4));
  v.invD4h = df_div(one, ok34 ? D4h : one);
  v.t4 = df_add(r4, neg(df_mul(v.L43, r3)));
  v.rho34 = df_add(df_add(w, neg(df_mul(df_mul(r3, r3), invd3))),
                   neg(df_mul(df_mul(v.t4, v.t4), v.invD4h)));
  u4f = val(df_mul(v.t4, v.invD4h));
  // _sub3_df(dA, dB = d3, dC = d4, gAB, gAC, gBC = g34, pA, pB = r3,
  // pC = r4, w): what does not involve A
  const P2 dB = d3, dC = d4, gBC = g34, pB = r3, pC = r4;
  v.U1 = df_add(df_mul(pB, pB), neg(df_mul(dB, w)));
  v.U2 = scale(df_add(df_mul(dB, pC), neg(df_mul(gBC, pB))), 2.0f);
  v.U3 = df_add(
      df_add(df_add(df_mul(dB, df_add(df_mul(dC, w), neg(df_mul(pC, pC)))),
                    neg(df_mul(dC, df_mul(pB, pB)))),
             scale(df_mul(df_mul(gBC, pB), pC), 2.0f)),
      neg(df_mul(df_mul(gBC, gBC), w)));
  v.U4 = df_add(df_mul(gBC, gBC), neg(df_mul(dB, dC)));
  v.V1 = scale(df_add(df_mul(gBC, w), neg(df_mul(pB, pC))), 2.0f);
  v.V2 = scale(df_add(df_mul(dC, pB), neg(df_mul(gBC, pC))), 2.0f);
  v.C2 = df_add(df_mul(pC, pC), neg(df_mul(dC, w)));
  v.X = df_add(df_mul(dB, dC), neg(df_mul(gBC, gBC)));
  return v;
}

// dfscan._sub3_df(dA, d3, d4, gAB, gAC, g34, pA, r3, r4, w): support
// {A, 3, 4}, with the voxel's parts of EAR column j
__device__ float sub3(P2 dA, P2 gAB, P2 gAC, P2 pA, P2 dB, P2 pB,
                      const VoxJ& v, float tol) {
  const P2 dC = v.d4, gBC = v.g34, pC = v.r4;
  const P2 dt[6] = {df_mul(df_mul(gAC, gAC), v.U1),
                    df_mul(df_mul(gAC, pA), v.U2), df_mul(dA, v.U3),
                    df_mul(df_mul(pA, pA), v.U4),
                    df_mul(gAB, df_add(df_mul(gAC, v.V1), df_mul(pA, v.V2))),
                    df_mul(df_mul(gAB, gAB), v.C2)};
  const float det4 = mf::acc(dt);
  // _det3_cramer_df
  const P2 Z = df_add(df_mul(gAB, dC), neg(df_mul(gBC, gAC)));
  const P2 W = df_add(df_mul(gAB, gBC), neg(df_mul(dB, gAC)));
  const P2 Y = df_add(df_mul(dA, dC), neg(df_mul(gAC, gAC)));
  const P2 V = df_add(df_mul(dA, gBC), neg(df_mul(gAC, gAB)));
  const P2 T = df_add(df_mul(dA, dB), neg(df_mul(gAB, gAB)));
  const P2 t0[3] = {df_mul(dA, v.X), neg(df_mul(gAB, Z)), df_mul(gAC, W)};
  const P2 t1[3] = {df_mul(pA, v.X), neg(df_mul(pB, Z)), df_mul(pC, W)};
  const P2 t2[3] = {neg(df_mul(pA, Z)), df_mul(pB, Y), neg(df_mul(pC, V))};
  const P2 t3[3] = {df_mul(pA, W), neg(df_mul(pB, V)), df_mul(pC, T)};
  const float det3 = mf::acc(t0), D1 = mf::acc(t1), D2 = mf::acc(t2),
              D3 = mf::acc(t3);
  const bool feas =
      det3 > mf::mul(mf::mul(mf::mul(tol, val(dA)), val(dB)), val(dC)) &&
      D1 >= 0.0f && D2 >= 0.0f && D3 >= 0.0f;
  return feas ? mf::dv(det4, det3) : mf::kInf;
}

// the small columns of voxel b: 0 the signal, 1 the CSF column, 2 + j EAR
// column j
struct Cols {
  const float* y;
  const float* a3;
  const float* a4;
  int n4;
  __device__ float operator()(int c, int s) const {
    return c == 0 ? y[s] : (c == 1 ? a3[s] : a4[(size_t)s * n4 + (c - 2)]);
  }
};

// the voxel Grams a block sums: 0 w = g(y, y), 1 d3 = g(a3, a3),
// 2 r3 = g(a3, y), then for EAR column j: d4 = g(a4j, a4j), r4 = g(a4j, y),
// g34 = g(a3, a4j)
struct Pairs {
  __device__ int2 operator()(int t) const {
    if (t < 3) return t == 0 ? make_int2(0, 0) : make_int2(1, t == 1 ? 1 : 0);
    const int j = (t - 3) / 3, k = (t - 3) % 3;
    return k == 0 ? make_int2(2 + j, 2 + j)
                  : (k == 1 ? make_int2(2 + j, 0) : make_int2(1, 2 + j));
  }
};

template <int E>
struct Smem {
  union {
    mf::hoist::Tile<2 + E> tile;
    P2 g4[E][kAtoms];  // after the pass: each atom's Gram with EAR column j
  };
  P2 vg[3 + 3 * E];
  VoxJ vj[E];
  P2 invd3;
};

template <int E>
__global__ void __launch_bounds__(kAtoms)
df4hoist_kernel(const float* __restrict__ A1h, const float* __restrict__ A2h,
                const float* __restrict__ A3h, const float* __restrict__ A4h,
                const float* __restrict__ yh, int8_t* __restrict__ q1a,
                int8_t* __restrict__ q2a, float* __restrict__ ra,
                int8_t* __restrict__ q1b, int8_t* __restrict__ q2b,
                float* __restrict__ rb, float* __restrict__ ab,
                float* __restrict__ row_pack, float* __restrict__ col_pack,
                float* __restrict__ vox, int S, int N1p, int N2, int N2pb,
                int n4, int NR, int NC, int NV, float tol) {
  constexpr int C = 2 + E;
  __shared__ Smem<E> sm;
  const int tid = threadIdx.x, b = blockIdx.y;
  const int n3 = 1, nx = n3 + n4, ns = n3 * n4;

  // pack layout offsets (ops/rescan._df4_hoists)
  const int r_ldl = 12 + 12 * nx, r_res1 = r_ldl + 16 * ns;
  const int r_ok = r_res1 + 1, r_row0 = r_ok + 3 * ns;
  const int c_x0 = 16, c_l23 = c_x0 + 24 * nx, c_ldl = c_l23 + 4 * n3;
  const int c_res2 = c_ldl + 12 * ns, c_col0 = c_res2 + 1;
  const int v_x0 = 4, v_s0 = v_x0 + 6 * nx, v_fix0 = v_s0 + 4 * ns;
  const int nrow = r_row0 + ns, ncol = c_col0 + ns, nvox = v_fix0 + ns;

  const int row_blocks = N1p / kAtoms;
  const bool is_row = blockIdx.x < row_blocks;
  const int i = (is_row ? blockIdx.x : blockIdx.x - row_blocks) * kAtoms + tid;
  const int width = is_row ? N1p : N2;    // atoms of the block's input
  const int padded = is_row ? N1p : N2pb; // atoms of its outputs
  const bool live = i < padded, real = i < width;

  const size_t vS = (size_t)b * S;
  const Cols cols = {yh + vS, A3h + vS, A4h + vS * n4, n4};
  const float* atom = (is_row ? A1h : A2h) + vS * width + i;
  const size_t oo = vS * padded + i;
  const mf::hoist::AtomOut out =
      is_row ? mf::hoist::AtomOut{q1a + oo, q2a + oo, ra + oo, nullptr,
                                  nullptr, (size_t)N1p}
             : mf::hoist::AtomOut{q1b + oo, q2b + oo, rb + oo, ab + oo,
                                  nullptr, (size_t)N2pb};

  mf::hoist::Gram vg = mf::hoist::gram_zero(), self = mf::hoist::gram_zero();
  mf::hoist::Gram g[C];
  #pragma unroll
  for (int c = 0; c < C; ++c) g[c] = mf::hoist::gram_zero();
  mf::hoist::stream<C>(sm.tile, cols, 2 + n4, S, Pairs{}, 3 + 3 * n4, vg,
                       atom, (size_t)width, live, real, out, self, g);
  __syncthreads();  // the tile's memory takes the EAR Grams

  // the atom's Grams: d (itself), p (the signal), b3 (CSF), EAR in sm.g4
  P2 dA = {0.0f, 0.0f}, pA = dA, gA3 = dA;
  if (real) {
    dA = mf::hoist::gram_value(self);
    pA = mf::hoist::gram_value(g[0]);
    gA3 = mf::hoist::gram_value(g[1]);
    #pragma unroll
    for (int c = 2; c < C; ++c) {
      if (c < 2 + n4) sm.g4[c - 2][tid] = mf::hoist::gram_value(g[c]);
    }
  }
  if (tid < 3 + 3 * n4) sm.vg[tid] = mf::hoist::gram_value(vg);
  __syncthreads();

  const P2 w = sm.vg[0], d3 = sm.vg[1], r3 = sm.vg[2];
  float* vx = vox + (size_t)b * NV;
  const bool first = blockIdx.x == 0;
  // the voxel's factors, one EAR column a thread
  if (tid < n4) {
    const int j = tid;
    const P2 one = {1.0f, 0.0f};
    const P2 invd3 = df_div(one, d3);
    bool ok34;
    float u4f;
    const VoxJ v = vox_factors(w, d3, r3, invd3, sm.vg[3 + 3 * j],
                               sm.vg[4 + 3 * j], sm.vg[5 + 3 * j], tol, ok34,
                               u4f);
    sm.vj[j] = v;
    if (j == 0) sm.invd3 = invd3;
    if (first) {
      const float rfix = mf::hoist::tmin(
          mf::hoist::tmin(sub1(d3, r3, w), sub1(v.d4, v.r4, w)),
          sub2(d3, v.d4, v.g34, r3, v.r4, w, tol));
      // extra column x = 1 + j: C2X = r4^2 - d4 w (= the sub-support's C2)
      mf::hoist::put_ps(vx, 1, v_x0 + 6 * (1 + j), v.C2);
      vx[v_x0 + 6 * (1 + j) + 4] = val(v.d4);
      vx[v_x0 + 6 * (1 + j) + 5] = val(v.r4);
      vx[v_s0 + 4 * j] = ok34 ? 1.0f : 0.0f;
      vx[v_s0 + 4 * j + 1] = val(df_mul(r3, invd3));
      vx[v_s0 + 4 * j + 2] = u4f;
      vx[v_s0 + 4 * j + 3] = val(v.L43);
      vx[v_fix0 + j] = rfix;
    }
  }
  if (first && tid == kAtoms - 1) {
    mf::hoist::put_ps(vx, 1, 0, w);
    // extra column x = 0, the CSF column
    mf::hoist::put_ps(vx, 1, v_x0, df_add(df_mul(r3, r3), neg(df_mul(d3, w))));
    vx[v_x0 + 4] = val(d3);
    vx[v_x0 + 5] = val(r3);
    for (int e = nvox; e < NV; ++e) vx[e] = 0.0f;
  }
  __syncthreads();
  if (!live) return;
  const P2 invd3 = sm.invd3;

  if (is_row) {
    float* rp = row_pack + (size_t)b * NR * N1p + i;
    const size_t st = (size_t)N1p;
    const P2 d1 = dA, p = pA, b3 = gA3;
    mf::hoist::put_ps(rp, st, 0, d1);
    mf::hoist::put_ps(rp, st, 4, p);
    mf::hoist::put_ps(rp, st, 8, df_mul(p, p));
    #pragma unroll 1
    for (int x = 0; x < nx; ++x) {
      const P2 bX = x == 0 ? b3 : sm.g4[x - 1][tid];
      mf::hoist::put_ps(rp, st, 12 + 12 * x, bX);
      mf::hoist::put_ps(rp, st, 16 + 12 * x, df_mul(bX, bX));
      mf::hoist::put_ps(rp, st, 20 + 12 * x, df_mul(bX, p));
    }
    const P2 L13 = df_mul(b3, invd3);
    rp[(size_t)r_res1 * st] = sub1(d1, p, w);
    const float s13 = sub2(d1, d3, b3, p, r3, w, tol);
    const P2 one = {1.0f, 0.0f};
    #pragma unroll 1
    for (int j = 0; j < n4; ++j) {
      const VoxJ& v = sm.vj[j];
      const P2 b4 = sm.g4[j][tid];
      const P2 e4r = df_add(b4, neg(df_mul(v.L43, b3)));
      const P2 L14 = df_mul(e4r, v.invD4h);
      const P2 D1h =
          df_add(df_add(d1, neg(df_mul(b3, L13))), neg(df_mul(e4r, L14)));
      const bool rowok = val(D1h) > mf::mul(tol, val(d1));
      const P2 invD1h = df_div(one, rowok ? D1h : one);
      const P2 pi1 = df_add(df_add(p, neg(df_mul(L13, r3))),
                            neg(df_mul(L14, v.t4)));
      const P2 kap1 = df_mul(pi1, invD1h);
      const P2 rho1 = df_add(v.rho34, neg(df_mul(pi1, kap1)));
      mf::hoist::put_ps(rp, st, r_ldl + 16 * j, e4r);
      mf::hoist::put_ps(rp, st, r_ldl + 16 * j + 4, kap1);
      mf::hoist::put_ps(rp, st, r_ldl + 16 * j + 8, invD1h);
      mf::hoist::put_ps(rp, st, r_ldl + 16 * j + 12, rho1);
      rp[(size_t)(r_ok + 3 * j) * st] = rowok ? 1.0f : 0.0f;
      rp[(size_t)(r_ok + 3 * j + 1) * st] = val(L13);
      rp[(size_t)(r_ok + 3 * j + 2) * st] = val(L14);
      rp[(size_t)(r_row0 + j) * st] = mf::hoist::tmin(
          mf::hoist::tmin(s13, sub2(d1, v.d4, b4, p, v.r4, w, tol)),
          sub3(d1, b3, b4, p, d3, r3, v, tol));
    }
    for (int e = nrow; e < NR; ++e) rp[(size_t)e * st] = 0.0f;
    return;
  }

  float* cp = col_pack + (size_t)b * NC * N2pb + i;
  const size_t st = (size_t)N2pb;
  if (!real) {  // a padded column: zeros, as the plain version pads
    for (int e = 0; e < NC; ++e) cp[(size_t)e * st] = 0.0f;
    return;
  }
  const P2 d2 = dA, q = pA, c3 = gA3;
  const P2 q2sq = df_mul(q, q);
  mf::hoist::put_ps(cp, st, 0, d2);
  mf::hoist::put_ps(cp, st, 4, q);
  mf::hoist::put_ps(cp, st, 8, q2sq);
  mf::hoist::put_ps(cp, st, 12, df_mul(d2, w));
  #pragma unroll 1
  for (int x = 0; x < nx; ++x) {
    const P2 dX = x == 0 ? d3 : sm.vj[x - 1].d4;
    const P2 rX = x == 0 ? r3 : sm.vj[x - 1].r4;
    const P2 cX = x == 0 ? c3 : sm.g4[x - 1][tid];
    const int e = c_x0 + 24 * x;
    // U2X
    mf::hoist::put_ps(
        cp, st, e,
        scale(df_add(df_mul(d2, rX), neg(df_mul(cX, q))), 2.0f));
    // U3X
    mf::hoist::put_ps(
        cp, st, e + 4,
        df_add(df_add(df_add(df_mul(d2, df_add(df_mul(dX, w),
                                               neg(df_mul(rX, rX)))),
                             neg(df_mul(dX, q2sq))),
                      scale(df_mul(df_mul(cX, q), rX), 2.0f)),
               neg(df_mul(df_mul(cX, cX), w))));
    // U4X, V1X, V2X, cX
    mf::hoist::put_ps(cp, st, e + 8,
                      df_add(df_mul(cX, cX), neg(df_mul(d2, dX))));
    mf::hoist::put_ps(
        cp, st, e + 12,
        scale(df_add(df_mul(cX, w), neg(df_mul(q, rX))), 2.0f));
    mf::hoist::put_ps(
        cp, st, e + 16,
        scale(df_add(df_mul(dX, q), neg(df_mul(cX, rX))), 2.0f));
    mf::hoist::put_ps(cp, st, e + 20, cX);
  }
  const P2 L23 = df_mul(c3, invd3);
  mf::hoist::put_ps(cp, st, c_l23, L23);
  cp[(size_t)c_res2 * st] = sub1(d2, q, w);
  const float s23 = sub2(d2, d3, c3, q, r3, w, tol);
  #pragma unroll 1
  for (int j = 0; j < n4; ++j) {
    const VoxJ& v = sm.vj[j];
    const P2 c4 = sm.g4[j][tid];
    const P2 e4c = df_add(c4, neg(df_mul(v.L43, c3)));
    const P2 L24 = df_mul(e4c, v.invD4h);
    const P2 d2r =
        df_add(df_add(d2, neg(df_mul(c3, L23))), neg(df_mul(e4c, L24)));
    const P2 q2r =
        df_add(df_add(q, neg(df_mul(L23, r3))), neg(df_mul(L24, v.t4)));
    mf::hoist::put_ps(cp, st, c_ldl + 12 * j, L24);
    mf::hoist::put_ps(cp, st, c_ldl + 12 * j + 4, d2r);
    mf::hoist::put_ps(cp, st, c_ldl + 12 * j + 8, q2r);
    cp[(size_t)(c_col0 + j) * st] = mf::hoist::tmin(
        mf::hoist::tmin(s23, sub2(d2, v.d4, c4, q, v.r4, w, tol)),
        sub3(d2, c3, c4, q, d3, r3, v, tol));
  }
  for (int e = ncol; e < NC; ++e) cp[(size_t)e * st] = 0.0f;
}

template <int E>
int launch(const float* A1h, const float* A2h, const float* A3h,
           const float* A4h, const float* yh, int8_t* q1a, int8_t* q2a,
           float* ra, int8_t* q1b, int8_t* q2b, float* rb, float* ab,
           float* row_pack, float* col_pack, float* vox, int B, int S,
           int N1p, int N2, int N2pb, int n4, int NR, int NC, int NV,
           float tol, cudaStream_t stream) {
  dim3 grid(N1p / kAtoms + (N2pb + kAtoms - 1) / kAtoms, B);
  df4hoist_kernel<E><<<grid, kAtoms, 0, stream>>>(
      A1h, A2h, A3h, A4h, yh, q1a, q2a, ra, q1b, q2b, rb, ab, row_pack,
      col_pack, vox, S, N1p, N2, N2pb, n4, NR, NC, NV, tol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mf_df4hoist(const float* A1h, const float* A2h,
                           const float* A3h, const float* A4h,
                           const float* yh, int8_t* q1a, int8_t* q2a,
                           float* ra, int8_t* q1b, int8_t* q2b, float* rb,
                           float* ab, float* row_pack, float* col_pack,
                           float* vox, int B, int S, int N1p, int N2,
                           int N2pb, int n4, int NR, int NC, int NV,
                           float tol, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  // the pack sizes (ops/rescan.df4_pack_sizes at n3 = 1), padded to 8
  const int n3 = 1, nx = n3 + n4, ns = n3 * n4;
  const int nrow = 12 + 12 * nx + 20 * ns + 1;
  const int ncol = 16 + 24 * nx + 4 * n3 + 13 * ns + 1;
  const int nvox = 4 + 6 * nx + 5 * ns;
  const auto pad8 = [](int n) { return (n + 7) / 8 * 8; };
  if (n4 < 1 || n4 > kMaxE || S < 1 || N1p % kAtoms || N2 < 1 ||
      N2pb < N2 || NR != pad8(nrow) || NC != pad8(ncol) || NV != pad8(nvox)) {
    return (int)cudaErrorInvalidValue;
  }
  // the Gram registers a thread holds: 2 + E of them
  decltype(&launch<4>) run = n4 <= 4    ? &launch<4>
                             : n4 <= 8  ? &launch<8>
                             : n4 <= 12 ? &launch<12>
                                        : &launch<16>;
  return run(A1h, A2h, A3h, A4h, yh, q1a, q2a, ra, q1b, q2b, rb, ab, row_pack,
             col_pack, vox, B, S, N1p, N2, N2pb, n4, NR, NC, NV, tol, stream);
}
