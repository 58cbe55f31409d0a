// Kernel 7: the double-float finalize of a scan's winner, C = 1-4 columns;
// in the fit, the whole finalize stage.
//
// Counterpart of ops/dfscan.finalize_top1 (the fit's finalize: the winner's
// columns gathered, df_nnls_cols and the float64 R^2; plain version
// finalize_top1_plain) and of ops/dfscan.df_nnls_cols (plain version
// df_nnls_cols_twin), which the JAX package runs as plain XLA inside the
// chunk's one jitted program (microstructure_fingerprinting_tpu/models/
// fit.py:143 _finalize_top1, ops/dfscan.py:1190 df_nnls_cols; no Pallas
// kernel). Per voxel:
//   * its C columns and the signal, staged in shared memory: read from a
//     (B, S, C) block (df_nnls_cols), or gathered (finalize_top1): fascicle
//     k's atom cand[b, k] from the rotated blocks D (B, K, S, N), then the
//     CSF signature (S,) and the EAR signature's column cand[b, -1] of
//     (S, E), each where the fit has it;
//   * the power-of-two scales exp2(ceil(log2(max(max|x|, 1e-30)))) of each
//     column and of y, by the same log2f / exp2f the plain version calls on
//     the card;
//   * quantize2 of [cols / sc | y / sy] and the (C + 1) x (C + 1)
//     double-float Gram: int8 level products exact in int32, the cross
//     products (a + R)' R and R' a as float64 sums of exact products,
//     rounded once (dfscan.df_gram), every entry of both triangles, since
//     the cross products make it unsymmetric;
//   * the closed-form solver in double-float arithmetic (df_dekker.cuh):
//     _df_div for C = 1, _df_nnls2, _df_nnls3 (Cramer signs against -tol3,
//     then the 12 -> 13 -> 23 fallback chain), _df_nnls4 (the 15 supports,
//     the first strict improvement over y'y in ascending mask order); the
//     scales undone;
//   * with gathered columns, the fit's R^2 (dfscan.r_squared): y_rec =
//     sum_c col_c w_c, the centred sums and the guards den > 0, S > 1, all
//     in float64.
//
// What bounds it on an H100: neither bytes (C + 1 floats a sample, a few MB
// a chunk) nor operations (~30 a sample, a few thousand a voxel for the
// solver). A fascicle column is gathered a sector a sample (the atom axis
// is D's contiguous one), and the solver is a few dependent double-float
// chains a voxel, with only 512 voxels (warps) a chunk to hide them. Its
// first design solved on one lane of a warp a voxel, the Cramer solves in
// out-of-line helpers that took their arrays through local memory, and left
// the column gather and the R^2 to ~20 torch kernels around it. The design:
// a warp a voxel, kWarps voxels a block. The lanes stage the columns,
// kStage samples a lane in flight, take every 32nd sample and reduce by xor
// shuffles, so every lane holds the Gram's bits (the per-sample scalings by
// powers of two as exact products, not divisions); then the solve is
// spread across the lanes, every helper inline on register arrays:
//   * C = 2: lane 0 the full 2 x 2 solve, lanes 1 and 2 the single-column
//     ones; every lane then _df_nnls2's cases;
//   * C = 3: lanes 1-3 the three 2-column fallbacks (_df_nnls2 whole),
//     lanes 4-7 the 3 x 3 determinant and its three Cramer numerators;
//     every lane then the weights, the sign test and the fallback chain;
//   * C = 4: lane 0 the empty support, lane m the support of mask m; the
//     3 x 3 determinants of masks 7, 11, 13, 14 (4 a lane) and the
//     cofactor expansions of the 4 x 4 determinant and its four Cramer
//     numerators (lanes 16-20) in one pass, then masks 7, 11, 13, 14 and 15
//     (on lane 15) finish together; a butterfly over lanes 0-15 keeps the
//     first minimum under df_lt, the lowest mask among the least residuals:
//     the winner of the sequential fold, since every support's residual is
//     a (hi, lo) pair without NaN and y'y sits in the first slot
//     (testing.df_lanes_first_min models it).
// Each support's arithmetic is the plain version's, operation for
// operation, whichever lane runs it. The float64 sums of the Gram take the
// lanes' order, another than cuBLAS's in the plain version: the two could
// round a cross product to neighbouring float32 values
// (testing.kernel_agreement; no entry has differed on the card). R^2's
// float64 sums take the lanes' order too (|dR^2| <= 1e-12).
#include <cuda_runtime.h>

#include "df_dekker.cuh"
#include "phases.cuh"

namespace {

using mf::df_add;
using mf::df_div;
using mf::df_lt;
using mf::df_mul;
using mf::kInf;
using mf::neg;
using mf::P2;
using mf::val;

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// voxels (warps) a block, at most; dynamic shared memory a block without
// the opt-in, less the static part, and the most a block takes
constexpr int kWarps = 4;
constexpr size_t kSmemDefault = 46 * 1024, kSmemMax = 227 * 1024;
// samples a lane loads before it stores them to the stage
constexpr int kStage = 8;

__device__ __forceinline__ P2 zero() { return {0.0f, 0.0f}; }

// torch.isfinite
__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= 3.40282347e+38f;
}

// torch.amax: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// df_nnls_cols' pow2: torch.exp2(torch.ceil(torch.log2(torch.clamp(m,
// min=1e-30)))), the clamp keeping NaN
__device__ __forceinline__ float pow2_scale(float m) {
  const float c = m < 1e-30f ? 1e-30f : m;
  return exp2f(ceilf(log2f(c)));
}

// dfscan._round_levels then .to(int8): clamp(round(x / s), -127, 127),
// given x / s; the scales 2^-7 and 2^-15 are powers of two, so the quotient
// is the exact product by 2^7 or 2^15, which the callers pass
__device__ __forceinline__ int level(float x_over_s) {
  return (int)fminf(fmaxf(rintf(x_over_s), -127.0f), 127.0f);
}

// x / sc of a column scale sc, given inv = 1 / sc: where sc is a power of
// two (pow2_scale's exp2f of an integer) or inf, x times inv, the same
// correctly rounded quotient without a division a sample; else the
// quotient
__device__ __forceinline__ float scaled(float x, float sc, float inv) {
  return (__float_as_int(sc) & 0x007fffff) == 0 ? mf::mul(x, inv)
                                                 : mf::dv(x, sc);
}

__device__ __forceinline__ P2 shfl(P2 x, int lane) {
  return {__shfl_sync(kFull, x.p, lane), __shfl_sync(kFull, x.e, lane)};
}

__device__ __forceinline__ P2 det2(P2 dA, P2 dB, P2 g) {
  return df_add(df_mul(dA, dB), neg(df_mul(g, g)));
}

// dfscan._df_det3
__device__ __forceinline__ P2 det3(const P2 (&m)[3][3]) {
  const P2 t1 = df_mul(m[0][0], df_add(df_mul(m[1][1], m[2][2]),
                                       neg(df_mul(m[1][2], m[2][1]))));
  const P2 t2 = df_mul(m[0][1], df_add(df_mul(m[1][0], m[2][2]),
                                       neg(df_mul(m[1][2], m[2][0]))));
  const P2 t3 = df_mul(m[0][2], df_add(df_mul(m[1][0], m[2][1]),
                                       neg(df_mul(m[1][1], m[2][0]))));
  return df_add(df_add(t1, neg(t2)), t3);
}

// dfscan._df_quadres: y'y - 2 w'Y + w'G w over the k x k system
template <int k>
__device__ __forceinline__ P2 quadres(P2 wy, const P2 (&G)[k][k],
                                      const P2 (&Y)[k], const P2 (&w)[k]) {
  P2 out = wy;
  #pragma unroll
  for (int a = 0; a < k; ++a) {
    out = df_add(out, mf::scale(df_mul(w[a], Y[a]), -2.0f));
    out = df_add(out, df_mul(df_mul(w[a], w[a]), G[a][a]));
    #pragma unroll
    for (int b = a + 1; b < k; ++b) {
      out = df_add(out,
                   mf::scale(df_mul(df_mul(w[a], w[b]), G[a][b]), 2.0f));
    }
  }
  return out;
}

// dfscan._df_cramer: the weights of the k x k system (unguarded), k <= 2
// (3 x 3 and 4 x 4: the determinants' pass of solve<4>)
template <int k>
__device__ __forceinline__ void cramer(const P2 (&G)[k][k], const P2 (&Y)[k],
                                       P2 (&w)[k]) {
  if constexpr (k == 1) {
    w[0] = df_div(Y[0], G[0][0]);
  } else {
    const P2 det = det2(G[0][0], G[1][1], G[0][1]);
    const P2 n1 = df_add(df_mul(Y[0], G[1][1]), neg(df_mul(G[0][1], Y[1])));
    const P2 n2 = df_add(df_mul(G[0][0], Y[1]), neg(df_mul(Y[0], G[0][1])));
    w[0] = df_div(n1, det);
    w[1] = df_div(n2, det);
  }
}

__device__ __forceinline__ P2 nan2inf(P2 x) {
  return x.p != x.p ? P2{kInf, 0.0f} : x;
}

__device__ __forceinline__ P2 df_where(bool c, P2 x, P2 y) { return c ? x : y; }

// _df_nnls2's pieces: the full 2 x 2 solve (with its weight numerators),
// and a single column's
struct Full2 {
  P2 w1D, w2D, w1, w2, res;
};

__device__ __forceinline__ Full2 nnls2_full(P2 wy, P2 dA, P2 dB, P2 g, P2 pA,
                                            P2 pB) {
  Full2 f;
  f.w1D = df_add(df_mul(dB, pA), neg(df_mul(g, pB)));
  f.w2D = df_add(df_mul(dA, pB), neg(df_mul(g, pA)));
  const P2 det = det2(dA, dB, g);
  f.w1 = df_div(f.w1D, det);
  f.w2 = df_div(f.w2D, det);
  const P2 G[2][2] = {{dA, g}, {g, dB}};
  const P2 Y[2] = {pA, pB}, w[2] = {f.w1, f.w2};
  f.res = quadres<2>(wy, G, Y, w);
  return f;
}

struct Single {
  P2 w, res;
};

__device__ __forceinline__ Single single(P2 wy, P2 d, P2 p) {
  const P2 G[1][1] = {{d}}, Y[1] = {p}, w[1] = {df_div(p, d)};
  return {w[0], quadres<1>(wy, G, Y, w)};
}

// _df_nnls2's cases (ops/nnls.lsqnonneg_2var's priority)
__device__ __forceinline__ void nnls2_pick(P2 wy, const Full2& f,
                                           const Single& sA,
                                           const Single& sB, P2 pA, P2 pB,
                                           P2& w1, P2& w2, P2& res) {
  const float v1 = val(f.w1D), v2 = val(f.w2D), a = val(pA), b = val(pB);
  const bool c1 = v1 > 0.0f && v2 > 0.0f;
  const bool c2 = !c1 && v1 >= 0.0f && v2 <= 0.0f;
  const bool c3 = !c1 && !c2 && v1 <= 0.0f && v2 >= 0.0f;
  const bool c4 = !c1 && !c2 && !c3 && v1 < 0.0f && v2 < 0.0f;
  const bool t1 = (c2 && a >= 0.0f) || (c4 && a > 0.0f);
  const bool t2 = (c3 && b >= 0.0f) || (c4 && a <= 0.0f && b > 0.0f);
  w1 = df_where(c1, f.w1, df_where(t1, sA.w, zero()));
  w2 = df_where(c1, f.w2, df_where(t2, sB.w, zero()));
  res = df_where(c1, nan2inf(f.res),
                 df_where(t1, sA.res, df_where(t2, sB.res, wy)));
}

// dfscan._df_nnls2 on one lane
__device__ __forceinline__ void nnls2(P2 wy, P2 dA, P2 dB, P2 g, P2 pA, P2 pB,
                                      P2& w1, P2& w2, P2& res) {
  nnls2_pick(wy, nnls2_full(wy, dA, dB, g, pA, pB), single(wy, dA, pA),
             single(wy, dB, pB), pA, pB, w1, w2, res);
}

// _df_nnls4's rule for a support's residual: infinite unless every weight
// is finite and >= 0 and the residual is a number
template <int k>
__device__ __forceinline__ P2 support_res(P2 wy, const P2 (&G)[k][k],
                                          const P2 (&Y)[k],
                                          const P2 (&w)[k]) {
  bool feas = true;
  #pragma unroll
  for (int a = 0; a < k; ++a) {
    const float va = val(w[a]);
    feas = feas && va >= 0.0f && finite(va);
  }
  const P2 q = quadres<k>(wy, G, Y, w);
  const float rv = (feas && q.p == q.p) ? q.p : kInf;
  return {rv, finite(rv) ? q.e : 0.0f};
}

// _df_nnls4's support of mask m, k = popcount(m) <= 2 of the 4 columns:
// its weights (zero off the support) and its residual; sg holds G (4 x 4,
// row-major), then A'y
template <int k>
__device__ __forceinline__ void support(const P2* sg, P2 wy, int m,
                                        P2 (&w)[4], P2& r) {
  int S[k];
  #pragma unroll
  for (int a = 0; a < k; ++a) {
    S[a] = __ffs(m) - 1;
    m &= m - 1;
  }
  P2 GS[k][k], YS[k], wS[k];
  #pragma unroll
  for (int a = 0; a < k; ++a) {
    YS[a] = sg[16 + S[a]];
    #pragma unroll
    for (int c = 0; c < k; ++c) GS[a][c] = sg[4 * S[a] + S[c]];
  }
  cramer<k>(GS, YS, wS);
  r = support_res<k>(wy, GS, YS, wS);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = zero();
    #pragma unroll
    for (int a = 0; a < k; ++a) {
      if (S[a] == i) w[i] = wS[a];
    }
  }
}

// The first minimum under df_lt over lanes 0-15 (lane l holds slot l's
// residual r and its index), by a butterfly that keeps the lower slot's
// value unless the higher one's is strictly less; on return lanes 0-15
// hold the winner (testing.df_lanes_first_min).
__device__ __forceinline__ void first_min(P2& r, int& idx, int lane) {
  #pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    const P2 o = {__shfl_xor_sync(kFull, r.p, off),
                  __shfl_xor_sync(kFull, r.e, off)};
    const int oi = __shfl_xor_sync(kFull, idx, off);
    const bool upper = lane & off;
    const P2 lo = upper ? o : r, hi = upper ? r : o;
    const int lo_i = upper ? oi : idx, hi_i = upper ? idx : oi;
    const bool take = df_lt(hi, lo);
    r = take ? hi : lo;
    idx = take ? hi_i : lo_i;
  }
}

// The solve of one voxel, on every lane of its warp: G (C x C), p = A'y
// and wy = y'y, identical bits on every lane; sg the warp's copy of G and
// p in shared memory. Returns w and res on every lane.
template <int C>
__device__ __forceinline__ void solve(const P2 (&G)[4][4], const P2 (&p)[4],
                                      P2 wy, const P2* sg, int lane,
                                      float neg_tol3, P2 (&w)[4], P2& res) {
  if constexpr (C == 1) {
    const P2 G1[1][1] = {{G[0][0]}}, Y1[1] = {p[0]};
    const P2 w0[1] = {df_div(p[0], G[0][0])};
    const bool pos = val(p[0]) >= 0.0f;
    const P2 r = quadres<1>(wy, G1, Y1, w0);
    w[0] = pos ? w0[0] : zero();
    res = pos ? r : wy;
  } else if constexpr (C == 2) {
    // lane 0 the full solve, lanes 1 and 2 column A and column B alone
    Full2 f = {};
    Single s = {};
    if (lane == 0) {
      f = nnls2_full(wy, G[0][0], G[1][1], G[0][1], p[0], p[1]);
    } else if (lane <= 2) {
      s = lane == 1 ? single(wy, G[0][0], p[0]) : single(wy, G[1][1], p[1]);
    }
    f = {shfl(f.w1D, 0), shfl(f.w2D, 0), shfl(f.w1, 0), shfl(f.w2, 0),
         shfl(f.res, 0)};
    const Single sA = {shfl(s.w, 1), shfl(s.res, 1)};
    const Single sB = {shfl(s.w, 2), shfl(s.res, 2)};
    nnls2_pick(wy, f, sA, sB, p[0], p[1], w[0], w[1], res);
  } else if constexpr (C == 3) {
    // lanes 1-3 the fallbacks (0, 1), (0, 2), (1, 2); lanes 4-7 the
    // determinant and the numerators of columns 0-2
    P2 fa = zero(), fb = zero(), fr = zero(), d = zero();
    if (lane >= 1 && lane <= 3) {
      const int a = lane == 3 ? 1 : 0, b = lane == 1 ? 1 : 2;
      nnls2(wy, sg[5 * a], sg[5 * b], sg[4 * a + b], sg[16 + a], sg[16 + b],
            fa, fb, fr);
    } else if (lane >= 4 && lane <= 7) {
      const int j = lane - 5;  // the column the numerator replaces, or -1
      P2 m[3][3];
      #pragma unroll
      for (int r = 0; r < 3; ++r) {
        #pragma unroll
        for (int c = 0; c < 3; ++c) m[r][c] = c == j ? p[r] : G[r][c];
      }
      d = det3(m);
    }
    P2 D[4], fw[3][2], frs[3];
    #pragma unroll
    for (int j = 0; j < 4; ++j) D[j] = shfl(d, 4 + j);
    #pragma unroll
    for (int t = 0; t < 3; ++t) {
      fw[t][0] = shfl(fa, 1 + t);
      fw[t][1] = shfl(fb, 1 + t);
      frs[t] = shfl(fr, 1 + t);
    }
    // _df_nnls3: the Cramer weights and their sign test, then the
    // fallback chain with first-strictly-better priority
    P2 G3[3][3], p3[3], wf[3];
    #pragma unroll
    for (int r = 0; r < 3; ++r) {
      p3[r] = p[r];
      #pragma unroll
      for (int c = 0; c < 3; ++c) G3[r][c] = G[r][c];
    }
    #pragma unroll
    for (int j = 0; j < 3; ++j) wf[j] = df_div(D[j + 1], D[0]);
    const bool full = val(D[1]) >= neg_tol3 && val(D[2]) >= neg_tol3 &&
                      val(D[3]) >= neg_tol3;
    const P2 res_f = nan2inf(quadres<3>(wy, G3, p3, wf));
    P2 fb3[3] = {fw[0][0], fw[0][1], zero()}, fr3 = frs[0];
    if (df_lt(frs[1], fr3)) {
      fb3[0] = fw[1][0]; fb3[1] = zero(); fb3[2] = fw[1][1]; fr3 = frs[1];
    }
    if (df_lt(frs[2], fr3)) {
      fb3[0] = zero(); fb3[1] = fw[2][0]; fb3[2] = fw[2][1]; fr3 = frs[2];
    }
    #pragma unroll
    for (int j = 0; j < 3; ++j) w[j] = full ? wf[j] : fb3[j];
    res = full ? res_f : fr3;
  } else {
    // lane 0 the empty support, lane m < 15 mask m, lane 15 mask 15 from
    // the 4 x 4 determinant and its numerators of columns 0-3 on lanes
    // 16-20. The 3 x 3 determinants run in one pass of the lanes of the
    // 3-column masks (7, 11, 13, 14: the support's and its three
    // numerators) and of lanes 16-20 (the four cofactors); then the lanes
    // of masks 7, 11, 13, 14 and 15 finish their supports together
    P2 r = {kInf, 0.0f};
    #pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = zero();
    const int k = lane < 16 ? __popc(lane) : 0;
    const bool cof = lane >= 16 && lane <= 20;
    const int jc = lane - 17;  // lanes 16-20: the column p replaces, or -1
    int S[4] = {0, 1, 2, 3};   // the support's columns (mask 15: all)
    if (k == 3) {
      int m = lane;
      #pragma unroll
      for (int a = 0; a < 3; ++a) {
        S[a] = __ffs(m) - 1;
        m &= m - 1;
      }
    }
    // entry (i, c) of [G | p] (c = 4: p) in sg
    auto at = [&](int i, int c) { return sg[c == 4 ? 16 + i : 4 * i + c]; };
    P2 d[4] = {};
    if (k == 3 || cof) {
      #pragma unroll
      for (int t = 0; t < 4; ++t) {
        // mask lanes: G_S, then G_S with column t - 1 replaced by p_S; lanes
        // 16-20: rows 1-3 of G (column jc replaced by p) without column t
        P2 m3[3][3];
        #pragma unroll
        for (int rr = 0; rr < 3; ++rr) {
          #pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int q = c < t ? c : c + 1;
            m3[rr][c] = k == 3 ? at(S[rr], c == t - 1 ? 4 : S[c])
                               : at(rr + 1, q == jc ? 4 : q);
          }
        }
        const P2 dt = det3(m3);
        if (k == 3) {
          d[t] = dt;
        } else {
          // _df_det4's cofactors of row 0
          P2 term = df_mul(at(0, t == jc ? 4 : t), dt);
          if (t % 2 == 1) term = neg(term);
          d[0] = t == 0 ? term : df_add(d[0], term);
        }
      }
    } else if (lane >= 1 && lane < 15) {
      if (k == 1) {
        support<1>(sg, wy, lane, w, r);
      } else {
        support<2>(sg, wy, lane, w, r);
      }
    } else if (lane == 0) {
      r = wy;
    }
    P2 D4[5];
    #pragma unroll
    for (int j = 0; j < 5; ++j) D4[j] = shfl(d[0], 16 + j);
    if (k >= 3) {
      // _df_cramer's weights, k of them, and _df_nnls4's residual rule,
      // every step predicated on a < k
      P2 wS[4], GS[4][4], YS[4];
      #pragma unroll
      for (int a = 0; a < 4; ++a) {
        const P2 num = k == 3 ? (a < 3 ? d[a + 1] : zero()) : D4[a + 1];
        wS[a] = a < k ? df_div(num, k == 3 ? d[0] : D4[0]) : zero();
        YS[a] = at(S[a], 4);
        #pragma unroll
        for (int c = 0; c < 4; ++c) GS[a][c] = at(S[a], S[c]);
      }
      bool feas = true;
      P2 q = wy;
      #pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (a < k) {
          const float va = val(wS[a]);
          feas = feas && va >= 0.0f && finite(va);
          q = df_add(q, mf::scale(df_mul(wS[a], YS[a]), -2.0f));
          q = df_add(q, df_mul(df_mul(wS[a], wS[a]), GS[a][a]));
          #pragma unroll
          for (int b2 = a + 1; b2 < 4; ++b2) {
            if (b2 < k) {
              q = df_add(q, mf::scale(df_mul(df_mul(wS[a], wS[b2]),
                                             GS[a][b2]), 2.0f));
            }
          }
        }
      }
      const float rv = (feas && q.p == q.p) ? q.p : kInf;
      r = {rv, finite(rv) ? q.e : 0.0f};
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        #pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (a < k && S[a] == i) w[i] = wS[a];
        }
      }
    }
    int idx = lane;
    first_min(r, idx, lane);
    const int win = __shfl_sync(kFull, idx, 0);
    res = shfl(r, 0);
    #pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = shfl(w[j], win);
  }
}

// Sample s of a voxel's column c < C is base[c][s * st[c]].
// df_nnls_cols: columns of a (B, S, C) block.
struct BlockCols {
  const float* cols;
  template <int C>
  __device__ __forceinline__ void columns(int b, int S, const float** base,
                                          long long* st) const {
    #pragma unroll
    for (int c = 0; c < C; ++c) {
      base[c] = cols + (size_t)b * S * C + c;
      st[c] = C;
    }
  }
};

// finalize_top1: fascicle k's atom cand[b, k] of the rotated blocks D
// (strides sb, sk, ss, sn), then the CSF signature (stride csf_st) where
// csf_on, then the EAR signature's column cand[b, ncand - 1] (strides es,
// ee) where the fit has EAR; cand (B, ncand) int64, strides c0, c1.
struct GatheredCols {
  const float* D;
  long long sb, sk, ss, sn;
  const long long* cand;
  long long c0, c1;
  int ncand, K, csf_on;
  const float* csf;
  long long csf_st;
  const float* ear;
  long long es, ee;
  template <int C>
  __device__ __forceinline__ void columns(int b, int S, const float** base,
                                          long long* st) const {
    const long long* cb = cand + b * c0;
    #pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < K) {
        base[c] = D + b * sb + c * sk + cb[c * c1] * sn;
        st[c] = ss;
      } else if (csf_on && c == K) {
        base[c] = csf;
        st[c] = csf_st;
      } else {
        base[c] = ear + cb[(ncand - 1) * c1] * ee;
        st[c] = es;
      }
    }
  }
};

// A warp a voxel: the columns from ``rd``, y (B, S) float32, raw scale;
// out w (B, C) raw-scale weights, res (B,) the raw residual and, where r2
// is not null, r2 (B,) float64.
template <int C, class Reader>
__global__ void __launch_bounds__(kWarps * kLanes)
finalize_kernel(Reader rd, const float* __restrict__ y,
                float* __restrict__ w_out, float* __restrict__ res_out,
                double* __restrict__ r2_out, int B, int S, float neg_tol3) {
  constexpr int K = C + 1;
  extern __shared__ float smem[];
  __shared__ P2 sgp[kWarps][20];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  int b = blockIdx.x * (blockDim.x / kLanes) + warp;
  // a warp past the last voxel runs the last one again and stores nothing
  // (every warp reaches the phase marks)
  const bool live = b < B;
  if (!live) b = B - 1;
  float* x = smem + (size_t)warp * K * S;  // x[c S + s]; c = C: the signal
  P2* sg = sgp[warp];
  MF_PHASE_BEGIN;

  // the columns and the signal, staged: kStage samples a lane loaded
  // before any is stored, so that the gathered reads (a sector each) are
  // in flight together
  {
    const float* base[K];
    long long st[K];
    rd.template columns<C>(b, S, base, st);
    base[C] = y + (size_t)b * S;
    st[C] = 1;
    for (int s0 = lane; s0 < S; s0 += kStage * kLanes) {
      float v[kStage][K];
      #pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int s = s0 + u * kLanes;
        #pragma unroll
        for (int c = 0; c < K; ++c) {
          v[u][c] = s < S ? __ldg(base[c] + s * st[c]) : 0.0f;
        }
      }
      #pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int s = s0 + u * kLanes;
        if (s < S) {
          #pragma unroll
          for (int c = 0; c < K; ++c) x[c * S + s] = v[u][c];
        }
      }
    }
    __syncwarp();
  }
  MF_PHASE(0);

  // the scales: max |x| of each column, then the power of two above it
  float m[K];
  #pragma unroll
  for (int c = 0; c < K; ++c) m[c] = 0.0f;
  for (int s = lane; s < S; s += kLanes) {
    #pragma unroll
    for (int c = 0; c < K; ++c) m[c] = nan_max(m[c], fabsf(x[c * S + s]));
  }
  float sc[K];
  #pragma unroll
  for (int c = 0; c < K; ++c) {
    for (int off = 16; off > 0; off /= 2) {
      m[c] = nan_max(m[c], __shfl_xor_sync(kFull, m[c], off));
    }
    sc[c] = pow2_scale(m[c]);
  }

  // the Gram of quantize2([cols / sc | y / sy]): entries (i, j) of G
  // (i, j < C), A'y (j = C) and y'y, as dfscan.df_gram sums them
  auto used = [](int i, int j) { return i < C || j == C; };
  int t11[K][K], t12[K][K], t22[K][K];
  double c1[K][K], c2[K][K];
  #pragma unroll
  for (int i = 0; i < K; ++i) {
    #pragma unroll
    for (int j = 0; j < K; ++j) {
      t11[i][j] = t12[i][j] = t22[i][j] = 0;
      c1[i][j] = c2[i][j] = 0.0;
    }
  }
  float inv[K];
  #pragma unroll
  for (int c = 0; c < K; ++c) inv[c] = mf::dv(1.0f, sc[c]);
  for (int s = lane; s < S; s += kLanes) {
    int q1[K], q2[K];
    float r[K], a[K], xa[K];
    #pragma unroll
    for (int c = 0; c < K; ++c) {
      const float z = scaled(x[c * S + s], sc[c], inv[c]);
      q1[c] = level(mf::mul(z, 128.0f));
      const float A1 = mf::mul((float)q1[c], 0.0078125f);
      q2[c] = level(mf::mul(mf::sub(z, A1), 32768.0f));
      a[c] = mf::add(A1, mf::mul((float)q2[c], 3.0517578125e-05f));
      r[c] = mf::sub(z, a[c]);
      xa[c] = mf::add(a[c], r[c]);
    }
    #pragma unroll
    for (int i = 0; i < K; ++i) {
      #pragma unroll
      for (int j = 0; j < K; ++j) {
        if (i <= j) {
          t11[i][j] += q1[i] * q1[j];
          t12[i][j] += q1[i] * q2[j] + q2[i] * q1[j];
          t22[i][j] += q2[i] * q2[j];
        }
        if (used(i, j)) {
          c1[i][j] += (double)xa[i] * (double)r[j];
          c2[i][j] += (double)r[i] * (double)a[j];
        }
      }
    }
  }
  #pragma unroll
  for (int i = 0; i < K; ++i) {
    #pragma unroll
    for (int j = 0; j < K; ++j) {
      for (int off = 16; off > 0; off /= 2) {
        if (i <= j) {
          t11[i][j] += __shfl_xor_sync(kFull, t11[i][j], off);
          t12[i][j] += __shfl_xor_sync(kFull, t12[i][j], off);
          t22[i][j] += __shfl_xor_sync(kFull, t22[i][j], off);
        }
        if (used(i, j)) {
          c1[i][j] += __shfl_xor_sync(kFull, c1[i][j], off);
          c2[i][j] += __shfl_xor_sync(kFull, c2[i][j], off);
        }
      }
    }
  }
  // every lane holds the same sums: the same G, p and y'y
  P2 G[4][4], p[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = zero();
    #pragma unroll
    for (int j = 0; j < 4; ++j) G[i][j] = zero();
  }
  P2 wy = zero();
  #pragma unroll
  for (int i = 0; i < K; ++i) {
    #pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!used(i, j)) continue;
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      const float gv[5] = {
          mf::mul((float)t11[lo][hi], 6.103515625e-05f),
          mf::mul((float)t12[lo][hi], 2.384185791015625e-07f),
          mf::mul((float)t22[lo][hi], 9.313225746154785e-10f),
          __double2float_rn(c1[i][j]), __double2float_rn(c2[i][j])};
      const P2 v = mf::df_from_sum(gv);
      if (i == C && j == C) {
        wy = v;
      } else if (j == C) {
        p[i] = v;
      } else {
        G[i][j] = v;
      }
    }
  }
  if (C >= 3 && lane == 0) {
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      sg[16 + i] = p[i];
      #pragma unroll
      for (int j = 0; j < 4; ++j) sg[4 * i + j] = G[i][j];
    }
  }
  __syncwarp();
  MF_PHASE(1);

  P2 w[4], res;
  solve<C>(G, p, wy, sg, lane, neg_tol3, w, res);
  // undo the scales (exact)
  const float sy = sc[C];
  float wr[C];
  #pragma unroll
  for (int c = 0; c < C; ++c) wr[c] = mf::mul(val(w[c]), mf::dv(sy, sc[c]));
  MF_PHASE(2);

  // R^2 in float64: y_rec = sum_c col_c w_c, then dfscan.r_squared
  double r2 = 0.0;
  if (r2_out != nullptr) {
    auto rec = [&](int s) {
      double v = (double)x[s] * (double)wr[0];
      #pragma unroll
      for (int c = 1; c < C; ++c) v = v + (double)x[c * S + s] * (double)wr[c];
      return v;
    };
    double sum_y = 0.0, sum_r = 0.0;
    for (int s = lane; s < S; s += kLanes) {
      sum_y = sum_y + (double)x[C * S + s];
      sum_r = sum_r + rec(s);
    }
    for (int off = 16; off > 0; off /= 2) {
      sum_y += __shfl_xor_sync(kFull, sum_y, off);
      sum_r += __shfl_xor_sync(kFull, sum_r, off);
    }
    const double my = sum_y / S, mr = sum_r / S;
    double num = 0.0, syy = 0.0, srr = 0.0;
    for (int s = lane; s < S; s += kLanes) {
      const double yc = (double)x[C * S + s] - my, rc = rec(s) - mr;
      num = num + yc * rc;
      syy = syy + yc * yc;
      srr = srr + rc * rc;
    }
    for (int off = 16; off > 0; off /= 2) {
      num += __shfl_xor_sync(kFull, num, off);
      syy += __shfl_xor_sync(kFull, syy, off);
      srr += __shfl_xor_sync(kFull, srr, off);
    }
    const double den = sqrt(syy * srr);
    const double r = den > 0.0 && S > 1 ? num / den : 0.0;
    r2 = r * r;
  }
  if (live && lane == 0) {
    #pragma unroll
    for (int c = 0; c < C; ++c) w_out[(size_t)b * C + c] = wr[c];
    res_out[b] = mf::mul(val(res), mf::mul(sy, sy));
    if (r2_out != nullptr) r2_out[b] = r2;
  }
  MF_PHASE(3);
}

// kWarps voxels a block where their staged columns fit the default shared
// memory, fewer (down to one, opted in above it) where they do not
template <int C, class Reader>
int launch(const Reader& rd, const float* y, float* w, float* res,
           double* r2, int B, int S, float neg_tol3, cudaStream_t stream) {
  const size_t per = (size_t)(C + 1) * S * sizeof(float);
  int warps = (int)(kSmemDefault / per);
  warps = warps < 1 ? 1 : (warps > kWarps ? kWarps : warps);
  const size_t bytes = (size_t)warps * per;
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  if (bytes > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        finalize_kernel<C, Reader>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  finalize_kernel<C, Reader>
      <<<(B + warps - 1) / warps, warps * kLanes, bytes, stream>>>(
          rd, y, w, res, r2, B, S, neg_tol3);
  return (int)cudaGetLastError();
}

template <class Reader>
int launch_c(int C, const Reader& rd, const float* y, float* w, float* res,
             double* r2, int B, int S, float neg_tol3, cudaStream_t stream) {
  switch (C) {
    case 1:
      return launch<1>(rd, y, w, res, r2, B, S, neg_tol3, stream);
    case 2:
      return launch<2>(rd, y, w, res, r2, B, S, neg_tol3, stream);
    case 3:
      return launch<3>(rd, y, w, res, r2, B, S, neg_tol3, stream);
    default:
      return launch<4>(rd, y, w, res, r2, B, S, neg_tol3, stream);
  }
}

}  // namespace

MF_PHASE_API(mf_finalize_phases)

// cols (B, S, C) not null: df_nnls_cols on that block, r2 not written;
// else finalize_top1 on the columns that D, cand, csf and ear give (K, the
// flags, the strides in elements), r2 written.
extern "C" int mf_finalize(const float* cols, const float* D,
                           const long long* cand, const float* csf,
                           const float* ear, const float* y, float* w,
                           float* res, double* r2, int B, int S, int C,
                           int K, int csf_on, int ear_on, int ncand, int sb,
                           int sk, int ss, int sn, int c0, int c1, int csf_st,
                           int es, int ee, float neg_tol3,
                           cudaStream_t stream) {
  if (C < 1 || C > 4 || S < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (cols != nullptr) {
    return launch_c(C, BlockCols{cols}, y, w, res, nullptr, B, S, neg_tol3,
                    stream);
  }
  if (K < 1 || C != K + (csf_on != 0) + (ear_on != 0) ||
      ncand < K + (ear_on != 0) || (csf_on && csf == nullptr) ||
      (ear_on && ear == nullptr) || r2 == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const GatheredCols rd = {D,   sb, sk,     ss,     sn,  cand, c0, c1,
                           ncand, K, csf_on, csf, csf_st, ear, es, ee};
  return launch_c(C, rd, y, w, res, r2, B, S, neg_tol3, stream);
}
