// Kernel 7: the double-float finalize of a scan's winner, C = 1-4 columns.
//
// Counterpart of ops/dfscan.df_nnls_cols (its plain version,
// df_nnls_cols_twin), which the JAX package runs as plain XLA inside the
// chunk's one jitted program (microstructure_fingerprinting_tpu/ops/
// dfscan.py:1190 df_nnls_cols; no Pallas kernel). Per voxel:
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
//     then the 12 -> 13 -> 23 fallback chain), _df_nnls4 (the 15 supports
//     in ascending mask order, strict improvement); the scales undone.
//
// What bounds it on an H100: neither bytes (C + 1 floats a sample, a few
// MB a chunk) nor operations (~30 a sample, a few thousand a voxel for the
// solver): the latency of one thread's dependent double-float chain. The
// plain version is thousands of tiny torch kernels (each df product and
// sum several), so the design is one block, one warp, a voxel: the lanes
// take every 32nd sample and reduce by shuffles, then lane 0 solves the
// voxel's system while the other voxels' warps run beside it. The float64
// sums take the lanes' order, another than cuBLAS's in the plain version:
// the two can round a cross product to neighbouring float32 values
// (testing.kernel_agreement).
#include <cuda_runtime.h>

#include "df_dekker.cuh"

namespace {

using mf::df_add;
using mf::df_div;
using mf::df_lt;
using mf::df_mul;
using mf::neg;
using mf::P2;
using mf::val;

constexpr int kThreads = 32;

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

// dfscan._round_levels then .to(int8): clamp(round(x / s), -127, 127)
__device__ __forceinline__ int level(float x, float s) {
  return (int)fminf(fmaxf(rintf(mf::dv(x, s)), -127.0f), 127.0f);
}

__device__ __forceinline__ P2 det2(P2 dA, P2 dB, P2 g) {
  return df_add(df_mul(dA, dB), neg(df_mul(g, g)));
}

// dfscan._df_det3
__device__ __noinline__ P2 det3(const P2 (&m)[3][3]) {
  const P2 t1 = df_mul(m[0][0], df_add(df_mul(m[1][1], m[2][2]),
                                       neg(df_mul(m[1][2], m[2][1]))));
  const P2 t2 = df_mul(m[0][1], df_add(df_mul(m[1][0], m[2][2]),
                                       neg(df_mul(m[1][2], m[2][0]))));
  const P2 t3 = df_mul(m[0][2], df_add(df_mul(m[1][0], m[2][1]),
                                       neg(df_mul(m[1][1], m[2][0]))));
  return df_add(df_add(t1, neg(t2)), t3);
}

// dfscan._df_det4: cofactors of row 0
__device__ __noinline__ P2 det4(const P2 (&m)[4][4]) {
  P2 out = zero();
  #pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    P2 minor[3][3];
    for (int r = 1; r < 4; ++r) {
      int k = 0;
      for (int cc = 0; cc < 4; ++cc) {
        if (cc != c) minor[r - 1][k++] = m[r][cc];
      }
    }
    P2 term = df_mul(m[0][c], det3(minor));
    if (c % 2 == 1) term = neg(term);
    out = c == 0 ? term : df_add(out, term);
  }
  return out;
}

// dfscan._df_quadres: y'y - 2 w'Y + w'G w over the first k entries
__device__ __noinline__ P2 quadres(P2 wy, const P2 (&G)[4][4],
                                   const P2 (&Y)[4], const P2 (&w)[4],
                                   int k) {
  P2 out = wy;
  #pragma unroll 1
  for (int a = 0; a < k; ++a) {
    out = df_add(out, mf::scale(df_mul(w[a], Y[a]), -2.0f));
    out = df_add(out, df_mul(df_mul(w[a], w[a]), G[a][a]));
    for (int b = a + 1; b < k; ++b) {
      out = df_add(out,
                   mf::scale(df_mul(df_mul(w[a], w[b]), G[a][b]), 2.0f));
    }
  }
  return out;
}

// dfscan._df_cramer: the weights of the k x k system (unguarded)
__device__ __noinline__ void cramer(const P2 (&G)[4][4], const P2 (&Y)[4],
                                    int k, P2 (&w)[4]) {
  if (k == 1) {
    w[0] = df_div(Y[0], G[0][0]);
  } else if (k == 2) {
    const P2 det = det2(G[0][0], G[1][1], G[0][1]);
    const P2 n1 = df_add(df_mul(Y[0], G[1][1]), neg(df_mul(G[0][1], Y[1])));
    const P2 n2 = df_add(df_mul(G[0][0], Y[1]), neg(df_mul(Y[0], G[0][1])));
    w[0] = df_div(n1, det);
    w[1] = df_div(n2, det);
  } else if (k == 3) {
    P2 m[3][3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) m[r][c] = G[r][c];
    const P2 det = det3(m);
    #pragma unroll 1
    for (int j = 0; j < 3; ++j) {
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) m[r][c] = c == j ? Y[r] : G[r][c];
      w[j] = df_div(det3(m), det);
    }
  } else {
    const P2 det = det4(G);
    P2 m[4][4];
    #pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) m[r][c] = c == j ? Y[r] : G[r][c];
      w[j] = df_div(det4(m), det);
    }
  }
}

__device__ __forceinline__ P2 nan2inf(P2 x) {
  return x.p != x.p ? P2{mf::kInf, 0.0f} : x;
}

__device__ __forceinline__ P2 df_where(bool c, P2 x, P2 y) { return c ? x : y; }

// dfscan._df_nnls2: the 2-variable NNLS, ops/nnls.lsqnonneg_2var's cases
__device__ __noinline__ void nnls2(P2 wy, P2 dA, P2 dB, P2 g, P2 pA, P2 pB,
                                   P2& w1, P2& w2, P2& res) {
  const P2 w1D = df_add(df_mul(dB, pA), neg(df_mul(g, pB)));
  const P2 w2D = df_add(df_mul(dA, pB), neg(df_mul(g, pA)));
  const P2 det = det2(dA, dB, g);
  const P2 G[4][4] = {{dA, g}, {g, dB}};
  const P2 Yf[4] = {pA, pB};
  const P2 wf[4] = {df_div(w1D, det), df_div(w2D, det)};
  const P2 res_f = quadres(wy, G, Yf, wf, 2);
  const P2 GA[4][4] = {{dA}}, GB[4][4] = {{dB}};
  const P2 YA[4] = {pA}, YB[4] = {pB};
  const P2 wA[4] = {df_div(pA, dA)}, wB[4] = {df_div(pB, dB)};
  const P2 res1 = quadres(wy, GA, YA, wA, 1);
  const P2 res2 = quadres(wy, GB, YB, wB, 1);

  const float v1 = val(w1D), v2 = val(w2D), a = val(pA), b = val(pB);
  const bool c1 = v1 > 0.0f && v2 > 0.0f;
  const bool c2 = !c1 && v1 >= 0.0f && v2 <= 0.0f;
  const bool c3 = !c1 && !c2 && v1 <= 0.0f && v2 >= 0.0f;
  const bool c4 = !c1 && !c2 && !c3 && v1 < 0.0f && v2 < 0.0f;
  const bool t1 = (c2 && a >= 0.0f) || (c4 && a > 0.0f);
  const bool t2 = (c3 && b >= 0.0f) || (c4 && a <= 0.0f && b > 0.0f);
  w1 = df_where(c1, wf[0], df_where(t1, wA[0], zero()));
  w2 = df_where(c1, wf[1], df_where(t2, wB[0], zero()));
  res = df_where(c1, nan2inf(res_f),
                 df_where(t1, res1, df_where(t2, res2, wy)));
}

// dfscan._df_nnls3: Cramer sign test, then the 2-subset fallback chain
__device__ __noinline__ void nnls3(P2 wy, const P2 (&G)[4][4],
                                   const P2 (&p)[4], float neg_tol3,
                                   P2 (&w)[4], P2& res) {
  P2 m[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) m[r][c] = G[r][c];
  const P2 det = det3(m);
  P2 D[3], wf[4] = {};
  #pragma unroll 1
  for (int j = 0; j < 3; ++j) {
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) m[r][c] = c == j ? p[r] : G[r][c];
    D[j] = det3(m);
    wf[j] = df_div(D[j], det);
  }
  const bool full = val(D[0]) >= neg_tol3 && val(D[1]) >= neg_tol3 &&
                    val(D[2]) >= neg_tol3;
  const P2 res_f = nan2inf(quadres(wy, G, p, wf, 3));

  P2 a12, b12, r12, a13, b13, r13, a23, b23, r23;
  nnls2(wy, G[0][0], G[1][1], G[0][1], p[0], p[1], a12, b12, r12);
  nnls2(wy, G[0][0], G[2][2], G[0][2], p[0], p[2], a13, b13, r13);
  nnls2(wy, G[1][1], G[2][2], G[1][2], p[1], p[2], a23, b23, r23);
  P2 fb[3] = {a12, b12, zero()}, fr = r12;
  if (df_lt(r13, fr)) {
    fb[0] = a13; fb[1] = zero(); fb[2] = b13; fr = r13;
  }
  if (df_lt(r23, fr)) {
    fb[0] = zero(); fb[1] = a23; fb[2] = b23; fr = r23;
  }
  for (int j = 0; j < 3; ++j) w[j] = full ? wf[j] : fb[j];
  res = full ? res_f : fr;
}

// dfscan._df_nnls4: every support in ascending mask order, strict
// improvement over the best so far (the empty support's y'y first)
__device__ __noinline__ void nnls4(P2 wy, const P2 (&G)[4][4],
                                   const P2 (&p)[4], P2 (&w)[4], P2& res) {
  for (int j = 0; j < 4; ++j) w[j] = zero();
  res = wy;
  #pragma unroll 1
  for (int mask = 1; mask < 16; ++mask) {
    int S[4], k = 0;
    for (int i = 0; i < 4; ++i) {
      if (mask >> i & 1) S[k++] = i;
    }
    P2 GS[4][4], YS[4], wS[4];
    for (int r = 0; r < k; ++r) {
      YS[r] = p[S[r]];
      for (int c = 0; c < k; ++c) GS[r][c] = G[S[r]][S[c]];
    }
    cramer(GS, YS, k, wS);
    bool feas = true;
    for (int a = 0; a < k; ++a) {
      const float va = val(wS[a]);
      feas = feas && va >= 0.0f && finite(va);
    }
    const P2 q = quadres(wy, GS, YS, wS, k);
    const float rv = (feas && q.p == q.p) ? q.p : mf::kInf;
    const P2 r = {rv, finite(rv) ? q.e : 0.0f};
    if (df_lt(r, res)) {
      for (int j = 0; j < 4; ++j) w[j] = zero();
      for (int a = 0; a < k; ++a) w[S[a]] = wS[a];
      res = r;
    }
  }
}

// One warp a voxel: cols (B, S, C), y (B, S) float32, raw scale; out w
// (B, C) raw-scale weights, res (B,) the raw residual.
template <int C>
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ cols, const float* __restrict__ y,
                float* __restrict__ w_out, float* __restrict__ res_out, int S,
                float neg_tol3) {
  constexpr int K = C + 1;
  const int b = blockIdx.x, lane = threadIdx.x;
  const float* cb = cols + (size_t)b * S * C;
  const float* yb = y + (size_t)b * S;
  auto at = [&](int s, int c) { return c < C ? cb[(size_t)s * C + c] : yb[s]; };

  // the scales: max |x| of each column, then the power of two above it
  float m[K];
  #pragma unroll
  for (int c = 0; c < K; ++c) m[c] = 0.0f;
  for (int s = lane; s < S; s += kThreads) {
    #pragma unroll
    for (int c = 0; c < K; ++c) m[c] = nan_max(m[c], fabsf(at(s, c)));
  }
  float sc[K];
  #pragma unroll
  for (int c = 0; c < K; ++c) {
    for (int off = 16; off > 0; off /= 2) {
      m[c] = nan_max(m[c], __shfl_xor_sync(0xffffffffu, m[c], off));
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
  for (int s = lane; s < S; s += kThreads) {
    int q1[K], q2[K];
    float r[K], a[K], x[K];
    #pragma unroll
    for (int c = 0; c < K; ++c) {
      const float z = mf::dv(at(s, c), sc[c]);
      q1[c] = level(z, 0.0078125f);
      const float A1 = mf::mul((float)q1[c], 0.0078125f);
      q2[c] = level(mf::sub(z, A1), 3.0517578125e-05f);
      a[c] = mf::add(A1, mf::mul((float)q2[c], 3.0517578125e-05f));
      r[c] = mf::sub(z, a[c]);
      x[c] = mf::add(a[c], r[c]);
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
          c1[i][j] += (double)x[i] * (double)r[j];
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
          t11[i][j] += __shfl_xor_sync(0xffffffffu, t11[i][j], off);
          t12[i][j] += __shfl_xor_sync(0xffffffffu, t12[i][j], off);
          t22[i][j] += __shfl_xor_sync(0xffffffffu, t22[i][j], off);
        }
        if (used(i, j)) {
          c1[i][j] += __shfl_xor_sync(0xffffffffu, c1[i][j], off);
          c2[i][j] += __shfl_xor_sync(0xffffffffu, c2[i][j], off);
        }
      }
    }
  }
  if (lane != 0) return;

  P2 M[K][K];
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
      M[i][j] = mf::df_from_sum(gv);
    }
  }
  P2 G[4][4], p[4], w[4];
  #pragma unroll
  for (int i = 0; i < C; ++i) {
    p[i] = M[i][C];
    #pragma unroll
    for (int j = 0; j < C; ++j) G[i][j] = M[i][j];
  }
  const P2 wy = M[C][C];
  P2 res;
  if constexpr (C == 1) {
    const P2 w0 = df_div(p[0], G[0][0]);
    const bool pos = val(p[0]) >= 0.0f;
    const P2 w1[4] = {w0};
    const P2 r = quadres(wy, G, p, w1, 1);
    w[0] = pos ? w0 : zero();
    res = pos ? r : wy;
  } else if constexpr (C == 2) {
    nnls2(wy, G[0][0], G[1][1], G[0][1], p[0], p[1], w[0], w[1], res);
  } else if constexpr (C == 3) {
    nnls3(wy, G, p, neg_tol3, w, res);
  } else {
    nnls4(wy, G, p, w, res);
  }
  // undo the scales (exact)
  const float sy = sc[C];
  #pragma unroll
  for (int c = 0; c < C; ++c) {
    w_out[(size_t)b * C + c] = mf::mul(val(w[c]), mf::dv(sy, sc[c]));
  }
  res_out[b] = mf::mul(val(res), mf::mul(sy, sy));
}

}  // namespace

extern "C" int mf_finalize(const float* cols, const float* y, float* w,
                           float* res, int B, int S, int C, float neg_tol3,
                           cudaStream_t stream) {
  if (C < 1 || C > 4 || S < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  switch (C) {
    case 1:
      finalize_kernel<1><<<B, kThreads, 0, stream>>>(cols, y, w, res, S,
                                                     neg_tol3);
      break;
    case 2:
      finalize_kernel<2><<<B, kThreads, 0, stream>>>(cols, y, w, res, S,
                                                     neg_tol3);
      break;
    case 3:
      finalize_kernel<3><<<B, kThreads, 0, stream>>>(cols, y, w, res, S,
                                                     neg_tol3);
      break;
    default:
      finalize_kernel<4><<<B, kThreads, 0, stream>>>(cols, y, w, res, S,
                                                     neg_tol3);
  }
  return (int)cudaGetLastError();
}
