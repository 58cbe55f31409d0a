// Kernel 6: the double-float [N1, N2] scan (df2_candidates at M = 1).
//
// Counterpart of ops/dfscan.df2_candidates (its plain version per row,
// df2_rows_twin), which the JAX package runs as plain XLA
// (microstructure_fingerprinting_tpu/ops/dfscan.py:428, jitted; no Pallas
// kernel). It serves one fascicle + CSF ([N, 1], the CSF column as the
// second axis) and two fascicles without CSF ([N, N]). For every voxel b
// and grid point (i1, i2): the double-float Gram g12 of gram_df.cuh (kernel
// 3's tile: exact int8 level products, the two float32 cross products as
// float64 sums rounded once, combined error-free), then the compensated
// bordered 3x3 determinant num12, det12, the weight numerators w1D, w2D and
// the reference's 2-variable case analysis (dfscan._two_var_cases) over the
// hoisted single-atom residuals. Out: per row i1 the least residual in IEEE
// total order (ops/nnls._tile_topm's order; a NaN, from an all-zero atom,
// ranks by its sign) and its first i2; rows past n1 (the operands' padding
// to N1p) give (+inf, 0) without loading anything.
// ops/dfscan.df2_top1_from_rows takes the first minimum across rows.
//
// What bounds it on an H100: operations, as kernel 3. Per point and sample
// two float64 and four int8 multiply-adds (the tile, on the tensor cores);
// per point a chain of ~200 explicitly rounded float32 operations, in
// Dekker's forms (df_dekker.cuh) so that every bit is the plain version's.
// The plain version materialises a (B, 256, N2) float64 Gram and dozens of
// float32 temporaries of that size a tile; here a point lives in registers
// from its Gram to its residual. The design, for this card:
//   * [N1, N2 > 1]: a 256-thread block owns 32 rows of one voxel and walks
//     their whole row, 64 columns a tile: the tile leaves its entries in the
//     mma layout, shared memory hands them to the chain's owner (thread
//     (ty, tx) has the 2 x 4 points at rows 2 ty + r, columns tx + 16 c),
//     and 32 threads, one a row, keep the row's running minimum; so a row
//     ends in the block with no second pass. Row values are staged once,
//     column values a tile, by cp.async under the tile's first chunk;
//   * [N1, 1]: a 64-column tile would spend 63/64 of its products on
//     padding. A thread a row sums its 552 samples itself (one load of each
//     row operand, coalesced across the warp; the column's sample is the
//     same for all): the float64 sums then run in sample order, another
//     order than the tile's (tests/test_torch_df2_kernel.py holds the plain
//     version in that order).
// The float64 sums take another order than the plain version's einsum, so
// the two can round a cross product to neighbouring float32 values at a
// near-tie (gram_df.cuh; testing.kernel_agreement).
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "df_dekker.cuh"
#include "gram_df.cuh"

namespace {

constexpr int TM = mf::kDfTM, TN = 64, kThreads = mf::kDfThreads;
// rows a block of the narrow path
constexpr int kNarrow = 128;
// entries of a row or column pack and of the voxel vector
// (ops/dfscan.df2_scan_operands)
constexpr int kPack = 8, kVox = 4;

using mf::df_mul;
using mf::neg;
using mf::P2;
using mf::val;

// a row's (i1) hoisted values: d1 = a1'a1, p = a1'y, Rp2 = p^2 (double
// floats), res1 = the residual of {1} alone
struct Row {
  P2 d1, p, Rp2;
  float res1;
};
// a column's (i2): d2, q = a2'y, X = d2 w - q^2, res2 of {2} alone
struct Col {
  P2 d2, q, X;
  float res2;
};

// a Row or Col from its pack: entries 0-6 at ``stride`` floats apart
template <class T>
__device__ __forceinline__ T load_pack(const float* v, int stride) {
  return {{v[0], v[stride]}, {v[2 * stride], v[3 * stride]},
          {v[4 * stride], v[5 * stride]}, v[6 * stride]};
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

// the residual of grid point (row, col) with Gram a: df2_candidates' chain
__device__ __forceinline__ float df2_point(P2 a, const Row& r, const Col& c,
                                           P2 wv, float wf) {
  const P2 parts[4] = {df_mul(r.d1, c.X), neg(df_mul(r.Rp2, c.d2)),
                       mf::scale(df_mul(a, df_mul(r.p, c.q)), 2.0f),
                       neg(df_mul(df_mul(a, a), wv))};
  const float num12 = mf::acc(parts);
  const float af = val(a), d1f = val(r.d1), pf = val(r.p);
  const float d2f = val(c.d2), qf = val(c.q);
  const float det12 = mf::sub(mf::mul(d1f, d2f), mf::mul(af, af));
  const float w1D = mf::sub(mf::mul(d2f, pf), mf::mul(af, qf));
  const float w2D = mf::sub(mf::mul(d1f, qf), mf::mul(af, pf));
  return two_var_cases(mf::dv(num12, det12), w1D, w2D, pf, qf, r.res1,
                       c.res2, wf);
}

// The block's shared memory: the Gram tile's buffers, which hold the low
// parts of a finished tile afterwards; the staged packs; the tile of the
// high parts, then of the residuals.
struct alignas(16) Smem {
  union {
    mf::GramDfSmem<TN> gram;
    float glo[TM][TN + 1];
  };
  float row[kPack][TM];
  float col[kPack][TN];
  float res[TM][TN + 1];
};

// two blocks an SM: at most 128 registers a thread
__global__ void __launch_bounds__(kThreads, 2)
df2scan_kernel(const int8_t* __restrict__ q1a, const int8_t* __restrict__ q2a,
               const float* __restrict__ a1h, const float* __restrict__ ra,
               const int8_t* __restrict__ q1b, const int8_t* __restrict__ q2b,
               const float* __restrict__ rb, const float* __restrict__ ab,
               const float* __restrict__ row_pack,
               const float* __restrict__ col_pack,
               const float* __restrict__ vox, float* __restrict__ row_val,
               int* __restrict__ row_i2, int S, int N1p, int N2pb, int n1,
               int n2) {
  extern __shared__ __align__(16) unsigned char dyn[];
  Smem& sm = *reinterpret_cast<Smem*>(dyn);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, row0 = blockIdx.x * TM;
  // a block of padded rows only: no point of the grid, nothing to load
  if (row0 >= n1) {
    if (tid < TM) {
      row_val[(size_t)b * N1p + row0 + tid] = mf::kInf;
      row_i2[(size_t)b * N1p + row0 + tid] = 0;
    }
    return;
  }

  // the rows' pack, 16 bytes a copy; joins the first tile's first chunk
  if (tid < kPack * (TM / 4)) {
    const int e = tid / (TM / 4), part = 4 * (tid % (TM / 4));
    mf::copy16_async(&sm.row[e][part],
                     row_pack + ((size_t)b * kPack + e) * N1p + row0 + part);
  }
  const P2 wv = {vox[b * kVox], vox[b * kVox + 1]};
  const float wf = vox[b * kVox + 2];

  // thread tid < TM: the running minimum of row row0 + tid
  int best_key = 0, best_j = 0;
  float best = mf::kInf;
  for (int col0 = 0; col0 < N2pb; col0 += TN) {
    // this tile's column pack; nobody reads sm.col since the last chain
    if (tid < kPack * (TN / 4)) {
      const int e = tid / (TN / 4), part = 4 * (tid % (TN / 4));
      mf::copy16_async(
          &sm.col[e][part],
          col_pack + ((size_t)b * kPack + e) * N2pb + col0 + part);
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

    #pragma unroll 1
    for (int r = 0; r < 2; ++r) {
      const int i = ty * 2 + r;
      const Row rw = load_pack<Row>(&sm.row[0][i], TM);
      #pragma unroll 1
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const Col cl = load_pack<Col>(&sm.col[0][j], TN);
        sm.res[i][j] = df2_point({sm.res[i][j], sm.glo[i][j]}, rw, cl, wv, wf);
      }
    }
    __syncthreads();

    // the row's minimum in total order, first column first; padded
    // columns (col0 + j >= n2) are not points of the grid
    if (tid < TM) {
      const int nj = min(TN, n2 - col0);
      for (int j = 0; j < nj; ++j) {
        const float v = sm.res[tid][j];
        const int k = mf::total_key(v);
        if ((col0 == 0 && j == 0) || k < best_key) {
          best_key = k;
          best_j = col0 + j;
          best = v;
        }
      }
    }
    // the next tile begins with a block barrier
  }
  if (tid < TM) {
    const int i = row0 + tid;
    const size_t o = (size_t)b * N1p + i;
    row_val[o] = i < n1 ? best : mf::kInf;
    row_i2[o] = i < n1 ? best_j : 0;
  }
}

// [N1, 1]: a thread a row, its five sums over the samples in order
__global__ void __launch_bounds__(kNarrow)
df2scan_narrow(const int8_t* __restrict__ q1a, const int8_t* __restrict__ q2a,
               const float* __restrict__ a1h, const float* __restrict__ ra,
               const int8_t* __restrict__ q1b, const int8_t* __restrict__ q2b,
               const float* __restrict__ rb, const float* __restrict__ ab,
               const float* __restrict__ row_pack,
               const float* __restrict__ col_pack,
               const float* __restrict__ vox, float* __restrict__ row_val,
               int* __restrict__ row_i2, int S, int N1p, int n1) {
  const int b = blockIdx.y, i = blockIdx.x * kNarrow + threadIdx.x;
  const size_t o = (size_t)b * N1p + i;
  // a padded row: no point of the grid, nothing to load
  if (i >= n1) {
    row_val[o] = mf::kInf;
    row_i2[o] = 0;
    return;
  }
  const size_t ao = (size_t)b * S * N1p + i, bo = (size_t)b * S;
  int t11 = 0, t12 = 0, t22 = 0;
  double c1 = 0.0, c2 = 0.0;
  #pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const size_t o = ao + (size_t)s * N1p;
    const int qa1 = q1a[o], qa2 = q2a[o];
    const int qb1 = __ldg(q1b + bo + s), qb2 = __ldg(q2b + bo + s);
    t11 += qa1 * qb1;
    t12 += qa1 * qb2 + qa2 * qb1;
    t22 += qa2 * qb2;
    c1 += (double)a1h[o] * (double)__ldg(rb + bo + s);
    c2 += (double)ra[o] * (double)__ldg(ab + bo + s);
  }
  // gram_df_tile's combine
  const float gv[5] = {mf::mul((float)t11, 6.103515625e-05f),
                       mf::mul((float)t12, 2.384185791015625e-07f),
                       mf::mul((float)t22, 9.313225746154785e-10f),
                       __double2float_rn(c1), __double2float_rn(c2)};
  const P2 a = mf::df_from_sum(gv);
  const Row rw = load_pack<Row>(row_pack + (size_t)b * kPack * N1p + i, N1p);
  const Col cl = load_pack<Col>(col_pack + (size_t)b * kPack, 1);
  const P2 wv = {vox[b * kVox], vox[b * kVox + 1]};
  row_val[o] = df2_point(a, rw, cl, wv, vox[b * kVox + 2]);
  row_i2[o] = 0;
}

}  // namespace

extern "C" int mf_df2scan(const int8_t* q1a, const int8_t* q2a,
                          const float* a1h, const float* ra,
                          const int8_t* q1b, const int8_t* q2b,
                          const float* rb, const float* ab,
                          const float* row_pack, const float* col_pack,
                          const float* vox, float* row_val, int* row_i2,
                          int B, int S, int N1p, int N2pb, int n1, int n2,
                          cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (n1 < 0 || n1 > N1p || n2 < 1 || n2 > N2pb) {
    return (int)cudaErrorInvalidValue;
  }
  if (N2pb == 1) {
    if (N1p % kNarrow) return (int)cudaErrorInvalidValue;
    dim3 grid(N1p / kNarrow, B);
    df2scan_narrow<<<grid, kNarrow, 0, stream>>>(
        q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox,
        row_val, row_i2, S, N1p, n1);
    return (int)cudaGetLastError();
  }
  if (N1p % TM || N2pb % TN) return (int)cudaErrorInvalidValue;
  if (!mf::gram_df_aligned(q1a, q2a, a1h, ra, q1b, q2b, rb, ab) ||
      (((uintptr_t)row_pack | (uintptr_t)col_pack) & 15)) {
    return (int)cudaErrorMisalignedAddress;
  }
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      df2scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N1p / TM, B);
  df2scan_kernel<<<grid, kThreads, smem, stream>>>(
      q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack, vox, row_val,
      row_i2, S, N1p, N2pb, n1, n2);
  return (int)cudaGetLastError();
}
