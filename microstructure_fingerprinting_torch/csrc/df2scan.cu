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
//     their whole row, 64 columns a tile, with gram_df.cuh's tile
//     arithmetic (the 8 warps 2 x 4, a warp 16 x 16 points: int8 m16n8k32
//     and float64 m16n8k8 mma, 32-sample chunks). The sample chunks run as
//     one ring of kStages buffers across the tiles: a chunk's copy
//     (cp.async, 16 bytes each) is issued right after the one block barrier
//     a chunk, which both publishes chunk i and frees the buffer of chunk
//     i - 1; the packs ride with the chunks (the rows' once, a tile's
//     columns with its first chunk, double-buffered by tile). A warp whose
//     16 rows or 16 columns of a tile are all padding (the last row band,
//     the last column tile) skips their products. The tile's Grams go
//     through shared memory to the chain's owners (thread (ty, tx): rows
//     2 ty, 2 ty + 1, columns tx + 16 c), which keep a running (total-order
//     key, column) a row across the tiles, visiting their columns in
//     increasing order; at the block's end a row's 16 threads, a half-warp,
//     merge theirs by shuffles, lexicographic on (key, column), so the
//     lowest column wins an exact tie. (A chain in the mma's own layout,
//     without the move, measured slower on the card: PERF.md.) The
//     chunk's copies and products are gram_df_tile's, written out here for
//     the ring: taken out of gram_df.cuh into shared pieces, they changed
//     kernel 3's code and slowed it on the card;
//   * [N1, 1]: a 64-column tile would spend 63/64 of its products on
//     padding. A thread a row sums its 552 samples itself (one load of each
//     row operand, coalesced across the warp; the column's sample is the
//     same for all): the float64 sums then run in sample order, another
//     order than the tile's (tests/test_torch_df2_kernel.py holds the plain
//     version in that order).
// The float64 sums take another order than the plain version's einsum, so
// the two can round a cross product to neighbouring float32 values at a
// near-tie (gram_df.cuh; testing.kernel_agreement).
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "df_dekker.cuh"
#include "gram_df.cuh"
#include "mma_sync.cuh"
#include "phases.cuh"

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

// the block's shared memory: kStages chunks of the operands (gram_df.cuh's
// layout and padding), the tile's Grams on their way to the chain, the
// packs
constexpr int kStages = 2;
using Chunk = mf::GramDfSmem<TN>::Chunk;
struct alignas(16) Smem {
  Chunk chunk[kStages];
  float res[TM][TN + 1], glo[TM][TN + 1];  // the tile's Grams, hi and lo
  float row[kPack][TM];                    // the rows' packs
  float col[2][kPack][TN];                 // the columns' packs, by tile
};

// (key, column) lexicographic: a < b
__device__ __forceinline__ bool key_lt(int ka, int ja, int kb, int jb) {
  return ka < kb || (ka == kb && ja < jb);
}

// the float of a total-order key (mf::total_key is its own inverse)
__device__ __forceinline__ float key_val(int k) {
  return __int_as_float(k < 0 ? k ^ 0x7fffffff : k);
}

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
  constexpr int SK = mf::kDfSK, NT = TN / 32;
  using Sm = mf::GramDfSmem<TN>;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, row0 = blockIdx.x * TM;
  // a block of padded rows only: no point of the grid, nothing to load
  if (row0 >= n1) {
    if (tid < TM) {
      row_val[(size_t)b * N1p + row0 + tid] = mf::kInf;
      row_i2[(size_t)b * N1p + row0 + tid] = 0;
    }
    return;
  }
  MF_PHASE_BEGIN;

  // lane (g, kq) loads rows ra0 + mt and columns cb0 + n, and holds the mma
  // results at rows ra0 + mt, columns j0 + NT e + n (gram_df.cuh)
  const int g = lane / 4, kq = lane % 4;
  const int ra0 = (warp / 4) * 16 + 2 * g;
  const int cb0 = (warp % 4) * 8 * NT + NT * g;
  const int j0 = (warp % 4) * 8 * NT + 2 * NT * kq;
  // a warp whose 16 rows are all padding computes nothing
  const bool rows_live = row0 + (warp / 4) * 16 < n1;
  const int n_chunk = (S + SK - 1) / SK, n_tile = N2pb / TN;
  const int steps = n_chunk * n_tile;
  const size_t abase = (size_t)b * S * N1p + row0;

  // What this thread copies of every chunk, 16 bytes each (gram_df_tile's
  // split): of both float planes of the rows the sample fa_s at points
  // fa_i.., of the columns' NT such samples; the levels of the rows by
  // warps 4 and 5, of the columns by the first 2 NT warps.
  constexpr int CA = TM / 4, CB = TN / 4, DA = TM / 16, DB = TN / 16;
  static_assert(SK * CA == kThreads && SK * CB == NT * kThreads &&
                SK * DA == 64 && SK * DB == NT * 64, "copies a thread");
  const int fa_s = tid / CA, fa_i = 4 * (tid % CA);
  const int fb_s = tid / CB, fb_i = 4 * (tid % CB);
  const int ta = tid % 64;
  const int qa_s = ta / DA, qa_i = 16 * (ta % DA);
  const int qb_s = tid / DB, qb_i = 16 * (tid % DB);
  const bool does_qa = tid / 64 == 2, does_qb = tid < NT * 64;

  // step k of the ring: chunk k % n_chunk of column tile k / n_chunk
  auto copy_step = [&](int k) {
    if (k < steps) {
      Chunk& f = sm.chunk[k % kStages];
      const int s0 = (k % n_chunk) * SK;
      const size_t bbase = (size_t)b * S * N2pb + (k / n_chunk) * TN;
      {
        const bool in = s0 + fa_s < S;
        const size_t o = in ? abase + (size_t)(s0 + fa_s) * N1p + fa_i : 0;
        mf::cp_async<16>(&f.a1h[fa_s][fa_i], a1h + o, in);
        mf::cp_async<16>(&f.ra[fa_s][fa_i], ra + o, in);
      }
      #pragma unroll
      for (int m = 0; m < NT; ++m) {
        const int sl = fb_s + m * (kThreads / CB);
        const bool in = s0 + sl < S;
        const size_t o = in ? bbase + (size_t)(s0 + sl) * N2pb + fb_i : 0;
        mf::cp_async<16>(&f.rb[sl][fb_i], rb + o, in);
        mf::cp_async<16>(&f.ab[sl][fb_i], ab + o, in);
      }
      if (does_qa) {
        const bool in = s0 + qa_s < S;
        const size_t o = in ? abase + (size_t)(s0 + qa_s) * N1p + qa_i : 0;
        mf::cp_async<16>(&f.q1a[qa_s][qa_i], q1a + o, in);
        mf::cp_async<16>(&f.q2a[qa_s][qa_i], q2a + o, in);
      }
      // the tile's column packs join its first chunk; the rows' the first
      if (k % n_chunk == 0 && tid < kPack * (TN / 4)) {
        const int e = tid / (TN / 4), part = 4 * (tid % (TN / 4));
        mf::copy16_async(&sm.col[(k / n_chunk) % 2][e][part],
                         col_pack + ((size_t)b * kPack + e) * N2pb +
                             (k / n_chunk) * TN + part);
      }
      if (k == 0 && tid < kPack * (TM / 4)) {
        const int e = tid / (TM / 4), part = 4 * (tid % (TM / 4));
        mf::copy16_async(&sm.row[e][part],
                         row_pack + ((size_t)b * kPack + e) * N1p + row0 +
                             part);
      }
      if (does_qb) {
        const bool in = s0 + qb_s < S;
        const size_t o = in ? bbase + (size_t)(s0 + qb_s) * N2pb + qb_i : 0;
        mf::cp_async<16>(&f.q1b[qb_s][qb_i], q1b + o, in);
        mf::cp_async<16>(&f.q2b[qb_s][qb_i], q2b + o, in);
      }
    }
    mf::cp_async_commit();  // a group a step, empty past the last
  };

  const P2 wv = {vox[b * kVox], vox[b * kVox + 1]};
  const float wf = vox[b * kVox + 2];
  // the running minimum of each of the thread's chain rows
  int best_key[2] = {INT_MAX, INT_MAX}, best_j[2] = {INT_MAX, INT_MAX};
  // the word of the lane's two rows and where they lie in it; its columns
  const int wa = ra0 & ~3, wb = cb0 & ~3;
  const uint32_t sel_a = (g & 1) ? 0x7362u : 0x5140u;
  const uint32_t sel_b = sel_a;
  static_assert(NT == 2, "a lane's two columns share a word");

  #pragma unroll
  for (int k = 0; k < kStages - 1; ++k) copy_step(k);
  for (int tile = 0; tile < n_tile; ++tile) {
    const int col0 = tile * TN;
    const bool live = rows_live && col0 + (warp % 4) * 16 < n2;
    int t11[NT][4] = {}, t12[NT][4] = {}, t22[NT][4] = {};   // [n][2 mt + e]
    double c1[2][NT][2] = {}, c2[2][NT][2] = {};             // [mt][n][e]
    for (int chunk = 0; chunk < n_chunk; ++chunk) {
      const int step = tile * n_chunk + chunk;
      // chunk `step` has landed (kStages - 2 younger groups in flight);
      // the barrier publishes it and frees the buffer of step - 1 for
      // step + kStages - 1
      mf::cp_async_wait<kStages - 2>();
      __syncthreads();
      copy_step(step + kStages - 1);
      if (!live) continue;
      const Chunk& f = sm.chunk[step % kStages];

      // levels (gram_df_tile): a register = 4 samples of one point, zeros
      // beyond S; the mma's k index 4 kq + u takes sample kq + 4 u of its
      // half of the chunk
      {
        int qa1[4], qa2[4], qb1[NT][2], qb2[NT][2];
        mf::pack2x4(&f.q1a[kq][wa], 4 * Sm::QA, sel_a, qa1[0], qa1[1]);
        mf::pack2x4(&f.q1a[kq + 16][wa], 4 * Sm::QA, sel_a, qa1[2], qa1[3]);
        mf::pack2x4(&f.q2a[kq][wa], 4 * Sm::QA, sel_a, qa2[0], qa2[1]);
        mf::pack2x4(&f.q2a[kq + 16][wa], 4 * Sm::QA, sel_a, qa2[2], qa2[3]);
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sl = kq + 16 * h;
          mf::pack2x4(&f.q1b[sl][wb], 4 * Sm::QB, sel_b, qb1[0][h], qb1[1][h]);
          mf::pack2x4(&f.q2b[sl][wb], 4 * Sm::QB, sel_b, qb2[0][h], qb2[1][h]);
        }
        #pragma unroll
        for (int n = 0; n < NT; ++n) {
          mf::mma_s8(t11[n], qa1, qb1[n]);
          mf::mma_s8(t12[n], qa1, qb2[n]);
          mf::mma_s8(t12[n], qa2, qb1[n]);
          mf::mma_s8(t22[n], qa2, qb2[n]);
        }
      }

      // cross products: float32 x float32 is exact in float64 and the mma
      // accumulates in float64, 8 samples an mma in sample order
      #pragma unroll
      for (int k8 = 0; k8 < SK / 8; ++k8) {
        const int sl = 8 * k8 + kq;
        double xa[2][2], xr[2][2], xb[2][NT], xab[2][NT];  // [k half][mt | n]
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 va =
              *reinterpret_cast<const float2*>(&f.a1h[sl + 4 * h][ra0]);
          const float2 vr =
              *reinterpret_cast<const float2*>(&f.ra[sl + 4 * h][ra0]);
          const float2 vb =
              *reinterpret_cast<const float2*>(&f.rb[sl + 4 * h][cb0]);
          const float2 vab =
              *reinterpret_cast<const float2*>(&f.ab[sl + 4 * h][cb0]);
          xa[h][0] = (double)va.x;
          xa[h][1] = (double)va.y;
          xr[h][0] = (double)vr.x;
          xr[h][1] = (double)vr.y;
          xb[h][0] = (double)vb.x;
          xb[h][1] = (double)vb.y;
          xab[h][0] = (double)vab.x;
          xab[h][1] = (double)vab.y;
        }
        #pragma unroll
        for (int n = 0; n < NT; ++n) {
          mf::mma_f64(c1[0][n], c1[1][n], xa[0][0], xa[0][1], xa[1][0],
                      xa[1][1], xb[0][n], xb[1][n]);
          mf::mma_f64(c2[0][n], c2[1][n], xr[0][0], xr[0][1], xr[1][0],
                      xr[1][1], xab[0][n], xab[1][n]);
        }
      }
    }
    MF_PHASE(0);
    if (live) {
      // the tile's Grams to the chain's owners
      #pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          #pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int i = 2 * mt + e;
            const float gv[5] = {
                mf::mul((float)t11[n][i], 6.103515625e-05f),
                mf::mul((float)t12[n][i], 2.384185791015625e-07f),
                mf::mul((float)t22[n][i], 9.313225746154785e-10f),
                __double2float_rn(c1[mt][n][e]),
                __double2float_rn(c2[mt][n][e])};
            const P2 a = mf::df_from_sum(gv);
            sm.res[ra0 + mt][j0 + NT * e + n] = a.p;
            sm.glo[ra0 + mt][j0 + NT * e + n] = a.e;
          }
        }
      }
    }
    __syncthreads();
    MF_PHASE(1);
    // thread (ty, tx): rows 2 ty + r, columns tx + 16 c, in increasing
    // order, so < keeps the first column of a tie
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 2 * ty + r;
      const Row rw = load_pack<Row>(&sm.row[0][i], TM);
      #pragma unroll 1
      for (int c = 0; c < 4; ++c) {
        const int jl = tx + 16 * c, j = col0 + jl;
        if (j >= n2) break;  // padded columns are not points of the grid
        const Col cl = load_pack<Col>(&sm.col[tile % 2][0][jl], TN);
        const float v = df2_point({sm.res[i][jl], sm.glo[i][jl]}, rw, cl,
                                  wv, wf);
        const int k = mf::total_key(v);
        if (k < best_key[r]) {
          best_key[r] = k;
          best_j[r] = j;
        }
      }
    }
    MF_PHASE(2);
    // the next tile's chunks begin with a block barrier: every chain of
    // this tile is done before its Grams take res and glo
  }

  // the row minima: a row's 16 threads (a half-warp), lexicographic on
  // (key, column)
  mf::cp_async_wait<0>();
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    #pragma unroll
    for (int off = 1; off < 16; off *= 2) {
      const int ko = __shfl_xor_sync(0xffffffffu, best_key[r], off);
      const int jo = __shfl_xor_sync(0xffffffffu, best_j[r], off);
      if (key_lt(ko, jo, best_key[r], best_j[r])) {
        best_key[r] = ko;
        best_j[r] = jo;
      }
    }
    if (tx == 0) {
      const int i = row0 + 2 * ty + r;
      const size_t o = (size_t)b * N1p + i;
      row_val[o] = i < n1 ? key_val(best_key[r]) : mf::kInf;
      row_i2[o] = i < n1 ? best_j[r] : 0;
    }
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

MF_PHASE_API(mf_df2scan_phases)

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
