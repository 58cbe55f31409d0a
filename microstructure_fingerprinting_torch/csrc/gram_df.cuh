// The double-float Gram tile of the re-scans (kernels 3 and 5).
//
// Device counterpart of microstructure_fingerprinting_tpu/ops/pallas_dfscan.py
// _df_gram_ps. A 256-thread block owns a 32-row x TN-column tile (TN = 64 in
// kernel 3, 32 in kernel 5) of the (i1, i2) grid of one voxel. Per point: the
// exact int8 [Q1|Q2] level products t11, t12, t22 (int32) and the two
// true-float32 cross products c1 = A1h' Rb and c2 = Ra' ab (exact float64
// products, float64 sums rounded once to float32), combined error-free into
// a double-float (hi, lo).
//
// What bounds it on an H100: operations. Per sample and point two float64
// multiply-adds and four int8 ones: on the plain float64 pipe, with both
// operands converted from float32 by every thread and sample (a
// quarter-rate operation), the tile took nine tenths of kernel 3 and two
// thirds of kernel 5. The design puts both on the tensor cores, in one pass
// over the samples:
//
//   * the 8 warps tile the block 2 x 4; a warp owns 16 rows x TN / 4 columns,
//     NT = TN / 32 mma column tiles of 8;
//   * cross products: mma m16n8k8 in float64, 2 NT per product and 8 samples.
//     A float32 value is widened where the fragment is loaded (exact), once
//     for the whole mma: 16 conversions feed 128 multiply-adds of a lane at
//     TN = 64 (12 feed 64 at TN = 32), where the scalar code spent 12 on 16.
//     Shared memory keeps float32: fragments of float64 would double the
//     bytes of the fragment loads, which at 16 bytes a lane and mma already
//     take as long as the mma itself;
//   * level products: mma m16n8k32 in int8, one depth a 32-sample chunk,
//     four products into three accumulator sets (t12 takes two). An mma
//     register needs 4 samples of one point where memory has 4 points of one
//     sample: a lane loads the 4 words of its points and transposes them
//     with byte permutes (mma_sync.cuh);
//   * a lane's two rows are neighbours (rows 2 g + mt of the warp's 16), so
//     one 8-byte (float) or 4-byte (int8) load feeds both halves of the
//     mma's m; at TN = 64 its two columns likewise. The int32 and float64
//     accumulators of the two mma shapes sit at the same (row, column) of a
//     lane, so the five values of a point meet in one thread;
//   * copies ahead of the products: 32-sample chunks of the eight operand
//     planes are copied as they lie in device memory (cp.async, 16 bytes
//     each, zeros beyond S) into two buffers, chunk i + 1 in flight while
//     chunk i is multiplied. Rows are padded (8 floats, 16 bytes of int8)
//     so that the four samples of a fragment load fall on distinct banks
//     and every copy lands 16-byte aligned.
//
// The float64 sums take the samples in the tensor cores' order (8 an mma,
// chunk after chunk), another order than the plain version's one einsum. A
// product of two float32 values carries 48 bits, so the float64 sum is not
// exact and the two orders can round to neighbouring float32 values at a
// near-tie (about one entry in 10^8): testing.kernel_agreement counts such
// entries, and tests/test_torch_gram_df_tile.py holds the plain version in
// this order against itself.
#pragma once

#include <stdint.h>

#include "async_copy.cuh"
#include "df32.cuh"
#include "mma_sync.cuh"

namespace mf {

constexpr int kDfTM = 32, kDfSK = 32, kDfThreads = 256, kDfBufs = 2;

// kDfBufs chunks of kDfSK samples of the operands, [sample][point], rows
// padded: levels by 16 bytes, float32 planes by 8 values
template <int TN>
struct alignas(16) GramDfSmem {
  static_assert(TN == 32 || TN == 64, "a warp owns 16 x TN / 4 points");
  static constexpr int QA = kDfTM + 16, QB = TN + 16;
  static constexpr int FA = kDfTM + 8, FB = TN + 8;
  struct Chunk {
    int8_t q1a[kDfSK][QA], q2a[kDfSK][QA], q1b[kDfSK][QB], q2b[kDfSK][QB];
    float a1h[kDfSK][FA], ra[kDfSK][FA], rb[kDfSK][FB], ab[kDfSK][FB];
  } chunk[kDfBufs];
};

// Where a thread's entries a[mt][n][e] of gram_df_tile lie in the tile.
template <int TN>
struct GramDfAt {
  int i0, j0;
  __device__ int row(int mt) const { return i0 + mt; }
  __device__ int col(int n, int e) const { return j0 + (TN / 32) * e + n; }
};

// The tile copies its operands 16 bytes at a time: the launchers refuse
// operands that are not 16-byte aligned (their rows then are, N1p and N2pb
// being multiples of 32).
inline bool gram_df_aligned(const void* q1a, const void* q2a, const void* a1h,
                            const void* ra, const void* q1b, const void* q2b,
                            const void* rb, const void* ab) {
  return (((uintptr_t)q1a | (uintptr_t)q2a | (uintptr_t)a1h | (uintptr_t)ra |
           (uintptr_t)q1b | (uintptr_t)q2b | (uintptr_t)rb | (uintptr_t)ab) &
          15) == 0;
}

// a[mt][n][e]: the double-float Gram entry (hi, lo) of the point (row0 +
// at.row(mt), col0 + at.col(n, e)) of voxel b, at being the returned map.
// Operands (B, S, N1p) of the rows (q1a, q2a int8; a1h, ra float32) and
// (B, S, N2pb) of the columns (q1b, q2b int8; rb, ab float32), 16-byte
// aligned. Copies that the caller has started and not committed join the
// first chunk's group. Begins and ends with a block barrier.
template <int TN>
__device__ __forceinline__ GramDfAt<TN> gram_df_tile(
    const int8_t* __restrict__ q1a, const int8_t* __restrict__ q2a,
    const float* __restrict__ a1h, const float* __restrict__ ra,
    const int8_t* __restrict__ q1b, const int8_t* __restrict__ q2b,
    const float* __restrict__ rb, const float* __restrict__ ab, int b, int S,
    int N1p, int N2pb, int row0, int col0, GramDfSmem<TN>& sm,
    P2 (&a)[2][TN / 32][2]) {
  using Sm = GramDfSmem<TN>;
  constexpr int TM = kDfTM, SK = kDfSK, NT = TN / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, kq = lane % 4;
  // lane (g, kq) loads rows ra0 + mt and columns cb0 + n, and holds the mma
  // results at rows ra0 + mt, columns j0 + NT e + n
  const int ra0 = (warp / 4) * 16 + 2 * g;
  const int cb0 = (warp % 4) * 8 * NT + NT * g;
  const GramDfAt<TN> at = {ra0, (warp % 4) * 8 * NT + 2 * NT * kq};
  const size_t abase = (size_t)b * S * N1p + row0;
  const size_t bbase = (size_t)b * S * N2pb + col0;
  const int n_chunk = (S + SK - 1) / SK;

  // What this thread copies of every chunk, 16 bytes each, the same place
  // in each chunk: of both float planes of the rows the sample fa_s at
  // points fa_i.., of the columns' NT such samples; the levels of the rows
  // by warps 4 and 5, of the columns by the first 2 NT warps.
  constexpr int CA = TM / 4, CB = TN / 4, DA = TM / 16, DB = TN / 16;
  static_assert(SK * CA == kDfThreads && SK * CB == NT * kDfThreads &&
                SK * DA == 64 && SK * DB == NT * 64, "copies a thread");
  const int fa_s = tid / CA, fa_i = 4 * (tid % CA);
  const int fb_s = tid / CB, fb_i = 4 * (tid % CB);
  const int ta = tid % 64;
  const int qa_s = ta / DA, qa_i = 16 * (ta % DA);
  const int qb_s = tid / DB, qb_i = 16 * (tid % DB);
  const bool does_qa = tid / 64 == 2, does_qb = tid < NT * 64;
  const size_t fa_o = abase + (size_t)fa_s * N1p + fa_i;
  const size_t fb_o = bbase + (size_t)fb_s * N2pb + fb_i;
  const size_t qa_o = abase + (size_t)qa_s * N1p + qa_i;
  const size_t qb_o = bbase + (size_t)qb_s * N2pb + qb_i;

  auto copy_chunk = [&](int chunk) {
    auto& f = sm.chunk[chunk % kDfBufs];
    const int s0 = chunk * SK;
    {
      const bool in = s0 + fa_s < S;
      const size_t o = in ? fa_o + (size_t)s0 * N1p : 0;
      cp_async<16>(&f.a1h[fa_s][fa_i], a1h + o, in);
      cp_async<16>(&f.ra[fa_s][fa_i], ra + o, in);
    }
    #pragma unroll
    for (int m = 0; m < NT; ++m) {
      const int sl = fb_s + m * (kDfThreads / CB);
      const bool in = s0 + sl < S;
      const size_t o =
          in ? fb_o + (size_t)(s0 + m * (kDfThreads / CB)) * N2pb : 0;
      cp_async<16>(&f.rb[sl][fb_i], rb + o, in);
      cp_async<16>(&f.ab[sl][fb_i], ab + o, in);
    }
    if (does_qa) {
      const bool in = s0 + qa_s < S;
      const size_t o = in ? qa_o + (size_t)s0 * N1p : 0;
      cp_async<16>(&f.q1a[qa_s][qa_i], q1a + o, in);
      cp_async<16>(&f.q2a[qa_s][qa_i], q2a + o, in);
    }
    if (does_qb) {
      const bool in = s0 + qb_s < S;
      const size_t o = in ? qb_o + (size_t)s0 * N2pb : 0;
      cp_async<16>(&f.q1b[qb_s][qb_i], q1b + o, in);
      cp_async<16>(&f.q2b[qb_s][qb_i], q2b + o, in);
    }
    cp_async_commit();
  };

  int t11[NT][4] = {}, t12[NT][4] = {}, t22[NT][4] = {};   // [n][2 mt + e]
  double c1[2][NT][2] = {}, c2[2][NT][2] = {};             // [mt][n][e]
  // the word of the lane's two rows and where they lie in it; its column(s)
  const int wa = ra0 & ~3, wb = cb0 & ~3;
  const uint32_t sel_a = (g & 1) ? 0x7362u : 0x5140u;
  const uint32_t sel_b = NT == 2 ? sel_a : 0x40u + 0x11u * (cb0 & 3);

  __syncthreads();
  copy_chunk(0);
  for (int chunk = 0; chunk < n_chunk; ++chunk) {
    if (chunk + 1 < n_chunk) {
      copy_chunk(chunk + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const auto& f = sm.chunk[chunk % kDfBufs];

    // levels: a register = 4 samples of one point, zeros beyond S. The
    // int32 sums do not depend on the order, so the mma's k index 4 kq + u
    // takes sample kq + 4 u of its half of the chunk, rows and columns
    // alike: the four lanes kq of a load then read neighbouring samples,
    // which the row padding puts on distinct banks
    {
      int qa1[4], qa2[4], qb1[NT][2], qb2[NT][2];
      pack2x4(&f.q1a[kq][wa], 4 * Sm::QA, sel_a, qa1[0], qa1[1]);
      pack2x4(&f.q1a[kq + 16][wa], 4 * Sm::QA, sel_a, qa1[2], qa1[3]);
      pack2x4(&f.q2a[kq][wa], 4 * Sm::QA, sel_a, qa2[0], qa2[1]);
      pack2x4(&f.q2a[kq + 16][wa], 4 * Sm::QA, sel_a, qa2[2], qa2[3]);
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sl = kq + 16 * h;
        if constexpr (NT == 2) {
          pack2x4(&f.q1b[sl][wb], 4 * Sm::QB, sel_b, qb1[0][h], qb1[1][h]);
          pack2x4(&f.q2b[sl][wb], 4 * Sm::QB, sel_b, qb2[0][h], qb2[1][h]);
        } else {
          qb1[0][h] = pack1x4(&f.q1b[sl][wb], 4 * Sm::QB, sel_b);
          qb2[0][h] = pack1x4(&f.q2b[sl][wb], 4 * Sm::QB, sel_b);
        }
      }
      #pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_s8(t11[n], qa1, qb1[n]);
        mma_s8(t12[n], qa1, qb2[n]);
        mma_s8(t12[n], qa2, qb1[n]);
        mma_s8(t22[n], qa2, qb2[n]);
      }
    }

    // cross products: float32 x float32 is exact in float64 and the mma
    // accumulates in float64; the planes hold zeros beyond S (no branch:
    // the four steps' loads and conversions run ahead of each other)
    #pragma unroll
    for (int k8 = 0; k8 < SK / 8; ++k8) {
      const int sl = 8 * k8 + kq;
      double xa[2][2], xr[2][2], xb[2][NT], xab[2][NT];    // [k half][mt | n]
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 va =
            *reinterpret_cast<const float2*>(&f.a1h[sl + 4 * h][ra0]);
        const float2 vr =
            *reinterpret_cast<const float2*>(&f.ra[sl + 4 * h][ra0]);
        xa[h][0] = (double)va.x;
        xa[h][1] = (double)va.y;
        xr[h][0] = (double)vr.x;
        xr[h][1] = (double)vr.y;
        if constexpr (NT == 2) {
          const float2 vb =
              *reinterpret_cast<const float2*>(&f.rb[sl + 4 * h][cb0]);
          const float2 vab =
              *reinterpret_cast<const float2*>(&f.ab[sl + 4 * h][cb0]);
          xb[h][0] = (double)vb.x;
          xb[h][1] = (double)vb.y;
          xab[h][0] = (double)vab.x;
          xab[h][1] = (double)vab.y;
        } else {
          xb[h][0] = (double)f.rb[sl + 4 * h][cb0];
          xab[h][0] = (double)f.ab[sl + 4 * h][cb0];
        }
      }
      #pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_f64(c1[0][n], c1[1][n], xa[0][0], xa[0][1], xa[1][0], xa[1][1],
                xb[0][n], xb[1][n]);
        mma_f64(c2[0][n], c2[1][n], xr[0][0], xr[0][1], xr[1][0], xr[1][1],
                xab[0][n], xab[1][n]);
      }
    }
    __syncthreads();
  }

  #pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    #pragma unroll
    for (int n = 0; n < NT; ++n) {
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * mt + e;
        const float gv[5] = {
            mul((float)t11[n][i], 6.103515625e-05f),
            mul((float)t12[n][i], 2.384185791015625e-07f),
            mul((float)t22[n][i], 9.313225746154785e-10f),
            __double2float_rn(c1[mt][n][e]), __double2float_rn(c2[mt][n][e])};
        a[mt][n][e] = df_from_sum(gv);
      }
    }
  }
  return at;
}

}  // namespace mf
