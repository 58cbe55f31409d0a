// The exact Gram tile of the f32 interval row passes (kernels 2 and 4).
//
// Device counterpart of microstructure_fingerprinting_tpu/ops/f32scan.py
// _gram_hi. A 256-thread block owns a 32-row x 64-column tile of the
// (i1, i2) grid of one voxel. Per point: the nine int8 level products of
// the three-level packs of kernel 1, grouped by scale (exact in int32), and
// the two bf16 corrections (exact products, float64 sums rounded once),
// summed in the TPU kernel's fixed order
// v_a + (v_b + (v_c + (c1 + (c2 + (v_d + v_e))))), the order KERR and KERR4
// were calibrated on.
//
// What bounds it on an H100: operations, and first the two float64
// correction products per sample and point (1.04 TFLOP per 512-voxel chunk
// at 782 x 782, S = 552: 15.5 ms at the float64 tensor rate), then the nine
// int8 products (4.7 POP, 2.4 ms at the int8 tensor rate). The design puts
// both on the tensor cores with mma.sync, in two passes over the samples so
// that neither pass holds the other's accumulators (a thread has 32 + 40
// accumulator registers in all):
//
//   pass 1, corrections: mma m16n8k8 in float64. The 8 warps tile the block
//     2 x 4, a warp owns 16 x 16 points: 2 mma per correction and 8
//     samples. 32-sample chunks of the four bf16 planes are copied as they
//     lie in device memory (cp.async, 16 bytes each, zeros beyond S) into
//     two buffers, chunk i + 1 in flight while chunk i is multiplied; a
//     value is widened at the fragment load (bf16 -> float is a shift,
//     float -> double is exact). A lane's two rows (columns) are
//     neighbours, rows 2g + mt of the warp's 16, so one 4-byte load feeds
//     both halves of the mma's m; plane rows are padded by 16 elements so
//     that the four samples of a fragment load fall on distinct banks.
//   pass 2, levels: mma m16n8k32 in int8, 18 per warp and chunk, chained on
//     five accumulator sets as the int32 sums are grouped. The levels are
//     copied as they lie (cp.async, 8 bytes each: rows padded by 8 bytes are
//     conflict-free but only 8-byte aligned) into three buffers, two chunks
//     in flight, one barrier a chunk. An mma register needs 4 samples of
//     one point where memory has 4 points of one sample: each lane loads
//     the 4 words of its two points and transposes them with 4 byte
//     permutes.
//
// Each thread finishes its 8 entries in the mma layout (scaling, the fixed
// float32 sum on CUDA cores) and the tile passes through shared memory to
// the callers' ownership: thread (ty, tx) = (tid / 16, tid % 16) owns the
// 2 x 4 points at rows ty * 2 + r and columns tx + 16 c.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "df32.cuh"
#include "mma_sync.cuh"

namespace mf {

constexpr int kHiTM = 32, kHiTN = 64, kHiSK = 32, kHiThreads = 256;
// padded rows of the staged planes: int8 levels (bytes), bf16 samples
// (elements), and of the float tile handed to the callers' ownership
constexpr int kHiQA = kHiTM + 8, kHiQB = kHiTN + 8;
constexpr int kHiFA = kHiTM + 16, kHiFB = kHiTN + 16;
constexpr int kHiEX = kHiTN + 8;

// 32-sample chunks of the operands as they lie in device memory: two
// buffers of the bf16 planes for the correction pass, then (over them) three
// of the int8 levels for the level pass, then the finished tile.
struct alignas(16) GramHiSmem {
  union {
    // bf16 bit patterns of the correction planes, [sample][point]
    struct {
      uint16_t sxa[kHiSK][kHiFA], sra[kHiSK][kHiFA];
      uint16_t srb[kHiSK][kHiFB], sab[kHiSK][kHiFB];
    } f[2];
    // int8 levels, [level][sample][point]
    struct {
      int8_t sqa[3][kHiSK][kHiQA];
      int8_t sqb[3][kHiSK][kHiQB];
    } q[3];
    float ex[kHiTM][kHiEX];
  };
};

// the two bf16 values at p (4-byte aligned), as doubles
__device__ __forceinline__ void widen2(const uint16_t* p, double (&v)[2]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  v[0] = (double)__uint_as_float(w << 16);
  v[1] = (double)__uint_as_float(w & 0xffff0000u);
}

// The tile copies its operands 8 and 16 bytes at a time: the launchers
// refuse packs that are not 16-byte aligned (their rows then are, T and N2B
// being multiples of 32).
inline bool gram_hi_aligned(const void* q123, const void* a1bf,
                            const void* rabf, const void* qb3,
                            const void* rbbf, const void* abbf) {
  return (((uintptr_t)q123 | (uintptr_t)a1bf | (uintptr_t)rabf |
           (uintptr_t)qb3 | (uintptr_t)rbbf | (uintptr_t)abbf) & 15) == 0;
}

// a[r][c]: the rounded Gram entry of the thread's point (row0 + ty*2 + r,
// col0 + tx + 16c) of voxel b. Operands are kernel 1's packs: q123/a1bf/rabf
// (B, nt, S, 3T | T) of the row block, qb3/rbbf/abbf (B, NB, S, 3N2B | N2B)
// of the column block, 16-byte aligned. Begins and ends with a block barrier.
__device__ __forceinline__ void gram_hi_tile(
    const int8_t* __restrict__ q123, const __nv_bfloat16* __restrict__ a1bf,
    const __nv_bfloat16* __restrict__ rabf, const int8_t* __restrict__ qb3,
    const __nv_bfloat16* __restrict__ rbbf,
    const __nv_bfloat16* __restrict__ abbf, int b, int S, int nt, int T,
    int NB, int N2B, int row0, int col0, GramHiSmem& sm, float (&a)[2][4]) {
  constexpr int TM = kHiTM, TN = kHiTN, SK = kHiSK, G = SK / 4;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ta = row0 / T, ia = row0 % T;         // row tile of the packs
  const int cb = col0 / N2B, jb = col0 % N2B;     // column block
  // the warp's 16 x 16 points; lane (g, kq) loads rows ra0 + mt and
  // columns cb0 + n, and holds the mma results at rows ra0 + mt, columns
  // wc * 16 + 2 (2 kq + e) + n
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, kq = lane % 4;
  const int ra0 = (warp / 4) * 16 + 2 * g, cb0 = (warp % 4) * 16 + 2 * g;
  const size_t abase = ((size_t)b * nt + ta) * S;
  const size_t bbase = ((size_t)b * NB + cb) * S;
  const int n_chunk = (S + SK - 1) / SK;

  // ---- pass 1: the two corrections -----------------------------------
  // bf16 x bf16 products are exact in double and the mma accumulates them
  // in float64; rounded once at the end. Chunk i + 1 is copied while chunk
  // i is multiplied.
  float cf1[2][2][2], cf2[2][2][2];               // [mt][n][e]
  {
    auto copy_chunk = [&](int chunk) {
      auto& f = sm.f[chunk % 2];
      const int s0 = chunk * SK;
      for (int k = tid; k < SK * (TM / 8); k += kHiThreads) {
        const int sl = k / (TM / 8), i = 8 * (k % (TM / 8));
        const bool in = s0 + sl < S;
        const size_t off = in ? (abase + s0 + sl) * T + ia + i : 0;
        cp_async<16>(&f.sxa[sl][i], a1bf + off, in);
        cp_async<16>(&f.sra[sl][i], rabf + off, in);
      }
      for (int k = tid; k < SK * (TN / 8); k += kHiThreads) {
        const int sl = k / (TN / 8), j = 8 * (k % (TN / 8));
        const bool in = s0 + sl < S;
        const size_t off = in ? (bbase + s0 + sl) * N2B + jb + j : 0;
        cp_async<16>(&f.srb[sl][j], rbbf + off, in);
        cp_async<16>(&f.sab[sl][j], abbf + off, in);
      }
      cp_async_commit();
    };
    double c1[2][2][2] = {}, c2[2][2][2] = {};
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
      const auto& f = sm.f[chunk % 2];
      // groups of 4 samples that hold a sample below S (block-uniform);
      // an mma takes two, the planes hold zeros beyond S
      const int ng = min(G, (S - chunk * SK + 3) / 4);
      #pragma unroll
      for (int gq = 0; gq < G; gq += 2) {
        if (gq >= ng) break;
        const int sl = 4 * gq + kq;
        double xa[2][2], ra[2][2], rb[2][2], ab[2][2];   // [k half][mt | n]
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          widen2(&f.sxa[sl + 4 * h][ra0], xa[h]);
          widen2(&f.sra[sl + 4 * h][ra0], ra[h]);
          widen2(&f.srb[sl + 4 * h][cb0], rb[h]);
          widen2(&f.sab[sl + 4 * h][cb0], ab[h]);
        }
        #pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma_f64(c1[0][n], c1[1][n], xa[0][0], xa[0][1], xa[1][0], xa[1][1],
                  rb[0][n], rb[1][n]);
          mma_f64(c2[0][n], c2[1][n], ra[0][0], ra[0][1], ra[1][0], ra[1][1],
                  ab[0][n], ab[1][n]);
        }
      }
      __syncthreads();
    }
    #pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      #pragma unroll
      for (int n = 0; n < 2; ++n) {
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          cf1[mt][n][e] = __double2float_rn(c1[mt][n][e]);
          cf2[mt][n][e] = __double2float_rn(c2[mt][n][e]);
        }
      }
    }
  }

  // ---- pass 2: the nine level products ---------------------------------
  // exact in int32, grouped by scale as the TPU kernel's int32 sums. Three
  // buffers: chunks i + 1 and i + 2 are copied while chunk i is multiplied,
  // one barrier a chunk. A group is committed every turn (an empty one past
  // the last chunk), so "at most one in flight" always means chunk i is in.
  int t11[2][4] = {}, t12[2][4] = {}, t22[2][4] = {}, t23[2][4] = {},
      t33[2][4] = {};                             // [n][2 mt + e]
  {
    auto copy_chunk = [&](int chunk) {
      if (chunk < n_chunk) {
        auto& q = sm.q[chunk % 3];
        const int s0 = chunk * SK;
        for (int k = tid; k < 3 * SK * (TM / 8); k += kHiThreads) {
          const int l = k / (SK * (TM / 8)), sl = (k / (TM / 8)) % SK;
          const int i = 8 * (k % (TM / 8));
          const bool in = s0 + sl < S;
          const size_t off =
              in ? (abase + s0 + sl) * 3 * T + l * T + ia + i : 0;
          cp_async<8>(&q.sqa[l][sl][i], q123 + off, in);
        }
        for (int k = tid; k < 3 * SK * (TN / 8); k += kHiThreads) {
          const int l = k / (SK * (TN / 8)), sl = (k / (TN / 8)) % SK;
          const int j = 8 * (k % (TN / 8));
          const bool in = s0 + sl < S;
          const size_t off =
              in ? (bbase + s0 + sl) * 3 * N2B + l * N2B + jb + j : 0;
          cp_async<8>(&q.sqb[l][sl][j], qb3 + off, in);
        }
      }
      cp_async_commit();
    };
    // the word of the lane's two rows (columns) and where they lie in it
    const int wa = ra0 & ~3, wb = cb0 & ~3;
    const uint32_t sel = (g & 1) ? 0x7362u : 0x5140u;
    copy_chunk(0);
    copy_chunk(1);
    for (int chunk = 0; chunk < n_chunk; ++chunk) {
      cp_async_wait<1>();
      __syncthreads();
      copy_chunk(chunk + 2);       // over chunk - 1, which every warp has left
      const auto& q = sm.q[chunk % 3];
      // a register = the 4 samples of group kq (kq + 4 for the upper half of
      // k) of one point; zeros beyond S
      int qa[3][4], qb[3][2][2];
      #pragma unroll
      for (int l = 0; l < 3; ++l) {
        pack2x4(&q.sqa[l][4 * kq][wa], kHiQA, sel, qa[l][0], qa[l][1]);
        pack2x4(&q.sqa[l][4 * kq + 16][wa], kHiQA, sel, qa[l][2], qa[l][3]);
        pack2x4(&q.sqb[l][4 * kq][wb], kHiQB, sel, qb[l][0][0], qb[l][1][0]);
        pack2x4(&q.sqb[l][4 * kq + 16][wb], kHiQB, sel, qb[l][0][1],
                qb[l][1][1]);
      }
      #pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma_s8(t11[n], qa[0], qb[0][n]);
        mma_s8(t12[n], qa[0], qb[1][n]);
        mma_s8(t12[n], qa[1], qb[0][n]);
        mma_s8(t22[n], qa[1], qb[1][n]);
        mma_s8(t22[n], qa[0], qb[2][n]);
        mma_s8(t22[n], qa[2], qb[0][n]);
        mma_s8(t23[n], qa[1], qb[2][n]);
        mma_s8(t23[n], qa[2], qb[1][n]);
        mma_s8(t33[n], qa[2], qb[2][n]);
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();

  // each entry finished in the mma layout (the fixed float32 sum), then
  // handed to its owner in the callers' layout through shared memory
  #pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    #pragma unroll
    for (int n = 0; n < 2; ++n) {
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * mt + e;
        const float v_a = mul((float)t11[n][i], 6.103515625e-05f);
        const float v_b = mul((float)t12[n][i], 2.384185791015625e-07f);
        const float v_c = mul((float)t22[n][i], 9.313225746154785e-10f);
        const float v_d = mul((float)t23[n][i], 3.637978807091713e-12f);
        const float v_e = mul((float)t33[n][i], 1.4210854715202004e-14f);
        sm.ex[ra0 + mt][(warp % 4) * 16 + 2 * (2 * kq + e) + n] =
            add(v_a, add(v_b, add(v_c, add(cf1[mt][n][e],
                                           add(cf2[mt][n][e],
                                               add(v_d, v_e))))));
      }
    }
  }
  __syncthreads();
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    #pragma unroll
    for (int c = 0; c < 4; ++c) a[r][c] = sm.ex[ty * 2 + r][tx + 16 * c];
  }
  __syncthreads();
}

}  // namespace mf
