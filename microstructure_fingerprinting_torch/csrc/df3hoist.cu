// Kernel 10: the prologue of the double-float [N1, N2, 1] re-scan.
//
// Counterpart of the JAX package's row_scan_df3 before its pallas_call
// (microstructure_fingerprinting_tpu/ops/pallas_dfscan.py:258-401: quantize2
// of the blocks and the signal, the nine df_grams, the compensated chain with
// _two_var_cases, the ps_stack packs and padb; XLA fuses them into the jit of
// the kernel) and of its plain version here, ops/rescan.df3_hoist_twin
// (_hoists and the packing of row_scan_df3_operands). From the normalised
// blocks A1h (B, S, N1p), A2h (B, S, N2), A3h (B, S, 1) and yh (B, S) it
// writes kernel 3's operands: the int8 levels and float32 planes of both
// blocks (q1a, q2a, ra; q1b, q2b, rb, ab, the columns past N2 zero),
// row_pack (B, 38, N1p), col_pack (B, 58, N2pb) (zero past N2, as the plain
// version pads after its chain) and vox (B, 24), in the layout that kernel 3
// reads (csrc/rescan3.cu rowdf / coldf / voxdf). a1h is A1h itself.
//
// What bounds it on an H100: bytes. Each block reads its atoms once and
// writes their levels, planes and packs once (~0.8 GB a 512-voxel chunk at
// 128 x 128); per atom and sample 3 Grams of 4 int32 multiply-adds and 2
// float64 fused multiply-adds; per atom a chain of ~1,000 float32 operations
// (Dekker products of 24). The plain version runs every double-float
// operation of the chain as several torch kernels on (B, N) tensors: ~3,000
// kernels a call, each a few microseconds on the card. The design, for this
// card (kernel 8's, csrc/df4hoist.cu, with no EAR columns; the skeleton in
// hoist.cuh):
//   * one launch a call: blocks 0 .. N1p/128 - 1 own 128 rows of A1 of one
//     voxel, the next ones 128 columns of A2; a thread one atom; the
//     (1, CSF, EAR) bucket's [N, E, 1] grid is the same launch with one
//     column block of E live threads;
//   * every block sums the voxel's 3 small Grams (w, d3, r3), one a thread
//     in sample order, so all blocks of a voxel agree; the first block
//     writes vox;
//   * the atom's 3 Grams stay in registers through the pass, then its chain
//     writes each pack entry straight to device memory (coalesced: the atom
//     axis is the pack's contiguous one).
// Every operation mirrors the plain version's, in Dekker's forms and its
// operand order (a Dekker product's error term depends on it), the case
// logic branch for branch (mf::two_var_cases, shared with kernel 3): bit for
// bit, NaN included (an all-zero padded row gives res1 = res13 = 0/0), but
// for the float64 cross sums' order (testing.kernel_agreement).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hoist.cuh"

namespace {

using mf::df_add;
using mf::df_mul;
using mf::dv;
using mf::neg;
using mf::P2;
using mf::scale;
using mf::val;
using mf::hoist::kAtoms;

// pack layout (ops/rescan._hoists; kernel 3's kRowQuads, kColQuads, kVox):
// double-float quadruples (hi, lo, hh, hl), then the single floats
constexpr int kRowQuads = 9, kColQuads = 14, kVoxQuads = 4, kVox = 24;
constexpr int kRowPack = 4 * kRowQuads + 2, kColPack = 4 * kColQuads + 2;

// the small columns of voxel b: 0 the signal, 1 the CSF column
struct Cols {
  const float* y;
  const float* a3;
  __device__ float operator()(int c, int s) const {
    return c == 0 ? y[s] : a3[s];
  }
};

// the voxel Grams a block sums: 0 w = g(y, y), 1 d3 = g(a3, a3),
// 2 r3 = g(a3, y)
struct Pairs {
  __device__ int2 operator()(int t) const {
    return t == 0 ? make_int2(0, 0) : make_int2(1, t == 1 ? 1 : 0);
  }
};

__global__ void __launch_bounds__(kAtoms)
df3hoist_kernel(const float* __restrict__ A1h, const float* __restrict__ A2h,
                const float* __restrict__ A3h, const float* __restrict__ yh,
                int8_t* __restrict__ q1a, int8_t* __restrict__ q2a,
                float* __restrict__ ra, int8_t* __restrict__ q1b,
                int8_t* __restrict__ q2b, float* __restrict__ rb,
                float* __restrict__ ab, float* __restrict__ row_pack,
                float* __restrict__ col_pack, float* __restrict__ vox, int S,
                int N1p, int N2, int N2pb) {
  __shared__ mf::hoist::Tile<2> tile;
  __shared__ P2 vg_sm[3];
  const int tid = threadIdx.x, b = blockIdx.y;
  const int row_blocks = N1p / kAtoms;
  const bool is_row = blockIdx.x < row_blocks;
  const int i = (is_row ? blockIdx.x : blockIdx.x - row_blocks) * kAtoms + tid;
  const int width = is_row ? N1p : N2;    // atoms of the block's input
  const int padded = is_row ? N1p : N2pb; // atoms of its outputs
  const bool live = i < padded, real = i < width;

  const size_t vS = (size_t)b * S;
  const float* atom = (is_row ? A1h : A2h) + vS * width + i;
  const size_t oo = vS * padded + i;
  const mf::hoist::AtomOut out =
      is_row ? mf::hoist::AtomOut{q1a + oo, q2a + oo, ra + oo, nullptr,
                                  nullptr, (size_t)N1p}
             : mf::hoist::AtomOut{q1b + oo, q2b + oo, rb + oo, ab + oo,
                                  nullptr, (size_t)N2pb};
  mf::hoist::Gram vg = mf::hoist::gram_zero(), self = mf::hoist::gram_zero();
  mf::hoist::Gram g[2] = {mf::hoist::gram_zero(), mf::hoist::gram_zero()};
  mf::hoist::stream<2>(tile, Cols{yh + vS, A3h + vS}, 2, S, Pairs{}, 3, vg,
                       atom, (size_t)width, live, real, out, self, g);
  if (tid < 3) vg_sm[tid] = mf::hoist::gram_value(vg);
  __syncthreads();
  if (!live) return;

  // the voxel's values (_hoists: C2v, res3_only)
  const P2 w = vg_sm[0], d3 = vg_sm[1], r3 = vg_sm[2];
  const float wf = val(w), r3v = val(r3);
  const float res3_only = mf::sub(wf, dv(mf::mul(r3v, r3v), val(d3)));
  const P2 C2v = df_add(df_mul(r3, r3), neg(df_mul(d3, w)));
  if (blockIdx.x == 0 && tid == 0) {
    float* vx = vox + (size_t)b * kVox;
    const P2 vq[kVoxQuads] = {C2v, w, d3, r3};
    #pragma unroll
    for (int k = 0; k < kVoxQuads; ++k) mf::hoist::put_ps(vx, 1, 4 * k, vq[k]);
    vx[4 * kVoxQuads] = wf;
    for (int e = 4 * kVoxQuads + 1; e < kVox; ++e) vx[e] = 0.0f;
  }

  if (is_row) {
    float* rp = row_pack + (size_t)b * kRowPack * N1p + i;
    const size_t st = (size_t)N1p;
    const P2 d1 = mf::hoist::gram_value(self);
    const P2 p = mf::hoist::gram_value(g[0]);
    const P2 b_ = mf::hoist::gram_value(g[1]);
    const P2 Rb2 = df_mul(b_, b_), Rbp = df_mul(b_, p), Rp2 = df_mul(p, p);
    const float res1 = dv(val(df_add(df_mul(d1, w), neg(Rp2))), val(d1));
    const P2 det13 = df_add(df_mul(d1, d3), neg(Rb2));
    const P2 n13[5] = {df_mul(df_mul(d1, d3), w),
                       neg(df_mul(df_mul(d1, r3), r3)), neg(df_mul(Rb2, w)),
                       scale(df_mul(df_mul(b_, p), r3), 2.0f),
                       neg(df_mul(d3, Rp2))};
    const float res13_full = dv(mf::acc(n13), val(det13));
    const P2 w1t[2] = {df_mul(d3, p), neg(df_mul(b_, r3))};
    const P2 w2t[2] = {df_mul(d1, r3), neg(df_mul(b_, p))};
    const float res13 =
        mf::two_var_cases(res13_full, mf::acc(w1t), mf::acc(w2t), val(p),
                          r3v, res1, res3_only, wf);
    const P2 rowD2a = df_add(df_mul(r3, b_), neg(df_mul(d3, p)));
    const P2 rowEG = df_add(df_mul(p, b_), neg(df_mul(d1, r3)));
    const P2 rq[kRowQuads] = {Rb2, Rbp, d1, Rp2, b_, p, rowD2a, rowEG, det13};
    #pragma unroll
    for (int k = 0; k < kRowQuads; ++k) mf::hoist::put_ps(rp, st, 4 * k, rq[k]);
    rp[(size_t)(4 * kRowQuads) * st] = res1;
    rp[(size_t)(4 * kRowQuads + 1) * st] = res13;
    return;
  }

  float* cp = col_pack + (size_t)b * kColPack * N2pb + i;
  const size_t st = (size_t)N2pb;
  if (!real) {  // a padded column: zeros, as the plain version pads
    for (int e = 0; e < kColPack; ++e) cp[(size_t)e * st] = 0.0f;
    return;
  }
  const P2 d2 = mf::hoist::gram_value(self);
  const P2 q = mf::hoist::gram_value(g[0]);
  const P2 c = mf::hoist::gram_value(g[1]);
  const P2 Cq2 = df_mul(q, q), Cc2 = df_mul(c, c), Ccq = df_mul(c, q);
  const P2 U1 = df_add(Cq2, neg(df_mul(d2, w)));
  const P2 U2 = scale(df_add(df_mul(d2, r3), neg(Ccq)), 2.0f);
  const P2 U3 = df_add(df_add(df_add(df_mul(d2, neg(C2v)), neg(df_mul(d3, Cq2))),
                              scale(df_mul(Ccq, r3), 2.0f)),
                       neg(df_mul(Cc2, w)));
  const P2 U4 = df_add(Cc2, neg(df_mul(d2, d3)));
  const P2 V1 = scale(df_add(df_mul(c, w), neg(df_mul(q, r3))), 2.0f);
  const P2 V2 = scale(df_add(df_mul(d3, q), neg(df_mul(c, r3))), 2.0f);
  const P2 X1c = df_add(df_mul(d2, w), neg(Cq2));
  const float res2 = dv(val(X1c), val(d2));
  const P2 det23 = df_add(df_mul(d2, d3), neg(Cc2));
  const P2 n23[5] = {df_mul(df_mul(d2, d3), w),
                     neg(df_mul(df_mul(d2, r3), r3)), neg(df_mul(Cc2, w)),
                     scale(df_mul(Ccq, r3), 2.0f), neg(df_mul(d3, Cq2))};
  const float res23_full = dv(mf::acc(n23), val(det23));
  const P2 w1t[2] = {df_mul(d3, q), neg(df_mul(c, r3))};
  const P2 w2t[2] = {df_mul(d2, r3), neg(df_mul(c, q))};
  const float res23 =
      mf::two_var_cases(res23_full, mf::acc(w1t), mf::acc(w2t), val(q), r3v,
                        res2, res3_only, wf);
  const P2 colB = df_add(df_mul(c, r3), neg(df_mul(q, d3)));
  const P2 colC = df_add(df_mul(q, c), neg(df_mul(r3, d2)));
  const P2 cq[kColQuads] = {U1, U2, U3,  U4,    V1,   V2,   X1c,
                            d2, q,  c,   det23, colB, colC, Ccq};
  #pragma unroll
  for (int k = 0; k < kColQuads; ++k) mf::hoist::put_ps(cp, st, 4 * k, cq[k]);
  cp[(size_t)(4 * kColQuads) * st] = res2;
  cp[(size_t)(4 * kColQuads + 1) * st] = res23;
}

}  // namespace

extern "C" int mf_df3hoist(const float* A1h, const float* A2h,
                           const float* A3h, const float* yh, int8_t* q1a,
                           int8_t* q2a, float* ra, int8_t* q1b, int8_t* q2b,
                           float* rb, float* ab, float* row_pack,
                           float* col_pack, float* vox, int B, int S, int N1p,
                           int N2, int N2pb, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (S < 1 || N1p % kAtoms || N2 < 1 || N2pb < N2) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(N1p / kAtoms + (N2pb + kAtoms - 1) / kAtoms, B);
  df3hoist_kernel<<<grid, kAtoms, 0, stream>>>(
      A1h, A2h, A3h, yh, q1a, q2a, ra, q1b, q2b, rb, ab, row_pack, col_pack,
      vox, S, N1p, N2, N2pb);
  return (int)cudaGetLastError();
}
