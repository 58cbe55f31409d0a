// Kernel 12: the hoists of the [N1, N2, 1] (flagship) interval row pass.
//
// Counterpart of the JAX package's rowmin_3(pallas=True) between its prep
// and its pallas_call (microstructure_fingerprinting_tpu/ops/f32scan.py:
// 367-372 and 395-440: the small _gram3_hi Grams, the block-1 row intervals,
// the block-1-free floor, the column lows, the chain prefixes and the packs;
// XLA fuses them into the jit of the kernel) and of its plain version here,
// ops/f32scan.row3_hoist_twin. From kernel 1's Grams gramA (B, 16, N1p) and
// gramB (B, 16, N2pb) (row 0 <x, x>, row 1 <x, y>, row 2 <x, a3>) and the
// normalised small columns yh (B, S) and A3h (B, S, 1) (kernel 13's
// outputs) it writes kernel 2's operands in the layout that csrc/rowmin3.cu
// reads: row_pack (B, 16, N1p) (d1, invd1, kap_p, rho1, kap_b, d1p, invd1p,
// kap_pp, rho13, lo_row, up_row, stab1, then 4 zero rows), col_pack
// (B, 8, N2pb) (d2, q, c, d2p, q2p, kap_c, then 2 zero rows) and vox (B, 8)
// (u3, invd3, then 6 zeros); and the per-column lows lo_c_sup (B, N2pb) and
// the floor upf (B,).
//
// What bounds it on an H100: bytes. Per atom it reads 3 Gram entries and
// writes 16 (row) or 9 (column) entries; the chain is ~60 float32
// operations a row and ~50 a column (chip_smoke.ROW3_CHAIN_OPS). The plain
// version runs each operation as one torch kernel: ~800 kernels a call.
// Its first design had every block of a voxel, 14 a voxel at 782 x 782,
// quantise the voxel's 2 small columns and sum its 3 small Grams one a
// thread in sample order, 552 dependent steps each: 4% of its bound. The
// design is kernel 11's (csrc/row4hoist.cu; the shared parts in
// csrc/hoist.cuh):
//   * a voxel launch (row3vox_kernel), a block a voxel, quantises the 2
//     small columns once and sums the 3 small Grams (w, d3, r3) in kParts
//     strided parts added in part order (hoist::vox_grams, kernel 11's
//     pass; testing.fdot_parts_order); it writes vox and the scratch
//     (B, kScr) = (w, d3, r3, 1 / d3) that the atom launch reads;
//   * the atom launch (row3hoist_kernel): blocks 0 .. N1p/128 - 1 own 128
//     rows of one voxel, the next ones 128 columns; a thread one atom. A
//     thread reads its voxel's scratch, runs its atom's chain and writes
//     its pack entries straight to device memory (coalesced: the atom axis
//     is the pack's contiguous one);
//   * upf is a minimum over every column of a voxel, across column blocks:
//     each column block writes the minimum of its columns' upper bounds
//     (by shuffles; the first block also the voxel's own supports {3} and
//     {}) to a scratch row of partials, and a third launch folds them, a
//     thread a voxel (hoist::fold_min).
// Plain float32 as the plain version computes it, operation for operation
// (--fmad=false; 1 / x the IEEE quotient, as torch's reciprocal), the
// branches of _sanit, _interval, _sub1 and _sub2 (det_tol = 0: the K = 3
// case logic) as they are, and torch.minimum / amin NaN-first
// (hoist::tmin): bit for bit, padded atoms' inf and NaN included (a zero
// Gram gives invd1 = 1 / 0 = inf), with the float64 sums of the small Grams
// in the parts' order (testing.fdot_parts_order; in the einsum's order the
// two agree by testing.kernel_agreement).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hoist.cuh"
#include "phases.cuh"

namespace {

using mf::add;
using mf::dv;
using mf::mul;
using mf::sub;
using mf::hoist::Consts;
using mf::hoist::fold;
using mf::hoist::Interval;
using mf::hoist::kAtoms;
using mf::hoist::sub1;
using mf::hoist::sub2;
using mf::hoist::tmin;

// rows of kernel 1's Grams (ops/prep: gram (B, 16, Np))
constexpr int kGramRows = 16;
// the pack sizes csrc/rowmin3.cu reads, and the entries written before the
// zero padding
constexpr int kRowPack = 16, kColPack = 8, kVox = 8;
constexpr int kRowUsed = 12, kColUsed = 6;

// the voxel launch's threads a block: a tile of the 2 small columns, a
// sample a thread
constexpr int kVoxThreads = 2 * mf::hoist::kVoxTile;
// the voxel scratch (B, kScr): w, d3, r3, 1 / d3
constexpr int kScr = 4;

// the small columns of voxel b: 0 the signal, 1 the CSF column
struct Cols {
  const float* y;
  const float* a3;
  __device__ float operator()(int c, int s) const {
    return c == 0 ? y[s] : a3[s];
  }
};

// the small Grams (qa, qb): 0 w = (y, y), 1 d3 = (a3, a3), 2 r3 = (a3, y)
struct Pair {
  __device__ int2 operator()(int t) const {
    return t == 0 ? make_int2(0, 0) : make_int2(1, t == 1 ? 1 : 0);
  }
};

// The voxel's prologue, a block a voxel: the small Grams, vox and the
// scratch.
__global__ void __launch_bounds__(kVoxThreads)
row3vox_kernel(const float* __restrict__ yh, const float* __restrict__ A3h,
               float* __restrict__ vox, float* __restrict__ scr, int S) {
  __shared__ mf::hoist::VoxGrams<2, 3> sm;
  __shared__ float vg[3];
  const int b = blockIdx.x;
  MF_PHASE_BEGIN;
  const size_t vS = (size_t)b * S;
  mf::hoist::vox_grams<2, 3, kVoxThreads>(sm, vg, Cols{yh + vS, A3h + vS}, 2,
                                          Pair{}, 3, S);
  MF_PHASE(0);
  // the voxel's values: eliminate the CSF column first
  if (threadIdx.x == 0) {
    const float w = vg[0], d3 = vg[1], r3 = vg[2];
    const float invd3 = dv(1.0f, d3);
    const float u3 = mul(r3, invd3);
    float* vx = vox + (size_t)b * kVox;
    vx[0] = u3;
    vx[1] = invd3;
    for (int e = 2; e < kVox; ++e) vx[e] = 0.0f;
    reinterpret_cast<float4*>(scr)[b] = make_float4(w, d3, r3, invd3);
  }
}

// The atoms' chains: row and column blocks of 128 atoms of one voxel.
__global__ void __launch_bounds__(kAtoms)
row3hoist_kernel(const float* __restrict__ gramA,
                 const float* __restrict__ gramB,
                 const float* __restrict__ scr, float* __restrict__ row_pack,
                 float* __restrict__ col_pack, float* __restrict__ lo_c_sup,
                 float* __restrict__ part, int N1p, int N2pb, Consts k) {
  __shared__ float red[kAtoms / 32];
  const int tid = threadIdx.x, b = blockIdx.y;
  const int row_blocks = N1p / kAtoms;
  const bool is_row = blockIdx.x < row_blocks;
  const int cb = blockIdx.x - row_blocks;  // column block
  const int i = (is_row ? blockIdx.x : cb) * kAtoms + tid;
  MF_PHASE_BEGIN;

  // the voxel's values
  const float4 v = __ldg(reinterpret_cast<const float4*>(scr) + b);
  const float w = v.x, d3 = v.y, r3 = v.z, invd3 = v.w;
  MF_PHASE(1);

  if (is_row) {
    const size_t st = (size_t)N1p;
    const float* gA = gramA + (size_t)b * kGramRows * st + i;
    float* rp = row_pack + (size_t)b * kRowPack * st + i;
    const float d1 = gA[0], p = gA[st], bb = gA[2 * st];
    // the row's intervals of the block-1 supports {1}, {1, 3}
    Interval acc = sub1(d1, p, w, k);
    fold(acc, sub2(d1, d3, bb, p, r3, w, 0.0f, k));
    // the prefixes of the progressive chains
    const float invd1 = dv(1.0f, d1);
    const float kap_p = mul(p, invd1);
    const float rho1 = sub(w, mul(p, kap_p));
    const float kap_b = mul(bb, invd3);
    const float d1p = sub(d1, mul(bb, kap_b));
    const bool stab1 = d1p > mul(k.eps, d1);
    const float invd1p = stab1 ? dv(1.0f, d1p) : 0.0f;
    const float p1p = sub(p, mul(kap_b, r3));
    const float kap_pp = mul(p1p, invd1p);
    const float rho13 =
        sub(sub(w, mul(mul(r3, r3), invd3)), mul(p1p, kap_pp));
    const float rows[kRowUsed] = {d1,    invd1,  kap_p,  rho1,
                                  kap_b, d1p,    invd1p, kap_pp,
                                  rho13, acc.lo, acc.up, stab1 ? 1.0f : 0.0f};
    #pragma unroll
    for (int e = 0; e < kRowPack; ++e) {
      rp[(size_t)e * st] = e < kRowUsed ? rows[e] : 0.0f;
    }
    MF_PHASE(2);
    return;
  }

  // a column: its chain pieces, its low over the supports {2}, {2, 3} and
  // its part of the floor
  const size_t st = (size_t)N2pb;
  const float* gB = gramB + (size_t)b * kGramRows * st + i;
  float* cp = col_pack + (size_t)b * kColPack * st + i;
  const float d2 = gB[0], q = gB[st], c = gB[2 * st];
  const float u3 = mul(r3, invd3);
  Interval acc = sub1(d2, q, w, k);
  fold(acc, sub2(d2, d3, c, q, r3, w, 0.0f, k));
  const float cols[kColUsed] = {d2, q, c, sub(d2, mul(mul(c, c), invd3)),
                                sub(q, mul(c, u3)), mul(c, invd3)};
  #pragma unroll
  for (int e = 0; e < kColPack; ++e) {
    cp[(size_t)e * st] = e < kColUsed ? cols[e] : 0.0f;
  }
  lo_c_sup[(size_t)b * N2pb + i] = acc.lo;
  MF_PHASE(2);

  // the block's part of the floor upf, a minimum (exact in any order, a
  // NaN winning: hoist::fold_min) by shuffles a warp, then over the warps;
  // the first column block adds the voxel's block-1-free supports {3} and
  // {}
  float m = acc.up;
  for (int off = 16; off > 0; off /= 2) {
    m = tmin(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (tid % 32 == 0) red[tid / 32] = m;
  __syncthreads();
  if (tid == 0) {
    m = red[0];
    for (int t = 1; t < kAtoms / 32; ++t) m = tmin(m, red[t]);
    if (cb == 0) m = tmin(tmin(sub1(d3, r3, w, k).up, add(w, k.kerr)), m);
    part[(size_t)b * (gridDim.x - row_blocks) + cb] = m;
  }
  MF_PHASE(3);
}

}  // namespace

MF_PHASE_API(mf_row3hoist_phases)

extern "C" int mf_row3hoist(const float* gramA, const float* gramB,
                            const float* yh, const float* A3h,
                            float* row_pack, float* col_pack, float* vox,
                            float* lo_c_sup, float* scr, float* part,
                            float* upf, int B, int S, int N1p, int N2pb,
                            float eps, float kerr, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (S < 1 || N1p < kAtoms || N2pb < kAtoms || N1p % kAtoms ||
      N2pb % kAtoms) {
    return (int)cudaErrorInvalidValue;
  }
  // scr (B, kScr): the voxel's values; part (B, N2pb / kAtoms): a partial
  // minimum a column block
  row3vox_kernel<<<B, kVoxThreads, 0, stream>>>(yh, A3h, vox, scr, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = N1p / kAtoms, col_blocks = N2pb / kAtoms;
  dim3 grid(row_blocks + col_blocks, B);
  // the K = 3 case logic has no determinant cutoff: sub2 takes det_tol = 0
  // and reads no tol
  row3hoist_kernel<<<grid, kAtoms, 0, stream>>>(
      gramA, gramB, scr, row_pack, col_pack, lo_c_sup, part, N1p, N2pb,
      Consts{eps, 0.0f, kerr});
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mf::hoist::fold_min<float><<<(B + 127) / 128, 128, 0, stream>>>(
      part, upf, B, col_blocks);
  return (int)cudaGetLastError();
}
