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
// version runs each operation as one torch kernel: ~800 kernels a call. The
// design is kernel 11's (csrc/row4hoist.cu; the shared parts in
// csrc/hoist.cuh):
//   * one launch a call: blocks 0 .. N1p/128 - 1 own 128 rows of one voxel,
//     the next ones 128 columns; a thread one atom;
//   * every block quantises the voxel's 2 small columns a tile of kTile
//     samples at a time into shared memory and sums the 3 small Grams (w,
//     d3, r3), one a thread in sample order (int32 level sums, float64 sums
//     of the bf16 corrections), so all blocks of a voxel hold the same bits
//     (every block of a voxel sums them again: a known cost, small beside
//     the packs at S = 552); the first block writes vox;
//   * a thread runs its atom's chain and writes its pack entries straight
//     to device memory (coalesced: the atom axis is the pack's contiguous
//     one);
//   * upf is a minimum over every column of a voxel, across column blocks:
//     each column block writes the minimum of its columns' upper bounds
//     (the first one also the voxel's own supports {3} and {}) to a scratch
//     row of partials, and a second launch of the same call folds them, a
//     thread a voxel.
// Plain float32 as the plain version computes it, operation for operation
// (--fmad=false; 1 / x the IEEE quotient, as torch's reciprocal), the
// branches of _sanit, _interval, _sub1 and _sub2 (det_tol = 0: the K = 3
// case logic) as they are, and torch.minimum / amin NaN-first
// (hoist::tmin): bit for bit, padded atoms' inf and NaN included (a zero
// Gram gives invd1 = 1 / 0 = inf), but for the order of the float64 sums of
// the small Grams (testing.kernel_agreement).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hoist.cuh"

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

struct Smem {
  mf::hoist::Tile3<2> tile;
  float vg[3];
  float red[kAtoms];
};

__global__ void __launch_bounds__(kAtoms)
row3hoist_kernel(const float* __restrict__ gramA,
                 const float* __restrict__ gramB,
                 const float* __restrict__ yh, const float* __restrict__ A3h,
                 float* __restrict__ row_pack, float* __restrict__ col_pack,
                 float* __restrict__ vox, float* __restrict__ lo_c_sup,
                 float* __restrict__ part, int S, int N1p, int N2pb,
                 Consts k) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, b = blockIdx.y;
  const int row_blocks = N1p / kAtoms;
  const bool is_row = blockIdx.x < row_blocks;
  const int cb = blockIdx.x - row_blocks;  // column block
  const int i = (is_row ? blockIdx.x : cb) * kAtoms + tid;

  // the small Grams, one a thread in sample order
  const size_t vS = (size_t)b * S;
  const float g =
      mf::hoist::small_grams(sm.tile, Cols{yh + vS, A3h + vS}, 2, S, Pair{}, 3);
  if (tid < 3) sm.vg[tid] = g;
  __syncthreads();

  // the voxel's values: eliminate the CSF column first
  const float w = sm.vg[0], d3 = sm.vg[1], r3 = sm.vg[2];
  const float invd3 = dv(1.0f, d3);
  const float u3 = mul(r3, invd3);
  if (blockIdx.x == 0 && tid == 0) {
    float* vx = vox + (size_t)b * kVox;
    vx[0] = u3;
    vx[1] = invd3;
    for (int e = 2; e < kVox; ++e) vx[e] = 0.0f;
  }

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
    return;
  }

  // a column: its chain pieces, its low over the supports {2}, {2, 3} and
  // its part of the floor
  const size_t st = (size_t)N2pb;
  const float* gB = gramB + (size_t)b * kGramRows * st + i;
  float* cp = col_pack + (size_t)b * kColPack * st + i;
  const float d2 = gB[0], q = gB[st], c = gB[2 * st];
  Interval acc = sub1(d2, q, w, k);
  fold(acc, sub2(d2, d3, c, q, r3, w, 0.0f, k));
  const float cols[kColUsed] = {d2, q, c, sub(d2, mul(mul(c, c), invd3)),
                                sub(q, mul(c, u3)), mul(c, invd3)};
  #pragma unroll
  for (int e = 0; e < kColPack; ++e) {
    cp[(size_t)e * st] = e < kColUsed ? cols[e] : 0.0f;
  }
  lo_c_sup[(size_t)b * N2pb + i] = acc.lo;

  // the block's part of the floor upf; the first column block adds the
  // voxel's block-1-free supports {3} and {}
  sm.red[tid] = acc.up;
  __syncthreads();
  if (tid == 0) {
    float m = sm.red[0];
    for (int t = 1; t < kAtoms; ++t) m = tmin(m, sm.red[t]);
    if (cb == 0) m = tmin(tmin(sub1(d3, r3, w, k).up, add(w, k.kerr)), m);
    part[(size_t)b * (gridDim.x - row_blocks) + cb] = m;
  }
}

}  // namespace

extern "C" int mf_row3hoist(const float* gramA, const float* gramB,
                            const float* yh, const float* A3h,
                            float* row_pack, float* col_pack, float* vox,
                            float* lo_c_sup, float* part, float* upf, int B,
                            int S, int N1p, int N2pb, float eps, float kerr,
                            cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (S < 1 || N1p < kAtoms || N2pb < kAtoms || N1p % kAtoms ||
      N2pb % kAtoms) {
    return (int)cudaErrorInvalidValue;
  }
  // part (B, N2pb / kAtoms): a partial minimum a column block
  const int row_blocks = N1p / kAtoms, col_blocks = N2pb / kAtoms;
  dim3 grid(row_blocks + col_blocks, B);
  // the K = 3 case logic has no determinant cutoff: sub2 takes det_tol = 0
  // and reads no tol
  row3hoist_kernel<<<grid, kAtoms, 0, stream>>>(
      gramA, gramB, yh, A3h, row_pack, col_pack, vox, lo_c_sup, part, S, N1p,
      N2pb, Consts{eps, 0.0f, kerr});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mf::hoist::fold_min<float><<<(B + 127) / 128, 128, 0, stream>>>(
      part, upf, B, col_blocks);
  return (int)cudaGetLastError();
}
