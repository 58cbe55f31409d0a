// Kernel 9: the prologue of the double-float [N1, N2] scan (df2_candidates).
//
// Counterpart of the hoists of the JAX package's df2_candidates
// (microstructure_fingerprinting_tpu/ops/dfscan.py:436-461, plain XLA in one
// jit with the scan) and of its plain version here,
// ops/dfscan.df2_hoist_twin (_df2_hoists). From the normalised blocks A1h
// (B, S, N1p), A2h (B, S, N2) and yh (B, S) it writes kernel 6's operands
// (ops/dfscan.df2_scan_operands): the int8 levels and float32 planes of both
// blocks (q1a, q2a, a1h = a + R, ra; q1b, q2b, rb, ab, the columns past N2
// zero), row_pack (B, 8, N1p) = d1, p, p^2 (hi, lo each), res1, 0;
// col_pack (B, 8, N2pb) = d2, q, d2 w - q^2 (hi, lo each), res2, 0, zero
// past N2; vox (B, 4) = w (hi, lo), its value, 0.
//
// What bounds it on an H100: bytes. The blocks are read once and ~14 bytes
// an element of operands written once; per atom and sample 2 Grams of 4
// int32 multiply-adds and 2 float64 fused multiply-adds. The plain version
// casts every int8 level to float64 before its einsums: a (B, S, N) float64
// temporary is 1.77 GB at B = 512, S = 552, N = 782, and the route peaked at
// ~19 GB a chunk. Here no product is materialised: the skeleton of
// hoist.cuh, a thread an atom, one launch a call for the row and the column
// blocks (the [N, 1] grid's CSF column is one thread of one block), every
// block summing the voxel's w itself (one thread, in sample order). Every
// operation after the sums mirrors the plain version's in Dekker's forms.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hoist.cuh"

namespace {

using mf::df_add;
using mf::df_mul;
using mf::neg;
using mf::P2;
using mf::val;
using mf::hoist::kAtoms;

// entries of a row or column pack and of the voxel vector
// (ops/dfscan.df2_scan_operands; kernel 6's kPack, kVox)
constexpr int kPack = 8, kVox = 4;

// the one small column: the signal
struct Cols {
  const float* y;
  __device__ float operator()(int, int s) const { return y[s]; }
};

// the one voxel Gram: w = g(y, y)
struct Pairs {
  __device__ int2 operator()(int) const { return make_int2(0, 0); }
};

__global__ void __launch_bounds__(kAtoms)
df2hoist_kernel(const float* __restrict__ A1h, const float* __restrict__ A2h,
                const float* __restrict__ yh, int8_t* __restrict__ q1a,
                int8_t* __restrict__ q2a, float* __restrict__ a1h,
                float* __restrict__ ra, int8_t* __restrict__ q1b,
                int8_t* __restrict__ q2b, float* __restrict__ rb,
                float* __restrict__ ab, float* __restrict__ row_pack,
                float* __restrict__ col_pack, float* __restrict__ vox, int S,
                int N1p, int N2, int N2pb) {
  __shared__ mf::hoist::Tile<1> tile;
  __shared__ P2 w_sm;
  const int tid = threadIdx.x, b = blockIdx.y;
  const int row_blocks = N1p / kAtoms;
  const bool is_row = blockIdx.x < row_blocks;
  const int i = (is_row ? blockIdx.x : blockIdx.x - row_blocks) * kAtoms + tid;
  const int width = is_row ? N1p : N2;
  const int padded = is_row ? N1p : N2pb;
  const bool live = i < padded, real = i < width;

  const size_t vS = (size_t)b * S;
  const float* atom = (is_row ? A1h : A2h) + vS * width + i;
  const size_t oo = vS * padded + i;
  const mf::hoist::AtomOut out =
      is_row ? mf::hoist::AtomOut{q1a + oo, q2a + oo, ra + oo, nullptr,
                                  a1h + oo, (size_t)N1p}
             : mf::hoist::AtomOut{q1b + oo, q2b + oo, rb + oo, ab + oo,
                                  nullptr, (size_t)N2pb};
  mf::hoist::Gram vg = mf::hoist::gram_zero(), self = mf::hoist::gram_zero();
  mf::hoist::Gram g[1] = {mf::hoist::gram_zero()};
  mf::hoist::stream<1>(tile, Cols{yh + vS}, 1, S, Pairs{}, 1, vg, atom,
                       (size_t)width, live, real, out, self, g);
  if (tid == 0) w_sm = mf::hoist::gram_value(vg);
  __syncthreads();
  if (!live) return;
  const P2 w = w_sm;
  if (blockIdx.x == 0 && tid == 0) {
    float* vx = vox + (size_t)b * kVox;
    vx[0] = w.p;
    vx[1] = w.e;
    vx[2] = val(w);
    vx[3] = 0.0f;
  }
  float* pk = (is_row ? row_pack + (size_t)b * kPack * N1p
                      : col_pack + (size_t)b * kPack * N2pb) + i;
  const size_t st = (size_t)padded;
  if (!real) {  // a padded column: zeros, as the plain version pads
    for (int e = 0; e < kPack; ++e) pk[(size_t)e * st] = 0.0f;
    return;
  }
  // a row: d1 = a1'a1, p = a1'y, p^2, res1 = (d1 w - p^2) / d1; a column:
  // d2, q = a2'y, X = d2 w - q^2, res2 = X / d2 (_df2_hoists)
  const P2 d = mf::hoist::gram_value(self), p = mf::hoist::gram_value(g[0]);
  const P2 p2 = df_mul(p, p);
  const P2 x = df_add(df_mul(d, w), neg(p2));
  const P2 third = is_row ? p2 : x;
  const float v[kPack] = {d.p, d.e, p.p, p.e, third.p, third.e,
                          mf::dv(val(x), val(d)), 0.0f};
  #pragma unroll
  for (int e = 0; e < kPack; ++e) pk[(size_t)e * st] = v[e];
}

}  // namespace

extern "C" int mf_df2hoist(const float* A1h, const float* A2h,
                           const float* yh, int8_t* q1a, int8_t* q2a,
                           float* a1h, float* ra, int8_t* q1b, int8_t* q2b,
                           float* rb, float* ab, float* row_pack,
                           float* col_pack, float* vox, int B, int S, int N1p,
                           int N2, int N2pb, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (S < 1 || N1p % kAtoms || N2 < 1 || N2pb < N2) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(N1p / kAtoms + (N2pb + kAtoms - 1) / kAtoms, B);
  df2hoist_kernel<<<grid, kAtoms, 0, stream>>>(
      A1h, A2h, yh, q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack, col_pack,
      vox, S, N1p, N2, N2pb);
  return (int)cudaGetLastError();
}
