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
// an element of operands written once (~6.2 GB a 512-voxel chunk at
// [782, 782] on the real atoms, 1.855 ms at 3.35 TB/s); per atom and sample
// 2 Grams of 4 int32 multiply-adds and 2 float64 fused multiply-adds. The
// plain version casts every int8 level to float64 before its einsums: a
// (B, S, N) float64 temporary is 1.77 GB at B = 512, S = 552, N = 782, and
// the route peaked at ~19 GB a chunk. Here no product is materialised. The
// design, for this card (the voxel and atom launches of hoist.cuh):
//   * the voxel launch (df2vox_kernel), a block a voxel: the signal
//     quantised once into the voxel's chunks, its Gram w in kParts parts,
//     vox; on the [N, 1] grid the one column (the CSF column) is a small
//     column of the voxel too: its levels and planes, its Grams d2 and q
//     and its pack, so that no block of the atom launch has one live atom;
//   * the atom launch (df2hoist_kernel): blocks of kBA rows of A1 of one
//     voxel, then (on [N, N > 1]) of kBA columns of A2; the atoms' samples
//     and the voxel's chunks stream through a cp.async ring, kParts threads
//     an atom quantise them and sum its 2 Grams, the levels and planes
//     leave as 16-byte vectors; the first thread of each atom then writes
//     its pack from w (read back from vox).
// Every operation after the sums mirrors the plain version's in Dekker's
// forms; the float64 sums run in kParts strided parts
// (testing.fdot_hoist_order).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hoist.cuh"

namespace {

using mf::df_add;
using mf::df_mul;
using mf::neg;
using mf::P2;
using mf::val;
using mf::hoist::ColChunk;
using mf::hoist::kBA;
using mf::hoist::kSK;

// entries of a row or column pack and of the voxel vector
// (ops/dfscan.df2_scan_operands; kernel 6's kPack, kVox)
constexpr int kPack = 8, kVox = 4;

// a row's or a column's pack from its Grams d (with itself) and p (with
// the signal): a row d1, p, p^2, res1 = (d1 w - p^2) / d1; a column d2,
// q = p, X = d2 w - q^2, res2 = X / d2 (_df2_hoists), each (hi, lo), then 0
__device__ void put_pack(float* pk, size_t st, bool is_row, P2 d, P2 p,
                         P2 w) {
  const P2 p2 = df_mul(p, p);
  const P2 x = df_add(df_mul(d, w), neg(p2));
  const P2 third = is_row ? p2 : x;
  const float v[kPack] = {d.p, d.e, p.p, p.e, third.p, third.e,
                          mf::dv(val(x), val(d)), 0.0f};
  #pragma unroll
  for (int e = 0; e < kPack; ++e) pk[(size_t)e * st] = v[e];
}

// the small columns of voxel b: 0 the signal, 1 the [N, 1] grid's column
struct Cols {
  const float* y;
  const float* a2;
  __device__ float operator()(int c, int s) const {
    return c == 0 ? y[s] : a2[s];
  }
};

// the voxel Grams: 0 w = g(y, y); on [N, 1] also 1 d2 = g(a2, a2) and
// 2 q = g(a2, y)
struct Pairs {
  __device__ int2 operator()(int t) const {
    return t == 0 ? make_int2(0, 0) : make_int2(1, t == 1 ? 1 : 0);
  }
};

// The voxel's prologue, a block a voxel: the signal's chunks, w, vox, and
// with ``narrow`` the [N, 1] grid's column (its levels and planes at
// (b, s, 0), its pack).
__global__ void __launch_bounds__(mf::hoist::kVoxThreads)
df2vox_kernel(const float* __restrict__ yh, const float* __restrict__ A2h,
              float* __restrict__ vox, ColChunk<1>* __restrict__ chunks,
              int8_t* __restrict__ q1b, int8_t* __restrict__ q2b,
              float* __restrict__ rb, float* __restrict__ ab,
              float* __restrict__ col_pack, int S, int narrow) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ P2 vg[3];
  MF_PHASE_BEGIN;
  const int b = blockIdx.x, nc = narrow ? 2 : 1;
  const size_t vS = (size_t)b * S;
  const mf::hoist::VoxStage st(smem_raw, nc, S);
  mf::hoist::voxel_pass<1>(st, Cols{yh + vS, A2h + vS}, nc, Pairs{},
                           narrow ? 3 : 1,
                           chunks + (size_t)b * ((S + kSK - 1) / kSK), vg);
  const P2 w = vg[0];
  if (threadIdx.x == 0) {
    float* vx = vox + (size_t)b * kVox;
    vx[0] = w.p;
    vx[1] = w.e;
    vx[2] = val(w);
    vx[3] = 0.0f;
  }
  if (narrow) {
    if (threadIdx.x == 1) put_pack(col_pack + (size_t)b * kPack, 1, false,
                                   vg[1], vg[2], w);
    for (int s = threadIdx.x; s < S; s += mf::hoist::kVoxThreads) {
      const int2 q = st.q[S + s];
      const double2 ra = st.ra[S + s];
      q1b[vS + s] = (int8_t)q.x;
      q2b[vS + s] = (int8_t)q.y;
      rb[vS + s] = (float)ra.x;
      ab[vS + s] = (float)ra.y;
    }
  }
  MF_PHASE(0);
}

// The atoms: blocks of kBA rows of one voxel, then (N2pb > 1) of kBA
// columns.
__global__ void __launch_bounds__(mf::hoist::kStreamThreads, 2)
df2hoist_kernel(const float* __restrict__ A1h, const float* __restrict__ A2h,
                const ColChunk<1>* __restrict__ chunks,
                const float* __restrict__ vox, int8_t* __restrict__ q1a,
                int8_t* __restrict__ q2a, float* __restrict__ a1h,
                float* __restrict__ ra, int8_t* __restrict__ q1b,
                int8_t* __restrict__ q2b, float* __restrict__ rb,
                float* __restrict__ ab, float* __restrict__ row_pack,
                float* __restrict__ col_pack, int S, int N1p, int N2,
                int N2pb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<mf::hoist::StreamSmem<1>*>(smem_raw);
  MF_PHASE_BEGIN;
  const int b = blockIdx.y, row_blocks = N1p / kBA;
  const bool is_row = blockIdx.x < row_blocks;
  const int i0 = (is_row ? blockIdx.x : blockIdx.x - row_blocks) * kBA;
  const int width = is_row ? N1p : N2;
  const int padded = is_row ? N1p : N2pb;
  const size_t vS = (size_t)b * S, oo = vS * padded + i0;
  const mf::hoist::AtomOut out =
      is_row ? mf::hoist::AtomOut{q1a + oo, q2a + oo, ra + oo, a1h + oo,
                                  true, (size_t)N1p}
             : mf::hoist::AtomOut{q1b + oo, q2b + oo, rb + oo, ab + oo,
                                  false, (size_t)N2pb};
  P2 g[2];
  mf::hoist::atom_stream<1>(sm, (is_row ? A1h : A2h) + vS * width, width, i0,
                            S, chunks + (size_t)b * ((S + kSK - 1) / kSK),
                            out, g);
  if (threadIdx.x < kBA) {  // the first thread of atom i
    const int i = i0 + threadIdx.x;
    float* pk = (is_row ? row_pack + (size_t)b * kPack * N1p
                        : col_pack + (size_t)b * kPack * N2pb) + i;
    const size_t st = (size_t)padded;
    if (i < width) {
      const float* vx = vox + (size_t)b * kVox;
      put_pack(pk, st, is_row, g[0], g[1], P2{vx[0], vx[1]});
    } else {  // a padded column: zeros, as the plain version pads
      for (int e = 0; e < kPack; ++e) pk[(size_t)e * st] = 0.0f;
    }
  }
  MF_PHASE(3);
}

}  // namespace

MF_PHASE_API(mf_df2hoist_phases)

extern "C" int mf_df2hoist(const float* A1h, const float* A2h,
                           const float* yh, int8_t* q1a, int8_t* q2a,
                           float* a1h, float* ra, int8_t* q1b, int8_t* q2b,
                           float* rb, float* ab, float* row_pack,
                           float* col_pack, float* vox, float* chunks, int B,
                           int S, int N1p, int N2, int N2pb,
                           cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  // N2pb = 1: the [N, 1] grid, its column taken by the voxel launch
  const int narrow = N2pb == 1;
  const size_t vsm = mf::hoist::voxel_smem(1 + narrow, S);
  const int ssm = (int)sizeof(mf::hoist::StreamSmem<1>);
  if (S < 1 || N1p % kBA || N2 < 1 || N2pb < N2 ||
      (!narrow && N2pb % kBA) || vsm > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  // chunks (B, n_chunk ColChunk<1>): the voxel's signal, quantised
  ColChunk<1>* cc = reinterpret_cast<ColChunk<1>*>(chunks);
  cudaError_t err = cudaFuncSetAttribute(
      df2vox_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)vsm);
  if (err != cudaSuccess) return (int)err;
  df2vox_kernel<<<B, mf::hoist::kVoxThreads, vsm, stream>>>(
      yh, A2h, vox, cc, q1b, q2b, rb, ab, col_pack, S, narrow);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      df2hoist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ssm);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N1p / kBA + (narrow ? 0 : N2pb / kBA), B);
  df2hoist_kernel<<<grid, mf::hoist::kStreamThreads, ssm, stream>>>(
      A1h, A2h, cc, vox, q1a, q2a, a1h, ra, q1b, q2b, rb, ab, row_pack,
      col_pack, S, N1p, N2, N2pb);
  return (int)cudaGetLastError();
}
