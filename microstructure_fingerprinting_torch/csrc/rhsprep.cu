// Kernel 13: the row passes' rhs columns, normalised, quantised and packed
// for kernel 1.
//
// Counterpart of the JAX package's rowmin_3 / rowmin_4 (pallas=True) before
// their prep (microstructure_fingerprinting_tpu/ops/f32scan.py:355-358 and
// 808-814: ops/nnls._normalize_block of the CSF and EAR columns,
// _normalize_y of the signal, ops/pallas_prep.pack_rhs; XLA fuses them into
// the jit of the row pass) and of its plain version here,
// ops/prep.rhs_prep_twin. Per voxel b it takes the raw signal y (B, S) and
// the n3 + n4 fixed columns a3 (B, S, n3) and a4 (B, S, n4), 1 + n3 + n4
// <= 15 (ops/prep.MAX_RHS) columns in all, and writes
//   * yh, a3h, a4h: each column over its l2 norm (the norm a float64 sum of
//     squares in sample order rounded once to float32, then the correctly
//     rounded sqrt, as ops/nnls.sumsq_f32 and sqrt_f32; a zero norm taken
//     as 1; the IEEE float32 quotient), what kernels 11 and 12 read;
//   * rhs_q (B, S, 384) int8: column j's quantize3 level l at lane
//     128 l + j, zeros elsewhere; rhs_r and rhs_a (B, S, 128) bf16: its
//     residual R and quantised part a at lane j, rounded to nearest even,
//     zeros elsewhere: pack_rhs's layout, what kernel 1 reads.
// The inputs are read with a batch stride (0 for a column shared by every
// voxel, as the fit's CSF and EAR blocks are), each voxel's (S, n) block
// contiguous.
//
// What bounds it on an H100: bytes, nearly all of them the lane padding of
// the packs (896 bytes a sample for at most 15 columns: 253 MB a 512-voxel
// chunk of 552 samples). The plain version runs ~300 torch kernels a call
// at 12 columns. The design, two launches:
//   * the norms (rhsnorm_kernel): a block a voxel stages the voxel's
//     columns in shared memory, one linear copy a column block with every
//     thread's loads in flight at once, then a thread a column sums its
//     squares in sample order (the float64 sum is exact up to its last
//     rounding, so the order moves a norm by an ulp at most rarely:
//     testing.kernel_agreement) into a (B, kNormPad) scratch of divisors;
//   * the packs (rhspack_kernel): a block a tile of kST samples of a voxel,
//     so that thousands of blocks are in flight. Each live (sample, column)
//     is loaded (a thread's loads all in flight at once), normalised and
//     quantised once, by one thread, into shared memory; then the tile's
//     rows of the packs, which are contiguous, are written whole in 16-byte
//     vectors (full sectors): lanes 0-15 of a level (0-7 and 8-15 of a
//     plane) from shared memory, every other vector (49 of 56 a sample)
//     zeros with no arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hoist.cuh"
#include "phases.cuh"

namespace {

using mf::dv;

// lanes of a level or plane of the packs (ops/prep._LANE)
constexpr int kLane = 128;
// the most columns a call takes (ops/prep.MAX_RHS)
constexpr int kMaxCols = 15;
// a voxel's entries in the divisors' scratch (ops/prep.RHS_NORM_PAD)
constexpr int kNormPad = 16;
// threads a block of the norms launch; samples staged at a time there
// (552, the protocol's, in one go)
constexpr int kNormThreads = 256, kNormTile = 640;
// threads and samples a block of the packs launch; the (sample, column)
// pairs a thread normalises at most
constexpr int kThreads = 256, kST = 32;
constexpr int kPairs = (kST * kMaxCols + kThreads - 1) / kThreads;
// 16-byte vectors a sample: of the levels (3 x 128 int8), of a plane
// (128 bf16)
constexpr int kQVec = 3 * kLane / 16, kPVec = kLane * 2 / 16;

// the raw columns of a call: 0 the signal, 1 .. n3 a3's, then a4's
struct In {
  const float* y;
  const float* a3;
  const float* a4;
  long long sy, s3, s4;  // batch strides in elements
  int n3, n4;
  __device__ float operator()(int b, int c, int s) const {
    if (c == 0) return y[b * sy + s];
    if (c <= n3) return a3[b * s3 + (long long)s * n3 + (c - 1)];
    return a4[b * s4 + (long long)s * n4 + (c - 1 - n3)];
  }
};

// (S, n) columns of one voxel, contiguous, into tile[c0 + c][t] for the
// samples s0 .. s0 + kn - 1: one linear copy, every load in flight at once
__device__ __forceinline__ void stage_cols(float (*tile)[kNormTile + 1],
                                           const float* __restrict__ src,
                                           int n, int c0, int s0, int kn) {
  const float* p = src + (size_t)s0 * n;
  #pragma unroll 8
  for (int e = threadIdx.x; e < kn * n; e += kNormThreads) {
    tile[c0 + e % n][e / n] = p[e];
  }
}

// the divisor of each column of voxel b: its l2 norm, 1 where that is 0
__global__ void __launch_bounds__(kNormThreads)
rhsnorm_kernel(In in, float* __restrict__ safe, int S) {
  __shared__ float tile[kMaxCols][kNormTile + 1];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int nc = 1 + in.n3 + in.n4;
  MF_PHASE_BEGIN;
  double acc = 0.0;
  for (int s0 = 0; s0 < S; s0 += kNormTile) {
    const int kn = min(kNormTile, S - s0);
    __syncthreads();  // the last tile is consumed
    stage_cols(tile, in.y + b * in.sy, 1, 0, s0, kn);
    stage_cols(tile, in.a3 + b * in.s3, in.n3, 1, s0, kn);
    if (in.n4) stage_cols(tile, in.a4 + b * in.s4, in.n4, 1 + in.n3, s0, kn);
    __syncthreads();
    if (tid < nc) {
      #pragma unroll 8
      for (int t = 0; t < kn; ++t) {
        const double x = (double)tile[tid][t];
        acc = __fma_rn(x, x, acc);  // the exact square, one rounding
      }
    }
  }
  if (tid < nc) {
    const float nrm = __fsqrt_rn(__double2float_rn(acc));
    safe[b * kNormPad + tid] = nrm > 0.0f ? nrm : 1.0f;
  }
  MF_PHASE(0);
}

__global__ void __launch_bounds__(kThreads)
rhspack_kernel(In in, const float* __restrict__ safe, float* __restrict__ yh,
               float* __restrict__ a3h, float* __restrict__ a4h,
               int8_t* __restrict__ rhs_q, __nv_bfloat16* __restrict__ rhs_r,
               __nv_bfloat16* __restrict__ rhs_a, int S) {
  // the tile's live lanes 0-15: levels, then the bf16 bits of R and a
  __shared__ alignas(16) int8_t lq[3][kST][16];
  __shared__ alignas(16) unsigned short lr[kST][16], la[kST][16];
  const int tid = threadIdx.x, b = blockIdx.x, s0 = blockIdx.y * kST;
  const int ns = min(kST, S - s0), nc = 1 + in.n3 + in.n4;
  MF_PHASE_BEGIN;

  // the live (sample, column) pairs, each once: their raw values loaded
  // first, all in flight together
  float raw[kPairs];
  #pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int p = tid + k * kThreads, t = p / nc, j = p % nc;
    raw[k] = p < ns * nc ? in(b, j, s0 + t) : 0.0f;
  }
  // lanes nc .. 15 of the tile are zeros
  for (int p = tid; p < kST * 16; p += kThreads) {
    const int t = p / 16, j = p % 16;
    if (j >= nc) {
      lq[0][t][j] = lq[1][t][j] = lq[2][t][j] = 0;
      lr[t][j] = la[t][j] = 0;
    }
  }
  // normalised, written to yh / a3h / a4h, quantised into the tile
  #pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int p = tid + k * kThreads, t = p / nc, j = p % nc;
    if (p < ns * nc) {
      const size_t o = (size_t)b * S + s0 + t;
      const float x = dv(raw[k], safe[b * kNormPad + j]);
      if (j == 0) {
        yh[o] = x;
      } else if (j <= in.n3) {
        a3h[o * in.n3 + (j - 1)] = x;
      } else {
        a4h[o * in.n4 + (j - 1 - in.n3)] = x;
      }
      const mf::hoist::Level3 l = mf::hoist::quantize3(x);
      lq[0][t][j] = (int8_t)l.q1;
      lq[1][t][j] = (int8_t)l.q2;
      lq[2][t][j] = (int8_t)l.q3;
      lr[t][j] = __bfloat16_as_ushort(__float2bfloat16_rn(l.r));
      la[t][j] = __bfloat16_as_ushort(__float2bfloat16_rn(l.a));
    }
  }
  __syncthreads();
  MF_PHASE(1);

  // the tile's rows of the packs are contiguous: 16-byte vectors, the
  // live ones from the tile, the rest zeros
  const size_t row = (size_t)b * S + s0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4* q = reinterpret_cast<uint4*>(rhs_q + row * 3 * kLane);
  for (int v = tid; v < ns * kQVec; v += kThreads) {
    const int t = v / kQVec, w = v % kQVec;
    q[v] = w % (kQVec / 3) ? zero
                           : *reinterpret_cast<const uint4*>(lq[w / 8][t]);
  }
  uint4* pr = reinterpret_cast<uint4*>(rhs_r + row * kLane);
  uint4* pa = reinterpret_cast<uint4*>(rhs_a + row * kLane);
  for (int v = tid; v < ns * kPVec; v += kThreads) {
    const int t = v / kPVec, w = v % kPVec;
    pr[v] = w < 2 ? reinterpret_cast<const uint4*>(lr[t])[w] : zero;
    pa[v] = w < 2 ? reinterpret_cast<const uint4*>(la[t])[w] : zero;
  }
  MF_PHASE(2);
}

}  // namespace

MF_PHASE_API(mf_rhsprep_phases)

extern "C" int mf_rhsprep(const float* y, const float* a3, const float* a4,
                          float* safe, float* yh, float* a3h, float* a4h,
                          int8_t* rhs_q, __nv_bfloat16* rhs_r,
                          __nv_bfloat16* rhs_a, int B, int S, int n3, int n4,
                          int sy, int s3, int s4, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (S < 1 || n3 < 1 || n4 < 0 || 1 + n3 + n4 > kMaxCols ||
      (n4 > 0) != (a4 != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)rhs_q | (uintptr_t)rhs_r | (uintptr_t)rhs_a) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  const In in{y, a3, a4, sy, s3, s4, n3, n4};
  rhsnorm_kernel<<<B, kNormThreads, 0, stream>>>(in, safe, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, (S + kST - 1) / kST);
  rhspack_kernel<<<grid, kThreads, 0, stream>>>(in, safe, yh, a3h, a4h, rhs_q,
                                                rhs_r, rhs_a, S);
  return (int)cudaGetLastError();
}
