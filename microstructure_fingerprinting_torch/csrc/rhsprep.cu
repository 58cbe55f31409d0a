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
//     squares rounded once to float32, then the correctly rounded sqrt, as
//     ops/nnls.sumsq_f32 and sqrt_f32; a zero norm taken as 1; the IEEE
//     float32 quotient), what kernels 11 and 12 read;
//   * rhs_q (B, S, 384) int8: column j's quantize3 level l at lane
//     128 l + j, zeros elsewhere; rhs_r and rhs_a (B, S, 128) bf16: its
//     residual R and quantised part a at lane j, rounded to nearest even,
//     zeros elsewhere: pack_rhs's layout, what kernel 1 reads.
// The inputs are read with a batch stride (0 for a column shared by every
// voxel, as the fit's CSF and EAR blocks are), each voxel's (S, n) block
// contiguous.
//
// What bounds it on an H100: bytes, nearly all of them the lane padding of
// the packs (896 bytes a sample for at most 15 columns). The plain version
// runs ~300 torch kernels a call at 12 columns. The design: one block a
// voxel; a tile of kNormTile samples of its columns at a time in shared
// memory, one thread a column summing its squares in sample order (the
// float64 sum is exact up to its last rounding, so the order moves a norm
// by an ulp at most rarely: testing.kernel_agreement); then a thread a lane
// of a sample row, kLane lanes a row and two rows at a time, each writing
// its levels and planes (coalesced: the lanes are the packs' contiguous
// axis) and, on the columns' lanes, the normalised value.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hoist.cuh"

namespace {

using mf::dv;

// lanes of a level or plane of the packs (ops/prep._LANE)
constexpr int kLane = 128;
// the most columns a call takes (ops/prep.MAX_RHS)
constexpr int kMaxCols = 15;
constexpr int kThreads = 2 * kLane;
// samples of the columns staged at a time for the norms
constexpr int kNormTile = 64;

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

__global__ void __launch_bounds__(kThreads)
rhsprep_kernel(In in, float* __restrict__ yh, float* __restrict__ a3h,
               float* __restrict__ a4h, int8_t* __restrict__ rhs_q,
               __nv_bfloat16* __restrict__ rhs_r,
               __nv_bfloat16* __restrict__ rhs_a, int S) {
  __shared__ float tile[kMaxCols][kNormTile];
  __shared__ float safe[kMaxCols];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int nc = 1 + in.n3 + in.n4;

  // the columns' l2 norms, one a thread in sample order
  double acc = 0.0;
  for (int s0 = 0; s0 < S; s0 += kNormTile) {
    const int kn = min(kNormTile, S - s0);
    __syncthreads();  // the last tile is consumed
    for (int e = tid; e < nc * kNormTile; e += kThreads) {
      const int c = e / kNormTile, t = e % kNormTile;
      if (t < kn) tile[c][t] = in(b, c, s0 + t);
    }
    __syncthreads();
    if (tid < nc) {
      #pragma unroll 1
      for (int t = 0; t < kn; ++t) {
        const double x = (double)tile[tid][t];
        acc = __fma_rn(x, x, acc);  // the exact square, one rounding
      }
    }
  }
  if (tid < nc) {
    const float nrm = __fsqrt_rn(__double2float_rn(acc));
    safe[tid] = nrm > 0.0f ? nrm : 1.0f;
  }
  __syncthreads();

  // a thread a lane of a sample row
  const int j = tid % kLane;
  const bool live = j < nc;
  #pragma unroll 1
  for (int s = tid / kLane; s < S; s += kThreads / kLane) {
    const size_t o = (size_t)b * S + s;
    int q1 = 0, q2 = 0, q3 = 0;
    float r = 0.0f, a = 0.0f;
    if (live) {
      const float x = dv(in(b, j, s), safe[j]);
      if (j == 0) {
        yh[o] = x;
      } else if (j <= in.n3) {
        a3h[o * in.n3 + (j - 1)] = x;
      } else {
        a4h[o * in.n4 + (j - 1 - in.n3)] = x;
      }
      const mf::hoist::Level3 l = mf::hoist::quantize3(x);
      q1 = l.q1;
      q2 = l.q2;
      q3 = l.q3;
      r = l.r;
      a = l.a;
    }
    int8_t* q = rhs_q + o * 3 * kLane + j;
    q[0] = (int8_t)q1;
    q[kLane] = (int8_t)q2;
    q[2 * kLane] = (int8_t)q3;
    rhs_r[o * kLane + j] = __float2bfloat16_rn(r);
    rhs_a[o * kLane + j] = __float2bfloat16_rn(a);
  }
}

}  // namespace

extern "C" int mf_rhsprep(const float* y, const float* a3, const float* a4,
                          float* yh, float* a3h, float* a4h, int8_t* rhs_q,
                          __nv_bfloat16* rhs_r, __nv_bfloat16* rhs_a, int B,
                          int S, int n3, int n4, int sy, int s3, int s4,
                          cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (S < 1 || n3 < 1 || n4 < 0 || 1 + n3 + n4 > kMaxCols ||
      (n4 > 0) != (a4 != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  rhsprep_kernel<<<B, kThreads, 0, stream>>>(
      In{y, a3, a4, sy, s3, s4, n3, n4}, yh, a3h, a4h, rhs_q, rhs_r, rhs_a,
      S);
  return (int)cudaGetLastError();
}
