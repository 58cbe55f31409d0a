// Kernel 1: operand prep of the interval row pass.
//
// Replaces the TPU kernel microstructure_fingerprinting_tpu/ops/pallas_prep.py
// (prep_block -> _prep_kernel, _quant3). Per voxel b and column n of the
// rotated block A (B, S, Np): l2-normalize as x * (1/||x||), split into three
// int8 levels (scales 2^-7, 2^-15, 2^-23) and the residual R, write the
// [Q1|Q2|Q3] tile packs and the bf16 x/r/a planes, and the hoist Grams:
// row 0 the exact-rounded <x, x>, rows 1+j the exact-rounded <x, rhs_j>.
//
// What bounds it on an H100: bytes. Every element of A is read once for the
// norm and once per sweep of up to kGroup rhs columns (1 + ceil(n_rhs / 4)
// reads in all), and ~5-7 bytes are written per element;
// the arithmetic per element is a few dozen operations per rhs column. The
// design: one thread per column, so a warp reads 32 neighbouring floats of a
// row of the row-major (S, Np) block and writes neighbouring bytes of each
// pack row (coalesced). The rhs Grams are accumulated kGroup columns per
// sweep over S, re-quantizing the column each sweep, so 15 rhs columns cost
// no more registers than 4 (no spills). Level products are int32 sums
// (exact); the squared norm and
// the bf16 corrections (bf16 x bf16 products are exact in f32) accumulate in
// float64 and are rounded once, so the result does not depend on summation
// order and equals the plain PyTorch version (ops/prep.py) bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "df32.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kMaxRhs = 15;   // rhs columns (gram rows 1..15)
constexpr int kGroup = 4;     // rhs columns accumulated per sweep
constexpr int kThreads = 128;

__device__ __forceinline__ float level(float v, float inv_scale) {
  // jnp.round / torch.round: round half to even (rintf), then clip; the
  // level goes through int8 as in ops/dfscan.quantize3, so a level of -0
  // becomes +0
  return (float)(int)fminf(fmaxf(rintf(mf::mul(v, inv_scale)), -127.0f),
                           127.0f);
}

__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ A, const int8_t* __restrict__ rhs_q,
            const __nv_bfloat16* __restrict__ rhs_r,
            const __nv_bfloat16* __restrict__ rhs_a, int8_t* __restrict__ q123,
            __nv_bfloat16* __restrict__ xbf, __nv_bfloat16* __restrict__ rbf,
            __nv_bfloat16* __restrict__ abf, float* __restrict__ gram, int S,
            int Np, int tile, int n_rhs) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= Np) return;
  const int nt = Np / tile, t = n / tile, i = n - t * tile;
  const float* Ab = A + (size_t)b * S * Np + n;

  // sweep 1: squared norm, float64 accumulation of exact products
  double nrm2 = 0.0;
  for (int s = 0; s < S; ++s) {
    double x = (double)Ab[(size_t)s * Np];
    nrm2 = fma(x, x, nrm2);
  }
  const float nrm = __fsqrt_rn(__double2float_rn(nrm2));
  const float inv = nrm > 0.0f ? mf::dv(1.0f, nrm) : 0.0f;

  // sweeps 2+: quantize (recomputed each sweep: it is a few operations
  // per element), emit the packs and <x, x> in the first sweep, and
  // accumulate the rhs Grams in groups of kGroup columns per sweep, so
  // the per-thread accumulators stay in registers at any n_rhs
  int s11 = 0, s12 = 0, s13 = 0, s22 = 0, s23 = 0, s33 = 0;
  double cdiag = 0.0;
  const size_t pack0 = ((size_t)b * nt + t) * S;
  float* g = gram + (size_t)b * 16 * Np + n;
  const int n_sweeps = n_rhs > 0 ? (n_rhs + kGroup - 1) / kGroup : 1;
  for (int sw = 0; sw < n_sweeps; ++sw) {
    const bool first = sw == 0;
    const int j0 = sw * kGroup;
    int v14[kGroup] = {}, v22[kGroup] = {}, v30[kGroup] = {};
    int v38[kGroup] = {}, v46[kGroup] = {};
    double c1[kGroup] = {}, c2[kGroup] = {};
    for (int s = 0; s < S; ++s) {
      const float xh = mf::mul(Ab[(size_t)s * Np], inv);
      const float q1 = level(xh, 128.0f);
      const float a1 = mf::mul(q1, 0.0078125f);
      const float q2 = level(mf::sub(xh, a1), 32768.0f);
      const float a2 = mf::add(a1, mf::mul(q2, 3.0517578125e-05f));
      const float q3 = level(mf::sub(xh, a2), 8388608.0f);
      const float a = mf::add(a2, mf::mul(q3, 1.1920928955078125e-07f));
      const float R = mf::sub(xh, a);
      const int i1 = (int)q1, i2 = (int)q2, i3 = (int)q3;
      const __nv_bfloat16 xb = __float2bfloat16_rn(xh);
      const __nv_bfloat16 rb = __float2bfloat16_rn(R);

      if (first) {
        int8_t* qrow = q123 + (pack0 + s) * 3 * tile + i;
        qrow[0] = (int8_t)i1;
        qrow[tile] = (int8_t)i2;
        qrow[2 * tile] = (int8_t)i3;
        const size_t po = (pack0 + s) * tile + i;
        if (xbf) xbf[po] = xb;
        if (rbf) rbf[po] = rb;
        if (abf) abf[po] = __float2bfloat16_rn(a);
        s11 += i1 * i1; s12 += i1 * i2; s13 += i1 * i3;
        s22 += i2 * i2; s23 += i2 * i3; s33 += i3 * i3;
        cdiag += (double)mf::mul(mf::add(mf::mul(2.0f, a), R), R);
      }

      const int8_t* rq = rhs_q + ((size_t)b * S + s) * 3 * kLane + j0;
      const __nv_bfloat16* rr = rhs_r + ((size_t)b * S + s) * kLane + j0;
      const __nv_bfloat16* ra = rhs_a + ((size_t)b * S + s) * kLane + j0;
      const double xd = (double)mf::bf(xb), rd = (double)mf::bf(rb);
      #pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j0 + j < n_rhs) {
          const int r1 = rq[j], r2 = rq[kLane + j], r3 = rq[2 * kLane + j];
          v14[j] += r1 * i1;
          v22[j] += r1 * i2 + r2 * i1;
          v30[j] += r1 * i3 + r2 * i2 + r3 * i1;
          v38[j] += r2 * i3 + r3 * i2;
          v46[j] += r3 * i3;
          c1[j] = fma((double)mf::bf(rr[j]), xd, c1[j]);
          c2[j] = fma((double)mf::bf(ra[j]), rd, c2[j]);
        }
      }
    }

    // integer sums are far below 2^24 here, so their float casts are exact
    if (first) {
      const float f12 = (float)s12, f13 = (float)s13, f22 = (float)s22;
      const float f23 = (float)s23;
      const float v[6] = {
          mf::mul((float)s11, 6.103515625e-05f),                 // 2^-14
          mf::mul(mf::mul(2.0f, f12), 2.384185791015625e-07f),   // 2^-22
          mf::mul(mf::add(f22, mf::mul(2.0f, f13)), 9.313225746154785e-10f),
          __double2float_rn(cdiag),
          mf::mul(mf::mul(2.0f, f23), 3.637978807091713e-12f),   // 2^-38
          mf::mul((float)s33, 1.4210854715202004e-14f)};         // 2^-46
      g[0] = mf::df_from_sum(v).p;
    }
    #pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j0 + j < n_rhs) {
        const float v[7] = {
            mf::mul((float)v14[j], 6.103515625e-05f),
            mf::mul((float)v22[j], 2.384185791015625e-07f),
            mf::mul((float)v30[j], 9.313225746154785e-10f),
            __double2float_rn(c1[j]), __double2float_rn(c2[j]),
            mf::mul((float)v38[j], 3.637978807091713e-12f),
            mf::mul((float)v46[j], 1.4210854715202004e-14f)};
        g[(size_t)(1 + j0 + j) * Np] = mf::df_from_sum(v).p;
      }
    }
  }
  for (int r = 1 + n_rhs; r < 16; ++r) g[(size_t)r * Np] = 0.0f;
}

}  // namespace

extern "C" int mf_prep_block(const float* A, const int8_t* rhs_q,
                             const __nv_bfloat16* rhs_r,
                             const __nv_bfloat16* rhs_a, int8_t* q123,
                             __nv_bfloat16* xbf, __nv_bfloat16* rbf,
                             __nv_bfloat16* abf, float* gram, int B, int S,
                             int Np, int tile, int n_rhs,
                             cudaStream_t stream) {
  if (n_rhs < 0 || n_rhs > kMaxRhs || tile <= 0 || Np % tile) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((Np + kThreads - 1) / kThreads, B);
  prep_kernel<<<grid, kThreads, 0, stream>>>(A, rhs_q, rhs_r, rhs_a, q123,
                                             xbf, rbf, abf, gram, S, Np,
                                             tile, n_rhs);
  return (int)cudaGetLastError();
}
