// Kernel 1: operand prep of the interval row pass.
//
// Replaces the TPU kernel microstructure_fingerprinting_tpu/ops/pallas_prep.py
// (prep_block -> _prep_kernel, _quant3). Per voxel b and column n of the
// rotated block A (B, S, Np): l2-normalize as x * (1/||x||), split into three
// int8 levels (scales 2^-7, 2^-15, 2^-23) and the residual R, write the
// [Q1|Q2|Q3] tile packs and the bf16 x/r/a planes, and the hoist Grams:
// row 0 the exact-rounded <x, x>, rows 1+j the exact-rounded <x, rhs_j>.
//
// What bounds it on an H100: bytes (4 read and 5-7 written an element), as
// long as enough of them are in flight and the arithmetic stays cheap. What
// holds it above that bound is the arithmetic of one block of 8 warps an SM:
// the quantisation (a dependent run of a few dozen operations an element)
// and, with many rhs columns, the products: 5 integer dot products and 2
// float64 multiply-adds an element and rhs column, whose bf16 operands are
// each converted to float64 first (conversions to 64-bit types are a slow
// instruction on this card). The design:
//   * one read of A: a block owns a strip of W neighbouring columns of one
//     voxel and brings the whole (S, W) strip into shared memory by cp.async,
//     all S rows in flight together; W is the widest of 32, 16 and 8 whose
//     strip, quantised planes and staged rhs fit kSmemLimit
//     (ops/prep.strip_width is the same rule; beyond it the launch is
//     refused, there is no second path). Narrower strips are slower;
//   * many threads a column: a thread takes 4 neighbouring columns and every
//     nsl-th sample, so the pack stores are 4 bytes (int8) and 8 bytes
//     (bf16) a thread and neighbouring threads fill whole 32-byte sectors.
//     The squared norm, cdiag and the integer sums are partial sums a thread,
//     joined by warp shuffles and through shared memory in a fixed order
//     (float64 sums of exact products rounded once; integers exact);
//   * one quantisation: after the norm each element is quantised once from
//     the strip, rounding by two adds of 1.5 * 2^23 instead of conversion
//     instructions; its levels (i1, i2, i3, 0), one byte each, are written
//     back over its float, and its bf16 x and r go to a second (S, W) plane
//     of words (3 + 2 + 2 bytes do not fit the float's 4), where the rhs
//     products read them;
//   * the rhs columns are staged once a block as two words a sample and
//     column, the levels (r3, r2, r1, 0) and the bf16 (r, a), and read as
//     broadcasts;
//   * the level products run on the integer dot-product instruction: with
//     the rhs word shifted by 16, 8, 0, -8, -16 bits, five __dp4a against
//     the element's word give the five scale groups (9 multiply-adds
//     before); int8 and float64 mma.sync, which would also cut the
//     conversions to a quarter, were not tried. The product phase gives a
//     thread 4 columns x kRhsTile rhs columns of every nsl-th sample (its 72
//     accumulator registers bound the tile: 4 x 4 runs at 199 registers and
//     gains 6% at 12 rhs columns but loses 15% at 2); the partial sums are
//     joined through shared memory, each sum by its own thread in slice
//     order. The two bf16 corrections stay float64 sums of exact products
//     (scalar fma on doubles).
// The result is what the plain PyTorch version (ops/prep.py) gives: bit for
// bit in the packs, the planes and the integer sums, and in the Grams up to
// the rounding of a float64 sum taken in another order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "df32.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kMaxRhs = 15;   // rhs columns (gram rows 1..15)
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kRhsTile = 2;   // rhs columns of a product-phase thread
// dynamic shared memory of a block, bytes (the SM's 227 KB less the 10 KB
// of static arrays below and the block's reserved 1 KB)
constexpr int kSmemLimit = 212 * 1024;
// words a product-phase thread hands to the join: per (column, rhs) 5
// integer sums and 2 doubles
constexpr int kJoinInts = 4 * kRhsTile * 5, kJoinDoubles = 4 * kRhsTile * 2;

__host__ __device__ constexpr int rhs_padded(int n_rhs) {
  return (n_rhs + kRhsTile - 1) / kRhsTile * kRhsTile;
}

// dynamic shared memory of a block: the strip and (with rhs columns) the
// x/r plane, over which the join's scratch is laid once they are dead, and
// the staged rhs
int smem_bytes(int S, int W, int n_rhs) {
  const int planes = S * W * 4 * (n_rhs > 0 ? 2 : 1);
  const int join = n_rhs > 0 ? kThreads * (kJoinInts + 2 * kJoinDoubles) * 4
                             : 0;
  return (planes > join ? planes : join) + S * rhs_padded(n_rhs) * 8;
}

// 1.5 * 2^23: adding it to |t| < 2^22 rounds t to an integer, half to even
constexpr float kRound = 12582912.0f;

__device__ __forceinline__ float level(float v, float inv_scale) {
  // jnp.round / torch.round (round half to even), then clip, as in
  // ops/dfscan.quantize3; (t + kRound) - kRound is rintf(t) for the
  // |t| <= 2^16 that normalized columns give, by two full-rate adds where
  // rintf and the int8 round trip are conversion instructions, and it turns
  // a level of -0 into +0 as that round trip does
  const float t = mf::mul(v, inv_scale);
  return fminf(fmaxf(mf::sub(mf::add(t, kRound), kRound), -127.0f), 127.0f);
}

// the integer of a level (|q| <= 127): the low mantissa bits of q + kRound
__device__ __forceinline__ int level_int(float q) {
  return __float_as_int(mf::add(q, kRound)) - __float_as_int(kRound);
}

// two floats rounded to bf16 (to nearest even) in one word, lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the two bf16 values of a word, widened (exact)
__device__ __forceinline__ double bf_lo(uint32_t w) {
  return (double)__uint_as_float(w << 16);
}
__device__ __forceinline__ double bf_hi(uint32_t w) {
  return (double)__uint_as_float(w & 0xffff0000u);
}

// sum over the lanes that share lane % G (the same column group)
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
  #pragma unroll
  for (int o = G; o < 32; o *= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ A, const int8_t* __restrict__ rhs_q,
            const __nv_bfloat16* __restrict__ rhs_r,
            const __nv_bfloat16* __restrict__ rhs_a, int8_t* __restrict__ q123,
            __nv_bfloat16* __restrict__ xbf, __nv_bfloat16* __restrict__ rbf,
            __nv_bfloat16* __restrict__ abf, float* __restrict__ gram, int S,
            int Np, int tile, int n_rhs) {
  constexpr int G = W / 4;              // column groups of 4
  constexpr int NSL = kThreads / G;     // sample slices of phases 1 and 2
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.y, n0 = blockIdx.x * W;
  const int nrp = rhs_padded(n_rhs);

  extern __shared__ __align__(16) uint32_t dyn[];
  uint32_t* strip = dyn;                        // [S][W] floats, then levels
  uint32_t* xr = dyn + (size_t)S * W;           // [S][W] bf16 (x, r)
  uint32_t* srhs = dyn + (size_t)S * W * (n_rhs > 0 ? 2 : 1);  // [S][nrp][2]
  __shared__ double red_n[kWarps][W], red_c[kWarps][W];
  __shared__ int red_i[6][kWarps][W];

  // ---- phase 0: the strip in flight, the rhs columns packed meanwhile
  for (int k = tid; k < S * G; k += kThreads) {
    const int s = k / G, part = 4 * (k % G);
    mf::copy16_async(strip + s * W + part,
                     A + ((size_t)b * S + s) * Np + n0 + part);
  }
  // four rhs columns of a sample a thread: their levels by one 4-byte load
  // a level, their bf16 r and a by one 8-byte load each (columns beyond
  // n_rhs stage as zeros)
  const int nq = (nrp + 3) / 4;
  for (int k = tid; k < S * nq; k += kThreads) {
    const int s = k / nq, j0 = 4 * (k % nq);
    const size_t o = (size_t)b * S + s;
    uint32_t q[3];
    #pragma unroll
    for (int l = 0; l < 3; ++l) {
      q[l] = *reinterpret_cast<const uint32_t*>(rhs_q + (o * 3 + l) * kLane +
                                                j0);
    }
    const uint2 r2 = *reinterpret_cast<const uint2*>(rhs_r + o * kLane + j0);
    const uint2 a2 = *reinterpret_cast<const uint2*>(rhs_a + o * kLane + j0);
    const uint32_t rw[2] = {r2.x, r2.y}, aw[2] = {a2.x, a2.y};
    #pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      if (j >= nrp) break;
      const bool in = j < n_rhs;
      const uint32_t lev = (q[2] >> (8 * u) & 0xffu) |
                           (q[1] >> (8 * u) & 0xffu) << 8 |
                           (q[0] >> (8 * u) & 0xffu) << 16;
      const uint32_t ra = (rw[u / 2] >> (16 * (u % 2)) & 0xffffu) |
                          (aw[u / 2] >> (16 * (u % 2)) & 0xffffu) << 16;
      srhs[2 * (s * nrp + j)] = in ? lev : 0u;
      srhs[2 * (s * nrp + j) + 1] = in ? ra : 0u;
    }
  }
  mf::copy_async_wait_all();
  __syncthreads();

  // ---- phase 1: squared norms, float64 sums of exact products
  const int cg = tid % G, sl = tid / G;
  double nrm2[4] = {};
  for (int s = sl; s < S; s += NSL) {
    const float4 v = reinterpret_cast<const float4*>(strip)[s * G + cg];
    const float x[4] = {v.x, v.y, v.z, v.w};
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      nrm2[c] = fma((double)x[c], (double)x[c], nrm2[c]);
    }
  }
  #pragma unroll
  for (int c = 0; c < 4; ++c) {
    nrm2[c] = group_sum<G>(nrm2[c]);
    if (lane < G) red_n[warp][4 * cg + c] = nrm2[c];
  }
  __syncthreads();
  float inv[4];
  #pragma unroll
  for (int c = 0; c < 4; ++c) {
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t += red_n[w][4 * cg + c];
    const float nrm = __fsqrt_rn(__double2float_rn(t));
    inv[c] = nrm > 0.0f ? mf::dv(1.0f, nrm) : 0.0f;
  }

  // ---- phase 2: quantise once, emit the packs, sums of <x, x>
  const int n = n0 + 4 * cg;                  // the thread's first column
  const int nt = Np / tile, t = n / tile, i = n - t * tile;
  const size_t pack0 = ((size_t)b * nt + t) * S;
  int s11[4] = {}, s12[4] = {}, s13[4] = {}, s22[4] = {}, s23[4] = {};
  int s33[4] = {};
  double cdiag[4] = {};
  for (int s = sl; s < S; s += NSL) {
    const float4 v = reinterpret_cast<const float4*>(strip)[s * G + cg];
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t lev[4], xrw[4], qw[3] = {};
    float av[4];
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float xh = mf::mul(x[c], inv[c]);
      const float q1 = level(xh, 128.0f);
      const float a1 = mf::mul(q1, 0.0078125f);
      const float q2 = level(mf::sub(xh, a1), 32768.0f);
      const float a2 = mf::add(a1, mf::mul(q2, 3.0517578125e-05f));
      const float q3 = level(mf::sub(xh, a2), 8388608.0f);
      const float a = mf::add(a2, mf::mul(q3, 1.1920928955078125e-07f));
      const float R = mf::sub(xh, a);
      const int i1 = level_int(q1), i2 = level_int(q2), i3 = level_int(q3);
      const uint32_t b1 = (uint32_t)i1 & 0xffu, b2 = (uint32_t)i2 & 0xffu;
      const uint32_t b3 = (uint32_t)i3 & 0xffu;
      lev[c] = b1 | b2 << 8 | b3 << 16;
      xrw[c] = bf16x2(xh, R);
      av[c] = a;
      qw[0] |= b1 << (8 * c);
      qw[1] |= b2 << (8 * c);
      qw[2] |= b3 << (8 * c);
      s11[c] += i1 * i1; s12[c] += i1 * i2; s13[c] += i1 * i3;
      s22[c] += i2 * i2; s23[c] += i2 * i3; s33[c] += i3 * i3;
      cdiag[c] += (double)mf::mul(mf::add(mf::mul(2.0f, a), R), R);
    }
    int8_t* qrow = q123 + (pack0 + s) * 3 * tile + i;
    #pragma unroll
    for (int l = 0; l < 3; ++l) {
      *reinterpret_cast<uint32_t*>(qrow + l * tile) = qw[l];
    }
    const size_t po = (pack0 + s) * tile + i;
    // the x halves (low) and the r halves (high) of two (x, r) words
    if (xbf) {
      *reinterpret_cast<uint2*>(xbf + po) =
          make_uint2(__byte_perm(xrw[0], xrw[1], 0x5410),
                     __byte_perm(xrw[2], xrw[3], 0x5410));
    }
    if (rbf) {
      *reinterpret_cast<uint2*>(rbf + po) =
          make_uint2(__byte_perm(xrw[0], xrw[1], 0x7632),
                     __byte_perm(xrw[2], xrw[3], 0x7632));
    }
    if (abf) {
      *reinterpret_cast<uint2*>(abf + po) =
          make_uint2(bf16x2(av[0], av[1]), bf16x2(av[2], av[3]));
    }
    reinterpret_cast<uint4*>(strip)[s * G + cg] =
        make_uint4(lev[0], lev[1], lev[2], lev[3]);
    if (n_rhs > 0) {
      reinterpret_cast<uint4*>(xr)[s * G + cg] =
          make_uint4(xrw[0], xrw[1], xrw[2], xrw[3]);
    }
  }
  #pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int sums[6] = {s11[c], s12[c], s13[c], s22[c], s23[c], s33[c]};
    #pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int v = group_sum<G>(sums[q]);
      if (lane < G) red_i[q][warp][4 * cg + c] = v;
    }
    const double d = group_sum<G>(cdiag[c]);
    if (lane < G) red_c[warp][4 * cg + c] = d;
  }
  __syncthreads();   // the sums, and the level and x/r planes, are complete

  // row 0: <x, x>; rows beyond the rhs columns: 0
  if (tid < W) {
    int si[6] = {};
    double cd = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      #pragma unroll
      for (int q = 0; q < 6; ++q) si[q] += red_i[q][w][tid];
      cd += red_c[w][tid];
    }
    // integer sums are far below 2^24 here, so their float casts are exact
    const float f12 = (float)si[1], f13 = (float)si[2], f22 = (float)si[3];
    const float f23 = (float)si[4];
    const float v[6] = {
        mf::mul((float)si[0], 6.103515625e-05f),               // 2^-14
        mf::mul(mf::mul(2.0f, f12), 2.384185791015625e-07f),   // 2^-22
        mf::mul(mf::add(f22, mf::mul(2.0f, f13)), 9.313225746154785e-10f),
        __double2float_rn(cd),
        mf::mul(mf::mul(2.0f, f23), 3.637978807091713e-12f),   // 2^-38
        mf::mul((float)si[5], 1.4210854715202004e-14f)};       // 2^-46
    float* g = gram + (size_t)b * 16 * Np + n0 + tid;
    g[0] = mf::df_from_sum(v).p;
    for (int r = 1 + n_rhs; r < 16; ++r) g[(size_t)r * Np] = 0.0f;
  }
  if (n_rhs == 0) return;

  // ---- phase 3: <x, rhs_j>. A thread: 4 columns x kRhsTile rhs columns of
  // every nsl-th sample; the five scale groups by __dp4a on shifted words
  const int njg = nrp / kRhsTile, ncomb = G * njg, nsl = kThreads / ncomb;
  const int combo = tid % ncomb, sl3 = tid / ncomb;
  const int cg3 = combo % G, jg = combo / G;
  int v[4][kRhsTile][5] = {};
  double c1[4][kRhsTile] = {}, c2[4][kRhsTile] = {};
  if (sl3 < nsl) {
    for (int s = sl3; s < S; s += nsl) {
      const uint4 L4 = reinterpret_cast<const uint4*>(strip)[s * G + cg3];
      const uint4 X4 = reinterpret_cast<const uint4*>(xr)[s * G + cg3];
      const uint32_t L[4] = {L4.x, L4.y, L4.z, L4.w};
      const uint32_t X[4] = {X4.x, X4.y, X4.z, X4.w};
      uint32_t R[kRhsTile], RA[kRhsTile];
      #pragma unroll
      for (int h = 0; h < kRhsTile / 2; ++h) {
        const uint4 R4 = reinterpret_cast<const uint4*>(
            srhs)[(s * njg + jg) * (kRhsTile / 2) + h];
        R[2 * h] = R4.x;
        RA[2 * h] = R4.y;
        R[2 * h + 1] = R4.z;
        RA[2 * h + 1] = R4.w;
      }
      double xd[4], rd[4];
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        xd[c] = bf_lo(X[c]);
        rd[c] = bf_hi(X[c]);
      }
      #pragma unroll
      for (int j = 0; j < kRhsTile; ++j) {
        // the element's bytes (i1, i2, i3, 0) against (r1, 0, 0, 0),
        // (r2, r1, 0, 0), (r3, r2, r1, 0), (0, r3, r2, r1), (0, 0, r3, r2)
        const int sh[5] = {(int)(R[j] >> 16), (int)(R[j] >> 8), (int)R[j],
                           (int)(R[j] << 8), (int)(R[j] << 16)};
        const double rrd = bf_lo(RA[j]), rad = bf_hi(RA[j]);
        #pragma unroll
        for (int c = 0; c < 4; ++c) {
          #pragma unroll
          for (int q = 0; q < 5; ++q) {
            v[c][j][q] = __dp4a((int)L[c], sh[q], v[c][j][q]);
          }
          c1[c][j] = fma(rrd, xd[c], c1[c][j]);
          c2[c][j] = fma(rad, rd[c], c2[c][j]);
        }
      }
    }
  }
  __syncthreads();   // the planes are dead: the join's scratch lies over them
  int* ji = reinterpret_cast<int*>(dyn);                 // [kJoinInts][T]
  double* jd = reinterpret_cast<double*>(dyn + kJoinInts * kThreads);
  if (sl3 < nsl) {
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      #pragma unroll
      for (int j = 0; j < kRhsTile; ++j) {
        const int p = c * kRhsTile + j;
        #pragma unroll
        for (int q = 0; q < 5; ++q) ji[(p * 5 + q) * kThreads + tid] =
            v[c][j][q];
        jd[(p * 2) * kThreads + tid] = c1[c][j];
        jd[(p * 2 + 1) * kThreads + tid] = c2[c][j];
      }
    }
  }
  __syncthreads();
  // join: each of a tile's 56 sums over the nsl slices by its own thread,
  // in slice order, into the first slice's place
  for (int k = tid; k < ncomb * (kJoinInts + kJoinDoubles); k += kThreads) {
    const int q = k / ncomb, first = k % ncomb;
    if (q < kJoinInts) {
      int acc = 0;
      const int* v0 = ji + q * kThreads + first;
      for (int m = 0; m < nsl; ++m) acc += v0[ncomb * m];
      ji[q * kThreads + first] = acc;
    } else {
      double* d = jd + (q - kJoinInts) * kThreads + first;
      double acc = 0.0;
      for (int m = 0; m < nsl; ++m) acc += d[ncomb * m];
      d[0] = acc;
    }
  }
  __syncthreads();
  for (int o = tid; o < W * nrp; o += kThreads) {
    const int col = o % W, j = o / W;
    if (j >= n_rhs) continue;
    const int p = (col % 4) * kRhsTile + j % kRhsTile;
    const int first = col / 4 + G * (j / kRhsTile);
    int vi[5];
    #pragma unroll
    for (int q = 0; q < 5; ++q) vi[q] = ji[(p * 5 + q) * kThreads + first];
    const double d1 = jd[(p * 2) * kThreads + first];
    const double d2 = jd[(p * 2 + 1) * kThreads + first];
    const float w[7] = {
        mf::mul((float)vi[0], 6.103515625e-05f),
        mf::mul((float)vi[1], 2.384185791015625e-07f),
        mf::mul((float)vi[2], 9.313225746154785e-10f),
        __double2float_rn(d1), __double2float_rn(d2),
        mf::mul((float)vi[3], 3.637978807091713e-12f),
        mf::mul((float)vi[4], 1.4210854715202004e-14f)};
    gram[((size_t)b * 16 + 1 + j) * Np + n0 + col] = mf::df_from_sum(w).p;
  }
}

template <int W>
int launch(const float* A, const int8_t* rhs_q, const __nv_bfloat16* rhs_r,
           const __nv_bfloat16* rhs_a, int8_t* q123, __nv_bfloat16* xbf,
           __nv_bfloat16* rbf, __nv_bfloat16* abf, float* gram, int B, int S,
           int Np, int tile, int n_rhs, cudaStream_t stream) {
  const int smem = smem_bytes(S, W, n_rhs);
  cudaError_t err = cudaFuncSetAttribute(
      prep_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  prep_kernel<W><<<dim3(Np / W, B), kThreads, smem, stream>>>(
      A, rhs_q, rhs_r, rhs_a, q123, xbf, rbf, abf, gram, S, Np, tile, n_rhs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mf_prep_block(const float* A, const int8_t* rhs_q,
                             const __nv_bfloat16* rhs_r,
                             const __nv_bfloat16* rhs_a, int8_t* q123,
                             __nv_bfloat16* xbf, __nv_bfloat16* rbf,
                             __nv_bfloat16* abf, float* gram, int B, int S,
                             int Np, int tile, int n_rhs,
                             cudaStream_t stream) {
  if (n_rhs < 0 || n_rhs > kMaxRhs || tile <= 0 || Np % tile || S <= 0 ||
      (uintptr_t)A % 16 || (uintptr_t)rhs_q % 4 || (uintptr_t)rhs_r % 8 ||
      (uintptr_t)rhs_a % 8) {
    return (int)cudaErrorInvalidValue;
  }
  // the widest strip that divides the tile and fits shared memory
  auto fits = [&](int W) {
    return tile % W == 0 && smem_bytes(S, W, n_rhs) <= kSmemLimit;
  };
  if (fits(32)) {
    return launch<32>(A, rhs_q, rhs_r, rhs_a, q123, xbf, rbf, abf, gram, B,
                      S, Np, tile, n_rhs, stream);
  }
  if (fits(16)) {
    return launch<16>(A, rhs_q, rhs_r, rhs_a, q123, xbf, rbf, abf, gram, B,
                      S, Np, tile, n_rhs, stream);
  }
  if (fits(8)) {
    return launch<8>(A, rhs_q, rhs_r, rhs_a, q123, xbf, rbf, abf, gram, B, S,
                     Np, tile, n_rhs, stream);
  }
  return (int)cudaErrorInvalidValue;
}
