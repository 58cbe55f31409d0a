// Pieces shared by the hoist kernels, the operand preparations of the scans:
//   * every kernel of them: quantize2 (dfscan.quantize2), the running sums
//     of a double-float Gram (dfscan.df_gram: exact int32 level sums and
//     float64 sums of exact float32 cross products, rounded once), put_ps
//     (a df32.presplit into a pack) and tmin (torch.minimum);
//   * kernel 8 (df4hoist.cu), a design of its own on the tensor cores;
//   * the plain float32 hoists of the interval row passes, kernels 11
//     (row4hoist.cu) and 12 (row3hoist.cu), and the rhs columns' pack,
//     kernel 13 (rhsprep.cu): quantize3, the small f32scan._gram3_hi Grams
//     and the support intervals (the second section);
//   * the double-float prologues of the [N1, N2] scan, kernel 9
//     (df2hoist.cu), and of the [N1, N2, 1] re-scan, kernel 10
//     (df3hoist.cu): a voxel launch and an atom launch on one stream of the
//     atoms' samples (the third section).
//
// Kernels 9 and 10 quantise every normalised atom of the two blocks into
// int8 levels and float32 planes, sum each atom's Grams with itself and with
// the voxel's one or two small columns (the signal y and, for kernel 10, the
// CSF column), and run a short double-float chain an atom. The voxel launch,
// a block a voxel, quantises the small columns once into a scratch of
// chunks laid out as the atom launch copies them, and sums the voxel's own
// Grams among them. The atom launch, a block of kBA atoms of one voxel,
// copies the atoms' samples into a ring of shared-memory chunks by cp.async
// (kStages - 1 chunks in flight, with the small columns' chunk of the same
// samples); kParts threads an atom quantise its samples from there into a
// staged tile and sum its Grams; the tile's levels and planes leave as whole
// 16-byte vectors, rows of the atom axis (the contiguous one of every
// output). Every Gram of both launches is summed in kParts strided parts:
// part p the samples s = p mod kParts in sample order, the parts added in
// part order and rounded once (testing.fdot_hoist_order), where the plain
// version's einsum takes another order (testing.kernel_agreement).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "df_dekker.cuh"
#include "phases.cuh"

namespace mf {
namespace hoist {

// atoms (threads) a block of kernels 11 and 12; the row blocks of every
// hoist kernel need N1p to be a multiple of it
constexpr int kAtoms = 128;
// the strided parts of every Gram sum of a voxel launch, and of kernels 9
// and 10's atom launch (testing.fdot_parts_order, fdot_hoist_order)
constexpr int kParts = 4;
// dfscan._S1, _S2: the level scales 2^-7 and 2^-15
constexpr float kS1 = 0.0078125f, kS2 = 3.0517578125e-05f;

// quantize2 of one value: x = s1 q1 + s2 q2 + r, a = s1 q1 + s2 q2
struct Level {
  int q1, q2;
  float r, a;
};

// dfscan._round_levels of x / scale, given x / scale: torch.clamp(
// torch.round(x / scale), -127, 127) (rintf rounds half to even, as
// torch.round). The scales are powers of two, so x / scale is the exact
// product of x by 1 / scale (a NaN alike): the callers pass that product.
__device__ __forceinline__ int round_level(float x_over_scale) {
  return __float2int_rz(fminf(fmaxf(rintf(x_over_scale), -127.0f), 127.0f));
}

// dfscan.quantize2, operation for operation
__device__ __forceinline__ Level quantize2(float x) {
  const int q1 = round_level(mul(x, 128.0f));
  const float a1 = mul(__int2float_rn(q1), kS1);
  const int q2 = round_level(mul(sub(x, a1), 32768.0f));
  const float a = add(a1, mul(__int2float_rn(q2), kS2));
  return {q1, q2, sub(x, a), a};
}

// the running sums of one Gram g(qa, qb) (dfscan.df_gram): the exact level
// products and the float64 cross products c1 = (a_a + R_a)' R_b, c2 = R_a' a_b
struct Gram {
  int t11, t12, t22;
  double c1, c2;
};

__device__ __forceinline__ Gram gram_zero() { return {0, 0, 0, 0.0, 0.0}; }

// one sample of g(qa, qb): qa's levels, a + R and R; qb's levels, R and a
__device__ __forceinline__ void gram_step(Gram& g, int qa1, int qa2,
                                          double apr, double ra, int2 qb,
                                          double rb, double ab) {
  g.t11 += qa1 * qb.x;
  g.t12 += qa1 * qb.y + qa2 * qb.x;
  g.t22 += qa2 * qb.y;
  g.c1 = __fma_rn(apr, rb, g.c1);
  g.c2 = __fma_rn(ra, ab, g.c2);
}

// df_gram's combine: the level sums scaled (exactly) and the cross sums
// rounded once, added error-free (df32.df_from_sum)
__device__ __forceinline__ P2 gram_value(const Gram& g) {
  const float v[5] = {mul(__int2float_rn(g.t11), 6.103515625e-05f),
                      mul(__int2float_rn(g.t12), 2.384185791015625e-07f),
                      mul(__int2float_rn(g.t22), 9.313225746154785e-10f),
                      __double2float_rn(g.c1), __double2float_rn(g.c2)};
  return df_from_sum(v);
}

// df32.presplit of x into entries e .. e + 3 of a pack: hi, lo and the
// Dekker halves of hi
__device__ __forceinline__ void put_ps(float* pack, size_t stride, int e,
                                       P2 x) {
  const P2 h = dekker_split(x.p);
  pack[(size_t)e * stride] = x.p;
  pack[(size_t)(e + 1) * stride] = x.e;
  pack[(size_t)(e + 2) * stride] = h.p;
  pack[(size_t)(e + 3) * stride] = h.e;
}

// torch.minimum on the card: a NaN operand wins (the first one first), else
// the device min (CUDA's fminf, which torch's kernel calls)
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// ---------------------------------------------------------------------------
// The plain float32 hoists of the interval row passes (kernels 11 and 12,
// csrc/row4hoist.cu and csrc/row3hoist.cu) and the rhs columns' levels
// (kernel 13, csrc/rhsprep.cu): quantize3, the small f32scan._gram3_hi
// Grams among the voxel's rhs columns, and the support intervals of
// f32scan._interval, _sub1 and _sub2.
// ---------------------------------------------------------------------------

// dfscan._S3 = 2^-23
constexpr float kS3 = 1.1920928955078125e-07f;

// x.to(torch.bfloat16).float(): round to nearest even
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dfscan.quantize3 of one value, operation for operation: levels (q1, q2,
// q3), the residual r and the quantised part a (x = a + r exactly)
struct Level3 {
  int q1, q2, q3;
  float r, a;
};

__device__ __forceinline__ Level3 quantize3(float x) {
  const Level l = quantize2(x);
  const int q3 = round_level(mul(l.r, 8388608.0f));
  const float a = add(l.a, mul(__int2float_rn(q3), kS3));
  return {l.q1, l.q2, q3, sub(x, a), a};
}

// quantize3 of one value as f32scan._gram3_hi multiplies it: the levels
// (q1, q2, q3) and the bf16 planes (bf(a + R), bf(R), bf(a))
__device__ __forceinline__ void quantize3_planes(float x, int4& q, float4& v) {
  const Level3 l = quantize3(x);
  q = make_int4(l.q1, l.q2, l.q3, 0);
  v = make_float4(bf16r(add(l.a, l.r)), bf16r(l.r), bf16r(l.a), 0.0f);
}

// the running sums of f32scan._gram3_hi(qa, qb): level products grouped by
// scale (exact in int32) and the two float64 correction sums
struct Gram3 {
  int t11, t12, t22, t23, t33;
  double c1, c2;
};

__device__ __forceinline__ void gram3_step(Gram3& g, int4 qa, float4 va,
                                           int4 qb, float4 vb) {
  g.t11 += qa.x * qb.x;
  g.t12 += qa.x * qb.y + qa.y * qb.x;
  g.t22 += qa.y * qb.y + qa.x * qb.z + qa.z * qb.x;
  g.t23 += qa.y * qb.z + qa.z * qb.y;
  g.t33 += qa.z * qb.z;
  g.c1 = __fma_rn((double)va.x, (double)vb.y, g.c1);
  g.c2 = __fma_rn((double)va.y, (double)vb.z, g.c2);
}

// df32.df_from_sum(v_a, v_b, v_c, c1, c2, v_d, v_e)[0]: the running float32
// sum in that order
__device__ __forceinline__ float gram3_value(const Gram3& g) {
  float h = mul(__int2float_rn(g.t11), 0x1p-14f);
  h = add(h, mul(__int2float_rn(g.t12), 0x1p-22f));
  h = add(h, mul(__int2float_rn(g.t22), 0x1p-30f));
  h = add(h, __double2float_rn(g.c1));
  h = add(h, __double2float_rn(g.c2));
  h = add(h, mul(__int2float_rn(g.t23), 0x1p-38f));
  return add(h, mul(__int2float_rn(g.t33), 0x1p-46f));
}

// samples of the small columns a voxel launch of kernels 11 and 12 stages
// at a time
constexpr int kVoxTile = 64;
static_assert(kVoxTile % kParts == 0, "a tile keeps every part's samples");

// The shared memory of vox_grams: a tile of kVoxTile samples of C small
// columns, quantize3'd for _gram3_hi, sample-major so that the threads of a
// warp, which read one sample of several columns, fall on distinct banks;
// the parts' sums of V Grams.
template <int C, int V>
struct VoxGrams {
  int4 q[kVoxTile][C];
  float4 v[kVoxTile][C];
  Gram3 part[kParts][V];
};

// The voxel launch's small Grams (kernels 11 and 12), a block of Threads
// threads a voxel: ``cols(c, s)`` is sample s of small column c < nc (C at
// most), quantised once, a tile at a time; the Grams ``pair(t)``, t < nv (V
// at most), summed in kParts strided parts: thread t sums Gram t % slots,
// slots = Threads / kParts, over part p = t / slots, the samples
// s = p mod kParts in order; the parts are added in part order, the int32
// sums exactly and the float64 sums rounded once
// (testing.fdot_parts_order). Their values go to ``vg`` (shared memory,
// nv floats), there for every thread on return. Every thread takes part.
template <int C, int V, int Threads, class Cols, class Pair>
__device__ __forceinline__ void vox_grams(VoxGrams<C, V>& sm, float* vg,
                                          const Cols& cols, int nc,
                                          const Pair& pair, int nv, int S) {
  constexpr int kSlots = Threads / kParts;
  // samples of the small columns a thread quantises a tile
  constexpr int kPer = (C * kVoxTile + Threads - 1) / Threads;
  static_assert(V <= kSlots && Threads % kParts == 0, "slots");
  const int tid = threadIdx.x;
  const int gi = tid % kSlots, p = tid / kSlots;
  const int2 pr = pair(gi < nv ? gi : 0);
  Gram3 g = {0, 0, 0, 0, 0, 0.0, 0.0};
  // the thread's samples of a tile (entry e = tid + u Threads: column
  // e / kVoxTile, sample e % kVoxTile), loaded a tile ahead so that the
  // loads are in flight while the last tile is summed
  float xv[kPer];
  auto load_tile = [&](int s0) {
    #pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * Threads;
      const int c = e / kVoxTile, t = e % kVoxTile;
      xv[u] = c < nc && s0 + t < S ? cols(c, s0 + t) : 0.0f;
    }
  };
  load_tile(0);
  for (int s0 = 0; s0 < S; s0 += kVoxTile) {
    const int kn = min(kVoxTile, S - s0);
    __syncthreads();  // the last tile is consumed
    #pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * Threads;
      const int c = e / kVoxTile, t = e % kVoxTile;
      if (c < nc && t < kn) quantize3_planes(xv[u], sm.q[t][c], sm.v[t][c]);
    }
    __syncthreads();
    if (s0 + kVoxTile < S) load_tile(s0 + kVoxTile);
    if (gi < nv) {
      #pragma unroll 1
      for (int t = p; t < kn; t += kParts) {
        gram3_step(g, sm.q[t][pr.x], sm.v[t][pr.x], sm.q[t][pr.y],
                   sm.v[t][pr.y]);
      }
    }
  }
  if (gi < nv) sm.part[p][gi] = g;
  __syncthreads();
  if (tid < nv) {
    // the parts in part order: int32 sums exact, float64 sums rounded once
    Gram3 t = sm.part[0][tid];
    #pragma unroll
    for (int q = 1; q < kParts; ++q) {
      const Gram3& u = sm.part[q][tid];
      t.t11 += u.t11;
      t.t12 += u.t12;
      t.t22 += u.t22;
      t.t23 += u.t23;
      t.t33 += u.t33;
      t.c1 = t.c1 + u.c1;
      t.c2 = t.c2 + u.c2;
    }
    vg[tid] = gram3_value(t);
  }
  __syncthreads();
}

// the scalars the plain versions pass as python floats (f32scan._EPS,
// _TOL, KERR)
struct Consts {
  float eps, tol, kerr;
};

struct Interval {
  float lo, up;
};

// f32scan._fold
__device__ __forceinline__ void fold(Interval& acc, Interval s) {
  acc.lo = tmin(acc.lo, s.lo);
  acc.up = tmin(acc.up, s.up);
}

// f32scan._interval
__device__ __forceinline__ Interval interval(bool feas, bool stab, float res,
                                             float ws, bool excl,
                                             const Consts& k) {
  const float err = mul(k.kerr, add(1.0f, ws));
  res = nan_to_inf(res);
  return {feas ? sub(res, err) : (stab ? kInf : (excl ? kInf : -k.kerr)),
          feas ? add(res, err) : kInf};
}

// f32scan._sub1: support {a}
__device__ __forceinline__ Interval sub1(float d, float p, float w,
                                         const Consts& k) {
  const float wa = dv(p, d);
  return interval(wa >= 0.0f, true, sub(w, mul(p, wa)), fabsf(wa), false, k);
}

// f32scan._sub2: support {a, b}, with the determinant cutoff ``det_tol``
// (0 for the [N1, N2, 1] case logic, _TOL for the 4-block enumeration)
__device__ __forceinline__ Interval sub2(float dA, float dB, float g, float pA,
                                         float pB, float w, float det_tol,
                                         const Consts& k) {
  const float invA = dv(1.0f, dA);
  const float piv = sub(dB, mul(mul(g, g), invA));
  const bool stab = piv > mul(k.eps, dB);
  const float invP = stab ? dv(1.0f, piv) : 0.0f;
  const float t = sub(pB, mul(mul(g, pA), invA));
  const float wb = mul(t, invP);
  const float wa = mul(sub(pA, mul(g, wb)), invA);
  const bool feas =
      stab && piv > mul(det_tol, dB) && wa >= 0.0f && wb >= 0.0f;
  const float res = sub(sub(w, mul(mul(pA, pA), invA)), mul(t, wb));
  return interval(feas, stab, res, add(fabsf(wa), fabsf(wb)), det_tol > 0.0f,
                  k);
}

// A minimum over the column blocks of a voxel: its partials (B, nparts)
// folded, a thread a voxel (a minimum is exact in any order, and a NaN
// wins as torch.minimum's does)
template <class T>
__global__ void fold_min(const T* __restrict__ part, T* __restrict__ out,
                         int B, int nparts) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* pb = part + (size_t)b * nparts;
  T m = pb[0];
  for (int t = 1; t < nparts; ++t) m = tmin(m, pb[t]);
  out[b] = m;
}

// ---------------------------------------------------------------------------
// The double-float prologues, kernels 9 (df2hoist.cu) and 10 (df3hoist.cu):
// a voxel launch, then an atom launch.
// ---------------------------------------------------------------------------

// the atom launch: kBA atoms a block, kParts threads an atom, kSK samples a
// chunk, a ring of kStages chunks
constexpr int kBA = 64, kStreamThreads = kParts * kBA, kSK = 32, kStages = 4;
// the voxel launch's threads a block; the most small Grams it sums
constexpr int kVoxThreads = 128, kMaxVoxGrams = 3;
static_assert(kSK % kParts == 0, "a chunk keeps every part's samples");
static_assert(kBA % 16 == 0, "a tile row is whole 16-byte vectors");

// a + b of two parts' sums, in that order: the int32 sums exact, the
// float64 sums rounded
__device__ __forceinline__ Gram gram_add(Gram t, const Gram& u) {
  t.t11 += u.t11;
  t.t12 += u.t12;
  t.t22 += u.t22;
  t.c1 = t.c1 + u.c1;
  t.c2 = t.c2 + u.c2;
  return t;
}

// kSK samples of the voxel's C small columns as the atom launch reads them:
// levels (q1, q2) and (R, a) as float64 (exact), zeros past S. The voxel
// launch writes a voxel's chunks once, (B, n_chunk, ColChunk<C>), and every
// atom block of the voxel copies them.
template <int C>
struct alignas(16) ColChunk {
  int2 q[C][kSK];
  double2 ra[C][kSK];
};

// The voxel launch's small columns in dynamic shared memory: nc columns of
// S samples, (R, a) then the levels.
struct VoxStage {
  double2* ra;
  int2* q;
  int S;
  __device__ VoxStage(unsigned char* smem, int nc, int S_)
      : ra(reinterpret_cast<double2*>(smem)),
        q(reinterpret_cast<int2*>(smem + (size_t)nc * S_ * sizeof(double2))),
        S(S_) {}
};

// bytes of that dynamic shared memory
inline size_t voxel_smem(int nc, int S) {
  return (size_t)nc * S * (sizeof(double2) + sizeof(int2));
}

// The voxel launch's pass, a block of kVoxThreads threads a voxel:
// ``cols(c, s)`` is sample s of the voxel's small column c < nc. Every
// sample quantised once into ``st``; the first Cs columns copied out as the
// voxel's chunks; the Grams ``pair(t)``, t < nv, summed in kParts strided
// parts (thread kParts t + p sums part p) and added in part order, their
// values into ``vg`` (shared memory). Every thread takes part; the values
// are there for every thread on return.
template <int Cs, class Cols, class Pair>
__device__ __forceinline__ void voxel_pass(const VoxStage& st,
                                           const Cols& cols, int nc,
                                           const Pair& pair, int nv,
                                           ColChunk<Cs>* __restrict__ chunks,
                                           P2* vg) {
  __shared__ Gram part[kParts][kMaxVoxGrams];
  const int tid = threadIdx.x, S = st.S;
  #pragma unroll 4
  for (int e = tid; e < nc * S; e += kVoxThreads) {
    const Level l = quantize2(cols(e / S, e % S));
    st.q[e] = make_int2(l.q1, l.q2);
    st.ra[e] = make_double2((double)l.r, (double)l.a);
  }
  __syncthreads();
  const int n_chunk = (S + kSK - 1) / kSK;
  for (int e = tid; e < n_chunk * Cs * kSK; e += kVoxThreads) {
    const int ch = e / (Cs * kSK), c = e / kSK % Cs, k = e % kSK;
    const int s = ch * kSK + k;
    const bool in = s < S;
    chunks[ch].q[c][k] = in ? st.q[c * S + s] : make_int2(0, 0);
    chunks[ch].ra[c][k] = in ? st.ra[c * S + s] : make_double2(0.0, 0.0);
  }
  const int gi = tid / kParts, p = tid % kParts;
  if (gi < nv) {
    const int2 pr = pair(gi);
    const double2* va = st.ra + pr.x * S;
    const double2* vb = st.ra + pr.y * S;
    const int2* qa = st.q + pr.x * S;
    const int2* qb = st.q + pr.y * S;
    Gram g = gram_zero();
    #pragma unroll 1
    for (int s = p; s < S; s += kParts) {
      // a + R in float32, as the plain version adds the planes
      const float apr = add((float)va[s].y, (float)va[s].x);
      gram_step(g, qa[s].x, qa[s].y, (double)apr, va[s].x, qb[s], vb[s].x,
                vb[s].y);
    }
    part[p][gi] = g;
  }
  __syncthreads();
  if (tid < nv) {
    Gram t = part[0][tid];
    #pragma unroll
    for (int q = 1; q < kParts; ++q) t = gram_add(t, part[q][tid]);
    vg[tid] = gram_value(t);
  }
  __syncthreads();
}

// a chunk of a block's atoms, quantised, as the stores write it out: the
// levels, R and the second plane (a, or a + R)
struct alignas(16) AtomTile {
  int8_t q[2][kSK][kBA];
  float r[kSK][kBA];
  float v[kSK][kBA];
};

// the atom launch's shared memory: the ring of the atoms' samples and the
// small columns' chunks (after the pass, the parts' Grams), and two tiles
template <int C>
struct alignas(16) StreamSmem {
  union {
    struct {
      float x[kStages][kSK][kBA];
      ColChunk<C> col[kStages];
    } ring;
    Gram part[kParts][1 + C][kBA];
  };
  AtomTile tile[2];
};

// where the atom launch writes a block's levels and planes: pointers at
// (voxel, sample 0, the block's first atom), the samples ``stride`` atoms
// apart (a multiple of 16); the second plane ``v``, where not null, a or
// (with ``v_apr``) a + R
struct AtomOut {
  int8_t* q1;
  int8_t* q2;
  float* r;
  float* v;
  bool v_apr;
  size_t stride;
};

// The atom launch's pass over the samples, a block of kStreamThreads
// threads: thread t owns atom a = t % kBA of the block (its atom i0 + a)
// and part p = t / kBA of its samples. ``in`` points at the voxel's block
// (sample 0, atom 0; the samples ``width`` atoms apart; atoms past
// ``width`` read as zeros); ``chunks`` at the voxel's small-column chunks.
// The levels and planes of the block's atoms go to ``out``; the threads of
// part 0 return their atom's Grams in ``g``: [0] with itself, [1 + c] with
// small column c. Every thread takes part.
template <int C>
__device__ __forceinline__ void atom_stream(
    StreamSmem<C>& sm, const float* __restrict__ in, int width, int i0,
    int S, const ColChunk<C>* __restrict__ chunks, const AtomOut& out,
    P2 (&g)[1 + C]) {
  const int tid = threadIdx.x, a = tid % kBA, p = tid / kBA;
  const int n_chunk = (S + kSK - 1) / kSK;
  // copies of 16 bytes where the rows allow it (width a multiple of 4 and
  // the block 16-byte aligned), else 8, else 4
  const uintptr_t base = (uintptr_t)in;
  const int vec = width % 4 == 0 && base % 16 == 0 ? 4
                  : width % 2 == 0 && base % 8 == 0 ? 2 : 1;
  // the chunk's atoms' samples, V floats a copy
  auto copy_x = [&](float (&xs)[kSK][kBA], int s0, auto v) {
    constexpr int V = decltype(v)::value, per = kBA / V;
    for (int e = tid; e < kSK * per; e += kStreamThreads) {
      const int k = e / per, at = V * (e % per);
      const bool ok = s0 + k < S && i0 + at < width;
      const float* src = ok ? in + (size_t)(s0 + k) * width + i0 + at : in;
      cp_async<4 * V>(&xs[k][at], src, ok);
    }
  };
  // chunk ch of the atoms' samples and of the small columns into the
  // ring, zeros past S and past width; one commit group a chunk (an empty
  // one past the last), complete after the cp_async_wait that covers it
  // and a barrier
  auto copy = [&](int ch) {
    if (ch < n_chunk) {
      float (&xs)[kSK][kBA] = sm.ring.x[ch % kStages];
      if (vec == 4) {
        copy_x(xs, ch * kSK, std::integral_constant<int, 4>{});
      } else if (vec == 2) {
        copy_x(xs, ch * kSK, std::integral_constant<int, 2>{});
      } else {
        copy_x(xs, ch * kSK, std::integral_constant<int, 1>{});
      }
      const uint4* csrc = reinterpret_cast<const uint4*>(chunks + ch);
      uint4* cdst = reinterpret_cast<uint4*>(&sm.ring.col[ch % kStages]);
      for (int e = tid; e < (int)(sizeof(ColChunk<C>) / 16);
           e += kStreamThreads) {
        cp_async<16>(cdst + e, csrc + e, true);
      }
    }
    cp_async_commit();
  };
  // the tile of chunk ch out to device memory: rows of 16-byte vectors
  auto store = [&](int ch) {
    const AtomTile& t = sm.tile[ch & 1];
    const int s0 = ch * kSK, kn = min(kSK, S - s0);
    constexpr int kQV = kBA / 16, kFV = kBA / 4;  // vectors a row
    for (int e = tid; e < 2 * kSK * kQV; e += kStreamThreads) {
      const int l = e / (kSK * kQV), k = e / kQV % kSK, j = e % kQV;
      if (k < kn) {
        int8_t* dst = (l ? out.q2 : out.q1) + (size_t)(s0 + k) * out.stride;
        reinterpret_cast<uint4*>(dst)[j] =
            reinterpret_cast<const uint4*>(t.q[l][k])[j];
      }
    }
    const int np = out.v ? 2 : 1;
    for (int e = tid; e < np * kSK * kFV; e += kStreamThreads) {
      const int l = e / (kSK * kFV), k = e / kFV % kSK, j = e % kFV;
      if (k < kn) {
        float* dst = (l ? out.v : out.r) + (size_t)(s0 + k) * out.stride;
        reinterpret_cast<float4*>(dst)[j] =
            reinterpret_cast<const float4*>(l ? t.v[k] : t.r[k])[j];
      }
    }
  };

  Gram acc[1 + C];
  #pragma unroll
  for (int j = 0; j <= C; ++j) acc[j] = gram_zero();
  for (int ch = 0; ch < kStages - 1; ++ch) copy(ch);
  for (int ch = 0; ch < n_chunk; ++ch) {
    // chunk ch landed; the last chunk's tile is written and its ring
    // buffers consumed
    cp_async_wait<kStages - 2>();
    __syncthreads();
    copy(ch + kStages - 1);
    if (ch > 0) store(ch - 1);
    MF_PHASE(1);
    const int kn = min(kSK, S - ch * kSK);
    const float (&xs)[kSK][kBA] = sm.ring.x[ch % kStages];
    AtomTile& t = sm.tile[ch & 1];
    // the thread's samples of the chunk, in one pass: quantised into the
    // tile, and the atom's Grams summed (a chunk of kSK samples fully
    // unrolled)
    const ColChunk<C>& cc = sm.ring.col[ch % kStages];
    auto step = [&](int k) {
      const Level l = quantize2(xs[k][a]);
      t.q[0][k][a] = (int8_t)l.q1;
      t.q[1][k][a] = (int8_t)l.q2;
      t.r[k][a] = l.r;
      const float apr = add(l.a, l.r);
      if (out.v) t.v[k][a] = out.v_apr ? apr : l.a;
      const double dapr = (double)apr, dr = (double)l.r;
      gram_step(acc[0], l.q1, l.q2, dapr, dr, make_int2(l.q1, l.q2), dr,
                (double)l.a);
      #pragma unroll
      for (int c = 0; c < C; ++c) {
        gram_step(acc[1 + c], l.q1, l.q2, dapr, dr, cc.q[c][k],
                  cc.ra[c][k].x, cc.ra[c][k].y);
      }
    };
    if (kn == kSK) {
      #pragma unroll
      for (int u = 0; u < kSK / kParts; ++u) step(p + kParts * u);
    } else {
      #pragma unroll 1
      for (int k = p; k < kn; k += kParts) step(k);
    }
    MF_PHASE(2);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free, the last tile written
  store(n_chunk - 1);
  #pragma unroll
  for (int j = 0; j <= C; ++j) sm.part[p][j][a] = acc[j];
  MF_PHASE(1);
  __syncthreads();
  if (p == 0) {
    #pragma unroll
    for (int j = 0; j <= C; ++j) {
      Gram t = sm.part[0][j][a];
      #pragma unroll
      for (int q = 1; q < kParts; ++q) t = gram_add(t, sm.part[q][j][a]);
      g[j] = gram_value(t);
    }
  }
  MF_PHASE(2);
}

}  // namespace hoist
}  // namespace mf
