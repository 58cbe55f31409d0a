// Kernel 8: the prologue of the double-float 4-block (EAR) re-scan.
//
// Counterpart of the JAX package's row_scan_df4 before its pallas_call
// (microstructure_fingerprinting_tpu/ops/pallas_dfscan.py:686-860: quantise,
// Grams, LDL' hoists, packs; XLA fuses them into the jit of the kernel) and
// of its plain version here, ops/rescan.df4_hoist_twin (_df4_hoists). From
// the normalised blocks A1h (B, S, N1p), A2h (B, S, N2), A3h (B, S, 1),
// A4h (B, S, N4) and yh (B, S) it writes kernel 5's operands: the int8
// levels and float32 planes of both blocks (q1a, q2a, ra; q1b, q2b, rb, ab,
// the columns past N2 zero), row_pack (B, NR, N1p), col_pack (B, NC, N2pb)
// (zero past N2, as the plain version pads after its chain) and vox (B, NV),
// in the layout that kernel 5 reads (csrc/rescan4.cu; ops/rescan
// .df4_pack_sizes). a1h is A1h itself.
//
// What bounds it on an H100: bytes. Each block reads its atoms once and
// writes their levels, planes and packs once (~2 GB a 512-voxel chunk at
// R = 256); per atom and sample 3 + N4 Grams (with itself, the signal, the
// CSF and the EAR columns) of 4 int8 level products and 2 float64
// multiply-adds; per atom a chain of ~1,700 float32 operations for each of
// the N4 sweeps. The plain version unrolls the N4 sweeps and the 1 + N4
// extra columns in Python, each double-float operation several torch
// kernels of a few microseconds: ~16,000 kernels a call. Its first design
// (a thread an atom summing all its Grams on the scalar pipes, every block
// the voxel's small Grams again) spent 80% of its cycles on the atom
// stream and 17% on the small Grams (examples/kernel_phases.py). The
// design, for this card:
//   * a first launch, a block a voxel (df4vox_kernel), quantises the
//     voxel's 2 + N4 small columns once, kVoxTile samples at a time (the
//     next tile's loads in flight while a tile is summed), writes them out
//     in chunks laid out as the tensor cores read them (ColChunk), and
//     sums the 3 + 3 N4 small Grams (w, d3, r3, then d4, r4, g34 of each
//     EAR column) with the samples split into kParts parts, a thread a Gram
//     and part: part p takes the samples s = p mod kParts in order, the
//     int32 level sums are exact in any order and the float64 sums of the
//     parts are added in part order and rounded once. Then the voxel's
//     LDL' factors and the parts of the {1, 2, 3, 4}-less sub-supports that
//     do not depend on the atom (the expansion of dfscan._sub3_df in B =
//     CSF, C = EAR column), one EAR column a thread: vox, and the scratch
//     (B, kScr) that the atom launch reads;
//   * the atom launch (df4hoist_kernel): blocks 0 .. N1p/64 - 1 own 64
//     rows of A1 of one voxel, the next ones 64 columns of A2; 128
//     threads, two an atom. The atoms' samples and the voxel's column
//     chunks are copied into shared memory kSK samples at a time by
//     cp.async (async_copy.cuh), two chunks ahead of the one being worked
//     on. A chunk at a time, every thread quantises half its atom's
//     samples (writing the levels and planes out once, coalesced: the atom
//     axis is the contiguous one) into a staging area, and the first
//     thread of each atom sums its Gram with itself in sample order from
//     there. The Grams of the block's atoms with the 2 + N4 small columns,
//     a skinny (64 x kSK) by (kSK x 8 NT) product, run on the tensor cores
//     (mma_sync.cuh): a warp owns 16 atoms and the NT column tiles of 8;
//     the level products by int8 m16n8k32 (exact in int32, the samples in
//     the permuted k order of gram_df.cuh), the two float32 cross products
//     (a + R)' R_b and R' a_b by float64 m16n8k8 (exact products, float64
//     sums rounded once), 8 samples an mma, chunk after chunk. A lane holds
//     28 NT accumulators through the pass: 64 atoms a block of 128 threads
//     keep them in registers without a spill, three blocks an SM for
//     NT <= 2 (kBA);
//   * the two threads of an atom then share its chain: the even and the odd
//     extra columns and sweeps, each pack entry written straight to device
//     memory (coalesced).
// Every operation after the sums mirrors the plain version's, in Dekker's
// forms and its operand order (a Dekker product's error term depends on
// it), the minimum as torch.minimum (hoist::tmin): bit for bit, NaN
// included (an all-zero padded atom gives res1 = 0/0), but for the float64
// sums' order: the atom's own Gram in sample order (testing
// .fdot_sample_order), its Grams with the small columns in the tensor
// cores' order, the voxel's small Grams in kParts parts (testing
// .fdot_parts_order): equal except at such near-ties
// (testing.kernel_agreement).
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "hoist.cuh"
#include "mma_sync.cuh"
#include "phases.cuh"

namespace {

using mf::df_add;
using mf::df_div;
using mf::df_mul;
using mf::neg;
using mf::P2;
using mf::scale;
using mf::val;
using mf::hoist::kAtoms;

// the most EAR columns a call takes
constexpr int kMaxE = 16;
constexpr int kMaxC = 2 + kMaxE, kMaxV = 3 + 3 * kMaxE;
// the voxel launch: threads a block, samples quantised at a time, and the
// parts the samples of a small Gram are split into (thread t sums Gram
// t % kGramSlots over the samples s = t / kGramSlots mod kParts)
constexpr int kVoxThreads = 256, kVoxTile = 64, kParts = 4;
constexpr int kGramSlots = kVoxThreads / kParts;
static_assert(kMaxV <= kGramSlots && kVoxTile % kParts == 0, "slots");
static_assert(kVoxTile % 32 == 0, "a tile writes whole column chunks");
// samples of the small columns a thread quantises a tile
constexpr int kVoxPer = (kMaxC * kVoxTile + kVoxThreads - 1) / kVoxThreads;
// the atom launch: kBA atoms a block (a warp's 16 of them a tile), two
// threads an atom, kSK samples a chunk; shared-memory rows padded so that
// the lanes of a fragment load fall on distinct banks: the atoms' levels by
// 16 bytes, their planes by 8 floats, the small columns' levels to 32
// bytes, their planes to 40 floats
constexpr int kBA = 64, kThreads = 2 * kBA, kSK = 32;
constexpr int kQA = kBA + 16, kFA = kBA + 8, kQC = 32, kFC = 40;
static_assert(kAtoms % kBA == 0, "row blocks tile N1p");
static_assert(8 * ((kMaxC + 7) / 8) <= kQC && kQC <= kFC, "column rows");

// dfscan._sub1_df: support {a}
__device__ float sub1(P2 d, P2 p, P2 w) {
  const float num = val(df_add(df_mul(d, w), neg(df_mul(p, p))));
  const float res = mf::dv(num, val(d));
  return val(p) >= 0.0f ? res : mf::kInf;
}

// dfscan._sub2_df: support {a, b}
__device__ float sub2(P2 dA, P2 dB, P2 g, P2 pA, P2 pB, P2 w, float tol) {
  const float det2 = val(df_add(df_mul(dA, dB), neg(df_mul(g, g))));
  const P2 nt[5] = {df_mul(df_mul(dA, dB), w), neg(df_mul(df_mul(g, g), w)),
                    scale(df_mul(df_mul(g, pA), pB), 2.0f),
                    neg(df_mul(df_mul(dA, pB), pB)),
                    neg(df_mul(df_mul(dB, pA), pA))};
  const float num = mf::acc(nt);
  const P2 n1t[2] = {df_mul(dB, pA), neg(df_mul(g, pB))};
  const P2 n2t[2] = {df_mul(dA, pB), neg(df_mul(g, pA))};
  const float n1 = mf::acc(n1t), n2 = mf::acc(n2t);
  const bool feas = det2 > mf::mul(mf::mul(tol, val(dA)), val(dB)) &&
                    n1 >= 0.0f && n2 >= 0.0f;
  return feas ? mf::dv(num, det2) : mf::kInf;
}

// The voxel's values for EAR column j: its Grams, the LDL' factors of
// ops/rescan._df4_hoists and the parts of dfscan._sub3_df with B = the CSF
// column, C = EAR column j (U1 .. V2, C2 and _det3_cramer_df's X), which
// every atom's {A, 3, 4} support shares.
struct VoxJ {
  P2 d4, r4, g34, L43, invD4h, t4, rho34;
  P2 U1, U2, U3, U4, V1, V2, C2, X;
};

__device__ VoxJ vox_factors(P2 w, P2 d3, P2 r3, P2 invd3, P2 d4, P2 r4,
                            P2 g34, float tol, bool& ok34, float& u4f) {
  const P2 one = {1.0f, 0.0f};
  VoxJ v;
  v.d4 = d4;
  v.r4 = r4;
  v.g34 = g34;
  v.L43 = df_mul(g34, invd3);
  const P2 D4h = df_add(d4, neg(df_mul(g34, v.L43)));
  ok34 = val(D4h) > mf::mul(tol, val(d4));
  v.invD4h = df_div(one, ok34 ? D4h : one);
  v.t4 = df_add(r4, neg(df_mul(v.L43, r3)));
  v.rho34 = df_add(df_add(w, neg(df_mul(df_mul(r3, r3), invd3))),
                   neg(df_mul(df_mul(v.t4, v.t4), v.invD4h)));
  u4f = val(df_mul(v.t4, v.invD4h));
  // _sub3_df(dA, dB = d3, dC = d4, gAB, gAC, gBC = g34, pA, pB = r3,
  // pC = r4, w): what does not involve A
  const P2 dB = d3, dC = d4, gBC = g34, pB = r3, pC = r4;
  v.U1 = df_add(df_mul(pB, pB), neg(df_mul(dB, w)));
  v.U2 = scale(df_add(df_mul(dB, pC), neg(df_mul(gBC, pB))), 2.0f);
  v.U3 = df_add(
      df_add(df_add(df_mul(dB, df_add(df_mul(dC, w), neg(df_mul(pC, pC)))),
                    neg(df_mul(dC, df_mul(pB, pB)))),
             scale(df_mul(df_mul(gBC, pB), pC), 2.0f)),
      neg(df_mul(df_mul(gBC, gBC), w)));
  v.U4 = df_add(df_mul(gBC, gBC), neg(df_mul(dB, dC)));
  v.V1 = scale(df_add(df_mul(gBC, w), neg(df_mul(pB, pC))), 2.0f);
  v.V2 = scale(df_add(df_mul(dC, pB), neg(df_mul(gBC, pC))), 2.0f);
  v.C2 = df_add(df_mul(pC, pC), neg(df_mul(dC, w)));
  v.X = df_add(df_mul(dB, dC), neg(df_mul(gBC, gBC)));
  return v;
}

// dfscan._sub3_df(dA, d3, d4, gAB, gAC, g34, pA, r3, r4, w): support
// {A, 3, 4}, with the voxel's parts of EAR column j
__device__ float sub3(P2 dA, P2 gAB, P2 gAC, P2 pA, P2 dB, P2 pB,
                      const VoxJ& v, float tol) {
  const P2 dC = v.d4, gBC = v.g34, pC = v.r4;
  const P2 dt[6] = {df_mul(df_mul(gAC, gAC), v.U1),
                    df_mul(df_mul(gAC, pA), v.U2), df_mul(dA, v.U3),
                    df_mul(df_mul(pA, pA), v.U4),
                    df_mul(gAB, df_add(df_mul(gAC, v.V1), df_mul(pA, v.V2))),
                    df_mul(df_mul(gAB, gAB), v.C2)};
  const float det4 = mf::acc(dt);
  // _det3_cramer_df
  const P2 Z = df_add(df_mul(gAB, dC), neg(df_mul(gBC, gAC)));
  const P2 W = df_add(df_mul(gAB, gBC), neg(df_mul(dB, gAC)));
  const P2 Y = df_add(df_mul(dA, dC), neg(df_mul(gAC, gAC)));
  const P2 V = df_add(df_mul(dA, gBC), neg(df_mul(gAC, gAB)));
  const P2 T = df_add(df_mul(dA, dB), neg(df_mul(gAB, gAB)));
  const P2 t0[3] = {df_mul(dA, v.X), neg(df_mul(gAB, Z)), df_mul(gAC, W)};
  const P2 t1[3] = {df_mul(pA, v.X), neg(df_mul(pB, Z)), df_mul(pC, W)};
  const P2 t2[3] = {neg(df_mul(pA, Z)), df_mul(pB, Y), neg(df_mul(pC, V))};
  const P2 t3[3] = {df_mul(pA, W), neg(df_mul(pB, V)), df_mul(pC, T)};
  const float det3 = mf::acc(t0), D1 = mf::acc(t1), D2 = mf::acc(t2),
              D3 = mf::acc(t3);
  const bool feas =
      det3 > mf::mul(mf::mul(mf::mul(tol, val(dA)), val(dB)), val(dC)) &&
      D1 >= 0.0f && D2 >= 0.0f && D3 >= 0.0f;
  return feas ? mf::dv(det4, det3) : mf::kInf;
}

// the small columns of voxel b: 0 the signal, 1 the CSF column, 2 + j EAR
// column j
struct Cols {
  const float* y;
  const float* a3;
  const float* a4;
  int n4;
  __device__ float operator()(int c, int s) const {
    return c == 0 ? y[s] : (c == 1 ? a3[s] : a4[(size_t)s * n4 + (c - 2)]);
  }
};

// the voxel Grams a block sums: 0 w = g(y, y), 1 d3 = g(a3, a3),
// 2 r3 = g(a3, y), then for EAR column j: d4 = g(a4j, a4j), r4 = g(a4j, y),
// g34 = g(a3, a4j)
struct Pairs {
  __device__ int2 operator()(int t) const {
    if (t < 3) return t == 0 ? make_int2(0, 0) : make_int2(1, t == 1 ? 1 : 0);
    const int j = (t - 3) / 3, k = (t - 3) % 3;
    return k == 0 ? make_int2(2 + j, 2 + j)
                  : (k == 1 ? make_int2(2 + j, 0) : make_int2(1, 2 + j));
  }
};

// the voxel scratch (B, kScr) the voxel launch writes and the atom launch
// reads: the CSF column's values, then each EAR column's VoxJ
constexpr int kScrJ = 30, kScr = 8 + kScrJ * kMaxE;
struct VoxScr {
  P2 w, d3, r3, invd3;
  VoxJ vj[kMaxE];
};
static_assert(sizeof(VoxJ) == kScrJ * sizeof(float) &&
                  sizeof(VoxScr) == kScr * sizeof(float),
              "the scratch layout");

// the voxel launch's tile: kVoxTile samples of the small columns, their
// levels (q1, q2) and (R, a) as float64 (exact); sample-major, so that
// the threads of a warp, which read one sample of several columns, fall
// on distinct banks
struct VoxTile {
  int2 q[kVoxTile][kMaxC];
  double2 ra[kVoxTile][kMaxC];
};

// a chunk of kSK samples of the small columns as the tensor cores read
// them: levels, R and a, zeros past S and past the 2 + N4 columns (the
// first kCW columns are written, all that 8 NT column tiles read). The
// voxel launch writes a voxel's chunks once, (B, n_chunk, ColChunk), and
// every atom block of the voxel copies them.
struct alignas(16) ColChunk {
  int8_t q1[kSK][kQC], q2[kSK][kQC];
  float r[kSK][kFC], a[kSK][kFC];
};
constexpr int kCW = 8 * ((kMaxC + 7) / 8);
static_assert(sizeof(ColChunk) % 16 == 0 && kCW <= kQC, "column chunks");

// The voxel's prologue, a block a voxel: the small Grams, the factors, vox,
// the scratch and the small columns' chunks.
__global__ void __launch_bounds__(kVoxThreads)
df4vox_kernel(const float* __restrict__ yh, const float* __restrict__ A3h,
              const float* __restrict__ A4h, float* __restrict__ vox,
              float* __restrict__ scr, ColChunk* __restrict__ cols_out,
              int S, int n4, int NV, float tol) {
  __shared__ VoxTile tile;
  __shared__ mf::hoist::Gram part[kParts][kMaxV];
  __shared__ P2 vg[kMaxV];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int n3 = 1, nx = n3 + n4, ns = n3 * n4;
  // voxel entries (ops/rescan._df4_hoists)
  const int v_x0 = 4, v_s0 = v_x0 + 6 * nx, v_fix0 = v_s0 + 4 * ns;
  const int nvox = v_fix0 + ns;
  MF_PHASE_BEGIN;

  const size_t vS = (size_t)b * S;
  const Cols cols = {yh + vS, A3h + vS, A4h + vS * n4, n4};
  const int nc = 2 + n4, nv = 3 + 3 * n4, n_chunk = (S + kSK - 1) / kSK;
  const int gi = tid % kGramSlots, p = tid / kGramSlots;
  const int2 pr = Pairs{}(gi < nv ? gi : 0);
  mf::hoist::Gram g = mf::hoist::gram_zero();
  // the thread's samples of a tile (entry e = tid + u kVoxThreads: column
  // e / kVoxTile, sample e % kVoxTile), loaded a tile ahead so that the
  // loads are in flight while the last tile is summed
  float xv[kVoxPer];
  auto load_tile = [&](int s0) {
    #pragma unroll
    for (int u = 0; u < kVoxPer; ++u) {
      const int e = tid + u * kVoxThreads;
      const int c = e / kVoxTile, t = e % kVoxTile;
      xv[u] = c < nc && s0 + t < S ? cols(c, s0 + t) : 0.0f;
    }
  };
  load_tile(0);
  for (int s0 = 0; s0 < S; s0 += kVoxTile) {
    const int kn = min(kVoxTile, S - s0);
    __syncthreads();  // the last tile is consumed
    #pragma unroll
    for (int u = 0; u < kVoxPer; ++u) {
      const int e = tid + u * kVoxThreads;
      const int c = e / kVoxTile, t = e % kVoxTile;
      if (c < nc && t < kn) {
        const mf::hoist::Level l = mf::hoist::quantize2(xv[u]);
        tile.q[t][c] = make_int2(l.q1, l.q2);
        tile.ra[t][c] = make_double2((double)l.r, (double)l.a);
      }
    }
    __syncthreads();
    if (s0 + kVoxTile < S) load_tile(s0 + kVoxTile);
    // the tile's samples of the small columns into the voxel's column
    // chunks (zeros past S and past the 2 + N4 columns)
    for (int e = tid; e < kVoxTile * kCW; e += kVoxThreads) {
      const int t = e / kCW, c = e % kCW, s = s0 + t;
      if (s >= n_chunk * kSK) continue;
      const bool in = t < kn && c < nc;
      ColChunk& cc = cols_out[(size_t)b * n_chunk + s / kSK];
      cc.q1[s % kSK][c] = in ? (int8_t)tile.q[t][c].x : 0;
      cc.q2[s % kSK][c] = in ? (int8_t)tile.q[t][c].y : 0;
      cc.r[s % kSK][c] = in ? (float)tile.ra[t][c].x : 0.0f;
      cc.a[s % kSK][c] = in ? (float)tile.ra[t][c].y : 0.0f;
    }
    if (gi < nv) {
      #pragma unroll 1
      for (int t = p; t < kn; t += kParts) {
        const double2 va = tile.ra[t][pr.x], vb = tile.ra[t][pr.y];
        const int2 qa = tile.q[t][pr.x];
        // a + R in float32, as the plain version adds the planes
        const float apr = mf::add((float)va.y, (float)va.x);
        mf::hoist::gram_step(g, qa.x, qa.y, (double)apr, va.x,
                             tile.q[t][pr.y], vb.x, vb.y);
      }
    }
  }
  if (gi < nv) part[p][gi] = g;
  __syncthreads();
  if (tid < nv) {
    // the parts in part order: int32 sums exact, float64 sums rounded once
    mf::hoist::Gram t = part[0][tid];
    #pragma unroll
    for (int q = 1; q < kParts; ++q) {
      const mf::hoist::Gram& u = part[q][tid];
      t.t11 += u.t11;
      t.t12 += u.t12;
      t.t22 += u.t22;
      t.c1 = t.c1 + u.c1;
      t.c2 = t.c2 + u.c2;
    }
    vg[tid] = mf::hoist::gram_value(t);
  }
  __syncthreads();
  MF_PHASE(0);

  const P2 w = vg[0], d3 = vg[1], r3 = vg[2];
  const P2 one = {1.0f, 0.0f};
  const P2 invd3 = df_div(one, d3);
  float* vx = vox + (size_t)b * NV;
  VoxScr* sc = reinterpret_cast<VoxScr*>(scr + (size_t)b * kScr);
  // the voxel's factors, one EAR column a thread; the CSF column's in
  // thread n4
  if (tid < n4) {
    const int j = tid;
    bool ok34;
    float u4f;
    const VoxJ v = vox_factors(w, d3, r3, invd3, vg[3 + 3 * j],
                               vg[4 + 3 * j], vg[5 + 3 * j], tol, ok34, u4f);
    sc->vj[j] = v;
    const float rfix = mf::hoist::tmin(
        mf::hoist::tmin(sub1(d3, r3, w), sub1(v.d4, v.r4, w)),
        sub2(d3, v.d4, v.g34, r3, v.r4, w, tol));
    // extra column x = 1 + j: C2X = r4^2 - d4 w (= the sub-support's C2)
    mf::hoist::put_ps(vx, 1, v_x0 + 6 * (1 + j), v.C2);
    vx[v_x0 + 6 * (1 + j) + 4] = val(v.d4);
    vx[v_x0 + 6 * (1 + j) + 5] = val(v.r4);
    vx[v_s0 + 4 * j] = ok34 ? 1.0f : 0.0f;
    vx[v_s0 + 4 * j + 1] = val(df_mul(r3, invd3));
    vx[v_s0 + 4 * j + 2] = u4f;
    vx[v_s0 + 4 * j + 3] = val(v.L43);
    vx[v_fix0 + j] = rfix;
  } else if (tid == n4) {
    sc->w = w;
    sc->d3 = d3;
    sc->r3 = r3;
    sc->invd3 = invd3;
    mf::hoist::put_ps(vx, 1, 0, w);
    // extra column x = 0, the CSF column
    mf::hoist::put_ps(vx, 1, v_x0, df_add(df_mul(r3, r3), neg(df_mul(d3, w))));
    vx[v_x0 + 4] = val(d3);
    vx[v_x0 + 5] = val(r3);
    for (int e = nvox; e < NV; ++e) vx[e] = 0.0f;
  }
  MF_PHASE(2);
}

// a chunk of kSK samples of the block's atoms as the tensor cores read
// them: levels, a + R and R
struct alignas(16) Chunk {
  int8_t q1[kSK][kQA], q2[kSK][kQA];
  float apr[kSK][kFA], r[kSK][kFA];
};

struct alignas(16) AtomSmem {
  union {
    Chunk c;
    // after the pass: [0] each atom's Gram with itself, [1 + c] with
    // small column c
    P2 g[1 + kMaxC][kBA];
  };
  float x[2][kSK][kBA];  // the atoms' samples of the next two chunks
  // the small columns' chunks: the one in the tensor cores and the next
  // two (read after the atoms' samples are consumed, so one buffer more)
  ColChunk col[3];
  VoxScr v;
};

// The atoms' Grams and chains: row and column blocks of kBA atoms of one
// voxel, NT tiles of 8 small columns.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT < 3 ? 3 : 2)
df4hoist_kernel(const float* __restrict__ A1h, const float* __restrict__ A2h,
                const float* __restrict__ scr,
                const ColChunk* __restrict__ cols_in,
                int8_t* __restrict__ q1a, int8_t* __restrict__ q2a,
                float* __restrict__ ra, int8_t* __restrict__ q1b,
                int8_t* __restrict__ q2b, float* __restrict__ rb,
                float* __restrict__ ab, float* __restrict__ row_pack,
                float* __restrict__ col_pack, int S, int N1p, int N2,
                int N2pb, int n4, int NR, int NC, float tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AtomSmem& sm = *reinterpret_cast<AtomSmem*>(smem_raw);
  const int tid = threadIdx.x, b = blockIdx.y;
  const int n3 = 1, nx = n3 + n4, ns = n3 * n4;
  // pack layout offsets (ops/rescan._df4_hoists)
  const int r_ldl = 12 + 12 * nx, r_res1 = r_ldl + 16 * ns;
  const int r_ok = r_res1 + 1, r_row0 = r_ok + 3 * ns;
  const int c_x0 = 16, c_l23 = c_x0 + 24 * nx, c_ldl = c_l23 + 4 * n3;
  const int c_res2 = c_ldl + 12 * ns, c_col0 = c_res2 + 1;
  const int nrow = r_row0 + ns, ncol = c_col0 + ns;
  MF_PHASE_BEGIN;

  const int row_blocks = N1p / kBA;
  const bool is_row = blockIdx.x < row_blocks;
  // the thread's atom and its half: the first half streams the atoms, the
  // second the small columns; each takes half the chain
  const int a = tid % kBA, h = tid / kBA;
  const int i = (is_row ? blockIdx.x : blockIdx.x - row_blocks) * kBA + a;
  const int width = is_row ? N1p : N2;    // atoms of the block's input
  const int padded = is_row ? N1p : N2pb; // atoms of its outputs
  const bool live = i < padded, real = i < width;
  const int nc = 2 + n4;

  // the voxel's scratch, read after the first barrier
  {
    const float* src = scr + (size_t)b * kScr;
    float* dst = reinterpret_cast<float*>(&sm.v);
    for (int e = tid; e < 8 + kScrJ * n4; e += kThreads) dst[e] = src[e];
  }

  // the pointers are formed where they are used, from the launch's
  // parameters: kept in registers through the sample loop they would
  // crowd the mma accumulators
  const size_t vS = (size_t)b * S;
  const int i0 = i - a;  // the block's first atom

  const int n_chunk = (S + kSK - 1) / kSK;
  // the atoms' samples of a chunk into sm.x[chunk % 2], zeros past S and
  // past the block's input: 16 bytes a copy where the rows are 16-byte
  // aligned (width a multiple of 4: the row blocks, the columns of an
  // R x R re-scan), else 4; and the voxel's column chunk into
  // sm.col[chunk % 3]; a commit group a chunk, complete after the
  // cp_async_wait that covers it and a barrier
  const bool wide_copy =
      width % 4 == 0 &&
      ((uintptr_t)((is_row ? A1h : A2h) + vS * width) & 15) == 0;
  auto copy_chunk = [&](int chunk) {
    const float* base = (is_row ? A1h : A2h) + vS * width;
    const int s0 = chunk * kSK;
    float (&xs)[kSK][kBA] = sm.x[chunk % 2];
    if (wide_copy) {
      for (int e = tid; e < kSK * kBA / 4; e += kThreads) {
        const int k = e / (kBA / 4), at = 4 * (e % (kBA / 4));
        const bool in = s0 + k < S && i0 + at < width;
        const float* src =
            in ? base + (size_t)(s0 + k) * width + i0 + at : base;
        mf::cp_async<16>(&xs[k][at], src, in);
      }
    } else {
      for (int e = tid; e < kSK * kBA; e += kThreads) {
        const int k = e / kBA, at = e % kBA;
        const bool in = s0 + k < S && i0 + at < width;
        const float* src =
            in ? base + (size_t)(s0 + k) * width + i0 + at : base;
        mf::cp_async<4>(&xs[k][at], src, in);
      }
    }
    // of the column chunk the 8 NT columns that the tiles read: a row's
    // levels 8 bytes a copy, its planes 16
    const ColChunk& csrc = cols_in[(size_t)b * n_chunk + chunk];
    ColChunk& cdst = sm.col[chunk % 3];
    for (int e = tid; e < kSK * 6 * NT; e += kThreads) {
      const int k = e / (6 * NT), u = e % (6 * NT);
      if (u < NT) {
        mf::cp_async<8>(&cdst.q1[k][8 * u], &csrc.q1[k][8 * u], true);
      } else if (u < 2 * NT) {
        const int c = 8 * (u - NT);
        mf::cp_async<8>(&cdst.q2[k][c], &csrc.q2[k][c], true);
      } else if (u < 4 * NT) {
        const int c = 4 * (u - 2 * NT);
        mf::cp_async<16>(&cdst.r[k][c], &csrc.r[k][c], true);
      } else {
        const int c = 4 * (u - 4 * NT);
        mf::cp_async<16>(&cdst.a[k][c], &csrc.a[k][c], true);
      }
    }
    mf::cp_async_commit();
  };

  // the warp's 16 atoms m0 .. m0 + 15 and the lane's place in the mma
  // fragments: rows g and g + 8, samples kq (+ 4) of a step
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, kq = lane % 4;
  const int m0 = 16 * warp;
  int t11[NT][4] = {}, t12[NT][4] = {}, t22[NT][4] = {};  // [n][2 hr + e]
  double c1[NT][2][2] = {}, c2[NT][2][2] = {};             // [n][hr][e]
  mf::hoist::Gram self = mf::hoist::gram_zero();

  copy_chunk(0);
  if (n_chunk > 1) copy_chunk(1);
  for (int chunk = 0; chunk < n_chunk; ++chunk) {
    const int s0 = chunk * kSK, kn = min(kSK, S - s0);
    // this chunk's copies landed (the next chunk's may be in flight); the
    // last chunk's staging is consumed
    if (chunk + 1 < n_chunk) {
      mf::cp_async_wait<1>();
    } else {
      mf::cp_async_wait<0>();
    }
    __syncthreads();
    const float (&xs)[kSK][kBA] = sm.x[chunk % 2];
    // the chunk's samples of the atoms, quantised, written out and staged:
    // thread (a, h) the samples kSK / 2 h .. of atom a; zeros past S and
    // for a padded atom
    #pragma unroll 2
    for (int u = 0; u < kSK / 2; ++u) {
      const int k = kSK / 2 * h + u;
      int q1 = 0, q2 = 0;
      float rr = 0.0f, aa = 0.0f, apr = 0.0f;
      if (k < kn && real) {
        const mf::hoist::Level l = mf::hoist::quantize2(xs[k][a]);
        q1 = l.q1;
        q2 = l.q2;
        rr = l.r;
        aa = l.a;
        apr = mf::add(l.a, l.r);
      }
      if (k < kn && live) {
        const size_t o = (vS + s0 + k) * padded + i;
        (is_row ? q1a : q1b)[o] = (int8_t)q1;
        (is_row ? q2a : q2b)[o] = (int8_t)q2;
        (is_row ? ra : rb)[o] = rr;
        if (!is_row) ab[o] = aa;
      }
      sm.c.q1[k][a] = (int8_t)q1;
      sm.c.q2[k][a] = (int8_t)q2;
      sm.c.apr[k][a] = apr;
      sm.c.r[k][a] = rr;
    }
    __syncthreads();  // staged; this chunk's sm.x consumed
    if (chunk + 2 < n_chunk) copy_chunk(chunk + 2);
    MF_PHASE(1);

    // the atom's Gram with itself, in sample order, from the staged levels
    // and planes (a = s1 q1 + s2 q2, as quantize2 forms it)
    if (h == 0) {
      #pragma unroll 1
      for (int k = 0; k < kn; ++k) {
        const int q1 = sm.c.q1[k][a], q2 = sm.c.q2[k][a];
        const float aa =
            mf::add(mf::mul(__int2float_rn(q1), mf::hoist::kS1),
                    mf::mul(__int2float_rn(q2), mf::hoist::kS2));
        const double dr = (double)sm.c.r[k][a];
        mf::hoist::gram_step(self, q1, q2, (double)sm.c.apr[k][a], dr,
                             make_int2(q1, q2), dr, (double)aa);
      }
    }

    // level products: int8 m16n8k32, one depth the chunk; a register holds
    // 4 samples of one atom or column, the mma's k index 4 kq + u taking
    // sample kq + 4 u of its half (the int32 sums do not depend on the
    // order), byte (m0 + g) % 4 = g % 4 of its word
    const ColChunk& cc = sm.col[chunk % 3];
    {
      const uint32_t sel = 0x40u + 0x11u * (uint32_t)(g & 3);
      const int wa = (m0 + g) & ~3, wb = (m0 + g + 8) & ~3;
      int qa1[4], qa2[4];
      qa1[0] = mf::pack1x4(&sm.c.q1[kq][wa], 4 * kQA, sel);
      qa1[1] = mf::pack1x4(&sm.c.q1[kq][wb], 4 * kQA, sel);
      qa1[2] = mf::pack1x4(&sm.c.q1[kq + 16][wa], 4 * kQA, sel);
      qa1[3] = mf::pack1x4(&sm.c.q1[kq + 16][wb], 4 * kQA, sel);
      qa2[0] = mf::pack1x4(&sm.c.q2[kq][wa], 4 * kQA, sel);
      qa2[1] = mf::pack1x4(&sm.c.q2[kq][wb], 4 * kQA, sel);
      qa2[2] = mf::pack1x4(&sm.c.q2[kq + 16][wa], 4 * kQA, sel);
      qa2[3] = mf::pack1x4(&sm.c.q2[kq + 16][wb], 4 * kQA, sel);
      #pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int wc = (8 * n + g) & ~3;
        const int qb1[2] = {mf::pack1x4(&cc.q1[kq][wc], 4 * kQC, sel),
                            mf::pack1x4(&cc.q1[kq + 16][wc], 4 * kQC, sel)};
        const int qb2[2] = {mf::pack1x4(&cc.q2[kq][wc], 4 * kQC, sel),
                            mf::pack1x4(&cc.q2[kq + 16][wc], 4 * kQC, sel)};
        mf::mma_s8(t11[n], qa1, qb1);
        mf::mma_s8(t12[n], qa1, qb2);
        mf::mma_s8(t12[n], qa2, qb1);
        mf::mma_s8(t22[n], qa2, qb2);
      }
    }
    // cross products: float64 m16n8k8, 8 samples a step; float32 values
    // widened where the fragment is loaded (exact); the planes hold zeros
    // past S
    #pragma unroll
    for (int k8 = 0; k8 < kSK / 8; ++k8) {
      const int sl = 8 * k8 + kq;
      {
        const double x0 = sm.c.apr[sl][m0 + g], x1 = sm.c.apr[sl][m0 + g + 8];
        const double x2 = sm.c.apr[sl + 4][m0 + g];
        const double x3 = sm.c.apr[sl + 4][m0 + g + 8];
        #pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = 8 * n + g;
          mf::mma_f64(c1[n][0], c1[n][1], x0, x1, x2, x3,
                      (double)cc.r[sl][col], (double)cc.r[sl + 4][col]);
        }
      }
      {
        const double x0 = sm.c.r[sl][m0 + g], x1 = sm.c.r[sl][m0 + g + 8];
        const double x2 = sm.c.r[sl + 4][m0 + g];
        const double x3 = sm.c.r[sl + 4][m0 + g + 8];
        #pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = 8 * n + g;
          mf::mma_f64(c2[n][0], c2[n][1], x0, x1, x2, x3,
                      (double)cc.a[sl][col], (double)cc.a[sl + 4][col]);
        }
      }
    }
    MF_PHASE(4);
  }
  __syncthreads();  // the chunk's memory takes the Grams

  // the lane's entries: atoms m0 + g + 8 hr, columns 8 n + 2 kq + e
  #pragma unroll
  for (int n = 0; n < NT; ++n) {
    #pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * kq + e;
        if (col < nc) {
          const mf::hoist::Gram gg = {t11[n][2 * hr + e], t12[n][2 * hr + e],
                                      t22[n][2 * hr + e], c1[n][hr][e],
                                      c2[n][hr][e]};
          sm.g[1 + col][m0 + g + 8 * hr] = mf::hoist::gram_value(gg);
        }
      }
    }
  }
  if (h == 0) sm.g[0][a] = mf::hoist::gram_value(self);
  __syncthreads();
  MF_PHASE(4);

  if (live) {
    const P2 w = sm.v.w, d3 = sm.v.d3, r3 = sm.v.r3, invd3 = sm.v.invd3;
    const P2 one = {1.0f, 0.0f};
    if (is_row) {
      float* rp = row_pack + (size_t)b * NR * N1p + i;
      const size_t st = (size_t)N1p;
      const P2 d1 = sm.g[0][a], p = sm.g[1][a], b3 = sm.g[2][a];
      if (h == 0) {
        mf::hoist::put_ps(rp, st, 0, d1);
        mf::hoist::put_ps(rp, st, 4, p);
        mf::hoist::put_ps(rp, st, 8, df_mul(p, p));
      }
      #pragma unroll 1
      for (int x = h; x < nx; x += 2) {
        const P2 bX = sm.g[2 + x][a];
        mf::hoist::put_ps(rp, st, 12 + 12 * x, bX);
        mf::hoist::put_ps(rp, st, 16 + 12 * x, df_mul(bX, bX));
        mf::hoist::put_ps(rp, st, 20 + 12 * x, df_mul(bX, p));
      }
      const P2 L13 = df_mul(b3, invd3);
      if (h == 0) rp[(size_t)r_res1 * st] = sub1(d1, p, w);
      const float s13 = sub2(d1, d3, b3, p, r3, w, tol);
      #pragma unroll 1
      for (int j = h; j < n4; j += 2) {
        const VoxJ& v = sm.v.vj[j];
        const P2 b4 = sm.g[3 + j][a];
        const P2 e4r = df_add(b4, neg(df_mul(v.L43, b3)));
        const P2 L14 = df_mul(e4r, v.invD4h);
        const P2 D1h =
            df_add(df_add(d1, neg(df_mul(b3, L13))), neg(df_mul(e4r, L14)));
        const bool rowok = val(D1h) > mf::mul(tol, val(d1));
        const P2 invD1h = df_div(one, rowok ? D1h : one);
        const P2 pi1 = df_add(df_add(p, neg(df_mul(L13, r3))),
                              neg(df_mul(L14, v.t4)));
        const P2 kap1 = df_mul(pi1, invD1h);
        const P2 rho1 = df_add(v.rho34, neg(df_mul(pi1, kap1)));
        mf::hoist::put_ps(rp, st, r_ldl + 16 * j, e4r);
        mf::hoist::put_ps(rp, st, r_ldl + 16 * j + 4, kap1);
        mf::hoist::put_ps(rp, st, r_ldl + 16 * j + 8, invD1h);
        mf::hoist::put_ps(rp, st, r_ldl + 16 * j + 12, rho1);
        rp[(size_t)(r_ok + 3 * j) * st] = rowok ? 1.0f : 0.0f;
        rp[(size_t)(r_ok + 3 * j + 1) * st] = val(L13);
        rp[(size_t)(r_ok + 3 * j + 2) * st] = val(L14);
        rp[(size_t)(r_row0 + j) * st] = mf::hoist::tmin(
            mf::hoist::tmin(s13, sub2(d1, v.d4, b4, p, v.r4, w, tol)),
            sub3(d1, b3, b4, p, d3, r3, v, tol));
      }
      for (int e = nrow + h; e < NR; e += 2) rp[(size_t)e * st] = 0.0f;
    } else if (!real) {  // a padded column: zeros, as the plain version pads
      float* cp = col_pack + (size_t)b * NC * N2pb + i;
      for (int e = h; e < NC; e += 2) cp[(size_t)e * N2pb] = 0.0f;
    } else {
      float* cp = col_pack + (size_t)b * NC * N2pb + i;
      const size_t st = (size_t)N2pb;
      const P2 d2 = sm.g[0][a], q = sm.g[1][a], c3 = sm.g[2][a];
      const P2 q2sq = df_mul(q, q);
      if (h == 0) {
        mf::hoist::put_ps(cp, st, 0, d2);
        mf::hoist::put_ps(cp, st, 4, q);
        mf::hoist::put_ps(cp, st, 8, q2sq);
        mf::hoist::put_ps(cp, st, 12, df_mul(d2, w));
      }
      #pragma unroll 1
      for (int x = h; x < nx; x += 2) {
        const P2 dX = x == 0 ? d3 : sm.v.vj[x - 1].d4;
        const P2 rX = x == 0 ? r3 : sm.v.vj[x - 1].r4;
        const P2 cX = sm.g[2 + x][a];
        const int e = c_x0 + 24 * x;
        // U2X
        mf::hoist::put_ps(
            cp, st, e,
            scale(df_add(df_mul(d2, rX), neg(df_mul(cX, q))), 2.0f));
        // U3X
        mf::hoist::put_ps(
            cp, st, e + 4,
            df_add(df_add(df_add(df_mul(d2, df_add(df_mul(dX, w),
                                                   neg(df_mul(rX, rX)))),
                                 neg(df_mul(dX, q2sq))),
                          scale(df_mul(df_mul(cX, q), rX), 2.0f)),
                   neg(df_mul(df_mul(cX, cX), w))));
        // U4X, V1X, V2X, cX
        mf::hoist::put_ps(cp, st, e + 8,
                          df_add(df_mul(cX, cX), neg(df_mul(d2, dX))));
        mf::hoist::put_ps(
            cp, st, e + 12,
            scale(df_add(df_mul(cX, w), neg(df_mul(q, rX))), 2.0f));
        mf::hoist::put_ps(
            cp, st, e + 16,
            scale(df_add(df_mul(dX, q), neg(df_mul(cX, rX))), 2.0f));
        mf::hoist::put_ps(cp, st, e + 20, cX);
      }
      const P2 L23 = df_mul(c3, invd3);
      if (h == 0) {
        mf::hoist::put_ps(cp, st, c_l23, L23);
        cp[(size_t)c_res2 * st] = sub1(d2, q, w);
      }
      const float s23 = sub2(d2, d3, c3, q, r3, w, tol);
      #pragma unroll 1
      for (int j = h; j < n4; j += 2) {
        const VoxJ& v = sm.v.vj[j];
        const P2 c4 = sm.g[3 + j][a];
        const P2 e4c = df_add(c4, neg(df_mul(v.L43, c3)));
        const P2 L24 = df_mul(e4c, v.invD4h);
        const P2 d2r =
            df_add(df_add(d2, neg(df_mul(c3, L23))), neg(df_mul(e4c, L24)));
        const P2 q2r =
            df_add(df_add(q, neg(df_mul(L23, r3))), neg(df_mul(L24, v.t4)));
        mf::hoist::put_ps(cp, st, c_ldl + 12 * j, L24);
        mf::hoist::put_ps(cp, st, c_ldl + 12 * j + 4, d2r);
        mf::hoist::put_ps(cp, st, c_ldl + 12 * j + 8, q2r);
        cp[(size_t)(c_col0 + j) * st] = mf::hoist::tmin(
            mf::hoist::tmin(s23, sub2(d2, v.d4, c4, q, v.r4, w, tol)),
            sub3(d2, c3, c4, q, d3, r3, v, tol));
      }
      for (int e = ncol + h; e < NC; e += 2) cp[(size_t)e * st] = 0.0f;
    }
  }
  MF_PHASE(3);
}

template <int NT>
int launch(const float* A1h, const float* A2h, const float* scr,
           const ColChunk* cols, int8_t* q1a,
           int8_t* q2a, float* ra, int8_t* q1b, int8_t* q2b, float* rb,
           float* ab, float* row_pack, float* col_pack, int B, int S, int N1p,
           int N2, int N2pb, int n4, int NR, int NC, float tol,
           cudaStream_t stream) {
  const int smem = (int)sizeof(AtomSmem);
  cudaError_t err = cudaFuncSetAttribute(
      df4hoist_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N1p / kBA + (N2pb + kBA - 1) / kBA, B);
  df4hoist_kernel<NT><<<grid, kThreads, smem, stream>>>(
      A1h, A2h, scr, cols, q1a, q2a, ra, q1b, q2b, rb, ab, row_pack, col_pack,
      S, N1p, N2, N2pb, n4, NR, NC, tol);
  return (int)cudaGetLastError();
}

}  // namespace

MF_PHASE_API(mf_df4hoist_phases)

extern "C" int mf_df4hoist(const float* A1h, const float* A2h,
                           const float* A3h, const float* A4h,
                           const float* yh, int8_t* q1a, int8_t* q2a,
                           float* ra, int8_t* q1b, int8_t* q2b, float* rb,
                           float* ab, float* row_pack, float* col_pack,
                           float* vox, float* scr, float* cols, int B,
                           int S, int N1p,
                           int N2, int N2pb, int n4, int NR, int NC, int NV,
                           float tol, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  // the pack sizes (ops/rescan.df4_pack_sizes at n3 = 1), padded to 8
  const int n3 = 1, nx = n3 + n4, ns = n3 * n4;
  const int nrow = 12 + 12 * nx + 20 * ns + 1;
  const int ncol = 16 + 24 * nx + 4 * n3 + 13 * ns + 1;
  const int nvox = 4 + 6 * nx + 5 * ns;
  const auto pad8 = [](int n) { return (n + 7) / 8 * 8; };
  if (n4 < 1 || n4 > kMaxE || S < 1 || N1p % kAtoms || N2 < 1 ||
      N2pb < N2 || NR != pad8(nrow) || NC != pad8(ncol) || NV != pad8(nvox)) {
    return (int)cudaErrorInvalidValue;
  }
  // scr (B, kScr): the voxel's factors; cols (B, n_chunk ColChunks): its
  // small columns, quantised
  ColChunk* cc = reinterpret_cast<ColChunk*>(cols);
  df4vox_kernel<<<B, kVoxThreads, 0, stream>>>(yh, A3h, A4h, vox, scr, cc, S,
                                               n4, NV, tol);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the tiles of 8 small columns (2 + N4 of them) the mma covers
  decltype(&launch<1>) run = 2 + n4 <= 8    ? &launch<1>
                             : 2 + n4 <= 16 ? &launch<2>
                                            : &launch<3>;
  return run(A1h, A2h, scr, cc, q1a, q2a, ra, q1b, q2b, rb, ab, row_pack,
             col_pack, B, S, N1p, N2, N2pb, n4, NR, NC, tol, stream);
}
