// Kernel 11: the hoists of the 4-block (EAR) interval row pass.
//
// Counterpart of the JAX package's rowmin_4(pallas=True) between its prep
// and its pallas_call (microstructure_fingerprinting_tpu/ops/f32scan.py:
// 823-1033: the small _gram3_hi Grams, the block-1-free floor, the column
// lows, the row-level supports, the chain prefixes of _rowmin4_body and the
// packs; XLA fuses them into the jit of the kernel) and of its plain version
// here, ops/f32scan.row4_hoist_twin. From kernel 1's Grams gramA
// (B, 16, N1p) and gramB (B, 16, N2pb) (row 0 <x, x>, row 1 <x, y>, row 2
// <x, a3>, row 3 + j <x, a4_j>) and the normalised small columns yh (B, S),
// A3h (B, S, 1) and A4h (B, S, N4) it writes kernel 4's operands in the
// layout that csrc/rowmin4.cu reads: row_pack (B, NR, N1p) with the
// row-level [lo, up] at nr, nr + 1, col_pack (B, NC, N2pb) and vox
// (B, NV), each padded with zero entries to a multiple of 8 (_pack8); and
// the per-column lows lo_c_sup (B, N2pb) and the floor upf (B,). The small
// columns are quantised here (dfscan.quantize3, as kernel 13, csrc/
// rhsprep.cu, quantises them for kernel 1): the same integers, and no
// float32 planes to pass. The small Grams, the support intervals and the
// fold of upf are csrc/hoist.cuh's, shared with kernel 12.
//
// What bounds it on an H100: bytes. Per atom it reads 3 + N4 Gram entries
// and writes 9 + 10 N4 (row) or 7 + 8 N4 (column) entries; the chain is
// ~14 float32 operations an extra column and ~120 a pair with its two
// sub-supports (chip_smoke.ROW4_CHAIN_OPS). The plain
// version runs each operation as one torch kernel on (B, N, 1, N4)
// temporaries: ~8,000 kernels a call at N4 = 10. Its first design
// had every block of a voxel, 15 a voxel, sum the voxel's small Grams over
// the samples one Gram a thread: 92% of its cycles (examples/
// kernel_phases.py). The design, for this card:
//   * a first launch, a block a voxel (row4vox_kernel), quantises the
//     voxel's 2 + N4 small columns once and sums the 3 + 3 N4 small Grams
//     (w, d3, r3, then d4, r4, g34 of each EAR column) with the samples
//     split into kParts parts, a thread a Gram and part (hoist::vox_grams,
//     shared with kernel 12): part p takes the samples s = p mod kParts in
//     order, the int32 level sums are exact in any order and the float64
//     corrections of the parts are added in part order and rounded once.
//     Then the voxel's factors (L43, D4h, stab34, invD4h, t4, rho34, u3,
//     u4o, u4), one EAR column a thread: vox, and the scratch (B, kScr)
//     that the atom launch reads;
//   * the atom launch (row4hoist_kernel): blocks 0 .. N1p/128 - 1 own 128
//     rows of one voxel, the next ones 128 columns; a thread one atom.
//     A block copies its voxel's scratch to shared memory, then a thread
//     runs its atom's chain one EAR column at a time, each pack entry
//     written straight to device memory (coalesced: the atom axis is the
//     pack's contiguous one), nothing of a sweep kept;
//   * upf is a minimum over every column of a voxel, across column blocks.
//     It takes a third launch of the same call: each column block writes
//     the minimum of its columns' upper bounds (the first one also the
//     voxel's own supports) to a scratch row of partials, and a thread a
//     voxel folds them. A minimum is exact in any order, and torch.minimum's
//     NaN (canonical on the card) wins as it does there.
// Plain float32 as the plain version computes it, operation for operation
// (--fmad=false; 1 / x the IEEE quotient, as torch's reciprocal), the
// branches of _sanit, _interval, _sub1, _sub2 and _sub3 as they are, and
// torch.minimum / amin NaN-first (hoist::tmin): bit for bit, but for the
// order of the float64 sums of the small Grams (testing.fdot_parts_order):
// equal except at such near-ties (testing.kernel_agreement).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hoist.cuh"
#include "phases.cuh"

namespace {

using mf::add;
using mf::dv;
using mf::kInf;
using mf::mul;
using mf::sub;
using mf::hoist::Consts;
using mf::hoist::fold;
using mf::hoist::Interval;
using mf::hoist::interval;
using mf::hoist::kAtoms;
using mf::hoist::sub1;
using mf::hoist::sub2;
using mf::hoist::tmin;

// the most EAR columns a call takes: kernel 1's Grams hold 15 rhs columns
// (ops/prep.MAX_RHS), the signal and the CSF column among them
constexpr int kMaxE = 13;
constexpr int kMaxC = 2 + kMaxE, kMaxV = 3 + 3 * kMaxE;
// rows of kernel 1's Grams (ops/prep: gram (B, 16, Np))
constexpr int kGramRows = 16;
// the voxel launch's threads a block (its small Grams: hoist::vox_grams)
constexpr int kVoxThreads = 256;

// torch.maximum on the card: a NaN operand wins, else fmaxf
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// f32scan._sub3 with det_tol = _TOL: support {a, b, c}
__device__ Interval sub3(float dA, float dB, float dC, float gAB, float gAC,
                         float gBC, float pA, float pB, float pC, float w,
                         const Consts& k) {
  const float invA = dv(1.0f, dA);
  const float pivB = sub(dB, mul(mul(gAB, gAB), invA));
  const bool stabB = pivB > mul(k.eps, dB);
  const float invB = stabB ? dv(1.0f, pivB) : 0.0f;
  const float gBC_r = sub(gBC, mul(mul(gAB, gAC), invA));
  const float tB = sub(pB, mul(mul(gAB, pA), invA));
  const float pivC =
      sub(sub(dC, mul(mul(gAC, gAC), invA)), mul(mul(gBC_r, gBC_r), invB));
  const bool stabC = pivC > mul(k.eps, dC);
  const float invC = stabC ? dv(1.0f, pivC) : 0.0f;
  const float tC =
      sub(sub(pC, mul(mul(gAC, pA), invA)), mul(mul(gBC_r, tB), invB));
  const float wc = mul(tC, invC);
  const float wb = mul(sub(tB, mul(gBC_r, wc)), invB);
  const float wa = mul(sub(sub(pA, mul(gAB, wb)), mul(gAC, wc)), invA);
  const bool stab = stabB && stabC;
  const bool feas = stab && mul(pivB, pivC) > mul(mul(k.tol, dB), dC) &&
                    wa >= 0.0f && wb >= 0.0f && wc >= 0.0f;
  const float res = sub(sub(sub(w, mul(mul(pA, pA), invA)),
                            mul(mul(tB, tB), invB)),
                        mul(tC, wc));
  return interval(feas, stab, res,
                  add(add(fabsf(wa), fabsf(wb)), fabsf(wc)), true, k);
}

// the voxel's values for EAR column j that the atoms read
// (rowmin_4_operands: eliminate 3 then 4)
struct VoxJ {
  float d4, r4, g34, invd4v, L43, invD4h, t4, rho34;
};

// the voxel scratch (B, kScr) the voxel launch writes and the atom launch
// reads: the CSF column's values, then each EAR column's
constexpr int kScrJ = 8, kScr = 4 + kScrJ * kMaxE;
struct VoxScr {
  float w, d3, r3, invd3v;
  VoxJ vj[kMaxE];
};
static_assert(sizeof(VoxJ) == kScrJ * sizeof(float) &&
                  sizeof(VoxScr) == kScr * sizeof(float),
              "the scratch layout");

// x_chain: the {1, 2, X} pieces of a row with extra column X
struct XRow {
  float L1x, invd1px, kap_ppx, rho1x;
  bool stabx;
};

__device__ __forceinline__ XRow x_chain(float d1, float p, float w, float bX,
                                        float rX, float invdX,
                                        const Consts& k) {
  XRow x;
  x.L1x = mul(bX, invdX);
  const float d1px = sub(d1, mul(bX, x.L1x));
  x.stabx = d1px > mul(k.eps, d1);
  x.invd1px = x.stabx ? dv(1.0f, d1px) : 0.0f;
  const float p1x = sub(p, mul(x.L1x, rX));
  x.kap_ppx = mul(p1x, x.invd1px);
  x.rho1x = sub(sub(w, mul(mul(rX, rX), invdX)), mul(p1x, x.kap_ppx));
  return x;
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

// the small Grams (qa, qb): 0 w = (y, y), 1 d3 = (a3, a3), 2 r3 = (a3, y),
// then for EAR column j: d4 = (a4j, a4j), r4 = (a4j, y), g34 = (a3, a4j)
struct Pair {
  __device__ int2 operator()(int t) const {
    if (t < 3) return t == 0 ? make_int2(0, 0) : make_int2(1, t == 1 ? 1 : 0);
    const int j = (t - 3) / 3, k = (t - 3) % 3;
    return k == 0 ? make_int2(2 + j, 2 + j)
                  : (k == 1 ? make_int2(2 + j, 0) : make_int2(1, 2 + j));
  }
};

// The voxel's prologue, a block a voxel: the small Grams, the factors, vox
// and the scratch.
__global__ void __launch_bounds__(kVoxThreads)
row4vox_kernel(const float* __restrict__ yh, const float* __restrict__ A3h,
               const float* __restrict__ A4h, float* __restrict__ vox,
               float* __restrict__ scr, int S, int n4, int NV, Consts k) {
  __shared__ mf::hoist::VoxGrams<kMaxC, kMaxV> sm;
  __shared__ float vg[kMaxV];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int n3 = 1, nx = n3 + n4, ns = n3 * n4;
  // voxel entries (ops/f32scan.row4_hoist_twin; csrc/rowmin4.cu)
  const int v0 = 1 + nx, nvox = 1 + nx + 3 * ns;
  MF_PHASE_BEGIN;

  const size_t vS = (size_t)b * S;
  mf::hoist::vox_grams<kMaxC, kMaxV, kVoxThreads>(
      sm, vg, Cols{yh + vS, A3h + vS, A4h + vS * n4, n4}, 2 + n4, Pair{},
      3 + 3 * n4, S);
  MF_PHASE(0);

  // the voxel's factors: the CSF column's in thread n4, EAR column j's in
  // thread j
  const float w = vg[0], d3 = vg[1], r3 = vg[2];
  const float invd3v = dv(1.0f, tmax(d3, k.eps));
  float* vx = vox + (size_t)b * NV;
  VoxScr* sc = reinterpret_cast<VoxScr*>(scr + (size_t)b * kScr);
  if (tid < n4) {
    VoxJ v;
    v.d4 = vg[3 + 3 * tid];
    v.r4 = vg[4 + 3 * tid];
    v.g34 = vg[5 + 3 * tid];
    v.invd4v = dv(1.0f, tmax(v.d4, k.eps));
    v.L43 = mul(v.g34, invd3v);
    const float D4h = sub(v.d4, mul(v.g34, v.L43));
    const bool stab34 = D4h > mul(k.tol, v.d4);
    v.invD4h = stab34 ? dv(1.0f, D4h) : 0.0f;
    v.t4 = sub(v.r4, mul(v.L43, r3));
    v.rho34 = sub(sub(w, mul(mul(r3, r3), invd3v)),
                  mul(mul(v.t4, v.t4), v.invD4h));
    sc->vj[tid] = v;
    vx[1 + n3 + tid] = mul(v.r4, v.invd4v);   // u4o
    vx[v0 + 3 * tid] = mul(v.t4, v.invD4h);   // u4
    vx[v0 + 3 * tid + 1] = v.L43;
    vx[v0 + 3 * tid + 2] = stab34 ? 1.0f : 0.0f;
  } else if (tid == n4) {
    sc->w = w;
    sc->d3 = d3;
    sc->r3 = r3;
    sc->invd3v = invd3v;
    vx[0] = w;
    vx[1] = mul(r3, invd3v);
    for (int e = nvox; e < NV; ++e) vx[e] = 0.0f;
  }
  MF_PHASE(2);
}

// The atoms' chains: row and column blocks of 128 atoms of one voxel.
__global__ void __launch_bounds__(kAtoms)
row4hoist_kernel(const float* __restrict__ gramA,
                 const float* __restrict__ gramB,
                 const float* __restrict__ scr, float* __restrict__ row_pack,
                 float* __restrict__ col_pack, float* __restrict__ lo_c_sup,
                 float* __restrict__ part, int N1p, int N2pb, int n4, int NR,
                 int NC, Consts k) {
  __shared__ VoxScr sv;
  __shared__ float red[kAtoms];
  const int tid = threadIdx.x, b = blockIdx.y;
  const int n3 = 1, nx = n3 + n4, ns = n3 * n4;
  // pack layout offsets (ops/f32scan.row4_hoist_twin; csrc/rowmin4.cu)
  const int r0 = 2 + 5 * nx, c0 = 2 + 4 * nx;
  const int nrow = 2 + 5 * nx + 5 * ns, ncol = 2 + 4 * nx + 4 * ns;
  MF_PHASE_BEGIN;

  const int row_blocks = N1p / kAtoms;
  const bool is_row = blockIdx.x < row_blocks;
  const int cb = blockIdx.x - row_blocks;  // column block
  const int i = (is_row ? blockIdx.x : cb) * kAtoms + tid;

  // the voxel's scratch
  const float* sb = scr + (size_t)b * kScr;
  for (int e = tid; e < 4 + kScrJ * n4; e += kAtoms) {
    reinterpret_cast<float*>(&sv)[e] = sb[e];
  }
  __syncthreads();
  const float w = sv.w, d3 = sv.d3, r3 = sv.r3, invd3v = sv.invd3v;
  MF_PHASE(1);

  if (is_row) {
    const float* gA = gramA + (size_t)b * kGramRows * N1p + i;
    float* rp = row_pack + (size_t)b * NR * N1p + i;
    const size_t st = (size_t)N1p;
    const float d1 = gA[0], p = gA[st], b3 = gA[2 * st];
    rp[0] = dv(1.0f, d1);
    rp[st] = p;
    const XRow x3 = x_chain(d1, p, w, b3, r3, invd3v, k);
    const float row3[5] = {x3.L1x, x3.invd1px, x3.kap_ppx, x3.rho1x,
                           x3.stabx ? 1.0f : 0.0f};
    #pragma unroll
    for (int e = 0; e < 5; ++e) rp[(size_t)(2 + e) * st] = row3[e];
    // the row-level supports {1}, {1,3}, then {1,4} and {1,3,4} a column
    Interval acc = sub1(d1, p, w, k);
    fold(acc, sub2(d1, d3, b3, p, r3, w, k.tol, k));
    #pragma unroll 1
    for (int j = 0; j < n4; ++j) {
      const VoxJ& v = sv.vj[j];
      const float b4 = gA[(size_t)(3 + j) * st];
      const XRow x4 = x_chain(d1, p, w, b4, v.r4, v.invd4v, k);
      const float row4[5] = {x4.L1x, x4.invd1px, x4.kap_ppx, x4.rho1x,
                             x4.stabx ? 1.0f : 0.0f};
      // the pair (3, j): order 3 -> 4 -> 1 -> 2
      const float e4r = sub(b4, mul(v.L43, b3));
      const float L14 = mul(e4r, v.invD4h);
      const float D1h = sub(sub(d1, mul(b3, x3.L1x)), mul(e4r, L14));
      const bool stabr = x3.stabx && D1h > mul(k.tol, d1);
      const float invD1h = stabr ? dv(1.0f, D1h) : 0.0f;
      const float pi1 = sub(sub(p, mul(x3.L1x, r3)), mul(L14, v.t4));
      const float kap1 = mul(pi1, invD1h);
      const float pairs[5] = {L14, invD1h, kap1, sub(v.rho34, mul(pi1, kap1)),
                              stabr ? 1.0f : 0.0f};
      #pragma unroll
      for (int e = 0; e < 5; ++e) {
        rp[(size_t)(2 + 5 * (n3 + j) + e) * st] = row4[e];
        rp[(size_t)(r0 + 5 * j + e) * st] = pairs[e];
      }
      fold(acc, sub2(d1, v.d4, b4, p, v.r4, w, k.tol, k));
      fold(acc, sub3(d1, d3, v.d4, b3, b4, v.g34, p, r3, v.r4, w, k));
    }
    rp[(size_t)nrow * st] = acc.lo;
    rp[(size_t)(nrow + 1) * st] = acc.up;
    for (int e = nrow + 2; e < NR; ++e) rp[(size_t)e * st] = 0.0f;
    MF_PHASE(3);
    return;
  }

  // a column: its chain pieces, its low over the supports {2}, {2,3},
  // {2,4}, {2,3,4} and its part of the floor
  const float* gB = gramB + (size_t)b * kGramRows * N2pb + i;
  float* cp = col_pack + (size_t)b * NC * N2pb + i;
  const size_t st = (size_t)N2pb;
  const float d2 = gB[0], q = gB[st], c3 = gB[2 * st];
  const float kap_c3 = mul(c3, invd3v);
  const float col3[4] = {kap_c3, sub(d2, mul(c3, kap_c3)),
                         sub(q, mul(kap_c3, r3)), c3};
  cp[0] = d2;
  cp[st] = q;
  #pragma unroll
  for (int e = 0; e < 4; ++e) cp[(size_t)(2 + e) * st] = col3[e];
  Interval acc = sub1(d2, q, w, k);
  fold(acc, sub2(d2, d3, c3, q, r3, w, k.tol, k));
  #pragma unroll 1
  for (int j = 0; j < n4; ++j) {
    const VoxJ& v = sv.vj[j];
    const float c4 = gB[(size_t)(3 + j) * st];
    const float kap_c4 = mul(c4, v.invd4v);
    const float col4[4] = {kap_c4, sub(d2, mul(c4, kap_c4)),
                           sub(q, mul(kap_c4, v.r4)), c4};
    const float e4cc = sub(c4, mul(v.L43, c3));
    const float L24 = mul(e4cc, v.invD4h);
    const float pairs[4] = {
        e4cc, L24, sub(sub(d2, mul(c3, kap_c3)), mul(e4cc, L24)),
        sub(sub(q, mul(kap_c3, r3)), mul(L24, v.t4))};
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      cp[(size_t)(2 + 4 * (n3 + j) + e) * st] = col4[e];
      cp[(size_t)(c0 + 4 * j + e) * st] = pairs[e];
    }
    fold(acc, sub2(d2, v.d4, c4, q, v.r4, w, k.tol, k));
    fold(acc, sub3(d2, d3, v.d4, c3, c4, v.g34, q, r3, v.r4, w, k));
  }
  for (int e = ncol; e < NC; ++e) cp[(size_t)e * st] = 0.0f;
  lo_c_sup[(size_t)b * N2pb + i] = acc.lo;
  MF_PHASE(3);

  // the block's part of the floor upf; the first column block adds the
  // voxel's block-1-free supports {}, {3}, {4}, {3,4}
  red[tid] = acc.up;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int t = 1; t < kAtoms; ++t) m = tmin(m, red[t]);
    if (cb == 0) {
      m = tmin(m, add(w, k.kerr));
      m = tmin(m, sub1(d3, r3, w, k).up);
      for (int j = 0; j < n4; ++j) {
        const VoxJ& v = sv.vj[j];
        m = tmin(m, sub1(v.d4, v.r4, w, k).up);
        m = tmin(m, sub2(d3, v.d4, v.g34, r3, v.r4, w, k.tol, k).up);
      }
    }
    part[(size_t)b * (gridDim.x - row_blocks) + cb] = m;
  }
}

}  // namespace

MF_PHASE_API(mf_row4hoist_phases)

extern "C" int mf_row4hoist(const float* gramA, const float* gramB,
                            const float* yh, const float* A3h,
                            const float* A4h, float* row_pack,
                            float* col_pack, float* vox, float* lo_c_sup,
                            float* scr, float* part, float* upf, int B, int S,
                            int N1p, int N2pb, int n4, int NR, int NC, int NV,
                            int nr, float eps, float tol, float kerr,
                            cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  // the pack sizes (f32scan.row4_pack_rows at n3 = 1), padded to 8
  const int n3 = 1, nx = n3 + n4, ns = n3 * n4;
  const int nrow = 2 + 5 * nx + 5 * ns, ncol = 2 + 4 * nx + 4 * ns;
  const int nvox = 1 + nx + 3 * ns;
  const auto pad8 = [](int n) { return (n + 7) / 8 * 8; };
  if (n4 < 1 || n4 > kMaxE || S < 1 || N1p % kAtoms || N2pb % kAtoms ||
      nr != nrow || NR != pad8(nrow + 2) || NC != pad8(ncol) ||
      NV != pad8(nvox)) {
    return (int)cudaErrorInvalidValue;
  }
  const Consts k{eps, tol, kerr};
  // scr (B, kScr): the voxel's factors; part (B, N2pb / kAtoms): a partial
  // minimum a column block
  row4vox_kernel<<<B, kVoxThreads, 0, stream>>>(yh, A3h, A4h, vox, scr, S,
                                                n4, NV, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = N1p / kAtoms, col_blocks = N2pb / kAtoms;
  dim3 grid(row_blocks + col_blocks, B);
  row4hoist_kernel<<<grid, kAtoms, 0, stream>>>(gramA, gramB, scr, row_pack,
                                                col_pack, lo_c_sup, part, N1p,
                                                N2pb, n4, NR, NC, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mf::hoist::fold_min<float><<<(B + 127) / 128, 128, 0, stream>>>(
      part, upf, B, col_blocks);
  return (int)cudaGetLastError();
}
