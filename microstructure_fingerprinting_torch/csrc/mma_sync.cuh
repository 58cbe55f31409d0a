// Warp-level tensor-core products (mma.sync) and the operand packing that
// the two Gram tiles share: gram_hi.cuh (row passes, kernels 2 and 4) and
// gram_df.cuh (re-scans, kernels 3 and 5).
#pragma once

#include <stdint.h>

namespace mf {

// D (16 x 8) += A (16 x 8, row-major) * B (8 x 8, column-major) in float64.
// Lane l = (g, kq) = (l / 4, l % 4) holds A[g][kq], A[g + 8][kq],
// A[g][kq + 4], A[g + 8][kq + 4]; B[kq][g], B[kq + 4][g]; and D rows g (d0)
// and g + 8 (d1) at columns 2 kq, 2 kq + 1.
__device__ __forceinline__ void mma_f64(double (&d0)[2], double (&d1)[2],
                                        double a0, double a1, double a2,
                                        double a3, double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d0[0]), "+d"(d0[1]), "+d"(d1[0]), "+d"(d1[1])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// D (16 x 8, int32) += A (16 x 32 int8, row-major) * B (32 x 8, column-major),
// exact. A register holds 4 consecutive k: a[0], a[1] rows g, g + 8 at
// k = 4 kq.., a[2], a[3] the same rows at k + 16; b[0], b[1] column g at
// k = 4 kq.. and k + 16; d[0], d[1] row g, columns 2 kq, 2 kq + 1; d[2],
// d[3] row g + 8.
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma operands of two neighbouring points from the staged levels: p points
// at the 4-byte word that holds both (bytes at, at + 1 of it; sel = 0x5140
// for at = 0, 0x7362 for at = 2) at the first of 4 consecutive samples,
// `row` bytes apart. lo, hi: the 4 samples of the first and of the second
// point, lowest sample in the lowest byte.
__device__ __forceinline__ void pack2x4(const int8_t* p, int row,
                                        uint32_t sel, int& lo, int& hi) {
  uint32_t w[4];
  #pragma unroll
  for (int u = 0; u < 4; ++u) {
    w[u] = *reinterpret_cast<const uint32_t*>(p + u * row);
  }
  const uint32_t t0 = __byte_perm(w[0], w[1], sel);
  const uint32_t t2 = __byte_perm(w[2], w[3], sel);
  lo = (int)__byte_perm(t0, t2, 0x5410);
  hi = (int)__byte_perm(t0, t2, 0x7632);
}

// The same for one point: p points at the 4-byte word that holds it (byte
// `at` of it, sel = 0x40 + 0x11 * at) at the first of 4 consecutive
// samples, `row` bytes apart. Returns the 4 samples, lowest in the lowest
// byte.
__device__ __forceinline__ int pack1x4(const int8_t* p, int row,
                                       uint32_t sel) {
  uint32_t w[4];
  #pragma unroll
  for (int u = 0; u < 4; ++u) {
    w[u] = *reinterpret_cast<const uint32_t*>(p + u * row);
  }
  const uint32_t t0 = __byte_perm(w[0], w[1], sel);
  const uint32_t t2 = __byte_perm(w[2], w[3], sel);
  return (int)__byte_perm(t0, t2, 0x5410);
}

}  // namespace mf
