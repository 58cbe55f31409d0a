// Per-phase clock counters of a kernel, compiled in only with -DMF_PHASES
// (examples/kernel_phases.py builds such a library apart; the fit's library
// never defines it, and then the macros are empty).
//
// MF_PHASE_BEGIN opens the kernel's first phase; MF_PHASE(k) closes phase k:
// a block barrier, then thread 0 adds the clock cycles since the previous
// mark to counter k (summed over blocks). Each mark must be reached by every
// thread of the block. MF_PHASE_API(name) defines the C entry point
// name(out, reset) that copies the counters to the host array out (kPhases
// values) and, with reset, zeroes them.
#pragma once

#ifdef MF_PHASES
#include <cuda_runtime.h>

namespace mf {
constexpr int kPhases = 8;
}

static __device__ unsigned long long mf_phase_cycles[mf::kPhases];
static __shared__ long long mf_phase_t0;

#define MF_PHASE_BEGIN                                                    \
  do {                                                                    \
    if (threadIdx.x == 0) mf_phase_t0 = clock64();                        \
  } while (0)
#define MF_PHASE(k)                                                       \
  do {                                                                    \
    __syncthreads();                                                      \
    if (threadIdx.x == 0) {                                               \
      const long long mf_phase_t = clock64();                             \
      atomicAdd(&mf_phase_cycles[k],                                      \
                (unsigned long long)(mf_phase_t - mf_phase_t0));          \
      mf_phase_t0 = mf_phase_t;                                           \
    }                                                                     \
  } while (0)
#define MF_PHASE_API(name)                                                \
  extern "C" int name(unsigned long long* out, int reset) {               \
    cudaError_t e = cudaMemcpyFromSymbol(out, mf_phase_cycles,            \
                                         sizeof(mf_phase_cycles));        \
    if (e == cudaSuccess && reset) {                                      \
      const unsigned long long z[mf::kPhases] = {};                       \
      e = cudaMemcpyToSymbol(mf_phase_cycles, z, sizeof(z));              \
    }                                                                     \
    return (int)e;                                                        \
  }
#else
#define MF_PHASE_BEGIN
#define MF_PHASE(k)
#define MF_PHASE_API(name)
#endif
