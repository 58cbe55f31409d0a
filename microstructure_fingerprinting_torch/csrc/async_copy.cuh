// Asynchronous copies from device to shared memory (cp.async): the copy is
// started, the thread goes on, and the data is there after a wait that covers
// it and a block barrier. copy16_async / copy4_async / copy_async_wait_all
// serve one-shot copies (kernels 1, 3 and 5: strips and packs); cp_async<N>
// with its groups serves the Gram tiles' rings of sample chunks.
#pragma once

#include <stdint.h>

namespace mf {

// 16 bytes, both addresses 16-byte aligned; past L1 (read once a block)
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

// 4 bytes, both addresses 4-byte aligned
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

// waits for every copy this thread has issued
__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;"
               ::: "memory");
}

// N = 8 or 16 bytes from device to shared memory without passing registers
// (zeros if !in); complete after the cp_async_wait that covers their group
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = in ? N : 0;
  if constexpr (N == 16) {      // past L1: every byte is read once a block
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                 :: "r"(d), "l"(src), "n"(N), "r"(n) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// waits until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace mf
