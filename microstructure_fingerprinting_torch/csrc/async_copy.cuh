// Asynchronous copies from device to shared memory (cp.async) for kernels
// 1 and 5: the copy is issued, the thread goes on, and the data is there
// after copy_async_wait_all() and a block barrier.
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

}  // namespace mf
