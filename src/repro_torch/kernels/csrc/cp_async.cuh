// Asynchronous 16-byte copies from global to shared memory (sm_80 and
// later), for the SIMT kernels' shared-memory rings.  A thread's copies
// since its last commit form one group; cp_async_wait<N>() returns once at
// most N of its groups are still in flight, and a __syncthreads() after it
// makes every thread's landed copies visible to the block.
#pragma once

#include <stdint.h>

// 16 bytes from src to dst (both 16-byte aligned), or 16 zero bytes where
// `full` is false: with a source size of 0 nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
