// Device helpers for the generated group kernels (backend/cuda_codegen.py).
//
// Each helper reproduces one operation of the reference interpreter as the
// JAX package's generated Pallas kernel evaluates it (repro/backend/codegen.py,
// _emit), so that the CUDA kernel, built with -fmad=false and IEEE division,
// runs the same f32 operations as the plain PyTorch version (backend/eager.py).
#pragma once

#include <cuda_runtime.h>

// x / 0 == 0; otherwise IEEE division (no reciprocal approximation).
__device__ __forceinline__ float ub_div(float a, float b) {
  return b == 0.f ? 0.f : a / b;
}

// min/max that propagate NaN, as jnp.minimum / torch.minimum do (fminf and
// fmaxf return the other operand instead).
__device__ __forceinline__ float ub_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float ub_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// float -> int32 (truncation), arithmetic shift, back to float.
__device__ __forceinline__ float ub_shr(float a, float b) {
  return (float)(((int)a) >> ((int)b));
}

__device__ __forceinline__ float ub_lt(float a, float b) { return a < b ? 1.f : 0.f; }

__device__ __forceinline__ float ub_gt(float a, float b) { return a > b ? 1.f : 0.f; }

__device__ __forceinline__ float ub_sel(float c, float t, float f) {
  return c != 0.f ? t : f;
}

// A bounded global load: elements outside the buffer or past the view's
// valid rows read as 0 (the Pallas kernel receives undefined values there
// and masks them; a CUDA read past the tensor would fault or read a
// neighbour's memory).
__device__ __forceinline__ float ub_load(const float* __restrict__ p, bool ok, int idx) {
  return ok ? p[idx] : 0.f;
}

// A 4-byte copy from global to shared memory that does not wait for its
// data (cp.async, sm_80 and later): a thread issues all its copies of a
// staged panel back to back, so they are in flight together, then
// ub_copy_wait() waits for them; a __syncthreads() after it makes every
// thread's copies visible to the block.  Elsewhere a plain copy.
__device__ __forceinline__ void ub_copy_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void ub_copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The thread's copies issued since the last commit made one group; wait
// until at most N of its groups are still in flight (the oldest land
// first).  Off the card a copy is done when issued.
__device__ __forceinline__ void ub_copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void ub_copy_wait_group() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
#endif
}
