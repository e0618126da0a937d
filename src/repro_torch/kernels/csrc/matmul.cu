// (M, K) @ (K, N) with an f32 accumulator, hand-written for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/matmul.py:22
// (_matmul_kernel).  Each output element is one f32 sum over k in order,
// acc = acc + a * b (built with -fmad=false), stored in the inputs' dtype.
//
// Bound: operations at these shapes.  The TPU kernel carries a (bm, bn) f32
// accumulator block across a sequential K grid axis.  Here a block of 256
// threads owns a 64 x 64 output tile and loops over K itself, staging 16-deep
// slices of A and B in shared memory; each thread keeps a 4 x 4 tile of
// accumulators in registers.  A simple SIMT tiling: no tensor cores, no
// cp.async or TMA (later work).  Edge tiles are masked, and the k loop of the
// last slice stops at K, so no padding term is ever added.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int NT = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(NT) matmul_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c, int m, int n, int k) {
  __shared__ float as[BK][BM + 1];  // A slice, transposed: as[kk][row]
  __shared__ float bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK, gm = m0 + r, gk = k0 + kk;
      as[kk][r] = (gm < m && gk < k) ? to_f32(a[(long long)gm * k + gk]) : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, cc = i % BN, gk = k0 + kk, gn = n0 + cc;
      bs[kk][cc] = (gk < k && gn < n) ? to_f32(b[(long long)gk * n + gn]) : 0.0f;
    }
    __syncthreads();
    const int kend = min(BK, k - k0);
#pragma unroll 4
    for (int kk = 0; kk < kend; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < m && gn < n) store(c + (long long)gm * n + gn, acc[i][j]);
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a: (m, k), b: (k, n), c: (m, n), row-major, all of `dtype` (0 float32,
// 1 bfloat16).
extern "C" int matmul_launch(const void* a, const void* b, void* c, int m, int n, int k,
                             int dtype, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    matmul_kernel<float><<<grid, NT, 0, s>>>((const float*)a, (const float*)b, (float*)c, m, n, k);
  } else {
    matmul_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)c, m, n, k);
  }
  return (int)cudaGetLastError();
}
