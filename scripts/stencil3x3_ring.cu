// The shared-memory line buffer design of the 3x3 stencil, for
// scripts/stencil_probe.py to time against the shipped register design
// (src/repro_torch/kernels/csrc/stencil3x3.cu).  Not part of the package.
//
// A block of `threads` threads sweeps a band of `rows` output rows of a
// strip of threads * V columns (V = 4 f32, 8 bf16).  The strip's input rows
// (its threads * V + 2 columns) land in a ring of S row panels of shared
// memory by 4-byte cp.async copies, S - 2 rows ahead of use: the paper's
// push memory, filled while the rows before are summed.  Each thread keeps
// its 3 x (V + 2) window in registers, reads one new row of it from the
// ring per output row (16-byte shared loads) and stores its V outputs as one
// 16-byte store.  One barrier a row.  Same sums, in the same order, as the
// shipped kernel.  4-byte copies need x's data and row stride on 4 bytes
// (bf16: W even); the launch refuses anything else.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

template <typename T> struct Lanes { static constexpr int V = 4; };
template <> struct Lanes<__nv_bfloat16> { static constexpr int V = 8; };

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  return *reinterpret_cast<const unsigned short*>(&b);
}

__device__ __forceinline__ void store16(float* p, const float* a) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* a) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      bf16_bits(a[0]) | bf16_bits(a[1]) << 16, bf16_bits(a[2]) | bf16_bits(a[3]) << 16,
      bf16_bits(a[4]) | bf16_bits(a[5]) << 16, bf16_bits(a[6]) | bf16_bits(a[7]) << 16);
}

// V + 2 elements of a panel (16-byte aligned) as f32
__device__ __forceinline__ void read(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float2 b = *reinterpret_cast<const float2*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y;
}

__device__ __forceinline__ void read(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t b = *reinterpret_cast<const uint32_t*>(p + 8);
  const uint32_t q[5] = {a.x, a.y, a.z, a.w, b};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    v[2 * i] = __uint_as_float(q[i] << 16);
    v[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(256) ring_kernel(const T* __restrict__ x,
                                                   const float* __restrict__ w,
                                                   T* __restrict__ out, int h, int wd, int rows,
                                                   bool wide_out) {
  constexpr int V = Lanes<T>::V;
  constexpr int PER = 4 / sizeof(T);  // elements a copy
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int nt = blockDim.x;
  const int strip = nt * V;
  const int panel = strip + 16 / sizeof(T);  // the 2-column halo, each panel on 16 bytes
  const int cbase = blockIdx.x * strip;
  const int row0 = blockIdx.y * rows;
  const int in_rows = min(rows, h - row0) + 2;
  const long long wp = wd + 2;
  const int n_el = (int)min((long long)strip + 2, wp - cbase);
  float k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = w[i];
  auto issue = [&](int r) {
    const T* src = x + (row0 + r) * wp + cbase;
    T* dst = ring + (r % S) * panel;
    for (int e = threadIdx.x * PER; e < n_el; e += nt * PER) cp_async4(dst + e, src + e);
  };
#pragma unroll
  for (int r = 0; r < S - 2; ++r) {
    if (r < in_rows) issue(r);
    cp_async_commit();
  }
  const int c0 = threadIdx.x * V;
  const int cols = min(V, wd - cbase - c0);
  T* dst = out + (long long)row0 * wd + cbase + c0;
  float win[3][V + 2];
  for (int r = 0; r < in_rows; ++r) {
    if (r + S - 2 < in_rows) issue(r + S - 2);
    cp_async_commit();
    cp_async_wait<S - 2>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < V + 2; ++j) {
      win[0][j] = win[1][j];
      win[1][j] = win[2][j];
    }
    read(ring + (r % S) * panel + c0, win[2]);
    if (r < 2 || cols <= 0) continue;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc[j] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) acc[j] = acc[j] + k[3 * dy + dx] * win[dy][j + dx];
      }
    }
    T* o = dst + (long long)(r - 2) * wd;
    if (wide_out && cols == V) {
      store16(o, acc);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j < cols) store(o + j, acc[j]);
    }
  }
}

template <typename T, int S>
int launch(const void* x, const void* w, void* out, int h, int wd, int threads, int rows,
           cudaStream_t s, int* smem_bytes) {
  constexpr int V = Lanes<T>::V;
  const int strip = threads * V;
  const int smem = S * (strip + 16 / (int)sizeof(T)) * (int)sizeof(T);
  *smem_bytes = smem;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ring_kernel<T, S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((wd + strip - 1) / strip, (h + rows - 1) / rows);
  const bool wide_out = (uintptr_t)out % 16 == 0 && ((long long)wd * sizeof(T)) % 16 == 0;
  ring_kernel<T, S><<<grid, threads, smem, s>>>((const T*)x, (const float*)w, (T*)out, h, wd,
                                                rows, wide_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stages(const void* x, const void* w, void* out, int h, int wd, int threads, int rows,
                  int stages, cudaStream_t s, int* smem_bytes) {
  switch (stages) {
    case 4: return launch<T, 4>(x, w, out, h, wd, threads, rows, s, smem_bytes);
    case 6: return launch<T, 6>(x, w, out, h, wd, threads, rows, s, smem_bytes);
    case 8: return launch<T, 8>(x, w, out, h, wd, threads, rows, s, smem_bytes);
    case 12: return launch<T, 12>(x, w, out, h, wd, threads, rows, s, smem_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// As stencil3x3_launch, with `stages` (4, 6, 8 or 12) ring slots; writes
// the block's shared bytes to *smem_bytes.
extern "C" int stencil3x3_ring_launch(const void* x, const void* w, void* out, int h, int wd,
                                      int dtype, int threads, int rows, int stages,
                                      int* smem_bytes, void* stream) {
  if ((uintptr_t)x % 4 || (dtype == 1 && wd % 2) || threads % 32 || threads > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_stages<float>(x, w, out, h, wd, threads, rows, stages, s, smem_bytes);
  return launch_stages<__nv_bfloat16>(x, w, out, h, wd, threads, rows, stages, s, smem_bytes);
}
