// 3x3 weighted valid convolution, hand-written for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/stencil.py:23
// (_stencil_kernel).  out[y][x] = sum over dy, dx of w[dy][dx] * in[y+dy][x+dx],
// accumulated in f32 from 0.0f in dy-then-dx order as acc = acc + w * v
// (built with -fmad=false, so each product and each sum rounds once, as in
// the plain PyTorch version), and stored in the input's dtype.
//
// Bound: bytes (one read of the input, one write of the output; 18 flops per
// output).  The TPU kernel streams three row-shifted views of the input in
// panels of block_h rows.  Here a block of 128 threads covers 128 output
// columns and 16 rows; each thread walks down its column with the 3x3 window
// in registers and reads one new input row of three values per output row
// (the paper's shift-register chain, per thread), so a warp reads each input
// row as consecutive addresses and neighbouring taps hit L1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int COLS = 128;  // threads per block, one output column each
constexpr int ROWS = 16;   // output rows each thread walks down

template <typename T>
__global__ void __launch_bounds__(COLS) stencil3x3_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out, int h, int wd) {
  const int col = blockIdx.x * COLS + threadIdx.x;
  const int row0 = blockIdx.y * ROWS;
  if (col >= wd) return;
  const long long wp = wd + 2;
  float k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = w[i];
  const T* src = x + row0 * wp + col;
  float r0[3], r1[3], r2[3];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    r0[dx] = to_f32(src[dx]);
    r1[dx] = to_f32(src[wp + dx]);
  }
  const int rows = min(ROWS, h - row0);
  for (int i = 0; i < rows; ++i) {
    const T* nxt = src + (i + 2) * wp;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) r2[dx] = to_f32(nxt[dx]);
    float acc = 0.0f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) acc = acc + k[dx] * r0[dx];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) acc = acc + k[3 + dx] * r1[dx];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) acc = acc + k[6 + dx] * r2[dx];
    store(out + (long long)(row0 + i) * wd + col, acc);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      r0[dx] = r1[dx];
      r1[dx] = r2[dx];
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: (h + 2, wd + 2) and out: (h, wd), both of `dtype` (0 float32, 1
// bfloat16); w: 9 float32 weights, row-major.
extern "C" int stencil3x3_launch(const void* x, const void* w, void* out, int h, int wd,
                                 int dtype, void* stream) {
  const dim3 grid((wd + COLS - 1) / COLS, (h + ROWS - 1) / ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    stencil3x3_kernel<float><<<grid, COLS, 0, s>>>(
        (const float*)x, (const float*)w, (float*)out, h, wd);
  } else {
    stencil3x3_kernel<__nv_bfloat16><<<grid, COLS, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)w, (__nv_bfloat16*)out, h, wd);
  }
  return (int)cudaGetLastError();
}
