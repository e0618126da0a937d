// 3x3 weighted valid convolution, hand-written for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/stencil.py:23
// (_stencil_kernel).  out[y][x] = sum over dy, dx of w[dy][dx] * in[y+dy][x+dx],
// accumulated in f32 from 0.0f in dy-then-dx order as acc = acc + w * v
// (built with -fmad=false, so each product and each sum rounds once, as in
// the plain PyTorch version), and stored in the input's dtype.
//
// Bound: bytes (one read of the input, one write of the output; 18 flops per
// output).  A 1080p image is a few microseconds of traffic, so the kernel's
// time is how many bytes it keeps in flight.  The TPU kernel streams three
// row-shifted views of the input in panels of block_h rows.  Here a thread
// owns V consecutive outputs (4 f32, 8 bf16) of a band of R rows: it loads
// all R + 2 input rows of its V + 2 columns into registers before its first
// sum, so the band's whole input is in flight at once (R + 2 rows read for
// R rows written), then stores each output row's V values as one 16-byte
// store.  R is 4 (ROWS): at 1080p it gives f32 810 blocks and bf16 270, and
// 8-row bands timed no faster (scripts/stencil_probe.py, which builds this
// source with another ROWS).  stencil.plan picks the block's threads (a
// strip of threads * V columns) from the shape.
//
// Alignment: a padded input row is (W + 2) elements long, so its rows start
// on every 16-byte phase (7,688 B apart for f32 at 1080p) and no wide load
// fits every row.  Loads are element pairs (8 B f32, 4 B bf16) where x's
// data and its row stride are aligned to two elements, else single
// elements; outputs are 16-byte stores where out's rows are 16-byte
// aligned, else single elements.  A thread whose band passes H or whose
// columns pass W takes the scalar tail, the same sums element by element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int ROWS = 4;  // R, the band's output rows (stencil.ROWS)

template <typename T> struct Lanes { static constexpr int V = 4; };        // f32: 16 B of outputs
template <> struct Lanes<__nv_bfloat16> { static constexpr int V = 8; };  // bf16: 16 B

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// N consecutive elements from p, as f32: in pairs where PAIRS (p aligned
// to two elements, N even), else one by one.
template <int N, bool PAIRS>
__device__ __forceinline__ void load(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += PAIRS ? 2 : 1) {
    if constexpr (PAIRS) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
    } else {
      v[i] = p[i];
    }
  }
}

template <int N, bool PAIRS>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += PAIRS ? 2 : 1) {
    if constexpr (PAIRS) {
      // two bf16 are the high halves of two f32: exact
      const uint32_t q = *reinterpret_cast<const uint32_t*>(p + i);
      v[i] = __uint_as_float(q << 16);
      v[i + 1] = __uint_as_float(q & 0xffff0000u);
    } else {
      v[i] = __bfloat162float(p[i]);
    }
  }
}

// V outputs to p as one 16-byte store (p 16-byte aligned).
__device__ __forceinline__ void store16(float* p, const float* a) {
  float4 q;
  q.x = a[0];
  q.y = a[1];
  q.z = a[2];
  q.w = a[3];
  *reinterpret_cast<float4*>(p) = q;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  return *reinterpret_cast<const unsigned short*>(&b);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* a) {
  uint4 q;
  q.x = bf16_bits(a[0]) | bf16_bits(a[1]) << 16;
  q.y = bf16_bits(a[2]) | bf16_bits(a[3]) << 16;
  q.z = bf16_bits(a[4]) | bf16_bits(a[5]) << 16;
  q.w = bf16_bits(a[6]) | bf16_bits(a[7]) << 16;
  *reinterpret_cast<uint4*>(p) = q;
}

// Block (strip, band): a strip of blockDim.x * V output columns, a band of
// R output rows; thread t owns columns c0 .. c0 + V - 1 of every row of it.
template <typename T, bool PAIRS>
__global__ void __launch_bounds__(MAX_THREADS) stencil3x3_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out, int h, int wd,
    bool wide_out) {
  constexpr int V = Lanes<T>::V, R = ROWS;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int row0 = blockIdx.y * R;
  if (c0 >= wd) return;
  const long long wp = wd + 2;
  float k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = w[i];
  const T* src = x + row0 * wp + c0;
  T* dst = out + (long long)row0 * wd + c0;
  if (row0 + R <= h && c0 + V <= wd) {
    // every load of the band before the first sum
    float v[R + 2][V + 2];
#pragma unroll
    for (int r = 0; r < R + 2; ++r) load<V + 2, PAIRS>(src + r * wp, v[r]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[j] = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) acc[j] = acc[j] + k[3 * dy + dx] * v[r + dy][j + dx];
        }
      }
      if (wide_out) {
        store16(dst + (long long)r * wd, acc);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) store(dst + (long long)r * wd + j, acc[j]);
      }
    }
    return;
  }
  // the ragged edge: the rows of the last band, the columns of the last thread
  const int rows = min(R, h - row0), cols = min(V, wd - c0);
  for (int r = 0; r < rows; ++r) {
    for (int j = 0; j < cols; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = acc + k[3 * dy + dx] * to_f32(src[(r + dy) * wp + j + dx]);
      }
      store(dst + (long long)r * wd + j, acc);
    }
  }
}

bool valid(int threads) {
  return threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0;
}

// Loads in pairs: x's data and its row stride (wd + 2 elements) aligned to
// two elements.
template <typename T>
bool pairs(const void* x, int wd) {
  return (uintptr_t)x % (2 * sizeof(T)) == 0 && wd % 2 == 0;
}

template <typename T, bool PAIRS>
int launch(const void* x, const void* w, void* out, int h, int wd, int threads,
           cudaStream_t s) {
  constexpr int V = Lanes<T>::V;
  const int strips = ((wd + V - 1) / V + threads - 1) / threads;
  const dim3 grid(strips, (h + ROWS - 1) / ROWS);
  const bool wide_out = (uintptr_t)out % 16 == 0 && ((long long)wd * sizeof(T)) % 16 == 0;
  const T* xs = (const T*)x;
  const float* ws = (const float*)w;
  T* os = (T*)out;
  stencil3x3_kernel<T, PAIRS><<<grid, threads, 0, s>>>(xs, ws, os, h, wd, wide_out);
  return (int)cudaGetLastError();
}

template <typename T, bool PAIRS>
int occupancy(int threads, int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, stencil3x3_kernel<T, PAIRS>, threads, 0);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: (h + 2, wd + 2) and out: (h, wd), both of `dtype` (0 float32, 1
// bfloat16); w: 9 float32 weights, row-major.  `threads` (a multiple of 32,
// at most 256) comes from stencil.plan.
extern "C" int stencil3x3_launch(const void* x, const void* w, void* out, int h, int wd,
                                 int dtype, int threads, void* stream) {
  if (!valid(threads) || (h + ROWS - 1) / ROWS > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return pairs<float>(x, wd) ? launch<float, true>(x, w, out, h, wd, threads, s)
                               : launch<float, false>(x, w, out, h, wd, threads, s);
  }
  return pairs<__nv_bfloat16>(x, wd)
             ? launch<__nv_bfloat16, true>(x, w, out, h, wd, threads, s)
             : launch<__nv_bfloat16, false>(x, w, out, h, wd, threads, s);
}

// How many blocks of the kernel a launch on x would take fit an SM.
extern "C" int stencil3x3_occupancy(const void* x, int wd, int dtype, int threads,
                                    int* blocks_per_sm) {
  if (!valid(threads)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return pairs<float>(x, wd) ? occupancy<float, true>(threads, blocks_per_sm)
                               : occupancy<float, false>(threads, blocks_per_sm);
  }
  return pairs<__nv_bfloat16>(x, wd) ? occupancy<__nv_bfloat16, true>(threads, blocks_per_sm)
                                     : occupancy<__nv_bfloat16, false>(threads, blocks_per_sm);
}
