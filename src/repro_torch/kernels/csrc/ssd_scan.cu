// Mamba2 SSD (state-space duality) chunked scan, hand-written for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/ssd.py:27 (_ssd_kernel).
// Per head h and chunk of L steps, with s = cumsum(a_h * dt) inside the chunk:
//   y[l, p]   = sum_{m <= l} G[l, m] * exp(s_l - s_m) * dt_m * x[m, p]
//             + exp(s_l) * sum_n C[l, n] * state[p, n]
//   state'    = exp(s_{L-1}) * state + sum_l exp(s_{L-1} - s_l) * dt_l * x[l, p] * B[l, n]
// with G = C B^T, B and C shared across heads, the f32 state carried across
// chunks in order.
//
// Bound: operations (2 * L * N flops of G per chunk, and per head about
// L * P flops of the intra-chunk sum per step plus 2 * P * N each for the
// state's read-out and update).  The TPU kernel runs the chunk axis as a
// sequential grid with the whole (H, P, N) state in VMEM.  Here the state of
// head h depends only on that head's x, so the grid is (head, 32-wide slice
// of P) and each block loops over the chunks in order with its (32, N) slice
// of the state in shared memory.  G of one chunk is L x L f32 (256 KB at
// L = 256, above a block's 227 KB) and the same for every head, so a first
// kernel (its own entry, ssd_gram_launch) writes G's lower triangle, zeros
// above, for every chunk into a buffer that every block of the scan
// (ssd_scan_launch) reads; the scan kernel then stages, per tile of 8 rows,
// G * exp(s_l - s_m) * dt_m for m <= l only (never above the diagonal, where
// exp overflows), and runs the sums as SIMT f32 loops (no tensor cores yet).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

// the gram kernel's ring: two slices of C's and B's rows
extern __shared__ __align__(16) float gram_smem[];

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int GT = 32, GNT = 64;         // gram kernel: 32 x 32 output tile, threads
constexpr int GK = 64, GS = GK + 4;      // its ring slices: 64 of N, rows padded to 68
constexpr int NT = 256, PT = 32;         // scan kernel: threads, P columns per block
constexpr int LT = NT / PT;              // rows of one tile of the intra-chunk sum

// One slice [n0, n0 + GK) of N: rows l0.. of C into cs and m0.. of B into
// bs (GT x GS each), zeros past row L and column n.  By cp.async: n % 4 == 0
// and b, c on 16 bytes, so a quad lies wholly inside or outside.
template <bool ASYNC>
__device__ __forceinline__ void gram_fill(float* cs, float* bs, const float* c, const float* b,
                                          long long t0, int l0, int m0, int L, int n, int n0) {
  if constexpr (ASYNC) {
    for (int qd = threadIdx.x; qd < 2 * GT * (GK / 4); qd += GNT) {
      const int r = qd / (GK / 4) % GT, e = qd % (GK / 4) * 4;
      const bool is_b = qd >= GT * (GK / 4);
      const int row = (is_b ? m0 : l0) + r;
      const bool ok = row < L && n0 + e < n;
      const float* src = is_b ? b : c;
      cp_async16((is_b ? bs : cs) + r * GS + e, ok ? src + (t0 + row) * n + n0 + e : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * GT * GK; i += GNT) {
      const int r = i / GK % GT, e = i % GK;
      const bool is_b = i >= GT * GK;
      const int row = (is_b ? m0 : l0) + r;
      (is_b ? bs : cs)[r * GS + e] =
          row < L && n0 + e < n ? (is_b ? b : c)[(t0 + row) * n + n0 + e] : 0.0f;
    }
  }
}

// g[t0 + l][m] = sum_n c[t0 + l][n] * b[t0 + m][n] for m <= l, and 0 for
// m > l, t0 = chunk * L.  Block (p, chunk) takes the p-th 32 x 32 tile on or
// below the diagonal, (ti, tj) with tj <= ti, and, off the diagonal, writes
// the zero tile (tj, ti) that mirrors it above: no block only writes zeros.
// Thread (ty, tx) = (tid / 8, tid % 8) sums rows ty*4 + i and columns
// tx + 8*j (i, j < 4) over N in order with __fmaf_rn, reading float4s of C
// (a quarter warp reads one address) and of B (eight rows 68 floats apart:
// distinct banks), through a 2-slice cp.async ring.
template <bool ASYNC>
__global__ void __launch_bounds__(GNT) ssd_gram_kernel(
    const float* __restrict__ b, const float* __restrict__ c, float* __restrict__ g, int L, int n) {
  const int p = blockIdx.x;
  int ti = (int)((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while (ti * (ti + 1) / 2 > p) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  const int tj = p - ti * (ti + 1) / 2;
  const int l0 = ti * GT, m0 = tj * GT;
  const long long t0 = (long long)blockIdx.y * L;
  float* gc = g + t0 * L;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;

  if (tj < ti) {  // the mirror tile: rows m0.., columns l0.., all above the diagonal
    if (L % 4 == 0) {
      for (int qd = tid; qd < GT * GT / 4; qd += GNT) {
        const int r = m0 + qd / (GT / 4), e = l0 + qd % (GT / 4) * 4;
        if (r < L && e < L)
          *reinterpret_cast<float4*>(gc + (long long)r * L + e) = float4{0.0f, 0.0f, 0.0f, 0.0f};
      }
    } else {
      for (int i = tid; i < GT * GT; i += GNT) {
        const int r = m0 + i / GT, e = l0 + i % GT;
        if (r < L && e < L) gc[(long long)r * L + e] = 0.0f;
      }
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const int slices = (n + GK - 1) / GK;
  gram_fill<ASYNC>(gram_smem, gram_smem + GT * GS, c, b, t0, l0, m0, L, n, 0);
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    // slice s has landed; every thread is done with slice s - 1, whose
    // stage slice s + 1 takes
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < slices) {
      float* nx = gram_smem + (s + 1) % 2 * 2 * GT * GS;
      gram_fill<ASYNC>(nx, nx + GT * GS, c, b, t0, l0, m0, L, n, (s + 1) * GK);
    }
    cp_async_commit();
    const float* cs = gram_smem + s % 2 * 2 * GT * GS;
    const float* bs = cs + GT * GS;
    const int kq = min(GK, n - s * GK);  // columns of the slice; zeros pad it to a quad
#pragma unroll 4
    for (int e = 0; e < kq; e += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = *reinterpret_cast<const float4*>(cs + (ty * 4 + i) * GS + e);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(bs + (tx + 8 * j) * GS + e);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __fmaf_rn(cv[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = __fmaf_rn(cv[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = __fmaf_rn(cv[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = __fmaf_rn(cv[i].w, bv[j].w, acc[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx + 8 * j;
      if (l < L && m < L) gc[(long long)l * L + m] = m <= l ? acc[i][j] : 0.0f;
    }
  }
}

size_t scan_smem_bytes(int L, int n) {
  return sizeof(float) * ((size_t)4 * L + (size_t)L * PT + (size_t)LT * L + (size_t)PT * (n + 1));
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ c, const float* __restrict__ g,
    T* __restrict__ y, int s_len, int H, int P, int N, int L) {
  extern __shared__ float smem[];
  float* s_s = smem;             // L: s[l], the cumulative log-decay
  float* dt_s = s_s + L;         // L: dt[l]
  float* es_s = dt_s + L;        // L: exp(s[l])
  float* tail_s = es_s + L;      // L: exp(s[L-1] - s[l]) * dt[l]
  float* xs = tail_s + L;        // L x PT: x[t0 + l, h, p0 + p]
  float* ws = xs + L * PT;       // LT x L: G * exp(s_l - s_m) * dt_m, m <= l
  float* hs = ws + LT * L;       // PT x (N + 1): the carried state slice

  const int h = blockIdx.x, p0 = blockIdx.y * PT;
  const int tid = threadIdx.x, pc = tid % PT, lr = tid / PT;
  const float ah = a[h];
  for (int i = tid; i < PT * (N + 1); i += NT) hs[i] = 0.0f;

  for (int ci = 0; ci < s_len / L; ++ci) {
    const long long t0 = (long long)ci * L;
    __syncthreads();  // the previous chunk's state update is done with xs and tail_s
    for (int l = tid; l < L; l += NT) dt_s[l] = dt[(t0 + l) * H + h];
    for (int i = tid; i < L * PT; i += NT) {
      const int l = i / PT, p = i % PT;
      xs[i] = p0 + p < P ? to_f32(x[((t0 + l) * H + h) * P + p0 + p]) : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int l = 0; l < L; ++l) {
        s = s + ah * dt_s[l];
        s_s[l] = s;
      }
    }
    __syncthreads();
    const float s_last = s_s[L - 1];
    for (int l = tid; l < L; l += NT) {
      es_s[l] = expf(s_s[l]);
      tail_s[l] = expf(s_last - s_s[l]) * dt_s[l];
    }

    // y, one tile of LT rows at a time; the state is read, not written
    const float* gc = g + t0 * L;
    for (int l0 = 0; l0 < L; l0 += LT) {
      __syncthreads();  // ws is free; es_s is written
      for (int i = tid; i < LT * L; i += NT) {
        const int r = i / L, m = i % L, l = l0 + r;
        if (l < L && m <= l) ws[i] = gc[(long long)l * L + m] * (expf(s_s[l] - s_s[m]) * dt_s[m]);
      }
      __syncthreads();
      const int l = l0 + lr;
      if (l < L) {
        const float* wr = ws + lr * L;
        float intra = 0.0f;
        for (int m = 0; m <= l; ++m) intra = intra + wr[m] * xs[m * PT + pc];
        const float* cr = c + (t0 + l) * N;
        const float* hr = hs + pc * (N + 1);
        float inter = 0.0f;
        for (int n = 0; n < N; ++n) inter = inter + cr[n] * hr[n];
        if (p0 + pc < P) store(y + ((t0 + l) * H + h) * P + p0 + pc, intra + es_s[l] * inter);
      }
    }
    __syncthreads();  // every read of the state for this chunk is done

    const float decay = es_s[L - 1];
    for (int i = tid; i < PT * N; i += NT) {
      const int p = i / N, n = i % N;
      float acc = 0.0f;
      for (int l = 0; l < L; ++l) acc = acc + (tail_s[l] * xs[l * PT + p]) * b[(t0 + l) * N + n];
      float* hp = hs + p * (N + 1) + n;
      *hp = decay * *hp + acc;
    }
  }
}

template <typename T>
int launch_scan(const void* x, const void* dt, const void* a, const void* b, const void* c,
                const void* g, void* y, int s_len, int h, int p, int n, int L, cudaStream_t s) {
  const size_t smem = scan_smem_bytes(L, n);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<dim3(h, (p + PT - 1) / PT), NT, smem, s>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)b, (const float*)c,
      (const float*)g, (T*)y, s_len, h, p, n, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// b, c: (s_len, n) float32; g: (s_len / L, L, L) float32, written whole:
// per chunk, C B^T on and below the diagonal, 0 above.  One launch on `stream`.
extern "C" int ssd_gram_launch(const void* b, const void* c, void* g, int s_len, int n, int L,
                               void* stream) {
  const int tiles = (L + GT - 1) / GT;
  const dim3 grid(tiles * (tiles + 1) / 2, s_len / L);
  const int smem = 2 * 2 * GT * GS * (int)sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (n % 4 == 0 && ((uintptr_t)b | (uintptr_t)c) % 16 == 0) {
    ssd_gram_kernel<true><<<grid, GNT, smem, s>>>((const float*)b, (const float*)c, (float*)g, L, n);
  } else {
    ssd_gram_kernel<false><<<grid, GNT, smem, s>>>((const float*)b, (const float*)c, (float*)g, L, n);
  }
  return (int)cudaGetLastError();
}

// x, y: (s_len, h, p) of `dtype` (0 float32, 1 bfloat16); dt: (s_len, h),
// a: (h,), b, c: (s_len, n), all float32; g: ssd_gram_launch's output for
// b, c and L; L divides s_len.  One launch on `stream`.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, const void* g, void* y, int s_len, int h, int p,
                               int n, int L, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_scan<float>(x, dt, a, b, c, g, y, s_len, h, p, n, L, s);
  return launch_scan<__nv_bfloat16>(x, dt, a, b, c, g, y, s_len, h, p, n, L, s);
}
