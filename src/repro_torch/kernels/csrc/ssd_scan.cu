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

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int GT = 16;                   // gram kernel: 16 x 16 output tile per block
constexpr int NT = 256, PT = 32;         // scan kernel: threads, P columns per block
constexpr int LT = NT / PT;              // rows of one tile of the intra-chunk sum

// g[t0 + l][m] = sum_n c[t0 + l][n] * b[t0 + m][n] for m <= l, and 0 for
// m > l, t0 = chunk * L
__global__ void __launch_bounds__(GT * GT) ssd_gram_kernel(
    const float* __restrict__ b, const float* __restrict__ c, float* __restrict__ g, int L, int n) {
  __shared__ float cs[GT][GT + 1], bs[GT][GT + 1];
  const int l0 = blockIdx.y * GT, m0 = blockIdx.x * GT;
  const long long t0 = (long long)blockIdx.z * L;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (m0 > l0 + GT - 1) {  // wholly above the diagonal
    if (l0 + ty < L && m0 + tx < L) g[(t0 + l0 + ty) * L + m0 + tx] = 0.0f;
    return;
  }
  float acc = 0.0f;
  for (int n0 = 0; n0 < n; n0 += GT) {
    cs[ty][tx] = (l0 + ty < L && n0 + tx < n) ? c[(t0 + l0 + ty) * n + n0 + tx] : 0.0f;
    bs[ty][tx] = (m0 + ty < L && n0 + tx < n) ? b[(t0 + m0 + ty) * n + n0 + tx] : 0.0f;
    __syncthreads();
    const int kend = min(GT, n - n0);
    for (int kk = 0; kk < kend; ++kk) acc = acc + cs[ty][kk] * bs[tx][kk];
    __syncthreads();
  }
  const int l = l0 + ty, m = m0 + tx;
  if (l < L && m < L) g[(t0 + l) * L + m] = m <= l ? acc : 0.0f;
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
  const dim3 grid((L + GT - 1) / GT, (L + GT - 1) / GT, s_len / L);
  ssd_gram_kernel<<<grid, dim3(GT, GT), 0, (cudaStream_t)stream>>>(
      (const float*)b, (const float*)c, (float*)g, L, n);
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
