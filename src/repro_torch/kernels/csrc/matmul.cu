// (M, K) @ (K, N) with an f32 accumulator on the SIMT cores, hand-written
// for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/matmul.py:22
// (_matmul_kernel) for every call that the tensor-core kernel
// (matmul_wgmma.cu) does not take: f32, and bf16 whose K or N is not a
// multiple of 8.  Each output element is one f32 sum over k in order,
// acc = fma(a, b, acc) rounded once a term (__fmaf_rn: -fmad=false, which
// the generated kernels need, does not split an explicit fused
// multiply-add), stored in the inputs' dtype.  No TF32: the JAX package's
// f32 tolerances hold its products to IEEE f32.
//
// Bound: operations.  2 M N K flops at the H100's 67 TFLOP/s of f32 FMA
// (separate multiplies and adds would halve that).  What the design does:
// - Register tiles.  A block of 256 threads owns a 128 x 128 output tile
//   (64 threads and 64 x 64 where 128-tiles cannot fill the card), each
//   thread an 8 x 8 tile of accumulators: rows ty*4 + i and BM/2 + ty*4 + i,
//   columns tx*4 + j and BN/2 + tx*4 + j.  For four k it reads its eight A
//   rows as eight float4s (A lies in shared memory as in global memory, k
//   fastest, so cp.async can copy it; a quarter warp reads one address)
//   and per k two float4s of B (8 threads side by side): 4 shared loads
//   of 16 bytes feed 64 FMAs, with no bank conflict.
// - A ring of STAGES slices, BK deep, in shared memory.  f32 operands whose
//   K and N are multiples of 4 and whose data starts on 16-byte boundaries
//   fill it with 16-byte cp.async (zeros past M or N), slice t + 2 landing
//   while slice t multiplies.  Every other call (bf16, converted to f32 as
//   it is stored; f32 that cp.async cannot copy whole) loads through
//   registers into the same ring, guarded element by element.
// - The last slice of a K range stops at its end: no padding term is ever
//   added.
// - Split K.  Where the output tiles cannot fill the 132 SMs (the 256 x 256
//   tile: 16 of 64 x 64), the wrapper (matmul.py: simt_plan) cuts K into
//   `splits` ranges of k_split, a multiple of BK, until the blocks reach
//   two an SM: block z sums its range into the f32 workspace
//   [splits, M, N], and matmul_reduce adds the splits in order and casts.
//   No floating-point atomics: every run gives the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

// the block's ring: STAGES slices of A then B
extern __shared__ __align__(16) float matmul_smem[];

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int BK = 16;      // k of one slice
constexpr int STAGES = 3;   // slices in the ring

template <int BM, int BN>
struct Tile {
  static constexpr int TX = BN / 8, TY = BM / 8, NT = TX * TY;  // threads, 8 x 8 outputs each
  static constexpr int A = BM * BK, B = BK * BN;                // floats of one slice
  static constexpr int SMEM = STAGES * (A + B) * 4;             // bytes of the ring
};

// Slice [k0, k0 + BK) into one stage: as[r * BK + kk] = A[m0 + r][k0 + kk],
// bs[kk * BN + c] = B[k0 + kk][n0 + c], zeros outside rows < m, k < ke and
// columns < n.  By cp.async: K and N multiples of 4 and k0 of 4, so a
// 16-byte chunk lies wholly inside or wholly outside.
template <int BM, int BN>
__device__ __forceinline__ void fill_async(float* as, float* bs, const float* a, const float* b,
                                           int m, int n, int k, int m0, int n0, int k0, int ke) {
  using L = Tile<BM, BN>;
  for (int c = threadIdx.x; c < L::A / 4; c += L::NT) {
    const int r = c / (BK / 4), kc = c % (BK / 4) * 4;
    const bool ok = m0 + r < m && k0 + kc < ke;
    cp_async16(as + r * BK + kc, ok ? a + (size_t)(m0 + r) * k + k0 + kc : a, ok);
  }
  for (int c = threadIdx.x; c < L::B / 4; c += L::NT) {
    const int kk = c / (BN / 4), nc = c % (BN / 4) * 4;
    const bool ok = k0 + kk < ke && n0 + nc < n;
    cp_async16(bs + kk * BN + nc, ok ? b + (size_t)(k0 + kk) * n + n0 + nc : b, ok);
  }
}

// The same slice through registers, converted to f32.
template <int BM, int BN, typename T>
__device__ __forceinline__ void fill_sync(float* as, float* bs, const T* a, const T* b,
                                          int m, int n, int k, int m0, int n0, int k0, int ke) {
  using L = Tile<BM, BN>;
  for (int e = threadIdx.x; e < L::A; e += L::NT) {
    const int gm = m0 + e / BK, gk = k0 + e % BK;
    as[e] = gm < m && gk < ke ? to_f32(a[(size_t)gm * k + gk]) : 0.0f;
  }
  for (int e = threadIdx.x; e < L::B; e += L::NT) {
    const int gk = k0 + e / BN, gn = n0 + e % BN;
    bs[e] = gk < ke && gn < n ? to_f32(b[(size_t)gk * n + gn]) : 0.0f;
  }
}

// c: the output (m, n) in OutT, or with gridDim.z > 1 the f32 workspace
// [gridDim.z, m, n]; block z sums k in [z * k_split, (z + 1) * k_split).
// Blocks of BM * BN / 64 threads, 512 of them on an SM at once: at most
// 128 registers a thread.
template <int BM, int BN, bool ASYNC, typename T, typename OutT>
__global__ void __launch_bounds__(BM * BN / 64, 512 / (BM * BN / 64)) matmul_kernel(
    const T* __restrict__ a, const T* __restrict__ b, OutT* __restrict__ c,
    int m, int n, int k, int k_split) {
  using L = Tile<BM, BN>;
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split, ke = min(k, kb + k_split);
  const int slices = (ke - kb + BK - 1) / BK;
  c += (size_t)blockIdx.z * m * n;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // the rows of A and columns of B this thread reads, as offsets in a slice
  int arow[8], bcol[2] = {tx * 4, BN / 2 + tx * 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    arow[i] = (ty * 4 + i) * BK;
    arow[4 + i] = (BM / 2 + ty * 4 + i) * BK;
  }
  auto fill = [&](int t) {
    float* as = matmul_smem + t % STAGES * (L::A + L::B);
    if constexpr (ASYNC)
      fill_async<BM, BN>(as, as + L::A, a, b, m, n, k, m0, n0, kb + t * BK, ke);
    else
      fill_sync<BM, BN>(as, as + L::A, a, b, m, n, k, m0, n0, kb + t * BK, ke);
  };
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < slices) fill(t);
    cp_async_commit();
  }
  for (int t = 0; t < slices; ++t) {
    // slice t has landed, and every thread is done with slice t - 1, whose
    // stage slice t + STAGES - 1 takes
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < slices) fill(t + STAGES - 1);
    cp_async_commit();
    const float* as = matmul_smem + t % STAGES * (L::A + L::B);
    const float* bs = as + L::A;
    const int kend = min(BK, ke - (kb + t * BK));
    if (kend == BK) {
#pragma unroll
      for (int kq = 0; kq < BK; kq += 4) {
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(as + arow[i] + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 b0 = *reinterpret_cast<const float4*>(bs + (kq + kk) * BN + bcol[0]);
          const float4 b1 = *reinterpret_cast<const float4*>(bs + (kq + kk) * BN + bcol[1]);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(ai, bv[j], acc[i][j]);
          }
        }
      }
    } else {
      for (int kk = 0; kk < kend; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * BN + bcol[0]);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * BN + bcol[1]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = as[arow[i] + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(ai, bv[j], acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + arow[i] / BK;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + bcol[j / 4] + j % 4;
      if (gn < n) store(c + (size_t)gm * n + gn, acc[i][j]);
    }
  }
}

// c[i] = ws[0][i] + ws[1][i] + ... in order, cast to OutT.
template <typename OutT>
__global__ void __launch_bounds__(256) matmul_reduce_kernel(
    const float* __restrict__ ws, OutT* __restrict__ c, long long mn, int splits) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn; i += gridDim.x * 256LL) {
    float acc = ws[i];
    for (int s = 1; s < splits; ++s) acc = acc + ws[s * mn + i];
    store(c + i, acc);
  }
}

template <typename K, typename... Args>
int start(K kernel, dim3 grid, int threads, int smem, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch(const void* a, const void* b, void* c, int m, int n, int k, int dtype, int k_split,
           int splits, cudaStream_t s) {
  using L = Tile<BM, BN>;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  if (dtype == 0) {
    const float *fa = (const float*)a, *fb = (const float*)b;
    const bool async = k % 4 == 0 && n % 4 == 0 && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
    if (async)
      return start(matmul_kernel<BM, BN, true, float, float>, grid, L::NT, L::SMEM, s, fa, fb,
                   (float*)c, m, n, k, k_split);
    return start(matmul_kernel<BM, BN, false, float, float>, grid, L::NT, L::SMEM, s, fa, fb,
                 (float*)c, m, n, k, k_split);
  }
  const __nv_bfloat16 *ha = (const __nv_bfloat16*)a, *hb = (const __nv_bfloat16*)b;
  if (splits > 1)
    return start(matmul_kernel<BM, BN, false, __nv_bfloat16, float>, grid, L::NT, L::SMEM, s, ha,
                 hb, (float*)c, m, n, k, k_split);
  return start(matmul_kernel<BM, BN, false, __nv_bfloat16, __nv_bfloat16>, grid, L::NT, L::SMEM,
               s, ha, hb, (__nv_bfloat16*)c, m, n, k, k_split);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a: (m, k), b: (k, n), row-major, of `dtype` (0 float32, 1 bfloat16);
// `tile` 128 (128 x 128 output tiles) or 64 (64 x 64); K in `splits`
// ranges of k_split.  c: the output (m, n) in dtype, or with splits > 1 the
// f32 workspace (splits, m, n) that matmul_reduce_launch sums.
extern "C" int matmul_launch(const void* a, const void* b, void* c, int m, int n, int k,
                             int dtype, int tile, int k_split, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 128) return launch<128, 128>(a, b, c, m, n, k, dtype, k_split, splits, s);
  if (tile == 64) return launch<64, 64>(a, b, c, m, n, k, dtype, k_split, splits, s);
  return (int)cudaErrorInvalidValue;
}

// ws: (splits, m, n) f32; c: (m, n) of `dtype`.
extern "C" int matmul_reduce_launch(const void* ws, void* c, long long mn, int splits, int dtype,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (int)((mn + 255) / 256 < 132 * 8 ? (mn + 255) / 256 : 132 * 8);
  if (dtype == 0)
    return start(matmul_reduce_kernel<float>, dim3(blocks), 256, 0, s, (const float*)ws,
                 (float*)c, mn, splits);
  return start(matmul_reduce_kernel<__nv_bfloat16>, dim3(blocks), 256, 0, s, (const float*)ws,
               (__nv_bfloat16*)c, mn, splits);
}
