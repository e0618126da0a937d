// Blockwise (flash) attention with an online softmax on the SIMT cores,
// hand-written for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:29
// (_flash_kernel) for every call that the tensor-core kernel
// (flash_attention_wgmma.cu) does not take: f32, and bf16 whose head dim is
// above 128 or not a multiple of 8.  q: (B, Sq, D), k and v: (B, Skv, D)
// with batch x heads folded into B; scores scaled by 1/sqrt(D); query row r
// stands at position q_offset + r (q_offset + Sq <= Skv: a rank's rows of a
// sequence split over ranks; 0 with Sq == Skv for self-attention); under
// `causal` column c of row r is kept when c <= q_offset + r and set to
// -1e30 otherwise, so exp gives 0 and never NaN, and KV tiles wholly above
// the diagonal are skipped.  The running max m, sum l and output
// accumulator are f32; the output is acc / l in the inputs' dtype.  Every
// product is an explicit fused multiply-add (__fmaf_rn: the library builds
// with -fmad=false, which leaves an explicit one fused), summed in order of
// the head dim for a score and of the KV column for an output.  No TF32:
// the JAX package's f32 tolerances hold the products to IEEE f32.
//
// Bound: operations (4 * D flops per kept score at the H100's 67 TFLOP/s of
// f32 FMA).  The TPU kernel walks a sequential KV grid axis with (bq,
// 128-lane) stats tiles in VMEM scratch.  Here one block owns BQ = 64 query
// rows of one (batch, head) and loops over BKV = 64-row KV tiles itself,
// stopping at the diagonal under `causal`.  What the design does:
// - Register tiles read as float4.  Q, K and V lie in shared memory as f32,
//   the head dim fastest as in global memory, rows padded to DS floats (a
//   multiple of 8 plus 4: a float4 stays 16-byte aligned and eight
//   neighbouring rows fall on distinct banks).  Thread (sy, sx) = (tid / 16,
//   tid % 16) owns the scores of R rows sy*R + i and the columns sx + 16*j
//   (j < 4), R = 8 at D <= 64 (128 threads) and 4 above (256 threads): for
//   every 4 of D it reads one float4 per Q row (a quarter warp reads one
//   address) and one per K row, R + 4 loads of 16 bytes for 16 R FMAs.  For
//   P V it owns the outputs of the same R rows and the columns
//   sx*4 + 64*jj .. + 3: for every 4 KV columns one float4 of P per row and
//   one of V per column group.
// - The softmax in registers.  A row's 64 scores lie in 16 lanes of one
//   warp, so its max and sum are __shfl_xor_sync within those lanes; m, l and
//   the rescale factor stay in registers of the threads that own the row's
//   outputs.  P goes to shared memory once, for P V.  Two __syncthreads a KV
//   tile.
// - K and V land while the other is multiplied.  One buffer each: V of tile
//   t loads during Q K^T of tile t, K of tile t + 1 during P V of tile t.
//   f32 rows with D % 4 == 0 that start on 16 bytes come by 16-byte cp.async;
//   every other call (bf16, converted to f32 as it is stored; other f32)
//   fetches into registers before the product and stores after it (at
//   D 256 in one go, four quads at a time: held across the product, or
//   fetched whole, the tile spills, so there its loads are not
//   overlapped).  Rows past Skv and
//   columns past D are zeros.  Q comes once, the same way.
// - Shared memory 4 * (3 * 64 * DS + 64 * 68) bytes: 68 KB at D 64 (three
//   blocks of 128 threads an SM by cp.async, which the launch bounds hold
//   to 168 registers; two of 256 through registers, 128 registers), 217 KB
//   at D 256 (one block of eight warps an SM).
// - Heavy, late query tiles first under causal masking: block x takes
//   query tile nq - 1 - x / B of head x % B, so the first wave holds every
//   head's longest tile (its KV tiles end at q_offset + q0 + BQ).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

// the block's Q, K, V tiles and P
extern __shared__ __align__(16) float flash_smem[];

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int BQ = 64, BKV = 64;
constexpr int PS = BKV + 4;  // row stride of P
constexpr float NEG_INF = -1e30f;

// By the head dim compiled for and the copy route: the rows of a thread's
// tile (8 at D <= 64 by cp.async, else 4: beside a tile held in registers
// for the copy, or D / 16 output columns a row at D 256, 8 rows spill), the
// threads of a block (16 lanes a row group), the blocks an SM must hold,
// the quads of a 64-row tile each thread copies through registers, and
// whether it holds them across the product they overlap (not at D 256,
// where that spills).
template <int DMAX, bool ASYNC> constexpr int TM = DMAX <= 64 && ASYNC ? 8 : 4;
template <int DMAX, bool ASYNC> constexpr int NT = BQ / TM<DMAX, ASYNC> * 16;
template <int DMAX, bool ASYNC> constexpr int MIN_BLOCKS = DMAX > 64 ? 1 : ASYNC ? 3 : 2;
template <int DMAX, bool ASYNC>
constexpr int PER = (BKV * DMAX / 4 + NT<DMAX, ASYNC> - 1) / NT<DMAX, ASYNC>;
template <int DMAX> constexpr bool HOLD = DMAX <= 128;

// the row stride of Q, K and V in shared memory: D rounded up to 8, plus 4
__host__ __device__ __forceinline__ int row_stride(int d) { return (d + 7) / 8 * 8 + 4; }

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)3 * BQ * row_stride(d) + (size_t)BQ * PS);
}

// Four consecutive elements of a row as a thread holds them between its
// global load and its shared store: f32 as they are, bf16 as their bits.
template <typename T> struct Stage;
template <> struct Stage<float> {
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() { return float4{0.0f, 0.0f, 0.0f, 0.0f}; }
  // row[e .. e + 3], zeros at columns >= d
  static __device__ __forceinline__ Raw fetch(const float* row, int e, int d, bool) {
    return float4{e < d ? row[e] : 0.0f, e + 1 < d ? row[e + 1] : 0.0f,
                  e + 2 < d ? row[e + 2] : 0.0f, e + 3 < d ? row[e + 3] : 0.0f};
  }
  static __device__ __forceinline__ float4 f32(Raw r) { return r; }
};
template <> struct Stage<__nv_bfloat16> {
  using Raw = uint2;  // element 2i in the low half of word i
  static __device__ __forceinline__ Raw zero() { return uint2{0u, 0u}; }
  // `vec`: D % 4 == 0 and the data starts on 8 bytes, so four elements are
  // one 8-byte load
  static __device__ __forceinline__ Raw fetch(const __nv_bfloat16* row, int e, int d, bool vec) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
    if (vec) return *reinterpret_cast<const uint2*>(h + e);
    const unsigned x0 = e < d ? h[e] : 0u, x1 = e + 1 < d ? h[e + 1] : 0u;
    const unsigned x2 = e + 2 < d ? h[e + 2] : 0u, x3 = e + 3 < d ? h[e + 3] : 0u;
    return uint2{x0 | x1 << 16, x2 | x3 << 16};
  }
  static __device__ __forceinline__ float4 f32(Raw r) {
    return float4{__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                  __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u)};
  }
};

// Where one thread's quads of a 64-row tile lie: quad q = tid + j * nt of
// the tile's rows x qpr quads, walked with (row, quad) carried from one j to
// the next, so no division per element.
struct Walk {
  int r0, c0, dr, dc, qpr;
  __device__ Walk(int qpr_, int nt) : qpr(qpr_) {
    r0 = threadIdx.x / qpr;
    c0 = threadIdx.x % qpr;
    dr = nt / qpr;
    dc = nt % qpr;
  }
  __device__ __forceinline__ void next(int& r, int& c) const {
    r += dr;
    c += dc;
    if (c >= qpr) {
      c -= qpr;
      ++r;
    }
  }
};

// Rows [t0, t0 + 64) of src (n rows of d) into dst (64 x ds) by 16-byte
// cp.async, zeros past row n.  D % 4 == 0 and src on 16 bytes.
__device__ __forceinline__ void tile_async(float* dst, const float* src, int t0, int n, int d,
                                           int ds, const Walk& w) {
  int r = w.r0, c = w.c0;
  while (r < BKV) {
    const bool in = t0 + r < n;
    cp_async16(dst + r * ds + 4 * c, in ? src + (size_t)(t0 + r) * d + 4 * c : src, in);
    w.next(r, c);
  }
}

// The same tile through registers: fetch, then (after the product it
// overlaps) put, converted to f32; zeros past row n and column d.
template <typename T, int N>
__device__ __forceinline__ void tile_fetch(typename Stage<T>::Raw (&st)[N],
                                           const T* src, int t0, int n, int d, bool vec,
                                           const Walk& w) {
  int r = w.r0, c = w.c0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (r < BKV)
      st[j] = t0 + r < n ? Stage<T>::fetch(src + (size_t)(t0 + r) * d, 4 * c, d, vec)
                         : Stage<T>::zero();
    w.next(r, c);
  }
}

template <typename T, int N>
__device__ __forceinline__ void tile_put(float* dst, const typename Stage<T>::Raw (&st)[N],
                                         int ds, const Walk& w) {
  int r = w.r0, c = w.c0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (r < BKV) *reinterpret_cast<float4*>(dst + r * ds + 4 * c) = Stage<T>::f32(st[j]);
    w.next(r, c);
  }
}

// The same tile through registers in one go, CHUNK quads at a time: where
// a whole tile in registers would spill.
constexpr int CHUNK = 4;
template <typename T>
__device__ __forceinline__ void tile_copy(float* dst, const T* src, int t0, int n, int d, int ds,
                                          bool vec, const Walk& w) {
  int r = w.r0, c = w.c0;
  while (r < BKV) {
    typename Stage<T>::Raw st[CHUNK];
    int at[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      at[j] = r < BKV ? r * ds + 4 * c : -1;
      if (r < BKV)
        st[j] = t0 + r < n ? Stage<T>::fetch(src + (size_t)(t0 + r) * d, 4 * c, d, vec)
                           : Stage<T>::zero();
      w.next(r, c);
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      if (at[j] >= 0) *reinterpret_cast<float4*>(dst + at[j]) = Stage<T>::f32(st[j]);
  }
}

template <typename T, int DMAX, bool ASYNC>
__global__ void __launch_bounds__(NT<DMAX, ASYNC>, MIN_BLOCKS<DMAX, ASYNC>) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int sq, int skv, int d, float scale, int causal, int q_offset,
    int vec) {
  constexpr int R = TM<DMAX, ASYNC>;  // rows of the thread's tile
  constexpr int JJ = DMAX / 64;  // float4 column groups of a thread's output row
  // the product loops' unrolling: through registers, the staged quads
  // already hold registers across them
  constexpr int UNROLL = ASYNC ? 4 : 1;
  const int ds = row_stride(d);
  const int dp = (d + 3) / 4 * 4;  // columns read: d, zero-padded to a quad
  float* qs = flash_smem;          // BQ x ds
  float* ks = qs + BQ * ds;        // BKV x ds
  float* vs = ks + BKV * ds;       // BKV x ds
  float* ps = vs + BKV * ds;       // BQ x PS: probabilities of the tile

  const int nb = gridDim.x / ((sq + BQ - 1) / BQ);  // B, the folded batch x heads
  const long long head = blockIdx.x % nb;
  const int q0 = ((sq + BQ - 1) / BQ - 1 - (int)(blockIdx.x / nb)) * BQ;
  const T* qh = q + head * sq * d;
  const T* kh = k + head * skv * d;
  const T* vh = v + head * skv * d;
  T* oh = o + head * sq * d;

  const int tid = threadIdx.x, sy = tid / 16, sx = tid % 16;
  const Walk w(dp / 4, NT<DMAX, ASYNC>);
  typename Stage<T>::Raw st[HOLD<DMAX> ? PER<DMAX, ASYNC> : 1];

  const int kv_end = causal ? min(skv, q_offset + q0 + BQ) : skv;
  const int tiles = (kv_end + BKV - 1) / BKV;
  if constexpr (ASYNC) {
    tile_async(qs, (const float*)qh, q0, sq, d, ds, w);
    tile_async(ks, (const float*)kh, 0, skv, d, ds, w);
    cp_async_commit();
  } else {
    tile_copy<T>(qs, qh, q0, sq, d, ds, vec, w);
    tile_copy<T>(ks, kh, 0, skv, d, ds, vec, w);
  }

  float m[R], l[R], acc[R][JJ][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][jj][x] = 0.0f;
  }
  const float* qrow = qs + sy * R * ds;
  const float* krow = ks + sx * ds;
  const float* prow = ps + sy * R * PS;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BKV;
    // K of this tile has landed; every thread is done with V and P of the last
    if constexpr (ASYNC) cp_async_wait<0>();
    __syncthreads();
    if constexpr (ASYNC) {
      tile_async(vs, (const float*)vh, k0, skv, d, ds, w);
      cp_async_commit();
    } else if constexpr (HOLD<DMAX>) {
      tile_fetch<T>(st, vh, k0, skv, d, vec, w);
    } else {
      tile_copy<T>(vs, vh, k0, skv, d, ds, vec, w);
    }

    float sc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll (UNROLL)
    for (int e = 0; e < dp; e += 4) {
      float4 a[R], b[4];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = *reinterpret_cast<const float4*>(qrow + i * ds + e);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(krow + 16 * j * ds + e);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = __fmaf_rn(a[i].x, b[j].x, sc[i][j]);
          sc[i][j] = __fmaf_rn(a[i].y, b[j].y, sc[i][j]);
          sc[i][j] = __fmaf_rn(a[i].z, b[j].z, sc[i][j]);
          sc[i][j] = __fmaf_rn(a[i].w, b[j].w, sc[i][j]);
        }
    }
    if constexpr (!ASYNC && HOLD<DMAX>) tile_put<T>(vs, st, ds, w);

    // the online softmax, a row across the 16 lanes of its half warp
    float alpha[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = q_offset + q0 + sy * R + i;  // the row's position
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + sx + 16 * j;
        sc[i][j] = c >= skv || (causal && c > r) ? NEG_INF : sc[i][j] * scale;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(sy * R + i) * PS + sx + 16 * j] = p;
        sum = sum + p;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) sum = sum + __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }

    // V and P of this tile are in; every thread is done with K
    if constexpr (ASYNC) cp_async_wait<0>();
    __syncthreads();
    const bool more = t + 1 < tiles;
    if (more) {
      if constexpr (ASYNC) {
        tile_async(ks, (const float*)kh, k0 + BKV, skv, d, ds, w);
        cp_async_commit();
      } else if constexpr (HOLD<DMAX>) {
        tile_fetch<T>(st, kh, k0 + BKV, skv, d, vec, w);
      } else {
        tile_copy<T>(ks, kh, k0 + BKV, skv, d, ds, vec, w);
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][jj][x] = acc[i][jj][x] * alpha[i];
#pragma unroll (UNROLL)
    for (int c = 0; c < BKV; c += 4) {
      float4 p[R];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = *reinterpret_cast<const float4*>(prow + i * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = vs + (c + cc) * ds + sx * 4;
#pragma unroll
        for (int jj = 0; jj < JJ; ++jj) {
          if (sx * 4 + 64 * jj >= dp) continue;
          const float4 vv = *reinterpret_cast<const float4*>(vr + 64 * jj);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float pi = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
            acc[i][jj][0] = __fmaf_rn(pi, vv.x, acc[i][jj][0]);
            acc[i][jj][1] = __fmaf_rn(pi, vv.y, acc[i][jj][1]);
            acc[i][jj][2] = __fmaf_rn(pi, vv.z, acc[i][jj][2]);
            acc[i][jj][3] = __fmaf_rn(pi, vv.w, acc[i][jj][3]);
          }
        }
      }
    }
    if constexpr (!ASYNC && HOLD<DMAX>) {
      if (more) tile_put<T>(ks, st, ds, w);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + sy * R + i;
    if (r >= sq) continue;
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = sx * 4 + 64 * jj + x;
        if (e < d) store(oh + (long long)r * d + e, acc[i][jj][x] / l[i]);
      }
  }
}

template <typename T, int DMAX, bool ASYNC>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv, int d,
           float scale, int causal, int q_offset, int vec, cudaStream_t s) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DMAX, ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned nq = (sq + BQ - 1) / BQ;
  constexpr int threads = NT<DMAX, ASYNC>;
  flash_kernel<T, DMAX, ASYNC><<<nq * (unsigned)b, threads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, d, scale, causal, q_offset, vec);
  return (int)cudaGetLastError();
}

template <typename T, bool ASYNC>
int launch_d(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv, int d,
             float scale, int causal, int q_offset, int vec, cudaStream_t s) {
  if (d <= 64)
    return launch<T, 64, ASYNC>(q, k, v, o, b, sq, skv, d, scale, causal, q_offset, vec, s);
  if (d <= 128)
    return launch<T, 128, ASYNC>(q, k, v, o, b, sq, skv, d, scale, causal, q_offset, vec, s);
  return launch<T, 256, ASYNC>(q, k, v, o, b, sq, skv, d, scale, causal, q_offset, vec, s);
}

// cp.async takes f32 rows whole: D a multiple of 4, every base on 16 bytes
bool copies_async(const void* q, const void* k, const void* v, int d, int dtype) {
  return dtype == 0 && d % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
}

template <typename T, int DMAX, bool ASYNC>
int occupancy(int d, int* threads, int* blocks_per_sm) {
  const int smem = (int)smem_bytes(d);
  *threads = NT<DMAX, ASYNC>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DMAX, ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                            flash_kernel<T, DMAX, ASYNC>,
                                                            NT<DMAX, ASYNC>, smem);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, o: (b, sq, d); k, v: (b, skv, d); all of `dtype` (0 float32, 1
// bfloat16); d <= 256; query row r at position q_offset + r.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int sq, int skv, int d, float scale, int causal,
                                      int q_offset, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (copies_async(q, k, v, d, dtype))
      return launch_d<float, true>(q, k, v, o, b, sq, skv, d, scale, causal, q_offset, 0, s);
    return launch_d<float, false>(q, k, v, o, b, sq, skv, d, scale, causal, q_offset, 0, s);
  }
  const int vec = d % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 8 == 0;
  return launch_d<__nv_bfloat16, false>(q, k, v, o, b, sq, skv, d, scale, causal, q_offset,
                                         vec, s);
}

// What a launch of head dim d would get on this card: its dynamic shared
// memory in bytes, its threads, and how many of its blocks fit an SM.
extern "C" int flash_attention_occupancy(int d, int dtype, int async, int* smem, int* threads,
                                         int* blocks_per_sm) {
  *smem = (int)smem_bytes(d);
  if (dtype == 0 && async) {
    if (d <= 64) return occupancy<float, 64, true>(d, threads, blocks_per_sm);
    if (d <= 128) return occupancy<float, 128, true>(d, threads, blocks_per_sm);
    return occupancy<float, 256, true>(d, threads, blocks_per_sm);
  }
  if (dtype == 0) {
    if (d <= 64) return occupancy<float, 64, false>(d, threads, blocks_per_sm);
    if (d <= 128) return occupancy<float, 128, false>(d, threads, blocks_per_sm);
    return occupancy<float, 256, false>(d, threads, blocks_per_sm);
  }
  if (d <= 64) return occupancy<__nv_bfloat16, 64, false>(d, threads, blocks_per_sm);
  if (d <= 128) return occupancy<__nv_bfloat16, 128, false>(d, threads, blocks_per_sm);
  return occupancy<__nv_bfloat16, 256, false>(d, threads, blocks_per_sm);
}
