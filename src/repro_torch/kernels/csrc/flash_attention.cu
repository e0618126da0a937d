// Blockwise (flash) attention with an online softmax, hand-written for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:29
// (_flash_kernel).  q: (B, Sq, D), k and v: (B, Skv, D) with batch x heads
// folded into B; scores scaled by 1/sqrt(D); under `causal` (Sq == Skv)
// column c of row r is kept when c <= r and set to -1e30 otherwise, so exp
// gives 0 and never NaN.  The running max m, sum l and output accumulator
// are f32; the output is acc / l in the inputs' dtype.
//
// Bound: operations (4 * D flops per kept score).  The TPU kernel walks a
// sequential KV grid axis with (bq, 128-lane) stats tiles in VMEM scratch.
// Here one block of 256 threads owns 64 query rows of one (batch, head) and
// loops over 64-row KV tiles itself, stopping at the diagonal under
// `causal`.  Q, K and V tiles are staged in shared memory as f32 (rows padded
// to D + 1 floats, so the score loop reads K without bank conflicts), the
// scores of one tile go through shared memory, m and l are one float per row,
// and each thread keeps D / 4 accumulators of one output row in registers.
// At D = 128 the tiles take 116 KB, above the 48 KB default: the launcher
// opts in to dynamic shared memory.  SIMT f32 arithmetic, no tensor cores
// (later work); bf16 is converted to f32 on load.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int BQ = 64, BKV = 64, NT = 256;
constexpr float NEG_INF = -1e30f;

size_t smem_bytes(int d) {
  const int ds = d + 1;
  return sizeof(float) * ((size_t)(BQ + 2 * BKV) * ds + BQ * (BKV + 1) + 3 * BQ);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int sq, int skv, int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int ds = d + 1;
  float* qs = smem;                   // BQ x ds
  float* ks = qs + BQ * ds;           // BKV x ds
  float* vs = ks + BKV * ds;          // BKV x ds
  float* ss = vs + BKV * ds;          // BQ x (BKV + 1): scores, then probabilities
  float* m_s = ss + BQ * (BKV + 1);   // BQ running max
  float* l_s = m_s + BQ;              // BQ running sum
  float* a_s = l_s + BQ;              // BQ rescale factor of the current tile

  // heavy (late) query tiles of a head first under causal masking
  const int nq = (sq + BQ - 1) / BQ;
  const long long head = blockIdx.x / nq;
  const int q0 = (nq - 1 - (int)(blockIdx.x % nq)) * BQ;
  const T* qh = q + head * sq * d;
  const T* kh = k + head * skv * d;
  const T* vh = v + head * skv * d;
  T* oh = o + head * sq * d;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < BQ * d; i += NT) {
    const int r = i / d, e = i % d;
    qs[r * ds + e] = q0 + r < sq ? to_f32(qh[(long long)(q0 + r) * d + e]) : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  const int sy = tid / 16, sx = tid % 16;  // scores: rows sy*4 + i, columns sx + 16*j
  const int ar = tid / 4, ac = tid % 4;    // output: row ar, columns ac + 4*j
  float acc[DMAX / 4];
#pragma unroll
  for (int j = 0; j < DMAX / 4; ++j) acc[j] = 0.0f;

  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's reads of ks, vs, ss are done
    for (int i = tid; i < BKV * d; i += NT) {
      const int r = i / d, e = i % d;
      const bool in = k0 + r < skv;
      const long long off = (long long)(k0 + r) * d + e;
      ks[r * ds + e] = in ? to_f32(kh[off]) : 0.0f;
      vs[r * ds + e] = in ? to_f32(vh[off]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int e = 0; e < d; ++e) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(sy * 4 + i) * ds + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(sx + 16 * j) * ds + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = sc[i][j] + qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sy * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sx + 16 * j;
        float s = sc[i][j] * scale;
        if (k0 + c >= skv || (causal && k0 + c > q0 + r)) s = NEG_INF;
        ss[r * (BKV + 1) + c] = s;
      }
    }
    __syncthreads();

    // online softmax: each warp takes BQ / 8 rows, each lane two columns
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* row = ss + r * (BKV + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1) sum = sum + __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    const float alpha = a_s[ar];
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) acc[j] = acc[j] * alpha;
    const float* prow = ss + ar * (BKV + 1);
    for (int c = 0; c < BKV; ++c) {
      const float p = prow[c];
      const float* vr = vs + c * ds;
#pragma unroll
      for (int j = 0; j < DMAX / 4; ++j) {
        const int e = ac + 4 * j;
        if (e < d) acc[j] = acc[j] + p * vr[e];
      }
    }
  }

  if (q0 + ar < sq) {
    const float l = l_s[ar];
#pragma unroll
    for (int j = 0; j < DMAX / 4; ++j) {
      const int e = ac + 4 * j;
      if (e < d) store(oh + (long long)(q0 + ar) * d + e, acc[j] / l);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv, int d,
           float scale, int causal, cudaStream_t s) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned nq = (sq + BQ - 1) / BQ;
  flash_kernel<T, DMAX><<<nq * (unsigned)b, NT, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv, int d,
             float scale, int causal, cudaStream_t s) {
  if (d <= 64) return launch<T, 64>(q, k, v, o, b, sq, skv, d, scale, causal, s);
  if (d <= 128) return launch<T, 128>(q, k, v, o, b, sq, skv, d, scale, causal, s);
  return launch<T, 256>(q, k, v, o, b, sq, skv, d, scale, causal, s);
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, o: (b, sq, d); k, v: (b, skv, d); all of `dtype` (0 float32, 1
// bfloat16); d <= 256.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int sq, int skv, int d, float scale, int causal,
                                      int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(q, k, v, o, b, sq, skv, d, scale, causal, s);
  return launch_d<__nv_bfloat16>(q, k, v, o, b, sq, skv, d, scale, causal, s);
}
