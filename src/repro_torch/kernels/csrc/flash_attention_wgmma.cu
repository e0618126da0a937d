// bf16 blockwise (flash) attention on Hopper's tensor cores, hand-written
// for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:29
// (_flash_kernel) for bf16 inputs with head dims up to 128 that are
// multiples of 8; f32 and other head dims stay on the SIMT kernel
// (flash_attention.cu).  q: (B, Sq, D), k and v: (B, Skv, D) with batch x
// heads folded into B; scores scaled by 1/sqrt(D); under `causal` (Sq == Skv)
// column c of row r is kept when c <= r and set to -1e30 otherwise; KV tiles
// wholly above the diagonal are skipped.  The running max m and sum l and
// the output accumulator are f32; the output is acc / l rounded once to bf16.
//
// Bound: operations (4 D flops per kept score on the bf16 tensor cores).
// The TPU kernel walks a sequential KV grid axis with its statistics in VMEM
// scratch.  Here one block owns 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows each, and one producer warp that issues the
// TMA loads: Q once, then K and V tiles of 128 rows through a ring of two
// stages, heavy (late) query tiles of a head first under `causal`.  Q, K and V
// land with the 128-byte swizzle in boxes of 64 columns (one box for D <= 64,
// two for D <= 128); columns past D are zeros and never stored, rows past
// Sq or Skv are zeros (a 3-D tensor map per head) and are masked.
//
// Per KV tile a warpgroup computes S = Q K^T with wgmma m64n128k16 (both
// operands K-major in shared memory), runs the online softmax on the
// accumulator registers (a row's 128 scores sit in one quad of threads:
// max and sum over shuffles 1 and 2; exp2 of scores prescaled by
// log2(e) / sqrt(D)), and adds P V with wgmma m64nDk16 taking P from
// registers: the S accumulator's layout is the register A operand's, so P is
// the f32 scores rounded to bf16 pairs (as FlashAttention-3 does; the JAX
// body keeps P in f32, a relative change of at most 2^-9 per term), and V,
// row-major (Skv, D), is MN-major (transposed B).  l sums the f32 P.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128, BKV = 128, STAGES = 2;
constexpr int CONSUMERS = 2;                   // warpgroups, 64 query rows each
constexpr int NT = 128 * CONSUMERS + 32;       // and one producer warp
constexpr int BOX_Q = BQ * 128;                // bytes of one 64-column box of Q
constexpr int BOX_KV = BKV * 128;              // of K or V
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DMAX>
constexpr int smem_bytes() {
  return (DMAX / 64) * (BOX_Q + 2 * STAGES * BOX_KV) + (1 + 3 * STAGES) * 8 + 1024;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 128 of this warpgroup) = Q K^T over DMAX / 16 steps of 16 columns
template <int DMAX>
__device__ __forceinline__ void scores(float (&s)[64], uint32_t q0, uint32_t k0) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DMAX / 16; ++ks) {
    const uint32_t box = ks / 4, off = (ks % 4) * 32;
    wgmma_ss_m64n128k16<0>(s, smem_desc(q0 + box * BOX_Q + off, 16, 1024),
                           smem_desc(k0 + box * BOX_KV + off, 16, 1024), ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// acc (64 x DMAX) += P V: P from registers, V MN-major (the next 64 columns
// of D one box, LBO, further)
template <int DMAX>
__device__ __forceinline__ void add_pv(float (&acc)[DMAX / 2], const uint32_t (&p)[BKV / 16][4],
                                       uint32_t v0) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint64_t desc = smem_desc(v0 + kk * 16 * 128, BOX_KV, 1024);
    if constexpr (DMAX == 64)
      wgmma_rs_m64n64k16<1>(acc, p[kk], desc, 1);
    else
      wgmma_rs_m64n128k16<1>(acc, p[kk], desc, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

template <int DMAX>
__global__ void __launch_bounds__(NT, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int sq, int skv,
    int d, float scale_log2, int causal) {
  constexpr int NBOX = DMAX / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);              // NBOX boxes of BQ rows
  uint8_t* ks = qs + NBOX * BOX_Q;                // STAGES x NBOX boxes of BKV rows
  uint8_t* vs = ks + STAGES * NBOX * BOX_KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * NBOX * BOX_KV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  // heavy (late) query tiles of a head first under causal masking
  const int nq = (sq + BQ - 1) / BQ;
  const int head = blockIdx.x / nq;
  const int q0 = (nq - 1 - (int)(blockIdx.x % nq)) * BQ;
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int ntiles = (kv_end + BKV - 1) / BKV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: Q once, then K and V of tile t into stage t % STAGES
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, NBOX * BOX_Q);
      for (int b = 0; b < NBOX; ++b) tma_load_3d(qs + b * BOX_Q, &tq, q_full, 64 * b, q0, head);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&k_full[s], NBOX * BOX_KV);
        for (int b = 0; b < NBOX; ++b)
          tma_load_3d(ks + (s * NBOX + b) * BOX_KV, &tk, &k_full[s], 64 * b, t * BKV, head);
        mbar_arrive_expect_tx(&v_full[s], NBOX * BOX_KV);
        for (int b = 0; b < NBOX; ++b)
          tma_load_3d(vs + (s * NBOX + b) * BOX_KV, &tv, &v_full[s], 64 * b, t * BKV, head);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63; this thread's rows
  // r and r + 8, its columns 8j + 2(l%4) and the next
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t q_addr = smem_addr(qs) + wg * 64 * 128;
  float acc[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.0f, 0.0f};  // l: this thread's columns
  mbar_wait(q_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, k0 = t * BKV;
    const uint32_t parity = (t / STAGES) & 1;
    mbar_wait(&k_full[s], parity);
    float sc[64];
    scores<DMAX>(sc, q_addr, smem_addr(ks + s * NBOX * BOX_KV));

    // scale into the exp2 domain; mask where the tile crosses this
    // warpgroup's diagonal or the end of the keys
    const bool masked = (causal && k0 + BKV - 1 > q0 + wg * 64) || k0 + BKV > skv;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (masked) {
          const int col = k0 + 8 * j + cq + (e & 1), row = row0 + 8 * (e >> 1);
          if (col >= skv || (causal && col > row)) x = NEG_INF;
        }
        sc[4 * j + e] = x;
      }

    // online softmax, per row h of this thread's two
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      alpha[h] = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * j + 2 * h + e] - m_new);
          sc[4 * j + 2 * h + e] = p;
          sum = sum + p;
        }
      l_run[h] = l_run[h] * alpha[h] + sum;
    }
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] = acc[4 * j + e] * alpha[e >> 1];

    // P as the register A operand of each 16-column slice
    uint32_t p[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);

    mbar_wait(&v_full[s], parity);
    add_pv<DMAX>(acc, p, smem_addr(vs + s * NBOX * BOX_KV));
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // the quad's partial sums make the row's l; out = acc / l
  float l_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l = l + __shfl_xor_sync(0xffffffffu, l, 1);
    l = l + __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[h] = l;
  }
  __nv_bfloat16* oh = o + (long long)head * sq * d;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= d) continue;  // d % 8 == 0: col + 1 < d as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < sq)
        *reinterpret_cast<__nv_bfloat162*>(oh + (long long)row * d + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * h] / l_row[h], acc[4 * j + 2 * h + 1] / l_row[h]);
    }
  }
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv, int d,
           float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // (B, S, D) as 3-D maps, innermost first, so a box never reads into the
  // next head: rows past S come back as zeros
  const uint64_t q_dims[3] = {(uint64_t)d, (uint64_t)sq, (uint64_t)b};
  const uint64_t q_strides[2] = {(uint64_t)d * 2, (uint64_t)sq * d * 2};
  const uint64_t kv_dims[3] = {(uint64_t)d, (uint64_t)skv, (uint64_t)b};
  const uint64_t kv_strides[2] = {(uint64_t)d * 2, (uint64_t)skv * d * 2};
  const uint32_t q_box[3] = {64, BQ, 1}, kv_box[3] = {64, BKV, 1};
  cudaError_t err = bf16_tensor_map(&tq, q, 3, q_dims, q_strides, q_box);
  if (err == cudaSuccess) err = bf16_tensor_map(&tk, k, 3, kv_dims, kv_strides, kv_box);
  if (err == cudaSuccess) err = bf16_tensor_map(&tv, v, 3, kv_dims, kv_strides, kv_box);
  constexpr int smem = smem_bytes<DMAX>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_wgmma_kernel<DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned nq = (sq + BQ - 1) / BQ;
  flash_wgmma_kernel<DMAX><<<nq * (unsigned)b, NT, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, sq, skv, d, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, o: (b, sq, d); k, v: (b, skv, d); all bf16, 16-byte aligned; d a
// multiple of 8 and at most 128.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            int b, int sq, int skv, int d, float scale,
                                            int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64) return launch<64>(q, k, v, o, b, sq, skv, d, scale, causal, s);
  return launch<128>(q, k, v, o, b, sq, skv, d, scale, causal, s);
}
