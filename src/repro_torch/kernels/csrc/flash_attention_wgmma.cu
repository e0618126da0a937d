// bf16 blockwise (flash) attention on Hopper's tensor cores, hand-written
// for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:29
// (_flash_kernel) for bf16 inputs with head dims up to 256 that are
// multiples of 8; f32 and other head dims stay on the SIMT kernel
// (flash_attention.cu).  q: (B, Sq, D), k and v: (B, Skv, D) with batch x
// heads folded into B; scores scaled by 1/sqrt(D); query row r stands at
// position q_offset + r (q_offset + Sq <= Skv: a rank's rows of a sequence
// split over ranks; 0 with Sq == Skv for self-attention); under `causal`
// column c of row r is kept when c <= q_offset + r and set to -1e30
// otherwise; KV tiles wholly above the diagonal are skipped.  The running max m and sum l and
// the output accumulator are f32; the output is acc / l rounded once to bf16.
//
// Bound: operations (4 D flops per kept score on the bf16 tensor cores).
// The TPU kernel walks a sequential KV grid axis with its statistics in VMEM
// scratch.  Here one block owns BQ query rows of one (batch, head): a
// consumer warpgroup for each 64 of them, and one producer warp that issues
// the TMA loads: Q once, then K and V tiles of BKV rows through a ring of
// two stages, heavy (late) query tiles of a head first under `causal`.  Q, K
// and V land with the 128-byte swizzle in boxes of 64 columns (DMAX / 64
// boxes); columns past D are zeros and never stored, rows past Sq or Skv
// are zeros (a 3-D tensor map per head) and are masked.
//
// Per KV tile a warpgroup computes S = Q K^T with wgmma m64nBKVk16 (both
// operands K-major in shared memory), runs the online softmax on the
// accumulator registers (a row's BKV scores sit in one quad of threads:
// max and sum over shuffles 1 and 2; exp2 of scores prescaled by
// log2(e) / sqrt(D)), and adds P V with wgmma m64nDMAXk16 taking P from
// registers: the S accumulator's layout is the register A operand's, so P is
// the f32 scores rounded to bf16 pairs (as FlashAttention-3 does; the JAX
// body keeps P in f32, a relative change of at most 2^-9 per term), and V,
// row-major (Skv, D), is MN-major (transposed B).  l sums the f32 P.
//
// The tile (Tile<DMAX>) is settled by three limits of the card:
// - Registers.  O is DMAX / 2 f32 a thread and S BKV / 2.  Up to D 128,
//   128-row KV tiles and two consumer warpgroups (288 threads).  At D 256,
//   O alone is 128, so KV tiles are 64 rows (S 32 registers, P 16; P V one
//   m64n256k16 a 16-row step of V) and a block has one consumer
//   warpgroup: 160 threads may take 255 registers.  With two consumer
//   warpgroups at D 256 ptxas kept too few registers a thread, spilled and
//   serialized the wgmma (C7512), however setmaxnreg split the registers
//   between producer and consumers.
// - Shared memory.  smem_bytes<DMAX>(), checked against the 227 KB a block
//   may use by a host compiler: at D 256 Q is 64 rows x 512 B = 32 KB and
//   two stages of 64-row K and V 128 KB, one block an SM.
// - Filling the card.  128-row query tiles would give gemma3-1b's 4 heads
//   of 2048 rows at D 256 only 64 blocks for 132 SMs; 64-row tiles give
//   128, each a busy warpgroup.

#include <stdint.h>

#include "sm90.cuh"

// Tiles and shared-memory layouts: plain constexpr, so a host compiler
// checks them.
namespace fa_wgmma {

constexpr int SMEM_PER_BLOCK = 232448;    // the H100's 227 KB a block may use
constexpr int STAGES = 2;

template <int DMAX>
struct Tile {
  static constexpr int BQ = DMAX <= 128 ? 128 : 64;   // query rows a block
  static constexpr int BKV = BQ;                      // KV rows a tile
  static constexpr int CONSUMERS = BQ / 64;           // warpgroups, 64 query rows each
  static constexpr int NT = 128 * CONSUMERS + 32;     // and one producer warp
  static constexpr int BOX_Q = BQ * 128;              // bytes of one 64-column box of Q
  static constexpr int BOX_KV = BKV * 128;            // of K or V
};

template <int DMAX>
constexpr int smem_bytes() {
  using T = Tile<DMAX>;
  return (DMAX / 64) * (T::BOX_Q + 2 * STAGES * T::BOX_KV) + (1 + 3 * STAGES) * 8 + 1024;
}

static_assert(smem_bytes<128>() <= SMEM_PER_BLOCK, "D 128 shared memory");
static_assert(smem_bytes<256>() <= SMEM_PER_BLOCK, "D 256 shared memory");

template <int DMAX>
void describe(int* out) {
  using T = Tile<DMAX>;
  out[0] = DMAX;
  out[1] = T::BQ;
  out[2] = T::BKV;
  out[3] = T::CONSUMERS;
  out[4] = T::NT;
  out[5] = smem_bytes<DMAX>();
}

}  // namespace fa_wgmma

// the instantiation a head dim of d (1 to 256) launches: out = {DMAX, BQ,
// BKV, CONSUMERS, threads a block, shared bytes a block}
extern "C" int flash_attention_wgmma_tile(int d, int* out) {
  if (d < 1 || d > 256) return 1;  // cudaErrorInvalidValue
  if (d <= 64) fa_wgmma::describe<64>(out);
  else if (d <= 128) fa_wgmma::describe<128>(out);
  else fa_wgmma::describe<256>(out);
  return 0;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using namespace sm90;
using namespace fa_wgmma;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x BKV of this warpgroup) = Q K^T over DMAX / 16 steps of 16 columns
template <int DMAX>
__device__ __forceinline__ void scores(float (&s)[Tile<DMAX>::BKV / 2], uint32_t q0, uint32_t k0) {
  using T = Tile<DMAX>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DMAX / 16; ++ks) {
    const uint32_t box = ks / 4, off = (ks % 4) * 32;
    const uint64_t qd = smem_desc(q0 + box * T::BOX_Q + off, 16, 1024);
    const uint64_t kd = smem_desc(k0 + box * T::BOX_KV + off, 16, 1024);
    if constexpr (T::BKV == 128)
      wgmma_ss_m64n128k16<0>(s, qd, kd, ks > 0);
    else
      wgmma_ss_m64n64k16<0>(s, qd, kd, ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// acc (64 x DMAX) += P V: P from registers, V MN-major (the next 64 columns
// of D one box, LBO, further)
template <int DMAX>
__device__ __forceinline__ void add_pv(float (&acc)[DMAX / 2],
                                       const uint32_t (&p)[Tile<DMAX>::BKV / 16][4], uint32_t v0) {
  using T = Tile<DMAX>;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BKV / 16; ++kk) {
    const uint64_t desc = smem_desc(v0 + kk * 16 * 128, T::BOX_KV, 1024);
    if constexpr (DMAX == 64)
      wgmma_rs_m64n64k16<1>(acc, p[kk], desc, 1);
    else if constexpr (DMAX == 128)
      wgmma_rs_m64n128k16<1>(acc, p[kk], desc, 1);
    else
      wgmma_rs_m64n256k16<1>(acc, p[kk], desc, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

template <int DMAX>
__global__ void __launch_bounds__(Tile<DMAX>::NT, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int sq, int skv,
    int d, float scale_log2, int causal, int q_offset) {
  using T = Tile<DMAX>;
  constexpr int BQ = T::BQ, BKV = T::BKV, CONSUMERS = T::CONSUMERS;
  constexpr int BOX_Q = T::BOX_Q, BOX_KV = T::BOX_KV;
  constexpr int NBOX = DMAX / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);              // NBOX boxes of BQ rows
  uint8_t* ks = qs + NBOX * BOX_Q;                // STAGES x NBOX boxes of BKV rows
  uint8_t* vs = ks + STAGES * NBOX * BOX_KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * NBOX * BOX_KV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  // heavy (late) query tiles of a head first under causal masking: tile
  // q0's KV tiles end at q_offset + q0 + BQ
  const int nq = (sq + BQ - 1) / BQ;
  const int head = blockIdx.x / nq;
  const int q0 = (nq - 1 - (int)(blockIdx.x % nq)) * BQ;
  const int kv_end = causal ? min(skv, q_offset + q0 + BQ) : skv;
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
  // r and r + 8 (at positions q_offset + r and the next), its columns
  // 8j + 2(l%4) and the next
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int pos0 = q_offset + row0;
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
    float sc[BKV / 2];
    scores<DMAX>(sc, q_addr, smem_addr(ks + s * NBOX * BOX_KV));

    // scale into the exp2 domain; where the tile crosses this warpgroup's
    // diagonal or the end of the keys, column k0 + cq + c of row h is kept
    // while c is below lim[h]: one bound a row, no column index formed
    const bool masked = (causal && k0 + BKV - 1 > q_offset + q0 + wg * 64) || k0 + BKV > skv;
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      lim[h] = (causal ? min(skv, pos0 + 8 * h + 1) : skv) - k0 - cq;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (masked && 8 * j + (e & 1) >= lim[e >> 1]) x = NEG_INF;
        sc[4 * j + e] = x;
      }

    // online softmax, per row h of this thread's two
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      alpha[h] = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
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
           float scale, int causal, int q_offset, cudaStream_t stream) {
  using T = Tile<DMAX>;
  CUtensorMap tq, tk, tv;
  // (B, S, D) as 3-D maps, innermost first, so a box never reads into the
  // next head: rows past S come back as zeros
  const uint64_t q_dims[3] = {(uint64_t)d, (uint64_t)sq, (uint64_t)b};
  const uint64_t q_strides[2] = {(uint64_t)d * 2, (uint64_t)sq * d * 2};
  const uint64_t kv_dims[3] = {(uint64_t)d, (uint64_t)skv, (uint64_t)b};
  const uint64_t kv_strides[2] = {(uint64_t)d * 2, (uint64_t)skv * d * 2};
  const uint32_t q_box[3] = {64, T::BQ, 1}, kv_box[3] = {64, T::BKV, 1};
  cudaError_t err = bf16_tensor_map(&tq, q, 3, q_dims, q_strides, q_box);
  if (err == cudaSuccess) err = bf16_tensor_map(&tk, k, 3, kv_dims, kv_strides, kv_box);
  if (err == cudaSuccess) err = bf16_tensor_map(&tv, v, 3, kv_dims, kv_strides, kv_box);
  constexpr int smem = smem_bytes<DMAX>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_wgmma_kernel<DMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned nq = (sq + T::BQ - 1) / T::BQ;
  flash_wgmma_kernel<DMAX><<<nq * (unsigned)b, T::NT, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, sq, skv, d, scale * LOG2E, causal, q_offset);
  return (int)cudaGetLastError();
}

template <int DMAX>
int occupancy(int* blocks_per_sm) {
  constexpr int smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_wgmma_kernel<DMAX>,
                                                        Tile<DMAX>::NT, smem);
  return (int)err;
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, o: (b, sq, d); k, v: (b, skv, d); all bf16, 16-byte aligned; d a
// multiple of 8 and at most 256; query row r at position q_offset + r.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            int b, int sq, int skv, int d, float scale,
                                            int causal, int q_offset, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64) return launch<64>(q, k, v, o, b, sq, skv, d, scale, causal, q_offset, s);
  if (d <= 128) return launch<128>(q, k, v, o, b, sq, skv, d, scale, causal, q_offset, s);
  if (d <= 256) return launch<256>(q, k, v, o, b, sq, skv, d, scale, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

// the blocks an SM of the current card holds at once of the instantiation
// a head dim of d launches
extern "C" int flash_attention_wgmma_occupancy(int d, int* blocks_per_sm) {
  if (d <= 64) return occupancy<64>(blocks_per_sm);
  if (d <= 128) return occupancy<128>(blocks_per_sm);
  return occupancy<256>(blocks_per_sm);
}
#endif  // __CUDACC__
