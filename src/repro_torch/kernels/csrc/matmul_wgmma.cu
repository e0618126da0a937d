// bf16 (M, K) @ (K, N) on Hopper's tensor cores, hand-written for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/matmul.py:22
// (_matmul_kernel) for bf16 operands: f32 accumulation, the output rounded
// once to bf16 (round to nearest even).  The f32 calls, and bf16 calls whose
// K or N is not a multiple of 8 or whose operands are not 16-byte aligned,
// stay on the SIMT kernel (matmul.cu): TMA takes no other strides.
//
// Bound: operations (2 M N K on the bf16 tensor cores, 989 TFLOP/s at the
// MLP shapes).  The TPU kernel carries a (bm, bn) f32 block in VMEM across a
// sequential K grid axis; here a block owns a 128 x 256 output tile and
// loops over K in steps of 64 (one 128-byte swizzle row of bf16) through a
// ring of 4 stages of 48 KB in shared memory.  One producer warp issues the
// TMA loads of each stage: A as one 128 x 64 box, K-major; B, row-major
// (K, N) and so MN-major for wgmma, as four 64 (N) x 64 (K) boxes.  Two
// consumer warpgroups each take 64 rows of the tile and issue 4 wgmma
// m64n256k16 per stage (B transposed), 128 f32 accumulators a thread,
// keeping one stage's products in flight while the next stage's are issued.
// Full and empty mbarriers per stage hand the stages back and forth.  TMA
// fills boxes past the edges with zeros, so a K tail adds +0 and ragged M
// and N edges are masked at the store.  One block per output tile (352 at
// the MLP shapes on 132 SMs): a persistent tile scheduler is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                   // warpgroups, 64 rows of the tile each
constexpr int NT = 128 * CONSUMERS + 32;       // and one producer warp
constexpr int A_BYTES = BM * BK * 2;           // 16 KB: rows of 64 K (128 bytes)
constexpr int B_BOX_BYTES = BK * 64 * 2;       // 8 KB: 64 K rows of 64 N
constexpr int B_BYTES = (BN / 64) * B_BOX_BYTES;
constexpr int SMEM_BYTES = STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8 + 1024;

__global__ void __launch_bounds__(NT, 1) matmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align1024(smem_raw);         // STAGES A tiles
  uint8_t* sb = sa + STAGES * A_BYTES;       // STAGES B tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (k + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: stage s takes k tiles s, s + STAGES, ...
    if (lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
        tma_load_2d(sa + s * A_BYTES, &ta, &full[s], kt * BK, m0);
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(sb + s * B_BYTES + b * B_BOX_BYTES, &tb, &full[s], n0 + 64 * b, kt * BK);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63 of the tile
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t a0 = smem_addr(sa + s * A_BYTES) + wg * 64 * 128;
    const uint32_t b0 = smem_addr(sb + s * B_BYTES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A: K-major, 16 K = 32 bytes along the row; B: MN-major, 16 K rows of
      // 128 bytes, each next 64 N one box (LBO) further
      wgmma_ss_m64n256k16<1>(acc, smem_desc(a0 + ks * 32, 16, 1024),
                             smem_desc(b0 + ks * 16 * 128, B_BOX_BYTES, 1024), 1);
    }
    wgmma_commit();
    fence_regs(acc);
    // the previous stage's products are done: hand its buffers back
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: rows r and r + 8, columns 8j + 2(l%4) and the next
  const int r = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= n) continue;  // n % 8 == 0: col + 1 < n as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row < m)
        *reinterpret_cast<__nv_bfloat162*>(c + (long long)row * n + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a: (m, k), b: (k, n), c: (m, n), row-major bf16; k and n multiples of 8,
// a and b 16-byte aligned (TMA's rule for bases and row strides).
extern "C" int matmul_wgmma_launch(const void* a, const void* b, void* c, int m, int n, int k,
                                   void* stream) {
  CUtensorMap ta, tb;
  const uint64_t a_dims[2] = {(uint64_t)k, (uint64_t)m}, a_strides[1] = {(uint64_t)k * 2};
  const uint32_t a_box[2] = {BK, BM};
  const uint64_t b_dims[2] = {(uint64_t)n, (uint64_t)k}, b_strides[1] = {(uint64_t)n * 2};
  const uint32_t b_box[2] = {64, BK};
  cudaError_t err = bf16_tensor_map(&ta, a, 2, a_dims, a_strides, a_box);
  if (err == cudaSuccess) err = bf16_tensor_map(&tb, b, 2, b_dims, b_strides, b_box);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_wgmma_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      ta, tb, (__nv_bfloat16*)c, m, n, k);
  return (int)cudaGetLastError();
}
