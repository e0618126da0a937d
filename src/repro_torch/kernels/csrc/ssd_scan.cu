// Mamba2 SSD (state-space duality) chunked scan, hand-written for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/ssd.py:27 (_ssd_kernel).
// Per head h and chunk c of L steps (t0 = c * L), with s = cumsum(a_h * dt)
// inside the chunk:
//   y[l, p]   = sum_{m <= l} G[l, m] * exp(s_l - s_m) * dt_m * x[m, p]
//             + exp(s_l) * sum_n C[l, n] * state_c[p, n]
//   state_{c+1} = exp(s_{L-1}) * state_c + S_c,
//   S_c[p, n] = sum_l exp(s_{L-1} - s_l) * dt_l * x[l, p] * B[l, n]
// with G = C B^T, B and C shared across heads, state_0 = 0.
//
// The TPU kernel runs the chunk axis as a sequential grid with the whole
// (H, P, N) state in VMEM.  Here only the state's recurrence is sequential,
// and it is elementwise: everything else is a product local to one chunk and
// head.  So the op is four kernels, each with its own launcher (the split of
// Mamba2's own GPU implementation):
// 1. ssd_gram: G of every chunk, its lower triangle, zeros above (L x L f32
//    is 256 KB at L = 256, the same for every head, so it is written once).
// 2. ssd_chunk_state: per (chunk, head), s by a block-wide scan (written to
//    an (S, H) buffer) and S_c, a (N x L)(L x P) product, into the workspace
//    (S / L, H, N, P): each chunk's state transposed, P fastest, as the
//    read-out reads it.
// 3. ssd_state_pass: one thread per four (h, n, p), a float4, walks the
//    chunks in order, eight chunks' loads in flight together, and overwrites
//    S_c with state_c, the state entering chunk c, in place.
// 4. ssd_chunk_out: per (64-row tile of the chunk, chunk, head), both terms
//    of y into one accumulator: K = N for the read-out, K <= L for the
//    intra-chunk sum, whose weights G * exp(s_l - s_m) * dt_m are formed in
//    shared memory slice by slice for m <= l only (never above the
//    diagonal, where exp overflows).
//
// Bound: operations (f32, no tensor cores; the state pass is bound by
// bytes).  Kernels 2 and 4 are SIMT products: a block of 64 threads owns a
// 64 x 64 output tile, each thread an 8 x 8 tile of __fmaf_rn accumulators
// (rows ty*4 + i and 32 + ty*4 + i, columns tx*4 + j and 32 + tx*4 + j) fed
// per k by two float4s of each operand from a two-slot ring of 16-deep
// slices; x, B and the states arrive by cp.async where every row lies on 16
// bytes (f32 x, P and N multiples of 4), through registers otherwise.
// ssd_chunk_out's A (the weights, or exp(s_l) C) is formed by the threads,
// transposed into the slot: its reads for slice t + 1 are issued before
// slice t's products and formed after them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

// the gram kernel's ring: two slices of C's and B's rows
extern __shared__ __align__(16) float gram_smem[];
// the product kernels' ring, then their per-chunk vectors
extern __shared__ __align__(16) float ssd_smem[];

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

constexpr int GT = 32, GNT = 64;         // gram kernel: 32 x 32 output tile, threads
constexpr int GK = 64, GS = GK + 4;      // its ring slices: 64 of N, rows padded to 68
constexpr int CT = 64, CNT = 64;         // product kernels: CT x CT output tile, threads
constexpr int KS = 16, LD = CT + 4;      // a ring slice: KS rows of k, rows padded to 68
constexpr int SLICE = KS * LD;           // floats of one operand's slice
constexpr int RING = 2 * 2 * SLICE;      // two slots of (A, B)
constexpr int PNT = 256;                 // state pass: threads

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

// acc[i][j] += sum over the KS k of a slot: A[k][row i] * B[k][column j],
// both operands k-major (row k of LD floats); with W, B's row k is scaled by
// w[k] first.  Rows ty*4 + i and 32 + ty*4 + i, columns tx*4 + j and
// 32 + tx*4 + j: a warp reads four distinct float4s of A and eight of B.
template <bool W>
__device__ __forceinline__ void slot_product(const float* as, const float* bs, const float* w,
                                             float (&acc)[8][8], int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < KS; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * LD + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(as + kk * LD + 32 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * LD + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * LD + 32 + tx * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    if constexpr (W) {
      const float wk = w[kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bv[j] * wk;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
  }
}

// the thread's i-th row (j-th column) of the 64 x 64 tile
__device__ __forceinline__ int tile_at(int t, int i) { return (i < 4 ? 0 : 28) + t * 4 + i; }

// Slice [k0, k0 + KS) of chunk t0's steps into one slot: as[r][e] =
// B[t0 + k0 + r][n0 + e], bs[r][e] = x[t0 + k0 + r][h][p0 + e], zeros past
// step L, column N and P.  By cp.async: f32 x, N and P multiples of 4 and x,
// b on 16 bytes, so a quad lies wholly inside or outside.
template <typename T, bool ASYNC>
__device__ __forceinline__ void state_fill(float* as, float* bs, const T* x, const float* b,
                                           long long t0, int k0, int L, int h, int H, int P,
                                           int N, int n0, int p0) {
  if constexpr (ASYNC) {
    for (int q = threadIdx.x; q < 2 * KS * (CT / 4); q += CNT) {
      const bool is_x = q >= KS * (CT / 4);
      const int r = q / (CT / 4) % KS, e = q % (CT / 4) * 4, l = k0 + r;
      if (is_x) {
        const bool ok = l < L && p0 + e < P;
        cp_async16(bs + r * LD + e, ok ? x + ((t0 + l) * H + h) * P + p0 + e : x, ok);
      } else {
        const bool ok = l < L && n0 + e < N;
        cp_async16(as + r * LD + e, ok ? b + (t0 + l) * N + n0 + e : b, ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < 2 * KS * CT; i += CNT) {
      const bool is_x = i >= KS * CT;
      const int r = i / CT % KS, e = i % CT, l = k0 + r;
      if (is_x) {
        bs[r * LD + e] = l < L && p0 + e < P ? to_f32(x[((t0 + l) * H + h) * P + p0 + e]) : 0.0f;
      } else {
        as[r * LD + e] = l < L && n0 + e < N ? b[(t0 + l) * N + n0 + e] : 0.0f;
      }
    }
  }
}

size_t state_smem_bytes(int L) {
  const int lp = (L + KS - 1) / KS * KS;
  return sizeof(float) * ((size_t)RING + 2 * (size_t)lp + CNT);
}

// Block (n tile + n_tiles * p tile, chunk c, head h).  s: each thread sums a
// run of R consecutive steps in order, the runs' totals are scanned across
// the block (Hillis-Steele over CNT), and each run adds the total before it.
// The block of the first (n, p) tile writes s to sbuf.  Then
// st[c][h][n][p] = sum_l B[t0 + l][n] * (x[t0 + l][h][p] * w_l),
// w_l = exp(s_{L-1} - s_l) * dt_l (zero past L), over l in ring slices.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(CNT) ssd_chunk_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const float* __restrict__ b, float* __restrict__ st, float* __restrict__ sbuf,
    int H, int P, int N, int L) {
  const int n_tiles = (N + CT - 1) / CT;
  const int n0 = blockIdx.x % n_tiles * CT, p0 = blockIdx.x / n_tiles * CT;
  const int c = blockIdx.y, h = blockIdx.z;
  const long long t0 = (long long)c * L;
  const int lp = (L + KS - 1) / KS * KS;
  float* const s_s = ssd_smem + RING;   // lp: s
  float* const w_s = s_s + lp;          // lp: the weights, zero past L
  float* const tot = w_s + lp;          // CNT: the runs' totals
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;

  const float ah = a[h];
  const int R = (L + CNT - 1) / CNT;
  float run = 0.0f;
  for (int r = 0; r < R; ++r) {
    const int l = tid * R + r;
    if (l < L) {
      run = run + ah * dt[(t0 + l) * H + h];
      s_s[l] = run;
    }
  }
  tot[tid] = run;
  __syncthreads();
  for (int off = 1; off < CNT; off <<= 1) {
    const float v = tid >= off ? tot[tid - off] : 0.0f;
    __syncthreads();
    tot[tid] = tot[tid] + v;
    __syncthreads();
  }
  if (tid > 0) {
    const float before = tot[tid - 1];
    for (int r = 0; r < R; ++r) {
      const int l = tid * R + r;
      if (l < L) s_s[l] = before + s_s[l];
    }
  }
  __syncthreads();
  const float s_last = s_s[L - 1];
  for (int l = tid; l < lp; l += CNT) {
    float w = 0.0f;
    if (l < L) {
      const float sl = s_s[l];
      if (blockIdx.x == 0) sbuf[(t0 + l) * H + h] = sl;
      w = expf(s_last - sl) * dt[(t0 + l) * H + h];
    }
    w_s[l] = w;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int slices = lp / KS;
  state_fill<T, ASYNC>(ssd_smem, ssd_smem + SLICE, x, b, t0, 0, L, h, H, P, N, n0, p0);
  cp_async_commit();
  for (int t = 0; t < slices; ++t) {
    // slice t has landed (and w_s is written); every thread is done with
    // slice t - 1, whose slot slice t + 1 takes
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < slices) {
      float* nx = ssd_smem + (t + 1) % 2 * 2 * SLICE;
      state_fill<T, ASYNC>(nx, nx + SLICE, x, b, t0, (t + 1) * KS, L, h, H, P, N, n0, p0);
    }
    cp_async_commit();
    const float* as = ssd_smem + t % 2 * 2 * SLICE;
    slot_product<true>(as, as + SLICE, w_s + t * KS, acc, ty, tx);
  }
  float* stc = st + ((long long)c * H + h) * N * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + tile_at(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = p0 + tile_at(tx, j);
      if (n < N && p < P) stc[(long long)n * P + p] = acc[i][j];
    }
  }
}

// In place over st (S / L, H, N, P): st[c] becomes the state entering chunk
// c, state_0 = 0, state_{c+1} = exp(s of chunk c's last step) * state_c +
// S_c, one thread per V consecutive (h, n, p) (V = 4, a float4, where
// N * P % 4 == 0: the four share h).  The loads of PG chunks are issued
// together, before their stores.  The last chunk's contribution and s only
// make the state after the sequence, which nothing reads: they are not
// loaded, and the state entering the last chunk is stored after the loop.
constexpr int PG = 8;

template <int V>
__device__ __forceinline__ void state_store(float* p, const float (&state)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = float4{state[0], state[1], state[2], state[3]};
  } else {
    *p = state[0];
  }
}

template <int V>
__global__ void __launch_bounds__(PNT) ssd_state_pass_kernel(
    float* __restrict__ st, const float* __restrict__ sbuf, int n_chunks, int H, int NP, int L) {
  const long long per = (long long)H * NP;
  const long long e = ((long long)blockIdx.x * PNT + threadIdx.x) * V;
  if (e >= per) return;
  const int h = (int)(e / NP);
  const int last = n_chunks - 1;
  float state[V];
#pragma unroll
  for (int v = 0; v < V; ++v) state[v] = 0.0f;
  for (int c0 = 0; c0 < last; c0 += PG) {
    float val[PG][V], s_last[PG];
#pragma unroll
    for (int u = 0; u < PG; ++u) {
      const int c = c0 + u;
      if (c < last) {
        if constexpr (V == 4) {
          const float4 q = *reinterpret_cast<const float4*>(st + c * per + e);
          val[u][0] = q.x, val[u][1] = q.y, val[u][2] = q.z, val[u][3] = q.w;
        } else {
          val[u][0] = st[c * per + e];
        }
        s_last[u] = sbuf[((long long)c * L + L - 1) * H + h];
      }
    }
#pragma unroll
    for (int u = 0; u < PG; ++u) {
      const int c = c0 + u;
      if (c < last) {
        state_store<V>(st + c * per + e, state);
        const float decay = expf(s_last[u]);
#pragma unroll
        for (int v = 0; v < V; ++v) state[v] = decay * state[v] + val[u][v];
      }
    }
  }
  state_store<V>(st + last * per + e, state);
}

// Slice t of block (l0, p0)'s K, in two steps so that the reads of slice
// t + 1 are in flight while slice t is multiplied.  Slices [0, n_ro), the
// read-out: A[k][l] = exp(s_l) * C[t0 + l0 + l][k0 + k], B[k][p] =
// state_c[k0 + k][p0 + p] (the workspace after the state pass).  Then the
// intra-chunk sum, m = k0 + k: A[k][l] = G[l0 + l][m] * (exp(s_l - s_m) * dt_m)
// for m <= l0 + l only, else 0 (exp is never taken above the diagonal), and
// B[k][p] = x[t0 + m][h][p0 + p].  A thread reads A at one k, tid % KS, and
// AREGS rows, tid / KS + (CNT / KS) * u, and stores it transposed.
constexpr int AREGS = KS * CT / CNT;

struct OutSlice {
  float v[AREGS];   // C or G as read
  float sm, dtm;    // s_m and dt_m (the intra-chunk sum)
};

// out_load: A's inputs into registers; B into the slot by cp.async where f32
// x and P % 4 == 0 (a quad lies wholly inside or outside) and x and st start
// on 16 bytes, else through registers, stored at once.
template <typename T, bool ASYNC>
__device__ __forceinline__ void out_load(OutSlice& a, float* bs, int t, int n_ro, const T* x,
                                         const float* dt, const float* c, const float* g,
                                         const float* sbuf, const float* stc, long long t0, int l0,
                                         int p0, int L, int h, int H, int P, int N) {
  const bool ro = t < n_ro;
  const int k0 = (ro ? t : t - n_ro) * KS, k = k0 + threadIdx.x % KS;
  if (ro) {
#pragma unroll
    for (int u = 0; u < AREGS; ++u) {
      const int l = threadIdx.x / KS + CNT / KS * u;
      a.v[u] = l0 + l < L && k < N ? c[(t0 + l0 + l) * N + k] : 0.0f;
    }
  } else {
    const bool kok = k < L;
    a.sm = kok ? sbuf[(t0 + k) * H + h] : 0.0f;
    a.dtm = kok ? dt[(t0 + k) * H + h] : 0.0f;
#pragma unroll
    for (int u = 0; u < AREGS; ++u) {
      const int la = l0 + threadIdx.x / KS + CNT / KS * u;
      a.v[u] = la < L && k <= la ? g[(t0 + la) * L + k] : 0.0f;
    }
  }
  const int rows = ro ? N : L;
  if constexpr (ASYNC) {
    for (int q = threadIdx.x; q < KS * (CT / 4); q += CNT) {
      const int r = q / (CT / 4), e = q % (CT / 4) * 4;
      const bool ok = k0 + r < rows && p0 + e < P;
      const float* src = ro ? stc + (long long)(k0 + r) * P + p0 + e
                            : reinterpret_cast<const float*>(x) + ((t0 + k0 + r) * H + h) * P + p0 + e;
      cp_async16(bs + r * LD + e, ok ? src : stc, ok);
    }
  } else {
    for (int i = threadIdx.x; i < KS * CT; i += CNT) {
      const int r = i / CT, e = i % CT;
      float v = 0.0f;
      if (k0 + r < rows && p0 + e < P)
        v = ro ? stc[(long long)(k0 + r) * P + p0 + e] : to_f32(x[((t0 + k0 + r) * H + h) * P + p0 + e]);
      bs[r * LD + e] = v;
    }
  }
}

// out_form: A formed from out_load's registers and stored transposed.
__device__ __forceinline__ void out_form(float* as, const OutSlice& a, int t, int n_ro,
                                         const float* sl_s, const float* es_s, int l0, int L) {
  const bool ro = t < n_ro;
  const int kk = threadIdx.x % KS, k = (ro ? t : t - n_ro) * KS + kk;
#pragma unroll
  for (int u = 0; u < AREGS; ++u) {
    const int l = threadIdx.x / KS + CNT / KS * u;
    float w;
    if (ro) {
      w = es_s[l] * a.v[u];
    } else {
      const int la = l0 + l;
      w = la < L && k <= la ? a.v[u] * (expf(sl_s[l] - a.sm) * a.dtm) : 0.0f;
    }
    as[kk * LD + l] = w;
  }
}

// Block (head h, chunk c, p tile + p_tiles * row tile index): the row tiles
// run heaviest first (the last rows of a chunk sum the most steps).  The
// read-out is skipped for chunk 0, whose entering state is zero.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(CNT) ssd_chunk_out_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ c,
    const float* __restrict__ g, const float* __restrict__ sbuf, const float* __restrict__ st,
    T* __restrict__ y, int H, int P, int N, int L) {
  const int h = blockIdx.x, ci = blockIdx.y;
  const int p_tiles = (P + CT - 1) / CT, r_tiles = (L + CT - 1) / CT;
  const int p0 = blockIdx.z % p_tiles * CT;
  const int l0 = (r_tiles - 1 - (int)blockIdx.z / p_tiles) * CT;
  const long long t0 = (long long)ci * L;
  const float* stc = st + ((long long)ci * H + h) * N * P;
  float* const sl_s = ssd_smem + RING;  // CT: s of the tile's rows
  float* const es_s = sl_s + CT;        // CT: exp(s) of the tile's rows
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  for (int r = tid; r < CT; r += CNT) {
    const float s = l0 + r < L ? sbuf[(t0 + l0 + r) * H + h] : 0.0f;
    sl_s[r] = s;
    es_s[r] = expf(s);
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int n_ro = ci == 0 ? 0 : (N + KS - 1) / KS;
  const int slices = n_ro + (min(l0 + CT, L) + KS - 1) / KS;
  OutSlice a;
  out_load<T, ASYNC>(a, ssd_smem + SLICE, 0, n_ro, x, dt, c, g, sbuf, stc, t0, l0, p0, L, h, H,
                     P, N);
  cp_async_commit();
  __syncthreads();  // sl_s and es_s are written
  out_form(ssd_smem, a, 0, n_ro, sl_s, es_s, l0, L);
  for (int t = 0; t < slices; ++t) {
    // slice t has landed and is formed; every thread is done with slice
    // t - 1, whose slot slice t + 1 takes
    cp_async_wait<0>();
    __syncthreads();
    float* nx = ssd_smem + (t + 1) % 2 * 2 * SLICE;
    if (t + 1 < slices)
      out_load<T, ASYNC>(a, nx + SLICE, t + 1, n_ro, x, dt, c, g, sbuf, stc, t0, l0, p0, L, h, H,
                         P, N);
    cp_async_commit();
    const float* as = ssd_smem + t % 2 * 2 * SLICE;
    slot_product<false>(as, as + SLICE, nullptr, acc, ty, tx);
    if (t + 1 < slices) out_form(nx, a, t + 1, n_ro, sl_s, es_s, l0, L);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = l0 + tile_at(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = p0 + tile_at(tx, j);
      if (l < L && p < P) store(y + ((t0 + l) * H + h) * P + p, acc[i][j]);
    }
  }
}

template <typename T, bool ASYNC>
int launch_state(const void* x, const void* dt, const void* a, const void* b, void* st,
                 void* sbuf, int s_len, int h, int p, int n, int L, cudaStream_t s) {
  const size_t smem = state_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<T, ASYNC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + CT - 1) / CT * ((p + CT - 1) / CT), s_len / L, h);
  ssd_chunk_state_kernel<T, ASYNC><<<grid, CNT, smem, s>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)b, (float*)st, (float*)sbuf,
      h, p, n, L);
  return (int)cudaGetLastError();
}

template <typename T, bool ASYNC>
int launch_out(const void* x, const void* dt, const void* c, const void* g, const void* sbuf,
               const void* st, void* y, int s_len, int h, int p, int n, int L, cudaStream_t s) {
  const int smem = (RING + 2 * CT) * (int)sizeof(float);
  const dim3 grid(h, s_len / L, (p + CT - 1) / CT * ((L + CT - 1) / CT));
  ssd_chunk_out_kernel<T, ASYNC><<<grid, CNT, smem, s>>>(
      (const T*)x, (const float*)dt, (const float*)c, (const float*)g, (const float*)sbuf,
      (const float*)st, (T*)y, h, p, n, L);
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

// x: (s_len, h, p) of `dtype` (0 float32, 1 bfloat16); dt: (s_len, h), a:
// (h,), b: (s_len, n), all float32; L divides s_len.  Writes st: (s_len / L,
// h, n, p) float32, each chunk's own state contribution transposed, and
// sbuf: (s_len, h) float32, s.  One launch on `stream`.
extern "C" int ssd_chunk_state_launch(const void* x, const void* dt, const void* a, const void* b,
                                      void* st, void* sbuf, int s_len, int h, int p, int n, int L,
                                      int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_state<__nv_bfloat16, false>(x, dt, a, b, st, sbuf, s_len, h, p, n, L, s);
  if (p % 4 == 0 && n % 4 == 0 && ((uintptr_t)x | (uintptr_t)b) % 16 == 0)
    return launch_state<float, true>(x, dt, a, b, st, sbuf, s_len, h, p, n, L, s);
  return launch_state<float, false>(x, dt, a, b, st, sbuf, s_len, h, p, n, L, s);
}

// st: ssd_chunk_state_launch's st, overwritten in place with the state
// entering each chunk; sbuf its sbuf.  One launch on `stream`.
extern "C" int ssd_state_pass_launch(void* st, const void* sbuf, int s_len, int h, int p, int n,
                                     int L, void* stream) {
  const long long per = (long long)h * n * p;
  cudaStream_t s = (cudaStream_t)stream;
  if (n * p % 4 == 0) {
    ssd_state_pass_kernel<4><<<(unsigned)((per / 4 + PNT - 1) / PNT), PNT, 0, s>>>(
        (float*)st, (const float*)sbuf, s_len / L, h, n * p, L);
  } else {
    ssd_state_pass_kernel<1><<<(unsigned)((per + PNT - 1) / PNT), PNT, 0, s>>>(
        (float*)st, (const float*)sbuf, s_len / L, h, n * p, L);
  }
  return (int)cudaGetLastError();
}

// x, y: (s_len, h, p) of `dtype`; dt: (s_len, h), c: (s_len, n), g:
// ssd_gram_launch's output, sbuf and st: the outputs of ssd_chunk_state_launch
// after ssd_state_pass_launch, all float32.  One launch on `stream`.
extern "C" int ssd_chunk_out_launch(const void* x, const void* dt, const void* c, const void* g,
                                    const void* sbuf, const void* st, void* y, int s_len, int h,
                                    int p, int n, int L, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_out<__nv_bfloat16, false>(x, dt, c, g, sbuf, st, y, s_len, h, p, n, L, s);
  if (p % 4 == 0 && ((uintptr_t)x | (uintptr_t)st) % 16 == 0)
    return launch_out<float, true>(x, dt, c, g, sbuf, st, y, s_len, h, p, n, L, s);
  return launch_out<float, false>(x, dt, c, g, sbuf, st, y, s_len, h, p, n, L, s);
}
