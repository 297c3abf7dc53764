// Grouped LoRA forward for multi-tenant decode, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lora_grouped.py: lora_grouped
// (_grouped_fwd_kernel), in its serving form: one shared base (Ew = 1),
// float base weights (quant "none").
//
//   y[m] = x[m] @ W0 + s * (x[m] @ A[g]) @ B[g],   g = gid[m / bm]
//
//   x [M, K] (M % bm == 0), W0 [K, N] shared, A [R, K, r], B [R, r, N],
//   gid int32 [M / bm] on the device, y [M, N] in x's type; f32 sums.
//
// What bounds it. Decode multiplies a handful of rows (M = 8 slots) by the
// whole frozen base, so the kernel is bound by reading W0 from device
// memory: about 2·M FLOPs per W0 element, far below the ~295 FLOP/byte the
// H100 needs before its arithmetic is the limit. For qwen2.5-0.5b one decode
// step reads ~716 MB of W0 through this kernel (24 layers x 14.9 M weights
// of q,k,v,o,gate,up,down in bf16) plus ~272 MB of tied unembedding outside
// it: ~988 MB, a bound of ~0.30 ms per step at 3.35 TB/s.
//
// Design (simple and right first):
// * A cluster of CS = 8 blocks owns BN = 64 output columns and RB = 8 rows;
//   its blocks split K eight ways. Inside a block the 8 warps interleave over
//   the block's K rows; a lane owns 2 columns, so a warp's W0 loads of one K
//   row are contiguous (coalesced). Each warp issues the loads of 8 K rows
//   before it uses them, so enough bytes are in flight to stream W0: the
//   narrow projections (N = 128, 896) still get 16-112 blocks.
// * All rows of the block share each W0 element it loads, so at decode
//   (M <= 8) W0 is read from device memory once. The Pallas grid re-read W0
//   once per row tile; with M > 8 this kernel re-reads it once per 8 rows.
// * h = x @ A[g] ([rows, r], r <= 16) is summed in the same K loop as
//   x @ W0, as the TPU kernel does: each block sums its K range, and the
//   cluster adds the eight partial sums through distributed shared memory.
//   h never goes to device memory (the MeSP point that the TPU kernel kept
//   in VMEM); it is rounded to x's type before it meets B, as there.
// * The partial x @ W0 sums are added the same way: each block of the
//   cluster finishes BN / CS of the columns, in a fixed order of blocks, so
//   results do not change from run to run (no atomics).
// * Each block reads its rows' gid from device memory, so re-routing
//   tenants between steps changes data, not the launch. A gid outside
//   [0, R) writes NaN to its rows rather than reading out of bounds.
// * The ragged K and N edges are masked in the kernel; nothing is padded.
// * At decode every block is short, so its time is a chain of memory round
//   trips (gid, x, W0 and A, B). Each stage issues all of its loads, into
//   registers of the raw type, before it converts or uses one, so a stage
//   costs one round trip, not one per load.
// Not yet: tensor cores (wgmma), TMA pipelining. Those are for a later
// change.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CPL = 2;              // output columns per lane
constexpr int BN = 32 * CPL;        // output columns per cluster
constexpr int RB = 8;               // rows per cluster
constexpr int KS = 256;             // K slab staged in shared memory
constexpr int RMAX = 16;            // largest LoRA rank supported
constexpr int CS = 8;               // blocks per cluster (K split)
constexpr int HP = RB * RMAX / 32;  // (row, rank) sums of h per lane
constexpr int U = 8;                // K rows loaded ahead per warp
constexpr int CN = BN / CS;         // columns each block finishes
constexpr int SPT = RB * KS / THREADS;  // x values staged per thread

template <typename T>
__global__ void __cluster_dims__(1, 1, CS) __launch_bounds__(THREADS)
    lora_grouped_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ a, const T* __restrict__ b,
                            const int* __restrict__ gid, T* __restrict__ y,
                            int M, int K, int N, int R, int r, int bm,
                            float scale) {
  __shared__ float xs[RB][KS];
  __shared__ float red[WARPS][RB][BN];
  __shared__ float hred[WARPS][RB * RMAX];
  __shared__ float part[RB][BN];       // this block's x@W0 partial
  __shared__ float hpart[RB * RMAX];   // this block's x@A partial
  __shared__ float hs[RB][RMAX];       // h over all of K, rounded to T
  __shared__ int gs[RB];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * RB;
  const int rows = min(RB, M - m0);
  const int n0 = blockIdx.x * BN;

  if (threadIdx.x < RB) {
    int g = -1;
    if (threadIdx.x < rows) {
      g = gid[(m0 + threadIdx.x) / bm];
      if (g < 0 || g >= R) g = -1;
    }
    gs[threadIdx.x] = g;
  }
  __syncthreads();

  // the (row, rank) pairs of h this lane sums: p = lane + 32 q
  int hi[HP];
  bool hon[HP];
  const T* hp[HP];
#pragma unroll
  for (int q = 0; q < HP; ++q) {
    const int p = lane + 32 * q, i = p / RMAX, j = p % RMAX;
    hi[q] = i;
    hon[q] = i < rows && j < r && gs[i] >= 0;
    hp[q] = hon[q] ? a + (size_t)gs[i] * K * r + j : a;
  }

  float acc[RB][CPL], hacc[HP];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
#pragma unroll
  for (int q = 0; q < HP; ++q) hacc[q] = 0.f;

  const int kc = (K + CS - 1) / CS;
  const int kb = rank * kc, ke = min(K, kb + kc);
  for (int k0 = kb; k0 < ke; k0 += KS) {
    const int len = min(KS, ke - k0);
    // all of a thread's loads are issued before the first store that
    // waits on one, so staging costs one memory round trip, not SPT
    T xv[SPT];
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int idx = threadIdx.x + s * THREADS, i = idx / KS, kk = idx % KS;
      xv[s] = load_or_zero(x + (size_t)(m0 + i) * K + k0 + kk,
                           i < rows && kk < len);
    }
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int idx = threadIdx.x + s * THREADS;
      xs[idx / KS][idx % KS] = to_f(xv[s]);
    }
    __syncthreads();
    for (int kk0 = warp; kk0 < len; kk0 += WARPS * U) {
      // raw loads first, converted only where they are used: a conversion
      // next to its load would stall the warp on every load in turn
      T wv[U][CPL], av[U][HP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = kk0 + u * WARPS;
        const bool ok = kk < len;
        const size_t k = (size_t)(k0 + kk);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int n = n0 + c * 32 + lane;
          wv[u][c] = load_or_zero(w + k * N + n, ok && n < N);
        }
#pragma unroll
        for (int q = 0; q < HP; ++q)
          av[u][q] = load_or_zero(hp[q] + k * r, ok && hon[q]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = kk0 + u * WARPS;
        if (kk < len) {
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const float xv = xs[i][kk];
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[i][c] += xv * to_f(wv[u][c]);
          }
#pragma unroll
          for (int q = 0; q < HP; ++q)
            hacc[q] += xs[hi[q]][kk] * to_f(av[u][q]);
        }
      }
    }
    __syncthreads();
  }

  // this block's partials: sum over its warps
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c) red[warp][i][c * 32 + lane] = acc[i][c];
#pragma unroll
  for (int q = 0; q < HP; ++q) hred[warp][lane + 32 * q] = hacc[q];
  __syncthreads();
  for (int idx = threadIdx.x; idx < RB * BN; idx += THREADS) {
    const int i = idx / BN, col = idx % BN;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += red[wi][i][col];
    part[i][col] = s;
  }
  if (threadIdx.x < RB * RMAX) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += hred[wi][threadIdx.x];
    hpart[threadIdx.x] = s;
  }
  cluster.sync();

  // across the cluster: every block gets all of h; block `rank` finishes
  // columns [rank * CN, (rank + 1) * CN) of the cluster's BN
  if (threadIdx.x < RB * RMAX) {
    float v[CS], s = 0.f;
#pragma unroll
    for (int c = 0; c < CS; ++c)
      v[c] = cluster.map_shared_rank(hpart, c)[threadIdx.x];
#pragma unroll
    for (int c = 0; c < CS; ++c) s += v[c];
    hs[threadIdx.x / RMAX][threadIdx.x % RMAX] = round_to<T>(s);
  }
  float tot = 0.f;
  const int oi = threadIdx.x / CN, ocol = rank * CN + threadIdx.x % CN;
  if (threadIdx.x < RB * CN) {
    float v[CS];
#pragma unroll
    for (int c = 0; c < CS; ++c)
      v[c] = cluster.map_shared_rank(&part[0][0], c)[oi * BN + ocol];
#pragma unroll
    for (int c = 0; c < CS; ++c) tot += v[c];
  }
  __syncthreads();
  const int n = n0 + ocol;
  if (threadIdx.x < RB * CN && oi < rows && n < N) {
    const int g = gs[oi];
    float out = NAN;
    if (g >= 0) {
      const T* bg = b + (size_t)g * r * N + n;
      T bv[RMAX];
#pragma unroll
      for (int j = 0; j < RMAX; ++j)
        bv[j] = load_or_zero(bg + (size_t)j * N, j < r);
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < RMAX; ++j) d += hs[oi][j] * to_f(bv[j]);
      out = tot + scale * d;
    }
    y[(size_t)(m0 + oi) * N + n] = from_f<T>(out);
  }
  // keep this block's shared memory alive until the cluster has read it
  cluster.sync();
}

template <typename T>
void launch(const void* x, const void* w, const void* a, const void* b,
            const void* gid, void* y, int M, int K, int N, int R, int r,
            int bm, float scale, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + RB - 1) / RB, CS);
  lora_grouped_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int*>(gid), static_cast<T*>(y), M, K, N, R, r, bm,
      scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int lora_grouped_fwd(int dtype, const void* x, const void* w,
                                const void* a, const void* b, const void* gid,
                                void* y, int M, int K, int N, int R, int r,
                                int bm, float scale, void* stream) {
  if (r < 1 || r > RMAX || bm < 1 || M % bm != 0 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    launch<__nv_bfloat16>(x, w, a, b, gid, y, M, K, N, R, r, bm, scale, s);
  else if (dtype == DTYPE_F32)
    launch<float>(x, w, a, b, gid, y, M, K, N, R, r, bm, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
