// Grouped LoRA forward for multi-tenant decode, written by hand for Hopper.
//
// Replaces the TPU kernels of src/repro/kernels/lora_grouped.py in their
// serving form, one shared base (Ew = 1):
//   lora_grouped (_grouped_fwd_kernel): float W0 -> entry lora_grouped_fwd;
//   lora_grouped_q (_grouped_fwd_q_kernel): int8 codes q [K, N] and an f32
//     scale row s [N], W0 = q * s -> entry lora_grouped_q;
//   lora_grouped_q4 (_grouped_fwd_q4_kernel, _unpack_tile of
//     lora_pack4.py): packed 4-bit codes q4 [ceil(K/2), N] (int4 or nf4,
//     wfmt.cuh) and s [N] -> entry lora_grouped_q4.
//
//   y[m] = x[m] @ W0 + s * (x[m] @ A[g]) @ B[g],   g = gid[m / bm]
//
//   x [M, K] (M % bm == 0), A [R, K, r], B [R, r, N], gid int32 [M / bm] on
//   the device, y [M, N] in x's type T; f32 sums. Over a quantized base the
//   codes are turned into weights in T in registers (int8 exactly; int4
//   (nib ^ 8) - 8 exactly; nf4 the codebook rounded to T once per block),
//   and the scale goes on the f32 accumulator once per output, never on the
//   weights: y = round_T(acc * s[n] + scale * (round_T(h) @ B[g])), the
//   TPU kernels' _finish.
//
// Two bodies. Every bf16 instance of the three entries runs the
// tensor-core body of lora_grouped_decode_tc.cuh (mma.sync over a cp.async
// ring, h summed on the tensor cores in the same loop, K split across a
// cluster by a plan the host chooses per shape: its header has the design).
// Every f32 instance runs the CUDA-core body below, whose bits do not
// change (tensor cores would take f32 as TF32).
//
// What bounds it. Decode multiplies a handful of rows (M = 8 slots) by the
// whole frozen base, so the kernel is bound by reading W0 from device
// memory: about 2·M FLOPs per W0 element, far below the ~295 FLOP/byte the
// H100 needs before its arithmetic is the limit. For qwen2.5-0.5b one decode
// step reads the 24 x 14.9 M weights of q,k,v,o,gate,up,down through this
// kernel: 716 MB in bf16 (~0.21 ms at 3.35 TB/s), 358 MB in int8 (~0.11 ms)
// and 179 MB packed (~0.053 ms), plus 1.2 MB of scale rows and the resident
// adapters' A and B.
//
// The f32 body, on CUDA cores:
// * A cluster of CS = 8 blocks owns BN output columns and RB = 8 rows; its
//   blocks split K eight ways (on whole byte rows of a packed base). Inside
//   a block the 8 warps interleave over the block's code rows (K rows, or
//   byte rows of two K rows each), so a warp's loads of one code row are
//   contiguous (coalesced). A float W0 gives a lane 2 columns (BN = 64); a
//   quantized one 4 columns, loaded as one 4-byte word where the row allows
//   it (BN = 128), so a warp reads 128 bytes of codes per code row. Each warp
//   issues the loads of 8 K rows before it uses them.
// * All rows of the block share each W0 element it loads, so at decode
//   (M <= 8) W0 is read from device memory once; with M > 8 it is re-read
//   once per 8 rows.
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
// * The ragged K and N edges are masked in the kernel; nothing is padded
//   and no dense float W0 is written anywhere. A packed base with odd K has
//   a pad nibble in its last byte row; it meets an x column the stager has
//   masked to zero.
// * Each stage issues all of its loads, into registers of the raw type,
//   before it converts or uses one, so a stage costs one round trip.

#include <cooperative_groups.h>
#include <math.h>

#include <cstdint>

#include "common.cuh"
#include "lora_grouped_decode_tc.cuh"
#include "wfmt.cuh"

namespace cg = cooperative_groups;
using wfmt::WFmt;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RB = 8;               // rows per cluster
constexpr int RMAX = 16;            // largest LoRA rank supported
constexpr int CS = 8;               // blocks per cluster (K split)
constexpr int HP = RB * RMAX / 32;  // (row, rank) sums of h per lane

// the tiling of each format
template <WFmt F> struct Tile {
  static constexpr bool kQuant = F != WFmt::kDense;
  static constexpr int CPL = kQuant ? 4 : 2;   // output columns per lane
  static constexpr int BN = 32 * CPL;          // output columns per cluster
  static constexpr int KR = wfmt::is_packed(F) ? 2 : 1;  // K rows a code row
  // K slab staged in shared memory (the quantized tiles' wider partial sums
  // leave room for half the float kernel's slab under 48 KB)
  static constexpr int KS = kQuant ? 128 : 256;
  static constexpr int U = 8 / KR;             // code rows loaded ahead
  static constexpr int CN = BN / CS;           // columns each block finishes
  static constexpr int SPT = RB * KS / THREADS;  // x values staged per thread
};

// Four codes of one code row at columns n .. n + 3 as one word (byte c at
// bits 8c); columns at or past N read as 0. ``vec``: N % 4 == 0 and the
// codes 4-byte aligned, so the word is one aligned load.
__device__ __forceinline__ uint32_t load_codes(const uint8_t* row, int n,
                                               int N, bool vec, bool ok) {
  if (!ok || n >= N) return 0u;
  if (vec) return *reinterpret_cast<const uint32_t*>(row + n);
  uint32_t v = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n + c < N) v |= static_cast<uint32_t>(row[n + c]) << (8 * c);
  return v;
}

// code c of a word as a weight in T, as f32: an int8 byte (``t`` unused),
// or nibble ``t`` (0 low, 1 high) of a packed byte; cs: nf4's codebook
// rounded to T
template <WFmt F>
__device__ __forceinline__ float code_value(uint32_t word, int c, int t,
                                            const float* cs) {
  const uint32_t byte = (word >> (8 * c)) & 0xffu;
  if constexpr (F == WFmt::kInt8) {
    return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(byte)));
  } else {
    return wfmt::nibble_value<F>(t ? byte >> 4 : byte & 15u, cs);
  }
}

template <typename T, WFmt F>
__global__ void __cluster_dims__(1, 1, CS) __launch_bounds__(THREADS)
    lora_grouped_fwd_kernel(const T* __restrict__ x,
                            const typename wfmt::WStore<T, F>::type*
                                __restrict__ w,
                            const float* __restrict__ S,
                            const T* __restrict__ a, const T* __restrict__ b,
                            const int* __restrict__ gid, T* __restrict__ y,
                            int M, int K, int N, int R, int r, int bm,
                            float scale) {
  using TL = Tile<F>;
  constexpr int CPL = TL::CPL, BN = TL::BN, KR = TL::KR, KS = TL::KS,
                U = TL::U, CN = TL::CN, SPT = TL::SPT;
  __shared__ float xs[RB][KS];
  __shared__ float red[WARPS][RB][BN];
  __shared__ float hred[WARPS][RB * RMAX];
  __shared__ float part[RB][BN];       // this block's x@W0 partial
  __shared__ float hpart[RB * RMAX];   // this block's x@A partial
  __shared__ float hs[RB][RMAX];       // h over all of K, rounded to T
  __shared__ float cs[16];             // nf4 codebook, rounded to T
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
  if constexpr (F == WFmt::kNF4) {
    if (threadIdx.x < 16) cs[threadIdx.x] = round_to<T>(wfmt::kNF4[threadIdx.x]);
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

  // the block's K range, on whole code rows
  const int kc = ((K + CS - 1) / CS + KR - 1) / KR * KR;
  const int kb = rank * kc, ke = min(K, kb + kc);
  // quantized: this lane's 4 columns, and whether they load as one word
  const int nq = n0 + lane * CPL;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
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
    if constexpr (!TL::kQuant) {
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
    } else {
      // code rows of this slab (k0 and KS are whole code rows); a packed
      // odd K's last high nibble is K row len, which the stager zeroed
      const int nrows = (len + KR - 1) / KR;
      const uint8_t* wb = reinterpret_cast<const uint8_t*>(w);
      for (int jj0 = warp; jj0 < nrows; jj0 += WARPS * U) {
        uint32_t wv[U];
        T av[U][KR][HP];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int jj = jj0 + u * WARPS;
          const bool ok = jj < nrows;
          wv[u] = load_codes(wb + (size_t)(k0 / KR + jj) * N, nq, N, vec, ok);
#pragma unroll
          for (int t = 0; t < KR; ++t) {
            const int kk = jj * KR + t;
            const size_t k = (size_t)(k0 + kk);
#pragma unroll
            for (int q = 0; q < HP; ++q)
              av[u][t][q] = load_or_zero(hp[q] + k * r,
                                         ok && kk < len && hon[q]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int jj = jj0 + u * WARPS;
          if (jj < nrows) {
#pragma unroll
            for (int t = 0; t < KR; ++t) {
              const int kk = jj * KR + t;
              float wf[CPL];
#pragma unroll
              for (int c = 0; c < CPL; ++c)
                wf[c] = code_value<F>(wv[u], c, t, cs);
#pragma unroll
              for (int i = 0; i < RB; ++i) {
                const float xv = xs[i][kk];
#pragma unroll
                for (int c = 0; c < CPL; ++c) acc[i][c] += xv * wf[c];
              }
#pragma unroll
              for (int q = 0; q < HP; ++q)
                hacc[q] += xs[hi[q]][kk] * to_f(av[u][t][q]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // this block's partials: sum over its warps (column of lane's c-th value:
  // float W0 c * 32 + lane, quantized lane * CPL + c)
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      red[warp][i][TL::kQuant ? lane * CPL + c : c * 32 + lane] = acc[i][c];
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
      float sn = 0.f;
      if constexpr (TL::kQuant) sn = S[n];
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < RMAX; ++j) d += hs[oi][j] * to_f(bv[j]);
      if constexpr (TL::kQuant)
        // acc * s[n] + scale * d, each product and the sum rounded apart
        out = __fadd_rn(__fmul_rn(tot, sn), __fmul_rn(scale, d));
      else
        out = tot + scale * d;
    }
    y[(size_t)(m0 + oi) * N + n] = from_f<T>(out);
  }
  // keep this block's shared memory alive until the cluster has read it
  cluster.sync();
}

template <typename T, WFmt F>
void launch(const void* x, const void* w, const void* s, const void* a,
            const void* b, const void* gid, void* y, int M, int K, int N,
            int R, int r, int bm, float scale, cudaStream_t stream) {
  using W = typename wfmt::WStore<T, F>::type;
  const dim3 grid((N + Tile<F>::BN - 1) / Tile<F>::BN, (M + RB - 1) / RB, CS);
  lora_grouped_fwd_kernel<T, F><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(s), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const int*>(gid),
      static_cast<T*>(y), M, K, N, R, r, bm, scale);
}

template <WFmt F>
int launch_as(int dtype, const void* x, const void* w, const void* s,
              const void* a, const void* b, const void* gid, void* y, int M,
              int K, int N, int R, int r, int bm, float scale, int split,
              int bn, int part, int hc, void* stream) {
  if (r < 1 || r > RMAX || bm < 1 || M % bm != 0 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return decode_tc::launch<F>(x, w, s, a, b, gid, y, M, K, N, R, r, bm,
                                scale, split, bn, part, hc, st);
  if (dtype != DTYPE_F32) return static_cast<int>(cudaErrorInvalidValue);
  launch<float, F>(x, w, s, a, b, gid, y, M, K, N, R, r, bm, scale, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 when it was accepted).
// split, bn, part, hc: the bf16 body's plan (kernels/lora_grouped.py,
// decode_plan): members of a cluster over K, column tile, rows of a part,
// h columns of a part; the f32 body takes none of them.

// float W0 [K, N] in x's type
extern "C" int lora_grouped_fwd(int dtype, const void* x, const void* w,
                                const void* a, const void* b, const void* gid,
                                void* y, int M, int K, int N, int R, int r,
                                int bm, float scale, int split, int bn,
                                int part, int hc, void* stream) {
  return launch_as<WFmt::kDense>(dtype, x, w, nullptr, a, b, gid, y, M, K, N,
                                 R, r, bm, scale, split, bn, part, hc,
                                 stream);
}

// int8 codes q [K, N], f32 scale s [N]
extern "C" int lora_grouped_q(int dtype, const void* x, const void* q,
                              const void* s, const void* a, const void* b,
                              const void* gid, void* y, int M, int K, int N,
                              int R, int r, int bm, float scale, int split,
                              int bn, int part, int hc, void* stream) {
  return launch_as<WFmt::kInt8>(dtype, x, q, s, a, b, gid, y, M, K, N, R, r,
                                bm, scale, split, bn, part, hc, stream);
}

// packed codes q4 [ceil(K/2), N] (method 0 int4, 1 nf4), f32 scale s [N]
extern "C" int lora_grouped_q4(int dtype, int method, const void* x,
                               const void* q4, const void* s, const void* a,
                               const void* b, const void* gid, void* y, int M,
                               int K, int N, int R, int r, int bm,
                               float scale, int split, int bn, int part,
                               int hc, void* stream) {
  if (method == 0)
    return launch_as<WFmt::kInt4>(dtype, x, q4, s, a, b, gid, y, M, K, N, R,
                                  r, bm, scale, split, bn, part, hc, stream);
  if (method == 1)
    return launch_as<WFmt::kNF4>(dtype, x, q4, s, a, b, gid, y, M, K, N, R,
                                 r, bm, scale, split, bn, part, hc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
