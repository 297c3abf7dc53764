// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile shape, the thread layout, the mask and live-tile ranges, tile
// loads with the optional fused RoPE, and the tile products on CUDA cores.
//
// Layouts are the reference's (src/repro/kernels/flash_attention.py): q, g,
// out [B*H, Nq, D]; k, v [B*Hkv, Nk, D], q head bh reading kv head bh / G;
// lse and delta [B*H, Nq] f32; RoPE tables cos, sin [N, D/2] f32 (Nq == Nk).
//
// A block holds one 64-row q tile and walks 64-row k tiles (or the reverse
// in flash_bwd_dkv). Its 256 threads form a 16 x 16 grid: thread (ty, tx)
// owns score rows ty + 16 i and score columns tx + 16 j (i, j < 4), and the
// D-wide accumulators' columns tx + 16 j (j < DMAX / 16). Rows of one
// thread row ty sit in one half-warp, so row maxima and sums are four
// shuffles. Tiles are staged in shared memory as f32, rows padded to D + 1
// (an odd stride: the 16 columns a half-warp reads fall in distinct banks).
#pragma once

#include "common.cuh"

namespace flash {

constexpr int BQ = 64;             // q rows per tile
constexpr int BK = 64;             // k rows per tile
constexpr int THREADS = 256;       // 16 x 16
constexpr int PS = BK + 1;         // stride of a staged [64][64] score tile
constexpr float NEG_INF = -1e30f;  // the reference's mask value (not -inf)
static_assert(BQ == BK, "load_tile, store_tile and acc_tile walk 64 rows");

// (q, k) is a pair the attention may use: inside both lengths, causal
// q >= k, window q - k < window (positions counted from 0 on both sides)
__device__ __forceinline__ bool valid(int q, int k, int nq, int nk,
                                      int causal, int window) {
  return q < nq && k < nk && (!causal || q >= k) &&
         (window <= 0 || q - k < window);
}

// every pair of the tile at (q_lo, k_lo) is valid: no mask is built
__device__ __forceinline__ bool interior(int q_lo, int k_lo, int nq, int nk,
                                         int causal, int window) {
  return q_lo + BQ <= nq && k_lo + BK <= nk &&
         (!causal || q_lo >= k_lo + BK - 1) &&
         (window <= 0 || q_lo + BQ - 1 - k_lo < window);
}

// [lo, hi) of the k tiles that q tile q_lo sees: nothing above the causal
// diagonal, nothing behind the window (core/flash.py _chunk_range)
__device__ __forceinline__ void k_range(int q_lo, int nq, int nk, int causal,
                                        int window, int* lo, int* hi) {
  const int q_hi = min(q_lo + BQ, nq) - 1;
  *hi = (nk + BK - 1) / BK;
  if (causal) *hi = min(*hi, q_hi / BK + 1);
  *lo = window > 0 ? max(0, q_lo - window + 1) / BK : 0;
}

// [lo, hi) of the q tiles that see k tile k_lo (the transpose of k_range)
__device__ __forceinline__ void q_range(int k_lo, int nq, int nk, int causal,
                                        int window, int* lo, int* hi) {
  const int k_hi = min(k_lo + BK, nk) - 1;
  *lo = causal ? k_lo / BQ : 0;
  *hi = (nq + BQ - 1) / BQ;
  if (window > 0) *hi = min(*hi, (k_hi + window - 1) / BQ + 1);
}

// Rows [row0, row0 + 64) of x [n, D] into dst [64][ld] as f32; rows past n
// are zero. With tables (cos != nullptr) each row is rotated by RoPE at its
// position, in f32, and rounded back to T, as the reference's _rot does:
// the rotated tile never reaches device memory. Products and sums are
// rounded one by one (no fused multiply-add), as the plain version's are.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* x,
                                          int row0, int n, int D,
                                          const float* cos,
                                          const float* sin) {
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < BQ * half; idx += THREADS) {
    const int r = idx / half, c = idx - r * half, row = row0 + r;
    float x1 = 0.f, x2 = 0.f;
    if (row < n) {
      x1 = to_f(x[(size_t)row * D + c]);
      x2 = to_f(x[(size_t)row * D + c + half]);
      if (cos) {
        const float cs = cos[(size_t)row * half + c];
        const float sn = sin[(size_t)row * half + c];
        const float y1 = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
        const float y2 = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
        x1 = round_to<T>(y1);
        x2 = round_to<T>(y2);
      }
    }
    dst[r * ld + c] = x1;
    dst[r * ld + c + half] = x2;
  }
}

// Write rows [row0, row0 + 64) of the f32 tile src [64][ld] to y [n, D] in
// T, rows past n skipped; with tables, counter-rotated first (R_-theta, the
// inverse of the rotation applied on load: the reference's
// _rot(acc, cos, -sin)), in f32.
template <typename T>
__device__ __forceinline__ void store_tile(T* y, const float* src, int ld,
                                           int row0, int n, int D,
                                           const float* cos,
                                           const float* sin) {
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < BQ * half; idx += THREADS) {
    const int r = idx / half, c = idx - r * half, row = row0 + r;
    if (row >= n) continue;
    float a1 = src[r * ld + c], a2 = src[r * ld + c + half];
    if (cos) {
      const float cs = cos[(size_t)row * half + c];
      const float sn = -sin[(size_t)row * half + c];
      const float y1 = __fsub_rn(__fmul_rn(a1, cs), __fmul_rn(a2, sn));
      const float y2 = __fadd_rn(__fmul_rn(a2, cs), __fmul_rn(a1, sn));
      a1 = y1;
      a2 = y2;
    }
    y[(size_t)row * D + c] = from_f<T>(a1);
    y[(size_t)row * D + c + half] = from_f<T>(a2);
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over staged tiles
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* A,
                                         const float* B, int ld, int D,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][j] += sum_t P[t][row_i] X[t][tx + 16 j] when trans (P^T X), or
// sum_t P[row_i][t] X[t][tx + 16 j] when not (P X); row_i = ty + 16 i,
// P a staged [64][PS] tile, X a staged [64][ld] tile
template <int JC, bool TRANS>
__device__ __forceinline__ void acc_tile(float (&acc)[4][JC], const float* P,
                                         const float* X, int ld, int D,
                                         int ty, int tx) {
  for (int t = 0; t < BK; ++t) {
    float x[JC], p[4];
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int c = tx + 16 * j;
      x[j] = c < D ? X[t * ld + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = TRANS ? P[t * PS + ty + 16 * i] : P[(ty + 16 * i) * PS + t];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JC; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

// max and sum over the 16 threads of a half-warp (one score row)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dynamic shared memory of a kernel with `tiles` staged [64][D + 1] tiles
// and `scores` staged [64][65] score tiles; above 48 KB it must be allowed
// per kernel
template <typename K>
inline int set_smem(K kernel, int D, int tiles, int scores, size_t* bytes) {
  *bytes = sizeof(float) * ((size_t)tiles * BQ * (D + 1) +
                            (size_t)scores * BQ * PS);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes));
}

}  // namespace flash
