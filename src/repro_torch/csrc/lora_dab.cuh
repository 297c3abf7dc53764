// The row-block pass of the LoRA factor gradients, shared by the plain
// dA/dB kernel (lora_dab.cu) and its grouped form over per-expert stacks
// (lora_grouped_train.cu):
//
//   sg = round(s g),  h = round(x @ A),  dh = round(sg @ B^T)
//   partial dA = x^T dh  [K, r],   partial dB = h^T sg  [r, N]
//
// over the rows m0 .. m0 + RB - 1 below m_end, with f32 sums and the
// roundings (to T) of the TPU kernels.
//
// A block of RB = 8 warps owns the RB rows, one warp a row. It recomputes
// its rows' h and dh (paper section 4.1: h is never stored): A, then B, is
// staged in shared memory a chunk of 256 rows (columns) at a time, every
// warp sums its row against the chunk, and a warp sum finishes each of the
// r values, rounded as the reference rounds. h and dh stay in shared
// memory. The block then writes its f32 partials of dA (threads over k:
// x^T dh over the RB rows) to wa [K, r] and of dB (threads over n: h^T sg)
// to wb [r, N]. The callers add the partials in a fixed order, never with
// atomics, so the result is the same on every run.
#pragma once

#include "common.cuh"

namespace dab_rows {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RB = WARPS;       // rows per block, one warp each
constexpr int CH = THREADS;     // rows of A (columns of B) per staged chunk
constexpr int RMAX = 32;

template <typename T, int RM>
__device__ __forceinline__ void partial_body(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ a,
    const T* __restrict__ b, float* __restrict__ wa, float* __restrict__ wb,
    int m0, int m_end, int K, int N, int r, float scale) {
  __shared__ float stage[CH * (RMAX + 1)];
  __shared__ float Hs[RB][RM];
  __shared__ float Ds[RB][RM];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m = m0 + warp;
  const bool row_ok = m < m_end;
  const int rs = r | 1;  // odd stride: the lanes of a warp hit distinct banks

  float hp[RM], dp[RM];
#pragma unroll
  for (int j = 0; j < RM; ++j) hp[j] = dp[j] = 0.f;

  // h = x @ A for the block's rows, A staged CH rows at a time
  for (int k0 = 0; k0 < K; k0 += CH) {
    __syncthreads();
    const int k = k0 + tid;
    for (int j = 0; j < r; ++j)
      stage[tid * rs + j] = k < K ? to_f(a[(size_t)k * r + j]) : 0.f;
    __syncthreads();
    if (row_ok) {
      const int kend = min(CH, K - k0);
#pragma unroll 2
      for (int kk = lane; kk < kend; kk += 32) {
        const float xv = to_f(x[(size_t)m * K + k0 + kk]);
#pragma unroll
        for (int j = 0; j < RM; ++j)
          if (j < r) hp[j] = fmaf(xv, stage[kk * rs + j], hp[j]);
      }
    }
  }
  // dh = round(s g) @ B^T, B staged CH columns at a time
  for (int n0 = 0; n0 < N; n0 += CH) {
    __syncthreads();
    const int n = n0 + tid;
    for (int j = 0; j < r; ++j)
      stage[tid * rs + j] = n < N ? to_f(b[(size_t)j * N + n]) : 0.f;
    __syncthreads();
    if (row_ok) {
      const int nend = min(CH, N - n0);
#pragma unroll 2
      for (int nn = lane; nn < nend; nn += 32) {
        const float sg = round_to<T>(scale * to_f(g[(size_t)m * N + n0 + nn]));
#pragma unroll
        for (int j = 0; j < RM; ++j)
          if (j < r) dp[j] = fmaf(sg, stage[nn * rs + j], dp[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RM; ++j) {
    if (j < r) {  // r is the same for every lane: no divergence
      const float hv = warp_sum(hp[j]), dv = warp_sum(dp[j]);
      if (lane == 0) {
        Hs[warp][j] = row_ok ? round_to<T>(hv) : 0.f;
        Ds[warp][j] = row_ok ? round_to<T>(dv) : 0.f;
      }
    }
  }
  __syncthreads();

  // dA partial: sum over the block's rows of x[m, k] dh[m, j]
  for (int k = tid; k < K; k += THREADS) {
    float xv[RB];
#pragma unroll
    for (int w = 0; w < RB; ++w)
      xv[w] = m0 + w < m_end ? to_f(x[(size_t)(m0 + w) * K + k]) : 0.f;
    for (int j = 0; j < r; ++j) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < RB; ++w) s = fmaf(xv[w], Ds[w][j], s);
      wa[(size_t)k * r + j] = s;
    }
  }
  // dB partial: sum over the block's rows of h[m, j] round(s g[m, n])
  for (int n = tid; n < N; n += THREADS) {
    float sg[RB];
#pragma unroll
    for (int w = 0; w < RB; ++w)
      sg[w] = m0 + w < m_end
                  ? round_to<T>(scale * to_f(g[(size_t)(m0 + w) * N + n]))
                  : 0.f;
    for (int j = 0; j < r; ++j) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < RB; ++w) s = fmaf(Hs[w][j], sg[w], s);
      wb[(size_t)j * N + n] = s;
    }
  }
}

// Launch ``kernel<T, RM>`` with the smallest RM (8, 16 or 32) >= r.
#define LORA_DAB_BY_RANK(kernel, T, r, grid, stream, ...)                   \
  do {                                                                      \
    if ((r) <= 8)                                                           \
      kernel<T, 8><<<(grid), dab_rows::THREADS, 0, (stream)>>>(__VA_ARGS__); \
    else if ((r) <= 16)                                                     \
      kernel<T, 16><<<(grid), dab_rows::THREADS, 0, (stream)>>>(__VA_ARGS__);\
    else                                                                    \
      kernel<T, 32><<<(grid), dab_rows::THREADS, 0, (stream)>>>(__VA_ARGS__);\
  } while (0)

}  // namespace dab_rows
