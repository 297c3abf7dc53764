// LoRA factor gradients, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lora_fused.py: lora_dab
// (_lora_dab_kernel), with the same arithmetic and roundings:
//
//   sg = round(s g),  h = round(x @ A),  dh = round(sg @ B^T)
//   dA = x^T dh   [K, r],   dB = h^T sg   [r, N]
//
//   x [M, K], g [M, N], A [K, r], B [r, N] (r <= 32); rounds to x's type,
//   f32 sums, dA and dB cast to A's and B's type.
//
// What bounds it: reading x and g once (the outputs are r-thin); ~8 r FLOPs
// per element of x or g, far below the card's ridge, so bytes.
//
// Design, two launches on one stream:
// * Partials. A block owns 8 rows (one warp per row). It recomputes its
//   rows' h and dh (paper section 4.1: h is never stored): A, then B, is
//   staged in shared memory a chunk of 256 rows (columns) at a time, every
//   warp sums its row against the chunk, and a warp sum finishes each of the
//   r values, rounded as the reference rounds. h and dh stay in shared
//   memory. The block then writes its f32 partials of dA (threads over k:
//   x^T dh over the 8 rows) and dB (threads over n: h^T sg) to a workspace.
// * Reduce. One thread per element of dA and dB adds the partials of all
//   row tiles in a fixed order and casts. No atomics: the result is the same
//   on every run.
// The TPU kernel carried dA and dB across its sequential row grid in VMEM;
// on Hopper the row tiles run in parallel, hence the second pass.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RB = WARPS;       // rows per block, one warp each
constexpr int CH = THREADS;     // rows of A (columns of B) per staged chunk
constexpr int RMAX = 32;

template <typename T, int RM>
__global__ void __launch_bounds__(THREADS) lora_dab_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ a,
    const T* __restrict__ b, float* __restrict__ ws, int M, int K, int N,
    int r, float scale) {
  __shared__ float stage[CH * (RMAX + 1)];
  __shared__ float Hs[RB][RM];
  __shared__ float Ds[RB][RM];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * RB, m = m0 + warp;
  const bool row_ok = m < M;
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

  float* wa = ws + (size_t)blockIdx.x * ((size_t)K * r + (size_t)r * N);
  float* wb = wa + (size_t)K * r;
  // dA partial: sum over the block's rows of x[m, k] dh[m, j]
  for (int k = tid; k < K; k += THREADS) {
    float xv[RB];
#pragma unroll
    for (int w = 0; w < RB; ++w)
      xv[w] = m0 + w < M ? to_f(x[(size_t)(m0 + w) * K + k]) : 0.f;
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
      sg[w] = m0 + w < M
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

template <typename T>
__global__ void __launch_bounds__(THREADS) lora_dab_reduce_kernel(
    const float* __restrict__ ws, int tiles, int K, int N, int r,
    T* __restrict__ da, T* __restrict__ db) {
  const size_t na = (size_t)K * r, per = na + (size_t)r * N;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < per;
       e += (size_t)gridDim.x * THREADS) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += ws[(size_t)t * per + e];
    if (e < na)
      da[e] = from_f<T>(s);
    else
      db[e - na] = from_f<T>(s);
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* a, const void* b,
           float* ws, void* da, void* db, int M, int K, int N, int r,
           float scale, cudaStream_t s) {
  const int tiles = (M + RB - 1) / RB;
  if (tiles > 0) {
    const T *xp = static_cast<const T*>(x), *gp = static_cast<const T*>(g),
            *ap = static_cast<const T*>(a), *bp = static_cast<const T*>(b);
    if (r <= 8)
      lora_dab_partial_kernel<T, 8><<<tiles, THREADS, 0, s>>>(
          xp, gp, ap, bp, ws, M, K, N, r, scale);
    else if (r <= 16)
      lora_dab_partial_kernel<T, 16><<<tiles, THREADS, 0, s>>>(
          xp, gp, ap, bp, ws, M, K, N, r, scale);
    else
      lora_dab_partial_kernel<T, 32><<<tiles, THREADS, 0, s>>>(
          xp, gp, ap, bp, ws, M, K, N, r, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t per = (size_t)K * r + (size_t)r * N;
  const size_t need = (per + THREADS - 1) / THREADS;
  const int blocks = need < 1024 ? (int)need : 1024;
  lora_dab_reduce_kernel<T><<<blocks, THREADS, 0, s>>>(
      ws, tiles, K, N, r, static_cast<T*>(da), static_cast<T*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 elements of the partials workspace that lora_dab needs.
extern "C" long long lora_dab_workspace(int M, int K, int N, int r) {
  const long long tiles = (M + RB - 1) / RB;
  return tiles * ((long long)K * r + (long long)r * N);
}

// Returns cudaGetLastError() after the launches (0 when both were accepted).
extern "C" int lora_dab(int dtype, const void* x, const void* g, const void* a,
                        const void* b, void* ws, void* da, void* db, int M,
                        int K, int N, int r, float scale, void* stream) {
  if (M < 0 || K < 1 || N < 1 || r < 1 || r > RMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, g, a, b, w, da, db, M, K, N, r, scale, s);
  if (dtype == DTYPE_F32)
    return launch<float>(x, g, a, b, w, da, db, M, K, N, r, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
