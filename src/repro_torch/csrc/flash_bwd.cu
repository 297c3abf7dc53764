// Flash-attention backward, written by hand for Hopper: two kernels.
//
// Replace the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_bwd, its two bodies _bwd_dq_kernel (flash_bwd_dq) and
// _bwd_dkv_kernel (flash_bwd_dkv), with the same arithmetic and roundings.
// The probabilities are recomputed from the saved logsumexp, never stored:
//
//   s  = (q k^T) scale (f32),  p = exp(s - lse), an explicit 0 on masked and
//        padded pairs (a fully masked row has lse = -1e30)
//   dp = g v^T (f32),  ds = round(p (dp - delta) scale)
//   dq = ds k,  dk = ds^T q,  dv = round(p)^T g   (f32 sums, one cast)
//
// round is to q's type; g arrives in q's type and delta = sum_d g out in
// f32, both made by the wrapper (as the TPU wrapper made them). dk and dv
// are summed over the G q heads of each kv head in f32 before their one
// cast. With RoPE tables q and k are rotated on load and dq, dk
// counter-rotated (R_-theta) in f32 before the cast.
//
// What bounds them: at the training shape (B*H 14, B*Hkv 2, N 256, D 64,
// causal) the pair moves ~1.3 MB and does ~0.15 GFLOP, so bytes: ~0.4 us at
// 3.35 TB/s. Both are set by latency instead: flash_bwd_dq has 56 blocks,
// flash_bwd_dkv only 8 (2 kv heads x 4 k tiles), each walking up to 28
// (q head, q tile) steps of CUDA-core products in turn.
//
// Design. flash_bwd_dq: one block per (b*h, 64-row q tile); it walks its
// live k tiles (k_range), accumulates ds k in registers and writes dq once.
// flash_bwd_dkv: one block per (b*hkv, 64-row k tile); K and V stay in
// shared memory while the block walks the G group members and each one's
// live q tiles (q_range), accumulating dk and dv in registers, and writes
// each once. The TPU kernel carried these sums across a sequential grid in
// VMEM; here one block owns each output tile, so no atomics and no second
// pass are needed and repeated calls give the same bits.

#include "flash_common.cuh"

namespace {

using namespace flash;

// p and ds of the thread's 4 x 4 (q row, k column) pairs of tile (q_lo,
// k_lo), given the staged tiles and the rows' lse and delta; ds rounded to
// T is staged in DSs, round(p) in Ps (when Ps is not null)
template <typename T>
__device__ __forceinline__ void probs_ds(
    float* Ps, float* DSs, const float* Qs, const float* Ks, const float* Gs,
    const float* Vs, const float (&lse_r)[4], const float (&dl_r)[4], int ld,
    int D, int q_lo, int k_lo, int nq, int nk, int causal, int window,
    float scale, int ty, int tx) {
  float s[4][4], dp[4][4];
  dot_tile(s, Qs, Ks, ld, D, ty, tx);
  dot_tile(dp, Gs, Vs, ld, D, ty, tx);
  const bool inner = interior(q_lo, k_lo, nq, nk, causal, window);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const bool ok = inner || valid(q_lo + r, k_lo + c, nq, nk, causal,
                                     window);
      const float p = ok ? expf(__fmul_rn(s[i][j], scale) - lse_r[i]) : 0.f;
      DSs[r * PS + c] = round_to<T>(p * (dp[i][j] - dl_r[i]) * scale);
      if (Ps) Ps[r * PS + c] = round_to<T>(p);
    }
}

// lse and delta of the thread's q rows ty + 16 i of tile q_lo (0 past nq:
// those rows are masked)
__device__ __forceinline__ void row_stats(float (&lse_r)[4], float (&dl_r)[4],
                                          const float* lse,
                                          const float* delta, int q_lo,
                                          int nq, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty + 16 * i;
    lse_r[i] = row < nq ? lse[row] : 0.f;
    dl_r[i] = row < nq ? delta[row] : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ cos,
    const float* __restrict__ sin, T* __restrict__ dq, int G, int nq, int nk,
    int D, int causal, int window, float scale) {
  constexpr int JC = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;
  float* Gs = Qs + BQ * ld;
  float* Ks = Gs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* DSs = Vs + BK * ld;

  const int bh = blockIdx.y, q_lo = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* kb = k + (size_t)(bh / G) * nk * D;
  const T* vb = v + (size_t)(bh / G) * nk * D;
  load_tile<T>(Qs, ld, q + (size_t)bh * nq * D, q_lo, nq, D, cos, sin);
  load_tile<T>(Gs, ld, g + (size_t)bh * nq * D, q_lo, nq, D, nullptr,
               nullptr);
  float lse_r[4], dl_r[4];
  row_stats(lse_r, dl_r, lse + (size_t)bh * nq, delta + (size_t)bh * nq,
            q_lo, nq, ty);

  float acc[4][JC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JC; ++j) acc[i][j] = 0.f;

  int lo, hi;
  k_range(q_lo, nq, nk, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();
    load_tile<T>(Ks, ld, kb, k_lo, nk, D, cos, sin);
    load_tile<T>(Vs, ld, vb, k_lo, nk, D, nullptr, nullptr);
    __syncthreads();
    probs_ds<T>(nullptr, DSs, Qs, Ks, Gs, Vs, lse_r, dl_r, ld, D, q_lo, k_lo,
                nq, nk, causal, window, scale, ty, tx);
    __syncthreads();
    acc_tile<JC, false>(acc, DSs, Ks, ld, D, ty, tx);
  }

  // stage dq in f32 (over Qs) and write it, counter-rotated with tables
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) Qs[(ty + 16 * i) * ld + c] = acc[i][j];
    }
  __syncthreads();
  store_tile<T>(dq + (size_t)bh * nq * D, Qs, ld, q_lo, nq, D, cos, sin);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ cos,
    const float* __restrict__ sin, T* __restrict__ dk, T* __restrict__ dv,
    int G, int nq, int nk, int D, int causal, int window, float scale) {
  constexpr int JC = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* Gs = Qs + BQ * ld;
  float* Ps = Gs + BQ * ld;
  float* DSs = Ps + BQ * PS;

  const int bkv = blockIdx.y, k_lo = blockIdx.x * BK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<T>(Ks, ld, k + (size_t)bkv * nk * D, k_lo, nk, D, cos, sin);
  load_tile<T>(Vs, ld, v + (size_t)bkv * nk * D, k_lo, nk, D, nullptr,
               nullptr);

  // rows ty + 16 i of this k tile, columns tx + 16 j
  float dk_acc[4][JC], dv_acc[4][JC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  int lo, hi;
  q_range(k_lo, nq, nk, causal, window, &lo, &hi);
  for (int gh = 0; gh < G; ++gh) {
    const size_t bh = (size_t)bkv * G + gh;
    for (int qt = lo; qt < hi; ++qt) {
      const int q_lo = qt * BQ;
      __syncthreads();
      load_tile<T>(Qs, ld, q + bh * nq * D, q_lo, nq, D, cos, sin);
      load_tile<T>(Gs, ld, g + bh * nq * D, q_lo, nq, D, nullptr, nullptr);
      __syncthreads();
      float lse_r[4], dl_r[4];
      row_stats(lse_r, dl_r, lse + bh * nq, delta + bh * nq, q_lo, nq, ty);
      probs_ds<T>(Ps, DSs, Qs, Ks, Gs, Vs, lse_r, dl_r, ld, D, q_lo, k_lo,
                  nq, nk, causal, window, scale, ty, tx);
      __syncthreads();
      acc_tile<JC, true>(dv_acc, Ps, Gs, ld, D, ty, tx);
      acc_tile<JC, true>(dk_acc, DSs, Qs, ld, D, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k_lo + ty + 16 * i;
    if (row >= nk) continue;
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dv[((size_t)bkv * nk + row) * D + c] = from_f<T>(dv_acc[i][j]);
    }
  }
  // stage dk in f32 (over Ks) and write it, counter-rotated with tables
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) Ks[(ty + 16 * i) * ld + c] = dk_acc[i][j];
    }
  __syncthreads();
  store_tile<T>(dk + (size_t)bkv * nk * D, Ks, ld, k_lo, nk, D, cos, sin);
}

float scale_of(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

template <typename T, int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const float* lse, const float* delta, const float* cos,
              const float* sin, void* dq, int BH, int G, int nq, int nk,
              int D, int causal, int window, cudaStream_t s) {
  auto kern = flash_bwd_dq_kernel<T, DMAX>;
  size_t smem;
  if (int rc = set_smem(kern, D, 4, 1, &smem)) return rc;
  const dim3 grid((nq + BQ - 1) / BQ, BH);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta, cos,
      sin, static_cast<T*>(dq), G, nq, nk, D, causal, window, scale_of(D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, const float* cos,
               const float* sin, void* dk, void* dv, int BHkv, int G, int nq,
               int nk, int D, int causal, int window, cudaStream_t s) {
  auto kern = flash_bwd_dkv_kernel<T, DMAX>;
  size_t smem;
  if (int rc = set_smem(kern, D, 4, 2, &smem)) return rc;
  const dim3 grid((nk + BK - 1) / BK, BHkv);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta, cos,
      sin, static_cast<T*>(dk), static_cast<T*>(dv), G, nq, nk, D, causal,
      window, scale_of(D));
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int D, int G, int nq, int nk) {
  return D < 8 || D > 128 || D % 8 || G < 1 || nq < 0 || nk < 0;
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 when accepted).
// q, g [BHkv * G, nq, D], k, v [BHkv, nk, D] of one type; lse, delta f32
// [BHkv * G, nq]; cos, sin f32 [nq, D / 2] or both null. D a multiple of 8
// up to 128.

extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* g, const void* lse,
                            const void* delta, const void* cos,
                            const void* sin, void* dq, int BH, int G, int nq,
                            int nk, int D, int causal, int window,
                            void* stream) {
  if (bad_args(D, G, nq, nk) || BH % G)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || nq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *l = static_cast<const float*>(lse),
              *dl = static_cast<const float*>(delta),
              *c = static_cast<const float*>(cos),
              *sn = static_cast<const float*>(sin);
  if (dtype == DTYPE_BF16) {
    using T = __nv_bfloat16;
    return D <= 64 ? launch_dq<T, 64>(q, k, v, g, l, dl, c, sn, dq, BH, G,
                                      nq, nk, D, causal, window, s)
                   : launch_dq<T, 128>(q, k, v, g, l, dl, c, sn, dq, BH, G,
                                       nq, nk, D, causal, window, s);
  }
  if (dtype == DTYPE_F32) {
    return D <= 64 ? launch_dq<float, 64>(q, k, v, g, l, dl, c, sn, dq, BH,
                                          G, nq, nk, D, causal, window, s)
                   : launch_dq<float, 128>(q, k, v, g, l, dl, c, sn, dq, BH,
                                           G, nq, nk, D, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* g, const void* lse,
                             const void* delta, const void* cos,
                             const void* sin, void* dk, void* dv, int BHkv,
                             int G, int nq, int nk, int D, int causal,
                             int window, void* stream) {
  if (bad_args(D, G, nq, nk)) return static_cast<int>(cudaErrorInvalidValue);
  if (BHkv == 0 || nk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *l = static_cast<const float*>(lse),
              *dl = static_cast<const float*>(delta),
              *c = static_cast<const float*>(cos),
              *sn = static_cast<const float*>(sin);
  if (dtype == DTYPE_BF16) {
    using T = __nv_bfloat16;
    return D <= 64 ? launch_dkv<T, 64>(q, k, v, g, l, dl, c, sn, dk, dv,
                                       BHkv, G, nq, nk, D, causal, window, s)
                   : launch_dkv<T, 128>(q, k, v, g, l, dl, c, sn, dk, dv,
                                        BHkv, G, nq, nk, D, causal, window,
                                        s);
  }
  if (dtype == DTYPE_F32) {
    return D <= 64 ? launch_dkv<float, 64>(q, k, v, g, l, dl, c, sn, dk, dv,
                                           BHkv, G, nq, nk, D, causal,
                                           window, s)
                   : launch_dkv<float, 128>(q, k, v, g, l, dl, c, sn, dk, dv,
                                            BHkv, G, nq, nk, D, causal,
                                            window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
