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
// causal) dq moves 1.5 MB and does 0.18 GFLOP, dk/dv 1.2 MB and 0.24
// GFLOP: bytes, under 0.5 us each at 3.35 TB/s. Both are set by latency
// instead: by how many dependent tile steps one block walks, and by how
// many blocks share them.
//
// Design. flash_bwd_dq: one block per (b*h, 64-row q tile); it walks its
// live k tiles (k_range), accumulates ds k in registers and writes dq once.
// flash_bwd_dkv: K and V of one 64-row k tile stay in shared memory while
// the block walks live q tiles (q_range), accumulating dk and dv in
// registers. The TPU kernel carried these sums across a sequential grid in
// VMEM; here no float atomics are used, and repeated calls give the same
// bits.
//
// bf16 (the *_tc kernels, flash_common.cuh's flash::tc): 4 warps, 16 rows
// each (dk/dv above 128 columns: 8, see below), every product on mma.sync
// m16n8k16 (bf16 operands, f32 sums), the next tile pair copied by cp.async
// into a second buffer while the current one is multiplied, p and ds
// rounded to bf16 and repacked from score fragments into A fragments in
// registers.
// * dq: s = q k^T and dp = g v^T, then dq += ds k with k's B fragments
//   from ldmatrix.trans. dq is staged in f32, counter-rotated and cast once.
// * dk/dv compute the transposes, s^T = k q^T and dp^T = v g^T, so p^T and
//   ds^T come out with k rows and feed dv += round(p^T) g and
//   dk += ds^T q straight from registers; lse and delta of the q tile's
//   columns are staged beside it. The G group members of a kv head run in
//   parallel: the grid is (k tile, b*hkv, C) in clusters of C = min(G, 8)
//   blocks (7 on the dense path: 56 blocks, not 8 walking 28 steps each),
//   block z walking members z G / C .. (z + 1) G / C - 1 in turn (above 8
//   members the shares may differ by one). Each block stages its f32 sums in shared
//   memory, and after a cluster barrier each adds the C blocks' sums for
//   its share of the tile's rows through distributed shared memory, in
//   rank order, so dk and dv are summed over g = 0 .. G-1 in a fixed order
//   (no atomics, no scratch in device memory, one launch); then dk is
//   counter-rotated and both are cast once. Above 128 columns a D-wide
//   accumulator takes 128 registers: dq walks a tile's keys in two passes
//   of 32, and dk/dv runs 8 warps, warps 0-3 summing dv and 4-7 dk over the
//   same 16-row slices (the dv warps compute no dp).
// f32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): the CUDA-core body on
// f32 tiles (tensor cores would round f32 operands to TF32); one dk/dv
// block per (k tile, b*hkv) walks the G members in turn. Above 128 columns
// the staged [64][D + 1] tiles would exceed shared memory (dq 279,808 B,
// dk/dv 296,448 at D 256): k and v (dq), and q and g with ds and round(p)
// (dk/dv), take turns in one staged tile each, with the same sums in the
// same order.

#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace flash;

// p and ds of the thread's 4 x 4 (q row, k column) pairs of tile (q_lo,
// k_lo), given the staged tiles and the rows' lse and delta; ds rounded to
// T is staged in DSs, round(p) in Ps (when Ps is not null)
// the same from the thread's scores s and dp already summed; s becomes p
template <typename T>
__device__ __forceinline__ void ds_of(
    float* Ps, float* DSs, float (&s)[4][4], const float (&dp)[4][4],
    const float (&lse_r)[4], const float (&dl_r)[4], int q_lo, int k_lo,
    int nq, int nk, int causal, int window, float scale, int ty, int tx) {
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
      s[i][j] = p;
    }
}

template <typename T>
__device__ __forceinline__ void probs_ds(
    float* Ps, float* DSs, const float* Qs, const float* Ks, const float* Gs,
    const float* Vs, const float (&lse_r)[4], const float (&dl_r)[4], int ld,
    int D, int q_lo, int k_lo, int nq, int nk, int causal, int window,
    float scale, int ty, int tx) {
  float s[4][4], dp[4][4];
  dot_tile(s, Qs, Ks, ld, D, ty, tx);
  dot_tile(dp, Gs, Vs, ld, D, ty, tx);
  ds_of<T>(Ps, DSs, s, dp, lse_r, dl_r, q_lo, k_lo, nq, nk, causal, window,
           scale, ty, tx);
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
  // above 128 columns four [64][D + 1] tiles exceed shared memory: k and v
  // take turns in one (v for dp, then k for s and ds k)
  constexpr bool ONE_KV = DMAX > 128;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;
  float* Gs = Qs + BQ * ld;
  float* Ks = Gs + BQ * ld;
  float* Vs = ONE_KV ? Ks : Ks + BK * ld;
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
    if constexpr (ONE_KV) {
      load_tile<T>(Vs, ld, vb, k_lo, nk, D, nullptr, nullptr);
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile(dp, Gs, Vs, ld, D, ty, tx);
      __syncthreads();
      load_tile<T>(Ks, ld, kb, k_lo, nk, D, cos, sin);
      __syncthreads();
      dot_tile(s, Qs, Ks, ld, D, ty, tx);
      ds_of<T>(nullptr, DSs, s, dp, lse_r, dl_r, q_lo, k_lo, nq, nk, causal,
               window, scale, ty, tx);
    } else {
      load_tile<T>(Ks, ld, kb, k_lo, nk, D, cos, sin);
      load_tile<T>(Vs, ld, vb, k_lo, nk, D, nullptr, nullptr);
      __syncthreads();
      probs_ds<T>(nullptr, DSs, Qs, Ks, Gs, Vs, lse_r, dl_r, ld, D, q_lo,
                  k_lo, nq, nk, causal, window, scale, ty, tx);
    }
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
  // above 128 columns four [64][D + 1] tiles and two score tiles exceed
  // shared memory: q and g take turns in one tile and ds and round(p) in
  // one score tile (g for dp, q for s and dk, g again for dv)
  constexpr bool ONE_QG = DMAX > 128;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* Gs = ONE_QG ? Qs : Qs + BQ * ld;
  float* Ps = Gs + BQ * ld;
  float* DSs = ONE_QG ? Ps : Ps + BQ * PS;

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
      float lse_r[4], dl_r[4];
      __syncthreads();
      if constexpr (ONE_QG) {
        load_tile<T>(Gs, ld, g + bh * nq * D, q_lo, nq, D, nullptr, nullptr);
        __syncthreads();
        float s[4][4], dp[4][4];
        dot_tile(dp, Gs, Vs, ld, D, ty, tx);
        __syncthreads();
        load_tile<T>(Qs, ld, q + bh * nq * D, q_lo, nq, D, cos, sin);
        __syncthreads();
        dot_tile(s, Qs, Ks, ld, D, ty, tx);
        row_stats(lse_r, dl_r, lse + bh * nq, delta + bh * nq, q_lo, nq, ty);
        ds_of<T>(nullptr, DSs, s, dp, lse_r, dl_r, q_lo, k_lo, nq, nk,
                 causal, window, scale, ty, tx);
        __syncthreads();
        acc_tile<JC, true>(dk_acc, DSs, Qs, ld, D, ty, tx);
        __syncthreads();  // ds and q are read: round(p) and g take their place
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Ps[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(s[i][j]);
        load_tile<T>(Gs, ld, g + bh * nq * D, q_lo, nq, D, nullptr, nullptr);
        __syncthreads();
        acc_tile<JC, true>(dv_acc, Ps, Gs, ld, D, ty, tx);
      } else {
        load_tile<T>(Qs, ld, q + bh * nq * D, q_lo, nq, D, cos, sin);
        load_tile<T>(Gs, ld, g + bh * nq * D, q_lo, nq, D, nullptr, nullptr);
        __syncthreads();
        row_stats(lse_r, dl_r, lse + bh * nq, delta + bh * nq, q_lo, nq, ty);
        probs_ds<T>(Ps, DSs, Qs, Ks, Gs, Vs, lse_r, dl_r, ld, D, q_lo, k_lo,
                    nq, nk, causal, window, scale, ty, tx);
        __syncthreads();
        acc_tile<JC, true>(dv_acc, Ps, Gs, ld, D, ty, tx);
        acc_tile<JC, true>(dk_acc, DSs, Qs, ld, D, ty, tx);
      }
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

// ---------------------------------------------------------------------------
// bf16 on tensor cores: the same functions, only the order of the sums
// differs

// the widest cluster of dk/dv blocks (the portable limit)
constexpr int kMaxCluster = 8;

__device__ __forceinline__ void add4(float4& s, float4 x) {
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

// four f32 values rounded to bf16 into 8 aligned bytes
__device__ __forceinline__ void store4(tc::bf16* y, float a, float b,
                                       float c, float d) {
  *reinterpret_cast<uint2*>(y) =
      make_uint2(mma::pack_bf16(a, b), mma::pack_bf16(c, d));
}

template <int DMAX>
__global__ void __launch_bounds__(tc::THREADS) flash_bwd_dq_tc(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
    const tc::bf16* __restrict__ v, const tc::bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ cos, const float* __restrict__ sin,
    tc::bf16* __restrict__ dq, int G, int nq, int nk, int D, int causal,
    int window, float scale) {
  using tc::bf16;
  constexpr int KS = DMAX / 16, NT = DMAX / 8;
  constexpr bool HOLD = DMAX <= 64;  // at 128 the registers go to acc
  constexpr int KW = DMAX > 128 ? 32 : BK;  // keys a pass
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int ts = tc::stride(D);
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Gs = Qs + BQ * ts;
  bf16* Ks = Gs + BQ * ts;      // two buffers
  bf16* Vs = Ks + 2 * BK * ts;  // two buffers

  const int bh = blockIdx.y, q_lo = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = q_lo + 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const bf16* kb = k + (size_t)(bh / G) * nk * D;
  const bf16* vb = v + (size_t)(bh / G) * nk * D;
  tc::zero_pads(Qs, 6 * BQ, D);
  int lo, hi;
  k_range(q_lo, nq, nk, causal, window, &lo, &hi);
  tc::load_tile(Qs, q + (size_t)bh * nq * D, q_lo, nq, D, cos, sin);
  tc::load_tile(Gs, g + (size_t)bh * nq * D, q_lo, nq, D, nullptr, nullptr);
  if (lo < hi) {
    tc::load_tile(Ks, kb, lo * BK, nk, D, cos, sin);
    tc::load_tile(Vs, vb, lo * BK, nk, D, nullptr, nullptr);
  }
  mma::cp_async_commit();
  // lse and delta of rows r0 and r0 + 8 (0 past nq: those rows are masked)
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lr[h] = row < nq ? lse[(size_t)bh * nq + row] : 0.f;
    dr[h] = row < nq ? delta[(size_t)bh * nq + row] : 0.f;
  }

  tc::AFrags<KS, HOLD> qf, gf;
  float acc[NT][4];
  tc::zero(acc);
  for (int kt = lo; kt < hi; ++kt) {
    const int buf = (kt - lo) & 1, k_lo = kt * BK;
    if (kt + 1 < hi) {
      tc::load_tile(Ks + (buf ^ 1) * BK * ts, kb, k_lo + BK, nk, D, cos, sin);
      tc::load_tile(Vs + (buf ^ 1) * BK * ts, vb, k_lo + BK, nk, D, nullptr,
                    nullptr);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    if (kt == lo) {
      qf.init(Qs + 16 * warp * ts, D, lane);
      gf.init(Gs + 16 * warp * ts, D, lane);
    }
    const bf16* Kt = Ks + buf * BK * ts;
    const bf16* Vt = Vs + buf * BK * ts;

    const bool inner = interior(q_lo, k_lo, nq, nk, causal, window);
    // the tile's keys in one pass (in two of 32 above 128 columns, where
    // acc takes the registers)
#pragma unroll 1
    for (int k0 = 0; k0 < BK; k0 += KW) {
      float s[KW / 8][4], dp[KW / 8][4];
      tc::dot_tile(s, qf, Kt + k0 * ts, D, lane);
      tc::dot_tile(dp, gf, Vt + k0 * ts, D, lane);
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const bool ok = inner || valid(r0 + 8 * h,
                                         k_lo + k0 + 8 * j + c0 + (e & 1), nq,
                                         nk, causal, window);
          const float p = ok ? expf(__fmul_rn(s[j][e], scale) - lr[h]) : 0.f;
          s[j][e] = p * (dp[j][e] - dr[h]) * scale;  // ds, rounded when packed
        }
      tc::acc_tile(acc, s, Kt + k0 * ts, D, lane);
    }
    __syncthreads();
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // stage dq in f32 over the k/v buffers, then counter-rotate and cast
  float* F = reinterpret_cast<float*>(Ks);
  const int lf = D + 4;
  tc::stage(F, lf, acc, 16 * warp, D, lane);
  __syncthreads();
  store_tile<bf16, tc::THREADS>(dq + (size_t)bh * nq * D, F, lf, q_lo, nq, D,
                                cos, sin);
}

// threads of a dk/dv block: 4 warps, or above 128 columns 8 in two warp
// groups, one summing dv and the other dk over the same 16-row slices (one
// D-wide accumulator each: two would take 256 registers)
__host__ __device__ constexpr int dkv_threads(int dmax) {
  return dmax > 128 ? 2 * tc::THREADS : tc::THREADS;
}

template <int DMAX>
__global__ void __launch_bounds__(dkv_threads(DMAX)) flash_bwd_dkv_tc(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
    const tc::bf16* __restrict__ v, const tc::bf16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ cos, const float* __restrict__ sin,
    tc::bf16* __restrict__ dk, tc::bf16* __restrict__ dv, int G, int nq,
    int nk, int D, int causal, int window, float scale) {
  using tc::bf16;
  constexpr int KS = DMAX / 16, NT = DMAX / 8;
  constexpr bool HOLD = DMAX <= 64;
  constexpr bool SPLIT = DMAX > 128;
  constexpr int NTH = dkv_threads(DMAX);
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int ts = tc::stride(D);
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* Vs = Ks + BK * ts;
  bf16* Qs = Vs + BK * ts;      // two buffers
  bf16* Gs = Qs + 2 * BQ * ts;  // two buffers
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BQ * ts);  // two [64]
  float* Ds = Ls + 2 * BQ;                                 // two [64]

  // block z of the cluster's C takes the members [z G / C, (z + 1) G / C)
  const int k_lo = blockIdx.x * BK, bkv = blockIdx.y;
  const int C = gridDim.z, rank = blockIdx.z;
  const int m_lo = rank * G / C, per = (rank + 1) * G / C - m_lo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's 16-row slice, and (SPLIT) its sum: 0 dv, 1 dk
  const int rw = warp % 4, role = warp / 4;
  const int r0 = k_lo + 16 * rw + (lane >> 2), c0 = 2 * (lane & 3);
  tc::zero_pads<NTH>(Ks, 6 * BK, D);
  int lo, hi;
  q_range(k_lo, nq, nk, causal, window, &lo, &hi);
  const int T = max(hi - lo, 0), steps = per * T;
  tc::load_tile<NTH>(Ks, k + (size_t)bkv * nk * D, k_lo, nk, D, cos, sin);
  tc::load_tile<NTH>(Vs, v + (size_t)bkv * nk * D, k_lo, nk, D, nullptr,
                     nullptr);
  // step i (member m_lo + i / T, q tile lo + i % T) into buffer b:
  // q (rotated), g, lse, delta
  auto load_q = [&](int b, int i) {
    const size_t bh = (size_t)bkv * G + m_lo + i / T;
    const int q_lo = (lo + i % T) * BQ;
    tc::load_tile<NTH>(Qs + b * BQ * ts, q + bh * nq * D, q_lo, nq, D, cos,
                       sin);
    tc::load_tile<NTH>(Gs + b * BQ * ts, g + bh * nq * D, q_lo, nq, D,
                       nullptr, nullptr);
    tc::load_rows<NTH>(Ls + b * BQ, lse + bh * nq, q_lo, nq);
    tc::load_rows<NTH>(Ds + b * BQ, delta + bh * nq, q_lo, nq);
  };
  if (steps > 0) load_q(0, 0);
  mma::cp_async_commit();

  tc::AFrags<KS, HOLD> kf, vf;
  // rows r0 and r0 + 8 of this k tile, summed over this block's members
  // (SPLIT: acc is dv in warp group 0 and dk in warp group 1)
  float dka[NT][4], dva[SPLIT ? 1 : NT][4];
  float(&acc)[NT][4] = dka;
  tc::zero(dka);
  if constexpr (!SPLIT) tc::zero(dva);
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1, q_lo = (lo + i % T) * BQ;
    if (i + 1 < steps) load_q(buf ^ 1, i + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    if (i == 0) {
      kf.init(Ks + 16 * rw * ts, D, lane);
      vf.init(Vs + 16 * rw * ts, D, lane);
    }
    const bf16* Qt = Qs + buf * BQ * ts;
    const bf16* Gt = Gs + buf * BQ * ts;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Ds + buf * BQ;

    const bool inner = interior(q_lo, k_lo, nq, nk, causal, window);
    // the tile's q columns in two passes of 32 (dk and dv take the
    // registers): st[j][e] is k row r0 + 8 (e >> 1), q column
    // q_lo + q0 + 8 j + c0 + (e & 1)
#pragma unroll 1
    for (int q0 = 0; q0 < BQ; q0 += 32) {
      float st[4][4], dpt[4][4];
      const bool want_ds = !SPLIT || role == 1;
      tc::dot_tile(st, kf, Qt + q0 * ts, D, lane);
      if (want_ds) tc::dot_tile(dpt, vf, Gt + q0 * ts, D, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = q0 + 8 * j + c0 + (e & 1);
          const bool ok = inner || valid(q_lo + c, r0 + 8 * (e >> 1), nq, nk,
                                         causal, window);
          const float p =
              ok ? expf(__fmul_rn(st[j][e], scale) - Lt[c]) : 0.f;
          if (want_ds) dpt[j][e] = p * (dpt[j][e] - Dt[c]) * scale;  // ds^T
          st[j][e] = p;                                              // p^T
        }
      if constexpr (SPLIT) {
        if (role == 0)
          tc::acc_tile(acc, st, Gt + q0 * ts, D, lane);   // dv
        else
          tc::acc_tile(acc, dpt, Qt + q0 * ts, D, lane);  // dk
      } else {
        tc::acc_tile(dva, st, Gt + q0 * ts, D, lane);   // dv += round(p)^T g
        tc::acc_tile(dka, dpt, Qt + q0 * ts, D, lane);  // dk += round(ds)^T q
      }
    }
    __syncthreads();
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // this block's sums in f32 over the q/g buffers; then each block of the
  // cluster adds the C blocks' sums, in rank (so member) order, over its
  // share of the rows (r = rank, rank + C, ...) through distributed
  // shared memory, counter-rotates dk and casts both once
  const int lf = D + 4;
  float* Fk = reinterpret_cast<float*>(Qs);
  if constexpr (SPLIT) {
    tc::stage(Fk + (1 - role) * BK * lf, lf, acc, 16 * rw, D, lane);
  } else {
    tc::stage(Fk, lf, dka, 16 * warp, D, lane);
    tc::stage(Fk + BK * lf, lf, dva, 16 * warp, D, lane);
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
  const int half = D / 2, q4 = half / 4;  // units: 4 columns + partners
  const int units = (BK - rank + C - 1) / C * q4;
  for (int idx = threadIdx.x; idx < units; idx += NTH) {
    const int r = rank + C * (idx / q4), c = (idx % q4) * 4;
    const int row = k_lo + r;
    if (row >= nk) continue;
    float4 k1 = make_float4(0.f, 0.f, 0.f, 0.f), k2 = k1, v1 = k1, v2 = k1;
#pragma unroll
    for (int m = 0; m < kMaxCluster; ++m) {
      if (m < C) {
        const float* f = (C > 1 ? cluster.map_shared_rank(Fk, m) : Fk) +
                         r * lf + c;
        add4(k1, *reinterpret_cast<const float4*>(f));
        add4(k2, *reinterpret_cast<const float4*>(f + half));
        add4(v1, *reinterpret_cast<const float4*>(f + BK * lf));
        add4(v2, *reinterpret_cast<const float4*>(f + BK * lf + half));
      }
    }
    float y1[4] = {k1.x, k1.y, k1.z, k1.w}, y2[4] = {k2.x, k2.y, k2.z, k2.w};
    if (cos) {  // R_-theta, as store_tile
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float cs = cos[(size_t)row * half + c + e];
        const float sn = -sin[(size_t)row * half + c + e];
        const float a1 =
            __fsub_rn(__fmul_rn(y1[e], cs), __fmul_rn(y2[e], sn));
        const float a2 =
            __fadd_rn(__fmul_rn(y2[e], cs), __fmul_rn(y1[e], sn));
        y1[e] = a1;
        y2[e] = a2;
      }
    }
    const size_t o = ((size_t)bkv * nk + row) * D + c;
    store4(dk + o, y1[0], y1[1], y1[2], y1[3]);
    store4(dk + o + half, y2[0], y2[1], y2[2], y2[3]);
    store4(dv + o, v1.x, v1.y, v1.z, v1.w);
    store4(dv + o + half, v2.x, v2.y, v2.z, v2.w);
  }
  if (C > 1) cluster.sync();  // the others' reads of this block are done
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
  if (int rc = set_smem(kern, D, DMAX > 128 ? 3 : 4, 1, &smem)) return rc;
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
  if (int rc = set_smem(kern, D, DMAX > 128 ? 3 : 4, DMAX > 128 ? 1 : 2,
                        &smem))
    return rc;
  const dim3 grid((nk + BK - 1) / BK, BHkv);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta, cos,
      sin, static_cast<T*>(dk), static_cast<T*>(dv), G, nq, nk, D, causal,
      window, scale_of(D));
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* delta, const float* cos,
                 const float* sin, void* dq, int BH, int G, int nq, int nk,
                 int D, int causal, int window, cudaStream_t s) {
  using tc::bf16;
  auto kern = flash_bwd_dq_tc<DMAX>;
  size_t smem;
  if (int rc = tc::set_smem(kern, D, 6, 0, &smem)) return rc;
  const dim3 grid((nq + BQ - 1) / BQ, BH);
  kern<<<grid, tc::THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
      cos, sin, static_cast<bf16*>(dq), G, nq, nk, D, causal, window,
      scale_of(D));
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* delta, const float* cos,
                  const float* sin, void* dk, void* dv, int BHkv, int G,
                  int nq, int nk, int D, int causal, int window,
                  cudaStream_t s) {
  using tc::bf16;
  auto kern = flash_bwd_dkv_tc<DMAX>;
  size_t smem;
  if (int rc = tc::set_smem(kern, D, 6, 4 * BQ, &smem)) return rc;
  const int C = G < kMaxCluster ? G : kMaxCluster;  // one cluster a k tile
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nk + BK - 1) / BK, BHkv, C);
  cfg.blockDim = dim3(dkv_threads(DMAX));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (cudaError_t rc = cudaLaunchKernelEx(
          &cfg, kern, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse,
          delta, cos, sin, static_cast<bf16*>(dk), static_cast<bf16*>(dv), G,
          nq, nk, D, causal, window, scale_of(D)))
    return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int D, int G, int nq, int nk) {
  return D < 8 || D > 256 || D % 8 || G < 1 || nq < 0 || nk < 0;
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 when accepted).
// q, g [BHkv * G, nq, D], k, v [BHkv, nk, D] of one type; lse, delta f32
// [BHkv * G, nq]; cos, sin f32 [nq, D / 2] or both null. D a multiple of 8
// up to 256 (instances for D up to 64, 128 and 256). bf16: q, k, v, g and
// the outputs 16-byte aligned (the wrapper checks).

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
    auto run = D <= 64 ? launch_dq_tc<64> : D <= 128 ? launch_dq_tc<128>
                                                     : launch_dq_tc<256>;
    return run(q, k, v, g, l, dl, c, sn, dq, BH, G, nq, nk, D, causal, window,
               s);
  }
  if (dtype == DTYPE_F32) {
    auto run = D <= 64    ? launch_dq<float, 64>
               : D <= 128 ? launch_dq<float, 128>
                          : launch_dq<float, 256>;
    return run(q, k, v, g, l, dl, c, sn, dq, BH, G, nq, nk, D, causal, window,
               s);
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
    auto run = D <= 64 ? launch_dkv_tc<64> : D <= 128 ? launch_dkv_tc<128>
                                                      : launch_dkv_tc<256>;
    return run(q, k, v, g, l, dl, c, sn, dk, dv, BHkv, G, nq, nk, D, causal,
               window, s);
  }
  if (dtype == DTYPE_F32) {
    auto run = D <= 64    ? launch_dkv<float, 64>
               : D <= 128 ? launch_dkv<float, 128>
                          : launch_dkv<float, 256>;
    return run(q, k, v, g, l, dl, c, sn, dk, dv, BHkv, G, nq, nk, D, causal,
               window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory (bytes) of the bf16 instance for head dim D at
// its last launch, as the runtime holds it (-1 on error). Each returns the
// CUDA error code.
extern "C" int flash_bwd_dq_smem(int D, int* bytes) {
  auto kern = D <= 64    ? flash_bwd_dq_tc<64>
              : D <= 128 ? flash_bwd_dq_tc<128>
                         : flash_bwd_dq_tc<256>;
  return flash::tc::smem_of(kern, bytes);
}

extern "C" int flash_bwd_dkv_smem(int D, int* bytes) {
  auto kern = D <= 64    ? flash_bwd_dkv_tc<64>
              : D <= 128 ? flash_bwd_dkv_tc<128>
                         : flash_bwd_dkv_tc<256>;
  return flash::tc::smem_of(kern, bytes);
}
