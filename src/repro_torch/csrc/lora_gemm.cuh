// The tiled product shared by the LoRA forward (lora_fused_fwd.cu) and the
// LoRA input gradient (lora_dx.cu), by their variants over a quantized
// W0 (lora_quant.cu: int8; lora_pack4.cu: packed int4 / nf4), and by their
// grouped forms over per-expert stacks (lora_grouped_train.cu), written by
// hand for Hopper. Its callers today: every f32 instance, forward and dx,
// dense and grouped, in every format. The bf16 forwards and dx run on
// tensor cores instead: dense over one W0 in lora_dense_tc.cuh and
// lora_dense_dx_tc.cuh, grouped over expert stacks in lora_grouped_tc.cuh
// and lora_grouped_dx_tc.cuh.
//
//   y[m, n] = sum_k P[m, k] Q[k, n]  +  s * sum_j L[m, j] R[j, n]
//
// with f32 sums and y rounded once to T. The two callers differ only in
// where Q, L and R come from:
//
//   forward (DX = false): P = x [M, K], Q = W0 [K, N] as stored,
//     L = h = x @ A summed in the same K loop as x @ W0 and rounded to T
//     (A [K, r]; h never leaves the chip), R = B [r, N], s = the LoRA scale.
//   dx (DX = true): P = g [M, N], Q = W0^T read in place from W0 [K, N]
//     (no transposed copy), L = dh [M, r] given (the f32 wrapper's thin
//     product), R = A^T read from A [K, r], s = 1.
//
// W0's format F (WFmt, wfmt.cuh) is a template parameter. kDense: W0 in T.
// The quantized formats hold a per-output-channel scale S [N] (f32) beside
// integer codes: kInt8 one int8 per weight; kInt4 / kNF4 two 4-bit codes
// per byte along K (byte row j: row 2j in the low nibble, 2j + 1 in the
// high one; int4 sign-extended, nf4 an index into NF4_CODE). Each code is
// turned into a weight in T (the integers are exact in T; nf4's codebook
// entries are rounded to T) and staged in shared memory as f32. The scale
// is not applied per weight: it commutes with the sum over K, so the
// forward applies it once per output in the epilogue,
//   y = round(acc * S[n] + s * (round(h) @ B)),
// and dx, whose sum runs over N, folds it onto g as P is staged,
//   P = round_T(g * round_T(S)).
// Those are the roundings of the TPU kernels (src/repro/kernels/
// lora_quant.py, lora_pack4.py), kept with __fmul_rn / __fadd_rn where FMA
// contraction would change the bits.
//
// Design (simple and right first, CUDA cores, f32 or bf16 in):
// * A block of 256 threads owns a BM x BN = 64 x 64 tile of y and walks the
//   contraction in slabs of BK = 32. Each thread sums a 4 x 4 micro-tile in
//   registers from f32 copies of the slab in shared memory.
// * The next slab's loads are started into registers, in the raw type, before
//   the current slab is multiplied, so their latency hides behind the
//   arithmetic; they are converted only when stored to shared memory.
// * Ragged edges (any M, K, N) are masked on load and store; nothing is
//   padded in device memory. A packed W0 with odd K has a pad nibble in its
//   last byte row; it meets an x column the loader has masked to zero, and
//   the loader zeroes it too.
// * The low-rank term is added in the epilogue from shared memory: L's
//   64 x r rows and R's r x 64 columns (r <= RMAX).
// Not yet: TF32 tensor cores for f32 (they would change f32's bits), TMA,
// split-K for the narrow outputs.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "wfmt.cuh"

namespace lora_gemm {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;
constexpr int RMAX = 32;            // largest LoRA rank the kernels take
constexpr int PER = BM * BK / THREADS;   // slab elements loaded per thread
constexpr int LPER = BK * RMAX / THREADS;  // A-slab elements per thread (fwd)
// packed W0: a slab's BK x BN (fwd) or BN x BK (dx) weights are
// BK * BN / 2 bytes, PB contiguous bytes per thread
constexpr int PB = BK * BN / 2 / THREADS;

// W0's formats (wfmt.cuh)
using wfmt::WFmt;
using wfmt::WStore;
using wfmt::is_packed;
using wfmt::kNF4;
using wfmt::nibble_value;

template <typename T, bool DX, WFmt F = WFmt::kDense>
struct Slab {
  using W = typename WStore<T, F>::type;
  static constexpr int QN = is_packed(F) ? PB : PER;
  T p[PER];
  W q[QN];
  T l[LPER];
  float sv[PER];  // dx over a quantized W0: S at the slab's P columns
  bool lo_ok, hi_ok;  // packed W0: this thread's low / high nibbles are in

  // Start the loads of the slab that begins at k0 (masked, raw type).
  __device__ __forceinline__ void load(const T* __restrict__ P,
                                       const W* __restrict__ Q,
                                       const float* __restrict__ S,
                                       const T* __restrict__ lo_in, int M,
                                       int Kc, int Nout, int r, int m0,
                                       int n0, int k0) {
    const int tid = threadIdx.x;
    {  // P [M, Kc]: thread -> row tid / 4, 8 contiguous k
      const int m = m0 + (tid >> 2), kk = k0 + (tid & 3) * PER;
#pragma unroll
      for (int e = 0; e < PER; ++e)
        p[e] = load_or_zero(P + (size_t)m * Kc + kk + e,
                            m < M && kk + e < Kc);
      if constexpr (DX && F != WFmt::kDense) {
#pragma unroll
        for (int e = 0; e < PER; ++e) sv[e] = kk + e < Kc ? S[kk + e] : 0.f;
      }
    }
    if constexpr (is_packed(F)) {
      if (!DX) {  // W0 bytes [ceil(Kc/2), Nout]: byte row tid / 16, 4 n
        const int j = k0 / 2 + (tid >> 4), n = n0 + (tid & 15) * PB;
        lo_ok = 2 * j < Kc;
        hi_ok = 2 * j + 1 < Kc;
#pragma unroll
        for (int e = 0; e < PB; ++e)
          q[e] = load_or_zero(Q + (size_t)j * Nout + n + e,
                              lo_ok && n + e < Nout);
      } else {  // W0 bytes [ceil(Nout/2), Kc]: byte row tid / 8, 4 k
        const int j = n0 / 2 + (tid >> 3), kk = k0 + (tid & 7) * PB;
        lo_ok = 2 * j < Nout;
        hi_ok = 2 * j + 1 < Nout;
#pragma unroll
        for (int e = 0; e < PB; ++e)
          q[e] = load_or_zero(Q + (size_t)j * Kc + kk + e,
                              lo_ok && kk + e < Kc);
      }
    } else if (!DX) {  // Q = W0 [Kc, Nout]: thread -> k row tid / 8, 8 n
      const int k = k0 + (tid >> 3), n = n0 + (tid & 7) * PER;
#pragma unroll
      for (int e = 0; e < PER; ++e)
        q[e] = load_or_zero(Q + (size_t)k * Nout + n + e,
                            k < Kc && n + e < Nout);
    } else {  // Q = W0^T from W0 [Nout, Kc]: thread -> n row tid / 4
      const int n = n0 + (tid >> 2), kk = k0 + (tid & 3) * PER;
#pragma unroll
      for (int e = 0; e < PER; ++e)
        q[e] = load_or_zero(Q + (size_t)n * Kc + kk + e,
                            n < Nout && kk + e < Kc);
    }
    if (!DX) {
#pragma unroll
      for (int e = 0; e < LPER; ++e) {  // A [Kc, r] rows k0 .. k0 + BK
        const int i = tid + e * THREADS, k = k0 + i / RMAX, j = i % RMAX;
        l[e] = load_or_zero(lo_in + (size_t)k * r + j, j < r && k < Kc);
      }
    }
  }

  // cs: the nf4 codebook rounded to T (shared memory; kNF4 only)
  __device__ __forceinline__ void store(float (*Ps)[BM], float (*Qs)[BN],
                                        float (*Ls)[RMAX],
                                        const float* cs) const {
    const int tid = threadIdx.x;
    {
      const int row = tid >> 2, kk = (tid & 3) * PER;
      if constexpr (DX && F != WFmt::kDense) {
        // g * S in g's type, S rounded to it first
#pragma unroll
        for (int e = 0; e < PER; ++e)
          Ps[kk + e][row] =
              round_to<T>(__fmul_rn(to_f(p[e]), round_to<T>(sv[e])));
      } else {
#pragma unroll
        for (int e = 0; e < PER; ++e) Ps[kk + e][row] = to_f(p[e]);
      }
    }
    if constexpr (is_packed(F)) {
      if (!DX) {  // byte row jj holds slab rows 2 jj, 2 jj + 1
        const int jj = tid >> 4, nn = (tid & 15) * PB;
#pragma unroll
        for (int e = 0; e < PB; ++e) {
          const unsigned b = q[e];
          Qs[2 * jj][nn + e] = lo_ok ? nibble_value<F>(b & 15u, cs) : 0.f;
          Qs[2 * jj + 1][nn + e] = hi_ok ? nibble_value<F>(b >> 4, cs) : 0.f;
        }
      } else {  // byte row jj holds tile columns 2 jj, 2 jj + 1
        const int jj = tid >> 3, kk = (tid & 7) * PB;
#pragma unroll
        for (int e = 0; e < PB; ++e) {
          const unsigned b = q[e];
          Qs[kk + e][2 * jj] = lo_ok ? nibble_value<F>(b & 15u, cs) : 0.f;
          Qs[kk + e][2 * jj + 1] = hi_ok ? nibble_value<F>(b >> 4, cs) : 0.f;
        }
      }
    } else if (!DX) {
      const int kk = tid >> 3, nn = (tid & 7) * PER;
#pragma unroll
      for (int e = 0; e < PER; ++e) Qs[kk][nn + e] = wval(q[e]);
    } else {
      const int nn = tid >> 2, kk = (tid & 3) * PER;
#pragma unroll
      for (int e = 0; e < PER; ++e) Qs[kk + e][nn] = wval(q[e]);
    }
    if (!DX) {
#pragma unroll
      for (int e = 0; e < LPER; ++e) {
        const int i = tid + e * THREADS;
        Ls[i / RMAX][i % RMAX] = to_f(l[e]);
      }
    }
  }

  // a dense or int8 weight as f32 (int8 is exact in T)
  __device__ __forceinline__ static float wval(T v) { return to_f(v); }
  __device__ __forceinline__ static float wval(int8_t v) {
    return static_cast<float>(v);
  }
};

// P, Q as above; S: W0's scale [N] (quantized F; nullptr for kDense);
// lo_in = A [Kc, r] (fwd) or dh [M, r] (dx); lo_out = B [r, Nout] (fwd) or
// A [Nout, r] (dx); y [M, Nout]. The block owns rows m0 .. m0 + BM - 1 of
// P and y, those below M (the plain kernels: m0 = blockIdx.y * BM; the
// grouped ones, lora_grouped_train.cu, end M at the row tile's end).
template <typename T, bool DX, WFmt F>
__device__ __forceinline__ void gemm_body(
    const T* __restrict__ P, const typename WStore<T, F>::type* __restrict__ Q,
    const float* __restrict__ S, const T* __restrict__ lo_in,
    const T* __restrict__ lo_out, T* __restrict__ y, int M, int Kc, int Nout,
    int r, float scale, int m0) {
  __shared__ __align__(16) float Ps[BK][BM];   // P slab, transposed: [k][m]
  __shared__ __align__(16) float Qs[BK][BN];   // Q slab: [k][n]
  __shared__ float Ls[BK][RMAX];               // A slab (fwd)
  __shared__ float Hs[BM][RMAX + 1];           // L rows of the tile
  __shared__ float Rs[RMAX][BN];               // R columns of the tile
  __shared__ float Cs[16];                     // nf4 codebook, rounded to T

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int tm = tid >> 4, tn = tid & 15;      // 4 x 4 micro-tile
  const int hm = tid >> 2, hj = tid & 3;       // h sums (fwd): row, rank lane
  const int hgroups = (r + 3) / 4;             // rank lanes in use (uniform)

  if constexpr (F == WFmt::kNF4) {
    if (tid < 16) Cs[tid] = round_to<T>(kNF4[tid]);
    __syncthreads();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float hacc[RMAX / 4];
#pragma unroll
  for (int i = 0; i < RMAX / 4; ++i) hacc[i] = 0.f;

  Slab<T, DX, F> slab;
  slab.load(P, Q, S, lo_in, M, Kc, Nout, r, m0, n0, 0);
  for (int k0 = 0; k0 < Kc; k0 += BK) {
    slab.store(Ps, Qs, Ls, Cs);
    __syncthreads();
    if (k0 + BK < Kc)
      slab.load(P, Q, S, lo_in, M, Kc, Nout, r, m0, n0, k0 + BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[kk][tm * 4]);
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[kk][tn * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pa[i], qa[j], acc[i][j]);
    }
    if (!DX) {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float xv = Ps[kk][hm];
#pragma unroll
        for (int i = 0; i < RMAX / 4; ++i)
          if (i < hgroups) hacc[i] = fmaf(xv, Ls[kk][hj + 4 * i], hacc[i]);
      }
    }
    __syncthreads();
  }

  // epilogue: the tile's low-rank factors into shared memory
  if (!DX) {
#pragma unroll
    for (int i = 0; i < RMAX / 4; ++i) Hs[hm][hj + 4 * i] = round_to<T>(hacc[i]);
  } else {
    for (int i = tid; i < BM * r; i += THREADS) {
      const int row = i / r, j = i % r, m = m0 + row;
      Hs[row][j] = m < M ? to_f(lo_in[(size_t)m * r + j]) : 0.f;
    }
  }
  for (int i = tid; i < r * BN; i += THREADS) {
    const int j = i / BN, nn = i % BN, n = n0 + nn;
    float v = 0.f;
    if (n < Nout)
      v = to_f(DX ? lo_out[(size_t)n * r + j] : lo_out[(size_t)j * Nout + n]);
    Rs[j][nn] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tm * 4 + i, m = m0 + row;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tn * 4 + c, n = n0 + col;
      if (n >= Nout) continue;
      float d = 0.f;
      for (int j = 0; j < r; ++j) d = fmaf(Hs[row][j], Rs[j][col], d);
      if constexpr (!DX && F != WFmt::kDense)
        // acc * S[n] + s * d, each product and the sum rounded apart
        y[(size_t)m * Nout + n] = from_f<T>(
            __fadd_rn(__fmul_rn(acc[i][c], S[n]), __fmul_rn(scale, d)));
      else
        y[(size_t)m * Nout + n] = from_f<T>(acc[i][c] + scale * d);
    }
  }
}

template <typename T, bool DX>
__global__ void __launch_bounds__(THREADS, 2)
    lora_gemm_kernel(const T* __restrict__ P, const T* __restrict__ Q,
                     const T* __restrict__ lo_in, const T* __restrict__ lo_out,
                     T* __restrict__ y, int M, int Kc, int Nout, int r,
                     float scale) {
  gemm_body<T, DX, WFmt::kDense>(P, Q, nullptr, lo_in, lo_out, y, M, Kc, Nout,
                                 r, scale, blockIdx.y * BM);
}

template <typename T, bool DX, WFmt F>
__global__ void __launch_bounds__(THREADS, 2)
    lora_gemm_q_kernel(const T* __restrict__ P,
                       const typename WStore<T, F>::type* __restrict__ Q,
                       const float* __restrict__ S,
                       const T* __restrict__ lo_in,
                       const T* __restrict__ lo_out, T* __restrict__ y, int M,
                       int Kc, int Nout, int r, float scale) {
  gemm_body<T, DX, F>(P, Q, S, lo_in, lo_out, y, M, Kc, Nout, r, scale,
                      blockIdx.y * BM);
}

inline int check_dims(int M, int Kc, int Nout, int r) {
  if (M < 0 || Kc < 1 || Nout < 1 || r < 1 || r > RMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// One activation type T's launch of format F: Q holds W0 in T (kDense; S
// unused) or W0's codes in format F with S its scale [N].
template <bool DX, WFmt F, typename T>
int launch_as(const void* P, const void* Q, const void* S, const void* lo_in,
              const void* lo_out, void* y, int M, int Kc, int Nout, int r,
              float scale, void* stream) {
  if (int rc = check_dims(M, Kc, Nout, r)) return rc;
  if (M == 0) return 0;
  const dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using W = typename WStore<T, F>::type;
  if constexpr (F == WFmt::kDense)
    lora_gemm_kernel<T, DX><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(P), static_cast<const T*>(Q),
        static_cast<const T*>(lo_in), static_cast<const T*>(lo_out),
        static_cast<T*>(y), M, Kc, Nout, r, scale);
  else
    lora_gemm_q_kernel<T, DX, F><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(P), static_cast<const W*>(Q),
        static_cast<const float*>(S), static_cast<const T*>(lo_in),
        static_cast<const T*>(lo_out), static_cast<T*>(y), M, Kc, Nout, r,
        scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lora_gemm
