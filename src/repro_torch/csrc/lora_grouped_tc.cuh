// The bf16 grouped LoRA forward over per-expert stacks on Hopper's tensor
// cores: the body of lora_grouped_gemm, lora_grouped_gemm_q and
// lora_grouped_gemm_q4 (lora_grouped_train.cu) when the activations are
// bf16. The f32 instances keep lora_gemm.cuh's CUDA-core body; the bf16
// dx has its own tensor-core body (lora_grouped_dx_tc.cuh).
//
// Replaces, in bf16, the TPU kernels of src/repro/kernels/lora_grouped.py
// with a W0 per group (Ew = E): lora_grouped (_grouped_fwd_kernel,
// _w_index), lora_grouped_q (_grouped_fwd_q_kernel) and lora_grouped_q4
// (_grouped_fwd_q4_kernel, _unpack_tile). With g = gid[m / bm]:
//
//   y[m] = round(x[m] @ W0[g] + s * round(x[m] @ A[g]) @ B[g])      kDense
//   y[m] = round(acc * S[g] + s * round(h) @ B[g]),                  kInt8,
//          acc = x[m] @ w(codes[g]),  h = x[m] @ A[g]                kInt4, kNF4
//
// f32 sums, h rounded to bf16 once, the epilogue's products and sum each
// rounded apart (__fmul_rn / __fadd_rn), as lora_gemm.cuh's gemm_body and the
// plain versions do; only the order of the f32 sums differs. w is the int8
// code, the sign-extended nibble (int4) or the nf4 codebook entry rounded to
// bf16: each exact in bf16. A gid outside [0, E) writes NaN to its tile's
// rows.
//
// What bounds it. At OLMoE-1B-7B's expert shapes (E 64, C = bm = 40, K x N
// 2048 x 1024 and 1024 x 2048, r 8) a launch does 2 * 40 FLOPs per W0 element
// it reads once: 40 FLOP/byte in bf16, 160 over nf4, below the H100's ~295,
// so the least time is that of reading the stack once (268 MB bf16, ~80 us;
// 67 MB nf4, ~20 us). Over codes, turning each code into a bf16 weight is
// work of the same order as the products, so its cost shows.
//
// Design:
// * One block of 8 warps per (row tile part, 256 output columns); the grid's
//   x runs over the column tiles, so one expert's blocks run side by side and
//   its x rows come from L2 after the first. Each warp owns 32 columns and
//   every row of the block: MF m16 fragments, MF = ceil(min(bm, 64) / 16)
//   (a template parameter), so a 40-row capacity tile takes 48 rows, not 64.
//   A bm above 64 is split into parts of 64 rows, as the CUDA-core body
//   does. At bm <= 64 one block per (tile, column tile) reads its slice of
//   the expert's W0 once a launch. 128 registers a thread: two blocks (16
//   warps) an SM.
// * The contraction runs in slabs of BK = 32 through a ring of STAGES = 4 in
//   shared memory, filled by cp.async (16 bytes a copy, zero-filled past an
//   edge) three slabs ahead: x [rows][BK], A [BK][r], and W0 as stored:
//   bf16 [BK][BN], or the raw codes, int8 [BK][BN] or packed bytes
//   [BK/2][BN] (rows padded so that the fragment loads meet no bank twice).
//   Rows whose stride is not a multiple of 16 bytes, or a base that is not
//   16-byte aligned (odd K, ragged N, r % 8 != 0), are loaded element by
//   element into the same slots, masked, in the same kernel.
// * Products: mma.sync m16n8k16 on x's fragments (ldmatrix) and W0's B
//   fragments built in registers from bf16 or codes (no converted copy of
//   W0 is written anywhere); h = x @ A in the same loop on the x fragments
//   already in registers: warp w < MF takes m16 fragment w. The fragment
//   loaders, the code conversions and the slab copies are lora_tc.cuh's,
//   which the dense forward (lora_dense_tc.cuh) shares; this loop is the
//   kernel's own.
// * Epilogue: h rounded to bf16 into shared memory (columns >= r zero), B's
//   rows [ceil16(r)][BN] beside it (rows >= r zero), d = round(h) @ B as one
//   more mma per fragment with B's fragments built as W0's, then y = acc +
//   s * d (or acc * S[n] + s * d), each product and the sum rounded apart.
//   A lane holds 8 adjacent columns of each of its rows: one 16-byte store.
// * Dynamic shared memory (34-98 KB) is allowed per instance with
//   cudaFuncSetAttribute before each launch; lora_grouped_gemm_smem reads it
//   back from the runtime.
// Not yet: wgmma with TMA.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "lora_tc.cuh"
#include "mma.cuh"
#include "wfmt.cuh"

namespace grouped_tc {

using namespace lora_tc;

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int BN = 32 * WARPS;  // output columns a block, 32 a warp
static_assert(WARPS >= 4, "warp w < MF <= 4 sums h for m16 fragment w");
constexpr int ROWS = 64;        // rows a block at most (MF <= 4)
// row stride in shared memory (elements) of a bf16 W0 slab, 8 past a
// multiple of 16: the 16 lanes of a half warp's 8-byte fragment loads meet
// distinct banks (x's and A's, XS and AS, are lora_tc.cuh's)
constexpr int WS = BN + 8;
// row strides (bytes) of the raw code slabs, for the same reason: int8 rows
// 2t of four lanes 8 words apart, packed rows t 8 words apart
constexpr int S8 = BN + 16, S4 = BN + 32;

// bytes of one ring stage and of the whole dynamic shared memory
template <int MF, WFmt F>
struct Layout {
  static constexpr int kX = MF * 16 * XS * 2;
  static constexpr int kA = BK * AS * 2;
  static constexpr int kW = F == WFmt::kDense  ? BK * WS * 2
                            : F == WFmt::kInt8 ? BK * S8
                                               : BK / 2 * S4;
  static constexpr int kStage = kX + kA + kW;
  static constexpr int kBytes = STAGES * kStage;
  // the epilogue's round(h) [MF * 16][AS] and B [RMAX][WS] reuse the ring
  static_assert(MF * 16 * AS * 2 + RMAX * WS * 2 <= kBytes,
                "epilogue tiles must fit in the ring");
};

// x [M, K] bf16; Q: W0's entries (bf16 [K, N], int8 codes [K, N] or packed
// bytes [ceil(K/2), N]) w_stride elements apart; S f32 [E, N] (nullptr for
// kDense); A [E, K, r]; B [E, r, N]; gid int32 [M / bm]; y [M, N] bf16.
// blockIdx.x: column tile; blockIdx.y: (row tile t, 64-row part of t).
template <int MF, WFmt F>
__global__ void __launch_bounds__(THREADS, 2)
    grouped_fwd_tc(const bf16* __restrict__ x,
                   const typename wfmt::WStore<bf16, F>::type* __restrict__ Q,
                   const float* __restrict__ S, const bf16* __restrict__ A,
                   const bf16* __restrict__ B, const int* __restrict__ gid,
                   bf16* __restrict__ y, int K, int N, int E,
                   size_t w_stride, int r, int bm, int parts, float scale,
                   int flags) {
  using L = Layout<MF, F>;
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.y / parts;
  const int m0 = t * bm + (blockIdx.y % parts) * ROWS, m_end = (t + 1) * bm;
  const int n0 = blockIdx.x * BN, cw0 = 32 * warp;
  const int e = gid[t];
  if (e < 0 || e >= E) {  // the whole block takes this branch
    const bf16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
    for (int i = threadIdx.x; i < MF * 16 * BN; i += THREADS) {
      const int m = m0 + i / BN, n = n0 + i % BN;
      if (m < m_end && n < N) y[(size_t)m * N + n] = nan;
    }
    return;
  }
  Q += (size_t)e * w_stride;
  A += (size_t)e * K * r;
  B += (size_t)e * r * N;

  const int rows = MF * 16;
  const int nk = (K + BK - 1) / BK;
  const bool vx = flags & kVecX, vw = flags & kVecW, va = flags & kVecA;

  auto load = [&](int stage, int k0) {
    uint8_t* st = smem + stage * L::kStage;
    stage_block<8, THREADS>(reinterpret_cast<bf16*>(st), XS, x, (size_t)K,
                            m0, k0, rows, BK, m_end, K, vx);
    stage_block<8, THREADS>(reinterpret_cast<bf16*>(st + L::kX), AS, A,
                            (size_t)r, k0, 0, BK, (r + 7) / 8 * 8, K, r, va);
    if constexpr (F == WFmt::kDense)
      stage_block<8, THREADS>(reinterpret_cast<bf16*>(st + L::kX + L::kA),
                              WS, Q, (size_t)N, k0, n0, BK, BN, K, N, vw);
    else if constexpr (F == WFmt::kInt8)
      stage_block<16, THREADS>(reinterpret_cast<int8_t*>(st + L::kX + L::kA),
                               S8, Q, (size_t)N, k0, n0, BK, BN, K, N, vw);
    else
      stage_block<16, THREADS>(st + L::kX + L::kA, S4, Q, (size_t)N, k0 / 2,
                               n0, BK / 2, BN, (K + 1) / 2, N, vw);
  };

  // acc: the warp's 32 columns of every row (tile j, lane group g: column
  // 4 g + j); hacc: h's n8 tiles over the rows of m16 fragment `warp`
  // (warps below MF)
  float acc[MF][4][4], hacc[RMAX / 8][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int i = 0; i < MF; ++i) acc[i][j][v] = 0.f;
      hacc[j][v] = 0.f;
    }
  const int hk = (r + 15) / 16;  // k16 steps over h's padded columns
  NibTable tb;
  if constexpr (wfmt::is_packed(F)) tb = nib_table<F>();

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * BK);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    mma::cp_async_commit();

    const uint8_t* st = smem + (kt % STAGES) * L::kStage;
    const bf16* xs = reinterpret_cast<const bf16*>(st);
    const bf16* as = reinterpret_cast<const bf16*>(st + L::kX);
    const uint8_t* ws = st + L::kX + L::kA;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MF][4], bw[4][2];
#pragma unroll
      for (int i = 0; i < MF; ++i) frag_a(af[i], xs + i * 16 * XS, XS, ks, lane);
      if constexpr (F == WFmt::kDense)
        frag_b16(bw, reinterpret_cast<const bf16*>(ws), WS, cw0, ks, lane);
      else if constexpr (F == WFmt::kInt8)
        frag_b8<S8>(bw, ws, cw0, ks, lane);
      else
        frag_b4<S4>(bw, ws, tb, cw0, ks, K - kt * BK, lane);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma::mma_bf16(acc[i][j], af[i], bw[j][0], bw[j][1]);
      if (warp < MF) {  // warp-uniform
        uint32_t ha[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          ha[v] = af[0][v];
#pragma unroll
          for (int i = 1; i < MF; ++i)
            if (warp == i) ha[v] = af[i][v];
        }
#pragma unroll
        for (int jp = 0; jp < RMAX / 16; ++jp) {
          if (jp < hk) {
            uint32_t ba[4];
            frag_bt(ba, as, AS, 16 * jp, ks, lane);
            mma::mma_bf16(hacc[2 * jp], ha, ba[0], ba[1]);
            mma::mma_bf16(hacc[2 * jp + 1], ha, ba[2], ba[3]);
          }
        }
      }
    }
  }

  // epilogue: round(h) [rows][AS] and B's rows [16 hk][WS] over the ring
  mma::cp_async_wait<0>();
  __syncthreads();
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + L::kX);
  const int g = lane >> 2, l4 = lane & 3;
  if (warp < MF) {
#pragma unroll
    for (int j = 0; j < RMAX / 8; ++j) {
      const int col = 8 * j + 2 * l4;
      if (col < 16 * hk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v0 = col < r ? hacc[j][2 * half] : 0.f;
          const float v1 = col + 1 < r ? hacc[j][2 * half + 1] : 0.f;
          *reinterpret_cast<uint32_t*>(hs + (warp * 16 + g + 8 * half) * AS +
                                       col) = mma::pack_bf16(v0, v1);
        }
      }
    }
  }
  stage_block<8, THREADS>(bs, WS, B, (size_t)N, 0, n0, 16 * hk, BN, r, N,
                          flags & kVecB);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  // the lane's 8 adjacent columns nb .. nb + 7: column nb + q holds tile
  // q % 4's accumulator entry of n index 2 l4 + q / 4
  const int nb = n0 + cw0 + 8 * l4;
  float sv[8];  // S at those columns (quantized formats)
  if constexpr (F != WFmt::kDense) {
    S += (size_t)e * N;
#pragma unroll
    for (int q = 0; q < 8; ++q) sv[q] = nb + q < N ? S[nb + q] : 0.f;
  }
  const bool vy = (flags & kVecY) && nb + 8 <= N;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    float d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) d[j][v] = 0.f;
    for (int ks = 0; ks < hk; ++ks) {
      uint32_t ha[4], bb[4][2];
      frag_a(ha, hs + i * 16 * AS, AS, ks, lane);
      frag_b16(bb, bs, WS, cw0, ks, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma::mma_bf16(d[j], ha, bb[j][0], bb[j][1]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + i * 16 + g + 8 * half;
      if (m >= m_end) continue;
      uint32_t o[4];
#pragma unroll
      for (int q2 = 0; q2 < 4; ++q2) {
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q = 2 * q2 + c, j = q % 4, idx = 2 * half + q / 4;
          const float a = acc[i][j][idx], dd = d[j][idx];
          if constexpr (F == WFmt::kDense)
            v[c] = __fadd_rn(a, __fmul_rn(scale, dd));
          else
            v[c] = __fadd_rn(__fmul_rn(a, sv[q]), __fmul_rn(scale, dd));
        }
        o[q2] = mma::pack_bf16(v[0], v[1]);
      }
      bf16* out = y + (size_t)m * N + nb;
      if (vy) {
        *reinterpret_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (nb + q < N)
            out[q] = __ushort_as_bfloat16(
                static_cast<unsigned short>(o[q / 2] >> (16 * (q % 2))));
      }
    }
  }
}

template <int MF, WFmt F>
int launch_mf(const void* x, const void* Q, const float* S, const void* A,
              const void* B, const int* gid, void* y, int M, int K, int N,
              int E, size_t w_stride, int r, int bm, float scale,
              cudaStream_t s) {
  using C = typename wfmt::WStore<bf16, F>::type;
  const int parts = (bm + ROWS - 1) / ROWS;
  const long long rows = (long long)(M / bm) * parts;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  int flags = 0;
  if (K % 8 == 0 && aligned16(x)) flags |= kVecX;
  if (N % (F == WFmt::kDense ? 8 : 16) == 0 && aligned16(Q)) flags |= kVecW;
  if (r % 8 == 0 && aligned16(A)) flags |= kVecA;
  if (N % 8 == 0 && aligned16(B)) flags |= kVecB;
  if (N % 8 == 0 && aligned16(y)) flags |= kVecY;
  auto kern = grouped_fwd_tc<MF, F>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<MF, F>::kBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((N + BN - 1) / BN, (unsigned)rows);
  kern<<<grid, THREADS, Layout<MF, F>::kBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const C*>(Q), S,
      static_cast<const bf16*>(A), static_cast<const bf16*>(B), gid,
      static_cast<bf16*>(y), K, N, E, w_stride, r, bm, parts, scale, flags);
  return static_cast<int>(cudaGetLastError());
}

// rows a block holds for tiles of bm rows, as m16 fragments
inline int frags_of(int bm) { return ((bm < ROWS ? bm : ROWS) + 15) / 16; }

// The bf16 forward of format F over tiles of bm rows (w_stride: elements of
// Q between two experts' entries; S's entries are N apart).
template <WFmt F>
int launch(const void* x, const void* Q, const float* S, const void* A,
           const void* B, const int* gid, void* y, int M, int K, int N, int E,
           size_t w_stride, int r, int bm, float scale, cudaStream_t s) {
  switch (frags_of(bm)) {
    case 1:
      return launch_mf<1, F>(x, Q, S, A, B, gid, y, M, K, N, E, w_stride, r,
                             bm, scale, s);
    case 2:
      return launch_mf<2, F>(x, Q, S, A, B, gid, y, M, K, N, E, w_stride, r,
                             bm, scale, s);
    case 3:
      return launch_mf<3, F>(x, Q, S, A, B, gid, y, M, K, N, E, w_stride, r,
                             bm, scale, s);
    default:
      return launch_mf<4, F>(x, Q, S, A, B, gid, y, M, K, N, E, w_stride, r,
                             bm, scale, s);
  }
}

// The dynamic shared memory the runtime allows format F's instance for
// tiles of bm rows: what launch set before its last launch.
template <WFmt F>
int smem_of(int bm, int* bytes) {
  cudaFuncAttributes a;
  cudaError_t rc;
  switch (frags_of(bm)) {
    case 1: rc = cudaFuncGetAttributes(&a, grouped_fwd_tc<1, F>); break;
    case 2: rc = cudaFuncGetAttributes(&a, grouped_fwd_tc<2, F>); break;
    case 3: rc = cudaFuncGetAttributes(&a, grouped_fwd_tc<3, F>); break;
    default: rc = cudaFuncGetAttributes(&a, grouped_fwd_tc<4, F>); break;
  }
  *bytes = rc == cudaSuccess ? a.maxDynamicSharedSizeBytes : -1;
  return static_cast<int>(rc);
}

}  // namespace grouped_tc
