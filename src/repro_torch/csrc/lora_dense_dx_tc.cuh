// The bf16 dense LoRA input gradient over one W0 on Hopper's tensor cores:
// the body of lora_dx_tc (lora_dx.cu), lora_dx_q_tc (lora_quant.cu) and
// lora_dx_q4_tc (lora_pack4.cu). The f32 instances keep lora_gemm.cuh's
// CUDA-core body and the wrapper's dh.
//
// Replaces, in bf16, the TPU kernels lora_dx (src/repro/kernels/
// lora_fused.py, _lora_dx_kernel), lora_dx_q (lora_quant.py,
// _lora_dx_q_kernel) and lora_dx_q4 (lora_pack4.py, _lora_dx_q4_kernel),
// and the thin product dh their wrappers computed outside the kernel:
//
//   dh = round(round(s g) @ B^T)                                 f32 sum
//   dx = round(g @ W0^T + dh @ A^T)                              kDense
//   dx = round(round(g * round(S[n])) @ w(codes)^T + dh @ A^T)   kInt8,
//                                                               kInt4, kNF4
//
// g [M, N], W0 [K, N] as stored (codes: int8 [K, N], packed [ceil(K/2),
// N]), S [N], A [K, r], B [r, N], dx [M, K]. f32 sums, dh rounded to bf16
// once after the whole contraction, the output rounded once; the scale
// products rounded as the plain versions round them (__fmul_rn, then RN to
// bf16), so only the order of the f32 sums differs from them. w is the
// int8 code, the sign-extended nibble (int4) or the nf4 codebook entry
// rounded to bf16: each exact in bf16. With an odd K over a packed base the
// pad nibble's column k = K is computed and never written.
//
// What bounds it. At the training paths' shapes (M 192 or 256; dx of
// 896 x 896, 896 x 128, 896 x 4864, 4864 x 896 and OLMoE's 2048 x 2048) a
// launch does 2 M FLOPs per W0 element it reads, near the H100's bf16 ridge
// (~295 FLOP/byte) and above it over codes; but each launch is small (0.2-
// 3.5 us at the card's peaks), so what sets its time is how much of the
// card it fills and how long each block's serial chain of slabs is, as for
// the dense forward (lora_dense_tc.cuh).
//
// Design: the dense forward's structure turned round, as the grouped dx
// (lora_grouped_dx_tc.cuh) turns the grouped forward round.
// * A block of 4 warps owns MF m16 row fragments (MF = ceil(min(M, 64) /
//   16)) by 128 output columns of K, 32 a warp. The contraction runs over N
//   in slabs of BK = 32 through a 4-stage cp.async ring; a slab carries g
//   [rows][BK], W0 read in place ([128 rows k][BK of n] as stored: bf16,
//   int8 codes, or packed bytes [64 byte rows][BK]) and B's [r][BK]
//   columns, which are neighbours along n like W0^T's. Every copy asks L2
//   for the row's whole 128-byte line: a slab reads 32-64 bytes of it.
//   When every operand takes 16-byte copies, FastLoad copies the slabs
//   from offsets set once (as the forward's FastLoad); ragged and
//   unaligned operands take the general loader, which masks ragged M, K
//   and N. A's rows for the epilogue are prefetched into L2 at the start.
// * mma.sync m16n8k16 on g's fragments (ldmatrix) and W0^T's B fragments
//   (lora_tc.cuh: frag_rows, frag_pair8, frag_pair4 with col_of, shared
//   with the grouped dx). Over codes each warp scales its g fragments by
//   round(S) in registers (S's slab entries come with the slab): no second
//   barrier a slab, no scaled copy in shared memory.
// * dh in the loop: warps below MF sum dh = g @ B^T over m16 fragment
//   `warp` on the same fragments of the unscaled g, B's fragments by
//   ldmatrix (frag_rows) on the slab's B columns. For s a power of two of
//   magnitude 1 or more (the model's alpha / r = 2; 4 or 1 at other ranks)
//   round(s g) = s g exactly and s multiplies the f32 sum once, after the
//   split's partials are added; for any other s each g fragment is scaled
//   in registers for that mma, each product rounded as the plain version
//   rounds it.
// * The contraction N is split across a thread-block cluster of up to 8
//   (grid z), the caller's split (the forward's rule with N in K's place
//   gives q, o 7; k, v 1, a 4-slab contraction: 28 blocks at M 256, a
//   member's chain is short; gate, up 8; down 2; 2048 x 2048 5). The forward's tile is kept
//   for every shape, k, v included.
// * Epilogue, as the forward's: after a cluster barrier each member writes
//   its f32 partials of acc and dh for every row into the owner's shared
//   memory (each warp turns a fragment round in its staging tile, so that
//   a remote store covers 4 rows of 128 contiguous bytes); after a second
//   barrier each owner adds the C partials of its rows in rank order (no
//   atomics: the same bits on every run), rounds dh once and writes
//   round(acc + round(dh) @ A^T), 8 adjacent columns a thread. A's rows for
//   the block's columns are copied as the loop ends, while the cluster
//   meets, and turned round in the staging tiles. dh never reaches device
//   memory and the call is one launch.
// * Dynamic shared memory (40-74 KB) is allowed per instance with
//   cudaFuncSetAttribute before each launch, the SM's shared memory carved
//   out in full so that three blocks fit an SM; plan() reads it back.
// Not yet: wgmma with TMA; a persistent grid.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "lora_dense_tc.cuh"
#include "lora_tc.cuh"
#include "mma.cuh"
#include "wfmt.cuh"

namespace dense_dx_tc {

namespace cg = cooperative_groups;
using namespace lora_tc;
// the forward's block, cluster and epilogue shapes
using dense_tc::BN;
using dense_tc::BS;
using dense_tc::FS;
using dense_tc::HS;
using dense_tc::kMaxSplit;
using dense_tc::NSTAGES;
using dense_tc::ROWS;
using dense_tc::THREADS;
using dense_tc::WARPS;

// row stride (f32) of a warp's staging tile [16][GS]: 10 words apart, so a
// fragment's 8-byte stores meet distinct banks
constexpr int GS = 32 + 8;
// the host's flag that s is a power of two of magnitude 1 or more
constexpr int kPow2 = 128;

// A block's tile: MF m16 row fragments by BN output columns, W0 in format
// F. Its shared memory (a ring of NSTAGES slabs, then, over the ring, the
// epilogue's partials, staging tiles and A's rows), its slab copy and its
// products on one slab.
template <int MF, WFmt F>
struct Tile {
  using C = typename wfmt::WStore<bf16, F>::type;
  static_assert(WARPS >= MF, "warp w < MF sums dh for m16 fragment w");
  static constexpr bool kQuant = F != WFmt::kDense;
  // bytes of g, W0, B and S in one ring stage, and of the whole ring
  static constexpr int kG = MF * 16 * XS * 2;
  static constexpr int kW = F == WFmt::kDense  ? BN * XS * 2
                            : F == WFmt::kInt8 ? BN * SC
                                               : BN / 2 * SC;
  static constexpr int kB = RMAX * XS * 2;
  static constexpr int kS = kQuant ? BK * 4 : 0;
  static constexpr int kStage = kG + kW + kB + kS;
  static constexpr int kRing = NSTAGES * kStage;
  // the epilogue over the ring: the C members' partials of acc and dh for
  // the rows a member owns, round(dh) of those rows, each warp's staging
  // tile (then A^T [RMAX][BS]), and A's rows [BN][AS] as copied
  static constexpr int kSlots = MF * 16 + kMaxSplit - 1;
  static constexpr int kStaging =
      (kSlots * (FS + HS) * 4 + MF * 16 * HS * 4 + 15) & ~15;
  static constexpr int kARaw = kStaging + WARPS * 16 * GS * 4;
  static constexpr int kEpi = kARaw + BN * AS * 2;
  static constexpr int kBytes = ((kRing > kEpi ? kRing : kEpi) + 15) & ~15;
  static_assert(RMAX * BS * 2 <= WARPS * 16 * GS * 4,
                "A^T fits in the staging tiles");

  // Stage the slab at n0 into st: g's rows m0 .. (those below M), W0's
  // output rows k0 .. (codes: byte rows k0 / 2 ..), B's rows below r (16 hk
  // rows), S's entries (codes); columns n0 .. n0 + BK, those below N.
  __device__ __forceinline__ static void load(uint8_t* st, const bf16* g,
                                              const C* Q, const float* S,
                                              const bf16* B, int M, int K,
                                              int N, int r, int hk, int m0,
                                              int k0, int n0, int flags) {
    stage_block<8, THREADS, bf16, true>(reinterpret_cast<bf16*>(st), XS, g,
                                        (size_t)N, m0, n0, MF * 16, BK, M, N,
                                        flags & kVecX);
    uint8_t* ws = st + kG;
    if constexpr (F == WFmt::kDense)
      stage_block<8, THREADS, bf16, true>(reinterpret_cast<bf16*>(ws), XS, Q,
                                          (size_t)N, k0, n0, BN, BK, K, N,
                                          flags & kVecW);
    else if constexpr (F == WFmt::kInt8)
      stage_block<16, THREADS, int8_t, true>(reinterpret_cast<int8_t*>(ws),
                                             SC, Q, (size_t)N, k0, n0, BN, BK,
                                             K, N, flags & kVecW);
    else
      stage_block<16, THREADS, uint8_t, true>(ws, SC, Q, (size_t)N, k0 / 2,
                                              n0, BN / 2, BK, (K + 1) / 2, N,
                                              flags & kVecW);
    stage_block<8, THREADS, bf16, true>(reinterpret_cast<bf16*>(ws + kW), XS,
                                        B, (size_t)N, 0, n0, 16 * hk, BK, r,
                                        N, flags & kVecB);
    if constexpr (kQuant)
      stage_block<4, THREADS>(reinterpret_cast<float*>(ws + kW + kB), 0, S,
                              0, 0, n0, 1, BK, 1, N, flags & kVecS);
  }

  // acc += the slab's p @ w(W0)^T over the warp's 32 columns (cw0 ..; n8
  // tile j, lane group g: column col_of<F>(j, g)) of every row, p = g or,
  // over codes, round(g * round(S[n])), each product rounded, g's
  // fragments scaled in registers; warps below MF also dacc += g @ B^T over
  // m16 fragment `warp` on the unscaled fragment (dh's n8 tiles below r;
  // g scaled by s first unless pow2).
  __device__ __forceinline__ static void mma(float (&acc)[MF][4][4],
                                             float (&dacc)[RMAX / 8][4],
                                             const uint8_t* st,
                                             const NibTable& tb, int cw0,
                                             int r, int warp, int lane,
                                             float scale, bool pow2) {
    const bf16* gs = reinterpret_cast<const bf16*>(st);
    const uint8_t* ws = st + kG;
    const bf16* bs = reinterpret_cast<const bf16*>(ws + kW);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MF][4], bw[2][2][2], ha[4];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        frag_a(af[i], gs + i * 16 * XS, XS, ks, lane);
#pragma unroll
      for (int v = 0; v < 4; ++v) {  // fragment `warp`, unscaled, for dh
        ha[v] = af[0][v];
#pragma unroll
        for (int i = 1; i < MF; ++i)
          if (warp == i) ha[v] = af[i][v];
      }
      if constexpr (kQuant) {
        // a lane's columns of the k step: 2 l4, + 1 (registers 0, 1) and
        // 2 l4 + 8, + 9 (registers 2, 3)
        const float* ss = reinterpret_cast<const float*>(ws + kW + kB) +
                          ks * 16 + 2 * (lane & 3);
        const float2 s0 = *reinterpret_cast<const float2*>(ss);
        const float2 s8 = *reinterpret_cast<const float2*>(ss + 8);
        const float c[4] = {round_to<bf16>(s0.x), round_to<bf16>(s0.y),
                            round_to<bf16>(s8.x), round_to<bf16>(s8.y)};
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const __nv_bfloat162 h =
                *reinterpret_cast<const __nv_bfloat162*>(&af[i][v]);
            af[i][v] = mma::pack_bf16(
                __fmul_rn(__low2float(h), c[(v >> 1) * 2]),
                __fmul_rn(__high2float(h), c[(v >> 1) * 2 + 1]));
          }
      }
      frag_w<F>(bw[0], ws, tb, cw0, 0, ks, lane);
      frag_w<F>(bw[1], ws, tb, cw0, 1, ks, lane);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma::mma_bf16(acc[i][j], af[i], bw[j / 2][j % 2][0],
                        bw[j / 2][j % 2][1]);
      if (warp < MF) {  // warp-uniform
        if (!pow2) {  // round(s g), each product rounded
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const __nv_bfloat162 h =
                *reinterpret_cast<const __nv_bfloat162*>(&ha[v]);
            ha[v] = mma::pack_bf16(__fmul_rn(__low2float(h), scale),
                                   __fmul_rn(__high2float(h), scale));
          }
        }
#pragma unroll
        for (int jp = 0; jp < RMAX / 16; ++jp) {
          if (16 * jp < r) {
            uint32_t bb[4];
            frag_rows<WFmt::kDense>(bb, bs, XS, 0, 2 * jp, ks, lane);
            mma::mma_bf16(dacc[2 * jp], ha, bb[0], bb[1]);
            if (16 * jp + 8 < r)  // else B's rows there are the zero pad
              mma::mma_bf16(dacc[2 * jp + 1], ha, bb[2], bb[3]);
          }
        }
      }
    }
  }
};

// the host's flag that every operand takes 16-byte copies and its offsets
// fit 32 bits: the kernel then copies its slabs by FastLoad
using dense_tc::kFast;

// One thread's 16-byte copies of a slab when every operand allows them
// (kFast), as the forward's FastLoad: each chunk's source offset at n = 0
// (-1 where its row of g or of W0 lies outside the operand; -2 for a row of
// B at or past r, copied as zeros), kept in registers, so that a slab costs
// an add and a compare a chunk. Chunk i of an operand: g row i / 4, columns
// 8 (i % 4) ..; W0 row i / Q, its Q-th part (Q 16-byte parts a row of the
// slab: 4 of bf16, 2 of codes); B row i / 4; S part i.
template <int MF, WFmt F>
struct FastLoad {
  using L = Tile<MF, F>;
  using W = typename wfmt::WStore<bf16, F>::type;
  static constexpr int kGC = MF * 16 * (BK / 8);
  static constexpr int kQ = F == WFmt::kDense ? BK / 8 : BK / 16;
  static constexpr int kWR = wfmt::is_packed(F) ? BN / 2 : BN;
  static constexpr int GE = (kGC + THREADS - 1) / THREADS;
  static constexpr int WE = kWR * kQ / THREADS;
  static_assert(kWR * kQ % THREADS == 0, "whole W0 chunks a thread");
  static_assert(RMAX * (BK / 8) <= THREADS, "a B chunk a thread at most");
  int go[GE], wo[WE], bo;

  __device__ __forceinline__ void init(int M, int K, int N, int r, int hk,
                                       int m0, int k0) {
#pragma unroll
    for (int e = 0; e < GE; ++e) {
      const int i = threadIdx.x + e * THREADS, m = m0 + i / 4;
      go[e] = i < kGC && m < M ? m * N + (i % 4) * 8 : -1;
    }
#pragma unroll
    for (int e = 0; e < WE; ++e) {
      const int i = threadIdx.x + e * THREADS, row = i / kQ;
      const int q = (i % kQ) * (F == WFmt::kDense ? 8 : 16);
      if constexpr (wfmt::is_packed(F))
        wo[e] = k0 / 2 + row < (K + 1) / 2 ? (k0 / 2 + row) * N + q : -1;
      else
        wo[e] = k0 + row < K ? (k0 + row) * N + q : -1;
    }
    const int i = threadIdx.x, j = i / 4;
    bo = i < 16 * hk * 4 ? (j < r ? j * N + (i % 4) * 8 : -2) : -1;
  }

  // the slab at n0 into stage st
  __device__ __forceinline__ void copy(uint8_t* st, const bf16* g,
                                        const W* Q, const float* S,
                                        const bf16* B, int N, int n0) const {
#pragma unroll
    for (int e = 0; e < GE; ++e) {
      const int i = threadIdx.x + e * THREADS, c = (i % 4) * 8;
      const bool ok = go[e] >= 0 && n0 + c < N;
      if (GE * THREADS == kGC || i < kGC)
        mma::cp_async16_l2(st + ((i / 4) * XS + c) * 2,
                           ok ? g + go[e] + n0 : g, ok);
    }
    uint8_t* ws = st + L::kG;
#pragma unroll
    for (int e = 0; e < WE; ++e) {
      const int i = threadIdx.x + e * THREADS, row = i / kQ, q = i % kQ;
      if constexpr (F == WFmt::kDense) {
        const bool ok = wo[e] >= 0 && n0 + q * 8 < N;
        mma::cp_async16_l2(ws + (row * XS + q * 8) * 2,
                           ok ? Q + wo[e] + n0 : Q, ok);
      } else {
        const bool ok = wo[e] >= 0 && n0 + q * 16 < N;
        mma::cp_async16_l2(ws + row * SC + q * 16, ok ? Q + wo[e] + n0 : Q,
                           ok);
      }
    }
    if (bo != -1) {
      const int i = threadIdx.x, c = (i % 4) * 8;
      const bool ok = bo >= 0 && n0 + c < N;
      mma::cp_async16_l2(ws + L::kW + ((i / 4) * XS + c) * 2,
                         ok ? B + bo + n0 : B, ok);
    }
    if constexpr (L::kQuant) {
      const int i = threadIdx.x;
      if (i < BK / 4) {
        const bool ok = n0 + 4 * i < N;
        mma::cp_async16(ws + L::kW + L::kB + 16 * i, ok ? S + n0 + 4 * i : S,
                        ok);
      }
    }
  }
};

// g [M, N] bf16; Q: W0 (bf16 [K, N], int8 codes [K, N] or packed bytes
// [ceil(K/2), N]); S f32 [N] (nullptr for kDense); A [K, r]; B [r, N];
// dx [M, K] bf16. blockIdx.x: 128-column tile of K; blockIdx.y: row tile;
// blockIdx.z: the member of the tile's cluster (its share of N).
template <int MF, WFmt F>
__global__ void __launch_bounds__(THREADS, 3)
    dense_dx_tc(const bf16* __restrict__ g,
                const typename wfmt::WStore<bf16, F>::type* __restrict__ Q,
                const float* __restrict__ S, const bf16* __restrict__ A,
                const bf16* __restrict__ B, bf16* __restrict__ dx, int M,
                int K, int N, int r, float scale, int flags) {
  using L = Tile<MF, F>;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = gridDim.z;  // one cluster a tile
  const int rank = static_cast<int>(cluster.block_rank());

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * ROWS, k0 = blockIdx.x * BN, cw0 = 32 * warp;
  const int rows = MF * 16;
  const int nk = (N + BK - 1) / BK;
  const int s0 = rank * nk / CL, ns = (rank + 1) * nk / CL - s0;
  const int hk = (r + 15) / 16;  // k16 steps over dh's padded columns
  const bool pow2 = flags & kPow2;
  FastLoad<MF, F> fl;
  const bool fast = flags & kFast;
  if (fast) fl.init(M, K, N, r, hk, m0, k0);
  auto load = [&](int stage, int slab) {
    if (fast)
      fl.copy(smem + stage * L::kStage, g, Q, S, B, N, slab * BK);
    else
      L::load(smem + stage * L::kStage, g, Q, S, B, M, K, N, r, hk, m0, k0,
              slab * BK, flags);
  };
  // A's rows for the epilogue into L2 while the loop runs (128-byte lines)
  {
    const int bytes = (K - k0 < BN ? K - k0 : BN) * r * 2;
    const char* a0 = reinterpret_cast<const char*>(A + (size_t)k0 * r);
    for (int off = threadIdx.x * 128; off < bytes; off += THREADS * 128)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(a0 + off));
  }

  // acc: the warp's 32 columns of every row (col_of); dacc: dh's n8 tiles
  // over the rows of m16 fragment `warp`
  float acc[MF][4][4], dacc[RMAX / 8][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
#pragma unroll
      for (int i = 0; i < MF; ++i) acc[i][j][v] = 0.f;
      dacc[j][v] = 0.f;
    }
  NibTable tb;
  if constexpr (wfmt::is_packed(F)) tb = nib_table<F>();

#pragma unroll
  for (int s = 0; s < NSTAGES - 1; ++s) {
    if (s < ns) load(s, s0 + s);
    mma::cp_async_commit();
  }
  for (int kt = 0; kt < ns; ++kt) {
    mma::cp_async_wait<NSTAGES - 2>();
    __syncthreads();
    if (kt + NSTAGES - 1 < ns)
      load((kt + NSTAGES - 1) % NSTAGES, s0 + kt + NSTAGES - 1);
    mma::cp_async_commit();
    L::mma(acc, dacc, smem + (kt % NSTAGES) * L::kStage, tb, cw0, r, warp,
           lane, scale, pow2);
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the block is done with its ring
  // A's rows k0 .. (those below K) for the epilogue, in flight while the
  // cluster meets
  bf16* ar = reinterpret_cast<bf16*>(smem + L::kARaw);
  stage_block<8, THREADS>(ar, AS, A, (size_t)r, k0, 0, BN, (r + 7) / 8 * 8,
                          K, r, flags & kVecA);
  mma::cp_async_commit();
  // every member is done with its ring before the others write over it
  if (CL > 1) cluster.sync();

  // Row `row` of the tile belongs to member row / slots, slot row % slots
  // (slots = ceil(rows / CL) consecutive rows a member). Each member writes
  // its partials of acc and dh for every row into the owner's shared
  // memory (rp [CL][slots][FS], hp [CL][slots][HS], at index rank), each
  // warp first turning one m16 fragment at a time round in its staging
  // tile, in natural column order, so that a remote store of the warp
  // covers 4 rows of 128 contiguous bytes.
  auto member = [&](float* p, int m) {
    return CL > 1 ? cluster.map_shared_rank(p, m) : p;
  };
  const int slots = (rows + CL - 1) / CL;
  float* rp = reinterpret_cast<float*>(smem);
  float* hp = rp + CL * slots * FS;
  float* hr = hp + CL * slots * HS;  // round(dh) of the member's rows
  float* gs = reinterpret_cast<float*>(smem + L::kStaging) + warp * 16 * GS;
  const int gq = lane >> 2, l4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* f = gs + (gq + 8 * half) * GS;
      const int v = 2 * half;
      if constexpr (wfmt::is_packed(F)) {
        // tiles 2p, 2p + 1 hold columns 16 p + 4 l4 + {0, 2} and {1, 3}
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
          *reinterpret_cast<float4*>(f + 16 * pp + 4 * l4) = make_float4(
              acc[i][2 * pp][v], acc[i][2 * pp + 1][v],
              acc[i][2 * pp][v + 1], acc[i][2 * pp + 1][v + 1]);
      } else {
        // tile j holds columns 8 j + 2 l4 + {0, 1}
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(f + 8 * j + 2 * l4) =
              make_float2(acc[i][j][v], acc[i][j][v + 1]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // rows 4 k .. 4 k + 3, 8 lanes a row
      const int rr = 4 * k + lane / 8, c = (lane % 8) * 4;
      const int row = i * 16 + rr;
      *reinterpret_cast<float4*>(
          member(rp, row / slots) + (rank * slots + row % slots) * FS + cw0 +
          c) = *reinterpret_cast<const float4*>(gs + rr * GS + c);
    }
    __syncwarp();
  }
  if (warp < MF) {  // dh's partial of m16 fragment `warp`, the same way
#pragma unroll
    for (int j = 0; j < RMAX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gs[(gq + 8 * (e >> 1)) * GS + 8 * j + 2 * l4 + (e & 1)] = dacc[j][e];
    __syncwarp();
    for (int idx = lane; idx < 16 * r; idx += 32) {
      const int rr = idx / r, j = idx % r, row = warp * 16 + rr;
      member(hp, row / slots)[(rank * slots + row % slots) * HS + j] =
          gs[rr * GS + j];
    }
  }
  mma::cp_async_wait<0>();  // A's rows
  if (CL > 1)
    cluster.sync();  // every member's partials are in place
  else
    __syncthreads();

  // the member's rows rank slots + s: dh summed over the members in rank
  // order, times s where it was not applied to g, and rounded once; A^T
  // [RMAX][BS] into the staging tiles (free now)
  const int first = rank * slots;
  const int mine = first < rows ? min(slots, rows - first) : 0;
  for (int i = threadIdx.x; i < mine * r; i += THREADS) {
    const int sl = i / r, j = i % r;
    float v = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxSplit; ++m)
      if (m < CL) v += hp[(m * slots + sl) * HS + j];
    hr[sl * HS + j] = round_to<bf16>(pow2 ? __fmul_rn(scale, v) : v);
  }
  bf16* at = reinterpret_cast<bf16*>(smem + L::kStaging);
  for (int i = threadIdx.x; i < r * BN; i += THREADS) {
    const int j = i / BN, kk = i % BN;
    at[j * BS + kk] = ar[kk * AS + j];
  }
  __syncthreads();

  constexpr int U = BN / 8;  // units of 8 columns a row
  const bool vy = flags & kVecY;
  for (int idx = threadIdx.x; idx < mine * U; idx += THREADS) {
    const int sl = idx / U, c = (idx % U) * 8;
    const int m = m0 + first + sl, k = k0 + c;
    if (m >= M || k >= K) continue;
    float a[8], d[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) a[q] = d[q] = 0.f;
#pragma unroll
    for (int mm = 0; mm < kMaxSplit; ++mm) {
      if (mm < CL) {
        const float* f = rp + (mm * slots + sl) * FS + c;
        const float4 u = *reinterpret_cast<const float4*>(f);
        const float4 w = *reinterpret_cast<const float4*>(f + 4);
        a[0] += u.x; a[1] += u.y; a[2] += u.z; a[3] += u.w;
        a[4] += w.x; a[5] += w.y; a[6] += w.z; a[7] += w.w;
      }
    }
    for (int j = 0; j < r; ++j) {
      const float hj = hr[sl * HS + j];
      const uint4 u = *reinterpret_cast<const uint4*>(at + j * BS + c);
      const uint32_t aw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
        d[q] = fmaf(hj, __uint_as_float(q % 2 ? aw[q / 2] & 0xffff0000u
                                              : aw[q / 2] << 16),
                    d[q]);
    }
    uint32_t o[4];
#pragma unroll
    for (int q2 = 0; q2 < 4; ++q2)
      o[q2] = mma::pack_bf16(__fadd_rn(a[2 * q2], d[2 * q2]),
                             __fadd_rn(a[2 * q2 + 1], d[2 * q2 + 1]));
    bf16* out = dx + (size_t)m * K + k;
    if (vy && k + 8 <= K) {
      *reinterpret_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (k + q < K)
          out[q] = __ushort_as_bfloat16(
              static_cast<unsigned short>(o[q / 2] >> (16 * (q % 2))));
    }
  }
}

template <int MF, WFmt F>
int launch_mf(const void* g, const void* Q, const float* S, const void* A,
              const void* B, void* dx, int M, int K, int N, int r,
              float scale, int split, cudaStream_t s) {
  using C = typename wfmt::WStore<bf16, F>::type;
  const long long row_tiles = (M + ROWS - 1) / ROWS;
  if (row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kern = dense_dx_tc<MF, F>;
  // the dynamic shared memory, and all of the SM's shared memory carved
  // out for it so that three blocks fit an SM
  if (cudaError_t rc = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          Tile<MF, F>::kBytes))
    return static_cast<int>(rc);
  if (cudaError_t rc = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared))
    return static_cast<int>(rc);
  int flags = 0;
  if (N % 8 == 0 && aligned16(g)) flags |= kVecX;
  if (N % (F == WFmt::kDense ? 8 : 16) == 0 && aligned16(Q)) flags |= kVecW;
  if (r % 8 == 0 && aligned16(A)) flags |= kVecA;
  if (N % 8 == 0 && aligned16(B)) flags |= kVecB;
  if (K % 8 == 0 && aligned16(dx)) flags |= kVecY;
  if (N % 4 == 0 && aligned16(S)) flags |= kVecS;
  if (pow2_scale(scale)) flags |= kPow2;
  const int all = kVecX | kVecW | kVecB | (F == WFmt::kDense ? 0 : kVecS);
  const long long lim = 1LL << 31;
  if ((flags & all) == all && (long long)M * N < lim &&
      (long long)K * N < lim && (long long)r * N < lim)
    flags |= kFast;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((K + BN - 1) / BN, (unsigned)row_tiles, split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Tile<MF, F>::kBytes;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (cudaError_t rc = cudaLaunchKernelEx(
          &cfg, kern, static_cast<const bf16*>(g), static_cast<const C*>(Q),
          S, static_cast<const bf16*>(A), static_cast<const bf16*>(B),
          static_cast<bf16*>(dx), M, K, N, r, scale, flags))
    return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 dx of format F: g [M, N], Q W0 as stored, S f32 [N] (nullptr
// for kDense), A [K, r], B [r, N], dx [M, K], s the LoRA scale.
template <WFmt F>
int launch(const void* g, const void* Q, const void* S, const void* A,
           const void* B, void* dx, int M, int K, int N, int r, float scale,
           int split, void* stream) {
  // the contraction is N: its slabs bound the split
  if (M < 0 || K < 1 || N < 1 || r < 1 || r > RMAX ||
      !dense_tc::split_ok(split, N))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const float* sc = static_cast<const float*>(S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dense_tc::frags_of(M)) {
    case 1:
      return launch_mf<1, F>(g, Q, sc, A, B, dx, M, K, N, r, scale, split,
                               s);
    case 2:
      return launch_mf<2, F>(g, Q, sc, A, B, dx, M, K, N, r, scale, split,
                               s);
    case 3:
      return launch_mf<3, F>(g, Q, sc, A, B, dx, M, K, N, r, scale, split,
                               s);
    default: return launch_mf<4, F>(g, Q, sc, A, B, dx, M, K, N, r, scale, split, s);
  }
}

// The launch plan of format F's dx at g [M, N] -> dx [M, K] with N split
// `split` ways (members of a cluster): the dynamic shared memory (bytes)
// the CUDA runtime holds for the instance M selects (what its last launch
// set); cudaErrorInvalidValue for a split outside split_ok over N.
template <WFmt F>
int plan(int M, int K, int N, int split, int* smem) {
  *smem = -1;
  if (M < 1 || K < 1 || N < 1 || !dense_tc::split_ok(split, N))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t rc;
  switch (dense_tc::frags_of(M)) {
    case 1: rc = cudaFuncGetAttributes(&a, dense_dx_tc<1, F>); break;
    case 2: rc = cudaFuncGetAttributes(&a, dense_dx_tc<2, F>); break;
    case 3: rc = cudaFuncGetAttributes(&a, dense_dx_tc<3, F>); break;
    default: rc = cudaFuncGetAttributes(&a, dense_dx_tc<4, F>); break;
  }
  if (rc == cudaSuccess) *smem = a.maxDynamicSharedSizeBytes;
  return static_cast<int>(rc);
}

}  // namespace dense_dx_tc
