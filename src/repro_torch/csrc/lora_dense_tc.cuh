// The bf16 dense LoRA forward over one W0 on Hopper's tensor cores: the
// body of lora_fused_fwd (lora_fused_fwd.cu), lora_fused_q (lora_quant.cu)
// and lora_fused_q4 (lora_pack4.cu) when the activations are bf16. The f32
// instances keep lora_gemm.cuh's CUDA-core body; the bf16 dx is this body
// turned round (lora_dense_dx_tc.cuh), which takes its shapes and split.
//
// Replaces, in bf16, the TPU kernels lora_fused (src/repro/kernels/
// lora_fused.py, _lora_fused_kernel), lora_fused_q (lora_quant.py,
// _lora_fused_q_kernel) and lora_fused_q4 (lora_pack4.py,
// _lora_fused_q4_kernel, _unpack_tile):
//
//   y = round(x @ W0 + s * round(x @ A) @ B)                    kDense
//   y = round(acc * S[n] + s * round(h) @ B),                    kInt8,
//       acc = x @ w(codes),  h = x @ A                           kInt4, kNF4
//
// f32 sums, h rounded to bf16 once after the whole K, the epilogue's
// products and sum each rounded apart (__fmul_rn / __fadd_rn), as
// lora_gemm.cuh's gemm_body and the plain versions do; only the order of
// the f32 sums differs. w is the int8 code, the sign-extended nibble (int4)
// or the nf4 codebook entry rounded to bf16: each exact in bf16. With an odd
// K over a packed base the pad nibble is zeroed and meets a zero x column.
//
// What bounds it. At the training paths' shapes (M 192 or 256 rows; K x N
// 896 x 896, 896 x 128, 896 x 4864, 4864 x 896; OLMoE's 2048 x 2048) a
// launch does 2 M FLOPs per W0 element it reads: 192-256 FLOP/byte in bf16,
// near the H100's ridge of ~295, and above it over codes. But every launch
// is small (0.06-2.2 GFLOP, 0.2-3.5 us at the card's peaks), so what sets
// its time is how much of the card it fills, how long each block's serial
// chain of slabs is, and how fast the slabs come from L2 (a launch rereads
// x once per column tile and W0 once per row tile). A dense launch has
// only 3-4 row tiles of 64.
//
// Design:
// * The K loop (Tile) is built from lora_tc.cuh's fragment loaders, code
//   conversions and slab copies, which the grouped forward
//   (lora_grouped_tc.cuh) shares: a block of 4 warps owns MF m16 row
//   fragments (MF = ceil(min(M, 64) / 16)) by 128 output columns, 32 a
//   warp; slabs of BK = 32 come through a 4-stage cp.async ring; mma.sync
//   m16n8k16 on x's fragments (ldmatrix) and W0's B fragments built in
//   registers from bf16 or codes; h = x @ A on the same x fragments. When
//   every operand takes 16-byte copies the slabs are copied by FastLoad,
//   whose per-thread offsets are set once, not by the general loader's
//   index arithmetic on every slab; ragged and unaligned operands take the
//   general loader, which masks ragged M, K and N (rows and columns past
//   their ends staged as zero).
// * The K range is split across a thread-block cluster of C blocks (grid z,
//   at most 8, the portable limit): member z sums slabs [z nk / C,
//   (z + 1) nk / C) of both x @ W0 and h. The caller passes C per shape
//   (kernels/autotune.py's choose_blocks: a measured plan, else the rule
//   of enough blocks for two an SM, at least 4 slabs a member). The rule
//   at M 256: q, o 7; k, v 7; gate, up 2; down 8; 2048 x 2048 5.
// * The tile's rows are shared out: member z owns ceil(rows / C)
//   consecutive rows. After a cluster barrier (every ring free), each
//   member writes its f32 partials of acc and h for every row into the
//   owner's shared memory (distributed shared memory), at its own rank's
//   place, one m16 fragment at a time turned around in a warp's staging
//   tile so that each remote store covers 4 rows of 128 contiguous bytes
//   (straight from the accumulators a store would scatter 16-byte pieces
//   over 8 rows, which draft timings found slower); after a second barrier
//   each owner adds the C partials of its rows in rank order (fixed order,
//   no atomics: the same bits on every run), rounds h to bf16 once, and
//   writes y = acc + s * round(h) @ B (or acc * S[n] + s * d) for them, 8
//   adjacent columns a thread (one 16-byte store). h never reaches device
//   memory, and no workspace or second launch is needed. C = 1 takes the
//   same path with block barriers.
// * B's columns (and S's) are copied with the first slab, so the epilogue
//   waits on no load.
// * Dynamic shared memory (the ring or the epilogue's partials, whichever is
//   larger, beside B's and S's columns: 36-75 KB) is allowed per instance
//   with cudaFuncSetAttribute before each launch, with the SM's shared
//   memory carved out in full so that three blocks fit an SM; plan() reads
//   the size back from the runtime.
// Not yet: wgmma with TMA. In draft timings the cp.async slab copies and
// the partials' way through distributed shared memory, not the tensor
// cores, set the time; a persistent grid.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "lora_tc.cuh"
#include "mma.cuh"
#include "wfmt.cuh"

namespace dense_tc {

namespace cg = cooperative_groups;
using namespace lora_tc;

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int BN = 32 * WARPS;  // output columns a block, 32 a warp
constexpr int ROWS = 64;        // rows a block at most (MF <= 4)
constexpr int kMaxSplit = 8;    // the portable cluster size
constexpr int NSTAGES = 4;      // ring stages
// row strides of the partial tile (f32), of h's partial and rounding (f32)
// and of B's columns (bf16)
constexpr int FS = BN + 4, HS = RMAX + 1, BS = BN + 8;
// row stride (f32) of a warp's staging tile, [16][GS]: its 32 columns of
// one m16 fragment
constexpr int GS = 32 + 4;

// A block's tile: MF m16 row fragments by BN columns, W0 in format F. Its
// shared memory (a ring of NSTAGES slabs, then, over the ring, the
// epilogue's partials), its slab copy by the general loader and its
// products on one slab.
template <int MF, WFmt F>
struct Tile {
  using C = typename wfmt::WStore<bf16, F>::type;
  static_assert(WARPS >= MF, "warp w < MF sums h for m16 fragment w");
  // row strides of a W0 slab: bf16 (elements) 8 past a multiple of 16, so
  // the 16 lanes of a half warp's 8-byte fragment loads meet distinct
  // banks; int8 (bytes) rows 2t of four lanes 8 words apart; packed (bytes)
  // rows t 8 words apart
  static constexpr int WS = BN + 8, S8 = BN + 16, S4 = BN + 32;
  // bytes of x, A and W0 in one ring stage, and of the whole ring
  static constexpr int kX = MF * 16 * XS * 2;
  static constexpr int kA = BK * AS * 2;
  static constexpr int kW = F == WFmt::kDense  ? BK * WS * 2
                            : F == WFmt::kInt8 ? BK * S8
                                               : BK / 2 * S4;
  static constexpr int kStage = kX + kA + kW;
  static constexpr int kRing = NSTAGES * kStage;
  // the epilogue over the ring: the C members' partials of acc and h for
  // the rows a member owns (C x ceil(rows / C) slots at most), round(h) of
  // those rows, and each warp's staging tile, which no other member writes
  static constexpr int kSlots = MF * 16 + kMaxSplit - 1;
  static constexpr int kStaging =
      (kSlots * (FS + HS) * 4 + MF * 16 * HS * 4 + 15) & ~15;
  static constexpr int kEpi = kStaging + WARPS * 16 * GS * 4;
  // (16-byte aligned, as B's copies need)
  static constexpr int kMain = ((kRing > kEpi ? kRing : kEpi) + 15) & ~15;
  // beside it, loaded with the first slab: B's columns [RMAX][BS] and S's
  static constexpr int kB = RMAX * BS * 2;
  static constexpr int kBytes = kMain + kB + BN * 4;

  // Stage the slab at k0 into st: x's rows m0 .. (those below m_end; row
  // stride K), A [K, r], W0's columns n0 .. (codes: byte rows k0 / 2 ..).
  __device__ __forceinline__ static void load(uint8_t* st, const bf16* x,
                                              const C* Q, const bf16* A,
                                              int K, int N, int r, int m0,
                                              int m_end, int n0, int k0,
                                              int flags) {
    stage_block<8, THREADS>(reinterpret_cast<bf16*>(st), XS, x, (size_t)K,
                            m0, k0, MF * 16, BK, m_end, K, flags & kVecX);
    stage_block<8, THREADS>(reinterpret_cast<bf16*>(st + kX), AS, A,
                            (size_t)r, k0, 0, BK, (r + 7) / 8 * 8, K, r,
                            flags & kVecA);
    if constexpr (F == WFmt::kDense)
      stage_block<8, THREADS>(reinterpret_cast<bf16*>(st + kX + kA), WS, Q,
                              (size_t)N, k0, n0, BK, BN, K, N,
                              flags & kVecW);
    else if constexpr (F == WFmt::kInt8)
      stage_block<16, THREADS>(reinterpret_cast<int8_t*>(st + kX + kA), S8,
                               Q, (size_t)N, k0, n0, BK, BN, K, N,
                               flags & kVecW);
    else
      stage_block<16, THREADS>(st + kX + kA, S4, Q, (size_t)N, k0 / 2, n0,
                               BK / 2, BN, (K + 1) / 2, N, flags & kVecW);
  }

  // acc += the slab's x @ w(W0) over the warp's 32 columns (cw0 ..) of
  // every row (tile j, lane group g: column 4 g + j); warps below MF also
  // hacc += x @ A over m16 fragment `warp` (hk k16 steps of h's padded
  // columns). kv: K less the slab's first row (rows at or past it are
  // zero); tb: the nibble table (packed formats).
  __device__ __forceinline__ static void mma(float (&acc)[MF][4][4],
                                             float (&hacc)[RMAX / 8][4],
                                             const uint8_t* st,
                                             const NibTable& tb, int cw0,
                                             int kv, int hk, int warp,
                                             int lane) {
    const bf16* xs = reinterpret_cast<const bf16*>(st);
    const bf16* as = reinterpret_cast<const bf16*>(st + kX);
    const uint8_t* ws = st + kX + kA;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MF][4], bw[4][2];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        frag_a(af[i], xs + i * 16 * XS, XS, ks, lane);
      if constexpr (F == WFmt::kDense)
        frag_b16(bw, reinterpret_cast<const bf16*>(ws), WS, cw0, ks, lane);
      else if constexpr (F == WFmt::kInt8)
        frag_b8<S8>(bw, ws, cw0, ks, lane);
      else
        frag_b4<S4>(bw, ws, tb, cw0, ks, kv, lane);
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
};

// the vector flags of a forward's operands: x [., K], W0's rows of N
// elements or codes, A [., r], B [r, N], y [., N], S [., N] (f32)
inline int vec_flags(WFmt f, const void* x, const void* Q, const void* A,
                     const void* B, const void* y, int K, int N, int r,
                     const void* S = nullptr) {
  int flags = 0;
  if (N % 4 == 0 && aligned16(S)) flags |= kVecS;
  if (K % 8 == 0 && aligned16(x)) flags |= kVecX;
  if (N % (f == WFmt::kDense ? 8 : 16) == 0 && aligned16(Q)) flags |= kVecW;
  if (r % 8 == 0 && aligned16(A)) flags |= kVecA;
  if (N % 8 == 0 && aligned16(B)) flags |= kVecB;
  if (N % 8 == 0 && aligned16(y)) flags |= kVecY;
  return flags;
}

// the host's flag that every operand takes 16-byte copies and its offsets
// fit 32 bits: the kernel then copies its slabs by FastLoad
constexpr int kFast = 64;

// One thread's 16-byte copies of a slab when every operand allows them
// (kFast): each chunk's source offset at slab 0 (-1 where its row of x or
// its columns of W0 lie outside the operand), kept in registers, so that a
// slab costs an add and a compare a chunk, not the general loader's index
// arithmetic. Chunk i of an operand: x row i / 4, columns 8 (i % 4) ..;
// W0 row i / Q, its Q-th part (Q 16-byte parts a row: 16 bf16, 8 codes);
// A row i / (r / 8).
template <int MF, WFmt F>
struct FastLoad {
  using L = Tile<MF, F>;
  using W = typename wfmt::WStore<bf16, F>::type;
  static constexpr int kXC = MF * 16 * (BK / 8);
  static constexpr int kQ = F == WFmt::kDense ? BN / 8 : BN / 16;
  static constexpr int kWR = wfmt::is_packed(F) ? BK / 2 : BK;
  static constexpr int XE = (kXC + THREADS - 1) / THREADS;
  static constexpr int WE = kWR * kQ / THREADS;
  static_assert(kWR * kQ % THREADS == 0, "whole W0 chunks a thread");
  int xo[XE], wo[WE], ao;

  __device__ __forceinline__ void init(int M, int K, int N, int r, int m0,
                                       int n0) {
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int i = threadIdx.x + e * THREADS, m = m0 + i / 4;
      xo[e] = i < kXC && m < M ? m * K + (i % 4) * 8 : -1;
    }
#pragma unroll
    for (int e = 0; e < WE; ++e) {
      const int i = threadIdx.x + e * THREADS;
      const int n = n0 + (i % kQ) * (F == WFmt::kDense ? 8 : 16);
      wo[e] = n < N ? (i / kQ) * N + n : -1;
    }
    const int ca = r / 8, i = threadIdx.x;
    ao = i < BK * ca ? (i / ca) * r + (i % ca) * 8 : -1;
  }

  // the slab at k0 into stage st
  __device__ __forceinline__ void copy(uint8_t* st, const bf16* x,
                                        const W* Q, const bf16* A, int K,
                                        int N, int r, int k0) const {
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int i = threadIdx.x + e * THREADS, c = (i % 4) * 8;
      const bool ok = xo[e] >= 0 && k0 + c < K;
      if (XE * THREADS == kXC || i < kXC)
        mma::cp_async16(st + ((i / 4) * XS + c) * 2,
                        ok ? x + xo[e] + k0 : x, ok);
    }
    const int ca = r / 8;
    if (ao >= 0) {
      const int i = threadIdx.x, row = i / ca;
      const bool ok = k0 + row < K;
      mma::cp_async16(st + L::kX + (row * AS + (i % ca) * 8) * 2,
                      ok ? A + ao + (size_t)k0 * r : A, ok);
    }
    uint8_t* wst = st + L::kX + L::kA;
#pragma unroll
    for (int e = 0; e < WE; ++e) {
      const int i = threadIdx.x + e * THREADS, row = i / kQ, q = i % kQ;
      if constexpr (F == WFmt::kDense) {
        const bool ok = wo[e] >= 0 && k0 + row < K;
        mma::cp_async16(wst + (row * L::WS + q * 8) * 2,
                        ok ? Q + wo[e] + (size_t)k0 * N : Q, ok);
      } else if constexpr (F == WFmt::kInt8) {
        const bool ok = wo[e] >= 0 && k0 + row < K;
        mma::cp_async16(wst + row * L::S8 + q * 16,
                        ok ? Q + wo[e] + (size_t)k0 * N : Q, ok);
      } else {
        const bool ok = wo[e] >= 0 && k0 / 2 + row < (K + 1) / 2;
        mma::cp_async16(wst + row * L::S4 + q * 16,
                        ok ? Q + wo[e] + (size_t)(k0 / 2) * N : Q, ok);
      }
    }
  }
};

// x [M, K] bf16; Q: W0 (bf16 [K, N], int8 codes [K, N] or packed bytes
// [ceil(K/2), N]); S f32 [N] (nullptr for kDense); A [K, r]; B [r, N];
// y [M, N] bf16. blockIdx.x: column tile; blockIdx.y: row tile; blockIdx.z:
// the member of the tile's cluster (its share of K).
template <int MF, WFmt F>
__global__ void __launch_bounds__(THREADS, 3)
    dense_fwd_tc(const bf16* __restrict__ x,
                 const typename wfmt::WStore<bf16, F>::type* __restrict__ Q,
                 const float* __restrict__ S, const bf16* __restrict__ A,
                 const bf16* __restrict__ B, bf16* __restrict__ y, int M,
                 int K, int N, int r, float scale, int flags) {
  using L = Tile<MF, F>;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.z;  // one cluster a tile
  const int rank = static_cast<int>(cluster.block_rank());

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * BN, cw0 = 32 * warp;
  const int rows = MF * 16;
  const int nk = (K + BK - 1) / BK;
  const int s0 = rank * nk / C, ns = (rank + 1) * nk / C - s0;
  FastLoad<MF, F> fl;
  const bool fast = flags & kFast;
  if (fast) fl.init(M, K, N, r, m0, n0);
  auto load = [&](int stage, int slab) {
    if (fast)
      fl.copy(smem + stage * L::kStage, x, Q, A, K, N, r, slab * BK);
    else
      L::load(smem + stage * L::kStage, x, Q, A, K, N, r, m0, M, n0,
              slab * BK, flags);
  };

  // acc: the warp's 32 columns of every row (tile j, lane group g: column
  // 4 g + j); hacc: h's n8 tiles over the rows of m16 fragment `warp`
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

  // B's columns n0 .. (rows below r) and S's, for the epilogue, in the
  // first slab's copy group
  bf16* bs = reinterpret_cast<bf16*>(smem + L::kMain);
  float* ss = reinterpret_cast<float*>(smem + L::kMain + L::kB);
  stage_block<8, THREADS>(bs, BS, B, (size_t)N, 0, n0, r, BN, r, N,
                          flags & kVecB);
  if constexpr (F != WFmt::kDense)
    stage_block<4, THREADS>(ss, 0, S, 0, 0, n0, 1, BN, 1, N, flags & kVecS);
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
    L::mma(acc, hacc, smem + (kt % NSTAGES) * L::kStage, tb, cw0,
           K - (s0 + kt) * BK, hk, warp, lane);
  }
  mma::cp_async_wait<0>();
  // every member is done with its ring before the others write over it
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();

  // Row `row` of the tile belongs to member row / slots, slot row % slots
  // (slots = ceil(rows / C) consecutive rows a member). Each member writes
  // its partials of acc and h for every row into the owner's shared memory
  // (rp [C][slots][FS], hp [C][slots][HS], at index rank). A lane holds 8
  // adjacent columns of each of its rows (column 8 l4 + q: tile q % 4's
  // entry of n index 2 l4 + q / 4); each warp first turns one m16 fragment
  // at a time around in its staging tile, so that a remote store of the
  // warp covers 4 rows of 128 contiguous bytes.
  auto member = [&](float* p, int m) {
    return C > 1 ? cluster.map_shared_rank(p, m) : p;
  };
  const int slots = (rows + C - 1) / C;
  float* rp = reinterpret_cast<float*>(smem);
  float* hp = rp + C * slots * FS;
  float* hr = hp + C * slots * HS;  // round(h) of the member's rows
  float* gs = reinterpret_cast<float*>(smem + L::kStaging) + warp * 16 * GS;
  const int g = lane >> 2, l4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* f = gs + (g + 8 * half) * GS + 8 * l4;
      const int v = 2 * half;
      *reinterpret_cast<float4*>(f) = make_float4(
          acc[i][0][v], acc[i][1][v], acc[i][2][v], acc[i][3][v]);
      *reinterpret_cast<float4*>(f + 4) = make_float4(
          acc[i][0][v + 1], acc[i][1][v + 1], acc[i][2][v + 1],
          acc[i][3][v + 1]);
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
  if (warp < MF) {  // h's partial of m16 fragment `warp`, the same way
#pragma unroll
    for (int j = 0; j < RMAX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gs[(g + 8 * (e >> 1)) * GS + 8 * j + 2 * l4 + (e & 1)] = hacc[j][e];
    __syncwarp();
    for (int idx = lane; idx < 16 * r; idx += 32) {
      const int rr = idx / r, j = idx % r, row = warp * 16 + rr;
      member(hp, row / slots)[(rank * slots + row % slots) * HS + j] =
          gs[rr * GS + j];
    }
  }
  if (C > 1)
    cluster.sync();  // every member's partials are in place
  else
    __syncthreads();

  // the member's rows rank slots + s: h summed over the members in rank
  // order and rounded once, then acc likewise, all from its own shared
  // memory
  const int first = rank * slots;
  const int mine = first < rows ? min(slots, rows - first) : 0;
  for (int i = threadIdx.x; i < mine * r; i += THREADS) {
    const int sl = i / r, j = i % r;
    float v = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxSplit; ++m)
      if (m < C) v += hp[(m * slots + sl) * HS + j];
    hr[sl * HS + j] = round_to<bf16>(v);
  }
  __syncthreads();

  constexpr int U = BN / 8;  // units of 8 columns a row
  const bool vy = flags & kVecY;
  for (int idx = threadIdx.x; idx < mine * U; idx += THREADS) {
    const int sl = idx / U, c = (idx % U) * 8;
    const int m = m0 + first + sl, n = n0 + c;
    if (m >= M || n >= N) continue;
    float a[8], d[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) a[q] = d[q] = 0.f;
#pragma unroll
    for (int mm = 0; mm < kMaxSplit; ++mm) {
      if (mm < C) {
        const float* f = rp + (mm * slots + sl) * FS + c;
        const float4 u = *reinterpret_cast<const float4*>(f);
        const float4 w = *reinterpret_cast<const float4*>(f + 4);
        a[0] += u.x; a[1] += u.y; a[2] += u.z; a[3] += u.w;
        a[4] += w.x; a[5] += w.y; a[6] += w.z; a[7] += w.w;
      }
    }
    for (int j = 0; j < r; ++j) {
      const float hj = hr[sl * HS + j];
      const uint4 u = *reinterpret_cast<const uint4*>(bs + j * BS + c);
      const uint32_t bw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
        d[q] = fmaf(hj, __uint_as_float(q % 2 ? bw[q / 2] & 0xffff0000u
                                              : bw[q / 2] << 16),
                    d[q]);
    }
    uint32_t o[4];
#pragma unroll
    for (int q2 = 0; q2 < 4; ++q2) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * q2 + e;
        if constexpr (F == WFmt::kDense)
          v[e] = __fadd_rn(a[q], __fmul_rn(scale, d[q]));
        else
          v[e] = __fadd_rn(__fmul_rn(a[q], ss[c + q]),
                           __fmul_rn(scale, d[q]));
      }
      o[q2] = mma::pack_bf16(v[0], v[1]);
    }
    bf16* out = y + (size_t)m * N + n;
    if (vy && n + 8 <= N) {
      *reinterpret_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (n + q < N)
          out[q] = __ushort_as_bfloat16(
              static_cast<unsigned short>(o[q / 2] >> (16 * (q % 2))));
    }
  }
}

// rows a block holds for M rows, as m16 fragments
inline int frags_of(int M) { return ((M < ROWS ? M : ROWS) + 15) / 16; }

// The hard limits of a K split: 1 .. kMaxSplit members (the portable
// cluster size), at most one a slab of BK. The split itself is the host's
// choice (kernels/autotune.py: a measured plan, else the heuristic).
inline bool split_ok(int split, int K) {
  return split >= 1 && split <= kMaxSplit && split <= (K + BK - 1) / BK;
}

template <int MF, WFmt F>
int launch_mf(const void* x, const void* Q, const float* S, const void* A,
              const void* B, void* y, int M, int K, int N, int r, float scale,
              int split, cudaStream_t s) {
  using C = typename wfmt::WStore<bf16, F>::type;
  const long long row_tiles = (M + ROWS - 1) / ROWS;
  if (row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kern = dense_fwd_tc<MF, F>;
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
  int flags = vec_flags(F, x, Q, A, B, y, K, N, r, S);
  const int all = kVecX | kVecW | kVecA;
  const long long lim = 1LL << 31;
  if ((flags & all) == all && (long long)M * K < lim &&
      (long long)K * N < lim && (long long)K * r < lim)
    flags |= kFast;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (unsigned)row_tiles, split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Tile<MF, F>::kBytes;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (cudaError_t rc = cudaLaunchKernelEx(
          &cfg, kern, static_cast<const bf16*>(x), static_cast<const C*>(Q),
          S, static_cast<const bf16*>(A), static_cast<const bf16*>(B),
          static_cast<bf16*>(y), M, K, N, r, scale,
          flags))
    return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 forward of format F: x [M, K], Q W0 as stored, S f32 [N]
// (nullptr for kDense), A [K, r], B [r, N], y [M, N], K split across
// `split` members (cudaErrorInvalidValue outside split_ok: never clamped).
template <WFmt F>
int launch(const void* x, const void* Q, const void* S, const void* A,
           const void* B, void* y, int M, int K, int N, int r, float scale,
           int split, void* stream) {
  if (M < 0 || K < 1 || N < 1 || r < 1 || r > RMAX || !split_ok(split, K))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const float* sc = static_cast<const float*>(S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (frags_of(M)) {
    case 1:
      return launch_mf<1, F>(x, Q, sc, A, B, y, M, K, N, r, scale, split,
                               s);
    case 2:
      return launch_mf<2, F>(x, Q, sc, A, B, y, M, K, N, r, scale, split,
                               s);
    case 3:
      return launch_mf<3, F>(x, Q, sc, A, B, y, M, K, N, r, scale, split,
                               s);
    default: return launch_mf<4, F>(x, Q, sc, A, B, y, M, K, N, r, scale, split, s);
  }
}

// The launch plan of format F at M x K -> N split `split` ways: the
// dynamic shared memory (bytes) the CUDA runtime allows the instance M
// selects, what launch set before that instance's last launch
// (cudaErrorInvalidValue for a split outside split_ok).
template <WFmt F>
int plan(int M, int K, int N, int split, int* smem) {
  *smem = -1;
  if (M < 1 || K < 1 || N < 1 || !split_ok(split, K))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t rc;
  switch (frags_of(M)) {
    case 1: rc = cudaFuncGetAttributes(&a, dense_fwd_tc<1, F>); break;
    case 2: rc = cudaFuncGetAttributes(&a, dense_fwd_tc<2, F>); break;
    case 3: rc = cudaFuncGetAttributes(&a, dense_fwd_tc<3, F>); break;
    default: rc = cudaFuncGetAttributes(&a, dense_fwd_tc<4, F>); break;
  }
  if (rc == cudaSuccess) *smem = a.maxDynamicSharedSizeBytes;
  return static_cast<int>(rc);
}

}  // namespace dense_tc
