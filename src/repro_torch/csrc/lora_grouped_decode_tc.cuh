// The bf16 grouped LoRA forward over one shared base, for multi-tenant
// decode, on Hopper's tensor cores: the body of lora_grouped_fwd,
// lora_grouped_q and lora_grouped_q4 (lora_grouped_fwd.cu) when the
// activations are bf16. The f32 instances keep that file's CUDA-core body.
//
// Replaces, in bf16, the TPU kernels _grouped_fwd_kernel,
// _grouped_fwd_q_kernel and _grouped_fwd_q4_kernel (with _unpack_tile) of
// src/repro/kernels/lora_grouped.py at Ew = 1:
//
//   y[m] = round(x[m] @ W0 + s * round(x[m] @ A[g]) @ B[g])       kDense
//   y[m] = round(acc * S[n] + s * round(h) @ B[g]),                kInt8,
//          acc = x[m] @ w(codes),  h = x[m] @ A[g]                 kInt4, kNF4
//
// with g = gid[m / bm] read on the device, f32 sums, h rounded to bf16 once
// after the whole K, the epilogue's products and sum each rounded apart
// (__fmul_rn / __fadd_rn), as the plain versions do; only the order of the
// f32 sums differs. w is the int8 code, the sign-extended nibble (int4) or
// the nf4 codebook entry rounded to bf16, each exact in bf16. A gid outside
// [0, R) writes NaN rows.
//
// What bounds it. Decode multiplies a few rows (8 slots) by the whole
// frozen base: 2 M FLOPs per W0 element, far below the card's ridge, so
// the bound is reading W0 once (0.09-2.7 us a launch at qwen2.5-0.5b's
// shapes in bf16, half that over int8, a quarter over packed codes). A
// launch is so short that its time is the launch and the chain of one
// block: its memory round trips, its cluster barriers and, with few warps
// on each scheduler to hide them, the latency of its own instructions
// (scripts/decode_ring_probe.cu measures each step of that chain).
//
// Design:
// * Rows come in parts of P = 16 rows (8 or 4 where a part's slots would
//   need more than 64 h columns), one m16 fragment, so that at decode
//   (M <= 16) W0 is read once a launch. A block of 8 warps owns BN = 64 or
//   128 columns of one part and the slabs of K (KD = 128 rows, whole byte
//   rows of a packed base) of its member of a cluster; warp w runs k16 step
//   w of every slab over all BN columns (mma.sync m16n8k16 on x's fragment
//   and W0's B fragments built in registers by lora_tc.cuh's builders, for
//   every format), so each slab costs one barrier for 128 rows of K.
// * h = x @ A[g] is summed on the tensor cores in the same loop, on the
//   same x fragment: the part's slots (its tiles of bm rows) each stage
//   their A[g] slab side by side, rw = 8 or 16 columns a slot (r rounded
//   up), h_cols <= 64 in all, and each row keeps only its own slot's r
//   columns. h never reaches device memory.
// * Slabs come through a ring of cp.async copies (16 bytes where an
//   operand's rows and base allow, W0's with the L2 128-byte line hint): 4
//   stages over codes, 3 over bf16. When x, W0 and A all take 16-byte
//   copies (FastCopy) each thread's offsets are set once and a slab costs
//   an add a copy. The gid load is issued first; x's and W0's first slabs
//   are issued before it returns; A's first slabs, B's columns of the
//   block's rows and S's columns go out as soon as it does, all in the
//   first copy group, so the epilogue waits on no load.
// * The K range is split across a thread-block cluster of `split` blocks
//   (grid z, at most 8, the portable limit), on whole slabs. After the
//   loop the 8 warps' partials of acc and h are added in the block, in
//   warp order, in shared memory over the idle ring; each member writes
//   its sums for every row into the shared memory of the member that owns
//   the row (distributed shared memory, ceil(rows / split) rows a member)
//   at its rank's place; after a cluster barrier each owner adds the
//   members' sums in rank order (no atomics: equal bits on every run),
//   rounds h to bf16 once, and writes y for its rows. A barrier phase
//   arrived at when the block starts and waited on before the first
//   remote write makes sure every member is running; nothing is read from
//   another block, so a block may leave as soon as its rows are written.
// * The plan (BN, split, P, h_cols) is chosen per shape on the host
//   (kernels/lora_grouped.py, decode_plan) and checked by launch(): BN 128
//   where N has two such column tiles, else 64; the split as many members
//   as the SMs hold of the tiles' blocks at once (one block an SM at BN
//   128, two at 64), at most 8 and at most one a slab. Each
//   block's chain, and the x and A it reads beside its W0 columns, set the
//   time more than the number of blocks does (scripts/
//   profile_torch_grouped.py --family decode_sweep). It depends on the shapes alone, and the
//   entry makes no host synchronisation and no allocation, so a launch can
//   be captured in a CUDA graph.
// * Ragged K and N, odd K over packed codes (the pad nibble zeroed, its x
//   column zero) and unaligned operands are masked in the copies and the
//   fragment builders; nothing is padded and no dense W0 is written.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "lora_tc.cuh"
#include "mma.cuh"
#include "wfmt.cuh"

namespace decode_tc {

namespace cg = cooperative_groups;
using namespace lora_tc;

// Built with -DDECODE_TC_STAMPS (scripts/decode_ring_probe.cu, never the
// library), thread 0 of block (0, 0, 0) records clock64() at the steps of
// its chain, and the cycles its K loop spends waiting, copying and in the
// products, into decode_tc_stamps.
#ifdef DECODE_TC_STAMPS
__device__ long long decode_tc_stamps[16];
#define DECODE_CLOCK() clock64()
#define DECODE_STAMP(i, v)                                            \
  do {                                                                \
    if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&     \
        blockIdx.z == 0)                                              \
      decode_tc_stamps[i] = (v);                                      \
  } while (0)
#else
#define DECODE_CLOCK() 0LL
#define DECODE_STAMP(i, v) \
  do {                     \
  } while (0)
#endif

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int KD = 16 * WARPS;  // slab depth: one k16 step a warp
constexpr int PMAX = 16;        // rows of a part at most (one m16 fragment)
constexpr int HCMAX = 64;       // h columns of a part at most
constexpr int RMAXD = 16;       // largest LoRA rank of the decode entries
constexpr int kMaxSplit = 8;    // the portable cluster size
constexpr int XSD = KD + 8;     // x slab row stride (elements)
constexpr int HT = HCMAX / 8;   // h's n8 tiles a warp holds at most

// the vector flags of the operands: x [., K], W0's rows, A [., r],
// B [r, N], S [N] (f32); kFast: x, W0 and A all take 16-byte copies with
// 32-bit offsets
enum : int { kVX = 1, kVW = 2, kVA = 4, kVB = 8, kVS = 16, kFast = 32 };

// The W0 slab of a block: BN columns of KD rows (KD / 2 byte rows of a
// packed base). Row strides: bf16 (elements) 8 past a multiple of 16, so
// a half warp's 8-byte fragment loads meet distinct banks; int8 (bytes)
// rows 2t of four lanes 32 bytes apart modulo 128; packed (bytes) rows t
// likewise (96, or 160 for 128 columns).
template <int BN, WFmt F>
struct Tile {
  static_assert(BN == 64 || BN == 128, "column tile of 64 or 128");
  using W = typename wfmt::WStore<bf16, F>::type;
  static constexpr int WS = BN + 8, S8 = BN + 16, S4 = BN == 64 ? 96 : 160;
  static constexpr int kW = F == WFmt::kDense  ? KD * WS * 2
                            : F == WFmt::kInt8 ? KD * S8
                                               : KD / 2 * S4;
  static constexpr int kX = PMAX * XSD * 2;
  // ring stages: 2 slabs in flight a block over bf16, 3 over codes
  static constexpr int NST = F == WFmt::kDense ? 3 : 4;
  // blocks an SM the registers allow (the widest tile holds 64 sums of
  // acc a thread)
  static constexpr int MINB = BN == 128 ? 1 : 2;
  // row strides (f32) of the warps' partials of acc and h after the loop
  static constexpr int RS = BN + 4;
};

// Byte offsets of dynamic shared memory: the ring of NST stages (x [PMAX]
// [XSD], A [KD][h_cols + 8], W0), over which the warps' partials of acc
// [WARPS][PMAX][BN + 4] and of h [WARPS][PMAX][h_cols + 4] (f32) lie after
// the loop; then the members' sums of acc [per][split][BN] and of h
// [per][split][RMAXD] for the rows the block owns (per = ceil(rows /
// split), rows = min(part, M)), round(h) [per][RMAXD], B's columns [per]
// [r][BN] (bf16), S's columns [BN], and the slots' gids [PMAX].
struct Layout {
  int kA, stage, hred, psum, hsum, hr, bs, ss, gs, bytes;
};

template <int BN, WFmt F>
__host__ __device__ __forceinline__ Layout layout_of(int hc, int part,
                                                     int split, int M,
                                                     int r) {
  using TL = Tile<BN, F>;
  Layout L;
  L.kA = KD * (hc + 8) * 2;
  L.stage = TL::kX + L.kA + TL::kW;
  L.hred = WARPS * PMAX * TL::RS * 4;
  const int ring = TL::NST * L.stage;
  const int red = L.hred + WARPS * PMAX * (hc + 4) * 4;
  const int rows = part < M ? part : M;
  const int per = (rows + split - 1) / split;
  L.psum = ((ring > red ? ring : red) + 15) & ~15;
  L.hsum = L.psum + per * split * BN * 4;
  L.hr = L.hsum + per * split * RMAXD * 4;
  L.bs = L.hr + per * RMAXD * 4;
  L.ss = L.bs + ((per * r * BN * 2 + 15) & ~15);
  L.gs = L.ss + BN * 4;
  L.bytes = L.gs + PMAX * 4;
  return L;
}

// cluster barrier halves (barrier.cluster): arrive without ordering (the
// block is running), arrive with release, wait with acquire
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the most slots (tiles of bm rows) that one part of `part` rows of M
// touches: a part's count depends only on its first row modulo bm, so
// the first min(parts, bm) parts show every count
__host__ __device__ inline int max_slots(int M, int part, int bm) {
  const int parts = (M + part - 1) / part;
  int most = 0;
  for (int p = 0; p < parts && p < bm; ++p) {
    const int m0 = p * part, m1 = (m0 + part < M ? m0 + part : M) - 1;
    const int n = m1 / bm - m0 / bm + 1;
    most = n > most ? n : most;
  }
  return most;
}

// One thread's 16-byte copies of a slab when x, W0 and A all take them
// (kFast): x's chunk and W0's chunks as offsets at slab 0, set once, so
// that a slab costs an add and a compare a copy. With two warps on each
// of an SM's schedulers little hides a copy loop's index arithmetic,
// which the general loader (stage_block) pays on every slab. x: row t /
// 16, columns 8 (t % 16) ..; W0: chunk t + 256 e, code row i / CPR, its
// (i % CPR)-th 16 bytes; A: K row t % 128 of slot chunks p = t / 128, + 2
template <int BN, WFmt F>
struct FastCopy {
  using TL = Tile<BN, F>;
  using W = typename TL::W;
  static constexpr bool kPacked = wfmt::is_packed(F);
  static constexpr int CE = F == WFmt::kDense ? 8 : 16;  // values a chunk
  static constexpr int CPR = BN / CE;                    // chunks a row
  static constexpr int WR = kPacked ? KD / 2 : KD;       // code rows a slab
  static constexpr int WC = WR * CPR;                    // chunks a slab
  static constexpr int WE = (WC + THREADS - 1) / THREADS;
  static constexpr int WSB = F == WFmt::kDense  ? TL::WS * 2
                             : F == WFmt::kInt8 ? TL::S8
                                                : TL::S4;  // row bytes
  static constexpr int XC = KD / 8;                      // x chunks a row
  static_assert(PMAX * XC == THREADS, "one x chunk a thread");
  int xo, wo[WE];

  __device__ __forceinline__ void init(int K, int N, int rows, int m0,
                                       int n0) {
    const int xr = threadIdx.x / XC;
    xo = xr < rows ? (m0 + xr) * K + (threadIdx.x % XC) * 8 : -1;
#pragma unroll
    for (int e = 0; e < WE; ++e) {
      const int i = threadIdx.x + THREADS * e;
      const int n = n0 + (i % CPR) * CE;
      wo[e] = i < WC && n < N ? (i / CPR) * N + n : -1;
    }
  }

  // x's and W0's chunks of the slab at k0 into stage st (x rows past the
  // part's, W0 columns past N and rows past K zero)
  __device__ __forceinline__ void xw(uint8_t* st, int kA, const bf16* x,
                                     const W* Q, int K, int N,
                                     int k0) const {
    const int xc = (threadIdx.x % XC) * 8;
    const bool xok = xo >= 0 && k0 + xc < K;
    mma::cp_async16(st + ((threadIdx.x / XC) * XSD + xc) * 2,
                    xok ? x + xo + k0 : x, xok);
    uint8_t* ws = st + TL::kX + kA;
    const int kr = kPacked ? k0 / 2 : k0;      // the slab's first code row
    const int nr = kPacked ? (K + 1) / 2 : K;  // code rows of W0
#pragma unroll
    for (int e = 0; e < WE; ++e) {
      const int i = threadIdx.x + THREADS * e;
      if (WE * THREADS == WC || i < WC) {
        const int row = i / CPR, cb = (i % CPR) * 16;
        const bool ok = wo[e] >= 0 && kr + row < nr;
        mma::cp_async16_l2(ws + row * WSB + cb,
                           ok ? Q + wo[e] + (size_t)kr * N : Q, ok);
      }
    }
  }

  // A's chunks of the slab at k0 for the part's ns slots (gids gs; rw = r,
  // 8 or 16) into the A area `as` (row stride hs)
  __device__ __forceinline__ static void a(bf16* as, int hs, const bf16* A,
                                           const int* gs, int ns, int K,
                                           int r, int k0) {
    const int row = threadIdx.x % KD, cps = r >> 4;  // 0: r 8, 1: r 16
    const bool in = k0 + row < K;
    for (int p = threadIdx.x / KD; p < (ns << cps); p += THREADS / KD) {
      const int sl = p >> cps, c = (p - (sl << cps)) * 8;
      const int g = gs[sl];
      const bool ok = in && g >= 0;
      mma::cp_async16(as + row * hs + sl * r + c,
                      ok ? A + ((size_t)g * K + k0 + row) * r + c : A, ok);
    }
  }
};

// x [M, K] bf16; Q: W0 (bf16 [K, N], int8 codes [K, N] or packed bytes
// [ceil(K/2), N]); S f32 [N] (unused for kDense); A [R, K, r]; B [R, r, N];
// gid int32 [M / bm]; y [M, N] bf16. blockIdx.x: column tile; blockIdx.y:
// part; blockIdx.z: the member of the cluster (its share of K's slabs).
template <int BN, WFmt F>
__global__ void __launch_bounds__(THREADS, Tile<BN, F>::MINB)
    decode_fwd_tc(const bf16* __restrict__ x,
                  const typename Tile<BN, F>::W* __restrict__ Q,
                  const float* __restrict__ S, const bf16* __restrict__ A,
                  const bf16* __restrict__ B, const int* __restrict__ gid,
                  bf16* __restrict__ y, int M, int K, int N, int R, int r,
                  int bm, float scale, int hc, int part, int flags) {
  using TL = Tile<BN, F>;
  constexpr int NST = TL::NST, RS = TL::RS;
  extern __shared__ __align__(16) uint8_t smem[];
  // each row of the part: its owner (member), its place there, its slot
  __shared__ int row_owner[PMAX], row_place[PMAX], row_slot[PMAX];
  cg::cluster_group cluster = cg::this_cluster();
  DECODE_STAMP(0, DECODE_CLOCK());
  // this block is running: the others may write its sums from now on
  cluster_arrive_relaxed();
  const int C = gridDim.z;  // one cluster a column tile and part
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout L = layout_of<BN, F>(hc, part, C, M, r);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * part, n0 = blockIdx.x * BN;
  const int rows = min(part, M - m0);
  const int s_lo = m0 / bm;
  const int ns = (m0 + rows - 1) / bm - s_lo + 1;  // the part's slots
  const int rws = r <= 8 ? 3 : 4;                  // log2 h columns a slot
  const int rw = 1 << rws;
  const int nk = (K + KD - 1) / KD;
  const int s0 = rank * nk / C, nsl = (rank + 1) * nk / C - s0;
  const int per = (rows + C - 1) / C;  // rows a member owns
  int* gs = reinterpret_cast<int*>(smem + L.gs);
  const bool fast = flags & kFast;
  FastCopy<BN, F> fc;
  if (fast) fc.init(K, N, rows, m0, n0);

  // 1. the slots' gids: the first load, waited on only at step 4
  int g = -1;
  if (threadIdx.x < ns) g = gid[s_lo + threadIdx.x];

  // 2. x's and W0's first slabs (nothing of theirs depends on the gids)
  auto copy_xw = [&](int stage, int slab) {
    uint8_t* st = smem + stage * L.stage;
    const int k0 = slab * KD;
    if (fast) {
      fc.xw(st, L.kA, x, Q, K, N, k0);
      return;
    }
    stage_block<8, THREADS>(reinterpret_cast<bf16*>(st), XSD, x, (size_t)K,
                            m0, k0, PMAX, KD, m0 + rows, K, flags & kVX);
    uint8_t* ws = st + TL::kX + L.kA;
    if constexpr (F == WFmt::kDense)
      stage_block<8, THREADS, bf16, true>(reinterpret_cast<bf16*>(ws),
                                          TL::WS, Q, (size_t)N, k0, n0, KD,
                                          BN, K, N, flags & kVW);
    else if constexpr (F == WFmt::kInt8)
      stage_block<16, THREADS, int8_t, true>(reinterpret_cast<int8_t*>(ws),
                                             TL::S8, Q, (size_t)N, k0, n0,
                                             KD, BN, K, N, flags & kVW);
    else
      stage_block<16, THREADS, uint8_t, true>(ws, TL::S4, Q, (size_t)N,
                                              k0 / 2, n0, KD / 2, BN,
                                              (K + 1) / 2, N, flags & kVW);
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s)
    if (s < nsl) copy_xw(s, s0 + s);

  // 3. the h columns past the slots' stay zero in every stage (no copy
  // writes them); the row tables
  const int hused = ns * rw;
  if (hused < hc)
    for (int i = threadIdx.x; i < NST * KD; i += THREADS) {
      bf16* as = reinterpret_cast<bf16*>(smem + (i / KD) * L.stage +
                                         TL::kX) +
                 (i % KD) * (hc + 8);
      for (int c = hused; c < hc; ++c) as[c] = zero<bf16>();
    }
  if (threadIdx.x < PMAX) {
    const int i = threadIdx.x;
    row_owner[i] = i / per;
    row_place[i] = i - (i / per) * per;
    row_slot[i] = (m0 + i) / bm - s_lo;
  }

  // 4. the gids (outside [0, R): -1, its rows NaN)
  if (threadIdx.x < ns) gs[threadIdx.x] = g >= 0 && g < R ? g : -1;
  __syncthreads();
  DECODE_STAMP(1, DECODE_CLOCK());

  // 5. A's first slabs, B's columns of the rows this block owns and S's
  // columns, in the first copy group with step 2's copies
  auto copy_a = [&](int stage, int slab) {
    bf16* as = reinterpret_cast<bf16*>(smem + stage * L.stage + TL::kX);
    const int k0 = slab * KD;
    if (fast) {
      FastCopy<BN, F>::a(as, hc + 8, A, gs, ns, K, r, k0);
      return;
    }
    for (int sl = 0; sl < ns; ++sl) {
      const int gg = gs[sl];
      stage_block<8, THREADS>(as + sl * rw, hc + 8,
                              A + (size_t)(gg < 0 ? 0 : gg) * K * r,
                              (size_t)r, k0, 0, KD, rw, gg < 0 ? 0 : K, r,
                              flags & kVA);
    }
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s)
    if (s < nsl) copy_a(s, s0 + s);
  const int own0 = rank * per;
  const int nown = max(0, min(per, rows - own0));
  bf16* bs = reinterpret_cast<bf16*>(smem + L.bs);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  // B's rows j < r, columns n0 .. of each owned row's slot: one pass over
  // (row, j, chunk of 8)
  constexpr int BQ = BN / 8;
  const bool vb = flags & kVB;
  for (int i = threadIdx.x; i < nown * r * BQ; i += THREADS) {
    const int oj = i / BQ, c = (i % BQ) * 8;
    const int o = oj / r, j = oj - o * r;
    const int gg = gs[row_slot[own0 + o]];
    const bf16* bsrc = B + ((size_t)(gg < 0 ? 0 : gg) * r + j) * N + n0 + c;
    bf16* bdst = bs + oj * BN + c;
    if (vb) {
      const bool ok = gg >= 0 && n0 + c < N;
      mma::cp_async16(bdst, ok ? bsrc : B, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        bdst[e] = gg >= 0 && n0 + c + e < N ? bsrc[e] : zero<bf16>();
    }
  }
  if constexpr (F != WFmt::kDense)
    stage_block<4, THREADS>(ss, 0, S, 0, 0, n0, 1, BN, 1, N, flags & kVS);
  mma::cp_async_commit();
#pragma unroll
  for (int s = 1; s < NST - 1; ++s) mma::cp_async_commit();
  DECODE_STAMP(2, DECODE_CLOCK());

  // acc: the warp's k16 step of each slab over all BN columns (tile j,
  // lane group g: column 32 (j / 4) + 4 g + j % 4); hacc: the same step
  // over h's columns (natural order, pairs of n8 tiles)
  float acc[BN / 8][4], hacc[HT][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
#pragma unroll
  for (int j = 0; j < HT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) hacc[j][v] = 0.f;
  const int hp = hc / 16;  // h column pairs
  NibTable tb;
  if constexpr (wfmt::is_packed(F)) tb = nib_table<F>();

  long long t_wait = 0, t_copy = 0, t_mma = 0;
  for (int kt = 0; kt < nsl; ++kt) {
    const long long c0 = DECODE_CLOCK();
    mma::cp_async_wait<NST - 2>();
    __syncthreads();
    const long long c1 = DECODE_CLOCK();
    if (kt + NST - 1 < nsl) {
      const int stage = (kt + NST - 1) % NST, slab = s0 + kt + NST - 1;
      copy_xw(stage, slab);
      copy_a(stage, slab);
    }
    mma::cp_async_commit();
    const long long c2 = DECODE_CLOCK();
    const uint8_t* st = smem + (kt % NST) * L.stage;
    const bf16* xs = reinterpret_cast<const bf16*>(st);
    const bf16* as = reinterpret_cast<const bf16*>(st + TL::kX);
    const uint8_t* ws = st + TL::kX + L.kA;
    uint32_t af[4];
    frag_a(af, xs, XSD, warp, lane);
#pragma unroll
    for (int c = 0; c < BN / 32; ++c) {
      uint32_t bw[4][2];
      if constexpr (F == WFmt::kDense)
        frag_b16(bw, reinterpret_cast<const bf16*>(ws), TL::WS, 32 * c, warp,
                 lane);
      else if constexpr (F == WFmt::kInt8)
        frag_b8<TL::S8>(bw, ws, 32 * c, warp, lane);
      else
        frag_b4<TL::S4>(bw, ws, tb, 32 * c, warp, K - (s0 + kt) * KD, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma::mma_bf16(acc[4 * c + j], af, bw[j][0], bw[j][1]);
    }
#pragma unroll
    for (int p = 0; p < HT / 2; ++p) {
      if (p < hp) {  // block-uniform
        uint32_t ba[4];
        frag_bt(ba, as, hc + 8, 16 * p, warp, lane);
        mma::mma_bf16(hacc[2 * p], af, ba[0], ba[1]);
        mma::mma_bf16(hacc[2 * p + 1], af, ba[2], ba[3]);
      }
    }
    const long long c3 = DECODE_CLOCK();
    t_wait += c1 - c0;
    t_copy += c2 - c1;
    t_mma += c3 - c2;
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials go over it
  DECODE_STAMP(3, DECODE_CLOCK());
  DECODE_STAMP(8, t_wait);
  DECODE_STAMP(9, t_copy);
  DECODE_STAMP(10, t_mma);

  // the warp's partials: acc at red[warp][row][column], h at
  // hred[warp][row][h column]
  float* red = reinterpret_cast<float*>(smem);
  float* hred = reinterpret_cast<float*>(smem + L.hred);
  const int g8 = lane >> 2, l4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* f = red + (warp * PMAX + g8 + 8 * half) * RS + 8 * l4;
#pragma unroll
    for (int c = 0; c < BN / 32; ++c) {
      const float(*a4)[4] = acc + 4 * c;
      *reinterpret_cast<float4*>(f + 32 * c) =
          make_float4(a4[0][2 * half], a4[1][2 * half], a4[2][2 * half],
                      a4[3][2 * half]);
      *reinterpret_cast<float4*>(f + 32 * c + 4) =
          make_float4(a4[0][2 * half + 1], a4[1][2 * half + 1],
                      a4[2][2 * half + 1], a4[3][2 * half + 1]);
    }
  }
#pragma unroll
  for (int t = 0; t < HT; ++t) {
    if (t < 2 * hp) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            hred + (warp * PMAX + g8 + 8 * half) * (hc + 4) + 8 * t +
            2 * l4) = make_float2(hacc[t][2 * half], hacc[t][2 * half + 1]);
    }
  }
  __syncthreads();

  // Row i of the part belongs to member row_owner[i], place row_place[i]
  // there. The block's sums over its warps (in warp order) go into the
  // owner's shared memory: acc at psum[place][rank][column], h at
  // hsum[place][rank][j].
  cluster_wait();  // every member is running
  DECODE_STAMP(4, DECODE_CLOCK());
  float* psum = reinterpret_cast<float*>(smem + L.psum);
  float* hsum = reinterpret_cast<float*>(smem + L.hsum);
  constexpr int Q4 = BN / 4;  // float4 units of a row
  for (int idx = threadIdx.x; idx < rows * Q4; idx += THREADS) {
    const int i = idx / Q4, c = 4 * (idx % Q4);
    float4 v = *reinterpret_cast<const float4*>(red + i * RS + c);
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 u =
          *reinterpret_cast<const float4*>(red + (w * PMAX + i) * RS + c);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(
        cluster.map_shared_rank(psum, row_owner[i]) +
        (row_place[i] * C + rank) * BN + c) = v;
  }
  for (int idx = threadIdx.x; idx < rows * RMAXD; idx += THREADS) {
    const int i = idx / RMAXD, j = idx % RMAXD;
    if (j < r) {
      const float* h = hred + i * (hc + 4) + row_slot[i] * rw + j;
      float v = h[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v += h[w * PMAX * (hc + 4)];
      cluster.map_shared_rank(hsum, row_owner[i])[(row_place[i] * C + rank) *
                                                      RMAXD +
                                                  j] = v;
    }
  }
  cluster_arrive();
  DECODE_STAMP(5, DECODE_CLOCK());
  cluster_wait();  // every member's sums are in place
  DECODE_STAMP(6, DECODE_CLOCK());

  // the owner's rows own0 + o: h summed over the members in rank order and
  // rounded once, then acc likewise
  float* hr = reinterpret_cast<float*>(smem + L.hr);
  for (int idx = threadIdx.x; idx < nown * RMAXD; idx += THREADS) {
    const int o = idx / RMAXD, j = idx % RMAXD;
    if (j < r) {
      float v = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxSplit; ++m)
        if (m < C) v += hsum[(o * C + m) * RMAXD + j];
      hr[idx] = round_to<bf16>(v);
    }
  }
  __syncthreads();
  constexpr int PAIRS = BN / 2;
  const bool y2 = N % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 3) == 0;
  for (int idx = threadIdx.x; idx < nown * PAIRS; idx += THREADS) {
    const int o = idx / PAIRS, c = 2 * (idx % PAIRS);
    const int m = m0 + own0 + o, n = n0 + c;
    if (n >= N) continue;
    const int gg = gs[row_slot[own0 + o]];
    float a0 = 0.f, a1 = 0.f;
    const float* pp = psum + o * C * BN + c;
#pragma unroll
    for (int mm = 0; mm < kMaxSplit; ++mm) {
      if (mm < C) {
        const float2 v = *reinterpret_cast<const float2*>(pp + mm * BN);
        a0 += v.x;
        a1 += v.y;
      }
    }
    float d0 = 0.f, d1 = 0.f;
    const bf16* bp = bs + o * r * BN + c;
    for (int j = 0; j < r; ++j) {
      const float hj = hr[o * RMAXD + j];
      const float2 bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bp + j * BN));
      d0 = fmaf(hj, bv.x, d0);
      d1 = fmaf(hj, bv.y, d1);
    }
    float v0 = NAN, v1 = NAN;
    if (gg >= 0) {
      if constexpr (F == WFmt::kDense) {
        v0 = __fadd_rn(a0, __fmul_rn(scale, d0));
        v1 = __fadd_rn(a1, __fmul_rn(scale, d1));
      } else {
        v0 = __fadd_rn(__fmul_rn(a0, ss[c]), __fmul_rn(scale, d0));
        v1 = __fadd_rn(__fmul_rn(a1, ss[c + 1]), __fmul_rn(scale, d1));
      }
    }
    bf16* out = y + (size_t)m * N + n;
    if (y2) {
      *reinterpret_cast<uint32_t*>(out) = mma::pack_bf16(v0, v1);
    } else {
      out[0] = __float2bfloat16(v0);
      if (n + 1 < N) out[1] = __float2bfloat16(v1);
    }
  }
  DECODE_STAMP(7, DECODE_CLOCK());
}

template <int BN, WFmt F>
int launch_bn(const void* x, const void* Q, const void* S, const void* A,
              const void* B, const void* gid, void* y, int M, int K, int N,
              int R, int r, int bm, float scale, int split, int part, int hc,
              cudaStream_t stream) {
  using W = typename Tile<BN, F>::W;
  auto kern = decode_fwd_tc<BN, F>;
  const Layout L = layout_of<BN, F>(hc, part, split, M, r);
  if (cudaError_t rc = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes))
    return static_cast<int>(rc);
  if (cudaError_t rc = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared))
    return static_cast<int>(rc);
  int flags = 0;
  if (K % 8 == 0 && aligned16(x)) flags |= kVX;
  if (N % (F == WFmt::kDense ? 8 : 16) == 0 && aligned16(Q)) flags |= kVW;
  if (r % 8 == 0 && aligned16(A)) flags |= kVA;
  if (N % 8 == 0 && aligned16(B)) flags |= kVB;
  if (N % 4 == 0 && aligned16(S)) flags |= kVS;
  const long long lim = 1LL << 31;
  if ((flags & (kVX | kVW | kVA)) == (kVX | kVW | kVA) &&
      (long long)M * K < lim && (long long)K * N < lim)
    flags |= kFast;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + part - 1) / part, split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (cudaError_t rc = cudaLaunchKernelEx(
          &cfg, kern, static_cast<const bf16*>(x), static_cast<const W*>(Q),
          static_cast<const float*>(S), static_cast<const bf16*>(A),
          static_cast<const bf16*>(B), static_cast<const int*>(gid),
          static_cast<bf16*>(y), M, K, N, R, r, bm, scale, hc, part, flags))
    return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 decode forward of format F with the host's plan: split members
// of a cluster over K, column tiles of bn, parts of `part` rows, hc h
// columns a part. A plan the body cannot run (a member without a slab, h
// columns too few for a part's slots) is refused, not mended.
template <WFmt F>
int launch(const void* x, const void* Q, const void* S, const void* A,
           const void* B, const void* gid, void* y, int M, int K, int N,
           int R, int r, int bm, float scale, int split, int bn, int part,
           int hc, cudaStream_t stream) {
  const int nk = (K + KD - 1) / KD;
  const int rw = r <= 8 ? 8 : 16;
  if (split < 1 || split > kMaxSplit || split > nk ||
      (bn != 64 && bn != 128) ||
      (part != 4 && part != 8 && part != PMAX) ||
      hc % 16 != 0 || hc > HCMAX || max_slots(M, part, bm) * rw > hc ||
      (M + part - 1) / part > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 64)
    return launch_bn<64, F>(x, Q, S, A, B, gid, y, M, K, N, R, r, bm, scale,
                            split, part, hc, stream);
  return launch_bn<128, F>(x, Q, S, A, B, gid, y, M, K, N, R, r, bm, scale,
                           split, part, hc, stream);
}

}  // namespace decode_tc
