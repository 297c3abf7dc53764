// The bf16 LoRA factor gradients on Hopper's tensor cores: the body of
// lora_dab (lora_dab.cu, one group: the dense linear) and lora_grouped_dab
// (lora_grouped_train.cu, per-expert stacks) when the activations are bf16.
// The f32 instances keep lora_dab.cuh's CUDA-core row blocks and their
// reduce kernels.
//
// Replaces, in bf16, the TPU kernels lora_dab (src/repro/kernels/
// lora_fused.py, _lora_dab_kernel) and lora_grouped_dab (lora_grouped.py,
// _grouped_dab_kernel), with their arithmetic and roundings:
//
//   sg = round(s g),  h = round(x @ A),  dh = round(sg @ B^T)
//   dA = x^T dh  [K, r],   dB = h^T sg  [r, N]
//
// x [M, K], g [M, N], A [K, r], B [r, N] (r <= 32); f32 sums, h and dh
// rounded to bf16 once after their whole contraction, dA and dB once after
// the sum over every row of the group. round(s g) is __fmul_rn then RN to
// bf16, as the plain version rounds it; for s a power of two of magnitude
// 1 or more s g is exact, and s multiplies dh's and dB's f32 sums instead
// (lora_tc::pow2_scale). Only the order of the f32 sums differs from the
// plain versions. Grouped: rows come in tiles of bm, tile t belongs to
// group gid[t]; a group's tiles must be one contiguous run (else its dA and
// dB are NaN), a group with no tile gets zeros, a tile whose gid lies
// outside [0, E) adds to no group.
//
// What bounds it: reading x and g once. The outputs are r-thin and a
// launch does 8 r FLOPs per element of x or g, far below the H100's ridge
// (~295 FLOP/byte). At the paths' shapes (M 192-256 dense; E 64 x 40 rows
// grouped) that is 0.1-0.9 us dense and 6.6 us grouped, so what sets the
// time is each block's serial chain: its slab's copies, h and dh, two
// cluster barriers, dA and dB, its stores (and, dense, the partials' sum).
//
// Design, one launch:
// * A thread-block cluster of C members (grid x, at most 8, or 16 where a
//   member's slice of 8 would not fit shared memory: qwen2.5-32b's MLP,
//   K or N 27,648, through H100's non-portable cluster size) owns a run of
//   rows: the grouped entry one cluster a group, its run of tiles; the
//   dense entry the M rows split into S sub-runs (grid y), one cluster
//   each. Member c owns 16-column tiles [c nKt / C, (c + 1) nKt / C) of K
//   and the same share of N's tiles. It queues its first chunk of rows and
//   B's [r][N slice] by cp.async, then turns A's slice round into [r][K
//   slice] (16-byte loads of A's rows) while they arrive, and walks its run
//   in chunks of R = 16 RF rows: x[chunk, K slice] and g[chunk, N slice]
//   side by side in one slab row (double-buffered when a run has more
//   chunks than its sub-runs), read from device memory once.
// * h and dh on tensor cores: mma.sync m16n8k16 over the member's columns,
//   x's or g's fragments (ldmatrix) against A's or B's slice (frag_rows),
//   every warp a share of the columns of one m16 row fragment; the warps'
//   partials are added in warp order, then the members' through
//   distributed shared memory: after a cluster barrier every member adds
//   the C partials in rank order, so that each holds bitwise the same h
//   and dh, rounded once to bf16. They never reach device memory. The
//   partials are double-buffered, so one cluster barrier a chunk suffices;
//   the last is split in two (arrive after the last read of another
//   member, wait before exit), so that the stores run inside it.
// * dA and dB on tensor cores: the member's slice of dA = x^T dh and of
//   dB^T = sg^T h, M = the slice's columns (m16 tiles), N = r, the sum over
//   the chunk's rows: x's and g's fragments come from the same slab by
//   ldmatrix.trans, dh's and h's by frag_bt. The f32 sums stay in
//   registers across the run (each warp MT m16 x RM tiles, 64 floats);
//   where a member's slice has more tiles than its warps hold, grid y
//   carries Q passes, each over its share of the tiles (x and g are then
//   read once per pass: no path shape needs more than one at r <= 16).
// * Cross-block partials: grouped, none (each cluster writes dA[e] and
//   dB[e]). Dense with S > 1 sub-runs, each cluster writes its f32 dA and
//   dB to a workspace of S (not M / 8) partials; the last block of the S
//   that share a column slice (an arrival count per slice, atomics on the
//   count only, which that block sets back to zero) adds the S partials in
//   sub-run order, all S loads in flight at once, and writes the output. No
//   second launch and no atomics on values: the same bits on every run.
// * The host picks C, S, RF and Q per shape (plan): C members so that the
//   clusters fill the card once (E 64: 2, 128 blocks of one a SM) and the
//   slice fits shared memory and the registers; S sub-runs of at most
//   kMaxSub so that dense launches fill half the card without many
//   partials (M 256: 8 x 8 blocks). On the card, 4 or 16 sub-runs and 4
//   members a group were slower at the paths' shapes.
// Draft timings on the card put most of a grouped block's time outside
// its arithmetic: in the slab's copies, and between the last dA/dB
// mma.sync and the end of the stores, whether the sums were stored from
// registers, staged in shared memory in the outputs' order, or dumped and
// written by a rolled loop (each tried; the simplest is kept).
// Not yet: wgmma and TMA.
#pragma once

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "lora_tc.cuh"
#include "mma.cuh"

namespace dab_tc {

namespace cg = cooperative_groups;
using namespace lora_tc;

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int kMaxC = 8;        // the portable cluster size: plans start
constexpr int kMaxCWide = 16;   // H100's non-portable cluster size: a plan
                                // takes more than 8 members only where a
                                // member's slice would not fit at 8
constexpr int kMaxSub = 8;      // dense sub-runs at most
constexpr int kAccTiles = 16;   // m16 x n8 sum tiles a warp holds (64 f32)
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have
// flags: 16-byte copies of x, g, B, 16-byte loads of A's rows; s a power
// of two >= 1
enum : int { kVx = 1, kVg = 2, kVb = 4, kVa = 8, kPow2 = 16 };

// RM: the rank rounded up to 8, 16 or 32 (NT n8 tiles of r); MT: the m16
// tiles of dA / dB^T a warp holds; RP: rows of A's and B's slices, and
// columns of h's and dh's, staged (at least 16: a B fragment load covers
// two n8 tiles); HS: row stride of h and dh (bf16, 8 past a multiple of
// 16, so that an ldmatrix's 8 rows meet distinct banks).
template <int RM>
struct Rank {
  static constexpr int NT = RM / 8, MT = kAccTiles / NT;
  static constexpr int RP = RM < 16 ? 16 : RM, HS = RP + 8;
};

// The shared memory of a block, in bytes from its base: nbuf slabs x
// [R][XS] of x | g, the slices F [RP][XS] of A^T | B, the warps' partials
// of h | dh [WARPS][16][2 RM] (f32), the block's [2][R][2 RM] (f32, read by
// the other members), h and dh [R][HS] (bf16), and four ints.
struct Layout {
  int x, f, pw, p, h, dh, info, bytes;
  __host__ __device__ Layout(int RM, int RF, int XS, int nbuf) {
    const int R = 16 * RF, RP = RM < 16 ? 16 : RM, HS = RP + 8;
    x = 0;
    f = x + nbuf * R * XS * 2;
    pw = f + RP * XS * 2;
    p = pw + WARPS * 16 * 2 * RM * 4;
    h = p + 2 * R * 2 * RM * 4;
    dh = h + R * HS * 2;
    info = dh + R * HS * 2;
    bytes = info + 16;
  }
};

struct Params {
  const bf16 *x, *g, *a, *b;
  const int* gid;  // tile -> group (grouped), nullptr (dense: one group)
  bf16 *da, *db;
  float* ws;       // dense, S > 1: S f32 partials of [dA | dB]
  int* cnt;        // dense, S > 1: C Q arrival counts, zero between calls
  int M, K, N, E, r, bm;
  float scale;
  int C, S, Q, RF, nbuf, XS, nKt, nNt, flags;
};

// The A fragment of the m16 x k16 block whose (m, k) entry is t[k0 + k]
// [c0 + m]: the transpose of a slab block, by ldmatrix.trans.
__device__ __forceinline__ void frag_at(uint32_t (&a)[4], const bf16* t,
                                        int ts, int c0, int k0, int lane) {
  const int mat = lane >> 3;
  mma::ldsm_x4_t(a, t + (k0 + (lane & 7) + 8 * (mat >> 1)) * ts + c0 +
                        8 * (mat & 1));
}

// the cluster barrier in two halves: arrive (release) once the block's
// last read of another member's shared memory is done, wait (acquire)
// before the block exits, so that no member leaves while another may
// still read it
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// a fragment's bf16 values times s, each product rounded (round(s g))
__device__ __forceinline__ void scale_frag(uint32_t (&a)[4], float s) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&a[v]);
    a[v] = mma::pack_bf16(__fmul_rn(__low2float(h), s),
                          __fmul_rn(__high2float(h), s));
  }
}

// blockIdx.x: the member (its share of K's and N's tiles); blockIdx.y:
// unit u (a dense sub-run or a group) times Q plus the pass.
template <int RM>
__global__ void __launch_bounds__(THREADS, 1) dab_tc(const Params p) {
  using RK = Rank<RM>;
  constexpr int NT = RK::NT, MT = RK::MT, RP = RK::RP, HS = RK::HS;
  constexpr int W2 = 2 * RM;  // a row of h | dh partials
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C, rank = static_cast<int>(cluster.block_rank());
  const int unit = blockIdx.y / p.Q, q = blockIdx.y % p.Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = p.K, N = p.N, r = p.r, RF = p.RF, R = 16 * RF, XS = p.XS;
  const bool pow2 = p.flags & kPow2;
  const Layout L(RM, RF, XS, p.nbuf);
  bf16* X = reinterpret_cast<bf16*>(smem + L.x);
  bf16* F = reinterpret_cast<bf16*>(smem + L.f);
  float* Pw = reinterpret_cast<float*>(smem + L.pw);
  float* P = reinterpret_cast<float*>(smem + L.p);
  bf16* H = reinterpret_cast<bf16*>(smem + L.h);
  bf16* DH = reinterpret_cast<bf16*>(smem + L.dh);
  int* info = reinterpret_cast<int*>(smem + L.info);

  // the member's tiles: K's [kt0, kt0 + ktc), then N's [nt0, nt0 + ntc);
  // this pass holds tiles [tp0, tp1) of the T
  const int kt0 = rank * p.nKt / C, ktc = (rank + 1) * p.nKt / C - kt0;
  const int nt0 = rank * p.nNt / C, ntc = (rank + 1) * p.nNt / C - nt0;
  const int T = ktc + ntc;
  const int tp0 = q * WARPS * MT, tp1 = min(T, tp0 + WARPS * MT);

  // the run of rows [row0, row1), and the group's A, B, dA and dB
  const bf16 *A = p.a, *B = p.b;
  bf16 *dA = p.da, *dB = p.db;
  int row0, row1;
  bool split = false;
  if (p.gid != nullptr) {
    const int e = unit, tiles = p.M / p.bm;
    if (threadIdx.x == 0) {
      info[0] = INT_MAX;
      info[1] = -1;
      info[2] = 0;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < tiles; t += THREADS) {
      if (p.gid[t] == e) {  // atomics on the count, never on values
        atomicMin(&info[0], t);
        atomicMax(&info[1], t);
        atomicAdd(&info[2], 1);
      }
    }
    __syncthreads();
    const int first = info[0], last = info[1], count = info[2];
    split = count > 0 && count != last - first + 1;
    row0 = count > 0 ? first * p.bm : 0;
    row1 = count > 0 ? (last + 1) * p.bm : 0;
    A += (size_t)e * K * r;
    B += (size_t)e * r * N;
    dA += (size_t)e * K * r;
    dB += (size_t)e * r * N;
  } else {
    const int nch = (p.M + R - 1) / R;
    row0 = unit * nch / p.S * R;
    row1 = min(p.M, (unit + 1) * nch / p.S * R);
  }

  // the pass's outputs: dA rows [ka, kb), dB columns [na, nb)
  const int ka = 16 * (kt0 + min(tp0, ktc)),
            kb = min(K, 16 * (kt0 + min(tp1, ktc)));
  const int na = 16 * (nt0 + max(tp0, ktc) - ktc),
            nb = min(N, 16 * (nt0 + max(tp1, ktc) - ktc));
  if (split) {  // the whole cluster takes this branch: no barrier is met
    const bf16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
    for (int i = ka * r + threadIdx.x; i < kb * r; i += THREADS) dA[i] = nan;
    const int wn = max(nb - na, 0);
    for (int i = threadIdx.x; i < r * wn; i += THREADS)
      dB[(size_t)(i / wn) * N + na + i % wn] = nan;
    return;
  }

  const int nch = (row1 - row0 + R - 1) / R;
  auto load = [&](int buf, int c) {
    bf16* xs = X + buf * R * XS;
    const int r0 = row0 + c * R;
    stage_block<8, THREADS>(xs, XS, p.x, (size_t)K, r0, 16 * kt0, R,
                            16 * ktc, row1, K, p.flags & kVx);
    stage_block<8, THREADS>(xs + 16 * ktc, XS, p.g, (size_t)N, r0, 16 * nt0,
                            R, 16 * ntc, row1, N, p.flags & kVg);
  };
  // the first chunk and B's slice (rows past r zero) in flight first
  if (nch > 0) load(0, 0);
  stage_block<8, THREADS>(F + 16 * ktc, XS, B, (size_t)N, 0, 16 * nt0, RP,
                          16 * ntc, r, N, p.flags & kVb);
  mma::cp_async_commit();
  // A's slice turned round into F[j][c] meanwhile: 16-byte loads of A's
  // rows (8 ranks each) where they allow them, element by element (rows
  // past r zero) elsewhere. Rows past r below RP are then left as they
  // are: they meet only h's and dh's columns past r, which reach no output
  if (p.flags & kVa) {
    const int rc = r / 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < 16 * ktc * rc; i += THREADS) {
      const int c = i / rc, q8 = (i % rc) * 8, k = 16 * kt0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < K) v = *reinterpret_cast<const uint4*>(A + (size_t)k * r + q8);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        F[(q8 + e) * XS + c] = __ushort_as_bfloat16(
            static_cast<unsigned short>(w[e / 2] >> (16 * (e % 2))));
    }
  } else {
    for (int i = threadIdx.x; i < RP * 16 * ktc; i += THREADS) {
      const int j = i / (16 * ktc), c = i % (16 * ktc), k = 16 * kt0 + c;
      F[j * XS + c] = j < r && k < K ? A[(size_t)k * r + j] : zero<bf16>();
    }
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][j][v] = 0.f;
  // warp -> m16 row fragment fi, part kp of that fragment's KS parts of
  // the member's T column tiles
  const int fi = warp % RF, kp = warp / RF, KS = (WARPS - 1 - fi) / RF + 1;
  const int s0 = kp * T / KS, s1 = (kp + 1) * T / KS;
  const int gq = lane >> 2, l4 = lane & 3;
  auto member = [&](float* ptr, int m) {
    return C > 1 ? cluster.map_shared_rank(ptr, m) : ptr;
  };

  for (int ch = 0; ch < nch; ++ch) {
    const int buf = p.nbuf == 2 ? ch & 1 : 0;
    if (p.nbuf == 1 && ch > 0) {
      __syncthreads();  // the block is done with the slab's last chunk
      load(0, ch);
      mma::cp_async_commit();
    }
    mma::cp_async_wait<0>();
    __syncthreads();  // the chunk (and F) in place; the other slab free
    if (p.nbuf == 2 && ch + 1 < nch) {
      load(buf ^ 1, ch + 1);
      mma::cp_async_commit();
    }
    const bf16* xs = X + buf * R * XS;

    // partial h (x tiles) and dh (g tiles) of fragment fi over tiles
    // [s0, s1) of the member's columns
    {
      float hacc[NT][4], dacc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) hacc[j][v] = dacc[j][v] = 0.f;
      for (int t = s0; t < s1; ++t) {
        uint32_t af[4];
        frag_a(af, xs + fi * 16 * XS, XS, t, lane);
        const bool gt = t >= ktc;  // warp-uniform
        if (gt && !pow2) scale_frag(af, p.scale);
#pragma unroll
        for (int jp = 0; jp < (NT + 1) / 2; ++jp) {
          if (16 * jp < r) {
            uint32_t bb[4];
            frag_rows<WFmt::kDense>(bb, F, XS, 0, 2 * jp, t, lane);
            if (gt)
              mma::mma_bf16(dacc[2 * jp], af, bb[0], bb[1]);
            else
              mma::mma_bf16(hacc[2 * jp], af, bb[0], bb[1]);
            if (2 * jp + 1 < NT && 16 * jp + 8 < r) {
              if (gt)
                mma::mma_bf16(dacc[2 * jp + 1], af, bb[2], bb[3]);
              else
                mma::mma_bf16(hacc[2 * jp + 1], af, bb[2], bb[3]);
            }
          }
        }
      }
      float* pw = Pw + warp * 16 * W2;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = gq + 8 * (e >> 1), col = 8 * j + 2 * l4 + (e & 1);
          pw[row * W2 + col] = hacc[j][e];
          pw[row * W2 + RM + col] = dacc[j][e];
        }
    }
    __syncthreads();
    // the block's partial: each fragment's warps added in warp order
    float* pb = P + (ch & 1) * R * W2;
    for (int i = threadIdx.x; i < R * W2; i += THREADS) {
      const int m = i / W2, col = i % W2, f = m / 16;
      float v = 0.f;
      for (int w = f; w < WARPS; w += RF)
        v += Pw[(w * 16 + m % 16) * W2 + col];
      pb[i] = v;
    }
    if (C > 1)
      cluster.sync();  // every member's partial in place
    else
      __syncthreads();
    // h and dh: the members' partials in rank order, rounded once
    for (int i = threadIdx.x; i < R * W2; i += THREADS) {
      float v = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxCWide; ++m)
        if (m < C) v += member(pb, m)[i];
      const int row = i / W2, col = i % W2;
      if (col < RM)
        H[row * HS + col] = __float2bfloat16(v);
      else
        DH[row * HS + col - RM] =
            __float2bfloat16(pow2 ? __fmul_rn(p.scale, v) : v);
    }
    __syncthreads();

    // dA (x tiles: x^T dh) and dB^T (g tiles: sg^T h) over the chunk
#pragma unroll 1
    for (int ks = 0; ks < RF; ++ks) {
      uint32_t bd[(NT + 1) / 2][4], bh[(NT + 1) / 2][4];
#pragma unroll
      for (int jp = 0; jp < (NT + 1) / 2; ++jp) {
        frag_bt(bd[jp], DH, HS, 16 * jp, ks, lane);
        frag_bt(bh[jp], H, HS, 16 * jp, ks, lane);
      }
#pragma unroll
      for (int u = 0; u < MT; ++u) {
        const int t = tp0 + warp + WARPS * u;
        if (t < tp1) {  // warp-uniform
          uint32_t af[4];
          frag_at(af, xs, XS, 16 * t, 16 * ks, lane);
          const bool gt = t >= ktc;
          if (gt && !pow2) scale_frag(af, p.scale);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (8 * j < r) {
              const int v = 2 * (j % 2);
              mma::mma_bf16(acc[u][j], af, gt ? bh[j / 2][v] : bd[j / 2][v],
                            gt ? bh[j / 2][v + 1] : bd[j / 2][v + 1]);
            }
          }
        }
      }
    }
  }
  mma::cp_async_wait<0>();  // nothing in flight (an empty run's F)
  // every read of another member's partials is done; the matching wait
  // comes before the block exits (finish)
  if (C > 1) cluster_arrive();
  auto finish = [&] {
    if (C > 1) cluster_wait();
  };

  // the outputs: dA[k][j] from tile t < ktc (row m of the tile: k), dB[j][n]
  // from the others; dense with S > 1: this sub-run's f32 partial
  const bool partial = p.gid == nullptr && p.S > 1;
  const size_t per = (size_t)K * r + (size_t)r * N;
  float* wsu = partial ? p.ws + unit * per : nullptr;
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    const int t = tp0 + warp + WARPS * u;
    if (t >= tp1) continue;
    const bool gt = t >= ktc;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = gq + 8 * (e >> 1), jj = 8 * j + 2 * l4 + (e & 1);
        if (jj >= r) continue;
        float v = acc[u][j][e];
        size_t idx;
        if (!gt) {
          const int k = 16 * (kt0 + t) + m;
          if (k >= K) continue;
          idx = (size_t)k * r + jj;
        } else {
          const int n = 16 * (nt0 + t - ktc) + m;
          if (n >= N) continue;
          if (pow2) v = __fmul_rn(p.scale, v);
          idx = (size_t)K * r + (size_t)jj * N + n;
        }
        if (partial)
          wsu[idx] = v;
        else if (!gt)
          dA[idx] = __float2bfloat16(v);
        else
          dB[idx - (size_t)K * r] = __float2bfloat16(v);
      }
  }
  if (!partial) return finish();

  // the last of the S blocks of this slice and pass adds the S partials in
  // sub-run order, every partial's load in flight before the first add
  __threadfence();
  __syncthreads();
  int* count = p.cnt + q * C + rank;
  if (threadIdx.x == 0) info[3] = atomicAdd(count, 1) == p.S - 1;
  __syncthreads();
  if (!info[3]) return finish();
  __threadfence();
  const int S = p.S;
  auto sum = [&](size_t o) {
    float u[kMaxSub];
#pragma unroll
    for (int s = 0; s < kMaxSub; ++s)
      u[s] = s < S ? __ldcg(p.ws + s * per + o) : 0.f;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSub; ++s)
      if (s < S) v += u[s];
    return __float2bfloat16(v);
  };
#pragma unroll 2
  for (int i = ka * r + threadIdx.x; i < kb * r; i += THREADS)
    dA[i] = sum(i);
  const int wn = max(nb - na, 0);
#pragma unroll 2
  for (int i = threadIdx.x; i < r * wn; i += THREADS) {
    const size_t o = (size_t)(i / wn) * N + na + i % wn;
    dB[o] = sum((size_t)K * r + o);
  }
  if (threadIdx.x == 0) *count = 0;  // ready for the next call
  finish();
}

// the card's SMs
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

// A launch's plan: C members a cluster, S dense sub-runs (1 grouped), Q
// passes, RF m16 fragments a chunk, nbuf slabs, the slab row stride XS and
// the dynamic shared memory.
struct Plan {
  int C, S, Q, RF, nbuf, XS, smem;
};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// Grouped (E groups, tiles of bm rows): C so that E clusters fill the card
// once; dense (M rows): C = 8 and S sub-runs of at most kMaxSub. Then more
// members while a slice has more tiles than the warps hold or does not fit
// shared memory. Returns false where no plan fits.
template <int RM>
bool plan_of(bool grouped, int M, int K, int N, int E, int bm, Plan* pl) {
  constexpr int cap = WARPS * Rank<RM>::MT;
  const int nKt = (K + 15) / 16, nNt = (N + 15) / 16;
  int C = grouped ? sm_count() / E : kMaxC;
  C = clampi(C < nKt + nNt ? C : nKt + nNt, 1, kMaxC);
  for (;; ++C) {
    const int T = (nKt + C - 1) / C + (nNt + C - 1) / C;
    const int Q = (T + cap - 1) / cap;
    if (Q > 1 && C < kMaxC) continue;
    const int XS = 16 * T + 8;
    int RF, S, nbuf;
    if (grouped) {
      RF = clampi(((bm < 64 ? bm : 64) + 15) / 16, 1, 4);
      S = 1;
      nbuf = 2;
    } else {
      const int per = (M + kMaxSub - 1) / kMaxSub;
      RF = clampi((per + 15) / 16, 1, 4);
      const int nch = (M + 16 * RF - 1) / (16 * RF);
      S = clampi(nch, 1, kMaxSub);
      nbuf = nch > S ? 2 : 1;
    }
    while (Layout(RM, RF, XS, nbuf).bytes > kSmemMax) {
      if (nbuf == 2) {
        nbuf = 1;
      } else if (RF > 1) {
        --RF;
        if (!grouped) {
          const int nch = (M + 16 * RF - 1) / (16 * RF);
          S = clampi(nch, 1, kMaxSub);
          nbuf = nch > S ? 2 : 1;
        }
      } else {
        break;
      }
    }
    const int bytes = Layout(RM, RF, XS, nbuf).bytes;
    if (bytes <= kSmemMax) {
      *pl = {C, S, Q, RF, nbuf, XS, bytes};
      return true;
    }
    if (C >= kMaxCWide) return false;
  }
}

// the plan of rank r (RM its rounding up to 8, 16 or 32)
inline bool plan_r(bool grouped, int M, int K, int N, int E, int bm, int r,
                   Plan* pl) {
  if (r <= 8) return plan_of<8>(grouped, M, K, N, E, bm, pl);
  if (r <= 16) return plan_of<16>(grouped, M, K, N, E, bm, pl);
  return plan_of<32>(grouped, M, K, N, E, bm, pl);
}

template <int RM>
int launch_rm(Params p, const Plan& pl, int units, cudaStream_t s) {
  auto kern = dab_tc<RM>;
  if (cudaError_t rc = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem))
    return static_cast<int>(rc);
  if (pl.C > kMaxC) {
    if (cudaError_t rc = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
      return static_cast<int>(rc);
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = pl.C;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.C, (unsigned)(units * pl.Q));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (cudaError_t rc = cudaLaunchKernelEx(&cfg, kern, p))
    return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// x [M, K], g [M, N] bf16; A [E, K, r], B [E, r, N] (E = 1 dense); gid
// int32 [M / bm] (nullptr: dense); dA, dB bf16 like A, B; ws: the plan's
// S partials (f32, dense S > 1), cnt its C Q zeroed counts.
inline int launch(const void* x, const void* g, const void* a, const void* b,
                  const int* gid, float* ws, int* cnt, void* da, void* db,
                  int M, int K, int N, int E, int r, int bm, float scale,
                  cudaStream_t s) {
  const bool grouped = gid != nullptr;
  Plan pl;
  if (!plan_r(grouped, M, K, N, E, bm, r, &pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = grouped ? E : pl.S;
  if ((long long)units * pl.Q > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.gid = gid;
  p.da = static_cast<bf16*>(da);
  p.db = static_cast<bf16*>(db);
  p.ws = ws;
  p.cnt = cnt;
  p.M = M;
  p.K = K;
  p.N = N;
  p.E = E;
  p.r = r;
  p.bm = bm;
  p.scale = scale;
  p.C = pl.C;
  p.S = pl.S;
  p.Q = pl.Q;
  p.RF = pl.RF;
  p.nbuf = pl.nbuf;
  p.XS = pl.XS;
  p.nKt = (K + 15) / 16;
  p.nNt = (N + 15) / 16;
  p.flags = 0;
  if (K % 8 == 0 && aligned16(x)) p.flags |= kVx;
  if (N % 8 == 0 && aligned16(g)) p.flags |= kVg;
  if (N % 8 == 0 && aligned16(b)) p.flags |= kVb;
  if (r % 8 == 0 && aligned16(a)) p.flags |= kVa;
  if (pow2_scale(scale)) p.flags |= kPow2;
  if (r <= 8) return launch_rm<8>(p, pl, units, s);
  if (r <= 16) return launch_rm<16>(p, pl, units, s);
  return launch_rm<32>(p, pl, units, s);
}

// out[0..6]: C, S, Q, RF, nbuf, dynamic shared memory (bytes), and the
// f32 elements of the dense workspace (S partials of K r + r N; 0 when S
// is 1 or grouped); *counts: the zeroed counts the dense launch needs (C Q
// when S > 1).
inline int plan_figures(bool grouped, int M, int K, int N, int E, int r,
                        int bm, long long* out) {
  Plan pl;
  if (!plan_r(grouped, M, K, N, E, bm, r, &pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool partial = !grouped && pl.S > 1;
  const long long v[8] = {
      pl.C, pl.S, pl.Q, pl.RF, pl.nbuf, pl.smem,
      partial ? (long long)pl.S * ((long long)K * r + (long long)r * N) : 0,
      partial ? (long long)pl.C * pl.Q : 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

}  // namespace dab_tc
