// The bf16 grouped LoRA input gradient over per-expert stacks on Hopper's
// tensor cores: the body of lora_grouped_dx, lora_grouped_dx_q and
// lora_grouped_dx_q4 (lora_grouped_train.cu) when the activations are
// bf16. The f32 instances keep lora_gemm.cuh's CUDA-core body.
//
// Replaces, in bf16, the TPU kernels of src/repro/kernels/lora_grouped.py
// with a W0 per group: lora_grouped_dx (_grouped_dx_kernel),
// lora_grouped_dx_q (_grouped_dx_q_kernel) and lora_grouped_dx_q4
// (_grouped_dx_q4_kernel). With e = gid[m / bm] and dh the wrapper's
// round((s g) @ B[e]^T):
//
//   dx[m] = round(g[m] @ W0[e]^T + dh[m] @ A[e]^T)                   kDense
//   dx[m] = round(round(g[m] * round(S[e])) @ w(codes[e])^T          kInt8,
//                 + dh[m] @ A[e]^T)                                 kInt4, kNF4
//
// f32 sums, one rounding of the output; the scale, per output channel of
// the forward, is per contraction column n here: g's column n times
// round(S[n]), each product rounded to bf16 (__fmul_rn), as gemm_body and
// the plain versions do. Only the order of the f32 sums differs from them.
// w is the int8 code, the sign-extended nibble (int4) or the nf4 codebook
// entry rounded to bf16: each exact in bf16. A gid outside [0, E) writes NaN
// to its tile's rows.
//
// What bounds it. At OLMoE-1B-7B's expert shapes (E 64, C = bm = 40, K x N
// 2048 x 1024 and 1024 x 2048, r 8) a launch does 2 * 40 FLOPs per W0
// element it reads once: 40 FLOP/byte in bf16, below the H100's ~295, so
// the least time is that of reading the stack once (268 MB bf16, ~80 us;
// 67 MB packed, ~20 us). Over codes, turning each code into a bf16 weight
// is work of the same order as the products.
//
// Design (the grouped forward's shape, lora_grouped_tc.cuh, turned round):
// * One block of 8 warps per (row tile part, 256 output columns of K); the
//   grid's x runs over the column tiles, so one expert's blocks run side by
//   side and its g rows come from L2 after the first. Each warp owns 32
//   output columns and every row of the block: MF m16 fragments, MF =
//   ceil(min(bm, 64) / 16), parts of 64 rows above bm 64; over codes MF is
//   at most 3 and parts take 48 rows (kTopMF). 128 registers a thread at
//   most, no spills: two blocks (16 warps) an SM.
// * The contraction runs over W0's columns n in slabs of BK = 32 through a
//   ring of STAGES = 4 filled by cp.async three slabs ahead: g [rows][BK],
//   and W0 read in place, its slab as stored: bf16 [256 rows k][BK of n],
//   int8 codes [256][BK bytes], or packed bytes [128 byte rows][BK] (byte
//   row i: rows 2i and 2i + 1). A slab takes 32 or 64 bytes of each W0 row,
//   so W0's copies ask L2 for the whole 128-byte line; later slabs find the
//   rest there. Over codes S's BK entries come with the slab, and once the
//   slab has landed the block scales g's slab in shared memory, in place:
//   round(g * round(S[n])), once, not once per warp; the slab's two k steps
//   then run one after the other (not unrolled), which keeps the code
//   conversions within 128 registers.
// * Products: mma.sync m16n8k16 on g's fragments (ldmatrix) and W0^T's B
//   fragments (lora_tc.cuh's frag_w, shared with the dense dx,
//   lora_dense_dx_tc.cuh). In dx the mma's contraction runs along a W0
//   row, so a B register holds W0[k, n], W0[k, n + 1], neighbours in
//   memory: bf16 fragments come straight from ldmatrix without .trans,
//   int8 ones from 16-bit loads of adjacent codes widened as the forward
//   widens them.
//   Packed codes: lane group g of n8 tiles 2p and 2p + 1 sits on rows 2i and
//   2i + 1 of byte row i = 8 p + g (col_of), so a 16-bit load of bytes
//   (i, n), (i, n + 1) gives tile 2p its low nibbles and tile 2p + 1 the
//   high ones (nib_pairs<0x6240, 0x7351>); the epilogue stores by the same
//   map. The pad nibble of an odd K lies in a row k >= K, which is never
//   written.
// * Epilogue: dh's rows [rows][ceil16(r)] and A[e]'s [256][ceil16(r)] (zero
//   past r) over the ring; dh @ A^T as one more mma per fragment, A's
//   fragments built by the same column map; then round(acc + lora), one
//   rounding, stored as bf16 pairs (natural order) or runs of 4 (packed).
//   Ragged K and N are masked in the kernel.
// * No atomics, a fixed order of sums: two launches give the same bits.
// * Dynamic shared memory (30-100 KB) is allowed per instance with
//   cudaFuncSetAttribute before each launch; lora_grouped_dx_plan reads it
//   back from the runtime.
// Not yet: wgmma with TMA.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "lora_grouped_tc.cuh"
#include "lora_tc.cuh"
#include "mma.cuh"
#include "wfmt.cuh"

namespace grouped_dx_tc {

using namespace lora_tc;
using grouped_tc::frags_of;

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int BN = 32 * WARPS;  // output columns (of K) a block, 32 a warp

// The most m16 row fragments a block of format F holds: 4 (64 rows) over
// bf16, as the forward; 3 (48 rows) over codes, whose conversions leave no
// room in 128 registers for a fourth fragment's sums. A taller tile is
// split into parts of that many rows.
template <WFmt F>
constexpr int kTopMF = F == WFmt::kDense ? 4 : 3;

// m16 row fragments of format F's block for tiles of bm rows
template <WFmt F>
inline int frags_for(int bm) {
  const int mf = frags_of(bm);
  return mf < kTopMF<F> ? mf : kTopMF<F>;
}

template <int MF, WFmt F>
struct Layout {
  static constexpr bool kQuant = F != WFmt::kDense;
  static constexpr int kP = MF * 16 * XS * 2;
  static constexpr int kW = F == WFmt::kDense  ? BN * XS * 2
                            : F == WFmt::kInt8 ? BN * SC
                                               : BN / 2 * SC;
  static constexpr int kS = kQuant ? BK * 4 : 0;
  static constexpr int kStage = kP + kW + kS;
  static constexpr int kBytes = STAGES * kStage;
  // the epilogue's dh [MF * 16][AS] and A [BN][AS] reuse the ring
  static_assert(MF * 16 * AS * 2 + BN * AS * 2 <= kBytes,
                "epilogue tiles must fit in the ring");
};

// g [M, N] bf16; Q: W0's entries (bf16 [K, N], int8 codes [K, N] or packed
// bytes [ceil(K/2), N]) w_stride elements apart; S f32 [E, N] (nullptr for
// kDense); A [E, K, r]; dh [M, r] bf16; gid int32 [M / bm]; dx [M, K] bf16.
// blockIdx.x: 256-column tile of K; blockIdx.y: (row tile t, MF * 16-row
// part).
template <int MF, WFmt F>
__global__ void __launch_bounds__(THREADS, 2)
    grouped_dx_tc(const bf16* __restrict__ g,
                  const typename wfmt::WStore<bf16, F>::type* __restrict__ Q,
                  const float* __restrict__ S, const bf16* __restrict__ A,
                  const bf16* __restrict__ dh, const int* __restrict__ gid,
                  bf16* __restrict__ dx, int K, int N, int E,
                  size_t w_stride, int r, int bm, int parts, int flags) {
  using L = Layout<MF, F>;
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.y / parts;
  const int m0 = t * bm + (blockIdx.y % parts) * (MF * 16);
  const int m_end = (t + 1) * bm;
  const int k0 = blockIdx.x * BN, cw0 = 32 * warp;
  const int e = gid[t];
  if (e < 0 || e >= E) {  // the whole block takes this branch
    const bf16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
    for (int i = threadIdx.x; i < MF * 16 * BN; i += THREADS) {
      const int m = m0 + i / BN, k = k0 + i % BN;
      if (m < m_end && k < K) dx[(size_t)m * K + k] = nan;
    }
    return;
  }
  Q += (size_t)e * w_stride;
  A += (size_t)e * K * r;
  if constexpr (L::kQuant) S += (size_t)e * N;

  const int rows = MF * 16;
  const int nk = (N + BK - 1) / BK;
  const bool vg = flags & kVecX, vw = flags & kVecW;

  auto load = [&](int stage, int n0) {
    uint8_t* st = smem + stage * L::kStage;
    stage_block<8, THREADS>(reinterpret_cast<bf16*>(st), XS, g, (size_t)N,
                            m0, n0, rows, BK, m_end, N, vg);
    uint8_t* ws = st + L::kP;
    if constexpr (F == WFmt::kDense)
      stage_block<8, THREADS, bf16, true>(reinterpret_cast<bf16*>(ws), XS, Q,
                                          (size_t)N, k0, n0, BN, BK, K, N,
                                          vw);
    else if constexpr (F == WFmt::kInt8)
      stage_block<16, THREADS, int8_t, true>(reinterpret_cast<int8_t*>(ws),
                                             SC, Q, (size_t)N, k0, n0, BN,
                                             BK, K, N, vw);
    else
      stage_block<16, THREADS, uint8_t, true>(ws, SC, Q, (size_t)N, k0 / 2,
                                              n0, BN / 2, BK, (K + 1) / 2, N,
                                              vw);
    if constexpr (L::kQuant)
      stage_block<4, THREADS>(reinterpret_cast<float*>(ws + L::kW), 0, S, 0,
                              0, n0, 1, BK, 1, N, flags & kVecS);
  };

  // acc[i][j]: m16 fragment i, n8 tile j of the warp's 32 columns (col_of)
  float acc[MF][4][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
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
    uint8_t* st = smem + (kt % STAGES) * L::kStage;
    bf16* ps = reinterpret_cast<bf16*>(st);
    const uint8_t* ws = st + L::kP;
    if constexpr (L::kQuant) {
      // g's slab times round(S), each product rounded: once a slab, in
      // place, 8 elements a thread (zero past N and past the tile's rows
      // stays zero)
      const float* ss = reinterpret_cast<const float*>(ws + L::kW);
      for (int i = threadIdx.x; i < rows * BK / 8; i += THREADS) {
        const int rr = i / (BK / 8), cc = 8 * (i % (BK / 8));
        uint4* p = reinterpret_cast<uint4*>(ps + rr * XS + cc);
        uint4 v = *p;
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 h =
              *reinterpret_cast<const __nv_bfloat162*>(&w[q]);
          w[q] = mma::pack_bf16(
              __fmul_rn(__low2float(h), round_to<bf16>(ss[cc + 2 * q])),
              __fmul_rn(__high2float(h), round_to<bf16>(ss[cc + 2 * q + 1])));
        }
        *p = v;
      }
    }
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    mma::cp_async_commit();
    if constexpr (L::kQuant) __syncthreads();

    // over codes one k step at a time: both at once need more than 128
    // registers
#pragma unroll(L::kQuant ? 1 : BK / 16)
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MF][4], bw[2][2][2];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        frag_a(af[i], ps + i * 16 * XS, XS, ks, lane);
      frag_w<F>(bw[0], ws, tb, cw0, 0, ks, lane);
      frag_w<F>(bw[1], ws, tb, cw0, 1, ks, lane);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma::mma_bf16(acc[i][j], af[i], bw[j / 2][j % 2][0],
                        bw[j / 2][j % 2][1]);
    }
  }

  // epilogue: dh's rows [rows][AS] and A's [BN][AS] over the ring
  mma::cp_async_wait<0>();
  __syncthreads();
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* as = reinterpret_cast<bf16*>(smem + rows * AS * 2);
  const int hk = (r + 15) / 16;  // k16 steps over the padded rank
  stage_block<8, THREADS>(hs, AS, dh, (size_t)r, m0, 0, rows, 16 * hk, m_end,
                          r, flags & kVecB);
  stage_block<8, THREADS>(as, AS, A, (size_t)r, k0, 0, BN, 16 * hk, K, r,
                          flags & kVecA);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  const int gq = lane >> 2, l4 = lane & 3;
  const int kb = k0 + cw0;  // the warp's first output column
  const bool vy = flags & kVecY;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    float d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) d[j][v] = 0.f;
    for (int ks = 0; ks < hk; ++ks) {
      uint32_t ha[4], b0[4], b1[4];
      frag_a(ha, hs + i * 16 * AS, AS, ks, lane);
      frag_rows<F>(b0, as, AS, cw0, 0, ks, lane);
      frag_rows<F>(b1, as, AS, cw0, 2, ks, lane);
      mma::mma_bf16(d[0], ha, b0[0], b0[1]);
      mma::mma_bf16(d[1], ha, b0[2], b0[3]);
      mma::mma_bf16(d[2], ha, b1[0], b1[1]);
      mma::mma_bf16(d[3], ha, b1[2], b1[3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + i * 16 + gq + 8 * half;
      if (m >= m_end) continue;
      bf16* out = dx + (size_t)m * K;
      auto val = [&](int j, int c) {
        return __fadd_rn(acc[i][j][2 * half + c], d[j][2 * half + c]);
      };
      if constexpr (wfmt::is_packed(F)) {
        // tiles 2p, 2p + 1 hold columns 16 p + 4 l4 + {0, 2} and {1, 3}
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int k = kb + 16 * pp + 4 * l4;
          const float v[4] = {val(2 * pp, 0), val(2 * pp + 1, 0),
                              val(2 * pp, 1), val(2 * pp + 1, 1)};
          if (vy && k + 4 <= K) {
            *reinterpret_cast<uint2*>(out + k) = make_uint2(
                mma::pack_bf16(v[0], v[1]), mma::pack_bf16(v[2], v[3]));
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (k + q < K) out[k + q] = __float2bfloat16(v[q]);
          }
        }
      } else {
        // tile j holds columns 8 j + 2 l4 + {0, 1}
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kb + 8 * j + 2 * l4;
          const float v0 = val(j, 0), v1 = val(j, 1);
          if (vy && k + 2 <= K) {
            *reinterpret_cast<uint32_t*>(out + k) = mma::pack_bf16(v0, v1);
          } else {
            if (k < K) out[k] = __float2bfloat16(v0);
            if (k + 1 < K) out[k + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

template <int MF, WFmt F>
int launch_mf(const void* g, const void* Q, const float* S, const void* A,
              const void* dh, const int* gid, void* dx, int M, int K, int N,
              int E, size_t w_stride, int r, int bm, cudaStream_t s) {
  using C = typename wfmt::WStore<bf16, F>::type;
  const int parts = (bm + MF * 16 - 1) / (MF * 16);
  const long long rows = (long long)(M / bm) * parts;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  int flags = 0;
  if (N % 8 == 0 && aligned16(g)) flags |= kVecX;
  if (N % (F == WFmt::kDense ? 8 : 16) == 0 && aligned16(Q)) flags |= kVecW;
  if (r % 8 == 0 && aligned16(A)) flags |= kVecA;
  if (r % 8 == 0 && aligned16(dh)) flags |= kVecB;
  if (K % 4 == 0 && aligned16(dx)) flags |= kVecY;
  if (N % 4 == 0 && aligned16(S)) flags |= kVecS;
  auto kern = grouped_dx_tc<MF, F>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<MF, F>::kBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((K + BN - 1) / BN, (unsigned)rows);
  kern<<<grid, THREADS, Layout<MF, F>::kBytes, s>>>(
      static_cast<const bf16*>(g), static_cast<const C*>(Q), S,
      static_cast<const bf16*>(A), static_cast<const bf16*>(dh), gid,
      static_cast<bf16*>(dx), K, N, E, w_stride, r, bm, parts, flags);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 dx of format F over tiles of bm rows: g [M, N], dx [M, K]
// (w_stride: elements of Q between two experts' entries; S's entries are N
// apart).
template <WFmt F>
int launch(const void* g, const void* Q, const float* S, const void* A,
           const void* dh, const int* gid, void* dx, int M, int K, int N,
           int E, size_t w_stride, int r, int bm, cudaStream_t s) {
  switch (frags_for<F>(bm)) {
    case 1:
      return launch_mf<1, F>(g, Q, S, A, dh, gid, dx, M, K, N, E, w_stride,
                             r, bm, s);
    case 2:
      return launch_mf<2, F>(g, Q, S, A, dh, gid, dx, M, K, N, E, w_stride,
                             r, bm, s);
    case 3:
      return launch_mf<3, F>(g, Q, S, A, dh, gid, dx, M, K, N, E, w_stride,
                             r, bm, s);
    default:
      return launch_mf<kTopMF<F>, F>(g, Q, S, A, dh, gid, dx, M, K, N, E,
                                     w_stride, r, bm, s);
  }
}

// The dynamic shared memory the runtime allows format F's instance for
// tiles of bm rows (what launch set before its last launch), and its MF.
template <WFmt F>
int plan_of(int bm, int* mf, int* bytes) {
  cudaFuncAttributes a;
  cudaError_t rc;
  *mf = frags_for<F>(bm);
  switch (*mf) {
    case 1: rc = cudaFuncGetAttributes(&a, grouped_dx_tc<1, F>); break;
    case 2: rc = cudaFuncGetAttributes(&a, grouped_dx_tc<2, F>); break;
    case 3: rc = cudaFuncGetAttributes(&a, grouped_dx_tc<3, F>); break;
    default:
      rc = cudaFuncGetAttributes(&a, grouped_dx_tc<kTopMF<F>, F>);
      break;
  }
  *bytes = rc == cudaSuccess ? a.maxDynamicSharedSizeBytes : -1;
  return static_cast<int>(rc);
}

}  // namespace grouped_dx_tc
