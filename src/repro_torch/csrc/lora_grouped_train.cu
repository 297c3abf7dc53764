// Grouped LoRA linear over per-expert stacks (MoE training), written by
// hand for Hopper: forward, input gradient and factor gradients.
//
// Replaces the TPU kernels of src/repro/kernels/lora_grouped.py in their
// training form, a W0 per group (Ew = E):
//   lora_grouped (_grouped_fwd_kernel, _w_index)  -> entry lora_grouped_gemm
//     y[m] = x[m] @ W0[g] + s * round(x[m] @ A[g]) @ B[g]
//   lora_grouped_dx (_grouped_dx_kernel)          -> entry lora_grouped_dx
//     dx[m] = g[m] @ W0[g]^T + dh[m] @ A[g]^T,  dh = round((s g) @ B[g]^T)
//     (dh per tile is the wrapper's, as _grouped_dh was the TPU wrapper's)
//   lora_grouped_dab (_grouped_dab_kernel)        -> entry lora_grouped_dab
//     dA[e] = sum over e's rows of x^T dh,  dB[e] = sum of round(x@A[e])^T sg
// and over quantized expert stacks (W0[e] = w(codes[e]) * S[e], S f32
// [E, 1, N] per output channel; the layouts of core/quant.py):
//   lora_grouped_q  (_grouped_fwd_q_kernel), Ew = E -> lora_grouped_gemm_q
//   lora_grouped_q4 (_grouped_fwd_q4_kernel, _unpack_tile), Ew = E
//                                                   -> lora_grouped_gemm_q4
//     y[m] = round(acc * S[g] + s * round(h) @ B[g]),  acc = x[m] @ w[g]
//   lora_grouped_dx_q / _dx_q4 (_grouped_dx_q_kernel, _grouped_dx_q4_kernel)
//                                  -> lora_grouped_dx_q, lora_grouped_dx_q4
//     dx[m] = round(round(g[m] * round(S[g])) @ w[g]^T + dh[m] @ A[g]^T)
//   with w the int8 code, the sign-extended nibble (int4) or the nf4
//   codebook entry rounded to T; the codes [E, K, N] int8 or packed
//   [E, ceil(K/2), N] uint8, read in place by both passes.
//
//   with g = gid[m / bm]: rows come in tiles of bm, every tile one group's
//   (an expert's capacity buffer), x [M, K], W0 [E, K, N], A [E, K, r],
//   B [E, r, N] (r <= 32), gid int32 [M / bm] on the device; f32 sums, the
//   TPU kernels' roundings (to x's type T), outputs in T.
//
// What bounds them. For OLMoE-1B-7B at batch 1 x seq 256 (E 64, C = bm =
// 40, M = 2,560 rows, K x N 2048 x 1024) the forward and dx do 2 * 40 FLOPs
// per W0 element of their expert, 40 FLOP/byte in bf16: far below the H100's
// ~295, so the least time is that of reading the 268 MB expert stack once
// (~80 us). dA/dB read x and g once (~8 r FLOPs an element): bytes too.
// Over codes the stack to read shrinks (nf4 gate/up: 67 MB, ~26 us from
// bytes with x, y and the factors). The bf16 forward, dx and dA/dB run on
// tensor cores; every f32 instance runs on CUDA cores, whose FMA rate
// limits the f32 products.
//
// Design:
// * The bf16 forward of every format (kDense, kInt8, kInt4, kNF4) is
//   lora_grouped_tc.cuh's body: mma.sync over a cp.async ring, a block of
//   ceil(min(bm, 64) / 16) m16 fragments by 256 columns, W0's fragments
//   built in registers from the stored bf16 or codes, h = x @ A in the same
//   K loop and round(h) @ B as one more mma in the epilogue (its header has
//   the details). Every bf16 shape goes through it; ragged edges are masked
//   in the kernel.
// * The bf16 dx of every format is lora_grouped_dx_tc.cuh's body, the
//   forward's shape turned round: 8 warps by 256 output columns of K, MF
//   m16 fragments, a cp.async ring over the contraction N with W0 read in
//   place as stored (no transposed copy); W0^T's fragments pair along a W0
//   row (ldmatrix without .trans, 16-bit loads of adjacent codes, packed
//   tiles on a byte's two rows); over codes g's slab is scaled by round(S)
//   in shared memory once a slab; dh @ A^T is one more mma per fragment in
//   the epilogue (its header has the details).
// * The f32 dx and f32 forward are lora_gemm.cuh's tiled product (the
//   plain LoRA forward and dx, with the same roundings), one block per
//   64 x 64 output tile. blockIdx.y runs over (row tile t, 64-row part of
//   t): the block reads gid[t] once, offsets W0 by gid * K * N, A and B by
//   the group's entry, and ends its rows at the tile's end. At bm <= 64 a
//   whole tile fits one block, so each expert's W0 is read once per column
//   block and launch. dx reads W0 in place, [K, N] as stored: no
//   transposed copy. The format WFmt is a template parameter: kDense, and
//   kInt8 / kInt4 / kNF4 for the quantized stacks. Their codes are offset
//   by the group's entry in bytes (K * N for int8, ceil(K/2) * N packed),
//   S by N. The
//   codes become weights in T in shared memory (nf4's codebook rounded to
//   T once per block); the scale multiplies the f32 accumulator once per
//   output in the forward and is folded onto g as dx stages it, as in
//   lora_gemm.cuh. Odd K (packed): the pad nibble meets an x column masked
//   to zero, and dx writes no row at k >= K.
// * The bf16 dA/dB is lora_dab_tc.cuh's body, one launch: a thread-block
//   cluster a group walks the group's run of tiles, x and g read once, h
//   and dh recomputed on tensor cores and added across the cluster in
//   distributed shared memory, dA[e] and dB[e] summed in registers and
//   written directly (its header has the details). The f32 dA/dB, two
//   launches on one stream, as lora_dab.cu: row blocks of 8 rows inside one
//   tile write f32 partials (h and dh recomputed on chip, never written to
//   device memory; lora_dab.cuh); then one block per (group, element chunk)
//   finds its group's run of tiles in gid and adds their partials in row
//   order, no atomics. In both a group with no tile gets zeros. The TPU
//   kernel kept each group's block in VMEM across its contiguous tiles;
//   that contiguity stays the contract: a group whose tiles are not one run
//   gets NaN, so a broken schedule cannot pass for a result.
// * A gid outside [0, E) writes NaN to its tile's rows (forward, dx) or
//   adds its tile to no group (dA/dB), rather than reading out of bounds.
// Not yet: wgmma and TMA, a K split.

#include <climits>
#include <cstdint>
#include <type_traits>

#include "lora_dab.cuh"
#include "lora_dab_tc.cuh"
#include "lora_gemm.cuh"
#include "lora_grouped_dx_tc.cuh"
#include "lora_grouped_tc.cuh"

namespace {

using lora_gemm::BM;
using lora_gemm::BN;
using wfmt::WFmt;
using wfmt::WStore;

// w_stride / s_stride: elements of Q (a quantized W0's code bytes) / of S
// between two groups' entries (S nullptr for kDense); lo_in is A
// (fwd, offset by the group's entry) or dh (dx, absolute rows); lo_out is B
// (fwd) or A (dx), offset by the group's entry.
template <typename T, bool DX, WFmt F>
__global__ void __launch_bounds__(lora_gemm::THREADS, 2)
    grouped_gemm_kernel(const T* __restrict__ P,
                        const typename WStore<T, F>::type* __restrict__ Q,
                        const float* __restrict__ S,
                        const T* __restrict__ lo_in,
                        const T* __restrict__ lo_out,
                        const int* __restrict__ gid, T* __restrict__ y,
                        int Kc, int Nout, int E, size_t w_stride,
                        size_t s_stride, int r, int bm, int parts,
                        float scale) {
  const int t = blockIdx.y / parts;
  const int m0 = t * bm + (blockIdx.y % parts) * BM, m_end = (t + 1) * bm;
  const int e = gid[t];
  if (e < 0 || e >= E) {  // the whole block takes this branch
    const float nan = __int_as_float(0x7fc00000);
    for (int i = threadIdx.x; i < BM * BN; i += lora_gemm::THREADS) {
      const int m = m0 + i / BN, n = blockIdx.x * BN + i % BN;
      if (m < m_end && n < Nout) y[(size_t)m * Nout + n] = from_f<T>(nan);
    }
    return;
  }
  Q += (size_t)e * w_stride;
  if (S != nullptr) S += (size_t)e * s_stride;
  if (!DX) lo_in += (size_t)e * Kc * r;
  lo_out += (size_t)e * r * Nout;
  lora_gemm::gemm_body<T, DX, F>(P, Q, S, lo_in, lo_out, y, m_end, Kc, Nout,
                                 r, scale, m0);
}

template <bool DX, WFmt F, typename T>
int launch_gemm(const void* P, const void* Q, const float* S,
                const void* lo_in, const void* lo_out, const int* gid,
                void* y, int M, int Kc, int Nout, int E, size_t w_stride,
                size_t s_stride, int r, int bm, float scale,
                cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // bf16: tensor cores; S's entries lie N = s_stride apart
    if constexpr (DX)  // lora_grouped_dx_tc.cuh: lo_in = dh, lo_out = A
      return grouped_dx_tc::launch<F>(P, Q, S, lo_out, lo_in, gid, y, M,
                                      Nout, Kc, E, w_stride, r, bm, s);
    else  // lora_grouped_tc.cuh
      return grouped_tc::launch<F>(P, Q, S, lo_in, lo_out, gid, y, M, Kc,
                                   Nout, E, w_stride, r, bm, scale, s);
  } else {
    using W = typename WStore<T, F>::type;
    const int parts = (bm + BM - 1) / BM;
    const long long rows = (long long)(M / bm) * parts;
    if (rows > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid((Nout + BN - 1) / BN, (unsigned)rows);
    grouped_gemm_kernel<T, DX, F><<<grid, lora_gemm::THREADS, 0, s>>>(
        static_cast<const T*>(P), static_cast<const W*>(Q), S,
        static_cast<const T*>(lo_in), static_cast<const T*>(lo_out), gid,
        static_cast<T*>(y), Kc, Nout, E, w_stride, s_stride, r, bm, parts,
        scale);
    return static_cast<int>(cudaGetLastError());
  }
}

// One format F in either activation type. Q's and S's entries lie
// w_stride and s_stride elements apart (the codes' bytes for a quantized F).
template <bool DX, WFmt F>
int launch_fmt(int dtype, const void* P, const void* Q, const void* S,
               const void* lo_in, const void* lo_out, const void* gid,
               void* y, int M, int Kc, int Nout, int E, size_t w_stride,
               size_t s_stride, int r, int bm, float scale, void* stream) {
  if (M < 0 || Kc < 1 || Nout < 1 || E < 1 || r < 1 ||
      r > lora_gemm::RMAX || bm < 1 || M % bm)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const int* g = static_cast<const int*>(gid);
  const float* sc = static_cast<const float*>(S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_gemm<DX, F, __nv_bfloat16>(
        P, Q, sc, lo_in, lo_out, g, y, M, Kc, Nout, E, w_stride, s_stride, r,
        bm, scale, s);
  if (dtype == DTYPE_F32)
    return launch_gemm<DX, F, float>(P, Q, sc, lo_in, lo_out, g, y, M, Kc,
                                     Nout, E, w_stride, s_stride, r, bm,
                                     scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The entry of a W0 [K, N] per expert: K * N weights, int8 codes or dense
// elements; ceil(K/2) * N bytes packed.
template <WFmt F>
size_t entry_size(int K, int N) {
  return (size_t)(wfmt::is_packed(F) ? (K + 1) / 2 : K) * N;
}

// The forward (DX false: P = x, lo = A, B) or dx (DX true: P = g, lo = dh,
// A, contraction over N) over one quantized format.
template <bool DX, WFmt F>
int launch_quant(int dtype, const void* P, const void* q, const void* s,
                 const void* lo_in, const void* lo_out, const void* gid,
                 void* y, int M, int K, int N, int E, int r, int bm,
                 float scale, void* stream) {
  if (K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (DX)
    return launch_fmt<DX, F>(dtype, P, q, s, lo_in, lo_out, gid, y, M, N, K,
                             E, entry_size<F>(K, N), N, r, bm, 1.f, stream);
  else
    return launch_fmt<DX, F>(dtype, P, q, s, lo_in, lo_out, gid, y, M, K, N,
                             E, entry_size<F>(K, N), N, r, bm, scale, stream);
}

// ------------------------------------------------------------------ dA/dB

using dab_rows::RB;

// Row block b covers rows of tile b / nb only (nb = ceil(bm / RB) blocks a
// tile); its partials go to ws[b]. A tile with no group writes nothing.
template <typename T, int RM>
__global__ void __launch_bounds__(dab_rows::THREADS) grouped_dab_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ a,
    const T* __restrict__ b, const int* __restrict__ gid,
    float* __restrict__ ws, int K, int N, int E, int r, int bm, int nb,
    float scale) {
  const int t = blockIdx.x / nb;
  const int e = gid[t];
  if (e < 0 || e >= E) return;  // the whole block takes this branch
  float* wa = ws + (size_t)blockIdx.x * ((size_t)K * r + (size_t)r * N);
  dab_rows::partial_body<T, RM>(
      x, g, a + (size_t)e * K * r, b + (size_t)e * r * N, wa,
      wa + (size_t)K * r, t * bm + (blockIdx.x % nb) * RB, (t + 1) * bm, K, N,
      r, scale);
}

// blockIdx.y = group e. The block finds e's tiles in gid (first, last,
// count), then each thread adds, for its elements of dA[e] and dB[e], the
// partials of the run's row blocks in order.
template <typename T>
__global__ void __launch_bounds__(dab_rows::THREADS) grouped_dab_reduce_kernel(
    const float* __restrict__ ws, const int* __restrict__ gid, int tiles,
    int nb, int K, int N, int r, T* __restrict__ da, T* __restrict__ db) {
  __shared__ int first, last, count;
  const int e = blockIdx.y;
  if (threadIdx.x == 0) {
    first = INT_MAX;
    last = -1;
    count = 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tiles; t += dab_rows::THREADS) {
    if (gid[t] == e) {
      atomicMin(&first, t);
      atomicMax(&last, t);
      atomicAdd(&count, 1);
    }
  }
  __syncthreads();
  const bool split = count > 0 && count != last - first + 1;
  const size_t na = (size_t)K * r, per = na + (size_t)r * N;
  for (size_t i = (size_t)blockIdx.x * dab_rows::THREADS + threadIdx.x;
       i < per; i += (size_t)gridDim.x * dab_rows::THREADS) {
    float s = 0.f;
    if (split) {
      s = __int_as_float(0x7fc00000);
    } else if (count > 0) {
      for (int rb = first * nb; rb < (last + 1) * nb; ++rb)
        s += ws[(size_t)rb * per + i];
    }
    if (i < na)
      da[(size_t)e * na + i] = from_f<T>(s);
    else
      db[(size_t)e * (per - na) + (i - na)] = from_f<T>(s);
  }
}

template <typename T>
int launch_dab(const void* x, const void* g, const void* a, const void* b,
               const int* gid, float* ws, void* da, void* db, int M, int K,
               int N, int E, int r, int bm, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {  // tensor cores
    return dab_tc::launch(x, g, a, b, gid, nullptr, nullptr, da, db, M, K, N,
                          E, r, bm, scale, s);
  } else {
    const int tiles = M / bm, nb = (bm + RB - 1) / RB;
    if (tiles > 0) {
      const T *xp = static_cast<const T*>(x), *gp = static_cast<const T*>(g),
              *ap = static_cast<const T*>(a), *bp = static_cast<const T*>(b);
      LORA_DAB_BY_RANK(grouped_dab_partial_kernel, T, r, tiles * nb, s, xp,
                       gp, ap, bp, gid, ws, K, N, E, r, bm, nb, scale);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t per = (size_t)K * r + (size_t)r * N;
    const size_t need = (per + dab_rows::THREADS - 1) / dab_rows::THREADS;
    const dim3 grid(need < 64 ? (unsigned)need : 64u, (unsigned)E);
    grouped_dab_reduce_kernel<T><<<grid, dab_rows::THREADS, 0, s>>>(
        ws, gid, tiles, nb, K, N, r, static_cast<T*>(da),
        static_cast<T*>(db));
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// Each entry returns cudaGetLastError() after its launches (0 when they
// were accepted).

extern "C" int lora_grouped_gemm(int dtype, const void* x, const void* w0,
                                 const void* a, const void* b,
                                 const void* gid, void* y, int M, int K,
                                 int N, int E, int r, int bm, float scale,
                                 void* stream) {
  if (K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fmt<false, WFmt::kDense>(dtype, x, w0, nullptr, a, b, gid, y,
                                         M, K, N, E, (size_t)K * N, 0, r, bm,
                                         scale, stream);
}

extern "C" int lora_grouped_dx(int dtype, const void* g, const void* w0,
                               const void* a, const void* dh,
                               const void* gid, void* dx, int M, int K,
                               int N, int E, int r, int bm, void* stream) {
  // W0's entry is [K, N] in both passes
  if (K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fmt<true, WFmt::kDense>(dtype, g, w0, nullptr, dh, a, gid,
                                        dx, M, N, K, E, (size_t)K * N, 0, r,
                                        bm, 1.f, stream);
}

// Over quantized expert stacks: q int8 [E, K, N] or q4 uint8
// [E, ceil(K/2), N], s f32 [E, 1, N]; method 0 int4, 1 nf4.
extern "C" int lora_grouped_gemm_q(int dtype, const void* x, const void* q,
                                   const void* s, const void* a,
                                   const void* b, const void* gid, void* y,
                                   int M, int K, int N, int E, int r, int bm,
                                   float scale, void* stream) {
  return launch_quant<false, WFmt::kInt8>(dtype, x, q, s, a, b, gid, y, M, K,
                                          N, E, r, bm, scale, stream);
}

extern "C" int lora_grouped_gemm_q4(int dtype, int method, const void* x,
                                    const void* q4, const void* s,
                                    const void* a, const void* b,
                                    const void* gid, void* y, int M, int K,
                                    int N, int E, int r, int bm, float scale,
                                    void* stream) {
  if (method == 0)
    return launch_quant<false, WFmt::kInt4>(dtype, x, q4, s, a, b, gid, y, M,
                                            K, N, E, r, bm, scale, stream);
  if (method == 1)
    return launch_quant<false, WFmt::kNF4>(dtype, x, q4, s, a, b, gid, y, M,
                                           K, N, E, r, bm, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int lora_grouped_dx_q(int dtype, const void* g, const void* q,
                                 const void* s, const void* a,
                                 const void* dh, const void* gid, void* dx,
                                 int M, int K, int N, int E, int r, int bm,
                                 void* stream) {
  return launch_quant<true, WFmt::kInt8>(dtype, g, q, s, dh, a, gid, dx, M, K,
                                         N, E, r, bm, 1.f, stream);
}

extern "C" int lora_grouped_dx_q4(int dtype, int method, const void* g,
                                  const void* q4, const void* s,
                                  const void* a, const void* dh,
                                  const void* gid, void* dx, int M, int K,
                                  int N, int E, int r, int bm, void* stream) {
  if (method == 0)
    return launch_quant<true, WFmt::kInt4>(dtype, g, q4, s, dh, a, gid, dx, M,
                                           K, N, E, r, bm, 1.f, stream);
  if (method == 1)
    return launch_quant<true, WFmt::kNF4>(dtype, g, q4, s, dh, a, gid, dx, M,
                                          K, N, E, r, bm, 1.f, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory (bytes) the CUDA runtime allows the bf16
// forward's instance of format fmt (a WFmt value: 0 dense, 1 int8, 2 int4,
// 3 nf4) for tiles of bm rows: what its last launch set.
extern "C" int lora_grouped_gemm_smem(int fmt, int bm, int* bytes) {
  *bytes = -1;
  if (bm < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (fmt) {
    case int(WFmt::kDense):
      return grouped_tc::smem_of<WFmt::kDense>(bm, bytes);
    case int(WFmt::kInt8):
      return grouped_tc::smem_of<WFmt::kInt8>(bm, bytes);
    case int(WFmt::kInt4):
      return grouped_tc::smem_of<WFmt::kInt4>(bm, bytes);
    case int(WFmt::kNF4):
      return grouped_tc::smem_of<WFmt::kNF4>(bm, bytes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Which body the dx of format fmt (a WFmt value) runs in activation type
// dtype for tiles of bm rows: *mf its m16 row fragments on tensor cores
// (bf16: lora_grouped_dx_tc.cuh) or 0 (f32: gemm_body on CUDA cores), and
// *bytes the dynamic shared memory the CUDA runtime allows that instance
// (what its last launch set; 0 for gemm_body, whose tiles are static).
extern "C" int lora_grouped_dx_plan(int dtype, int fmt, int bm, int* mf,
                                    int* bytes) {
  *mf = *bytes = -1;
  if (bm < 1 || fmt < 0 || fmt > int(WFmt::kNF4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_F32) {
    *mf = *bytes = 0;
    return 0;
  }
  if (dtype != DTYPE_BF16) return static_cast<int>(cudaErrorInvalidValue);
  switch (fmt) {
    case int(WFmt::kDense):
      return grouped_dx_tc::plan_of<WFmt::kDense>(bm, mf, bytes);
    case int(WFmt::kInt8):
      return grouped_dx_tc::plan_of<WFmt::kInt8>(bm, mf, bytes);
    case int(WFmt::kInt4):
      return grouped_dx_tc::plan_of<WFmt::kInt4>(bm, mf, bytes);
    default:
      return grouped_dx_tc::plan_of<WFmt::kNF4>(bm, mf, bytes);
  }
}

// f32 elements of the partials workspace that the f32 lora_grouped_dab
// needs (the bf16 body needs none: each cluster writes its group's dA and
// dB).
extern "C" long long lora_grouped_dab_workspace(int M, int K, int N, int r,
                                                int bm) {
  const long long blocks = (long long)(M / bm) * ((bm + RB - 1) / RB);
  return blocks * ((long long)K * r + (long long)r * N);
}

// The bf16 dA/dB's plan for E groups in tiles of bm rows (lora_dab_tc.cuh):
// out[0..7] = C (the members of a group's cluster), S (1), Q (passes over
// a member's columns), RF (m16 row fragments a chunk), slabs (1 or 2),
// dynamic shared memory (bytes), workspace (0) and counts (0).
extern "C" int lora_grouped_dab_plan(int M, int K, int N, int E, int r,
                                     int bm, long long* out) {
  if (M < 0 || K < 1 || N < 1 || E < 1 || r < 1 || r > dab_rows::RMAX ||
      bm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dab_tc::plan_figures(true, M, K, N, E, r, bm, out);
}

extern "C" int lora_grouped_dab(int dtype, const void* x, const void* g,
                                const void* a, const void* b,
                                const void* gid, void* ws, void* da,
                                void* db, int M, int K, int N, int E, int r,
                                int bm, float scale, void* stream) {
  if (M < 0 || K < 1 || N < 1 || E < 1 || r < 1 || r > dab_rows::RMAX ||
      bm < 1 || M % bm || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gp = static_cast<const int*>(gid);
  float* w = static_cast<float*>(ws);
  if (dtype == DTYPE_BF16)
    return launch_dab<__nv_bfloat16>(x, g, a, b, gp, w, da, db, M, K, N, E,
                                     r, bm, scale, s);
  if (dtype == DTYPE_F32)
    return launch_dab<float>(x, g, a, b, gp, w, da, db, M, K, N, E, r, bm,
                             scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
