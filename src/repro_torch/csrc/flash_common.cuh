// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile shape, the mask and live-tile ranges, and two bodies of tile
// loads and products: the f32 instance's on CUDA cores, the bf16
// instance's on tensor cores (namespace flash::tc, below).
//
// Layouts are the reference's (src/repro/kernels/flash_attention.py): q, g,
// out [B*H, Nq, D]; k, v [B*Hkv, Nk, D], q head bh reading kv head bh / G;
// lse and delta [B*H, Nq] f32; RoPE tables cos, sin [N, D/2] f32 (Nq == Nk).
//
// What bounds the kernels: at the training paths' shapes a launch moves
// 1.1-6.3 MB and does 0.12-0.54 GFLOP: under 1.9 us at 3.35 TB/s. So they
// are set by latency: by how many dependent steps (tile loads, products,
// softmax) one block walks, and by how many blocks share the work.
//
// f32 instance (CUDA cores): a block of 256 threads holds one 64-row q
// tile and walks 64-row k tiles (or the reverse in flash_bwd_dkv); thread
// (ty, tx) of a 16 x 16 grid owns score rows ty + 16 i and columns tx + 16 j
// (i, j < 4), and the D-wide accumulators' columns tx + 16 j (j < DMAX /
// 16). Tiles are staged in shared memory as f32, rows padded to D + 1 (an
// odd stride: a half-warp's 16 columns fall in distinct banks). It keeps
// these CUDA-core products because tensor cores would take f32 operands as
// TF32 (a 10-bit mantissa) and change the answer the f32 checks hold to
// 1e-4.
//
// bf16 instance (tensor cores): see the flash::tc section.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace flash {

constexpr int BQ = 64;             // q rows per tile
constexpr int BK = 64;             // k rows per tile
constexpr int THREADS = 256;       // 16 x 16
constexpr int PS = BK + 1;         // stride of a staged [64][64] score tile
constexpr float NEG_INF = -1e30f;  // the reference's mask value (not -inf)
static_assert(BQ == BK, "load_tile, store_tile and acc_tile walk 64 rows");

// (q, k) is a pair the attention may use: inside both lengths, causal
// q >= k, window q - k < window (positions counted from 0 on both sides)
__device__ __forceinline__ bool valid(int q, int k, int nq, int nk,
                                      int causal, int window) {
  return q < nq && k < nk && (!causal || q >= k) &&
         (window <= 0 || q - k < window);
}

// every pair of the tile at (q_lo, k_lo) is valid: no mask is built
__device__ __forceinline__ bool interior(int q_lo, int k_lo, int nq, int nk,
                                         int causal, int window) {
  return q_lo + BQ <= nq && k_lo + BK <= nk &&
         (!causal || q_lo >= k_lo + BK - 1) &&
         (window <= 0 || q_lo + BQ - 1 - k_lo < window);
}

// [lo, hi) of the k tiles that q tile q_lo sees: nothing above the causal
// diagonal, nothing behind the window (core/flash.py _chunk_range)
__device__ __forceinline__ void k_range(int q_lo, int nq, int nk, int causal,
                                        int window, int* lo, int* hi) {
  const int q_hi = min(q_lo + BQ, nq) - 1;
  *hi = (nk + BK - 1) / BK;
  if (causal) *hi = min(*hi, q_hi / BK + 1);
  *lo = window > 0 ? max(0, q_lo - window + 1) / BK : 0;
}

// [lo, hi) of the q tiles that see k tile k_lo (the transpose of k_range)
__device__ __forceinline__ void q_range(int k_lo, int nq, int nk, int causal,
                                        int window, int* lo, int* hi) {
  const int k_hi = min(k_lo + BK, nk) - 1;
  *lo = causal ? k_lo / BQ : 0;
  *hi = (nq + BQ - 1) / BQ;
  if (window > 0) *hi = min(*hi, (k_hi + window - 1) / BQ + 1);
}

// Rows [row0, row0 + 64) of x [n, D] into dst [64][ld] as S (f32, or T
// itself); rows past n are zero. With tables (cos != nullptr) each row is
// rotated by RoPE at its position, in f32, and rounded back to T, as the
// reference's _rot does: the rotated tile never reaches device memory.
// Products and sums are rounded one by one (no fused multiply-add), as the
// plain version's are. NT threads share the rows.
template <typename T, int NT = THREADS, typename S>
__device__ __forceinline__ void load_tile(S* dst, int ld, const T* x,
                                          int row0, int n, int D,
                                          const float* cos,
                                          const float* sin) {
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < BQ * half; idx += NT) {
    const int r = idx / half, c = idx - r * half, row = row0 + r;
    float x1 = 0.f, x2 = 0.f;
    if (row < n) {
      x1 = to_f(x[(size_t)row * D + c]);
      x2 = to_f(x[(size_t)row * D + c + half]);
      if (cos) {
        const float cs = cos[(size_t)row * half + c];
        const float sn = sin[(size_t)row * half + c];
        const float y1 = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
        const float y2 = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
        x1 = round_to<T>(y1);
        x2 = round_to<T>(y2);
      }
    }
    dst[r * ld + c] = from_f<S>(x1);
    dst[r * ld + c + half] = from_f<S>(x2);
  }
}

// Write rows [row0, row0 + 64) of the f32 tile src [64][ld] to y [n, D] in
// T, rows past n skipped; with tables, counter-rotated first (R_-theta, the
// inverse of the rotation applied on load: the reference's
// _rot(acc, cos, -sin)), in f32. NT threads share the rows.
template <typename T, int NT = THREADS>
__device__ __forceinline__ void store_tile(T* y, const float* src, int ld,
                                           int row0, int n, int D,
                                           const float* cos,
                                           const float* sin) {
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < BQ * half; idx += NT) {
    const int r = idx / half, c = idx - r * half, row = row0 + r;
    if (row >= n) continue;
    float a1 = src[r * ld + c], a2 = src[r * ld + c + half];
    if (cos) {
      const float cs = cos[(size_t)row * half + c];
      const float sn = -sin[(size_t)row * half + c];
      const float y1 = __fsub_rn(__fmul_rn(a1, cs), __fmul_rn(a2, sn));
      const float y2 = __fadd_rn(__fmul_rn(a2, cs), __fmul_rn(a1, sn));
      a1 = y1;
      a2 = y2;
    }
    y[(size_t)row * D + c] = from_f<T>(a1);
    y[(size_t)row * D + c + half] = from_f<T>(a2);
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d] over staged tiles
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* A,
                                         const float* B, int ld, int D,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][j] += sum_t P[t][row_i] X[t][tx + 16 j] when trans (P^T X), or
// sum_t P[row_i][t] X[t][tx + 16 j] when not (P X); row_i = ty + 16 i,
// P a staged [64][PS] tile, X a staged [64][ld] tile
template <int JC, bool TRANS>
__device__ __forceinline__ void acc_tile(float (&acc)[4][JC], const float* P,
                                         const float* X, int ld, int D,
                                         int ty, int tx) {
  for (int t = 0; t < BK; ++t) {
    float x[JC], p[4];
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int c = tx + 16 * j;
      x[j] = c < D ? X[t * ld + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = TRANS ? P[t * PS + ty + 16 * i] : P[(ty + 16 * i) * PS + t];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JC; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

// max and sum over the 16 threads of a half-warp (one score row)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dynamic shared memory of a kernel with `tiles` staged [64][D + 1] tiles
// and `scores` staged [64][65] score tiles; above 48 KB it must be allowed
// per kernel
template <typename K>
inline int set_smem(K kernel, int D, int tiles, int scores, size_t* bytes) {
  *bytes = sizeof(float) * ((size_t)tiles * BQ * (D + 1) +
                            (size_t)scores * BQ * PS);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes));
}

// ---------------------------------------------------------------------------
// bf16 instance on tensor cores
//
// A block is 4 warps (128 threads) over one 64-row tile (dk/dv at D above
// 128: 8, two warp groups, flash_bwd.cu); warp w owns its
// rows 16 w .. 16 w + 15 and every product of those rows runs on
// mma.sync m16n8k16 (bf16 operands, f32 sums): a warp's 16 x 64 score tile
// is 8 accumulator fragments, s[j] holding columns 8 j .. 8 j + 7 (or 4,
// half the tile, where registers are short), and a D-wide accumulator is
// DMAX / 8 fragments. Tiles sit in shared memory as bf16, [64][TS] with
// TS = DP + 8, DP being D padded to a multiple of 16: the pad columns
// D .. DP are zero, so they add nothing to a product over D, and the row
// stride is an odd multiple of 16 bytes, so the 8 rows one ldmatrix reads
// lie in distinct banks. Tiles arrive by 16-byte cp.async (rows past the
// end zero-filled); with RoPE tables a q or k tile goes through registers
// instead, rotated and rounded by the f32 instance's load_tile. A score
// tile's probabilities (or ds) are rounded to bf16 and repacked from
// accumulator fragments into the A fragments of the next product in
// registers: an m16n8 C fragment's rows and columns are those of half an
// m16k16 A fragment.
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;

__host__ __device__ __forceinline__ int dpad(int D) {
  return (D + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int stride(int D) { return dpad(D) + 8; }

// bytes of dynamic shared memory for `tiles` staged [64][TS] bf16 tiles and
// `floats` more f32 values; above 48 KB it must be allowed per kernel
template <typename K>
inline int set_smem(K kernel, int D, int tiles, int floats, size_t* bytes) {
  *bytes = sizeof(bf16) * (size_t)tiles * BQ * stride(D) +
           sizeof(float) * (size_t)floats;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes));
}

// the dynamic shared memory a kernel's launches are allowed, in bytes: what
// set_smem set before its last launch, as the runtime holds it
template <typename K>
inline int smem_of(K kernel, int* bytes) {
  cudaFuncAttributes a;
  const cudaError_t rc = cudaFuncGetAttributes(&a, kernel);
  *bytes = rc == cudaSuccess ? a.maxDynamicSharedSizeBytes : -1;
  return static_cast<int>(rc);
}

// zero the pad columns D .. DP of `rows` staged rows (D % 16 == 8 only);
// NTH threads share the rows (the load helpers below take the same)
template <int NTH = THREADS>
__device__ __forceinline__ void zero_pads(bf16* t, int rows, int D) {
  if (D % 16 == 0) return;
  const int ts = stride(D);
  for (int r = threadIdx.x; r < rows; r += NTH)
    *reinterpret_cast<uint4*>(t + (size_t)r * ts + D) = uint4{0, 0, 0, 0};
}

// Rows [row0, row0 + 64) of x [n, D] into dst [64][TS]: by cp.async, or,
// with tables, rotated by RoPE at each row's position in f32 and rounded to
// bf16 (the reference's _rot). Rows past n are zero.
template <int NTH = THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* x, int row0,
                                          int n, int D, const float* cos,
                                          const float* sin) {
  const int ts = stride(D);
  if (!cos) {
    const int chunks = D / 8;
    for (int idx = threadIdx.x; idx < BQ * chunks; idx += NTH) {
      const int r = idx / chunks, c = (idx - r * chunks) * 8;
      const int row = row0 + r;
      const bool ok = row < n;
      mma::cp_async16(dst + r * ts + c, x + (size_t)(ok ? row : 0) * D + c,
                      ok);
    }
    return;
  }
  flash::load_tile<bf16, NTH>(dst, ts, x, row0, n, D, cos, sin);
}
// rows [row0, row0 + 64) of the f32 vector x [n] into dst [64]; 0 past n
template <int NTH = THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* x,
                                          int row0, int n) {
  for (int r = threadIdx.x; r < BQ; r += NTH) {
    const bool ok = row0 + r < n;
    mma::cp_async4(dst + r, x + (ok ? row0 + r : 0), ok);
  }
}

// A fragment of k step ks (columns 16 ks ..) of the 16 staged rows at t
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int ts, int ks, int lane) {
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  mma::ldsm_x4(a, t + r * ts + ks * 16 + (lane >> 4) * 8);
}

// B fragments of n tiles n0 and n0 + 8 at k step ks for a product with the
// staged rows of t as B's columns (b = t^T: t [n][k], keys or q rows by d):
// b[0], b[1] for n0, b[2], b[3] for n0 + 8
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* t,
                                       int ts, int n0, int ks, int lane) {
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  mma::ldsm_x4(b, t + r * ts + ks * 16 + ((lane >> 3) & 1) * 8);
}

// the same for a product with t itself as B (t [k][n], rows by d): k step
// ks over t's rows 16 ks .., n tiles n0 and n0 + 8 over its columns
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* t,
                                        int ts, int n0, int ks, int lane) {
  const int r = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  mma::ldsm_x4_t(b, t + r * ts + n0 + (lane >> 4) * 8);
}

// The A fragments of a warp's 16 staged rows over D: held in registers
// (HOLD) or read from shared memory at each use (when registers are short).
template <int KS, bool HOLD>
struct AFrags {
  uint32_t r[HOLD ? KS : 1][4];
  const bf16* t;
  int ts;

  __device__ __forceinline__ void init(const bf16* rows, int D, int lane) {
    t = rows;
    ts = stride(D);
    if (HOLD) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        if (ks < dpad(D) / 16) frag_a(r[ks], t, ts, ks, lane);
    }
  }
  __device__ __forceinline__ void get(uint32_t (&a)[4], int ks,
                                      int lane) const {
    if (HOLD) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = r[HOLD ? ks : 0][i];
    } else {
      frag_a(a, t, ts, ks, lane);
    }
  }
};

// s = A b over D: a warp's 16 rows against the first 8 NJ staged rows of t.
// Each k step issues all its fragment loads before its products, so their
// latency is paid once a step and not once a product.
template <int NJ, int KS, bool HOLD>
__device__ __forceinline__ void dot_tile(float (&s)[NJ][4],
                                         const AFrags<KS, HOLD>& A,
                                         const bf16* t, int D, int lane) {
  const int ts = stride(D), nks = dpad(D) / 16;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < nks) {
      uint32_t a[4], b[NJ / 2][4];
      A.get(a, ks, lane);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp)
        frag_b(b[jp], t, ts, 16 * jp, ks, lane);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        mma::mma_bf16(s[2 * jp], a, b[jp][0], b[jp][1]);
        mma::mma_bf16(s[2 * jp + 1], a, b[jp][2], b[jp][3]);
      }
    }
  }
}

// acc += round(p) x: p a warp's 16 x 8 NJ fragments (rounded to bf16 here,
// repacked as A fragments), x the first 8 NJ rows of a staged tile. Up to
// 128 columns (NT 16) a k step loads all its B fragments before its
// products; wider (NT 32, D up to 256) it loads and multiplies them 4
// pairs at a time, so that 16 registers and not 64 hold them beside acc.
template <int NT, int NJ>
__device__ __forceinline__ void acc_tile(float (&acc)[NT][4],
                                         const float (&p)[NJ][4],
                                         const bf16* x, int D, int lane) {
  const int ts = stride(D), nks = dpad(D) / 16;
  if constexpr (NT > 16) {
    constexpr int JB = 4;
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      const uint32_t a[4] = {
          mma::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
          mma::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
          mma::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          mma::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int j0 = 0; j0 < NT / 2; j0 += JB) {
        uint32_t b[JB][4];
#pragma unroll
        for (int jb = 0; jb < JB; ++jb)
          if (j0 + jb < nks) frag_bt(b[jb], x, ts, 16 * (j0 + jb), kk, lane);
#pragma unroll
        for (int jb = 0; jb < JB; ++jb) {
          if (j0 + jb < nks) {
            mma::mma_bf16(acc[2 * (j0 + jb)], a, b[jb][0], b[jb][1]);
            mma::mma_bf16(acc[2 * (j0 + jb) + 1], a, b[jb][2], b[jb][3]);
          }
        }
      }
    }
    return;
  }
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t b[NT / 2][4];
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp)
      if (jp < nks) frag_bt(b[jp], x, ts, 16 * jp, kk, lane);
    const uint32_t a[4] = {
        mma::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
        mma::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        mma::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        mma::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      if (jp < nks) {
        mma::mma_bf16(acc[2 * jp], a, b[jp][0], b[jp][1]);
        mma::mma_bf16(acc[2 * jp + 1], a, b[jp][2], b[jp][3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// a warp's accumulator fragments (rows r0 .. r0 + 15) into the f32 tile
// F [64][lf], columns below D
template <int NT>
__device__ __forceinline__ void stage(float* F, int lf,
                                      const float (&acc)[NT][4], int r0,
                                      int D, int lane) {
  const int g = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + c0;
    if (c < D) {
      *reinterpret_cast<float2*>(F + (r0 + g) * lf + c) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(F + (r0 + g + 8) * lf + c) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// max and sum over the 4 lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace tc

}  // namespace flash
