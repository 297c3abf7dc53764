// The tensor-core pieces shared by the bf16 LoRA kernels: the grouped
// forward over expert stacks (lora_grouped_tc.cuh) and the dense forward
// over one W0 (lora_dense_tc.cuh); the two input gradients, grouped
// (lora_grouped_dx_tc.cuh) and dense (lora_dense_dx_tc.cuh), take the
// A-fragment loader, the code conversions, the slab copies and W0^T's B
// fragments (frag_rows, frag_pair8, frag_pair4). The forwards compute, per
// output tile,
//
//   acc = x @ w(W0)   and   h = x @ A
//
// in one K loop over slabs of BK = 32 staged in shared memory by cp.async,
// on mma.sync m16n8k16 (bf16 in, f32 sums, csrc/mma.cuh). Each kernel has
// its own loop, grid and epilogue; what they share is here:
//
// * the A-fragment (x, by ldmatrix) and transposed B-fragment (A's slab,
//   ldmatrix.trans) loaders;
// * W0's B fragments built in registers, the same way in every format: in
//   a warp's n8 tile j, lane group g holds column 4 g + j, so one 32-bit
//   load of a K row gives a lane its column in all four tiles (8 bytes for
//   bf16). Codes become bf16 pairs right there: int8 through the f32 bit
//   pattern 2^23 + 128 + v (exact, no conversion instruction); a packed
//   byte holds rows 2i and 2i + 1 of one column, which is one fragment
//   register, and its two nibbles go through a 16-entry bf16 table held in
//   eight registers and read with byte permutes (int4's sign-extended
//   values, nf4's codebook rounded to bf16). A nibble of a row k >= K (the
//   pad of an odd K) becomes zero;
// * W0^T's B fragments for the input gradients, whose contraction runs
//   along a W0 row: bf16 by ldmatrix without .trans, int8 by 16-bit loads
//   of adjacent codes, packed codes with an n8 tile pair on a byte's two
//   rows (col_of);
// * stage_block, the masked slab copy: 16-byte cp.async copies where an
//   operand's rows and base allow them, element by element elsewhere.
// Every function is inlined into its kernel; the grouped kernels keep the
// registers they had when these lived in their own headers.
#pragma once

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "wfmt.cuh"

namespace lora_tc {

using bf16 = __nv_bfloat16;
using wfmt::WFmt;

constexpr int BK = 32;          // contraction slab
constexpr int STAGES = 4;       // ring stages of the grouped forward
constexpr int RMAX = 32;        // largest LoRA rank (lora_gemm.cuh's RMAX)
// row strides in shared memory (elements) of x and A, each 8 past a
// multiple of 16: the 8 rows an ldmatrix reads meet distinct banks
constexpr int XS = BK + 8, AS = RMAX + 8;

// which operands take 16-byte copies (their rows and base 16-byte aligned);
// the others are loaded element by element; kVecY: 16-byte stores of y
enum : int {
  kVecX = 1, kVecW = 2, kVecA = 4, kVecB = 8, kVecY = 16, kVecS = 32
};

// A fragment (rows 0 .. 15 of t, columns 16 ks ..) for mma_bf16
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int ts, int ks, int lane) {
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  mma::ldsm_x4(a, t + r * ts + ks * 16 + (lane >> 4) * 8);
}

// B fragments of n tiles n0 and n0 + 8 at k step ks from t [k][n] in
// natural column order: b[0], b[1] for n0, b[2], b[3] for n0 + 8
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* t,
                                        int ts, int n0, int ks, int lane) {
  const int r = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  mma::ldsm_x4_t(b, t + r * ts + n0 + (lane >> 4) * 8);
}

// prmt.b32: byte n of the result is byte s[4n+2 : 4n] of {b, a} (a bytes
// 0-3), or, where s[4n+3] is set, that byte's top bit copied to all 8 bits
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// The B fragments (b[j][0..1], n8 tile j) of k step ks over a warp's 32
// columns c0 .. of a bf16 slab t [k][n] (row stride ts), lane group g on
// column c0 + 4 g + j: rows 16 ks + 2 l, + 1, + 8, + 9 (l = lane % 4).
__device__ __forceinline__ void frag_b16(uint32_t (&b)[4][2], const bf16* t,
                                         int ts, int c0, int ks, int lane) {
  const bf16* p = t + (ks * 16 + 2 * (lane & 3)) * ts + c0 + 4 * (lane >> 2);
  const uint2 r0 = *reinterpret_cast<const uint2*>(p);
  const uint2 r1 = *reinterpret_cast<const uint2*>(p + ts);
  const uint2 r8 = *reinterpret_cast<const uint2*>(p + 8 * ts);
  const uint2 r9 = *reinterpret_cast<const uint2*>(p + 9 * ts);
  b[0][0] = prmt(r0.x, r1.x, 0x5410);
  b[1][0] = prmt(r0.x, r1.x, 0x7632);
  b[2][0] = prmt(r0.y, r1.y, 0x5410);
  b[3][0] = prmt(r0.y, r1.y, 0x7632);
  b[0][1] = prmt(r8.x, r9.x, 0x5410);
  b[1][1] = prmt(r8.x, r9.x, 0x7632);
  b[2][1] = prmt(r8.y, r9.y, 0x5410);
  b[3][1] = prmt(r8.y, r9.y, 0x7632);
}

// byte J of the biased codes u0 and u1 (v + 128) as a bf16 pair: the f32
// 2^23 + u, less 2^23 + 128, is v exactly, and its upper half is bf16(v)
template <int J>
__device__ __forceinline__ uint32_t int8_pair(uint32_t u0, uint32_t u1) {
  const float f0 =
      __uint_as_float(prmt(u0, 0x4B000000u, 0x7440 | J)) - 8388736.f;
  const float f1 =
      __uint_as_float(prmt(u1, 0x4B000000u, 0x7440 | J)) - 8388736.f;
  return prmt(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// The same over int8 codes t [k][S8 bytes]: one 32-bit load a row
template <int S8>
__device__ __forceinline__ void frag_b8(uint32_t (&b)[4][2], const uint8_t* t,
                                        int c0, int ks, int lane) {
  const uint8_t* p = t + (ks * 16 + 2 * (lane & 3)) * S8 + c0 +
                     4 * (lane >> 2);
  const uint32_t u0 = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  const uint32_t u1 = *reinterpret_cast<const uint32_t*>(p + S8) ^ 0x80808080u;
  const uint32_t u8 =
      *reinterpret_cast<const uint32_t*>(p + 8 * S8) ^ 0x80808080u;
  const uint32_t u9 =
      *reinterpret_cast<const uint32_t*>(p + 9 * S8) ^ 0x80808080u;
  b[0][0] = int8_pair<0>(u0, u1);
  b[1][0] = int8_pair<1>(u0, u1);
  b[2][0] = int8_pair<2>(u0, u1);
  b[3][0] = int8_pair<3>(u0, u1);
  b[0][1] = int8_pair<0>(u8, u9);
  b[1][1] = int8_pair<1>(u8, u9);
  b[2][1] = int8_pair<2>(u8, u9);
  b[3][1] = int8_pair<3>(u8, u9);
}

// A 16-entry bf16 table for the nibbles: lo[q] holds the low bytes of
// entries 4 q .. 4 q + 3, hi[q] their high bytes
struct NibTable {
  uint32_t lo[4], hi[4];
};

template <WFmt F>
__device__ __forceinline__ NibTable nib_table() {
  NibTable tb;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    tb.lo[q] = tb.hi[q] = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * q + e;
      const uint32_t v = __bfloat16_as_ushort(
          F == WFmt::kInt4 ? __float2bfloat16(static_cast<float>((i ^ 8) - 8))
                           : __float2bfloat16(wfmt::kNF4[i]));
      tb.lo[q] |= (v & 0xffu) << (8 * e);
      tb.hi[q] |= (v >> 8) << (8 * e);
    }
  }
  return tb;
}

// The 4 nibbles in the low 16 bits of s (two packed bytes: tiles j, j + 1,
// each low nibble then high) as two bf16 pairs p0 (tile j) and p1: table
// entries 0-7 and 8-15 by byte permutes, the half chosen by m (byte n 0xff
// where nibble n is 8 or more). The pairs are the nibbles (0, 1) and (2, 3),
// the forward's; with S0 = 0x6240, S1 = 0x7351 they are (0, 2) and (1, 3),
// both bytes' low nibbles and both high ones (dx: tiles j, j + 1 on a byte's
// two rows, lora_grouped_dx_tc.cuh).
template <uint32_t S0 = 0x5140, uint32_t S1 = 0x7362>
__device__ __forceinline__ void nib_pairs(uint32_t s, uint32_t m,
                                          const NibTable& tb, uint32_t& p0,
                                          uint32_t& p1) {
  const uint32_t s7 = s & 0x7777u;
  const uint32_t l = (prmt(tb.lo[0], tb.lo[1], s7) & ~m) |
                     (prmt(tb.lo[2], tb.lo[3], s7) & m);
  const uint32_t h = (prmt(tb.hi[0], tb.hi[1], s7) & ~m) |
                     (prmt(tb.hi[2], tb.hi[3], s7) & m);
  p0 = prmt(l, h, S0);
  p1 = prmt(l, h, S1);
}

// The same over packed codes t [k / 2][S4 bytes] (byte row i: rows 2i and
// 2i + 1 of a column), rows at or past kv zero.
template <int S4>
__device__ __forceinline__ void frag_b4(uint32_t (&b)[4][2], const uint8_t* t,
                                        const NibTable& tb, int c0, int ks,
                                        int kv, int lane) {
  const int l = lane & 3;
  const uint8_t* p = t + (ks * 8 + l) * S4 + c0 + 4 * (lane >> 2);
  const int k = ks * 16 + 2 * l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // byte rows ks * 8 + l and + 4
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p + 4 * h * S4);
    const uint32_t w4 = w << 4;  // each low nibble's bit 3 at its byte's top
    nib_pairs(w, prmt(w4, w, 0xD9C8), tb, b[0][h], b[1][h]);
    nib_pairs(w >> 16, prmt(w4, w, 0xFBEA), tb, b[2][h], b[3][h]);
    const uint32_t keep = (k + 8 * h < kv ? 0x0000ffffu : 0u) |
                          (k + 8 * h + 1 < kv ? 0xffff0000u : 0u);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j][h] &= keep;
  }
}

// W0^T's B fragments: a B register pairs W0[k, n] and W0[k, n + 1] of a
// slab [output column k][BK of n] as stored (bf16 rows XS apart, codes SC
// bytes apart).

// row stride (bytes) of the code slabs, 12 words: the 8 rows of a fragment
// load (two words each) meet distinct banks. A bf16 slab's rows are
// [BK + 8] like g's (XS): ldmatrix's 8 rows meet distinct banks.
constexpr int SC = BK + 16;

// The output column, counted from the warp's first, that lane group g of
// n8 tile j holds: natural for bf16 and int8; over packed codes tiles 2p
// and 2p + 1 on rows 2i and 2i + 1 of byte row i = 8 p + g.
template <WFmt F>
__device__ __forceinline__ int col_of(int j, int g) {
  if constexpr (wfmt::is_packed(F))
    return 16 * (j >> 1) + 2 * g + (j & 1);
  else
    return 8 * j + g;
}

// B fragments of n8 tiles j0 and j0 + 1 at k step ks from t [output
// column][contraction] (row stride ts), columns by col_of<F> from c0:
// b[0], b[1] tile j0; b[2], b[3] tile j0 + 1. No .trans: a B register's
// pair lies along a row.
template <WFmt F>
__device__ __forceinline__ void frag_rows(uint32_t (&b)[4], const bf16* t,
                                          int ts, int c0, int j0, int ks,
                                          int lane) {
  const int mat = lane >> 3;
  const int row = c0 + col_of<F>(j0 + (mat >> 1), lane & 7);
  mma::ldsm_x4(b, t + row * ts + ks * 16 + (mat & 1) * 8);
}

// int8 codes t [output column][SC bytes], n8 tiles 2 jp and 2 jp + 1: per
// tile two 16-bit loads of adjacent codes (contraction 2l, 2l + 1 and
// 2l + 8, 2l + 9), widened through the f32 bit pattern as the forward does
// (int8_pair)
__device__ __forceinline__ void frag_pair8(uint32_t (&b)[2][2],
                                           const uint8_t* t, int c0, int jp,
                                           int ks, int lane) {
  const uint8_t* p = t + (c0 + 16 * jp + (lane >> 2)) * SC + ks * 16 +
                     2 * (lane & 3);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const uint8_t* q = p + 8 * jj * SC;
    const uint32_t u =
        (*reinterpret_cast<const uint16_t*>(q) |
         static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(q + 8))
             << 16) ^
        0x80808080u;
    b[jj][0] = int8_pair<0>(u, u >> 8);
    b[jj][1] = int8_pair<2>(u, u >> 8);
  }
}

// packed codes t [output column / 2][SC bytes], n8 tiles 2 jp and 2 jp + 1:
// byte row c0 / 2 + 8 jp + g, its low nibbles and its high ones (col_of)
__device__ __forceinline__ void frag_pair4(uint32_t (&b)[2][2],
                                           const uint8_t* t,
                                           const NibTable& tb, int c0, int jp,
                                           int ks, int lane) {
  const uint8_t* q = t + (c0 / 2 + 8 * jp + (lane >> 2)) * SC + ks * 16 +
                     2 * (lane & 3);
  const uint32_t w =
      *reinterpret_cast<const uint16_t*>(q) |
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(q + 8)) << 16;
  const uint32_t w4 = w << 4;  // each low nibble's bit 3 at its byte's top
  nib_pairs<0x6240, 0x7351>(w, prmt(w4, w, 0xD9C8), tb, b[0][0], b[1][0]);
  nib_pairs<0x6240, 0x7351>(w >> 16, prmt(w4, w, 0xFBEA), tb, b[0][1],
                            b[1][1]);
}

// The B fragments of n8 tiles 2 jp and 2 jp + 1 at k step ks over the
// warp's columns c0 .. of the W0 slab ws, in format F
template <WFmt F>
__device__ __forceinline__ void frag_w(uint32_t (&b)[2][2],
                                       const uint8_t* ws, const NibTable& tb,
                                       int c0, int jp, int ks, int lane) {
  if constexpr (F == WFmt::kDense) {
    uint32_t b4[4];
    frag_rows<F>(b4, reinterpret_cast<const bf16*>(ws), XS, c0, 2 * jp, ks,
                 lane);
    b[0][0] = b4[0];
    b[0][1] = b4[1];
    b[1][0] = b4[2];
    b[1][1] = b4[3];
  } else if constexpr (F == WFmt::kInt8) {
    frag_pair8(b, ws, c0, jp, ks, lane);
  } else {
    frag_pair4(b, ws, tb, c0, jp, ks, lane);
  }
}

// s a power of two of magnitude 1 or more: round(s g) = s g exactly for
// every bf16 g (no subnormal result), so s may multiply an f32 sum of g's
// products instead (the dense dx's dh, dA/dB's dh and dB)
inline bool pow2_scale(float s) {
  int e = 0;
  return std::fabs(std::frexp(s, &e)) == 0.5f && e >= 1;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename E> __device__ __forceinline__ E zero() { return E(0); }
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

// Rows [0, rows) x columns [0, cols) of the block of src at (r0, c0) (row
// stride ld, rows below nr and columns below nc in range) into dst (row
// stride ds), zero elsewhere, by the block's NT threads: by 16-byte copies
// (V elements each) when vec, else element by element. L2: the copies ask
// L2 for each row's whole 128-byte line (mma::cp_async16_l2).
template <int V, int NT, typename E, bool L2 = false>
__device__ __forceinline__ void stage_block(E* dst, int ds, const E* src,
                                            size_t ld, int r0, int c0,
                                            int rows, int cols, int nr,
                                            int nc, bool vec) {
  if (vec) {
    const int chunks = cols / V;
    for (int i = threadIdx.x; i < rows * chunks; i += NT) {
      const int rr = i / chunks, cc = (i - rr * chunks) * V;
      const bool ok = r0 + rr < nr && c0 + cc < nc;
      const E* from = ok ? src + (size_t)(r0 + rr) * ld + c0 + cc : src;
      if constexpr (L2)
        mma::cp_async16_l2(dst + rr * ds + cc, from, ok);
      else
        mma::cp_async16(dst + rr * ds + cc, from, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += NT) {
      const int rr = i / cols, cc = i - rr * cols;
      const bool ok = r0 + rr < nr && c0 + cc < nc;
      dst[rr * ds + cc] =
          ok ? src[(size_t)(r0 + rr) * ld + c0 + cc] : zero<E>();
    }
  }
}

}  // namespace lora_tc
