// Warp-level tensor-core and asynchronous-copy primitives for Hopper
// (sm_90a), as thin wrappers over their PTX instructions:
//
// * cp_async16 / cp_async4: a 16- or 4-byte copy from device memory to
//   shared memory that does not pass through registers (cp.async); a copy
//   whose `ok` is false reads nothing and writes zeros; cp_async16_l2 asks
//   L2 to fetch the whole 128-byte line around the 16 bytes (for a slab
//   that reads a row's line in parts, one part per slab). Copies are grouped
//   by cp_async_commit, and cp_async_wait<N> waits until at most N of the
//   thread's groups are still in flight (a __syncthreads after it makes
//   every thread's copies visible to the block).
// * ldsm_x4 / ldsm_x4_t: four 8 x 8 matrices of 16-bit values from shared
//   memory (ldmatrix); lane l gives the address of row l % 8 of matrix
//   l / 8 (16 bytes, 16-byte aligned) and receives, in register i, the
//   elements (l / 4, 2 (l % 4) + {0, 1}) of matrix i, or with _t those of
//   its transpose.
// * mma_bf16: d += a b on one m16n8k16 tile, bf16 operands, f32 sums
//   (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32). With g = l / 4
//   and t = l % 4: a[0..3] hold A's (g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
//   (g + 8, 2t + 8..); b[0..1] B's (2t.., g), (2t + 8.., g); d[0..3] D's
//   (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// * pack_bf16: two f32 values rounded to bf16 (to nearest, ties to even)
//   in one register, the first in the low half: an A or B operand pair.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16_l2(void* dst, const void* src,
                                              bool ok) {
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(ok ? 16 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma
