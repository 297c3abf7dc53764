// LoRA linear forward, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lora_fused.py: lora_fused
// (_lora_fused_kernel), with the same arithmetic:
//
//   y = x @ W0 + s * round(x @ A) @ B
//
//   x [M, K], W0 [K, N], A [K, r], B [r, N] (r <= 32), y [M, N] in x's type;
//   f32 sums; h = x @ A is rounded to x's type before it meets B.
//
// What bounds it. At the training shapes (M = 192 rows of batch 4 x seq 48,
// K, N in {896, 128, 4864}) the x @ W0 product does 2 M = 384 FLOPs per
// 2-byte W0 element, 192 FLOP/byte: below the H100's bf16 tensor-core ridge
// of ~295, so the least time is that of reading W0 once. This first kernel
// runs on CUDA cores (f32 FMAs), whose rate, not the bytes, limits it.
//
// Design: the tiled product of lora_gemm.cuh. Each 64 x 64 tile of y sums
// its rows' h = x @ A ([64, r], f32) in the same K loop as x @ W0, from the
// same x slab in shared memory; the column blocks of one row tile repeat
// that r-wide work, a fraction r / 64 of the main product. The epilogue
// rounds h to x's type and adds s * h @ B[:, cols]. h never reaches device
// memory: the point of MeSP, which the TPU kernel kept in VMEM.

#include "lora_gemm.cuh"

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int lora_fused_fwd(int dtype, const void* x, const void* w0,
                              const void* a, const void* b, void* y, int M,
                              int K, int N, int r, float scale,
                              void* stream) {
  return lora_gemm::launch<false>(dtype, x, w0, a, b, y, M, K, N, r, scale,
                                  stream);
}
