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
// What bounds it. At the training paths' shapes (M = 192 rows of batch 4 x
// seq 48 or 256 of 1 x 256; K, N in {896, 128, 4864}; OLMoE's q, k, v, o
// 2048 x 2048) x @ W0 does 2 M = 384-512 FLOPs per 2-byte W0 element,
// 192-256 FLOP/byte, near the H100's bf16 tensor-core ridge of ~295; but
// each launch is small (a few microseconds at the card's peaks), so how
// much of the card it fills sets its time.
//
// Design. bf16: lora_dense_tc.cuh's tensor-core body (mma.sync over a
// cp.async ring, h = x @ A in the same K loop, K split across a cluster of
// up to 8 blocks whose f32 partials meet in distributed shared memory,
// h rounded once after the sum). f32: lora_gemm.cuh's tiled product on CUDA
// cores (f32 FMAs, no TF32), each 64 x 64 tile of y summing its rows' h in
// the same K loop. Either way h never reaches device memory: the point of
// MeSP, which the TPU kernel kept in VMEM.

#include "lora_dense_tc.cuh"
#include "lora_gemm.cuh"

using wfmt::WFmt;

// Returns cudaGetLastError() after the launch (0 when it was accepted).
// split: the bf16 body's K split (the f32 body takes none).
extern "C" int lora_fused_fwd(int dtype, const void* x, const void* w0,
                              const void* a, const void* b, void* y, int M,
                              int K, int N, int r, float scale, int split,
                              void* stream) {
  if (dtype == DTYPE_BF16)
    return dense_tc::launch<WFmt::kDense>(x, w0, nullptr, a, b, y, M, K, N,
                                          r, scale, split, stream);
  if (dtype == DTYPE_F32)
    return lora_gemm::launch_as<false, WFmt::kDense, float>(
        x, w0, nullptr, a, b, y, M, K, N, r, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 launch plan at M x K -> N under the caller's K split (members
// of a cluster, checked against its limits): the dynamic shared memory
// (bytes) the runtime holds for the instance M selects. Returns a CUDA
// error code.
extern "C" int lora_fused_fwd_plan(int M, int K, int N, int split,
                                   int* smem) {
  return dense_tc::plan<WFmt::kDense>(M, K, N, split, smem);
}
