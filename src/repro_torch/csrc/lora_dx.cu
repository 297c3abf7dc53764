// LoRA linear input gradient, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lora_fused.py: lora_dx
// (_lora_dx_kernel), with the same arithmetic:
//
//   dx = g @ W0^T + dh @ A^T,   dh = round((s g) @ B^T)
//
//   g [M, N], W0 [K, N], A [K, r], B [r, N], dx [M, K] in g's type; f32
//   sums, dh rounded to g's type, one rounding of the output.
//
// What bounds it: as the forward, the g @ W0^T product (2 M FLOPs per W0
// element), which at the training paths' shapes is a few microseconds at
// the card's peaks: how much of the card a launch fills sets its time.
//
// Design. bf16 (lora_dx_tc): lora_dense_dx_tc.cuh's tensor-core body, dh
// summed in its own loop over N beside g @ W0^T, N split across a cluster
// of up to 8 blocks, W0 read in place: one launch, no dh in device memory.
// f32 (lora_dx): the tiled product of lora_gemm.cuh on CUDA cores, a block
// a 64 x 64 tile of dx, W0 read in place as stored ([K, N], contiguous n)
// and turned round in shared memory, dh (the wrapper's thin product, as the
// TPU wrapper computed it) added in the epilogue. The TPU wrapper wrote a
// transposed, padded copy of W0 to device memory on every call; neither
// writes one.

#include "lora_dense_dx_tc.cuh"
#include "lora_gemm.cuh"

using wfmt::WFmt;

// The f32 dx on the wrapper's dh (bf16 takes lora_dx_tc). Returns
// cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int lora_dx(const void* g, const void* w0, const void* a,
                       const void* dh, void* dx, int M, int K, int N, int r,
                       void* stream) {
  return lora_gemm::launch_as<true, WFmt::kDense, float>(
      g, w0, nullptr, dh, a, dx, M, N, K, r, 1.f, stream);
}

// The bf16 dx, dh = round(round(s g) @ B^T) summed in the kernel.
extern "C" int lora_dx_tc(const void* g, const void* w0, const void* a,
                          const void* b, void* dx, int M, int K, int N, int r,
                          float scale, int split, void* stream) {
  return dense_dx_tc::launch<WFmt::kDense>(g, w0, nullptr, a, b, dx, M, K, N,
                                           r, scale, split, stream);
}

// The bf16 dx's launch plan at g [M, N] -> dx [M, K] under the caller's
// split of N (members of a cluster, checked against its limits): the
// dynamic shared memory (bytes) the runtime holds for the instance M
// selects. Returns a CUDA error code.
extern "C" int lora_dx_plan(int M, int K, int N, int split, int* smem) {
  return dense_dx_tc::plan<WFmt::kDense>(M, K, N, split, smem);
}
