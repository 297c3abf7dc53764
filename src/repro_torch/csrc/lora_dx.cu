// LoRA linear input gradient, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lora_fused.py: lora_dx
// (_lora_dx_kernel), with the same arithmetic:
//
//   dx = g @ W0^T + dh @ A^T,   dh = round((s g) @ B^T)
//
//   g [M, N], W0 [K, N], A [K, r], dh [M, r] in g's type (the thin product
//   the wrapper computes, as the TPU wrapper did), dx [M, K] in g's type;
//   f32 sums, one rounding of the output.
//
// What bounds it: as the forward, the g @ W0^T product (2 M FLOPs per W0
// element); on CUDA cores, the arithmetic.
//
// Design: the tiled product of lora_gemm.cuh with W0 read in place as
// stored, [K, N] with contiguous n: a block owns a 64 x 64 tile of dx
// (rows m, columns k) and loads, per slab of 32 n, 64 rows of W0 of 32
// contiguous n each, transposing them in shared memory. The TPU wrapper
// wrote a transposed, padded copy of W0 to device memory on every call; this
// kernel writes none. The epilogue adds dh @ A^T from shared memory.

#include "lora_gemm.cuh"

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int lora_dx(int dtype, const void* g, const void* w0,
                       const void* a, const void* dh, void* dx, int M, int K,
                       int N, int r, void* stream) {
  return lora_gemm::launch<true, lora_gemm::WFmt::kDense>(
      dtype, g, w0, nullptr, dh, a, dx, M, N, K, r, 1.f, stream);
}
