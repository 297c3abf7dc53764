// LoRA linear forward and input gradient over an int8 frozen base, written
// by hand for Hopper.
//
// Replace the TPU kernels of src/repro/kernels/lora_quant.py: lora_fused_q
// (_lora_fused_q_kernel) and lora_dx_q (_lora_dx_q_kernel), with the same
// arithmetic (W0 = q * s per output channel, q int8 [K, N], s f32 [N]):
//
//   y  = round(acc * s + s_lora * (round(x @ A) @ B)),  acc = x @ q
//   dx = round(round(g * round(s)) @ q^T + dh @ A^T),
//        dh = round((s_lora g) @ B^T)
//
//   x [M, K], A [K, r], B [r, N] (r <= 32), g [M, N] in T (f32 or bf16);
//   f32 sums; "round" is to T where the TPU kernels round; dh, the thin
//   product the TPU wrapper computed outside its kernel, is summed in the
//   bf16 dx kernel and computed by the wrapper for f32.
//
// What bounds them. At the paper's batch 1 x seq 256 (M = 256) an int8
// product does 2 M = 512 FLOPs per one-byte W0 element, above the H100's
// bf16 tensor-core ridge of ~295 FLOP/byte: the least time is that of the
// FLOPs, a few microseconds a launch, so how much of the card a launch
// fills sets its time.
//
// Design. The bf16 forward is lora_dense_tc.cuh's tensor-core body with W0
// in format kInt8: the codes are staged raw and turned into bf16 fragment
// registers by a bit trick (exact), the K range is split across a cluster,
// and the scale multiplies the f32 sum once per output in the epilogue. The
// bf16 dx is lora_dense_dx_tc.cuh's body in the same format: the codes
// staged raw and widened into W0^T's fragments the same way, g's slab
// scaled by round(s) in shared memory once a slab, dh summed in the same
// loop on the unscaled g, N split across a cluster: one launch. The f32
// forward and dx are the tiled product of lora_gemm.cuh on CUDA cores: its
// slab loader reads int8 bytes and turns each into a weight in shared
// memory; dx folds the scale onto g as it stages it and adds the wrapper's
// dh. dx reads q in place, [K, N] with contiguous n: the TPU wrapper wrote
// a transposed int8 copy of q to device memory on every call; this writes
// none. No dense float W0 reaches device memory.

#include "lora_dense_dx_tc.cuh"
#include "lora_dense_tc.cuh"
#include "lora_gemm.cuh"

using wfmt::WFmt;

// Each returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int lora_fused_q(int dtype, const void* x, const void* q,
                            const void* s, const void* a, const void* b,
                            void* y, int M, int K, int N, int r, float scale,
                            int split, void* stream) {
  if (dtype == DTYPE_BF16)
    return dense_tc::launch<WFmt::kInt8>(x, q, s, a, b, y, M, K, N, r, scale,
                                         split, stream);
  if (dtype == DTYPE_F32)
    return lora_gemm::launch_as<false, WFmt::kInt8, float>(
        x, q, s, a, b, y, M, K, N, r, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 dx on the wrapper's dh (bf16 takes lora_dx_q_tc)
extern "C" int lora_dx_q(const void* g, const void* q, const void* s,
                         const void* a, const void* dh, void* dx, int M,
                         int K, int N, int r, void* stream) {
  return lora_gemm::launch_as<true, WFmt::kInt8, float>(g, q, s, dh, a, dx, M,
                                                        N, K, r, 1.f, stream);
}

// The bf16 dx, dh = round(round(s_lora g) @ B^T) summed in the kernel.
extern "C" int lora_dx_q_tc(const void* g, const void* q, const void* s,
                            const void* a, const void* b, void* dx, int M,
                            int K, int N, int r, float scale, int split,
                            void* stream) {
  return dense_dx_tc::launch<WFmt::kInt8>(g, q, s, a, b, dx, M, K, N, r,
                                          scale, split, stream);
}

// The bf16 forward's launch plan at M x K -> N (lora_fused_fwd_plan's).
extern "C" int lora_fused_q_plan(int M, int K, int N, int split,
                                 int* smem) {
  return dense_tc::plan<WFmt::kInt8>(M, K, N, split, smem);
}

// The bf16 dx's launch plan at g [M, N] -> dx [M, K] (lora_dx_plan's).
extern "C" int lora_dx_q_plan(int M, int K, int N, int split, int* smem) {
  return dense_dx_tc::plan<WFmt::kInt8>(M, K, N, split, smem);
}
