// LoRA linear forward and input gradient over a packed 4-bit frozen base
// (int4 or nf4), written by hand for Hopper.
//
// Replace the TPU kernels of src/repro/kernels/lora_pack4.py: lora_fused_q4
// (_lora_fused_q4_kernel, _unpack_tile) and lora_dx_q4 (_lora_dx_q4_kernel),
// with the same arithmetic as lora_quant.cu over W0 = w(q4) * s, where
// q4 uint8 [ceil(K/2), N] packs rows 2j / 2j + 1 into the low / high nibble
// of byte row j, and w is the sign-extended nibble (int4) or NF4_CODE[nibble]
// rounded to the activations' type (nf4).
//
// What bounds them. At M = 256 a 4-bit product does 1,024 FLOPs per W0
// byte, above the H100's bf16 ridge of ~295: the least time is that of the
// FLOPs, a few microseconds a launch at the path's shapes.
//
// Design. The bf16 forward is lora_dense_tc.cuh's tensor-core body with W0
// in format kInt4 or kNF4: the packed bytes are staged raw, and each byte
// (rows 2j, 2j + 1 of a column: one fragment register) becomes a bf16 pair
// through a 16-entry table in registers read with byte permutes; the K
// range is split across a cluster. The bf16 dx is lora_dense_dx_tc.cuh's
// body in the same formats: the bytes staged raw as stored, an n8 tile pair
// on a byte's two rows (one 16-bit load gives one tile its low nibbles and
// the other its high ones), g's slab scaled by round(s) once a slab, dh
// summed in the same loop, N split across a cluster: one launch. The f32
// forward and dx are the tiled product of lora_gemm.cuh on CUDA cores (one
// kernel body, the format a template parameter): a BK = 32 slab of W0 is 16
// byte rows; the forward's loader gives each thread 4 contiguous bytes of
// one byte row and writes 8 weights (two k rows) to shared memory; dx reads
// the packed bytes in place and untransposed, 4 contiguous bytes along n of
// one byte row per thread, each byte giving two output columns, and adds
// the wrapper's dh. The nf4 codebook is rounded to the activations' type
// once per block. Odd K: the pad nibble is masked to zero in the forward
// and meets a masked x column; dx never writes rows at k >= K, which it
// takes from A. No dense float W0 reaches device memory.

#include "lora_dense_dx_tc.cuh"
#include "lora_dense_tc.cuh"
#include "lora_gemm.cuh"

using wfmt::WFmt;

namespace {

template <WFmt F>
int fused_q4(int dtype, const void* x, const void* q4, const void* s,
             const void* a, const void* b, void* y, int M, int K, int N,
             int r, float scale, int split, void* stream) {
  if (dtype == DTYPE_BF16)
    return dense_tc::launch<F>(x, q4, s, a, b, y, M, K, N, r, scale, split,
                               stream);
  if (dtype == DTYPE_F32)
    return lora_gemm::launch_as<false, F, float>(x, q4, s, a, b, y, M, K, N,
                                                 r, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// method: 0 int4, 1 nf4. Each returns cudaGetLastError() after the launch.
extern "C" int lora_fused_q4(int dtype, int method, const void* x,
                             const void* q4, const void* s, const void* a,
                             const void* b, void* y, int M, int K, int N,
                             int r, float scale, int split, void* stream) {
  if (method == 0)
    return fused_q4<WFmt::kInt4>(dtype, x, q4, s, a, b, y, M, K, N, r, scale,
                                 split, stream);
  if (method == 1)
    return fused_q4<WFmt::kNF4>(dtype, x, q4, s, a, b, y, M, K, N, r, scale,
                                split, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 dx on the wrapper's dh (bf16 takes lora_dx_q4_tc); method 0
// int4, 1 nf4
extern "C" int lora_dx_q4(int method, const void* g, const void* q4,
                          const void* s, const void* a, const void* dh,
                          void* dx, int M, int K, int N, int r, void* stream) {
  if (method == 0)
    return lora_gemm::launch_as<true, WFmt::kInt4, float>(
        g, q4, s, dh, a, dx, M, N, K, r, 1.f, stream);
  if (method == 1)
    return lora_gemm::launch_as<true, WFmt::kNF4, float>(
        g, q4, s, dh, a, dx, M, N, K, r, 1.f, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 dx, dh = round(round(s_lora g) @ B^T) summed in the kernel;
// method 0 int4, 1 nf4.
extern "C" int lora_dx_q4_tc(int method, const void* g, const void* q4,
                             const void* s, const void* a, const void* b,
                             void* dx, int M, int K, int N, int r,
                             float scale, int split, void* stream) {
  if (method == 0)
    return dense_dx_tc::launch<WFmt::kInt4>(g, q4, s, a, b, dx, M, K, N, r,
                                            scale, split, stream);
  if (method == 1)
    return dense_dx_tc::launch<WFmt::kNF4>(g, q4, s, a, b, dx, M, K, N, r,
                                           scale, split, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 forward's launch plan at M x K -> N (lora_fused_fwd_plan's);
// method 0 int4, 1 nf4.
extern "C" int lora_fused_q4_plan(int method, int M, int K, int N,
                                  int split, int* smem) {
  if (method == 0) return dense_tc::plan<WFmt::kInt4>(M, K, N, split, smem);
  if (method == 1) return dense_tc::plan<WFmt::kNF4>(M, K, N, split, smem);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 dx's launch plan at g [M, N] -> dx [M, K]; method 0 int4, 1 nf4.
extern "C" int lora_dx_q4_plan(int method, int M, int K, int N, int split,
                               int* smem) {
  if (method == 0) return dense_dx_tc::plan<WFmt::kInt4>(M, K, N, split, smem);
  if (method == 1) return dense_dx_tc::plan<WFmt::kNF4>(M, K, N, split, smem);
  return static_cast<int>(cudaErrorInvalidValue);
}
