// W0's storage formats, shared by the kernels that read a frozen base: the
// LoRA GEMM body (lora_gemm.cuh: lora_fused_fwd, lora_dx, lora_quant,
// lora_pack4) and the grouped decode kernel (lora_grouped_fwd.cu).
//
// kDense: W0 in the activations' type T. The quantized formats hold a
// per-output-channel scale S [N] (f32) beside integer codes (the layouts of
// src/repro_torch/core/quant.py): kInt8 one int8 per weight; kInt4 / kNF4
// two 4-bit codes per byte along K (byte row j: K row 2j in the low nibble,
// 2j + 1 in the high one; int4 sign-extended, nf4 an index into kNF4).
#pragma once

#include <cstdint>

#include "common.cuh"

// *p, or zero where ``ok`` is false, for W0's integer codes (beside the
// f32 and bf16 overloads of common.cuh)
__device__ __forceinline__ int8_t load_or_zero(const int8_t* p, bool ok) {
  return ok ? *p : int8_t(0);
}
__device__ __forceinline__ uint8_t load_or_zero(const uint8_t* p, bool ok) {
  return ok ? *p : uint8_t(0);
}

namespace wfmt {

// chip_smoke.py's TC_FORMATS names the formats by these values: it finds
// each format's ptxas figures by the value in the mangled kernel name and
// passes it to lora_grouped_gemm_smem; kernels/lora_grouped.py's
// _DX_FORMATS passes it to lora_grouped_dx_plan. Keep the order.
enum class WFmt { kDense, kInt8, kInt4, kNF4 };

__host__ __device__ constexpr bool is_packed(WFmt f) {
  return f == WFmt::kInt4 || f == WFmt::kNF4;
}

// W0's stored element type
template <typename T, WFmt F> struct WStore { using type = T; };
template <typename T> struct WStore<T, WFmt::kInt8> { using type = int8_t; };
template <typename T> struct WStore<T, WFmt::kInt4> { using type = uint8_t; };
template <typename T> struct WStore<T, WFmt::kNF4> { using type = uint8_t; };

// NF4_CODE of src/repro_torch/core/quant.py (each value exact in f32)
__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f,
    -0.39491748809814453f, -0.28444138169288635f, -0.18477343022823334f,
    -0.09105003625154495f, 0.0f, 0.07958029955625534f, 0.16093020141124725f,
    0.24611230194568634f, 0.33791524171829224f, 0.44070982933044434f,
    0.5626170039176941f, 0.7229568362236023f, 1.0f};

// one 4-bit code as a weight in T, as f32; cs: the codebook rounded to T
template <WFmt F>
__device__ __forceinline__ float nibble_value(unsigned nib, const float* cs) {
  if constexpr (F == WFmt::kInt4) {
    return static_cast<float>(static_cast<int>(nib ^ 8u) - 8);
  } else {
    return cs[nib];
  }
}

}  // namespace wfmt
