// Shared helpers of the port's CUDA kernels: element conversions for the
// two activation types the kernels take (f32 and bf16), a warp sum, and the
// error-string entry point every library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed from Python (kernels/_build.py callers)
enum DType { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// *p, or zero where ``ok`` is false (the address is then not read)
__device__ __forceinline__ float load_or_zero(const float* p, bool ok) {
  return ok ? *p : 0.f;
}
__device__ __forceinline__ __nv_bfloat16 load_or_zero(const __nv_bfloat16* p,
                                                     bool ok) {
  return ok ? *p : __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

// round an f32 value to T's precision and back (the reference's
// ``.astype(x.dtype)`` on an f32 intermediate)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
