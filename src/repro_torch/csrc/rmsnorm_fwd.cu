// RMSNorm forward, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py: rmsnorm
// (_rmsnorm_kernel), with the same arithmetic in f32:
//
//   y = x * rsqrt(mean(x^2) + eps) * w,   x [M, d], w [d], y in x's type
//
// What bounds it. Each element is read once and written once with ~4 FLOPs
// in between, so it is bound by bytes; at decode (M = 8, d = 896: 14 KB in
// and out) the work is so small that the launch itself is the cost.
//
// Design: one block per row. Its threads stride the row summing squares in
// f32, a warp-shuffle and shared-memory reduction gives the row's sum, and a
// second pass over the row (now in L1/L2) writes the normalised output. No
// row is padded; any d works.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) rmsnorm_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    int d, float eps) {
  __shared__ float part[THREADS / 32];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* yr = y + (size_t)blockIdx.x * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    const float v = to_f(xr[j]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < THREADS / 32 ? part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  const float rms = rsqrtf(part[0] / d + eps);
  for (int j = threadIdx.x; j < d; j += THREADS)
    yr[j] = from_f<T>(to_f(xr[j]) * rms * to_f(w[j]));
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* w, void* y,
                           int M, int d, float eps, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    rmsnorm_fwd_kernel<__nv_bfloat16><<<M, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), d, eps);
  else if (dtype == DTYPE_F32)
    rmsnorm_fwd_kernel<float><<<M, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), d, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
