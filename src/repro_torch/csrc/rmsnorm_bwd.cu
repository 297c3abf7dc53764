// RMSNorm backward, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py: rmsnorm_bwd
// (_rmsnorm_bwd_kernel), with the same arithmetic in f32:
//
//   rms = rsqrt(mean(x^2) + eps),  xhat = x rms,  dxhat = g w
//   dx  = (dxhat - xhat mean(dxhat xhat)) rms        x, g [M, d], w [d]
//   dw  = sum over rows of g xhat
//
// rms and xhat are recomputed from x (the MeSP residual: x only).
//
// What bounds it: bytes. Each element of x and g is read once (twice from
// the block's view; the second pass hits L1/L2) and dx written once, ~10
// FLOPs each.
//
// Design: one block per row, as rmsnorm_fwd.cu. One pass sums x^2 and
// (g w) x together, a warp-shuffle and shared-memory reduction finishes both,
// and a second pass writes dx. dw, only when asked for (dwp not null), is
// written as per-row f32 partials g xhat [M, d] that the wrapper adds in a
// fixed order, as the TPU wrapper added its per-row-block partials: no
// atomics.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(THREADS) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ g,
    T* __restrict__ dx, float* __restrict__ dwp, int d, float eps) {
  __shared__ float part[2][WARPS];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  const T* gr = g + row * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float ss = 0.f, dot = 0.f;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    const float xv = to_f(xr[j]);
    ss = fmaf(xv, xv, ss);
    dot = fmaf(to_f(gr[j]) * to_f(w[j]), xv, dot);
  }
  ss = warp_sum(ss);
  dot = warp_sum(dot);
  if (lane == 0) {
    part[0][warp] = ss;
    part[1][warp] = dot;
  }
  __syncthreads();
  if (warp == 0) {
    float a = lane < WARPS ? part[0][lane] : 0.f;
    float b = lane < WARPS ? part[1][lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      part[0][0] = a;
      part[1][0] = b;
    }
  }
  __syncthreads();
  const float rms = rsqrtf(part[0][0] / d + eps);
  const float mean = part[1][0] * rms / d;  // mean(dxhat * xhat)
  T* dxr = dx + row * d;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    const float xh = to_f(xr[j]) * rms, gv = to_f(gr[j]);
    dxr[j] = from_f<T>((gv * to_f(w[j]) - xh * mean) * rms);
    if (dwp) dwp[row * d + j] = gv * xh;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
// dwp: null, or f32 [M, d] for the per-row dw partials.
extern "C" int rmsnorm_bwd(int dtype, const void* x, const void* w,
                           const void* g, void* dx, void* dwp, int M, int d,
                           float eps, void* stream) {
  if (d < 1 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(dwp);
  if (dtype == DTYPE_BF16) {
    using T = __nv_bfloat16;
    rmsnorm_bwd_kernel<T><<<M, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(g), static_cast<T*>(dx), p, d, eps);
  } else if (dtype == DTYPE_F32) {
    rmsnorm_bwd_kernel<float><<<M, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(g), static_cast<float*>(dx), p, d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
