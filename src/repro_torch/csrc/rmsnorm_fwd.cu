// RMSNorm forward, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py: rmsnorm
// (_rmsnorm_kernel), with the same arithmetic in f32:
//
//   y = x * rsqrt(mean(x^2) + eps) * w,   x [M, d], w [d], y in x's type
//
// (an f32 sum of squares, rsqrt(sum / d + eps), y = (x * rms) * w rounded
// once to x's type).
//
// What bounds it. Each element is read once and written once with ~4 FLOPs
// in between, so it is bound by bytes; at decode (M = 8, d = 896: 14 KB in
// and out) the work is so small that the launch and the chain of memory
// round trips inside it are the cost.
//
// Design: one warp a row, four rows a block, so a block needs no barrier.
// A lane loads its share of x and of w in one round trip, into registers:
// NV units of 16 bytes (8 bf16 or 4 f32 values), unit u of lane l at
// element 16/sizeof(T) * (l + 32 u), when d and the bases of x, w and y
// allow 16-byte accesses; otherwise the same registers hold elements
// l + 32 (u V + e), loaded one by one, coalesced across the warp. The sum
// of squares is a warp shuffle; the output is written from the registers,
// so x is read once. NV (1 to 16) is the smallest power of two that holds
// a row; a wider row (more than 4,096 bf16 or 2,048 f32 values) is summed
// in passes of 16 units and read again for the output. Any d works; no row
// is padded. The row loads and stores are rownorm.cuh's, shared with the
// backward.

#include "rownorm.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

template <typename T, int NV>
__device__ __forceinline__ float sum_squares(const Unit<T> (&xs)[NV]) {
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int e = 0; e < Unit<T>::V; ++e) {
      const float v = to_f(xs[u].v[e]);
      ss += v * v;
    }
  return ss;
}

// y = (x rms) w, rounded once to T, into xs's registers
template <typename T, int NV>
__device__ __forceinline__ void scale_units(Unit<T> (&xs)[NV],
                                            const Unit<T> (&ws)[NV],
                                            float rms) {
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int e = 0; e < Unit<T>::V; ++e)
      xs[u].v[e] = from_f<T>(to_f(xs[u].v[e]) * rms * to_f(ws[u].v[e]));
}

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS) rmsnorm_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    int M, int d, float eps, bool vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= M) return;  // a whole warp
  const T* xr = x + (size_t)row * d;
  T* yr = y + (size_t)row * d;
  constexpr int CHUNK = 32 * Unit<T>::V * NV;  // values a pass holds
  Unit<T> xs[NV], ws[NV];
  if (d <= CHUNK) {  // the whole row in registers: x read once
    load_units<T, NV>(xs, xr, 0, d, lane, vec);
    load_units<T, NV>(ws, w, 0, d, lane, vec);
    const float rms = rsqrtf(warp_sum(sum_squares<T, NV>(xs)) / d + eps);
    scale_units<T, NV>(xs, ws, rms);
    store_units<T, NV>(yr, xs, 0, d, lane, vec);
    return;
  }
  float ss = 0.f;
  for (int base = 0; base < d; base += CHUNK) {
    load_units<T, NV>(xs, xr, base, d, lane, vec);
    ss += sum_squares<T, NV>(xs);
  }
  const float rms = rsqrtf(warp_sum(ss) / d + eps);
  for (int base = 0; base < d; base += CHUNK) {
    load_units<T, NV>(xs, xr, base, d, lane, vec);
    load_units<T, NV>(ws, w, base, d, lane, vec);
    scale_units<T, NV>(xs, ws, rms);
    store_units<T, NV>(yr, xs, base, d, lane, vec);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int M, int d, float eps,
           cudaStream_t s) {
  const bool vec = rows_take_units<T>(d, {x, w, y});
  const dim3 grid((M + WARPS - 1) / WARPS);
  with_units<T>(d, [&](auto nv) {
    rmsnorm_fwd_kernel<T, decltype(nv)::value><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
        M, d, eps, vec);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* w, void* y,
                           int M, int d, float eps, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w, y, M, d, eps, s);
  if (dtype == DTYPE_F32) return launch<float>(x, w, y, M, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
