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
// What bounds it: bytes. Each element of x and g is read once and dx
// written once, ~10 FLOPs each; at the training shapes ([192-256, 896],
// [256, 2048] in bf16: 1.0-3.1 MB) a launch lasts as long as one row's
// chain of dependent steps, so the design keeps that chain short.
//
// Design: one warp a row, WARPS rows a block, so no block barrier. A lane
// loads its share of x, g and w in one round trip into registers, in
// 16-byte units where d and the bases allow them and element by element
// otherwise (rownorm.cuh, as the forward), and keeps x and g w (f32). The
// lane's shares of sum x^2 and sum (g w) x are short chains (one a unit,
// then added pairwise); both warp sums take the same five shuffle steps;
// dx is computed from the registers and written, so x and g are read once
// for rows up to 4,096 bf16 or 2,048 f32 values. With d = 2048 a lane
// holds 64 values, fully unrolled: the row's time is the warp's own
// instruction stream, so nothing in the dx loop branches and g w is formed
// once, and the body is compiled apart for 16-byte and element access
// (VEC), since inside a training step, where other kernels have taken the
// instruction cache, each launch fetches its body again. A wider row is
// summed in passes of 16 units and read again for dx. dw, only when asked
// for (dwp not null), is written as per-row f32 partials g xhat [M, d]
// that the wrapper adds in a fixed order, as the TPU wrapper added its
// per-row-block partials: no atomics.

#include "rownorm.cuh"

namespace {

// rows a block, one warp each. Two: within 0.05 us of the fastest of 1, 2
// and 4 at every training shape on an H100 (four lead at [192-256, 896],
// one at [192-256, 2048], where the rows spread over more SMs);
// scripts/profile_torch_grouped.py --family rmsnorm_bwd_sweep builds and
// times each
#ifndef RMS_BWD_WARPS
#define RMS_BWD_WARPS 2
#endif
constexpr int WARPS = RMS_BWD_WARPS;
constexpr int THREADS = 32 * WARPS;

// g w in f32 for a lane's units: computed once, for the sums and for dx
template <typename T, int NV>
__device__ __forceinline__ void products(float (&gw)[NV][Unit<T>::V],
                                         const Unit<T> (&gs)[NV],
                                         const Unit<T> (&ws)[NV]) {
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int e = 0; e < Unit<T>::V; ++e)
      gw[u][e] = to_f(gs[u].v[e]) * to_f(ws[u].v[e]);
}

// a lane's shares of sum x^2 and of sum (g w) x over its units: one chain
// of V fmas a unit, then the units' partials added pairwise, so no chain is
// longer than V + log2(NV)
template <typename T, int NV>
__device__ __forceinline__ void partial_sums(const Unit<T> (&xs)[NV],
                                             const float (&gw)[NV][Unit<T>::V],
                                             float& ss, float& dot) {
  float s[NV], p[NV];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    s[u] = p[u] = 0.f;
#pragma unroll
    for (int e = 0; e < Unit<T>::V; ++e) {
      const float xv = to_f(xs[u].v[e]);
      s[u] = fmaf(xv, xv, s[u]);
      p[u] = fmaf(gw[u][e], xv, p[u]);
    }
  }
#pragma unroll
  for (int h = NV / 2; h > 0; h /= 2)
#pragma unroll
    for (int u = 0; u < h; ++u) {
      s[u] += s[u + h];
      p[u] += p[u + h];
    }
  ss += s[0];
  dot += p[0];
}

// both warp sums at once: five shuffle steps, each value in warp_sum's order
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// dx = (g w - xhat mean) rms, rounded once to T, into dxs
template <typename T, int NV>
__device__ __forceinline__ void grad_units(Unit<T> (&dxs)[NV],
                                           const Unit<T> (&xs)[NV],
                                           const float (&gw)[NV][Unit<T>::V],
                                           float rms, float mean) {
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int e = 0; e < Unit<T>::V; ++e) {
      const float xh = to_f(xs[u].v[e]) * rms;
      dxs[u].v[e] = from_f<T>((gw[u][e] - xh * mean) * rms);
    }
}

// the dw partials g xhat of a lane's units, f32, into the row dwr; g is
// read again here, so that no path keeps it in registers past g w (dw is
// asked for only when a norm weight trains)
template <typename T, int NV>
__device__ __forceinline__ void dw_units(float* dwr, const Unit<T> (&xs)[NV],
                                         const T* gr, float rms, int base,
                                         int d, int lane, bool vec) {
  Unit<T> gs[NV];
  load_units<T, NV>(gs, gr, base, d, lane, vec);
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int e = 0; e < Unit<T>::V; ++e) {
      const int c = unit_col<T>(base, lane, u, e, vec);
      if (c < d) dwr[c] = to_f(gs[u].v[e]) * (to_f(xs[u].v[e]) * rms);
    }
}

// VEC: the rows take 16-byte units (one way of loading and storing a body)
template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(THREADS) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ g,
    T* __restrict__ dx, float* __restrict__ dwp, int M, int d, float eps) {
  constexpr bool vec = VEC;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= M) return;  // a whole warp
  const size_t off = (size_t)row * d;
  const T* xr = x + off;
  const T* gr = g + off;
  T* dxr = dx + off;
  float* dwr = dwp ? dwp + off : nullptr;
  constexpr int CHUNK = 32 * Unit<T>::V * NV;  // values a pass holds
  Unit<T> xs[NV], gs[NV], ws[NV];
  float gw[NV][Unit<T>::V];
  float ss = 0.f, dot = 0.f;
  if (d <= CHUNK) {  // the whole row in registers: x and g read once
    load_units<T, NV>(xs, xr, 0, d, lane, vec);
    load_units<T, NV>(gs, gr, 0, d, lane, vec);
    load_units<T, NV>(ws, w, 0, d, lane, vec);
    products<T, NV>(gw, gs, ws);
    partial_sums<T, NV>(xs, gw, ss, dot);
    warp_sum2(ss, dot);
    const float rms = rsqrtf(ss / d + eps);
    const float mean = dot * rms / d;  // mean(dxhat * xhat)
    if (dwr) dw_units<T, NV>(dwr, xs, gr, rms, 0, d, lane, vec);
    grad_units<T, NV>(gs, xs, gw, rms, mean);
    store_units<T, NV>(dxr, gs, 0, d, lane, vec);
    return;
  }
  for (int base = 0; base < d; base += CHUNK) {
    load_units<T, NV>(xs, xr, base, d, lane, vec);
    load_units<T, NV>(gs, gr, base, d, lane, vec);
    load_units<T, NV>(ws, w, base, d, lane, vec);
    products<T, NV>(gw, gs, ws);
    partial_sums<T, NV>(xs, gw, ss, dot);
  }
  warp_sum2(ss, dot);
  const float rms = rsqrtf(ss / d + eps);
  const float mean = dot * rms / d;
  for (int base = 0; base < d; base += CHUNK) {
    load_units<T, NV>(xs, xr, base, d, lane, vec);
    load_units<T, NV>(gs, gr, base, d, lane, vec);
    load_units<T, NV>(ws, w, base, d, lane, vec);
    products<T, NV>(gw, gs, ws);
    if (dwr) dw_units<T, NV>(dwr, xs, gr, rms, base, d, lane, vec);
    grad_units<T, NV>(gs, xs, gw, rms, mean);
    store_units<T, NV>(dxr, gs, base, d, lane, vec);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* g, void* dx, float* dwp,
           int M, int d, float eps, cudaStream_t s) {
  const bool vec = rows_take_units<T>(d, {x, w, g, dx});
  const dim3 grid((M + WARPS - 1) / WARPS);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  with_units<T>(d, [&](auto nv) {
    constexpr int NV = decltype(nv)::value;
    const auto kernel = vec ? rmsnorm_bwd_kernel<T, NV, true>
                            : rmsnorm_bwd_kernel<T, NV, false>;
    kernel<<<grid, THREADS, 0, s>>>(xp, wp, gp, dxp, dwp, M, d, eps);
  });
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w, g, dx, p, M, d, eps, s);
  if (dtype == DTYPE_F32) return launch<float>(x, w, g, dx, p, M, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
