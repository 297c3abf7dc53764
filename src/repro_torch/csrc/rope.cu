// Rotary embedding by tables, written by hand for Hopper.
//
// Replaces the TPU kernel of src/repro/kernels/rope.py: rope_fwd
// (_rope_kernel) and, through its autograd Function, rope_apply, whose
// backward is the same kernel at -theta (sin negated):
//
//   y[b, n, h, j]        = x1 * cos[n, j] - x2 * sin[n, j]
//   y[b, n, h, half + j] = x2 * cos[n, j] + x1 * sin[n, j]
//
//   with x1 = x[b, n, h, j], x2 = x[b, n, h, half + j] (j < half = D / 2),
//   x [B, N, H, D] in T (f32 or bf16), cos / sin f32 [N, half]; f32
//   arithmetic, each product and the sum rounded apart (__fmul_rn,
//   __fsub_rn, __fadd_rn, as the plain rotation computes them), the output
//   rounded once to T: bit for bit the plain version.
//
// What bounds it on the H100: bytes. Each element of x is read once and
// written once, a few FLOPs each, and the tables once per position (b, n).
// At [1, 256, 16, 128] bf16 that is 2 MB, under a microsecond at 3.35 TB/s,
// so a launch lasts about as long as its launch and one chain of loads.
//
// Design: one block of one to four warps a position (b, n), its H heads
// side by side. A thread owns one unit of the half: 16 bytes of x1 and the
// 16 bytes of x2 that pair with them (8 bf16 or 4 f32 pairs), at columns
// V u + e, where half and the bases allow 16-byte accesses; otherwise V
// columns u + units e, loaded one by one (the two compiled as separate
// bodies, VEC). It loads the unit's cos and sin
// once and keeps them in registers while it rotates its heads h0, h0 +
// hstep, ... (the block's threads cover hstep heads at a time). Offsets
// inside a position are 32-bit and set once; a thread divides three times
// in 32 bits, none a pair. A half of more units than a block has threads
// (over 1,024 bf16 or 512 f32 pairs) is walked unit by unit, the heads of
// each in turn. Any B, N, H and even D; nothing is padded.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 4;

// VEC: 16-byte units (a compile-time choice: each body holds one way of
// loading and storing)
template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    rope_kernel(const T* __restrict__ x, const float* __restrict__ cs,
                const float* __restrict__ sn, T* __restrict__ y, int N, int H,
                int half, int units) {
  constexpr bool vec = VEC;
  constexpr int V = 16 / sizeof(T);  // pairs a unit holds
  const int t = threadIdx.x, nt = blockDim.x;
  const bool wide = units > nt;
  const int u0 = wide ? t : t % units;
  const int h0 = wide ? 0 : t / units;
  const int hstep = wide ? 1 : nt / units;  // heads the block covers at once
  const int ustep = wide ? nt : units;
  if (h0 >= hstep) return;
  const int D = 2 * half;
  const size_t row = (size_t)blockIdx.x * H * D;  // position b N + n
  const T* xr = x + row;
  T* yr = y + row;
  const size_t tab = (size_t)(blockIdx.x % N) * half;
  const float* cr = cs + tab;
  const float* sr = sn + tab;
  for (int u = u0; u < units; u += ustep) {
    // column of pair e: V u + e (16-byte units) or u + units e (elements)
    const int j0 = vec ? V * u : u, js = vec ? 1 : units;
    float c[V], s[V];
    if (vec) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        *reinterpret_cast<float4*>(c + 4 * q) =
            *reinterpret_cast<const float4*>(cr + j0 + 4 * q);
        *reinterpret_cast<float4*>(s + 4 * q) =
            *reinterpret_cast<const float4*>(sr + j0 + 4 * q);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = j0 + js * e;
        c[e] = j < half ? cr[j] : 0.f;
        s[e] = j < half ? sr[j] : 0.f;
      }
    }
#pragma unroll 4
    for (int h = h0; h < H; h += hstep) {
      const int o = h * D + j0;
      alignas(16) T a[V], b[V];
      if (vec) {
        *reinterpret_cast<uint4*>(a) =
            *reinterpret_cast<const uint4*>(xr + o);
        *reinterpret_cast<uint4*>(b) =
            *reinterpret_cast<const uint4*>(xr + o + half);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const bool in = j0 + js * e < half;
          a[e] = load_or_zero(xr + o + js * e, in);
          b[e] = load_or_zero(xr + o + half + js * e, in);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float x1 = to_f(a[e]), x2 = to_f(b[e]);
        a[e] = from_f<T>(__fsub_rn(__fmul_rn(x1, c[e]), __fmul_rn(x2, s[e])));
        b[e] = from_f<T>(__fadd_rn(__fmul_rn(x2, c[e]), __fmul_rn(x1, s[e])));
      }
      if (vec) {
        *reinterpret_cast<uint4*>(yr + o) = *reinterpret_cast<const uint4*>(a);
        *reinterpret_cast<uint4*>(yr + o + half) =
            *reinterpret_cast<const uint4*>(b);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (j0 + js * e < half) {
            yr[o + js * e] = a[e];
            yr[o + half + js * e] = b[e];
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* cs, const void* sn, void* y, int B,
           int N, int H, int D, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long positions = (long long)B * N;
  if (positions == 0 || H == 0) return 0;
  if (positions > INT_MAX || (long long)H * D > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int half = D / 2;
  const bool vec = half % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(cs) |
                     reinterpret_cast<uintptr_t>(sn) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int units = (half + V - 1) / V;
  const long long work = (long long)H * units;  // (head, unit) pairs
  const int warps = static_cast<int>(
      work >= 32LL * MAX_WARPS ? MAX_WARPS : (work + 31) / 32);
  const auto kernel = vec ? rope_kernel<T, true> : rope_kernel<T, false>;
  kernel<<<static_cast<unsigned>(positions), 32 * warps, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(cs),
      static_cast<const float*>(sn), static_cast<T*>(y), N, H, half, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int rope_fwd(int dtype, const void* x, const void* cs,
                        const void* sn, void* y, int B, int N, int H, int D,
                        void* stream) {
  if (B < 0 || N < 0 || H < 0 || D < 2 || D % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, cs, sn, y, B, N, H, D, s);
  if (dtype == DTYPE_F32) return launch<float>(x, cs, sn, y, B, N, H, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
