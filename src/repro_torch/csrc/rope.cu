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
// written once, a few FLOPs each; the tables are read once per (b, n) row
// (from L2 for the H heads). At [1, 256, 16, 128] bf16 that is 2 MB, under
// a microsecond at 3.35 TB/s, so one launch is mostly its own overhead.
//
// Design (simple and right first): one thread per (b, n, h, j) pair, the
// pairs of a row on neighbouring threads, so the loads of x1, of x2 and of
// the tables are contiguous across a warp. Any B, N, H and even D; nothing
// is padded.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rope_kernel(const T* __restrict__ x, const float* __restrict__ cs,
                const float* __restrict__ sn, T* __restrict__ y,
                long long pairs, int N, int H, int half) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= pairs) return;
  const int j = static_cast<int>(i % half);
  const long long row = i / half;            // (b, n, h)
  const int n = static_cast<int>((row / H) % N);
  const size_t o = (size_t)row * (2 * half) + j;
  const float x1 = to_f(x[o]), x2 = to_f(x[o + half]);
  const float c = cs[(size_t)n * half + j], s = sn[(size_t)n * half + j];
  y[o] = from_f<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  y[o + half] = from_f<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
}

template <typename T>
int launch(const void* x, const void* cs, const void* sn, void* y, int B,
           int N, int H, int D, cudaStream_t s) {
  const long long pairs = (long long)B * N * H * (D / 2);
  if (pairs == 0) return 0;
  const long long blocks = (pairs + THREADS - 1) / THREADS;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  rope_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(cs),
      static_cast<const float*>(sn), static_cast<T*>(y), pairs, N, H, D / 2);
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
