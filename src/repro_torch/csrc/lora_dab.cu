// LoRA factor gradients, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lora_fused.py: lora_dab
// (_lora_dab_kernel), with the same arithmetic and roundings:
//
//   sg = round(s g),  h = round(x @ A),  dh = round(sg @ B^T)
//   dA = x^T dh   [K, r],   dB = h^T sg   [r, N]
//
//   x [M, K], g [M, N], A [K, r], B [r, N] (r <= 32); rounds to x's type,
//   f32 sums, dA and dB cast to A's and B's type.
//
// What bounds it: reading x and g once (the outputs are r-thin); ~8 r FLOPs
// per element of x or g, far below the card's ridge, so bytes.
//
// bf16: lora_dab_tc.cuh's tensor-core body over one group, one launch (its
// header has the design). f32, two launches on one stream:
// * Partials. A block owns 8 rows and writes the f32 partials of dA and dB
//   over them to a workspace, with h and dh recomputed on chip
//   (lora_dab.cuh).
// * Reduce. One thread per element of dA and dB adds the partials of all
//   row tiles in a fixed order and casts. No atomics: the result is the same
//   on every run.
// The TPU kernel carried dA and dB across its sequential row grid in VMEM;
// on Hopper the row tiles run in parallel, hence the f32 second pass.

#include "lora_dab.cuh"
#include "lora_dab_tc.cuh"

namespace {

using dab_rows::RB;
using dab_rows::RMAX;
using dab_rows::THREADS;

template <typename T, int RM>
__global__ void __launch_bounds__(THREADS) lora_dab_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ a,
    const T* __restrict__ b, float* __restrict__ ws, int M, int K, int N,
    int r, float scale) {
  float* wa = ws + (size_t)blockIdx.x * ((size_t)K * r + (size_t)r * N);
  dab_rows::partial_body<T, RM>(x, g, a, b, wa, wa + (size_t)K * r,
                                blockIdx.x * RB, M, K, N, r, scale);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) lora_dab_reduce_kernel(
    const float* __restrict__ ws, int tiles, int K, int N, int r,
    T* __restrict__ da, T* __restrict__ db) {
  const size_t na = (size_t)K * r, per = na + (size_t)r * N;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < per;
       e += (size_t)gridDim.x * THREADS) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += ws[(size_t)t * per + e];
    if (e < na)
      da[e] = from_f<T>(s);
    else
      db[e - na] = from_f<T>(s);
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* a, const void* b,
           float* ws, void* da, void* db, int M, int K, int N, int r,
           float scale, cudaStream_t s) {
  const int tiles = (M + RB - 1) / RB;
  if (tiles > 0) {
    const T *xp = static_cast<const T*>(x), *gp = static_cast<const T*>(g),
            *ap = static_cast<const T*>(a), *bp = static_cast<const T*>(b);
    LORA_DAB_BY_RANK(lora_dab_partial_kernel, T, r, tiles, s, xp, gp, ap, bp,
                     ws, M, K, N, r, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t per = (size_t)K * r + (size_t)r * N;
  const size_t need = (per + THREADS - 1) / THREADS;
  const int blocks = need < 1024 ? (int)need : 1024;
  lora_dab_reduce_kernel<T><<<blocks, THREADS, 0, s>>>(
      ws, tiles, K, N, r, static_cast<T*>(da), static_cast<T*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 elements of the partials workspace that the f32 lora_dab needs (the
// bf16 body's: lora_dab_plan).
extern "C" long long lora_dab_workspace(int M, int K, int N, int r) {
  const long long tiles = (M + RB - 1) / RB;
  return tiles * ((long long)K * r + (long long)r * N);
}

// The bf16 body's plan at x [M, K], g [M, N], rank r: out[0..7] = C (the
// members of a cluster, which share K's and N's columns), S (sub-runs of
// rows, one cluster each), Q (passes over a member's columns), RF (m16 row
// fragments a chunk), slabs (1 or 2), dynamic shared memory (bytes), the
// workspace (f32 elements) and the zeroed counts the launch needs.
extern "C" int lora_dab_plan(int M, int K, int N, int r, long long* out) {
  if (M < 0 || K < 1 || N < 1 || r < 1 || r > RMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return dab_tc::plan_figures(false, M, K, N, 1, r, 0, out);
}

// Returns cudaGetLastError() after the launches (0 when they were
// accepted). ws: f32, lora_dab_workspace's elements (f32) or lora_dab_plan's
// (bf16); cnt (bf16): lora_dab_plan's count of int32 zeros, which the
// launch leaves zero.
extern "C" int lora_dab(int dtype, const void* x, const void* g, const void* a,
                        const void* b, void* ws, void* cnt, void* da,
                        void* db, int M, int K, int N, int r, float scale,
                        void* stream) {
  if (M < 0 || K < 1 || N < 1 || r < 1 || r > RMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == DTYPE_BF16)
    return dab_tc::launch(x, g, a, b, nullptr, w, static_cast<int*>(cnt), da,
                          db, M, K, N, 1, r, 0, scale, s);
  if (dtype == DTYPE_F32)
    return launch<float>(x, g, a, b, w, da, db, M, K, N, r, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
