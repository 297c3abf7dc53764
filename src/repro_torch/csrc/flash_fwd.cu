// Flash-attention forward, written by hand for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_fwd (_fwd_kernel), with the same arithmetic and roundings:
//
//   s   = (q k^T) scale in f32, scale = 1/sqrt(D); masked pairs -1e30
//   m   = running row max;  p = exp(s - m);  l = l corr + sum p (p unrounded)
//   acc = acc corr + round(p) v   (p rounded to v's type, f32 sums)
//   out = acc / max(l, 1e-30) in q's type,  lse = m + log(max(l, 1e-30))
//   rows that never saw a key: out = 0, lse = -1e30 exactly
//
// GQA: q head bh reads kv head bh / G, K and V are never repeated. Fused
// RoPE (tables not null): q and k tiles are rotated right after the load.
//
// What bounds it: at the training shape (B*H 14, B*Hkv 2, N 256, D 64,
// causal) the function moves ~0.5 MB (q, k, v read once, out and lse written
// once) and does ~60 MFLOP, so bytes: ~0.16 us at 3.35 TB/s. The kernel
// instead is set by latency: 56 blocks on 132 SMs, each walking up to 4 k
// tiles with a serial chain of shared-memory products on CUDA cores.
//
// Design: one block per (b*h, 64-row q tile); the block derives its own
// live k-tile range from causal, window and the lengths (the TPU kernel's
// sparse flat grid took this from a precomputed schedule) and never loads a
// tile above the diagonal or behind the window. The online-softmax state
// (m, l, acc) stays in registers in f32; only boundary tiles build a mask;
// the ragged edge is masked in place (no padded copies); out and lse are
// written once. Products run on CUDA cores (tensor cores are later work).

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ cos, const float* __restrict__ sin,
    T* __restrict__ out, float* __restrict__ lse, int G, int nq, int nk,
    int D, int causal, int window, float scale) {
  constexpr int JC = DMAX / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ps = Vs + BK * ld;

  const int bh = blockIdx.y, q_lo = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* kb = k + (size_t)(bh / G) * nk * D;
  const T* vb = v + (size_t)(bh / G) * nk * D;
  load_tile<T>(Qs, ld, q + (size_t)bh * nq * D, q_lo, nq, D, cos, sin);

  float m[4], l[4], acc[4][JC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JC; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  k_range(q_lo, nq, nk, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T>(Ks, ld, kb, k_lo, nk, D, cos, sin);
    load_tile<T>(Vs, ld, vb, k_lo, nk, D, nullptr, nullptr);
    __syncthreads();

    float s[4][4];
    dot_tile(s, Qs, Ks, ld, D, ty, tx);
    const bool inner = interior(q_lo, k_lo, nq, nk, causal, window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fmul_rn(s[i][j], scale);
        if (!inner && !valid(q_lo + ty + 16 * i, k_lo + tx + 16 * j, nq, nk,
                             causal, window))
          s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < JC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    acc_tile<JC, false>(acc, Ps, Vs, ld, D, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty + 16 * i;
    if (row >= nq) continue;
    const bool never = m[i] <= NEG_INF * 0.5f;
    const float lv = fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)bh * nq + row) * D;
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) o[c] = from_f<T>(never ? 0.f : acc[i][j] / lv);
    }
    if (tx == 0) lse[(size_t)bh * nq + row] = never ? NEG_INF : m[i] + logf(lv);
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, const float* cos,
           const float* sin, void* out, float* lse, int BH, int G, int nq,
           int nk, int D, int causal, int window, cudaStream_t s) {
  auto kern = flash_fwd_kernel<T, DMAX>;
  size_t smem;
  if (int rc = set_smem(kern, D, 3, 1, &smem)) return rc;
  const dim3 grid((nq + BQ - 1) / BQ, BH);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cos, sin, static_cast<T*>(out), lse, G, nq,
      nk, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
// q [BH, nq, D], k, v [BH / G, nk, D] of one type; out like q; lse f32
// [BH, nq]; cos, sin f32 [nq, D / 2] or both null. D a multiple of 8 up to
// 128.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, const void* cos, const void* sin,
                         void* out, void* lse, int BH, int G, int nq, int nk,
                         int D, int causal, int window, void* stream) {
  if (D < 8 || D > 128 || D % 8 || G < 1 || BH % G || nq < 0 || nk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || nq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  float* l = static_cast<float*>(lse);
  if (dtype == DTYPE_BF16) {
    return D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, c, sn, out, l, BH, G,
                                               nq, nk, D, causal, window, s)
                   : launch<__nv_bfloat16, 128>(q, k, v, c, sn, out, l, BH,
                                                G, nq, nk, D, causal, window,
                                                s);
  }
  if (dtype == DTYPE_F32) {
    return D <= 64 ? launch<float, 64>(q, k, v, c, sn, out, l, BH, G, nq, nk,
                                       D, causal, window, s)
                   : launch<float, 128>(q, k, v, c, sn, out, l, BH, G, nq, nk,
                                        D, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
