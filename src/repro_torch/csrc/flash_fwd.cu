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
// causal) the function moves 1.06 MB (q, k, v read once, out and lse
// written once) and does 0.12 GFLOP: bytes, 0.32 us at 3.35 TB/s. The
// kernel is set by latency instead: 56 blocks on 132 SMs, each walking up
// to 4 k tiles, every tile a dependent chain of load, product, softmax and
// product.
//
// Design: one block per (b*h, 64-row q tile); the block derives its own
// live k-tile range from causal, window and the lengths (the TPU kernel's
// sparse flat grid took this from a precomputed schedule) and never loads a
// tile above the diagonal or behind the window. The online-softmax state
// (m, l, acc) stays in registers in f32; only boundary tiles build a mask;
// the ragged edge is masked in place (no padded copies); out and lse are
// written once.
//
// bf16 (flash_fwd_tc, flash_common.cuh's flash::tc): 4 warps, 16 q rows
// each. The q tile is staged once (rotated first with tables) and held as
// mma A fragments (read from the staged tile at each k tile when D > 128,
// where the D-wide accumulator takes 128 registers); k and v tiles are
// double-buffered in shared memory as bf16 and the next pair is copied by
// cp.async while the current one is multiplied. s = q k^T and acc += round(p) v run on mma.sync m16n8k16
// (f32 sums); the row max and sum run over the 4 lanes that share a row
// (each lane keeps its share of l and the 4 are added once at the end); p
// goes from the score fragments to the A fragments of p v in registers. out
// is staged through shared memory and stored in 16-byte rows.
// f32 (flash_fwd_kernel): the CUDA-core body on f32 tiles (tensor cores
// would round f32 operands to TF32).

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

// bf16 on tensor cores: the same function, only the order of the sums
// differs
template <int DMAX>
__global__ void __launch_bounds__(tc::THREADS) flash_fwd_tc(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
    const tc::bf16* __restrict__ v, const float* __restrict__ cos,
    const float* __restrict__ sin, tc::bf16* __restrict__ out,
    float* __restrict__ lse, int G, int nq, int nk, int D, int causal,
    int window, float scale) {
  using tc::bf16;
  constexpr int KS = DMAX / 16, NT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int ts = tc::stride(D);
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = Qs + BQ * ts;      // two buffers
  bf16* Vs = Ks + 2 * BK * ts;  // two buffers

  const int bh = blockIdx.y, q_lo = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = q_lo + 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const bf16* kb = k + (size_t)(bh / G) * nk * D;
  const bf16* vb = v + (size_t)(bh / G) * nk * D;
  tc::zero_pads(Qs, 5 * BQ, D);
  int lo, hi;
  k_range(q_lo, nq, nk, causal, window, &lo, &hi);
  tc::load_tile(Qs, q + (size_t)bh * nq * D, q_lo, nq, D, cos, sin);
  if (lo < hi) {
    tc::load_tile(Ks, kb, lo * BK, nk, D, cos, sin);
    tc::load_tile(Vs, vb, lo * BK, nk, D, nullptr, nullptr);
  }
  mma::cp_async_commit();

  // above 128 columns q's fragments are read from Qs at each k tile: o
  // alone takes 128 registers
  tc::AFrags<KS, (DMAX <= 128)> qf;
  float o[NT][4];
  tc::zero(o);
  // rows r0 and r0 + 8: the running max and this lane's share of the sum
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int kt = lo; kt < hi; ++kt) {
    const int buf = (kt - lo) & 1, k_lo = kt * BK;
    if (kt + 1 < hi) {
      tc::load_tile(Ks + (buf ^ 1) * BK * ts, kb, k_lo + BK, nk, D, cos, sin);
      tc::load_tile(Vs + (buf ^ 1) * BK * ts, vb, k_lo + BK, nk, D, nullptr,
                    nullptr);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // every group but the one just issued is in
    __syncthreads();
    if (kt == lo) qf.init(Qs + 16 * warp * ts, D, lane);
    const bf16* Kt = Ks + buf * BK * ts;
    const bf16* Vt = Vs + buf * BK * ts;

    float s[8][4];
    tc::dot_tile(s, qf, Kt, D, lane);
    const bool inner = interior(q_lo, k_lo, nq, nk, causal, window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], scale);
        if (!inner && !valid(r0 + 8 * (e >> 1), k_lo + 8 * j + c0 + (e & 1),
                             nq, nk, causal, window))
          x = NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], tc::quad_max(mx[h]));
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    tc::acc_tile(o, s, Vt, D, lane);
    __syncthreads();  // this buffer is refilled in the next iteration
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // out in bf16 over the warp's own q rows of Qs, then 16-byte stores
  bf16* Os = Qs + 16 * warp * ts;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = (lane >> 2) + 8 * h, row = r0 + 8 * h;
    const float lv = fmaxf(tc::quad_sum(l[h]), 1e-30f);
    const bool never = m[h] <= NEG_INF * 0.5f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + c0;
      if (c < D)
        *reinterpret_cast<uint32_t*>(Os + rl * ts + c) = mma::pack_bf16(
            never ? 0.f : o[j][2 * h] / lv,
            never ? 0.f : o[j][2 * h + 1] / lv);
    }
    if ((lane & 3) == 0 && row < nq)
      lse[(size_t)bh * nq + row] = never ? NEG_INF : m[h] + logf(lv);
  }
  __syncwarp();
  const int chunks = D / 8;
  bf16* ob = out + (size_t)bh * nq * D;
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    const int row = q_lo + 16 * warp + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(ob + (size_t)row * D + c) =
          *reinterpret_cast<const uint4*>(Os + r * ts + c);
  }
}

template <int DMAX>
int launch_tc(const void* q, const void* k, const void* v, const float* cos,
              const float* sin, void* out, float* lse, int BH, int G, int nq,
              int nk, int D, int causal, int window, cudaStream_t s) {
  using tc::bf16;
  auto kern = flash_fwd_tc<DMAX>;
  size_t smem;
  if (int rc = tc::set_smem(kern, D, 5, 0, &smem)) return rc;
  const dim3 grid((nq + BQ - 1) / BQ, BH);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kern<<<grid, tc::THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), cos, sin, static_cast<bf16*>(out), lse, G,
      nq, nk, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
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
// 256 (instances for D up to 64, 128 and 256). bf16: q, k, v and out
// 16-byte aligned (the wrapper checks).
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, const void* cos, const void* sin,
                         void* out, void* lse, int BH, int G, int nq, int nk,
                         int D, int causal, int window, void* stream) {
  if (D < 8 || D > 256 || D % 8 || G < 1 || BH % G || nq < 0 || nk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || nq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  float* l = static_cast<float*>(lse);
  if (dtype == DTYPE_BF16) {
    auto run = D <= 64 ? launch_tc<64> : D <= 128 ? launch_tc<128>
                                                  : launch_tc<256>;
    return run(q, k, v, c, sn, out, l, BH, G, nq, nk, D, causal, window, s);
  }
  if (dtype == DTYPE_F32) {
    auto run = D <= 64 ? launch<float, 64> : D <= 128 ? launch<float, 128>
                                                      : launch<float, 256>;
    return run(q, k, v, c, sn, out, l, BH, G, nq, nk, D, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory (bytes) of the bf16 instance for head dim D at
// its last launch, as the runtime holds it (-1 on error). Returns the CUDA
// error code.
extern "C" int flash_fwd_smem(int D, int* bytes) {
  auto kern = D <= 64 ? flash_fwd_tc<64> : D <= 128 ? flash_fwd_tc<128>
                                                    : flash_fwd_tc<256>;
  return flash::tc::smem_of(kern, bytes);
}
