// Probe of what sets the bf16 decode body's chain on an H100 (sm_90a): the
// clock cycles one block of 128 threads spends a slab when it streams an
// L2-resident W0-like source (64 rows of 64 or 128 bytes, rows a decode
// shape's pitch apart) through a ring of NST stages, by 16-byte cp.async
// copies (with and without the L2 128-byte hint) or by bulk copies (TMA,
// cp.async.bulk, one a row, completing on an mbarrier a stage); the cycles
// of a dependent L2 load, of a cluster barrier among 8 blocks, and the time
// of an empty launch with and without a cluster of 8 (CUDA events over a
// graph of launches); and the decode body itself (csrc/
// lora_grouped_decode_tc.cuh, built with its clock stamps) at decode shapes
// and plans: the cycles of thread 0 of its first block from its start to
// the gids, to the prologue's copies, through the K loop (split into
// waiting, copying and products), to each cluster barrier, to the end.
// Built and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -I src/repro_torch/csrc -o decode_ring_probe \
//       scripts/decode_ring_probe.cu && ./decode_ring_probe
//
// Prints one JSON object a measurement.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#define DECODE_TC_STAMPS
#include "lora_grouped_decode_tc.cuh"

#include <cstdint>
#include <cstdio>
#include <vector>

namespace cg = cooperative_groups;

#define CHECK(x)                                                         \
  do {                                                                   \
    cudaError_t e_ = (x);                                                \
    if (e_ != cudaSuccess) {                                             \
      std::fprintf(stderr, "%s: %s\n", #x, cudaGetErrorString(e_));      \
      std::exit(1);                                                      \
    }                                                                    \
  } while (0)

constexpr int THREADS = 128, ROWS = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool L2>
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  if constexpr (L2)
    asm volatile(
        "cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(
            smem_addr(dst)),
        "l"(src)
        : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// sum a few bytes of a stage, so that the loop uses what it waited for
__device__ __forceinline__ uint32_t touch(const uint8_t* st, int bytes) {
  return *reinterpret_cast<const uint32_t*>(st + (threadIdx.x * 16) % bytes);
}

template <int NST, bool L2>
__global__ void __launch_bounds__(THREADS)
    ring_cpasync(const uint8_t* src, int pitch, int row_bytes, int slabs,
                 long long* cycles, uint32_t* sink) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int sb = ROWS * row_bytes, per_row = row_bytes / 16;
  const uint8_t* base = src + (size_t)blockIdx.x * slabs * ROWS * pitch;
  auto issue = [&](int stage, int slab) {
    for (int i = threadIdx.x; i < ROWS * per_row; i += THREADS) {
      const int r = i / per_row, c = i - r * per_row;
      cp16<L2>(sm + stage * sb + i * 16,
               base + (size_t)(slab * ROWS + r) * pitch + c * 16);
    }
  };
  __syncthreads();
  const long long t0 = clock64();
  for (int s = 0; s < NST - 1; ++s) {
    if (s < slabs) issue(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  uint32_t acc = 0;
  for (int kt = 0; kt < slabs; ++kt) {
    cp_wait<NST - 2>();
    __syncthreads();
    if (kt + NST - 1 < slabs) issue((kt + NST - 1) % NST, kt + NST - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    acc += touch(sm + (kt % NST) * sb, sb);
  }
  cp_wait<0>();
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  if (acc == 0x12345678u) sink[0] = acc;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "{ .reg .b64 st; mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], "
      "%1; }\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int NST>
__global__ void __launch_bounds__(THREADS)
    ring_bulk(const uint8_t* src, int pitch, int row_bytes, int slabs,
              long long* cycles, uint32_t* sink) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ __align__(8) uint64_t bar[NST];
  const int sb = ROWS * row_bytes;
  const uint8_t* base = src + (size_t)blockIdx.x * slabs * ROWS * pitch;
  if (threadIdx.x < NST) mbar_init(&bar[threadIdx.x], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  // warp 0 issues a stage: lane 0 arms the barrier, then each lane copies
  // two rows
  auto issue = [&](int stage, int slab) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) mbar_expect(&bar[stage], sb);
      __syncwarp();
      for (int r = threadIdx.x; r < ROWS; r += 32)
        bulk_row(sm + stage * sb + r * row_bytes,
                 base + (size_t)(slab * ROWS + r) * pitch, row_bytes,
                 &bar[stage]);
    }
  };
  const long long t0 = clock64();
  for (int s = 0; s < NST - 1; ++s)
    if (s < slabs) issue(s, s);
  uint32_t acc = 0;
  for (int kt = 0; kt < slabs; ++kt) {
    mbar_wait(&bar[kt % NST], (kt / NST) & 1);
    __syncthreads();  // every thread is done with stage (kt - 1) % NST
    if (kt + NST - 1 < slabs) issue((kt + NST - 1) % NST, kt + NST - 1);
    acc += touch(sm + (kt % NST) * sb, sb);
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  if (acc == 0x12345678u) sink[0] = acc;
}

// a chain of dependent loads through an L2-resident ring of indices
__global__ void chase(const int* next, int steps, long long* cycles,
                      int* sink) {
  int i = 0;
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) i = next[i];
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = i;
}

__global__ void __cluster_dims__(8, 1, 1)
    cluster_barriers(int rounds, long long* cycles) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const long long t0 = clock64();
  for (int i = 0; i < rounds; ++i) cl.sync();
  const long long t1 = clock64();
  if (threadIdx.x == 0 && cl.block_rank() == 0) cycles[0] = t1 - t0;
}

__global__ void empty_kernel(int* p) {
  if (p && threadIdx.x == 1 << 30) p[0] = 1;
}

template <typename K>
double time_launches(K kern, int blocks, int cluster, cudaStream_t s) {
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = cluster;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cfg.attrs = &at;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaGraph_t g;
  cudaGraphExec_t ge;
  CHECK(cudaStreamBeginCapture(s, cudaStreamCaptureModeGlobal));
  for (int i = 0; i < 200; ++i)
    CHECK(cudaLaunchKernelEx(&cfg, kern, static_cast<int*>(nullptr)));
  CHECK(cudaStreamEndCapture(s, &g));
  CHECK(cudaGraphInstantiate(&ge, g, 0));
  CHECK(cudaGraphLaunch(ge, s));
  cudaEvent_t a, b;
  CHECK(cudaEventCreate(&a));
  CHECK(cudaEventCreate(&b));
  CHECK(cudaEventRecord(a, s));
  for (int i = 0; i < 10; ++i) CHECK(cudaGraphLaunch(ge, s));
  CHECK(cudaEventRecord(b, s));
  CHECK(cudaEventSynchronize(b));
  float ms = 0;
  CHECK(cudaEventElapsedTime(&ms, a, b));
  return 1e3 * ms / 2000;
}

template <typename K>
void run_ring(const char* name, K kern, const uint8_t* src, int pitch,
              int row_bytes, int blocks, int slabs, int nst,
              long long* d_cyc, uint32_t* sink) {
  const int smem = nst * ROWS * row_bytes;
  CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem));
  for (int rep = 0; rep < 3; ++rep)  // warm L2, then measure
    kern<<<blocks, THREADS, smem>>>(src, pitch, row_bytes, slabs, d_cyc,
                                    sink);
  CHECK(cudaDeviceSynchronize());
  std::vector<long long> cyc(blocks);
  CHECK(cudaMemcpy(cyc.data(), d_cyc, blocks * sizeof(long long),
                   cudaMemcpyDeviceToHost));
  double mean = 0;
  for (long long c : cyc) mean += c;
  mean /= blocks;
  std::printf(
      "{\"probe\": \"%s\", \"stages\": %d, \"row_bytes\": %d, \"pitch\": %d, "
      "\"blocks\": %d, \"slabs\": %d, \"cycles_per_slab\": %.1f}\n",
      name, nst, row_bytes, pitch, blocks, slabs, mean / slabs);
}

// the decode body over a bf16 base at M 8, bm 2, r 8, R 4 (zero inputs:
// the chain does not depend on the values), one plan
void run_decode(const char* name, int K, int N, int split, int bn) {
  const int M = 8, R = 4, r = 8, bm = 2;
  void *x, *w, *a, *b, *y;
  int* gid;
  CHECK(cudaMalloc(&x, (size_t)M * K * 2));
  CHECK(cudaMalloc(&w, (size_t)K * N * 2));
  CHECK(cudaMalloc(&a, (size_t)R * K * r * 2));
  CHECK(cudaMalloc(&b, (size_t)R * r * N * 2));
  CHECK(cudaMalloc(&y, (size_t)M * N * 2));
  CHECK(cudaMalloc(&gid, 4 * sizeof(int)));
  CHECK(cudaMemset(x, 0, (size_t)M * K * 2));
  CHECK(cudaMemset(w, 0, (size_t)K * N * 2));
  CHECK(cudaMemset(a, 0, (size_t)R * K * r * 2));
  CHECK(cudaMemset(b, 0, (size_t)R * r * N * 2));
  const int g[4] = {3, 0, 3, 1};
  CHECK(cudaMemcpy(gid, g, sizeof(g), cudaMemcpyHostToDevice));
  for (int rep = 0; rep < 3; ++rep) {
    const int rc = decode_tc::launch<wfmt::WFmt::kDense>(
        x, w, nullptr, a, b, gid, y, M, K, N, R, r, bm, 2.f, split, bn, 16,
        32, 0);
    if (rc) {
      std::fprintf(stderr, "decode launch: %d\n", rc);
      std::exit(1);
    }
  }
  CHECK(cudaDeviceSynchronize());
  long long t[16];
  CHECK(cudaMemcpyFromSymbol(t, decode_tc::decode_tc_stamps, sizeof(t)));
  const int nk = (K + decode_tc::KD - 1) / decode_tc::KD;
  std::printf(
      "{\"probe\": \"decode_%s\", \"K\": %d, \"N\": %d, \"split\": %d, "
      "\"bn\": %d, \"slabs_member0\": %d, \"to_gids\": %lld, "
      "\"prologue_copies\": %lld, \"k_loop\": %lld, \"loop_wait\": %lld, "
      "\"loop_copy\": %lld, \"loop_mma\": %lld, \"to_cluster_wait1\": "
      "%lld, \"pushes\": %lld, \"cluster_wait2\": %lld, \"epilogue\": "
      "%lld, \"total\": %lld}\n",
      name, K, N, split, bn, nk / split, t[1] - t[0], t[2] - t[1],
      t[3] - t[2], t[8], t[9], t[10], t[4] - t[3], t[5] - t[4], t[6] - t[5],
      t[7] - t[6], t[7] - t[0]);
  for (void* p : {x, w, a, b, y}) CHECK(cudaFree(p));
  CHECK(cudaFree(gid));
}

int main() {
  int dev = 0, clock_khz = 0, sms = 0;
  CHECK(cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, dev));
  CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  std::printf("{\"probe\": \"device\", \"clock_khz\": %d, \"sms\": %d}\n",
              clock_khz, sms);
  const int pitch = 1792, slabs = 48, maxb = 132;
  uint8_t* src;
  CHECK(cudaMalloc(&src, (size_t)maxb * slabs * ROWS * pitch));
  CHECK(cudaMemset(src, 1, (size_t)maxb * slabs * ROWS * pitch));
  long long* d_cyc;
  uint32_t* sink;
  CHECK(cudaMalloc(&d_cyc, maxb * sizeof(long long)));
  CHECK(cudaMalloc(&sink, 64));
  for (int blocks : {1, 132}) {
    for (int rb : {64, 128}) {
      run_ring("cp_async", ring_cpasync<2, false>, src, pitch, rb, blocks,
               slabs, 2, d_cyc, sink);
      run_ring("cp_async", ring_cpasync<4, false>, src, pitch, rb, blocks,
               slabs, 4, d_cyc, sink);
      run_ring("cp_async_l2", ring_cpasync<4, true>, src, pitch, rb, blocks,
               slabs, 4, d_cyc, sink);
      run_ring("cp_async", ring_cpasync<8, false>, src, pitch, rb, blocks,
               slabs, 8, d_cyc, sink);
      run_ring("bulk", ring_bulk<2>, src, pitch, rb, blocks, slabs, 2, d_cyc,
               sink);
      run_ring("bulk", ring_bulk<4>, src, pitch, rb, blocks, slabs, 4, d_cyc,
               sink);
      run_ring("bulk", ring_bulk<8>, src, pitch, rb, blocks, slabs, 8, d_cyc,
               sink);
    }
  }
  // dependent L2 loads: a ring of 4096 indices 64 ints apart
  const int n = 4096 * 64;
  std::vector<int> next(n, 0);
  for (int i = 0; i < 4096; ++i) next[i * 64] = ((i + 1) % 4096) * 64;
  int* d_next;
  int* d_sink;
  CHECK(cudaMalloc(&d_next, n * sizeof(int)));
  CHECK(cudaMalloc(&d_sink, 64));
  CHECK(cudaMemcpy(d_next, next.data(), n * sizeof(int),
                   cudaMemcpyHostToDevice));
  for (int rep = 0; rep < 3; ++rep) chase<<<1, 1>>>(d_next, 4096, d_cyc, d_sink);
  CHECK(cudaDeviceSynchronize());
  long long c = 0;
  CHECK(cudaMemcpy(&c, d_cyc, sizeof(c), cudaMemcpyDeviceToHost));
  std::printf("{\"probe\": \"l2_load\", \"cycles_per_load\": %.1f}\n",
              c / 4096.0);
  for (int rep = 0; rep < 3; ++rep) cluster_barriers<<<8, THREADS>>>(100, d_cyc);
  CHECK(cudaDeviceSynchronize());
  CHECK(cudaMemcpy(&c, d_cyc, sizeof(c), cudaMemcpyDeviceToHost));
  std::printf("{\"probe\": \"cluster8_sync\", \"cycles_per_sync\": %.1f}\n",
              c / 100.0);
  // the decode shapes at their decode_plan plans, and down without a split
  run_decode("q_o", 896, 896, 7, 128);
  run_decode("k_v", 896, 128, 7, 64);
  run_decode("gate_up", 896, 4864, 3, 128);
  run_decode("down", 4864, 896, 8, 128);
  run_decode("down", 4864, 896, 1, 128);
  run_decode("eight_slabs", 8 * decode_tc::KD, 64, 1, 64);
  run_decode("one_slab", decode_tc::KD, 64, 1, 64);
  cudaStream_t s;
  CHECK(cudaStreamCreate(&s));
  for (int blocks : {1, 8, 224}) {
    std::printf(
        "{\"probe\": \"empty_launch_in_graph\", \"blocks\": %d, "
        "\"us_no_cluster\": %.3f, \"us_cluster8\": %.3f}\n",
        blocks, time_launches(empty_kernel, blocks, 1, s),
        blocks % 8 ? -1.0 : time_launches(empty_kernel, blocks, 8, s));
  }
  return 0;
}
