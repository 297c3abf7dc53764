// Row loads shared by the RMSNorm kernels (rmsnorm_fwd.cu, rmsnorm_bwd.cu):
// one warp holds a row chunk of NV units of 16 bytes a lane in registers,
// and the launch picks NV from the row width.
#pragma once

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

// units a lane holds: a warp's chunk of 4,096 bf16 or 2,048 f32 values
constexpr int NV_MAX = 16;

template <typename T>
struct alignas(16) Unit {
  static constexpr int V = 16 / sizeof(T);  // values in 16 bytes
  T v[V];
};

// Column of value e of unit u of a lane's share of the chunk at `base`:
// V (lane + 32 u) + e when the row takes 16-byte accesses (`vec`), else
// lane + 32 (u V + e), so that element accesses coalesce across the warp.
template <typename T>
__device__ __forceinline__ int unit_col(int base, int lane, int u, int e,
                                        bool vec) {
  constexpr int V = Unit<T>::V;
  return vec ? base + V * (lane + 32 * u) + e
             : base + lane + 32 * (u * V + e);
}

// Unit u (of NV) of a lane's share of the row chunk at `base` (columns
// unit_col), zero past d: one 16-byte load when `vec`, else V element loads.
template <typename T, int NV>
__device__ __forceinline__ void load_units(Unit<T> (&out)[NV], const T* row,
                                           int base, int d, int lane,
                                           bool vec) {
  constexpr int V = Unit<T>::V;
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    if (vec) {
      const int c = unit_col<T>(base, lane, u, 0, true);
      if (c < d) {
        *reinterpret_cast<uint4*>(out[u].v) =
            *reinterpret_cast<const uint4*>(row + c);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) out[u].v[e] = from_f<T>(0.f);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = unit_col<T>(base, lane, u, e, false);
        out[u].v[e] = c < d ? row[c] : from_f<T>(0.f);
      }
    }
  }
}

// Writes `in` where load_units read it, skipping columns past d.
template <typename T, int NV>
__device__ __forceinline__ void store_units(T* row, const Unit<T> (&in)[NV],
                                            int base, int d, int lane,
                                            bool vec) {
  constexpr int V = Unit<T>::V;
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    if (vec) {
      const int c = unit_col<T>(base, lane, u, 0, true);
      if (c < d)
        *reinterpret_cast<uint4*>(row + c) =
            *reinterpret_cast<const uint4*>(in[u].v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = unit_col<T>(base, lane, u, e, false);
        if (c < d) row[c] = in[u].v[e];
      }
    }
  }
}

// Calls f(std::integral_constant<int, NV>{}) with NV the smallest power of
// two (1 to NV_MAX) of 16-byte units a lane needs to hold a row of d values
// of T; a wider row takes NV_MAX and runs in passes.
template <typename T, typename F>
void with_units(int d, F&& f) {
  constexpr int V = Unit<T>::V;
  const int units = (d + 32 * V - 1) / (32 * V);  // a lane's share
  if (units <= 1)
    f(std::integral_constant<int, 1>{});
  else if (units <= 2)
    f(std::integral_constant<int, 2>{});
  else if (units <= 4)
    f(std::integral_constant<int, 4>{});
  else if (units <= 8)
    f(std::integral_constant<int, 8>{});
  else
    f(std::integral_constant<int, NV_MAX>{});
}

// Whether every base in `ptrs` is 16-byte aligned (a null one counts as
// aligned) and d a whole number of units: then a row takes 16-byte accesses.
template <typename T>
bool rows_take_units(int d, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return d % Unit<T>::V == 0 && (bits & 15) == 0;
}
