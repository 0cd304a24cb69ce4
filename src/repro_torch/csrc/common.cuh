// Helpers shared by the port's kernels: f32 <-> element-type conversion,
// and the tile loader of the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Copy `rows` rows of D elements (row r at src + r * stride) into shared
// memory as f32 (row r at dst + r * ld), with zeros for rows >= valid.
// VEC > 1 moves 16 bytes per load (D % VEC == 0, src and stride 16-byte
// aligned; the caller checks); VEC == 1 moves one element. Each thread
// issues a batch of kBatch loads before it stores any of them, so that
// several loads per thread are in flight: the attention kernels stream
// their K and V tiles through this, and one load in flight per thread left
// them waiting on memory latency.
template <typename T, int VEC, int NTHREADS>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src, int64_t stride,
                                          int rows, int valid, int D) {
  constexpr int kBatch = 8;
  const int per_row = D / VEC;
  const int chunks = rows * per_row;
  for (int base = threadIdx.x; base < chunks; base += NTHREADS * kBatch) {
    if constexpr (VEC > 1) {
      uint4 buf[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * NTHREADS;
        const int r = idx / per_row, c = (idx - r * per_row) * VEC;
        buf[u] = (idx < chunks && r < valid)
                     ? *reinterpret_cast<const uint4*>(src + r * stride + c)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * NTHREADS;
        if (idx < chunks) {
          const int r = idx / per_row, c = (idx - r * per_row) * VEC;
          const T* e = reinterpret_cast<const T*>(&buf[u]);
#pragma unroll
          for (int j = 0; j < VEC; ++j) dst[r * ld + c + j] = to_f(e[j]);
        }
      }
    } else {
      float buf[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * NTHREADS;
        const int r = idx / per_row, c = idx - r * per_row;
        buf[u] = (idx < chunks && r < valid) ? to_f(src[r * stride + c]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * NTHREADS;
        if (idx < chunks) {
          const int r = idx / per_row, c = idx - r * per_row;
          dst[r * ld + c] = buf[u];
        }
      }
    }
  }
}

// Whether 16-byte loads can stream rows of D elements from these pointers.
inline bool vec16_ok(int D, int elem_bytes, const void* const* ptrs, int n) {
  if ((D * elem_bytes) % 16) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

}  // namespace repro
