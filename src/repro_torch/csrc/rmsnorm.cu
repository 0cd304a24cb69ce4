// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel.
// For every row r of x (R rows of D elements):
//
//     out[r, :] = x[r, :] * rsqrt(sum(x[r, :]^2) / D + eps) * w
//
// with x and w read as f32 and every sum taken in f32; out has x's type.
// x is f32 or bf16 and w is f32 or bf16, independently (a template on both,
// chosen by the dtype codes the wrapper passes).
//
// Bound: memory traffic. The work is 4 flops per element against 4 or 2
// bytes read and written, far below the card's balance point, so the least
// time is (R * D * sizeof(x) in + the same out + D * sizeof(w)) bytes over
// the device memory rate. The design reads the row once from device memory
// (the second pass over it hits L1/L2: one CTA owns the row), with 16-byte
// vector loads and stores where the row allows them.
//
// Layout: one CTA per row. Threads stride the row in 16-byte vectors (or
// single elements when D or an address is not 16-byte aligned), reduce
// sum(x^2) in registers, then across the warp by shuffles and across warps
// through shared memory. The TPU wrapper pads R to whole 256-row tiles;
// here the grid is exactly R rows and the D tail is masked by the loops.

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kMaxThreads = 256;

// Sum of v over the CTA; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = (blockDim.x + 31) / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// VEC elements of x per 16-byte vector (1: scalar path).
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ out, int D, float eps) {
  __shared__ float red[32];
  const T* xr = x + (int64_t)blockIdx.x * D;
  T* orow = out + (int64_t)blockIdx.x * D;

  float ss = 0.0f;
  if (VEC > 1) {
    for (int i = threadIdx.x * VEC; i < D; i += blockDim.x * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f(e[j]);
        ss = __fadd_rn(ss, __fmul_rn(f, f));
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float f = to_f(xr[i]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
  }
  const float inv = rsqrtf(block_sum(ss, red) / (float)D + eps);

  if (VEC > 1) {
    for (int i = threadIdx.x * VEC; i < D; i += blockDim.x * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o[j] = from_f<T>(__fmul_rn(__fmul_rn(to_f(e[j]), inv), to_f(w[i + j])));
      *reinterpret_cast<uint4*>(orow + i) = packed;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x)
      orow[i] = from_f<T>(__fmul_rn(__fmul_rn(to_f(xr[i]), inv), to_f(w[i])));
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int64_t R, int D,
           float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = D % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int units = vec ? D / kVec : D;            // loads per row
  int threads = ((units + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  const T* xt = static_cast<const T*>(x);
  const W* wt = static_cast<const W*>(w);
  T* ot = static_cast<T*>(out);
  if (vec)
    rmsnorm_kernel<T, W, kVec><<<(unsigned)R, threads, 0, stream>>>(xt, wt, ot, D, eps);
  else
    rmsnorm_kernel<T, W, 1><<<(unsigned)R, threads, 0, stream>>>(xt, wt, ot, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). x, w, out are device pointers;
// x and out are contiguous (R, D); dtype codes: 0 = f32, 1 = bf16. The
// caller has checked shapes, devices and contiguity, and that
// 0 < R < 2^31. Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int64_t R, int D, float eps, int x_dtype,
                              int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0 || D == 0) return 0;
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, w, out, R, D, eps, s);
  if (x_dtype == 0 && w_dtype == 1) return launch<float, __nv_bfloat16>(x, w, out, R, D, eps, s);
  if (x_dtype == 1 && w_dtype == 0) return launch<__nv_bfloat16, float>(x, w, out, R, D, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
