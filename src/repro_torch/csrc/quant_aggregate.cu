// Fused int8 dequantize + weighted client reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_aggregate.py::_agg_kernel.
// Computes, for every n in [0, N):
//
//     acc = 0;  for c in 0..C-1:  acc = acc + (float(q[c, n]) * scale[c, n / qblock]) * w[c]
//     out[n] = acc
//
// in exactly that order, with every multiply and add rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), so the result equals the
// plain PyTorch version (repro_torch/kernels/quant_aggregate.py::plain)
// bit for bit.
//
// Bound: memory traffic. The work is 3 flops per int8 byte read, far below
// the card's ~20 flops/byte balance point for f32, so the least time is
//     bytes = C*N (q) + 4*C*N/qblock (scales) + 4*C (w) + 4*N (out)
// over the device memory rate. The design reads each int8 byte exactly once
// (16-byte vector loads, neighbouring threads on neighbouring addresses)
// and writes only the f32 result; the (C, N) f32 dequant never exists.
//
// Layout: one thread owns 16 consecutive outputs. qblock is a multiple of
// 16, so all 16 lie in one scale block: one scale load per thread per
// client. The client loop runs inside the thread, so there are no atomics
// and no cross-block reduction, and the output is deterministic. w is staged
// in shared memory once per block. The N tail is masked in the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 16;      // outputs per thread == bytes per int8 vector load
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
quant_aggregate_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scale,
                       const float* __restrict__ w,
                       float* __restrict__ out,
                       int C, int64_t N, int qblock) {
  extern __shared__ float w_s[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) w_s[c] = w[c];
  __syncthreads();

  const int64_t n0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  if (n0 >= N) return;                      // tail mask (N % 16 == 0)
  const int64_t nblocks = N / qblock;
  const int64_t blk = n0 / qblock;

  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;

  for (int c = 0; c < C; ++c) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(q + (int64_t)c * N + n0));
    const float s = __ldg(scale + (int64_t)c * nblocks + blk);
    const float wc = w_s[c];
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn((float)b[i], s), wc));
  }

  float4* o = reinterpret_cast<float4*>(out + n0);
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i)
    o[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers; the
// caller has checked dtypes, contiguity, 16-byte alignment, N % qblock == 0
// and qblock % 16 == 0. Returns cudaGetLastError() after the launch.
extern "C" int quant_aggregate_launch(const void* q, const void* scale,
                                      const void* w, void* out, int C,
                                      int64_t N, int qblock, void* stream) {
  const int64_t threads_needed = N / kVec;
  const int64_t grid = (threads_needed + kThreads - 1) / kThreads;
  if (grid > 0) {
    quant_aggregate_kernel<<<(unsigned)grid, kThreads, C * sizeof(float),
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<const float*>(w), static_cast<float*>(out), C, N, qblock);
  }
  return (int)cudaGetLastError();
}
