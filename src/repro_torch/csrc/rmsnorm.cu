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
// the device memory rate. At the serve path's decode shape (8 rows of 7168)
// that is 73 ns, so there the kernel is bound by latency: how many device
// memory round trips lie between its launch and its last store.
//
// Design: a row slice of a CTA lives in registers from its load to its
// store. Each thread issues every load it will need, its VPT vectors of x
// and the matching vectors of w (16 bytes of x each, or single elements on
// the scalar path), before it waits on any of them; the sum of squares, the
// scaling and the stores then run on registers, so x is read from device
// memory once and the reduction waits on one round trip. Thread t holds
// vectors t, t + threads, ..., so neighbouring threads load neighbouring
// addresses. The layout is chosen in Python (kernels/rmsnorm.py::
// launch_plan) from the shape alone and passed in as K, threads, VPT and
// VEC:
//
//  - one CTA per row (K == 1): the row sum is a warp-shuffle tree, then the
//    warps' sums through shared memory. With at least as many rows as SMs
//    (prefill) the CTA is narrow (128 threads of 8 vectors at yi-34b's
//    width), with fewer (decode) it is wide (448 threads of 2).
//  - cluster (K > 1, a row too long for one CTA's registers): the row is
//    split over a thread-block cluster of K CTAs (cudaLaunchKernelEx with a
//    cluster dimension), each CTA holding per_cta elements. Each CTA
//    reduces its part to one partial and writes it into slot `rank` of
//    every CTA's shared memory (mapa + st.shared::cluster); after a cluster
//    barrier (arrive.release / wait.acquire) each CTA adds the K slots of
//    its own shared memory in rank order 0..K-1, so every CTA holds the
//    same inv and the result does not depend on timing. A first barrier,
//    arrived at on entry and waited on only before those writes, makes
//    sure every CTA of the cluster has started before its shared memory is
//    written. No CTA touches another's shared memory after the second
//    barrier, so none has to wait for the others before it exits. At the
//    decode shape, clusters of 8 or 16 CTAs per row measured slower than
//    one wide CTA per row on an H100 (the barrier round trip costs more
//    than the extra SMs save), so decode does not take them.
//
// No atomics; the D tail and any partial last slice are masked in the
// kernel. A launch the card refuses (a cluster it cannot place, more
// threads than the launch bound) returns its error to the wrapper, which
// raises.

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kMaxCluster = 16;   // non-portable cluster sizes above 8 are opted into

// Threads a CTA may have for VPT vectors per thread: the bound keeps the
// kernel's registers (VPT vectors of x and of w, up to 8 + 16 per vector)
// within the register file at full occupancy of the bound.
template <int VEC, int VPT>
constexpr int thread_bound() {
  return VEC == 1 || VPT <= 2 ? 1024 : 2048 / VPT;
}

// VEC elements of type T as one aligned load (16 bytes of x, or VEC
// elements of w: 32 bytes for f32 w beside bf16 x, 8 for bf16 w beside f32 x).
template <typename T, int VEC>
struct alignas(VEC * sizeof(T) >= 16 ? 16 : VEC * sizeof(T)) Pack {
  T e[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the CTA, in a fixed order; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = (blockDim.x + 31) / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < nwarps ? red[lane] : 0.0f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// v into the f32 at this CTA's shared address `local`, in the shared memory
// of cluster rank `rank`
__device__ __forceinline__ void st_cluster(uint32_t local, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

// Grid: R * K CTAs; CTA b normalises elements [rank * per_cta, (rank + 1) *
// per_cta) of row b / K, rank = b % K (its rank in a 1-d cluster of K).
template <typename T, typename W, int VEC, int VPT>
__global__ void __launch_bounds__(thread_bound<VEC, VPT>())
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
               int D, int K, int per_cta, float eps) {
  __shared__ float red[32];
  __shared__ float partials[kMaxCluster];   // slot r: cluster rank r's partial sum
  const int rank = blockIdx.x % K;
  const int64_t row = blockIdx.x / K;
  const T* xr = x + row * D;
  T* orow = out + row * D;
  const int c0 = rank * per_cta;
  const int c1 = min(D, c0 + per_cta);
  if (K > 1) cluster_arrive_relaxed();   // this CTA has started

  // every load of this thread, before any is used
  Pack<T, VEC> xv[VPT];
  Pack<W, VEC> wv[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int e = c0 + (threadIdx.x + i * blockDim.x) * VEC;
    if (e < c1) {
      xv[i] = *reinterpret_cast<const Pack<T, VEC>*>(xr + e);
      wv[i] = *reinterpret_cast<const Pack<W, VEC>*>(w + e);
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int e = c0 + (threadIdx.x + i * blockDim.x) * VEC;
    if (e < c1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f(xv[i].e[j]);
        ss = __fadd_rn(ss, __fmul_rn(f, f));
      }
    }
  }
  float total = block_sum(ss, red);
  if (K > 1) {
    cluster_wait();                        // every CTA of the cluster has started
    // lane r of warp 0 sends this CTA's partial to cluster rank r
    if (threadIdx.x < K) st_cluster(smem_u32(&partials[rank]), threadIdx.x, total);
    cluster_arrive();
    cluster_wait();
    total = 0.0f;
    for (int r = 0; r < K; ++r) total = __fadd_rn(total, partials[r]);
  }
  const float inv = rsqrtf(total / (float)D + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int e = c0 + (threadIdx.x + i * blockDim.x) * VEC;
    if (e < c1) {
      Pack<T, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.e[j] = from_f<T>(__fmul_rn(__fmul_rn(to_f(xv[i].e[j]), inv), to_f(wv[i].e[j])));
      *reinterpret_cast<Pack<T, VEC>*>(orow + e) = o;
    }
  }
}

template <typename T, typename W, int VEC, int VPT>
int launch_vpt(const void* x, const void* w, void* out, int64_t R, int D, float eps, int K,
               int threads, int per_cta, cudaStream_t stream) {
  if (threads > thread_bound<VEC, VPT>()) return (int)cudaErrorInvalidValue;
  auto kernel = rmsnorm_kernel<T, W, VEC, VPT>;
  const T* xt = static_cast<const T*>(x);
  const W* wt = static_cast<const W*>(w);
  T* ot = static_cast<T*>(out);
  if (K == 1) {
    rmsnorm_kernel<T, W, VEC, VPT><<<(unsigned)R, threads, 0, stream>>>(xt, wt, ot, D, K,
                                                                      per_cta, eps);
    return (int)cudaGetLastError();
  }
  if (K > 8) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(R * K));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, xt, wt, ot, D, K, per_cta, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename W, int VEC>
int launch_vec(const void* x, const void* w, void* out, int64_t R, int D, float eps, int K,
               int threads, int vpt, int per_cta, cudaStream_t stream) {
  switch (vpt) {
    case 1: return launch_vpt<T, W, VEC, 1>(x, w, out, R, D, eps, K, threads, per_cta, stream);
    case 2: return launch_vpt<T, W, VEC, 2>(x, w, out, R, D, eps, K, threads, per_cta, stream);
    case 4: return launch_vpt<T, W, VEC, 4>(x, w, out, R, D, eps, K, threads, per_cta, stream);
    case 8: return launch_vpt<T, W, VEC, 8>(x, w, out, R, D, eps, K, threads, per_cta, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int64_t R, int D, float eps, int K,
           int threads, int vpt, int vec, int per_cta, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  // the plan must cover the row exactly: K slices of per_cta elements, each
  // held by threads x vpt vectors of vec elements
  if (K < 1 || K > kMaxCluster || threads < 32 || threads % 32 || per_cta < 1 ||
      (int64_t)K * per_cta < D || (int64_t)(K - 1) * per_cta >= D ||
      (int64_t)threads * vpt * vec < per_cta || per_cta % vec || R * K >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  if (vec == kVec) {
    const void* ptrs[3] = {x, w, out};
    if (!repro::vec16_ok(D, sizeof(T), ptrs, 3)) return (int)cudaErrorInvalidValue;
    return launch_vec<T, W, kVec>(x, w, out, R, D, eps, K, threads, vpt, per_cta, stream);
  }
  if (vec == 1)
    return launch_vec<T, W, 1>(x, w, out, R, D, eps, K, threads, vpt, per_cta, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). x, w, out are device pointers;
// x and out are contiguous (R, D); dtype codes: 0 = f32, 1 = bf16. The
// launch geometry comes from kernels/rmsnorm.py::launch_plan: a cluster of K
// CTAs per row (1: one CTA per row), `threads` threads of `vpt` vectors of
// `vec` elements (16 bytes, or 1 for the scalar path), `per_cta` elements of
// the row per CTA. The caller has checked shapes, devices and contiguity,
// and that 0 < R < 2^31; a plan that does not cover the row, or a vector
// path on misaligned pointers, returns cudaErrorInvalidValue. Otherwise
// returns the launch's error (cudaLaunchKernelEx) or cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int64_t R, int D,
                              float eps, int x_dtype, int w_dtype, int K, int threads,
                              int vpt, int vec, int per_cta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0 || D == 0) return 0;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, out, R, D, eps, K, threads, vpt, vec, per_cta, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, out, R, D, eps, K, threads, vpt, vec, per_cta, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, out, R, D, eps, K, threads, vpt, vec, per_cta, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, R, D, eps, K, threads, vpt, vec,
                                                per_cta, s);
  return (int)cudaErrorInvalidValue;
}
