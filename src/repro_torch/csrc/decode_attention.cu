// Decode attention (one query token over a KV cache) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::_decode_kernel. For q (B,H,Dk),
// k (B,S,KV,Dk), v (B,S,KV,Dv) and length (B,) int32, head h = kvh*G + g
// (G = H/KV, any value) attends over the keys j < length[b]:
//
//     s = (q . k_j) * scale, -1e30 where j >= length[b]
//     online softmax over kv blocks: m, l, acc = acc * alpha + p . v
//
// and the kernel returns the unnormalised o = acc, m and l (all f32), so a
// caller can log-sum-exp combine shards of a cache. A row with length 0
// keeps m = -1e30, l = 0, o = 0, as the Pallas kernel does. q, k, v are
// read as f32 and every product is summed in f32.
//
// Bound: memory traffic. Each key and value up to length[b] is read once
// for the whole GQA group: 2*G*D flops per 2*D elements read, far below the
// card's balance point, so the least time is the K and V bytes up to length
// (plus q and the outputs) over the device memory rate.
//
// Layout: one CTA of 256 threads per (batch, kv head), as the TPU grid has
// it. It loads the group's G query rows once, walks the cache in blocks of
// 64 keys and stops at length[b] (the Pallas kernel skips later blocks with
// pl.when; its S must be a multiple of its block, while here any S is taken
// and the tail is masked). K and V tiles come in with 16-byte loads, several
// in flight per thread (common.cuh). Scores, probabilities and the G x Dv
// accumulator live in shared memory, so G is a runtime value. Splitting S
// across CTAs (flash-decoding) is the later speed work: at B*KV = 64 CTAs
// this grid fills half of the 132 SMs.

#include "common.cuh"

namespace {

using repro::load_rows;
using repro::to_f;

constexpr int kBK = 64;         // keys per block: two per lane in the softmax pass
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

size_t smem_bytes(int G, int Dk, int Dv) {
  return sizeof(float) * ((size_t)G * Dk + (size_t)kBK * (Dk + 1) + (size_t)kBK * Dv +
                          (size_t)G * kBK + (size_t)G * Dv + 3 * (size_t)G);
}

// VEC: elements per global load of K and V (16 bytes, or 1 where the rows
// are not 16-byte aligned).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ length,
              float* __restrict__ o, float* __restrict__ m_out,
              float* __restrict__ l_out, int S, int H, int KV, int Dk, int Dv,
              float scale) {
  extern __shared__ float smem[];
  const int G = H / KV, ldk = Dk + 1;
  float* Qs = smem;                  // [G][Dk]
  float* Ks = Qs + G * Dk;           // [kBK][ldk]
  float* Vs = Ks + kBK * ldk;        // [kBK][Dv]
  float* Ps = Vs + kBK * Dv;         // [G][kBK]
  float* accs = Ps + G * kBK;        // [G][Dv]
  float* ms = accs + G * Dv;         // [G]
  float* ls = ms + G;                // [G]
  float* as = ls + G;                // [G] rescale of the block

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = min(max(length[b], 0), S);
  const int64_t head0 = (int64_t)b * H + (int64_t)kvh * G;   // first head of the group

  for (int idx = tid; idx < G * Dk; idx += kThreads) Qs[idx] = to_f(q[head0 * Dk + idx]);
  for (int idx = tid; idx < G * Dv; idx += kThreads) accs[idx] = 0.0f;
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.0f;
  }

  const T* kbase = k + ((int64_t)b * S * KV + kvh) * Dk;    // key 0 of this kv head
  const T* vbase = v + ((int64_t)b * S * KV + kvh) * Dv;
  const int nkb = (len + kBK - 1) / kBK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();   // Qs/accs initialised; the previous block is done with Ks, Vs, Ps
    load_rows<T, VEC, kThreads>(Ks, ldk, kbase + (int64_t)k0 * KV * Dk, (int64_t)KV * Dk,
                                kBK, len - k0, Dk);
    load_rows<T, VEC, kThreads>(Vs, Dv, vbase + (int64_t)k0 * KV * Dv, (int64_t)KV * Dv,
                                kBK, len - k0, Dv);
    __syncthreads();

    // scores: a warp takes 32 consecutive keys of one query row
    for (int idx = tid; idx < G * kBK; idx += kThreads) {
      const int g = idx / kBK, t = idx - g * kBK;
      const float* qr = Qs + g * Dk;
      const float* kr = Ks + t * ldk;
      float dot = 0.0f;
      for (int d = 0; d < Dk; ++d) dot = fmaf(qr[d], kr[d], dot);
      Ps[idx] = k0 + t < len ? __fmul_rn(dot, scale) : kNegInf;
    }
    __syncthreads();

    // online softmax: a warp per query row, two keys per lane
    for (int g = warp; g < G; g += kWarps) {
      float* prow = Ps + g * kBK;
      const float s0 = prow[lane], s1 = prow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
        as[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v: a thread owns column c of every row
    for (int c = tid; c < Dv; c += kThreads) {
      for (int g = 0; g < G; ++g) {
        const float* prow = Ps + g * kBK;
        float pv = 0.0f;
#pragma unroll 8
        for (int t = 0; t < kBK; ++t) pv = fmaf(prow[t], Vs[t * Dv + c], pv);
        accs[g * Dv + c] = accs[g * Dv + c] * as[g] + pv;
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < G * Dv; idx += kThreads) o[head0 * Dv + idx] = accs[idx];
  for (int g = tid; g < G; g += kThreads) {
    m_out[head0 + g] = ms[g];
    l_out[head0 + g] = ls[g];
  }
}

template <typename T, int VEC>
int launch_vec(const void* q, const void* k, const void* v, const void* length,
               void* o, void* m, void* l, int B, int S, int H, int KV, int Dk,
               int Dv, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, Dk, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T, VEC><<<(unsigned)(B * KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(length), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), S, H, KV, Dk, Dv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           void* o, void* m, void* l, int B, int S, int H, int KV, int Dk,
           int Dv, float scale, cudaStream_t stream) {
  const void* kp[] = {k};
  const void* vp[] = {v};
  if (repro::vec16_ok(Dk, sizeof(T), kp, 1) && repro::vec16_ok(Dv, sizeof(T), vp, 1))
    return launch_vec<T, 16 / sizeof(T)>(q, k, v, length, o, m, l, B, S, H, KV, Dk, Dv,
                                         scale, stream);
  return launch_vec<T, 1>(q, k, v, length, o, m, l, B, S, H, KV, Dk, Dv, scale, stream);
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's limit before launching).
extern "C" int64_t decode_attention_smem_bytes(int G, int Dk, int Dv) {
  return (int64_t)smem_bytes(G, Dk, Dv);
}

// Plain C entry point (bound with ctypes). Device pointers to contiguous
// q (B,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv) of one dtype (0 = f32, 1 = bf16),
// length (B,) int32, and f32 outputs o (B,H,Dv), m (B,H), l (B,H). The
// caller has checked shapes, H % KV == 0 and 0 < Dk, Dv <= 128. Returns the
// first CUDA error of the set-up or the launch, else 0.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* length,
                                       void* o, void* m, void* l, int B, int S,
                                       int H, int KV, int Dk, int Dv,
                                       float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (Dk <= 0 || Dv <= 0 || Dk > kMaxD || Dv > kMaxD) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(q, k, v, length, o, m, l, B, S, H, KV, Dk, Dv, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, length, o, m, l, B, S, H, KV, Dk, Dv, scale, s);
  return (int)cudaErrorInvalidValue;
}
