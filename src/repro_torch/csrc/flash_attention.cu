// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_fwd_kernel. For q (B,Sq,H,Dk),
// k (B,Sk,KV,Dk), v (B,Sk,KV,Dv), head h reading kv head h / (H/KV) (GQA by
// index; the group need not be a power of two), it computes per row
//
//     s = (q . k) * scale, masked to -1e30 where causal and q_offset+i < j
//     online softmax over kv blocks: m, l, acc = acc * alpha + p . v
//     out = acc / max(l, 1e-30)   (in q's type)
//     lse = m + log(max(l, 1e-30))   (f32, (B,H,Sq): the training slice's
//                                     backward will need it)
//
// with q, k, v read as f32 and every product summed in f32, as the Pallas
// kernel does (.astype(float32) inside).
//
// Bound: at the serve shapes, operations. Causal attention needs
// 4*B*H*D*Sq*(Sq+1)/2 flops against a few bytes per element of q, k, v and
// out, far above the card's balance point. This first version runs the two
// products on the CUDA cores in f32 (fmaf on register tiles), not on the
// tensor cores: it is right and simple, and its time stands beside the
// tensor-core bound in PERF.md. wgmma/TMA is the later speed work.
//
// Head dims up to 288 (MLA's absorbed form in f32: Dk 288, Dv 256); the
// f32 tiles then take 230,400 bytes of shared memory, within the 227 KB a
// block may use, and the accumulator 4 x 16 registers a thread.
//
// Layout: one CTA of 256 threads per (q block of 64 rows, head, batch). It
// keeps its q tile in shared memory and walks the kv blocks of 64 keys that
// the causal diagonal lets through (the Pallas kernel skips the others with
// pl.when); the running m and l of a row live in the registers of the four
// threads that own that row in the softmax pass, the accumulator in
// registers as a 4 x (Dv/16) tile per thread. Tiles are stored as f32 in
// shared memory with rows padded by one word, so column reads hit distinct
// banks; they are filled with 16-byte loads, several in flight per thread
// (common.cuh). q_offset is a runtime argument. The Sq and Sk tails are masked in
// the kernel (the TPU kernel asserts divisibility). Blocks are issued
// heaviest first (last q block first), since under a causal mask the work
// grows with the q block index.

#include "common.cuh"

namespace {

using repro::from_f;
using repro::load_rows;

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // keys per kv block
constexpr int kThreads = 256;  // 16 x 16 threads; each owns rows ty+16i, columns tx+16j
constexpr int kLdp = kBK + 1;  // padded row stride of the score tile
constexpr int kMaxD = 288;   // MLA's absorbed Dk (kv_lora_rank 256 + rope 32)
constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory a block may use on Hopper
constexpr float kNegInf = -1e30f;

size_t smem_bytes(int Dk, int Dv) {
  return sizeof(float) * ((size_t)kBQ * (Dk + 1) + (size_t)kBK * (Dk + 1) +
                          (size_t)kBK * Dv + (size_t)kBQ * kLdp + kBQ);
}

// NJ: output column slots per thread, Dv <= 16 * NJ. VEC: elements per
// global load (16 bytes, or 1 where the rows are not 16-byte aligned).
template <typename T, int NJ, int VEC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int Dk, int Dv, int q_offset, int causal, float scale) {
  extern __shared__ float smem[];
  const int ldk = Dk + 1;
  float* Qs = smem;                    // [kBQ][ldk]
  float* Ks = Qs + kBQ * ldk;          // [kBK][ldk]
  float* Vs = Ks + kBK * ldk;          // [kBK][Dv]
  float* Ps = Vs + kBK * Dv;           // [kBQ][kLdp]: scores, then probabilities
  float* alpha_s = Ps + kBQ * kLdp;    // [kBQ]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  load_rows<T, VEC, kThreads>(Qs, ldk, q + (((int64_t)b * Sq + q0) * H + h) * Dk,
                              (int64_t)H * Dk, kBQ, Sq - q0, Dk);
  const T* kbase = k + ((int64_t)b * Sk * KV + kvh) * Dk;    // key 0 of this kv head
  const T* vbase = v + ((int64_t)b * Sk * KV + kvh) * Dv;

  // kv blocks to visit: under a causal mask, up to the block holding the
  // position of this CTA's last row
  int nkb = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last = q_offset + min(q0 + kBQ, Sq) - 1;
    nkb = min(nkb, last < 0 ? 0 : last / kBK + 1);
  }

  // softmax pass: thread owns row rr, keys part*16 .. part*16+15
  const int rr = tid / 4, part = tid % 4;
  float m_run = kNegInf, l_run = 0.0f;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();   // the previous block is done with Ks, Vs, Ps, alpha_s
    load_rows<T, VEC, kThreads>(Ks, ldk, kbase + (int64_t)k0 * KV * Dk, (int64_t)KV * Dk,
                                kBK, Sk - k0, Dk);
    load_rows<T, VEC, kThreads>(Vs, Dv, vbase + (int64_t)k0 * KV * Dv, (int64_t)KV * Dv,
                                kBK, Sk - k0, Dv);
    __syncthreads();

    // scores on a 4 x 4 register tile: rows ty+16i, keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < Dk; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, t = tx + 16 * j;
        const int kpos = k0 + t;
        float val = __fmul_rn(s[i][j], scale);
        if (kpos >= Sk || (causal && q_offset + q0 + r < kpos)) val = kNegInf;
        Ps[r * kLdp + t] = val;
      }
    __syncthreads();

    // online softmax of row rr; the four owners of a row are adjacent lanes
    {
      float* prow = Ps + rr * kLdp + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (part == 0) alpha_s[rr] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p . v on rows ty+16i, columns tx+16j
    float pv[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) pv[i][j] = 0.0f;
    for (int t = 0; t < kBK; ++t) {
      float pr[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * kLdp + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < Dv ? Vs[t * Dv + c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) pv[i][j] = fmaf(pr[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = acc[i][j] * a + pv[i][j];
    }
  }

  // epilogue: each row's l comes from its softmax owner through shared memory
  __syncthreads();
  if (part == 0) alpha_s[rr] = fmaxf(l_run, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = alpha_s[r];
    T* orow = out + (((int64_t)b * Sq + qi) * H + h) * Dv;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < Dv) orow[c] = from_f<T>(acc[i][j] / l);
    }
  }
  if (part == 0 && q0 + rr < Sq)
    lse[((int64_t)b * H + h) * Sq + q0 + rr] = m_run + logf(fmaxf(l_run, 1e-30f));
}

template <typename T, int NJ, int VEC>
int launch_vec(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Sk, int H, int KV, int Dk, int Dv,
               int q_offset, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Dk, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, NJ, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, H, KV, Dk, Dv,
      q_offset, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int Sq, int Sk, int H, int KV, int Dk, int Dv,
              int q_offset, int causal, float scale, cudaStream_t stream) {
  const void* qk[] = {q, k};
  const void* vv[] = {v};
  if (repro::vec16_ok(Dk, sizeof(T), qk, 2) && repro::vec16_ok(Dv, sizeof(T), vv, 1))
    return launch_vec<T, NJ, 16 / sizeof(T)>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv,
                                             q_offset, causal, scale, stream);
  return launch_vec<T, NJ, 1>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset,
                              causal, scale, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Sk, int H, int KV, int Dk, int Dv, int q_offset,
           int causal, float scale, cudaStream_t s) {
  if (Dv <= 16)
    return launch_nj<T, 1>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset, causal, scale, s);
  if (Dv <= 32)
    return launch_nj<T, 2>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset, causal, scale, s);
  if (Dv <= 64)
    return launch_nj<T, 4>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset, causal, scale, s);
  if (Dv <= 128)
    return launch_nj<T, 8>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset, causal, scale, s);
  if (Dv <= 256)
    return launch_nj<T, 16>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset, causal, scale, s);
  return launch_nj<T, 18>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset, causal, scale, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers to contiguous
// q (B,Sq,H,Dk), k (B,Sk,KV,Dk), v (B,Sk,KV,Dv), out (B,Sq,H,Dv) of one
// dtype (0 = f32, 1 = bf16) and lse (B,H,Sq) f32. The caller has checked
// shapes, H % KV == 0, q_offset >= 0 and B, H < 65536. Head dims must be
// in 0 < Dk, Dv <= 288 with the tiles (smem_bytes) within the shared memory
// a block may use: else cudaErrorInvalidValue, before any CUDA call.
// Returns that, or the first CUDA error of the set-up or the launch, else 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int Dk, int Dv, int q_offset, int causal,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (Dk <= 0 || Dv <= 0 || Dk > kMaxD || Dv > kMaxD || smem_bytes(Dk, Dv) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset, causal, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset,
                                 causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
