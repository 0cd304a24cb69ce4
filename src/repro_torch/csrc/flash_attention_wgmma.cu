// Flash-attention forward on Hopper's tensor cores (sm_90a, wgmma).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:30 (_fwd_kernel) for bf16 inputs
// whose head dims Dk, Dv are multiples of 8 (a tensor map's row stride is
// a multiple of 16 bytes) and fit one of the tiles below: every (Dk, Dv)
// of the port's configs (128/128, 64/64, MLA's absorbed 288/256 and
// expanded 96/64, the reduced configs' 16/16 and 24/16). f32, and bf16 at
// other head dims, take the 3xTF32 mma.sync kernel in flash_attention.cu
// (kernels/flash_attention.launch_plan decides). For q (B,Sq,H,Dk), k (B,Sk,KV,Dk),
// v (B,Sk,KV,Dv), head h reading kv head h / (H/KV) (GQA by index, any
// group size), it computes per row
//
//     s = (q . k) * scale, masked to -1e30 where causal and q_offset+i < j
//     online softmax over kv blocks: m, l, acc = acc * alpha + p . v
//     out = acc / max(l, 1e-30)   (bf16)
//     lse = m + log(max(l, 1e-30))   (f32, (B,H,Sq), for the backward)
//
// Bound: operations. At the serve shape (B 8, S 2048 causal, 56/8 heads of
// 128) the two products are 481 GFLOP against 540 MB of q, k, v, out and
// lse: 0.487 ms at the 989 TFLOP/s bf16 tensor-core peak of an H100 SXM,
// 0.161 ms of memory traffic at 3.35 TB/s. So both products run on the
// tensor cores:
//
// - S = Q K^T is a wgmma with both operands in shared memory, K-major, in
//   the 128-byte-swizzle layout that wgmma's descriptors name: 64-column
//   panels of rows of 128 bytes, the 16-byte chunk c of row r stored at
//   chunk c ^ (r % 8). A 128-wide head is two panels.
// - O += P V is a wgmma with A = P from registers: the S accumulator
//   fragment, scaled, exponentiated and rounded to bf16 in place (a thread's
//   accumulator pairs for columns 16kk .. 16kk+15 are exactly its A fragment
//   for k-step kk). V stays [key][d] in shared memory, which is MN-major
//   for this product; wgmma takes it transposed (16-bit types only).
// - The online softmax runs on the accumulator fragment: a row lives in the
//   four threads of a quad, so its max and sum take two shuffles. No score
//   tile goes through shared memory. exp is exp2 with log2(e) folded into
//   the scale.
// - K and V tiles of BK = 128 keys (64 at MLA's dims) arrive by TMA (cp.async.bulk.tensor with a
//   4-d tensor map per operand, encoded on the host; rows past Sk read as
//   zeros), each 64-column panel one box that the TMA unit writes in the
//   128-byte swizzle, into rings of two stages with an mbarrier per stage.
//   One thread starts every copy; no other thread spends an instruction on
//   them. Tiles stay bf16 in shared memory; Q is loaded once per CTA.
// - Block j's P V runs on the tensor cores while the CUDA cores do the
//   softmax of block j+1, whose Q K^T was started just before it; K_{j+2}
//   and V_{j+1} are in flight meanwhile.
//
// Numerics: P is rounded to bf16 before P V, as the plain version does
// (p.to(v.dtype)) and as SDPA does; the Pallas kernel keeps P in f32. Every
// product sums in f32. Tolerance 2e-2 in bf16 (tests/test_kernels.py).
//
// Layout: one CTA of two warpgroups per (128 q rows, head, batch), each
// warpgroup 64 rows; both read every K/V tile. Under a causal mask the CTA
// stops at the block holding its last row's position, and the mask is
// applied only on blocks that cross the diagonal or the Sk tail. CTAs are
// launched heaviest first (last q block first). q_offset is a runtime
// argument; the Sq and Sk tails are masked here (the TPU kernel asserts
// divisibility).
//
// Tiles, any head dim. The kernel is templated on KS, the k-steps of 16
// columns that Q K^T takes, and DVP, the 64-column panels of V and O. Q
// and K load as ceil(KS / 4) panels. The tensor maps are encoded with the
// true head dims, so where a dim stops short of its last panel (16, 24, 96,
// 288) the box's columns past it lie outside the tensor, and TMA writes
// zeros there (and counts the whole box's bytes): the zero columns of Q
// and K add nothing to Q K^T, and O's zero columns are not stored.
// kernels/flash_attention.launch_plan names the first tile of
// FA_WGMMA_TILES that holds a call's dims, so Dk = 24 takes KS = 2 and Dk =
// 288 takes 18, reading none of the fifth panel's zero columns; the entry
// point launches the tile it is given.
//
// MLA's absorbed dims (288, 256). Bound: operations; at the serve shape (B
// 8, S 2048 causal, 40 heads on one kv head) the products are 730.5 GFLOP
// against 733 MB: 0.739 ms at 989 TFLOP/s, 0.219 ms at 3.35 TB/s. Against
// the 64/128 tiles:
// - Shared memory: at 128 keys a stage, Q, two K and two V stages would
//   take 352 KB. keys_a_stage picks 128 keys a stage where the tiles fit
//   in a block's shared memory, else 64. With 64: Q 128 x 320 x 2 B = 80
//   KB, the K ring 2 x 64 x 320 x 2 B = 80 KB and the V ring 2 x 64 x 256
//   x 2 B = 64 KB, 230,464 bytes with alignment and barriers, under the
//   232,448 a block may use. 128 q rows a CTA stay, so K and V are read by two
//   warpgroups at once as before.
// - O of 64 x 256 f32 is 128 registers a thread; P V is two n128 wgmmas a
//   k-step, on the two halves of O. S of 64 x 64 takes 32.
//
// Measured at the serve shape on an H100 SXM (700 W), in the order the
// design was reached: two warpgroups in lockstep, blocks of 64 keys through
// a cp.async ring, 2.09 ms; one warpgroup per CTA, 1.90 ms; two warpgroups
// again, each with the softmax of j+1 under P_j V_j, blocks of 128 keys,
// 1.63 ms; TMA in place of cp.async (whose address arithmetic and launch
// cost every thread some 16 instructions per block), 1.09 ms. Left for
// later: warp specialisation (a producer warp, so the two warpgroups need
// not meet at a barrier every block), pingpong between the warpgroups,
// persistent CTAs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;
using bf16 = __nv_bfloat16;

constexpr int kWG = 2;         // consumer warpgroups per CTA, 64 q rows each
constexpr int kBQ = 64 * kWG;  // q rows per CTA; keys per kv block: BK (64 or 128)
constexpr int kThreads = 128 * kWG;
constexpr int kStages = 2;     // K ring and V ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 64-column panels that KS k-steps of 16 read (the last one part zeros
// where the head dim stops short of it)
__host__ __device__ constexpr int k_panels(int ks) { return (ks + 3) / 4; }

// shared memory of the tiles, in bytes: + 1024 for alignment; Q, the K
// ring, the V ring (in whole panels), 5 mbarriers
__host__ __device__ constexpr int smem_bytes(int ks, int dvp, int bk) {
  return 1024 + 2 * (kBQ * 64 * k_panels(ks) + kStages * bk * 64 * k_panels(ks) +
                     kStages * bk * 64 * dvp) + 64;
}
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use on Hopper
// keys a stage: 128 where the tiles fit in shared memory, else 64
__host__ __device__ constexpr int keys_a_stage(int ks, int dvp) {
  return smem_bytes(ks, dvp, 128) <= kMaxSmem ? 128 : 64;
}

// Fold a block of raw scores into the running max m2 (log2 units) and sum l
// of this thread's two rows; s becomes exp2(s * scale_log2 - m2), the scale
// folded into one fma. MASK: the block crosses the diagonal or the Sk tail.
// Returns the rescale of each row's earlier accumulator in alpha.
template <int BK, bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], float (&m2)[2],
                                               float (&l)[2], float (&alpha)[2], int k0,
                                               int q0, int r0, int cq, int Sk, int q_offset,
                                               int causal, float scale_log2) {
  if constexpr (MASK) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + cq + (i % 2);
      const int row = q0 + r0 + 8 * ((i / 2) % 2);
      if (key >= Sk || (causal && q_offset + row < key)) s[i] = kNegInf;
    }
  }
  // a row's four owners are one quad
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = kNegInf;
#pragma unroll
    for (int j8 = 0; j8 < BK / 8; ++j8)
      mx = fmaxf(mx, fmaxf(s[4 * j8 + 2 * hr], s[4 * j8 + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m2[hr], mx * scale_log2);
    alpha[hr] = ex2(m2[hr] - m_new);
    m2[hr] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int j8 = 0; j8 < BK / 8; ++j8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(s[4 * j8 + 2 * hr + e], scale_log2, -m_new));
        s[4 * j8 + 2 * hr + e] = p;
        sum += p;
      }
    l[hr] = l[hr] * alpha[hr] + sum;
  }
}

template <int BK>
__device__ __forceinline__ void softmax_block(float (&s)[BK / 2], float (&m2)[2],
                                              float (&l)[2], float (&alpha)[2], int k0, int q0,
                                              int r0, int cq, int Sk, int q_offset, int causal,
                                              float scale_log2) {
  if (k0 + BK > Sk || (causal && k0 + BK - 1 > q_offset + q0))
    online_softmax<BK, true>(s, m2, l, alpha, k0, q0, r0, cq, Sk, q_offset, causal, scale_log2);
  else
    online_softmax<BK, false>(s, m2, l, alpha, k0, q0, r0, cq, Sk, q_offset, causal, scale_log2);
}

// S = Q K^T for one kv block, started and committed (not waited for);
// KS k-steps of 16 columns: columns between Dk and 16 * KS are zeros
template <int KS, int BK>
__device__ __forceinline__ void start_qk(float (&s)[BK / 2], uint32_t Qs, uint32_t kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t col = (kk % 4) * 32;   // 16 elements = 32 bytes into the panel
    wgmma_ss<BK>(s, desc_sw128(Qs + (kk / 4) * (kBQ * 128) + col, 16, 1024),
                 desc_sw128(kt + (kk / 4) * (BK * 128) + col, 16, 1024), kk > 0);
  }
  wgmma_commit();
  fence_regs(s);
}

// O += P V for one kv block, started and committed (not waited for), on
// DVP panels of V (64 * DVP columns of O). Four panels are two n128
// products a k-step, on columns 0..127 and 128..255 of O (accumulator
// elements 0..63 and 64..127: the D layout puts column 8j + c at element
// 4j + c), reading V's panels 0-1 and 2-3.
template <int DVP, int BK>
__device__ __forceinline__ void start_pv(float (&o)[32 * DVP], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vt) {
  static_assert(DVP == 1 || DVP == 2 || DVP == 4, "V is 1, 2 or 4 panels");
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if constexpr (DVP <= 2) {
      wgmma_rs<64 * DVP>(o, pa[kk], desc_sw128(vt + kk * 16 * 128, BK * 128, 1024));
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        wgmma_rs<128>(*reinterpret_cast<float(*)[64]>(o + 64 * c), pa[kk],
                      desc_sw128(vt + c * 2 * BK * 128 + kk * 16 * 128, BK * 128, 1024));
    }
  }
  wgmma_commit();
  fence_regs(o);
}

// KS: k-steps of Q K^T (Dk <= 16 * KS); DVP: 64-column panels of V and O
// (Dv <= 64 * DVP); BK: keys a stage
template <int KS, int DVP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                   float* __restrict__ lse, int Sq, int Sk, int H, int KV, int Dv,
                   int q_offset, int causal, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int PK = k_panels(KS), DV = 64 * DVP;
  constexpr int dk = 64 * PK, dv = DV;                          // in whole panels
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;   // [dk/64][kBQ][128 B]
  const uint32_t Ks = Qs + kBQ * dk * 2;                        // kStages x [dk/64][BK][128 B]
  const uint32_t Vs = Ks + kStages * BK * dk * 2;              // kStages x [dv/64][BK][128 B]
  const uint32_t bars = Vs + kStages * BK * dv * 2;            // Q, K stages, V stages
  const uint32_t qbar = bars, kbar = bars + 8, vbar = kbar + 8 * kStages;
  constexpr int kTileK = BK * dk * 2, kTileV = BK * dv * 2;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  // kv blocks to visit: under a causal mask, up to the block holding the
  // position of this CTA's last row
  int nkb = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = q_offset + min(q0 + kBQ, Sq) - 1;
    nkb = min(nkb, last < 0 ? 0 : last / BK + 1);
  }

  // accumulator fragment: thread holds rows r0 and r0 + 8 of the 64,
  // columns 8j + cq and 8j + cq + 1 (the wgmma D layout)
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int qw0 = q0 + 64 * wg;                  // first row of this warpgroup
  const uint32_t Qw = Qs + 64 * 128 * wg;        // its rows of the Q panels
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
  float m2[2] = {kNegInf, kNegInf};   // running max, in log2 units
  float l[2] = {0.0f, 0.0f};          // this thread's share of the running sum
  float alpha[2];

  // thread 0 starts every copy: Q, then K_j into stage j % 2 and V_j into
  // stage j % 2, each stage with its mbarrier (its n-th fill has parity n & 1)
  const bool copier = tid == 0;
  if (copier) {
    mbar_init(qbar);
    for (int i = 0; i < kStages; ++i) mbar_init(kbar + 8 * i);
    for (int i = 0; i < kStages; ++i) mbar_init(vbar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_k = [&](int j) {
    const uint32_t bar = kbar + 8 * (j % kStages);
    mbar_expect_tx(bar, kTileK);
    tma_tile<BK, PK>(Ks + (j % kStages) * kTileK, &tk, bar, kvh, j * BK, b);
  };
  auto load_v = [&](int j) {
    const uint32_t bar = vbar + 8 * (j % kStages);
    mbar_expect_tx(bar, kTileV);
    tma_tile<BK, DVP>(Vs + (j % kStages) * kTileV, &tv, bar, kvh, j * BK, b);
  };
  if (copier) {
    mbar_expect_tx(qbar, kBQ * dk * 2);
    tma_tile<kBQ, PK>(Qs, &tq, qbar, h, q0, b);
    if (nkb > 0) load_k(0);
    if (nkb > 1) load_k(1);
    if (nkb > 0) load_v(0);
  }

  uint32_t pa[BK / 16][4];
  if (nkb > 0) {   // block 0's scores and softmax before the loop
    mbar_wait(qbar, 0);
    mbar_wait(kbar, 0);
    float s[BK / 2];
    start_qk<KS, BK>(s, Qw, Ks);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_block<BK>(s, m2, l, alpha, 0, qw0, r0, cq, Sk, q_offset, causal, scale_log2);
    to_a_fragments<BK>(s, pa);
    __syncthreads();   // K_0's stage is refilled next
  }

  // step j: O += P_j V_j on the tensor cores while the softmax of block j+1
  // runs on the CUDA cores. No wgmma or wait sits under a branch (ptxas
  // serialises the wgmma pipeline otherwise): the last step is peeled.
  for (int j = 0; j + 1 < nkb; ++j) {
    if (copier) {   // the stages of K_j and V_{j-1} are free (barrier below)
      if (j + 2 < nkb) load_k(j + 2);
      load_v(j + 1);
    }
    const int k1 = (j + 1) * BK;
    mbar_wait(kbar + 8 * ((j + 1) % kStages), ((j + 1) / kStages) & 1);
    mbar_wait(vbar + 8 * (j % kStages), (j / kStages) & 1);

    float s[BK / 2];
    start_qk<KS, BK>(s, Qw, Ks + ((j + 1) % kStages) * kTileK);
    start_pv<DVP, BK>(o, pa, Vs + (j % kStages) * kTileV);
    wgmma_wait<1>();   // S_{j+1} is done; P_j V_j may still run
    fence_regs(s);
    softmax_block<BK>(s, m2, l, alpha, k1, qw0, r0, cq, Sk, q_offset, causal, scale_log2);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int jd = 0; jd < DV / 8; ++jd) {
      o[4 * jd] *= alpha[0];
      o[4 * jd + 1] *= alpha[0];
      o[4 * jd + 2] *= alpha[1];
      o[4 * jd + 3] *= alpha[1];
    }
    to_a_fragments<BK>(s, pa);
    __syncthreads();   // both warpgroups are done with K_j's and V_j's stages
  }
  if (nkb > 0) {   // the last step: P V only
    mbar_wait(vbar + 8 * ((nkb - 1) % kStages), ((nkb - 1) / kStages) & 1);
    start_pv<DVP, BK>(o, pa, Vs + ((nkb - 1) % kStages) * kTileV);
    wgmma_wait<0>();
    fence_regs(o);
  } else {
    mbar_wait(qbar, 0);   // no copy may be in flight when the CTA exits
  }

  // epilogue: a row's sum is spread over its quad
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = qw0 + r0 + 8 * hr;
    if (qi >= Sq) continue;
    const float inv = 1.0f / fmaxf(lr, 1e-30f);
    bf16* orow = out + (((int64_t)b * Sq + qi) * H + h) * Dv;
#pragma unroll
    for (int jd = 0; jd < DV / 8; ++jd)   // columns past Dv (a multiple of 8) are zeros
      if (8 * jd < Dv)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd + cq) =
            __floats2bfloat162_rn(o[4 * jd + 2 * hr] * inv, o[4 * jd + 2 * hr + 1] * inv);
    if (lane % 4 == 0) {
      const float m = m2[hr] == kNegInf ? kNegInf : m2[hr] * kLn2;
      lse[((int64_t)b * H + h) * Sq + qi] = m + logf(fmaxf(lr, 1e-30f));
    }
  }
}

template <int KS, int DVP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
           int Sk, int H, int KV, int Dk, int Dv, int q_offset, int causal, float scale,
           cudaStream_t stream) {
  constexpr int BK = keys_a_stage(KS, DVP);
  constexpr int smem = smem_bytes(KS, DVP, BK);
  static_assert(smem <= kMaxSmem, "tiles exceed the shared memory of a block");
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, B, Sq, H, Dk, kBQ);
  // with no keys, K and V are never read: their maps only need to be valid
  if (!rc)
    rc = Sk ? encode(&tk, k, B, Sk, KV, Dk, BK) : encode(&tk, q, B, Sq, H, Dk, BK);
  if (!rc)
    rc = Sk ? encode(&tv, v, B, Sk, KV, Dv, BK) : encode(&tv, q, B, Sq, H, Dk, BK);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<KS, DVP, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_wgmma_kernel<KS, DVP, BK><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), Sq, Sk, H, KV, Dv,
      q_offset, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

// The instantiated tiles, (k-steps of Q K^T, panels of V), indexed by the
// entry point's `tile`; kernels/flash_attention.WGMMA_TILES mirrors this
// list (a CPU test reads it from here).
#define FA_WGMMA_TILES(X) X(1, 1) X(2, 1) X(4, 1) X(4, 2) X(6, 1) X(8, 1) X(8, 2) X(18, 4)

}  // namespace

// Plain C entry point (bound with ctypes), with the signature of
// flash_attention.cu's. Device pointers to contiguous bf16 (dtype 1)
// q (B,Sq,H,Dk), k (B,Sk,KV,Dk), v (B,Sk,KV,Dv), out (B,Sq,H,Dv), all
// 16-byte aligned, and f32 lse (B,H,Sq). Dk and Dv multiples of 8 (a tensor
// map's row stride is a multiple of 16 bytes). `tile` indexes
// FA_WGMMA_TILES and `smem` is the dynamic shared memory the caller's plan
// gives it; the call runs on that tile if it holds the dims (Dk <= 16 *
// KS, Dv <= 64 * DVP) and its shared bytes are `smem`, else gets
// cudaErrorInvalidValue before any CUDA call. The caller has checked
// shapes, H % KV == 0, q_offset >= 0 and B, H < 65536. Returns the
// driver's error from encoding a tensor map, or the first CUDA error of the
// set-up or the launch, else 0.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* out, void* lse, int B, int Sq, int Sk,
                                            int H, int KV, int Dk, int Dv, int q_offset,
                                            int causal, float scale, int dtype, int tile,
                                            int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (dtype != 1 || Dk <= 0 || Dv <= 0 || Dk % 8 || Dv % 8) return (int)cudaErrorInvalidValue;
  int i = 0;
#define FA_TRY(KS, DVP)                                                                       \
  if (tile == i++)                                                                            \
    return Dk <= 16 * KS && Dv <= 64 * DVP &&                                                 \
                   smem == smem_bytes(KS, DVP, keys_a_stage(KS, DVP))                         \
               ? launch<KS, DVP>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset,       \
                                 causal, scale, s)                                            \
               : (int)cudaErrorInvalidValue;
  FA_WGMMA_TILES(FA_TRY)
#undef FA_TRY
  return (int)cudaErrorInvalidValue;
}
