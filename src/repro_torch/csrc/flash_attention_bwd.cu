// Flash-attention backward on Hopper's tensor cores (sm_90a, wgmma).
//
// Replaces no TPU kernel: the JAX package differentiates its flash
// attention with jnp (src/repro/kernels/ops.py:108, _blockwise_bwd under
// jax.custom_vjp), and the port's plain version of that
// (kernels/flash_attention.plain_bwd) runs as torch ops that take every
// score, probability and product of a 512-key block through device memory
// in f32. This kernel keeps them in registers.
//
// For bf16 q (B,Sq,H,Dk), k (B,Sk,KV,Dk), v (B,Sk,KV,Dv), the forward's out
// (B,Sq,H,Dv) and f32 lse (B,H,Sq), and dout, head h reading kv head
// h / (H/KV), causal (q_offset + i >= j) or full, it computes
//
//     p = exp(s * scale - lse),  s = q . k      (recomputed, f32)
//     delta = rowsum(dout * out)                (f32)
//     ds = p * (dout . v - delta)               (f32)
//     dv = sum over rows of p dout,  dk = scale * sum over rows of ds q,
//     dq = scale * sum over keys of ds k        (f32 sums, bf16 out)
//
// p and ds are rounded to bf16 only as wgmma operands; the plain version
// also rounds s, dout . v and every product to bf16.
//
// Bound: operations. At yi-34b's training shape (B 2, S 4096 causal, 56/8
// heads of 128) the five products a (query, key) pair needs are 1.20
// TFLOP against 0.54 GB of inputs and gradients: 1.216 ms at the 989 TFLOP/s
// bf16 tensor-core peak, 0.16 ms of memory traffic at 3.35 TB/s. So every
// product runs on the tensor cores, and nothing of size Sq x Sk touches
// device memory. Measured there on an H100 SXM (700 W): 3.37 ms, 2.77x the
// bound, ~500 TFLOP/s over the 7 products done; the torch ops took 51.3 ms.
//
// Determinism: no float atomics. dk and dv are sums over query rows, dq a
// sum over keys; one pass over the pairs would have to add each dq from
// many CTAs. So the work is split in two kernels that each own what they
// write, and recompute what they share (s, p, dout . v): 7 products a pair
// instead of 5, every sum in a fixed order, every run bitwise the last.
//
// 1. fa_bwd_prep_kernel: one warp a (b, q, h) row writes delta and
//    lse * log2(e) into (B, H, Sp) f32 arrays, Sp = Sq rounded up to 128;
//    rows past Sq get delta 0 and lse +inf, so their p is exactly 0. Memory
//    bound (reads out and dout once).
// 2. fa_bwd_dkdv_kernel: one CTA of two warpgroups a (128 keys, kv head,
//    batch row), each warpgroup 64 keys; K and V loaded once. The CTA walks
//    the G = H/KV heads of its group and, for each, the q tiles of 64 rows
//    that the causal mask lets reach its keys. A step computes S^T = K Q^T
//    and dP^T = V dO^T (keys as the 64 accumulator rows), p and ds in the
//    accumulator fragments, then dV += P^T dO and dK += dS^T Q with P^T and
//    dS^T as register A operands (the forward's P V trick). Q, dO and the
//    tile's lse and delta arrive by TMA into a ring of three stages; each
//    stage has a full and an empty mbarrier, so the two warpgroups are not
//    held in step and one's exponentials run under the other's products.
//    Key tiles with the most q rows (the first, under a causal mask) are
//    launched first.
// 3. fa_bwd_dq_kernel: one CTA of two warpgroups a (128 q rows, head,
//    batch row), Q and dO loaded once, the key tiles of 64 that the mask
//    lets through in order through a three-stage TMA ring of K and V:
//    S = Q K^T, dP = dO V^T, ds, then dQ += dS K. Last q tiles first.
//
// Every operand tile sits in shared memory in the 128-byte swizzle that TMA
// writes and wgmma's descriptors name (64-column panels of 128-byte rows),
// and each serves both ways it is read: K-major as the B of S or dP, and
// MN-major as the B of dV, dK or dQ. The masks are applied only on tiles
// that cross the diagonal or the Sk tail.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace wg;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // two consumer warpgroups
constexpr int kStages = 3;      // the ring of the operand that streams
constexpr int kKeysKV = 128;    // keys a dK/dV CTA, 64 a warpgroup
constexpr int kRowsKV = 64;     // q rows a dK/dV step
constexpr int kRowsQ = 128;     // q rows a dQ CTA, 64 a warpgroup
constexpr int kKeysQ = 64;      // keys a dQ step
constexpr int kPad = 128;       // the prepared rows are padded to a multiple of this
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int padded(int sq) { return (sq + kPad - 1) / kPad * kPad; }

// shared memory of the two kernels, in bytes: + 1024 for alignment, the
// resident tiles, kStages of the streamed ones (and, for dK/dV, each
// stage's lse and delta), 7 mbarriers
__host__ __device__ constexpr int smem_dkdv(int dk, int dv) {
  return 1024 + 2 * kKeysKV * (dk + dv) + kStages * (2 * kRowsKV * (dk + dv) + 8 * kRowsKV) +
         64;
}
__host__ __device__ constexpr int smem_dq(int dk, int dv) {
  return 1024 + 2 * kRowsQ * (dk + dv) + kStages * 2 * kKeysQ * (dk + dv) + 64;
}
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use on Hopper

// delta and lse in log2 units, row (b, h, q) of the padded (B, H, Sp)
// arrays; one warp a row, lanes over the head dim in a fixed order
__global__ void __launch_bounds__(256)
fa_bwd_prep_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ lse2,
                   float* __restrict__ delta, int B, int Sq, int Sp, int H, int Dv) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;   // (b, q, h), h fastest
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)B * Sp * H) return;
  const int h = (int)(row % H), q = (int)((row / H) % Sp), b = (int)(row / ((int64_t)Sp * H));
  float sum = 0.0f;
  if (q < Sq) {
    const int64_t base = (((int64_t)b * Sq + q) * H + h) * Dv;
    for (int d = 2 * lane; d < Dv; d += 64) {
      const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + base + d));
      const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + base + d));
      sum = fmaf(o.x, g.x, sum);
      sum = fmaf(o.y, g.y, sum);
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) {
    const int64_t at = ((int64_t)b * H + h) * Sp + q;
    delta[at] = q < Sq ? sum : 0.0f;
    lse2[at] = q < Sq ? lse[((int64_t)b * H + h) * Sq + q] * kLog2e : INFINITY;
  }
}

// S (64 x N, f32) = A . B^T over K columns: A rows of 128-byte panels with
// panel stride a_panel, B the same with b_panel; both K-major in shared memory
template <int K, int N>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], uint32_t a, uint32_t a_panel,
                                        uint32_t b, uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;   // 16 elements = 32 bytes into the panel
    wgmma_ss<N>(d, desc_sw128(a + (kk / 4) * a_panel + col, 16, 1024),
                desc_sw128(b + (kk / 4) * b_panel + col, 16, 1024), kk > 0);
  }
}

// D (64 x N, f32) += A (64 x 64, bf16 A fragments) . B, B a tile of 64
// rows (the k index) in N/64 panels of 128-byte rows, MN-major
template <int N>
__device__ __forceinline__ void gemm_rs(float (&d)[N / 2], const uint32_t (&a)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<N>(d, a[kk], desc_sw128(b + kk * 16 * 128, 64 * 128, 1024));
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse2, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Sq, int Sk, int Sp,
                   int H, int KV, int q_offset, int causal, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int PK = DK / 64, PV = DV / 64;
  constexpr int kTileQ = kRowsKV * DK * 2, kTileDO = kRowsKV * DV * 2;
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t Ks = (base + 1023) & ~1023u;         // [PK][128 keys][128 B]
  const uint32_t Vs = Ks + kKeysKV * DK * 2;           // [PV][128 keys][128 B]
  const uint32_t Qs = Vs + kKeysKV * DV * 2;           // kStages x [PK][64 rows][128 B]
  const uint32_t Ds = Qs + kStages * kTileQ;           // kStages x [PV][64 rows][128 B]
  const uint32_t Rs = Ds + kStages * kTileDO;          // kStages x (lse2[64], delta[64])
  const uint32_t kvbar = Rs + kStages * 8 * kRowsKV;   // K and V, then full[], empty[]
  const uint32_t full = kvbar + 8, empty = full + 8 * kStages;
  const float* rows = reinterpret_cast<const float*>(smem_raw + (Rs - base));

  const int tid = threadIdx.x, wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // key tiles outermost, the first (most q rows under a causal mask) first
  const int per = KV * B;
  const int k0 = (blockIdx.x / per) * kKeysKV;
  const int kvh = (blockIdx.x % per) % KV, b = (blockIdx.x % per) / KV;
  const int G = H / KV;

  // q tiles that reach this CTA's keys: under a causal mask, rows from
  // k0 - q_offset on
  const int nqt = (Sq + kRowsKV - 1) / kRowsKV;
  const int first = causal ? min(max(k0 - q_offset, 0) / kRowsKV, nqt) : 0;
  const int nq = nqt - first, n_it = G * nq;

  const bool copier = tid == 0;
  if (copier) {
    mbar_init(kvbar);
    for (int i = 0; i < kStages; ++i) mbar_init(full + 8 * i);
    for (int i = 0; i < kStages; ++i) mbar_init(empty + 8 * i, 8);   // one arrival a warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // step t: head kvh * G + t / nq, q tile first + t % nq, into stage t % kStages
  auto load = [&](int t) {
    const int s = t % kStages, h = kvh * G + t / nq, q0 = (first + t % nq) * kRowsKV;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, kTileQ + kTileDO + 8 * kRowsKV);
    tma_tile<kRowsKV, PK>(Qs + s * kTileQ, &tq, bar, h, q0, b);
    tma_tile<kRowsKV, PV>(Ds + s * kTileDO, &tdo, bar, h, q0, b);
    const int64_t at = ((int64_t)b * H + h) * Sp + q0;
    bulk_load(Rs + s * 8 * kRowsKV, lse2 + at, 4 * kRowsKV, bar);
    bulk_load(Rs + s * 8 * kRowsKV + 4 * kRowsKV, delta + at, 4 * kRowsKV, bar);
  };
  if (copier && n_it > 0) {
    mbar_expect_tx(kvbar, kKeysKV * (DK + DV) * 2);
    tma_tile<kKeysKV, PK>(Ks, &tk, kvbar, kvh, k0, b);
    tma_tile<kKeysKV, PV>(Vs, &tv, kvbar, kvh, k0, b);
    for (int t = 0; t < kStages - 1 && t < n_it; ++t) load(t);
  }

  // accumulator fragment: thread holds rows r0 and r0 + 8 of its
  // warpgroup's 64 keys, columns 8j + cq and 8j + cq + 1 (the wgmma D layout)
  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int kw0 = k0 + 64 * wgi;                       // this warpgroup's first key
  const uint32_t Kw = Ks + 64 * 128 * wgi, Vw = Vs + 64 * 128 * wgi;
  float dka[DK / 2], dva[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dka[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = 0.0f;
  if (n_it > 0) mbar_wait(kvbar, 0);

  for (int t = 0; t < n_it; ++t) {
    const int s = t % kStages;
    if (copier && t + kStages - 1 < n_it) {   // refill the stage step t - 1 used
      const int u = t + kStages - 1;
      if (u >= kStages) mbar_wait(empty + 8 * (u % kStages), (u / kStages - 1) & 1);
      load(u);
    }
    __syncwarp();
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    const int q0 = (first + t % nq) * kRowsKV;
    const uint32_t Qt = Qs + s * kTileQ, Dt = Ds + s * kTileDO;

    // S^T = K Q^T and dP^T = V dO^T, keys as rows
    float st[32], dpt[32];
    wgmma_fence();
    gemm_ss<DK, 64>(st, Kw, kKeysKV * 128, Qt, kRowsKV * 128);
    gemm_ss<DV, 64>(dpt, Vw, kKeysKV * 128, Dt, kRowsKV * 128);
    wgmma_commit();
    fence_regs(st);
    fence_regs(dpt);
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // p and ds; column c is q row q0 + c, whose lse and delta the stage holds
    const float* lrow = rows + s * 2 * kRowsKV;
    const bool mask = causal && q_offset + q0 < kw0 + 63;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j8 + cq + e;
        const float l2 = lrow[c], dl = lrow[kRowsKV + c];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = 4 * j8 + 2 * hr + e;
          float p = ex2(fmaf(st[i], scale_log2, -l2));
          if (mask && q_offset + q0 + c < kw0 + r0 + 8 * hr) p = 0.0f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - dl);
        }
      }
    uint32_t pa[4][4], da[4][4];
    to_a_fragments<64>(st, pa);
    to_a_fragments<64>(dpt, da);

    // dV += P^T dO, dK += dS^T Q
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    gemm_rs<DV>(dva, pa, Dt);
    gemm_rs<DK>(dka, da, Qt);
    wgmma_commit();
    fence_regs(dva);
    fence_regs(dka);
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp is done with stage s
  }

  // epilogue: rows past Sk are not stored
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = kw0 + r0 + 8 * hr;
    if (key >= Sk) continue;
    const int64_t at = ((int64_t)b * Sk + key) * KV + kvh;
    bf16* vrow = dv + at * DV;
    bf16* krow = dk + at * DK;
#pragma unroll
    for (int jd = 0; jd < DV / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * jd + cq) =
          __floats2bfloat162_rn(dva[4 * jd + 2 * hr], dva[4 * jd + 2 * hr + 1]);
#pragma unroll
    for (int jd = 0; jd < DK / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * jd + cq) =
          __floats2bfloat162_rn(dka[4 * jd + 2 * hr] * scale, dka[4 * jd + 2 * hr + 1] * scale);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse2, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int B, int Sq, int Sk, int Sp, int H, int KV,
                 int q_offset, int causal, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int PK = DK / 64, PV = DV / 64;
  constexpr int kTileK = kKeysQ * DK * 2, kTileV = kKeysQ * DV * 2;
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;   // [PK][128 rows][128 B]
  const uint32_t Ds = Qs + kRowsQ * DK * 2;                    // [PV][128 rows][128 B]
  const uint32_t Ks = Ds + kRowsQ * DV * 2;                    // kStages x [PK][64 keys][128 B]
  const uint32_t Vs = Ks + kStages * kTileK;                   // kStages x [PV][64 keys][128 B]
  const uint32_t qbar = Vs + kStages * kTileV;                 // Q and dO, then full[], empty[]
  const uint32_t full = qbar + 8, empty = full + 8 * kStages;

  const int tid = threadIdx.x, wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // q tiles outermost, the last (most keys under a causal mask) first
  const int per = H * B, nqt = (Sq + kRowsQ - 1) / kRowsQ;
  const int q0 = (nqt - 1 - (int)(blockIdx.x / per)) * kRowsQ;
  const int h = (blockIdx.x % per) % H, b = (blockIdx.x % per) / H;
  const int kvh = h / (H / KV);

  // key tiles to visit: under a causal mask, up to the one holding the
  // position of this CTA's last row
  int nk = (Sk + kKeysQ - 1) / kKeysQ;
  if (causal) {
    const int last = q_offset + min(q0 + kRowsQ, Sq) - 1;
    nk = min(nk, last < 0 ? 0 : last / kKeysQ + 1);
  }

  const bool copier = tid == 0;
  if (copier) {
    mbar_init(qbar);
    for (int i = 0; i < kStages; ++i) mbar_init(full + 8 * i);
    for (int i = 0; i < kStages; ++i) mbar_init(empty + 8 * i, 8);   // one arrival a warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int j) {
    const int s = j % kStages;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, kTileK + kTileV);
    tma_tile<kKeysQ, PK>(Ks + s * kTileK, &tk, bar, kvh, j * kKeysQ, b);
    tma_tile<kKeysQ, PV>(Vs + s * kTileV, &tv, bar, kvh, j * kKeysQ, b);
  };
  if (copier && nk > 0) {
    mbar_expect_tx(qbar, kRowsQ * (DK + DV) * 2);
    tma_tile<kRowsQ, PK>(Qs, &tq, qbar, h, q0, b);
    tma_tile<kRowsQ, PV>(Ds, &tdo, qbar, h, q0, b);
    for (int j = 0; j < kStages - 1 && j < nk; ++j) load(j);
  }

  const int r0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int qw0 = q0 + 64 * wgi;                       // this warpgroup's first row
  const uint32_t Qw = Qs + 64 * 128 * wgi, Dw = Ds + 64 * 128 * wgi;
  float l2[2], dl[2];                                  // rows r0 and r0 + 8
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t at = ((int64_t)b * H + h) * Sp + qw0 + r0 + 8 * hr;   // < Sp: padded to 128
    l2[hr] = lse2[at];
    dl[hr] = delta[at];
  }
  float dqa[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dqa[i] = 0.0f;
  if (nk > 0) mbar_wait(qbar, 0);

  for (int j = 0; j < nk; ++j) {
    const int s = j % kStages;
    if (copier && j + kStages - 1 < nk) {   // refill the stage step j - 1 used
      const int u = j + kStages - 1;
      if (u >= kStages) mbar_wait(empty + 8 * (u % kStages), (u / kStages - 1) & 1);
      load(u);
    }
    __syncwarp();
    mbar_wait(full + 8 * s, (j / kStages) & 1);
    const int k0 = j * kKeysQ;
    const uint32_t Kt = Ks + s * kTileK, Vt = Vs + s * kTileV;

    // S = Q K^T and dP = dO V^T
    float sa[32], dpa[32];
    wgmma_fence();
    gemm_ss<DK, 64>(sa, Qw, kRowsQ * 128, Kt, kKeysQ * 128);
    gemm_ss<DV, 64>(dpa, Dw, kRowsQ * 128, Vt, kKeysQ * 128);
    wgmma_commit();
    fence_regs(sa);
    fence_regs(dpa);
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(dpa);

    // ds; column c is key k0 + c
    const bool mask = k0 + kKeysQ > Sk || (causal && k0 + kKeysQ - 1 > q_offset + qw0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i / 2) % 2, key = k0 + 8 * (i / 4) + cq + (i % 2);
      float p = ex2(fmaf(sa[i], scale_log2, -l2[hr]));
      if (mask && (key >= Sk || (causal && q_offset + qw0 + r0 + 8 * hr < key))) p = 0.0f;
      dpa[i] = p * (dpa[i] - dl[hr]);
    }
    uint32_t da[4][4];
    to_a_fragments<64>(dpa, da);

    // dQ += dS K
    fence_regs(dqa);
    wgmma_fence();
    gemm_rs<DK>(dqa, da, Kt);
    wgmma_commit();
    fence_regs(dqa);
    wgmma_wait<0>();
    fence_regs(dqa);
    if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp is done with stage s
  }

  // epilogue: rows past Sq are not stored
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = qw0 + r0 + 8 * hr;
    if (qi >= Sq) continue;
    bf16* row = dq + (((int64_t)b * Sq + qi) * H + h) * DK;
#pragma unroll
    for (int jd = 0; jd < DK / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * jd + cq) =
          __floats2bfloat162_rn(dqa[4 * jd + 2 * hr] * scale, dqa[4 * jd + 2 * hr + 1] * scale);
  }
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, void* dq, void* dk, void* dv, void* lse2, void* delta, int B, int Sq,
           int Sk, int H, int KV, int q_offset, int causal, float scale, cudaStream_t stream) {
  constexpr int sm_kv = smem_dkdv(DK, DV), sm_q = smem_dq(DK, DV);
  static_assert(sm_kv <= kMaxSmem && sm_q <= kMaxSmem,
                "tiles exceed the shared memory of a block");
  const int Sp = padded(Sq);
  // each kernel's maps, boxes of the rows it loads at a time
  CUtensorMap kv_q, kv_k, kv_v, kv_do, q_q, q_k, q_v, q_do;
  int rc = encode(&kv_q, q, B, Sq, H, DK, kRowsKV);
  if (!rc) rc = encode(&kv_do, dout, B, Sq, H, DV, kRowsKV);
  if (!rc) rc = encode(&kv_k, k, B, Sk, KV, DK, kKeysKV);
  if (!rc) rc = encode(&kv_v, v, B, Sk, KV, DV, kKeysKV);
  if (!rc) rc = encode(&q_q, q, B, Sq, H, DK, kRowsQ);
  if (!rc) rc = encode(&q_do, dout, B, Sq, H, DV, kRowsQ);
  if (!rc) rc = encode(&q_k, k, B, Sk, KV, DK, kKeysQ);
  if (!rc) rc = encode(&q_v, v, B, Sk, KV, DV, kKeysQ);
  if (rc) return rc;
  const float scale_log2 = scale * kLog2e;
  auto* lse2_f = static_cast<float*>(lse2);
  auto* delta_f = static_cast<float*>(delta);

  const int64_t prep_rows = (int64_t)B * Sp * H;
  fa_bwd_prep_kernel<<<(unsigned)((prep_rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), lse2_f, delta_f, B, Sq, Sp, H, DV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, sm_q);
  if (err != cudaSuccess) return (int)err;
  const int64_t dq_ctas = (int64_t)((Sq + kRowsQ - 1) / kRowsQ) * H * B;
  fa_bwd_dq_kernel<DK, DV><<<(unsigned)dq_ctas, kThreads, sm_q, stream>>>(
      q_q, q_k, q_v, q_do, lse2_f, delta_f, static_cast<bf16*>(dq), B, Sq, Sk, Sp, H, KV,
      q_offset, causal, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, sm_kv);
  if (err != cudaSuccess) return (int)err;
  const int64_t kv_ctas = (int64_t)((Sk + kKeysKV - 1) / kKeysKV) * KV * B;
  fa_bwd_dkdv_kernel<DK, DV><<<(unsigned)kv_ctas, kThreads, sm_kv, stream>>>(
      kv_q, kv_k, kv_v, kv_do, lse2_f, delta_f, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, Sq, Sk, Sp, H, KV, q_offset, causal, scale, scale_log2);
  return (int)cudaGetLastError();
}

// The instantiated head dims (Dk, Dv), the ones the entry point launches;
// kernels/flash_attention.BWD_DIMS mirrors this list (a CPU test reads it
// from here).
#define FA_BWD_DIMS(X) X(64, 64) X(64, 128) X(128, 64) X(128, 128)

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers to contiguous
// bf16 q (B,Sq,H,Dk), k (B,Sk,KV,Dk), v (B,Sk,KV,Dv), out and dout
// (B,Sq,H,Dv), dq, dk, dv shaped as q, k, v, all 16-byte aligned; f32 lse
// (B,H,Sq) from the forward; f32 workspaces lse2 and delta of (B,H,Sp)
// elements, Sp = Sq rounded up to 128 (written here). (Dk, Dv) not in
// FA_BWD_DIMS gives cudaErrorInvalidValue before any CUDA call, as Sq or
// Sk of 0 does. The caller has checked
// shapes, H % KV == 0 and q_offset >= 0. Launches three kernels on
// `stream`; returns the driver's error from encoding a tensor map, or the
// first CUDA error of a set-up or launch, else 0.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* dq, void* dk, void* dv, void* lse2, void* delta,
                                          int B, int Sq, int Sk, int H, int KV, int Dk, int Dv,
                                          int q_offset, int causal, float scale,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
#define FA_TRY(DK, DV)                                                                     \
  if (Dk == DK && Dv == DV)                                                                \
    return launch<DK, DV>(q, k, v, out, dout, lse, dq, dk, dv, lse2, delta, B, Sq, Sk, H,  \
                          KV, q_offset, causal, scale, s);
  FA_BWD_DIMS(FA_TRY)
#undef FA_TRY
  return (int)cudaErrorInvalidValue;
}
