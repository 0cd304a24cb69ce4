// Flash-attention forward on Hopper's tensor cores in f32: 3xTF32 on
// mma.sync (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:30 (_fwd_kernel) for f32 inputs, and
// for bf16 inputs whose head dims the wgmma kernel (flash_attention_wgmma.cu)
// does not take: dims that are not multiples of 8, or Dv above 256
// (kernels/flash_attention.launch_plan decides). For q (B,Sq,H,Dk),
// k (B,Sk,KV,Dk), v (B,Sk,KV,Dv), head h reading kv head h / (H/KV) (GQA by
// index; the group need not be a power of two), it computes per row
//
//     s = (q . k) * scale, masked to -1e30 where causal and q_offset+i < j
//     online softmax over kv blocks: m, l, acc = acc * alpha + p . v
//     out = acc / max(l, 1e-30)   (in q's type)
//     lse = m + log(max(l, 1e-30))   (f32, (B,H,Sq), for the backward)
//
// with f32 products, as the Pallas kernel computes them (.astype(float32)
// inside), for head dims up to 288 (MLA's absorbed Dk).
//
// Bound: operations. At yi-34b's serve shape in f32 (B 8, S 2048 causal,
// 56/8 heads of 128) the two products are 481 GFLOP against 1.07 GB: 7.18
// ms at the 67 TFLOP/s of an H100 SXM's CUDA cores in f32, 2.92 ms for the
// three passes below (1,443 GFLOP) at its 495 TFLOP/s dense TF32
// tensor-core rate, 0.32 ms of memory traffic at 3.35 TB/s. So both
// products run on the tensor cores, in TF32 with three passes:
//
// - The split. One TF32 product keeps 11 bits of each operand: raw
//   scores of ~17 (288-wide unit rows, MLA's scale) then miss f32 by far
//   more than the 2e-5 tolerance. Each f32 operand x becomes hi =
//   rna_tf32(x) and lo = rna_tf32(x - hi) (cvt.rna.tf32.f32's value), and
//   each product is lo*hi + hi*lo + hi*hi, summed in f32 in the tensor
//   core's accumulator (small terms first); the dropped lo*lo is 2^-22 of
//   the product. This covers Q K^T and P V, with P kept in f32 before its
//   split. A bf16 value is exact in TF32 (8 of 11 bits), so bf16 inputs
//   take one pass for Q K^T and two for P V (P's lo against V).
// - Why mma.sync and not wgmma. wgmma takes .tf32 operands K-major only
//   (the transposed layout is for 16-bit types) and cannot split a
//   shared-memory operand on the fly: V ([key][d], MN-major for P V) would
//   be transposed every block into V^T hi and lo tiles, K stored twice, and
//   TMA would take only dims that are multiples of 4; at MLA's 288/256 the
//   hi and lo tiles exceed a block's shared memory. mma.sync.m16n8k8.tf32
//   takes its fragments from registers, so the split costs a few
//   instructions an element, any layout of V is free, and one kernel takes
//   every dim up to 288 (columns past a dim are zero-padded) in both
//   dtypes. Its cost: one 16 x 8 x 8 product an instruction, so the three
//   passes and the splits share the same issue slots. At yi-34b's serve
//   shape in f32 that keeps it above the f32 CUDA-core bound (PERF.md). No
//   path of the port launches f32 at head dims wgmma could take (its f32
//   models are the reduced configs, head dims 16 and 24), so no wgmma
//   variant is kept for them.
//
// Design:
// - Fragments without transposes. Each product's k index may be permuted
//   as long as A and B agree. In Q K^T, thread (g, t) of a warp reads Q
//   and K columns 4t .. 4t+3 of each 16-column slice as one 16-byte load
//   (8 bytes in bf16), which serves two k-steps: k = t and t + 4 are
//   columns 4t and 4t+1 in the first, 4t+2 and 4t+3 in the second. In P V
//   the k index is the key: the S accumulator holds keys 2t and 2t+1 of
//   each 8, so P's A fragment is that accumulator as it stands (k = t is
//   key 2t, k = t + 4 key 2t+1) and V's B fragment reads those two rows.
// - The online softmax runs on the accumulator fragments: a row lives in
//   the four threads of a quad, so its max and sum take two shuffles, and
//   no score tile goes through shared memory. exp is exp2 with log2(e)
//   folded into the scale.
// - K and V stream through a cp.async ring of one K and one V buffer
//   (16-byte copies where rows and pointers allow, else 8-, 4- or, for odd
//   bf16 dims, 2-byte ones; rows past Sk are zero-filled by the copy). V_j
//   loads while the warps compute Q K_j^T and its softmax, K_{j+1} while
//   they compute P V_j: two barriers a block. Tile rows are padded so that
//   the fragment loads hit distinct banks: Q and K rows of 16 * sizeof(T)
//   (mod 128) bytes, V rows of 16 (mod 64). Columns past Dk and Dv are
//   zeroed once and never written again.
// - Each warp holds MT m-tiles of 16 rows (MT = 2 where O fits in
//   registers, Dv <= 128), so every K and V fragment it loads and splits
//   serves 3 * MT products.
// - Layout: one CTA of four warps per tile of 64 * MT rows, per kv head
//   and batch. A tile's rows are QP query positions of HG heads of one GQA
//   group (QP * HG = 64 * MT, QP the power of two at or above Sq up to 64 *
//   MT): at prefill a tile is one head's 64 * MT positions; at a short Sq
//   it holds several heads of the group, which then share every K and V
//   tile (40 heads of MLA's absorbed form at one query row: one CTA).
//   Under a causal mask the CTA stops at the block holding its last
//   position, a warp skips the blocks that lie wholly past its own rows,
//   and the mask is applied only on blocks that cross the diagonal or the
//   Sk tail. CTAs are launched heaviest first (last q tile first).
//   q_offset is a runtime argument; the Sq and Sk tails are masked here
//   (the TPU kernel asserts divisibility).
// - Tiles: FA_TF32X3_TILES (Dk, Dv, MT, keys a block) below. The caller
//   names the tile (kernels/flash_attention.launch_plan, whose
//   TF32X3_TILES a CPU test holds to this list) and its shared bytes; the
//   entry point launches that tile or refuses. Shared memory (f32): 109,056
//   bytes at 128/128 (two CTAs an SM), 150,016 at MLA's 288/256.

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 288;          // MLA's absorbed Dk (kv_lora_rank 256 + rope 32)
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use on Hopper
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The instantiated tiles, indexed by the entry point's `tile`: Dk and Dv
// the tile holds, m-tiles of 16 rows a warp, keys a block
#define FA_TF32X3_TILES(X) \
  X(32, 32, 2, 64) X(64, 64, 2, 64) X(128, 64, 2, 32) X(128, 128, 2, 32) \
  X(288, 128, 2, 16) X(288, 256, 1, 32) X(288, 288, 1, 32)

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// row stride (elements) of a Q or K tile holding dk columns: at least dk
// rounded to 16, and 16 * esize (mod 128) bytes
__host__ __device__ constexpr int ld_qk(int dk, int esize) {
  const int unit = 128 / esize, w = round_up(dk, 16);
  return w + ((16 - w) % unit + unit) % unit;
}
// row stride (elements) of a V tile holding dv columns: 16 (mod 64) bytes
__host__ __device__ constexpr int ld_v(int dv, int esize) {
  const int unit = 64 / esize, w = round_up(dv, 8);
  return w + ((16 / esize - w) % unit + unit) % unit;
}
__host__ __device__ constexpr int rows_of(int mt) { return 16 * mt * kWarps; }
__host__ __device__ constexpr int smem_bytes(int dk, int dv, int mt, int bk, int esize) {
  return esize * (rows_of(mt) * ld_qk(dk, esize) + bk * ld_qk(dk, esize) + bk * ld_v(dv, esize));
}

// one chunk of vb bytes from global to shared memory; zeros where !ok
// (the source is then not read). vb 16, 8 and 4 are cp.async; 2 (bf16 rows
// of an odd length) a plain load and store.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, bool ok, int vb) {
  const uint32_t d = smem_u32(dst);
  const int n = ok ? vb : 0;
  if (vb == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else if (vb == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else if (vb == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    *dst = ok ? *src : from_f<T>(0.0f);
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// rows [0, rows) of a K or V tile: row r is key k0 + r (zeros past Sk), D
// elements of which sit at src + key * stride
template <typename T>
__device__ __forceinline__ void load_kv(T* dst, int ld, const T* src, int64_t stride, int k0,
                                        int Sk, int rows, int D, int vb) {
  const int per_row = D * (int)sizeof(T) / vb, elems = vb / (int)sizeof(T);
  // chunk i is row i / per_row, column chunk i % per_row: stepped, not divided
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const bool ok = k0 + r < Sk;
    copy_chunk(dst + r * ld + c * elems,
               src + (ok ? (int64_t)(k0 + r) * stride : 0) + c * elems, ok, vb);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// zero columns [from, ld) of `rows` rows (tile columns past the head dim)
template <typename T>
__device__ __forceinline__ void zero_cols(T* dst, int ld, int rows, int from) {
  const int w = ld - from;
  for (int i = threadIdx.x; i < rows * w; i += kThreads)
    dst[(i / w) * ld + from + i % w] = from_f<T>(0.0f);
}

// four consecutive elements as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// cvt.rna.tf32.f32 (to nearest, ties away from zero, on the 10 mantissa
// bits TF32 keeps) in two integer instructions: add half of the dropped
// 13 bits' range to the magnitude, then clear them. Same value for every
// finite x, and cheaper than the cvt on sm_90a.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo in TF32 where SPLIT (f32 inputs); a bf16 value is exact in
// TF32, and lo is then never read
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
  }
}

// D (16 x 8, f32) += A (16 x 8, tf32) . B (8 x 8, tf32)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// DK, DV: the head dims the tile holds (Dk <= DK, Dv <= DV); MT: m-tiles a
// warp; BK: keys a block. qp, hg: query positions and heads of a tile.
// vb: bytes a copy moves.
template <typename T, int DK, int DV, int MT, int BK>
__global__ void __launch_bounds__(kThreads)
flash_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                    int Dk, int Dv, int q_offset, int causal, float scale_log2, int qp, int hg,
                    int vb) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int ES = sizeof(T), ROWS = rows_of(MT), NV = DV / 8, NS = BK / 8;
  constexpr int LDQ = ld_qk(DK, ES), LDV = ld_v(DV, ES);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [ROWS][LDQ]
  T* Ks = Qs + ROWS * LDQ;                    // [BK][LDQ]
  T* Vs = Ks + BK * LDQ;                      // [BK][LDV]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int G = H / KV, ngrp = (G + hg - 1) / hg;
  const int kvh = blockIdx.y / ngrp, h0 = kvh * G + (blockIdx.y % ngrp) * hg;
  const int hend = min(h0 + hg, (kvh + 1) * G);   // heads h0 .. hend-1 of the group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * qp;   // heaviest first
  const int b = blockIdx.z;
  const int npos = min(qp, Sq - q0);

  // kv blocks to visit: under a causal mask, up to the block holding the
  // position of this tile's last row
  int nkb = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = q_offset + q0 + npos - 1;
    nkb = min(nkb, last < 0 ? 0 : last / BK + 1);
  }

  // the padding columns, then Q (row r: position q0 + r % qp of head
  // h0 + r / qp) and K_0, as one group of copies
  zero_cols(Qs, LDQ, ROWS, Dk);
  zero_cols(Ks, LDQ, BK, Dk);
  zero_cols(Vs, LDV, BK, Dv);
  {
    const int per_row = Dk * ES / vb, elems = vb / ES;
    for (int i = tid; i < ROWS * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * elems;
      const int pos = q0 + r % qp, head = h0 + r / qp;
      const bool ok = pos < Sq && head < hend;
      copy_chunk(Qs + r * LDQ + c,
                 q + (ok ? (((int64_t)b * Sq + pos) * H + head) * Dk : 0) + c, ok, vb);
    }
  }
  const T* kbase = k + ((int64_t)b * Sk * KV + kvh) * Dk;   // key 0 of this kv head
  const T* vbase = v + ((int64_t)b * Sk * KV + kvh) * Dv;
  if (nkb > 0) load_kv(Ks, LDQ, kbase, (int64_t)KV * Dk, 0, Sk, BK, Dk, vb);
  cp_commit();

  // this warp's rows: rb .. rb + 16 * MT - 1; a thread holds rows
  // rb + 16 mi + g and + 8 of each m-tile mi (the mma accumulator layout)
  const int rb = warp * 16 * MT;
  int wlo, whi;   // the positions of the warp's rows
  if (qp >= 16 * MT) {
    wlo = q0 + rb % qp;
    whi = min(wlo + 16 * MT, q0 + npos) - 1;
  } else {
    wlo = q0;
    whi = q0 + npos - 1;
  }
  const bool live = h0 + rb / qp < hend && whi >= wlo;
  int qpos[MT][2];   // global positions of this thread's rows
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) qpos[mi][hh] = q_offset + q0 + (rb + 16 * mi + g + 8 * hh) % qp;

  float o[MT][NV][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][u][e] = 0.0f;
  float m2[MT][2], l[MT][2];   // running max (log2 units), this thread's share of the sum
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m2[mi][hh] = kNegInf;
      l[mi][hh] = 0.0f;
    }
  const int npairs = (Dk + 15) / 16;

  for (int j = 0; j < nkb; ++j) {
    const int k0 = j * BK;
    cp_wait_all();
    __syncthreads();   // K_j (and Q) landed; every warp is done with V_{j-1}
    load_kv(Vs, LDV, vbase, (int64_t)KV * Dv, k0, Sk, BK, Dv, vb);
    cp_commit();

    const bool busy = live && !(causal && k0 > q_offset + whi);
    float s[MT][NS][4];
    if (busy) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][n][e] = 0.0f;
      // S = Q K_j^T over 16-column slices p, two k-steps each; the three
      // products go out in turn over every accumulator, so that no mma
      // waits on the one before it
      for (int p = 0; p < npairs; ++p) {
        float4 xq[MT][2], yk[NS];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const T* qr = Qs + (rb + 16 * mi + g) * LDQ + 16 * p + 4 * t;
          xq[mi][0] = ld4(qr);              // row g
          xq[mi][1] = ld4(qr + 8 * LDQ);    // row g + 8
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) yk[n] = ld4(Ks + (8 * n + g) * LDQ + 16 * p + 4 * t);
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          uint32_t ah[MT][4], al[MT][4], bh[NS][2], bl[NS][2];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            split<SPLIT>(st ? xq[mi][0].z : xq[mi][0].x, ah[mi][0], al[mi][0]);
            split<SPLIT>(st ? xq[mi][1].z : xq[mi][1].x, ah[mi][1], al[mi][1]);
            split<SPLIT>(st ? xq[mi][0].w : xq[mi][0].y, ah[mi][2], al[mi][2]);
            split<SPLIT>(st ? xq[mi][1].w : xq[mi][1].y, ah[mi][3], al[mi][3]);
          }
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            split<SPLIT>(st ? yk[n].z : yk[n].x, bh[n][0], bl[n][0]);
            split<SPLIT>(st ? yk[n].w : yk[n].y, bh[n][1], bl[n][1]);
          }
          if constexpr (SPLIT) {
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
              for (int n = 0; n < NS; ++n) mma(s[mi][n], al[mi], bh[n][0], bh[n][1]);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
              for (int n = 0; n < NS; ++n) mma(s[mi][n], ah[mi], bl[n][0], bl[n][1]);
          }
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int n = 0; n < NS; ++n) mma(s[mi][n], ah[mi], bh[n][0], bh[n][1]);
        }
      }

      // online softmax of this thread's rows; a row's four owners are a quad
      float alphas[MT][2];
      const bool mask = k0 + BK > Sk || (causal && k0 + BK - 1 > q_offset + wlo);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (mask) {
#pragma unroll
            for (int n = 0; n < NS; ++n)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = k0 + 8 * n + 2 * t + e;
                if (key >= Sk || (causal && qpos[mi][hh] < key)) s[mi][n][2 * hh + e] = kNegInf;
              }
          }
          float mx = kNegInf;
#pragma unroll
          for (int n = 0; n < NS; ++n)
            mx = fmaxf(mx, fmaxf(s[mi][n][2 * hh], s[mi][n][2 * hh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m2[mi][hh], mx * scale_log2);
          const float alpha = ex2(m2[mi][hh] - m_new);
          m2[mi][hh] = m_new;
          float sum = 0.0f;
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pe = ex2(fmaf(s[mi][n][2 * hh + e], scale_log2, -m_new));
              s[mi][n][2 * hh + e] = pe;
              sum += pe;
            }
          l[mi][hh] = l[mi][hh] * alpha + sum;
          alphas[mi][hh] = alpha;
        }
      // O's rescale, skipped where no row's max moved (alpha 1 exactly)
      bool same = true;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) same = same && alphas[mi][0] == 1.0f && alphas[mi][1] == 1.0f;
      if (!__all_sync(0xffffffffu, same)) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int u = 0; u < NV; ++u) {
            o[mi][u][0] *= alphas[mi][0];
            o[mi][u][1] *= alphas[mi][0];
            o[mi][u][2] *= alphas[mi][1];
            o[mi][u][3] *= alphas[mi][1];
          }
      }
    }

    cp_wait_all();
    __syncthreads();   // V_j landed; every warp is done with K_j
    if (j + 1 < nkb) load_kv(Ks, LDQ, kbase, (int64_t)KV * Dk, k0 + BK, Sk, BK, Dk, vb);
    cp_commit();

    if (busy) {
      // O += P V_j, a k-step per 8 keys: P's A fragment is S's accumulator
      // (k = t: key 2t, k = t + 4: key 2t + 1), V's B fragment rows 2t, 2t+1
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          split<true>(s[mi][n][0], ph[mi][0], pl[mi][0]);
          split<true>(s[mi][n][2], ph[mi][1], pl[mi][1]);
          split<true>(s[mi][n][1], ph[mi][2], pl[mi][2]);
          split<true>(s[mi][n][3], ph[mi][3], pl[mi][3]);
        }
        const T* vr = Vs + (8 * n + 2 * t) * LDV + g;
        static_assert(NV % 4 == 0, "O's column tiles go in groups of 4");
#pragma unroll
        for (int u0 = 0; u0 < NV; u0 += 4) {   // four column tiles, each product over all
          uint32_t vh[4][2], vl[4][2];
#pragma unroll
          for (int uu = 0; uu < 4; ++uu) {
            split<SPLIT>(to_f(vr[8 * (u0 + uu)]), vh[uu][0], vl[uu][0]);
            split<SPLIT>(to_f(vr[LDV + 8 * (u0 + uu)]), vh[uu][1], vl[uu][1]);
          }
#pragma unroll
          for (int uu = 0; uu < 4; ++uu)
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) mma(o[mi][u0 + uu], pl[mi], vh[uu][0], vh[uu][1]);
          if constexpr (SPLIT) {
#pragma unroll
            for (int uu = 0; uu < 4; ++uu)
#pragma unroll
              for (int mi = 0; mi < MT; ++mi) mma(o[mi][u0 + uu], ph[mi], vl[uu][0], vl[uu][1]);
          }
#pragma unroll
          for (int uu = 0; uu < 4; ++uu)
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) mma(o[mi][u0 + uu], ph[mi], vh[uu][0], vh[uu][1]);
        }
      }
    }
  }
  cp_wait_all();   // no copy may be in flight when the CTA exits

  // epilogue: a row's sum is spread over its quad
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lr = l[mi][hh];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int r = rb + 16 * mi + g + 8 * hh;
      const int pos = q0 + r % qp, head = h0 + r / qp;
      if (pos >= Sq || head >= hend) continue;
      const float inv = 1.0f / fmaxf(lr, 1e-30f);
      T* orow = out + (((int64_t)b * Sq + pos) * H + head) * Dv;
#pragma unroll
      for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * u + 2 * t + e;
          if (c < Dv) orow[c] = from_f<T>(o[mi][u][2 * hh + e] * inv);
        }
      if (t == 0) {
        const float m = m2[mi][hh] == kNegInf ? kNegInf : m2[mi][hh] * kLn2;
        lse[((int64_t)b * H + head) * Sq + pos] = m + logf(fmaxf(lr, 1e-30f));
      }
    }
}

// the widest copy that rows of Dk and Dv elements and the pointers allow
int copy_bytes(int Dk, int Dv, int esize, const void* const* ptrs) {
  for (int vb = 16; vb > esize; vb /= 2) {
    bool ok = (Dk * esize) % vb == 0 && (Dv * esize) % vb == 0;
    for (int i = 0; i < 3; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % vb == 0;
    if (ok) return vb;
  }
  return esize == 4 ? 4 : 2;
}

template <typename T, int DK, int DV, int MT, int BK>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
           int Sk, int H, int KV, int Dk, int Dv, int q_offset, int causal, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes(DK, DV, MT, BK, sizeof(T));
  static_assert(smem <= kMaxSmem, "tiles exceed the shared memory of a block");
  constexpr int rows = rows_of(MT);
  const void* ptrs[3] = {q, k, v};
  const int vb = copy_bytes(Dk, Dv, sizeof(T), ptrs);
  // a tile: qp positions of hg heads, qp the power of two at or above Sq
  // (at most the tile's rows)
  int qp = 1;
  while (qp < Sq && qp < rows) qp *= 2;
  const int hg = rows / qp, G = H / KV;
  cudaError_t err = cudaFuncSetAttribute(flash_tf32x3_kernel<T, DK, DV, MT, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + qp - 1) / qp, KV * ((G + hg - 1) / hg), B);
  flash_tf32x3_kernel<T, DK, DV, MT, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, H, KV, Dk, Dv, q_offset, causal,
      scale * kLog2e, qp, hg, vb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                int Sq, int Sk, int H, int KV, int Dk, int Dv, int q_offset, int causal,
                float scale, int tile, int smem, cudaStream_t s) {
  int i = 0;
#define FA_TRY(DK, DV, MT, BK)                                                                \
  if (tile == i++)                                                                            \
    return Dk <= DK && Dv <= DV && smem == smem_bytes(DK, DV, MT, BK, sizeof(T))              \
               ? launch<T, DK, DV, MT, BK>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv,       \
                                           q_offset, causal, scale, s)                        \
               : (int)cudaErrorInvalidValue;
  FA_TF32X3_TILES(FA_TRY)
#undef FA_TRY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers to contiguous
// q (B,Sq,H,Dk), k (B,Sk,KV,Dk), v (B,Sk,KV,Dv), out (B,Sq,H,Dv) of one
// dtype (0 = f32, 1 = bf16) and lse (B,H,Sq) f32. The caller has checked
// shapes, H % KV == 0, q_offset >= 0 and B, H < 65536. `tile` indexes
// FA_TF32X3_TILES and `smem` is the dynamic shared memory the caller's
// plan gives it; the call runs on that tile if it holds Dk and Dv and its
// shared bytes are `smem`, else gets cudaErrorInvalidValue before any CUDA
// call. Returns that, or the first CUDA error of the set-up or the launch,
// else 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int Dk, int Dv, int q_offset, int causal,
                                      float scale, int dtype, int tile, int smem,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (Dk <= 0 || Dv <= 0 || Dk > kMaxD || Dv > kMaxD) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_tile<float>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset, causal,
                              scale, tile, smem, s);
  if (dtype == 1)
    return launch_tile<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dk, Dv, q_offset,
                                      causal, scale, tile, smem, s);
  return (int)cudaErrorInvalidValue;
}
