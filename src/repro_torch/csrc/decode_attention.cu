// Decode attention (one query token over a KV cache) for Hopper (sm_90a),
// split over the cache (flash-decoding).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py:29 (_decode_kernel). For q (B,H,Dk),
// k (B,S,KV,Dk), v (B,S,KV,Dv) and length (B,) int32, head h = kvh*G + g
// (G = H/KV, any value up to 32) attends over the keys j < length[b]
// (length clamped to [0, S]):
//
//     s = (q . k_j) * scale, -1e30 where j >= length[b]
//     softmax statistics m (max), l (sum of exp(s - m)), o = sum exp(s - m) v
//
// and returns the unnormalised o, m and l (all f32), so a caller can
// log-sum-exp combine shards of a cache. A row with length 0 comes out as
// exactly m = -1e30, l = 0, o = 0, as the Pallas kernel gives. Scores and
// probabilities stay in f32.
//
// Bound: memory traffic. Each key and value up to length[b] is read once for
// the whole GQA group: 2*G*D flops per 2*D elements, far below the card's
// balance point. At the serve shape (B 8, 8 kv heads of 128, a 2,112-key
// cache full) that is 69.6 MB: 0.021 ms at 3.35 TB/s.
//
// Design, to get that many bytes in flight:
// - The grid is (B*KV, n_split): a CTA takes one chunk of `chunk` keys
//   (a multiple of 64) of one (batch, kv head). At the serve shape a chunk
//   of 256 keys gives 9 splits and 576 CTAs on 132 SMs.
// - Each CTA streams its chunk in tiles of 64 keys with cp.async (16 bytes,
//   zero-filled past the chunk's end) into a ring of two stages: tile i+1
//   lands while tile i is computed. Tiles stay in the cache's type.
// - All 256 threads work in both products, and the whole GQA group shares
//   each tile. In bf16 (G <= 16, head dims multiples of 16: the serve path)
//   both products run on the tensor cores with mma.sync (decode_mma_kernel):
//   the group's rows padded to 16 are the M of both. Otherwise, on the CUDA
//   cores (decode_split_kernel): scores with 8 lanes per key, each taking
//   16-byte chunks of the row, and a 3-step shuffle sum per query row; P . V
//   with a thread owning 2 output columns of every row over 16 of the
//   tile's 64 keys, the four key quarters summed once per chunk. A first
//   version ran the bf16 path on the CUDA cores too: 0.092 ms at the serve
//   shape on an H100 SXM, its instructions about as long as its loads.
// - Each CTA writes its partial (o, m, l) in f32 to scratch; a second small
//   kernel in the same call log-sum-exp combines the splits of each row.
//   A split that starts at or past length[b] writes m = -1e30, l = 0, o = 0,
//   which the combine weighs by exp(-1e30 - m) = 0, or, when every split is
//   empty, leaves at m = -1e30, l = 0, o = 0.
// Shapes whose rows are not 16-byte aligned take the same kernel with
// element-wise loads.

#include "common.cuh"

namespace {

using repro::to_f;

constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of the CUDA-core kernel: the K/V ring, which the
// end-of-chunk reduction of P . V then reuses, followed by q (f32), the
// scores and the row statistics.
template <typename T>
__host__ __device__ size_t ring_or_red_bytes(int G, int Dk, int Dv) {
  const size_t ring = (size_t)kStages * kBK * (Dk + Dv) * sizeof(T);
  const size_t red = sizeof(float) * 4 * (size_t)G * Dv;
  return ring > red ? ring : red;
}

template <typename T>
size_t smem_bytes(int G, int Dk, int Dv) {
  return ring_or_red_bytes<T>(G, Dk, Dv) +
         sizeof(float) * ((size_t)G * Dk + (size_t)G * kBK + 3 * (size_t)G);
}

// Copy kBK rows of D elements (row r at src + r * stride) to dst (row r at
// dst + r * ld), zeros for rows >= valid. VEC: 16-byte cp.async (the caller
// checked alignment), else element-wise loads and stores.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int64_t stride,
                                          int valid, int D, int ld) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = D / E;
    for (int idx = threadIdx.x; idx < kBK * per_row; idx += kThreads) {
      const int r = idx / per_row, c = (idx - r * per_row) * E;
      const bool ok = r < valid;
      cp_async16(dst + r * ld + c, src + (int64_t)(ok ? r : 0) * stride + c, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      dst[r * ld + c] = r < valid ? src[r * stride + c] : T(0.0f);
    }
  }
}

// 16 bytes of f32 or bf16 as floats, without taking the address of a register
__device__ __forceinline__ void unpack16(const uint4 raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Online softmax of a score tile (row g at Ps + g * ldp): a warp per query
// row, two keys per lane. Leaves exp(s - m_new) in place, folds the tile
// into the row's running max ms and sum ls, and the rescale of its earlier
// accumulator into as.
__device__ __forceinline__ void softmax_rows(float* Ps, int ldp, float* ms, float* ls,
                                             float* as, int G) {
  const int lane = threadIdx.x % 32;
  for (int g = threadIdx.x / 32; g < G; g += kWarps) {
    float* prow = Ps + g * ldp;
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
}

// This CTA's chunk: keys [start, start + n) of (batch b, kv head kvh), and
// the slots of its partial. part holds o [B*H][n_split][Dv], then m and l
// [B*H][n_split]; row head0 + g is the group's query head g.
struct Chunk {
  int b, kvh, split, start, n;
  int64_t head0;
  float *po, *pm, *pl;
};

__device__ __forceinline__ Chunk locate(const int* length, float* part, int S, int H, int KV,
                                        int Dv, int chunk, int n_split) {
  Chunk c;
  c.b = blockIdx.x / KV;
  c.kvh = blockIdx.x % KV;
  c.split = blockIdx.y;
  c.start = c.split * chunk;
  c.n = min(c.start + chunk, min(max(length[c.b], 0), S)) - c.start;   // <= 0: past length
  c.head0 = (int64_t)c.b * H + (int64_t)c.kvh * (H / KV);
  const int64_t rows = (int64_t)gridDim.x / KV * H;                    // B * H
  c.po = part;
  c.pm = part + rows * n_split * Dv;
  c.pl = c.pm + rows * n_split;
  return c;
}

// The chunk's softmax statistics: m and l of the group's G rows.
__device__ __forceinline__ void write_stats(const Chunk& c, const float* ms, const float* ls,
                                            int G, int n_split) {
  for (int g = threadIdx.x; g < G; g += kThreads) {
    c.pm[(c.head0 + g) * n_split + c.split] = ms[g];
    c.pl[(c.head0 + g) * n_split + c.split] = ls[g];
  }
}

// The partial of a chunk at or past length[b]: m = -1e30, l = 0, o = 0 for
// the group's G rows.
__device__ __forceinline__ void write_empty(const Chunk& c, int G, int Dv, int n_split) {
  for (int idx = threadIdx.x; idx < G * Dv; idx += kThreads)
    c.po[((c.head0 + idx / Dv) * n_split + c.split) * Dv + idx % Dv] = 0.0f;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    c.pm[(c.head0 + g) * n_split + c.split] = kNegInf;
    c.pl[(c.head0 + g) * n_split + c.split] = 0.0f;
  }
}

// MAXG: compile-time bound on G (registers per row); VEC: 16-byte loads and
// 16-byte score chunks, else one element at a time.
template <typename T, bool VEC, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ part, int S, int H, int KV, int Dk, int Dv,
                    int chunk, int n_split, float scale) {
  constexpr int CH = VEC ? 16 / sizeof(T) : 1;   // elements per score chunk
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int G = H / KV;
  T* ring = reinterpret_cast<T*>(smem_raw);                     // kStages x (K tile, V tile)
  float* Qs = reinterpret_cast<float*>(smem_raw + ring_or_red_bytes<T>(G, Dk, Dv));   // [G][Dk]
  float* Ps = Qs + G * Dk;                                      // [G][kBK]
  float* ms = Ps + G * kBK;                                     // [G]
  float* ls = ms + G;                                           // [G]
  float* as = ls + G;                                           // [G] rescale of the tile
  float* red = reinterpret_cast<float*>(smem_raw);              // [4][G][Dv], after the loop

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const Chunk ch = locate(length, part, S, H, KV, Dv, chunk, n_split);
  if (ch.n <= 0) {
    write_empty(ch, G, Dv, n_split);
    return;
  }
  const int64_t head0 = ch.head0, key0 = ((int64_t)ch.b * S + ch.start) * KV + ch.kvh;
  const T* kbase = k + key0 * Dk;   // first key of the chunk
  const T* vbase = v + key0 * Dv;
  const int64_t kstride = (int64_t)KV * Dk, vstride = (int64_t)KV * Dv;
  const int n = ch.n, ntiles = (n + kBK - 1) / kBK;
  const int tile_elems = kBK * (Dk + Dv);

  load_tile<T, VEC>(ring, kbase, kstride, n, Dk, Dk);
  load_tile<T, VEC>(ring + kBK * Dk, vbase, vstride, n, Dv, Dv);
  cp_async_commit();
  for (int idx = tid; idx < G * Dk; idx += kThreads) Qs[idx] = to_f(q[head0 * Dk + idx]);
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.0f;
  }

  // P . V ownership: columns c0 and c0 + 64, keys kq*16 .. kq*16+15 of a tile
  const int c0 = tid % 64, kq = tid / 64;
  float acc[MAXG][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g][0] = acc[g][1] = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      T* nxt = ring + ((i + 1) % kStages) * tile_elems;
      const int k1 = (i + 1) * kBK;
      load_tile<T, VEC>(nxt, kbase + k1 * kstride, kstride, n - k1, Dk, Dk);
      load_tile<T, VEC>(nxt + kBK * Dk, vbase + k1 * vstride, vstride, n - k1, Dv, Dv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile i has landed; q and the statistics are set

    const T* Kt = ring + (i % kStages) * tile_elems;
    const T* Vt = Kt + kBK * Dk;
    const int k0 = i * kBK;

    // scores: 8 lanes per key, 4 keys per warp per pass
    const int l8 = lane % 8;
#pragma unroll
    for (int pass = 0; pass < kBK / (4 * kWarps); ++pass) {
      const int t = warp * (kBK / kWarps) + pass * 4 + lane / 8;
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dot[g] = 0.0f;
      for (int c = l8 * CH; c < Dk; c += 8 * CH) {
        float kf[CH];
        if constexpr (VEC) {
          unpack16(*reinterpret_cast<const uint4*>(Kt + t * Dk + c), kf);
        } else {
          kf[0] = to_f(Kt[t * Dk + c]);
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
#pragma unroll
            for (int x = 0; x < CH; ++x) dot[g] = fmaf(Qs[g * Dk + c + x], kf[x], dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          float d = dot[g];
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          d += __shfl_xor_sync(0xffffffffu, d, 4);
          if (l8 == 0) Ps[g * kBK + t] = k0 + t < n ? __fmul_rn(d, scale) : kNegInf;
        }
      }
    }
    __syncthreads();

    softmax_rows(Ps, kBK, ms, ls, as, G);
    __syncthreads();

    // acc = acc * alpha + p . v over this thread's 16 keys
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float a = as[g];
        acc[g][0] *= a;
        acc[g][1] *= a;
      }
    }
#pragma unroll 4
    for (int t = kq * 16; t < kq * 16 + 16; ++t) {
      const float v0 = c0 < Dv ? to_f(Vt[t * Dv + c0]) : 0.0f;
      const float v1 = c0 + 64 < Dv ? to_f(Vt[t * Dv + c0 + 64]) : 0.0f;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float p = Ps[g * kBK + t];
          acc[g][0] = fmaf(p, v0, acc[g][0]);
          acc[g][1] = fmaf(p, v1, acc[g][1]);
        }
      }
    }
    __syncthreads();   // stage i % kStages and Ps are free again
  }
  cp_async_wait<0>();
  __syncthreads();

  // sum the four key quarters through the (now idle) ring, write the partial
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (c0 < Dv) red[(kq * G + g) * Dv + c0] = acc[g][0];
      if (c0 + 64 < Dv) red[(kq * G + g) * Dv + c0 + 64] = acc[g][1];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * Dv; idx += kThreads) {
    const int g = idx / Dv, c = idx - g * Dv;
    const int gd = G * Dv;
    ch.po[((head0 + g) * n_split + ch.split) * Dv + c] =
        red[idx] + red[gd + idx] + red[2 * gd + idx] + red[3 * gd + idx];
  }
  write_stats(ch, ms, ls, G, n_split);
}

// ---- bf16 on the tensor cores (mma.sync m16n8k16) ----------------------
// Taken when q, k, v are bf16, Dk and Dv are multiples of 16, G <= 16 and
// the rows are 16-byte aligned (the serve path: G 7, head dim 128). The
// group's G rows, padded to 16, are the M of both products: S = Q K^T has
// each warp take 8 keys of the tile, with Q's A fragments in registers for
// the whole chunk; O += P V has each warp own 16 output columns over all 64
// keys, V's B fragments read with ldmatrix.trans. The softmax is the SIMT
// kernel's, through the same score tile in shared memory. Tile rows are
// padded by 16 bytes so the fragment loads hit distinct banks.

constexpr int kPadBf16 = 8;          // bf16 elements of padding per tile row
constexpr int kLdP = kBK + 8;        // f32 row stride of the score tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

size_t mma_smem_bytes(int Dk, int Dv) {
  return (size_t)kStages * kBK * (Dk + Dv + 2 * kPadBf16) * 2 +
         sizeof(float) * (16 * (size_t)kLdP + 3 * 16);
}

__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ length,
                  float* __restrict__ part, int S, int H, int KV, int Dk, int Dv, int chunk,
                  int n_split, float scale) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int G = H / KV, ldk = Dk + kPadBf16, ldv = Dv + kPadBf16;
  const int tile_elems = kBK * (ldk + ldv);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // kStages x (K [kBK][ldk], V [kBK][ldv])
  float* Ps = reinterpret_cast<float*>(smem_raw + (size_t)kStages * tile_elems * 2);  // [16][kLdP]
  float* ms = Ps + 16 * kLdP;                       // [16]
  float* ls = ms + 16;                              // [16]
  float* as = ls + 16;                              // [16] rescale of the tile

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const Chunk ch = locate(length, part, S, H, KV, Dv, chunk, n_split);
  if (ch.n <= 0) {
    write_empty(ch, G, Dv, n_split);
    return;
  }
  const int64_t head0 = ch.head0, key0 = ((int64_t)ch.b * S + ch.start) * KV + ch.kvh;
  const bf16* kbase = k + key0 * Dk;
  const bf16* vbase = v + key0 * Dv;
  const int64_t kstride = (int64_t)KV * Dk, vstride = (int64_t)KV * Dv;
  const int n = ch.n, ntiles = (n + kBK - 1) / kBK;

  load_tile<bf16, true>(ring, kbase, kstride, n, Dk, ldk);
  load_tile<bf16, true>(ring + kBK * ldk, vbase, vstride, n, Dv, ldv);
  cp_async_commit();
  for (int idx = tid; idx < 16 * kLdP; idx += kThreads) Ps[idx] = 0.0f;   // rows >= G stay 0
  if (tid < 16) {
    ms[tid] = kNegInf;
    ls[tid] = 0.0f;
    as[tid] = 1.0f;
  }

  // fragment coordinates: rows r and r + 8, column pair cq
  const int r = lane / 4, cq = 2 * (lane % 4);
  uint32_t qa[kMaxD / 16][4];   // Q's A fragments, k-step ks
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q + (head0 + r) * Dk);
    const uint32_t* q8 = reinterpret_cast<const uint32_t*>(q + (head0 + r + 8) * Dk);
#pragma unroll
    for (int ks = 0; ks < kMaxD / 16; ++ks) {
      const bool live = ks < Dk / 16;
      const int d = (16 * ks + cq) / 2;
      qa[ks][0] = live && r < G ? q0[d] : 0u;
      qa[ks][1] = live && r + 8 < G ? q8[d] : 0u;
      qa[ks][2] = live && r < G ? q0[d + 4] : 0u;
      qa[ks][3] = live && r + 8 < G ? q8[d + 4] : 0u;
    }
  }
  float oc[2][4];   // O columns warp*16 + 8*nt + cq (+1), rows r and r + 8
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oc[nt][e] = 0.0f;
  const bool owns_cols = warp * 16 < Dv;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      bf16* nxt = ring + ((i + 1) % kStages) * tile_elems;
      const int k1 = (i + 1) * kBK;
      load_tile<bf16, true>(nxt, kbase + k1 * kstride, kstride, n - k1, Dk, ldk);
      load_tile<bf16, true>(nxt + kBK * ldk, vbase + k1 * vstride, vstride, n - k1, Dv, ldv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile i has landed; Ps and the statistics are set

    const bf16* Kt = ring + (i % kStages) * tile_elems;
    const bf16* Vt = Kt + kBK * ldk;
    const int k0 = i * kBK;

    // S = Q K^T: warp takes keys warp*8 .. warp*8+7
    {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const uint32_t* krow = reinterpret_cast<const uint32_t*>(Kt + (warp * 8 + r) * ldk);
#pragma unroll
      for (int ks = 0; ks < kMaxD / 16; ++ks)
        if (ks < Dk / 16) mma_bf16(c, qa[ks], krow[(16 * ks + cq) / 2], krow[(16 * ks + cq + 8) / 2]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + 8 * (e / 2), t = warp * 8 + cq + (e % 2);
        if (row < G) Ps[row * kLdP + t] = k0 + t < n ? __fmul_rn(c[e], scale) : kNegInf;
      }
    }
    __syncthreads();

    softmax_rows(Ps, kLdP, ms, ls, as, G);
    __syncthreads();

    // O = O * alpha + P V: warp owns columns warp*16 .. warp*16+15
    if (owns_cols) {
      const float a0 = as[r], a8 = as[r + 8];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        oc[nt][0] *= a0;
        oc[nt][1] *= a0;
        oc[nt][2] *= a8;
        oc[nt][3] *= a8;
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const float* p0 = Ps + r * kLdP + 16 * kk + cq;
        const float* p8 = p0 + 8 * kLdP;
        const uint32_t pa[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p8[0], p8[1]),
                                pack_bf16(p0[8], p0[9]), pack_bf16(p8[8], p8[9])};
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vt + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * ldv +
                                  warp * 16 + 8 * (lane / 16));
        mma_bf16(oc[0], pa, vb[0], vb[1]);
        mma_bf16(oc[1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // stage i % kStages and Ps are free again
  }

  if (owns_cols) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r + 8 * (e / 2), c = warp * 16 + 8 * nt + cq + (e % 2);
        if (row < G) ch.po[((head0 + row) * n_split + ch.split) * Dv + c] = oc[nt][e];
      }
  }
  write_stats(ch, ms, ls, G, n_split);
}

// Log-sum-exp combine of the splits: one CTA per (batch, head) row.
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part, float* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out, int rows,
                      int n_split, int Dv) {
  const int row = blockIdx.x;
  const float* po = part + (int64_t)row * n_split * Dv;
  const float* pm = part + (int64_t)rows * n_split * Dv + (int64_t)row * n_split;
  const float* pl = pm + (int64_t)rows * n_split;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, pm[s]);
  for (int c = threadIdx.x; c < Dv; c += blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < n_split; ++s) acc = fmaf(po[s * Dv + c], expf(pm[s] - M), acc);
    o[(int64_t)row * Dv + c] = acc;
  }
  if (threadIdx.x == 0) {
    float L = 0.0f;
    for (int s = 0; s < n_split; ++s) L = fmaf(pl[s], expf(pm[s] - M), L);
    m_out[row] = M;
    l_out[row] = L;
  }
}

template <typename T, bool VEC, int MAXG>
int launch_split(const void* q, const void* k, const void* v, const void* length, void* part,
                 int B, int S, int H, int KV, int Dk, int Dv, int chunk, int n_split,
                 float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(H / KV, Dk, Dv);
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, VEC, MAXG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<T, VEC, MAXG><<<dim3(B * KV, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(length), static_cast<float*>(part), S, H, KV, Dk, Dv, chunk,
      n_split, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_g(const void* q, const void* k, const void* v, const void* length, void* part,
             int B, int S, int H, int KV, int Dk, int Dv, int chunk, int n_split, float scale,
             cudaStream_t stream) {
  if (H / KV <= 8)
    return launch_split<T, VEC, 8>(q, k, v, length, part, B, S, H, KV, Dk, Dv, chunk, n_split,
                                   scale, stream);
  return launch_split<T, VEC, 32>(q, k, v, length, part, B, S, H, KV, Dk, Dv, chunk, n_split,
                                  scale, stream);
}

int launch_mma(const void* q, const void* k, const void* v, const void* length, void* part,
               int B, int S, int H, int KV, int Dk, int Dv, int chunk, int n_split,
               float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(Dk, Dv);
  cudaError_t err = cudaFuncSetAttribute(decode_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_mma_kernel<<<dim3(B * KV, n_split), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(length),
      static_cast<float*>(part), S, H, KV, Dk, Dv, chunk, n_split, scale);
  return (int)cudaGetLastError();
}

// whether a call takes the tensor-core kernel
bool mma_ok(int H, int KV, int Dk, int Dv, int dtype, const void* q, const void* k,
            const void* v) {
  const void* ptrs[] = {q, k, v};
  return dtype == 1 && H / KV <= 16 && Dk % 16 == 0 && Dv % 16 == 0 &&
         repro::vec16_ok(Dk, 2, ptrs, 3) && repro::vec16_ok(Dv, 2, ptrs, 3);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length, void* part,
           int B, int S, int H, int KV, int Dk, int Dv, int chunk, int n_split, float scale,
           cudaStream_t stream) {
  const void* kv[] = {k, v};
  if (repro::vec16_ok(Dk, sizeof(T), kv, 2) && repro::vec16_ok(Dv, sizeof(T), kv, 2))
    return launch_g<T, true>(q, k, v, length, part, B, S, H, KV, Dk, Dv, chunk, n_split,
                             scale, stream);
  return launch_g<T, false>(q, k, v, length, part, B, S, H, KV, Dk, Dv, chunk, n_split, scale,
                            stream);
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's limit before launching). dtype: 0 = f32, 1 = bf16.
extern "C" int64_t decode_attention_smem_bytes(int G, int Dk, int Dv, int dtype) {
  if (dtype == 0) return (int64_t)smem_bytes<float>(G, Dk, Dv);
  const size_t simt = smem_bytes<__nv_bfloat16>(G, Dk, Dv), mma = mma_smem_bytes(Dk, Dv);
  return (int64_t)(simt > mma ? simt : mma);
}

// Plain C entry point (bound with ctypes). Device pointers to contiguous
// q (B,H,Dk), k (B,S,KV,Dk), v (B,S,KV,Dv) of one dtype (0 = f32, 1 = bf16),
// length (B,) int32, f32 scratch `part` of B*H*n_split*(Dv + 2) floats, and
// f32 outputs o (B,H,Dv), m (B,H), l (B,H). chunk is a multiple of 64 and
// n_split = ceil(S / chunk). The caller has checked shapes, H % KV == 0,
// H/KV <= 32 and 0 < Dk, Dv <= 128. Launches the split kernel and the
// combine on `stream`; returns the first CUDA error, else 0.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* length, void* part, void* o, void* m,
                                       void* l, int B, int S, int H, int KV, int Dk, int Dv,
                                       int chunk, int n_split, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (Dk <= 0 || Dv <= 0 || Dk > kMaxD || Dv > kMaxD || chunk <= 0 || chunk % kBK ||
      H / KV > 32)
    return (int)cudaErrorInvalidValue;
  if (n_split > 0) {
    int rc = mma_ok(H, KV, Dk, Dv, dtype, q, k, v)
                 ? launch_mma(q, k, v, length, part, B, S, H, KV, Dk, Dv, chunk, n_split, scale, s)
           : dtype == 0 ? launch<float>(q, k, v, length, part, B, S, H, KV, Dk, Dv, chunk,
                                        n_split, scale, s)
           : dtype == 1 ? launch<__nv_bfloat16>(q, k, v, length, part, B, S, H, KV, Dk, Dv,
                                                chunk, n_split, scale, s)
                        : (int)cudaErrorInvalidValue;
    if (rc != 0) return rc;
  }
  decode_combine_kernel<<<B * H, 128, 0, s>>>(static_cast<const float*>(part),
                                              static_cast<float*>(o), static_cast<float*>(m),
                                              static_cast<float*>(l), B * H, n_split, Dv);
  return (int)cudaGetLastError();
}
