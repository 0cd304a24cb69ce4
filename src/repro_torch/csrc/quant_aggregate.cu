// Fused int8 dequantize + weighted client reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_aggregate.py::_agg_kernel.
// Computes, for every lane s in [0, S) and every n in [0, N):
//
//     acc = 0;  for c in 0..C-1:  acc = acc + (float(q[s, c, n]) * scale[s, c, n / qblock]) * w[s, c]
//     out[s, n] = acc
//
// (S = 1 is the single (C, N) reduction; S > 1 reduces a campaign's lanes
// in one launch.)
// in exactly that order, with every multiply and add rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), so the result equals the
// plain PyTorch version (repro_torch/kernels/quant_aggregate.py::plain)
// bit for bit.
//
// Bound: memory traffic. The work is 3 flops per int8 byte read, far below
// the card's ~20 flops/byte balance point for f32, so the least time is
//     bytes = S*(C*N (q) + 4*C*N/qblock (scales) + 4*C (w) + 4*N (out))
// over the device memory rate. Reaching that rate takes bytes in flight:
// by Little's law about 3.35 TB/s x ~0.7 us, 2-3 MB across the card. A
// thread that walks the clients with one load each keeps only a few hundred
// KB in flight, so the design hands the loads to the copy engine instead.
//
// Layout: each lane's outputs are cut into tiles of `tile` (8 per consumer
// thread); the tiles of all lanes form one index space (tile i is tile
// i % n_tiles of lane i / n_tiles), and each of `grid` CTAs takes tiles
// b, b + grid, ... in turn. A CTA
// streams its tiles' q rows, client after client, through a ring of
// `stages` stages in shared memory, each holding the tile slices of
// `stage_clients` clients. One thread of an extra producer warp fills a
// stage with a single TMA copy: a 2-d tensor map views q as (S*C rows,
// N / 4 int32 columns), a lane's rows starting at row s*C, so one box of
// stage_clients rows x tile bytes is one instruction, completing on the
// stage's "full" mbarrier (expect_tx of the box's bytes; rows past S*C and
// columns past N arrive as zeros). A lane's last stage may read the next
// lane's first rows: their scales and w are staged as zeros, so they add
// (x * 0) * 0 = +-0, which leaves any sum as it was. Each
// consumer warp arrives on the stage's "empty" mbarrier once it has read
// the stage, which frees it for the producer; the producer runs on into the
// next tile, so a CTA pays the first copy's latency once. Every consumer
// thread owns 8 consecutive outputs (one scale block: qblock is a multiple
// of 16) and reads 8 bytes per client from the stage.
//
// The scale and w rows are not 16-byte aligned (scale row c starts at
// 4 * c * nblocks bytes), which TMA cannot describe, and a tile needs only a
// few values of each row. The consumers fetch those of `chunk` clients at a
// time into shared memory with 4-byte cp.async copies, the next chunk (of
// this tile or the next) while the current one is in use, so no stage
// waits on their latency (the FL path's 100 clients are one chunk per tile).
//
// A thread adds its clients in order; the rows past C of the last stage add
// (x * 0) * 0 = +-0, which leaves any sum bitwise as it was (a sum that
// starts at +0 is never -0). Each lane's outputs are thus bitwise those of
// a launch over that lane alone. Each int8 value becomes a float by a byte
// permute and an add (int8_to_f), exactly as a conversion would. No atomics
// and no cross-CTA reduction: the output is deterministic. The ragged last
// tile masks its stores. The geometry (tile, stage_clients, stages, chunk,
// grid) comes from Python (kernels/quant_aggregate.py::launch_plan).
//
// Found on the way, on an H100: one cp.async.bulk per (client, tile) slice
// kept the issuing thread busy longer than memory took to deliver the
// bytes, hence one TMA copy per stage; scale loads issued a stage ahead of
// their use still stalled every stage, hence the chunks.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 8;            // outputs per consumer thread (8 int8 bytes per client)
constexpr int kMaxStageClients = 8;
constexpr int kMaxStages = 4;
// Tile, output and scale offsets are 64-bit; the TMA copy's column, in
// int32 words of q, is a signed 32-bit coordinate: N / 4 <= INT32_MAX.
constexpr int64_t kMaxN = (int64_t)0x7fffffff * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// a barrier among the consumer threads only (the producer runs ahead)
__device__ __forceinline__ void consumers_sync(int consumers) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(consumers) : "memory");
}
// float(b) of byte i of a word of int8 values biased by +128, exactly: the
// float with bits 0x4B0000uu is 2^23 + uu, less 2^23 + 128. One byte
// permute and one add, where a conversion instruction (I2F) runs at a
// quarter of the add's rate and would bound the kernel near its byte bound.
// `hi` holds 0x4B00 in a register, so the byte selector is the permute's
// immediate (with 0x4B00 as the immediate, the compiler rebuilt the four
// selectors in registers for every client).
__device__ __forceinline__ float int8_to_f(uint32_t biased, uint32_t hi, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, hi, 0x5440u + i)), 8388736.0f);
}
// 4 bytes from global to shared memory, in this thread's current commit group
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// one box of the 2-d tensor map (int32 column x, row y) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// acc[i] += (float(q) * scale) * w for the stage's clients in order, q from
// this thread's 8 bytes of each client's row in the stage. NC > 0: exactly
// NC clients, unrolled without a branch between them, so the compiler can
// interleave their independent products; NC == 0: nc clients.
template <int NC>
__device__ __forceinline__ void add_stage(float (&acc)[kOut], const unsigned char* base,
                                          int tile, const float* s, int bpt, const float* w,
                                          int nc, uint32_t hi) {
#pragma unroll
  for (int j = 0; j < (NC ? NC : kMaxStageClients); ++j) {
    if (NC || j < nc) {
      const uint2 v = *reinterpret_cast<const uint2*>(base + (size_t)j * tile);
      // the 8 bytes biased to unsigned (b + 128)
      const uint32_t u[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
      const float sc = s[j * bpt], wc = w[j];
#pragma unroll
      for (int i = 0; i < kOut; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(int8_to_f(u[i / 4], hi, i % 4), sc), wc));
    }
  }
}

// The scale blocks of a tile: the first, and how many its outputs touch.
struct TileBlocks {
  int64_t blk0;
  int nblk;
};
__device__ __forceinline__ TileBlocks tile_blocks(int64_t tile0, int tile, int64_t N,
                                                  int qblock) {
  const int64_t end = tile0 + tile < N ? tile0 + tile : N;
  return {tile0 / qblock, (int)((end - 1) / qblock - tile0 / qblock) + 1};
}

// Dynamic shared memory: the ring of q boxes (stages x stage_clients x
// `tile` bytes), the stages' full and empty mbarriers, then two buffers of
// a chunk's scales (chunk x blocks the tile can touch) and w (chunk).
__global__ void quant_aggregate_kernel(const __grid_constant__ CUtensorMap tq,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ w,
                                       float* __restrict__ out,
                                       int S, int C, int64_t N, int qblock, int tile,
                                       int stage_clients, int stages, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int consumers = blockDim.x - 32;          // the last warp is the producer
  const int64_t n_tiles = (N + tile - 1) / tile;     // per lane
  const int64_t all_tiles = n_tiles * S;              // over every lane
  const int n_stages = (C + stage_clients - 1) / stage_clients;
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + (uint32_t)(stages * stage_clients * tile);
  const uint32_t empty = full + 8u * stages;
  const int bpt = tile / qblock + 2;              // room per client for its scales
  float* const chunks = reinterpret_cast<float*>(smem + (size_t)stages * stage_clients * tile +
                                                 16 * stages);
  const size_t chunk_floats = (size_t)chunk * (bpt + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {
    // producer: one thread, one TMA copy per stage once its slot is free,
    // through every stage of every tile of this CTA; the ring's n-th refill
    // of a slot waits for its n-th release (parity n & 1)
    if (threadIdx.x != consumers) return;
    const uint32_t box = (uint32_t)(stage_clients * tile);
    int slot = 0, phase = 0;
    bool wrapped = false;
    for (int64_t gi = blockIdx.x; gi < all_tiles; gi += gridDim.x) {
      const int64_t ti = gi % n_tiles;
      const int row0 = (int)(gi / n_tiles) * C;      // the lane's first row
      for (int k = 0; k < n_stages; ++k) {
        if (wrapped) mbar_wait(empty + 8 * slot, phase ^ 1);
        mbar_expect_tx(full + 8 * slot, box);
        tma_load_2d(ring + (uint32_t)slot * box, &tq, full + 8 * slot, (int)(ti * tile / 4),
                    row0 + k * stage_clients);
        if (++slot == stages) slot = 0, phase ^= 1, wrapped = true;
      }
    }
    return;
  }

  // consumers: in each tile, thread t owns outputs [tile0 + 8t, tile0 + 8t +
  // 8); past N (the ragged tile) it still reads the stages and arrives,
  // stores nothing
  const int t = threadIdx.x;
  const int64_t nblocks = N / qblock;
  const int chunk_stages = chunk / stage_clients;
  const int tile_chunks = (n_stages + chunk_stages - 1) / chunk_stages;
  uint32_t hi;
  asm("mov.b32 %0, 0x4B00;\n" : "=r"(hi));   // a register, not an immediate

  // Chunk `ci` of global tile `gi` (clients [ci * chunk, +chunk) of its
  // lane) into buffer `buf`: this thread's share of the scales and w by
  // cp.async, in one commit group, and zeros past C.
  auto fetch = [&](int64_t gi, int ci, int buf) {
    const int64_t ti = gi % n_tiles, lane = gi / n_tiles;
    const float* const l_scale = scale + lane * C * nblocks;
    const float* const l_w = w + lane * C;
    const TileBlocks tb = tile_blocks(ti * tile, tile, N, qblock);
    float* const s_buf = chunks + buf * chunk_floats;
    float* const w_buf = s_buf + (size_t)chunk * bpt;
    const int c0 = ci * chunk, items = chunk * (tb.nblk + 1);
    for (int i = t; i < items; i += consumers) {
      const int j = i / (tb.nblk + 1), bb = i - j * (tb.nblk + 1);
      float* const dst = bb < tb.nblk ? s_buf + j * bpt + bb : w_buf + j;
      if (c0 + j >= C)
        *dst = 0.0f;
      else if (bb < tb.nblk)
        cp_async4(smem_u32(dst), l_scale + (int64_t)(c0 + j) * nblocks + tb.blk0 + bb);
      else
        cp_async4(smem_u32(dst), l_w + c0 + j);
    }
    cp_async_commit();
  };

  int slot = 0, phase = 0, buf = 0;
  if (blockIdx.x < all_tiles && n_stages > 0) fetch(blockIdx.x, 0, 0);
  for (int64_t gi = blockIdx.x; gi < all_tiles; gi += gridDim.x) {
    const int64_t ti = gi % n_tiles;
    float* const l_out = out + (gi / n_tiles) * N;
    const int64_t tile0 = ti * tile;
    const int64_t n0 = tile0 + (int64_t)kOut * t;
    const int b = (int)((n0 < N ? n0 : N - 1) / qblock - tile0 / qblock);   // its block
    float acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = 0.0f;
    const float* s_ch = nullptr;
    const float* w_ch = nullptr;
    for (int k = 0, kc = 0, ci = 0; k < n_stages; ++k) {
      if (kc == 0) {
        // this chunk has landed, and every consumer is done with the
        // previous one, whose buffer takes the next chunk (of this tile, or
        // the first of the next tile) while this one is used
        cp_async_wait_all();
        consumers_sync(consumers);
        if (ci + 1 < tile_chunks)
          fetch(gi, ci + 1, buf ^ 1);
        else if (gi + gridDim.x < all_tiles)
          fetch(gi + gridDim.x, 0, buf ^ 1);
        s_ch = chunks + buf * chunk_floats;
        w_ch = s_ch + (size_t)chunk * bpt;
        buf ^= 1;
        ++ci;
      }
      const int jc = kc * stage_clients;   // the stage's first client in the chunk
      mbar_wait(full + 8 * slot, phase);
      const unsigned char* base = smem + (size_t)slot * stage_clients * tile + kOut * t;
      if (stage_clients == kMaxStageClients)   // every stage of C >= 8 clients
        add_stage<kMaxStageClients>(acc, base, tile, s_ch + jc * bpt + b, bpt, w_ch + jc,
                                    kMaxStageClients, hi);
      else                                     // the one stage of C < 8 clients
        add_stage<0>(acc, base, tile, s_ch + jc * bpt + b, bpt, w_ch + jc, stage_clients, hi);
      __syncwarp();
      if (t % 32 == 0) mbar_arrive(empty + 8 * slot);
      if (++slot == stages) slot = 0, phase ^= 1;
      if (++kc == chunk_stages) kc = 0;
    }
    if (n0 < N) {
      float4* o = reinterpret_cast<float4*>(l_out + n0);
      o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers to
// S lanes of (C, N) q, (C, N / qblock) scales, (C,) w and (N,) out, each
// lane's right after the last; the caller has checked dtypes, contiguity,
// 16-byte alignment of q and out, N % qblock == 0 and qblock % 16 == 0. The geometry comes from
// kernels/quant_aggregate.py::launch_plan: tiles of `tile` outputs (8 per
// consumer thread, plus one producer warp), `stages` ring stages of
// `stage_clients` clients, scales and w staged `chunk` clients at a time (a
// multiple of stage_clients), `grid` CTAs that take the tiles in turn
// (CTA b: tiles b, b + grid, ... of the S * ceil(N / tile) tiles of every
// lane). A geometry the kernel does not take returns
// cudaErrorInvalidValue, a tensor map the driver refuses its error;
// otherwise returns cudaGetLastError() after the launch.
extern "C" int quant_aggregate_launch(const void* q, const void* scale, const void* w,
                                      void* out, int S, int C, int64_t N, int qblock, int tile,
                                      int stage_clients, int stages, int chunk, int grid,
                                      void* stream) {
  if (tile < 256 || tile % 256 || tile > 1024 || stage_clients < 1 ||
      stage_clients > kMaxStageClients || stages < 1 || stages > kMaxStages || C < 0 ||
      S < 1 || (int64_t)S * C > 0x7fffffff || N < 1 || N > kMaxN || qblock < 16 ||
      qblock % 16 || N % qblock || N % 16 || chunk < stage_clients || chunk % stage_clients ||
      grid < 1 || grid > (int64_t)S * ((N + tile - 1) / tile))
    return (int)cudaErrorInvalidValue;
  const int threads = tile / kOut + 32;
  const size_t smem = (size_t)stages * stage_clients * tile + 16 * (size_t)stages +
                      2 * 4 * (size_t)chunk * (tile / qblock + 3);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // q as (S*C rows, N / 4 int32 columns), read in boxes of tile bytes x
  // stage_clients rows; with no clients the kernel reads no box
  CUtensorMap tq{};
  if (C > 0) {
    const cuuint64_t dims[2] = {(cuuint64_t)(N / 4), (cuuint64_t)S * C};
    const cuuint64_t strides[1] = {(cuuint64_t)N};
    const cuuint32_t box[2] = {(cuuint32_t)(tile / 4), (cuuint32_t)stage_clients};
    const cuuint32_t elem[2] = {1, 1};
    CUresult rc = cuTensorMapEncodeTiled(
        &tq, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(q), dims, strides, box, elem,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) return (int)rc;
  }
  if (smem > 48 * 1024) {   // above the default: opted into once per device and size
    static size_t allowed[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (smem > allowed[dev]) {
      err = cudaFuncSetAttribute(quant_aggregate_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      allowed[dev] = smem;
    }
  }
  quant_aggregate_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, static_cast<const float*>(scale), static_cast<const float*>(w),
      static_cast<float*>(out), S, C, N, qblock, tile, stage_clients, stages, chunk);
  return (int)cudaGetLastError();
}
