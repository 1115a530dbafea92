// Hopper (sm_90a) building blocks of the 3x3 conv kernels of conv3x3.cu
// and the decoder-chain kernels of decoder_chain.cu: TMA tensor maps and
// loads, an mbarrier ring, the wgmma m64n128k16 and m64n64k16 bf16 products
// (A from registers or from shared memory, B from shared memory through a
// descriptor), the bf16 store epilogue of a 16 x 16 pixel tile, and the
// persistent producer/consumer main loop of a taps conv (taps_produce,
// taps_consume), parametrised by its epilogue.
//
// Every operand tile in shared memory is in the layout that TMA's 128-byte
// swizzle writes and a wgmma descriptor reads: rows of 64 bf16 (128 B),
// the 16-byte chunk j of row r stored at chunk j ^ (r % 8), each tile
// 1024-byte aligned. A K-major operand of R rows is then described by its
// start address, a stride of 1024 B between groups of 8 rows, and the
// swizzle mode; the k16 step s within the 64-wide row adds 32 s bytes to the
// start address.
//
// The tensor maps are made on the host by cuTensorMapEncodeTiled, taken
// from the driver through the runtime's cudaGetDriverEntryPoint (or
// cudaGetDriverEntryPointByVersion from CUDA 12.5 on), so the library links
// against the CUDA runtime alone and needs no -lcuda. <cuda.h> is included
// for the CUtensorMap type and its enums only.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace conv_wgmma {

using bf16 = __nv_bfloat16;

constexpr int kN = 128;                  // output channels of every conv
constexpr int kKB = 64;                  // K rows of one block: 128 B
constexpr int kMaxC = 128;               // input channels a kernel takes
constexpr int kTile = 16;                // a tile is kTile x kTile pixels
constexpr int kTilePix = kTile * kTile;  // 256 = 2 warpgroups x 2 m64 tiles
constexpr int kConsumers = 2;            // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's
// Registers a thread after setmaxnreg: the producer warpgroup gives its
// share to the consumers (each SM sub-partition holds 2 consumer warps
// and 1 producer warp: 2 x 232 + 40 = 504 of its 512 registers a lane).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRowBytes = kKB * 2;               // one swizzled row
constexpr int kWBlockBytes = kN * kRowBytes;     // 16 KB of weight

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// 64-channel blocks a pixel of C channels takes (C = 96 -> 2, the second
// half zero-filled by TMA).
__host__ __device__ constexpr int channel_blocks(int C) {
  return (C + kKB - 1) / kKB;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// threadIdx.x, read anew where it is used: the compiler cannot hoist an
// asm volatile, so per-thread indices derived from it are recomputed
// inside a tile loop instead of being held (or spilled) across it.
__device__ __forceinline__ int thread_x() {
  int r;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(r));
  return r;
}

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and expect `bytes` more of TMA traffic before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A phase that has
// not completed after ~2^35 cycles (over 15 s) is a fault of the pipeline:
// trap, so that the launch fails instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > (1LL << 35)) __trap();
  }
}

// A ring of kStages buffers: full[s] completes when TMA has filled buffer
// s, empty[s] when every consumer warp has released it. Producer and
// consumers walk the same sequence of uses; use i takes buffer i % kStages
// in round i / kStages.
template <int kStages>
struct Ring {
  uint64_t full[kStages];
  uint64_t empty[kStages];

  __device__ void init(uint32_t consumer_warps) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
  }
  // producer: wait until buffer i % kStages is free (round 0 passes), then
  // expect tx_bytes into it
  __device__ void acquire(uint32_t i, uint32_t tx_bytes) {
    mbar_wait(&empty[i % kStages], ((i / kStages) & 1) ^ 1);
    mbar_expect_tx(&full[i % kStages], tx_bytes);
  }
  // consumer: wait until buffer i % kStages holds use i's data
  __device__ void wait_full(uint32_t i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
  }
  // consumer warp, after its last read of use i
  __device__ void release(uint32_t i) { mbar_arrive(&empty[i % kStages]); }
};

// The producer warpgroup drops to kProducerRegs registers a thread, the
// consumers rise to kConsumerRegs (both warpgroup-wide).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// ---- TMA loads (one thread issues; the barrier counts the bytes)

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Coordinates are signed: a box that reaches outside the tensor reads
// zeros there (the SAME halo without a padded copy).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- wgmma

// Descriptor of a K-major, 128-byte swizzled operand tile starting at p
// (1024-byte aligned, or that plus 32 s bytes for k16 step s).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;  // start address, 16 B units
  d |= uint64_t(1) << 16;                     // leading offset (unused)
  d |= uint64_t(1024 >> 4) << 32;             // 8 rows x 128 B apart
  d |= uint64_t(1) << 62;                     // 128-byte swizzle
  return d;
}

// The descriptor of k16 step s past d: +32 s bytes.
__device__ __forceinline__ uint64_t desc_step(uint64_t d, int s) {
  return d + static_cast<uint64_t>(2 * s);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Make this thread's plain stores to shared memory visible to the async
// proxy (a wgmma descriptor read); before the barrier that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The two consumer warpgroups meet (named barrier 1; the producer
// warpgroup never takes part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

#define CONV_WGMMA_D64                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),      \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define CONV_WGMMA_D64_REGS                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) = [d +] a (64 x 16, bf16 fragments in registers:
// warp w holds rows 16w..16w+15; a[0] rows l/4, k 2(l%4)..+1, a[1] those
// rows + 8, a[2] and a[3] the same at k + 8) @ b (16 x 128 through
// descriptor db, K-major). accumulate = 0 ignores d.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      CONV_WGMMA_D64_REGS ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : CONV_WGMMA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 128, f32) = [d +] a (64 x 16 through descriptor da, K-major)
// @ b (16 x 128 through descriptor db, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      CONV_WGMMA_D64_REGS ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CONV_WGMMA_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

#define CONV_WGMMA_D32                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, f32) = [d +] a (64 x 16 in registers, as wgmma_rs) @ b (16 x
// 64 through descriptor db, K-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : CONV_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef CONV_WGMMA_D64
#undef CONV_WGMMA_D64_REGS
#undef CONV_WGMMA_D32

// 4 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---- tiles

// Tile `tile` of a batch of (H, W) images cut into kTile x kTile tiles,
// column tiles fastest, then rows, then images.
struct TileCoord {
  int img, y0, x0;
};

__device__ __forceinline__ TileCoord tile_coord(int tile, int tiles_h,
                                                int tiles_w) {
  const int per_img = tiles_h * tiles_w;
  const int img = tile / per_img;
  const int r = tile - img * per_img;
  return {img, (r / tiles_w) * kTile, (r % tiles_w) * kTile};
}

// Pixel of row `row` (0..63) of m64 tile t of consumer warpgroup g: rows of
// the 256-pixel tile run row-major over its 16 x 16 pixels, and warpgroup g
// owns pixel rows 8g .. 8g + 7.
__device__ __forceinline__ int tile_pixel(int g, int t, int row) {
  return g * 128 + t * 64 + row;
}

// Two f32 rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Round the f32 accumulator of m64 tile t of this thread's warpgroup g once
// to bf16 and store it into the NHWC output (H, W, kN) of image tc.img;
// pixels of a ragged tile outside the image are dropped. With kBiasRelu
// the f32 value gets + bias[channel] and ReLU before the rounding.
// Accumulator element 4i + 2h + e of warp w, lane l is row 16w + l / 4 +
// 8h, channel 8i + 2 (l % 4) + e (wgmma's m64nNk16 f32 layout), so the 4
// lanes of a quad hold a row's channels in 4-byte pieces. A 4 x 4
// transpose inside the quad (two shuffle rounds) gives each lane 8
// consecutive channels, stored as one 16-byte vector: a quarter of the
// store instructions.
template <bool kBiasRelu>
__device__ __forceinline__ void store_m64(const float (&acc)[64],
                                          bf16* __restrict__ out, int H,
                                          int W, TileCoord tc, int g, int t,
                                          const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) & 3;
  const int q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = tile_pixel(g, t, 16 * w + lane / 4 + 8 * h);
    const int y = tc.y0 + p / kTile;
    const int x = tc.x0 + p % kTile;
    bf16* op = out + ((static_cast<long long>(tc.img) * H + y) * W + x) * kN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // v[i]: channels 8 (4j + i) + 2q, +1; after the transpose, channels
      // 8 (4j + q) + 2i, +1
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * (4 * j + i) + 2 * h;
        if (kBiasRelu) {
          const int c = 8 * (4 * j + i) + 2 * q;
          v[i] = pack_bf16(fmaxf(acc[e] + __ldg(bias + c), 0.f),
                           fmaxf(acc[e + 1] + __ldg(bias + c + 1), 0.f));
        } else {
          v[i] = pack_bf16(acc[e], acc[e + 1]);
        }
      }
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i & m) continue;
          const uint32_t send = (q & m) ? v[i] : v[i + m];
          const uint32_t recv = __shfl_xor_sync(0xffffffffu, send, m);
          if (q & m) {
            v[i] = recv;
          } else {
            v[i + m] = recv;
          }
        }
      }
      if (y < H && x < W) {
        *reinterpret_cast<uint4*>(op + 8 * (4 * j + q)) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// A taps epilogue that stores both m64 tiles of warpgroup g (store_m64).
template <bool kBiasRelu>
struct StoreTile {
  bf16* out;
  int H, W;
  const float* bias;  // kBiasRelu only
  __device__ __forceinline__ void operator()(float (&acc)[2][64],
                                             TileCoord tc, int /*tile*/,
                                             int g) const {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      store_m64<kBiasRelu>(acc[t], out, H, W, tc, g, t, bias);
    }
  }
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// acc += the product of one 64-row K block, summed by four wgmma steps in
// the fresh fragment part first (scale-d = 0 on the first step) and added
// with a rounded f32 add: the tensor cores' truncating accumulator never
// carries more than 64 rows (summing 1152 rows straight through it biased
// the chain's coordinates past their tolerance).
__device__ __forceinline__ void add_block(float (&acc)[64],
                                          float (&part)[64]) {
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += part[i];
}

// ---- the taps main loop
//
// A persistent block walks the 16 x 16 tiles tile = blockIdx.x + i *
// gridDim.x. Its producer warpgroup (one thread issues) brings each tile's
// input with a 1-pixel halo (18 x 18 pixels, one 41,984-byte block per 64
// channels; TMA zero-fills outside the image) into one of kHaloBufs halo
// buffers, then the tile's 9 * cbs weight blocks (K-major, tap-major then
// channel block) into a ring of kTapsStages. The two consumer warpgroups
// read each tap's shifted rows from the halo with ldmatrix into wgmma's
// register-A fragment, multiply by wgmma_rs, sum each K block by add_block,
// release the halo after their last read, and hand their f32 totals to
// the epilogue: epi(acc, tc, tile, g), acc[t] the m64 tile t of
// warpgroup g.

constexpr int kHalo = kTile + 2;                                  // 18
constexpr int kHaloBoxBytes = kHalo * kHalo * kRowBytes;          // 41,472
constexpr int kHaloBlkBytes = round_up(kHaloBoxBytes, 1024);      // 41,984
constexpr int kTapsStages = 3;
constexpr int kConsumerWarps = kConsumers * 4;

template <int kHaloBufs>
struct TapsBars {
  Ring<kTapsStages> w;
  uint64_t halo_full[kHaloBufs];
  uint64_t halo_empty[kHaloBufs];

  __device__ void init() {
    w.init(kConsumerWarps);
    for (int b = 0; b < kHaloBufs; ++b) {
      mbar_init(&halo_full[b], 1);
      mbar_init(&halo_empty[b], kConsumerWarps);
    }
  }
};

// Bytes the loop takes from the 1024-aligned start of dynamic shared
// memory: the halo buffers, the weight ring, the barriers.
template <int kHaloBufs>
__host__ __device__ constexpr int taps_bytes(int C) {
  return kHaloBufs * channel_blocks(C) * kHaloBlkBytes +
         kTapsStages * kWBlockBytes +
         static_cast<int>(sizeof(TapsBars<kHaloBufs>));
}

template <int kHaloBufs>
__device__ __forceinline__ TapsBars<kHaloBufs>* taps_bars(unsigned char* smem,
                                                          int C) {
  return reinterpret_cast<TapsBars<kHaloBufs>*>(
      smem + kHaloBufs * channel_blocks(C) * kHaloBlkBytes +
      kTapsStages * kWBlockBytes);
}

// One 64-row K block for NT m64 tiles: acc[t] += A_t @ the weight block of
// ring use kit. This lane's ldmatrix row of A_t is row q[t] of the swizzled
// tile at shared address blk (kRowBytes a row), read as 4 k16 steps.
template <int NT, int kStages>
__device__ __forceinline__ void taps_kblock(float (&acc)[NT][64],
                                            const int (&q)[NT], uint32_t blk,
                                            Ring<kStages>* ring,
                                            const unsigned char* wring,
                                            uint32_t kit) {
  const int lane = threadIdx.x & 31;
  ring->wait_full(kit);
  const uint64_t db = desc_sw128(wring + (kit % kStages) * kWBlockBytes);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const uint32_t row = blk + q[t] * kRowBytes;
    uint32_t a[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      ldmatrix_x4(a[s], row + (((2 * s + (lane >> 4)) ^ (q[t] & 7)) << 4));
    }
    float part[64];
    fence_operands(part);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_rs(part, a[s], desc_step(db, s), s);
    add_block(acc[t], part);
  }
  if (lane == 0) ring->release(kit);
}

// The producer's loop (one thread). Image tc.img of the tile walk is image
// img0 + tc.img of xmap.
template <int kHaloBufs>
__device__ __forceinline__ void taps_produce(const CUtensorMap* xmap,
                                             const CUtensorMap* wmap,
                                             unsigned char* smem, int C,
                                             int img0, int tiles_h,
                                             int tiles_w, int n_tiles) {
  const int cbs = channel_blocks(C);
  const int halo_bytes = cbs * kHaloBlkBytes;
  unsigned char* wring = smem + kHaloBufs * halo_bytes;
  TapsBars<kHaloBufs>* bars = taps_bars<kHaloBufs>(smem, C);
  tma_prefetch_map(xmap);
  tma_prefetch_map(wmap);
  const int n_kb = 9 * cbs;
  uint32_t kit = 0;
  for (int tile = blockIdx.x, it = 0; tile < n_tiles;
       tile += gridDim.x, ++it) {
    const TileCoord tc = tile_coord(tile, tiles_h, tiles_w);
    const int hb = it % kHaloBufs;
    const uint32_t phase = (it / kHaloBufs) & 1;
    mbar_wait(&bars->halo_empty[hb], phase ^ 1);
    mbar_expect_tx(&bars->halo_full[hb], cbs * kHaloBoxBytes);
    for (int cb = 0; cb < cbs; ++cb) {
      tma_load_4d(smem + hb * halo_bytes + cb * kHaloBlkBytes, xmap,
                  &bars->halo_full[hb], cb * kKB, tc.x0 - 1, tc.y0 - 1,
                  img0 + tc.img);
    }
    for (int kb = 0; kb < n_kb; ++kb, ++kit) {
      bars->w.acquire(kit, kWBlockBytes);
      tma_load_2d(wring + (kit % kTapsStages) * kWBlockBytes, wmap,
                  &bars->w.full[kit % kTapsStages], kb * kKB, 0);
    }
  }
}

// The consumers' loop (both consumer warpgroups, after consumer_regs).
template <int kHaloBufs, class Epilogue>
__device__ __forceinline__ void taps_consume(unsigned char* smem, int C,
                                             int tiles_h, int tiles_w,
                                             int n_tiles, const Epilogue& epi) {
  const int cbs = channel_blocks(C);
  const int halo_bytes = cbs * kHaloBlkBytes;
  const unsigned char* wring = smem + kHaloBufs * halo_bytes;
  TapsBars<kHaloBufs>* bars = taps_bars<kHaloBufs>(smem, C);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = warp >> 2;  // consumer warpgroup: pixel rows 8g .. 8g + 7
  const int wq = warp & 3;
  const int n_kb = 9 * cbs;  // K blocks: tap-major, then 64-channel blocks
  uint32_t kit = 0;
  for (int tile = blockIdx.x, it = 0; tile < n_tiles;
       tile += gridDim.x, ++it) {
    const TileCoord tc = tile_coord(tile, tiles_h, tiles_w);
    const int hb = it % kHaloBufs;
    const uint32_t phase = (it / kHaloBufs) & 1;
    const uint32_t halo = smem_u32(smem + hb * halo_bytes);
    float acc[2][64];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
    }
    mbar_wait(&bars->halo_full[hb], phase);
    for (int kb = 0; kb < n_kb; ++kb, ++kit) {
      const int tap = kb / cbs;
      const int dy = tap / 3;
      const int dx = tap - 3 * dy;
      // this lane's ldmatrix row of m64 tile t: output pixel (8g + 4t +
      // wq, lane % 16) shifted by the tap, in the halo tile
      int q[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        q[t] = (g * 8 + t * 4 + wq + dy) * kHalo + (lane & 15) + dx;
      }
      taps_kblock<2>(acc, q, halo + (kb - tap * cbs) * kHaloBlkBytes,
                     &bars->w, wring, kit);
    }
    if (lane == 0) mbar_arrive(&bars->halo_empty[hb]);
    epi(acc, tc, tile, g);
  }
}

// ---- host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Error codes of map_bf16 beside cudaError_t's: no driver entry point, and
// 1000 + the CUresult of a refused encoding.
constexpr int kErrNoEncoder = 999;
constexpr int kErrEncodeBase = 1000;

// A bf16 tensor map with the 128-byte swizzle: dims innermost first,
// strides (bytes) of dims 1.. , box in elements (box[0] = kKB).
inline int map_bf16(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                         const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + static_cast<int>(r);
}

// NHWC x (B, H, W, C) read in boxes of 64 channels x bw x bh pixels of one
// image.
inline int map_nhwc(CUtensorMap* map, const void* x, int B, int H, int W,
                    int C, int bh, int bw) {
  const cuuint64_t dims[4] = {cuuint64_t(C), cuuint64_t(W), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(C) * 2, cuuint64_t(W) * C * 2,
                                 cuuint64_t(H) * W * C * 2};
  const cuuint32_t box[4] = {kKB, cuuint32_t(bw), cuuint32_t(bh), 1};
  return map_bf16(map, x, 4, dims, strides, box);
}

// K-major weight (kN, K) read in blocks of kKB K rows x all kN outputs.
inline int map_kmajor_weight(CUtensorMap* map, const void* w, int K) {
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(kN)};
  const cuuint64_t strides[1] = {cuuint64_t(K) * 2};
  const cuuint32_t box[2] = {kKB, kN};
  return map_bf16(map, w, 2, dims, strides, box);
}

// The persistent grid: one block per SM, or one per tile if fewer.
inline cudaError_t persistent_grid(long long n_tiles, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  *grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  return err;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace conv_wgmma
