// SAME 3x3 stride-1 convs for Hopper (sm_90a), bf16 NHWC x HWIO -> bf16,
// f32 accumulation, no bias, Co = 128, C in {32, 64, 96, 128}. Two designs,
// the counterparts of the two TPU kernels of benchmarks/pallas_conv_probe.py:
//
//   conv3x3_taps   replaces pallas_conv3x3 (:59, body `_kernel` :34): nine
//                  K=C products, one per tap. A block stages a tile's input
//                  with its 1-pixel halo once, by TMA, and reads each tap's
//                  shifted rows from it with ldmatrix into wgmma's
//                  register-A fragment.
//   conv3x3_im2col replaces pallas_conv3x3_v2 (:111, body `_kernel_v2`
//                  :83): one K=9C contraction. TMA brings each K block of
//                  the im2col matrix (one tap's shifted 16 x 16 window, 64
//                  channels) straight into shared memory in the layout a
//                  wgmma descriptor reads, and wgmma reads A and B there.
//                  The block is a tiled-mode box of the NHWC tensor map at
//                  the tap's shifted origin: for a stride-1 3x3 conv it is
//                  the load TMA's im2col mode would make, zero fill
//                  included, with no second kind of tensor map.
//
// Bound on an H100 at the probe's shape (x (160, 176, 240, 128), w (3, 3,
// 128, 128)): operations. 2 * 160 * 176 * 240 * 9 * 128 * 128 = 1.993e12
// FLOP is 2.015 ms at 989 TFLOP/s dense bf16; the 3.46 GB of x and out take
// 1.03 ms at 3.35 TB/s.
//
// Design (building blocks in conv_wgmma.cuh), against what held the first
// warp-level (m16n8k16) kernels back:
// - Tensor cores: wgmma.mma_async m64n128k16, B (and im2col's A) read from
//   128-byte swizzled shared memory through descriptors.
// - Weights: the wrapper re-lays HWIO (3, 3, C, 128) as K-major (128, 9 Cp),
//   Cp = C rounded up to 64, zero rows padding each tap (C = 32 or 96); a
//   wgmma descriptor reads that layout without the transpose bit. A
//   producer warpgroup (one thread issues) streams it by TMA in 16 KB
//   blocks of 64 K rows into an mbarrier ring (3 stages for taps, 4 for
//   im2col, whose stages also hold A), so no block barrier stands between
//   two K blocks.
// - Tile: 16 x 16 = 256 output pixels x 128 channels per block, two
//   consumer warpgroups of two m64 tiles each. Every weight block fetched
//   from L2 feeds 256 pixels, twice the 128 of the warp-level kernels: at
//   the probe's shape 160 * 11 * 15 = 26,400 tiles x 294,912 B = 7.79 GB of
//   weight a call (15.6 GB before). No cluster (1 x 1 x 1): 2-block
//   clusters that multicast each weight block halved that again but did
//   not run faster on the card. im2col's A blocks add 9 reads of x from
//   L2, 15.6 GB, the price of taking A from shared memory without a
//   gather.
// - Overlap: a persistent grid of one block per SM walks the tiles
//   (tile = blockIdx.x + i * gridDim.x). The producer runs ahead by the
//   ring: taps (the main loop taps_produce / taps_consume of
//   conv_wgmma.cuh, shared with decoder_chain.cu) double-buffers the halo
//   tile (18 x 18 pixels x Cp channels, 83 KB at
//   C = 128) and releases it before its epilogue, so the next tile's
//   input and first weights load while this one multiplies and stores.
//   Any number of images.
// - Accumulation: each 64-row K block is summed by four wgmma steps in a
//   fresh fragment (scale-d = 0 on the first) and added to the f32 total
//   with a rounded add: the tensor cores' truncating accumulator never
//   carries more than 64 rows. The total (2 x 64 registers) and the
//   fragment (64) fit the 232 registers a consumer thread gets from
//   setmaxnreg (3 warpgroups of 128 threads; the producer keeps 40).
// - Halo: TMA's zero fill outside the tensor stands for the SAME padding
//   and for the missing channels of a C = 32 or 96 block; the ragged last
//   tiles mask their stores. Any H and W, smaller than a tile too.

#include <climits>

#include "conv_wgmma.cuh"

namespace {

using namespace conv_wgmma;

constexpr int kABlockBytes = kTilePix * kRowBytes;                // 32 KB
constexpr int kIm2colStageBytes = kABlockBytes + kWBlockBytes;    // 48 KB
constexpr int kIm2colStages = 4;

// Dynamic shared memory, with slack to align the tiles to 1024 bytes.
__host__ __device__ constexpr int taps_smem_bytes(int C) {
  return 1024 + taps_bytes<2>(C);
}

__host__ __device__ constexpr int im2col_smem_bytes() {
  return 1024 + kIm2colStages * kIm2colStageBytes +
         static_cast<int>(sizeof(Ring<kIm2colStages>));
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_taps(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap, bf16* __restrict__ out,
             int H, int W, int C, int tiles_h, int tiles_w, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  if (threadIdx.x == 0) {
    taps_bars<2>(smem, C)->init();
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp >= kConsumerWarps) {  // the producer warpgroup
    producer_regs();
    if (warp == kConsumerWarps && (threadIdx.x & 31) == 0) {
      taps_produce<2>(&xmap, &wmap, smem, C, 0, tiles_h, tiles_w, n_tiles);
    }
    return;
  }
  consumer_regs();
  taps_consume<2>(smem, C, tiles_h, tiles_w, n_tiles,
                  StoreTile<false>{out, H, W, nullptr});
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_im2col(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               bf16* __restrict__ out, int H, int W, int C, int tiles_h,
               int tiles_w, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto* ring = reinterpret_cast<Ring<kIm2colStages>*>(
      smem + kIm2colStages * kIm2colStageBytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    ring->init(kConsumerWarps);
    mbar_fence_init();
  }
  __syncthreads();
  const int cbs = channel_blocks(C);
  const int n_kb = 9 * cbs;

  if (warp >= kConsumerWarps) {  // the producer warpgroup
    producer_regs();
    if (warp == kConsumerWarps && lane == 0) {  // one thread issues
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap);
      uint32_t kit = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const TileCoord tc = tile_coord(tile, tiles_h, tiles_w);
        for (int kb = 0; kb < n_kb; ++kb, ++kit) {
          const int tap = kb / cbs;
          const int dy = tap / 3;
          const int dx = tap - 3 * dy;
          unsigned char* stage =
              smem + (kit % kIm2colStages) * kIm2colStageBytes;
          uint64_t* full = &ring->full[kit % kIm2colStages];
          ring->acquire(kit, kIm2colStageBytes);
          // the im2col K block: the tap's shifted 16 x 16 window, 64
          // channels, zero outside the image
          tma_load_4d(stage, &xmap, full, (kb - tap * cbs) * kKB,
                      tc.x0 - 1 + dx, tc.y0 - 1 + dy, tc.img);
          tma_load_2d(stage + kABlockBytes, &wmap, full, kb * kKB, 0);
        }
      }
    }
    return;
  }

  consumer_regs();
  const int g = warp >> 2;
  uint32_t kit = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileCoord tc = tile_coord(tile, tiles_h, tiles_w);
    float acc[2][64];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
    }
    for (int kb = 0; kb < n_kb; ++kb, ++kit) {
      const unsigned char* stage =
          smem + (kit % kIm2colStages) * kIm2colStageBytes;
      ring->wait_full(kit);
      const uint64_t db = desc_sw128(stage + kABlockBytes);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint64_t da =
            desc_sw128(stage + tile_pixel(g, t, 0) * kRowBytes);
        float part[64];
        fence_operands(part);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          wgmma_ss(part, desc_step(da, s), desc_step(db, s), s);
        }
        add_block(acc[t], part);
      }
      if (lane == 0) ring->release(kit);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      store_m64<false>(acc[t], out, H, W, tc, g, t, nullptr);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int smem, int box, const void* x, const void* wk,
           void* out, int B, int H, int W, int C, void* stream) {
  if (C % 32 != 0 || C < 32 || C > kMaxC || B < 1 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_h = (H + kTile - 1) / kTile;
  const int tiles_w = (W + kTile - 1) / kTile;
  const long long n_tiles = static_cast<long long>(B) * tiles_h * tiles_w;
  if (n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  int err = map_nhwc(&xmap, x, B, H, W, C, box, box);
  if (err != 0) return err;
  err = map_kmajor_weight(&wmap, wk, 9 * channel_blocks(C) * kKB);
  if (err != 0) return err;
  cudaError_t cerr = allow_smem(kernel, smem);
  int grid = 0;
  if (cerr == cudaSuccess) cerr = persistent_grid(n_tiles, &grid);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<bf16*>(out), H, W, C, tiles_h, tiles_w,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, H, W, C) bf16 NHWC; wk (128, 9 Cp) bf16, the K-major weight (row
// co, column tap * Cp + ci, Cp = C rounded up to 64, zero where ci >= C);
// out (B, H, W, 128) bf16. All contiguous and 16-byte aligned; C % 32 == 0,
// C <= 128. Returns 0 on success, else the cudaError_t of the launch, or
// 999 (no cuTensorMapEncodeTiled) or 1000 + CUresult (a refused tensor map).
int conv3x3_taps_launch(const void* x, const void* wk, void* out, int B,
                        int H, int W, int C, void* stream) {
  return launch(conv3x3_taps, taps_smem_bytes(C), kHalo, x, wk, out, B, H,
                W, C, stream);
}

int conv3x3_im2col_launch(const void* x, const void* wk, void* out, int B,
                          int H, int W, int C, void* stream) {
  return launch(conv3x3_im2col, im2col_smem_bytes(), kTile, x, wk, out, B,
                H, W, C, stream);
}

// Dynamic shared memory of a block for C input channels (ptxas -v reports
// only the static part): kernel 0 = taps, 1 = im2col.
int conv3x3_smem_bytes(int kernel, int C) {
  return kernel == 0 ? taps_smem_bytes(C) : im2col_smem_bytes();
}

}  // extern "C"
