// SAME 3x3 stride-1 convs for Hopper (sm_90a), bf16 NHWC x HWIO -> bf16,
// f32 accumulation, no bias. Two designs, the counterparts of the two TPU
// kernels of benchmarks/pallas_conv_probe.py:
//
//   conv3x3_taps   replaces pallas_conv3x3 (:59, body `_kernel` :34): nine
//                  K=C products, one per tap, each read straight from the
//                  tile staged once with its 1-pixel halo.
//   conv3x3_im2col replaces pallas_conv3x3_v2 (:111, body `_kernel_v2`
//                  :83): one K=9C contraction; each K chunk of the im2col
//                  matrix (tap-shifted columns) is gathered from the staged
//                  tile into its own shared-memory buffer, then multiplied.
//
// Bound on an H100 at the probe's shape (x (160, 176, 240, 128), w (3, 3,
// 128, 128)): operations. 2 * 160 * 176 * 240 * 9 * 128 * 128 = 1.993e12
// FLOP is 2.02 ms at 989 TFLOP/s dense bf16; the 3.46 GB of x and out take
// 1.03 ms at 3.35 TB/s.
//
// Shared memory and halos (conv_tile.cuh): a block computes a 8 x 16 pixel
// tile times all 128 output channels. The TPU padded x in device memory
// (pallas_conv_probe.py:66) and needed H % BH == 0; here the staged tile's
// halo is zero-filled by cp.async where it falls outside the image, and
// the ragged last tiles mask their stores, so any H and W work. The
// weights (295 KB) stream through two 32-row chunk buffers (17 KB); the
// staged tile is 10 x 18 x 136 bf16 (49 KB), so three blocks fit an SM.

#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

constexpr int kAStride = kKC + kPad;  // row stride of an im2col chunk

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_taps(const bf16* __restrict__ x, const bf16* __restrict__ w,
             bf16* __restrict__ out, int H, int W, int C, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  conv3x3_taps_block<false>(x, w, nullptr, out, H, W, C, tiles_w, smem);
}

__host__ __device__ constexpr int im2col_smem_bytes(int C) {
  return taps_smem_bytes(C) +
         kTilePix * kAStride * static_cast<int>(sizeof(bf16));
}

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_im2col(const bf16* __restrict__ x, const bf16* __restrict__ w9,
               bf16* __restrict__ out, int H, int W, int C, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = C + kPad;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  bf16* wbuf = tile + (kTileH + 2) * (kTileW + 2) * cs;
  bf16* abuf = wbuf + 2 * kWChunkElems;  // (128 pixels, kKC) of im2col
  const long long img = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  stage_tile(tile, cs, x + img * H * W * C, H, W, C, ty0 - 1, tx0 - 1,
             kTileH + 2, kTileW + 2);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const bf16* a_row[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    a_row[mt] = abuf + ((wm * 2 + mt) * 16 + (lane & 15)) * kAStride +
                (lane >> 4) * 8;
  }
  float acc[2][8][4] = {};
  const int n_chunks = 9 * C / kKC;
  load_w_chunk(wbuf, w9, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load_w_chunk(wbuf + ((c + 1) & 1) * kWChunkElems, w9, c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // gather im2col columns [c * kKC, c * kKC + kKC): column k is tap
    // k / C, channel k % C; 8-column vectors never straddle two taps
    for (int i = threadIdx.x; i < kTilePix * kKC / 8; i += kThreads) {
      const int p = i / (kKC / 8);
      const int v = i - p * (kKC / 8);
      const int k = c * kKC + v * 8;
      const int tap = k / C;
      const int src_pix =
          (p / kTileW + tap / 3) * (kTileW + 2) + p % kTileW + tap % 3;
      *reinterpret_cast<uint4*>(abuf + p * kAStride + v * 8) =
          *reinterpret_cast<const uint4*>(tile + src_pix * cs + k - tap * C);
    }
    __syncthreads();
    warp_mma<2, 8>(acc, a_row, wbuf + (c & 1) * kWChunkElems, kWStride,
                   wn * 64);
    __syncthreads();
  }
  store_tile<false>(acc, nullptr, out + img * H * W * kN, H, W, ty0, tx0);
}

template <typename Kernel>
int launch(Kernel kernel, int smem, const void* x, const void* w, void* out,
           int B, int H, int W, int C, void* stream_ptr) {
  if (C % kKC != 0 || C > kMaxC || B < 1 || B > 65535 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  dim3 grid(tiles_h * tiles_w, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), H, W, C, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, H, W, C) bf16, w (3, 3, C, 128) bf16, out (B, H, W, 128) bf16, all
// contiguous and 16-byte aligned; C % 32 == 0, C <= 128. Returns the
// cudaError_t of the launch (0 = success).
int conv3x3_taps_launch(const void* x, const void* w, void* out, int B,
                        int H, int W, int C, void* stream) {
  return launch(conv3x3_taps, taps_smem_bytes(C), x, w, out, B, H, W, C,
                stream);
}

int conv3x3_im2col_launch(const void* x, const void* w, void* out, int B,
                          int H, int W, int C, void* stream) {
  return launch(conv3x3_im2col, im2col_smem_bytes(C), x, w, out, B, H, W, C,
                stream);
}

// Dynamic shared memory of a block for C input channels (ptxas -v reports
// only the static part): kernel 0 = taps, 1 = im2col.
int conv3x3_smem_bytes(int kernel, int C) {
  return kernel == 0 ? taps_smem_bytes(C) : im2col_smem_bytes(C);
}

}  // extern "C"
