// Shared device-side building block of the 3x3 conv kernels for Hopper
// (sm_90a): a bf16 SAME 3x3 conv of a tile held in shared memory, f32
// accumulation on the tensor cores through mma.sync m16n8k16.
//
// Used by csrc/conv3x3.cu (the counterparts of the TPU kernels
// benchmarks/pallas_conv_probe.py:59 pallas_conv3x3 and :111
// pallas_conv3x3_v2) and csrc/decoder_chain.cu (:233 pallas_chain and
// :199 pallas_chain_v2 of benchmarks/pallas_chain_probe.py).
//
// What the TPU kept in VMEM does not fit here: a 128 -> 128 3x3 weight is
// 9 x 128 x 128 bf16 = 295 KB, more than the 227 KB of shared memory a
// block may use. So a block holds only its input tile (with a 1-pixel halo
// on all four sides, zero-filled where it falls outside the image) and
// streams the weights through two shared-memory buffers of kKC rows of K,
// loaded with cp.async while the previous chunk is multiplied; every block
// reads the weights from L2. A block's output is a 2-D tile of
// kTileH x kTileW pixels (not a full-width row band: one 240-wide band of
// 128 channels with halo is 186 KB at one row), times all kN channels.
//
// Layouts: activations NHWC, weights HWIO viewed as (9C, kN) with row
// (dy * 3 + dx) * C + ci. Shared-memory rows are padded by kPad bf16 so
// that the eight 16-byte rows an ldmatrix phase reads fall in distinct
// banks. 8 warps: 4 along the pixels (M) x 2 along the channels (N).
// No wgmma, TMA or warp specialisation: a simple correct kernel first.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace conv_tile {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;            // 8 warps: 4 (M) x 2 (N)
constexpr int kTileH = 8;                // output rows of one block
constexpr int kTileW = 16;               // output columns of one block
constexpr int kTilePix = kTileH * kTileW;  // 128 = 4 warps x 2 m16 tiles
constexpr int kN = 128;                  // output channels of every conv
constexpr int kKC = 32;                  // K rows of weight per chunk
constexpr int kPad = 8;                  // bf16 padding of a smem row
constexpr int kWStride = kN + kPad;      // row stride of a weight chunk
constexpr int kWChunkElems = kKC * kWStride;
constexpr int kMaxC = 128;               // input channels a kernel takes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; when !valid nothing is read and the 16 bytes
// are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row-major) @ b (16 x 8), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where accumulator element i of tile (mt, nt) lies in a warp's block:
// row (pixel) and column (channel), as mma.sync m16n8k16 lays it out.
__device__ __forceinline__ int acc_row(int m_tile, int i) {
  return m_tile * 16 + ((threadIdx.x & 31) >> 2) + (i >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int n_tile, int i) {
  return n_tile * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

// One warp's share of a (pixels x channels) product over kKC rows of K:
// MT tiles of 16 rows of A, whose rows this lane addresses through
// a_row[mt] (the lane's ldmatrix row: row lane % 16 of the tile, K offset
// (lane / 16) * 8), times NT tiles of 8 columns of B, held [k][n] in shared
// memory with row stride bs, starting at column n0.
//
// The product over the chunk is summed in a zeroed fragment and then added
// to acc with a rounded f32 add. The tensor cores add into their
// accumulator with truncation, so accumulating a 1152-deep sum straight
// through every mma step biases it toward zero and moves several times as
// many bf16 outputs off the correctly rounded value as an f32 sum does;
// the conv probe prints that share for the kernels and for cuDNN.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const bf16* const (&a_row)[MT],
                                         const bf16* b, int bs, int n0) {
  static_assert(NT % 2 == 0, "B is loaded two n8 tiles at a time");
  constexpr int kSteps = kKC / 16;
  const int lane = threadIdx.x & 31;
  const bf16* b_lane =
      b + ((lane & 7) + ((lane >> 3) & 1) * 8) * bs + n0 + (lane >> 4) * 8;
  uint32_t a[kSteps][MT][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[ks][mt], a_row[mt] + ks * 16);
  }
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    float part[MT][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t bq[4];
      ldmatrix_x4_trans(bq, b_lane + ks * 16 * bs + np * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(part[mt][0], a[ks][mt], bq[0], bq[1]);
        mma_bf16(part[mt][1], a[ks][mt], bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][2 * np][i] += part[mt][0][i];
        acc[mt][2 * np + 1][i] += part[mt][1][i];
      }
    }
  }
}

// cp.async a th x tw pixel window of one NHWC image, origin (y0, x0), into
// shared memory [pixel][cs]; pixels outside the image are zero (SAME
// padding without a padded copy in device memory). C % 8 == 0.
__device__ __forceinline__ void stage_tile(bf16* dst, int cs,
                                           const bf16* __restrict__ img,
                                           int H, int W, int C, int y0,
                                           int x0, int th, int tw) {
  const int vpp = C / 8;  // 16-byte vectors per pixel
  const int n = th * tw * vpp;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int pix = i / vpp;
    const int v = i - pix * vpp;
    const int y = y0 + pix / tw;
    const int x = x0 + pix % tw;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const bf16* src =
        in ? img + (static_cast<long long>(y) * W + x) * C + v * 8 : img;
    cp_async16(dst + pix * cs + v * 8, src, in);
  }
}

// cp.async rows [chunk * kKC, chunk * kKC + kKC) of a (rows, kN) weight.
__device__ __forceinline__ void load_w_chunk(bf16* dst,
                                             const bf16* __restrict__ w,
                                             int chunk) {
  const bf16* src = w + static_cast<long long>(chunk) * kKC * kN;
  for (int i = threadIdx.x; i < kKC * kN / 8; i += kThreads) {
    const int r = i / (kN / 8);
    const int v = i - r * (kN / 8);
    cp_async16(dst + r * kWStride + v * 8, src + r * kN + v * 8, true);
  }
}

// The 3x3 conv of a staged tile for this warp's pixels and channels,
// accumulated into acc (warp (wm, wn) owns rows (wm * MT + mt) * 16 + ...
// and channels wn * 64 + ...).
//   in: the input tile, (oh + 2) x (ow + 2) pixels of C channels, row
//       stride cs, already in flight (cp.async committed) or written;
//   n_out: the oh * ow output pixels; padding rows up to 4 * MT * 16
//       compute on pixel 0 and their results are dropped by the caller;
//   w: (9C, kN) weight in device memory; wbuf: 2 * kWChunkElems of smem.
// Starts and ends with every thread past a barrier, so the caller may
// reuse wbuf and overwrite what the conv read once it returns.
template <int MT>
__device__ __forceinline__ void conv3x3_tile(float (&acc)[MT][8][4],
                                             const bf16* in, int cs, int ow,
                                             int n_out, int C,
                                             const bf16* __restrict__ w,
                                             bf16* wbuf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const bf16* a_base[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    int p = (wm * MT + mt) * 16 + (lane & 15);
    if (p >= n_out) p = 0;
    a_base[mt] = in + ((p / ow) * (ow + 2) + p % ow) * cs + (lane >> 4) * 8;
  }
  const int n_chunks = 9 * C / kKC;  // C % kKC == 0: a chunk is one tap
  load_w_chunk(wbuf, w, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      load_w_chunk(wbuf + ((c + 1) & 1) * kWChunkElems, w, c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k = c * kKC;
    const int tap = k / C;
    const int shift = ((tap / 3) * (ow + 2) + tap % 3) * cs + (k - tap * C);
    const bf16* a_row[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) a_row[mt] = a_base[mt] + shift;
    warp_mma<MT, 8>(acc, a_row, wbuf + (c & 1) * kWChunkElems, kWStride,
                    wn * 64);
    __syncthreads();
  }
}

// Write this warp's share of a block's kTileH x kTileW x kN accumulator,
// rounded once to bf16, into one NHWC image `out` (H x W x kN) at tile
// origin (ty0, tx0); the pixels of a ragged last tile that fall outside
// the image are dropped. With kBiasRelu the f32 accumulator gets
// + bias[co] and ReLU before the rounding.
template <bool kBiasRelu>
__device__ __forceinline__ void store_tile(const float (&acc)[2][8][4],
                                           const float* __restrict__ bias,
                                           bf16* __restrict__ out, int H,
                                           int W, int ty0, int tx0) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = acc_row(wm * 2 + mt, half * 2);
      const int y = ty0 + p / kTileW;
      const int x = tx0 + p % kTileW;
      if (y >= H || x >= W) continue;
      bf16* op = out + (static_cast<long long>(y) * W + x) * kN;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = wn * 64 + acc_col(nt, 0);
        float v0 = acc[mt][nt][half * 2];
        float v1 = acc[mt][nt][half * 2 + 1];
        if (kBiasRelu) {
          v0 = fmaxf(v0 + bias[col], 0.f);
          v1 = fmaxf(v1 + bias[col + 1], 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(op + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Shared memory of conv3x3_taps_block for C input channels.
__host__ __device__ constexpr int taps_smem_bytes(int C) {
  return ((kTileH + 2) * (kTileW + 2) * (C + kPad) + 2 * kWChunkElems) *
         static_cast<int>(sizeof(bf16));
}

// One block of a SAME 3x3 conv (NHWC x HWIO): stage the tile with its halo
// once, accumulate the nine taps from it, write bf16. With kBiasRelu the
// f32 accumulator gets + bias[co] and ReLU before the one rounding.
// Grid: (tiles of kTileH x kTileW, images).
template <bool kBiasRelu>
__device__ __forceinline__ void conv3x3_taps_block(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ bias, bf16* __restrict__ out, int H, int W,
    int C, int tiles_w, unsigned char* smem) {
  const int cs = C + kPad;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  bf16* wbuf = tile + (kTileH + 2) * (kTileW + 2) * cs;
  const long long img = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  stage_tile(tile, cs, x + img * H * W * C, H, W, C, ty0 - 1, tx0 - 1,
             kTileH + 2, kTileW + 2);
  cp_async_commit();
  float acc[2][8][4] = {};
  conv3x3_tile<2>(acc, tile, cs, kTileW, kTilePix, C, w, wbuf);
  store_tile<kBiasRelu>(acc, bias, out + img * H * W * kN, H, W, ty0, tx0);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace conv_tile
