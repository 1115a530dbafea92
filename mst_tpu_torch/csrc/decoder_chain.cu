// The finest decoder level in kernels for Hopper (sm_90a): conv3x3 + bias
// + ReLU (stage A, C -> 128), conv3x3 + bias + ReLU (stage B, 128 -> 128),
// the 1x1 predictor (128 -> 4P) and the packed online soft-argmax, for
// x (KB, Hp, Wp, C) bf16 NHWC and HWIO weights -> out (KB, 2, P) f32, the
// full-resolution (X, Y) of each of the P channels. Packed channel
// (si * 2 + sj) * P + p of pixel (i, j) is the logit at full-resolution
// (x = 2j + sj, y = 2i + si). Two designs, the counterparts of the two TPU
// kernels of benchmarks/pallas_chain_probe.py:
//
//   chain_plane   replaces pallas_chain (:233, body `_kernel` :72). The TPU
//                 kept the stage-A plane in VMEM (176 x 240 x 128 bf16 =
//                 10.8 MB an image); no SM holds that, so stage A writes it
//                 once to a scratch buffer in device memory, a group of
//                 images at a time, sized by the wrapper so that the group's
//                 planes stay in the 50 MB L2. A second kernel reads them
//                 back with halos for stage B, the predictor and the
//                 statistics.
//   chain_stream  replaces pallas_chain_v2 (:199, body `_kernel_v2` :127).
//                 Each block stages x with a 2-pixel halo, recomputes the
//                 stage-A values of its tile plus a 1-pixel halo in shared
//                 memory, and runs stage B, the predictor and the
//                 statistics from there: no intermediate leaves the SM.
//
// Bound on an H100 at the probe's shape (KB 160, 176 x 240, C 64, P 12):
// operations. 2 * 6,758,400 px * (9*64*128 + 9*128*128 + 128*48) =
// 3.073e12 FLOP is 3.11 ms at 989 TFLOP/s dense bf16; x and the weights,
// 0.87 GB, take 0.26 ms at 3.35 TB/s.
//
// Border semantics: stage-A values outside the image are zero before
// stage B reads them (SAME padding of stage B's input), not relu(ba),
// which is what a zero input would give. chain_plane gets that from the
// zero-filled halo of its staged plane tile; chain_stream zeroes the
// recomputed halo pixels that fall outside the image, on all four sides.
//
// Rounding points as the TPU kernels: stage A and stage B are rounded to
// bf16 after bias and ReLU in f32; the logits stay f32.
//
// Blocks run in no order, so the TPU's carry of (m, s, sx, sy) across a
// sequential grid axis becomes per-(image, tile) partial statistics for
// the 4P packed channels, merged by a second launch with max-rescaling and
// the unify_packed_stats epilogue (no atomics: the result does not change
// from run to run). Packed coordinates: column j, row i of the packed
// plane; the four sub-positions are unified only at the end.
//
// Shared memory (conv_tile.cuh has the conv's): per block 8 x 16 output
// pixels; the stage-A tile 10 x 18 x 136 bf16 (49 KB, reused for the f32
// logits), stage B's output 128 x 136 bf16 (35 KB; in chain_stream it
// reuses the x tile), the weight chunk buffers (17 KB), the predictor
// padded to 64 columns (18 KB): about 125 KB, one block of 8 warps an SM.

#include "conv_tile.cuh"
#include "online_softmax.cuh"

namespace {

using namespace conv_tile;
using online_softmax::Stats;

constexpr int kMaxN4 = 64;                // packed predictor channels 4P
constexpr int kPStride = kMaxN4 + kPad;   // smem row stride of the predictor
constexpr int kLStride = kMaxN4 + 4;      // smem row stride of the logits
constexpr int kATileElems = (kTileH + 2) * (kTileW + 2) * kWStride;
constexpr int kBTileElems = kTilePix * kWStride;

// The predictor (128 x n4, zero-padded to kMaxN4 columns) and its bias into
// shared memory; plain loads, visible after the caller's next barrier.
__device__ __forceinline__ void load_predictor(bf16* wp, float* bp,
                                               const bf16* __restrict__ wpred,
                                               const float* __restrict__ bpred,
                                               int n4) {
  for (int i = threadIdx.x; i < kN * kMaxN4; i += kThreads) {
    const int r = i / kMaxN4;
    const int c = i - r * kMaxN4;
    wp[r * kPStride + c] = c < n4 ? wpred[r * n4 + c] : __float2bfloat16(0.f);
  }
  for (int c = threadIdx.x; c < kMaxN4; c += kThreads) {
    bp[c] = c < n4 ? bpred[c] : 0.f;
  }
}

// acc (this warp's share of a 128-pixel x 128-channel conv) + bias, ReLU,
// rounded to bf16, into a [pixel][kWStride] tile.
__device__ __forceinline__ void store_relu(const float (&acc)[2][8][4],
                                           const float* bias, bf16* dst) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = acc_row(wm * 2 + mt, half * 2);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = wn * 64 + acc_col(nt, 0);
        *reinterpret_cast<__nv_bfloat162*>(dst + p * kWStride + col) =
            __floats2bfloat162_rn(
                fmaxf(acc[mt][nt][half * 2] + bias[col], 0.f),
                fmaxf(acc[mt][nt][half * 2 + 1] + bias[col + 1], 0.f));
      }
    }
  }
}

// The 1x1 predictor on stage B's bf16 tile (128 pixels x 128 channels),
// f32 logits into shared memory, then this tile's online statistics of
// each packed channel over its pixels inside the image, written to
// part[c * 4 + {m, s, sx, sy}]. Starts after a barrier that made btile
// visible; logits may alias any smem no longer read.
__device__ __forceinline__ void predict_stats(const bf16* btile,
                                              const bf16* wp, const float* bp,
                                              float* logits, Stats* red,
                                              int n4, int H, int W, int ty0,
                                              int tx0, float* part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  float acc[2][4][4] = {};
  for (int k = 0; k < kN; k += kKC) {
    const bf16* a_row[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      a_row[mt] = btile + ((wm * 2 + mt) * 16 + (lane & 15)) * kWStride +
                  (lane >> 4) * 8 + k;
    }
    warp_mma<2, 4>(acc, a_row, wp + k * kPStride, kPStride, wn * 32);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = wn * 32 + acc_col(nt, i);
        logits[acc_row(wm * 2 + mt, i) * kLStride + col] =
            acc[mt][nt][i] + bp[col];
      }
    }
  }
  __syncthreads();

  // four threads a column, 32 pixels each
  const int col = threadIdx.x % kMaxN4;
  const int q = threadIdx.x / kMaxN4;
  Stats st = online_softmax::empty();
  if (col < n4) {
    for (int p = q * 32; p < q * 32 + 32; ++p) {
      const int y = ty0 + p / kTileW;
      const int x = tx0 + p % kTileW;
      if (y >= H || x >= W) continue;
      online_softmax::push(st, logits[p * kLStride + col],
                           static_cast<float>(x), static_cast<float>(y));
    }
  }
  red[q * kMaxN4 + col] = st;
  __syncthreads();
  if (threadIdx.x < n4) {
    Stats a = red[threadIdx.x];
    for (int k = 1; k < kThreads / kMaxN4; ++k) {
      a = online_softmax::merge(a, red[k * kMaxN4 + threadIdx.x]);
    }
    float* o = part + threadIdx.x * 4;
    o[0] = a.m;
    o[1] = a.s;
    o[2] = a.sx;
    o[3] = a.sy;
  }
}

// biases (ba, bb, bpred) and the statistics' reduction buffer
constexpr int kMiscBytes =
    (2 * kN + kMaxN4) * static_cast<int>(sizeof(float)) +
    kThreads * static_cast<int>(sizeof(Stats));
// the stage-A tile, the weight chunk buffers and the predictor
constexpr int kCommonBytes =
    (kATileElems + 2 * kWChunkElems + kN * kPStride) *
        static_cast<int>(sizeof(bf16)) +
    kMiscBytes;

constexpr int plane_tail_smem_bytes() {
  return kCommonBytes + kBTileElems * static_cast<int>(sizeof(bf16));
}

__host__ __device__ constexpr int x_tile_elems(int C) {
  return (kTileH + 4) * (kTileW + 4) * (C + kPad);
}

__host__ __device__ constexpr int stream_smem_bytes(int C) {
  return kCommonBytes + (x_tile_elems(C) > kBTileElems ? x_tile_elems(C)
                                                       : kBTileElems) *
                            static_cast<int>(sizeof(bf16));
}

// chain_plane, stage A: a group of images' planes into the scratch buffer.
__global__ void __launch_bounds__(kThreads, 2)
chain_plane_stage_a(const bf16* __restrict__ x, const bf16* __restrict__ wa,
                    const float* __restrict__ ba, bf16* __restrict__ plane,
                    int H, int W, int C, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  conv3x3_taps_block<true>(x, wa, ba, plane, H, W, C, tiles_w, smem);
}

// chain_plane, the rest: stage B from the plane (halo rows and columns
// read back, zero outside the image), predictor, statistics. Grid: (tiles,
// images of the group); part is the group's first image's partials.
__global__ void __launch_bounds__(kThreads, 1)
chain_plane_tail(const bf16* __restrict__ plane, const bf16* __restrict__ wb,
                 const float* __restrict__ bb, const bf16* __restrict__ wpred,
                 const float* __restrict__ bpred, float* __restrict__ part,
                 int H, int W, int n4, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* atile = reinterpret_cast<bf16*>(smem);
  bf16* wbuf = atile + kATileElems;
  bf16* wp = wbuf + 2 * kWChunkElems;
  bf16* btile = wp + kN * kPStride;
  float* sbb = reinterpret_cast<float*>(btile + kBTileElems);
  float* sbp = sbb + kN;
  Stats* red = reinterpret_cast<Stats*>(sbp + kMaxN4);

  const long long img = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  load_predictor(wp, sbp, wpred, bpred, n4);
  for (int c = threadIdx.x; c < kN; c += kThreads) sbb[c] = bb[c];
  stage_tile(atile, kWStride, plane + img * H * W * kN, H, W, kN, ty0 - 1,
             tx0 - 1, kTileH + 2, kTileW + 2);
  cp_async_commit();
  float acc[2][8][4] = {};
  conv3x3_tile<2>(acc, atile, kWStride, kTileW, kTilePix, kN, wb, wbuf);
  store_relu(acc, sbb, btile);
  __syncthreads();
  predict_stats(btile, wp, sbp, reinterpret_cast<float*>(atile), red, n4, H,
                W, ty0, tx0,
                part + (img * gridDim.x + blockIdx.x) * n4 * 4);
}

// chain_stream: the whole chain for one 8 x 16 tile. Grid: (tiles, KB).
__global__ void __launch_bounds__(kThreads, 1)
chain_stream(const bf16* __restrict__ x, const bf16* __restrict__ wa,
             const float* __restrict__ ba, const bf16* __restrict__ wb,
             const float* __restrict__ bb, const bf16* __restrict__ wpred,
             const float* __restrict__ bpred, float* __restrict__ part,
             int H, int W, int C, int n4, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = C + kPad;
  bf16* atile = reinterpret_cast<bf16*>(smem);
  bf16* wbuf = atile + kATileElems;
  bf16* wp = wbuf + 2 * kWChunkElems;
  bf16* xtile = wp + kN * kPStride;  // later stage B's output tile
  const int region = x_tile_elems(C) > kBTileElems ? x_tile_elems(C)
                                                   : kBTileElems;
  float* sba = reinterpret_cast<float*>(xtile + region);
  float* sbb = sba + kN;
  float* sbp = sbb + kN;
  Stats* red = reinterpret_cast<Stats*>(sbp + kMaxN4);

  const long long img = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  load_predictor(wp, sbp, wpred, bpred, n4);
  for (int c = threadIdx.x; c < kN; c += kThreads) {
    sba[c] = ba[c];
    sbb[c] = bb[c];
  }
  stage_tile(xtile, cs, x + img * H * W * C, H, W, C, ty0 - 2, tx0 - 2,
             kTileH + 4, kTileW + 4);
  cp_async_commit();

  // stage A on the (kTileH + 2) x (kTileW + 2) pixels around the tile:
  // 180 pixels, computed as 4 warps x 3 m16 tiles = 192 rows
  constexpr int kAW = kTileW + 2;
  constexpr int kAPix = (kTileH + 2) * kAW;
  {
    float acc[3][8][4] = {};
    conv3x3_tile<3>(acc, xtile, cs, kAW, kAPix, C, wa, wbuf);
    const int warp = threadIdx.x >> 5;
    const int wm = warp & 3;
    const int wn = warp >> 2;
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = acc_row(wm * 3 + mt, half * 2);
        if (p >= kAPix) continue;
        const int y = ty0 - 1 + p / kAW;
        const int xx = tx0 - 1 + p % kAW;
        const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = wn * 64 + acc_col(nt, 0);
          // outside the image stage B must read zeros, not relu(ba)
          const float v0 =
              in ? fmaxf(acc[mt][nt][half * 2] + sba[col], 0.f) : 0.f;
          const float v1 =
              in ? fmaxf(acc[mt][nt][half * 2 + 1] + sba[col + 1], 0.f)
                 : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(atile + p * kWStride + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  // stage B on the tile (conv3x3_tile's first barrier publishes atile)
  {
    float acc[2][8][4] = {};
    conv3x3_tile<2>(acc, atile, kWStride, kTileW, kTilePix, kN, wb, wbuf);
    store_relu(acc, sbb, xtile);
  }
  __syncthreads();
  predict_stats(xtile, wp, sbp, reinterpret_cast<float*>(atile), red, n4, H,
                W, ty0, tx0,
                part + (img * gridDim.x + blockIdx.x) * n4 * 4);
}

// Merge the tiles' partials of each image and channel, then unify the four
// sub-positions (unify_packed_stats): out[img] = (X[0..P), Y[0..P)).
__global__ void chain_merge(const float* __restrict__ part,
                            float* __restrict__ out, int n_tiles, int P,
                            float eps) {
  __shared__ Stats tot[kMaxN4];
  const int img = blockIdx.x;
  const int n4 = 4 * P;
  for (int c = threadIdx.x; c < n4; c += blockDim.x) {
    Stats a = online_softmax::empty();
    for (int t = 0; t < n_tiles; ++t) {
      const float* q =
          part + ((static_cast<long long>(img) * n_tiles + t) * n4 + c) * 4;
      a = online_softmax::merge(a, Stats{q[0], q[1], q[2], q[3]});
    }
    tot[c] = a;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    float M = tot[p].m;
    for (int k = 1; k < 4; ++k) M = fmaxf(M, tot[k * P + p].m);
    float S = 0.f, X = 0.f, Y = 0.f;
    for (int k = 0; k < 4; ++k) {  // k = si * 2 + sj
      const Stats a = tot[k * P + p];
      const float scale = expf(a.m - M);
      const float sk = a.s * scale;
      S += sk;
      X += 2.f * a.sx * scale + static_cast<float>(k & 1) * sk;
      Y += 2.f * a.sy * scale + static_cast<float>(k >> 1) * sk;
    }
    const float inv = 1.f / (S + eps);
    out[(static_cast<long long>(img) * 2) * P + p] = X * inv;
    out[(static_cast<long long>(img) * 2 + 1) * P + p] = Y * inv;
  }
}

int tiles_of(int H, int W) {
  return ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
}

bool bad_shape(int KB, int H, int W, int C, int P) {
  return C % kKC != 0 || C > kMaxC || P < 1 || 4 * P > kMaxN4 || KB < 1 ||
         KB > 65535 || H < 1 || W < 1;
}

}  // namespace

extern "C" {

// Common arguments: x (KB, H, W, C) bf16; wa (3, 3, C, 128) and wb (3, 3,
// 128, 128) bf16; ba, bb (128) f32; wpred (128, 4P) bf16; bpred (4P) f32;
// part: scratch of KB * decoder_chain_tiles(H, W) * 4P * 4 f32; out
// (KB, 2, P) f32. All contiguous, 16-byte aligned; C % 32 == 0, C <= 128,
// 4P <= 64. Each returns the cudaError_t of its launches (0 = success).

// The blocks (output tiles) of one image, each writing one set of partials.
int decoder_chain_tiles(int H, int W) { return tiles_of(H, W); }

// plane: scratch of group * H * W * 128 bf16; images run `group` at a time.
int chain_plane_launch(const void* x, const void* wa, const float* ba,
                       const void* wb, const float* bb, const void* wpred,
                       const float* bpred, void* plane, float* part,
                       float* out, int KB, int H, int W, int C, int P,
                       int group, float eps, void* stream_ptr) {
  if (bad_shape(KB, H, W, C, P) || group < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int smem_a = taps_smem_bytes(C);
  const int smem_b = plane_tail_smem_bytes();
  cudaError_t err = allow_smem(chain_plane_stage_a, smem_a);
  if (err == cudaSuccess) err = allow_smem(chain_plane_tail, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int n_tiles = tiles_of(H, W);
  const int n4 = 4 * P;
  for (int g0 = 0; g0 < KB; g0 += group) {
    const int g = KB - g0 < group ? KB - g0 : group;
    dim3 grid(n_tiles, g);
    chain_plane_stage_a<<<grid, kThreads, smem_a, stream>>>(
        static_cast<const bf16*>(x) + static_cast<long long>(g0) * H * W * C,
        static_cast<const bf16*>(wa), ba, static_cast<bf16*>(plane), H, W, C,
        tiles_w);
    chain_plane_tail<<<grid, kThreads, smem_b, stream>>>(
        static_cast<const bf16*>(plane), static_cast<const bf16*>(wb), bb,
        static_cast<const bf16*>(wpred), bpred,
        part + static_cast<long long>(g0) * n_tiles * n4 * 4, H, W, n4,
        tiles_w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chain_merge<<<KB, kMaxN4, 0, stream>>>(part, out, n_tiles, P, eps);
  return static_cast<int>(cudaGetLastError());
}

int chain_stream_launch(const void* x, const void* wa, const float* ba,
                        const void* wb, const float* bb, const void* wpred,
                        const float* bpred, float* part, float* out, int KB,
                        int H, int W, int C, int P, float eps,
                        void* stream_ptr) {
  if (bad_shape(KB, H, W, C, P)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int smem = stream_smem_bytes(C);
  cudaError_t err = allow_smem(chain_stream, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int n_tiles = tiles_of(H, W);
  dim3 grid(n_tiles, KB);
  chain_stream<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wa), ba,
      static_cast<const bf16*>(wb), bb, static_cast<const bf16*>(wpred),
      bpred, part, H, W, C, 4 * P, tiles_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_merge<<<KB, kMaxN4, 0, stream>>>(part, out, n_tiles, P, eps);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a block for C input channels (ptxas -v reports
// only the static part): kernel 0 = chain_plane_stage_a,
// 1 = chain_plane_tail, 2 = chain_stream.
int decoder_chain_smem_bytes(int kernel, int C) {
  return kernel == 0   ? taps_smem_bytes(C)
         : kernel == 1 ? plane_tail_smem_bytes()
                       : stream_smem_bytes(C);
}

}  // extern "C"
