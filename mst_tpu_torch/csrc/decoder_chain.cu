// The finest decoder level in kernels for Hopper (sm_90a): conv3x3 + bias
// + ReLU (stage A, C -> 128), conv3x3 + bias + ReLU (stage B, 128 -> 128),
// the 1x1 predictor (128 -> 4P) and the packed online soft-argmax, for
// x (KB, Hp, Wp, C) bf16 NHWC -> out (KB, 2, P) f32, the full-resolution
// (X, Y) of each of the P channels. Packed channel (si * 2 + sj) * P + p of
// pixel (i, j) is the logit at full-resolution (x = 2j + sj, y = 2i + si).
// Two designs, the counterparts of the two TPU kernels of
// benchmarks/pallas_chain_probe.py:
//
//   chain_plane   replaces pallas_chain (:233, body `_kernel` :72). The TPU
//                 kept the stage-A plane in VMEM (176 x 240 x 128 bf16 =
//                 10.8 MB an image); no SM holds that, so a stage-A kernel
//                 (the taps loop of conv_wgmma.cuh with a bias + ReLU
//                 epilogue) writes it to a scratch buffer in device memory,
//                 a group of images at a time, sized by the wrapper so that
//                 the group's planes stay in the 50 MB L2. A tail kernel
//                 runs the taps loop over the planes (TMA's zero fill
//                 outside the image is stage B's SAME padding) with the
//                 chain's tail as its epilogue.
//   chain_stream  replaces pallas_chain_v2 (:199, body `_kernel_v2` :127).
//                 One persistent kernel: each block brings x with a 2-pixel
//                 halo by TMA, computes the 18 x 18 stage-A pixels around
//                 its 16 x 16 tile into a swizzled shared-memory tile, runs
//                 stage B from there with the taps addressing, then the
//                 chain's tail: no intermediate leaves the SM.
//
// Bound on an H100 at the probe's shape (KB 160, 176 x 240, C 64, P 12):
// operations. 2 * 6,758,400 px * (9*64*128 + 9*128*128 + 128*48) =
// 3.073e12 FLOP is 3.11 ms at 989 TFLOP/s dense bf16; x and the weights,
// 0.87 GB, take 0.26 ms at 3.35 TB/s.
//
// Design (building blocks in conv_wgmma.cuh): 384 threads, a producer
// warpgroup (one thread issues TMA; 40 registers by setmaxnreg) and two
// consumer warpgroups (232 registers) of two m64 tiles each; wgmma
// m64n128k16 with A from registers by ldmatrix; the weights re-laid
// K-major by the wrapper and streamed in 16 KB blocks of 64 K rows through
// a 3-stage mbarrier ring; each 64-row K block summed in a fresh fragment
// and added with a rounded f32 add (add_block); 16 x 16 output tiles in a
// persistent grid, so each weight block read from L2 feeds 256 pixels
// (the first 8 x 16 tiles fed 128).
//
// The chain's tail (ChainTail): stage B's f32 sums get bias + ReLU and are
// rounded to bf16 in registers, and packed in pairs they are already the
// register A fragments of the predictor's k16 steps: elements 4(2s) +
// {0,1}, 4(2s) + {2,3}, 4(2s+1) + {0,1} and 4(2s+1) + {2,3} of an m64n128
// accumulator are a[0..3] of k16 step s (FlashAttention-3's P.V trick), so
// stage B's output never goes to shared memory. The predictor runs as
// wgmma m64n64k16 against its K-major copy in shared memory, zero-padded
// to 64 columns (one instruction shape for every 4P <= 64; columns >= 4P
// are ignored). The consumers write the f32 logits to a shared-memory
// tile and go on to the next tile; two warps of the producer warpgroup,
// idle otherwise, reduce it (chain_stats: one packed channel a thread,
// 8 pixels of a row at a time) behind two mbarriers. Reducing in the
// consumers, by shuffles across the lanes of each warp and a merge of the
// 8 warps, kept the tensor cores idle meanwhile and ran slower.
//
// chain_plane runs plane_group(...) images at a time (the wrapper): each
// group is one persistent launch of each kernel, whose last round of tiles
// leaves SMs idle unless the group's tiles fill whole rounds, so the
// wrapper takes the group size, of those whose planes fit L2, that wastes
// the fewest rounds (4 images = 660 tiles = 5 x 132 at the probe's shape).
//
// Shared memory (a block may use 232,448 B): the taps loop takes 218,112 B
// at C = 128 with a double-buffered halo; the tail adds the predictor
// (16 KB) and the logits tile (72 KB). chain_plane's tail single-buffers
// the halo instead (226,064 B): its producer loads the next tile's halo
// while the consumers run the tail, which covers most of that load.
// chain_stream (202,576 B) holds the stage-A tile (2 x 41,984 B, which
// also takes the logits once stage B has read it), one 64-channel block of
// x (20 x 20 pixels, 51,200 B; at C > 64 the channel blocks come one at a
// time, stage A's K loop ordered channel-block first), the ring and the
// tail's constants.
//
// chain_stream's stage A covers 324 pixels = 6 m64 tiles, 3 a warpgroup,
// but 3 totals and a fragment would take 256 registers. It runs in two
// passes, m64 tiles {2g, 2g+1} and then {4 + g}, streaming wa twice; the
// second pass reuses the x block that the first pass ends on.
//
// Border semantics: stage-A values outside the image are zero before
// stage B reads them (SAME padding of stage B's input), not relu(ba),
// which is what a zero input would give. chain_plane gets that from TMA's
// zero fill around the plane; chain_stream zeroes the stage-A pixels that
// fall outside the image, on all four sides.
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

#include <climits>

#include "conv_wgmma.cuh"
#include "online_softmax.cuh"

namespace {

using namespace conv_wgmma;
using online_softmax::Stats;

constexpr int kMaxN4 = 64;                       // packed predictor columns
constexpr int kPredBlkBytes = kMaxN4 * kRowBytes;  // one K block: 8 KB
constexpr int kLStride = kMaxN4 + 8;  // f32 row of the logits tile: the
                                      // half-warps' 8-byte stores are
                                      // free of bank conflicts
constexpr int kLogitBytes = kTilePix * kLStride * 4;  // 73,728
constexpr int kStatsWarp0 = kConsumerWarps + 1;  // producer warpgroup's
constexpr int kStatsThreads = kMaxN4;            // warps 1 and 2: a column
                                                 // a thread

// The tail's constants and barriers in shared memory (1024-aligned).
struct ChainSmem {
  // the predictor, K-major (kMaxN4 rows of K = 128), as 2 swizzled K blocks
  unsigned char wp[kN / kKB][kPredBlkBytes];
  float bias_b[kN];
  float bias_p[kMaxN4];
  uint64_t logits_full;   // the consumers wrote a tile's logits
  uint64_t logits_empty;  // the statistics threads read them

  __device__ void init_bars() {
    mbar_init(&logits_full, kConsumers * 128);
    mbar_init(&logits_empty, kStatsThreads);
  }
};

// The predictor (wpk: (kMaxN4, kN) bf16, K-major, zero rows past 4P) into
// its swizzled K blocks, and the biases; every thread of the block, before
// the barrier that publishes them.
__device__ __forceinline__ void load_chain_consts(ChainSmem* cs,
                                                  const bf16* __restrict__ wpk,
                                                  const float* __restrict__ bb,
                                                  const float* __restrict__ bp,
                                                  int n4) {
  constexpr int kChunks = kN / 8;  // 16-byte chunks of a predictor row
  for (int i = threadIdx.x; i < kMaxN4 * kChunks; i += blockDim.x) {
    const int n = i / kChunks;
    const int ch = i % kChunks;
    const uint4 v = reinterpret_cast<const uint4*>(wpk)[i];
    *reinterpret_cast<uint4*>(cs->wp[ch / 8] + n * kRowBytes +
                              (((ch & 7) ^ (n & 7)) << 4)) = v;
  }
  for (int c = threadIdx.x; c < kN; c += blockDim.x) cs->bias_b[c] = bb[c];
  for (int c = threadIdx.x; c < kMaxN4; c += blockDim.x) {
    cs->bias_p[c] = c < n4 ? bp[c] : 0.f;
  }
  fence_proxy_async();  // wgmma reads the predictor through the async proxy
}

// The tile count of a persistent block at tile `tile`.
__device__ __forceinline__ int tile_iter(int tile) {
  return (tile - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x);
}

// The consumers' share of the chain's tail on one tile (see the note
// above): warpgroup g's stage-B sums acc[t] -> bias + ReLU + bf16 in
// registers -> the predictor by wgmma -> the f32 logits (without bpred)
// into the tile `logits` [pixel][kLStride], once the statistics threads
// have read the previous tile's.
struct ChainTail {
  ChainSmem* cs;
  float* logits;

  __device__ __forceinline__ void operator()(float (&acc)[2][64],
                                             TileCoord /*tc*/, int tile,
                                             int g) const {
    const int tid = thread_x();
    const int lane = tid & 31;
    const int q = lane & 3;
    float logit[2][32];
    uint32_t a[2][8][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = 8 * i + 2 * q;
        const float b0 = cs->bias_b[c];
        const float b1 = cs->bias_b[c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * i + 2 * h;
          a[t][i / 2][2 * (i & 1) + h] = pack_bf16(
              fmaxf(acc[t][e] + b0, 0.f), fmaxf(acc[t][e + 1] + b1, 0.f));
        }
      }
    }
    const uint64_t d0 = desc_sw128(cs->wp[0]);
    const uint64_t d1 = desc_sw128(cs->wp[1]);
#pragma unroll
    for (int t = 0; t < 2; ++t) fence_operands(logit[t]);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        wgmma_rs_n64(logit[t], a[t][s], desc_step(s < 4 ? d0 : d1, s & 3),
                     s);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 2; ++t) fence_operands(logit[t]);

    // element 4i + 2h + e of m64 tile t is pixel tile_pixel(g, t, 16w +
    // lane / 4 + 8h), column 8i + 2q + e
    mbar_wait(&cs->logits_empty, (tile_iter(tile) & 1) ^ 1);
    const int w = (tid >> 5) & 3;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row =
            logits + tile_pixel(g, t, 16 * w + lane / 4 + 8 * h) * kLStride;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          *reinterpret_cast<float2*>(row + 8 * i + 2 * q) =
              make_float2(logit[t][4 * i + 2 * h], logit[t][4 * i + 2 * h + 1]);
        }
      }
    }
    mbar_arrive(&cs->logits_full);
  }
};

// The statistics threads (kStatsThreads of the producer warpgroup, column
// c each) on every tile of the block: once the logits are whole, the
// online (m, s, sx, sy) of column c over the tile's pixels inside the image,
// 8 pixels of a row at a time (8 independent loads, a max tree, one
// rescale), the coordinates relative to the tile's corner until the end;
// the partial to part + tile * n4 * 4; then the logits are free.
__device__ __forceinline__ void chain_stats(ChainSmem* cs,
                                            const float* logits, int c,
                                            float* __restrict__ part, int H,
                                            int W, int n4, int tiles_h,
                                            int tiles_w, int n_tiles) {
  for (int tile = blockIdx.x, it = 0; tile < n_tiles;
       tile += gridDim.x, ++it) {
    const TileCoord tc = tile_coord(tile, tiles_h, tiles_w);
    mbar_wait(&cs->logits_full, it & 1);
    if (c < n4) {
      const int rows = min(kTile, H - tc.y0);
      const int cols = min(kTile, W - tc.x0);
      float m = -CUDART_INF_F, s = 0.f, sx = 0.f, sy = 0.f;
      for (int j = 0; j < rows; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* px = logits + (kTile * j + 8 * half) * kLStride + c;
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            v[u] = 8 * half + u < cols ? px[u * kLStride] : -CUDART_INF_F;
          }
          const float mh =
              fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])),
                    fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
          if (mh > m) {  // a new maximum: rescale what came before
            const float f = __expf(m - mh);
            s *= f;
            sx *= f;
            sy *= f;
            m = mh;
          }
          float sh = 0.f, sxh = 0.f;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float e = __expf(v[u] - m);  // 0 outside the image
            sh += e;
            sxh = fmaf(e, static_cast<float>(8 * half + u), sxh);
          }
          s += sh;
          sx += sxh;
          sy = fmaf(sh, static_cast<float>(j), sy);
        }
      }
      const float x0 = static_cast<float>(tc.x0);
      const float y0 = static_cast<float>(tc.y0);
      *reinterpret_cast<float4*>(
          part + (static_cast<long long>(tile) * n4 + c) * 4) =
          make_float4(m + cs->bias_p[c], s, fmaf(x0, s, sx),
                      fmaf(y0, s, sy));
    }
    mbar_arrive(&cs->logits_empty);
  }
}

// ---- chain_plane

__host__ __device__ constexpr int plane_tail_offset() {
  return round_up(taps_bytes<1>(kN), 1024);
}

__host__ __device__ constexpr int stage_a_smem_bytes(int C) {
  return 1024 + taps_bytes<2>(C);
}

__host__ __device__ constexpr int plane_tail_smem_bytes() {
  return 1024 + plane_tail_offset() + static_cast<int>(sizeof(ChainSmem)) +
         kLogitBytes;
}

// Stage A of images img0 .. img0 + the group's images (xmap: all KB
// images) into the group's planes: the taps loop, bias + ReLU epilogue.
__global__ void __launch_bounds__(kThreads, 1)
chain_plane_stage_a(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ ba, bf16* __restrict__ plane,
                    int H, int W, int C, int img0, int tiles_h, int tiles_w,
                    int n_tiles) {
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
      taps_produce<2>(&xmap, &wmap, smem, C, img0, tiles_h, tiles_w,
                      n_tiles);
    }
    return;
  }
  consumer_regs();
  taps_consume<2>(smem, C, tiles_h, tiles_w, n_tiles,
                  StoreTile<true>{plane, H, W, ba});
}

// Stage B on the group's planes (pmap, 128 channels), the predictor and
// the statistics: the taps loop, one halo buffer, ChainTail epilogue.
// part: the group's first image's partials.
__global__ void __launch_bounds__(kThreads, 1)
chain_plane_tail(const __grid_constant__ CUtensorMap pmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const bf16* __restrict__ wpk, const float* __restrict__ bb,
                 const float* __restrict__ bpred, float* __restrict__ part,
                 int H, int W, int n4, int tiles_h, int tiles_w,
                 int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto* cs = reinterpret_cast<ChainSmem*>(smem + plane_tail_offset());
  float* logits = reinterpret_cast<float*>(cs + 1);
  load_chain_consts(cs, wpk, bb, bpred, n4);
  if (threadIdx.x == 0) {
    taps_bars<1>(smem, kN)->init();
    cs->init_bars();
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp >= kConsumerWarps) {  // the producer warpgroup
    producer_regs();
    if (warp == kConsumerWarps && (threadIdx.x & 31) == 0) {
      taps_produce<1>(&pmap, &wmap, smem, kN, 0, tiles_h, tiles_w, n_tiles);
    } else if (warp >= kStatsWarp0 && warp < kStatsWarp0 + 2) {
      chain_stats(cs, logits, threadIdx.x - kStatsWarp0 * 32, part, H, W,
                  n4, tiles_h, tiles_w, n_tiles);
    }
    return;
  }
  consumer_regs();
  taps_consume<1>(smem, kN, tiles_h, tiles_w, n_tiles,
                  ChainTail{cs, logits});
}

// ---- chain_stream

constexpr int kXHalo = kTile + 4;                         // 20: x tile side
constexpr int kXBytes = kXHalo * kXHalo * kRowBytes;      // 51,200
constexpr int kAPix = kHalo * kHalo;                      // 324 stage-A px
constexpr int kATileBytes = 2 * kHaloBlkBytes;            // 128 channels
constexpr int kStreamRingOff = kATileBytes + kXBytes;     // 1024-aligned
constexpr int kStreamCsOff = kStreamRingOff + kTapsStages * kWBlockBytes;

static_assert(kLogitBytes <= kATileBytes, "the tail's logits reuse the "
              "stage-A tile");

struct StreamBars {
  Ring<kTapsStages> w;
  Ring<1> x;  // one x buffer: full when loaded, empty after its last use
};

__host__ __device__ constexpr int stream_smem_bytes() {
  return 1024 + kStreamCsOff + static_cast<int>(sizeof(ChainSmem)) +
         static_cast<int>(sizeof(StreamBars));
}

// One pass of stage A for m64 tiles T0 .. T0 + NT - 1 (rows 64 T .. of the
// 324 stage-A pixels, row r = pixel (r / 18, r % 18) of the 18 x 18 region
// around the tile), then its epilogue into the stage-A tile: bias + ReLU
// rounded to bf16, zero outside the image, in the 128-byte swizzle (chunk
// j of pixel row r at j ^ (r % 8)) that stage B's taps addressing reads.
// Pass 0 walks x's channel blocks 0 .. cbs - 1 and pass 1 walks them back,
// starting on the block pass 0 ended on; each block's last use releases x.
template <int NT>
__device__ __forceinline__ void stage_a_pass(
    int pass, int T0, int cbs, TileCoord tc, int H, int W,
    const float* __restrict__ ba, StreamBars* bars, uint32_t xbuf,
    const unsigned char* wring, unsigned char* atile, ChainSmem* cs, int it,
    uint32_t& kit, uint32_t& xit) {
  const int tid = thread_x();
  const int lane = tid & 31;
  const int wq = (tid >> 5) & 3;
  float acc[NT][64];
  int q0[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
    // rows past the 324 pixels compute on the last one; dropped below
    int r = 64 * (T0 + t) + 16 * wq + (lane & 15);
    r = r < kAPix ? r : kAPix - 1;
    q0[t] = (r / kHalo) * kXHalo + r % kHalo;
  }
  for (int j = 0; j < cbs; ++j) {
    if (pass == 0 || j > 0) bars->x.wait_full(xit);
    for (int tap = 0; tap < 9; ++tap, ++kit) {
      const int dy = tap / 3;
      const int dx = tap - 3 * dy;
      int q[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) q[t] = q0[t] + dy * kXHalo + dx;
      taps_kblock<NT>(acc, q, xbuf, &bars->w, wring, kit);
    }
    if (pass == 1 || j < cbs - 1) {  // the last use of this x block
      if (lane == 0) bars->x.release(xit);
      ++xit;
    }
  }
  // the stage-A tile holds the last tile's logits until they are read
  if (pass == 0) mbar_wait(&cs->logits_empty, (it & 1) ^ 1);
  const int tid_e = thread_x();
  const int q = tid_e & 3;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * (T0 + t) + 16 * ((tid_e >> 5) & 3) +
                    (tid_e & 31) / 4 + 8 * h;
      if (r >= kAPix) continue;
      const int ay = r / kHalo;
      const int ax = r - ay * kHalo;
      const int y = tc.y0 - 1 + ay;
      const int x = tc.x0 - 1 + ax;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      unsigned char* row = atile + r * kRowBytes + 4 * q;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = 8 * i + 2 * q;
        const int e = 4 * i + 2 * h;
        const uint32_t v =
            in ? pack_bf16(fmaxf(acc[t][e] + __ldg(ba + c), 0.f),
                           fmaxf(acc[t][e + 1] + __ldg(ba + c + 1), 0.f))
               : 0u;
        *reinterpret_cast<uint32_t*>(row + (i / 8) * kHaloBlkBytes +
                                     (((i & 7) ^ (r & 7)) << 4)) = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
chain_stream(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wamap,
             const __grid_constant__ CUtensorMap wbmap,
             const float* __restrict__ ba, const bf16* __restrict__ wpk,
             const float* __restrict__ bb, const float* __restrict__ bpred,
             float* __restrict__ part, int H, int W, int C, int n4,
             int tiles_h, int tiles_w, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* atile = smem;
  unsigned char* xbuf = smem + kATileBytes;
  unsigned char* wring = smem + kStreamRingOff;
  auto* cs = reinterpret_cast<ChainSmem*>(smem + kStreamCsOff);
  auto* bars = reinterpret_cast<StreamBars*>(smem + kStreamCsOff +
                                             sizeof(ChainSmem));
  load_chain_consts(cs, wpk, bb, bpred, n4);
  if (threadIdx.x == 0) {
    bars->w.init(kConsumerWarps);
    bars->x.init(kConsumerWarps);
    cs->init_bars();
    mbar_fence_init();
  }
  __syncthreads();
  const int cbs = channel_blocks(C);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= kConsumerWarps) {  // the producer warpgroup
    producer_regs();
    if (warp == kConsumerWarps && lane == 0) {  // one thread issues
      const CUtensorMap* xm = &xmap;
      const CUtensorMap* wam = &wamap;
      const CUtensorMap* wbm = &wbmap;
      tma_prefetch_map(xm);
      tma_prefetch_map(wam);
      tma_prefetch_map(wbm);
      uint32_t kit = 0, xit = 0;
      auto load_x = [&](int tile, int cb) {
        const TileCoord tc = tile_coord(tile, tiles_h, tiles_w);
        bars->x.acquire(xit, kXBytes);
        tma_load_4d(xbuf, xm, &bars->x.full[0], cb * kKB, tc.x0 - 2,
                    tc.y0 - 2, tc.img);
        ++xit;
      };
      auto load_w = [&](const CUtensorMap* map, int kb) {
        bars->w.acquire(kit, kWBlockBytes);
        tma_load_2d(wring + (kit % kTapsStages) * kWBlockBytes, map,
                    &bars->w.full[kit % kTapsStages], kb * kKB, 0);
        ++kit;
      };
      if (static_cast<int>(blockIdx.x) < n_tiles) load_x(blockIdx.x, 0);
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int pass = 0; pass < 2; ++pass) {
          for (int j = 0; j < cbs; ++j) {
            const int cb = pass == 0 ? j : cbs - 1 - j;
            if (j > 0) load_x(tile, cb);  // j = 0: loaded or kept
            for (int tap = 0; tap < 9; ++tap) load_w(wam, tap * cbs + cb);
          }
        }
        // the next tile's first x block loads while stage B runs
        if (tile + static_cast<int>(gridDim.x) < n_tiles) {
          load_x(tile + gridDim.x, 0);
        }
        for (int kb = 0; kb < 9 * (kN / kKB); ++kb) load_w(wbm, kb);
      }
    } else if (warp >= kStatsWarp0 && warp < kStatsWarp0 + 2) {
      // the tail's logits reuse the stage-A tile, free after stage B
      chain_stats(cs, reinterpret_cast<const float*>(atile),
                  threadIdx.x - kStatsWarp0 * 32, part, H, W, n4, tiles_h,
                  tiles_w, n_tiles);
    }
    return;
  }

  consumer_regs();
  const int g = warp >> 2;
  const int wq = warp & 3;
  const uint32_t a_u32 = smem_u32(atile);
  // the tail's logits reuse the stage-A tile, free after stage B's reads
  const ChainTail tail{cs, reinterpret_cast<float*>(atile)};
  uint32_t kit = 0, xit = 0;
  for (int tile = blockIdx.x, it = 0; tile < n_tiles;
       tile += gridDim.x, ++it) {
    const TileCoord tc = tile_coord(tile, tiles_h, tiles_w);
    stage_a_pass<2>(0, 2 * g, cbs, tc, H, W, ba, bars, smem_u32(xbuf), wring,
                    atile, cs, it, kit, xit);
    stage_a_pass<1>(1, 4 + g, cbs, tc, H, W, ba, bars, smem_u32(xbuf), wring,
                    atile, cs, it, kit, xit);
    consumer_sync();  // the stage-A tile is whole
    float acc[2][64];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
    }
    for (int kb = 0; kb < 9 * (kN / kKB); ++kb, ++kit) {
      const int tap = kb / 2;
      const int dy = tap / 3;
      const int dx = tap - 3 * dy;
      int q[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        q[t] = (g * 8 + t * 4 + wq + dy) * kHalo + (lane & 15) + dx;
      }
      taps_kblock<2>(acc, q, a_u32 + (kb & 1) * kHaloBlkBytes, &bars->w,
                     wring, kit);
    }
    consumer_sync();  // stage B's last read: the tail may reuse the tile
    tail(acc, tc, tile, g);
  }
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
  return ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
}

bool bad_shape(int KB, int H, int W, int C, int P) {
  return C % 32 != 0 || C < 32 || C > kMaxC || P < 1 || 4 * P > kMaxN4 ||
         KB < 1 || H < 1 || W < 1 ||
         static_cast<long long>(KB) * tiles_of(H, W) > INT_MAX;
}

int launch_merge(const float* part, float* out, int KB, int H, int W, int P,
                 float eps, cudaStream_t stream) {
  chain_merge<<<KB, kMaxN4, 0, stream>>>(part, out, tiles_of(H, W), P, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Common arguments: x (KB, H, W, C) bf16; wak (128, 9 Cp) and wbk (128,
// 1152) bf16, the K-major conv weights (row co, column tap * Cp + ci, Cp =
// C rounded up to 64, zero where ci >= C); ba, bb (128) f32; wpk (64, 128)
// bf16, the K-major predictor (row n = packed channel, zero rows past 4P);
// bpred (4P) f32; part: scratch of KB * decoder_chain_tiles(H, W) * 4P * 4
// f32; out (KB, 2, P) f32. All contiguous, 16-byte aligned; C % 32 == 0,
// C <= 128, 4P <= 64. Each returns 0 on success, else the cudaError_t of
// its launches, or 999 (no cuTensorMapEncodeTiled) or 1000 + CUresult (a
// refused tensor map).

// The output tiles (16 x 16 pixels) of one image, each writing one set of
// partials.
int decoder_chain_tiles(int H, int W) { return tiles_of(H, W); }

// plane: scratch of group * H * W * 128 bf16; images run `group` at a time.
int chain_plane_launch(const void* x, const void* wak, const float* ba,
                       const void* wbk, const float* bb, const void* wpk,
                       const float* bpred, void* plane, float* part,
                       float* out, int KB, int H, int W, int C, int P,
                       int group, float eps, void* stream_ptr) {
  if (bad_shape(KB, H, W, C, P) || group < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  CUtensorMap xmap, wamap, pmap, wbmap;
  const int ka = 9 * channel_blocks(C) * kKB;
  int err = map_nhwc(&xmap, x, KB, H, W, C, kHalo, kHalo);
  if (err == 0) err = map_kmajor_weight(&wamap, wak, ka);
  if (err == 0) err = map_nhwc(&pmap, plane, group, H, W, kN, kHalo, kHalo);
  if (err == 0) err = map_kmajor_weight(&wbmap, wbk, 9 * kN);
  if (err != 0) return err;
  const int smem_a = stage_a_smem_bytes(C);
  const int smem_b = plane_tail_smem_bytes();
  cudaError_t cerr = allow_smem(chain_plane_stage_a, smem_a);
  if (cerr == cudaSuccess) cerr = allow_smem(chain_plane_tail, smem_b);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int tiles_h = (H + kTile - 1) / kTile;
  const int tiles_w = (W + kTile - 1) / kTile;
  const int per_img = tiles_h * tiles_w;
  const int n4 = 4 * P;
  int grid_full = 0;
  cerr = persistent_grid(static_cast<long long>(group) * per_img, &grid_full);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  for (int g0 = 0; g0 < KB; g0 += group) {
    const int n_tiles = (KB - g0 < group ? KB - g0 : group) * per_img;
    const int grid = n_tiles < grid_full ? n_tiles : grid_full;
    chain_plane_stage_a<<<grid, kThreads, smem_a, stream>>>(
        xmap, wamap, ba, static_cast<bf16*>(plane), H, W, C, g0, tiles_h,
        tiles_w, n_tiles);
    chain_plane_tail<<<grid, kThreads, smem_b, stream>>>(
        pmap, wbmap, static_cast<const bf16*>(wpk), bb, bpred,
        part + static_cast<long long>(g0) * per_img * n4 * 4, H, W, n4,
        tiles_h, tiles_w, n_tiles);
    cerr = cudaGetLastError();
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
  }
  return launch_merge(part, out, KB, H, W, P, eps, stream);
}

int chain_stream_launch(const void* x, const void* wak, const float* ba,
                        const void* wbk, const float* bb, const void* wpk,
                        const float* bpred, float* part, float* out, int KB,
                        int H, int W, int C, int P, float eps,
                        void* stream_ptr) {
  if (bad_shape(KB, H, W, C, P)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  CUtensorMap xmap, wamap, wbmap;
  int err = map_nhwc(&xmap, x, KB, H, W, C, kXHalo, kXHalo);
  if (err == 0) {
    err = map_kmajor_weight(&wamap, wak, 9 * channel_blocks(C) * kKB);
  }
  if (err == 0) err = map_kmajor_weight(&wbmap, wbk, 9 * kN);
  if (err != 0) return err;
  const int smem = stream_smem_bytes();
  cudaError_t cerr = allow_smem(chain_stream, smem);
  const int tiles_h = (H + kTile - 1) / kTile;
  const int tiles_w = (W + kTile - 1) / kTile;
  const int n_tiles = KB * tiles_h * tiles_w;
  int grid = 0;
  if (cerr == cudaSuccess) cerr = persistent_grid(n_tiles, &grid);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  chain_stream<<<grid, kThreads, smem, stream>>>(
      xmap, wamap, wbmap, ba, static_cast<const bf16*>(wpk), bb, bpred, part,
      H, W, C, 4 * P, tiles_h, tiles_w, n_tiles);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return launch_merge(part, out, KB, H, W, P, eps, stream);
}

// Dynamic shared memory of a block for C input channels (ptxas -v reports
// only the static part): kernel 0 = chain_plane_stage_a,
// 1 = chain_plane_tail, 2 = chain_stream.
int decoder_chain_smem_bytes(int kernel, int C) {
  return kernel == 0   ? stage_a_smem_bytes(C)
         : kernel == 1 ? plane_tail_smem_bytes()
                       : stream_smem_bytes();
}

}  // extern "C"
