// Fused 1x1 predictor + soft-argmax for Hopper (sm_90a).
//
// Replaces the TPU kernel mst_tpu/ops/pallas/fused_predict.py:109
// (`_fused_rows` -> `pl.pallas_call` of `_kernel`, merge
// `unify_packed_stats`) in its unpacked form:
//   x (R, H, W, C) NHWC-contiguous  x  w (C, P)  +  b (P)
//   -> out (R, P, 2): per row and output channel p, the soft-argmax
//      (sx, sy) / (s + eps) of the logits x[r, :, :, :] @ w[:, p] + b[p].
// x and w are both f32 or both bf16 (a bf16 step's activations and its
// weight, as the TPU kernel casts the weight to the activations' dtype);
// bf16 values are widened in registers, and the products, sums, bias and
// statistics are f32 (the TPU kernel's f32 accumulation, :84). The
// (R, H, W, P) logits volume never reaches device memory.
//
// Bound on an H100: bytes. Reading x once is R*H*W*C*4 bytes in f32
// (3.46 GB at the eval decode's R = 160, 352 x 480, C = 32: 1.03 ms at
// 3.35 TB/s), half that in bf16 (0.52 ms); the product is 2*C*P flops a
// pixel (21 GFLOP at P = 12, 52 at P = 30: 0.3 and 0.8 ms at the 67
// TFLOP/s f32 rate). The design streams x at the memory rate and keeps
// the arithmetic under it:
//
// - A persistent grid, one block an SM (fused_predict_blocks). The R*H*W
//   pixels, flattened, are cut into one contiguous range a block; a
//   block's work items are the pieces of its range that fall in one row
//   (item_of), so every block streams the same number of bytes.
// - A ring of kStages copies. One producer thread copies each stage
//   (stage_pixels: up to 64 KB of one item's pixels, a contiguous byte
//   range) into shared memory behind full and empty mbarriers: 192 KB in
//   flight an SM. A 1-D bulk copy needs 16-byte-aligned addresses and
//   sizes, so that copy takes the aligned superset of the range (at most
//   15 bytes before and after, never across a page) and the consumers
//   index inside it.
// - The stage in shared memory without bank conflicts. At C = 32 (every
//   shipped config) with x 16-byte aligned (kSwz), the producer loads a
//   stage as 2-D TMA boxes of 256 pixels x 32 channels with the swizzle
//   of a pixel's width: in f32, 128 bytes a pixel and the 128-byte
//   swizzle, so the 16-byte chunk j of pixel r lands at chunk j ^ (r % 8);
//   in bf16, 64 bytes a pixel and the 64-byte swizzle, chunk j (8
//   channels) at j ^ ((r / 2) % 4). Lane l takes pixels l + 32 i of a
//   block of 32 kPix pixels, so at every step all lanes read the same
//   chunk j (one broadcast weight read feeds the warp) and the eight
//   lanes of a quarter warp read eight different 16-byte bank groups.
//   Other shapes take the 1-D bulk copy of the aligned superset and
//   scalar reads (any C, any element-aligned x). A first design rotated the
//   float4 index by lane over a 1-D copy: conflict-free for x, but each
//   warp then read 8 weight rows at once (4 wavefronts a read instead of
//   1), and P = 30 ran at 41% of the bound.
// - Register blocking, eight consumer warps, no spill at any P <= 32. The
//   output channels go in groups (groups, group_width): P <= 12 one group
//   and P <= 24 two of at most 12 channels, with 2 pixels a thread (kPix);
//   P <= 32 four groups of 8 channels with 4 pixels a thread (and P <= 16
//   two of 8). Warp w computes group w % groups. Each weight read from
//   shared memory feeds kPix FMAs. Nine warps an SM put three on one
//   sub-partition, so a thread has at most 168 registers: 2 pixels x 16
//   channels and 4 x 12 spilled, which is why P = 30 runs as 4 x 8 x 4.
// - The statistics in log2 units (the weights and bias carry log2 e), one
//   ex2 an exponential; for each channel a thread takes its two pixels'
//   max first and rescales once (online_softmax.cuh push_group): no branch
//   on the data.
// - The block merge in the same launch. At the end of an item the block
//   merges its threads (shuffles, then the warps in shared memory), writes
//   one partial a channel to slot block + row of the scratch, fences, and
//   counts itself in on the row's arrival counter. The block that arrives
//   last merges the row's partials in block order, writes the output and
//   resets the counter to 0 for the next call. Chosen over a second
//   launch: one launch a call, and the merge of a row overlaps the other
//   blocks' streaming.
//
// ops/kernels/fused_predict.py mirrors the work split (fused_work) and the
// merge arithmetic (fused_split_reference) for the CPU tests;
// chip_smoke.py holds the split against fused_predict_items.
//
// The partial-statistics variant (fused_predict_partial_launch) is the same
// kernel over one H slab of a spatial mesh: x holds rows [row0, row0 + H)
// of each map, each pixel's y is offset by row0, and the row's last block
// writes the merged statistics (m, s, sx, sy) in log2 units in place of
// finishing them, so that the 'space' ranks merge their slabs' statistics
// (ops/kernels/online_stats.merge_ranks) into the whole map's soft-argmax.
// Its bound is the same bytes: the slab's x read once.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_wgmma.cuh"
#include "online_softmax.cuh"

namespace {

using online_softmax::Stats;

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 3;
constexpr int kStageBytes = 64 * 1024;
// a stage buffer: 1024-byte aligned (the swizzle's period), with room for
// the 1-D copy's aligned superset
constexpr int kStageAlloc = kStageBytes + 1024;
constexpr int kBoxPixels = 256;  // TMA box: 256 pixels x 32 channels
constexpr int kSwzC = 32;        // the channel count of the swizzled path
constexpr int kMaxP = 32;
constexpr int kMaxC = 128;
constexpr float kLog2e = 1.4426950408889634f;

using StageRing = conv_wgmma::Ring<kStages>;

// ---- the work split (host and device)

__host__ __device__ inline long long range_start(long long T, int G, int b) {
  return T * b / G;
}

// The block whose range holds flat pixel q of T.
__host__ __device__ inline int block_of(long long q, long long T, int G) {
  return static_cast<int>(((q + 1) * G + T - 1) / T) - 1;
}

struct Item {
  int row, begin, end;  // pixels [begin, end) of one row
};

// Item k of block b, or false past its last.
__host__ __device__ inline bool item_of(long long T, int HW, int G, int b,
                                        int k, Item* it) {
  const long long s = range_start(T, G, b), e = range_start(T, G, b + 1);
  const long long row = s / HW + k;
  const long long r0 = row * HW;
  if (r0 >= e) return false;
  it->row = static_cast<int>(row);
  it->begin = static_cast<int>((s > r0 ? s : r0) - r0);
  it->end = static_cast<int>((e < r0 + HW ? e : r0 + HW) - r0);
  return true;
}

// Pixels a stage holds: at most 64 KB of x (eb bytes an element), in whole
// 128-pixel blocks (a warp's pixel groups at either kPix).
__host__ __device__ inline int stage_pixels(int C, int eb) {
  return kStageBytes / (eb * C) / 128 * 128;
}

// An element of x or w as f32: kEB = 4 is an f32, kEB = 2 a bf16 (its
// bits, the high half of the f32 it widens to).
template <int kEB>
struct Elem {
  using T = float;
  __device__ static float widen(T v) { return v; }
};

template <>
struct Elem<2> {
  using T = uint16_t;
  __device__ static float widen(T v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
};

// Element e (of 8) of a 16-byte chunk of bf16.
__device__ __forceinline__ float bf16_at(const uint4& u, int e) {
  const int k = e >> 1;
  const uint32_t w = k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Channel groups: P up to 12 in one, up to 24 in two, up to 32 in four (the
// warps split evenly); each group ceil(P / groups) channels rounded up to 4
// (float4 weight reads), at most 12.
__host__ __device__ inline int groups(int P) {
  return P <= 12 ? 1 : P <= 24 ? 2 : 4;
}

__host__ __device__ inline int group_width(int P) {
  return ((P + groups(P) - 1) / groups(P) + 3) / 4 * 4;
}

// Pixels a thread blocks: 4 in groups of 8 channels when there are several
// groups (a 512-pixel stage still gives every thread work), else 2 (4 x 12
// channels spilled).
__host__ __device__ inline int pixels_per_thread(int P) {
  return groups(P) > 1 && group_width(P) <= 8 ? 4 : 2;
}

// Pixel group q of a stage at kPix pixels a thread: pixels first(q) + 32 i,
// i < kPix (lane q % 32 of a block of 32 kPix pixels).
template <int kPix>
__host__ __device__ inline int first_of_group(int q) {
  return (q >> 5) * 32 * kPix + (q & 31);
}

// Byte offsets into dynamic shared memory past its 1024-aligned start: the
// stages, the padded weights (group, 4-channel block, channel, output; 4
// floats of padding a block), the bias, the warps' partials, the ring, the
// last-arrival flag. total includes the 1024 bytes of alignment slack.
struct Layout {
  int w, b, red, ring, flag, total;
  __host__ __device__ Layout(int C, int P) {
    const int pc = group_width(P), g = groups(P), cq = (C + 3) / 4;
    w = kStages * kStageAlloc;
    b = w + g * cq * (4 * pc + 4) * 4;
    red = (b + g * pc * 4 + 15) & ~15;
    ring = red + kConsumerWarps * pc * static_cast<int>(sizeof(Stats));
    flag = ring + static_cast<int>(sizeof(StageRing));
    total = flag + 16 + 1024;
  }
};

// ---- device helpers

// One bulk copy of `bytes` (a multiple of 16) from global src to shared
// dst, both 16-byte aligned, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, uintptr_t src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(conv_wgmma::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(conv_wgmma::smem_u32(bar))
      : "memory");
}

// The consumer warps meet (named barrier 1; the producer warp never does).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void fma4(float (&acc)[4], float u, float4 w) {
  acc[0] = fmaf(u, w.x, acc[0]);
  acc[1] = fmaf(u, w.y, acc[1]);
  acc[2] = fmaf(u, w.z, acc[2]);
  acc[3] = fmaf(u, w.w, acc[3]);
}

// acc[i] (log2 units) of pixels px + 32 i, i < kPix, of the stage xs for
// the PC outputs whose padded weights start at wg (wstride floats a
// 4-channel block), biases at bg. kSwz: xs holds 32 channels a pixel in the
// swizzle of a pixel's width (128 bytes in f32, 64 in bf16); else C
// channels a pixel, plain.
template <int PC, int kPix, bool kSwz, int kEB>
__device__ __forceinline__ void dot_group(const void* xs, int px, int C,
                                          const float* wg, const float* bg,
                                          float (&acc)[kPix][PC / 4][4]) {
  constexpr int wstride = 4 * PC + 4;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
#pragma unroll
    for (int q = 0; q < PC / 4; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = bg[4 * q + e];
    }
  }
  if constexpr (kSwz && kEB == 4) {
    // the pixels px + 32 i share px % 8, so one swizzle serves all
    const float4* p0 = static_cast<const float4*>(xs) + px * 8;
    const int sw = px & 7;
#pragma unroll(kPix * PC <= 24 ? 2 : 1)
    for (int j = 0; j < 8; ++j) {
      float u[kPix][4];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const float4 u4 = p0[i * 32 * 8 + (j ^ sw)];
        u[i][0] = u4.x;
        u[i][1] = u4.y;
        u[i][2] = u4.z;
        u[i][3] = u4.w;
      }
      const float* wj = wg + j * wstride;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int q = 0; q < PC / 4; ++q) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(wj + c * PC + 4 * q);
#pragma unroll
          for (int i = 0; i < kPix; ++i) fma4(acc[i][q], u[i][c], w4);
        }
      }
    }
  } else if constexpr (kSwz) {
    // bf16: four 16-byte chunks of 8 channels a pixel; the pixels
    // px + 32 i share (px / 2) % 4, so one swizzle serves all
    const uint4* p0 = static_cast<const uint4*>(xs) + px * 4;
    const int sw = (px >> 1) & 3;
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      uint4 raw[kPix];
#pragma unroll
      for (int i = 0; i < kPix; ++i) raw[i] = p0[i * 32 * 4 + (j ^ sw)];
      const float* wj = wg + 2 * j * wstride;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float u[kPix];
#pragma unroll
        for (int i = 0; i < kPix; ++i) u[i] = bf16_at(raw[i], c);
        const float* wc = wj + (c >> 2) * wstride + (c & 3) * PC;
#pragma unroll
        for (int q = 0; q < PC / 4; ++q) {
          const float4 w4 = *reinterpret_cast<const float4*>(wc + 4 * q);
#pragma unroll
          for (int i = 0; i < kPix; ++i) fma4(acc[i][q], u[i], w4);
        }
      }
    }
  } else {
    using E = Elem<kEB>;
    const typename E::T* xe = static_cast<const typename E::T*>(xs);
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      float u[kPix];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        u[i] = E::widen(xe[(px + 32 * i) * C + c]);
      }
      const float* wc = wg + (c >> 2) * wstride + (c & 3) * PC;
#pragma unroll
      for (int q = 0; q < PC / 4; ++q) {
        const float4 w4 = *reinterpret_cast<const float4*>(wc + 4 * q);
#pragma unroll
        for (int i = 0; i < kPix; ++i) fma4(acc[i][q], u[i], w4);
      }
    }
  }
}

// The first byte of pixel s of row `row` (eb bytes an element).
__device__ __forceinline__ uintptr_t pixel_addr(const void* x, int row,
                                                int HW, int C, int s,
                                                int eb) {
  return reinterpret_cast<uintptr_t>(x) +
         (static_cast<long long>(row) * HW + s) * C * eb;
}

template <int PC, int kPix, bool kSwz, int kEB>
__global__ void __launch_bounds__(kThreads, 1)
    fused_predict_kernel(const __grid_constant__ CUtensorMap xmap,
                         const void* __restrict__ x,
                         const typename Elem<kEB>::T* __restrict__ w,
                         const float* __restrict__ b,
                         float4* __restrict__ part, int* __restrict__ arrivals,
                         float* __restrict__ out, float4* __restrict__ stats,
                         int R, int HW, int W, int C, int P, int row0,
                         float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = conv_wgmma::align_1024(smem_raw);
  const Layout L(C, P);
  constexpr int wstride = 4 * PC + 4;
  const int G = groups(P);
  const int cq = (C + 3) / 4;
  float* sw = reinterpret_cast<float*>(smem + L.w);
  float* sb = reinterpret_cast<float*>(smem + L.b);
  Stats* red = reinterpret_cast<Stats*>(smem + L.red);
  StageRing* ring = reinterpret_cast<StageRing*>(smem + L.ring);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < G * cq * 4 * PC; i += kThreads) {
    const int p = i % PC, ci = i / PC, c = ci % (4 * cq), g = ci / (4 * cq);
    const int pg = g * PC + p;
    sw[(g * cq + c / 4) * wstride + (c % 4) * PC + p] =
        c < C && pg < P ? Elem<kEB>::widen(w[c * P + pg]) * kLog2e : 0.f;
  }
  for (int i = tid; i < G * PC; i += kThreads) {
    sb[i] = i < P ? b[i] * kLog2e : 0.f;
  }
  if (tid == 0) {
    ring->init(kConsumerWarps);
    conv_wgmma::mbar_fence_init();
  }
  __syncthreads();

  const long long T = static_cast<long long>(R) * HW;
  const int nb = gridDim.x;
  const int SP = stage_pixels(C, kEB);
  constexpr int kBoxBytes = kBoxPixels * kSwzC * kEB;
  Item it;

  if (warp == kConsumerWarps) {  // the producer: one thread
    if (lane == 0) {
      if constexpr (kSwz) conv_wgmma::tma_prefetch_map(&xmap);
      uint32_t use = 0;
      for (int k = 0; item_of(T, HW, nb, blockIdx.x, k, &it); ++k) {
        for (int s = it.begin; s < it.end; s += SP, ++use) {
          const int n = min(SP, it.end - s);
          unsigned char* dst = smem + (use % kStages) * kStageAlloc;
          uint64_t* bar = &ring->full[use % kStages];
          if constexpr (kSwz) {
            const int boxes = (n + kBoxPixels - 1) / kBoxPixels;
            ring->acquire(use, boxes * kBoxBytes);
            const int p0 = it.row * HW + s;  // < 2^31, checked at launch
            for (int i = 0; i < boxes; ++i) {
              conv_wgmma::tma_load_2d(dst + i * kBoxBytes, &xmap, bar, 0,
                                      p0 + i * kBoxPixels);
            }
          } else {
            const uintptr_t a = pixel_addr(x, it.row, HW, C, s, kEB);
            const uintptr_t a0 = a & ~uintptr_t(15);
            const uintptr_t a1 =
                (a + static_cast<uintptr_t>(kEB) * n * C + 15) &
                ~uintptr_t(15);
            ring->acquire(use, static_cast<uint32_t>(a1 - a0));
            bulk_load(dst, a0, static_cast<uint32_t>(a1 - a0), bar);
          }
        }
      }
    }
    return;
  }

  // the consumers: warp w computes channel group w % G
  const int g = warp % G;
  const int tg = (warp / G) * 32 + lane;  // thread of its group
  const int TG = kConsumers / G;
  const float* wg = sw + g * cq * wstride;
  const float* bg = sb + g * PC;
  uint32_t use = 0;
  for (int k = 0; item_of(T, HW, nb, blockIdx.x, k, &it); ++k) {
    Stats st[PC];
#pragma unroll
    for (int p = 0; p < PC; ++p) st[p] = online_softmax::empty();
    for (int s = it.begin; s < it.end; s += SP, ++use) {
      const int n = min(SP, it.end - s);
      ring->wait_full(use);
      const void* xs = smem + (use % kStages) * kStageAlloc +
                       (kSwz ? 0 : pixel_addr(x, it.row, HW, C, s, kEB) & 15);
      for (int q = tg; first_of_group<kPix>(q) < n; q += TG) {
        const int px = first_of_group<kPix>(q);
        float acc[kPix][PC / 4][4];
        dot_group<PC, kPix, kSwz, kEB>(xs, px, C, wg, bg, acc);
        float fx[kPix], fy[kPix];
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          const int f = s + px + 32 * i, y = f / W;
          fx[i] = static_cast<float>(f - y * W);
          fy[i] = static_cast<float>(y + row0);
        }
#pragma unroll
        for (int p = 0; p < PC; ++p) {
          float l[kPix];
#pragma unroll
          for (int i = 0; i < kPix; ++i) {  // the first pixel is valid
            l[i] = i == 0 || px + 32 * i < n ? acc[i][p / 4][p % 4]
                                             : -CUDART_INF_F;
          }
          online_softmax::push_group(st[p], l, fx, fy);
        }
      }
      __syncwarp();
      if (lane == 0) ring->release(use);
    }

    // the item's partial: lanes, then the group's warps, into slot b + row
#pragma unroll
    for (int p = 0; p < PC; ++p) {
      const Stats a = online_softmax::warp_merge2(st[p]);
      if (lane == 0) red[warp * PC + p] = a;
    }
    consumers_sync();
    const long long r0 = static_cast<long long>(it.row) * HW;
    if (tid < P) {
      const int gp = tid / PC, c = tid % PC;
      Stats a = online_softmax::empty();
      for (int v = gp; v < kConsumerWarps; v += G) {
        a = online_softmax::merge2(a, red[v * PC + c]);
      }
      __stcg(part + static_cast<long long>(blockIdx.x + it.row) * P + tid,
             make_float4(a.m, a.s, a.sx, a.sy));
      __threadfence();
    }
    consumers_sync();
    const int first = block_of(r0, T, nb), last = block_of(r0 + HW - 1, T, nb);
    if (tid == 0) *flag = atomicAdd(arrivals + it.row, 1) == last - first;
    consumers_sync();
    if (*flag) {  // the row's last block: merge its partials in block order
      if (tid < P) {
        __threadfence();
        Stats a = online_softmax::empty();
        for (int v = first; v <= last; ++v) {
          const float4 q =
              __ldcg(part + static_cast<long long>(v + it.row) * P + tid);
          a = online_softmax::merge2(a, Stats{q.x, q.y, q.z, q.w});
        }
        if (stats != nullptr) {  // the partial variant: the statistics
          stats[static_cast<long long>(it.row) * P + tid] =
              make_float4(a.m, a.s, a.sx, a.sy);
        } else {
          const float inv = 1.f / (a.s + eps);
          float* o = out + (static_cast<long long>(it.row) * P + tid) * 2;
          o[0] = a.sx * inv;
          o[1] = a.sy * inv;
        }
      }
      if (tid == 0) arrivals[it.row] = 0;
    }
  }
}

// x viewed as (R*HW pixels, 32 channels) of eb bytes, read in boxes of
// kBoxPixels pixels with the swizzle of a pixel's width (128 bytes in f32,
// 64 in bf16).
int map_pixels(CUtensorMap* map, const void* x, long long pixels, int eb) {
  const conv_wgmma::EncodeTiled enc = conv_wgmma::encode_tiled();
  if (enc == nullptr) return conv_wgmma::kErrNoEncoder;
  const cuuint64_t dims[2] = {cuuint64_t(kSwzC), cuuint64_t(pixels)};
  const cuuint64_t strides[1] = {cuuint64_t(kSwzC) * eb};
  const cuuint32_t box[2] = {kSwzC, kBoxPixels};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(
      map,
      eb == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(x), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      eb == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0
                           : conv_wgmma::kErrEncodeBase + static_cast<int>(r);
}

struct Args {
  const void *x, *w;
  const float* b;
  float4* part;
  int* arrivals;
  float* out;
  float4* stats;  // the partial variant's output, else nullptr
  int R, HW, W, C, P, blocks, row0;
  float eps;
  cudaStream_t stream;
};

template <int PC, int kPix, bool kSwz, int kEB>
cudaError_t launch(const CUtensorMap& map, const Args& a) {
  const auto kernel = fused_predict_kernel<PC, kPix, kSwz, kEB>;
  const int bytes = Layout(a.C, a.P).total;
  cudaError_t err = conv_wgmma::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<a.blocks, kThreads, bytes, a.stream>>>(
      map, a.x, static_cast<const typename Elem<kEB>::T*>(a.w), a.b, a.part,
      a.arrivals, a.out, a.stats, a.R, a.HW, a.W, a.C, a.P, a.row0, a.eps);
  return cudaGetLastError();
}

template <bool kSwz, int kEB>
cudaError_t dispatch(const CUtensorMap& map, const Args& a) {
  const int pc = group_width(a.P);
  if (pixels_per_thread(a.P) == 2) {
    return pc == 4   ? launch<4, 2, kSwz, kEB>(map, a)
           : pc == 8 ? launch<8, 2, kSwz, kEB>(map, a)
                     : launch<12, 2, kSwz, kEB>(map, a);
  }
  return launch<8, 4, kSwz, kEB>(map, a);
}

template <int kEB>
int run(const Args& a) {
  CUtensorMap map = {};
  if (a.C == kSwzC && reinterpret_cast<uintptr_t>(a.x) % 16 == 0) {
    const int err =
        map_pixels(&map, a.x, static_cast<long long>(a.R) * a.HW, kEB);
    if (err != 0) return err;
    return static_cast<int>(dispatch<true, kEB>(map, a));
  }
  return static_cast<int>(dispatch<false, kEB>(map, a));
}

}  // namespace

extern "C" {

// The persistent grid for R rows of HW pixels: one block an SM, or one a
// pixel if fewer (no block's range is empty).
int fused_predict_blocks(int R, int HW) {
  int grid = 0;
  conv_wgmma::persistent_grid(static_cast<long long>(R) * HW, &grid);
  return grid;
}

// Block `block`'s work items as (row, begin, end) triples into out (room
// for max_items); returns their count.
int fused_predict_items(int R, int HW, int blocks, int block, int* out,
                        int max_items) {
  Item it;
  int k = 0;
  for (; item_of(static_cast<long long>(R) * HW, HW, blocks, block, k, &it);
       ++k) {
    if (k < max_items) {
      out[3 * k] = it.row;
      out[3 * k + 1] = it.begin;
      out[3 * k + 2] = it.end;
    }
  }
  return k;
}

int fused_predict_stage_pixels(int C, int elem_bytes) {
  return stage_pixels(C, elem_bytes);
}

int fused_predict_group_width(int P) { return group_width(P); }

int fused_predict_pixels_per_thread(int P) { return pixels_per_thread(P); }

// Dynamic shared memory a block asks for.
int fused_predict_smem_bytes(int C, int P) { return Layout(C, P).total; }

// x (R, HW, C) and w (C, P), both f32 (elem_bytes 4) or both bf16
// (elem_bytes 2), b (P) f32; part: scratch of (R + blocks - 1) * P * 4
// floats; arrivals: R ints, 0 on entry and left 0; out (R, P, 2) f32.
// Returns the cudaError_t of the launch (0 = success; 999: no
// cuTensorMapEncodeTiled; 1000 + CUresult: a refused tensor map).
int fused_predict_launch(const void* x, const void* w, const float* b,
                         float* part, int* arrivals, float* out, int R,
                         int HW, int W, int C, int P, int elem_bytes,
                         int blocks, float eps, void* stream_ptr) {
  const long long pixels = static_cast<long long>(R) * HW;
  if (P < 1 || P > kMaxP || C < 1 || C > kMaxC || blocks < 1 ||
      (elem_bytes != 4 && elem_bytes != 2) || pixels >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {x, w, b, reinterpret_cast<float4*>(part), arrivals, out,
                  nullptr, R, HW, W, C, P, blocks, 0, eps,
                  static_cast<cudaStream_t>(stream_ptr)};
  return elem_bytes == 4 ? run<4>(a) : run<2>(a);
}

// The partial-statistics variant: x (R, HW, C) holds rows [row0, row0 +
// HW / W) of each map; stats (R, P, 4) f32 gets each row's and channel's
// (m, s, sx, sy) in log2 units, y offset by row0. The rest as
// fused_predict_launch.
int fused_predict_partial_launch(const void* x, const void* w,
                                 const float* b, float* part, int* arrivals,
                                 float* stats, int R, int HW, int W, int C,
                                 int P, int elem_bytes, int blocks, int row0,
                                 void* stream_ptr) {
  const long long pixels = static_cast<long long>(R) * HW;
  if (P < 1 || P > kMaxP || C < 1 || C > kMaxC || blocks < 1 ||
      (elem_bytes != 4 && elem_bytes != 2) || pixels >= (1LL << 31) ||
      row0 < 0 || row0 >= (1 << 24)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {x, w, b, reinterpret_cast<float4*>(part), arrivals,
                  nullptr, reinterpret_cast<float4*>(stats), R, HW, W, C, P,
                  blocks, row0, 0.f, static_cast<cudaStream_t>(stream_ptr)};
  return elem_bytes == 4 ? run<4>(a) : run<2>(a);
}

}  // extern "C"
