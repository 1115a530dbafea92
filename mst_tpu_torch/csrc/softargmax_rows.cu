// Rows soft-argmax for Hopper (sm_90a): one launch, one thread block
// cluster a row.
//
// Replaces the TPU kernel mst_tpu/ops/pallas/softargmax.py:63
// (`_softargmax_rows` -> `pl.pallas_call` of `_kernel`): the soft-argmax
// of each row of (R, H*W) logits, (sx, sy) / (s + eps) with online-softmax
// statistics m (max), s (mass), sx, sy (moments of x = flat mod W,
// y = flat div W). The logits are f32 or bf16; a bf16 logit is widened to
// f32 in registers (what the TPU wrapper does before its kernel,
// softargmax.py:100), and every statistic is f32.
//
// Bound on an H100: bytes. Each logit is read once (4 B, or 2 B in bf16)
// and each row writes two floats; at TTST's shape (R = 8 rows of
// 352 x 480) that is 5.4 MB in f32, 1.6 us at 3.35 TB/s, less than a
// launch. So the design spends one launch and no scratch, and spreads each
// row over enough SMs to read it at the memory rate:
//
// - A cluster of kCluster = 16 CTAs a row (a non-portable size, allowed by
//   cudaFuncAttributeNonPortableClusterSizeAllowed; the library checks
//   with cudaOccupancyMaxActiveClusters that one fits before the first
//   launch). 8 rows x 16 = 128 CTAs on the 132 SMs; the portable 8 would
//   leave half the card idle at R = 8. More rows queue as clusters.
// - A row's 16-byte-aligned body is cut into kCluster equal slices of
//   16-byte vectors (kVec logits: 4 f32 or 8 bf16; row_split); the row's
//   unaligned head (a row start off 16 bytes) goes to rank 0 and its
//   ragged tail to the last rank, as scalar loads. Each thread issues all
//   kLoads of its 16-byte loads before it reduces them, and reduces each
//   vector with one max, one rescale and one ex2 a logit
//   (online_softmax.cuh push_group).
// - The CTA merges its warps (shuffles, then shared memory); rank 0 merges
//   the cluster's CTAs through distributed shared memory
//   (cooperative_groups::this_cluster(), map_shared_rank, cluster.sync())
//   and writes (sx, sy) / (s + eps).
//
// The partial-statistics variant (softargmax_rows_partial_launch) is the
// same kernel over one H slab of a spatial mesh: each row holds rows
// [row0, row0 + H) of its map, each logit's y is offset by row0, and the
// cluster's merge stops before the soft-argmax: rank 0 writes the row's
// (m, s, sx, sy) in log2 units, which the 'space' ranks merge
// (ops/kernels/online_stats.merge_ranks) into the whole map's.
//
// ops/kernels/softargmax_rows.py mirrors the split (row_split) and the
// merge arithmetic (rows_split_reference) for the CPU tests;
// chip_smoke.py holds the split against softargmax_rows_slice.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "online_softmax.cuh"

namespace cg = cooperative_groups;

namespace {

using online_softmax::Stats;

constexpr int kCluster = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;  // 16-byte loads a thread issues before reducing
constexpr float kLog2e = 1.4426950408889634f;

// The logits of a 16-byte vector: kVec = 4 f32, or 8 bf16 (their bits
// held as uint16_t; a bf16 is the high half of the f32 it widens to).
template <int kVec>
struct Logits;

__device__ __forceinline__ uint32_t word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

template <>
struct Logits<4> {
  using T = float;
  __device__ static float at(const uint4& u, int j) {
    return __uint_as_float(word(u, j));
  }
  __device__ static float one(const T* p) { return *p; }
};

template <>
struct Logits<8> {
  using T = uint16_t;
  __device__ static float at(const uint4& u, int j) {
    const uint32_t w = word(u, j >> 1);
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static float one(const T* p) {
    return __uint_as_float(static_cast<uint32_t>(*p) << 16);
  }
};

// Rank `rank`'s share (of cluster >= 2) of a row of HW logits whose first
// element sits `lead` logits past a 16-byte boundary, at vec logits a
// 16-byte vector: the scalar elements [h0, h1) (the head on rank 0, the
// tail on the last rank) and the vectors [v0, v1) of the body, which
// starts at element head.
struct Slice {
  int head, h0, h1, v0, v1;
};

__host__ __device__ inline Slice row_split(int HW, int lead, int cluster,
                                           int rank, int vec) {
  Slice s;
  s.head = (vec - lead) & (vec - 1);
  if (s.head > HW) s.head = HW;
  const int nv = (HW - s.head) / vec;
  s.v0 = static_cast<int>(static_cast<long long>(nv) * rank / cluster);
  s.v1 = static_cast<int>(static_cast<long long>(nv) * (rank + 1) / cluster);
  s.h0 = rank == cluster - 1 ? s.head + vec * nv : 0;
  s.h1 = rank == 0 ? s.head : rank == cluster - 1 ? HW : 0;
  return s;
}

__device__ __forceinline__ void coords(int f, int W, int row0, float& fx,
                                       float& fy) {
  const int y = f / W;
  fx = static_cast<float>(f - y * W);
  fy = static_cast<float>(y + row0);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    softargmax_rows_kernel(const void* __restrict__ x,
                           float* __restrict__ out,
                           float4* __restrict__ stats, int HW, int W,
                           int row0, float eps) {
  using L = Logits<kVec>;
  using T = typename L::T;
  __shared__ Stats warp_stats[kWarps];
  __shared__ Stats cta_stats;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = static_cast<const T*>(x) + row * HW;
  const int lead = static_cast<int>(
      (reinterpret_cast<uintptr_t>(xr) / sizeof(T)) & (kVec - 1));
  const Slice sl = row_split(HW, lead, kCluster, rank, kVec);
  const uint4* body = reinterpret_cast<const uint4*>(xr + sl.head);

  Stats st = online_softmax::empty();
  for (int base = sl.v0 + tid; base < sl.v1; base += kThreads * kLoads) {
    uint4 v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = base + i * kThreads;
      v[i] = idx < sl.v1 ? __ldcs(body + idx) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int f = sl.head + kVec * (base + i * kThreads);
      float l[kVec], fx[kVec], fy[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) l[j] = L::at(v[i], j) * kLog2e;
      coords(f, W, row0, fx[0], fy[0]);
#pragma unroll
      for (int j = 1; j < kVec; ++j) {  // the next pixels, wrapping rows
        fx[j] = fx[j - 1] + 1.f;
        fy[j] = fy[j - 1];
        if (fx[j] >= static_cast<float>(W)) {
          fx[j] = 0.f;
          fy[j] += 1.f;
        }
      }
      if (i == 0 || base + i * kThreads < sl.v1) {
        online_softmax::push_group(st, l, fx, fy);
      }
    }
  }
  if (tid < sl.h1 - sl.h0) {  // the head or the tail: one logit a thread
    float l[1] = {L::one(xr + sl.h0 + tid) * kLog2e}, fx[1], fy[1];
    coords(sl.h0 + tid, W, row0, fx[0], fy[0]);
    online_softmax::push_group(st, l, fx, fy);
  }

  st = online_softmax::warp_merge2(st);
  if (lane == 0) warp_stats[warp] = st;
  __syncthreads();
  if (warp == 0) {
    Stats a = lane < kWarps ? warp_stats[lane] : online_softmax::empty();
    a = online_softmax::warp_merge2(a);
    if (lane == 0) cta_stats = a;
  }
  cluster.sync();  // every CTA's partial is in its shared memory
  if (rank == 0 && warp == 0) {
    Stats a = online_softmax::empty();
    if (lane < kCluster) a = *cluster.map_shared_rank(&cta_stats, lane);
    a = online_softmax::warp_merge2(a);
    if (lane == 0) {
      if (stats != nullptr) {  // the partial variant: the statistics
        stats[row] = make_float4(a.m, a.s, a.sx, a.sy);
      } else {
        const float inv = 1.f / (a.s + eps);
        out[2 * row] = a.sx * inv;
        out[2 * row + 1] = a.sy * inv;
      }
    }
  }
  cluster.sync();  // keep every CTA's shared memory until rank 0 has read it
}

// Set up a kernel once: the non-portable cluster size, and a check that
// one cluster of kCluster CTAs fits on this card.
template <int kVec>
cudaError_t setup() {
  static cudaError_t status = [] {
    cudaError_t err = cudaFuncSetAttribute(
        softargmax_rows_kernel<kVec>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters,
                                         softargmax_rows_kernel<kVec>, &cfg);
    if (err != cudaSuccess) return err;
    return clusters >= 1 ? cudaSuccess : cudaErrorInvalidConfiguration;
  }();
  return status;
}

template <int kVec>
cudaError_t launch(const void* x, float* out, float4* stats, int R, int HW,
                   int W, int row0, float eps, cudaStream_t stream) {
  cudaError_t err = setup<kVec>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, softargmax_rows_kernel<kVec>, x, out, stats,
                           HW, W, row0, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

int softargmax_rows_cluster() { return kCluster; }

// Rank `rank`'s slice of a row at vec logits a 16-byte vector (4: f32,
// 8: bf16) as {head, h0, h1, v0, v1}.
void softargmax_rows_slice(int HW, int lead, int cluster, int rank, int vec,
                           int* out) {
  const Slice s = row_split(HW, lead, cluster, rank, vec);
  out[0] = s.head;
  out[1] = s.h0;
  out[2] = s.h1;
  out[3] = s.v0;
  out[4] = s.v1;
}

// x (R, HW) contiguous, f32 (elem_bytes 4) or bf16 (elem_bytes 2) ->
// out (R, 2) f32. Returns the cudaError_t of the launch (0 = success).
int softargmax_rows_launch(const void* x, float* out, int R, int HW, int W,
                           int elem_bytes, float eps, void* stream_ptr) {
  if (R < 1 || HW < 1 || W < 1 || (elem_bytes != 4 && elem_bytes != 2) ||
      static_cast<long long>(R) * kCluster > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(
      elem_bytes == 4 ? launch<4>(x, out, nullptr, R, HW, W, 0, eps, stream)
                      : launch<8>(x, out, nullptr, R, HW, W, 0, eps, stream));
}

// The partial-statistics variant: x (R, HW) holds rows [row0, row0 +
// HW / W) of each map -> stats (R, 4) f32, each row's (m, s, sx, sy) in
// log2 units, y offset by row0 (16-byte aligned). The rest as
// softargmax_rows_launch.
int softargmax_rows_partial_launch(const void* x, float* stats, int R,
                                   int HW, int W, int elem_bytes, int row0,
                                   void* stream_ptr) {
  if (R < 1 || HW < 1 || W < 1 || (elem_bytes != 4 && elem_bytes != 2) ||
      static_cast<long long>(R) * kCluster > 0x7fffffff || row0 < 0 ||
      row0 >= (1 << 24) ||
      (reinterpret_cast<uintptr_t>(stats) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float4* st = reinterpret_cast<float4*>(stats);
  return static_cast<int>(
      elem_bytes == 4
          ? launch<4>(x, nullptr, st, R, HW, W, row0, 0.f, stream)
          : launch<8>(x, nullptr, st, R, HW, W, row0, 0.f, stream));
}

}  // extern "C"
