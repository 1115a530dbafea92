// TTST's batched k-means for Hopper (sm_90a): the whole Lloyd loop of
// every row in one launch, with nothing read back to the host until the
// caller reads the centres.
//
// Replaces no TPU kernel: mst_tpu/ops/kmeans.py runs the loop as a vmap of
// lax.while_loop, which XLA keeps on the TPU. The port's torch while_loop
// (ops/kmeans.py) reads one flag on the host every trip and launches about
// fifteen small kernels a trip (the broadcast distances, argmin, one-hot,
// a cuBLAS bmm for the means, the reseed gather, the where's): at
// B <= 16 rows of N = 10,000 2-D points and k = 19 centres a trip is
// ~0.6 MFLOP a row, microseconds of one SM, but costs ~0.6 ms of launches
// and host reads. Bound on an H100: latency, trip after dependent trip.
// So the design spends one launch, no host read, and spreads a row over
// enough SMs that a trip is short:
//
// - A cluster of kCluster CTAs a row (16 rows: 128 CTAs on the 132 SMs);
//   each cluster runs its row's loop to the row's own stopping rule, so
//   rows need no grid-wide sync. Each CTA stages its slice of the row's
//   points once in dynamic shared memory (8 B a point), the centres
//   double-buffered beside them.
// - A trip: each thread loads the centres into registers and takes the
//   nearest centre of each of its points (the first minimum, as
//   torch.argmin; the distance written with _rn intrinsics so nvcc
//   contracts nothing into an FMA, bit for bit torch's
//   ((a - b) ** 2).sum(-1)), adding (x, y, 1) to per-cluster registers by
//   predicated adds over the compile-time kMaxClusters. Then a fixed-order
//   reduction: shuffles down each warp, the warps' partials summed in
//   warp order into the CTA's partial, and after a cluster barrier every
//   CTA sums the CTAs' partials in rank order through distributed shared
//   memory. No atomics: a call repeats its bits, and every CTA of a
//   cluster computes the same centres and the same stopping decision.
// - Thread j takes the mean sum / max(count, 1), or for an empty cluster
//   the point reseed[it, row, j], and the shift of its centre; every
//   thread sums the shifts in cluster order and applies the while_loop
//   body's rule, active = shift^2 >= tol && iters < iter_limit. A row's
//   own trip index is the while_loop's global one (rows leave and never
//   come back), so the reseed table is indexed as the loop indexes it.
// - After the loop each CTA writes its slice's final assignment, and rank
//   0 the row's centres and iteration count.
//
// The means are summed in another order than the loop's bmm; on TTST's
// draws (whole-pixel coordinates, sums below 2^24) both are exact.
// ops/kernels/kmeans.py binds it (mst_tpu_torch::kmeans2d) with the
// loop as its plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs a row (portable)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// k = n_goal - 1 = 19 in every shipped config: the next multiple of 8
constexpr int kMaxClusters = 24;
// shared memory before the points: the warps' partial sums and counts,
// the CTA's partials (two buffers, read by the cluster), two buffers of
// centres and the clusters' shifts
constexpr int kFixedBytes =
    4 * (3 * kWarps * kMaxClusters + 2 * 3 * kMaxClusters +
         2 * 2 * kMaxClusters + kMaxClusters);

// The nearest of the first k centres (cx, cy) to (x, y), the first on a
// tie.
__device__ __forceinline__ int nearest(float x, float y, const float* cx,
                                       const float* cy, int k) {
  float best = 0.0f;
  int arg = 0;
#pragma unroll
  for (int j = 0; j < kMaxClusters; ++j) {
    if (j < k) {
      const float dx = __fsub_rn(x, cx[j]);
      const float dy = __fsub_rn(y, cy[j]);
      const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (j == 0 || d < best) {
        best = d;
        arg = j;
      }
    }
  }
  return arg;
}

__global__ void __launch_bounds__(kThreads)
    kmeans_kernel(const float* __restrict__ X, const float* __restrict__ init,
                  const int64_t* __restrict__ reseed,
                  int64_t* __restrict__ assign, float* __restrict__ centres,
                  int64_t* __restrict__ iters_out, int B, int N, int k,
                  float tol, int iter_limit) {
  extern __shared__ float4 smem[];
  // [kWarps][kMaxClusters] each
  float* warp_x = reinterpret_cast<float*>(smem);
  float* warp_y = warp_x + kWarps * kMaxClusters;
  int* warp_n = reinterpret_cast<int*>(warp_y + kWarps * kMaxClusters);
  // [2][kMaxClusters] each: this CTA's partials, by trip parity
  float* cta_x = reinterpret_cast<float*>(warp_n + kWarps * kMaxClusters);
  float* cta_y = cta_x + 2 * kMaxClusters;
  int* cta_n = reinterpret_cast<int*>(cta_y + 2 * kMaxClusters);
  float2* cbuf = reinterpret_cast<float2*>(cta_n + 2 * kMaxClusters);
  float* shift = reinterpret_cast<float*>(cbuf + 2 * kMaxClusters);
  float2* pts = reinterpret_cast<float2*>(shift + kMaxClusters);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = static_cast<int>(static_cast<long long>(N) * rank / kCluster);
  const int n = static_cast<int>(
                    static_cast<long long>(N) * (rank + 1) / kCluster) - p0;
  const float* xr = X + static_cast<size_t>(row) * N * 2;
  for (int p = tid; p < n; p += kThreads) {
    pts[p] = make_float2(xr[2 * (p0 + p)], xr[2 * (p0 + p) + 1]);
  }
  if (tid < k) {
    const float* c0 = init + (static_cast<size_t>(row) * k + tid) * 2;
    cbuf[tid] = make_float2(c0[0], c0[1]);
  }
  __syncthreads();

  int cur = 0;  // the buffer holding the row's centres, and the partials'
  int iters = 0;
  for (;;) {
    const float2* c = cbuf + cur * kMaxClusters;
    float cx[kMaxClusters], cy[kMaxClusters];
    float sx[kMaxClusters], sy[kMaxClusters];
    int sn[kMaxClusters];
#pragma unroll
    for (int j = 0; j < kMaxClusters; ++j) {
      const float2 cj = c[j < k ? j : 0];
      cx[j] = cj.x;
      cy[j] = cj.y;
      sx[j] = 0.0f;
      sy[j] = 0.0f;
      sn[j] = 0;
    }
    for (int p = tid; p < n; p += kThreads) {
      const float2 x = pts[p];
      const int arg = nearest(x.x, x.y, cx, cy, k);
#pragma unroll
      for (int j = 0; j < kMaxClusters; ++j) {
        if (j == arg) {
          sx[j] = __fadd_rn(sx[j], x.x);
          sy[j] = __fadd_rn(sy[j], x.y);
          sn[j] += 1;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxClusters; ++j) {
      float a = sx[j], b = sy[j];
      int m = sn[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, o));
        b = __fadd_rn(b, __shfl_down_sync(0xffffffffu, b, o));
        m += __shfl_down_sync(0xffffffffu, m, o);
      }
      if (lane == 0) {
        warp_x[warp * kMaxClusters + j] = a;
        warp_y[warp * kMaxClusters + j] = b;
        warp_n[warp * kMaxClusters + j] = m;
      }
    }
    __syncthreads();
    const int part = cur * kMaxClusters + tid;
    if (tid < k) {
      float a = 0.0f, b = 0.0f;
      int m = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        a = __fadd_rn(a, warp_x[w * kMaxClusters + tid]);
        b = __fadd_rn(b, warp_y[w * kMaxClusters + tid]);
        m += warp_n[w * kMaxClusters + tid];
      }
      cta_x[part] = a;
      cta_y[part] = b;
      cta_n[part] = m;
    }
    cluster.sync();  // every CTA's partials of this trip are in place
    if (tid < k) {
      float a = 0.0f, b = 0.0f;
      int m = 0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        a = __fadd_rn(a, *cluster.map_shared_rank(cta_x + part, r));
        b = __fadd_rn(b, *cluster.map_shared_rank(cta_y + part, r));
        m += *cluster.map_shared_rank(cta_n + part, r);
      }
      float2 mean;
      if (m > 0) {
        const float count = static_cast<float>(m);
        mean = make_float2(__fdiv_rn(a, count), __fdiv_rn(b, count));
      } else {
        const int64_t i =
            reseed[(static_cast<size_t>(iters) * B + row) * k + tid];
        mean = make_float2(xr[2 * i], xr[2 * i + 1]);
      }
      cbuf[(cur ^ 1) * kMaxClusters + tid] = mean;
      const float dx = __fsub_rn(mean.x, c[tid].x);
      const float dy = __fsub_rn(mean.y, c[tid].y);
      shift[tid] =
          __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    }
    __syncthreads();
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxClusters; ++j) {
      if (j < k) s = __fadd_rn(s, shift[j]);
    }
    ++iters;
    cur ^= 1;
    if (!(__fmul_rn(s, s) >= tol && iters < iter_limit)) break;
  }

  const float2* c = cbuf + cur * kMaxClusters;
  float cx[kMaxClusters], cy[kMaxClusters];
#pragma unroll
  for (int j = 0; j < kMaxClusters; ++j) {
    const float2 cj = c[j < k ? j : 0];
    cx[j] = cj.x;
    cy[j] = cj.y;
  }
  int64_t* ar = assign + static_cast<size_t>(row) * N + p0;
  for (int p = tid; p < n; p += kThreads) {
    ar[p] = nearest(pts[p].x, pts[p].y, cx, cy, k);
  }
  if (rank == 0 && tid < k) {
    float* out = centres + (static_cast<size_t>(row) * k + tid) * 2;
    out[0] = c[tid].x;
    out[1] = c[tid].y;
  }
  if (rank == 0 && tid == 0) iters_out[row] = iters;
  cluster.sync();  // keep every CTA's partials until the last trip's reads
}

}  // namespace

extern "C" {

// X (B, N, 2) f32 and init (B, k, 2) f32 centres, reseed (iter_limit, B,
// k) int64 indices into each row's points, all contiguous on the current
// device -> assign (B, N) int64, centres (B, k, 2) f32, iters (B,) int64.
// Returns the cudaError_t of the launch (0 = success), or
// cudaErrorInvalidValue before any launch for what the kernel cannot
// take: B < 1, k outside 1..min(kMaxClusters, N), iter_limit < 1, or a
// CTA's slice of a row (ceil(N / kCluster) points) beyond the device's
// shared memory a block.
int kmeans_launch(const float* X, const float* init, const int64_t* reseed,
                  int64_t* assign, float* centres, int64_t* iters, int B,
                  int N, int k, float tol, int iter_limit, void* stream_ptr) {
  if (B < 1 || N < 1 || k < 1 || k > kMaxClusters || k > N ||
      iter_limit < 1 || static_cast<long long>(B) * kCluster > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem =
      kFixedBytes + 8LL * ((static_cast<long long>(N) + kCluster - 1) /
                           kCluster);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kmeans_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream_ptr);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kmeans_kernel, X, init, reseed, assign,
                           centres, iters, B, N, k, tol, iter_limit);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
