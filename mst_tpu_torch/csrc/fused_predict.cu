// Fused 1x1 predictor + soft-argmax for Hopper (sm_90a).
//
// Replaces the TPU kernel mst_tpu/ops/pallas/fused_predict.py
// (`_fused_rows` -> `pl.pallas_call` of `_kernel`, merge
// `unify_packed_stats`) in its unpacked form:
//   x (R, H, W, C) f32, NHWC-contiguous  x  w (C, P)  +  b (P)
//   -> out (R, P, 2): per row and output channel p, the soft-argmax
//      (sx, sy) / (s + eps) of the logits x[r, :, :, :] @ w[:, p] + b[p].
// The (R, H, W, P) logits volume never reaches device memory.
//
// Bound on an H100: bytes. Reading x once is R*H*W*C*4 bytes (3.46 GB at
// the eval decode's R = 160, 352 x 480, C = 32: ~1.03 ms at 3.35 TB/s);
// the product is 2*C*P flops per pixel (21 GFLOP, ~0.3 ms at the 67 TFLOP/s
// f32 rate), so the design only has to stream x at full rate.
//
// Design: the TPU walked 8-row tiles of one row in order, carrying the
// statistics in scratch; here the pixels of a row are cut into chunks that
// run in parallel. Pass 1 (grid: chunks x rows) gives each thread pixels of
// its chunk; a pixel's C channels are contiguous (128 B at C = 32), read as
// float4 and dotted with the weights held in shared memory (every thread
// reads the same weight, a broadcast). Each thread keeps online (m, s, sx,
// sy) per output channel in registers; warp shuffles and then shared memory
// merge them (max-rescaling, as unify_packed_stats) into one partial per
// (row, chunk, p). Pass 2 merges the chunks of each row. No wgmma or TMA:
// a simple correct kernel first.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 32;  // output channels; pred_len is 12 or 30

struct Stats {
  float m, s, sx, sy;
};

__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  const float M = fmaxf(a.m, b.m);
  if (M == -CUDART_INF_F) return a;  // both empty
  const float fa = __expf(a.m - M);
  const float fb = __expf(b.m - M);
  return {M, a.s * fa + b.s * fb, a.sx * fa + b.sx * fb,
          a.sy * fa + b.sy * fb};
}

// PC: the P channels rounded up to a compiled capacity; the extra channels
// get zero weights and are never written.
template <int PC>
__global__ void __launch_bounds__(kThreads)
fused_predict_partial(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ part,
                      int HW, int W, int C, int P, int pix_per_chunk,
                      int n_chunks, int vec4) {
  extern __shared__ float smem[];
  float* sw = smem;                  // C * PC weights, sw[c * PC + p]
  float* sb = smem + C * PC;         // PC biases
  Stats* red = reinterpret_cast<Stats*>(sb + PC);  // (warps, PC) partials

  for (int i = threadIdx.x; i < C * PC; i += blockDim.x) {
    const int c = i / PC, p = i % PC;
    sw[i] = p < P ? w[c * P + p] : 0.f;
  }
  for (int p = threadIdx.x; p < PC; p += blockDim.x) {
    sb[p] = p < P ? b[p] : 0.f;
  }
  __syncthreads();

  const int chunk = blockIdx.x;
  const int row = blockIdx.y;
  const int start = chunk * pix_per_chunk;
  const int end = min(start + pix_per_chunk, HW);

  Stats st[PC];
#pragma unroll
  for (int p = 0; p < PC; ++p) st[p] = {-CUDART_INF_F, 0.f, 0.f, 0.f};

  const float* xrow = x + static_cast<long long>(row) * HW * C;
  for (int pix = start + threadIdx.x; pix < end; pix += blockDim.x) {
    const float* xp = xrow + static_cast<long long>(pix) * C;
    float acc[PC];
#pragma unroll
    for (int p = 0; p < PC; ++p) acc[p] = sb[p];
    if (vec4) {
      const float4* xp4 = reinterpret_cast<const float4*>(xp);
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 v = __ldg(xp4 + c4);
        const float* w0 = sw + (4 * c4) * PC;
#pragma unroll
        for (int p = 0; p < PC; ++p) {
          acc[p] = fmaf(v.x, w0[p], acc[p]);
          acc[p] = fmaf(v.y, w0[PC + p], acc[p]);
          acc[p] = fmaf(v.z, w0[2 * PC + p], acc[p]);
          acc[p] = fmaf(v.w, w0[3 * PC + p], acc[p]);
        }
      }
    } else {
      for (int c = 0; c < C; ++c) {
        const float v = __ldg(xp + c);
#pragma unroll
        for (int p = 0; p < PC; ++p) acc[p] = fmaf(v, sw[c * PC + p], acc[p]);
      }
    }
    const float fx = static_cast<float>(pix % W);
    const float fy = static_cast<float>(pix / W);
#pragma unroll
    for (int p = 0; p < PC; ++p) {
      const float l = acc[p];
      if (l > st[p].m) {  // new maximum: rescale what came before
        const float f = __expf(st[p].m - l);
        st[p] = {l, st[p].s * f + 1.f, st[p].sx * f + fx, st[p].sy * f + fy};
      } else {
        const float e = __expf(l - st[p].m);
        st[p].s += e;
        st[p].sx = fmaf(e, fx, st[p].sx);
        st[p].sy = fmaf(e, fy, st[p].sy);
      }
    }
  }

  // merge across the warp, then across the block's warps
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < PC; ++p) {
    Stats a = st[p];
    for (int off = 16; off > 0; off >>= 1) {
      Stats o = {__shfl_down_sync(0xffffffffu, a.m, off),
                 __shfl_down_sync(0xffffffffu, a.s, off),
                 __shfl_down_sync(0xffffffffu, a.sx, off),
                 __shfl_down_sync(0xffffffffu, a.sy, off)};
      a = merge(a, o);
    }
    if (lane == 0) red[warp * PC + p] = a;
  }
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    Stats a = red[p];
    for (int k = 1; k < n_warps; ++k) a = merge(a, red[k * PC + p]);
    float* out = part + ((static_cast<long long>(row) * n_chunks + chunk) * P
                         + p) * 4;
    out[0] = a.m;
    out[1] = a.s;
    out[2] = a.sx;
    out[3] = a.sy;
  }
}

__global__ void fused_predict_merge(const float* __restrict__ part,
                                    float* __restrict__ out, int P,
                                    int n_chunks, float eps) {
  const int row = blockIdx.x;
  const int p = threadIdx.x;
  if (p >= P) return;
  Stats a = {-CUDART_INF_F, 0.f, 0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const float* q = part + ((static_cast<long long>(row) * n_chunks + c) * P
                             + p) * 4;
    a = merge(a, Stats{q[0], q[1], q[2], q[3]});
  }
  const float inv = 1.f / (a.s + eps);
  out[(row * P + p) * 2] = a.sx * inv;
  out[(row * P + p) * 2 + 1] = a.sy * inv;
}

template <int PC>
cudaError_t launch_partial(const float* x, const float* w, const float* b,
                           float* part, int R, int HW, int W, int C, int P,
                           int pix_per_chunk, int n_chunks, int vec4,
                           cudaStream_t stream) {
  const size_t smem = (C * PC + PC) * sizeof(float)
                      + (kThreads / 32) * PC * sizeof(Stats);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_predict_partial<PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(n_chunks, R);
  fused_predict_partial<PC><<<grid, kThreads, smem, stream>>>(
      x, w, b, part, HW, W, C, P, pix_per_chunk, n_chunks, vec4);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// part: scratch of R * n_chunks * P * 4 floats; out: R * P * 2 floats.
// Returns the cudaError_t of the launches (0 = success).
int fused_predict_launch(const float* x, const float* w, const float* b,
                         float* part, float* out, int R, int HW, int W, int C,
                         int P, int pix_per_chunk, int n_chunks, int vec4,
                         float eps, void* stream_ptr) {
  if (P < 1 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto launch = P <= 4    ? launch_partial<4>
                      : P <= 8  ? launch_partial<8>
                      : P <= 12 ? launch_partial<12>
                      : P <= 16 ? launch_partial<16>
                      : P <= 24 ? launch_partial<24>
                                : launch_partial<32>;
  cudaError_t err = launch(x, w, b, part, R, HW, W, C, P, pix_per_chunk,
                           n_chunks, vec4, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_predict_merge<<<R, 32, 0, stream>>>(part, out, P, n_chunks, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
