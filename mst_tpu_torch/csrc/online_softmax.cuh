// Online soft-argmax statistics, shared by csrc/decoder_chain.cu,
// csrc/fused_predict.cu and csrc/softargmax_rows.cu: for one logit map,
// the running max m, the mass s = sum exp(l - m) and the moments sx, sy of
// the coordinates, merged across threads, blocks and launches with
// max-rescaling (the arithmetic of unify_packed_stats,
// mst_tpu/ops/pallas/fused_predict.py:36).
//
// merge takes natural-log units (decoder_chain.cu). merge2, push_group and
// warp_merge2 take the logits scaled by log2(e) (the kernel folds the
// factor into its weights or its loads), so each exponential is one ex2;
// the ratios sx / s and sy / s are the same in either unit.
// ops/kernels/online_stats.py mirrors the log2-unit arithmetic for the CPU
// tests.

#pragma once

#include <math_constants.h>

namespace online_softmax {

struct Stats {
  float m, s, sx, sy;
};

__device__ __forceinline__ Stats empty() {
  return {-CUDART_INF_F, 0.f, 0.f, 0.f};
}

__device__ __forceinline__ Stats merge(Stats a, Stats b) {
  const float M = fmaxf(a.m, b.m);
  if (M == -CUDART_INF_F) return a;  // both empty
  const float fa = __expf(a.m - M);
  const float fb = __expf(b.m - M);
  return {M, a.s * fa + b.s * fb, a.sx * fa + b.sx * fb,
          a.sy * fa + b.sy * fb};
}

// 2^x, one MUFU op (ex2.approx.ftz: 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// merge in log2 units.
__device__ __forceinline__ Stats merge2(Stats a, Stats b) {
  const float M = fmaxf(a.m, b.m);
  if (M == -CUDART_INF_F) return a;  // both empty
  const float fa = ex2(a.m - M);
  const float fb = ex2(b.m - M);
  return {M, fmaf(a.s, fa, b.s * fb), fmaf(a.sx, fa, b.sx * fb),
          fmaf(a.sy, fa, b.sy * fb)};
}

// Add a group of N log2-unit logits at coordinates (fx, fy) without a
// branch on the data: the group's max first, then one rescale of what came
// before and N exponentials. A logit of -inf (a masked slot) adds nothing;
// the group must hold at least one finite logit.
template <int N>
__device__ __forceinline__ void push_group(Stats& st, const float (&l)[N],
                                           const float (&fx)[N],
                                           const float (&fy)[N]) {
  float m = st.m;
#pragma unroll
  for (int i = 0; i < N; ++i) m = fmaxf(m, l[i]);
  const float r = ex2(st.m - m);
  float s = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = ex2(l[i] - m);
    s += e;
    sx = fmaf(e, fx[i], sx);
    sy = fmaf(e, fy[i], sy);
  }
  st = {m, fmaf(st.s, r, s), fmaf(st.sx, r, sx), fmaf(st.sy, r, sy)};
}

// Merge the statistics of the 32 lanes of a warp (log2 units); every lane
// ends with the total.
__device__ __forceinline__ Stats warp_merge2(Stats a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Stats o = {__shfl_xor_sync(0xffffffffu, a.m, off),
                     __shfl_xor_sync(0xffffffffu, a.s, off),
                     __shfl_xor_sync(0xffffffffu, a.sx, off),
                     __shfl_xor_sync(0xffffffffu, a.sy, off)};
    a = merge2(a, o);
  }
  return a;
}

}  // namespace online_softmax
