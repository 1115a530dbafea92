// Online soft-argmax statistics, shared by csrc/fused_predict.cu and
// csrc/decoder_chain.cu: for one logit map, the running max m, the mass
// s = sum exp(l - m) and the moments sx, sy of the coordinates, merged
// across threads, blocks and launches with max-rescaling (the arithmetic
// of unify_packed_stats, mst_tpu/ops/pallas/fused_predict.py:36).

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

// Add logit l at coordinates (fx, fy).
__device__ __forceinline__ void push(Stats& st, float l, float fx, float fy) {
  if (l > st.m) {  // new maximum: rescale what came before
    const float f = __expf(st.m - l);
    st = {l, st.s * f + 1.f, st.sx * f + fx, st.sy * f + fy};
  } else {
    const float e = __expf(l - st.m);
    st.s += e;
    st.sx = fmaf(e, fx, st.sx);
    st.sy = fmaf(e, fy, st.sy);
  }
}

}  // namespace online_softmax
