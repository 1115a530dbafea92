// trajwin — native trajectory-windowing kernel for the offline builders.
//
// Fuses the reference's four-pass pandas pipeline (split_fragmented ->
// downsample -> filter_short_trajectories -> sliding_window, reference
// utils/data_utils.py:14-112) into ONE linear scan over the annotation rows,
// emitting window row-indices. The pandas path is O(n) groupby.apply calls
// with Python-level per-group work; at SDD scale (~10M rows) this kernel is
// the data-loader hot path. Rows must be grouped by metaId in order of
// appearance with frames ascending within a group — which is how both raw
// loaders emit them.
//
// Build: g++ -O3 -shared -fPIC trajwin.cc -o libtrajwin_<hash>.so, done at
// first use by mst_tpu_torch/native/__init__.py into build/mst_tpu_torch/.

#include <cstdint>
#include <vector>

namespace {

struct Fragment {
  int64_t start;  // row index of fragment start
  int64_t len;    // rows in fragment
};

// Collect fragments: boundaries at group change or (if split_fragments)
// at frame gaps != 1 within a group.
void collect_fragments(const int64_t* meta, const int64_t* frame, int64_t n,
                       bool split_fragments, std::vector<Fragment>* out) {
  if (n == 0) return;
  int64_t start = 0;
  for (int64_t i = 1; i <= n; ++i) {
    bool boundary = (i == n) || (meta[i] != meta[i - 1]);
    if (!boundary && split_fragments && frame[i] - frame[i - 1] != 1) {
      boundary = true;
    }
    if (boundary) {
      out->push_back({start, i - start});
      start = i;
    }
  }
}

}  // namespace

extern "C" {

// Pass 1: count output windows (so Python can allocate exact buffers).
// step: downsample stride (keep positions 0, step, 2*step, ... within each
//       fragment); window/stride: sliding-window params on the downsampled
//       sequence.
int64_t trajwin_count(const int64_t* meta, const int64_t* frame, int64_t n,
                      int32_t split_fragments, int64_t step, int64_t window,
                      int64_t stride) {
  std::vector<Fragment> frags;
  collect_fragments(meta, frame, n, split_fragments != 0, &frags);
  int64_t n_win = 0;
  for (const auto& f : frags) {
    int64_t kept = (f.len + step - 1) / step;  // ceil(len/step)
    if (kept >= window) n_win += (kept - window) / stride + 1;
  }
  return n_win;
}

// Pass 2: fill row indices. out_idx has n_win*window entries; window w of
// the output covers rows out_idx[w*window : (w+1)*window] of the input, and
// the new metaId of every row in window w is w (factorized in appearance
// order, matching the pandas path).
void trajwin_fill(const int64_t* meta, const int64_t* frame, int64_t n,
                  int32_t split_fragments, int64_t step, int64_t window,
                  int64_t stride, int64_t* out_idx) {
  std::vector<Fragment> frags;
  collect_fragments(meta, frame, n, split_fragments != 0, &frags);
  int64_t w = 0;
  for (const auto& f : frags) {
    int64_t kept = (f.len + step - 1) / step;
    if (kept < window) continue;
    int64_t n_chunk = (kept - window) / stride + 1;
    for (int64_t c = 0; c < n_chunk; ++c) {
      int64_t base = c * stride;  // position in downsampled sequence
      for (int64_t j = 0; j < window; ++j) {
        out_idx[w * window + j] = f.start + (base + j) * step;
      }
      ++w;
    }
  }
}

// Gather windows into a dense (n_win, window, 2) float32 trajectory tensor —
// the per-epoch batch-assembly hot path (replaces DataFrame reshapes).
void trajwin_gather_xy(const double* x, const double* y,
                       const int64_t* out_idx, int64_t n_win, int64_t window,
                       float* out_xy) {
  for (int64_t w = 0; w < n_win; ++w) {
    for (int64_t j = 0; j < window; ++j) {
      int64_t r = out_idx[w * window + j];
      out_xy[(w * window + j) * 2 + 0] = static_cast<float>(x[r]);
      out_xy[(w * window + j) * 2 + 1] = static_cast<float>(y[r]);
    }
  }
}

}  // extern "C"
