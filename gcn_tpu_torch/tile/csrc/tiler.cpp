// Native ELL tiler — the TPU-era counterpart of the reference's csr2tile
// (tile.cu:104-169). Pure host C++ (the reference's tiler is host-only too:
// its single CUDA call just reads the SM count, which has no TPU analogue —
// pass geometry in via r / p instead).
//
// Contract (mirrors the CSR-pointer convention of renumber.cu:23 /
// tile.cu:104): the caller owns all buffers. Two-phase protocol because the
// output size depends on the degree distribution:
//   1. ell_plan(indptr, n, r, p, &num_windows, &num_blocks)
//   2. ell_fill(indptr, indices, data, n, r, p, cols, vals, win)
// where cols/vals are float/int32[num_blocks * p * r] laid out
// [block][stride j][row r] and win is int32[num_blocks] (nondecreasing,
// every window present — see gcn_tpu/tile/ell.py for the format docs).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// passes per window: ceil(max_degree_in_window / p), min 1
static std::vector<int64_t> window_passes(const int32_t* indptr, int64_t n,
                                          int64_t r, int64_t p) {
  const int64_t num_windows = std::max<int64_t>(1, ceil_div(n, r));
  std::vector<int64_t> passes(num_windows, 1);
  for (int64_t w = 0; w < num_windows; ++w) {
    int64_t wmax = 0;
    const int64_t lo = w * r, hi = std::min(n, (w + 1) * r);
    for (int64_t i = lo; i < hi; ++i)
      wmax = std::max<int64_t>(wmax, indptr[i + 1] - indptr[i]);
    passes[w] = std::max<int64_t>(1, ceil_div(wmax, p));
  }
  return passes;
}

}  // namespace

extern "C" {

int ell_plan(const int32_t* indptr, int64_t n, int64_t r, int64_t p,
             int64_t* num_windows_out, int64_t* num_blocks_out) {
  if (!indptr || n < 0 || r <= 0 || p <= 0) return -1;
  const auto passes = window_passes(indptr, n, r, p);
  int64_t blocks = 0;
  for (int64_t v : passes) blocks += v;
  *num_windows_out = static_cast<int64_t>(passes.size());
  *num_blocks_out = blocks;
  return 0;
}

int ell_fill(const int32_t* indptr, const int32_t* indices, const float* data,
             int64_t n, int64_t r, int64_t p, int32_t* cols, float* vals,
             int32_t* win) {
  if (!indptr || !indices || !data || !cols || !vals || !win) return -1;
  const auto passes = window_passes(indptr, n, r, p);
  const int64_t num_windows = static_cast<int64_t>(passes.size());
  int64_t num_blocks = 0;
  for (int64_t v : passes) num_blocks += v;

  const int64_t stride = p * r;  // slots per block
  std::memset(cols, 0, sizeof(int32_t) * num_blocks * stride);
  std::memset(vals, 0, sizeof(float) * num_blocks * stride);

  std::vector<int64_t> block_off(num_windows + 1, 0);
  for (int64_t w = 0; w < num_windows; ++w)
    block_off[w + 1] = block_off[w] + passes[w];
  for (int64_t w = 0; w < num_windows; ++w)
    for (int64_t q = 0; q < passes[w]; ++q)
      win[block_off[w] + q] = static_cast<int32_t>(w);

  for (int64_t i = 0; i < n; ++i) {
    const int64_t w = i / r;
    const int64_t lr = i - w * r;
    const int64_t lo = indptr[i], hi = indptr[i + 1];
    for (int64_t e = lo; e < hi; ++e) {
      const int64_t j = e - lo;                       // edge ordinal in row
      const int64_t blk = block_off[w] + j / p;       // pass block
      const int64_t slot = blk * stride + (j % p) * r + lr;
      cols[slot] = indices[e];
      vals[slot] = data[e];
    }
  }
  return 0;
}

}  // extern "C"
