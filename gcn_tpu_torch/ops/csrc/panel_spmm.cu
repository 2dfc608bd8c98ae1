// K2: row-window panel SpMM for Hopper (sm_90a), out = A @ x over PanelAdj.
//
// Replaces the TPU path of gcn_tpu/ops/panel_spmm.py:
//   * _scatter_kernel (panel_spmm.py:66), the Pallas one-hot scatter
//     out[window(b)] += onehot(local_row[b]) (R x NB) @ products[b] (NB x k)
//     on the MXU at HIGHEST precision, accumulating consecutive blocks of
//     one window in VMEM through the sequential revisit grid;
//   * _panel_scatter (panel_spmm.py:97), its pallas_call;
//   * _gather_products (panel_spmm.py:137), the XLA gather x[cols] * vals
//     that feeds it through device memory.
//
// Layout (gcn_tpu_torch/tile/format.py): cols int32 / vals f32 / local_row
// int32 of shape (num_blocks, NB); window w owns blocks
// [win_off[w], win_off[w+1]); a padding slot has local_row == R.
//
//   out[w*R + i, c] = sum_{slots s of window w, local_row[s] == i}
//                     vals[s] * x[cols[s], c]
//
// Design. One thread block of 32 warps per (window, 32-column tile); the
// TPU's sequential revisit grid becomes the block's walk over its window's
// slots, found through win_off. The block's walkers share those slots out
// in fixed contiguous shares. A walker is a group of 8 lanes that together
// hold the tile's 32 columns, four a lane (one float4 load), so a warp
// holds 4 walkers. The float4 loads need x's rows on 16-byte boundaries:
// the caller passes x with a row stride ldx that is a multiple of 4 and a
// 16-byte-aligned base (ops/panel_spmm.py pads or copies any other x).
// Lane j of a walker loads slot j's (local_row, col, val) of each run of 8
// slots (coalesced, and the next run's ahead of use); the walker broadcasts
// them with shuffles and issues its 8 gathered x-row loads together before
// summing them, so the products never touch device memory (the TPU path
// writes and rereads them: ~341 MB at synth-arxiv, k = 32). Padding slots
// are skipped.
//
// The window's R x 32 f32 sum lives in shared memory. The layout keeps
// each window's real slots in CSR order with the padding at the tail
// (tile/format.py; PanelAdj.validate checks it), so a walker sees each row
// as one run of consecutive slots, summed in registers. A run that ends
// inside the walker's share belongs to no other walker and is added into
// the shared sum at once; the walker's first and last runs, which a
// neighbouring share may continue, are set aside, and each row among them
// is then summed in walker order by the warp that holds its first part.
// Each output row of the window is written once, zeros included: no
// atomics, a fixed order of summation, a deterministic result. All in f32
// (the counterpart of HIGHEST): no TF32, no tensor cores.
//
// Bound on the H100 at synth-arxiv, k = 32 (reordered, 2.59M slots): the
// compulsory bytes are 12 B a slot (cols, vals, local_row), x read once and
// out written once, ~75 MB, i.e. ~22 us at 3.35 TB/s; 2 flop per edge and
// column is far below the f32 peak, so bytes bound it. x (21.7 MB) stays
// in the 50 MB L2, which serves the gathered rows. A window runs on one SM,
// so the hub windows of a degree-sorted graph (the first holds 228 blocks,
// 4.5% of the slots) form the kernel's tail; there the SM's instruction
// issue (shuffles, loads, adds for each slot) rather than memory paces the
// walk, which is why a walker holds four columns a lane. The k > 32 column
// tiles each reread the window's metadata. Shared memory at R = 128 is
// 50,176 B (the sum, 128 walkers' first and last runs and their rows),
// above the 48 KB default, so the kernel's limit is raised once per device.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 32;
constexpr int V = 4;             // columns a lane (one float4)
constexpr int L = 32 / V;        // lanes a walker
constexpr int Q = kWarps * V;    // walkers a block
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// shared memory: the window's sum [r][32], then each walker's first and
// last runs [2Q][32] and their rows [2Q]
size_t smem_bytes(int32_t r) {
  return ((size_t)r * 32 + 2 * Q * 32) * sizeof(float) +
         2 * Q * sizeof(int32_t);
}

__global__ void __launch_bounds__(kWarps * 32, 1)
    panel_spmm_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ cols,
                      const float* __restrict__ vals,
                      const int32_t* __restrict__ local_row,
                      const int32_t* __restrict__ win_off,
                      float* __restrict__ out, int32_t n_out, int32_t r,
                      int32_t nb, int32_t k, int32_t ldx) {
  extern __shared__ float smem[];
  float* sum = smem;                      // [r][32]
  float* edge = smem + (int64_t)r * 32;   // [2Q][32]
  int32_t* edge_row = reinterpret_cast<int32_t*>(edge + 2 * Q * 32);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int li = lane % L;
  const int q = warp * V + lane / L;
  const int64_t w = blockIdx.x;
  const int32_t c0 = blockIdx.y * 32;
  const int32_t cl = li * V;             // this lane's first column in tile
  const bool col_ok = c0 + cl < ldx;     // its float4 lies in x's row
  for (int32_t i = threadIdx.x; i < r * 32; i += blockDim.x) sum[i] = 0.0f;
  __syncthreads();

  const int64_t s0 = (int64_t)win_off[w] * nb;
  const int64_t total = (int64_t)win_off[w + 1] * nb - s0;
  const int64_t share = ((total + Q - 1) / Q + L - 1) / L * L;
  const int64_t a = s0 + min64(total, q * share);
  const int64_t e = s0 + min64(total, (q + 1) * share);

  int32_t first_row = r;  // the walker's first run, set aside; r = none
  float first[V], run[V];
#pragma unroll
  for (int t = 0; t < V; ++t) first[t] = run[t] = 0.0f;
  int32_t cur = r;        // row of the running sum; r = none
  int32_t lr_next = r, c_next = 0;
  float v_next = 0.0f;
  if (a + li < e) {
    lr_next = __ldg(local_row + a + li);
    c_next = __ldg(cols + a + li);
    v_next = __ldg(vals + a + li);
  }
  // every lane of a warp runs the same number of steps: walkers of one
  // warp have equal shares except at the window's tail
  const int64_t steps = (share + L - 1) / L;
  for (int64_t step = 0; step < steps; ++step) {
    const int32_t lr = lr_next, c = c_next;
    const float v = v_next;
    const int64_t s = a + (step + 1) * L + li;
    lr_next = r;
    if (s < e) {
      lr_next = __ldg(local_row + s);
      c_next = __ldg(cols + s);
      v_next = __ldg(vals + s);
    }
    float4 xv[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int32_t cj = __shfl_sync(kFull, c, j, L);
      const int32_t lj = __shfl_sync(kFull, lr, j, L);
      xv[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (lj < r && col_ok) {
        xv[j] = __ldg(reinterpret_cast<const float4*>(
            x + (int64_t)cj * ldx + c0 + cl));
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int32_t lj = __shfl_sync(kFull, lr, j, L);
      const float vj = __shfl_sync(kFull, v, j, L);
      if (lj == r) continue;  // padding, or past the share
      if (lj != cur) {        // a run ends
        if (cur < r) {
          if (first_row == r) {
            first_row = cur;
#pragma unroll
            for (int t = 0; t < V; ++t) first[t] = run[t];
          } else {
#pragma unroll
            for (int t = 0; t < V; ++t) sum[cur * 32 + cl + t] += run[t];
          }
        }
        cur = lj;
#pragma unroll
        for (int t = 0; t < V; ++t) run[t] = 0.0f;
      }
      run[0] = fmaf(vj, xv[j].x, run[0]);
      run[1] = fmaf(vj, xv[j].y, run[1]);
      run[2] = fmaf(vj, xv[j].z, run[2]);
      run[3] = fmaf(vj, xv[j].w, run[3]);
    }
  }
  // the last run; a walker with a single run keeps it as its first
  if (first_row == r) {
    first_row = cur;
#pragma unroll
    for (int t = 0; t < V; ++t) first[t] = run[t];
    cur = r;
  }
#pragma unroll
  for (int t = 0; t < V; ++t) {
    edge[(2 * q) * 32 + cl + t] = first[t];
    edge[(2 * q + 1) * 32 + cl + t] = run[t];
  }
  if (li == 0) {
    edge_row[2 * q] = first_row;
    edge_row[2 * q + 1] = cur;
  }
  __syncthreads();
  // Each row among the set-aside runs is summed, in walker order, by the
  // warp holding its first part. Between two real entries lies at most one
  // empty one (a single-run walker's last); an empty first entry means an
  // empty walker, and every later walker is empty too (padding is last).
  for (int i = warp; i < 2 * Q; i += kWarps) {
    const int32_t row = edge_row[i];
    if (row == r) continue;
    int32_t prev = i > 0 ? edge_row[i - 1] : r;
    if (prev == r && i > 1) prev = edge_row[i - 2];
    if (prev == row) continue;
    float acc = edge[i * 32 + lane];
    for (int j = i + 1; j < 2 * Q; ++j) {
      const int32_t rj = edge_row[j];
      if (rj == r) {
        if ((j & 1) == 0) break;
        continue;
      }
      if (rj != row) break;
      acc += edge[j * 32 + lane];
    }
    sum[row * 32 + lane] += acc;
  }
  __syncthreads();

  const int64_t row0 = w * r;
  for (int32_t idx = threadIdx.x; idx < r * 32; idx += blockDim.x) {
    const int64_t row = row0 + (idx >> 5);
    const int32_t cc = c0 + (idx & 31);
    if (row < n_out && cc < k) out[row * k + cc] = sum[idx];
  }
}

// Raises the kernel's dynamic shared memory limit to the whole of a block's
// on the current device, once per device.
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(panel_spmm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

}  // namespace

// x: f32 (n_cols, k) with row stride ldx, a multiple of 4, and a 16-byte-
// aligned base (columns k..ldx-1 are read and dropped); cols/vals/
// local_row: (num_blocks, nb); win_off: int32 (num_windows + 1); out: f32
// (n_out, k), n_out <= num_windows * r. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for an x it cannot take or
// when the window's r x 32 sum exceeds shared memory.
extern "C" int gcn_panel_spmm_f32(const float* x, const int32_t* cols,
                                  const float* vals,
                                  const int32_t* local_row,
                                  const int32_t* win_off, float* out,
                                  int32_t num_windows, int32_t n_out,
                                  int32_t r, int32_t nb, int32_t k,
                                  int32_t ldx, void* stream) {
  if (n_out <= 0 || k <= 0 || num_windows <= 0)
    return (int)cudaGetLastError();
  const size_t smem = smem_bytes(r);
  if (ldx % 4 != 0 || ldx < k || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)num_windows, (unsigned)((k + 31) / 32));
  panel_spmm_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, cols, vals, local_row, win_off, out, n_out, r, nb, k, ldx);
  return (int)cudaGetLastError();
}
