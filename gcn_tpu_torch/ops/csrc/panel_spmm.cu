// K2: row-window panel SpMM for Hopper (sm_90a), out = A @ x over PanelAdj.
//
// Replaces the TPU path of gcn_tpu/ops/panel_spmm.py:
//   * _scatter_kernel (panel_spmm.py:66), the Pallas one-hot scatter
//     out[window(b)] += onehot(local_row[b]) (R x NB) @ products[b] (NB x k)
//     on the MXU at HIGHEST precision, accumulating consecutive blocks of
//     one window in VMEM through the sequential revisit grid;
//   * _panel_scatter (panel_spmm.py:98), its pallas_call;
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
// What bounds it on the H100 (synth-arxiv, k = 32, reordered, 2.59M
// slots): the compulsory bytes are 12 B a slot (cols, vals, local_row), x
// read once and out written once, ~75 MB, ~22 us at 3.35 TB/s; 2 flop an
// edge and column is far below the f32 peak. Each slot gathers a 128-B x
// row from the 50 MB L2 that holds x (~330 MB in all), and the SM's issue
// of shuffles, loads and adds for each slot paces a walk. A degree-sorted
// graph puts its hub rows in the first windows: at synth-arxiv the first
// holds 4.5% of the slots, ~6 times an SM's fair share, and a window that
// runs on one SM is the kernel's tail.
//
// Design. One SpMM is two launches of one kernel body, each over a list of
// windows from the split plan (tile/tiler.py::split_plan, made on the host
// when the PanelAdj is built):
//   * heavy windows, more slots than the per-SM mean: a thread block
//     cluster of kParts CTAs walks each, CTA q a contiguous share of the
//     window's slots (the plan's part q), into its own R x 32 shared sum.
//     The cluster then combines the parts through distributed shared
//     memory: rank q sums rows [q*R/kParts, (q+1)*R/kParts) over ranks
//     0..kParts-1 in rank order and writes them once;
//   * light windows: one CTA a window, with half the warps of a heavy CTA
//     and a smaller shared footprint (33 KB against 50 KB at R = 128), so
//     that two share an SM and one window's zeroing and syncs overlap the
//     other's walk.
// The two launches write disjoint rows, so the heavy one runs on a side
// stream forked from the caller's, beside the light one, and the caller's
// stream waits for it: the hub parts (~1.9 MB of gathers each at
// synth-arxiv, paced by one SM's share of the L2) overlap the light walk.
// Inside a CTA (and a 32-column tile, grid.y), walkers share the CTA's
// slots out in fixed contiguous shares. A walker is a group of 8 lanes
// that together hold the tile's 32 columns, four a lane (one float4 load),
// so a warp holds 4 walkers. The float4 loads need x's rows on 16-byte
// boundaries: the caller passes a row stride ldx that is a multiple of 4
// and a 16-byte-aligned base (ops/_align.py copies any other x). Lane j of
// a walker loads slot j's (local_row, col, val) of each run of 8 slots
// (coalesced, and the next run's ahead of use); the walker broadcasts them
// with shuffles and issues its 8 gathered x-row loads together before
// summing them, so the products never touch device memory (the TPU path
// writes and rereads them). Padding slots are skipped.
//
// Each window keeps its real slots in CSR order with the padding at the
// tail (tile/format.py; PanelAdj.validate checks it), so a walker sees each
// row as one run of consecutive slots, summed in registers. A run that ends
// inside the walker's share belongs to no other walker and is added into
// the shared sum at once; the walker's first and last runs, which a
// neighbouring share may continue, are set aside, and each row among them
// is then summed in walker order by the warp that holds its first part. A
// run that crosses a part boundary leaves a partial sum in each part, and
// the rank-order combine adds them. Each output element is written once:
// no atomics, a fixed order of summation, a deterministic result. All in
// f32 (the counterpart of HIGHEST): no TF32, no tensor cores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int V = 4;                 // columns a lane (one float4)
constexpr int L = 32 / V;            // lanes a walker
constexpr int kParts = 8;            // CTAs of a heavy window's cluster
constexpr int kHeavyWarps = 32;      // warps a heavy-window CTA
constexpr int kLightWarps = 16;      // warps a light-window CTA
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// shared memory: the window's sum [r][32], then each walker's first and
// last runs [2Q][32] and their rows [2Q]
template <int WARPS>
size_t smem_bytes(int32_t r) {
  constexpr int Q = WARPS * V;
  return ((size_t)r * 32 + 2 * Q * 32) * sizeof(float) +
         2 * Q * sizeof(int32_t);
}

// Window windows[blockIdx.x] (light), or part `rank` of heavy window
// windows[blockIdx.x / kParts] (SPLIT, one cluster a window).
template <int WARPS, bool SPLIT>
__global__ void __launch_bounds__(WARPS * 32)
    panel_spmm_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ cols,
                      const float* __restrict__ vals,
                      const int32_t* __restrict__ local_row,
                      const int32_t* __restrict__ win_off,
                      const int32_t* __restrict__ windows,
                      const int32_t* __restrict__ parts,
                      float* __restrict__ out, int32_t n_out, int32_t r,
                      int32_t nb, int32_t k, int32_t ldx) {
  constexpr int Q = WARPS * V;   // walkers a block
  extern __shared__ float smem[];
  float* sum = smem;                      // [r][32]
  float* edge = smem + (int64_t)r * 32;   // [2Q][32]
  int32_t* edge_row = reinterpret_cast<int32_t*>(edge + 2 * Q * 32);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int li = lane % L;
  const int q = warp * V + lane / L;
  const int32_t c0 = blockIdx.y * 32;
  const int32_t cl = li * V;             // this lane's first column in tile
  const bool col_ok = c0 + cl < ldx;     // its float4 lies in x's row
  for (int32_t i = threadIdx.x; i < r * 32; i += blockDim.x) sum[i] = 0.0f;
  __syncthreads();

  int32_t w;
  int64_t s0, total;  // the CTA's slots [s0, s0 + total)
  if constexpr (SPLIT) {
    const int32_t h = blockIdx.x / kParts;
    const int32_t rank = (int32_t)cg::this_cluster().block_rank();
    w = windows[h];
    const int32_t* pr = parts + h * (kParts + 1) + rank;
    s0 = (int64_t)win_off[w] * nb + pr[0];
    total = pr[1] - pr[0];
  } else {
    w = windows[blockIdx.x];
    s0 = (int64_t)win_off[w] * nb;
    total = (int64_t)win_off[w + 1] * nb - s0;
  }
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
  // warp have equal shares except at the CTA's tail
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
  for (int i = warp; i < 2 * Q; i += WARPS) {
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

  const int64_t row0 = (int64_t)w * r;
  if constexpr (SPLIT) {
    // every part's sum is complete; rank q then sums its rows over the
    // cluster's parts in rank order, and no CTA leaves while another
    // still reads its shared memory
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int32_t rank = (int32_t)cluster.block_rank();
    const int32_t per = (r + kParts - 1) / kParts;
    const int32_t lo = min(r, rank * per) * 32;
    const int32_t hi = min(r, (rank + 1) * per) * 32;
    for (int32_t idx = lo + threadIdx.x; idx < hi; idx += blockDim.x) {
      float acc = 0.0f;
#pragma unroll
      for (int src = 0; src < kParts; ++src)
        acc += cluster.map_shared_rank(sum, src)[idx];
      const int64_t row = row0 + (idx >> 5);
      const int32_t cc = c0 + (idx & 31);
      if (row < n_out && cc < k) out[row * k + cc] = acc;
    }
    cluster.sync();
  } else {
    __syncthreads();
    for (int32_t idx = threadIdx.x; idx < r * 32; idx += blockDim.x) {
      const int64_t row = row0 + (idx >> 5);
      const int32_t cc = c0 + (idx & 31);
      if (row < n_out && cc < k) out[row * k + cc] = sum[idx];
    }
  }
}

// Raises a kernel's dynamic shared memory limit to the whole of a block's
// on the current device, once per device and kernel.
template <int WARPS, bool SPLIT>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(panel_spmm_kernel<WARPS, SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

// The stream the heavy-window launch forks onto (the highest priority,
// so that the long hub parts start first) and the events of the fork and
// the join, made once per device. One SpMM at a time uses them: `mu` is
// held from the fork's record to the join's wait, so another host thread
// cannot re-record `fork` before the side stream has waited on it. Under
// a CUDA graph capture the record and the wait fork the side stream into
// the capture and join it back, so the graph holds both launches; the
// stream, the events and allow_smem's attribute are made by a call before
// any capture (a captured fit's eager warm-up, train/capture.py).
struct Side {
  std::mutex mu;
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

// The current device's Side, locked into `lock` for the caller.
cudaError_t side_stream(Side** side, std::unique_lock<std::mutex>* lock) {
  static Side sides[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Side& sd = sides[dev];
  *lock = std::unique_lock<std::mutex>(sd.mu);
  if (sd.stream == nullptr) {
    int least = 0, greatest = 0;
    err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming);
    if (err == cudaSuccess)
      err = cudaStreamCreateWithPriority(&sd.stream, cudaStreamNonBlocking,
                                         greatest);
    if (err != cudaSuccess) return err;
  }
  *side = &sd;
  return cudaSuccess;
}

template <int WARPS, bool SPLIT>
cudaError_t launch(int32_t n_windows, const float* x, const int32_t* cols,
                   const float* vals, const int32_t* local_row,
                   const int32_t* win_off, const int32_t* windows,
                   const int32_t* parts, float* out, int32_t n_out,
                   int32_t r, int32_t nb, int32_t k, int32_t ldx,
                   cudaStream_t stream) {
  if (n_windows <= 0) return cudaSuccess;
  const size_t smem = smem_bytes<WARPS>(r);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem<WARPS, SPLIT>();
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_windows * (SPLIT ? kParts : 1),
                     (unsigned)((k + 31) / 32));
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kParts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SPLIT ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, panel_spmm_kernel<WARPS, SPLIT>, x, cols,
                            vals, local_row, win_off, windows, parts, out,
                            n_out, r, nb, k, ldx);
}

}  // namespace

// One SpMM, as two launches ordered on `stream`: the n_heavy windows of
// `heavy` (int32), each split by `heavy_parts` (int32 (n_heavy, 9), slot
// offsets from the window's first slot) across a cluster of 8 CTAs, on a
// side stream forked from `stream`, and beside it the n_light windows of
// `light` (int32), a CTA each; work queued on `stream` afterwards waits
// for both. x: f32 (n_cols, k) with row stride ldx, a multiple of 4, and
// a 16-byte-aligned base (columns k..ldx-1 are read and dropped);
// cols/vals/local_row: (num_blocks, nb); win_off: int32 (num_windows +
// 1); out: f32 (n_out, k), n_out <= num_windows * r; every window of
// [0, ceil(n_out / r)) in one of the two lists. Returns the first launch
// error, or cudaErrorInvalidValue for an x it cannot take or when the
// window's r x 32 sum exceeds shared memory.
extern "C" int gcn_panel_spmm_f32(
    const float* x, const int32_t* cols, const float* vals,
    const int32_t* local_row, const int32_t* win_off, const int32_t* heavy,
    const int32_t* heavy_parts, int32_t n_heavy, const int32_t* light,
    int32_t n_light, float* out, int32_t n_out, int32_t r, int32_t nb,
    int32_t k, int32_t ldx, void* stream) {
  if (n_out <= 0 || k <= 0) return (int)cudaGetLastError();
  if (ldx % 4 != 0 || ldx < k || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the heavy windows run on a side stream forked from `stream`, beside
  // the light ones (their rows are disjoint); `stream` then waits for them.
  // The side stream is unknown to PyTorch's allocator: every buffer it
  // touches was allocated on `stream` before the fork, and `stream` waits
  // for the join before any later use or reuse of them.
  cudaStream_t hs = s;
  Side* side = nullptr;
  std::unique_lock<std::mutex> lock;  // held to the join's wait
  cudaError_t err = cudaSuccess;
  const bool fork = n_heavy > 0 && n_light > 0;
  if (fork) {
    err = side_stream(&side, &lock);
    if (err == cudaSuccess) err = cudaEventRecord(side->fork, s);
    if (err == cudaSuccess)
      err = cudaStreamWaitEvent(side->stream, side->fork);
    if (err != cudaSuccess) return (int)err;
    hs = side->stream;
  }
  err = launch<kHeavyWarps, true>(n_heavy, x, cols, vals, local_row, win_off,
                                  heavy, heavy_parts, out, n_out, r, nb, k,
                                  ldx, hs);
  if (err == cudaSuccess && fork) err = cudaEventRecord(side->join, hs);
  if (err == cudaSuccess)
    err = launch<kLightWarps, false>(n_light, x, cols, vals, local_row,
                                     win_off, light, nullptr, out, n_out, r,
                                     nb, k, ldx, s);
  if (err == cudaSuccess && fork) err = cudaStreamWaitEvent(s, side->join);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
