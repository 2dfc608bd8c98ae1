// The COO product for Hopper (sm_90a), out = A @ x over row-sorted edges.
//
// Replaces no TPU kernel: gcn_tpu computes this product with XLA's fused
// gather and sorted segment_sum (gcn_tpu/ops/spmm.py, the CooAdj branch),
// not with Pallas. It is added for speed: the port's torch-op product
// (ops/spmm.py::_segment_spmm_plain) writes the gathered rows x[cols] and
// the weighted products to device memory, two E x k float32 arrays (373 MB
// each at synth-arxiv's 2.3M padded edges and k = 40), and reads them back
// before torch.segment_reduce sums them. This kernel gathers and weighs x
// rows on chip, sums them there and writes each output row once.
//
// Layout (ops/adjacency.py::coo_adjacency): cols int64 and vals f32 over
// E padded edges, sorted by row; row r's run of edges is
// [row_ptr[r], row_ptr[r+1]) (row_ptr int64[n_rows + 1]). The padding
// edges (col 0, weight 0) close the last row's run and are multiplied all
// the same, as in the plain version. order (int64[n_rows]) lists the rows
// by edge count, longest first, and its first n_long rows are the long
// ones (more than adjacency.LONG_ROW edges); all three are made on the
// host with the arrays.
//
//   out[r, c] = sum_{e in [row_ptr[r], row_ptr[r+1])} vals[e] * x[cols[e], c]
//
// What bounds it on the H100 (synth-arxiv, k = 40): the compulsory bytes
// are 8 B an edge, x read once and out written once, ~73 MB, ~22 us at
// 3.35 TB/s; 2 flop an edge and column is far below the f32 peak. But
// every edge gathers one x row (160 B at k = 40): ~373 MB served by the
// 50 MB L2 that holds x (27 MB), and each gather waits on its col's load,
// which waits on the row's offsets. The chains of those latencies, and the
// longest row's chain above all, are what the design is built around.
//
// Design.
//   * The sum is taken in edge order, one output element a thread,
//     starting at 0, each product rounded before it is added (__fmul_rn,
//     then __fadd_rn, which nvcc cannot contract into an FMA): the same
//     float32 operations in the same order as the plain version (x[cols]
//     * vals, then segment_reduce's sequential loop), so the two are
//     bit-equal, and two calls are too. No atomics; an empty row gives 0.
//   * A lane owns one float4 of a row's columns (one 16-byte load of x a
//     gather); a row's L lanes adapt to k: L = ceil(k / 4) up to 32, and
//     past k = 128 grid.y cuts the columns into slices of at most 32
//     float4s.
//   * Short rows: a group of L lanes walks one row, kUnroll edges a step:
//     it issues the step's gathers before it multiplies any of them and
//     loads the next step's cols and vals while they are in flight. A warp
//     holds floor(32 / L) groups (3 at k = 40). A thread needs few
//     registers (40), so 6 blocks, 48 warps, fit an SM: many rows' chains
//     are in flight at once, and that, more than a long unroll, hides them.
//   * Long rows (synth-arxiv's longest holds 1,046 edges): a group would
//     walk one in series, one latency a step, and be the launch's tail. A
//     whole thread block takes one instead, in chunks: every thread
//     gathers and weighs kUnroll of the chunk's edges into shared memory,
//     then the L lanes of slot 0 add the chunk's products in edge order.
//   * Rows are handed out longest first (order): the long rows' blocks
//     come first in the grid, then the short rows' groups, so the longest
//     short rows start first and no chain starts last.
// x rows must start on 16-byte boundaries with a row stride ldx that is a
// multiple of 4 elements, readable up to the next multiple of 4 columns
// (ops/_align.py copies any other x into zero-padded rows); the padded
// columns are read and never written. The kernel allocates nothing, does
// not synchronize, and launches on the caller's stream.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kMinBlocks = 6;  // blocks an SM holds: at most 40 registers
constexpr int kWarp = 32;
constexpr int kUnroll = 2;     // edges a thread gathers at once
constexpr int kMaxLanes = 32;  // float4s a slice: 128 columns

__device__ __forceinline__ float4 weigh(const float4& x, float v) {
  return make_float4(__fmul_rn(x.x, v), __fmul_rn(x.y, v), __fmul_rn(x.z, v),
                     __fmul_rn(x.w, v));
}

__device__ __forceinline__ void add(float4& acc, const float4& p) {
  acc.x = __fadd_rn(acc.x, p.x);
  acc.y = __fadd_rn(acc.y, p.y);
  acc.z = __fadd_rn(acc.z, p.z);
  acc.w = __fadd_rn(acc.w, p.w);
}

__device__ __forceinline__ const float4* row_of(const float* xv, int64_t c,
                                                int64_t ldx) {
  return reinterpret_cast<const float4*>(xv + c * ldx);
}

// columns 4 vec .. 4 vec + 3 of an output row, those below k
__device__ __forceinline__ void store(float* o, const float4& acc, int k,
                                      int vec) {
  if ((k & 3) == 0) {
    *reinterpret_cast<float4*>(o) = acc;
    return;
  }
  const int left = k - 4 * vec;
  o[0] = acc.x;
  if (left > 1) o[1] = acc.y;
  if (left > 2) o[2] = acc.z;
  if (left > 3) o[3] = acc.w;
}

// One long row a block: chunks of slots x kUnroll edges, slot s gathering
// edges s, s + slots, ... of the chunk; the products wait in shared memory
// for slot 0's lanes, which add them in edge order.
__device__ void long_row(const float* __restrict__ x, int64_t ldx,
                         const int64_t* __restrict__ cols,
                         const float* __restrict__ vals, int64_t beg,
                         int64_t end, float* __restrict__ o, int k, int lanes,
                         float4* prod) {
  const int slots = kThreads / lanes;
  const int s = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int vec = blockIdx.y * lanes + lane;
  const bool live = s < slots && 4 * vec < k;
  const float* xv = x + 4 * vec;
  const int chunk = slots * kUnroll;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t e0 = beg; e0 < end; e0 += chunk) {
    const int m = static_cast<int>(min(static_cast<int64_t>(chunk), end - e0));
    if (live) {
      int64_t c[kUnroll];
      float v[kUnroll];
      float4 g[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (s + slots * j < m) {
          c[j] = __ldg(cols + e0 + s + slots * j);
          v[j] = __ldg(vals + e0 + s + slots * j);
        }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (s + slots * j < m) g[j] = __ldg(row_of(xv, c[j], ldx));
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (s + slots * j < m)
          prod[(s + slots * j) * lanes + lane] = weigh(g[j], v[j]);
    }
    __syncthreads();
    if (s == 0 && live)
      for (int i = 0; i < m; ++i) add(acc, prod[i * lanes + lane]);
    __syncthreads();
  }
  if (s == 0 && live) store(o + 4 * vec, acc, k, vec);
}

// One short row a group of L lanes, kUnroll edges a step.
__device__ void short_row(const float* __restrict__ x, int64_t ldx,
                          const int64_t* __restrict__ cols,
                          const float* __restrict__ vals, int64_t e,
                          int64_t end, float* __restrict__ o, int k, int vec) {
  const float* xv = x + 4 * vec;
  int m = static_cast<int>(min(static_cast<int64_t>(kUnroll), end - e));
  int64_t c[kUnroll];
  float v[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j)
    if (j < m) {
      c[j] = __ldg(cols + e + j);
      v[j] = __ldg(vals + e + j);
    }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  while (m > 0) {
    float4 g[kUnroll];
    float w[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (j < m) {
        g[j] = __ldg(row_of(xv, c[j], ldx));
        w[j] = v[j];
      }
    // the next step's cols and vals, while the gathers are in flight
    e += kUnroll;
    const int mn =
        static_cast<int>(min(static_cast<int64_t>(kUnroll), end - e));
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (j < mn) {
        c[j] = __ldg(cols + e + j);
        v[j] = __ldg(vals + e + j);
      }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (j < m) add(acc, weigh(g[j], w[j]));
    m = mn;
  }
  store(o + 4 * vec, acc, k, vec);
}

// blocks [0, n_long): the long rows order[0 .. n_long), one a block; then
// the short rows order[n_long ..), groups a warp to a row each
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    coo_spmm_kernel(const float* __restrict__ x, int64_t ldx,
                    const int64_t* __restrict__ cols,
                    const float* __restrict__ vals,
                    const int64_t* __restrict__ row_ptr,
                    const int64_t* __restrict__ order, int64_t n_long,
                    float* __restrict__ out, int64_t n_rows, int32_t k,
                    int32_t lanes, int32_t groups) {
  __shared__ float4 prod[kThreads * kUnroll];
  if (blockIdx.x < n_long) {
    const int64_t row = order[blockIdx.x];
    long_row(x, ldx, cols, vals, row_ptr[row], row_ptr[row + 1],
             out + row * k, k, lanes, prod);
    return;
  }
  const int lane = threadIdx.x % kWarp;
  const int group = lane / lanes;
  if (group >= groups) return;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) - n_long) * (kThreads / kWarp) +
      threadIdx.x / kWarp;
  const int64_t item = n_long + warp * groups + group;
  const int vec = blockIdx.y * lanes + lane % lanes;  // the lane's float4
  if (item >= n_rows || 4 * vec >= k) return;
  const int64_t row = order[item];
  short_row(x, ldx, cols, vals, row_ptr[row], row_ptr[row + 1],
            out + row * k, k, vec);
}

}  // namespace

// out (n_rows x k, row-major, contiguous) = A @ x; returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for operands it cannot take.
extern "C" int gcn_coo_spmm(const float* x, int64_t ldx, const int64_t* cols,
                            const float* vals, const int64_t* row_ptr,
                            const int64_t* order, int64_t n_long, float* out,
                            int64_t n_rows, int32_t k, void* stream) {
  if (n_rows <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const int vecs = (k + 3) / 4;
  if (ldx % 4 != 0 || ldx < 4 * vecs || n_long < 0 || n_long > n_rows ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      ((k & 3) == 0 && reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (vecs + kMaxLanes - 1) / kMaxLanes;
  const int lanes = (vecs + slices - 1) / slices;
  const int groups = kWarp / lanes;
  const int64_t rows_per_block =
      static_cast<int64_t>(groups) * (kThreads / kWarp);
  const int64_t blocks =
      n_long + (n_rows - n_long + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slices));
  coo_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, ldx, cols, vals, row_ptr, order, n_long, out, n_rows, k, lanes,
      groups);
  return static_cast<int>(cudaGetLastError());
}
