// K1: packed-stride ELL SpMM for Hopper (sm_90a), out = A @ x.
//
// Replaces the TPU path of gcn_tpu/ops/ell_spmm.py:
//   * _reduce_kernel (ell_spmm.py:55), the Pallas pass-block reduce that
//     accumulates each window's (R, k_pad) pass-blocks by revisiting its
//     output block on the sequential grid;
//   * _gather_stride_sum (ell_spmm.py:159), the XLA gather + weighting +
//     sum over the P slot strides that feeds it;
//   * the grouped-span reduce (ell_spmm.py:234-280), and with it every
//     branch of _spmm_ell_impl: hub runs, row chunks, unsorted graphs, and
//     the k > k_pad column-chunk recursion (ell_spmm.py:191-199).
//
// Layout (gcn_tpu_torch/tile/ell.py): cols int32 / vals f32 of shape
// (num_blocks, P, R); window w owns blocks [win_off[w], win_off[w+1]).
// Slot s = b*P + j of window w holds, for row i of the window, the edge at
// cols[s*R + i] with weight vals[s*R + i]; padding slots carry col 0 and
// weight 0, and are multiplied all the same (so x[0] that is not finite
// poisons the row exactly as it does on the TPU path).
//
//   out[w*R + i, c] = sum_{b in window w} sum_{j < P}
//                     vals[(b*P+j)*R + i] * x[cols[(b*P+j)*R + i], c]
//
// What bounds it on the H100 (synth-arxiv, k = 32): the compulsory bytes
// are cols + vals (8 B a slot), x read once and out written once, ~66 MB,
// ~20 us at 3.35 TB/s; ~2 flop an edge and column is far below the f32
// peak. But every slot gathers one x row (128 B at k = 32, f32): ~2.6M
// rows, ~335 MB, served by the 50 MB L2 that holds x. That gather volume,
// and the latency of each gather, is what the kernel is built around: the
// TPU kernel streams whole pass-blocks through VMEM, where on this card a
// gather that waits on a col load that waits on memory is a chain of two
// latencies, and only many gathers in flight hide them. And a window's
// pass-blocks are a walk in series: on a layout without the hub split (the
// serving layout, HGNN's G) one window walks 262 pass-blocks where the
// mean is 4, and the one thread block that walks it is the kernel's tail.
//
// Design. One SpMM is two launches of one kernel body, each over a list of
// windows from the walk split plan (tile/ell.py::walk_split_plan, made on
// the host with the layout), as kernel K2 (panel_spmm.cu) does:
//   * light windows, at most half the per-SM mean of pass-blocks or at
//     most 16 steps (below): a thread block per (window, slab of up to 64
//     rows) walks the window whole;
//   * heavy windows: a thread block cluster of C blocks per (window,
//     slab); block q walks the plan's part q, a contiguous share of the
//     window's pass-blocks, into registers. The cluster then puts its
//     partial 64 x 32 sums in shared memory, and rank q sums its share of
//     the slab's rows over ranks 0..C-1, in rank order, through
//     distributed shared memory, and writes them once.
// The two launches write disjoint rows, so the heavy one runs on a side
// stream forked from the caller's, beside the light one, and the caller's
// stream waits for it.
// A thread block has 128 threads and one 32-column tile of x (grid.y walks
// the column tiles, so k > 32 needs no loop in the kernel). A row group of
// 8 lanes covers the tile, 4 columns a lane: one 16-byte load of f32 x,
// one 8-byte load of bf16 x. A group owns 4 rows of the slab (i, i + G,
// i + 2G, i + 3G for G groups).
//   * Metadata on chip. The walk's slot rows (a window's pass-blocks are
//     contiguous, so its slots b*P + j are one run of rows of R) come into
//     shared memory with cp.async, max(P, 4) slot rows a stage, in a ring
//     of kStages, so the next stages' metadata arrives while the current
//     one is summed, and a gather's col comes from shared memory.
//   * Many gathers in flight. A step takes JB = 4 slot rows, across
//     pass-block boundaries when P < 4: a thread issues the gathers of the
//     4 slots of its 4 rows (16 independent vector loads) before it
//     multiplies any of them, at any P. A P = 1 walk of 262 pass-blocks
//     takes 66 steps.
//   * One loop for the four variants (f32; table_bf16, x as bf16;
//     products_bf16; both). The sums are taken in f32; under ROUND
//     (products_bf16, gcn_tpu's _gather_stride_sum output in bf16) each
//     pass-block's P-slot sum is rounded to bf16 at its last slot before
//     it is added into the window's sum.
//   * Each output element is written once, by the thread that summed it
//     or (heavy windows) by the cluster rank that combined it: no atomics,
//     a fixed order of summation, a deterministic result. Index arithmetic
//     inside a walk is 32-bit.
// The x rows must start on vector boundaries: the caller passes a row
// stride ldx that is a multiple of 4 and an aligned base (ops/_align.py
// copies any other x into zero-padded rows); R must be a multiple of 4 and
// cols/vals 16-byte aligned, for the 16-byte copies.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int V = 4;             // columns a lane: one vector load
constexpr int L = 32 / V;        // lanes a row group: one 32-column tile
constexpr int RPT = 4;           // rows a group
constexpr int JB = 4;            // slot rows whose gathers are issued together
constexpr int kMaxGroups = 16;   // groups a block: 128 threads, 64 rows
constexpr int kStages = 3;       // stages of metadata in the ring
constexpr int kMaxParts = 16;    // blocks of a heavy window's cluster
constexpr int kPortableParts = 8;
constexpr int kMaxDevices = 64;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using raw = float4;
  __device__ static raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float4 widen(raw v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  using raw = uint2;  // four bf16, element 0 in the low half of .x
  __device__ static raw zero() { return make_uint2(0u, 0u); }
  __device__ static raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static float4 widen(raw v) {
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fma4(float (&a)[V], float v, float4 xf) {
  a[0] = fmaf(v, xf.x, a[0]);
  a[1] = fmaf(v, xf.y, a[1]);
  a[2] = fmaf(v, xf.z, a[2]);
  a[3] = fmaf(v, xf.w, a[3]);
}

// slot rows a stage of the ring: one pass-block, or four slot rows when a
// pass-block has fewer
__host__ __device__ __forceinline__ int32_t stage_rows(int32_t p) {
  return p > JB ? p : JB;
}

// shared memory of a block: the ring [stage][stage_rows][slab] of cols and
// of vals, then (SPLIT) the partial sums [slab][32]
size_t smem_bytes(int32_t p, int32_t slab, bool split) {
  return (size_t)kStages * stage_rows(p) * slab * 8 +
         (split ? (size_t)slab * 32 * sizeof(float) : 0);
}

// Slab (blockIdx.x % slabs) of window windows[blockIdx.x / slabs] (light),
// or part `rank` of slab (item % slabs) of heavy window windows[item /
// slabs], item = blockIdx.x / n_parts (SPLIT: one cluster of n_parts
// blocks an item).
// At most 128 registers a thread, so that four blocks share an SM (the
// products_bf16 variants' running pass-block sums otherwise take ~140).
template <typename T, bool ROUND, bool SPLIT>
__global__ void __launch_bounds__(kMaxGroups * L, 4)
    ell_spmm_kernel(const T* __restrict__ x, int32_t ldx,
                    const int32_t* __restrict__ cols,
                    const float* __restrict__ vals,
                    const int32_t* __restrict__ win_off,
                    const int32_t* __restrict__ windows,
                    const int32_t* __restrict__ parts,
                    float* __restrict__ out, int32_t n_out, int32_t r,
                    int32_t p, int32_t k, int32_t slabs, int32_t n_parts) {
  extern __shared__ int4 smem[];
  const int groups = blockDim.x / L;
  const int32_t slab = groups * RPT;   // rows a block can hold
  const int32_t spr = stage_rows(p);
  int32_t* s_cols = reinterpret_cast<int32_t*>(smem);  // [stage][spr][slab]
  float* s_vals = reinterpret_cast<float*>(s_cols + kStages * spr * slab);
  int32_t item = blockIdx.x, rank = 0;
  if constexpr (SPLIT) {
    rank = (int32_t)cg::this_cluster().block_rank();
    item = blockIdx.x / n_parts;
  }
  const int32_t wi = item / slabs;
  const int32_t w = __ldg(windows + wi);
  const int32_t r0 = (item - wi * slabs) * slab;
  const int64_t row0 = (int64_t)w * r + r0;
  // a slab past the output rows has nothing to write (the whole cluster
  // shares the slab, so it leaves together)
  if (row0 >= n_out) return;
  const int32_t rows = min(slab, r - r0);
  const int g = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const int32_t col = blockIdx.y * 32 + lane * V;
  const bool col_ok = col < k;
  int32_t b0 = __ldg(win_off + w);
  int32_t nblk = __ldg(win_off + w + 1) - b0;
  if constexpr (SPLIT) {
    const int32_t* pr = parts + wi * (n_parts + 1) + rank;
    b0 += __ldg(pr);
    nblk = __ldg(pr + 1) - __ldg(pr);
  }
  const int32_t n_slots = nblk * p;    // slot rows of the walk
  const int32_t n_stages = (n_slots + spr - 1) / spr;
  const int64_t first = (int64_t)b0 * p * r + r0;
  const int32_t* wc = cols + first;
  const float* wv = vals + first;

  // copy stage st's slot rows (`rows` ints and floats each) into its place
  // in the ring, 16 bytes a copy
  const int32_t chunks = rows / 4;
  auto stage = [&](int32_t st) {
    const int32_t s0 = st * spr;
    const int32_t n = min(spr, n_slots - s0) * chunks;
    const int32_t base = (st % kStages) * spr * slab;
    for (int32_t c = threadIdx.x; c < n; c += blockDim.x) {
      const int32_t j = c / chunks;
      const int32_t q = (c - j * chunks) * 4;
      const int32_t src = (s0 + j) * r + q;
      const int32_t dst = base + j * slab + q;
      cp_async16(s_cols + dst, wc + src);
      cp_async16(s_vals + dst, wv + src);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) stage(s);
    cp_async_commit();
  }

  float acc[RPT][V];
  float part[RPT][V];  // ROUND: the running pass-block's sum
#pragma unroll
  for (int t = 0; t < RPT; ++t)
#pragma unroll
    for (int u = 0; u < V; ++u) acc[t][u] = part[t][u] = 0.0f;

  for (int32_t st = 0; st < n_stages; ++st) {
    // stage st has landed, and every thread is done with st - 1, whose
    // place the next copy refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (st + kStages - 1 < n_stages) stage(st + kStages - 1);
    cp_async_commit();
    const int32_t* sc = s_cols + (st % kStages) * spr * slab;
    const float* sv = s_vals + (st % kStages) * spr * slab;
    const int32_t srows = min(spr, n_slots - st * spr);
    for (int32_t j0 = 0; j0 < srows; j0 += JB) {
      typename Vec<T>::raw xv[JB][RPT];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
#pragma unroll
        for (int t = 0; t < RPT; ++t) {
          const int32_t i = g + groups * t;
          xv[jj][t] = Vec<T>::zero();
          if (j0 + jj < srows && i < rows && col_ok) {
            const int32_t c = sc[(j0 + jj) * slab + i];
            xv[jj][t] = Vec<T>::load(x + (int64_t)c * ldx + col);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        if (j0 + jj >= srows) break;
#pragma unroll
        for (int t = 0; t < RPT; ++t) {
          const int32_t i = g + groups * t;
          if (i < rows) {
            const float v = sv[(j0 + jj) * slab + i];
            const float4 xf = Vec<T>::widen(xv[jj][t]);
            if constexpr (ROUND) {
              fma4(part[t], v, xf);
            } else {
              fma4(acc[t], v, xf);
            }
          }
        }
        if constexpr (ROUND) {
          // the pass-block's last slot: a stage starts on a pass-block
          if (((j0 + jj + 1) & (p - 1)) == 0) {
#pragma unroll
            for (int t = 0; t < RPT; ++t)
#pragma unroll
              for (int u = 0; u < V; ++u) {
                acc[t][u] += __bfloat162float(__float2bfloat16_rn(part[t][u]));
                part[t][u] = 0.0f;
              }
          }
        }
      }
    }
  }

  if constexpr (SPLIT) {
    // every part's sums into this block's shared memory; then rank q sums
    // its share of the slab's rows over the cluster's parts in rank order,
    // and no block leaves while another still reads its shared memory
    float* s_sum = s_vals + kStages * spr * slab;   // [slab][32]
#pragma unroll
    for (int t = 0; t < RPT; ++t) {
      const int32_t i = g + groups * t;
      if (i < rows)
        *reinterpret_cast<float4*>(s_sum + i * 32 + lane * V) =
            make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int32_t per = (rows + n_parts - 1) / n_parts;
    const int32_t lo = min(rows, rank * per) * 32;
    const int32_t hi = min(rows, (rank + 1) * per) * 32;
    for (int32_t idx = lo + threadIdx.x; idx < hi; idx += blockDim.x) {
      float sum = 0.0f;
      for (int32_t src = 0; src < n_parts; ++src)
        sum += cluster.map_shared_rank(s_sum, src)[idx];
      const int64_t row = row0 + (idx >> 5);
      const int32_t cc = blockIdx.y * 32 + (idx & 31);
      if (row < n_out && cc < k) out[row * k + cc] = sum;
    }
    cluster.sync();
  } else {
    if (!col_ok) return;
#pragma unroll
    for (int t = 0; t < RPT; ++t) {
      const int32_t i = g + groups * t;
      if (i >= rows || row0 + i >= n_out) continue;
      float* o = out + (row0 + i) * k + col;
      if (k % V == 0) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          if (col + u < k) o[u] = acc[t][u];
        }
      }
    }
  }
}

// Allows a cluster of more than 8 blocks (non-portable) for one kernel,
// once per device.
template <typename T, bool ROUND>
cudaError_t allow_wide_clusters() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(ell_spmm_kernel<T, ROUND, true>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
  return err;
}

struct Shape {
  int32_t groups, slab, slabs;
};

Shape shape_of(int32_t r) {
  const int groups = r / RPT < kMaxGroups ? r / RPT : kMaxGroups;
  const int32_t slab = groups * RPT;
  return {groups, slab, (r + slab - 1) / slab};
}

// The launch configuration of one list: n_windows windows (x n_parts
// blocks a cluster when SPLIT).
template <typename T, bool ROUND, bool SPLIT>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int32_t n_windows, int32_t n_parts, int32_t r,
                      int32_t p, int32_t k, cudaStream_t s) {
  const Shape sh = shape_of(r);
  const size_t smem = smem_bytes(p, sh.slab, SPLIT);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  if (SPLIT && (n_parts < 1 || n_parts > kMaxParts))
    return cudaErrorInvalidValue;
  if (SPLIT && n_parts > kPortableParts) {
    const cudaError_t err = allow_wide_clusters<T, ROUND>();
    if (err != cudaSuccess) return err;
  }
  *cfg = {};
  cfg->gridDim = dim3((unsigned)((int64_t)n_windows * sh.slabs *
                                 (SPLIT ? n_parts : 1)),
                      (unsigned)((k + 31) / 32));
  cfg->blockDim = dim3(sh.groups * L);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT ? n_parts : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = SPLIT ? 1 : 0;
  return cudaSuccess;
}

template <typename T, bool ROUND, bool SPLIT>
cudaError_t launch(int32_t n_windows, int32_t n_parts, const T* x,
                   int32_t ldx, const int32_t* cols, const float* vals,
                   const int32_t* win_off, const int32_t* windows,
                   const int32_t* parts, float* out, int32_t n_out,
                   int32_t r, int32_t p, int32_t k, cudaStream_t s) {
  if (n_windows <= 0) return cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<T, ROUND, SPLIT>(&cfg, attr, n_windows,
                                               n_parts, r, p, k, s);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, ell_spmm_kernel<T, ROUND, SPLIT>, x, ldx,
                            cols, vals, win_off, windows, parts, out, n_out,
                            r, p, k, shape_of(r).slabs, n_parts);
}

// The stream the heavy-window launch forks onto (the highest priority,
// so that the long walks start first) and the events of the fork and the
// join, made once per device; kernel K2 (panel_spmm.cu) keeps its own.
// One SpMM at a time uses them: `mu` is held from the fork's record to the
// join's wait, so another host thread cannot re-record `fork` before the
// side stream has waited on it. Under a CUDA graph capture the record and
// the wait fork the side stream into the capture and join it back, so the
// graph holds both launches; the stream and the events are made by a call
// before any capture (a captured fit's eager warm-up, train/capture.py).
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

template <typename T, bool ROUND>
cudaError_t spmm(const T* x, int32_t ldx, const int32_t* cols,
                 const float* vals, const int32_t* win_off,
                 const int32_t* heavy, const int32_t* heavy_parts,
                 int32_t n_heavy, int32_t n_parts, const int32_t* light,
                 int32_t n_light, float* out, int32_t n_out, int32_t r,
                 int32_t p, int32_t k, cudaStream_t s) {
  // the heavy windows run on a side stream forked from `s`, beside the
  // light ones (their rows are disjoint); `s` then waits for them. The
  // side stream is unknown to PyTorch's allocator: every buffer it touches
  // was allocated on `s` before the fork, and `s` waits for the join
  // before any later use or reuse of them.
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
    if (err != cudaSuccess) return err;
    hs = side->stream;
  }
  err = launch<T, ROUND, true>(n_heavy, n_parts, x, ldx, cols, vals, win_off,
                               heavy, heavy_parts, out, n_out, r, p, k, hs);
  if (err == cudaSuccess && fork) err = cudaEventRecord(side->join, hs);
  if (err == cudaSuccess)
    err = launch<T, ROUND, false>(n_light, 1, x, ldx, cols, vals, win_off,
                                  light, nullptr, out, n_out, r, p, k, s);
  if (err == cudaSuccess && fork) err = cudaStreamWaitEvent(s, side->join);
  return err;
}

}  // namespace

// One SpMM, as up to two launches ordered on `stream`: the n_heavy
// windows of `heavy` (int32), each split by `heavy_parts` (int32 (n_heavy,
// n_parts + 1), pass-block offsets from the window's first block) across a
// cluster of n_parts (1..16) blocks, on a side stream forked from
// `stream`, and beside it the n_light windows of `light` (int32), walked
// whole; work queued on `stream` afterwards waits for both. Every window
// of [0, ceil(n_out / r)) must be in one of the two lists.
// x: (n_cols, k) rows of stride ldx (a multiple of 4, base aligned to one
// 4-element vector; columns k..ldx-1 may be read and dropped), f32, or
// bf16 when x_bf16 is set; cols/vals: (num_blocks, p, r), 16-byte aligned,
// r a multiple of 4; win_off: int32 (num_windows + 1); out: f32 (n_out,
// k), 16-byte aligned, n_out <= num_windows * r. products_bf16 rounds each
// pass-block's sum to bf16. Returns the first launch error, or
// cudaErrorInvalidValue for operands it cannot take.
extern "C" int gcn_ell_spmm(const void* x, int32_t ldx, const int32_t* cols,
                            const float* vals, const int32_t* win_off,
                            const int32_t* heavy, const int32_t* heavy_parts,
                            int32_t n_heavy, int32_t n_parts,
                            const int32_t* light, int32_t n_light,
                            float* out, int32_t n_out, int32_t r, int32_t p,
                            int32_t k, int32_t x_bf16, int32_t products_bf16,
                            void* stream) {
  if (n_out <= 0 || k <= 0) return (int)cudaGetLastError();
  if (r % RPT != 0 || p <= 0 || (p & (p - 1)) != 0 || ldx % V != 0 ||
      ldx < k || reinterpret_cast<uintptr_t>(cols) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % (V * (x_bf16 ? 2 : 4)) != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (n_heavy > 0 && (n_parts < 1 || n_parts > kMaxParts)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  cudaError_t err;
  if (x_bf16 && products_bf16)
    err = spmm<__nv_bfloat16, true>(xb, ldx, cols, vals, win_off, heavy,
                                    heavy_parts, n_heavy, n_parts, light,
                                    n_light, out, n_out, r, p, k, s);
  else if (x_bf16)
    err = spmm<__nv_bfloat16, false>(xb, ldx, cols, vals, win_off, heavy,
                                     heavy_parts, n_heavy, n_parts, light,
                                     n_light, out, n_out, r, p, k, s);
  else if (products_bf16)
    err = spmm<float, true>(xf, ldx, cols, vals, win_off, heavy, heavy_parts,
                            n_heavy, n_parts, light, n_light, out, n_out, r,
                            p, k, s);
  else
    err = spmm<float, false>(xf, ldx, cols, vals, win_off, heavy,
                             heavy_parts, n_heavy, n_parts, light, n_light,
                             out, n_out, r, p, k, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of n_parts blocks of the heavy-window kernel (f32) can
// be resident on the current device at once, for rows of r and pass-blocks
// of p slots (cudaOccupancyMaxActiveClusters); 0 when none can, or minus
// the CUDA error.
extern "C" int gcn_ell_max_clusters(int32_t n_parts, int32_t r, int32_t p) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<float, false, true>(&cfg, attr, 1, n_parts, r,
                                                  p, 32, nullptr);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &clusters, ell_spmm_kernel<float, false, true>, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}
