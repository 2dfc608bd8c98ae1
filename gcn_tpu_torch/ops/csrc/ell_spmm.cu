// K1: packed-stride ELL SpMM for Hopper (sm_90a), out = A @ x.
//
// Replaces, in one launch, the TPU path of gcn_tpu/ops/ell_spmm.py:
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
// latencies, and only many gathers in flight hide them.
//
// Design. A thread block of 128 threads owns a slab of up to 64 rows of
// one window and one 32-column tile of x (grid.y walks the column tiles,
// so k > 32 needs no loop in the kernel). A row group of 8 lanes covers
// the tile, 4 columns a lane: one 16-byte load of f32 x, one 8-byte load
// of bf16 x. A group owns 4 rows of the slab (i, i + G, i + 2G, i + 3G
// for G groups); at up to 128 registers a thread, four blocks share an
// SM.
//   * Metadata on chip. The window's pass-blocks are one contiguous range
//     of cols and of vals; the block brings each pass-block's slab (P x
//     rows ints and floats) into shared memory with cp.async, in a ring
//     of kStages, so the next pass-blocks' metadata arrives while the
//     current one is summed, and a gather's col comes from shared memory.
//   * Many gathers in flight. For each pass-block a thread issues the
//     gathers of JB slots for all its rows (16 independent vector loads
//     at P = 4) before it multiplies any of them: 8,192 16-byte gathers
//     in flight on an SM.
//   * One loop for the three variants (f32; table_bf16, x as bf16;
//     products_bf16): a loop over the window's pass-blocks with the P
//     slots inside. The pass-block's sum is taken in f32 and added into
//     the f32 window sum; under ROUND (products_bf16, gcn_tpu's
//     _gather_stride_sum output in bf16) it is rounded to bf16 first.
//   * Each output element is written once, by the thread that summed it:
//     no atomics, a fixed order of summation, a deterministic result.
//     Index arithmetic inside a window is 32-bit.
// The x rows must start on vector boundaries: the caller passes a row
// stride ldx that is a multiple of 4 and an aligned base (ops/_align.py
// copies any other x into zero-padded rows); R must be a multiple of 4 and
// cols/vals 16-byte aligned, for the 16-byte copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V = 4;             // columns a lane: one vector load
constexpr int L = 32 / V;        // lanes a row group: one 32-column tile
constexpr int RPT = 4;           // rows a group
constexpr int JB = 4;            // slots whose gathers are issued together
constexpr int kMaxGroups = 16;   // groups a block: 128 threads, 64 rows
constexpr int kStages = 3;       // pass-blocks of metadata in the ring

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

template <typename T, bool ROUND>
__global__ void __launch_bounds__(kMaxGroups * L, 2)
    ell_spmm_kernel(const T* __restrict__ x, int32_t ldx,
                    const int32_t* __restrict__ cols,
                    const float* __restrict__ vals,
                    const int32_t* __restrict__ win_off,
                    float* __restrict__ out, int32_t n_out, int32_t r,
                    int32_t p, int32_t k, int32_t slabs) {
  extern __shared__ int4 smem[];
  const int groups = blockDim.x / L;
  const int32_t slab = groups * RPT;   // rows a block can hold
  int32_t* s_cols = reinterpret_cast<int32_t*>(smem);    // [stage][P][slab]
  float* s_vals = reinterpret_cast<float*>(s_cols + kStages * p * slab);
  const int32_t w = blockIdx.x / slabs;
  const int32_t r0 = (blockIdx.x - w * slabs) * slab;
  const int32_t rows = min(slab, r - r0);
  const int g = threadIdx.x / L;
  const int32_t col = blockIdx.y * 32 + (threadIdx.x % L) * V;
  const bool col_ok = col < k;
  const int32_t b0 = __ldg(win_off + w);
  const int32_t nblk = __ldg(win_off + w + 1) - b0;
  const int64_t first = (int64_t)b0 * p * r + r0;
  const int32_t* wc = cols + first;
  const float* wv = vals + first;

  // copy pass-block blk's slab (P rows of `rows` ints and floats) into its
  // stage of the ring, 16 bytes a copy
  const int32_t chunks = rows / 4;
  auto stage = [&](int32_t blk) {
    const int32_t st = blk % kStages;
    for (int32_t c = threadIdx.x; c < p * chunks; c += blockDim.x) {
      const int32_t j = c / chunks;
      const int32_t q = (c - j * chunks) * 4;
      const int32_t src = (blk * p + j) * r + q;
      const int32_t dst = (st * p + j) * slab + q;
      cp_async16(s_cols + dst, wc + src);
      cp_async16(s_vals + dst, wv + src);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nblk) stage(s);
    cp_async_commit();
  }

  float acc[RPT][V];
#pragma unroll
  for (int t = 0; t < RPT; ++t)
#pragma unroll
    for (int u = 0; u < V; ++u) acc[t][u] = 0.0f;

  for (int32_t blk = 0; blk < nblk; ++blk) {
    // pass-block blk has landed, and every thread is done with blk - 1,
    // whose stage the next copy refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (blk + kStages - 1 < nblk) stage(blk + kStages - 1);
    cp_async_commit();
    const int32_t* sc = s_cols + (blk % kStages) * p * slab;
    const float* sv = s_vals + (blk % kStages) * p * slab;
    float part[RPT][V];
#pragma unroll
    for (int t = 0; t < RPT; ++t)
#pragma unroll
      for (int u = 0; u < V; ++u) part[t][u] = 0.0f;
    for (int32_t j0 = 0; j0 < p; j0 += JB) {
      typename Vec<T>::raw xv[JB][RPT];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
#pragma unroll
        for (int t = 0; t < RPT; ++t) {
          const int32_t i = g + groups * t;
          xv[jj][t] = Vec<T>::zero();
          if (j0 + jj < p && i < rows && col_ok) {
            const int32_t c = sc[(j0 + jj) * slab + i];
            xv[jj][t] = Vec<T>::load(x + (int64_t)c * ldx + col);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
#pragma unroll
        for (int t = 0; t < RPT; ++t) {
          const int32_t i = g + groups * t;
          if (j0 + jj < p && i < rows) {
            const float v = sv[(j0 + jj) * slab + i];
            const float4 xf = Vec<T>::widen(xv[jj][t]);
            part[t][0] = fmaf(v, xf.x, part[t][0]);
            part[t][1] = fmaf(v, xf.y, part[t][1]);
            part[t][2] = fmaf(v, xf.z, part[t][2]);
            part[t][3] = fmaf(v, xf.w, part[t][3]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < RPT; ++t) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if constexpr (ROUND) {
          acc[t][u] += __bfloat162float(__float2bfloat16_rn(part[t][u]));
        } else {
          acc[t][u] += part[t][u];
        }
      }
    }
  }

  if (!col_ok) return;
  const int64_t row0 = (int64_t)w * r + r0;
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

template <typename T, bool ROUND>
int launch(const T* x, int32_t ldx, const int32_t* cols, const float* vals,
           const int32_t* win_off, float* out, int32_t n_out, int32_t r,
           int32_t p, int32_t k, cudaStream_t s) {
  const int groups = r / RPT < kMaxGroups ? r / RPT : kMaxGroups;
  const int32_t slab = groups * RPT;
  const int32_t slabs = (r + slab - 1) / slab;
  const int64_t windows = ((int64_t)n_out + r - 1) / r;
  const size_t smem = (size_t)kStages * p * slab * 8;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(windows * slabs), (unsigned)((k + 31) / 32));
  ell_spmm_kernel<T, ROUND><<<grid, groups * L, smem, s>>>(
      x, ldx, cols, vals, win_off, out, n_out, r, p, k, slabs);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_cols, k) rows of stride ldx (a multiple of 4, base aligned to one
// 4-element vector; columns k..ldx-1 may be read and dropped), f32, or
// bf16 when x_bf16 is set; cols/vals: (num_blocks, p, r), 16-byte aligned,
// r a multiple of 4; win_off: int32 (num_windows + 1); out: f32 (n_out,
// k), 16-byte aligned, n_out <= num_windows * r. products_bf16 rounds each
// pass-block's sum to bf16. Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for operands it cannot take.
extern "C" int gcn_ell_spmm(const void* x, int32_t ldx, const int32_t* cols,
                            const float* vals, const int32_t* win_off,
                            float* out, int32_t n_out, int32_t r, int32_t p,
                            int32_t k, int32_t x_bf16, int32_t products_bf16,
                            void* stream) {
  if (n_out <= 0 || k <= 0) return (int)cudaGetLastError();
  if (r % RPT != 0 || p <= 0 || ldx % V != 0 || ldx < k ||
      reinterpret_cast<uintptr_t>(cols) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vals) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % (V * (x_bf16 ? 2 : 4)) != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (x_bf16 && products_bf16)
    return launch<__nv_bfloat16, true>(xb, ldx, cols, vals, win_off, out,
                                       n_out, r, p, k, s);
  if (x_bf16)
    return launch<__nv_bfloat16, false>(xb, ldx, cols, vals, win_off, out,
                                        n_out, r, p, k, s);
  if (products_bf16)
    return launch<float, true>(xf, ldx, cols, vals, win_off, out, n_out, r,
                               p, k, s);
  return launch<float, false>(xf, ldx, cols, vals, win_off, out, n_out, r, p,
                              k, s);
}
