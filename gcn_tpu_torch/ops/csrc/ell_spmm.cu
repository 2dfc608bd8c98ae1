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
//   out[w*R + i, c] = sum_{s in window w} vals[s*R+i] * x[cols[s*R+i], c]
//
// Design. A group of L lanes (L = 32 for k >= 32, the next power of two
// of k below that) owns one output row; lane l holds the columns
// c0 + l + t*L (t < CPT) of a column tile of width L*CPT, so the group
// reads each gathered x row as one contiguous run (128 B at k = 32). The
// group walks its window's slots in order, reading each slot's col/val
// once (one broadcast load for the group) and accumulating in registers;
// each output element is written exactly once, with no atomics, so the
// result is deterministic. Windows need no ordering between thread blocks:
// the TPU's sequential revisit grid becomes the loop over win_off.
//
// Bound on the H100 at the main path's shape (synth-arxiv, k = 32): the
// compulsory bytes are cols + vals (8 B a slot), x read once and out
// written once, ~66 MB, i.e. ~20 us at 3.35 TB/s; the 2.2M gathered x rows
// come mostly from the 50 MB L2, which holds x. The work is ~2 flop per
// edge and column, far below the f32 peak, so bytes bound it; in practice
// the dependent col -> x load chain (latency) paces this simple version.
//
// The bf16 options of gcn_tpu's _spmm_ell_impl (ell_spmm.py:184-190) are
// template parameters:
//   * table_bf16: x arrives as bf16 (the wrapper casts it once per call),
//     so every gathered row moves half the bytes; each element is widened
//     with __bfloat162float and multiplied and summed in f32;
//   * products_bf16: the sum over one pass-block's P slots (the TPU path's
//     _gather_stride_sum output) is rounded to bf16 (__float2bfloat16_rn)
//     and added into a separate f32 window accumulator.
// The f32 variant keeps its flat slot loop, whose time is K1's reference;
// the nested per-block loop of products_bf16 runs faster (PERF.md §7), and
// merging the two loops is the first step of K1's redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

template <int CPT, typename T, bool ROUND>
__global__ void ell_spmm_kernel(const T* __restrict__ x,
                                const int32_t* __restrict__ cols,
                                const float* __restrict__ vals,
                                const int32_t* __restrict__ win_off,
                                float* __restrict__ out, int32_t n_out,
                                int32_t r, int32_t p, int32_t k,
                                int32_t lanes_log2) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = tid >> lanes_log2;
  if (row >= n_out) return;
  const int32_t lanes = 1 << lanes_log2;
  const int32_t lane = (int32_t)(tid & (lanes - 1));
  const int64_t w = row / r;
  const int64_t i = row - w * r;
  const int64_t b0 = win_off[w];
  const int64_t b1 = win_off[w + 1];
  const int32_t tile = lanes * CPT;
  float* out_row = out + row * k;
  for (int32_t c0 = 0; c0 < k; c0 += tile) {
    float acc[CPT];
#pragma unroll
    for (int t = 0; t < CPT; ++t) acc[t] = 0.0f;
    if (!ROUND) {
#pragma unroll 4
      for (int64_t s = b0 * p; s < b1 * p; ++s) {
        const int64_t slot = s * r + i;
        const int32_t c = __ldg(cols + slot);
        const float v = __ldg(vals + slot);
        const T* xr = x + (int64_t)c * k + c0 + lane;
#pragma unroll
        for (int t = 0; t < CPT; ++t) {
          if (c0 + lane + t * lanes < k) {
            acc[t] = fmaf(v, load_f32(xr + t * lanes), acc[t]);
          }
        }
      }
    } else {
      for (int64_t b = b0; b < b1; ++b) {
        float blk[CPT];
#pragma unroll
        for (int t = 0; t < CPT; ++t) blk[t] = 0.0f;
        for (int64_t s = b * p; s < (b + 1) * p; ++s) {
          const int64_t slot = s * r + i;
          const int32_t c = __ldg(cols + slot);
          const float v = __ldg(vals + slot);
          const T* xr = x + (int64_t)c * k + c0 + lane;
#pragma unroll
          for (int t = 0; t < CPT; ++t) {
            if (c0 + lane + t * lanes < k) {
              blk[t] = fmaf(v, load_f32(xr + t * lanes), blk[t]);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < CPT; ++t) {
          acc[t] += __bfloat162float(__float2bfloat16_rn(blk[t]));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < CPT; ++t) {
      const int32_t col = c0 + lane + t * lanes;
      if (col < k) out_row[col] = acc[t];
    }
  }
}

template <typename T, bool ROUND>
void launch(const T* x, const int32_t* cols, const float* vals,
            const int32_t* win_off, float* out, int32_t n_out, int32_t r,
            int32_t p, int32_t k, cudaStream_t s) {
  int32_t lanes_log2 = 0;
  while ((1 << lanes_log2) < k && lanes_log2 < 5) ++lanes_log2;
  const int block = 256;
  const int64_t threads = (int64_t)n_out << lanes_log2;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  if (k <= 32) {
    ell_spmm_kernel<1, T, ROUND><<<grid, block, 0, s>>>(
        x, cols, vals, win_off, out, n_out, r, p, k, lanes_log2);
  } else if (k <= 64) {
    ell_spmm_kernel<2, T, ROUND><<<grid, block, 0, s>>>(
        x, cols, vals, win_off, out, n_out, r, p, k, lanes_log2);
  } else {
    ell_spmm_kernel<4, T, ROUND><<<grid, block, 0, s>>>(
        x, cols, vals, win_off, out, n_out, r, p, k, lanes_log2);
  }
}

}  // namespace

// x: (n_cols, k) row-major, f32, or bf16 when x_bf16 is set; cols/vals:
// (num_blocks, p, r); win_off: int32 (num_windows + 1); out: f32 (n_out, k),
// n_out <= num_windows * r. products_bf16 rounds each pass-block's sum to
// bf16. Launches on `stream`; returns cudaGetLastError().
extern "C" int gcn_ell_spmm(const void* x, const int32_t* cols,
                            const float* vals, const int32_t* win_off,
                            float* out, int32_t n_out, int32_t r, int32_t p,
                            int32_t k, int32_t x_bf16, int32_t products_bf16,
                            void* stream) {
  if (n_out <= 0 || k <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (x_bf16 && products_bf16) {
    launch<__nv_bfloat16, true>(xb, cols, vals, win_off, out, n_out, r, p, k,
                                s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, false>(xb, cols, vals, win_off, out, n_out, r, p, k,
                                 s);
  } else if (products_bf16) {
    launch<float, true>(xf, cols, vals, win_off, out, n_out, r, p, k, s);
  } else {
    launch<float, false>(xf, cols, vals, win_off, out, n_out, r, p, k, s);
  }
  return (int)cudaGetLastError();
}
