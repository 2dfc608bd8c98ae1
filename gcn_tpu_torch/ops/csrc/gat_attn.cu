// Multi-head edge-softmax attention for Hopper (sm_90a): the aggregation of
// a GAT layer (Velickovic et al., arXiv:1710.10903, section 2.1), forward
// and backward.
//
// Replaces no TPU kernel: gcn_tpu has no GAT and no kernel that computes a
// softmax over a row's edges. It is added because the same function in
// torch ops (ops/gat_attn.py::_gat_attention_plain) writes several E x H x F
// float32 arrays to device memory (the gathered rows, the weighted
// products, and again in the backward): 9.5 GB each at ogbn-arxiv's 2.33 M
// edges with self loops and 4 heads of 256, where these kernels write
// nothing of that size.
//
// Layout (ops/gat_attn.py::gat_layout): per vertex, wh holds H heads of
// `width` floats (width a multiple of 4, rows 16-byte aligned), el and er
// H floats. Forward edges are sorted by row: row i's run of sources is
// cols[row_ptr[i] .. row_ptr[i+1]). The transpose groups the same edges by
// source j: t_cols holds each edge's destination row i, t_edge its
// position in the forward arrays. order / t_order hand the rows out: first
// the rows of more than 64 edges, longest first, the first n_long of them
// past LONG_ROW (256), then the others in the rabbit order of the
// pattern, each run of 1,024 rows longest first, so that a community's
// rows, which gather the same source rows, run together while those rows
// are in L2, and a warp's groups walk rows of near equal length. The
// order decides only which group walks a row and when, never the order
// of a row's sums. No padding edge lies in any run. The walk's helpers
// (item_of, chunk_of, shape_of, walk_blocks) are row_walk.cuh's.
//
//   s_ij = er[i,h] + el[j,h];  e_ij = LeakyReLU(s_ij)
//   lse_i = log sum_j exp(e_ij);  alpha_ij = exp(e_ij - lse_i)
//   out[i,h] = sum_j alpha_ij wh[j,h]
//
// Backward, with D[i,h] = dout[i,h] . out[i,h]:
//   dwh[j,h] = sum_i alpha_ij dout[i,h]                    (transpose walk)
//   ds_ij    = alpha_ij (dout[i,h] . wh[j,h] - D[i,h]) LeakyReLU'(s_ij)
//   d_el[j,h] = sum_i ds_ij  (transpose walk);  d_er[i,h] = sum_j ds_ij
//
// What bounds it on the H100: every edge gathers one source row of a head
// (1 KB at width 256); an iteration's compulsory bytes (each operand read
// once, each result written once) take ~0.4 ms a 1,024-wide pass, but the
// gathers move ~9.5 GB a pass, served partly by the 50 MB L2 (the 694 MB
// wh does not fit). Arithmetic is ~2 flops a gathered float, far below the
// f32 peak. So the design keeps gathers in flight and writes no per-edge
// row.
//
// Design.
//   * A group of G lanes owns one (row, head): lane l holds float4s
//     l, l + G, ... (V of them) of the head's row; G is the smallest power
//     of two with G x V float4s covering the width (V = 2 up to width 256,
//     V = 8 up to 1,024): a warp a head at width 256, 8 lanes at 40.
//     Consecutive groups take consecutive heads of a row, so they share
//     the row's column loads.
//   * Forward: an online softmax (running max, running sum, the
//     accumulator rescaled) over the row's edges in edge order, kUnroll
//     edges' gathers in flight at once; every lane keeps the same scalar
//     state, so no shuffle is needed. out is written once, with the row's
//     logsumexp lse (n x H), which the backward reads to recompute alpha.
//   * Backward: one walk of the transpose rows j: wh[j,h] is held in
//     registers, each in-edge gathers dout[i,h], recomputes alpha_ij from
//     el, er and lse, reduces dout . wh across the group's lanes (xor
//     shuffles, the same bits in every lane), and adds alpha dout and ds
//     in edge order; ds is stored at the edge's forward position (E x H
//     floats), and a row pass sums it into d_er in forward edge order. D
//     comes from the same row pass before the walk.
//   * Long rows: a thread block takes one (row, head); its groups walk
//     contiguous chunks of the run, and group 0 merges their partial
//     states (max, sum and accumulator; or sums) in chunk order.
//   * No atomics: every sum is taken in a fixed order, so two calls are
//     bit-equal. Nothing is allocated, nothing synchronizes, and every
//     launch runs on the caller's stream, so a CUDA graph can capture it.

#include <cuda_runtime.h>

#include <cstdint>

#include "row_walk.cuh"

namespace {

constexpr int kUnroll = 2;     // edges whose gathers are in flight at once

__device__ __forceinline__ float leaky(float s, float slope) {
  return s > 0.f ? s : s * slope;
}

// acc = acc * a + b * x
__device__ __forceinline__ void rescale_add(float4& acc, float a, float b,
                                            const float4& x) {
  acc.x = acc.x * a + b * x.x;
  acc.y = acc.y * a + b * x.y;
  acc.z = acc.z * a + b * x.z;
  acc.w = acc.w * a + b * x.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// the sum over the G lanes of a group, the same bits in each of them
__device__ __forceinline__ float group_sum(float v, int G) {
  const int wl = threadIdx.x % kWarp;
  const unsigned mask =
      G == kWarp ? 0xffffffffu : ((1u << G) - 1u) << (wl & ~(G - 1));
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off, G);
  return v;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    gat_attn_fwd(const float4* __restrict__ wh, const float* __restrict__ el,
                 const float* __restrict__ er,
                 const int64_t* __restrict__ cols,
                 const int64_t* __restrict__ row_ptr,
                 const int64_t* __restrict__ order, int64_t n_long,
                 float4* __restrict__ out, float* __restrict__ lse, int64_t n,
                 int H, int F4, int G, float slope) {
  __shared__ float4 s_acc[V * kThreads];
  __shared__ float s_m[kThreads];
  __shared__ float s_l[kThreads];
  Item it;
  if (!item_of(order, n_long, n, H, G, it)) return;
  const int lane = threadIdx.x % G, g = threadIdx.x / G;
  const int groups = kThreads / G;
  const int h = it.head;
  const int64_t stride = static_cast<int64_t>(H) * F4;  // float4s a vertex
  int64_t beg = row_ptr[it.row], end = row_ptr[it.row + 1];
  if (it.whole_block) chunk_of(beg, end, g, groups);
  const float er_i = er[it.row * H + h];

  float m = -INFINITY, l = 0.f;
  float4 acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = zero4();
  for (int64_t e = beg; e < end; e += kUnroll) {
    const int cnt = static_cast<int>(min(static_cast<int64_t>(kUnroll),
                                         end - e));
    int64_t c[kUnroll];
    float sc[kUnroll];
    float4 x[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < cnt) c[u] = __ldg(cols + e + u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < cnt) {
        sc[u] = __ldg(el + c[u] * H + h);
        const float4* src = wh + c[u] * stride + static_cast<int64_t>(h) * F4;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int q = lane + G * v;
          x[u][v] = q < F4 ? __ldg(src + q) : zero4();
        }
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < cnt) {
        const float s = leaky(er_i + sc[u], slope);
        const float mn = fmaxf(m, s);
        const float a = expf(m - mn), p = expf(s - mn);
        l = l * a + p;
#pragma unroll
        for (int v = 0; v < V; ++v) rescale_add(acc[v], a, p, x[u][v]);
        m = mn;
      }
  }

  if (it.whole_block) {
    // merge the groups' partial states in chunk order
#pragma unroll
    for (int v = 0; v < V; ++v) s_acc[v * kThreads + threadIdx.x] = acc[v];
    if (lane == 0) {
      s_m[g] = m;
      s_l[g] = l;
    }
    __syncthreads();
    if (g != 0) return;
    m = -INFINITY;
    for (int k = 0; k < groups; ++k) m = fmaxf(m, s_m[k]);
    l = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = zero4();
    for (int k = 0; k < groups; ++k) {
      if (s_l[k] == 0.f) continue;  // an empty chunk
      const float a = expf(s_m[k] - m);
      l += a * s_l[k];
#pragma unroll
      for (int v = 0; v < V; ++v)
        rescale_add(acc[v], 1.f, a, s_acc[v * kThreads + k * G + lane]);
    }
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float4* o = out + (it.row * H + h) * static_cast<int64_t>(F4);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int q = lane + G * v;
    if (q < F4)
      o[q] = make_float4(acc[v].x * inv, acc[v].y * inv, acc[v].z * inv,
                         acc[v].w * inv);
  }
  if (lane == 0) lse[it.row * H + h] = l > 0.f ? m + logf(l) : 0.f;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    gat_attn_bwd(const float4* __restrict__ wh, const float* __restrict__ el,
                 const float* __restrict__ er, const float* __restrict__ lse,
                 const float4* __restrict__ dout, const float* __restrict__ d,
                 const int64_t* __restrict__ t_cols,
                 const int64_t* __restrict__ t_edge,
                 const int64_t* __restrict__ t_row_ptr,
                 const int64_t* __restrict__ t_order, int64_t n_long,
                 float4* __restrict__ dwh, float* __restrict__ d_el,
                 float* __restrict__ ds, int64_t n, int H, int F4, int G,
                 float slope) {
  __shared__ float4 s_acc[V * kThreads];
  __shared__ float s_l[kThreads];
  Item it;
  if (!item_of(t_order, n_long, n, H, G, it)) return;
  const int lane = threadIdx.x % G, g = threadIdx.x / G;
  const int groups = kThreads / G;
  const int h = it.head;
  const int64_t j = it.row;
  const int64_t self = (j * H + h) * static_cast<int64_t>(F4);
  int64_t beg = t_row_ptr[j], end = t_row_ptr[j + 1];
  if (it.whole_block) chunk_of(beg, end, g, groups);
  const float el_j = el[j * H + h];
  float4 w[V], acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int q = lane + G * v;
    w[v] = q < F4 ? wh[self + q] : zero4();
    acc[v] = zero4();
  }
  float dl = 0.f;
  for (int64_t e = beg; e < end; e += kUnroll) {
    const int cnt = static_cast<int>(min(static_cast<int64_t>(kUnroll),
                                         end - e));
    int64_t i[kUnroll], f[kUnroll];
    float sc[kUnroll], ls[kUnroll], di[kUnroll];
    float4 gr[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < cnt) {
        i[u] = __ldg(t_cols + e + u);
        f[u] = __ldg(t_edge + e + u);
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < cnt) {
        const int64_t ih = i[u] * H + h;
        sc[u] = __ldg(er + ih);
        ls[u] = __ldg(lse + ih);
        di[u] = __ldg(d + ih);
        const float4* src = dout + ih * F4;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int q = lane + G * v;
          gr[u][v] = q < F4 ? __ldg(src + q) : zero4();
        }
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < cnt) {
        const float s = sc[u] + el_j;
        const float alpha = expf(leaky(s, slope) - ls[u]);
        float part = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) part += dot4(gr[u][v], w[v]);
        const float de = alpha * (group_sum(part, G) - di[u]);
        const float dsv = s > 0.f ? de : de * slope;
#pragma unroll
        for (int v = 0; v < V; ++v) rescale_add(acc[v], 1.f, alpha, gr[u][v]);
        dl += dsv;
        if (lane == 0) ds[f[u] * H + h] = dsv;
      }
  }

  if (it.whole_block) {
#pragma unroll
    for (int v = 0; v < V; ++v) s_acc[v * kThreads + threadIdx.x] = acc[v];
    if (lane == 0) s_l[g] = dl;
    __syncthreads();
    if (g != 0) return;
    dl = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = zero4();
    for (int k = 0; k < groups; ++k) {
      dl += s_l[k];
#pragma unroll
      for (int v = 0; v < V; ++v)
        rescale_add(acc[v], 1.f, 1.f, s_acc[v * kThreads + k * G + lane]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int q = lane + G * v;
    if (q < F4) dwh[self + q] = acc[v];
  }
  if (lane == 0) d_el[j * H + h] = dl;
}

// Two row passes under one kernel: mode 0, out[i,h] = a[i,h] . b[i,h] (a
// group of G lanes an item); mode 1, out[i,h] = the sum of a[e,h] over row
// i's run of edges [row_ptr[i], row_ptr[i+1]), in edge order (a thread an
// item).
template <int V>
__global__ void __launch_bounds__(kThreads)
    gat_attn_rows(const float* __restrict__ a, const float* __restrict__ b,
                  const int64_t* __restrict__ row_ptr,
                  float* __restrict__ out, int64_t n, int H, int F4, int G,
                  int mode) {
  if (mode == 1) {
    const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
    if (k >= n * H) return;
    const int64_t i = k / H;
    const int h = static_cast<int>(k % H);
    float sum = 0.f;
    for (int64_t e = row_ptr[i]; e < row_ptr[i + 1]; ++e)
      sum += a[e * H + h];
    out[k] = sum;
    return;
  }
  const int64_t k = static_cast<int64_t>(blockIdx.x) * (kThreads / G) +
                    threadIdx.x / G;
  if (k >= n * H) return;
  const int lane = threadIdx.x % G;
  const float4* a4 = reinterpret_cast<const float4*>(a) + k * F4;
  const float4* b4 = reinterpret_cast<const float4*>(b) + k * F4;
  float part = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int q = lane + G * v;
    if (q < F4) part += dot4(__ldg(a4 + q), __ldg(b4 + q));
  }
  part = group_sum(part, G);
  if (lane == 0) out[k] = part;
}

}  // namespace

// out (n x H x width) and lse (n x H): the forward. Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for operands it cannot take.
extern "C" int gcn_gat_attn_fwd(const float* wh, const float* el,
                                const float* er, const int64_t* cols,
                                const int64_t* row_ptr, const int64_t* order,
                                int64_t n_long, float* out, float* lse,
                                int64_t n, int32_t H, int32_t width,
                                float slope, void* stream) {
  int V, G;
  if (n <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (width % 4 != 0 || !shape_of(width / 4, 2, 8, V, G) || n_long < 0 ||
      n_long > n || !aligned(wh) || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = walk_blocks(n, n_long, H, G);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w4 = reinterpret_cast<const float4*>(wh);
  auto* o4 = reinterpret_cast<float4*>(out);
  if (V == 2)
    gat_attn_fwd<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        w4, el, er, cols, row_ptr, order, n_long, o4, lse, n, H, width / 4, G,
        slope);
  else
    gat_attn_fwd<8><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        w4, el, er, cols, row_ptr, order, n_long, o4, lse, n, H, width / 4, G,
        slope);
  return static_cast<int>(cudaGetLastError());
}

// dwh (n x H x width), d_el (n x H) and ds (E x H, at forward positions):
// the transpose walk of the backward, after gcn_gat_attn_rows' mode 0 has
// made d.
extern "C" int gcn_gat_attn_bwd(const float* wh, const float* el,
                                const float* er, const float* lse,
                                const float* dout, const float* d,
                                const int64_t* t_cols, const int64_t* t_edge,
                                const int64_t* t_row_ptr,
                                const int64_t* t_order, int64_t n_long,
                                float* dwh, float* d_el, float* ds, int64_t n,
                                int32_t H, int32_t width, float slope,
                                void* stream) {
  int V, G;
  if (n <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (width % 4 != 0 || !shape_of(width / 4, 2, 8, V, G) || n_long < 0 ||
      n_long > n || !aligned(wh) || !aligned(dout) || !aligned(dwh))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = walk_blocks(n, n_long, H, G);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w4 = reinterpret_cast<const float4*>(wh);
  const auto* g4 = reinterpret_cast<const float4*>(dout);
  auto* dw4 = reinterpret_cast<float4*>(dwh);
  if (V == 2)
    gat_attn_bwd<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        w4, el, er, lse, g4, d, t_cols, t_edge, t_row_ptr, t_order, n_long,
        dw4, d_el, ds, n, H, width / 4, G, slope);
  else
    gat_attn_bwd<8><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        w4, el, er, lse, g4, d, t_cols, t_edge, t_row_ptr, t_order, n_long,
        dw4, d_el, ds, n, H, width / 4, G, slope);
  return static_cast<int>(cudaGetLastError());
}

// mode 0: out[i,h] = a[i,h] . b[i,h] over width floats (a, b n x H x
// width); mode 1: out[i,h] = the sum of a[e,h] (a E x H) over row i's run
// of row_ptr, in edge order.
extern "C" int gcn_gat_attn_rows(const float* a, const float* b,
                                 const int64_t* row_ptr, float* out,
                                 int64_t n, int32_t H, int32_t width,
                                 int32_t mode, void* stream) {
  int V, G;
  if (n <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (width % 4 != 0 || !shape_of(width / 4, 2, 8, V, G) ||
      (mode != 0 && mode != 1) || (mode == 0 && (!aligned(a) || !aligned(b))) ||
      (mode == 1 && row_ptr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = mode == 1 ? kThreads : kThreads / G;
  const int64_t blocks = (n * H + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (V == 2)
    gat_attn_rows<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, b, row_ptr, out, n, H, width / 4, G, mode);
  else
    gat_attn_rows<8><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, b, row_ptr, out, n, H, width / 4, G, mode);
  return static_cast<int>(cudaGetLastError());
}
