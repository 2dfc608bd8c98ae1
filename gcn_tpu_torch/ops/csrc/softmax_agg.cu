// Per-channel softmax aggregation for Hopper (sm_90a): the SoftMax_Agg of
// DeeperGCN's GENConv (Li et al., arXiv:2006.07739, section 3.1), forward
// and the value-only backward of its stop-gradient form.
//
// Replaces no TPU kernel: gcn_tpu has no DeeperGCN and no kernel whose
// softmax logits are the gathered features themselves. It is added because
// the same function in torch ops (ops/softmax_agg.py::_softmax_aggregate_
// plain) writes several E x k float32 arrays to device memory (the gathered
// rows, their exp, the weighted products; 1.19 GB each at ogbn-arxiv's
// 2.33 M edges with self loops and k = 128), where these kernels write
// nothing of that size.
//
// Layout (ops/gat_attn.py::gat_layout, GAT's A + I): per vertex, m holds k
// floats (k a multiple of 4, rows 16-byte aligned). Forward edges are
// sorted by row: row v's run of sources is cols[row_ptr[v] .. row_ptr[v+1]).
// The transpose groups the same edges by source u: t_cols holds each
// edge's destination row v, in row order within a source. order / t_order
// hand the rows out: first the rows of more than 64 edges, longest first,
// the first n_long of them past LONG_ROW (256), then the others in the
// rabbit order of the pattern. The order decides only which group walks a
// row and when, never the order of a row's sums. The walk is gat_attn.cu's
// at one head a row (row_walk.cuh).
//
//   lse[v,c] = log sum_{u in N(v)} exp(t m[u,c])
//   a[v,c]   = sum_{u in N(v)} exp(t m[u,c] - lse[v,c]) m[u,c]
//
// Backward, the weights held constant (GENConv's softmax_sg computes them
// under torch.no_grad(), so the gradient reaches m through the value only):
//   dm[u,c] = sum_{v : u in N(v)} exp(t m[u,c] - lse[v,c]) da[v,c]
// Each weight is recomputed from lse as one exp of a difference that is
// never positive: a factored exp(t m) exp(-lse) would overflow past t m ~ 88.
//
// What bounds it on the H100: every edge gathers one source row (512 B at
// k = 128) forward, and lse and da of its destination (1 KB) backward: 1.19
// and 2.38 GB a pass at ogbn-arxiv's size, served partly by the 50 MB L2
// (m is 87 MB). The compulsory bytes (each operand read once, each result
// written once) take ~0.07 ms a forward. Arithmetic is one exp and a few
// flops a gathered float, below the f32 peak. So the design keeps gathers
// in flight and writes no per-edge value.
//
// Design.
//   * A group of G lanes owns one row: lane l holds float4s l, l + G, ...
//     (V of them) of the row's channels; G is the smallest power of two
//     with G x V float4s covering k (a warp a row at k = 128).
//   * Forward: an online softmax per channel (running max, running sum, the
//     accumulator rescaled, one exp an element: the smaller of the two
//     factors is exp(-|t x - max|) and the other is 1) over the row's edges
//     in edge order, kUnroll edges' gathers in flight. a is written once,
//     and lse (n x k) when the caller keeps it for the backward.
//   * Backward: one walk of the transpose rows u: m[u] is held in
//     registers, each in-edge gathers lse[v] and da[v] and adds the
//     recomputed weight times da[v] in edge order.
//   * Long rows: a thread block takes one row; its groups walk contiguous
//     chunks of the run, and group 0 merges their partial states (max, sum
//     and accumulator; or sums) in chunk order.
//   * No atomics: every sum is taken in a fixed order, so two calls are
//     bit-equal. Nothing is allocated, nothing synchronizes, and every
//     launch runs on the caller's stream, so a CUDA graph can capture it.

#include <cuda_runtime.h>

#include <cstdint>

#include "row_walk.cuh"

namespace {

constexpr int kFwdUnroll = 4;  // edges whose gathers are in flight at once
constexpr int kBwdUnroll = 2;

__device__ __forceinline__ float4 fill4(float v) {
  return make_float4(v, v, v, v);
}

// One channel's online softmax step with logit s = t x and value x: the
// running max mx, sum l and accumulator acc rescaled where s raises the max.
__device__ __forceinline__ void online(float& mx, float& l, float& acc,
                                       float x, float s) {
  const float d = s - mx;
  const bool up = d > 0.f;
  const float e = expf(-fabsf(d));
  const float a = up ? e : 1.f;  // the old terms' factor
  const float p = up ? 1.f : e;  // the new term's weight
  l = l * a + p;
  acc = acc * a + p * x;
  mx = up ? s : mx;
}

__device__ __forceinline__ void online4(float4& mx, float4& l, float4& acc,
                                        const float4& x, float t) {
  online(mx.x, l.x, acc.x, x.x, t * x.x);
  online(mx.y, l.y, acc.y, x.y, t * x.y);
  online(mx.z, l.z, acc.z, x.z, t * x.z);
  online(mx.w, l.w, acc.w, x.w, t * x.w);
}

// merge a chunk's state (m2, l2, acc2) into the running one, in that order
__device__ __forceinline__ void merge(float& mx, float& l, float& acc,
                                      float m2, float l2, float acc2) {
  const float mn = fmaxf(mx, m2);
  const float a = expf(mx - mn), b = expf(m2 - mn);
  l = l * a + l2 * b;
  acc = acc * a + acc2 * b;
  mx = mn;
}

__device__ __forceinline__ void merge4(float4& mx, float4& l, float4& acc,
                                       const float4& m2, const float4& l2,
                                       const float4& acc2) {
  merge(mx.x, l.x, acc.x, m2.x, l2.x, acc2.x);
  merge(mx.y, l.y, acc.y, m2.y, l2.y, acc2.y);
  merge(mx.z, l.z, acc.z, m2.z, l2.z, acc2.z);
  merge(mx.w, l.w, acc.w, m2.w, l2.w, acc2.w);
}

__device__ __forceinline__ float weight(float s, float lse) {
  return expf(s - lse);
}

// acc += exp(s - lse) * g, channel by channel
__device__ __forceinline__ void add_weighted(float4& acc, const float4& s,
                                             const float4& lse,
                                             const float4& g) {
  acc.x += weight(s.x, lse.x) * g.x;
  acc.y += weight(s.y, lse.y) * g.y;
  acc.z += weight(s.z, lse.z) * g.z;
  acc.w += weight(s.w, lse.w) * g.w;
}

__device__ __forceinline__ void add4(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    softmax_agg_fwd(const float4* __restrict__ m,
                    const int64_t* __restrict__ cols,
                    const int64_t* __restrict__ row_ptr,
                    const int64_t* __restrict__ order, int64_t n_long,
                    float4* __restrict__ out, float4* __restrict__ lse,
                    int64_t n, int F4, int G, float t) {
  __shared__ float4 s_m[V * kThreads];
  __shared__ float4 s_l[V * kThreads];
  __shared__ float4 s_acc[V * kThreads];
  Item it;  // H = 1: an item is a row, all its channels
  if (!item_of(order, n_long, n, 1, G, it)) return;
  const int64_t row = it.row;
  const bool whole_block = it.whole_block;
  const int lane = threadIdx.x % G, g = threadIdx.x / G;
  const int groups = kThreads / G;
  int64_t beg = row_ptr[row], end = row_ptr[row + 1];
  if (whole_block) chunk_of(beg, end, g, groups);

  float4 mx[V], l[V], acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mx[v] = fill4(-INFINITY);
    l[v] = zero4();
    acc[v] = zero4();
  }
  for (int64_t e = beg; e < end; e += kFwdUnroll) {
    const int cnt = static_cast<int>(min(static_cast<int64_t>(kFwdUnroll),
                                         end - e));
    int64_t c[kFwdUnroll];
    float4 x[kFwdUnroll][V];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u)
      if (u < cnt) c[u] = __ldg(cols + e + u);
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u)
      if (u < cnt) {
        const float4* src = m + c[u] * F4;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int q = lane + G * v;
          x[u][v] = q < F4 ? __ldg(src + q) : zero4();
        }
      }
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u)
      if (u < cnt) {
#pragma unroll
        for (int v = 0; v < V; ++v) online4(mx[v], l[v], acc[v], x[u][v], t);
      }
  }

  if (whole_block) {
    // merge the groups' partial states in chunk order
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s_m[v * kThreads + threadIdx.x] = mx[v];
      s_l[v * kThreads + threadIdx.x] = l[v];
      s_acc[v * kThreads + threadIdx.x] = acc[v];
    }
    __syncthreads();
    if (g != 0) return;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mx[v] = fill4(-INFINITY);
      l[v] = zero4();
      acc[v] = zero4();
    }
    for (int k = 0; k < groups; ++k) {
      const int at = k * G + lane;
      if (s_l[at].x == 0.f) continue;  // an empty chunk
#pragma unroll
      for (int v = 0; v < V; ++v)
        merge4(mx[v], l[v], acc[v], s_m[v * kThreads + at],
               s_l[v * kThreads + at], s_acc[v * kThreads + at]);
    }
  }
  float4* o = out + row * F4;
  float4* ls = lse == nullptr ? nullptr : lse + row * F4;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int q = lane + G * v;
    if (q >= F4) continue;
    const float4 a = acc[v], s = l[v], mm = mx[v];
    o[q] = make_float4(s.x > 0.f ? a.x / s.x : 0.f,
                       s.y > 0.f ? a.y / s.y : 0.f,
                       s.z > 0.f ? a.z / s.z : 0.f,
                       s.w > 0.f ? a.w / s.w : 0.f);
    if (ls != nullptr)
      ls[q] = make_float4(s.x > 0.f ? mm.x + logf(s.x) : 0.f,
                          s.y > 0.f ? mm.y + logf(s.y) : 0.f,
                          s.z > 0.f ? mm.z + logf(s.z) : 0.f,
                          s.w > 0.f ? mm.w + logf(s.w) : 0.f);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    softmax_agg_bwd(const float4* __restrict__ m,
                    const float4* __restrict__ lse,
                    const float4* __restrict__ da,
                    const int64_t* __restrict__ t_cols,
                    const int64_t* __restrict__ t_row_ptr,
                    const int64_t* __restrict__ t_order, int64_t n_long,
                    float4* __restrict__ dm, int64_t n, int F4, int G,
                    float t) {
  __shared__ float4 s_acc[V * kThreads];
  Item it;
  if (!item_of(t_order, n_long, n, 1, G, it)) return;
  const int64_t u_row = it.row;
  const bool whole_block = it.whole_block;
  const int lane = threadIdx.x % G, g = threadIdx.x / G;
  const int groups = kThreads / G;
  int64_t beg = t_row_ptr[u_row], end = t_row_ptr[u_row + 1];
  if (whole_block) chunk_of(beg, end, g, groups);
  float4 s[V], acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int q = lane + G * v;
    const float4 x = q < F4 ? m[u_row * F4 + q] : zero4();
    s[v] = make_float4(t * x.x, t * x.y, t * x.z, t * x.w);
    acc[v] = zero4();
  }
  for (int64_t e = beg; e < end; e += kBwdUnroll) {
    const int cnt = static_cast<int>(min(static_cast<int64_t>(kBwdUnroll),
                                         end - e));
    int64_t i[kBwdUnroll];
    float4 ls[kBwdUnroll][V], gr[kBwdUnroll][V];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (u < cnt) i[u] = __ldg(t_cols + e + u);
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (u < cnt) {
        const float4* lsrc = lse + i[u] * F4;
        const float4* gsrc = da + i[u] * F4;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int q = lane + G * v;
          ls[u][v] = q < F4 ? __ldg(lsrc + q) : zero4();
          gr[u][v] = q < F4 ? __ldg(gsrc + q) : zero4();
        }
      }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (u < cnt) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          add_weighted(acc[v], s[v], ls[u][v], gr[u][v]);
      }
  }

  if (whole_block) {
#pragma unroll
    for (int v = 0; v < V; ++v) s_acc[v * kThreads + threadIdx.x] = acc[v];
    __syncthreads();
    if (g != 0) return;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = zero4();
    for (int k = 0; k < groups; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        add4(acc[v], s_acc[v * kThreads + k * G + lane]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int q = lane + G * v;
    if (q < F4) dm[u_row * F4 + q] = acc[v];
  }
}

}  // namespace

// out (n x k) and, unless lse is null, lse (n x k): the forward. Returns
// the launch's cudaGetLastError(), or cudaErrorInvalidValue for operands
// it cannot take.
extern "C" int gcn_softmax_agg_fwd(const float* m, const int64_t* cols,
                                   const int64_t* row_ptr,
                                   const int64_t* order, int64_t n_long,
                                   float* out, float* lse, int64_t n,
                                   int32_t k, float t, void* stream) {
  int V, G;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (k % 4 != 0 || !shape_of(k / 4, 1, 2, V, G) || n_long < 0 ||
      n_long > n || !aligned(m) || !aligned(out) ||
      (lse != nullptr && !aligned(lse)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = walk_blocks(n, n_long, 1, G);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m4 = reinterpret_cast<const float4*>(m);
  auto* o4 = reinterpret_cast<float4*>(out);
  auto* l4 = reinterpret_cast<float4*>(lse);
  if (V == 1)
    softmax_agg_fwd<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        m4, cols, row_ptr, order, n_long, o4, l4, n, k / 4, G, t);
  else
    softmax_agg_fwd<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        m4, cols, row_ptr, order, n_long, o4, l4, n, k / 4, G, t);
  return static_cast<int>(cudaGetLastError());
}

// dm (n x k): the transpose walk of the backward, from the forward's lse.
extern "C" int gcn_softmax_agg_bwd(const float* m, const float* lse,
                                   const float* da, const int64_t* t_cols,
                                   const int64_t* t_row_ptr,
                                   const int64_t* t_order, int64_t n_long,
                                   float* dm, int64_t n, int32_t k, float t,
                                   void* stream) {
  int V, G;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (k % 4 != 0 || !shape_of(k / 4, 1, 2, V, G) || n_long < 0 ||
      n_long > n || !aligned(m) || !aligned(lse) || !aligned(da) ||
      !aligned(dm))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = walk_blocks(n, n_long, 1, G);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m4 = reinterpret_cast<const float4*>(m);
  const auto* l4 = reinterpret_cast<const float4*>(lse);
  const auto* g4 = reinterpret_cast<const float4*>(da);
  auto* d4 = reinterpret_cast<float4*>(dm);
  if (V == 1)
    softmax_agg_bwd<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        m4, l4, g4, t_cols, t_row_ptr, t_order, n_long, d4, n, k / 4, G, t);
  else
    softmax_agg_bwd<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        m4, l4, g4, t_cols, t_row_ptr, t_order, n_long, d4, n, k / 4, G, t);
  return static_cast<int>(cudaGetLastError());
}
