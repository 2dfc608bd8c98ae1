// The row walk that the edge-softmax kernels share (gat_attn.cu,
// softmax_agg.cu): how the rows of a GatLayout (ops/gat_attn.py::
// gat_layout) are handed out to thread blocks and lane groups.
//
// order lists the rows in walk order, the n_long rows past LONG_ROW first.
// An item is one (row, head) of H heads a row. Blocks [0, n_long * H) take
// one long item each, whole: the block's groups walk contiguous chunks of
// the row's run (chunk_of) and merge them in chunk order. The other blocks
// hold kThreads / G groups of G lanes, a short item each, in walk order.
// A lane holds V float4s of the item's width; shape_of picks V and G.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarp = 32;

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Which (row, head) a group owns; false for a group past the last item.
struct Item {
  int64_t row;
  int head;
  bool whole_block;
};

__device__ __forceinline__ bool item_of(const int64_t* order, int64_t n_long,
                                        int64_t n, int H, int G, Item& it) {
  const int64_t b = blockIdx.x;
  if (b < n_long * H) {
    it.row = order[b / H];
    it.head = static_cast<int>(b % H);
    it.whole_block = true;
    return true;
  }
  const int64_t k = n_long * H + (b - n_long * H) * (kThreads / G) +
                    threadIdx.x / G;
  if (k >= n * H) return false;
  it.row = order[k / H];
  it.head = static_cast<int>(k % H);
  it.whole_block = false;
  return true;
}

// the part of [beg, end) that group g of `groups` walks: contiguous chunks
__device__ __forceinline__ void chunk_of(int64_t& beg, int64_t& end, int g,
                                         int groups) {
  const int64_t len = end - beg;
  const int64_t c = (len + groups - 1) / groups;
  const int64_t b = beg + min(len, c * g);
  end = beg + min(len, c * (g + 1));
  beg = b;
}

// float4s a lane (V) and lanes a group (G) for F4 float4s an item: V is
// v_lo up to v_lo warps' float4s, v_hi beyond, and G the smallest power of
// two with G x V covering F4; false past v_hi x kWarp float4s
bool shape_of(int F4, int v_lo, int v_hi, int& V, int& G) {
  if (F4 <= 0 || F4 > v_hi * kWarp) return false;
  V = F4 <= v_lo * kWarp ? v_lo : v_hi;
  G = 1;
  while (G * V < F4) G *= 2;
  return true;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int64_t walk_blocks(int64_t n, int64_t n_long, int H, int G) {
  const int64_t per_block = kThreads / G;
  return n_long * H + ((n - n_long) * H + per_block - 1) / per_block;
}

}  // namespace
