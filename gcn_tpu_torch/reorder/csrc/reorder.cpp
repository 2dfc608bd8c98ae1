// Native vertex-reordering library for gcn_tpu.
//
// Fresh C++ implementations of the reordering passes whose objectives the
// reference implements for CUDA hosts (renumber.cu / order_*.cu /
// unitheap.cu — see SURVEY.md §2a): degree sort, DFS, BFS/RCM, Gorder
// (sliding-window locality greedy with a lazy bucket priority queue), and
// Rabbit-style greedy modularity community clustering.
//
// Contract (mirrors the reference's extern "C" CSR-pointer interface,
// renumber.cu:23, but computes the permutation only — applying it is
// vectorized numpy on the Python side):
//
//   int gcn_reorder(const char* method,
//                   const int32_t* indptr,  // [n+1]
//                   const int32_t* indices, // [nnz]
//                   const float*   data,    // [nnz] (weights; may be null)
//                   int32_t n, int64_t nnz,
//                   int32_t* perm_out)      // [n], perm[new] = old
//
// Returns 0 on success, nonzero on error. Thread-free, allocation-checked.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <numeric>
#include <queue>
#include <string>
#include <vector>

namespace {

using std::int32_t;
using std::int64_t;

struct Csr {
  const int32_t* indptr;
  const int32_t* indices;
  const float* data;
  int32_t n;
  int64_t nnz;

  int32_t deg(int32_t u) const { return indptr[u + 1] - indptr[u]; }
};

// ---------------------------------------------------------------- degree --

void order_degree(const Csr& g, int32_t* perm) {
  // counting sort by degree ascending, stable in vertex id
  int32_t maxd = 0;
  for (int32_t u = 0; u < g.n; ++u) maxd = std::max(maxd, g.deg(u));
  std::vector<int64_t> start(maxd + 2, 0);
  for (int32_t u = 0; u < g.n; ++u) start[g.deg(u) + 1]++;
  for (int32_t d = 0; d <= maxd; ++d) start[d + 1] += start[d];
  for (int32_t u = 0; u < g.n; ++u) perm[start[g.deg(u)]++] = u;
}

// ------------------------------------------------------------------- dfs --

void order_dfs(const Csr& g, int32_t* perm) {
  std::vector<char> visited(g.n, 0);
  std::vector<int32_t> stack;
  int64_t pos = 0;
  for (int32_t s = 0; s < g.n; ++s) {
    if (visited[s]) continue;
    visited[s] = 1;
    stack.push_back(s);
    while (!stack.empty()) {
      int32_t u = stack.back();
      stack.pop_back();
      perm[pos++] = u;
      // push in reverse so the smallest column is visited first
      for (int64_t e = g.indptr[u + 1] - 1; e >= g.indptr[u]; --e) {
        int32_t v = g.indices[e];
        if (!visited[v]) {
          visited[v] = 1;
          stack.push_back(v);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- rcm --

void order_rcm(const Csr& g, int32_t* perm) {
  // Cuthill-McKee: BFS from a minimum-degree vertex per component, visiting
  // neighbors in ascending-degree order; final order reversed.
  std::vector<char> visited(g.n, 0);
  std::vector<int32_t> order;
  order.reserve(g.n);
  std::vector<int32_t> by_deg(g.n);
  order_degree(g, by_deg.data());  // component seeds in ascending degree
  std::vector<int32_t> nbrs;
  std::deque<int32_t> q;
  for (int32_t seed : by_deg) {
    if (visited[seed]) continue;
    visited[seed] = 1;
    q.push_back(seed);
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop_front();
      order.push_back(u);
      nbrs.clear();
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        int32_t v = g.indices[e];
        if (!visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(), [&](int32_t a, int32_t b) {
        int32_t da = g.deg(a), db = g.deg(b);
        return da != db ? da < db : a < b;
      });
      for (int32_t v : nbrs) q.push_back(v);
    }
  }
  for (int32_t i = 0; i < g.n; ++i) perm[i] = order[g.n - 1 - i];
}

// ---------------------------------------------------------------- gorder --

// Lazy bucket priority queue: buckets[p] holds candidate vertices whose last
// recorded priority was p; stale entries are skipped on pop. This plays the
// role of the reference's UnitHeap (unitheap.cu) with simpler invariants.
struct BucketQueue {
  std::vector<std::vector<int32_t>> buckets;
  std::vector<int64_t> prio;   // current priority per vertex
  std::vector<char> placed;
  int64_t top = 0;

  explicit BucketQueue(int32_t n) : buckets(8), prio(n, 0), placed(n, 0) {}

  void ensure(int64_t p) {
    if (p >= static_cast<int64_t>(buckets.size()))
      buckets.resize(static_cast<size_t>(p) + 1);
  }

  void push(int32_t v) {
    ensure(prio[v]);
    buckets[prio[v]].push_back(v);
    top = std::max(top, prio[v]);
  }

  void bump(int32_t v, int64_t delta) {
    prio[v] += delta;
    if (delta > 0 && !placed[v]) push(v);
    // negative deltas leave a stale entry; pop() skips it
  }

  int32_t pop() {
    while (true) {
      while (top > 0 && buckets[top].empty()) --top;
      auto& b = buckets[top];
      while (!b.empty()) {
        int32_t v = b.back();
        b.pop_back();
        if (!placed[v] && prio[v] == top) return v;
        if (!placed[v] && prio[v] < top) {
          // stale high entry; reinsert at true priority
          ensure(prio[v]);
          buckets[prio[v]].push_back(v);
        }
      }
      if (top == 0) {
        // bucket 0 may legitimately be empty here if all zero-priority
        // vertices were placed; find any unplaced vertex
        for (size_t v = 0; v < placed.size(); ++v)
          if (!placed[v]) return static_cast<int32_t>(v);
        return -1;
      }
    }
  }
};

void order_gorder(const Csr& g, int32_t* perm, int32_t window = 5,
                  bool siblings = false) {
  // Greedy: next vertex maximizes edges/shared-neighbors with the last
  // `window` placed vertices (order_gorder.cu:88-143). Hubs
  // (deg > sqrt(n)) are excluded from priority updates, bounding cost.
  //
  // `siblings`: also bump vertices sharing a neighbor with the window
  // vertex — the reference's sibling term (order_gorder.cu:121-139 with
  // locality_sibling=1). On the symmetric GCN adjacency the directed
  // parent/child split collapses to plain neighbors, and siblings are the
  // 2-hop neighborhood. The reference entry point runs window=3
  // (renumber.cu:176); "gorder3" exposes that faithful configuration.
  const int32_t n = g.n;
  const int64_t huge = std::max<int64_t>(2, (int64_t)std::sqrt((double)n));
  // seed order: RCM for locality (complete_gorder composes RCM first)
  std::vector<int32_t> seed(n);
  order_rcm(g, seed.data());
  std::vector<int32_t> seed_rank(n);
  for (int32_t i = 0; i < n; ++i) seed_rank[seed[i]] = i;

  BucketQueue q(n);
  // initialize: push all in reverse seed order so ties pop in seed order
  for (int32_t i = n - 1; i >= 0; --i) q.push(seed[i]);

  std::deque<int32_t> win;
  auto bump_neighbors = [&](int32_t u, int64_t delta) {
    if (g.deg(u) > huge) return;
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      int32_t v = g.indices[e];
      if (!q.placed[v]) q.bump(v, delta);
      if (siblings && g.deg(v) <= huge) {
        for (int64_t e2 = g.indptr[v]; e2 < g.indptr[v + 1]; ++e2) {
          int32_t s = g.indices[e2];
          if (s != u && !q.placed[s]) q.bump(s, delta);
        }
      }
    }
  };

  for (int32_t pos = 0; pos < n; ++pos) {
    int32_t u = q.pop();
    q.placed[u] = 1;
    perm[pos] = u;
    bump_neighbors(u, +1);
    win.push_back(u);
    if (static_cast<int32_t>(win.size()) > window) {
      bump_neighbors(win.front(), -1);
      win.pop_front();
    }
  }
}

// ---------------------------------------------------------------- rabbit --

// Greedy modularity merging (Arai et al. IPDPS'16 objective, as in
// renumber.cu:319-522): each round scans vertices in ascending degree and
// merges u into the neighbor v maximizing dQ = w_uv/2m - d_u d_v/(2m)^2 when
// positive; merged adjacency is combined small-to-large over flat sorted
// vectors. The dendrogram (children lists) is emitted depth-first so each
// community is contiguous.
void order_rabbit(const Csr& g, int32_t* perm, int32_t max_rounds = 64) {
  const int32_t n = g.n;
  double two_m = 0.0;
  std::vector<double> wdeg(n, 0.0);
  for (int32_t u = 0; u < n; ++u)
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      double w = g.data ? g.data[e] : 1.0;
      wdeg[u] += w;
      two_m += w;
    }
  if (two_m <= 0) {
    std::iota(perm, perm + n, 0);
    return;
  }

  using Nbr = std::pair<int32_t, double>;  // (neighbor super-vertex, weight)
  std::vector<std::vector<Nbr>> adj(n);
  for (int32_t u = 0; u < n; ++u) {
    auto& a = adj[u];
    a.reserve(g.deg(u));
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      int32_t v = g.indices[e];
      if (v != u) a.emplace_back(v, g.data ? g.data[e] : 1.0);
    }
    // CSR columns are already sorted; canonicalize no longer needs order
  }

  std::vector<int32_t> parent(n);
  std::iota(parent.begin(), parent.end(), 0);
  std::vector<std::vector<int32_t>> children(n);

  auto find = [&](int32_t u) {
    int32_t r = u;
    while (parent[r] != r) r = parent[r];
    while (parent[u] != r) {
      int32_t next = parent[u];
      parent[u] = r;
      u = next;
    }
    return r;
  };

  // canonicalize an adjacency list: remap to roots, drop self, merge dups.
  // O(size) via a slot scratch array (first-seen order) — the sort-based
  // dedup this replaces made canonicalize the dominant rabbit cost at
  // 10M+ nnz (re-sorting large supervertices on every merge); nothing
  // downstream depends on adjacency order, only on summed weights.
  std::vector<Nbr> tmp;
  std::vector<int32_t> slot(n, -1);
  auto canonicalize = [&](std::vector<Nbr>& a, int32_t self) {
    tmp.clear();
    tmp.reserve(a.size());
    for (auto& [v0, w] : a) {
      int32_t v = find(v0);
      if (v == self) continue;
      int32_t s = slot[v];
      if (s < 0) {
        slot[v] = static_cast<int32_t>(tmp.size());
        tmp.emplace_back(v, w);
      } else {
        tmp[s].second += w;
      }
    }
    for (auto& [v, w] : tmp) slot[v] = -1;
    a.swap(tmp);
  };

  std::vector<int32_t> active(n);
  order_degree(g, active.data());  // ascending degree scan

  for (int32_t round = 0; round < max_rounds; ++round) {
    bool merged_any = false;
    std::vector<int32_t> next_active;
    next_active.reserve(active.size());
    for (int32_t u0 : active) {
      int32_t u = find(u0);
      if (u != u0 || adj[u].empty()) continue;  // already absorbed this round
      canonicalize(adj[u], u);
      int32_t best = -1;
      double best_gain = 0.0;
      for (auto& [v, w] : adj[u]) {
        double gain = w / two_m - (wdeg[u] * wdeg[v]) / (two_m * two_m);
        if (gain > best_gain) {
          best_gain = gain;
          best = v;
        }
      }
      if (best < 0) {
        next_active.push_back(u);
        continue;
      }
      int32_t small = u, big = best;
      if (adj[small].size() > adj[big].size()) std::swap(small, big);
      // big absorbs small; u's dendrogram node hangs under the survivor.
      // (No pre-canonicalize of small: parent[small]=big is set below, so
      // big's canonicalize remaps small's stale/self entries anyway.)
      adj[big].insert(adj[big].end(), adj[small].begin(), adj[small].end());
      adj[small].clear();
      adj[small].shrink_to_fit();
      wdeg[big] += wdeg[small];
      parent[small] = big;
      children[big].push_back(small);
      canonicalize(adj[big], big);
      merged_any = true;
      next_active.push_back(big);
    }
    if (!merged_any) break;
    // dedupe roots for the next round, preserving scan order
    std::vector<char> seen(n, 0);
    active.clear();
    for (int32_t u : next_active) {
      int32_t r = find(u);
      if (!seen[r]) {
        seen[r] = 1;
        active.push_back(r);
      }
    }
  }

  // depth-first dendrogram emit: communities contiguous
  int64_t pos = 0;
  std::vector<int32_t> stack;
  for (int32_t u = 0; u < n; ++u) {
    if (parent[u] != u) continue;
    stack.push_back(u);
    while (!stack.empty()) {
      int32_t v = stack.back();
      stack.pop_back();
      perm[pos++] = v;
      for (int32_t c : children[v]) stack.push_back(c);
    }
  }
}

}  // namespace

extern "C" int gcn_reorder(const char* method, const int32_t* indptr,
                           const int32_t* indices, const float* data,
                           int32_t n, int64_t nnz, int32_t* perm_out) {
  if (!method || !indptr || !indices || !perm_out || n < 0) return 1;
  Csr g{indptr, indices, data, n, nnz};
  std::string m(method);
  try {
    if (m == "identity") {
      std::iota(perm_out, perm_out + n, 0);
    } else if (m == "degree") {
      order_degree(g, perm_out);
    } else if (m == "dfs") {
      order_dfs(g, perm_out);
    } else if (m == "rcm") {
      order_rcm(g, perm_out);
    } else if (m == "gorder") {
      order_gorder(g, perm_out);
    } else if (m == "gorder3") {
      order_gorder(g, perm_out, 3, true);
    } else if (m == "rabbit") {
      order_rabbit(g, perm_out);
    } else {
      return 2;  // unknown method
    }
  } catch (...) {
    return 3;
  }
  // permutation validity self-check (cf. renumber.cu:123-149)
  std::vector<char> seen(n, 0);
  for (int32_t i = 0; i < n; ++i) {
    int32_t v = perm_out[i];
    if (v < 0 || v >= n || seen[v]) return 4;
    seen[v] = 1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Symmetric CSR permutation: out[i, j] = A[perm[i], perm[j]], columns sorted
// ascending within each row. The native counterpart of the reference's
// perm_apply (renumber.cu:233-318), replacing the numpy COO-lexsort path
// whose global (row, col) sort cost ~30 s at yelp scale (13.5M nnz); this
// is an O(nnz) row gather + per-row sorts, OpenMP-parallel over rows.
// ---------------------------------------------------------------------------

extern "C" int gcn_csr_permute(const int32_t* indptr, const int32_t* indices,
                               const float* data, const int32_t* perm,
                               int32_t n, int64_t nnz,
                               int32_t* out_indptr, int32_t* out_indices,
                               float* out_data) {
  if (!indptr || !indices || !data || !perm || !out_indptr || !out_indices ||
      !out_data || n < 0 || nnz < 0)
    return 1;
  std::vector<int32_t> inv(n);
  std::vector<char> seen(n, 0);
  for (int32_t i = 0; i < n; ++i) {
    int32_t o = perm[i];
    if (o < 0 || o >= n || seen[o]) return 4;  // not a permutation
    seen[o] = 1;
    inv[o] = i;
  }
  out_indptr[0] = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t o = perm[i];
    out_indptr[i + 1] = out_indptr[i] + (indptr[o + 1] - indptr[o]);
  }
  if (out_indptr[n] != nnz) return 5;

  bool fail = false;
#pragma omp parallel
  {
    std::vector<std::pair<int32_t, float>> row;
#pragma omp for schedule(dynamic, 256)
    for (int32_t i = 0; i < n; ++i) {
      int32_t o = perm[i];
      int64_t s = indptr[o];
      int64_t len = indptr[o + 1] - s;
      row.resize(len);
      for (int64_t j = 0; j < len; ++j) {
        int32_t c = indices[s + j];
        if (c < 0 || c >= n) { fail = true; break; }
        row[j] = {inv[c], data[s + j]};
      }
      std::sort(row.begin(), row.end(),
                [](const auto& a, const auto& b) { return a.first < b.first; });
      int64_t d = out_indptr[i];
      for (int64_t j = 0; j < len; ++j) {
        out_indices[d + j] = row[j].first;
        out_data[d + j] = row[j].second;
      }
    }
  }
  return fail ? 6 : 0;
}
