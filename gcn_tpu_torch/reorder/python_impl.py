"""Pure numpy/scipy reordering passes: the fallbacks for the native library.

Copies of ``gcn_tpu.reorder.python_impl``: the same passes, visit orders
and tie-breaks, so that a graph gets the same permutation from both
packages. Same contract everywhere: take a CSRGraph, return perm with
perm[new] = old.

  * ``degree`` / ``degree_out`` / ``degree_in`` — stable argsorts of the
    row, row and column degrees;
  * ``dfs`` — iterative DFS visit order over every component;
  * ``rcm`` — reverse Cuthill-McKee (scipy);
  * ``bfs`` — multi-component BFS visit order;
  * ``gorder`` / ``gorder3`` — the sliding-window locality greedy (Wei et
    al.), window 5, or window 3 with the sibling term;
  * ``rabbit`` — community clustering by greedy modularity merging (Arai
    et al.); ``modularity`` scores a community assignment.
"""

from __future__ import annotations

import heapq
from collections import defaultdict, deque

import numpy as np

from gcn_tpu_torch.graph.csr import CSRGraph


def degree_order(g: CSRGraph) -> np.ndarray:
    """Sort vertices by degree ascending."""
    return np.argsort(g.row_degrees(), kind="stable").astype(np.int32)


def degree_out_order(g: CSRGraph) -> np.ndarray:
    """Sort by out-degree (CSR row lengths) ascending: ``degree_order`` on
    a symmetric adjacency, different on a directed one."""
    return np.argsort(g.row_degrees(), kind="stable").astype(np.int32)


def degree_in_order(g: CSRGraph) -> np.ndarray:
    """Sort by in-degree (column counts) ascending."""
    return np.argsort(g.col_degrees(), kind="stable").astype(np.int32)


def dfs_order(g: CSRGraph) -> np.ndarray:
    """Iterative DFS visit order over every component."""
    n = g.shape[0]
    indptr, indices = g.indptr, g.indices
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int32)
    pos = 0
    for start in range(n):
        if visited[start]:
            continue
        stack = [start]
        visited[start] = True
        while stack:
            u = stack.pop()
            order[pos] = u
            pos += 1
            # push neighbours in reverse so lower ids are visited first
            for v in indices[indptr[u]:indptr[u + 1]][::-1]:
                if not visited[v]:
                    visited[v] = True
                    stack.append(v)
    assert pos == n
    return order


def rcm_order(g: CSRGraph) -> np.ndarray:
    """Reverse Cuthill-McKee via scipy."""
    import scipy.sparse.csgraph as csgraph

    perm = csgraph.reverse_cuthill_mckee(g.to_scipy(), symmetric_mode=True)
    return perm.astype(np.int32)


def bfs_order(g: CSRGraph, start: int = 0) -> np.ndarray:
    """Multi-component BFS visit order, from ``start`` first."""
    n = g.shape[0]
    indptr, indices = g.indptr, g.indices
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int32)
    pos = 0
    for s in [start] + [u for u in range(n) if u != start]:
        if visited[s]:
            continue
        visited[s] = True
        q = deque([s])
        while q:
            u = q.popleft()
            order[pos] = u
            pos += 1
            for v in indices[indptr[u]:indptr[u + 1]]:
                if not visited[v]:
                    visited[v] = True
                    q.append(v)
    assert pos == n
    return order


def gorder_order(g: CSRGraph, window: int = 5,
                 siblings: bool = False) -> np.ndarray:
    """Sliding-window greedy locality ordering.

    Next vertex = argmax over unplaced v of the number of edges linking v to
    the last ``window`` placed vertices, through a lazy max-heap seeded with
    the RCM rank (ties go to the lower rank); hub vertices (degree above
    sqrt(n)) bump no priorities. ``siblings=True`` adds the shared-neighbour
    term: window vertices also bump their 2-hop neighbourhood.
    """
    n = g.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int32)
    indptr, indices = g.indptr, g.indices
    deg = g.row_degrees()
    huge = max(int(np.sqrt(n)), 2)
    try:
        seed_rank = np.empty(n, dtype=np.int64)
        seed_rank[rcm_order(g)] = np.arange(n)
    except Exception:
        seed_rank = np.arange(n)

    prio = np.zeros(n, dtype=np.int64)
    placed = np.zeros(n, dtype=bool)
    # heap of (-priority, seed_rank, vertex); stale entries skipped on pop
    heap = [(0, int(seed_rank[v]), v) for v in range(n)]
    heapq.heapify(heap)
    win: list[int] = []
    order = np.empty(n, dtype=np.int32)

    def bump1(v: int, delta: int):
        if not placed[v]:
            prio[v] += delta
            if delta > 0:
                heapq.heappush(heap, (-int(prio[v]), int(seed_rank[v]), v))

    def bump(u: int, delta: int):
        if deg[u] > huge:
            return
        for v in indices[indptr[u]:indptr[u + 1]]:
            bump1(v, delta)
            if siblings and deg[v] <= huge:
                for s in indices[indptr[v]:indptr[v + 1]]:
                    if s != u:
                        bump1(s, delta)

    for pos in range(n):
        while True:
            negp, _, u = heapq.heappop(heap)
            if not placed[u] and -negp == prio[u]:
                break
        placed[u] = True
        order[pos] = u
        bump(u, +1)
        win.append(u)
        if len(win) > window:
            bump(win.pop(0), -1)
    return order


def gorder3_order(g: CSRGraph) -> np.ndarray:
    """Gorder at window 3 with the sibling term."""
    return gorder_order(g, window=3, siblings=True)


def rabbit_order(g: CSRGraph, max_rounds: int = 64,
                 return_communities: bool = False):
    """Community-clustering order by greedy modularity merging (Rabbit
    order, Arai et al.): each vertex merges into the neighbour with the
    largest positive gain dQ = w_uv/(2m) - d_u d_v/(2m)^2, vertices scanned
    in ascending degree, rounds repeat until no merge happens, and the
    dendrogram is emitted community by community so each community's
    vertices are contiguous. ``return_communities`` also returns each
    vertex's community id."""
    n = g.shape[0]
    if n == 0:
        out = np.empty(0, dtype=np.int32)
        return (out, out.copy()) if return_communities else out
    rows, cols, vals = g.to_coo()
    two_m = float(vals.sum())
    if two_m <= 0:
        out = np.arange(n, dtype=np.int32)
        return (out, np.zeros(n, np.int32)) if return_communities else out

    parent = np.arange(n, dtype=np.int64)

    def find(u: int) -> int:
        root = u
        while parent[root] != root:
            root = parent[root]
        while parent[u] != root:
            parent[u], u = root, parent[u]
        return root

    adj: list[dict] = [defaultdict(float) for _ in range(n)]
    for r, c, v in zip(rows.tolist(), cols.tolist(), vals.tolist()):
        if r != c:
            adj[r][c] += v
    wdeg = np.zeros(n, dtype=np.float64)
    np.add.at(wdeg, rows, vals.astype(np.float64))
    children: list[list[int]] = [[] for _ in range(n)]

    active = list(np.argsort(g.row_degrees(), kind="stable"))
    for _ in range(max_rounds):
        merged_any = False
        next_active = []
        for u in active:
            u = find(int(u))
            if not adj[u]:
                continue
            best_v, best_gain = -1, 0.0
            items = list(adj[u].items())
            adj[u].clear()
            for v0, w in items:
                v = find(v0)
                if v != u:
                    adj[u][v] += w
            for v, w in adj[u].items():
                gain = w / two_m - (wdeg[u] * wdeg[v]) / (two_m * two_m)
                if gain > best_gain:
                    best_gain, best_v = gain, v
            if best_v >= 0:
                u2, v2 = u, best_v
                if len(adj[u2]) > len(adj[v2]):
                    u2, v2 = v2, u2
                for t0, w in adj[u2].items():     # v2 absorbs u2
                    t = find(t0)
                    if t != v2:
                        adj[v2][t] += w
                adj[v2].pop(u2, None)
                adj[u2].clear()
                wdeg[v2] += wdeg[u2]
                parent[u2] = v2
                children[v2].append(u2)
                merged_any = True
                next_active.append(v2)
            else:
                next_active.append(u)
        if not merged_any:
            break
        seen = set()
        active = []
        for u in next_active:
            u = find(int(u))
            if u not in seen:
                seen.add(u)
                active.append(u)

    # each dendrogram node is a real vertex: emit it before its children
    order = np.empty(n, dtype=np.int32)
    communities = np.empty(n, dtype=np.int32)
    pos = 0
    for ci, root in enumerate(u for u in range(n) if parent[u] == u):
        stack = [root]
        while stack:
            u = stack.pop()
            order[pos] = u
            communities[u] = ci
            pos += 1
            stack.extend(children[u])
    assert pos == n
    if return_communities:
        return order, communities
    return order


def modularity(g: CSRGraph, communities: np.ndarray) -> float:
    """Newman modularity Q of a community assignment."""
    rows, cols, vals = g.to_coo()
    two_m = float(vals.sum())
    if two_m == 0:
        return 0.0
    wdeg = np.zeros(g.shape[0], dtype=np.float64)
    np.add.at(wdeg, rows, vals.astype(np.float64))
    in_w = vals[communities[rows] == communities[cols]].sum()
    comm_deg = np.zeros(int(communities.max()) + 1, dtype=np.float64)
    np.add.at(comm_deg, communities, wdeg)
    return float(in_w / two_m - np.sum((comm_deg / two_m) ** 2))
