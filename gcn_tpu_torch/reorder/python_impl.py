"""Pure numpy reordering passes: the fallbacks for the native library.

Copies of ``gcn_tpu.reorder.python_impl.degree_order`` and ``rabbit_order``.
Same contract: take a CSRGraph, return perm with perm[new] = old.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from gcn_tpu_torch.graph.csr import CSRGraph


def degree_order(g: CSRGraph) -> np.ndarray:
    """Sort vertices by degree ascending."""
    return np.argsort(g.row_degrees(), kind="stable").astype(np.int32)


def rabbit_order(g: CSRGraph, max_rounds: int = 64) -> np.ndarray:
    """Community-clustering order by greedy modularity merging (Rabbit
    order, Arai et al.): each vertex merges into the neighbour with the
    largest positive gain dQ = w_uv/(2m) - d_u d_v/(2m)^2, rounds repeat
    until no merge happens, and the dendrogram is emitted community by
    community so each community's vertices are contiguous."""
    n = g.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int32)
    rows, cols, vals = g.to_coo()
    two_m = float(vals.sum())
    if two_m <= 0:
        return np.arange(n, dtype=np.int32)

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

    order = np.empty(n, dtype=np.int32)
    pos = 0
    for root in (u for u in range(n) if parent[u] == u):
        stack = [root]
        while stack:
            u = stack.pop()
            order[pos] = u
            pos += 1
            stack.extend(children[u])
    assert pos == n
    return order
