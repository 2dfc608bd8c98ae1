"""Vertex reordering for SpMM locality (host side).

Methods (perm[new] = old, the ``vomp`` convention of the renumbering
library that gcn_tpu follows):
  identity | degree | degree_in | degree_out | dfs | rcm | gorder | gorder3
  | rabbit

The native C++ library (``reorder/native.py``) computes degree, dfs, rcm,
gorder, gorder3 and rabbit when it builds; numpy passes
(``reorder/python_impl.py``) otherwise, and always for degree_in and
degree_out, as in gcn_tpu, so both packages give the same permutations.
Every reorder is validated by a permutation check and a graph-isomorphism
checksum. ``save_order`` and ``load_order`` read and write the
renumbering library's order files (one new id an old vertex a line).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gcn_tpu_torch.graph.csr import CSRGraph

METHODS = ("identity", "degree", "degree_in", "degree_out", "dfs", "rcm",
           "gorder", "gorder3", "rabbit")
# passes of the native library; degree_in and degree_out are numpy-only
_NATIVE_METHODS = ("degree", "dfs", "rcm", "gorder", "gorder3", "rabbit")


def route(method: str, prefer_native: bool = True) -> str:
    """Which implementation ``compute_permutation`` runs for ``method``:
    ``"native"``, ``"numpy"`` or ``"none"`` (identity)."""
    if method == "identity":
        return "none"
    if prefer_native and method in _NATIVE_METHODS:
        from gcn_tpu_torch.reorder import native

        if native.available():
            return "native"
    return "numpy"


def compute_permutation(g: CSRGraph, method: str = "rabbit",
                        prefer_native: bool = True) -> np.ndarray:
    """Return perm (int32[n], perm[new]=old) for the given method."""
    if method not in METHODS:
        raise ValueError(
            f"unknown reorder method {method!r}; options: {METHODS}")
    how = route(method, prefer_native)
    if how == "none":
        return np.arange(g.shape[0], dtype=np.int32)
    if how == "native":
        from gcn_tpu_torch.reorder import native

        return native.compute_permutation(g, method)
    from gcn_tpu_torch.reorder import python_impl

    return getattr(python_impl, f"{method}_order")(g)


def reorder_graph(g: CSRGraph, method: str = "rabbit", *,
                  prefer_native: bool = True,
                  verify: bool = True) -> Tuple[CSRGraph, np.ndarray]:
    """Compute a permutation and apply it symmetrically; returns
    (permuted graph with sorted columns, perm) with perm[new] = old."""
    perm = compute_permutation(g, method, prefer_native=prefer_native)
    validate_permutation(perm, g.shape[0])
    g2 = g.permute(perm)
    if verify:
        a = np.sort(g.isomorphism_checksum())
        b = np.sort(g2.isomorphism_checksum())
        if not np.allclose(a, b, rtol=1e-9, atol=1e-6):
            raise AssertionError(
                f"reorder {method!r} broke the graph: checksum mismatch")
    return g2, perm


def reorder_stats(g: CSRGraph) -> dict:
    """Rabbit's community statistics: community count, modularity Q, the
    largest community and the singletons. Runs the numpy clustering (the
    native pass does not export its dendrogram); for analysis, not the
    training path."""
    from gcn_tpu_torch.reorder import python_impl

    _, communities = python_impl.rabbit_order(g, return_communities=True)
    q = python_impl.modularity(g, communities)
    sizes = np.bincount(communities)
    return {
        "communities": int(len(sizes)),
        "modularity": float(q),
        "largest_community": int(sizes.max()),
        "singleton_communities": int((sizes == 1).sum()),
    }


def validate_permutation(perm: np.ndarray, n: int) -> None:
    if perm.shape != (n,):
        raise ValueError(f"perm shape {perm.shape} != ({n},)")
    seen = np.zeros(n, dtype=bool)
    seen[perm] = True
    if not seen.all():
        raise ValueError("not a permutation: missing indices")


def save_order(path: str, perm: np.ndarray) -> None:
    """Write an order file: line u holds the new id of old vertex u (a rank
    vector, rank[old] = new, the inverse of perm[new] = old)."""
    perm = np.asarray(perm, dtype=np.int64)
    rank = np.empty_like(perm)
    rank[perm] = np.arange(perm.shape[0])
    np.savetxt(path, rank, fmt="%d")


def load_order(path: str, n: int = None) -> np.ndarray:
    """Read an order file (rank[old] = new, one a line) -> perm[new] = old
    (int32), validated when ``n`` is given."""
    rank = np.loadtxt(path, dtype=np.int64).reshape(-1)
    perm = np.empty_like(rank)
    perm[rank] = np.arange(rank.shape[0])
    perm = perm.astype(np.int32)
    if n is not None:
        validate_permutation(perm, n)
    return perm
