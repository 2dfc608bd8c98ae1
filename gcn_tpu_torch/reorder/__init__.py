"""Vertex reordering for SpMM locality (host side).

Methods (perm[new] = old): ``identity`` | ``degree`` | ``rabbit``. The native
C++ library (``reorder/native.py``) computes them when it builds; numpy
passes otherwise. Every reorder is validated by a permutation check and a
graph-isomorphism checksum. The other ``gcn_tpu`` methods (dfs, rcm,
gorder) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gcn_tpu_torch.graph.csr import CSRGraph

METHODS = ("identity", "degree", "rabbit")


def compute_permutation(g: CSRGraph, method: str = "rabbit",
                        prefer_native: bool = True) -> np.ndarray:
    """Return perm (int32[n], perm[new]=old) for the given method."""
    if method not in METHODS:
        raise ValueError(f"unknown reorder method {method!r}; the port has "
                         f"{METHODS} (ROADMAP.md lists the rest)")
    if method == "identity":
        return np.arange(g.shape[0], dtype=np.int32)
    if prefer_native:
        from gcn_tpu_torch.reorder import native

        if native.available():
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


def validate_permutation(perm: np.ndarray, n: int) -> None:
    if perm.shape != (n,):
        raise ValueError(f"perm shape {perm.shape} != ({n},)")
    seen = np.zeros(n, dtype=bool)
    seen[perm] = True
    if not seen.all():
        raise ValueError("not a permutation: missing indices")
