"""Graph and feature normalization (host side, numpy).

The numerics of ``gcn_tpu.graph.normalize``, which keeps the pygcn
reference's (gcnio/util/utils.py:64-90):

  * ``gcn_normalize``: D^{-1/2} (A + I) D^{-1/2}, with the self loop added
    only when A[0, 0] is empty;
  * ``row_normalize``: D^{-1} A (same self-loop rule), inf -> 0;
  * ``row_normalize_features``: row-sum normalize a dense feature matrix.
"""

from __future__ import annotations

import numpy as np

from gcn_tpu_torch.graph.csr import CSRGraph


def _has_nonzero_diag_head(g: CSRGraph) -> bool:
    row0 = g.indices[g.indptr[0]:g.indptr[1]]
    if 0 in row0:
        v = g.data[g.indptr[0]:g.indptr[1]][row0 == 0]
        return bool(np.any(v != 0))
    return False


def gcn_normalize(g: CSRGraph, *,
                  add_self_loops: bool | None = None) -> CSRGraph:
    """Symmetric GCN normalization D^{-1/2} (A + I) D^{-1/2}.

    ``add_self_loops`` forces self-loop addition on or off; the default adds
    I iff A[0, 0] == 0.
    """
    assert g.shape[0] == g.shape[1]
    if add_self_loops is None:
        add_self_loops = not _has_nonzero_diag_head(g)
    if add_self_loops:
        g = g.with_self_loops()
    # scaling never moves entries: keep the CSR structure
    r = np.repeat(np.arange(g.shape[0], dtype=np.int64), np.diff(g.indptr))
    v = g.data.astype(np.float64)
    rowsum = np.bincount(r, weights=v, minlength=g.shape[0])
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(rowsum, -0.5)
    d_inv_sqrt[~np.isfinite(d_inv_sqrt)] = 0.0
    vals = (d_inv_sqrt[r] * v * d_inv_sqrt[g.indices]).astype(np.float32)
    return CSRGraph(g.indptr, g.indices, vals, g.shape)


def row_normalize(g: CSRGraph, *,
                  add_self_loops: bool | None = None) -> CSRGraph:
    """Row-stochastic normalization D^{-1} A."""
    if add_self_loops is None:
        add_self_loops = not _has_nonzero_diag_head(g)
    if add_self_loops:
        g = g.with_self_loops()
    r = np.repeat(np.arange(g.shape[0], dtype=np.int64), np.diff(g.indptr))
    v = g.data.astype(np.float64)
    rowsum = np.bincount(r, weights=v, minlength=g.shape[0])
    with np.errstate(divide="ignore"):
        d_inv = 1.0 / rowsum
    d_inv[~np.isfinite(d_inv)] = 0.0
    vals = (d_inv[r] * v).astype(np.float32)
    return CSRGraph(g.indptr, g.indices, vals, g.shape)


def row_normalize_features(x: np.ndarray) -> np.ndarray:
    """Row-sum normalize dense features (zero rows stay zero)."""
    x = np.asarray(x, dtype=np.float32)
    s = x.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(s != 0, 1.0 / s, 0.0)
    return (x * inv).astype(np.float32)
