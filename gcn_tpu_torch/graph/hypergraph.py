"""Hypergraph construction math (HGNN pipeline), numpy and scipy.

The port's copy of ``gcn_tpu/graph/hypergraph.py`` (the port imports
nothing of gcn_tpu); the arrays it builds equal gcn_tpu's. The HGNN
reference's hypergraph utilities (pyhgnn/utils/hypergraph_utils.py), with
the same numerics:

  * Euclidean distance matrix (hypergraph_utils.py:10-25)
  * probabilistic KNN incidence H with exp(-d^2 / (m * d_avg)^2)
    (hypergraph_utils.py:128-154, construct_H_with_KNN:157-181)
  * multi-modality incidence concatenation (hypergraph_utils.py:28-78)
  * G = Dv^{-1/2} H W De^{-1} H^T Dv^{-1/2}  (generate_G_from_H:97-125)

G is returned as a CSRGraph, so it is lowered like any graph
(``ops.adjacency.device_adjacency``) and applied through ``ops.spmm``:
dense, COO, or the ELL layout and kernel K1.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from gcn_tpu_torch.graph.csr import CSRGraph


def euclidean_distances(x: np.ndarray,
                        gram_dtype=np.float64) -> np.ndarray:
    """Pairwise Euclidean distance matrix (hypergraph_utils.py:10-25).

    True (square-rooted) distances, symmetrized with max(d, d.T) exactly as
    the reference's Eu_dis does — the KNN incidence weights below depend on
    the distance scale, not just the neighbor ranking.

    The O(n^2 d) Gram matmul runs in ``gram_dtype``. float64 (default)
    keeps near-duplicate distances exact; float32 is faster but
    sqrt-amplifies cancellation for tiny distances (~5e-3 absolute error
    where d ~ 0 — it can reorder near-tied KNN picks), so it is opt-in for
    workloads without near-duplicate points. Squared norms and the
    combination are float64 either way. The result is a dense n x n
    float64 matrix (1.2 GB at n = 12,311).
    """
    x64 = np.asarray(x, dtype=np.float64)
    sq = np.einsum("ij,ij->i", x64, x64)
    xg = np.asarray(x, dtype=gram_dtype)
    d = (xg @ xg.T).astype(np.float64)
    d *= -2.0
    d += sq[:, None]
    d += sq[None, :]
    np.maximum(d, 0.0, out=d)
    np.sqrt(d, out=d)
    return np.maximum(d, d.T)


def _knn_incidence_triplets(
    x: np.ndarray,
    k_neig: int,
    *,
    is_prob: bool = True,
    m_prob: float = 1.0,
):
    """(neighbors, weights) of the KNN incidence, vectorized.

    ``neighbors``/``weights`` are (n, k) arrays: hyperedge (column) c
    contains vertices ``neighbors[c]`` with weights ``weights[c]``.
    Same math as the reference's per-center loop
    (hypergraph_utils.py:128-181) without the per-row full argsort:
    argpartition selects the k nearest (identical set when distances are
    distinct), and when a center is not among its own k nearest (possible
    only under >=k exact-duplicate points) it evicts the farthest selected
    neighbor — the element the loop's ``order[:k][-1]`` overwrite removes.
    """
    n = x.shape[0]
    dis = euclidean_distances(x)
    np.fill_diagonal(dis, 0.0)
    avg = dis.mean(axis=1)                        # d_avg per center
    k = min(int(k_neig), n)
    if k < n:
        neigh = np.argpartition(dis, k - 1, axis=1)[:, :k]
    else:
        neigh = np.broadcast_to(np.arange(n), (n, n)).copy()
    centers = np.arange(n)
    has_self = (neigh == centers[:, None]).any(axis=1)
    if not has_self.all():
        miss = np.flatnonzero(~has_self)
        far = np.argmax(dis[miss[:, None], neigh[miss]], axis=1)
        neigh[miss, far] = miss
    d = np.take_along_axis(dis, neigh, axis=1)    # dvec[v] per (center, v)
    if is_prob:
        denom = (m_prob * avg) ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            w = np.where(denom[:, None] > 0,
                         np.exp(-(d ** 2) / denom[:, None]), 1.0)
    else:
        w = np.ones_like(d)
    return neigh, w.astype(np.float32)


def construct_H_with_KNN(
    x: np.ndarray,
    k_neig: int = 10,
    *,
    is_prob: bool = True,
    m_prob: float = 1.0,
) -> np.ndarray:
    """KNN hyperedge incidence: one hyperedge per vertex containing its
    k nearest neighbors (self included), weighted
    exp(-d^2/(m_prob*d_avg)^2) with true Euclidean d and d_avg the mean
    distance from the center (hypergraph_utils.py:128-181).

    Vectorized (argpartition + broadcast weights); bit-equal to the
    reference's per-center loop, which survives as
    ``_construct_H_with_KNN_loop``, the parity oracle of the tests. H is a
    dense n x n float32 matrix (0.6 GB at n = 12,311)."""
    n = x.shape[0]
    neigh, w = _knn_incidence_triplets(x, k_neig, is_prob=is_prob,
                                       m_prob=m_prob)
    h = np.zeros((n, n), dtype=np.float32)
    h[neigh, np.arange(n)[:, None]] = w           # h[v, center] = w
    return h


def _construct_H_with_KNN_loop(
    x: np.ndarray,
    k_neig: int = 10,
    *,
    is_prob: bool = True,
    m_prob: float = 1.0,
) -> np.ndarray:
    """The reference's per-center loop (hypergraph_utils.py:157-181),
    kept verbatim as the parity oracle for the vectorized version."""
    n = x.shape[0]
    dis = euclidean_distances(x)
    h = np.zeros((n, n), dtype=np.float32)
    for center in range(n):
        dvec = dis[center].copy()
        dvec[center] = 0.0
        avg = float(dvec.mean())
        order = np.argsort(dvec)
        neigh = order[:k_neig]
        if center not in neigh:
            neigh[-1] = center
        for v in neigh:
            if is_prob and avg > 0:
                h[v, center] = np.exp(-(dvec[v] ** 2) / ((m_prob * avg) ** 2))
            else:
                h[v, center] = 1.0
    return h


def feature_concat(*f_list, normal_col: bool = False) -> np.ndarray:
    """Multi-modality feature fusion (hypergraph_utils.py:28-55): skip
    empty entries, flatten >2-D features to (objects, last_dim), optionally
    max-abs-normalize each column (per matrix AND again after fusion, as
    the reference does)."""
    mats = []
    for f in f_list:
        if f is None or np.size(f) == 0:
            continue
        f = np.asarray(f)
        if f.ndim > 2:
            f = f.reshape(-1, f.shape[-1])
        if normal_col:
            f = f / np.maximum(np.max(np.abs(f), axis=0), 1e-12)
        mats.append(f)
    if not mats:
        raise ValueError("no feature matrices to concatenate")
    out = np.hstack(mats)
    if normal_col:
        out = out / np.maximum(np.max(np.abs(out), axis=0), 1e-12)
    return out


def hyperedge_concat(*h_list) -> np.ndarray:
    """Concatenate incidence matrices along hyperedges
    (hypergraph_utils.py:28-50), skipping empty entries."""
    mats = [np.asarray(h) for h in h_list if h is not None and np.size(h)]
    if not mats:
        raise ValueError("no incidence matrices to concatenate")
    return np.hstack(mats)


def generate_G_from_H(h,
                      w: Optional[np.ndarray] = None,
                      *,
                      variance_weight: bool = False):
    """G = Dv^{-1/2} H W De^{-1} H^T Dv^{-1/2} (hypergraph_utils.py:97-125).

    Accepts a single incidence matrix or a list of them (the multi-scale
    form produced by ``split_diff_scale=True``); lists map element-wise,
    mirroring generate_G_from_H's list recursion
    (hypergraph_utils.py:81-93).
    """
    if isinstance(h, (list, tuple)):
        return [generate_G_from_H(sub, w, variance_weight=variance_weight)
                for sub in h]
    import scipy.sparse as sp

    hs = (h.tocsr() if sp.issparse(h)
          else sp.csr_matrix(np.asarray(h, dtype=np.float64)))
    hs = hs.astype(np.float64)
    n, n_e = hs.shape
    if w is None:
        w = np.ones(n_e, dtype=np.float64)
    dv = np.asarray(hs @ w).ravel()
    de = np.asarray(hs.sum(axis=0)).ravel()
    with np.errstate(divide="ignore"):
        inv_de = np.where(de > 0, 1.0 / de, 0.0)
        inv_sqrt_dv = np.where(dv > 0, dv ** -0.5, 0.0)
    h2 = sp.diags(inv_sqrt_dv) @ hs               # Dv^-1/2 H
    g = (h2 @ sp.diags(w * inv_de)) @ h2.T        # ... W De^-1 H^T Dv^-1/2
    out = CSRGraph.from_scipy(g.tocsr().astype(np.float32))
    del variance_weight
    return out


def generate_G_factors(h: np.ndarray, w: Optional[np.ndarray] = None):
    """Factored form of generate_G_from_H: G = A1 @ A2 with
    A1 = Dv^-1/2 H (W De^-1) and A2 = H^T Dv^-1/2, returned as two sparse
    CSRGraphs (n x n_e) and (n_e x n).

    The reference materializes the dense n x n chain
    (hypergraph_utils.py:97-125); for large hypergraphs G has ~k^2
    neighbors per vertex while H has only k entries per hyperedge, so
    applying the two factors (``ops.spmm.TwoHopAdj``) is the scalable
    formulation.
    """
    import scipy.sparse as sp

    hs = (h.tocsr() if sp.issparse(h)
          else sp.csr_matrix(np.asarray(h, dtype=np.float64)))
    hs = hs.astype(np.float64)
    n, n_e = hs.shape
    if w is None:
        w = np.ones(n_e, dtype=np.float64)
    dv = np.asarray(hs @ w).ravel()
    de = np.asarray(hs.sum(axis=0)).ravel()
    with np.errstate(divide="ignore"):
        inv_de = np.where(de > 0, 1.0 / de, 0.0)
        inv_sqrt_dv = np.where(dv > 0, dv ** -0.5, 0.0)
    a1 = sp.diags(inv_sqrt_dv) @ hs @ sp.diags(w * inv_de)
    a2 = (hs.T @ sp.diags(inv_sqrt_dv)).tocsr()
    return (CSRGraph.from_scipy(a1.tocsr().astype(np.float32)),
            CSRGraph.from_scipy(a2.astype(np.float32)))


def construct_H_with_KNN_multi(
    features: Sequence[np.ndarray],
    k_neigs: Union[int, Sequence[int]] = 10,
    *,
    is_prob: bool = True,
    m_prob: float = 1.0,
    split_diff_scale: bool = False,
):
    """Multi-modality / multi-scale KNN hypergraph: one group of hyperedges
    per (feature modality, K) pair (visual_data.py:5-59).

    With ``split_diff_scale=False`` (default) all groups concatenate into
    one incidence matrix. With True, returns a list with one incidence
    matrix per K scale (modalities still concatenate within a scale),
    matching construct_H_with_KNN(split_diff_scale=True)
    (hypergraph_utils.py:157-181); feed the list to generate_G_from_H to
    get one G per scale.
    """
    if isinstance(k_neigs, int):
        k_neigs = [k_neigs]
    if split_diff_scale:
        per_scale: List[np.ndarray] = []
        for k in k_neigs:
            hs = [construct_H_with_KNN(x, k, is_prob=is_prob, m_prob=m_prob)
                  for x in features]
            per_scale.append(hyperedge_concat(*hs))
        return per_scale
    hs = []
    for x in features:
        for k in k_neigs:
            hs.append(construct_H_with_KNN(x, k, is_prob=is_prob,
                                           m_prob=m_prob))
    return hyperedge_concat(*hs)
