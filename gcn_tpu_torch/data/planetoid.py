"""Planetoid-family loaders: cora / citeseer / cora_ml / polblogs / pubmed.

The port's copy of ``gcn_tpu.data.planetoid`` (host numpy and scipy; the
same arrays for the same files and seed). File formats follow the pygcn
reference's ``Dataset`` (gcnio/data/dataio.py):

  * ``<name>.npz`` — the gnn-meta-attack archive layout: CSR triplets
    ``adj_{data,indices,indptr,shape}``, optional
    ``attr_{data,indices,indptr,shape}``, and ``labels``;
  * pubmed — the tkipf/gcn Planetoid pickles ``ind.pubmed.{x,y,tx,ty,allx,
    ally,graph}`` and ``ind.pubmed.test.index``.

Files must already exist under ``root``: nothing is downloaded, and a
missing file raises ``FileNotFoundError`` naming where to fetch it.

Graph cleanup: symmetrize, binarize, optional largest-connected-component
restriction, zero diagonal, symmetry and unweightedness asserts. Splits:
``setting='nettack'`` -> stratified 10/10/80, ``setting='gcn'`` ->
20-per-class train, 500 val, 1000 test.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import scipy.sparse as sp

NAMES = ("cora", "citeseer", "cora_ml", "polblogs", "pubmed")

_NPZ_URL = ("https://raw.githubusercontent.com/danielzuegner/"
            "gnn-meta-attack/master/data/{name}.npz")
_PUBMED_URL = "https://raw.githubusercontent.com/tkipf/gcn/master/gcn/data/"


def _require(path: str, hint: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"dataset file {path!r} not found (nothing is downloaded); "
            f"fetch it from {hint} and place it there, or use a synth-* "
            f"dataset")
    return path


def load_npz_graph(path: str):
    """gnn-meta-attack npz archive -> (adj csr, features csr, labels)."""
    with np.load(path, allow_pickle=True) as f:
        adj = sp.csr_matrix(
            (f["adj_data"], f["adj_indices"], f["adj_indptr"]),
            shape=f["adj_shape"])
        if "attr_data" in f:
            feats = sp.csr_matrix(
                (f["attr_data"], f["attr_indices"], f["attr_indptr"]),
                shape=f["attr_shape"])
        else:
            feats = sp.eye(adj.shape[0], format="csr")
        labels = f["labels"] if "labels" in f else None
    return adj, feats.astype(np.float32), labels


def _largest_connected_component(adj: sp.csr_matrix) -> np.ndarray:
    _, comp = sp.csgraph.connected_components(adj)
    sizes = np.bincount(comp)
    return np.flatnonzero(comp == sizes.argmax())


def _clean_adj(adj: sp.spmatrix, require_lcc: bool):
    adj = adj + adj.T
    adj.data[:] = 1.0
    keep = None
    if require_lcc:
        keep = _largest_connected_component(adj.tocsr())
        adj = adj.tocsr()[keep][:, keep]
    adj = adj.tolil()
    adj.setdiag(0)
    adj = adj.astype(np.float32).tocsr()
    adj.eliminate_zeros()
    assert np.abs(adj - adj.T).sum() == 0, "adjacency must be symmetric"
    assert adj.nnz == 0 or adj.max() == 1, "adjacency must be unweighted"
    return adj, keep


def _stratified_split(labels: np.ndarray, fractions=(0.1, 0.1, 0.8),
                      rng: np.random.Generator = None):
    """Per-class proportional split (the nettack 10/10/80)."""
    rng = rng or np.random.default_rng()
    idx_train, idx_val, idx_test = [], [], []
    for c in np.unique(labels):
        members = rng.permutation(np.flatnonzero(labels == c))
        n = len(members)
        n_tr = max(1, int(round(fractions[0] * n)))
        n_va = max(1, int(round(fractions[1] * n)))
        idx_train.append(members[:n_tr])
        idx_val.append(members[n_tr:n_tr + n_va])
        idx_test.append(members[n_tr + n_va:])

    def cat(xs):
        return np.sort(np.concatenate(xs)).astype(np.int64)

    return cat(idx_train), cat(idx_val), cat(idx_test)


def _gcn_split(labels: np.ndarray, per_class: int = 20, n_val: int = 500,
               n_test: int = 1000, rng: np.random.Generator = None):
    """20-per-class train / 500 val / 1000 test."""
    rng = rng or np.random.default_rng()
    idx = np.arange(len(labels))
    train, rest = [], []
    for c in range(int(labels.max()) + 1):
        members = rng.permutation(idx[labels == c])
        train.append(members[:per_class])
        rest.append(members[per_class:])
    rest = rng.permutation(np.concatenate(rest))
    return (np.sort(np.concatenate(train)).astype(np.int64),
            np.sort(rest[:n_val]).astype(np.int64),
            np.sort(rest[n_val:n_val + n_test]).astype(np.int64))


def _load_pubmed_pickles(root: str):
    """tkipf/gcn Planetoid pickles -> (adj, features, labels)."""
    objs = {}
    for part in ("x", "y", "tx", "ty", "allx", "ally", "graph"):
        path = _require(os.path.join(root, f"ind.pubmed.{part}"),
                        _PUBMED_URL + f"ind.pubmed.{part}")
        with open(path, "rb") as f:
            objs[part] = pickle.load(f, encoding="latin1")
    ti_path = _require(os.path.join(root, "ind.pubmed.test.index"),
                       _PUBMED_URL + "ind.pubmed.test.index")
    with open(ti_path) as f:
        test_idx = np.array([int(line.strip()) for line in f],
                            dtype=np.int64)
    test_sorted = np.sort(test_idx)

    features = sp.vstack([sp.csr_matrix(objs["allx"]),
                          sp.csr_matrix(objs["tx"])]).tolil()
    features[test_idx] = features[test_sorted]
    labels_1hot = np.vstack([objs["ally"], objs["ty"]])
    labels_1hot[test_idx] = labels_1hot[test_sorted]
    labels = labels_1hot.argmax(axis=1)

    n = features.shape[0]
    graph = objs["graph"]  # dict: node -> neighbour list
    src = np.fromiter((u for u, vs in graph.items() for _ in vs),
                      dtype=np.int64)
    dst = np.fromiter((v for _, vs in graph.items() for v in vs),
                      dtype=np.int64)
    adj = sp.coo_matrix((np.ones(len(src), np.float32), (src, dst)),
                        shape=(n, n)).tocsr()
    return adj, features.tocsr().astype(np.float32), labels


def load(name: str, root: str, setting: str = "nettack", seed: int = 15):
    """Load a planetoid-roster dataset from local files -> GraphData."""
    from gcn_tpu_torch.data.registry import GraphData
    from gcn_tpu_torch.graph.csr import CSRGraph

    name = name.lower()
    assert name in NAMES, f"{name!r} not in {NAMES}"
    assert setting in ("nettack", "gcn")
    rng = np.random.default_rng(seed)

    if name == "pubmed":
        adj, feats, labels = _load_pubmed_pickles(root)
    else:
        path = _require(os.path.join(root, f"{name}.npz"),
                        _NPZ_URL.format(name=name))
        adj, feats, labels = load_npz_graph(path)

    adj, keep = _clean_adj(adj, require_lcc=(setting == "nettack"))
    if keep is not None:
        feats = feats[keep]
        labels = labels[keep]
    labels = np.asarray(labels).astype(np.int64)

    if setting == "nettack":
        tr, va, te = _stratified_split(labels, rng=rng)
    else:
        tr, va, te = _gcn_split(labels, rng=rng)

    return GraphData(
        name=name,
        adj=CSRGraph.from_scipy(adj),
        features=np.asarray(feats.todense(), dtype=np.float32),
        labels=labels,
        idx_train=tr, idx_val=va, idx_test=te,
    )
