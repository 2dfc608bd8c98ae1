"""GraphSAINT-format loader: flickr / ppi / amazon / reddit / yelp.

The port's copy of ``gcn_tpu.data.graphsaint`` (host numpy and scipy; the
same arrays for the same files). Directory layout:

    <root>/<name>/adj_full.npz    scipy CSR, full graph
    <root>/<name>/adj_train.npz   scipy CSR, train-node subgraph
    <root>/<name>/feats.npy       (n, f) float features
    <root>/<name>/class_map.json  {node: class} or {node: multilabel list}
    <root>/<name>/role.json       {"tr": [...], "va": [...], "te": [...]}

Features are standard-scaled with statistics fit on the train nodes only;
multi-label targets are squashed to their argmax. Nothing is downloaded: a
missing file raises ``FileNotFoundError`` pointing at the GraphSAINT data
release.
"""

from __future__ import annotations

import json
import os

import numpy as np
import scipy.sparse as sp

NAMES = ("flickr", "ppi", "amazon", "reddit", "yelp")

_HINT = ("the GraphSAINT data release "
         "(https://github.com/GraphSAINT/GraphSAINT#data)")


def _require(path: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"dataset file {path!r} not found (nothing is downloaded); "
            f"fetch it from {_HINT}, or use a synth-* dataset")
    return path


def standard_scale(feats: np.ndarray, fit_idx: np.ndarray) -> np.ndarray:
    """StandardScaler fit on the ``fit_idx`` rows only."""
    mu = feats[fit_idx].mean(axis=0)
    sd = feats[fit_idx].std(axis=0)
    sd = np.where(sd == 0, 1.0, sd)
    return ((feats - mu) / sd).astype(np.float32)


def load(name: str, root: str, normalize: bool = True):
    from gcn_tpu_torch.data.registry import GraphData
    from gcn_tpu_torch.graph.csr import CSRGraph

    name = name.lower()
    assert name in NAMES, f"{name!r} not in {NAMES}"
    d = os.path.join(root, name)
    adj_full = sp.load_npz(_require(os.path.join(d, "adj_full.npz"))).tocsr()
    adj_train = sp.load_npz(_require(os.path.join(d, "adj_train.npz"))).tocsr()
    feats = np.load(_require(os.path.join(d, "feats.npy"))).astype(np.float32)
    with open(_require(os.path.join(d, "class_map.json"))) as f:
        class_map = {int(k): v for k, v in json.load(f).items()}
    with open(_require(os.path.join(d, "role.json"))) as f:
        role = json.load(f)
    assert len(class_map) == feats.shape[0], "class map must cover all nodes"

    if normalize:
        train_nodes = np.unique(adj_train.nonzero()[0])
        feats = standard_scale(feats, train_nodes)

    n = adj_full.shape[0]
    labels = np.zeros(n, dtype=np.int64)
    for k, v in class_map.items():
        labels[k] = int(np.argmax(v)) if isinstance(v, list) else int(v)

    adj = adj_full + adj_full.T
    adj.data[:] = 1.0
    adj = adj.tolil()
    adj.setdiag(0)
    adj = adj.astype(np.float32).tocsr()
    adj.eliminate_zeros()

    return GraphData(
        name=name,
        adj=CSRGraph.from_scipy(adj),
        features=feats,
        labels=labels,
        idx_train=np.sort(np.asarray(role["tr"], dtype=np.int64)),
        idx_val=np.sort(np.asarray(role["va"], dtype=np.int64)),
        idx_test=np.sort(np.asarray(role["te"], dtype=np.int64)),
    )
