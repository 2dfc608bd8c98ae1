"""Dataset registry.

``get_dataset(name, root=None, seed=...)`` returns a ``GraphData`` bundle;
for the same name, files and seed it equals ``gcn_tpu.data.get_dataset``
bit for bit. The ``synth-*`` datasets come from the seeded generators in
``gcn_tpu_torch.data.synthetic``; the real ones are read from local files
under ``root`` (default ``$GCN_TPU_DATA``, else ``~/gcn_data``) by
``data/planetoid.py`` (cora, citeseer, cora_ml, polblogs, pubmed) and
``data/graphsaint.py`` (flickr, ppi, amazon, reddit, yelp). Nothing is
downloaded: a missing file raises ``FileNotFoundError``. The HGNN ``.mat``
loader is ``data/hypergraph_mat.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from gcn_tpu_torch.data import synthetic
from gcn_tpu_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class GraphData:
    name: str
    adj: CSRGraph            # symmetric, binary, no self loops
    features: np.ndarray     # float32 (n, f)
    labels: np.ndarray       # int64 (n,)
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1

    @property
    def num_features(self) -> int:
        return self.features.shape[1]

    def masks(self):
        """Boolean masks of the splits and one-hot labels zeroed outside
        each split (the reference's ``Dataset(require_mask=True)``):
        ``(train_mask, val_mask, test_mask, y_train, y_val, y_test)``, each
        ``y_*`` an (n, C) matrix."""
        n, c = self.num_nodes, self.num_classes
        onehot = np.zeros((n, c), dtype=np.float32)
        onehot[np.arange(n), self.labels] = 1.0
        masks, ys = [], []
        for idx in (self.idx_train, self.idx_val, self.idx_test):
            m = np.zeros(n, dtype=bool)
            m[np.asarray(idx)] = True
            masks.append(m)
            ys.append(np.where(m[:, None], onehot, 0.0))
        return (*masks, *ys)


# (n, classes, avg_degree, feat_dim, powerlaw[, feat_noise]), sized after
# the pygcn reference's benchmark roster
_SYNTH_SPECS = {
    "synth-tiny":   (200, 4, 8.0, 16, False),
    "synth-small":  (1500, 6, 9.0, 32, False),
    "synth-cora":   (2708, 7, 3.9, 1433, False),
    "synth-citeseer": (3327, 6, 2.8, 3703, False),
    "synth-pubmed": (19717, 3, 4.5, 500, False),
    "synth-flickr": (89250, 7, 10.0, 500, True),
    "synth-ppi":    (14755, 121, 15.0, 50, True),
    "synth-arxiv":  (169343, 40, 13.7, 128, True),
    "synth-reddit": (232965, 41, 50.0, 602, True),
    "synth-yelp":   (716847, 100, 19.5, 300, True),
    "synth-amazon": (1569960, 107, 10.0, 200, True),
    # feature noise 4x the class-centroid scale: the graph is load-bearing
    "synth-cora-hard":   (2708, 7, 3.9, 64, False, 4.0),
    "synth-pubmed-hard": (19717, 3, 4.5, 128, False, 4.0),
}


def get_dataset(name: str, root: Optional[str] = None, seed: int = 0,
                **kw) -> GraphData:
    if name in _SYNTH_SPECS:
        spec = _SYNTH_SPECS[name]
        n, c, deg, f, powerlaw = spec[:5]
        noise = spec[5] if len(spec) > 5 else 1.0
        gen = synthetic.powerlaw_sbm if powerlaw else synthetic.sbm
        adj, labels = gen(n=n, n_classes=c, avg_degree=deg, seed=seed, **kw)
        feats = synthetic.class_features(labels, feat_dim=f, noise=noise,
                                         seed=seed)
        tr, va, te = synthetic.split_indices(labels, seed=seed)
        return GraphData(name, adj, feats, labels, tr, va, te)

    from gcn_tpu_torch.data import graphsaint, planetoid

    if name in planetoid.NAMES:
        return planetoid.load(name, root=root or _default_root(), **kw)
    if name in graphsaint.NAMES:
        return graphsaint.load(name, root=root or _default_root(), **kw)
    raise KeyError(
        f"unknown dataset {name!r}; synthetic options: {sorted(_SYNTH_SPECS)}"
        f", real: {planetoid.NAMES + graphsaint.NAMES}")


def _default_root() -> str:
    return os.environ.get("GCN_TPU_DATA", os.path.expanduser("~/gcn_data"))
