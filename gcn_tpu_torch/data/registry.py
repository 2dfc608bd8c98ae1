"""Dataset registry: the ``synth-*`` datasets.

``get_dataset(name, seed=...)`` returns a ``GraphData`` bundle built by the
seeded generators in ``gcn_tpu_torch.data.synthetic``; for the same seed it
equals ``gcn_tpu.data.get_dataset`` bit for bit. The HGNN ``.mat`` loader
is ``data/hypergraph_mat.py``; the planetoid and GraphSAINT loaders are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

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


def get_dataset(name: str, seed: int = 0, **kw) -> GraphData:
    if name not in _SYNTH_SPECS:
        raise KeyError(
            f"unknown dataset {name!r}: the port has the synthetic datasets "
            f"{sorted(_SYNTH_SPECS)}; the real-data loaders are not ported "
            f"yet (ROADMAP.md)")
    spec = _SYNTH_SPECS[name]
    n, c, deg, f, powerlaw = spec[:5]
    noise = spec[5] if len(spec) > 5 else 1.0
    gen = synthetic.powerlaw_sbm if powerlaw else synthetic.sbm
    adj, labels = gen(n=n, n_classes=c, avg_degree=deg, seed=seed, **kw)
    feats = synthetic.class_features(labels, feat_dim=f, noise=noise,
                                     seed=seed)
    tr, va, te = synthetic.split_indices(labels, seed=seed)
    return GraphData(name, adj, feats, labels, tr, va, te)
