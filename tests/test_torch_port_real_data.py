"""The port on the real datasets, gated on their files: the counterpart of
``tests/test_real_data.py`` (same files, shapes and accuracy floors).

The files are not in the repository and nothing is downloaded: each test
skips unless its files are under ``$GCN_TPU_DATA`` (default
``~/gcn_data``). The port runs on the card when there is one, else on the
CPU. This file imports neither jax nor gcn_tpu, so it runs where only the
port's dependencies are (``gcn_tpu_torch/run_sweep.sh`` runs it with
``--noconftest``).
"""

import os

import numpy as np
import pytest

ROOT = os.environ.get("GCN_TPU_DATA", os.path.expanduser("~/gcn_data"))


def _have(*names):
    return all(os.path.exists(os.path.join(ROOT, n)) for n in names)


def _device():
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


_PUBMED_FILES = [f"ind.pubmed.{p}" for p in
                 ("x", "y", "tx", "ty", "allx", "ally", "graph",
                  "test.index")]

# name -> (gate files, (n, nfeat, nclass), min test accuracy)
_PLANETOID = {
    "cora": (["cora.npz"], (2708, 1433, 7), 0.78),
    "citeseer": (["citeseer.npz"], (3327, 3703, 6), 0.66),
    "pubmed": (_PUBMED_FILES, (19717, 500, 3), 0.75),
}


@pytest.mark.parametrize("name", sorted(_PLANETOID))
def test_planetoid_accuracy_parity(name):
    files, (n, f, c), min_acc = _PLANETOID[name]
    if not _have(*files):
        pytest.skip(f"{name} files not provisioned under {ROOT}")
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.models import GCN

    data = get_dataset(name, root=ROOT, setting="gcn", seed=15)
    assert data.num_nodes == n and data.num_features == f
    assert data.num_classes == c
    accs = {}
    for variant in ("v1", "v6"):
        m = GCN(data.num_features, 16, data.num_classes, variant=variant,
                seed=15, device=_device())
        m.fit(data.features, data.adj, data.labels, data.idx_train,
              data.idx_val, train_iters=200, mode="val")
        accs[variant] = m.test(data.idx_test, verbose=False)
    assert accs["v1"] >= min_acc, f"{name} v1 accuracy {accs['v1']:.3f}"
    # the reorder/tile pipeline must not change what the model learns
    assert abs(accs["v6"] - accs["v1"]) < 0.03, accs


_SAINT_SHAPES = {
    "flickr": (89250, 500),
    "reddit": (232965, 602),
    "ppi": (14755, 50),
    "yelp": (716847, 300),
    "amazon": (1598960, 200),
}


@pytest.mark.parametrize("name", sorted(_SAINT_SHAPES))
def test_graphsaint_loads_and_trains(name):
    d = os.path.join(ROOT, name)
    needed = ["adj_full.npz", "adj_train.npz", "feats.npy",
              "class_map.json", "role.json"]
    if not all(os.path.exists(os.path.join(d, p)) for p in needed):
        pytest.skip(f"{name} GraphSAINT files not provisioned under {d}")
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.models import GCN

    data = get_dataset(name, root=ROOT)
    n, f = _SAINT_SHAPES[name]
    assert data.num_nodes == n and data.num_features == f
    m = GCN(data.num_features, 4, data.num_classes,
            variant="v6" if n < 300_000 else "v4", seed=15,
            device=_device())
    m.fit(data.features, data.adj, data.labels, data.idx_train,
          train_iters=5)
    losses = [h["loss_train"] for h in m.history]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


_HGNN_MATS = {
    "ModelNet40_mvcnn_gvcnn.mat": 0.90,
    "NTU2012_mvcnn_gvcnn.mat": 0.75,
}


@pytest.mark.parametrize("mat", sorted(_HGNN_MATS))
def test_hgnn_mat_accuracy_parity(mat):
    path = os.path.join(ROOT, mat)
    if not os.path.exists(path):
        pytest.skip(f"{mat} not provisioned under {ROOT}")
    from gcn_tpu_torch.data.hypergraph_mat import load_features_and_hypergraph
    from gcn_tpu_torch.graph.hypergraph import generate_G_from_H
    from gcn_tpu_torch.models.hgnn import HGNN

    fts, labels, idx_train, idx_test, h = load_features_and_hypergraph(
        path, k_neigs=(10,), use_mvcnn_feature=False,
        use_gvcnn_feature=True, use_mvcnn_feature_for_structure=True,
        use_gvcnn_feature_for_structure=True)
    g = generate_G_from_H(h)
    model = HGNN(in_ch=fts.shape[1], n_class=int(labels.max()) + 1,
                 n_hid=128, dropout=0.5, seed=15, device=_device())
    model.fit(fts, g, labels, idx_train, idx_val=idx_test, num_epochs=600)
    acc = model.test(idx_test, verbose=False)
    assert acc >= _HGNN_MATS[mat], f"{mat} accuracy {acc:.3f}"
