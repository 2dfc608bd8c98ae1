"""ModelNet40 / NTU2012 visual-object .mat loaders for the HGNN pipeline.

File format follows the reference's ``load_ft``
(pyhgnn/datasets/data_helper.py:5-22): a MATLAB archive with

    Y        (n, 1) labels, possibly 1-based
    indices  (n, 1) 1 = train, 0 = test
    X        cell array of per-modality feature matrices
             (X[0] = MVCNN, X[1] = GVCNN)

``load_features_and_hypergraph`` mirrors ``load_feature_construct_H``
(pyhgnn/datasets/visual_data.py:5-59): concatenate the selected modality
features, and build the KNN hypergraph incidence H from the selected
structure modalities. The port's copy of ``gcn_tpu/data/hypergraph_mat.py``.
Nothing is downloaded: a missing file raises with a pointer to the HGNN
data release.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from gcn_tpu_torch.graph.hypergraph import (construct_H_with_KNN,
                                            hyperedge_concat)

MODALITIES = ("MVCNN", "GVCNN")
_HINT = "the HGNN data release (https://github.com/iMoonLab/HGNN#datasets)"


def _require(path: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"dataset file {path!r} not found; nothing is downloaded: "
            f"fetch it from {_HINT}")
    return path


def load_ft(mat_path: str, feature_name: str = "GVCNN"):
    """-> (features f32 (n,f), labels int64 (n,), idx_train, idx_test)."""
    import scipy.io as scio

    if feature_name not in MODALITIES:
        raise ValueError(f"feature_name must be one of {MODALITIES}")
    data = scio.loadmat(_require(mat_path))
    labels = data["Y"].astype(np.int64).reshape(-1)
    if labels.min() == 1:
        labels = labels - 1
    idx = np.asarray(data["indices"]).reshape(-1)
    fts = data["X"][0][MODALITIES.index(feature_name)].astype(np.float32)
    if fts.ndim != 2:  # cell-array nesting varies across scipy versions
        fts = np.asarray(fts.item()).astype(np.float32)
    idx_train = np.flatnonzero(idx == 1).astype(np.int64)
    idx_test = np.flatnonzero(idx == 0).astype(np.int64)
    return fts, labels, idx_train, idx_test


def load_features_and_hypergraph(
    mat_path: str,
    *,
    m_prob: float = 1.0,
    k_neigs: Sequence[int] = (10,),
    is_prob_h: bool = True,
    use_mvcnn_feature: bool = False,
    use_gvcnn_feature: bool = True,
    use_mvcnn_feature_for_structure: bool = False,
    use_gvcnn_feature_for_structure: bool = True,
):
    """-> (features, labels, idx_train, idx_test, H incidence matrix)."""
    loaded = {}

    def modality(name):
        if name not in loaded:
            loaded[name] = load_ft(mat_path, feature_name=name)
        return loaded[name]

    fts = None
    if use_mvcnn_feature:
        fts = modality("MVCNN")[0]
    if use_gvcnn_feature:
        g = modality("GVCNN")[0]
        fts = g if fts is None else np.hstack([fts, g])
    if fts is None:
        raise ValueError("no feature modality selected")

    h = None
    for use, name in ((use_mvcnn_feature_for_structure, "MVCNN"),
                      (use_gvcnn_feature_for_structure, "GVCNN")):
        if use:
            for k in k_neigs:
                tmp = construct_H_with_KNN(modality(name)[0], k_neig=int(k),
                                           is_prob=is_prob_h, m_prob=m_prob)
                h = tmp if h is None else hyperedge_concat(h, tmp)
    if h is None:
        raise ValueError("no structure modality selected")

    _, labels, idx_train, idx_test = next(iter(loaded.values()))
    return fts, labels, idx_train, idx_test, h
