"""A seeded stand-in for a visual-object dataset (ModelNet40's shape): one
Gaussian centroid a class, ``n`` objects of ``f`` features, ~80% of them
for training and the rest for validation and test, as the HGNN training
script splits them.

A frozen copy of the port's ``data/synthetic.py::synthetic_visual_features``
(the numpy calls and their order unchanged, so the same seed gives the
same arrays). After them, from the same generator, a second modality's
structure columns (``mvcnn_columns`` wide, its own centroids, the same
labels): HGNN builds one group of hyperedges from each modality that its
configuration names for the structure, and this stand-in's second
modality feeds H only.
"""

from __future__ import annotations

import numpy as np


def make(*, objects, features, classes, seed, train_share=0.8,
         mvcnn_columns=64):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, objects).astype(np.int64)
    centroids = rng.standard_normal((classes, features)).astype(np.float32)
    fts = centroids[labels] + 0.6 * rng.standard_normal(
        (objects, features)).astype(np.float32)
    train = rng.random(objects) < train_share
    mv_centroids = rng.standard_normal((classes, mvcnn_columns)).astype(
        np.float32)
    mvcnn = mv_centroids[labels] + 0.6 * rng.standard_normal(
        (objects, mvcnn_columns)).astype(np.float32)
    return {"n": objects, "features": fts, "labels": labels,
            "modalities": {"mvcnn": mvcnn, "gvcnn": fts},
            "idx_train": np.flatnonzero(train),
            "idx_val": np.flatnonzero(~train)}
