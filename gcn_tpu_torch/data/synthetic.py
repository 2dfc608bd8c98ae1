"""Seeded synthetic graph generators (numpy).

The port's copy of the ``gcn_tpu.data.synthetic`` generators that the
``synth-*`` datasets use. The numpy calls and their order are unchanged, so
the same seed gives bit-identical graphs, features and splits.

  * ``sbm``          — planted-partition stochastic block model.
  * ``powerlaw_sbm`` — degree-corrected SBM with Pareto degree weights.
  * ``synthetic_visual_features`` — the HGNN stand-in for the
    ModelNet40/NTU2012 visual features (examples/train_hgnn.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gcn_tpu_torch.graph.csr import CSRGraph, coo_to_csr


def _shuffle(rng, n, src, dst, labels):
    """Hide the planted order so reordering has work to do."""
    pi = rng.permutation(n)
    new_labels = np.empty(n, dtype=np.int64)
    new_labels[pi] = labels
    return pi[src], pi[dst], new_labels


def sbm(n: int = 1000, n_classes: int = 5, avg_degree: float = 10.0,
        p_in_frac: float = 0.8, seed: int = 0,
        shuffle: bool = True) -> Tuple[CSRGraph, np.ndarray]:
    """Planted-partition graph. Returns (symmetric binary adj, labels)."""
    rng = np.random.default_rng(seed)
    sizes = np.full(n_classes, n // n_classes)
    sizes[: n % n_classes] += 1
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    labels = np.repeat(np.arange(n_classes), sizes)

    total_edges = int(n * avg_degree / 2)
    m_in = int(total_edges * p_in_frac)
    m_out = total_edges - m_in

    srcs, dsts = [], []
    for c in range(n_classes):
        mc = int(round(m_in * sizes[c] / n))
        srcs.append(rng.integers(0, sizes[c], size=mc) + offsets[c])
        dsts.append(rng.integers(0, sizes[c], size=mc) + offsets[c])
    if n_classes > 1 and m_out > 0:
        ci = rng.integers(0, n_classes, size=m_out)
        shift = rng.integers(1, n_classes, size=m_out)
        cj = (ci + shift) % n_classes
        srcs.append(rng.integers(0, sizes[ci]) + offsets[ci])
        dsts.append(rng.integers(0, sizes[cj]) + offsets[cj])
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    if shuffle:
        src, dst, labels = _shuffle(rng, n, src, dst, labels)
    g = coo_to_csr(src, dst, None, (n, n)).symmetrize(binarize=True)
    return g, labels.astype(np.int64)


def powerlaw_sbm(n: int = 10000, n_classes: int = 10,
                 avg_degree: float = 13.0, p_in_frac: float = 0.7,
                 alpha: float = 2.2, seed: int = 0,
                 shuffle: bool = True) -> Tuple[CSRGraph, np.ndarray]:
    """Degree-corrected SBM: Chung-Lu degree weights w_i ~ Zipf(alpha)."""
    rng = np.random.default_rng(seed)
    sizes = np.full(n_classes, n // n_classes)
    sizes[: n % n_classes] += 1
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    labels = np.repeat(np.arange(n_classes), sizes)

    w = (1.0 - rng.random(n)) ** (-1.0 / (alpha - 1.0))  # Pareto tail
    w = np.minimum(w, np.sqrt(n))  # cap hubs
    total_edges = int(n * avg_degree / 2)

    def sample_block(lo, hi, m):
        if m <= 0:
            return (np.empty(0, np.int64),) * 2
        pb = w[lo:hi] / w[lo:hi].sum()
        s = rng.choice(hi - lo, size=m, p=pb) + lo
        d = rng.choice(hi - lo, size=m, p=pb) + lo
        return s, d

    srcs, dsts = [], []
    m_in = int(total_edges * p_in_frac)
    for c in range(n_classes):
        mc = int(round(m_in * sizes[c] / n))
        s, d = sample_block(offsets[c], offsets[c + 1], mc)
        srcs.append(s)
        dsts.append(d)
    m_out = total_edges - m_in
    if n_classes > 1 and m_out > 0:
        p = w / w.sum()
        srcs.append(rng.choice(n, size=m_out, p=p))
        dsts.append(rng.choice(n, size=m_out, p=p))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if shuffle:
        src, dst, labels = _shuffle(rng, n, src, dst, labels)
    g = coo_to_csr(src, dst, None, (n, n)).symmetrize(binarize=True)
    return g, labels.astype(np.int64)


def class_features(labels: np.ndarray, feat_dim: int = 64,
                   noise: float = 1.0, seed: int = 0) -> np.ndarray:
    """Dense features = class centroid + N(0, noise)."""
    rng = np.random.default_rng(seed + 17)
    n_classes = int(labels.max()) + 1
    centroids = rng.normal(size=(n_classes, feat_dim))
    x = centroids[labels] + noise * rng.normal(size=(labels.shape[0],
                                                     feat_dim))
    return x.astype(np.float32)


def split_indices(labels: np.ndarray, per_class_train: int = 20,
                  n_val: int = 500, n_test: int = 1000, seed: int = 0):
    """Planetoid-style split: N per class train, then val/test pools."""
    rng = np.random.default_rng(seed + 31)
    n = labels.shape[0]
    idx = rng.permutation(n)
    train, rest = [], []
    count = np.zeros(int(labels.max()) + 1, dtype=int)
    for i in idx:
        c = labels[i]
        if count[c] < per_class_train:
            train.append(i)
            count[c] += 1
        else:
            rest.append(i)
    rest = np.array(rest)
    n_val = min(n_val, max(len(rest) - 1, 0))
    n_test = min(n_test, max(len(rest) - n_val, 0))
    return (np.array(train, dtype=np.int64),
            rest[:n_val].astype(np.int64),
            rest[n_val:n_val + n_test].astype(np.int64))


def synthetic_visual_features(n: int = 800, f: int = 2048,
                              classes: int = 40, seed: int = 0):
    """A feature cloud shaped like the HGNN visual-object datasets: ``n``
    objects of ``f`` features around one Gaussian centroid a class, ~80%
    of them train. -> (features f32 (n, f), labels int64 (n,), idx_train,
    idx_test); the same numpy calls as examples/train_hgnn.py, so equal
    arrays for a seed."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n).astype(np.int64)
    centroids = rng.standard_normal((classes, f)).astype(np.float32)
    fts = centroids[labels] + 0.6 * rng.standard_normal((n, f)).astype(
        np.float32)
    idx = rng.random(n) < 0.8
    return fts, labels, np.flatnonzero(idx), np.flatnonzero(~idx)
