"""A seeded stand-in for a citation graph: a degree-corrected stochastic
block model with class-centroid features and a planetoid-style split.

A frozen copy of the port's ``data/synthetic.py`` generators
(``powerlaw_sbm``, ``class_features``, ``split_indices``), which the
``synth-*`` datasets use: the same numpy calls in the same order, so a
seed gives the same graph, features and split as the port's
``get_dataset("synth-arxiv", seed=0)``. The benchmark keeps its own copy so
that a change to the program's generators cannot change what it measures.

``make`` returns plain arrays: the graph as a binary, symmetric CSR with
no self loops and sorted columns (``indptr`` int64, ``indices`` int64),
``features`` float32 (n, f), ``labels`` int64 and the three index sets.
"""

from __future__ import annotations

import numpy as np


def _edges(n, n_classes, avg_degree, p_in_frac, alpha, rng):
    """``powerlaw_sbm``'s (src, dst) and labels before the shuffle."""
    sizes = np.full(n_classes, n // n_classes)
    sizes[: n % n_classes] += 1
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    labels = np.repeat(np.arange(n_classes), sizes)

    w = (1.0 - rng.random(n)) ** (-1.0 / (alpha - 1.0))  # Pareto tail
    w = np.minimum(w, np.sqrt(n))                        # cap hubs
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
    return src[keep], dst[keep], labels


def symmetric_csr(src, dst, n):
    """A + A^T, binarized, diagonal removed, as (indptr, indices) with each
    row's columns ascending."""
    rows = np.concatenate([src, dst]).astype(np.int64)
    cols = np.concatenate([dst, src]).astype(np.int64)
    keep = rows != cols
    key = np.unique(rows[keep] * n + cols[keep])
    rows, cols = key // n, key % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols


def class_features(labels, feat_dim, noise, seed):
    """Class centroid + N(0, noise) a row."""
    rng = np.random.default_rng(seed + 17)
    n_classes = int(labels.max()) + 1
    centroids = rng.normal(size=(n_classes, feat_dim))
    x = centroids[labels] + noise * rng.normal(size=(labels.shape[0],
                                                     feat_dim))
    return x.astype(np.float32)


def split_indices(labels, per_class_train, n_val, n_test, seed):
    """``per_class_train`` rows a class for training, then the val and
    test pools, in a seeded order."""
    rng = np.random.default_rng(seed + 31)
    idx = rng.permutation(labels.shape[0])
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


def make(*, nodes, classes, avg_degree, features, seed, p_in_frac=0.7,
         alpha=2.2, noise=1.0, per_class_train=20, n_val=500, n_test=1000):
    rng = np.random.default_rng(seed)
    src, dst, labels = _edges(nodes, classes, avg_degree, p_in_frac, alpha,
                              rng)
    # hide the planted order, as the port's generator does
    pi = rng.permutation(nodes)
    shuffled = np.empty(nodes, dtype=np.int64)
    shuffled[pi] = labels
    src, dst, labels = pi[src], pi[dst], shuffled
    indptr, indices = symmetric_csr(src, dst, nodes)
    x = class_features(labels, features, noise, seed)
    idx_train, idx_val, idx_test = split_indices(
        labels, per_class_train, n_val, n_test, seed)
    return {"n": nodes, "indptr": indptr, "indices": indices,
            "features": x, "labels": labels, "idx_train": idx_train,
            "idx_val": idx_val, "idx_test": idx_test}
