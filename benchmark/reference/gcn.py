"""The plain reference of the two-layer GCN (Kipf and Welling,
arXiv:1609.02907; pygcn's GraphConvolution and training recipe).

    A-hat = D^-1/2 (A + I) D^-1/2      (D: the degrees of A + I)
    h     = dropout(relu(A-hat X W1 + b1))
    out   = log_softmax(A-hat (h W2) + b2)
    loss  = mean NLL of the training rows

and Adam with L2 decay. It builds A-hat itself from the raw binary graph
of the benchmark's inputs, works in the caller's vertex order, and imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import (DTYPES, SparseOperator, adam_steps,
                                        dropout_masks, matmul)


class Problem:
    """One configuration's training problem on ``device`` in
    ``precision``."""

    def __init__(self, cfg: dict, data: dict, device, precision: str):
        self.cfg, self.precision = cfg, precision
        self.device = torch.device(device)
        dtype = DTYPES[precision]
        n = data["n"]
        indptr = np.asarray(data["indptr"], dtype=np.int64)
        cols = np.asarray(data["indices"], dtype=np.int64)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        if (rows == cols).any():
            raise ValueError("the raw graph carries self loops")
        loops = np.arange(n, dtype=np.int64)
        rows = np.concatenate([rows, loops])
        cols = np.concatenate([cols, loops])
        deg = np.bincount(rows, minlength=n).astype(np.float64)
        d = deg ** -0.5
        self.a_hat = SparseOperator(rows, cols, d[rows] * d[cols], (n, n),
                                    self.device, dtype)
        x = torch.as_tensor(data["features"], device=self.device,
                            dtype=dtype)
        with torch.no_grad():
            self.ax = self.a_hat(x)     # A-hat X, constant over training
        self.labels = torch.as_tensor(data["labels"], device=self.device)
        self.idx_train = torch.as_tensor(data["idx_train"],
                                         device=self.device)
        self.n, self.hidden = n, cfg["hidden_channels"]

    def loss(self, params, keep_mask):
        w1, b1, w2, b2 = params
        keep = 1.0 - self.cfg["dropout"]
        h = torch.relu(matmul(self.ax, w1, self.precision) + b1)
        h = torch.where(keep_mask, h / keep, torch.zeros_like(h))
        out = self.a_hat(matmul(h, w2, self.precision)) + b2
        lp = torch.log_softmax(out, dim=1)
        idx = self.idx_train
        return -lp[idx, self.labels[idx]].mean()

    def steps(self, p0, dropout_seed: int, n_steps: int, perm=None, at=()):
        """The first ``n_steps`` steps of a fit from the leaves ``p0`` (W1,
        b1, W2, b2) with the dropout stream of ``dropout_seed``; ``perm``
        places the stream's rows on vertices (the program's row order);
        the parameters are kept after each step count in ``at``."""
        cfg = self.cfg
        masks = dropout_masks(dropout_seed, (self.n, self.hidden), n_steps,
                              1.0 - cfg["dropout"], self.device, perm)
        p0 = [p.to(device=self.device, dtype=DTYPES[self.precision])
              for p in p0]
        return adam_steps(self.loss, p0, masks, lrs=[cfg["lr"]] * n_steps,
                          weight_decay=cfg["weight_decay"],
                          betas=cfg["adam_betas"], eps=cfg["adam_eps"],
                          at=at)
