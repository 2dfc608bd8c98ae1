"""The plain reference of HGNN (Feng et al., arXiv:1809.09401; pyhgnn's
hypergraph utilities, HGNN_conv and training recipe).

    H[v, e] = exp(-d(v, c_e)^2 / (m * mean_u d(u, c_e))^2)  for the k
              objects v nearest to the centre c_e of hyperedge e (itself
              included), by Euclidean distance over the structure columns;
              one group of hyperedges a structure modality
    G       = Dv^-1/2 H De^-1 H^T Dv^-1/2
    h       = dropout(relu(G (X W1 + b1)))
    out     = G (h W2 + b2)
    loss    = mean cross-entropy of the training rows

and Adam with L2 decay under MultiStepLR. It builds H and G itself, in
float64, from the benchmark's features, and imports nothing of the
program.
"""

from __future__ import annotations

import bisect

import torch

from benchmark.reference.common import (DTYPES, SparseOperator, adam_steps,
                                        dropout_masks, matmul)


def knn_incidence(x: torch.Tensor, k: int, m_prob: float,
                  is_prob: bool) -> torch.Tensor:
    """H (n, n) of the KNN hyperedges of the rows of ``x`` (float64), one a
    row as centre: distances symmetrised with max(d, d^T), the centre
    forced in if k exact duplicates crowd it out."""
    sq = (x * x).sum(1)
    d = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min_(0).sqrt_()
    d = torch.maximum(d, d.T)
    d.fill_diagonal_(0.0)
    avg = d.mean(1)
    n = x.shape[0]
    neigh = torch.topk(d, k, dim=1, largest=False).indices
    centres = torch.arange(n, device=x.device)
    missing = ~(neigh == centres[:, None]).any(1)
    if missing.any():
        rows = missing.nonzero()[:, 0]
        far = d[rows[:, None], neigh[rows]].argmax(1)
        neigh[rows, far] = rows
    dist = torch.gather(d, 1, neigh)
    if is_prob:
        w = torch.exp(-dist ** 2 / ((m_prob * avg[:, None]) ** 2))
    else:
        w = torch.ones_like(dist)
    h = torch.zeros(n, n, dtype=x.dtype, device=x.device)
    h[neigh, centres[:, None].expand_as(neigh)] = w
    return h


def operator_g(h: torch.Tensor) -> torch.Tensor:
    """G = Dv^-1/2 H De^-1 H^T Dv^-1/2 with unit hyperedge weights."""
    dv = h.sum(1)
    de = h.sum(0)
    inv_sqrt_dv = torch.where(dv > 0, dv.rsqrt(), torch.zeros_like(dv))
    inv_de = torch.where(de > 0, 1.0 / de, torch.zeros_like(de))
    left = h * inv_sqrt_dv[:, None]
    return (left * inv_de[None, :]) @ left.T


class Problem:
    def __init__(self, cfg: dict, data: dict, device, precision: str):
        self.cfg, self.precision = cfg, precision
        self.device = torch.device(device)
        dtype = DTYPES[precision]
        fts = torch.as_tensor(data["features"], device=self.device)
        cols = cfg["structure_columns"]
        h = torch.cat([
            knn_incidence(torch.as_tensor(
                data["modalities"][mod][:, :cols], device=self.device,
                dtype=torch.float64), k, cfg["m_prob"], cfg["is_probH"])
            for mod in ("mvcnn", "gvcnn")
            if cfg[f"use_{mod}_feature_for_structure"]
            for k in cfg["K_neigs"]], dim=1)
        g = operator_g(h)
        del h
        rows, cols = g.nonzero(as_tuple=True)
        vals = g[rows, cols]
        del g
        n = data["n"]
        self.g = SparseOperator(rows.cpu(), cols.cpu(), vals.cpu(), (n, n),
                                self.device, dtype)
        self.x = fts.to(dtype)
        self.labels = torch.as_tensor(data["labels"], device=self.device)
        self.idx_train = torch.as_tensor(data["idx_train"],
                                         device=self.device)
        self.n, self.hidden = n, cfg["n_hid"]

    def loss(self, params, keep_mask):
        w1, b1, w2, b2 = params
        keep = 1.0 - self.cfg["drop_out"]
        h = torch.relu(self.g(matmul(self.x, w1, self.precision) + b1))
        h = torch.where(keep_mask, h / keep, torch.zeros_like(h))
        out = self.g(matmul(h, w2, self.precision) + b2)
        idx = self.idx_train
        lp = torch.log_softmax(out[idx], dim=1)
        return -lp.gather(1, self.labels[idx][:, None]).mean()

    def lr_at(self, epoch: int) -> float:
        """MultiStepLR: lr times gamma for each milestone passed."""
        cfg = self.cfg
        return cfg["lr"] * cfg["gamma"] ** bisect.bisect_right(
            sorted(cfg["milestones"]), epoch)

    def steps(self, p0, dropout_seed: int, n_steps: int, perm=None, at=()):
        cfg = self.cfg
        masks = dropout_masks(dropout_seed, (self.n, self.hidden), n_steps,
                              1.0 - cfg["drop_out"], self.device, perm)
        p0 = [p.to(device=self.device, dtype=DTYPES[self.precision])
              for p in p0]
        return adam_steps(self.loss, p0, masks,
                          lrs=[self.lr_at(e) for e in range(n_steps)],
                          weight_decay=cfg["weight_decay"],
                          betas=cfg["adam_betas"], eps=cfg["adam_eps"],
                          at=at)
