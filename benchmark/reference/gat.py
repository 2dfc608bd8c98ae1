"""The plain reference of the GAT (Velickovic et al., arXiv:1710.10903,
section 2.1; github.com/PetarV-/GAT ``utils/layers.py::attn_head`` and
``models/gat.py::inference``):

    per layer l and head k:
      Wh    = h W^k                       (W: the columns of gat<l>.w)
      e_ij  = LeakyReLU_slope(a_dst^k . Wh_i + b_dst + a_src^k . Wh_j + b_src)
      alpha = softmax_j e_ij over j in N(i) + {i}
      out_i = sum_j alpha_ij Wh_j + b^k
    layers but the last: heads concatenated, plus the skip h W_res + b_res
    where the configuration has one, then ELU; the last: heads averaged;
    log-softmax, mean NLL of the training rows, Adam without decay.

It builds A + I itself from the raw binary graph of the benchmark's
inputs and imports nothing of the program. Each row's softmax is taken
over its edges with ``scatter_reduce`` (max) and ``index_add`` (sum); the
weighted sums are taken per head and in edge chunks, each chunk under
``torch.utils.checkpoint`` so that no E x F array outlives it, and fit on
the card after ``free_device_memory()``. Dense products go through
``common.matmul``, so the ``tf32`` control rounds their operands.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.common import DTYPES, adam_steps, matmul

CHUNK = 1 << 20   # edges a chunk of the weighted sums


def _aggregate(wh_h, alpha_h, rows, cols, n: int):
    """sum over the chunk's edges of alpha[e] * wh_h[cols[e]] into
    rows[e]: (n, F)."""
    out = wh_h.new_zeros((n, wh_h.shape[1]))
    return out.index_add(0, rows, wh_h[cols] * alpha_h.unsqueeze(1))


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
        self.rows = torch.as_tensor(np.concatenate([rows, loops]),
                                    device=self.device)
        self.cols = torch.as_tensor(np.concatenate([cols, loops]),
                                    device=self.device)
        self.x = torch.as_tensor(data["features"], device=self.device,
                                 dtype=dtype)
        self.labels = torch.as_tensor(data["labels"], device=self.device)
        self.idx_train = torch.as_tensor(data["idx_train"],
                                         device=self.device)
        self.n = n

    def _attention(self, wh, el, er):
        """(n, H, F): each row's softmax over its edges, per head."""
        rows, cols, n = self.rows, self.cols, self.n
        heads = wh.shape[1]
        e = torch.nn.functional.leaky_relu(er[rows] + el[cols],
                                           self.cfg["negative_slope"])
        top = torch.full((n, heads), float("-inf"), dtype=e.dtype,
                         device=e.device).scatter_reduce(
            0, rows.unsqueeze(1).expand(-1, heads), e.detach(), "amax")
        p = torch.exp(e - top[rows])
        alpha = p / torch.zeros_like(top).index_add(0, rows, p)[rows]
        out = []
        for k in range(heads):
            acc = 0
            for c in range(0, rows.numel(), CHUNK):
                acc = acc + checkpoint(
                    _aggregate, wh[:, k], alpha[c:c + CHUNK, k],
                    rows[c:c + CHUNK], cols[c:c + CHUNK], n,
                    use_reentrant=False)
            out.append(acc)
        return torch.stack(out, dim=1)

    def loss(self, params, keep_mask=None):
        cfg, prec = self.cfg, self.precision
        heads, residual = cfg["heads"], cfg["residual"]
        it, h, last = iter(params), self.x, len(heads)
        for l, (n_heads, res) in enumerate(zip(heads, residual), start=1):
            if l < last:
                w, b, aw, ab = (next(it) for _ in range(4))
                rw, rb = (next(it), next(it)) if res else (None, None)
            else:
                aw, ab = next(it), next(it)
                rw, rb = (next(it), next(it)) if res else (None, None)
                w, b = next(it), next(it)
            wh = matmul(h, w, prec).view(h.shape[0], n_heads, -1)
            el = torch.cat([matmul(wh[:, k], aw[:, k:k + 1], prec)
                            for k in range(n_heads)], dim=1) + ab[:n_heads]
            er = torch.cat([matmul(wh[:, k], aw[:, n_heads + k:n_heads + k
                                                + 1], prec)
                            for k in range(n_heads)], dim=1) + ab[n_heads:]
            out = self._attention(wh, el, er) + b.view(n_heads, -1)
            if res:
                out = out + (matmul(h, rw, prec) + rb).view(out.shape)
            h = (out.mean(dim=1) if l == last
                 else torch.nn.functional.elu(out.reshape(h.shape[0], -1)))
        lp = torch.log_softmax(h, dim=1)
        idx = self.idx_train
        return -lp[idx, self.labels[idx]].mean()

    def steps(self, p0, dropout_seed: int, n_steps: int, perm=None, at=()):
        """The first ``n_steps`` steps of a fit from the leaves ``p0`` (the
        program's order: gat1 W and b, att1, gat2, att2, res2, att3, gat3);
        the configuration has no dropout, so ``dropout_seed`` draws
        nothing, and the graph keeps its own vertex order (``perm`` is
        None); the parameters are kept after each step count in ``at``."""
        if perm is not None:
            raise ValueError("the GAT cell trains in the graph's own order")
        cfg = self.cfg
        p0 = [p.to(device=self.device, dtype=DTYPES[self.precision])
              for p in p0]
        return adam_steps(self.loss, p0, [None] * n_steps,
                          lrs=[cfg["lr"]] * n_steps,
                          weight_decay=cfg["weight_decay"],
                          betas=cfg["adam_betas"], eps=cfg["adam_eps"],
                          at=at)
