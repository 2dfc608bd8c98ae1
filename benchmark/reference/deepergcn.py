"""The plain reference of DeeperGCN (Li et al., arXiv:2006.07739, sections
3.1-3.2; the ogbn-arxiv run of github.com/lightaime/deep_gcns_torch,
``examples/ogb/ogbn_arxiv/model.py`` and ``gcn_lib/sparse/torch_vertex.py::
GENConv``):

    h0   = x W_enc + b_enc
    h1   = GENConv_0(h0)
    h_{l+1} = h_l + GENConv_l(Dropout(ReLU(BN_{l-1}(h_l))))   l = 1 .. L-1
    out  = Dropout(ReLU(BN_{L-1}(h_L))) W_out + b_out
    GENConv(h)_v = (h_v + sum_{u in N(v)} alpha_vu m_u) W + b,
      m_u = ReLU(h_u) + 1e-7, alpha_vu = softmax_u(t m_u) per channel,
      computed under no_grad (the run's softmax_sg)
    BN: batch statistics (biased variance, eps 1e-5)
    log-softmax, mean NLL of the training rows, Adam.

It builds A + I itself from the raw binary graph of the benchmark's
inputs and imports nothing of the program. The running statistics are not
kept: the compared numbers are training losses, gradients and parameter
changes, which read the batch statistics only. Each row's per-channel
logsumexp is taken in edge chunks with ``scatter_reduce`` (max) and
``index_add`` (sum), and the weighted sums in edge chunks; each block runs
under ``torch.utils.checkpoint``, so that only its input outlives its
forward and 28 layers of float64 fit on the card after
``free_device_memory()``. Dense products go through ``common.matmul``, so
the ``tf32`` control rounds their operands. Dropout draws its keep masks
as the program does: 28 ``torch.rand`` of (n, hidden) a step from a
generator on the device seeded with the fit's dropout seed, in the
forward's order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.common import DTYPES, adam_steps, matmul

CHUNK = 1 << 20   # edges a chunk


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
        self.n, self.hidden = n, cfg["hidden_channels"]
        self.num_layers = cfg["num_layers"]

    def _chunks(self):
        for c in range(0, self.rows.numel(), CHUNK):
            yield self.rows[c:c + CHUNK], self.cols[c:c + CHUNK]

    def _aggregate(self, m):
        """(n, k): each row's per-channel softmax of t m over its edges,
        held constant, weighting m."""
        t, n = self.cfg["t"], self.n
        with torch.no_grad():
            top = torch.full((n, m.shape[1]), float("-inf"), dtype=m.dtype,
                             device=m.device)
            for rows, cols in self._chunks():
                top.scatter_reduce_(
                    0, rows.unsqueeze(1).expand(-1, m.shape[1]),
                    t * m[cols], "amax")
            total = torch.zeros_like(top)
            for rows, cols in self._chunks():
                total.index_add_(0, rows, torch.exp(t * m[cols] - top[rows]))
            lse = top + torch.log(total)
        out = m.new_zeros((n, m.shape[1]))
        for rows, cols in self._chunks():
            g = m[cols]
            alpha = torch.exp(t * g.detach() - lse[rows])
            out = out.index_add(0, rows, g * alpha)
        return out

    def _gen_conv(self, h, w, b):
        a = self._aggregate(torch.relu(h) + self.cfg["msg_eps"])
        return matmul(h + a, w, self.precision) + b

    def _pre_activation(self, h, scale, shift, mask):
        z = F.batch_norm(h, None, None, scale.view(-1), shift, training=True,
                         eps=self.cfg["bn_eps"])
        keep = 1.0 - self.cfg["dropout"]
        return torch.where(mask, torch.relu(z) / keep, torch.zeros_like(z))

    def _block(self, h, scale, shift, mask, w, b):
        return self._gen_conv(self._pre_activation(h, scale, shift, mask),
                              w, b)

    def loss(self, params, masks):
        """The training loss of the leaves ``params`` (enc W, b, conv0,
        then norm<l-1> and conv<l> a block, norm<L-1>, out) with the
        step's keep masks."""
        it, prec = iter(params), self.precision
        w, b = next(it), next(it)
        h = matmul(self.x, w, prec) + b
        w, b = next(it), next(it)
        h = checkpoint(self._gen_conv, h, w, b, use_reentrant=False)
        for l in range(1, self.num_layers):
            scale, shift, w, b = (next(it) for _ in range(4))
            h = h + checkpoint(self._block, h, scale, shift, masks[l - 1], w,
                               b, use_reentrant=False)
        scale, shift, w, b = (next(it) for _ in range(4))
        z = self._pre_activation(h, scale, shift, masks[-1])
        lp = torch.log_softmax(matmul(z, w, prec) + b, dim=1)
        idx = self.idx_train
        return -lp[idx, self.labels[idx]].mean()

    def _masks(self, dropout_seed: int, n_steps: int):
        keep = 1.0 - self.cfg["dropout"]
        gen = torch.Generator(device=self.device).manual_seed(dropout_seed)
        for _ in range(n_steps):
            yield [torch.rand((self.n, self.hidden), generator=gen,
                              device=self.device) < keep
                   for _ in range(self.num_layers)]

    def steps(self, p0, dropout_seed: int, n_steps: int, perm=None, at=()):
        """The first ``n_steps`` steps of a fit from the leaves ``p0`` (the
        program's order) with the dropout stream of ``dropout_seed``; the
        graph keeps its own vertex order (``perm`` is None); the
        parameters are kept after each step count in ``at``."""
        if perm is not None:
            raise ValueError("the DeeperGCN cell trains in the graph's own "
                             "order")
        cfg = self.cfg
        p0 = [p.to(device=self.device, dtype=DTYPES[self.precision])
              for p in p0]
        return adam_steps(self.loss, p0, self._masks(dropout_seed, n_steps),
                          lrs=[cfg["lr"]] * n_steps,
                          weight_decay=cfg["weight_decay"],
                          betas=cfg["adam_betas"], eps=cfg["adam_eps"],
                          at=at)
