"""The port's DeeperGCN training, driven as ``DeeperGCN.fit`` drives it.

Set-up does once what ``DeeperGCN.fit`` does on every call before its
fit, under its span ``deepergcn.layout`` (A + I, the COO arrays, GAT's
layout with its transpose, the features' upload), through the model's
own ``build_layout``, and keeps the results; each fit is then the
program's ``train.loop.fit_gcn(..., jit_loop=True)`` over them with the
model's own forward, fresh running statistics as its ``buffers`` and the
dropout generator registered, as ``DeeperGCN.fit`` calls it. The cell
runs no ``spmm``: the aggregation is the softmax aggregation's own
kernels.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.models import layers
from gcn_tpu_torch.models.deepergcn import DeeperGCN
from gcn_tpu_torch.train import capture, loop, optim

from benchmark.harness import Fit


class Program:
    def __init__(self, cfg: dict, job: dict, data: dict, device, spans):
        fixed = (layers.BN_MOMENTUM, layers.BN_EPS, layers.MSG_EPS)
        if (cfg["bn_momentum"], cfg["bn_eps"], cfg["msg_eps"]) != fixed:
            raise ValueError("the port's batch norm and GENConv take the "
                             "run's (momentum, eps, message eps) = "
                             f"{fixed}")
        self.device = torch.device(device)
        n, x = data["n"], data["features"]
        c = int(data["labels"].max()) + 1
        self.lr, self.weight_decay = cfg["lr"], cfg["weight_decay"]
        self.mode = job["mode"]
        self.model = DeeperGCN(x.shape[1], c, num_layers=cfg["num_layers"],
                               hidden=cfg["hidden_channels"], t=cfg["t"],
                               dropout=cfg["dropout"], lr=cfg["lr"],
                               weight_decay=cfg["weight_decay"],
                               device=self.device)
        self.layers = self.model.layers
        with spans("self_loops_layout_upload", self.device):
            self.layout = self.model.build_layout(CSRGraph(
                data["indptr"], data["indices"],
                np.ones(len(data["indices"]), np.float32), (n, n)))
        with spans("upload", self.device):
            self.feats = torch.as_tensor(x, dtype=torch.float32,
                                         device=self.device)
            self.labels = torch.as_tensor(data["labels"], dtype=torch.int64,
                                          device=self.device)
            self.idx_train, self.idx_val = (
                torch.as_tensor(np.asarray(data[k]), dtype=torch.int64,
                                device=self.device)
                for k in ("idx_train", "idx_val"))
        self.perm, self.adj, self.spmm_widths = None, None, []
        self.n, self.nnz = n, self.layout.nnz   # edges with self loops

    def fit(self, params: dict, dropout_seed: int, iters: int) -> Fit:
        gen = torch.Generator(device=self.device).manual_seed(dropout_seed)
        buffers = self.model.init_buffers()

        def forward(p, train):
            return self.model.forward(p, buffers, self.feats, self.layout,
                                      train, gen)

        t0 = time.perf_counter()
        res = loop.fit_gcn(
            params, lambda ps: optim.adam_l2(ps, self.lr, self.weight_decay),
            forward, self.labels, self.idx_train, self.idx_val,
            train_iters=iters, mode=self.mode, generator=gen, jit_loop=True,
            buffers=buffers)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        # replays: the step timer holds the intervals after fit_gcn's WARMUP
        # iterations; the replays before them are taken at the median
        steps = res.timers("step").d.samples
        replayed = max(iters - capture.WARMUP, 0)
        replay_ms = (sum(steps) + statistics.median(steps)
                     * max(replayed - len(steps), 0)) if steps else 0.0
        state = res.opt_state or {}
        return Fit(iters=iters,
                   losses=[h["loss_train"] for h in res.history],
                   wall_s=wall, replay_s=replay_ms / 1e3,
                   loop_s=res.timers("fit_scan").d.samples[-1] / 1e3,
                   exp_avg=[state[i]["exp_avg"] if i in state else None
                            for i in range(2 * len(self.layers))],
                   final=[t.detach() for layer in res.final_params.values()
                          for t in layer.values()])
