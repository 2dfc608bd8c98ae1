"""The port's GAT training, driven as ``GAT.fit`` drives it.

Set-up does once what ``GAT.fit`` does on every call before its fit,
under its span ``gat.layout`` (A + I, the COO arrays, the attention's
layout with its transpose map, the features' upload), through the
model's own ``build_layout``, and keeps the results; each fit is then
the program's ``train.loop.fit_gcn(..., jit_loop=True)`` over them with
the model's own forward, as ``GAT.fit`` calls it. The cell runs no
``spmm``: the aggregation is the attention's own kernels.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.models.gat import GAT
from gcn_tpu_torch.train import capture, loop, optim

from benchmark.harness import Fit


class Program:
    def __init__(self, cfg: dict, job: dict, data: dict, device, spans):
        if cfg["dropout"]:
            raise ValueError("the GAT configuration trains without dropout")
        self.device = torch.device(device)
        n, x = data["n"], data["features"]
        c = int(data["labels"].max()) + 1
        self.lr, self.weight_decay = cfg["lr"], cfg["weight_decay"]
        self.mode = job["mode"]
        self.model = GAT(x.shape[1], c, heads=cfg["heads"],
                         hidden=cfg["hidden"], residual=cfg["residual"],
                         negative_slope=cfg["negative_slope"], lr=cfg["lr"],
                         weight_decay=cfg["weight_decay"], device=self.device)
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
        def forward(p, train):
            return self.model.forward(p, self.feats, self.layout)

        t0 = time.perf_counter()
        res = loop.fit_gcn(
            params, lambda ps: optim.adam_l2(ps, self.lr, self.weight_decay),
            forward, self.labels, self.idx_train, self.idx_val,
            train_iters=iters, mode=self.mode, jit_loop=True)
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
