"""The port's GCN training, driven as ``GCN.fit`` drives it.

Set-up does once what ``GCN.fit`` does on every call (normalize, the
variant's reorder and layout, upload, the layer-1 hoist) through the
program's own functions and its ``GCN`` object's choices (orders, k_pad,
the adjacency kind), and keeps the results; each fit is then the program's
``train.loop.fit_gcn(..., jit_loop=True)`` over them, as ``GCN.fit`` calls
it.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.models.gcn import GCN
from gcn_tpu_torch.models.gcn_core import gcn_forward
from gcn_tpu_torch.ops.permute import inverse_permutation
from gcn_tpu_torch.ops.spmm import hoist_spmm
from gcn_tpu_torch.train import capture, loop, optim

from benchmark.harness import Fit


class Program:
    def __init__(self, cfg: dict, job: dict, data: dict, device, spans):
        self.device = torch.device(device)
        n, x = data["n"], data["features"]
        f, c = x.shape[1], int(data["labels"].max()) + 1
        h = cfg["hidden_channels"]
        self.lr, self.weight_decay = cfg["lr"], cfg["weight_decay"]
        self.dropout, self.mode = cfg["dropout"], job["mode"]
        self.layers = [("gc1", f, h), ("gc2", h, c)]
        model = GCN(f, h, c, dropout=cfg["dropout"], lr=cfg["lr"],
                    weight_decay=cfg["weight_decay"],
                    variant=job["variant"], device=self.device)
        if model.hoist_ax != cfg["hoist_layer1"]:
            raise ValueError(f"variant {job['variant']} does not hoist "
                             f"layer 1 as the configuration states")
        self.orders = model._orders()
        with spans("normalize"):
            g = gcn_normalize(CSRGraph(
                data["indptr"], data["indices"],
                np.ones(len(data["indices"]), np.float32), (n, n)))
        with spans("reorder_tile_upload", self.device):
            self.adj, perm = model._build_adjacency(g)
        self.perm = perm
        with spans("upload", self.device):
            labels = data["labels"]
            if perm is not None:
                inv = inverse_permutation(perm)
                x, labels = x[perm], labels[perm]
            else:
                inv = None

            def idx(a):
                a = np.asarray(a) if inv is None else inv[np.asarray(a)]
                return torch.as_tensor(a, dtype=torch.int64,
                                       device=self.device)

            feats = torch.as_tensor(x, dtype=torch.float32,
                                    device=self.device)
            self.labels = torch.as_tensor(labels, dtype=torch.int64,
                                          device=self.device)
            self.idx_train, self.idx_val = (idx(data["idx_train"]),
                                            idx(data["idx_val"]))
        with spans("hoist", self.device):
            self.feats = hoist_spmm(self.adj, feats)
        self.nnz = len(data["indices"]) + n       # A-hat = A + I, scaled
        self.n = n
        # the widths at which the step runs the SpMM (forward and transpose)
        self.spmm_widths = sorted(
            {n_out if order == "a_xw" else n_in
             for order, (_, n_in, n_out) in zip(self.orders, self.layers)
             if order in ("a_xw", "ax_w")})

    def fit(self, params: dict, dropout_seed: int, iters: int) -> Fit:
        gen = torch.Generator(device=self.device).manual_seed(dropout_seed)

        def forward(p, train):
            return gcn_forward(p, self.feats, self.adj, self.adj,
                               orders=self.orders,
                               dropout_rate=self.dropout, with_relu=True,
                               train=train, generator=gen)

        t0 = time.perf_counter()
        res = loop.fit_gcn(
            params, lambda ps: optim.adam_l2(ps, self.lr, self.weight_decay),
            forward, self.labels, self.idx_train, self.idx_val,
            train_iters=iters, mode=self.mode, generator=gen, jit_loop=True)
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
                            for i in range(4)],
                   final=[t.detach() for layer in res.final_params.values()
                          for t in layer.values()])
