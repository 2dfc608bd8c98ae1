"""The port's HGNN training, driven through ``HGNN.fit``.

Set-up builds H with the program's hypergraph functions, one group of
KNN hyperedges a modality that the configuration names for the structure
(pyhgnn's order: MVCNN, then GVCNN), G from H, and lowers G onto the
device once through the model's own ``_lower``; each fit is
``HGNN.fit(..., jit_loop=True)`` given that lowered G. (``HGNN.fit``
lowers G again on every call; the subclass below takes the lowered G as it
is, changes nothing else of the fit, and each fit checks that ``_lower``
did not run, so a renamed hook cannot put the lowering back into the
window unseen.)
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from gcn_tpu_torch.graph.hypergraph import (construct_H_with_KNN,
                                            generate_G_from_H)
from gcn_tpu_torch.models.hgnn import HGNN
from gcn_tpu_torch.train import capture

from benchmark.harness import Fit


MODALITIES = ("mvcnn", "gvcnn")


class _LoweredOnce(HGNN):
    """HGNN whose ``fit`` is handed G already on the device; counts the
    lowerings."""

    lowered = 0

    def _adjacency(self, g):
        return g

    def _lower(self, g_csr):
        self.lowered += 1
        return super()._lower(g_csr)


def incidence(cfg: dict, data: dict) -> np.ndarray:
    """H: the KNN hyperedges of each structure modality the configuration
    names, over its first ``structure_columns`` columns."""
    cols = cfg["structure_columns"]
    return np.hstack([
        construct_H_with_KNN(data["modalities"][mod][:, :cols],
                             k_neig=int(k), is_prob=cfg["is_probH"],
                             m_prob=cfg["m_prob"])
        for mod in MODALITIES if cfg[f"use_{mod}_feature_for_structure"]
        for k in cfg["K_neigs"]])


class Program:
    def __init__(self, cfg: dict, job: dict, data: dict, device, spans):
        if job["g_form"] != "dense":
            raise ValueError(f"G form {job['g_form']!r}: only 'dense' "
                             f"(G as one matrix) is driven here")
        self.device = torch.device(device)
        x = data["features"]
        n, f = x.shape
        c = int(data["labels"].max()) + 1
        h = cfg["n_hid"]
        self.layers = [("hgc1", f, h), ("hgc2", h, c)]
        self.perm = None
        with spans("hypergraph"):
            inc = incidence(cfg, data)
            g = generate_G_from_H(inc)
            del inc
        self.model = _LoweredOnce(
            in_ch=f, n_class=c, n_hid=h, dropout=cfg["drop_out"],
            lr=cfg["lr"], weight_decay=cfg["weight_decay"],
            milestones=cfg["milestones"], gamma=cfg["gamma"],
            device=self.device)
        with spans("lower_upload", self.device):
            self.g_adj = self.model._lower(g)
        self.nnz, self.n = g.nnz, n
        # HGNN.fit uploads its numpy inputs on every call
        self.x, self.labels = x, data["labels"]
        self.idx_train, self.idx_val = data["idx_train"], data["idx_val"]
        # layer 1 is hoisted (G X once a fit); layer 2's SpMM runs at n_class
        self.spmm_widths = [c]
        self.adj = self.g_adj

    def fit(self, params: dict, dropout_seed: int, iters: int) -> Fit:
        m = self.model
        m.params = params
        m.seed = dropout_seed - 1      # HGNN.fit seeds its stream seed + 1
        t0 = time.perf_counter()
        lowered = m.lowered
        m.fit(self.x, self.g_adj, self.labels, self.idx_train,
              idx_val=self.idx_val, num_epochs=iters, jit_loop=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        if m.lowered != lowered:
            raise RuntimeError("HGNN.fit lowered G inside the fit: the "
                               "hook this family overrides has moved")
        # epoch_ms[i] is epoch i; the capture happens inside epoch WARMUP's
        # interval, whose replay is taken at the median
        replays = m.epoch_ms[capture.WARMUP + 1:]
        replay_ms = (sum(replays) + statistics.median(replays)
                     if replays else 0.0)
        state = m.opt_state or {}
        return Fit(iters=iters,
                   losses=[e["loss_train"] for e in m.history],
                   wall_s=wall, replay_s=replay_ms / 1e3,
                   loop_s=m.timers("fit_scan").d.samples[-1] / 1e3,
                   exp_avg=[state[i]["exp_avg"] if i in state else None
                            for i in range(4)],
                   final=[t.detach() for layer in m._final_params.values()
                          for t in layer.values()])
