"""Hypergraph GNN (HGNN), the pyhgnn model family.

The port of ``gcn_tpu.models.hgnn``: two HGNN_conv layers
``x -> relu(G (x W1 + b1)) -> dropout -> G (x W2 + b2)`` over the
hypergraph operator G (``graph.hypergraph.generate_G_from_H``, or its two
factors as a ``TwoHopAdj``), with the reference's recipe
(pyhgnn/train.py:47-155): Adam (lr 1e-3, classic L2 weight decay 5e-4),
MultiStepLR (``lr_at``, set before each epoch), cross-entropy, best-val
snapshot. ``fit`` lowers G, uploads the inputs and hoists G X, then trains
through the models' one loop, ``train.loop.fit_gcn``: its loss is
``cross_entropy``, its host hook MultiStepLR's rate and its mode
"val_acc", pyhgnn's best-val rule (the epochs as replays of one captured
CUDA graph under ``jit_loop=True``, the default, gcn_tpu's ``lax.scan``).
Weights and biases start at U(-1/sqrt(out), 1/sqrt(out))
(pyhgnn/models/layers.py).

Every G-product goes through ``ops.spmm``. ``HGNN._lower`` keeps G (or a
factor) dense up to an 8192x8192-equivalent area and, under the default
``adj_kind="auto"``, lowers it past that area to the row-walk COO layout,
as GCN does: the COO kernel (``ops/csrc/coo_spmm.cu``). ``adj_kind="ell"``
lowers it to K1's ELL layout instead. Everything runs on ``device``: the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import bisect
import statistics
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.models.layers import dropout as dropout_fn
from gcn_tpu_torch.models.layers import init_linear
from gcn_tpu_torch.ops.adjacency import device_adjacency
from gcn_tpu_torch.ops.spmm import TwoHopAdj, hoist_spmm, spmm
from gcn_tpu_torch.train.loop import fit_gcn
from gcn_tpu_torch.train.metrics import accuracy
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.checkpoint import (load_training_state,
                                           save_training_state)
from gcn_tpu_torch.utils.device import resolve_device
from gcn_tpu_torch.utils.timers import Timers, span


def init_hgnn_params(generator: torch.Generator, in_ch: int, n_hid: int,
                     n_class: int, dtype=torch.float32, device=None):
    """Both layers' parameters on ``device``: the card by default,
    ``device="cpu"`` for the CPU (``init_linear``)."""
    return {
        "hgc1": init_linear(generator, in_ch, n_hid, True, dtype, device),
        "hgc2": init_linear(generator, n_hid, n_class, True, dtype, device),
    }


def hgnn_forward(params, x, g_adj, *, dropout: float = 0.5,
                 train: bool = False,
                 generator: Optional[torch.Generator] = None, gx=None,
                 g_rowsum=None) -> torch.Tensor:
    """Logits (n, n_class). HGNN_conv is x W + b, then G @ (.) (the A(XW)
    order). With ``gx`` (= G @ X) and ``g_rowsum`` (= G @ 1), layer 1 is
    the training-invariant expansion G(XW + 1 b^T) = (GX)W + (G1)b^T: no
    G-product (X is constant; dropout comes after layer 1)."""
    w1, b1 = params["hgc1"]["w"], params["hgc1"]["b"]
    if gx is not None:
        h = torch.matmul(gx, w1) + g_rowsum[:, None] * b1[None, :]
    else:
        h = spmm(g_adj, torch.matmul(x, w1) + b1)
    h = torch.relu(h)
    if train and dropout > 0:
        if generator is None:
            raise ValueError("training forward needs a generator for dropout")
        h = dropout_fn(generator, h, dropout, train=True)
    h = torch.matmul(h, params["hgc2"]["w"]) + params["hgc2"]["b"]
    return spmm(g_adj, h)


def cross_entropy(logits, labels, idx):
    """Mean cross-entropy of the rows ``idx``."""
    lp = torch.log_softmax(logits[idx], dim=1)
    return -lp.gather(1, labels[idx][:, None]).mean()


class HGNN:
    """Class API of pyhgnn's train_model function (train.py:47-128)."""

    # gcn_tpu's optax chain: add_decayed_weights, scale_by_adam, then the
    # schedule (checkpoint stages 0, 1, 2)
    _ADAM_INDEX = 1

    def __init__(self, in_ch: int, n_class: int, n_hid: int = 128,
                 dropout: float = 0.5, lr: float = 0.001,
                 weight_decay: float = 5e-4,
                 milestones: Sequence[int] = (100,), gamma: float = 0.9,
                 adj_kind: str = "auto", seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.in_ch, self.n_class, self.n_hid = in_ch, n_class, n_hid
        self.dropout = dropout
        self.lr, self.weight_decay = lr, weight_decay
        self.milestones, self.gamma = list(milestones), gamma
        self.adj_kind = adj_kind
        self.seed = seed
        self.params = None
        self.timers = Timers(self.device)
        self.best_acc = 0.0
        self.output = None
        self.g_adj = None             # G on the device, set by fit()
        self.history = []             # per-epoch loss (+ val accuracy)
        self.epoch_ms = []            # per-epoch time on the device's stream
        self._epochs_done = 0

    def init_params(self):
        """Fresh parameters from a generator seeded with ``seed``."""
        gen = torch.Generator().manual_seed(self.seed)
        return init_hgnn_params(gen, self.in_ch, self.n_hid, self.n_class,
                                device=self.device)

    def lr_at(self, epoch: int) -> float:
        """MultiStepLR's rate for (0-based) ``epoch``: lr * gamma ** (the
        milestones <= epoch), as gcn_tpu's optax schedule computes it."""
        return self.lr * self.gamma ** bisect.bisect_right(
            sorted(self.milestones), epoch)

    def _lower(self, g_csr: CSRGraph):
        """G (or a factor) onto the device as ``adj_kind`` says. "auto" is
        ``device_adjacency``'s area rule: dense up to an
        8192x8192-equivalent area (so a tall, narrow factor stays dense),
        the row-walk COO layout past it. "ell" is K1's layout, at k_pad 128
        when n_hid > 64, else 32."""
        if self.adj_kind == "ell":
            return device_adjacency(g_csr, "ell", device=self.device,
                                    k_pad=128 if self.n_hid > 64 else 32)
        return device_adjacency(g_csr, self.adj_kind, device=self.device)

    def _adjacency(self, G):
        if isinstance(G, TwoHopAdj):
            return G
        if isinstance(G, tuple) and len(G) == 2:
            # factored G = A1 @ A2 (graph.hypergraph.generate_G_factors)
            return TwoHopAdj(*(self._lower(a) for a in G))
        if isinstance(G, CSRGraph):
            return self._lower(G)
        if hasattr(G, "tocsr"):
            return self._lower(CSRGraph.from_scipy(G))
        return self._lower(CSRGraph.from_dense(np.asarray(G)))

    def fit(self, features, G, labels, idx_train, idx_val=None, *,
            num_epochs: int = 600, verbose: bool = False,
            print_freq: int = 100, resume_from: Optional[str] = None,
            jit_loop: bool = True):
        """Train for ``num_epochs`` through ``train.loop.fit_gcn``; with
        ``idx_val`` keep the parameters of the best validation accuracy
        (its mode "val_acc", tracked on the device). ``resume_from``
        continues from a ``save_state`` checkpoint of either package.
        ``jit_loop`` picks ``fit_gcn``'s flavor: the epochs as replays of
        one captured CUDA graph (the default, as in gcn_tpu), or eager.
        G's lowering, the inputs' upload, the G X hoist and the resume run
        under the span ``hgnn.prepare``, before the ``fit`` span."""
        dev = self.device

        def index(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=dev)

        with span("hgnn.prepare"):
            adj = self.g_adj = self._adjacency(G)
            x = torch.as_tensor(np.asarray(features), dtype=torch.float32,
                                device=dev)
            labels = index(labels)
            idx_train = index(idx_train)
            idx_val = index(idx_val) if idx_val is not None else None
            # the training-invariant layer-1 aggregation: GX in column
            # chunks, and the row sums for the bias term (hgnn_forward's
            # expansion)
            with self.timers("hoist_gx").d as t:
                gx = t.fence(hoist_spmm(adj, x))
            with torch.no_grad():
                g_rowsum = spmm(adj, x.new_ones((x.shape[0], 1)))[:, 0]

            if self.params is None:
                self.params = self.init_params()
            gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
            self._epochs_done = 0
            adam_state, schedule_at = None, 0
            if resume_from is not None:
                state = load_training_state(resume_from, self.params,
                                            adam_index=self._ADAM_INDEX,
                                            schedule=True)
                self.params, adam_state = state.params, state.adam_state
                self._epochs_done = state.iteration
                schedule_at = state.schedule_count
                state.restore_generator(gen)
                if idx_val is not None:
                    warnings.warn(
                        "resume_from restores params/optimizer/rng but NOT "
                        "the best-val snapshot: best tracking restarts here")

        # MultiStepLR's rate, set before each epoch: on a CUDA device a
        # tensor that the captured epoch reads, filled at a milestone
        rate = self.lr_at(schedule_at)
        lr = torch.tensor(rate, device=dev) if dev.type == "cuda" else rate
        opt = None

        def make_optimizer(leaves):
            nonlocal opt
            opt = adam_l2(leaves, lr, self.weight_decay)
            return opt

        def set_rate(epoch):
            nonlocal rate
            new = self.lr_at(schedule_at + epoch)
            if new == rate:
                return
            rate = new
            for group in opt.param_groups:
                if isinstance(group["lr"], torch.Tensor):
                    group["lr"].fill_(new)
                else:
                    group["lr"] = new

        last = {}   # the parameters evaluated last, and their logits

        def forward(p, train):
            # the loss reads the logits, the validation accuracy log-probs
            out = hgnn_forward(p, None, adj, dropout=self.dropout,
                               train=train, generator=gen, gx=gx,
                               g_rowsum=g_rowsum)
            if train:
                return out
            last.update(params=p, logits=out)
            return torch.log_softmax(out, 1)

        res = fit_gcn(self.params, make_optimizer, forward, labels,
                      idx_train, idx_val, train_iters=num_epochs,
                      mode="no_val" if idx_val is None else "val_acc",
                      timers=self.timers, opt_state=adam_state,
                      start_iter=self._epochs_done, generator=gen,
                      jit_loop=jit_loop, loss=cross_entropy, before=set_rate)
        self.epoch_ms = res.iter_ms
        self.history = [{"epoch": h.pop("iter"), **h} for h in res.history]
        if verbose:
            for e in range(0, num_epochs, print_freq):
                h = self.history[e]
                acc = f" val_acc {h['acc_val']:.4f}" if "acc_val" in h else ""
                print(f"Epoch {e}/{num_epochs} loss {h['loss_train']:.4f}"
                      + acc)
        self.opt_state = res.opt_state
        self._schedule_at = schedule_at + num_epochs
        self._final_params = res.final_params
        self._rng_state = res.rng_state
        self._epochs_done += num_epochs
        if idx_val is not None:
            self.best_acc = max((h["acc_val"] for h in self.history),
                                default=-float("inf"))
        self.params = res.params
        # the chosen parameters' logits: those of fit_gcn's final evaluation
        # (``res.log_probs``) when it was of these parameters
        if last.get("params") is not res.params:
            with torch.no_grad():
                forward(res.params, False)
        self.output = last["logits"]
        self._labels = labels
        return self

    @property
    def median_epoch_ms(self) -> float:
        return statistics.median(self.epoch_ms) if self.epoch_ms else 0.0

    def save_state(self, path: str) -> None:
        """Save the full resumable training state (last-iterate params,
        Adam state, schedule position, epoch count, dropout stream) in
        gcn_tpu's layout; continue with ``fit(..., resume_from=path)`` in
        either package."""
        if getattr(self, "opt_state", None) is None:
            raise RuntimeError("nothing to save: call fit() first")
        save_training_state(path, self._final_params, self.opt_state,
                            self._epochs_done, adam_index=self._ADAM_INDEX,
                            schedule_count=self._schedule_at,
                            rng_state=self._rng_state,
                            rng_device=self.device.type)

    def test(self, idx_test, verbose: bool = True):
        idx = torch.as_tensor(np.asarray(idx_test), dtype=torch.int64,
                              device=self.device)
        acc = float(accuracy(torch.log_softmax(self.output, 1),
                             self._labels, idx))
        if verbose:
            print(f"HGNN test accuracy: {acc:.4f}")
        return acc
