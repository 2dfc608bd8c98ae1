"""Hypergraph GNN (HGNN), the pyhgnn model family.

The port of ``gcn_tpu.models.hgnn``: two HGNN_conv layers
``x -> relu(G (x W1 + b1)) -> dropout -> G (x W2 + b2)`` over the
hypergraph operator G (``graph.hypergraph.generate_G_from_H``, or its two
factors as a ``TwoHopAdj``), with the reference's recipe
(pyhgnn/train.py:47-155): Adam (lr 1e-3, classic L2 weight decay 5e-4),
MultiStepLR (``lr_at``, set before each epoch), cross-entropy, best-val
snapshot. ``fit`` runs the epochs as replays of one captured CUDA graph
(``jit_loop=True``, the default, gcn_tpu's ``lax.scan``) or eagerly;
both flavors run one ``step`` and give bit-equal results on the CPU.
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
from typing import Optional, Sequence

import numpy as np
import torch

from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.models.layers import dropout as dropout_fn
from gcn_tpu_torch.models.layers import init_linear
from gcn_tpu_torch.ops.adjacency import device_adjacency
from gcn_tpu_torch.ops.spmm import TwoHopAdj, hoist_spmm, spmm
from gcn_tpu_torch.train.capture import CapturedLoop
from gcn_tpu_torch.train.metrics import accuracy
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.checkpoint import named_leaves, snapshot
from gcn_tpu_torch.utils.device import resolve_device
from gcn_tpu_torch.utils.timers import Marks, Timers, span


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
        """Train for ``num_epochs``; with ``idx_val`` keep the parameters
        of the best validation accuracy (tracked on the device: the host
        waits once, after the last epoch). ``resume_from`` continues from a
        ``save_state`` checkpoint of either package. ``jit_loop`` (the
        default, as in gcn_tpu) runs the epochs as replays of one captured
        CUDA graph (``train/capture.py``; plain calls of the same epoch on
        the CPU); ``jit_loop=False`` runs them eagerly. The fit is a ``fit``
        span (``utils/timers.py``): ``fit.prepare`` (G, the inputs' upload,
        the G X hoist, the optimizer, the buffers), ``fit.loop`` and
        ``fit.finish`` (the host reads and the final evaluation)."""
        with span("fit"):
            with span("fit.prepare"):
                adj = self.g_adj = self._adjacency(G)
                dev = self.device
                x = torch.as_tensor(np.asarray(features), dtype=torch.float32,
                                    device=dev)
                labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                                         device=dev)
                idx_train = torch.as_tensor(np.asarray(idx_train),
                                            dtype=torch.int64, device=dev)
                if idx_val is not None:
                    idx_val = torch.as_tensor(np.asarray(idx_val),
                                              dtype=torch.int64, device=dev)

                if self.params is None:
                    self.params = self.init_params()
                gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
                self._epochs_done = 0
                adam_state, schedule_at = None, 0
                if resume_from is not None:
                    from gcn_tpu_torch.utils.checkpoint import (
                        load_training_state)

                    state = load_training_state(resume_from, self.params,
                                                adam_index=self._ADAM_INDEX,
                                                schedule=True)
                    self.params, adam_state = state.params, state.adam_state
                    self._epochs_done = state.iteration
                    schedule_at = state.schedule_count
                    state.restore_generator(gen)
                    if idx_val is not None:
                        import warnings

                        warnings.warn(
                            "resume_from restores params/optimizer/rng but "
                            "NOT the best-val snapshot: best tracking "
                            "restarts here")

                params = {name: {k: t.detach().clone().requires_grad_(True)
                                 for k, t in layer.items()}
                          for name, layer in self.params.items()}
                leaves = [t for _, t in named_leaves(params)]
                # MultiStepLR's rate, set before each epoch: on a CUDA device
                # a tensor that the captured epoch reads, filled at a
                # milestone
                rate = self.lr_at(schedule_at)
                lr = (torch.tensor(rate, device=dev) if dev.type == "cuda"
                      else rate)
                opt = adam_l2(leaves, lr, self.weight_decay)
                if adam_state:
                    full = opt.state_dict()
                    full["state"] = adam_state
                    opt.load_state_dict(full)

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

                # the training-invariant layer-1 aggregation: GX in column
                # chunks, and the row sums for the bias term (hgnn_forward's
                # expansion)
                with self.timers("hoist_gx").d as t:
                    gx = t.fence(hoist_spmm(adj, x))
                with torch.no_grad():
                    g_rowsum = spmm(adj, x.new_ones((x.shape[0], 1)))[:, 0]

                def evaluate(p):
                    with torch.no_grad():
                        return hgnn_forward(p, None, adj, train=False, gx=gx,
                                            g_rowsum=g_rowsum)

                best_params = snapshot(params)
                best = [t for _, t in named_leaves(best_params)]
                best_acc = torch.tensor(-float("inf"), device=dev)
                epoch = torch.zeros(1, dtype=torch.int64, device=dev)
                losses = torch.full((num_epochs,), float("nan"), device=dev)
                accs = torch.full((num_epochs,), float("nan"), device=dev)

                def step():
                    """One epoch: the training step, its loss and the
                    best-val select, recorded at index ``epoch`` of the
                    device buffers."""
                    opt.zero_grad(set_to_none=True)
                    logits = hgnn_forward(params, None, adj,
                                          dropout=self.dropout, train=True,
                                          generator=gen, gx=gx,
                                          g_rowsum=g_rowsum)
                    loss = cross_entropy(logits, labels, idx_train)
                    loss.backward()
                    opt.step()
                    with torch.no_grad():
                        losses.index_copy_(0, epoch,
                                           loss.detach().reshape(1))
                        if idx_val is not None:
                            acc = accuracy(
                                torch.log_softmax(evaluate(params), 1),
                                labels, idx_val)
                            take = acc > best_acc
                            best_acc.copy_(torch.where(take, acc, best_acc))
                            for b, p in zip(best, leaves):
                                b.copy_(torch.where(take, p, b))
                            accs.index_copy_(0, epoch, acc.reshape(1))
                        epoch.add_(1)

                marks = Marks(dev)

            with span("fit.loop"):
                if jit_loop:
                    with self.timers("fit_scan").d:
                        CapturedLoop(step, dev, gen).run(num_epochs,
                                                         set_rate, marks)
                else:
                    with span("loop.replay", iters=num_epochs):
                        for e in range(num_epochs):
                            set_rate(e)
                            marks.mark()
                            step()
                    marks.mark()

            with span("fit.finish"):
                self.epoch_ms = marks.intervals_ms()

                losses = losses.tolist()
                accs = accs.tolist() if idx_val is not None else []
                self.history = [
                    {"epoch": self._epochs_done + e, "loss_train": loss_e,
                     **({"acc_val": accs[e]} if accs else {})}
                    for e, loss_e in enumerate(losses)]
                if verbose:
                    for e in range(0, num_epochs, print_freq):
                        msg = f"Epoch {e}/{num_epochs} loss {losses[e]:.4f}"
                        if accs:
                            msg += f" val_acc {accs[e]:.4f}"
                        print(msg)
                self.opt_state = opt.state_dict()["state"]
                self._schedule_at = schedule_at + num_epochs
                self._final_params = snapshot(params)
                self._rng_state = gen.get_state()
                self._epochs_done += num_epochs
                if idx_val is not None:
                    self.best_acc = float(best_acc)
                    self.params = best_params
                else:
                    self.params = self._final_params
                self.output = evaluate(self.params)
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
        from gcn_tpu_torch.utils.checkpoint import save_training_state

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
