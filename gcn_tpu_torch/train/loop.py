"""The training loop of every model: the three fit modes of the pygcn
reference (gcn1.py:180-301), as ``gcn_tpu.train.loop.fit_gcn`` runs them,
and pyhgnn's:

  * ``no_val``     — train, then one eval forward of the last iterate;
  * ``val``        — best-val snapshot: a lower val loss, then a higher val
    accuracy, each take the snapshot (the later improvement wins);
  * ``early_stop`` — patience on the val loss;
  * ``val_acc``    — pyhgnn's best-val snapshot (``train_model``): a
    strictly higher val accuracy takes it; no val loss is computed.

``GCN.fit``, ``GAT.fit``, ``DeeperGCN.fit`` and ``HGNN.fit`` train
through ``fit_gcn``. One
training iteration is written once, as gcn_tpu's ``_fit_scanned`` writes
it (gcn_tpu/train/loop.py:187-316): a device-side ``body`` whose best-val
snapshot and patience counter are selects into preallocated device
buffers, and whose per-iteration losses, val losses and val accuracies
are read once, after the run. ``CapturedLoop`` (``train/capture.py``)
runs it ``train_iters`` times, in one of two flavors:

  * ``jit_loop=True`` (the default, gcn_tpu's whole-run ``lax.scan``): on
    a CUDA device, replays of one captured CUDA graph of ``body``;
  * ``jit_loop=False``: plain calls of ``body``, eager steps.

On the CPU neither captures, so the two flavors give bit-equal results. A
stopped iteration (``early_stop``) is computed and discarded in both: it
changes neither the parameters, nor Adam's state, nor the dropout
generator, and does not count in ``iters_run``. ``fit_scan`` times the
whole loop; ``TrainResult.iter_ms`` holds the time of every iteration
(``Marks``), and the "step" timer those after the first ``WARMUP``, the
reference's convention (gcn5.py:273-291). ``verbose`` prints after the
loop.

Each fit is a ``fit`` span with the children ``fit.prepare`` (the copy of
the parameters, the optimizer, the loop's buffers), ``fit.loop`` (the
``fit_scan`` region) and ``fit.finish`` (the host reads and the final
evaluation); see ``utils/timers.py``.

A model with state beside its parameters that the training forward
writes in place and the evaluation forward reads (DeeperGCN's batch-norm
running statistics) passes it as ``buffers``: a stopped iteration leaves
it as it was, each best-val snapshot copies it beside the parameters, the
final evaluation runs under the snapshot's values (copied in, so that a
captured graph that reads the buffers stays valid), and
``TrainResult.buffers`` / ``final_buffers`` return it. Without buffers
the iteration runs the same kernels as before they existed.

A run resumes from a checkpoint (``utils.checkpoint``) with ``opt_state``,
the Adam state it saved, and ``start_iter``, the updates already done;
``TrainResult.opt_state`` is the state to save after the run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from gcn_tpu_torch.train.capture import CapturedLoop
from gcn_tpu_torch.train.metrics import accuracy, masked_nll
from gcn_tpu_torch.utils.checkpoint import (named_leaves, snapshot,
                                           tree_like)
from gcn_tpu_torch.utils.timers import Marks, Timers, span

WARMUP = 10


@dataclasses.dataclass
class TrainResult:
    params: dict            # best (or final) params, detached
    log_probs: torch.Tensor  # eval-mode outputs of ``params``
    timers: Timers
    history: list
    best_iter: int = -1
    final_params: dict = None  # last iterate
    iters_run: int = 0         # executed optimizer updates
    opt_state: dict = None     # Adam state after the last update
    rng_state: torch.Tensor = None  # the dropout generator's, likewise
    iter_ms: list = None       # every iteration's time, stopped ones too
    buffers: dict = None       # the buffers of ``params``, detached
    final_buffers: dict = None  # the buffers of the last iterate


def fit_gcn(
    params: dict,
    make_optimizer: Callable,   # list of tensors -> torch.optim.Optimizer
    forward: Callable,          # forward(params, train): log-probs in eval
    labels: torch.Tensor,
    idx_train: torch.Tensor,
    idx_val: Optional[torch.Tensor] = None,
    *,
    train_iters: int = 200,
    mode: str = "auto",  # auto | no_val | val | early_stop | val_acc
    patience: int = 500,
    verbose: bool = False,
    timers: Optional[Timers] = None,
    opt_state: Optional[dict] = None,  # Adam state to resume from
    start_iter: int = 0,               # updates done before this run
    generator: Optional[torch.Generator] = None,  # the one ``forward``
                                                  # draws dropout from
    jit_loop: bool = True,
    loss: Optional[Callable] = None,   # loss(train output, labels, idx)
    before: Optional[Callable[[int], None]] = None,
    buffers: Optional[dict] = None,    # state forward(params, True)
                                       # writes in place (not copied)
) -> TrainResult:
    """Train ``params`` (a nested dict, copied) for ``train_iters`` steps.
    ``history`` and ``best_iter`` count iterations from ``start_iter``;
    ``rng_state`` is ``generator``'s state after the last step. ``loss``
    is the training loss of ``forward(params, True)``, ``masked_nll`` by
    default; the val loss and accuracy read ``forward(params, False)``.
    ``before(i)`` runs on the host before iteration ``i`` (it may enqueue
    device work, such as a learning rate's ``fill_``). With ``jit_loop`` on
    a CUDA device, ``forward`` must be capturable (no host reads of device
    values) and draw its random numbers only from ``generator``, and
    ``make_optimizer`` must give a capturable optimizer (``adam_l2`` does
    on the card). ``buffers`` is a nested dict of the tensors that
    ``forward`` reads and its training call updates in place; at the end
    they hold the values of the returned parameters."""
    if mode == "auto":
        mode = "no_val" if idx_val is None else "val"
    if mode not in ("no_val", "val", "early_stop", "val_acc"):
        raise ValueError(f"unknown fit mode {mode!r}")
    if mode != "no_val" and idx_val is None:
        raise ValueError(f"mode {mode!r} requires idx_val")
    loss = loss or masked_nll
    dev = labels.device
    # the device's timers: CUDA events on the card
    timers = timers or Timers(dev)
    track_val = mode != "no_val"
    val_loss = mode in ("val", "early_stop")
    early = mode == "early_stop"

    def eval_forward(p):
        with torch.no_grad():
            return forward(p, False)

    # one iteration; the state it reads and writes is made in fit.prepare

    def guarded():
        """What a stopped iteration must leave as it was: the parameters,
        the buffers and Adam's state (which exists from the first step
        on)."""
        out = list(leaves) + buf_leaves
        for p in leaves:
            out += [v for v in opt.state[p].values()
                    if isinstance(v, torch.Tensor)]
        return out

    def take_best(take, value, best_value):
        # each select writes its buffer in place: one kernel apiece
        torch.where(take, value, best_value, out=best_value)
        for b, p in zip(best, leaves):
            torch.where(take, p.detach(), b, out=b)
        for b, t in zip(best_buf, buf_leaves):
            torch.where(take, t, b, out=b)
        torch.where(take, it, best_it, out=best_it)

    def body():
        opt.zero_grad(set_to_none=True)
        saved = [t.detach().clone() for t in guarded()] if early else None
        value = loss(forward(params, True), labels, idx_train)
        value.backward()
        opt.step()
        with torch.no_grad():
            losses.index_copy_(0, it, value.detach().reshape(1))
            if early:
                for t, s in zip(guarded(), saved):
                    t.copy_(torch.where(stop, s, t))
                live = torch.logical_not(stop)
                n_exec.add_(live.to(torch.int64))
            if track_val:
                lp = eval_forward(params)
                if val_loss:
                    loss_val = masked_nll(lp, labels, idx_val)
                    losses_val.index_copy_(0, it, loss_val.reshape(1))
                acc_val = accuracy(lp, labels, idx_val)
                accs_val.index_copy_(0, it, acc_val.reshape(1))
            if mode == "val_acc":
                take_best(acc_val > best_acc, acc_val, best_acc)
            elif mode == "val":
                # a lower val loss, then a higher val accuracy, each take
                # the snapshot; the later one wins
                take_best(loss_val < best_loss, loss_val, best_loss)
                take_best(acc_val > best_acc, acc_val, best_acc)
            elif early:
                improved = live & (loss_val < best_loss)
                take_best(improved, loss_val, best_loss)
                pat.copy_(torch.where(improved, patience,
                                      torch.where(stop, pat, pat - 1)))
                # the warm-up guard on the LOCAL index
                stop.copy_(stop | ((it[0] > patience) & (pat <= 0)))
            it.add_(1)

    with span("fit"):
        with span("fit.prepare"):
            params = {name: {k: t.detach().clone().requires_grad_(True)
                             for k, t in layer.items()}
                      for name, layer in params.items()}
            leaves = [t for _, t in named_leaves(params)]
            buf_leaves = [t for _, t in named_leaves(buffers or {})]
            opt = make_optimizer(leaves)
            if opt_state:
                opt.load_state_dict({**opt.state_dict(), "state": opt_state})

            def scalar(value, dtype=torch.float32):
                return torch.tensor(value, dtype=dtype, device=dev)

            # the local iteration index, the count of executed iterations
            # and the stop flag (early_stop's), the records, the best-val
            # snapshot (from the initial parameters, at a local index) and
            # the patience
            it = torch.zeros(1, dtype=torch.int64, device=dev)
            n_exec = scalar(0, torch.int64)
            stop = scalar(False, torch.bool)
            losses, losses_val, accs_val = (
                torch.full((train_iters,), float("nan"), device=dev)
                for _ in range(3))
            best = [t.detach().clone() for t in leaves]
            best_buf = [t.detach().clone() for t in buf_leaves]
            best_loss = scalar(float("inf"))
            best_acc = scalar(-float("inf"))
            best_it = torch.full((1,), -1, dtype=torch.int64, device=dev)
            pat = scalar(patience, torch.int64)
            loop = CapturedLoop(body, dev if jit_loop else None, generator)
            marks = Marks(dev)

        with span("fit.loop"), timers("fit_scan").d:
            loop.run(train_iters, before, marks)

        with span("fit.finish"):
            iter_ms = marks.intervals_ms()
            step_timer = timers("step")
            timers.reset("step")
            step_timer.d.add(iter_ms[WARMUP:] if len(iter_ms) > WARMUP
                             else iter_ms)

            # executed updates (< train_iters if stopped)
            n = int(n_exec) if early else train_iters
            if generator is not None:
                generator.set_state(loop.generator_state_after(n))
            history = []
            lists = [t[:n].tolist() for t in (losses, losses_val, accs_val)]
            for i, (loss_train, loss_v, acc_v) in enumerate(zip(*lists)):
                rec = {"iter": start_iter + i, "loss_train": loss_train}
                msg = f"Epoch {i:4d}, training loss: {loss_train:.6f}"
                if val_loss:
                    rec["loss_val"] = loss_v
                    msg += f", val loss: {loss_v:.6f}"
                if track_val:
                    rec["acc_val"] = acc_v
                    msg += f", val acc: {acc_v:.4f}"
                history.append(rec)
                if verbose and i % 10 == 0:
                    print(msg)
            if verbose and bool(stop):
                print(f"=== early stopping at iteration {n - 1}, "
                      f"best val loss {float(best_loss):.4f} ===")

            final = snapshot(params)
            final_buffers = snapshot(buffers) if buffers else None
            best_iter = start_iter + int(best_it)
            if mode == "no_val" or best_iter < start_iter:
                best_params, best_iter = final, start_iter + n - 1
                best_buffers = final_buffers
            else:
                best_params = tree_like(params, best)
                best_buffers = tree_like(buffers, best_buf) if buffers \
                    else None
                for t, b in zip(buf_leaves, best_buf):
                    t.copy_(b)
            return TrainResult(
                params=best_params, log_probs=eval_forward(best_params),
                timers=timers, history=history, best_iter=best_iter,
                final_params=final, iters_run=n,
                opt_state=opt.state_dict()["state"],
                rng_state=(generator.get_state() if generator is not None
                           else None),
                iter_ms=iter_ms, buffers=best_buffers,
                final_buffers=final_buffers)
