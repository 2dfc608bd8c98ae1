"""GCN training loop: the three fit modes of the pygcn reference
(gcn1.py:180-301), as ``gcn_tpu.train.loop.fit_gcn`` runs them:

  * ``no_val``     — train, then one eval forward of the last iterate;
  * ``val``        — best-val snapshot: a lower val loss, then a higher val
    accuracy, each take the snapshot (the later improvement wins);
  * ``early_stop`` — patience on the val loss.

Two loop flavors, as in gcn_tpu:

  * ``jit_loop=True`` (the default): gcn_tpu's ``_fit_scanned``, the whole
    fit as one device-side loop (``train/capture.py``): on a CUDA device
    one captured CUDA graph of one iteration, replayed ``train_iters``
    times; the best-val snapshot and the patience counter are selects
    into preallocated device buffers, and the per-iteration losses,
    val losses and val accuracies are read once, after the run. A
    stopped iteration (``early_stop``) is computed and discarded: it
    changes neither the parameters, nor Adam's state, nor the dropout
    generator, and does not count in ``iters_run``. ``fit_scan`` times the
    whole loop; the "step" timer holds the time between replays;
  * ``jit_loop=False``: a plain Python loop of eager steps (forward, loss,
    backward, Adam) that reads each step's loss on the host.

The "step" device timer covers each step and restarts after the first
``WARMUP`` steps, the reference's convention (gcn5.py:273-291). On the
CPU the two flavors run the same arithmetic and give bit-equal results.

Each fit is a ``fit`` span with the children ``fit.prepare`` (the copy of
the parameters, the optimizer, the loop's buffers), ``fit.loop`` (the
``fit_scan`` region; in the eager flavor one ``loop.replay`` span) and
``fit.finish`` (the host reads and the final evaluation); see
``utils/timers.py``.

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


def fit_gcn(
    params: dict,
    make_optimizer: Callable,   # list of tensors -> torch.optim.Optimizer
    forward: Callable,          # forward(params, train) -> log_probs
    labels: torch.Tensor,
    idx_train: torch.Tensor,
    idx_val: Optional[torch.Tensor] = None,
    *,
    train_iters: int = 200,
    mode: str = "auto",  # auto | no_val | val | early_stop
    patience: int = 500,
    verbose: bool = False,
    timers: Optional[Timers] = None,
    opt_state: Optional[dict] = None,  # Adam state to resume from
    start_iter: int = 0,               # updates done before this run
    generator: Optional[torch.Generator] = None,  # the one ``forward``
                                                  # draws dropout from
    jit_loop: bool = True,
) -> TrainResult:
    """Train ``params`` (a nested dict, copied) for ``train_iters`` steps.
    ``history`` and ``best_iter`` count iterations from ``start_iter``;
    ``rng_state`` is ``generator``'s state after the last step. With
    ``jit_loop`` on a CUDA device, ``forward`` must be capturable (no host
    reads of device values) and draw its random numbers only from
    ``generator``, and ``make_optimizer`` must give a capturable optimizer
    (``adam_l2`` does on the card)."""
    if mode == "auto":
        mode = "no_val" if idx_val is None else "val"
    if mode not in ("no_val", "val", "early_stop"):
        raise ValueError(f"unknown fit mode {mode!r}")
    if mode != "no_val" and idx_val is None:
        raise ValueError(f"mode {mode!r} requires idx_val")
    # the device's timers: CUDA events on the card, so an eager step's time
    # is the card's, not the host's time to enqueue it
    timers = timers or Timers(labels.device)

    def eval_forward(p):
        with torch.no_grad():
            return forward(p, False)

    run = _fit_captured if jit_loop else _fit_eager
    with span("fit"):
        return run(params, make_optimizer, opt_state, forward, eval_forward,
                   labels, idx_train, idx_val, train_iters=train_iters,
                   mode=mode, patience=patience, verbose=verbose,
                   timers=timers, start_iter=start_iter,
                   generator=generator)


def _trainable(params, make_optimizer, opt_state):
    """A copy of ``params`` to train, and its optimizer, resumed from
    ``opt_state`` where given."""
    params = {name: {k: t.detach().clone().requires_grad_(True)
                     for k, t in layer.items()}
              for name, layer in params.items()}
    opt = make_optimizer([t for _, t in named_leaves(params)])
    if opt_state:
        full = opt.state_dict()
        full["state"] = opt_state
        opt.load_state_dict(full)
    return params, opt


def _fit_eager(params, make_optimizer, opt_state, forward, eval_forward,
               labels, idx_train, idx_val, *, train_iters, mode, patience,
               verbose, timers, start_iter, generator):
    """The Python loop of eager steps, each step's loss read on the host."""
    with span("fit.prepare"):
        params, opt = _trainable(params, make_optimizer, opt_state)
        best_params, best_lp = None, None
        best_loss_val = float("inf")
        best_acc_val = -float("inf")
        best_iter = -1
        patience_left = patience
        history = []

    with span("fit.loop"), span("loop.replay") as replay:
        for i in range(train_iters):
            if i == WARMUP:
                timers.reset("step")
            with timers("step").d as t:
                opt.zero_grad(set_to_none=True)
                loss = masked_nll(forward(params, True), labels, idx_train)
                loss.backward()
                opt.step()
                t.fence(loss)
            rec = {"iter": start_iter + i, "loss_train": float(loss.detach())}

            if mode in ("val", "early_stop"):
                lp = eval_forward(params)
                loss_val = float(masked_nll(lp, labels, idx_val))
                acc_val = float(accuracy(lp, labels, idx_val))
                rec.update(loss_val=loss_val, acc_val=acc_val)
                if mode == "val":
                    if loss_val < best_loss_val:
                        best_loss_val = loss_val
                        best_params, best_lp = snapshot(params), lp
                        best_iter = start_iter + i
                    if acc_val > best_acc_val:
                        best_acc_val = acc_val
                        best_params, best_lp = snapshot(params), lp
                        best_iter = start_iter + i
                else:
                    if loss_val < best_loss_val:
                        best_loss_val = loss_val
                        best_params, best_lp = snapshot(params), lp
                        best_iter = start_iter + i
                        patience_left = patience
                    else:
                        patience_left -= 1
                    if i > patience and patience_left <= 0:
                        history.append(rec)
                        if verbose:
                            print(f"=== early stopping at iteration {i}, "
                                  f"best val loss {best_loss_val:.4f} ===")
                        break
            history.append(rec)
            if verbose and i % 10 == 0:
                msg = (f"Epoch {i:4d}, training loss: "
                       f"{rec['loss_train']:.6f}")
                if "loss_val" in rec:
                    msg += (f", val loss: {rec['loss_val']:.6f}, "
                            f"val acc: {rec['acc_val']:.4f}")
                print(msg)
        replay.set(iters=len(history))

    with span("fit.finish"):
        final = snapshot(params)
        rng_state = generator.get_state() if generator is not None else None
        if mode == "no_val" or best_params is None:
            best_params = final
            best_lp = eval_forward(final)
            best_iter = start_iter + len(history) - 1
        return TrainResult(params=best_params, log_probs=best_lp,
                           timers=timers, history=history,
                           best_iter=best_iter, final_params=final,
                           iters_run=len(history),
                           opt_state=opt.state_dict()["state"],
                           rng_state=rng_state)


def _fit_captured(params, make_optimizer, opt_state, forward, eval_forward,
                  labels, idx_train, idx_val, *, train_iters, mode, patience,
                  verbose, timers, start_iter, generator):
    """gcn_tpu's ``_fit_scanned`` (gcn_tpu/train/loop.py:187-316): one
    training iteration as a device-side ``body``, run ``train_iters`` times
    by ``CapturedLoop``. Its state lives in device tensors: the local
    iteration index ``it``, the best-val snapshot (selects into
    preallocated copies of the parameters, starting from the initial
    ones), the best val loss and accuracy, ``best_iter``, the patience
    counter, the stop flag and the count of executed iterations."""
    with span("fit.prepare"):
        params, opt = _trainable(params, make_optimizer, opt_state)
        dev = labels.device
        leaves = [t for _, t in named_leaves(params)]
        track_val = mode in ("val", "early_stop")
        early = mode == "early_stop"

        def scalar(value, dtype=torch.float32):
            return torch.tensor(value, dtype=dtype, device=dev)

        it = torch.zeros(1, dtype=torch.int64, device=dev)
        n_exec = scalar(0, torch.int64)
        stop = scalar(False, torch.bool)
        losses = torch.full((train_iters,), float("nan"), device=dev)
        losses_val = torch.full((train_iters,), float("nan"), device=dev)
        accs_val = torch.full((train_iters,), float("nan"), device=dev)
        best = [t.detach().clone() for t in leaves]
        best_loss = scalar(float("inf"))
        best_acc = scalar(-float("inf"))
        best_it = torch.full((1,), -1, dtype=torch.int64, device=dev)
        pat = scalar(patience, torch.int64)

        def guarded():
            """What a stopped iteration must leave as it was: the parameters
            and Adam's state (which exists from the first step on)."""
            out = list(leaves)
            for p in leaves:
                out += [v for v in opt.state[p].values()
                        if isinstance(v, torch.Tensor)]
            return out

        def take_best(take, value, best_value):
            best_value.copy_(torch.where(take, value, best_value))
            for b, p in zip(best, leaves):
                b.copy_(torch.where(take, p.detach(), b))
            best_it.copy_(torch.where(take, start_iter + it, best_it))

        def body():
            live = torch.logical_not(stop)
            opt.zero_grad(set_to_none=True)
            saved = ([t.detach().clone() for t in guarded()] if early
                     else None)
            loss = masked_nll(forward(params, True), labels, idx_train)
            loss.backward()
            opt.step()
            loss = loss.detach()
            with torch.no_grad():
                if early:
                    for t, s in zip(guarded(), saved):
                        t.copy_(torch.where(stop, s, t))
                losses.index_copy_(0, it, loss.reshape(1))
                n_exec.add_(live.to(torch.int64))
                if track_val:
                    lp = eval_forward(params)
                    loss_val = masked_nll(lp, labels, idx_val)
                    acc_val = accuracy(lp, labels, idx_val)
                    losses_val.index_copy_(0, it, loss_val.reshape(1))
                    accs_val.index_copy_(0, it, acc_val.reshape(1))
                    if mode == "val":
                        # a lower val loss, then a higher val accuracy, each
                        # take the snapshot; the later one wins
                        take_best(loss_val < best_loss, loss_val, best_loss)
                        take_best(acc_val > best_acc, acc_val, best_acc)
                    else:
                        improved = live & (loss_val < best_loss)
                        take_best(improved, loss_val, best_loss)
                        pat.copy_(torch.where(improved, patience,
                                              torch.where(stop, pat, pat - 1)))
                        # the warm-up guard on the LOCAL index, as the eager
                        # flavor's ``i > patience``
                        stop.copy_(stop | ((it[0] > patience) & (pat <= 0)))
                it.add_(1)

        loop = CapturedLoop(body, dev, generator)
        marks = Marks(dev)

    with span("fit.loop"), timers("fit_scan").d:
        loop.run(train_iters, marks=marks)

    with span("fit.finish"):
        step_timer = timers("step")
        timers.reset("step")
        steps = marks.intervals_ms()
        step_timer.d.add(steps[WARMUP:] if len(steps) > WARMUP else steps)

        n = int(n_exec)   # executed updates (< train_iters if stopped)
        if generator is not None:
            generator.set_state(loop.generator_state_after(n))
        history = []
        lists = [t[:n].tolist() for t in (losses, losses_val, accs_val)]
        for i, (loss, loss_val, acc_val) in enumerate(zip(*lists)):
            rec = {"iter": start_iter + i, "loss_train": loss}
            if track_val:
                rec.update(loss_val=loss_val, acc_val=acc_val)
            history.append(rec)
            if verbose and i % 10 == 0:
                msg = f"Epoch {i:4d}, training loss: {loss:.6f}"
                if track_val:
                    msg += (f", val loss: {loss_val:.6f}, "
                            f"val acc: {acc_val:.4f}")
                print(msg)
        if verbose and bool(stop):
            print(f"=== early stopping at iteration {n - 1}, "
                  f"best val loss {float(best_loss):.4f} ===")

        final = snapshot(params)
        best_iter = int(best_it)
        if mode == "no_val" or best_iter < 0:
            best_params, best_iter = final, start_iter + n - 1
        else:
            best_params = tree_like(params, best)
        return TrainResult(params=best_params,
                           log_probs=eval_forward(best_params), timers=timers,
                           history=history, best_iter=best_iter,
                           final_params=final, iters_run=n,
                           opt_state=opt.state_dict()["state"],
                           rng_state=(generator.get_state()
                                      if generator is not None else None))
