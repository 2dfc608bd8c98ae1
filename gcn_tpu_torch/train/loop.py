"""GCN training loop: the three fit modes of the pygcn reference
(gcn1.py:180-301), as ``gcn_tpu.train.loop.fit_gcn`` runs them:

  * ``no_val``     — train, then one eval forward of the last iterate;
  * ``val``        — best-val snapshot: a lower val loss, then a higher val
    accuracy, each take the snapshot (the later improvement wins);
  * ``early_stop`` — patience on the val loss.

A plain Python loop of eager steps (forward, loss, backward, Adam). The
"step" device timer covers each step and restarts after the first
``WARMUP`` steps, the reference's convention (gcn5.py:273-291).

A run resumes from a checkpoint (``utils.checkpoint``) with ``opt_state``,
the Adam state it saved, and ``start_iter``, the updates already done;
``TrainResult.opt_state`` is the state to save after the run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from gcn_tpu_torch.train.metrics import accuracy, masked_nll
from gcn_tpu_torch.utils.checkpoint import named_leaves, snapshot
from gcn_tpu_torch.utils.timers import Timers

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
) -> TrainResult:
    """Train ``params`` (a nested dict, copied) for ``train_iters`` steps.
    ``history`` and ``best_iter`` count iterations from ``start_iter``;
    ``rng_state`` is ``generator``'s state after the last step."""
    if mode == "auto":
        mode = "no_val" if idx_val is None else "val"
    if mode not in ("no_val", "val", "early_stop"):
        raise ValueError(f"unknown fit mode {mode!r}")
    if mode != "no_val" and idx_val is None:
        raise ValueError(f"mode {mode!r} requires idx_val")
    timers = timers or Timers()
    params = {name: {k: t.detach().clone().requires_grad_(True)
                     for k, t in layer.items()}
              for name, layer in params.items()}
    opt = make_optimizer([t for _, t in named_leaves(params)])
    if opt_state:
        full = opt.state_dict()
        full["state"] = opt_state
        opt.load_state_dict(full)

    def eval_forward(p):
        with torch.no_grad():
            return forward(p, False)

    best_params, best_lp = None, None
    best_loss_val = float("inf")
    best_acc_val = -float("inf")
    best_iter = -1
    patience_left = patience
    history = []

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
            msg = f"Epoch {i:4d}, training loss: {rec['loss_train']:.6f}"
            if "loss_val" in rec:
                msg += (f", val loss: {rec['loss_val']:.6f}, "
                        f"val acc: {rec['acc_val']:.4f}")
            print(msg)

    final = snapshot(params)
    rng_state = generator.get_state() if generator is not None else None
    if mode == "no_val" or best_params is None:
        best_params = final
        best_lp = eval_forward(final)
        best_iter = start_iter + len(history) - 1
    return TrainResult(params=best_params, log_probs=best_lp, timers=timers,
                       history=history, best_iter=best_iter,
                       final_params=final, iters_run=len(history),
                       opt_state=opt.state_dict()["state"],
                       rng_state=rng_state)
