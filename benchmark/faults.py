"""Faults planted in the program for the check of the comparison: each
must turn ``correct`` false. They patch the program's module attributes
for the duration of a ``with`` block and touch no file.

  * ``half_batch``: the loss takes the mean over the first half of the
    training rows only;
  * ``state_unchanged``: the optimizer's step leaves every parameter and
    its own state as they were;
  * ``first_layer_grad_scaled``: dropout's backward leaves out its 1/keep
    factor, so the first layer's gradient is keep times what it should be
    (the forward is unchanged);
  * ``milestone_ignored`` (HGNN): MultiStepLR never lowers the rate.

``FAULTS[name]`` is ``(plant, families)``: ``plant(family)`` gives the
``with`` block, for the model families the fault can occur in.
"""

from __future__ import annotations

import contextlib

import torch


class _Still(torch.optim.Optimizer):
    """An optimizer whose step changes nothing."""

    def __init__(self, params, *args, **kwargs):
        super().__init__(list(params), {"lr": 0.0})

    def step(self, closure=None):
        return None


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def half_batch(family: str):
    if family == "gcn":
        from gcn_tpu_torch.train import loop

        real = loop.masked_nll
        return _patched(loop, "masked_nll", lambda lp, labels, idx: real(
            lp, labels, idx[: max(idx.numel() // 2, 1)]))
    from gcn_tpu_torch.models import hgnn

    real = hgnn.cross_entropy
    return _patched(hgnn, "cross_entropy", lambda logits, labels, idx: real(
        logits, labels, idx[: max(idx.numel() // 2, 1)]))


def state_unchanged(family: str):
    if family == "gcn":
        from gcn_tpu_torch.train import optim

        return _patched(optim, "adam_l2", lambda params, *a, **k: _Still(
            params))
    from gcn_tpu_torch.models import hgnn

    return _patched(hgnn, "adam_l2", lambda params, *a, **k: _Still(params))


def first_layer_grad_scaled(family: str):
    from gcn_tpu_torch.models import gcn_core, hgnn, layers

    real = layers.dropout

    def unscaled_backward(generator, x, rate, train):
        y = real(generator, x, rate, train)
        if not train or rate <= 0.0:
            return y
        return y.detach() + (1.0 - rate) * (y - y.detach())

    module, name = ((gcn_core, "dropout") if family == "gcn"
                    else (hgnn, "dropout_fn"))
    return _patched(module, name, unscaled_backward)


def milestone_ignored(family: str):
    from gcn_tpu_torch.models import hgnn

    return _patched(hgnn.HGNN, "lr_at", lambda self, epoch: self.lr)


FAULTS = {"half_batch": (half_batch, ("gcn", "hgnn")),
          "state_unchanged": (state_unchanged, ("gcn", "hgnn")),
          "first_layer_grad_scaled": (first_layer_grad_scaled,
                                      ("gcn", "hgnn")),
          "milestone_ignored": (milestone_ignored, ("hgnn",))}


def for_family(family: str) -> dict:
    """The faults that ``family`` can have, by name, each its ``plant``."""
    return {name: plant for name, (plant, families) in FAULTS.items()
            if family in families}
