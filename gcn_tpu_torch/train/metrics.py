"""Loss and evaluation metrics (F.nll_loss on log_softmax outputs, the
reference's utils.accuracy, and micro-F1)."""

from __future__ import annotations

import torch


def masked_nll(log_probs: torch.Tensor, labels: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the rows selected by ``idx``."""
    return -log_probs[idx, labels[idx]].mean()


def accuracy(log_probs: torch.Tensor, labels: torch.Tensor,
             idx: torch.Tensor | None = None) -> torch.Tensor:
    if idx is not None:
        log_probs = log_probs[idx]
        labels = labels[idx]
    return (log_probs.argmax(dim=1) == labels).float().mean()


def micro_f1(pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Micro-averaged F1 for single-label predictions (== accuracy)."""
    return (pred == labels).float().mean()
