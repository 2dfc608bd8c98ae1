"""Loss and evaluation metrics (F.nll_loss on log_softmax outputs and the
reference's utils.accuracy)."""

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
