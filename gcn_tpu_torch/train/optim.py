"""Adam with classic L2 weight decay, the reference's training recipe.

``torch.optim.Adam(weight_decay=wd)`` adds ``wd * param`` to the gradient
before the moment updates: exactly ``gcn_tpu.train.optim.adam_l2``, which
places optax's ``add_decayed_weights`` before ``scale_by_adam``.
"""

from __future__ import annotations

from typing import Iterable

import torch


def adam_l2(params: Iterable[torch.Tensor], lr: float = 0.01,
            weight_decay: float = 5e-4, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)
