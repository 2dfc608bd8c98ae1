"""Adam with classic L2 weight decay, the reference's training recipe.

``torch.optim.Adam(weight_decay=wd)`` adds ``wd * param`` to the gradient
before the moment updates: exactly ``gcn_tpu.train.optim.adam_l2``, which
places optax's ``add_decayed_weights`` before ``scale_by_adam``.

On a CUDA device the Adam is ``capturable``, the one a captured fit needs
(``train/capture.py``): its step count lives on the parameters' device and
its bias corrections are tensor ops, so one CUDA graph replays every step.
Both loop flavors get it there, so that they run the same arithmetic;
torch refuses it for CPU parameters, which get the plain Adam. ``lr`` may
be a 0-d tensor on the parameters' device, which a captured step reads at
every replay (HGNN's schedule fills it at a milestone).
"""

from __future__ import annotations

from typing import Iterable, Union

import torch


def adam_l2(params: Iterable[torch.Tensor],
            lr: Union[float, torch.Tensor] = 0.01,
            weight_decay: float = 5e-4, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8) -> torch.optim.Adam:
    params = list(params)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay,
                            capturable=all(p.is_cuda for p in params))
