"""The weight carrier between the two packages.

``params_from_numpy`` turns ``gcn_tpu`` parameters, given as nested dicts of
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side,
or a loaded npz checkpoint), into the port's nested dicts of tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from gcn_tpu_torch.utils.device import resolve_device


def params_from_numpy(params_np, device=None, dtype=torch.float32):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device``: the card by default (``utils.device.resolve_device``),
    ``device="cpu"`` for the CPU (copies; the arrays are not shared)."""
    device = resolve_device(device)
    out = {}
    for key, value in params_np.items():
        if isinstance(value, dict):
            out[key] = params_from_numpy(value, device, dtype)
        else:
            out[key] = torch.tensor(np.asarray(value), dtype=dtype,
                                    device=device)
    return out


def params_to_numpy(params):
    """The inverse: nested dict of tensors -> nested dict of numpy arrays."""
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in params.items()}
