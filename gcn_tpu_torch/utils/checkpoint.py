"""Parameter checkpoints in ``gcn_tpu``'s flat-npz format.

Keys are the nested-dict paths joined by ``//`` (``"gc1//w"``), exactly as
``gcn_tpu.utils.checkpoint`` writes them, so checkpoints load across the two
packages in both directions. Writes are atomic (tmp file + rename).
"""

from __future__ import annotations

import os

import numpy as np

from gcn_tpu_torch.convert import params_from_numpy

_SEP = "//"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(params, prefix: str = "") -> dict:
    flat = {}
    for key in sorted(params):
        value = params[key]
        if isinstance(value, dict):
            flat.update(_flatten(value, f"{prefix}{key}{_SEP}"))
        else:
            flat[prefix + str(key)] = value.detach().cpu().numpy()
    return flat


def _unflatten_like(stored: dict, like, prefix: str = ""):
    out = {}
    for key, value in like.items():
        name = prefix + str(key)
        if isinstance(value, dict):
            out[key] = _unflatten_like(stored, value, name + _SEP)
            continue
        if name not in stored:
            raise KeyError(f"checkpoint missing parameter {name!r}")
        arr = stored[name]
        if arr.shape != tuple(value.shape):
            raise ValueError(f"checkpoint shape mismatch for {name!r}: "
                             f"{arr.shape} vs {tuple(value.shape)}")
        out[key] = arr
    return out


def save_params(path: str, params) -> None:
    """Save a nested dict of tensors to ``path`` (npz, keys = paths)."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **_flatten(params))
    os.replace(tmp, path)


def load_params(path: str, like):
    """Load into the structure of ``like`` (shapes validated; dtype and
    device taken from ``like``'s tensors)."""
    with np.load(_npz_path(path)) as f:
        stored = dict(f)
    nested = _unflatten_like(stored, like)
    leaf = next(iter(_leaves(like)))
    return params_from_numpy(nested, leaf.device, dtype=leaf.dtype)


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


def snapshot(params):
    """Detached copy of a nested dict of tensors."""
    return {k: snapshot(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in params.items()}

