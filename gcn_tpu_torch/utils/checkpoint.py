"""Parameter and training-state checkpoints in ``gcn_tpu``'s flat-npz format.

Keys are the nested-dict paths joined by ``//`` (``"gc1//w"``), exactly as
``gcn_tpu.utils.checkpoint`` writes them, so checkpoints load across the two
packages in both directions. Writes are atomic (tmp file + rename).

A training state (``save_training_state``) holds the parameters under
``params//``, the optimizer under ``opt//`` in the layout of gcn_tpu's optax
chain, the iteration count under ``__iteration__`` and the dropout stream.
torch.optim.Adam's ``step``, ``exp_avg`` and ``exp_avg_sq`` are optax
``scale_by_adam``'s ``count``, ``mu`` and ``nu``
(``opt//<i>//.count``, ``opt//<i>//.mu//gc1//w``, ...), where ``i`` is the
adam stage's place in the chain: 1 behind ``add_decayed_weights``, 0
without weight decay. HGNN's MultiStepLR position is the next stage's
``count``. gcn_tpu keeps its dropout stream as a JAX key (``__rng__``),
which the port cannot continue; the port keeps its generator's state under
``__torch_rng__`` (and its device type under ``__torch_rng_device__``),
which gcn_tpu ignores.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

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


def _atomic_savez(path: str, flat: dict) -> None:
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save_params(path: str, params) -> None:
    """Save a nested dict of tensors to ``path`` (npz, keys = paths)."""
    _atomic_savez(path, _flatten(params))


def load_params(path: str, like):
    """Load into the structure of ``like`` (shapes validated; dtype and
    device taken from ``like``'s tensors)."""
    with np.load(_npz_path(path)) as f:
        stored = dict(f)
    return params_from_numpy(_unflatten_like(stored, like),
                             *_device_dtype(like))


def _leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


def named_leaves(params, prefix: str = ""):
    """(path, tensor) of every leaf of a nested dict, in insertion order:
    the order in which the port hands parameters to its optimizers, so
    that position i of ``optimizer.state_dict()["state"]`` is leaf i."""
    for key, value in params.items():
        if isinstance(value, dict):
            yield from named_leaves(value, f"{prefix}{key}{_SEP}")
        else:
            yield prefix + str(key), value


def tree_like(like, leaves):
    """A nested dict shaped like ``like`` whose leaves are ``leaves``, in
    the order of ``named_leaves(like)``."""
    leaves = iter(leaves)

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else next(leaves)
                for k, v in tree.items()}

    return build(like)


@dataclasses.dataclass
class TrainingState:
    """What ``load_training_state`` reads back."""

    params: dict             # nested dict of tensors, shaped like the model
    adam_state: dict         # torch.optim.Adam state: {i: {step, exp_avg,
                             # exp_avg_sq}}, empty before the first step
    iteration: int           # optimizer updates done
    schedule_count: Optional[int]  # the learning-rate schedule's position
    rng_state: Optional[torch.Tensor]  # the port's dropout generator
    rng_device: Optional[str]          # the device type it belongs to
    jax_rng: bool            # gcn_tpu's JAX key is present (not usable)

    def restore_generator(self, generator: torch.Generator) -> None:
        """Continue the saved dropout stream in ``generator``. A checkpoint
        that has no stream of the generator's device type (gcn_tpu's JAX
        key, or a generator of the other device) leaves ``generator`` at
        its seed, with a warning: the resumed dropout masks then differ
        from an uninterrupted run's (with dropout 0 nothing differs)."""
        if (self.rng_state is not None
                and self.rng_device == generator.device.type):
            generator.set_state(self.rng_state)
            return
        if self.rng_state is not None:
            source = f"a {self.rng_device} generator's state"
        else:
            source = "gcn_tpu's JAX key" if self.jax_rng else "no stream"
        warnings.warn(
            f"the checkpoint holds {source}, which this "
            f"{generator.device.type} generator cannot continue: dropout "
            "restarts from the model's seed")


def _adam_prefix(adam_index: int) -> str:
    return f"opt{_SEP}{adam_index}{_SEP}"


def save_training_state(path: str, params, adam_state: dict,
                        iteration: int, *, adam_index: int = 1,
                        schedule_count: Optional[int] = None,
                        rng_state: Optional[torch.Tensor] = None,
                        rng_device: Optional[str] = None) -> None:
    """Full mid-training checkpoint in gcn_tpu's key layout: ``params``,
    torch.optim.Adam's state (``optimizer.state_dict()["state"]``, its
    indices those of ``named_leaves(params)``) as the adam stage
    ``adam_index`` of the optax chain, the iteration count, the schedule
    position (stage ``adam_index + 1``) when given, and the dropout
    generator's state (``generator.get_state()``) with its device type
    when given. Loads in gcn_tpu's ``load_training_state`` too."""
    flat = _flatten(params, f"params{_SEP}")
    opt = _adam_prefix(adam_index)
    count = 0
    for i, (name, leaf) in enumerate(named_leaves(params)):
        state = adam_state.get(i, {})
        if "step" in state:
            count = int(state["step"])
        for key, moment in ((".mu", "exp_avg"), (".nu", "exp_avg_sq")):
            value = state.get(moment)
            flat[f"{opt}{key}{_SEP}{name}"] = (
                np.zeros(tuple(leaf.shape), np.float32) if value is None
                else value.detach().cpu().numpy())
    flat[f"{opt}.count"] = np.asarray(count, dtype=np.int32)
    if schedule_count is not None:
        flat[f"{_adam_prefix(adam_index + 1)}.count"] = np.asarray(
            schedule_count, dtype=np.int32)
    flat["__iteration__"] = np.asarray(iteration, dtype=np.int64)
    if rng_state is not None:
        flat["__torch_rng__"] = rng_state.numpy()
        flat["__torch_rng_device__"] = np.asarray(rng_device)
    _atomic_savez(path, flat)


def load_training_state(path: str, params_like, *, adam_index: int = 1,
                        schedule: bool = False) -> TrainingState:
    """Read a training state written by ``save_training_state`` or by
    gcn_tpu's. Shapes are checked against ``params_like``, whose tensors
    also give the device and dtype; ``schedule`` reads the learning-rate
    schedule's position (stage ``adam_index + 1``)."""
    with np.load(_npz_path(path)) as f:
        stored = dict(f)
    params = params_from_numpy(
        _unflatten_like(stored, params_like, f"params{_SEP}"),
        *_device_dtype(params_like))
    opt = _adam_prefix(adam_index)
    if f"{opt}.count" not in stored:
        raise KeyError(f"checkpoint has no adam stage {opt!r}: its optimizer "
                       "chain differs (weight decay on in one run, off in "
                       "the other?)")
    count = int(stored[f"{opt}.count"])
    adam_state = {}
    if count > 0:
        mu = _unflatten_like(stored, params_like, f"{opt}.mu{_SEP}")
        nu = _unflatten_like(stored, params_like, f"{opt}.nu{_SEP}")
        mu_leaves = dict(named_leaves(mu))
        nu_leaves = dict(named_leaves(nu))
        for i, (name, leaf) in enumerate(named_leaves(params_like)):
            # on the parameters' device: the port's Adam is capturable on
            # a CUDA device (``train/optim.py``) and keeps its count there
            adam_state[i] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=leaf.device),
                "exp_avg": torch.as_tensor(mu_leaves[name], dtype=leaf.dtype,
                                           device=leaf.device),
                "exp_avg_sq": torch.as_tensor(nu_leaves[name],
                                              dtype=leaf.dtype,
                                              device=leaf.device)}
    schedule_count = None
    if schedule:
        key = f"{_adam_prefix(adam_index + 1)}.count"
        if key not in stored:
            raise KeyError(f"checkpoint has no schedule stage {key!r}")
        schedule_count = int(stored[key])
    rng = stored.get("__torch_rng__")
    return TrainingState(
        params=params, adam_state=adam_state,
        iteration=int(stored["__iteration__"]),
        schedule_count=schedule_count,
        rng_state=None if rng is None else torch.from_numpy(rng),
        rng_device=(str(stored["__torch_rng_device__"]) if rng is not None
                    else None),
        jax_rng="__rng__" in stored)


def _device_dtype(like):
    leaf = next(iter(_leaves(like)))
    return leaf.device, leaf.dtype


def snapshot(params):
    """Detached copy of a nested dict of tensors."""
    return {k: snapshot(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in params.items()}

