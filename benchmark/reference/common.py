"""Plain PyTorch pieces of the references: the sparse aggregation, the
matrix product in a chosen precision, dropout masks from a seed, and Adam
with classic L2 decay written out by hand.

Nothing here imports the program. Precisions: ``"float64"`` (the
yardstick every number is compared with), ``"float32"``, and ``"tf32"``,
float32 whose dense matrix products take their operands rounded to TF32
(10 mantissa bits, to nearest even) with float32 sums, as the tensor cores
take them when TF32 is switched on: the control, the step below the
float32 that the configurations state. The rounding is written out, so the
control reads the same on the card and on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "tf32": torch.float32}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return tf32(g) @ tf32(b).T, tf32(a).T @ tf32(g)


def matmul(a, b, precision: str):
    """``a @ b``, with TF32 operands under ``"tf32"``."""
    if precision == "tf32":
        return _Tf32Matmul.apply(a, b)
    return a @ b


class SparseOperator:
    """A fixed sparse matrix S as coalesced torch sparse tensors of S and
    S^T, applied as a differentiable ``S @ x`` (the gradient of x is
    ``S^T @ g``)."""

    def __init__(self, rows, cols, vals, shape, device, dtype):
        rows = torch.as_tensor(rows, dtype=torch.int64)
        cols = torch.as_tensor(cols, dtype=torch.int64)
        vals = torch.as_tensor(vals, dtype=torch.float64)

        def coo(r, c, v, size):
            return torch.sparse_coo_tensor(
                torch.stack([r, c]), v, size, check_invariants=True
            ).coalesce().to(device=device, dtype=dtype)

        self.mat = coo(rows, cols, vals, shape)
        self.t_mat = coo(cols, rows, vals, (shape[1], shape[0]))
        self.nnz = int(vals.numel())

    def __call__(self, x):
        return _Apply.apply(x, self)


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return torch.sparse.mm(op.mat, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.op.t_mat, g.contiguous()), None


def dropout_masks(dropout_seed: int, shape, steps: int, keep: float,
                  device, perm=None):
    """The keep masks of ``steps`` training steps, one at a time: one
    ``torch.rand`` of ``shape`` a step from a generator on ``device``
    seeded with ``dropout_seed``, kept where below ``keep`` (the draw the
    model's inverted dropout makes). ``perm[i]`` is the vertex that row
    ``i`` of a draw belongs to, when the draws are laid out in another
    order than the reference's (a reordered graph); None for the same
    order."""
    if perm is not None and not np.array_equal(np.sort(perm),
                                               np.arange(shape[0])):
        raise ValueError("the row order is not a permutation of the rows")
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    for _ in range(steps):
        draw = torch.rand(shape, generator=gen, device=device) < keep
        if perm is not None:
            placed = torch.empty_like(draw)
            placed[torch.as_tensor(perm, device=device)] = draw
            draw = placed
        yield draw


@dataclasses.dataclass
class Steps:
    """What the steps of a fit give: each step's training loss, the
    gradient the optimizer was handed at step 1 (L2 term included), the
    parameters after the last step, leaf by leaf, and after each step
    count asked for in ``at``."""

    losses: List[float]
    grad1: List[torch.Tensor]
    params: List[torch.Tensor]
    at: Dict[int, List[torch.Tensor]]


def adam_steps(loss_fn, p0: List[torch.Tensor], masks, *, lrs,
               weight_decay: float, betas, eps: float, at=()) -> Steps:
    """A step of Adam with classic L2 decay (``wd * p`` added to the
    gradient before the moments) from ``p0`` for each mask of ``masks``;
    ``loss_fn(params, mask)`` is one step's loss, ``lrs[t]`` step t's
    learning rate; the parameters are kept after each step count in
    ``at``."""
    b1, b2 = betas
    params = [p.detach().clone().requires_grad_(True) for p in p0]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, grad1, kept = [], None, {}
    for t, mask in enumerate(masks, start=1):
        loss = loss_fn(params, mask)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = [g + weight_decay * p for g, p in zip(grads, params)]
            if grad1 is None:
                grad1 = [g.clone() for g in grads]
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = mi / (1 - b1 ** t)
                v_hat = vi / (1 - b2 ** t)
                p.sub_(lrs[t - 1] * m_hat / (v_hat.sqrt() + eps))
            if t in at:
                kept[t] = [p.detach().clone() for p in params]
    return Steps(losses=losses, grad1=grad1,
                 params=[p.detach() for p in params], at=kept)
