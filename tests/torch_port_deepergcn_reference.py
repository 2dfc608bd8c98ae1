"""A plain reference of DeeperGCN (Li et al., arXiv:2006.07739; the ResGCN+
stack of GENConv layers that github.com/lightaime/deep_gcns_torch trains on
ogbn-arxiv) for the CPU tests: dense per-channel softmax over a boolean
mask of A + I, its weights computed under ``torch.no_grad()`` (the run's
``softmax_sg``), and ``torch.nn.functional.batch_norm`` with explicit
running buffers, in plain torch, independent of the port. It imports
neither jax, gcn_tpu nor gcn_tpu_torch.

Parameters come as a dict ``{name: {"w", "b"}}`` with the port's leaf
names: ``enc``, ``conv<l>`` (in, out), ``norm<l>`` (``w`` the scale of
shape (1, C), ``b`` the shift), ``out``; buffers as ``{norm<l>: {"mean",
"var"}}``. Dropout draws its keep masks from ``generator`` as the port's
inverted dropout does: one ``torch.rand`` of the activation's shape a
dropout, in the forward's order, kept where below 1 - rate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_aggregate(mask, m, t, detach_weights=True):
    """(n, k): row v's per-channel softmax over {u : mask[v, u]} of t m[u],
    weighting m[u]; the weights under ``no_grad`` unless
    ``detach_weights`` is False."""
    n, k = m.shape

    def weights():
        logits = (t * m).unsqueeze(0).expand(n, n, k)
        logits = logits.masked_fill(~mask.unsqueeze(-1), float("-inf"))
        return torch.softmax(logits, dim=1)

    if detach_weights:
        with torch.no_grad():
            alpha = weights()
    else:
        alpha = weights()
    return torch.einsum("vuc,uc->vc", alpha, m)


def gen_conv(p, mask, h, t, eps=1e-7):
    return (h + dense_aggregate(mask, torch.relu(h) + eps, t)) @ p["w"] \
        + p["b"]


def logits(params, buffers, x, mask, num_layers, t, *, train=False,
           dropout=0.0, generator=None):
    """The network's log-probabilities; a training forward moves
    ``buffers`` in place."""

    def drop(z):
        if not train or dropout <= 0.0:
            return z
        keep = torch.rand(z.shape, generator=generator) < 1.0 - dropout
        return torch.where(keep, z / (1.0 - dropout), torch.zeros_like(z))

    def pre_activation(h, l):
        p, b = params[f"norm{l}"], buffers[f"norm{l}"]
        z = F.batch_norm(h, b["mean"], b["var"], p["w"].view(-1), p["b"],
                         training=train, momentum=0.1, eps=1e-5)
        return drop(torch.relu(z))

    h = x @ params["enc"]["w"] + params["enc"]["b"]
    h = gen_conv(params["conv0"], mask, h, t)
    for l in range(1, num_layers):
        h = gen_conv(params[f"conv{l}"], mask, pre_activation(h, l - 1),
                     t) + h
    out = pre_activation(h, num_layers - 1) @ params["out"]["w"] \
        + params["out"]["b"]
    return torch.log_softmax(out, dim=1)


def loss(lp, labels, idx):
    return -lp[idx, labels[idx]].mean()


def adam_fit(params, buffers, x, mask, labels, idx, num_layers, t, steps,
             lr, dropout=0.0, generator=None, betas=(0.9, 0.999), eps=1e-8):
    """``steps`` steps of Adam (no decay) from ``params`` and ``buffers``
    (copied): each step's loss, and the parameters and buffers after the
    last, as dicts like the inputs."""
    p = {name: {k: v.detach().clone().requires_grad_(True)
                for k, v in layer.items()} for name, layer in params.items()}
    bufs = {name: {k: v.clone() for k, v in b.items()}
            for name, b in buffers.items()}
    leaves = [v for layer in p.values() for v in layer.values()]
    m = [torch.zeros_like(v) for v in leaves]
    v2 = [torch.zeros_like(v) for v in leaves]
    losses = []
    for step in range(1, steps + 1):
        value = loss(logits(p, bufs, x, mask, num_layers, t, train=True,
                            dropout=dropout, generator=generator),
                     labels, idx)
        grads = torch.autograd.grad(value, leaves)
        losses.append(float(value.detach()))
        with torch.no_grad():
            for q, g, mi, vi in zip(leaves, grads, m, v2):
                mi.mul_(betas[0]).add_(g, alpha=1 - betas[0])
                vi.mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                upd = (mi / (1 - betas[0] ** step)) / (
                    (vi / (1 - betas[1] ** step)).sqrt() + eps)
                q.sub_(lr * upd)
    return losses, p, bufs
