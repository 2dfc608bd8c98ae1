"""A plain reference of the GAT (Velickovic et al., arXiv:1710.10903,
section 2.1; ``attn_head`` of github.com/PetarV-/GAT) for the CPU tests:
dense attention over a boolean mask of A + I, in plain torch, independent
of the port. It imports neither jax, gcn_tpu nor gcn_tpu_torch.

Parameters come as a dict ``{name: {"w", "b"}}`` with the port's leaf
names: ``gat<l>`` (in, heads x width), ``att<l>`` (width, 2 x heads; column
h a_src of head h, column heads + h its a_dst; ``b`` the two logit biases
a head), ``res<l>`` (in, heads x width) for a layer with the skip.
"""

from __future__ import annotations

import torch


def dense_attention(mask, wh, el, er, negative_slope=0.2):
    """(n, H, F): row i's softmax over {j : mask[i, j]} of
    LeakyReLU(er[i] + el[j]), per head, weighting wh[j]."""
    logits = torch.nn.functional.leaky_relu(
        er.T[:, :, None] + el.T[:, None, :], negative_slope)  # (H, n, n)
    logits = logits.masked_fill(~mask, float("-inf"))
    alpha = torch.softmax(logits, dim=-1)
    return torch.einsum("hij,jhf->ihf", alpha, wh)


def logits(params, x, mask, heads, residual, negative_slope=0.2):
    """The network's log-probabilities: concatenated heads and ELU in every
    layer but the last, whose heads are averaged; the skip where
    ``residual`` says."""
    h, last = x, len(heads)
    for l, (n_heads, res) in enumerate(zip(heads, residual), start=1):
        w, b = params[f"gat{l}"]["w"], params[f"gat{l}"]["b"]
        att = params[f"att{l}"]
        wh = (h @ w).view(h.shape[0], n_heads, -1)
        a = att["w"]
        el = torch.stack([wh[:, k] @ a[:, k] for k in range(n_heads)], 1)
        er = torch.stack([wh[:, k] @ a[:, n_heads + k]
                          for k in range(n_heads)], 1)
        el, er = el + att["b"][:n_heads], er + att["b"][n_heads:]
        out = dense_attention(mask, wh, el, er, negative_slope)
        out = out + b.view(n_heads, -1)
        if res:
            out = out + (h @ params[f"res{l}"]["w"]
                         + params[f"res{l}"]["b"]).view(out.shape)
        if l == last:
            h = out.mean(dim=1)
        else:
            h = torch.nn.functional.elu(out.reshape(h.shape[0], -1))
    return torch.log_softmax(h, dim=1)


def loss(params, x, mask, labels, idx, heads, residual):
    lp = logits(params, x, mask, heads, residual)
    return -lp[idx, labels[idx]].mean()


def adam_fit(params, x, mask, labels, idx, heads, residual, steps, lr,
             betas=(0.9, 0.999), eps=1e-8):
    """``steps`` steps of Adam (no decay) from ``params``: each step's loss
    and the parameters after the last, as a dict like ``params``."""
    p = {name: {k: t.detach().clone().requires_grad_(True)
                for k, t in layer.items()} for name, layer in params.items()}
    leaves = [t for layer in p.values() for t in layer.values()]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    losses = []
    for t in range(1, steps + 1):
        value = loss(p, x, mask, labels, idx, heads, residual)
        grads = torch.autograd.grad(value, leaves)
        losses.append(float(value.detach()))
        with torch.no_grad():
            for q, g, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(betas[0]).add_(g, alpha=1 - betas[0])
                vi.mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                step = (mi / (1 - betas[0] ** t)) / (
                    (vi / (1 - betas[1] ** t)).sqrt() + eps)
                q.sub_(lr * step)
    return losses, p
