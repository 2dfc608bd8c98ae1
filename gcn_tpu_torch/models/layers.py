"""Graph convolution layer primitives (functional).

Numerics of the pygcn reference's ``GraphConvolution`` (gcn1.py:14-62), as
in ``gcn_tpu.models.layers``: weights (in, out), W and b drawn from
U(-1/sqrt(out), 1/sqrt(out)), output ``A (X W) + b``; the order ``(A X) W``
is the reference's ``GraphConvolution2`` (gcn3.py:87-92). ``gat_conv`` is
a GAT layer's attention heads (``models/gat.py``), which gcn_tpu lacks.
"""

from __future__ import annotations

from typing import Dict

import torch

from gcn_tpu_torch.utils.device import resolve_device


def init_linear(generator: torch.Generator, n_in: int, n_out: int,
                with_bias: bool = True, dtype=torch.float32,
                device=None) -> Dict[str, torch.Tensor]:
    """U(-1/sqrt(out), 1/sqrt(out)) weights drawn from ``generator`` (on the
    CPU, so every device gets the same numbers), then moved to ``device``:
    the card by default (``utils.device.resolve_device``), ``device="cpu"``
    for the CPU."""
    device = resolve_device(device)
    stdv = 1.0 / (n_out ** 0.5)

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=dtype)
        return ((2.0 * u - 1.0) * stdv).to(device)

    params = {"w": uniform((n_in, n_out))}
    if with_bias:
        params["b"] = uniform((n_out,))
    return params


def graph_conv(params: Dict[str, torch.Tensor], adj, x: torch.Tensor,
               order: str = "a_xw") -> torch.Tensor:
    """One graph convolution.

    order:
      "a_xw" — A @ (X @ W): SpMM at width n_out.
      "ax_w" — (A @ X) @ W: SpMM at width n_in.
      "xw"   — X @ W only: the aggregation was hoisted upstream.
    """
    from gcn_tpu_torch.ops.spmm import spmm

    w = params["w"]
    if order == "a_xw":
        h = spmm(adj, torch.matmul(x, w))
    elif order == "ax_w":
        h = torch.matmul(spmm(adj, x), w)
    elif order == "xw":
        h = torch.matmul(x, w)
    else:
        raise ValueError(f"unknown contraction order {order!r}")
    if "b" in params:
        h = h + params["b"]
    return h


def auto_order(n_in: int, n_out: int) -> str:
    """The contraction order that runs the SpMM at the narrower width."""
    return "a_xw" if n_out <= n_in else "ax_w"


def dropout(generator: torch.Generator, x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout; the mask is drawn from ``generator`` (which lives
    on x's device). Inside a captured CUDA graph the generator must be
    registered with the graph (``train/capture.py`` does so), or every
    replay would draw the captured masks again."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def gat_conv(params: Dict[str, torch.Tensor], att: Dict[str, torch.Tensor],
             layout, x: torch.Tensor, heads: int,
             negative_slope: float = 0.2) -> torch.Tensor:
    """The heads of one GAT layer (arXiv:1710.10903, eqs. 1-4), before its
    bias: returns (n, heads, width), head h's ``sum_j alpha_ij (x W)[j, h]``.

    ``params["w"]`` is (in, heads * width), the heads' W side by side;
    ``att["w"]`` is (width, 2 * heads), column h head h's ``a_src`` and
    column heads + h its ``a_dst``, and ``att["b"]`` their two logit biases
    a head (``attn_head``'s two 1x1 convolutions carry them, inside the
    LeakyReLU). Both scores of every head come from one product, ``x (W
    a)``, which equals ``(x W) a``; the aggregation is
    ``ops.gat_attn.gat_attention`` over ``layout`` (a ``GatLayout``)."""
    from gcn_tpu_torch.ops import gat_attn

    w = params["w"]
    width = w.shape[1] // heads
    wh = torch.matmul(x, w).view(x.shape[0], heads, width)
    wa = torch.einsum("ihf,fsh->ish", w.view(-1, heads, width),
                      att["w"].view(width, 2, heads)).reshape(-1, 2 * heads)
    scores = torch.matmul(x, wa) + att["b"]
    return gat_attn.gat_attention(layout, wh, scores[:, :heads],
                                  scores[:, heads:], negative_slope)
