"""Graph convolution layer primitives (functional).

Numerics of the pygcn reference's ``GraphConvolution`` (gcn1.py:14-62), as
in ``gcn_tpu.models.layers``: weights (in, out), W and b drawn from
U(-1/sqrt(out), 1/sqrt(out)), output ``A (X W) + b``; the order ``(A X) W``
is the reference's ``GraphConvolution2`` (gcn3.py:87-92). ``gat_conv`` is
a GAT layer's attention heads (``models/gat.py``), ``gen_conv`` and
``batch_norm`` the layers of DeeperGCN (``models/deepergcn.py``); gcn_tpu
lacks all three.
"""

from __future__ import annotations

from typing import Dict

import torch

from gcn_tpu_torch.utils.device import resolve_device

# DeeperGCN's constants, as its ogbn-arxiv run sets them: GENConv's message
# epsilon, and BatchNorm1d's momentum and epsilon
MSG_EPS = 1e-7
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


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


def gen_conv(params: Dict[str, torch.Tensor], layout, h: torch.Tensor,
             t: float, eps: float = MSG_EPS) -> torch.Tensor:
    """DeeperGCN's GENConv (arXiv:2006.07739, eq. 4, as
    ``gcn_lib/sparse/torch_vertex.py::GENConv`` runs it for ogbn-arxiv):
    messages ``relu(h_u) + eps``, their per-channel softmax aggregation
    over ``N(v)`` at temperature ``t`` with the weights held constant
    (``ops.softmax_agg.softmax_aggregate`` over ``layout``, a ``GatLayout``
    of A + I), added to ``h_v``, then the one-layer MLP ``(h + a) W + b``."""
    from gcn_tpu_torch.ops.softmax_agg import softmax_aggregate

    a = softmax_aggregate(layout, torch.relu(h) + eps, t)
    return torch.addmm(params["b"], h + a, params["w"])


def batch_norm(params: Dict[str, torch.Tensor],
               buffers: Dict[str, torch.Tensor], h: torch.Tensor,
               train: bool) -> torch.Tensor:
    """``BatchNorm1d`` over the rows of ``h`` (n, C), functional: ``params``
    holds the affine scale as ``w`` (1, C) and shift as ``b`` (C,),
    ``buffers`` the running ``mean`` and ``var`` (C,). Training normalizes
    by the batch's statistics (the biased variance) and moves the running
    ones toward them in place (the unbiased variance, by ``BN_MOMENTUM``);
    evaluation normalizes by the running ones; ``BN_EPS`` is added to the
    variance. torch's own batch norm, whose CUDA kernels reduce in a fixed
    order and read nothing back to the host, so a CUDA graph can capture
    it and two calls agree bit for bit."""
    return torch.nn.functional.batch_norm(
        h, buffers["mean"], buffers["var"], params["w"].view(-1),
        params["b"], training=train, momentum=BN_MOMENTUM, eps=BN_EPS)
