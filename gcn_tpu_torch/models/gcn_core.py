"""Functional 2-layer GCN core: a params dict and a forward function.

The port of ``gcn_tpu.models.gcn_core``; the class with the fit/test/predict
surface is ``gcn_tpu_torch.models.gcn.GCN``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gcn_tpu_torch.models.layers import dropout, graph_conv, init_linear


def init_gcn_params(generator: torch.Generator, nfeat: int, nhid: int,
                    nclass: int, with_bias: bool = True, dtype=torch.float32,
                    device=None):
    """Both layers' parameters on ``device``: the card by default,
    ``device="cpu"`` for the CPU (``init_linear``)."""
    return {
        "gc1": init_linear(generator, nfeat, nhid, with_bias, dtype, device),
        "gc2": init_linear(generator, nhid, nclass, with_bias, dtype,
                           device),
    }


def gcn_forward(params, x: torch.Tensor, adj1, adj2=None, *,
                orders: Tuple[str, str] = ("a_xw", "a_xw"),
                dropout_rate: float = 0.5, with_relu: bool = True,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Returns log-probabilities (n, nclass): gc1 -> [relu] -> [dropout] ->
    gc2 -> log_softmax; dropout applies only with relu on (gcn1.py:131-137).
    """
    if adj2 is None:
        adj2 = adj1
    h = graph_conv(params["gc1"], adj1, x, orders[0])
    if with_relu:
        h = torch.relu(h)
        if train and dropout_rate > 0.0:
            if generator is None:
                raise ValueError("training forward needs a generator for "
                                 "dropout")
            h = dropout(generator, h, dropout_rate, train=True)
    h = graph_conv(params["gc2"], adj2, h, orders[1])
    return torch.log_softmax(h, dim=1)
