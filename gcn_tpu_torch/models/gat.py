"""The graph attention network of Velickovic et al. (ICLR 2018,
arXiv:1710.10903), with the fit/predict/test surface of ``GCN``.

gcn_tpu has no GAT: this model is the port's own. Its layers follow the
paper's section 2.1 and the reference code (github.com/PetarV-/GAT,
``utils/layers.py::attn_head``, ``models/gat.py::inference``); the
defaults are the paper's inductive model (section 3.3), its largest
published widths:

  * layers 1 and 2: 4 heads of 256, concatenated (1,024 wide), then ELU;
  * layer 2 adds a skip across it: each head's input (1,024) differs from
    its output (256) in width, so ``attn_head`` adds a 1x1 projection of
    the input with a bias, which over the 4 heads is ``h1 W_res + b_res``
    (1,024 x 1,024), added before the ELU;
  * layer 3: 6 heads of ``nclass``, each with its own bias, averaged, no
    activation; then log-softmax;
  * no dropout and no L2 (the paper found no need for them); Adam at lr
    0.005 (``train.optim.adam_l2`` at decay 0).

A head computes ``Wh = h W``, the scores ``Wh . a_src`` and ``Wh . a_dst``
(plus ``attn_head``'s two logit biases), ``alpha_ij = softmax_j
LeakyReLU_0.2(a_dst . Wh_i + a_src . Wh_j)`` over ``j in N(i) + {i}``, and
``sum_j alpha_ij Wh_j + b``: ``layers.gat_conv`` over
``ops.gat_attn.gat_attention``, the hand-written kernels on the card.

Departures from the paper's PPI model, by what the port trains on:

  * the loss: PPI's 121 sigmoid labels become the dataset's classes, a
    masked NLL over the training rows (``train.metrics.masked_nll``), as
    the port's other models train;
  * the batch: the whole graph each step, where PPI took 2 graphs;
  * the two logit biases of each head are kept and trained: in
    ``attn_head`` they sit inside the LeakyReLU, so they do not cancel in
    the softmax (only their sum matters, and both get the same gradient);
  * the initial draw: Glorot uniform for every W (per head, as the 1x1
    convolutions), zeros for every bias, from a CPU generator seeded with
    ``seed``.

``GAT.fit`` builds the layout (A + I, ``device_adjacency(kind="coo")``,
``gat_attn.gat_layout``) and uploads the features under a span
``gat.layout``, as ``GCN.fit`` prepares its adjacency before the fit,
then trains through ``train.loop.fit_gcn`` (the captured loop by
default).

The leaves, as (name, in, out), in the order the optimizer takes them
(``gat_layers``): ``gat<l>`` (in, heads x width), ``att<l>`` (width, 2 x
heads), ``res<l>`` (in, heads x width) where the layer has the skip; the
last layer lists ``att`` first and its ``gat`` last, so that its W and b
close the list.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.models.gcn import _as_csr, _as_dense_features
from gcn_tpu_torch.models.layers import gat_conv
from gcn_tpu_torch.ops.adjacency import device_adjacency
from gcn_tpu_torch.ops.gat_attn import GatLayout, gat_layout
from gcn_tpu_torch.train.loop import fit_gcn
from gcn_tpu_torch.train.metrics import accuracy, masked_nll
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.device import resolve_device
from gcn_tpu_torch.utils.timers import Timers, span


def gat_layers(nfeat: int, nclass: int, heads: Sequence[int],
               hidden: Sequence[int], residual: Sequence[bool]) -> list:
    """The leaves' (name, in, out), in the optimizer's order."""
    if not len(heads) == len(hidden) + 1 == len(residual):
        raise ValueError(f"heads {tuple(heads)}, hidden {tuple(hidden)} and "
                         f"residual {tuple(residual)} do not describe the "
                         f"same layers")
    out, n_in = [], nfeat
    widths = list(hidden) + [nclass]
    for l, (h, f, res) in enumerate(zip(heads, widths, residual), start=1):
        gat, att = (f"gat{l}", n_in, h * f), (f"att{l}", f, 2 * h)
        skip = [(f"res{l}", n_in, h * f)] if res else []
        out += ([att, *skip, gat] if l == len(heads) else [gat, att, *skip])
        n_in = h * f
    return out


def init_gat_params(generator: torch.Generator, layers, heads,
                    device=None) -> dict:
    """Glorot uniform W (each head's fan: W and the skip ``in`` to
    ``width``, a_src and a_dst ``width`` to 1), zero biases, drawn on the
    CPU from ``generator``, then moved to ``device``."""
    device = resolve_device(device)
    params = {}
    n_heads = {f"{kind}{l}": h for l, h in enumerate(heads, start=1)
               for kind in ("gat", "att", "res")}
    for name, n_in, n_out in layers:
        h = n_heads[name]
        fan = (n_in + 1) if name.startswith("att") else (n_in + n_out // h)
        limit = (6.0 / fan) ** 0.5
        u = torch.rand((n_in, n_out), generator=generator)
        params[name] = {"w": ((2.0 * u - 1.0) * limit).to(device),
                        "b": torch.zeros(n_out, device=device)}
    return params


def gat_forward(params: dict, x: torch.Tensor, layout: GatLayout, *,
                heads: Sequence[int], residual: Sequence[bool],
                negative_slope: float = 0.2) -> torch.Tensor:
    """Log-probabilities (n, nclass) of the GAT over ``layout``; computes in
    x's dtype and reads nothing back to the host, so a CUDA graph can
    capture it."""
    h, n, last = x, x.shape[0], len(heads)
    for l, (n_heads, res) in enumerate(zip(heads, residual), start=1):
        gat = params[f"gat{l}"]
        out = gat_conv(gat, params[f"att{l}"], layout, h, n_heads,
                       negative_slope)
        out = out + gat["b"].view(n_heads, -1)
        if res:
            skip = params[f"res{l}"]
            out = out + (torch.matmul(h, skip["w"]) + skip["b"]).view(
                out.shape)
        h = (out.mean(dim=1) if l == last
             else torch.nn.functional.elu(out.reshape(n, -1)))
    return torch.log_softmax(h, dim=1)


def self_loop_layout(adj, device) -> GatLayout:
    """``gat_layout`` of ``adj``'s pattern with self loops (``N(i) +
    {i}``), through a ``CooAdj`` on ``device``; edge weights are not
    read. GAT's attention and DeeperGCN's aggregation walk it."""
    g = _as_csr(adj)
    g = CSRGraph(g.indptr, g.indices, np.ones(g.nnz, np.float32),
                 g.shape).with_self_loops()
    return gat_layout(device_adjacency(g, "coo", device=device))


class GAT:
    def __init__(self, nfeat: int, nclass: int,
                 heads: Sequence[int] = (4, 4, 6),
                 hidden: Sequence[int] = (256, 256),
                 residual: Sequence[bool] = (False, True, False),
                 negative_slope: float = 0.2, lr: float = 0.005,
                 weight_decay: float = 0.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.nfeat, self.nclass = nfeat, nclass
        self.heads, self.hidden = tuple(heads), tuple(hidden)
        self.residual = tuple(bool(r) for r in residual)
        self.negative_slope = negative_slope
        self.lr, self.weight_decay, self.seed = lr, weight_decay, seed
        self.layers = gat_layers(nfeat, nclass, self.heads, self.hidden,
                                 self.residual)
        self.params = None
        self.timers = Timers(self.device)
        self.layout: Optional[GatLayout] = None
        self.features = None
        self.labels = None
        self.output = None
        self.history = []
        self.best_iter = -1

    def init_params(self) -> dict:
        """Fresh parameters from a generator seeded with ``seed``."""
        gen = torch.Generator().manual_seed(self.seed)
        return init_gat_params(gen, self.layers, self.heads, self.device)

    def build_layout(self, adj) -> GatLayout:
        """The attention's layout of ``adj``'s pattern with self loops
        (``N(i) + {i}``), on the model's device; edge weights are not
        read."""
        return self_loop_layout(adj, self.device)

    def forward(self, params: dict, x: torch.Tensor,
                layout: GatLayout) -> torch.Tensor:
        return gat_forward(params, x, layout, heads=self.heads,
                           residual=self.residual,
                           negative_slope=self.negative_slope)

    def fit(self, features, adj, labels, idx_train, idx_val=None, *,
            train_iters: int = 100, initialize: bool = True,
            mode: str = "auto", patience: int = 100, verbose: bool = False,
            jit_loop: bool = True):
        """Train through ``train.loop.fit_gcn`` (the captured loop by
        default), after the layout and the features' upload, under the
        span ``gat.layout``."""
        x = _as_dense_features(features)
        self.labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                                      device=self.device)

        def index(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=torch.int64, device=self.device)

        if initialize or self.params is None:
            self.params = self.init_params()

        with span("gat.layout"):
            self.layout = self.build_layout(adj)
            self.features = torch.as_tensor(x, device=self.device)

        def forward(p, train):
            return self.forward(p, self.features, self.layout)

        result = fit_gcn(
            self.params, lambda ps: adam_l2(ps, self.lr, self.weight_decay),
            forward, self.labels, index(idx_train), index(idx_val),
            train_iters=train_iters, mode=mode, patience=patience,
            verbose=verbose, timers=self.timers, jit_loop=jit_loop)
        self.params = result.params
        self.output = result.log_probs
        self.history = result.history
        self.best_iter = result.best_iter
        return self

    def predict(self, features=None, adj=None) -> torch.Tensor:
        """Eval-mode log-probs; a fresh (features, adj) pair gets its own
        layout."""
        if features is None and adj is None:
            return self.output
        layout = self.build_layout(adj)
        x = torch.as_tensor(_as_dense_features(features),
                            device=self.device)
        with torch.no_grad():
            return self.forward(self.params, x, layout)

    def test(self, idx_test, verbose: bool = True) -> float:
        """Test accuracy on the stored outputs."""
        idx = torch.as_tensor(np.asarray(idx_test), dtype=torch.int64,
                              device=self.device)
        loss = float(masked_nll(self.output, self.labels, idx))
        acc = float(accuracy(self.output, self.labels, idx))
        if verbose:
            print(f"Test set results: loss= {loss:.4f} accuracy= {acc:.4f}")
        return acc
