"""DeeperGCN (Li, Xiong, Thabet and Ghanem, "DeeperGCN: All You Need to
Train Deeper GCNs", arXiv:2006.07739), the ResGCN+ stack of GENConv
layers as its ogbn-arxiv run trains it (github.com/lightaime/deep_gcns_torch,
``examples/ogb/ogbn_arxiv/model.py::DeeperGCN``), with the
fit/predict/test surface of ``GAT``.

gcn_tpu has no DeeperGCN: this model is the port's own. With ``N(v)``
holding v itself (the run adds self loops) and L layers:

  * encoder: ``h0 = x W_enc + b_enc``;
  * ``h1 = GENConv_0(h0)``;
  * for l = 1 .. L-1, the pre-activation residual block (section 3.2,
    "ResGCN+": norm, ReLU, graph convolution, addition):
    ``h_{l+1} = h_l + GENConv_l(Dropout(ReLU(BN_{l-1}(h_l))))``;
  * head: ``log_softmax(Dropout(ReLU(BN_{L-1}(h_L))) W_out + b_out)``.

GENConv (``layers.gen_conv``): messages ``relu(h_u) + 1e-7``, their
per-channel softmax aggregation at a fixed temperature t whose weights
get no gradient (the run's ``softmax_sg``; ``ops.softmax_agg``, the
hand-written kernels on the card), added to ``h_v``, then one linear
layer (``mlp_layers`` 1). BN (``layers.batch_norm``) is BatchNorm1d over
all nodes: batch statistics in training, which also move its running
statistics (momentum 0.1, unbiased variance), and the running ones in
evaluation. Those running statistics are the model's buffers, state
beside its parameters that ``train.loop.fit_gcn`` guards, snapshots with
the best parameters and returns (``buffers=``).

The defaults are the run's: 28 layers, hidden 128, t 0.1, dropout 0.5,
Adam at lr 0.01 without decay; 491,176 parameters at ogbn-arxiv's 128
features and 40 classes. The initial draw is PyTorch's: every linear
layer's W and b from U(-1/sqrt(in), 1/sqrt(in)), BN's scale 1 and shift
0, from a CPU generator seeded with ``seed``.

``DeeperGCN.fit`` builds the layout (A + I, ``models.gat.self_loop_layout``,
the one GAT's attention walks) and uploads the features under a span
``deepergcn.layout``, then trains through ``fit_gcn`` (the captured loop
by default) with the dropout generator registered, as ``GCN.fit`` does.

The leaves, as (name, in, out), in the order the optimizer takes them
(``deepergcn_layers``): ``enc`` (in, hidden), ``conv0``, then ``norm<l-1>``
(1, hidden: the scale as ``w`` of shape (1, hidden), the shift as ``b``)
and ``conv<l>`` (hidden, hidden) for each block, ``norm<L-1>``, and
``out`` (hidden, nclass) last.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gcn_tpu_torch.models.gat import self_loop_layout
from gcn_tpu_torch.models.gcn import _as_dense_features
from gcn_tpu_torch.models.layers import batch_norm, dropout, gen_conv
from gcn_tpu_torch.ops.gat_attn import GatLayout
from gcn_tpu_torch.train.loop import fit_gcn
from gcn_tpu_torch.train.metrics import accuracy, masked_nll
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.device import resolve_device
from gcn_tpu_torch.utils.timers import Timers, span


def deepergcn_layers(nfeat: int, nclass: int, num_layers: int = 28,
                     hidden: int = 128) -> list:
    """The leaves' (name, in, out), in the optimizer's order."""
    if num_layers < 1:
        raise ValueError(f"DeeperGCN needs a layer, got {num_layers}")
    out = [("enc", nfeat, hidden), ("conv0", hidden, hidden)]
    for l in range(1, num_layers):
        out += [(f"norm{l - 1}", 1, hidden), (f"conv{l}", hidden, hidden)]
    return out + [(f"norm{num_layers - 1}", 1, hidden),
                  ("out", hidden, nclass)]


def init_deepergcn_params(generator: torch.Generator, layers,
                          device=None) -> dict:
    """PyTorch's initialisation, drawn on the CPU from ``generator`` and
    moved to ``device``: a linear layer's W (in, out) and b from
    U(-1/sqrt(in), 1/sqrt(in)) (``nn.Linear``'s), a norm's scale 1 and
    shift 0."""
    device = resolve_device(device)
    params = {}
    for name, n_in, n_out in layers:
        if name.startswith("norm"):
            params[name] = {"w": torch.ones((1, n_out), device=device),
                            "b": torch.zeros(n_out, device=device)}
            continue
        bound = 1.0 / n_in ** 0.5
        w = (2.0 * torch.rand((n_in, n_out), generator=generator) - 1.0)
        b = (2.0 * torch.rand(n_out, generator=generator) - 1.0)
        params[name] = {"w": (w * bound).to(device),
                        "b": (b * bound).to(device)}
    return params


def init_deepergcn_buffers(layers, device=None) -> dict:
    """Each norm's running statistics as BatchNorm1d starts them: mean 0,
    variance 1."""
    device = resolve_device(device)
    return {name: {"mean": torch.zeros(n_out, device=device),
                   "var": torch.ones(n_out, device=device)}
            for name, _, n_out in layers if name.startswith("norm")}


def deepergcn_forward(params: dict, buffers: dict, x: torch.Tensor,
                      layout: GatLayout, *, num_layers: int, t: float,
                      dropout_rate: float = 0.5, train: bool = False,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Log-probabilities (n, nclass) of the ResGCN+ stack over ``layout``.
    A training forward draws its dropout masks from ``generator`` and
    moves ``buffers`` in place; nothing is read back to the host, so a
    CUDA graph can capture it."""
    if train and dropout_rate > 0.0 and generator is None:
        raise ValueError("a training forward needs a generator for dropout")

    def pre_activation(h, l):
        z = batch_norm(params[f"norm{l}"], buffers[f"norm{l}"], h, train)
        return dropout(generator, torch.relu(z), dropout_rate, train)

    enc = params["enc"]
    h = torch.addmm(enc["b"], x, enc["w"])
    h = gen_conv(params["conv0"], layout, h, t)
    for l in range(1, num_layers):
        h = gen_conv(params[f"conv{l}"], layout, pre_activation(h, l - 1),
                     t) + h
    out = params["out"]
    logits = torch.addmm(out["b"], pre_activation(h, num_layers - 1),
                         out["w"])
    return torch.log_softmax(logits, dim=1)


class DeeperGCN:
    def __init__(self, nfeat: int, nclass: int, num_layers: int = 28,
                 hidden: int = 128, t: float = 0.1, dropout: float = 0.5,
                 lr: float = 0.01, weight_decay: float = 0.0, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.nfeat, self.nclass = nfeat, nclass
        self.num_layers, self.hidden = num_layers, hidden
        self.t, self.dropout = t, dropout
        self.lr, self.weight_decay, self.seed = lr, weight_decay, seed
        self.layers = deepergcn_layers(nfeat, nclass, num_layers, hidden)
        self.params = None
        self.buffers = None
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
        return init_deepergcn_params(gen, self.layers, self.device)

    def init_buffers(self) -> dict:
        return init_deepergcn_buffers(self.layers, self.device)

    def build_layout(self, adj) -> GatLayout:
        """The aggregation's layout of ``adj``'s pattern with self loops,
        on the model's device (GAT's); edge weights are not read."""
        return self_loop_layout(adj, self.device)

    def forward(self, params: dict, buffers: dict, x: torch.Tensor,
                layout: GatLayout, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return deepergcn_forward(params, buffers, x, layout,
                                 num_layers=self.num_layers, t=self.t,
                                 dropout_rate=self.dropout, train=train,
                                 generator=generator)

    def fit(self, features, adj, labels, idx_train, idx_val=None, *,
            train_iters: int = 100, initialize: bool = True,
            mode: str = "auto", patience: int = 100, verbose: bool = False,
            jit_loop: bool = True):
        """Train through ``train.loop.fit_gcn`` (the captured loop by
        default), after the layout and the features' upload, under the
        span ``deepergcn.layout``; the norms' running statistics are the
        loop's buffers, and the model keeps those of the chosen
        parameters."""
        x = _as_dense_features(features)
        self.labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                                      device=self.device)

        def index(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=torch.int64, device=self.device)

        if initialize or self.params is None:
            self.params = self.init_params()
            self.buffers = self.init_buffers()

        with span("deepergcn.layout"):
            self.layout = self.build_layout(adj)
            self.features = torch.as_tensor(x, device=self.device)

        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        buffers = self.buffers

        def forward(p, train):
            return self.forward(p, buffers, self.features, self.layout,
                                train, gen)

        result = fit_gcn(
            self.params, lambda ps: adam_l2(ps, self.lr, self.weight_decay),
            forward, self.labels, index(idx_train), index(idx_val),
            train_iters=train_iters, mode=mode, patience=patience,
            verbose=verbose, timers=self.timers, generator=gen,
            jit_loop=jit_loop, buffers=buffers)
        self.params = result.params
        self.output = result.log_probs
        self.history = result.history
        self.best_iter = result.best_iter
        return self

    def predict(self, features=None, adj=None) -> torch.Tensor:
        """Eval-mode log-probs under the running statistics; a fresh
        (features, adj) pair gets its own layout."""
        if features is None and adj is None:
            return self.output
        layout = self.build_layout(adj)
        x = torch.as_tensor(_as_dense_features(features),
                            device=self.device)
        with torch.no_grad():
            return self.forward(self.params, self.buffers, x, layout)

    def test(self, idx_test, verbose: bool = True) -> float:
        """Test accuracy on the stored outputs."""
        idx = torch.as_tensor(np.asarray(idx_test), dtype=torch.int64,
                              device=self.device)
        loss = float(masked_nll(self.output, self.labels, idx))
        acc = float(accuracy(self.output, self.labels, idx))
        if verbose:
            print(f"Test set results: loss= {loss:.4f} accuracy= {acc:.4f}")
        return acc
