"""Two-layer GCN with the pygcn reference's API and variant ladder.

The port of ``gcn_tpu.models.gcn.GCN``. The variants differ only in
contraction order, adjacency representation and preprocessing:

  v1  both layers A(XW)
  v2  layer-1 aggregation A@X hoisted out of the training loop
  v3  layer 2 uses (AX)W
  v4  contraction order chosen from the layer widths
  v5  v4 (instrumented in the reference; the same math here)
  v6  v4 + vertex reorder (rabbit, then degree sort) -> packed-ELL tiling
      -> kernel K1, with features, labels and index sets permuted to match

Everything runs on ``device``: the card (``cuda``) unless the caller passes
``device="cpu"``. ``predict()`` and ``output`` are always in the caller's
original vertex order. ``save_state`` and ``fit(..., resume_from=path)``
continue a run across processes and across the two packages
(``utils.checkpoint``); ``adj_options={"freq_split": True}`` trains over the
frequency-split tables (``tile/freq_split.py``). ``profile_ops`` prints the
per-op table (xw, af, bi of each layer, forward, backward) of a fitted
model.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.models.gcn_core import gcn_forward, init_gcn_params
from gcn_tpu_torch.models.layers import auto_order
from gcn_tpu_torch.ops.adjacency import device_adjacency
from gcn_tpu_torch.ops.permute import inverse_permutation
from gcn_tpu_torch.ops.spmm import hoist_spmm, spmm
from gcn_tpu_torch.train.loop import fit_gcn
from gcn_tpu_torch.train.metrics import accuracy, masked_nll
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.device import resolve_device
from gcn_tpu_torch.utils.timers import Timers

_VARIANTS = ("v1", "v2", "v3", "v4", "v5", "v6")


def _as_csr(adj) -> CSRGraph:
    if isinstance(adj, CSRGraph):
        return adj
    if hasattr(adj, "tocsr"):  # scipy
        return CSRGraph.from_scipy(adj)
    return CSRGraph.from_dense(np.asarray(adj))


def _as_dense_features(x) -> np.ndarray:
    if hasattr(x, "todense"):
        x = np.asarray(x.todense())
    return np.asarray(x, dtype=np.float32)


class GCN:
    def __init__(
        self,
        nfeat: int,
        nhid: int,
        nclass: int,
        dropout: float = 0.5,
        lr: float = 0.01,
        weight_decay: float = 5e-4,
        with_relu: bool = True,
        with_bias: bool = True,
        variant: str = "v4",
        adj_kind: Optional[str] = None,
        reorder: Optional[str] = None,
        seed: int = 0,
        dtype=torch.float32,
        hoist_ax: Optional[bool] = None,
        adj_options: Optional[dict] = None,
        device=None,
    ):
        if variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {_VARIANTS}")
        self.device = resolve_device(device)
        self.nfeat, self.nhid, self.nclass = nfeat, nhid, nclass
        # layer-1 A@X is training-invariant whenever layer 1 runs A(XW)
        if hoist_ax is None:
            hoist_ax = variant in ("v2", "v4", "v5", "v6")
        self.hoist_ax = hoist_ax or variant == "v2"
        self.dropout = dropout
        self.lr = lr
        self.weight_decay = weight_decay if with_relu else 0.0
        self.with_relu = with_relu
        self.with_bias = with_bias
        self.variant = variant
        self.reorder = reorder if reorder is not None else (
            "rabbit" if variant == "v6" else None)
        if adj_kind is None:
            adj_kind = "ell" if variant == "v6" else "auto"
        self.adj_kind = adj_kind
        self.adj_options = dict(adj_options or {})
        self.seed = seed
        self.dtype = dtype

        self.params = None
        self.timers = Timers(self.device)
        self.adj_norm = None          # device adjacency (possibly permuted)
        self.features = None          # device features (possibly permuted)
        self.labels = None            # device labels (possibly permuted)
        self.perm = None              # perm[new] = old vertex id, or None
        self._inv_perm = None         # inv[old] = new
        self.output = None            # eval-mode log-probs, ORIGINAL order
        self.history = []
        self.best_iter = -1
        self._hoisted_ax = None
        self._iters_done = 0

    def init_params(self):
        """Fresh parameters from a generator seeded with ``seed``."""
        gen = torch.Generator().manual_seed(self.seed)
        return init_gcn_params(gen, self.nfeat, self.nhid, self.nclass,
                               self.with_bias, self.dtype, self.device)

    # ------------------------------------------------------------------ fit

    def _orders(self):
        l1 = "xw" if self.hoist_ax else "a_xw"
        if self.variant == "v1":
            return (l1, "a_xw")
        if self.variant == "v2":
            return ("xw", "a_xw")
        if self.variant == "v3":
            return (l1, "ax_w")
        return (l1, auto_order(self.nhid, self.nclass))

    def _build_adjacency(self, g: CSRGraph, *, normalized: bool = True):
        """reorder -> degree sort (ELL) -> device adjacency. Returns
        (device_adj, perm) with perm[new] = old (or None)."""
        perm = None
        if self.reorder:
            from gcn_tpu_torch.reorder import reorder_graph

            g, perm = reorder_graph(g, method=self.reorder)
        if self.adj_kind == "ell":
            from gcn_tpu_torch.tile.ell import degree_sort_order

            ds = degree_sort_order(g)
            g = g.permute(ds)
            perm = ds if perm is None else perm[ds]
            if self.adj_options.get("freq_split"):
                # part-aware order: each segment (hot prefix, cold tail)
                # re-sorted by cold-part degree, composed into the chain
                from gcn_tpu_torch.tile.freq_split import freq_split_order

                po = freq_split_order(
                    g, hot_rows=self.adj_options.get("hot_rows"),
                    table_bf16=bool(self.adj_options.get("table_bf16")))
                if po is not None:
                    g = g.permute(po)
                    perm = perm[po]

        kind = self.adj_kind
        kwargs = {}
        if kind == "auto" and max(g.shape) > 8192:
            kind = "coo"
        if kind in ("coo", "ell"):
            # the normalization of a symmetric adjacency is symmetric
            kwargs["symmetric"] = True if normalized else None
        if kind == "ell":
            # k_pad >= the widest SpMM operand (min side of each layer)
            widest = max(min(self.nhid, self.nfeat),
                         min(self.nhid, self.nclass))
            kwargs["k_pad"] = next(k for k in (32, 64, 128)
                                   if k >= min(widest, 128))
            kwargs.update(self.adj_options)
        elif self.adj_options:
            import warnings

            warnings.warn(
                f"adj_options {sorted(self.adj_options)} only apply to the "
                f"'ell' adjacency; resolved kind is {kind!r} — ignored")
        return device_adjacency(g, kind, device=self.device, **kwargs), perm

    def _remap_idx(self, idx):
        idx = np.asarray(idx)
        if self._inv_perm is not None:
            idx = self._inv_perm[idx]
        return torch.as_tensor(idx, dtype=torch.int64, device=self.device)

    def _adam_index(self) -> int:
        """The adam stage's place in gcn_tpu's optax chain (``adam_l2``):
        behind ``add_decayed_weights`` when there is weight decay."""
        return 1 if self.weight_decay else 0

    def fit(self, features, adj, labels, idx_train, idx_val=None, *,
            train_iters: int = 200, initialize: bool = True,
            verbose: bool = False, normalize: bool = True,
            patience: int = 500, mode: str = "auto",
            name: str = "dataset", dump_adj_csv: Optional[str] = None,
            resume_from: Optional[str] = None):
        """Train; ``resume_from`` continues from a ``save_state`` checkpoint
        of either package (params, Adam state, iteration count and, from
        this package on the same device type, the dropout stream).
        ``dump_adj_csv`` names a directory to write the normalized
        adjacency to, as ``<name>.csv`` (``utils/writecsv.py``), before any
        reordering."""
        g = _as_csr(adj)
        x = _as_dense_features(features)
        labels_np = np.asarray(labels)
        if normalize:
            g = gcn_normalize(g)
        if dump_adj_csv:
            from gcn_tpu_torch.utils.writecsv import write as write_csv

            write_csv(g, name, dump_adj_csv)

        self.perm = self._inv_perm = None
        adj_dev, perm = self._build_adjacency(g, normalized=normalize)
        if perm is not None:
            self.perm = perm
            self._inv_perm = inverse_permutation(perm)
            x = x[perm]
            labels_np = labels_np[perm]
        self.adj_norm = adj_dev
        self.features = torch.as_tensor(x, dtype=self.dtype,
                                        device=self.device)
        self.labels = torch.as_tensor(labels_np, dtype=torch.int64,
                                      device=self.device)
        idx_train = self._remap_idx(idx_train)
        idx_val = self._remap_idx(idx_val) if idx_val is not None else None

        if initialize or self.params is None:
            self.params = self.init_params()
        self._iters_done = 0
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        opt_state = None
        if resume_from is not None:
            from gcn_tpu_torch.utils.checkpoint import load_training_state

            state = load_training_state(resume_from, self.params,
                                        adam_index=self._adam_index())
            self.params, opt_state = state.params, state.adam_state
            self._iters_done = state.iteration
            state.restore_generator(gen)
            if mode not in ("auto", "no_val") or idx_val is not None:
                import warnings

                warnings.warn(
                    "resume_from restores params/optimizer/rng but NOT the "
                    "best-validation snapshot or patience counter: best-val "
                    "tracking restarts at the resume point")

        orders = self._orders()
        feats = self.features
        if self.hoist_ax:
            with self.timers("hoist_ax").d as t:
                self._hoisted_ax = t.fence(hoist_spmm(self.adj_norm,
                                                      self.features))
            feats = self._hoisted_ax
        adj_n = self.adj_norm

        def forward(p, train):
            return gcn_forward(p, feats, adj_n, adj_n, orders=orders,
                               dropout_rate=self.dropout,
                               with_relu=self.with_relu, train=train,
                               generator=gen)

        result = fit_gcn(
            self.params, lambda ps: adam_l2(ps, self.lr, self.weight_decay),
            forward, self.labels, idx_train, idx_val,
            train_iters=train_iters, mode=mode, patience=patience,
            verbose=verbose, timers=self.timers, opt_state=opt_state,
            start_iter=self._iters_done, generator=gen)
        self.params = result.params
        self.opt_state = result.opt_state
        self._final_params = result.final_params
        self._rng_state = result.rng_state
        self._iters_done += result.iters_run
        lp = result.log_probs
        if self.perm is not None:
            lp = lp[torch.as_tensor(self._inv_perm, device=self.device)]
        self.output = lp
        self.history = result.history
        self.best_iter = result.best_iter
        return self

    # ----------------------------------------------------------- evaluation

    def predict(self, features=None, adj=None):
        """Eval-mode log-probs in original vertex order. A fresh
        (features, adj) pair runs the same pipeline as fit."""
        if features is None and adj is None:
            return self.output
        g = gcn_normalize(_as_csr(adj))
        x = _as_dense_features(features)
        rep, perm = self._build_adjacency(g, normalized=True)
        if perm is not None:
            x = x[perm]
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        orders = self._orders()
        if orders[0] == "xw":
            x = hoist_spmm(rep, x)
        with torch.no_grad():
            lp = gcn_forward(self.params, x, rep, rep, orders=orders,
                             dropout_rate=self.dropout,
                             with_relu=self.with_relu, train=False)
        if perm is not None:
            lp = lp[torch.as_tensor(inverse_permutation(perm),
                                    device=self.device)]
        return lp

    def profile_ops(self, n_iters: int = 20, warmup: int = 5,
                    verbose: bool = True) -> Timers:
        """Per-op timing table of the v5/v6 instrumentation: xw (X@W), af
        (the SpMM aggregation) and bi (bias) of each layer, then the whole
        forward and backward, under this variant's contraction orders and
        hoisted features (a hoisted layer 1 has no af row: its SpMM ran in
        preprocessing). Each op runs alone and is timed with the device
        timers (``utils/timers.py``: CUDA events on the card, the host
        clock on the CPU), so the rows are per-op upper bounds. Rows keep
        the first ``warmup`` iterations out; returns the timers."""
        if self.params is None or self.adj_norm is None:
            raise RuntimeError("call fit() first")
        t = Timers(self.device)
        adj = self.adj_norm
        orders = self._orders()
        feats = self._hoisted_ax if orders[0] == "xw" else self.features
        p = {name: {k: v.detach().requires_grad_(True)
                    for k, v in layer.items()}
             for name, layer in self.params.items()}
        leaves = [v for layer in p.values() for v in layer.values()]

        def layer(prefix, h, w, b, order):
            if order == "ax_w":            # (A h) W
                with t(f"{prefix}_af").d:
                    h = spmm(adj, h)
                with t(f"{prefix}_xw").d:
                    h = torch.matmul(h, w)
            else:                          # A (h W); "xw" = hoisted, no af
                with t(f"{prefix}_xw").d:
                    h = torch.matmul(h, w)
                if order == "a_xw":
                    with t(f"{prefix}_af").d:
                        h = spmm(adj, h)
            if b is not None:
                with t(f"{prefix}_bi").d:
                    h = h + b
            return h

        def fwd():
            return gcn_forward(p, feats, adj, adj, orders=orders,
                               dropout_rate=0.0, with_relu=self.with_relu,
                               train=False)

        for i in range(n_iters + warmup):
            if i == warmup:
                t.reset()
            with torch.no_grad():
                h = layer("l1", feats, p["gc1"]["w"], p["gc1"].get("b"),
                          orders[0])
                h = torch.relu(h)
                layer("l2", h, p["gc2"]["w"], p["gc2"].get("b"), orders[1])
                with t("fwd").d:
                    fwd()
            with t("bwd").d:
                torch.autograd.grad(fwd().sum(), leaves)
        if verbose:
            print(t.report())
        return t

    def save_state(self, path: str) -> None:
        """Save the full resumable training state (last-iterate params,
        Adam state, iteration count, dropout stream) in gcn_tpu's layout;
        continue with ``fit(..., resume_from=path)`` in either package."""
        from gcn_tpu_torch.utils.checkpoint import save_training_state

        if getattr(self, "opt_state", None) is None:
            raise RuntimeError("nothing to save: call fit() first")
        save_training_state(path, self._final_params, self.opt_state,
                            self._iters_done, adam_index=self._adam_index(),
                            rng_state=self._rng_state,
                            rng_device=self.device.type)

    def save(self, path: str) -> None:
        """Save trained parameters (npz with gcn_tpu's keys)."""
        from gcn_tpu_torch.utils.checkpoint import save_params

        if self.params is None:
            raise RuntimeError("nothing to save: call fit() first")
        save_params(path, self.params)

    def load(self, path: str) -> "GCN":
        """Load parameters saved by ``save`` or by ``gcn_tpu``."""
        from gcn_tpu_torch.utils.checkpoint import load_params

        like = self.params if self.params is not None else self.init_params()
        self.params = load_params(path, like)
        return self

    def test(self, idx_test, verbose: bool = True):
        """Test accuracy on the stored outputs."""
        idx = torch.as_tensor(np.asarray(idx_test), dtype=torch.int64,
                              device=self.device)
        labels = self.labels
        if self.perm is not None:
            # output is in original order; un-permute labels to match
            labels = labels[torch.as_tensor(self._inv_perm,
                                            device=self.device)]
        loss = float(masked_nll(self.output, labels, idx))
        acc = float(accuracy(self.output, labels, idx))
        if verbose:
            print(f"Test set results: loss= {loss:.4f} accuracy= {acc:.4f}")
        return acc
