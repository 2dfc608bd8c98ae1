"""Sharded GCN training over row bands.

The port of ``gcn_tpu.parallel.train_step``: full-batch 2-layer GCN with
the graph row-partitioned into shards (``parallel/partition.py``), weights
replicated, and the feature, label and mask rows split by band. Each
process runs the step for the shards it owns (``parallel/mesh.py``):

  * per layer, the fused boundary-rows-first aggregation over the
    pass-block partition (``halo.dist_spmm_halo_ell_overlap_blocks_xw``):
    the send rows' ``rows @ W`` leaves first, the interior K1 runs while it
    travels, the halo K1 after the wait, k-chunked at ``exchange_chunk``;
  * the loss is psum(masked NLL sum) / psum(mask count), as gcn_tpu's
    ``loss_shmap``: the count is all-reduced first (no gradient), each
    process back-propagates its bands' share (the exchanges carry the
    cross-band gradients), then every parameter gradient is all-reduced
    and each process takes the same Adam step.

Knobs ported: ``exchange`` "halo" (the ragged plan) or "all_gather" (the
baseline); ``kernel`` "ell" (K1, needs the halo) or "segsum" (``index_add``);
``overlap`` True / "blocks"; ``exchange_dtype`` None, "bf16" or "fp8" (the
halo wire); ``exchange_chunk`` ("auto" = ``k_pad``, None = no chunking);
``k_pad``. Not ported yet, each raising ``NotImplementedError`` (ROADMAP.md,
"Still to port"): ``exchange="halo_padded"``, ``exchange="halo_hier"``,
``overlap="split"`` and ``overlap=False``, ``model_axis``,
``exchange_dtype="auto"``.

Dropout draws each band's mask from a ``torch.Generator`` seeded from
(seed, iteration, band) (``band_seed``), so a resumed run equals an
uninterrupted one and the masks do not depend on how the shards are spread
over processes. JAX draws other bits, so parity with gcn_tpu holds at
dropout 0.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gcn_tpu_torch.models.layers import dropout as dropout_fn
from gcn_tpu_torch.parallel.mesh import Mesh
from gcn_tpu_torch.parallel.partition import ShardedGraph, pad_rows
from gcn_tpu_torch.utils.checkpoint import named_leaves

_EXCHANGES = ("halo", "halo_padded", "halo_hier", "all_gather")
_WIRES = {None: None, "bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, 'Still to port': {item})")


def band_seed(seed: int, iteration: int, band: int) -> int:
    """The dropout generator's seed of ``band`` at ``iteration``."""
    return int(np.random.SeedSequence([seed, iteration, band])
               .generate_state(1, np.uint64)[0])


def _psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.distributed:
        t = t.clone()
        dist.all_reduce(t)
    return t


def _all_reduce_grads(params) -> None:
    """Sum every parameter gradient over the processes, in one
    collective."""
    leaves = [t for _, t in named_leaves(params)]
    flat = torch.cat([t.grad.reshape(-1) for t in leaves])
    dist.all_reduce(flat)
    off = 0
    for t in leaves:
        t.grad.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def make_sharded_gcn_train_step(
    mesh: Mesh,
    sg: ShardedGraph,
    *,
    dropout: float = 0.5,
    with_relu: bool = True,
    exchange: str = "halo",
    kernel: str = None,
    overlap=True,
    model_axis: str = None,
    with_bias: bool = True,
    exchange_dtype: str = None,
    exchange_chunk="auto",
    k_pad: int = 32,
) -> Tuple[Callable, Callable, Callable]:
    """Returns ``(train_step, eval_fn, shard_fn)`` for the shards that
    ``mesh`` gives this process.

    ``shard_fn(x, labels, mask)`` takes the host arrays of every row (padded
    to ``sg.n_rows_padded`` or not) and returns ``(adj, xs, ys, ms)``: the
    owned shards' adjacency structures and bands on ``mesh.device``.
    ``train_step(params, opt, rng, adj, xs, ys, ms)`` takes one optimizer
    step on ``params`` (a nested dict of leaf tensors that require grad;
    ``opt`` was built over ``named_leaves(params)``) with the dropout stream
    ``rng = (seed, iteration)``, and returns the global loss (a 0-dim
    tensor). ``eval_fn(params, adj, xs)`` returns the owned bands'
    log-probs, stacked.

    ``with_relu=False`` drops layer 1's relu, and with it the dropout,
    which applies only after the relu, as in gcn_tpu. Each bias is added
    when ``params`` holds one; ``with_bias`` states whether they do
    (gcn_tpu needs it for the model axis's parameter specs, which the port
    does not have).
    """
    if exchange not in _EXCHANGES:
        raise ValueError(f"exchange must be one of {_EXCHANGES}")
    if exchange == "halo_padded":
        raise _not_ported("exchange='halo_padded'",
                          "the padded halo plan")
    if exchange == "halo_hier":
        raise _not_ported("exchange='halo_hier'",
                          "the hierarchical halo plan")
    if exchange_dtype == "auto":
        raise _not_ported("exchange_dtype='auto'",
                          "projection.py on H100 and NVLink numbers")
    if exchange_dtype not in _WIRES:
        raise ValueError(f"exchange_dtype must be one of {tuple(_WIRES)}")
    if exchange_dtype is not None and exchange != "halo":
        raise ValueError("exchange_dtype applies to the halo exchange only; "
                         "the all_gather baseline ships the compute dtype")
    if overlap not in (True, False, "blocks", "split"):
        raise ValueError("overlap must be True, False, 'blocks' or 'split'")
    if model_axis is not None:
        raise _not_ported("model_axis", "the 2-D model axis")
    if kernel is None:
        kernel = "segsum" if exchange == "all_gather" else "ell"
    if kernel not in ("segsum", "ell"):
        raise ValueError("kernel must be 'ell' or 'segsum'")
    if kernel == "ell" and exchange != "halo":
        raise ValueError("kernel='ell' requires the halo exchange")
    if kernel == "ell" and overlap not in (True, "blocks"):
        raise _not_ported(f"overlap={overlap!r}",
                          "overlap='split' and the monolithic layout")
    if exchange_chunk == "auto":
        exchange_chunk = k_pad

    from gcn_tpu_torch.parallel import halo, spmm_dist

    dev = mesh.device
    rps = sg.rows_per_shard
    owned = list(mesh.shards)

    def index(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    fused = None
    if exchange == "halo":
        plan = halo.build_halo_plan_ragged(sg)
        send_idx = [index(plan.send_idx[s]) for s in owned]
        ex_fn = halo.make_halo_exchange(plan, _WIRES[exchange_dtype])
        if kernel == "ell":
            ell_int, ell_halo = halo.build_sharded_ell_blocks(
                sg, plan, k_pad=k_pad, shards=owned, device=dev)
            extra = (ell_int, ell_halo)

            def fused(adj, xs, w):
                (e_int, e_halo), idx = adj
                return halo.dist_spmm_halo_ell_overlap_blocks_xw(
                    e_int, e_halo, idx, xs, w, mesh, ex_fn,
                    chunk=exchange_chunk)
        else:
            extra = [(index(sg.rows_local[s]), index(plan.col_remap[s]),
                      torch.as_tensor(sg.vals[s], device=dev))
                     for s in owned]

            def band_spmm(adj, hs):
                coo, idx = adj
                return halo.dist_spmm_halo(coo, idx, hs, rps, mesh, ex_fn)
    else:
        send_idx = None
        extra = [(index(sg.rows_local[s]), index(sg.cols[s]),
                  torch.as_tensor(sg.vals[s], device=dev)) for s in owned]

        def band_spmm(adj, hs):
            return spmm_dist.dist_spmm_gathered(adj[0], hs, rps, mesh)

    def layer(adj, hs, w):
        if fused is not None:
            return fused(adj, hs, w)
        return band_spmm(adj, [torch.matmul(h, w) for h in hs])

    def forward(params, adj, xs, rng, train):
        w1, b1 = params["gc1"]["w"], params["gc1"].get("b")
        w2, b2 = params["gc2"]["w"], params["gc2"].get("b")
        # bias after aggregation, as GraphConvolution: A (X W) + b
        hs = []
        for shard, h in zip(owned, layer(adj, xs, w1)):
            if b1 is not None:
                h = h + b1
            if with_relu:
                h = torch.relu(h)
                if train and dropout > 0:
                    gen = torch.Generator(device=dev).manual_seed(
                        band_seed(*rng, shard))
                    h = dropout_fn(gen, h, dropout, train=True)
            hs.append(h)
        out = layer(adj, hs, w2)
        if b2 is not None:
            out = [h + b2 for h in out]
        return [torch.log_softmax(h, dim=1) for h in out]

    def train_step(params, opt, rng, adj, xs, ys, ms):
        opt.zero_grad(set_to_none=True)
        lps = forward(params, adj, xs, rng, train=True)
        count = _psum(sum(m.sum() for m in ms), mesh)
        loss = sum(-(lp.gather(1, y[:, None])[:, 0] * m).sum()
                   for lp, y, m in zip(lps, ys, ms)) / count.clamp_min(1.0)
        loss.backward()
        if mesh.distributed:
            _all_reduce_grads(params)
        opt.step()
        return _psum(loss.detach(), mesh)

    def eval_fn(params, adj, xs):
        with torch.no_grad():
            return torch.cat(forward(params, adj, xs, None, train=False))

    def shard_fn(x, labels, mask):
        def bands(a, dtype):
            a = pad_rows(np.asarray(a), sg)
            return [torch.tensor(a[s * rps:(s + 1) * rps], dtype=dtype,
                                 device=dev) for s in owned]

        return ((extra, send_idx), bands(x, torch.float32),
                bands(labels, torch.int64), bands(mask, torch.float32))

    return train_step, eval_fn, shard_fn
