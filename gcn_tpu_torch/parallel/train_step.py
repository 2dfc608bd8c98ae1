"""Sharded GCN training over row bands, with an optional model axis.

The port of ``gcn_tpu.parallel.train_step``: full-batch 2-layer GCN with
the graph row-partitioned into bands (``parallel/partition.py``) and the
feature, label and mask rows split by band. Each process runs the step for
the slots it owns (``parallel/mesh.py``). On a 1-D mesh a slot is a band
and the weights are replicated:

  * per layer, the band aggregation over the halo exchange: by default the
    fused boundary-rows-first form over the pass-block partition
    (``halo.dist_spmm_halo_ell_overlap_blocks_xw``): the send rows'
    ``rows @ W`` leaves first, the interior K1 runs while it travels, the
    halo K1 after the wait, k-chunked at ``exchange_chunk``;
  * the loss is psum(masked NLL sum) / psum(mask count), as gcn_tpu's
    ``loss_shmap``: the count is all-reduced first (no gradient), each
    process back-propagates its bands' share (the exchanges carry the
    cross-band gradients), then every parameter gradient is all-reduced
    over the data group and each process takes the same Adam step.

With ``model_axis`` (``create_mesh_2d``, ``create_mesh_hier_model``) each
band is split over m model slots, tensor parallelism over the widths, as
gcn_tpu's: x's columns, w1's and w2's rows and b1 are sharded over the
model slots, b2 is replicated. Layer 1 computes each slot's partial
``x_j @ w1_j`` and reduce-scatters them over the model slots into hidden
shards of H/m columns; the halo exchange (one a model slot, among the bands
of that slot) and K1 then run on the hidden shard. Layer 2 aggregates the
hidden shard first, multiplies by ``w2_j`` and sums over the model slots:
``(A h) W``. The fused boundary-rows-first forms are off, as in gcn_tpu, so
the overlaps run their unfused forms and ``exchange_chunk`` does not apply.
The model sum's backward is the identity on each slot (every slot computes
the same loss from the sum); the reduce-scatter's is an all-gather. Within
one process both are sums and column splits that autograd differentiates.

Knobs, as gcn_tpu's: ``exchange`` "halo" (the ragged plan), "halo_padded"
(the padded all-to-all plan), "halo_hier" (the host x chip plan, whose
factorization the mesh gives: ``create_mesh_hier``) or "all_gather" (the
baseline); ``kernel`` "ell" (K1, needs a halo exchange) or "segsum"
(the fixed-order segment sum, ``spmm_dist.local_spmm``); ``overlap``
True / "blocks" (the pass-block partition),
"split" (the row-split parts in part-degree order) or False (the
monolithic layout: ``x @ w``, the exchange, then K1 on concat(halo,
band)); ``exchange_dtype`` None, "bf16", "fp8" (the halo wire) or "auto"
(``projection.recommend_wire_dtype`` on the plan this run builds, at the
layer ``widths`` (nfeat, nhid, nclass), which nothing else reads);
``exchange_chunk`` ("auto" = ``k_pad``, None = no chunking); ``k_pad``;
``axis`` (the mesh's row axes: "data", or ("host", "chip"), the default for
"halo_hier"); ``model_axis``. The port adds ``hier_fanout``, the
hierarchical plan's fan-out ("ragged", the one gcn_tpu's step builds, or
"all_gather").

Dropout draws each band's mask from a ``torch.Generator`` seeded from
(seed, iteration, band) (``band_seed``), and with a model axis each slot's
from (seed, iteration, band, model) (``slot_seed``), so a resumed run
equals an uninterrupted one and the masks do not depend on how the slots
are spread over processes. JAX draws other bits, so parity with gcn_tpu
holds at dropout 0.
"""

from __future__ import annotations

import logging
from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gcn_tpu_torch.models.layers import dropout as dropout_fn
from gcn_tpu_torch.ops.adjacency import segment_lengths
from gcn_tpu_torch.parallel.halo import _round_up
from gcn_tpu_torch.parallel.mesh import Mesh
from gcn_tpu_torch.parallel.partition import ShardedGraph, pad_rows
from gcn_tpu_torch.utils.checkpoint import named_leaves

_EXCHANGES = ("halo", "halo_padded", "halo_hier", "all_gather")
_WIRES = {None: None, "bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def band_seed(seed: int, iteration: int, band: int) -> int:
    """The dropout generator's seed of ``band`` at ``iteration``."""
    return int(np.random.SeedSequence([seed, iteration, band])
               .generate_state(1, np.uint64)[0])


def slot_seed(seed: int, iteration: int, band: int, model: int) -> int:
    """The dropout generator's seed of slot (``band``, ``model``) at
    ``iteration`` on a mesh with a model axis."""
    return int(np.random.SeedSequence([seed, iteration, band, model])
               .generate_state(1, np.uint64)[0])


def pad_model_params(params, model_axis_size: int):
    """Zero-pad GCN parameters so that nfeat and nhid divide the model
    axis's size, as gcn_tpu's ``pad_model_params``: w1's rows and columns,
    b1 and w2's rows. The padded entries stay exactly zero in training (the
    padded x columns are zero, the padded hidden units see zero
    pre-activations and zero w2 rows, and the weight decay keeps zeros at
    zero), so the padded model computes the unpadded one. ``shard_fn`` pads
    x's columns to match. Returns new tensors (detached copies)."""
    m = model_axis_size
    gc1 = {k: v.detach().clone() for k, v in params["gc1"].items()}
    gc2 = {k: v.detach().clone() for k, v in params["gc2"].items()}
    w1 = gc1["w"]
    f_pad = _round_up(w1.shape[0], m) - w1.shape[0]
    h_pad = _round_up(w1.shape[1], m) - w1.shape[1]
    gc1["w"] = torch.nn.functional.pad(w1, (0, h_pad, 0, f_pad))
    if gc1.get("b") is not None:
        gc1["b"] = torch.nn.functional.pad(gc1["b"], (0, h_pad))
    gc2["w"] = torch.nn.functional.pad(gc2["w"], (0, 0, 0, h_pad))
    return {"gc1": gc1, "gc2": gc2}


def _model_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows of ``t`` (split evenly over the model slots) that this
    process's model slots own."""
    c = t.shape[0] // mesh.n_model
    js = mesh.model_slots
    return t[js.start * c:js.stop * c]


def shard_model_params(params, mesh: Mesh):
    """This process's model shards of full parameters (padded with
    ``pad_model_params`` where the widths do not divide the model axis):
    w1's and w2's rows and b1's entries of its model slots, b2 whole; new
    leaf tensors. Where the process owns whole bands, ``params`` itself."""
    if not mesh.model_parallel:
        return params
    out = {"gc1": {}, "gc2": {}}
    for layer, sharded in (("gc1", ("w", "b")), ("gc2", ("w",))):
        for k, v in params[layer].items():
            v = _model_rows(v, mesh) if k in sharded else v
            out[layer][k] = v.detach().clone()
    return out


def gather_model_params(params, mesh: Mesh):
    """The full parameters from this process's model shards (an all-gather
    over its model group), detached: the counterpart of ``jax.device_get``
    on gcn_tpu's sharded layout, for eval, checkpoints and comparisons.
    Where the process owns whole bands, detached copies of ``params``."""
    out = {}
    for layer, leaves in params.items():
        out[layer] = {}
        for k, v in leaves.items():
            v = v.detach()
            sharded = k == "w" or (layer == "gc1" and k == "b")
            if mesh.model_parallel and sharded:
                parts = [torch.empty_like(v) for _ in mesh.model_ranks]
                dist.all_gather(parts, v.contiguous(),
                                group=mesh.model_group)
                v = torch.cat(parts)
            out[layer][k] = v.clone()
    return out


def _psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over this rank's data group."""
    if mesh.data_parallel:
        t = t.clone()
        dist.all_reduce(t, group=mesh.data_group)
    return t


def _all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum every parameter gradient over this rank's data group (the ranks
    holding the same parameter rows), in one collective."""
    leaves = [t for _, t in named_leaves(params)]
    flat = torch.cat([t.grad.reshape(-1) for t in leaves])
    dist.all_reduce(flat, group=mesh.data_group)
    off = 0
    for t in leaves:
        t.grad.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


class _ModelReduceScatter(torch.autograd.Function):
    """Each rank's partial (rows, H) summed over its model group, this
    rank's run of H / q columns kept (gcn_tpu's ``psum_scatter`` over the
    model axis). Backward: the all-gather of the column runs. NCCL
    reduce-scatters; gloo has no reduce-scatter, so on the CPU it is an
    all_reduce and a slice."""

    @staticmethod
    def forward(ctx, mesh, partial):
        ctx.mesh = mesh
        q = mesh.ranks_per_band
        rows, width = partial.shape
        # (q, rows, width / q): rank i's columns as one contiguous block
        blocks = partial.reshape(rows, q, width // q).transpose(0, 1).clone(
            memory_format=torch.contiguous_format)
        if dist.get_backend(mesh.model_group) == "nccl":
            out = partial.new_empty((rows, width // q))
            dist.reduce_scatter_tensor(out, blocks, group=mesh.model_group)
            return out
        dist.all_reduce(blocks, group=mesh.model_group)
        return blocks[mesh.model_ranks.index(mesh.rank)].clone()

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        parts = [torch.empty_like(grad) for _ in mesh.model_ranks]
        dist.all_gather(parts, grad.contiguous(), group=mesh.model_group)
        return None, torch.cat(parts, dim=1)


class _ModelSum(torch.autograd.Function):
    """The sum over this rank's model group (gcn_tpu's ``psum`` over the
    model axis). Backward: the identity, as JAX transposes it: every slot
    computes the same loss from the sum, so each slot's cotangent is the
    sum's own."""

    @staticmethod
    def forward(ctx, mesh, t):
        t = t.clone()
        dist.all_reduce(t, group=mesh.model_group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def _check_axes(mesh: Mesh, exchange, axis, model_axis):
    """gcn_tpu's axis names: ``axis`` must name the mesh's row axes
    (("host", "chip") by default for "halo_hier"), ``model_axis`` its model
    axis, and a mesh with a model axis needs ``model_axis``."""
    if exchange == "halo_hier" and not isinstance(axis, tuple):
        axis = ("host", "chip")
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for name in names + ((model_axis,) if model_axis is not None else ()):
        if name not in mesh.axis_names:
            raise ValueError(f"the mesh has no axis {name!r} (its axes: "
                             f"{mesh.axis_names})")
    if names != mesh.data_axes:
        raise ValueError(f"axis={axis!r} must name the mesh's row axes "
                         f"{mesh.data_axes}")
    if model_axis is not None and model_axis != mesh.model_axis:
        raise ValueError(f"model_axis={model_axis!r} must name the mesh's "
                         f"model axis {mesh.model_axis!r}")
    if model_axis is None and mesh.model_axis is not None:
        raise ValueError("the mesh has a model axis: pass "
                         f"model_axis={mesh.model_axis!r}")


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
    axis: str = "data",
    widths: tuple = None,
    hier_fanout: str = "ragged",
) -> Tuple[Callable, Callable, Callable]:
    """Returns ``(train_step, eval_fn, shard_fn)`` for the slots that
    ``mesh`` gives this process.

    ``shard_fn(x, labels, mask)`` takes the host arrays of every row (padded
    to ``sg.n_rows_padded`` or not) and returns ``(adj, xs, ys, ms)``: the
    owned slots' adjacency structures and feature bands (with a model axis,
    each slot's columns of x, zero-padded to the model multiple) and the
    owned bands' labels and masks, on ``mesh.device``. ``train_step(params,
    opt, rng, adj, xs, ys, ms)`` takes one optimizer step on ``params`` (a
    nested dict of leaf tensors that require grad; ``opt`` was built over
    ``named_leaves(params)``) with the dropout stream ``rng = (seed,
    iteration)``, and returns the global loss (a 0-dim tensor).
    ``eval_fn(params, adj, xs)`` returns the owned bands' log-probs,
    stacked. With a model axis ``params`` are this process's model shards
    (``shard_model_params`` of the full, padded parameters; the full ones
    where it owns whole bands), and ``gather_model_params`` returns the
    full ones.

    ``with_relu=False`` drops layer 1's relu, and with it the dropout,
    which applies only after the relu, as in gcn_tpu. Each bias is added
    when ``params`` holds one; ``with_bias`` states whether they do, and
    with a model axis (where gcn_tpu's parameter specs need it) a mismatch
    raises ``ValueError``.
    """
    if exchange not in _EXCHANGES:
        raise ValueError(f"exchange must be one of {_EXCHANGES}")
    if exchange_dtype != "auto" and exchange_dtype not in _WIRES:
        raise ValueError(f"exchange_dtype must be one of "
                         f"{tuple(_WIRES) + ('auto',)}")
    if exchange_dtype is not None and exchange == "all_gather":
        raise ValueError("exchange_dtype applies to the halo exchanges only; "
                         "the all_gather baseline ships the compute dtype")
    if overlap not in (True, False, "blocks", "split"):
        raise ValueError("overlap must be True, False, 'blocks' or 'split'")
    if kernel is None:
        kernel = "segsum" if exchange == "all_gather" else "ell"
    if kernel not in ("segsum", "ell"):
        raise ValueError("kernel must be 'ell' or 'segsum'")
    if kernel == "ell" and exchange == "all_gather":
        raise ValueError("kernel='ell' requires a halo exchange")
    if exchange == "halo_hier" and mesh.n_hosts is None:
        raise ValueError("exchange='halo_hier' needs a host x chip mesh "
                         "(create_mesh_hier)")
    _check_axes(mesh, exchange, axis, model_axis)
    if exchange_chunk == "auto":
        exchange_chunk = k_pad

    from gcn_tpu_torch.parallel import halo, spmm_dist

    dev = mesh.device
    rps = sg.rows_per_shard
    owned = list(mesh.shards)
    n_model = mesh.n_model
    # the owned slots' (band, model index), in slot order
    slots = [(s // n_model, s % n_model) for s in mesh.slots]
    js = len(mesh.model_slots)

    def index(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    def per_slot(bands):
        """A list over the owned bands as a list over the owned slots."""
        return [bands[b - owned[0]] for b, _ in slots]

    fused = band_spmm = None
    if exchange == "all_gather":
        send_idx = None
        extra = [(index(sg.cols[s]), torch.as_tensor(sg.vals[s], device=dev),
                  index(segment_lengths(sg.rows_local[s], rps)))
                 for s in owned]

        def band_spmm(adj, hs):
            return spmm_dist.dist_spmm_gathered(adj[0], hs, mesh)
    else:
        if exchange == "halo_hier":
            plan = halo.build_halo_plan_hier(sg, mesh.n_hosts, mesh.n_chips,
                                             fanout=hier_fanout)
        elif exchange == "halo_padded":
            plan = halo.build_halo_plan(sg)
        else:
            plan = halo.build_halo_plan_ragged(sg)
        if exchange_dtype == "auto":
            # the wire policy on this run's exact plan volumes (with a model
            # axis, the band plan every model slot exchanges over); its
            # inputs are host data, the same on every rank, so every
            # process resolves the same wire
            from gcn_tpu_torch.parallel.projection import (
                recommend_wire_dtype)

            exchange_dtype, why = recommend_wire_dtype(sg, plan,
                                                       widths=widths)
            logging.getLogger(__name__).info("auto halo wire -> %s (%s)",
                                             exchange_dtype, why)
        send_idx = per_slot(halo.send_indices(plan, owned, dev))
        ex_fn = halo.make_halo_exchange(plan, _WIRES[exchange_dtype])
        layout = dict(k_pad=k_pad, shards=owned, device=dev)
        if kernel == "segsum":
            extra = [(index(plan.col_remap[s]),
                      torch.as_tensor(sg.vals[s], device=dev),
                      index(segment_lengths(sg.rows_local[s], rps)))
                     for s in owned]

            def band_spmm(adj, hs):
                coo, idx = adj
                return halo.dist_spmm_halo(coo, idx, hs, mesh, ex_fn)
        elif overlap in (True, "blocks"):
            extra = halo.build_sharded_ell_blocks(sg, plan, **layout)

            def fused(adj, xs, w):
                (e_int, e_halo), idx = adj
                return halo.dist_spmm_halo_ell_overlap_blocks_xw(
                    e_int, e_halo, idx, xs, w, mesh, ex_fn,
                    chunk=exchange_chunk)

            def band_spmm(adj, hs):
                (e_int, e_halo), idx = adj
                return halo.dist_spmm_halo_ell_overlap_blocks(
                    e_int, e_halo, idx, hs, mesh, ex_fn)
        elif overlap == "split":
            # each part in its own part-degree row order, restored to band
            # order by unpermute_rows
            e_int, i_take, i_back = halo.build_sharded_ell(
                sg, plan, part="interior", part_order=True, **layout)
            e_bnd, b_take, b_back = halo.build_sharded_ell(
                sg, plan, part="boundary", part_order=True, **layout)
            extra = (e_int, e_bnd, list(zip(i_take, i_back)),
                     list(zip(b_take, b_back)))

            def fused(adj, xs, w):
                (e_int, e_bnd, i_un, b_un), idx = adj
                return halo.dist_spmm_halo_ell_overlap_xw(
                    e_int, e_bnd, idx, xs, w, mesh, ex_fn,
                    chunk=exchange_chunk, int_unperm=i_un, bnd_unperm=b_un)

            def band_spmm(adj, hs):
                (e_int, e_bnd, i_un, b_un), idx = adj
                return halo.dist_spmm_halo_ell_overlap(
                    e_int, e_bnd, idx, hs, mesh, ex_fn, int_unperm=i_un,
                    bnd_unperm=b_un)
        else:
            extra = halo.build_sharded_ell(sg, plan, **layout)

            def band_spmm(adj, hs):
                ell, idx = adj
                return halo.dist_spmm_halo_ell(ell, idx, hs, mesh, ex_fn)
    # one entry an owned slot (a band's structures serve its model slots)
    extra = (tuple(per_slot(part) for part in extra)
             if isinstance(extra, tuple) else per_slot(extra))
    if model_axis is not None:
        fused = None    # gcn_tpu's fused path is off with a model axis

    def layer(adj, hs, w):
        if fused is not None:
            return fused(adj, hs, w)
        return band_spmm(adj, [torch.matmul(h, w) for h in hs])

    def hidden(h, band, model, b1, rng, train):
        """Layer 1's epilogue on one slot's aggregation: bias, relu and
        dropout."""
        if b1 is not None:
            h = h + b1
        if with_relu:
            h = torch.relu(h)
            if train and dropout > 0:
                seed = (band_seed(*rng, band) if model_axis is None
                        else slot_seed(*rng, band, model))
                gen = torch.Generator(device=dev).manual_seed(seed)
                h = dropout_fn(gen, h, dropout, train=True)
        return h

    def forward_1d(params, adj, xs, rng, train):
        w1, b1 = params["gc1"]["w"], params["gc1"].get("b")
        w2, b2 = params["gc2"]["w"], params["gc2"].get("b")
        # bias after aggregation, as GraphConvolution: A (X W) + b
        hs = [hidden(h, band, 0, b1, rng, train)
              for (band, _), h in zip(slots, layer(adj, xs, w1))]
        out = layer(adj, hs, w2)
        if b2 is not None:
            out = [h + b2 for h in out]
        return [torch.log_softmax(h, dim=1) for h in out]

    def forward_model(params, adj, xs, rng, train):
        w1, b1 = params["gc1"]["w"], params["gc1"].get("b")
        w2, b2 = params["gc2"]["w"], params["gc2"].get("b")
        if (b1 is not None) != with_bias or (b2 is not None) != with_bias:
            raise ValueError(f"with_bias={with_bias} disagrees with the "
                             f"parameters")
        fj = w1.shape[0] // js       # x columns a model slot
        hj = w2.shape[0] // js       # hidden columns a model slot
        if w1.shape[1] != hj * n_model:
            raise ValueError(
                f"nhid {w1.shape[1]} must be a multiple of the model axis "
                f"size {n_model} and match w2's rows: pad_model_params")
        # layer 1: the slots' partial x_j @ w1_j, reduce-scattered over the
        # model slots into hidden shards of H / m columns
        hs = []
        for i in range(0, len(slots), js):
            part = sum(torch.matmul(xs[i + j], w1[j * fj:(j + 1) * fj])
                       for j in range(js))
            if mesh.model_parallel:
                part = _ModelReduceScatter.apply(mesh, part)
            hs += [part[:, j * hj:(j + 1) * hj] for j in range(js)]
        hs = [hidden(h, band, model, None if b1 is None else
                     b1[(i % js) * hj:(i % js + 1) * hj], rng, train)
              for i, ((band, model), h) in enumerate(
                  zip(slots, band_spmm(adj, hs)))]
        # layer 2: (A h) W: aggregate the hidden shard, contract with the
        # matching w2 rows, sum over the model slots
        aggs = band_spmm(adj, hs)
        out = []
        for i in range(0, len(slots), js):
            z = sum(torch.matmul(aggs[i + j], w2[j * hj:(j + 1) * hj])
                    for j in range(js))
            if mesh.model_parallel:
                z = _ModelSum.apply(mesh, z)
            if b2 is not None:
                z = z + b2
            out.append(torch.log_softmax(z, dim=1))
        return out

    forward = forward_1d if model_axis is None else forward_model

    def train_step(params, opt, rng, adj, xs, ys, ms):
        opt.zero_grad(set_to_none=True)
        lps = forward(params, adj, xs, rng, train=True)
        count = _psum(sum(m.sum() for m in ms), mesh)
        loss = sum(-(lp.gather(1, y[:, None])[:, 0] * m).sum()
                   for lp, y, m in zip(lps, ys, ms)) / count.clamp_min(1.0)
        loss.backward()
        if mesh.data_parallel:
            _all_reduce_grads(params, mesh)
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

        xs = bands(x, torch.float32)
        if model_axis is not None:
            # each slot's run of x's columns, zero-padded to the model
            # multiple (the padded parameters come from pad_model_params)
            f = xs[0].shape[1]
            fj = _round_up(f, n_model) // n_model
            xs = [torch.nn.functional.pad(xb, (0, fj * n_model - f))
                  [:, model * fj:(model + 1) * fj].contiguous()
                  for xb, (_, model) in zip(per_slot(xs), slots)]
        return ((extra, send_idx), xs, bands(labels, torch.int64),
                bands(mask, torch.float32))

    return train_step, eval_fn, shard_fn
