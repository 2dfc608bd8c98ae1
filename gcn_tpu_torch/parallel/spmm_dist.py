"""Distributed SpMM baseline: gather every band, then a segment sum.

The port of ``gcn_tpu.parallel.spmm_dist``. Each process owns the row bands
of its slots and their activations; a layer's aggregation needs source
rows from every band, so the baseline gathers them all within the data
group (the ranks of one run of model indices):

    x_full = all_gather(owned bands)              # every band, n rows
    out_band = local_spmm(shard, x_full)          # segment sum per slot

XLA's sorted ``segment_sum`` is no Pallas kernel, so its counterpart here
is plain torch on the card as on the CPU: the COO product's fixed-order
segment sum (``ops/spmm.py::segment_sum``) over each shard's row edge
counts, made once with the shard's arrays by
``ops/adjacency.py::segment_lengths``, which checks that the local rows
are sorted; the gather ``x_full[cols]`` differentiates by
``ops/spmm.py::gather_rows``, each x_full row's cotangents summed in edge
order over a sort of the columns made with the arrays. The halo exchange
(``parallel/halo.py``) replaces this baseline on the main path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gcn_tpu_torch.ops.spmm import gather_rows, segment_sum


def local_spmm(cols, vals, x_full, row_len):
    """out[r] = sum_e [rows_local[e] == r] vals[e] * x_full[cols[e]], with
    ``row_len`` the shard's row edge counts (``segment_lengths`` of its
    sorted ``rows_local``): each row's edges summed in edge order, and the
    gradient of x_full each column's edges in edge order (``cols`` a
    ``RowGather`` into x_full's rows, or a plain index tensor; no
    atomics)."""
    return segment_sum(gather_rows(x_full, cols) * vals[:, None], row_len)


class _AllGather(torch.autograd.Function):
    """Every band of this rank's data group, in band order. Backward: the
    sum over the group of the cotangent, then this process's rows: a
    reduce-scatter on NCCL; gloo has none on the CPU, so there it is an
    all_reduce and a slice."""

    @staticmethod
    def forward(ctx, mesh, local):
        ctx.mesh = mesh
        parts = [torch.empty_like(local) for _ in mesh.data_ranks]
        dist.all_gather(parts, local.contiguous(), group=mesh.data_group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        grad = grad.contiguous()
        rows = grad.shape[0] // len(mesh.data_ranks)
        if dist.get_backend() == "nccl":
            out = grad.new_empty((rows, grad.shape[1]))
            dist.reduce_scatter_tensor(out, grad, group=mesh.data_group)
            return None, out
        total = grad.clone()
        dist.all_reduce(total, group=mesh.data_group)
        pos = mesh.data_ranks.index(mesh.rank)
        return None, total[pos * rows:(pos + 1) * rows]


def dist_spmm_gathered(shard_arrays, x_bands, mesh):
    """SpMM of the owned slots: ``shard_arrays`` are the owned slots'
    (cols, vals, row_len) (a slot's are its band's), ``x_bands`` their
    activation bands. With a model axis each model index gathers its own
    columns: the owned slots' bands go side by side, one all_gather."""
    js = len(mesh.model_slots)
    # (band rows, owned model indices x width): each band's slots side by
    # side, the bands stacked in order
    local = torch.cat([torch.cat(x_bands[i:i + js], dim=1)
                       for i in range(0, len(x_bands), js)])
    x_full = _AllGather.apply(mesh, local) if mesh.data_parallel else local
    k = x_bands[0].shape[1]
    outs = []
    for i, (cols, vals, row_len) in enumerate(shard_arrays):
        j = i % js
        x_j = x_full if js == 1 else x_full[:, j * k:(j + 1) * k]
        outs.append(local_spmm(cols, vals, x_j, row_len))
    return outs
