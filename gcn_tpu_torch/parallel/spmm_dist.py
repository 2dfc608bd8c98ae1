"""Distributed SpMM baseline: gather every band, then a segment sum.

The port of ``gcn_tpu.parallel.spmm_dist``. Each process owns the row bands
of its shards and their activations; a layer's aggregation needs source
rows from every band, so the baseline gathers them all:

    x_full = all_gather(owned bands)              # every process, n rows
    out_band = local_spmm(shard, x_full)          # index_add per shard

XLA's ``segment_sum`` is no Pallas kernel, so its counterpart here is plain
torch (``index_add``) on the card as on the CPU. The halo exchange
(``parallel/halo.py``) replaces this baseline on the main path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def local_spmm(rows_local, cols, vals, x_full, rows_per_shard):
    """out[r] = sum_e [rows_local[e] == r] vals[e] * x_full[cols[e]]."""
    gathered = x_full[cols] * vals[:, None]
    return x_full.new_zeros((rows_per_shard, x_full.shape[1])).index_add(
        0, rows_local, gathered)


class _AllGather(torch.autograd.Function):
    """Every process's owned bands, in shard order. Backward: the sum over
    processes of the cotangent, then this process's rows: a reduce-scatter
    on NCCL; gloo has none on the CPU, so there it is an all_reduce and a
    slice."""

    @staticmethod
    def forward(ctx, mesh, local):
        ctx.mesh = mesh
        parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
        dist.all_gather(parts, local.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        grad = grad.contiguous()
        rows = grad.shape[0] // mesh.world_size
        if dist.get_backend() == "nccl":
            out = grad.new_empty((rows, grad.shape[1]))
            dist.reduce_scatter_tensor(out, grad)
            return None, out
        total = grad.clone()
        dist.all_reduce(total)
        return None, total[mesh.rank * rows:(mesh.rank + 1) * rows]


def dist_spmm_gathered(shard_arrays, x_bands, rows_per_shard, mesh):
    """SpMM of the owned bands: ``shard_arrays`` are the owned shards'
    (rows_local, cols, vals), ``x_bands`` their activation bands."""
    local = torch.cat(x_bands)
    x_full = _AllGather.apply(mesh, local) if mesh.distributed else local
    return [local_spmm(rows_local, cols, vals, x_full, rows_per_shard)
            for rows_local, cols, vals in shard_arrays]
