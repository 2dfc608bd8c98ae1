"""Which shards a process owns, and the process group that joins them.

The port of ``gcn_tpu.parallel.mesh``. gcn_tpu runs its sharded step as one
SPMD program over a JAX device mesh. The port runs one process per rank
over ``torch.distributed`` and lets each process own one or more row bands
(shards): rank r owns the contiguous shards ``[r * spr, (r + 1) * spr)``
with ``spr = n_shards // world_size``. Within a process, moving rows
between two of its shards is a copy on its device; between processes it is
point-to-point over NCCL (GPUs) or gloo (CPU). A hierarchical mesh
(``create_mesh_hier``) also factors the shards as hosts x chips, shard =
host * n_chips + chip, for the hierarchical halo exchange.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from gcn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_shards`` row bands over ``world_size`` processes; this process
    is ``rank`` and keeps its shards' tensors on ``device``. ``n_hosts`` x
    ``n_chips`` factor the shards on a hierarchical mesh (None on a flat
    one)."""

    n_shards: int
    device: torch.device
    rank: int = 0
    world_size: int = 1
    n_hosts: Optional[int] = None
    n_chips: Optional[int] = None

    @property
    def shards_per_rank(self) -> int:
        return self.n_shards // self.world_size

    @property
    def shards(self) -> range:
        """The shards this process owns, ascending."""
        spr = self.shards_per_rank
        return range(self.rank * spr, (self.rank + 1) * spr)

    def owner(self, shard: int) -> int:
        """The rank that owns ``shard``."""
        return shard // self.shards_per_rank

    def local_index(self, shard: int) -> int:
        """Position of an owned ``shard`` in this process's lists."""
        return shard - self.rank * self.shards_per_rank

    @property
    def distributed(self) -> bool:
        return self.world_size > 1


def create_mesh(n_shards: int, device=None) -> Mesh:
    """A mesh of ``n_shards`` bands over the initialized process group (one
    process when there is none), tensors on ``device``: the card by
    default, ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    rank, world = 0, 1
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    if n_shards < world or n_shards % world:
        raise ValueError(f"{n_shards} shards cannot be spread evenly over "
                         f"{world} processes")
    return Mesh(n_shards=n_shards, device=device, rank=rank,
                world_size=world)


def create_mesh_hier(n_hosts: int, n_chips: int, device=None) -> Mesh:
    """A mesh of ``n_hosts * n_chips`` bands for the hierarchical halo
    exchange: shard = host * n_chips + chip, so a host's chips are
    consecutive shards (and, the ownership being contiguous, consecutive
    ranks); the card by default, ``device="cpu"`` for the CPU."""
    mesh = create_mesh(n_hosts * n_chips, device)
    return dataclasses.replace(mesh, n_hosts=n_hosts, n_chips=n_chips)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         n_shards: Optional[int] = None,
                         device=None) -> Mesh:
    """Join the process group and return this process's mesh.

    With ``coordinator_address`` ("host:port") the rank and world size are
    the arguments; without it they come from the environment ``torchrun``
    sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). On
    the card (the default) each process takes ``cuda:LOCAL_RANK`` modulo the
    visible cards and the backend is NCCL; ``device="cpu"`` uses gloo.
    ``n_shards`` defaults to one shard a process.
    """
    if device is None:
        resolve_device(None)
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is not None:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    # one collective that every rank joins, so that NCCL sets up its
    # communicator before the first point-to-point exchange
    dist.all_reduce(torch.zeros(1, device=device))
    return create_mesh(n_shards or dist.get_world_size(), device)
