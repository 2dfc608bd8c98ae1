"""Which slots a process owns, and the process groups that join them.

The port of ``gcn_tpu.parallel.mesh``. gcn_tpu runs its sharded step as one
SPMD program over a JAX device mesh. The port runs one process per rank
over ``torch.distributed`` and lets each process own one or more slots of
the mesh. A slot is a (row band, model index) pair, numbered as gcn_tpu
orders its devices: slot = band * n_model + model, so a band's model slots
are consecutive (``create_mesh_2d``: data x model; ``create_mesh_hier_model``:
host x chip x model, band = host * n_chips + chip). A 1-D mesh
(``create_mesh``, ``create_mesh_hier``) has n_model = 1, and a slot is a
band (a shard). Rank r owns the contiguous slots ``[r * spr, (r + 1) *
spr)``, ``spr = n_slots // world_size``: either whole bands (spr a multiple
of n_model) or part of one band's model slots (spr divides n_model).

Within a process, moving rows between two of its slots is a copy on its
device; between processes it is point-to-point over NCCL (GPUs) or gloo
(CPU). The halo exchange, the all_gather baseline, the loss and the gradient
all-reduce run within a data group (the ranks that own one run of model
indices, one rank a band or run of bands); the model axis's reduce-scatter
and sum run within a model group (the ranks that share one band). Where a
process owns whole bands, the data group is the world and the model group
is the process itself.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gcn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_shards`` row bands x ``n_model`` model slots over ``world_size``
    processes; this process is ``rank`` and keeps its slots' tensors on
    ``device``. ``n_hosts`` x ``n_chips`` factor the bands on a
    hierarchical mesh (None on a flat one). ``axis_names`` are gcn_tpu's
    (the model axis, when there is one, last). ``data_group`` /
    ``model_group``: this rank's process groups where they are neither the
    world nor the rank alone (None then)."""

    n_shards: int
    device: torch.device
    rank: int = 0
    world_size: int = 1
    n_hosts: Optional[int] = None
    n_chips: Optional[int] = None
    n_model: int = 1
    axis_names: Tuple[str, ...] = ("data",)
    data_group: object = dataclasses.field(default=None, compare=False,
                                           repr=False)
    model_group: object = dataclasses.field(default=None, compare=False,
                                            repr=False)

    def __post_init__(self):
        n, w, m = self.n_slots, self.world_size, self.n_model
        if n < w or n % w:
            raise ValueError(f"{n} slots cannot be spread evenly over {w} "
                             f"processes")
        spr = n // w
        if spr % m and m % spr:
            raise ValueError(
                f"{spr} slots a process neither hold whole bands of "
                f"{m} model slots nor divide one band's {m}")

    @property
    def model_axis(self) -> Optional[str]:
        """The model axis's name, None on a 1-D mesh."""
        return "model" if "model" in self.axis_names else None

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The names of the axes the row bands span."""
        return tuple(a for a in self.axis_names if a != self.model_axis)

    @property
    def n_slots(self) -> int:
        return self.n_shards * self.n_model

    @property
    def slots_per_rank(self) -> int:
        return self.n_slots // self.world_size

    @property
    def slots(self) -> range:
        """The slots this process owns, ascending."""
        spr = self.slots_per_rank
        return range(self.rank * spr, (self.rank + 1) * spr)

    @property
    def shards(self) -> range:
        """The row bands of this process's slots, ascending."""
        s = self.slots
        return range(s[0] // self.n_model, (s[-1] // self.n_model) + 1)

    @property
    def shards_per_rank(self) -> int:
        return len(self.shards)

    @property
    def model_slots(self) -> range:
        """The model indices this process owns in each of its bands."""
        m, spr = self.n_model, self.slots_per_rank
        if spr >= m:
            return range(m)
        lo = self.slots[0] % m
        return range(lo, lo + spr)

    def owner(self, slot: int) -> int:
        """The rank that owns ``slot`` (a shard on a 1-D mesh)."""
        return slot // self.slots_per_rank

    def local_index(self, slot: int) -> int:
        """Position of an owned ``slot`` in this process's lists."""
        return slot - self.rank * self.slots_per_rank

    @property
    def ranks_per_band(self) -> int:
        """The size of a model group: 1 where a process owns whole
        bands."""
        return max(1, self.n_model // self.slots_per_rank)

    @property
    def data_ranks(self) -> Tuple[int, ...]:
        """The ranks of this rank's data group, ascending."""
        q = self.ranks_per_band
        return tuple(range(self.rank % q, self.world_size, q))

    @property
    def model_ranks(self) -> Tuple[int, ...]:
        """The ranks of this rank's model group, ascending."""
        q = self.ranks_per_band
        return tuple(range(self.rank // q * q, self.rank // q * q + q))

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    @property
    def data_parallel(self) -> bool:
        """Whether this rank's data group spans more than itself."""
        return len(self.data_ranks) > 1

    @property
    def model_parallel(self) -> bool:
        """Whether this rank's band is split over more than itself."""
        return self.ranks_per_band > 1


def _process() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _mesh(n_bands: int, n_model: int, device, axis_names, **factors
          ) -> Mesh:
    """A mesh over the initialized process group (one process when there
    is none), with its data and model groups made."""
    device = resolve_device(device)
    rank, world = _process()
    mesh = Mesh(n_shards=n_bands, device=device, rank=rank, world_size=world,
                n_model=n_model, axis_names=tuple(axis_names), **factors)
    q = mesh.ranks_per_band
    if q == 1 or world == 1:
        return mesh
    # every rank makes every group, in one order: the data groups, then the
    # model groups
    groups = {}
    for i in range(q):
        ranks = list(range(i, world, q))
        groups["data", i] = dist.new_group(ranks) if len(ranks) > 1 else None
    for b in range(world // q):
        groups["model", b] = dist.new_group(list(range(b * q, b * q + q)))
    return dataclasses.replace(mesh, data_group=groups["data", rank % q],
                               model_group=groups["model", rank // q])


def create_mesh(n_shards: int, device=None) -> Mesh:
    """A mesh of ``n_shards`` bands over the initialized process group (one
    process when there is none), tensors on ``device``: the card by
    default, ``device="cpu"`` for the CPU."""
    return _mesh(n_shards, 1, device, ("data",))


def create_mesh_hier(n_hosts: int, n_chips: int, device=None) -> Mesh:
    """A mesh of ``n_hosts * n_chips`` bands for the hierarchical halo
    exchange: shard = host * n_chips + chip, so a host's chips are
    consecutive shards (and, the ownership being contiguous, consecutive
    ranks); the card by default, ``device="cpu"`` for the CPU."""
    return _mesh(n_hosts * n_chips, 1, device, ("host", "chip"),
                 n_hosts=n_hosts, n_chips=n_chips)


def create_mesh_2d(n_data: int, n_model: int, device=None) -> Mesh:
    """A data x model mesh: ``n_data`` row bands, each split over
    ``n_model`` model slots (tensor parallelism over the feature and
    hidden widths, ``make_sharded_gcn_train_step(model_axis="model")``);
    slot = band * n_model + model. The card by default, ``device="cpu"``
    for the CPU."""
    return _mesh(n_data, n_model, device, ("data", "model"))


def create_mesh_hier_model(n_hosts: int, n_chips: int, n_model: int,
                           device=None) -> Mesh:
    """A host x chip x model mesh: the hierarchical row partition (band =
    host * n_chips + chip, the ``halo_hier`` exchange's two levels) with
    ``n_model`` model slots a band; slot = band * n_model + model, so a
    band's model slots are neighbours. The card by default,
    ``device="cpu"`` for the CPU."""
    return _mesh(n_hosts * n_chips, n_model, device,
                 ("host", "chip", "model"), n_hosts=n_hosts,
                 n_chips=n_chips)


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
