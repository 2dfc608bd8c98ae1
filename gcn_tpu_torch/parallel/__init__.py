"""Row-band sharded GCN training (the port of ``gcn_tpu.parallel``): the
row partition, the ragged halo plan and its exchange over
``torch.distributed``, the pass-block sharded ELL layout on K1, and the
sharded train step."""

from gcn_tpu_torch.parallel.halo import (RaggedHaloPlan,
                                         build_halo_plan_ragged,
                                         build_sharded_ell_blocks,
                                         make_halo_exchange)
from gcn_tpu_torch.parallel.mesh import (Mesh, create_mesh,
                                         initialize_multihost)
from gcn_tpu_torch.parallel.partition import (ShardedGraph,
                                              band_degree_sort_order,
                                              pad_rows, rows_per_shard_for,
                                              shard_graph_by_rows)
from gcn_tpu_torch.parallel.train_step import make_sharded_gcn_train_step

__all__ = [
    "Mesh",
    "RaggedHaloPlan",
    "ShardedGraph",
    "band_degree_sort_order",
    "build_halo_plan_ragged",
    "build_sharded_ell_blocks",
    "create_mesh",
    "initialize_multihost",
    "make_halo_exchange",
    "make_sharded_gcn_train_step",
    "pad_rows",
    "rows_per_shard_for",
    "shard_graph_by_rows",
]
