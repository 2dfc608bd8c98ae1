"""Row-band sharded GCN training (the port of ``gcn_tpu.parallel``): the
row partition; the 1-D, hierarchical and model-axis meshes; the ragged,
padded and hierarchical halo plans and their exchanges over
``torch.distributed``; the pass-block, monolithic and row-split sharded
ELL layouts on K1 with ``unpermute_rows``; and the sharded train step,
with tensor parallelism over the widths on a model axis."""

from gcn_tpu_torch.parallel.halo import (HaloPlan, HierHaloPlan,
                                         RaggedHaloPlan, build_halo_plan,
                                         build_halo_plan_hier,
                                         build_halo_plan_ragged,
                                         build_sharded_ell,
                                         build_sharded_ell_blocks,
                                         make_halo_exchange, send_indices,
                                         unpermute_rows)
from gcn_tpu_torch.parallel.mesh import (Mesh, create_mesh, create_mesh_2d,
                                         create_mesh_hier,
                                         create_mesh_hier_model,
                                         initialize_multihost)
from gcn_tpu_torch.parallel.partition import (ShardedGraph,
                                              band_degree_sort_order,
                                              pad_rows, rows_per_shard_for,
                                              shard_graph_by_rows)
from gcn_tpu_torch.parallel.train_step import (gather_model_params,
                                               make_sharded_gcn_train_step,
                                               pad_model_params,
                                               shard_model_params)

__all__ = [
    "HaloPlan",
    "HierHaloPlan",
    "Mesh",
    "RaggedHaloPlan",
    "ShardedGraph",
    "band_degree_sort_order",
    "build_halo_plan",
    "build_halo_plan_hier",
    "build_halo_plan_ragged",
    "build_sharded_ell",
    "build_sharded_ell_blocks",
    "create_mesh",
    "create_mesh_2d",
    "create_mesh_hier",
    "create_mesh_hier_model",
    "gather_model_params",
    "initialize_multihost",
    "make_halo_exchange",
    "make_sharded_gcn_train_step",
    "pad_model_params",
    "pad_rows",
    "rows_per_shard_for",
    "send_indices",
    "shard_graph_by_rows",
    "shard_model_params",
    "unpermute_rows",
]
