"""gcn_tpu_torch imports, trains GCN (in both loop flavors) and HGNN (both
forms of G), runs the panel and frequency-split SpMMs, saves and resumes a
training state, takes sharded training steps over two row bands and every
exchange and layout flavor over four, imports the host modules (loaders,
CSV dumps, row analysis, artifacts, profiling), reorders by gorder and
profiles a fitted model's ops, takes a step on a 2 x 2 mesh with a model
axis, tiles with the native tiler and runs the rest of CSRGraph, imports
the projection, the measurement and host scripts and the lazy top-level
names, projects a full step and takes a step with the auto wire, with jax
and gcn_tpu blocked."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["gcn_tpu"] = None
import gcn_tpu_torch
from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.models import GCN
import gcn_tpu_torch.train_gcn, gcn_tpu_torch.convert
import gcn_tpu_torch.utils.checkpoint, gcn_tpu_torch.ops.ell_spmm
data = get_dataset("synth-tiny", seed=0)
m = GCN(data.num_features, 8, data.num_classes, variant="v6", device="cpu")
m.fit(data.features, data.adj, data.labels, data.idx_train, train_iters=3)
assert len(m.history) == 3
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "gcn_tpu")
                and sys.modules[k] is not None)
assert not leaked, leaked
m.test(data.idx_test)
import torch
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.ops.spmm import spmm
from gcn_tpu_torch.tile import panel_adjacency
g = gcn_normalize(data.adj)
adj = panel_adjacency(g, device="cpu")
x = torch.tensor(data.features, requires_grad=True)
spmm(adj, x).sum().backward()
assert torch.allclose(x.grad.sum(dim=1),
                      torch.tensor(g.to_dense().sum(axis=0)) * x.shape[1],
                      rtol=1e-5, atol=1e-5)
import numpy as np
from gcn_tpu_torch.data.synthetic import synthetic_visual_features
from gcn_tpu_torch.graph.hypergraph import (construct_H_with_KNN,
                                            generate_G_factors,
                                            generate_G_from_H)
from gcn_tpu_torch.models import HGNN
fts, labels, tr, te = synthetic_visual_features(n=120, f=32, classes=4)
h = construct_H_with_KNN(fts[:, :16], 5)
for G in (generate_G_from_H(h), generate_G_factors(h)):
    hm = HGNN(32, 4, n_hid=16, adj_kind="ell", device="cpu")
    hm.fit(fts, G, labels, tr, idx_val=te, num_epochs=3)
    assert len(hm.history) == 3 and 0.0 <= hm.test(te) <= 1.0
from gcn_tpu_torch.tile.freq_split import ell_adjacency_freq, spmm_ell_freq
fsa = ell_adjacency_freq(g, hot_rows=64, r=16, device="cpu")
xf = torch.tensor(data.features, requires_grad=True)
spmm_ell_freq(fsa, xf).sum().backward()
assert torch.allclose(xf.grad.sum(dim=1), x.grad.sum(dim=1), rtol=1e-4,
                      atol=1e-4)
import os, tempfile
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "state")
    m.save_state(path)
    m2 = GCN(data.num_features, 8, data.num_classes, variant="v6",
             device="cpu")
    m2.fit(data.features, data.adj, data.labels, data.idx_train,
           train_iters=2, resume_from=path)
    assert m2._iters_done == 5
import gcn_tpu_torch.train_gcn_dist
from gcn_tpu_torch.models.gcn_core import init_gcn_params
from gcn_tpu_torch.parallel import (create_mesh, make_sharded_gcn_train_step,
                                    shard_graph_by_rows)
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.checkpoint import named_leaves
step, eval_fn, shard_fn = make_sharded_gcn_train_step(
    create_mesh(2, "cpu"), shard_graph_by_rows(g, 2), dropout=0.5)
a, xs, ys, ms = shard_fn(data.features, data.labels,
                         np.ones(data.num_nodes, np.float32))
params = init_gcn_params(torch.Generator().manual_seed(0), data.num_features,
                         8, data.num_classes, device="cpu")
opt = adam_l2([t.requires_grad_(True) for _, t in named_leaves(params)])
losses = [float(step(params, opt, (1, i), a, xs, ys, ms)) for i in range(2)]
assert np.isfinite(losses).all() and len(losses) == 2
assert eval_fn(params, a, xs).shape[1] == data.num_classes
from gcn_tpu_torch.parallel import (HaloPlan, HierHaloPlan, build_halo_plan,
                                    build_halo_plan_hier, build_sharded_ell,
                                    create_mesh_hier, send_indices,
                                    unpermute_rows)
sg4 = shard_graph_by_rows(g, 4)
for flavor in (dict(exchange="halo_padded", overlap=False),
               dict(exchange="halo_hier", overlap="split"),
               dict(exchange="halo_hier", hier_fanout="all_gather")):
    mesh = (create_mesh_hier(2, 2, "cpu") if flavor["exchange"] == "halo_hier"
            else create_mesh(4, "cpu"))
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(mesh, sg4,
                                                          **flavor)
    a, xs, ys, ms = shard_fn(data.features, data.labels,
                             np.ones(data.num_nodes, np.float32))
    params = init_gcn_params(torch.Generator().manual_seed(0),
                             data.num_features, 8, data.num_classes,
                             device="cpu")
    opt = adam_l2([t.requires_grad_(True) for _, t in named_leaves(params)])
    assert np.isfinite(float(step(params, opt, (1, 0), a, xs, ys, ms)))
assert isinstance(build_halo_plan(sg4), HaloPlan)
assert isinstance(build_halo_plan_hier(sg4, 2, 2), HierHaloPlan)
adjs, takes, backs = build_sharded_ell(sg4, build_halo_plan(sg4),
                                       part="interior", part_order=True,
                                       device="cpu")
y = torch.randn(sg4.rows_per_shard, 3)
assert torch.equal(unpermute_rows(y, takes[0], backs[0])[backs[0]], y)
assert len(send_indices(build_halo_plan_hier(sg4, 2, 2), [0], "cpu")[0]) == 3
import gcn_tpu_torch.analysis.rows, gcn_tpu_torch.data.graphsaint
import gcn_tpu_torch.data.planetoid, gcn_tpu_torch.ops.permute
import gcn_tpu_torch.utils.artifacts, gcn_tpu_torch.utils.profiling
import gcn_tpu_torch.utils.writecsv
from gcn_tpu_torch.reorder import METHODS, reorder_graph, reorder_stats
assert len(METHODS) == 9
g2, perm = reorder_graph(g, "gorder")
assert sorted(perm.tolist()) == list(range(g.shape[0]))
assert reorder_stats(g)["communities"] >= 1
m3 = GCN(data.num_features, 8, data.num_classes, variant="v6",
         reorder="gorder", device="cpu")
m3.fit(data.features, data.adj, data.labels, data.idx_train, train_iters=2)
rows = m3.profile_ops(n_iters=2, warmup=1, verbose=False).names()
assert rows == ["l1_xw", "l1_bi", "l2_xw", "l2_af", "l2_bi", "fwd",
                "bwd"], rows
from gcn_tpu_torch.train.capture import CapturedLoop
m4 = GCN(data.num_features, 8, data.num_classes, variant="v6", device="cpu")
m4.fit(data.features, data.adj, data.labels, data.idx_train, train_iters=3,
       jit_loop=False)
assert [h["loss_train"] for h in m4.history] == [h["loss_train"]
                                                 for h in m.history]
assert "fit_scan" in m.timers.names()
from gcn_tpu_torch.parallel import (create_mesh_2d, gather_model_params,
                                    pad_model_params, shard_model_params)
import gcn_tpu_torch.tile.native
from gcn_tpu_torch.tile.ell import ell_adjacency, tile_route
sg2 = shard_graph_by_rows(g, 2)
step, eval_fn, shard_fn = make_sharded_gcn_train_step(
    create_mesh_2d(2, 2, "cpu"), sg2, dropout=0.5, model_axis="model")
a, xs, ys, ms = shard_fn(data.features, data.labels,
                         np.ones(data.num_nodes, np.float32))
params = pad_model_params(init_gcn_params(
    torch.Generator().manual_seed(0), data.num_features, 8,
    data.num_classes, device="cpu"), 2)
opt = adam_l2([t.requires_grad_(True) for _, t in named_leaves(params)])
assert np.isfinite(float(step(params, opt, (1, 0), a, xs, ys, ms)))
assert eval_fn(params, a, xs).shape[1] == data.num_classes
assert gather_model_params(params, create_mesh_2d(2, 2, "cpu"))[
    "gc1"]["w"].shape[1] == 8
ea = ell_adjacency(g, device="cpu")
assert ea.tiler in ("native", "numpy", "ladder")
g.copy().to_dag().eliminate_zeros().permute_rows(
    np.arange(g.shape[0])[::-1]).validate()
import gcn_tpu_torch.time_sharded, gcn_tpu_torch.time_links
import gcn_tpu_torch.bench_scaling, gcn_tpu_torch.ablate_reorder
import gcn_tpu_torch.row_analysis
from gcn_tpu_torch.parallel import projection
assert gcn_tpu_torch.GCN is GCN and gcn_tpu_torch.HGNN is HGNN
assert gcn_tpu_torch.get_dataset is get_dataset and gcn_tpu_torch.spmm is spmm
prows, meta = projection.project_weak_scaling_fullstep(
    [4], nodes_per_device=128, chips_per_host=4, reorder="degree")
assert 0 < prows[0].eff[1.0] <= 1 and "NVIDIA" in meta["spmm_rate_source"]
step, eval_fn, shard_fn = make_sharded_gcn_train_step(
    create_mesh(4, "cpu"), sg4, exchange_dtype="auto",
    widths=(data.num_features, 8, data.num_classes))
a, xs, ys, ms = shard_fn(data.features, data.labels,
                         np.ones(data.num_nodes, np.float32))
params = init_gcn_params(torch.Generator().manual_seed(0), data.num_features,
                         8, data.num_classes, device="cpu")
opt = adam_l2([t.requires_grad_(True) for _, t in named_leaves(params)])
assert np.isfinite(float(step(params, opt, (1, 0), a, xs, ys, ms)))
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "gcn_tpu")
                and sys.modules[k] is not None)
assert not leaked, leaked
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Test set results: loss= " in proc.stdout
