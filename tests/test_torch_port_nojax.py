"""gcn_tpu_torch imports, trains GCN and HGNN (both forms of G), runs the
panel and frequency-split SpMMs, saves and resumes a training state, takes
sharded training steps over two row bands, imports the host modules
(loaders, CSV dumps, row analysis, artifacts, profiling), reorders by
gorder and profiles a fitted model's ops, with jax and gcn_tpu blocked."""

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
