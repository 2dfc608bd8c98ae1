"""Inputs and runners shared by the sharded path's tests: three graphs made
with numpy from a seed (a community graph, a heavy-tailed one in in-band
degree order, one whose bands 1-3 are empty), a small GCN problem on the
first, a few steps of gcn_tpu's sharded step on its 4-device CPU mesh and of
the port's in one process, and the port's step in two gloo processes of two
shards each."""

import json
import os
import re
import socket
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest

from gcn_tpu.data.synthetic import class_features, powerlaw_sbm, sbm
from gcn_tpu.graph.csr import coo_to_csr as jx_coo
from gcn_tpu.graph.normalize import gcn_normalize as jx_normalize
from gcn_tpu.models.gcn_core import init_gcn_params as jx_init
from gcn_tpu.parallel import create_mesh as jx_mesh
from gcn_tpu.parallel import create_mesh_hier as jx_mesh_hier
from gcn_tpu.parallel import make_sharded_gcn_train_step as jx_step
from gcn_tpu.parallel import partition as jx_part
from gcn_tpu.train.optim import adam_l2 as jx_adam

from gcn_tpu_torch.convert import params_from_numpy
from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.parallel import (create_mesh, create_mesh_hier,
                                    make_sharded_gcn_train_step,
                                    shard_graph_by_rows)
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.checkpoint import named_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = 4
STEPS = 3


def port_graph(g):
    """A gcn_tpu CSRGraph as the port's."""
    return CSRGraph(g.indptr, g.indices, g.data, g.shape)


def sbm_graph():
    adj, labels = sbm(n=256, n_classes=4, avg_degree=8.0, seed=3)
    return jx_normalize(adj), labels


def powerlaw_graph():
    adj, _ = powerlaw_sbm(n=1024, n_classes=8, avg_degree=12, seed=3)
    g = jx_normalize(adj)
    sg0 = jx_part.shard_graph_by_rows(g, NS)
    return g.permute(jx_part.band_degree_sort_order(g, sg0.rows_per_shard))


def empty_band_graph():
    """All edges among the first 64 of 256 rows: bands 1-3 are empty."""
    rng = np.random.default_rng(1234)
    src, dst = rng.integers(0, 64, 400), rng.integers(0, 64, 400)
    return jx_normalize(jx_coo(src, dst, np.ones(400, np.float32),
                               (256, 256)).symmetrize())


GRAPHS = {"sbm": lambda: sbm_graph()[0], "powerlaw": powerlaw_graph,
          "empty_band": empty_band_graph}


def problem(nhid=40, with_bias=True):
    """(graph, features, labels, mask, gcn_tpu's initial parameters) on the
    community graph."""
    jg, labels = sbm_graph()
    x = class_features(labels, feat_dim=16, seed=3)
    p0 = jax.tree_util.tree_map(np.asarray,
                                jx_init(jax.random.PRNGKey(0), 16, nhid, 4,
                                        with_bias=with_bias))
    return jg, x, labels, np.ones(jg.shape[0], np.float32), p0


def jax_run(jg, x, labels, mask, p0, steps=STEPS, hier=None,
            hier_fanout="ragged", **kw):
    """gcn_tpu's sharded step at dropout 0 on its 4-device CPU mesh (a
    ``hier`` = (hosts, chips) mesh for the hierarchical exchange, whose
    fan-out gcn_tpu's step takes from ``build_halo_plan_hier``'s default,
    set here): the losses and the eval log-probs."""
    from gcn_tpu.parallel import halo as jx_halo

    jsg = jx_part.shard_graph_by_rows(jg, NS)
    tx = jx_adam(0.01, 5e-4)
    mesh = jx_mesh_hier(*hier) if hier else jx_mesh(NS)
    build = jx_halo.build_halo_plan_hier
    jx_halo.build_halo_plan_hier = partial(build, fanout=hier_fanout)
    try:
        step, eval_fn, shard_fn = jx_step(mesh, jsg, tx, dropout=0.0, **kw)
    finally:
        jx_halo.build_halo_plan_hier = build
    adj, xs, ys, ms = shard_fn(jsg, jx_part.pad_rows(x, jsg),
                               jx_part.pad_rows(labels, jsg),
                               jx_part.pad_rows(mask, jsg))
    params, opt_state, losses = p0, tx.init(p0), []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state,
                                       jax.random.PRNGKey(7), adj, xs, ys,
                                       ms)
        losses.append(float(loss))
    return losses, np.asarray(eval_fn(params, adj, xs))


def port_run(g, x, labels, mask, p0, steps=STEPS, dropout=0.0, mesh=None,
             hier=None, **kw):
    """The port's sharded step, every shard in this process on the CPU
    (a ``hier`` = (hosts, chips) mesh when given): the losses and the eval
    log-probs."""
    sg = shard_graph_by_rows(g, NS)
    if mesh is None:
        mesh = (create_mesh_hier(*hier, "cpu") if hier
                else create_mesh(NS, "cpu"))
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(
        mesh, sg, dropout=dropout, **kw)
    adj, xs, ys, ms = shard_fn(x, labels, mask)
    params = params_from_numpy(p0, "cpu")
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    opt = adam_l2(leaves, 0.01, 5e-4)
    losses = [float(step(params, opt, (8, i), adj, xs, ys, ms))
              for i in range(steps)]
    return losses, eval_fn(params, adj, xs).numpy()


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def subprocess_env():
    """This environment without torchrun's variables, the repository on the
    path, one intra-op thread a process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    return env


WORKER = r"""
import json, logging, sys
import numpy as np
from gcn_tpu_torch.data.synthetic import class_features, sbm
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.parallel import (create_mesh_hier, initialize_multihost,
                                    make_sharded_gcn_train_step,
                                    shard_graph_by_rows)
from gcn_tpu_torch.models.gcn_core import init_gcn_params
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.checkpoint import named_leaves
import torch

coord, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
kw = json.loads(sys.argv[4])
# the sharded step logs the wire it resolves for exchange_dtype="auto"
step_log = logging.getLogger("gcn_tpu_torch.parallel.train_step")
step_log.addHandler(logging.StreamHandler(sys.stdout))
step_log.setLevel(logging.INFO)
p0 = kw.pop("params", None)
hier = kw.pop("hier", None)
mesh = initialize_multihost(coord, world, rank, n_shards=4, device="cpu")
if hier:
    mesh = create_mesh_hier(*hier, device="cpu")
adj, labels = sbm(n=256, n_classes=4, avg_degree=8.0, seed=3)
g = gcn_normalize(adj)
x = class_features(labels, feat_dim=16, seed=3)
kw.setdefault("exchange_chunk", 16)
step, eval_fn, shard_fn = make_sharded_gcn_train_step(
    mesh, shard_graph_by_rows(g, 4), **kw)
a, xs, ys, ms = shard_fn(x, labels, np.ones(256, np.float32))
if p0 is None:
    params = init_gcn_params(torch.Generator().manual_seed(0), 16, 40, 4,
                             device="cpu")
else:
    params = {l: {k: torch.tensor(v, dtype=torch.float32)
                  for k, v in layer.items()} for l, layer in p0.items()}
leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
opt = adam_l2(leaves, 0.01, 5e-4)
losses = [float(step(params, opt, (8, i), a, xs, ys, ms)) for i in range(4)]
print("LOSSES", json.dumps(losses))
print("EVAL", json.dumps(eval_fn(params, a, xs).tolist()))
"""


def gloo_outputs(world=2, **kw):
    """The standard output of each of ``world`` gloo worker processes of 4 /
    world shards each with the step options ``kw`` (``params``: numpy
    parameters to start from; ``hier``: (hosts, chips) of a hierarchical
    mesh)."""
    coord = f"127.0.0.1:{free_port()}"
    arg = json.dumps(kw, default=lambda a: np.asarray(a).tolist())
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, coord, str(world), str(rank), arg],
        cwd=REPO, env=subprocess_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a gloo worker timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    return outs


def gloo_run(world=2, **kw):
    """Each rank's losses and the concatenated eval log-probs of
    ``gloo_outputs(world, **kw)``."""
    outs = gloo_outputs(world, **kw)
    losses = [json.loads(re.search(r"LOSSES (\[.*\])", o).group(1))
              for o in outs]
    lp = np.concatenate([json.loads(re.search(r"EVAL (\[.*\])", o).group(1))
                         for o in outs])
    return losses, lp


def one_process_of_gloo_problem(**kw):
    """The port's step in one process of four shards on the gloo workers'
    problem (their graph and parameters), dropout 0.5 by default."""
    import torch

    from gcn_tpu_torch.convert import params_to_numpy
    from gcn_tpu_torch.data.synthetic import class_features as t_features
    from gcn_tpu_torch.data.synthetic import sbm as t_sbm
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.models.gcn_core import init_gcn_params

    adj, labels = t_sbm(n=256, n_classes=4, avg_degree=8.0, seed=3)
    x = t_features(labels, feat_dim=16, seed=3)
    p0 = params_to_numpy(init_gcn_params(torch.Generator().manual_seed(0),
                                         16, 40, 4, device="cpu"))
    kw.setdefault("dropout", 0.5)
    kw.setdefault("exchange_chunk", 16)
    return port_run(gcn_normalize(adj), x, labels, np.ones(256, np.float32),
                    p0, steps=4, **kw)
