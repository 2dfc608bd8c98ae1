"""The model axis of the port's sharded step against gcn_tpu's, on the CPU.

``make_sharded_gcn_train_step(model_axis="model")`` on ``create_mesh_2d(4,
2)`` (every exchange, overlap and kernel that gcn_tpu composes with a model
axis) and on ``create_mesh_hier_model(2, 2, 2)`` (``halo_hier``) matches
gcn_tpu's model-axis step on the conftest's 8 fake CPU devices over 3
``adam_l2`` steps at dropout 0, at the sizes of tests/test_parallel.py's
model-axis tests: per-step losses at rtol 1e-4, eval log-probs at rtol
1e-5 + atol 1e-4, post-step parameters at rtol 1e-5 + atol 1e-6
(tests/test_torch_port_dist_flavors.py's tolerances). Widths that do not
divide the model axis go through ``pad_model_params``: its arrays equal
gcn_tpu's, the padded entries stay exactly zero and the trimmed model is
the unpadded one. The model-axis step equals the port's own 1-D step
under plain SGD (which, unlike Adam, passes a gradient's scale on to the
parameters), in one process and over four gloo processes of one slot each:
that holds the model sum's backward to the identity and the gradient
all-reduce to the data group. Two and four gloo processes match one.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.data.synthetic import class_features, sbm
from gcn_tpu.graph.normalize import gcn_normalize as jx_normalize
from gcn_tpu.models.gcn_core import init_gcn_params as jx_init
from gcn_tpu.parallel import create_mesh_2d as jx_mesh_2d
from gcn_tpu.parallel import create_mesh_hier_model as jx_mesh_hier_model
from gcn_tpu.parallel import make_sharded_gcn_train_step as jx_step
from gcn_tpu.parallel import pad_model_params as jx_pad
from gcn_tpu.parallel import shard_graph_by_rows as jx_shard
from gcn_tpu.parallel.partition import pad_rows as jx_pad_rows
from gcn_tpu.train.optim import adam_l2 as jx_adam

from gcn_tpu_torch.convert import params_from_numpy
from gcn_tpu_torch.parallel import (Mesh, create_mesh, create_mesh_2d,
                                    create_mesh_hier_model,
                                    gather_model_params,
                                    make_sharded_gcn_train_step,
                                    pad_model_params, shard_graph_by_rows,
                                    shard_model_params)
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.checkpoint import named_leaves
from torch_port_dist_graphs import REPO, free_port, port_graph, subprocess_env
from torch_port_model_axis_worker import run as worker_run

STEPS = 3
LOSS_TOL = dict(rtol=1e-4, atol=0)
LP_TOL = dict(rtol=1e-5, atol=1e-4)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def problem(n=512, classes=5, feat=32, hid=16, seed=3):
    """(graph, features, labels, mask, gcn_tpu's initial parameters): the
    community graph of tests/test_parallel.py's model-axis tests."""
    adj, labels = sbm(n=n, n_classes=classes, avg_degree=8.0, seed=seed)
    x = class_features(labels, feat_dim=feat, seed=seed)
    p0 = jax.tree_util.tree_map(np.asarray,
                                jx_init(jax.random.PRNGKey(0), feat, hid,
                                        classes))
    return jx_normalize(adj), x, labels, np.ones(n, np.float32), p0


def _numpy(params):
    return {layer: {k: np.asarray(v) for k, v in leaves.items()}
            for layer, leaves in params.items()}


def jax_run(g, x, labels, mask, p0, mesh, steps=STEPS, **kw):
    """gcn_tpu's model-axis step at dropout 0 (``mesh`` = ("2d", data,
    model) or ("hier_model", hosts, chips, model)): the losses, the eval
    log-probs and the post-step parameters."""
    kind, *shape = mesh
    jmesh = (jx_mesh_2d if kind == "2d" else jx_mesh_hier_model)(*shape)
    bands = int(np.prod(shape[:-1]))
    jsg = jx_shard(g, bands)
    tx = jx_adam(0.01, 5e-4)
    step, eval_fn, shard_fn = jx_step(jmesh, jsg, tx, dropout=0.0,
                                      model_axis="model", **kw)
    adj, xs, ys, ms = shard_fn(jsg, jx_pad_rows(x, jsg),
                               jx_pad_rows(labels, jsg),
                               jx_pad_rows(mask, jsg))
    params, opt_state, losses = p0, tx.init(p0), []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state,
                                       jax.random.PRNGKey(7), adj, xs, ys,
                                       ms)
        losses.append(float(loss))
    lp = np.asarray(eval_fn(params, adj, xs))[:g.shape[0]]
    return losses, lp, _numpy(jax.device_get(params))


def port_run(g, x, labels, mask, p0, mesh, steps=STEPS, dropout=0.0,
             sgd=None, **kw):
    """The port's step, every slot in this process on the CPU (``mesh`` as
    ``jax_run``'s, or ("1d", bands) for the 1-D step); adam_l2, or SGD at
    learning rate ``sgd``."""
    kind, *shape = mesh
    pmesh = {"2d": create_mesh_2d, "hier_model": create_mesh_hier_model,
             "1d": create_mesh}[kind](*shape, device="cpu")
    if pmesh.model_axis is not None:
        kw["model_axis"] = "model"
    sg = shard_graph_by_rows(port_graph(g), pmesh.n_shards)
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(
        pmesh, sg, dropout=dropout, **kw)
    adj, xs, ys, ms = shard_fn(x, labels, mask)
    params = shard_model_params(params_from_numpy(p0, "cpu"), pmesh)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    opt = (adam_l2(leaves, 0.01, 5e-4) if sgd is None
           else torch.optim.SGD(leaves, lr=sgd))
    losses = [float(step(params, opt, (8, i), adj, xs, ys, ms))
              for i in range(steps)]
    lp = eval_fn(params, adj, xs).numpy()[:g.shape[0]]
    return losses, lp, _numpy(gather_model_params(params, pmesh))


def assert_params_close(got, want, tol=PARAM_TOL):
    assert got.keys() == want.keys()
    for layer in want:
        assert got[layer].keys() == want[layer].keys()
        for k in want[layer]:
            np.testing.assert_allclose(got[layer][k], want[layer][k], **tol,
                                       err_msg=f"{layer}.{k}")


CONFIGS_2D = {
    "halo_blocks": dict(),
    "halo_split": dict(overlap="split"),
    "halo_no_overlap": dict(overlap=False),
    "halo_segsum": dict(kernel="segsum"),
    "padded_blocks": dict(exchange="halo_padded"),
    "padded_split": dict(exchange="halo_padded", overlap="split"),
    "padded_no_overlap": dict(exchange="halo_padded", overlap=False),
    "padded_segsum": dict(exchange="halo_padded", kernel="segsum"),
    "all_gather_segsum": dict(exchange="all_gather"),
}
CONFIGS_HIER = {
    "hier_blocks": dict(exchange="halo_hier"),
    "hier_split": dict(exchange="halo_hier", overlap="split"),
    "hier_no_overlap": dict(exchange="halo_hier", overlap=False),
    "hier_segsum": dict(exchange="halo_hier", kernel="segsum"),
}


@pytest.mark.parametrize("config", list(CONFIGS_2D))
def test_model_axis_matches_gcn_tpu(config):
    """4 bands x 2 model slots: K1's plain version aggregates each slot's
    hidden shard (8 of 16 columns) on every layout."""
    g, x, labels, mask, p0 = problem()
    kw = CONFIGS_2D[config]
    want = jax_run(g, x, labels, mask, p0, ("2d", 4, 2), **kw)
    got = port_run(g, x, labels, mask, p0, ("2d", 4, 2), **kw)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **LP_TOL)
    assert_params_close(got[2], want[2])


@pytest.mark.parametrize("config", list(CONFIGS_HIER))
def test_hier_model_axis_matches_gcn_tpu(config):
    """2 hosts x 2 chips x 2 model slots: the hierarchical exchange's two
    levels run within each model slot (test_parallel.py's sizes)."""
    g, x, labels, mask, p0 = problem(classes=4, feat=16, hid=16)
    kw = CONFIGS_HIER[config]
    want = jax_run(g, x, labels, mask, p0, ("hier_model", 2, 2, 2), **kw)
    got = port_run(g, x, labels, mask, p0, ("hier_model", 2, 2, 2), **kw)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **LP_TOL)
    assert_params_close(got[2], want[2])


def test_indivisible_widths_pad():
    """nfeat 31, nhid 13 on a model axis of 2: ``pad_model_params`` gives
    gcn_tpu's arrays, ``shard_fn`` pads x's columns to 32, the padded
    entries are exactly zero after 3 steps, the run equals gcn_tpu's, and
    the trimmed parameters and log-probs equal the unpadded 1-D step's."""
    feat, hid = 31, 13
    g, x, labels, mask, p0 = problem(n=256, classes=4, feat=feat, hid=hid,
                                     seed=5)
    padded = pad_model_params(params_from_numpy(p0, "cpu"), 2)
    want_pad = _numpy(jx_pad(p0, 2))
    assert padded["gc1"]["w"].shape == (32, 14)
    assert padded["gc2"]["w"].shape == (14, 4)
    for layer in want_pad:
        for k, v in want_pad[layer].items():
            got = padded[layer][k].numpy()
            assert got.dtype == v.dtype and np.array_equal(got, v)
    p_pad = _numpy(padded)
    sg = shard_graph_by_rows(port_graph(g), 4)
    _, _, shard_fn = make_sharded_gcn_train_step(
        create_mesh_2d(4, 2, "cpu"), sg, model_axis="model")
    xs = shard_fn(x, labels, mask)[1]
    assert [tuple(t.shape) for t in xs[:2]] == [(64, 16), (64, 16)]
    assert not xs[1][:, -1].any()          # the padded column

    want = jax_run(g, x, labels, mask, p_pad, ("2d", 4, 2))
    got = port_run(g, x, labels, mask, p_pad, ("2d", 4, 2))
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **LP_TOL)
    assert_params_close(got[2], want[2])
    p = got[2]
    assert not np.abs(p["gc1"]["w"][feat:]).any()
    assert not np.abs(p["gc1"]["w"][:, hid:]).any()
    assert not np.abs(p["gc1"]["b"][hid:]).any()
    assert not np.abs(p["gc2"]["w"][hid:]).any()
    trimmed = {"gc1": {"w": p["gc1"]["w"][:feat, :hid],
                       "b": p["gc1"]["b"][:hid]},
               "gc2": {"w": p["gc2"]["w"][:hid], "b": p["gc2"]["b"]}}
    one_l, one_lp, one_p = port_run(g, x, labels, mask, p0, ("1d", 4))
    np.testing.assert_allclose(got[0], one_l, **LOSS_TOL)
    np.testing.assert_allclose(got[1], one_lp, **LP_TOL)
    assert_params_close(trimmed, one_p)


@pytest.mark.parametrize("config", ["halo_blocks", "padded_split",
                                    "halo_no_overlap", "all_gather_segsum",
                                    "hier_blocks"])
def test_model_axis_equals_the_1d_step(config):
    """SGD at learning rate 1, 2 steps, dropout 0: the model-axis step's
    losses and post-step parameters equal the port's 1-D step's on the
    same bands (one process: the model sum and reduce-scatter are local
    sums and column splits)."""
    g, x, labels, mask, p0 = problem(classes=4, feat=16, hid=16)
    if config.startswith("hier"):
        kw, mesh = CONFIGS_HIER[config], ("hier_model", 2, 2, 2)
    else:
        kw, mesh = CONFIGS_2D[config], ("2d", 4, 2)
    flat = port_run(g, x, labels, mask, p0, ("1d", 4), steps=2, sgd=1.0)
    got = port_run(g, x, labels, mask, p0, mesh, steps=2, sgd=1.0, **kw)
    np.testing.assert_allclose(got[0], flat[0], rtol=1e-5, atol=0)
    assert_params_close(got[2], flat[2])


def test_mesh_slots_and_their_owners():
    """Slot = band * n_model + model, a contiguous run of slots a rank:
    whole bands, or part of one band; other splits raise."""
    mesh = create_mesh_2d(4, 2, "cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.model_axis == "model" and mesh.data_axes == ("data",)
    assert list(mesh.slots) == list(range(8)) and list(mesh.shards) == [0, 1,
                                                                      2, 3]
    assert list(mesh.model_slots) == [0, 1] and not mesh.model_parallel
    whole = dataclasses.replace(mesh, rank=1, world_size=2)
    assert list(whole.slots) == [4, 5, 6, 7] and list(whole.shards) == [2, 3]
    assert [whole.owner(s) for s in range(8)] == [0] * 4 + [1] * 4
    assert whole.local_index(6) == 2 and whole.data_ranks == (0, 1)
    assert whole.model_ranks == (1,) and not whole.model_parallel
    part = Mesh(n_shards=2, device=torch.device("cpu"), rank=3,
                world_size=4, n_model=2, axis_names=("data", "model"))
    assert list(part.slots) == [3] and list(part.shards) == [1]
    assert list(part.model_slots) == [1] and part.model_parallel
    assert part.data_ranks == (1, 3) and part.model_ranks == (2, 3)
    quarter = Mesh(n_shards=2, device=torch.device("cpu"), rank=5,
                   world_size=8, n_model=4, axis_names=("data", "model"))
    assert list(quarter.model_slots) == [1] and quarter.ranks_per_band == 4
    half = dataclasses.replace(quarter, rank=1, world_size=4)
    assert list(half.model_slots) == [2, 3] and half.data_ranks == (1, 3)
    hier = create_mesh_hier_model(2, 2, 2, "cpu")
    assert hier.axis_names == ("host", "chip", "model")
    assert hier.data_axes == ("host", "chip") and hier.n_shards == 4
    flat = create_mesh(4, "cpu")
    assert flat.model_axis is None and flat.n_slots == 4
    with pytest.raises(ValueError, match="spread evenly"):
        dataclasses.replace(mesh, world_size=3)
    with pytest.raises(ValueError, match="spread evenly"):
        dataclasses.replace(mesh, world_size=16)
    with pytest.raises(ValueError, match="whole bands"):
        Mesh(n_shards=3, device=torch.device("cpu"), world_size=2,
             n_model=4)


@pytest.mark.parametrize("mesh,kw,match", [
    ("2d", dict(), "pass model_axis"),
    ("2d", dict(model_axis="rows"), "no axis 'rows'"),
    ("2d", dict(model_axis="model", axis="host"), "no axis 'host'"),
    ("2d", dict(model_axis="model", axis="model"), "row axes"),
    ("hier", dict(model_axis="model", axis="data"), "no axis 'data'"),
    ("2d", dict(model_axis="model", exchange="halo_hier"),
     "create_mesh_hier"),
])
def test_model_axis_options_raise(mesh, kw, match):
    sg = shard_graph_by_rows(port_graph(problem()[0]), 4)
    m = (create_mesh_2d(4, 2, "cpu") if mesh == "2d"
         else create_mesh_hier_model(2, 2, 2, "cpu"))
    with pytest.raises(ValueError, match=match):
        make_sharded_gcn_train_step(m, sg, **kw)


def test_bias_and_width_mismatches_raise():
    """``with_bias`` must state whether the parameters hold biases, and
    nhid must divide the model axis (else ``pad_model_params``)."""
    g, x, labels, mask, p0 = problem(n=256, classes=4, feat=16, hid=13)
    sg = shard_graph_by_rows(port_graph(g), 4)
    mesh = create_mesh_2d(4, 2, "cpu")
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(
        mesh, sg, model_axis="model", with_bias=False)
    adj, xs, _, _ = shard_fn(x, labels, mask)
    params = pad_model_params(params_from_numpy(p0, "cpu"), 2)
    with pytest.raises(ValueError, match="with_bias"):
        eval_fn(params, adj, xs)
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(
        mesh, sg, model_axis="model")
    with pytest.raises(ValueError, match="pad_model_params"):
        eval_fn(params_from_numpy(p0, "cpu"), adj, xs)
    assert eval_fn(params, adj, xs).shape == (256, 4)


def test_model_axis_meshes_default_to_the_card():
    if torch.cuda.is_available():
        assert create_mesh_2d(4, 2).device.type == "cuda"
        assert create_mesh_hier_model(2, 2, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_mesh_2d(4, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_mesh_hier_model(2, 2, 2)


def _gloo(world, kw):
    """The worker in ``world`` gloo processes; returns each rank's result
    (losses, and the eval log-probs by band; rank 0's full parameters)."""
    import json
    import re

    coord = f"127.0.0.1:{free_port()}"
    script = os.path.join(REPO, "tests", "torch_port_model_axis_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, script, coord, str(world), str(rank),
         json.dumps(kw)], cwd=REPO, env=subprocess_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
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

    def field(out, key):
        found = re.search(rf"^{key} (.*)$", out, re.M)
        return json.loads(found.group(1)) if found else None

    lp = {}
    for out in outs:
        lp.update({int(b): np.asarray(v)
                   for b, v in (field(out, "EVAL") or {}).items()})
    params = {layer: {k: np.asarray(v, np.float32) for k, v in lv.items()}
              for layer, lv in field(outs[0], "PARAMS").items()}
    return [field(out, "LOSSES") for out in outs], lp, params


@pytest.mark.parametrize("world,kw", [
    (2, dict(mesh=["2d", 4, 2])),
    (4, dict(mesh=["2d", 2, 2], exchange="halo_padded")),
    (4, dict(mesh=["2d", 2, 2], exchange="all_gather")),
    (4, dict(mesh=["2d", 2, 2], overlap="split")),
    (4, dict(mesh=["hier_model", 2, 2, 2], exchange="halo_hier")),
], ids=["whole_bands_2", "one_slot_padded_4", "one_slot_all_gather_4",
        "one_slot_split_4", "hier_whole_bands_4"])
def test_gloo_processes_match_one_process(world, kw):
    """Processes of whole bands, or of one slot each (the model sum and
    reduce-scatter over gloo, the padded all-to-all and the all_gather on
    the data group), against one process of every slot: dropout 0.5 (the
    masks seeded by slot), 4 adam_l2 steps."""
    kw = dict(kw, dropout=0.5)
    losses, lp, params = _gloo(world, kw)
    assert all(ls == losses[0] for ls in losses)
    one = worker_run(kw)
    np.testing.assert_allclose(losses[0], one["losses"], rtol=1e-5, atol=0)
    assert sorted(lp) == sorted(one["eval"])
    for b, want in one["eval"].items():
        np.testing.assert_allclose(lp[b], want, rtol=1e-5, atol=1e-5)
    assert_params_close(params, one["params"])


def test_gloo_one_slot_processes_equal_the_1d_step():
    """Four processes of one slot each (2 bands x 2 model slots), SGD at
    learning rate 1, dropout 0: the post-step parameters equal the 1-D
    step's on the same 2 bands in one process. A model sum whose backward
    all-reduced, or a gradient all-reduce over the world, would scale or
    mix the gradients."""
    kw = dict(dropout=0.0, optimizer="sgd", lr=1.0, steps=2)
    losses, _, params = _gloo(4, dict(kw, mesh=["2d", 2, 2]))
    flat = worker_run(dict(kw, mesh=["1d", 2]))
    np.testing.assert_allclose(losses[0], flat["losses"], rtol=1e-5, atol=0)
    assert_params_close(params, flat["params"])
