"""The sharded step's gathers and their gradients, on the CPU.

A row that several shards need appears several times in its shard's send
indices, so the send gather's gradient adds several cotangents into one
row. gcn_tpu takes ``jnp.take``, whose transpose is XLA's scatter-add in a
fixed order; ``index_select``'s backward adds them with atomics on the
card. The port's send gather (``parallel/halo.py::gather_send_rows``) adds
one plan segment at a time, whose rows repeat only as the padding's row 0
(zero cotangents); the all_gather baseline's and the segment sum's
``x[cols]`` (``ops/spmm.py::gather_rows``) sums each row's cotangents in
edge order over a sort made with the arrays. Here:

  * on every plan (ragged, padded, hierarchical 2 x 2, 1 x 4 and 4 x 1 with
    both fan-outs) each send gather's forward is ``index_select`` and its
    gradient is bit-equal to ``index_add_`` of the cotangents, also for a
    plain index tensor; so is ``gather_rows``' over a shard's columns;
    both refuse a plain index tensor off the CPU;
  * on every plan a segment repeats no row but row 0, the ragged plan's
    segments ship exactly the rows each destination needs and pad with
    row 0, and the plans under test repeat send rows across segments (the
    padding row at least), so the sums above add duplicates;
  * a float64 ``gradcheck`` of both gathers passes;
  * two runs of 2 sharded steps from the same start leave bit-equal losses
    and parameters on the CPU, in every flavor whose product is the
    segment sum over a gather (the all_gather baseline, ``kernel="segsum"``
    on each plan, the model axis's baseline) and in the default one. On
    synth-small their gathers pass 32,768 elements, where the backward of
    ``x[cols]`` (``index_put_`` with accumulate) adds with atomics across
    threads on the CPU; ``gather_rows`` replaces it there too;
  * the sharded step over the hierarchical exchange at 1 x 4 and 4 x 1 (the
    shapes that repeat rows as the ragged plan does) matches gcn_tpu's at
    dropout 0, at tests/test_torch_port_dist.py's tolerances: per-step
    losses rtol 1e-4, eval log-probs atol 1e-4 + rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.models import GCN
from gcn_tpu_torch.ops.spmm import gather_rows, row_gather
from gcn_tpu_torch.parallel import (build_halo_plan, build_halo_plan_hier,
                                    build_halo_plan_ragged, create_mesh,
                                    create_mesh_2d, create_mesh_hier,
                                    make_sharded_gcn_train_step,
                                    send_indices, shard_graph_by_rows)
from gcn_tpu_torch.parallel.halo import (HierHaloPlan, SendRows,
                                         _pair_boundaries, gather_send_rows,
                                         send_rows)
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.checkpoint import named_leaves
from torch_port_dist_graphs import (GRAPHS, NS, jax_run, port_graph,
                                    port_run, problem)

K = 24
PLANS = {
    "ragged": (build_halo_plan_ragged, None, "ragged"),
    "padded": (build_halo_plan, None, "ragged"),
    **{f"hier {h}x{c} {fan}": (build_halo_plan_hier, (h, c), fan)
       for h, c in ((2, 2), (1, 4), (4, 1))
       for fan in ("ragged", "all_gather")}}


def _plan(name):
    build, hier, fan = PLANS[name]
    sg = shard_graph_by_rows(port_graph(GRAPHS["powerlaw"]()), NS)
    plan = build(sg, *hier, fanout=fan) if hier else build(sg)
    return sg, plan


def _gathers(plan, sg):
    """Each shard's send gathers as (SendRows, table rows): the band's, and
    the ragged fan-out's from the received unions."""
    out = []
    for rows in send_indices(plan, range(NS), "cpu"):
        if isinstance(plan, HierHaloPlan):
            out += [(rows[0], sg.rows_per_shard), (rows[1], sg.rows_per_shard),
                    (rows[2], sum(plan.inter_sizes))]
        else:
            out.append((rows, sg.rows_per_shard))
    return out


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_send_gather_grad_is_index_add(plan_name):
    sg, plan = _plan(plan_name)
    rng = np.random.default_rng(16)
    for rows, n in _gathers(plan, sg):
        assert isinstance(rows, SendRows)
        x = torch.tensor(rng.standard_normal((n, K)), dtype=torch.float32,
                         requires_grad=True)
        ct = torch.tensor(rng.standard_normal((rows.idx.numel(), K)),
                          dtype=torch.float32)
        out = gather_send_rows(x, rows)
        assert torch.equal(out, x.detach().index_select(0, rows.idx))
        out.backward(ct)
        want = torch.zeros(n, K).index_add_(0, rows.idx, ct)
        assert torch.equal(x.grad, want)


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_send_segments_repeat_only_the_padding_row(plan_name):
    """What makes the segment adds race-free on the card: within a
    segment every row but row 0 (the padding) is distinct."""
    sg, plan = _plan(plan_name)
    for rows, n in _gathers(plan, sg):
        assert sum(b - a for a, b in rows.segments) == rows.idx.numel()
        for a, b in rows.segments:
            counts = torch.bincount(rows.idx[a:b], minlength=n)
            assert int((counts[1:] > 1).sum()) == 0


def test_send_gather_takes_a_plain_index_on_the_cpu_only():
    """A plain index tensor (as callers holding a plan's arrays pass it)
    is one segment on the CPU: ``index_add_`` there adds in index order."""
    sg, plan = _plan("ragged")
    idx = torch.as_tensor(plan.send_idx[0], dtype=torch.int64)
    rng = np.random.default_rng(18)
    x = torch.tensor(rng.standard_normal((sg.rows_per_shard, K)),
                     dtype=torch.float32, requires_grad=True)
    ct = torch.tensor(rng.standard_normal((idx.numel(), K)),
                      dtype=torch.float32)
    gather_send_rows(x, idx).backward(ct)
    assert torch.equal(x.grad, torch.zeros(sg.rows_per_shard, K).index_add_(
        0, idx, ct))
    with pytest.raises(ValueError, match="SendRows"):
        gather_send_rows(torch.zeros(4, 2, device="meta"),
                         torch.zeros(3, dtype=torch.int64, device="meta"))


def test_ragged_segments_ship_the_needed_rows():
    sg, plan = _plan("ragged")
    needed, _ = _pair_boundaries(sg)
    for s, rows in enumerate(send_indices(plan, range(NS), "cpu")):
        dests = [(s + t) % NS for t in range(1, NS) if plan.sizes[t - 1]]
        assert len(rows.segments) == len(dests)
        for (a, b), d in zip(rows.segments, dests):
            shipped = rows.idx[a:b].numpy()
            u = needed[d, s]
            np.testing.assert_array_equal(shipped[:len(u)], u)
            assert not shipped[len(u):].any()


def test_send_rows_refuses_a_wrong_plan():
    with pytest.raises(ValueError, match="segments"):
        send_rows(np.arange(10), (8,), 16, "cpu")
    with pytest.raises(ValueError, match="segments"):
        send_rows(np.arange(8) + 4, (8,), 10, "cpu")


def test_gather_rows_grad_is_index_add():
    """``local_spmm``'s gather over each shard's columns (every column
    read by each of its edges)."""
    sg, _ = _plan("ragged")
    rng = np.random.default_rng(17)
    n = sg.n_rows_padded
    for s in range(NS):
        rows = row_gather(sg.cols[s], n, "cpu")
        assert int((torch.bincount(rows.idx) > 1).sum()) > 100
        x = torch.tensor(rng.standard_normal((n, K)), dtype=torch.float32,
                         requires_grad=True)
        ct = torch.tensor(rng.standard_normal((rows.idx.numel(), K)),
                          dtype=torch.float32)
        out = gather_rows(x, rows)
        assert torch.equal(out, x.detach().index_select(0, rows.idx))
        out.backward(ct)
        assert torch.equal(x.grad, torch.zeros(n, K).index_add_(
            0, rows.idx, ct))


def test_gather_rows_refuses_a_plain_index_off_the_cpu():
    table = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="RowGather"):
        gather_rows(table, torch.zeros(3, dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_plans_under_test_repeat_send_rows(plan_name):
    sg, plan = _plan(plan_name)
    repeated = [int((torch.bincount(rows.idx) > 1).sum())
                for rows, _ in _gathers(plan, sg) if rows.idx.numel()]
    assert sum(repeated) > 0
    if plan_name in ("ragged", "padded") or plan_name.startswith(
            ("hier 1x4", "hier 4x1")):
        # rows that two or three other shards read, beside the padding
        assert min(r for r in repeated if r) > 100


@pytest.mark.parametrize("gather", ["send", "rows"])
def test_gathers_gradcheck(gather):
    sg, plan = _plan("ragged")
    rows = send_indices(plan, [0], "cpu")[0]
    if gather == "rows":
        rows = row_gather(rows.idx.numpy(), sg.rows_per_shard, "cpu")
    assert int((torch.bincount(rows.idx) > 1).sum()) > 0
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (sg.rows_per_shard, 2)), dtype=torch.float64, requires_grad=True)
    fn = gather_send_rows if gather == "send" else gather_rows
    assert torch.autograd.gradcheck(lambda t: fn(t, rows), (x,))


@pytest.mark.parametrize("hier", [(1, 4), (4, 1)])
@pytest.mark.parametrize("fanout", ["ragged", "all_gather"])
def test_hier_step_matches_gcn_tpu(hier, fanout):
    """nhid 40 > chunk 16: layer 1's exchange goes in 3 slices."""
    jg, x, labels, mask, p0 = problem()
    kw = dict(exchange="halo_hier", hier=hier, hier_fanout=fanout,
              exchange_chunk=16)
    want_l, want_lp = jax_run(jg, x, labels, mask, p0, **kw)
    got_l, got_lp = port_run(port_graph(jg), x, labels, mask, p0, **kw)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=0)
    np.testing.assert_allclose(got_lp, want_lp, rtol=1e-5, atol=1e-4)


STEP_FLAVORS = {
    "halo": (None, dict()),
    "halo_segsum": (None, dict(kernel="segsum")),
    "padded_segsum": (None, dict(exchange="halo_padded", kernel="segsum")),
    "hier_segsum": ((2, 2), dict(exchange="halo_hier", kernel="segsum")),
    "all_gather": (None, dict(exchange="all_gather")),
    "model_axis_all_gather": ("model", dict(exchange="all_gather",
                                            model_axis="model")),
}


@pytest.mark.parametrize("flavor", list(STEP_FLAVORS))
def test_sharded_step_two_runs_bit_equal(flavor):
    data = get_dataset("synth-small", seed=15)
    sg = shard_graph_by_rows(gcn_normalize(data.adj), NS)
    mesh_of, kw = STEP_FLAVORS[flavor]
    mesh = (create_mesh_2d(NS, 2, "cpu") if mesh_of == "model" else
            create_mesh_hier(*mesh_of, "cpu") if mesh_of else
            create_mesh(NS, "cpu"))
    step, _, shard_fn = make_sharded_gcn_train_step(mesh, sg, dropout=0.0,
                                                    **kw)
    p0 = params_to_numpy(GCN(data.num_features, 32, data.num_classes,
                             seed=15, device="cpu").init_params())
    mask = np.ones(sg.n_rows, np.float32)
    runs = []
    for _ in range(2):
        params = params_from_numpy(p0, "cpu")
        opt = adam_l2([t.requires_grad_(True)
                       for _, t in named_leaves(params)])
        adj, xs, ys, ms = shard_fn(data.features, data.labels, mask)
        losses = [float(step(params, opt, (1, i), adj, xs, ys, ms))
                  for i in range(2)]
        runs.append((losses, [t.detach().clone()
                              for _, t in named_leaves(params)]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
