"""The port's DeeperGCN (``models/deepergcn.py``, ``ops/softmax_agg.py``,
``layers.gen_conv`` / ``batch_norm``, ``fit_gcn``'s buffers) on the CPU
against the plain dense reference of ``torch_port_deepergcn_reference.py``,
on seeded random weights at a small size: 300 vertices, hidden 16, 4
layers, and one 28-layer case at hidden 8.

The graph has a hub whose row holds more than ``LONG_ROW`` edges and an
isolated last vertex (only its self loop).

Tolerances: in float64 the port and the reference differ only in the
order of their sums (segment sums against a dense softmax and einsum;
batch statistics by ``var_mean`` against ``F.batch_norm``), so values and
gradients agree to rtol 1e-9. The fit runs in float32, as
``DeeperGCN.fit`` does: losses at rtol 1e-5, each leaf's change over its
3 Adam steps within 1e-3 of the reference's change in norm (Adam divides
by the gradient's own size, so an element whose gradient is at rounding
level can move by a sizeable share of lr on either side; the norm of the
change is not), the running variances at rtol 1e-4 (float32 sums of 300
rows through 4 layers). The convolutions' biases are left out of the
fit's comparison: each adds a constant to a channel of h, which batch
norm removes wherever h is used, so their gradient is rounding.
"""

import hashlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_port_deepergcn_reference as ref
from gcn_tpu_torch.graph import hypergraph as hg
from gcn_tpu_torch.graph.csr import coo_to_csr
from gcn_tpu_torch.models import GAT, GCN, HGNN, DeeperGCN
from gcn_tpu_torch.models.deepergcn import (deepergcn_forward,
                                            deepergcn_layers)
from gcn_tpu_torch.models.layers import batch_norm
from gcn_tpu_torch.ops.adjacency import LONG_ROW, device_adjacency
from gcn_tpu_torch.ops.gat_attn import gat_layout
from gcn_tpu_torch.ops.softmax_agg import softmax_aggregate
from gcn_tpu_torch.utils.timers import counters

N, F_IN, C = 300, 12, 5


def _graph(seed=0):
    """Vertex 0 a hub of 280 neighbours, random edges among 1..298, the
    last vertex isolated; symmetric, no self loops."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(280, np.int64), rng.integers(1, N - 1,
                                                                 600)])
    dst = np.concatenate([np.arange(1, 281), rng.integers(1, N - 1, 600)])
    return coo_to_csr(src, dst, None, (N, N)).symmetrize()


@pytest.fixture(scope="module")
def graph():
    g = _graph()
    with_loops = g.with_self_loops()
    lay = gat_layout(device_adjacency(with_loops, "coo", device="cpu"))
    mask = torch.as_tensor(with_loops.to_dense() != 0)
    return g, lay, mask


def _data(seed=1, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((N, F_IN)), dtype=dtype)
    labels = torch.as_tensor(rng.integers(0, C, N))
    return x, labels, torch.arange(0, N, 3), torch.arange(1, N, 3)


# ---- the aggregation ------------------------------------------------------


@pytest.mark.parametrize("k,t,scale", [(16, 0.1, 1.0), (8, 1.0, 3.0),
                                       (12, 0.1, 800.0)])
def test_aggregation_and_its_gradient_match_reference(graph, k, t, scale):
    """Rows past ``LONG_ROW``, and t m reaching ~80 where the scale is
    800 (a factored exp(t m) exp(-lse) would overflow float32 there)."""
    _, lay, mask = graph
    assert int(lay.row_len[0]) > LONG_ROW
    gen = torch.Generator().manual_seed(k)
    m = (scale * torch.rand((N, k), generator=gen, dtype=torch.float64)
         ).requires_grad_(True)
    if scale > 100:
        assert 70 < float(t * m.detach().max()) < 90
    got = softmax_aggregate(lay, m, t)
    want = ref.dense_aggregate(mask, m, t)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    # the isolated last vertex aggregates its own row alone
    torch.testing.assert_close(got[-1], m[-1].detach(), rtol=1e-12, atol=0)
    da = torch.randn((N, k), generator=gen, dtype=torch.float64)
    g_got, = torch.autograd.grad(got, m, da)
    g_want, = torch.autograd.grad(want, m, da)
    torch.testing.assert_close(g_got, g_want, rtol=1e-9, atol=1e-12)


def test_weights_are_held_constant_and_t_gets_no_gradient(graph):
    """The gradient is the reference's with its weights under no_grad, and
    far from the gradient through the weights; a t that asks for a
    gradient gets none."""
    _, lay, mask = graph
    gen = torch.Generator().manual_seed(3)
    m = (2 * torch.rand((N, 8), generator=gen, dtype=torch.float64)
         ).requires_grad_(True)
    t = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    da = torch.randn((N, 8), generator=gen, dtype=torch.float64)
    got, = torch.autograd.grad(softmax_aggregate(lay, m, t), m, da)
    detached, = torch.autograd.grad(ref.dense_aggregate(mask, m, 0.5), m, da)
    through, = torch.autograd.grad(
        ref.dense_aggregate(mask, m, 0.5, detach_weights=False), m, da)
    torch.testing.assert_close(got, detached, rtol=1e-9, atol=1e-12)
    assert float((got - through).norm() / through.norm()) > 0.05
    assert t.grad is None


def test_every_call_counts_and_none_takes_a_kernel_on_the_cpu(graph):
    _, lay, _ = graph
    before = dict(counters)
    m = torch.rand((N, 8), dtype=torch.float64, requires_grad=True)
    softmax_aggregate(lay, m, 0.1).sum().backward()
    with torch.no_grad():
        softmax_aggregate(lay, m, 0.1)
    assert counters["softmax_agg"] - before.get("softmax_agg", 0) == 3
    assert not any(v - before.get(k, 0) for k, v in counters.items()
                   if k.startswith("softmax_agg_k"))


# ---- batch norm -----------------------------------------------------------


def test_batch_norm_running_statistics_and_evaluation_match_reference():
    gen = torch.Generator().manual_seed(2)
    w = 1 + 0.1 * torch.randn((1, 16), generator=gen, dtype=torch.float64)
    b = 0.1 * torch.randn(16, generator=gen, dtype=torch.float64)
    ours = {"mean": torch.zeros(16, dtype=torch.float64),
            "var": torch.ones(16, dtype=torch.float64)}
    theirs = {k: v.clone() for k, v in ours.items()}
    for step in range(3):
        h = 3 * torch.randn((N, 16), generator=gen, dtype=torch.float64) + step
        got = batch_norm({"w": w, "b": b}, ours, h, train=True)
        want = torch.nn.functional.batch_norm(
            h, theirs["mean"], theirs["var"], w.view(-1), b, training=True,
            momentum=0.1, eps=1e-5)
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)
    for k in ours:
        torch.testing.assert_close(ours[k], theirs[k], rtol=1e-12, atol=0)
    h = torch.randn((N, 16), generator=gen, dtype=torch.float64)
    torch.testing.assert_close(
        batch_norm({"w": w, "b": b}, ours, h, train=False),
        torch.nn.functional.batch_norm(h, theirs["mean"], theirs["var"],
                                       w.view(-1), b, training=False,
                                       eps=1e-5),
        rtol=1e-12, atol=1e-12)


# ---- the model ------------------------------------------------------------


def test_published_size_has_491176_parameters():
    layers = deepergcn_layers(128, 40, num_layers=28, hidden=128)
    assert sum(i * o + o for _, i, o in layers) == 491_176
    assert [name for name, _, _ in layers[:4]] == ["enc", "conv0", "norm0",
                                                   "conv1"]
    assert layers[-2:] == [("norm27", 1, 128), ("out", 128, 40)]
    model = DeeperGCN(128, 40, device="cpu")
    params = model.init_params()
    assert sum(t.numel() for layer in params.values()
               for t in layer.values()) == 491_176
    assert torch.equal(params["norm3"]["w"], torch.ones(1, 128))
    assert len(model.init_buffers()) == 28


def _params(layers, seed, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, i, o in layers:
        if name.startswith("norm"):
            out[name] = {"w": 1 + 0.2 * torch.randn((1, o), generator=gen,
                                                    dtype=dtype),
                         "b": 0.1 * torch.randn(o, generator=gen,
                                                dtype=dtype)}
        else:
            out[name] = {"w": torch.randn((i, o), generator=gen,
                                          dtype=dtype) / i ** 0.5,
                         "b": 0.1 * torch.randn(o, generator=gen,
                                                dtype=dtype)}
    return out


def _buffers(layers, dtype=torch.float64):
    return {name: {"mean": torch.zeros(o, dtype=dtype),
                   "var": torch.ones(o, dtype=dtype)}
            for name, _, o in layers if name.startswith("norm")}


@pytest.mark.parametrize("num_layers,hidden", [(4, 16), (28, 8)])
def test_forward_loss_and_every_gradient_match_reference(graph, num_layers,
                                                         hidden):
    """A training forward with dropout 0.5 (both sides draw the same masks
    from generators of one seed), its loss and every leaf's gradient, the
    running statistics it leaves, and the evaluation forward after it."""
    _, lay, mask = graph
    x, labels, idx, _ = _data()
    layers = deepergcn_layers(F_IN, C, num_layers, hidden)
    params = _params(layers, 3)
    leaves = [t.requires_grad_(True) for layer in params.values()
              for t in layer.values()]
    ours, theirs = _buffers(layers), _buffers(layers)
    lp = deepergcn_forward(params, ours, x, lay, num_layers=num_layers,
                           t=0.1, dropout_rate=0.5, train=True,
                           generator=torch.Generator().manual_seed(9))
    want = ref.logits(params, theirs, x, mask, num_layers, 0.1, train=True,
                      dropout=0.5,
                      generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(lp, want, rtol=1e-9, atol=1e-11)
    got = torch.autograd.grad(ref.loss(lp, labels, idx), leaves)
    wanted = torch.autograd.grad(ref.loss(want, labels, idx), leaves)
    assert len(got) == 4 * num_layers + 4
    for a, b in zip(got, wanted):
        assert b.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-12)
    for name in ours:
        for k in ("mean", "var"):
            torch.testing.assert_close(ours[name][k], theirs[name][k],
                                       rtol=1e-9, atol=1e-12)
    with torch.no_grad():
        torch.testing.assert_close(
            deepergcn_forward(params, ours, x, lay, num_layers=num_layers,
                              t=0.1),
            ref.logits(params, theirs, x, mask, num_layers, 0.1),
            rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("jit_loop", [True, False])
def test_three_step_fit_matches_reference(graph, jit_loop):
    """``DeeperGCN.fit`` in float32 with dropout 0.5 against the reference's
    3 Adam steps: losses, parameters and running statistics; no call takes
    a kernel on the CPU."""
    g, _, mask = graph
    x, labels, idx, _ = _data(dtype=torch.float32)
    model = DeeperGCN(F_IN, C, num_layers=4, hidden=16, seed=4,
                      device="cpu")
    p0, b0 = model.init_params(), model.init_buffers()
    before = dict(counters)
    model.fit(x.numpy(), g, labels.numpy(), idx.numpy(), train_iters=3,
              mode="no_val", jit_loop=jit_loop)
    calls = counters["softmax_agg"] - before.get("softmax_agg", 0)
    # 4 forward and 4 backward calls a step, 4 in the final evaluation
    assert calls == 3 * 8 + 4
    assert not any(v - before.get(k, 0) for k, v in counters.items()
                   if k.startswith("softmax_agg_k"))
    losses, want, want_buf = ref.adam_fit(
        p0, b0, x, mask, labels, idx, 4, model.t, steps=3, lr=model.lr,
        dropout=0.5, generator=torch.Generator().manual_seed(model.seed + 1))
    np.testing.assert_allclose([h["loss_train"] for h in model.history],
                               losses, rtol=1e-5)
    for name, layer in model.params.items():
        for k, t in layer.items():
            if name.startswith("conv") and k == "b":
                # a convolution's bias adds a constant to each channel of
                # h, which every later use of h normalizes away (batch
                # norm): its gradient is rounding, and Adam's step on it
                # a coin toss
                continue
            moved = want[name][k].detach() - p0[name][k]
            gap = (t - want[name][k].detach()).norm() / moved.norm()
            assert gap < 1e-3, (name, k, float(gap))
    # the variances at rtol 1e-4; the means also follow the biases' coin
    # tosses, which shift h by at most 2 lr a step and channel on either
    # side, so within 1e-2 (momentum 0.1 over 3 steps of shifts of at most
    # 0.06 a channel)
    for name, b in model.buffers.items():
        torch.testing.assert_close(b["var"], want_buf[name]["var"],
                                   rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(b["mean"], want_buf[name]["mean"],
                                   rtol=0, atol=1e-2)


def _fit(g, mode, iters, lr=0.01, patience=100):
    x, labels, idx, idx_val = _data(dtype=torch.float32)
    model = DeeperGCN(F_IN, C, num_layers=3, hidden=8, seed=6, lr=lr,
                      device="cpu")
    model.fit(x.numpy(), g, labels.numpy(), idx.numpy(),
              None if mode == "no_val" else idx_val.numpy(),
              train_iters=iters, mode=mode, patience=patience)
    return model


def _snapshot_equal(a, b):
    return all(torch.equal(a[k][j], b[k][j]) for k in a for j in a[k])


@pytest.mark.parametrize("mode", ["val", "early_stop"])
def test_fit_gcn_carries_the_buffers(graph, mode):
    """``TrainResult``'s best buffers are the running statistics of the
    best iteration, its final ones those of the last executed one (a run
    of that many iterations without val gives both bit for bit), the
    model keeps the best ones, and a stopped iteration changes none."""
    from gcn_tpu_torch.train import loop

    g = graph[0]
    seen = {}
    real = loop.fit_gcn

    def keep(*a, **kw):
        seen["result"] = real(*a, **kw)
        return seen["result"]

    loop_fit = pytest.MonkeyPatch()
    loop_fit.setattr("gcn_tpu_torch.models.deepergcn.fit_gcn", keep)
    try:
        model = _fit(g, mode, 24, lr=0.3, patience=2)
    finally:
        loop_fit.undo()
    res = seen["result"]
    if mode == "early_stop":
        assert res.iters_run < 24
    assert 0 <= res.best_iter < res.iters_run - 1
    best = _fit(g, "no_val", res.best_iter + 1, lr=0.3)
    last = _fit(g, "no_val", res.iters_run, lr=0.3)
    assert _snapshot_equal(res.buffers, best.buffers)
    assert _snapshot_equal(res.final_buffers, last.buffers)
    assert _snapshot_equal(model.buffers, best.buffers)
    assert _snapshot_equal(model.params, best.params)
    assert torch.equal(model.output, best.output)
    assert not _snapshot_equal(res.buffers, res.final_buffers)


# ---- the models without buffers -------------------------------------------


class _Ops(TorchDispatchMode):
    """The names of the aten operations dispatched, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _existing_fit(kind):
    """A 4-iteration fit of one of the models that pass no buffers, at a
    small size on the CPU, with dropout where the model has it and early
    stopping at patience 1 (so that guarded state is saved and restored):
    (the aten operations of the whole fit, its losses, the sum of its
    output)."""
    rng = np.random.default_rng(7)
    if kind == "hgnn":
        labels = rng.integers(0, 4, 160)
        x = (rng.standard_normal((4, 24)) * 2)[labels] \
            + rng.standard_normal((160, 24))
        x = x.astype(np.float32)
        g = hg.generate_G_from_H(hg.construct_H_with_KNN(x, 6))
        model = HGNN(24, 4, n_hid=16, dropout=0.5, milestones=(2,),
                     adj_kind="coo", device="cpu")
        fit = dict(idx_val=np.arange(100, 160), num_epochs=4)
        args = (x, g, labels, np.arange(100))
    else:
        x = rng.standard_normal((N, F_IN)).astype(np.float32)
        labels = rng.integers(0, C, N)
        if kind == "gcn":
            model = GCN(F_IN, 16, C, variant="v4", seed=2, device="cpu")
        else:
            model = GAT(F_IN, C, heads=(2, 2, 3), hidden=(8, 8), seed=2,
                        device="cpu")
        fit = dict(idx_val=np.arange(1, N, 3), train_iters=4,
                   mode="early_stop", patience=1)
        args = (x, _graph(), labels, np.arange(0, N, 3))
    with _Ops() as ops:
        model.fit(*args, **fit)
    losses = [h["loss_train"] for h in model.history]
    return ops.names, losses, float(model.output.double().sum())


# Recorded from the same calls at the commit before fit_gcn took buffers:
# (the number of aten operations, the sha256 of their names joined by
# newlines, first 16 hex digits; the losses; the output's sum)
PARENT = {
    "gcn": (857, "df38d279263dedbf",
            [1.6833878755569458, 1.673598051071167, 1.6481460332870483,
             1.6322964429855347], -2438.787394940853),
    "hgnn": (660, "2b7102d88d1d45c8",
             [2.217717170715332, 2.0683176517486572, 2.187185049057007,
              2.022395133972168], -233.5674803261645),
    "gat": (3852, "4fc5a29095d023cf",
            [1.6459351778030396, 1.6169674396514893, 1.591869831085205],
            -2435.645674109459),
}


@pytest.mark.parametrize("kind", sorted(PARENT))
def test_models_without_buffers_run_what_they_ran_before(kind):
    names, losses, total = _existing_fit(kind)
    count, digest, want_losses, want_total = PARENT[kind]
    assert len(names) == count
    assert hashlib.sha256("\n".join(names).encode()).hexdigest()[:16] \
        == digest
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    np.testing.assert_allclose(total, want_total, rtol=1e-6)
