"""The port's GAT (``models/gat.py``, ``ops/gat_attn.py``) on the CPU
against the plain dense reference of ``torch_port_gat_reference.py``, on
seeded random weights at a small size: heads (2, 2, 3), widths (8, 8, C),
the skip across the middle layer.

The graph has a hub whose row holds more than ``LONG_ROW`` edges, an
isolated last vertex (only its self loop, beside ``CooAdj``'s padding),
and a number of edges that is not a multiple of ``EDGE_PAD``.

Tolerances: in float64 the port and the reference differ only in the
order of their sums (segment sums against dense softmax and einsum), so
values and gradients agree to rtol 1e-10. The fit runs in float32, as
``GAT.fit`` does: losses at rtol 1e-5 (sums of a few hundred float32
terms, reassociated), and each leaf's change over its 3 Adam steps within
1e-3 of the reference's change in norm (Adam divides by the gradient's
own size, so an element whose gradient is at rounding level can move by a
sizeable share of lr on either side; the norm of the change is not).
"""

import numpy as np
import pytest
import torch

import torch_port_gat_reference as ref
from gcn_tpu_torch.graph.csr import CSRGraph, coo_to_csr
from gcn_tpu_torch.models.gat import GAT, gat_forward, gat_layers
from gcn_tpu_torch.ops import gat_attn
from gcn_tpu_torch.ops.adjacency import EDGE_PAD, LONG_ROW, device_adjacency
from gcn_tpu_torch.ops.gat_attn import gat_attention, gat_layout
from gcn_tpu_torch.reorder import compute_permutation
from gcn_tpu_torch.utils.timers import counters

N, F_IN, C = 300, 12, 5
HEADS, HIDDEN, RESIDUAL = (2, 2, 3), (8, 8), (False, True, False)


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
    adj = device_adjacency(with_loops, "coo", device="cpu")
    mask = torch.as_tensor(with_loops.to_dense() != 0)
    return g, adj, gat_layout(adj), mask


def test_layout_keeps_padding_out_of_every_row(graph):
    _, adj, lay, mask = graph
    assert lay.nnz == int(mask.sum()) and lay.nnz % EDGE_PAD != 0
    # CooAdj counts its padding in the last row; the layout does not
    assert int(adj.row_len[-1]) == 1 + adj.rows.numel() - adj.nnz
    t_row_len = torch.diff(lay.t_row_ptr)
    assert int(lay.row_len[-1]) == int(t_row_len[-1]) == 1
    assert int(lay.row_ptr[-1]) == int(lay.t_row_ptr[-1]) == lay.nnz
    assert lay.rows.numel() == lay.cols.numel() == lay.nnz
    assert torch.equal(lay.row_len, mask.sum(1))
    assert torch.equal(t_row_len, mask.sum(0))
    # the hub's row is long in both directions, and walked first
    assert lay.long_rows == lay.t_long_rows == 1
    assert int(lay.row_len[0]) == 281 > LONG_ROW
    assert int(lay.row_order[0]) == int(lay.t_row_order[0]) == 0


def _order_graph(kind, seed=0):
    """Vertex 0 a hub of 280 neighbours, vertex 1 one of 100 (past
    ``HEAD_ROW``, short of ``LONG_ROW``), random edges among 2..298, with
    self loops; "symmetric" or "directed" (the edges one way only: the
    hubs' columns hold few entries)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(280, np.int64), np.ones(100, np.int64),
                          rng.integers(2, N - 1, 600)])
    dst = np.concatenate([np.arange(1, 281), np.arange(150, 250),
                          rng.integers(2, N - 1, 600)])
    g = coo_to_csr(src, dst, None, (N, N))
    return (g.symmetrize() if kind == "symmetric" else g).with_self_loops()


def _runs_longest_first(rows, row_len, run):
    return np.concatenate([
        rows[i:i + run][np.argsort(-row_len[rows[i:i + run]],
                                   kind="stable")]
        for i in range(0, rows.size, run)])


@pytest.mark.parametrize("run_rows", [gat_attn.RUN_ROWS, 50])
@pytest.mark.parametrize("direction", ["forward", "transpose"])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_walk_order_is_long_rows_then_rabbit_order(monkeypatch, kind,
                                                   direction, run_rows):
    """Each walk order holds every row once: first the rows past
    ``HEAD_ROW``, longest first, those past ``LONG_ROW`` leading, then
    the rest in the rabbit order of the pattern (made symmetric for it
    when it is not), each run of ``RUN_ROWS`` longest first; one count of
    ``gat_layout_local_order`` a layout. The runs are also cut shorter
    than the graph, so that there are several."""
    monkeypatch.setattr(gat_attn, "RUN_ROWS", run_rows)
    g = _order_graph(kind)
    before = counters["gat_layout_local_order"]
    lay = gat_layout(device_adjacency(g, "coo", device="cpu"))
    assert counters["gat_layout_local_order"] == before + 1
    pattern = CSRGraph(g.indptr, g.indices, np.ones(g.nnz, np.float32),
                       g.shape)
    perm = compute_permutation(
        pattern if kind == "symmetric" else pattern.symmetrize(), "rabbit")
    if direction == "forward":
        order, n_long = lay.row_order.numpy(), lay.long_rows
        row_len = g.row_degrees()
    else:
        order, n_long = lay.t_row_order.numpy(), lay.t_long_rows
        row_len = g.col_degrees()
    assert np.array_equal(np.sort(order), np.arange(N))
    head = np.flatnonzero(row_len > gat_attn.HEAD_ROW)
    wide = direction == "forward" or kind == "symmetric"
    assert list(head) == ([0, 1] if wide else [])
    assert n_long == int((row_len > LONG_ROW).sum()) == int(wide)
    assert np.array_equal(order[:head.size],
                          head[np.argsort(-row_len[head], kind="stable")])
    rest = perm[row_len[perm] <= gat_attn.HEAD_ROW]
    assert np.array_equal(order[head.size:],
                          _runs_longest_first(rest, row_len, run_rows))


def test_transpose_map_points_at_each_edges_forward_position(graph):
    _, _, lay, _ = graph
    e = lay.t_edge
    assert torch.equal(torch.sort(e).values, torch.arange(lay.nnz))
    assert torch.equal(lay.rows[e], lay.t_cols)
    src = lay.cols[e]
    assert torch.equal(src, torch.repeat_interleave(
        torch.arange(N), torch.diff(lay.t_row_ptr)))
    # within a source, destinations in row order
    for j in (0, 7, N - 1):
        run = lay.t_cols[int(lay.t_row_ptr[j]):int(lay.t_row_ptr[j + 1])]
        assert torch.equal(run, torch.sort(run).values)


def _inputs(seed, heads, width, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    wh = torch.randn((N, heads, width), generator=gen, dtype=dtype)
    el = torch.randn((N, heads), generator=gen, dtype=dtype)
    er = torch.randn((N, heads), generator=gen, dtype=dtype)
    return [t.requires_grad_(True) for t in (wh, el, er)]


@pytest.mark.parametrize("heads,width", [(2, 8), (3, 5), (4, 16)])
@pytest.mark.parametrize("slope", [0.2, 0.0])
def test_attention_and_its_gradients_match_reference(graph, heads, width,
                                                     slope):
    _, _, lay, mask = graph
    wh, el, er = _inputs(heads * 10 + width, heads, width)
    got = gat_attention(lay, wh, el, er, slope)
    want = ref.dense_attention(mask, wh, el, er, slope)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
    dout = torch.randn_like(want)
    g_got = torch.autograd.grad(got, (wh, el, er), dout)
    g_want = torch.autograd.grad(want, (wh, el, er), dout)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_last_row_sees_only_its_self_loop(graph):
    """The isolated last vertex attends to itself alone: its output is its
    own row, whatever the scores (the padding's column 0 is the hub)."""
    _, _, lay, _ = graph
    wh, el, er = _inputs(5, 2, 8)
    with torch.no_grad():
        el[0] += 50.0      # a phantom edge to the hub would take the row
        out = gat_attention(lay, wh, el, er)
    torch.testing.assert_close(out[-1], wh[-1], rtol=1e-12, atol=0)


def _params(seed, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    return {name: {"w": torch.randn((i, o), generator=gen, dtype=dtype)
                   / i ** 0.5,
                   "b": 0.1 * torch.randn(o, generator=gen, dtype=dtype)}
            for name, i, o in gat_layers(F_IN, C, HEADS, HIDDEN, RESIDUAL)}


def _data(seed=1, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((N, F_IN)), dtype=dtype)
    labels = torch.as_tensor(rng.integers(0, C, N))
    return x, labels, torch.arange(0, N, 3)


def test_layers_are_listed_in_the_optimizers_order():
    names = [name for name, _, _ in gat_layers(128, 40, (4, 4, 6),
                                               (256, 256),
                                               (False, True, False))]
    assert names == ["gat1", "att1", "gat2", "att2", "res2", "att3", "gat3"]
    assert gat_layers(128, 40, (4, 4, 6), (256, 256),
                      (False, True, False))[-1] == ("gat3", 1024, 240)


def test_forward_loss_and_every_gradient_match_reference(graph):
    _, _, lay, mask = graph
    x, labels, idx = _data()
    params = _params(3)
    leaves = [t.requires_grad_(True) for layer in params.values()
              for t in layer.values()]
    lp = gat_forward(params, x, lay, heads=HEADS, residual=RESIDUAL)
    want = ref.logits(params, x, mask, HEADS, RESIDUAL)
    torch.testing.assert_close(lp, want, rtol=1e-10, atol=1e-12)
    loss = -lp[idx, labels[idx]].mean()
    ref_loss = ref.loss(params, x, mask, labels, idx, HEADS, RESIDUAL)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-12, atol=0)
    got = torch.autograd.grad(loss, leaves)
    wanted = torch.autograd.grad(ref_loss, leaves)
    assert len(got) == 14
    for a, b in zip(got, wanted):
        assert b.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("jit_loop", [True, False])
def test_three_step_fit_matches_reference(graph, jit_loop):
    g, _, _, mask = graph
    x, labels, idx = _data(dtype=torch.float32)
    model = GAT(F_IN, C, heads=HEADS, hidden=HIDDEN, residual=RESIDUAL,
                seed=4, device="cpu")
    p0 = model.init_params()
    before = {k: v for k, v in counters.items() if k.startswith("gat_attn")}
    model.fit(x.numpy(), g, labels.numpy(), idx.numpy(), train_iters=3,
              mode="no_val", jit_loop=jit_loop)
    launches = {k: v - before.get(k, 0) for k, v in counters.items()
                if k.startswith("gat_attn_h")}
    assert not any(launches.values())      # no kernel on the CPU
    losses, want = ref.adam_fit(p0, x, mask, labels, idx, HEADS, RESIDUAL,
                                steps=3, lr=model.lr)
    np.testing.assert_allclose([h["loss_train"] for h in model.history],
                               losses, rtol=1e-5)
    for name, layer in model.params.items():
        for k, t in layer.items():
            moved = want[name][k].detach() - p0[name][k]
            gap = (t - want[name][k].detach()).norm() / moved.norm()
            assert gap < 1e-3, (name, k, float(gap))
