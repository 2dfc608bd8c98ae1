"""``gcn_tpu_torch/bench.py``, the port's one-line SpMM benchmark, on the CPU:
its line has ``bench.py``'s keys plus only the port's additions, its host
columns equal what gcn_tpu's own functions give on the same graph, its
roofline arithmetic holds, and a failing step or an impossible roofline
makes it raise. ``chain_timing.train_step_fit`` in ``bench.py``'s generic
form (raw features, orders ("a_xw", "ax_w")) gives the losses of
``bench.py::bench_train_step``'s step function over 5 steps at rtol 1e-4
(f32 sums in another order, compounded over Adam steps). No time is
measured here: the CPU gives none."""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gcn_tpu.data import get_dataset as jx_get_dataset
from gcn_tpu.graph.normalize import gcn_normalize as jx_normalize
from gcn_tpu.models.gcn_core import gcn_forward as jx_gcn_forward
from gcn_tpu.models.gcn_core import init_gcn_params as jx_init
from gcn_tpu.ops.adjacency import coo_adjacency as jx_coo
from gcn_tpu.reorder import reorder_graph as jx_reorder
from gcn_tpu.tile import degree_sort_order as jx_degree_sort
from gcn_tpu.tile import ell_adjacency as jx_ell
from gcn_tpu.train.metrics import masked_nll as jx_masked_nll
from gcn_tpu.train.optim import adam_l2 as jx_adam

from gcn_tpu_torch import bench
from gcn_tpu_torch.convert import params_from_numpy
from gcn_tpu_torch.utils import chain_timing as ct
from torch_port_native import native_reorder  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = "synth-cora-hard"
ADDITIONS = {"sparse_mm_ms", "gather_ns_per_row", "event_floor_ms",
             "train_step_eager_ms", "train_step_hoisted_eager_ms", "card"}


def _bench_py_keys():
    """(top-level keys, detail keys) of the line ``bench.py`` prints, read
    from its source."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [getattr(k, "value", None) for k in node.keys]
            if "metric" in keys:
                detail = node.values[keys.index("detail")]
                return set(keys), {k.value for k in detail.keys}
    raise AssertionError("bench.py prints no line with a metric")


@pytest.fixture(scope="module")
def cpu_line():
    """The benchmark's line for GRAPH at k = 16 on the CPU."""
    data, g, perm = bench.prepared_graph(GRAPH)
    return bench.measure(data, g, perm, 16, "cpu", GRAPH)


def _jx_graph(name=GRAPH):
    """gcn_tpu's pipeline of bench.py: normalize, rabbit, degree sort."""
    jg, _ = jx_reorder(jx_normalize(jx_get_dataset(name, seed=0).adj),
                       "rabbit")
    return jg.permute(jx_degree_sort(jg))


def test_line_has_bench_py_keys_and_only_the_additions(capsys):
    top, detail = _bench_py_keys()
    assert bench.main(["--dataset", "synth-tiny", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == top
    assert set(line["detail"]) == detail | ADDITIONS
    assert line["metric"] == "torch_spmm_edges_per_s_tiny_k32"
    assert bench.metric_name("synth-arxiv", 32) == \
        "torch_spmm_edges_per_s_arxiv_k32"
    assert line["unit"] == "edges/s"


def test_times_are_null_on_the_cpu(cpu_line):
    d = cpu_line["detail"]
    assert cpu_line["value"] is None and cpu_line["vs_baseline"] is None
    for key in ("ell_ms", "ell_ms_train_default", "coo_baseline_ms",
                "roofline_pct", "train_step_ms", "train_step_hoisted_ms",
                "sparse_mm_ms", "gather_ns_per_row", "event_floor_ms",
                "train_step_eager_ms", "train_step_hoisted_eager_ms"):
        assert d[key] is None, key
    assert d["card"]["device"] == "cpu"


def test_host_columns_equal_gcn_tpu(cpu_line):
    jg = _jx_graph()
    serving = jx_ell(jg, symmetric=True, span_pass_limit=0)
    d = cpu_line["detail"]
    assert (d["n"], d["nnz"], d["k"]) == (jg.shape[0], jx_coo(
        jg, symmetric=True).nnz, 16)
    assert d["slots"] == int(serving.cols.size)
    assert d["pad_fraction"] == serving.pad_fraction


def test_layouts_are_the_ones_measured(cpu_line):
    """``bench.layouts`` (which chip_smoke.py checks K1 on) gives the
    serving layout with no hub rows and gcn_tpu's slots, and the training
    layout with the default hub cap; measuring on them gives the line
    ``measure`` gives when it builds its own."""
    data, g, perm = bench.prepared_graph(GRAPH)
    serving, train = bench.layouts(g, "cpu")
    jg = _jx_graph()
    assert serving.n_hub == 0
    assert int(serving.cols.numel()) == int(jx_ell(
        jg, symmetric=True, span_pass_limit=0).cols.size)
    assert train.span_pass_limit == jx_ell(jg, symmetric=True).span_pass_limit
    assert int(train.cols.numel()) == int(jx_ell(jg, symmetric=True).cols.size)
    line = bench.measure(data, g, perm, 16, "cpu", GRAPH,
                         adjs=(serving, train))
    assert line == cpu_line


def test_roofline_is_slots_times_ns_per_slot(cpu_line):
    d = cpu_line["detail"]
    assert d["roofline_ms"] > 0
    assert d["roofline_ns_per_slot"] * d["slots"] * 1e-6 == pytest.approx(
        d["roofline_ms"], rel=1e-12)
    n, e, k = d["n"], d["nnz"], d["k"]
    # the serving layout has no hub rows: one offset a window of R, + 1
    serving = jx_ell(_jx_graph(), symmetric=True, span_pass_limit=0)
    n_win_off = -(-serving.n_rows // serving.r) + 1
    assert d["roofline_ms"] == pytest.approx(
        (e * 8 + n_win_off * 4 + 2 * n * k * 4) / ct.HBM_BYTES_PER_S * 1e3,
        rel=1e-12)


def test_times_feed_value_ratio_and_roofline(monkeypatch):
    """With every SpMM timed at ``ms`` ms the line's arithmetic is
    bench.py's: stored edges over K1's seconds, the COO time over K1's."""
    ms = 0.5
    monkeypatch.setattr(ct, "on_device_ms", lambda *a, **kw: ms)
    data, g, perm = bench.prepared_graph("synth-tiny")
    line = bench.measure(data, g, perm, 32, "cpu", "synth-tiny")
    d = line["detail"]
    assert line["value"] == pytest.approx(g.nnz / (ms * 1e-3))
    assert line["vs_baseline"] == 1.0
    assert d["roofline_pct"] == pytest.approx(100 * d["roofline_ms"] / ms)


def test_roofline_above_100_raises(monkeypatch):
    monkeypatch.setattr(ct, "on_device_ms", lambda *a, **kw: 1e-9)
    data, g, perm = bench.prepared_graph("synth-tiny")
    with pytest.raises(RuntimeError, match="of its bound"):
        bench.measure(data, g, perm, 32, "cpu", "synth-tiny")


def test_failing_train_step_raises(monkeypatch):
    def fail(*args, **kw):
        raise RuntimeError("the step failed")

    monkeypatch.setattr(ct, "train_step_fit", fail)
    with pytest.raises(RuntimeError, match="the step failed"):
        bench.main(["--dataset", "synth-tiny", "--device", "cpu"])


def test_default_device_is_the_card():
    """Without a card the benchmark refuses instead of timing the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--dataset", "synth-tiny"])


def _jx_bench_losses(adj, feats, labels, idx, params, steps):
    """bench.py::bench_train_step's step function (dropout 0, Adam with L2
    5e-4, scanned), returning each step's loss instead of their sum."""
    orders = ("a_xw", "ax_w")
    tx = jx_adam(0.01, 5e-4)

    def step(carry, _):
        p, o = carry

        def loss_fn(pp):
            lp = jx_gcn_forward(pp, feats, adj, orders=orders,
                                dropout_rate=0.0, train=False)
            return jx_masked_nll(lp, labels, idx)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = tx.update(grads, o, p)
        return (optax.apply_updates(p, updates), o), loss

    @jax.jit
    def run(p, o):
        return jax.lax.scan(step, (p, o), None, length=steps)[1]

    return np.asarray(run(params, tx.init(params)))


def test_generic_train_step_losses_equal_bench_py():
    steps, nhid = 5, bench.NHID
    data, g, perm = bench.prepared_graph(GRAPH)
    jg = _jx_graph()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(g.shape[0])
    feats = data.features[perm]
    labels = data.labels[perm]
    idx = inv[np.asarray(data.idx_train)]
    params = jax.tree_util.tree_map(np.asarray, jx_init(
        jax.random.PRNGKey(0), data.num_features, nhid, data.num_classes))
    want = _jx_bench_losses(jx_ell(jg, symmetric=True), jnp.asarray(feats),
                            jnp.asarray(labels),
                            jnp.asarray(idx, dtype=jnp.int32), params, steps)

    import torch

    from gcn_tpu_torch.tile.ell import ell_adjacency

    adj = ell_adjacency(g, symmetric=True, device="cpu")
    res = ct.train_step_fit(
        adj, torch.as_tensor(feats), torch.as_tensor(labels),
        torch.as_tensor(idx), nhid, data.num_classes, steps=steps,
        orders=("a_xw", "ax_w"), params=params_from_numpy(params, "cpu"))
    got = [h["loss_train"] for h in res.history]
    assert len(got) == steps
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
