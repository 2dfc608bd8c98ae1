"""The port's measurement scripts (``bench_kpad``, ``bench_gather``,
``bench_e2e_width``, ``bench_hgnn``, ``bench_freq_split``,
``bench_fp8_wire``, ``run_sweep.sh``) on the CPU: their host-side columns
equal what gcn_tpu's functions give on the same graphs (synth-small and
small hypergraphs), the fp8 script's f32 leg at dropout 0 equals gcn_tpu's
sharded step from the same parameters (losses rtol 1e-4, the sharded
parity tests'), and each script's ``main`` runs with ``--device cpu`` at a
tiny size and writes a schema-valid artifact with no device time in it."""

import json
import os
import subprocess

import jax
import numpy as np
import pytest

from gcn_tpu.data import get_dataset as jx_dataset
from gcn_tpu.graph.normalize import gcn_normalize as jx_normalize
from gcn_tpu.reorder import reorder_graph as jx_reorder
from gcn_tpu.tile import degree_sort_order as jx_degree_sort
from gcn_tpu.tile import ell_adjacency as jx_ell
from gcn_tpu.tile import ell_adjacency_freq as jx_ell_freq

from gcn_tpu_torch import (bench_e2e_width, bench_fp8_wire,
                           bench_freq_split, bench_gather, bench_hgnn,
                           bench_kpad)
from gcn_tpu_torch.utils.artifacts import validate_artifact
from torch_port_dist_graphs import REPO, subprocess_env
from torch_port_native import native_reorder  # noqa: F401 (autouse)


def _jx_prepared(name):
    """gcn_tpu's pipeline of the scripts: normalize, rabbit, degree sort."""
    g = jx_normalize(jx_dataset(name, seed=0).adj)
    g, _ = jx_reorder(g, "rabbit")
    return g.permute(jx_degree_sort(g))


def _artifact(path, schema):
    art = json.loads(path.read_text())
    assert art["_meta"]["schema"] == schema
    assert art["_meta"]["device"] == "cpu"
    assert validate_artifact(art) == []
    return art


def test_bench_kpad_host_columns_equal_gcn_tpu(tmp_path, capsys):
    out = tmp_path / "kpad.json"
    assert bench_kpad.main(["-g", "synth-small", "--ks", "8", "64",
                            "--k-pads", "32", "64", "128", "--device",
                            "cpu", "-o", str(out)]) == 0
    rows = _artifact(out, "kpad_sweep_torch_v1")["rows"]
    assert len(rows) == 6
    jg = _jx_prepared("synth-small")
    for row in rows:
        ja = jx_ell(jg, symmetric=True, span_pass_limit=0,
                    k_pad=row["k_pad"])
        assert row["slots"] == int(ja.cols.size)
        assert row["pad_fraction"] == round(ja.pad_fraction, 4)
        assert row["spans"] == len(ja.spans)
        assert row["p"] == 128 // row["k_pad"]
        assert row["ell_ms"] is None and row["sparse_mm_ms"] is None
        assert row["max_abs_err"] < 1e-6 and row["bound_ms"] > 0
    printed = [json.loads(line) for line in capsys.readouterr().out
               .splitlines() if line.startswith("{")]
    assert printed == rows


@pytest.mark.parametrize("part_order", [False, True])
def test_bench_freq_split_host_columns_equal_gcn_tpu(tmp_path, part_order):
    from gcn_tpu.tile.freq_split import freq_split_order as jx_order

    out = tmp_path / "freq.json"
    argv = ["-g", "synth-small", "--hot-rows", "256", "--device", "cpu",
            "-o", str(out)] + (["--part-order"] if part_order else [])
    assert bench_freq_split.main(argv) == 0
    art = _artifact(out, "freq_split_torch_v1")
    jg = _jx_prepared("synth-small")
    single = jx_ell(jg, symmetric=True, table_bf16=True, span_pass_limit=0)
    assert art["single"]["slots"] == int(single.cols.size)
    assert art["single"]["pad_fraction"] == round(single.pad_fraction, 4)
    if part_order:
        jg = jg.permute(jx_order(jg, hot_rows=256, table_bf16=True))
    fs = jx_ell_freq(jg, hot_rows=256, table_bf16=True, span_pass_limit=0)
    split = art["freq_split"]
    assert split["hot_rows"] == fs.hot_rows == 256
    assert split["hot_edge_fraction"] == round(fs.hot_edge_fraction, 4)
    assert split["hot_slots"] == int(fs.hot.cols.size)
    assert split["cold_slots"] == int(fs.cold.cols.size)
    assert split["max_abs_err_vs_single"] < 1e-6
    assert split["ms"] is None and "speedup" not in art


def test_bench_freq_split_order_sweep(tmp_path):
    out = tmp_path / "sweep.json"
    assert bench_freq_split.main(["-g", "synth-small", "--hot-rows", "256",
                                  "--order-sweep", "--device", "cpu", "-o",
                                  str(out)]) == 0
    art = _artifact(out, "freq_split_order_torch_v1")
    jg = _jx_prepared("synth-small")
    shipped = jx_ell_freq(jg, hot_rows=256, table_bf16=True,
                          span_pass_limit=0)
    first = art["rows"][0]
    assert first["order"].startswith("shipped")
    assert first["hot_slots"] == int(shipped.hot.cols.size)
    assert first["cold_slots"] == int(shipped.cold.cols.size)
    assert len(art["rows"]) == 5 and all(r["ms"] is None
                                         for r in art["rows"])


def test_bench_hgnn_nnz_equal_gcn_tpu(tmp_path):
    from gcn_tpu.graph.hypergraph import (construct_H_with_KNN,
                                          generate_G_factors,
                                          generate_G_from_H)

    out = tmp_path / "hgnn.json"
    argv = ["--n", "300", "--f", "96", "--nhid", "16", "--classes", "4",
            "--device", "cpu", "-o", str(out)]
    assert bench_hgnn.main(argv) == 0
    paths = _artifact(out, "hgnn_bench_torch_v1")["paths"]
    fts = bench_hgnn.hypergraph(300, 96, 4, 10)[0]
    h = construct_H_with_KNN(fts[:, :64], k_neig=10, is_prob=True,
                             m_prob=1.0)
    a1, a2 = generate_G_factors(h)
    assert paths["dense"]["nnz"] == generate_G_from_H(h).nnz
    assert paths["factored"]["nnz"] == a1.nnz + a2.nnz
    for row in paths.values():
        assert row["epoch_ms"] is None and row["spmm_ms"] is None


def test_bench_fp8_wire_f32_leg_equals_gcn_tpu():
    """The f32 leg's losses at dropout 0 from gcn_tpu's initial parameters
    against gcn_tpu's sharded step on its 4-device mesh, same pipeline."""
    from gcn_tpu.models.gcn_core import init_gcn_params as jx_init
    from gcn_tpu.parallel import create_mesh as jx_mesh
    from gcn_tpu.parallel import make_sharded_gcn_train_step as jx_step
    from gcn_tpu.parallel import partition as jx_part
    from gcn_tpu.train.optim import adam_l2 as jx_adam

    from gcn_tpu_torch.parallel import create_mesh

    graph, ns, steps = "synth-small", 4, 3
    data = jx_dataset(graph, seed=15)
    p0 = jax.tree_util.tree_map(np.asarray, jx_init(
        jax.random.PRNGKey(15), data.num_features, 8, data.num_classes))
    row, losses = bench_fp8_wire.run_one(
        create_mesh(ns, "cpu"), graph, 8, steps, 15, None, "halo",
        dropout=0.0, params0=p0)
    assert row["finite"] and 0.0 <= row["acc_test"] <= 1.0

    g = jx_normalize(data.adj)
    x, labels = data.features.astype(np.float32), data.labels
    mask = np.zeros(data.num_nodes, np.float32)
    mask[np.asarray(data.idx_train)] = 1.0
    g, perm = jx_reorder(g, "rabbit")
    x, labels, mask = x[perm], labels[perm], mask[perm]
    bperm = jx_part.band_degree_sort_order(
        g, jx_part.rows_per_shard_for(data.num_nodes, ns))
    g, x, labels, mask = g.permute(bperm), x[bperm], labels[bperm], \
        mask[bperm]
    sg = jx_part.shard_graph_by_rows(g, ns)
    tx = jx_adam(0.01, 5e-4)
    step, _, shard_fn = jx_step(jx_mesh(ns), sg, tx, dropout=0.0,
                                exchange="halo")
    adj, xs, ys, ms = shard_fn(sg, jx_part.pad_rows(x, sg),
                               jx_part.pad_rows(labels, sg),
                               jx_part.pad_rows(mask, sg))
    params, opt_state, want = p0, tx.init(p0), []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state,
                                       jax.random.PRNGKey(7), adj, xs, ys,
                                       ms)
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_bench_fp8_wire_main_writes_its_artifact(tmp_path):
    out = tmp_path / "wire.json"
    assert bench_fp8_wire.main(["--legs", "synth-tiny:halo:8:2",
                                "synth-tiny:halo_hier:8:2", "--shards", "4",
                                "--seeds", "15", "--device", "cpu", "-o",
                                str(out)]) == 0
    art = _artifact(out, "fp8_wire_eval_torch_v1")
    assert [r["wire"] for r in art["runs"]] == ["f32", "bf16", "fp8"] * 2
    assert set(art["summary"]) == {"synth-tiny/halo", "synth-tiny/halo_hier"}
    assert all(r["finite"] for r in art["runs"])


def test_bench_gather_and_e2e_width_mains(tmp_path):
    out = tmp_path / "gather.json"
    assert bench_gather.main(["--sizes", "500", "2000", "--ks", "8",
                              "--device", "cpu", "-o", str(out)]) == 0
    art = _artifact(out, "gather_microbench_torch_v1")
    assert [r["n"] for r in art["rows"]] == [500, 2000]
    assert art["rows"][0]["f32_ns_per_row"] is None
    assert art["stream_gb_per_s"] is None and art["event_floor_ms"] is None
    out = tmp_path / "e2e.json"
    assert bench_e2e_width.main(["-g", "synth-tiny", "-i", "3",
                                 "--variants", "v6", "--hiddens", "8",
                                 "--device", "cpu", "-o", str(out)]) == 0
    (row,) = _artifact(out, "e2e_width_torch_v1")["rows"]
    assert row["k_pad"] == 32 and row["adjacency"] == "EllAdj"
    assert 0.0 <= row["acc_test"] <= 1.0 and row["step_ms_captured"] is None


def test_run_sweep_writes_its_artifact(tmp_path):
    out = tmp_path / "sweep.json"
    env = dict(subprocess_env(), DEVICE="cpu", GRAPHS="synth-tiny",
               ITERS="3", REAL="", OUT=str(out), OMP_NUM_THREADS="2")
    proc = subprocess.run(["bash", os.path.join(REPO, "gcn_tpu_torch",
                                                "run_sweep.sh")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (run,) = _artifact(out, "run_sweep_torch_v1")["runs"]
    assert run["graph"] == "synth-tiny" and run["exit"] == 0
    assert 0.0 <= run["acc_test"] <= 1.0


def test_csr_to_torch_is_the_matrix():
    """``CSRGraph.to_torch``, the operand the scripts hand to
    ``torch.sparse.mm``, holds the same matrix."""
    from gcn_tpu_torch.data import get_dataset

    g = get_dataset("synth-tiny", seed=0).adj
    np.testing.assert_array_equal(g.to_torch("cpu").to_dense().numpy(),
                                  g.to_dense())
