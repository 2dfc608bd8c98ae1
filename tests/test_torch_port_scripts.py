"""The port's host scripts on the CPU: ``bench_scaling`` (its three
projection modes print the rows of the port's projection functions, and its
live mode runs the sharded step), ``ablate_reorder`` and ``row_analysis``,
whose host-side output equals gcn_tpu's scripts' (``examples/``) on
synth-tiny, and the card's measurement scripts where the CPU can reach
them: ``time_sharded``'s arithmetic of the scales and ``time_links``'s
exchanges over gloo."""

import json
import os
import subprocess
import sys

import pytest

from gcn_tpu_torch import ablate_reorder, bench_scaling, row_analysis
from gcn_tpu_torch.parallel import projection as pt
from torch_port_dist_graphs import REPO, subprocess_env
from torch_port_native import native_reorder  # noqa: F401 (autouse)
from torch_port_native import pinned_command


def _rows(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_bench_scaling_project_rows_equal_the_projection(capsys):
    argv = ["--project", "--devices", "4", "16", "--nodes-per-device",
            "256", "--chips-per-host", "4"]
    assert bench_scaling.main(argv) == 0
    want = pt.project_weak_scaling([4, 16], nodes_per_device=256,
                                   chips_per_host=4, bytes_per_elt=4)
    assert _rows(capsys.readouterr().out) == json.loads(json.dumps(
        [r.to_json() for r in want]))


def test_bench_scaling_fullstep_rows_equal_the_projection(capsys, tmp_path):
    out = tmp_path / "fullstep.json"
    argv = ["--fullstep", "--devices", "4", "12", "--nodes-per-device", "256",
            "--chips-per-host", "4", "--workload", "sbm", "--halo-wire",
            "bf16", "--out", str(out)]
    assert bench_scaling.main(argv) == 0
    rows, meta = pt.project_weak_scaling_fullstep(
        [4, 12], nodes_per_device=256, chips_per_host=4, workload="sbm",
        bytes_per_elt=2, exchange_chunk=32)
    want = json.loads(json.dumps([r.to_json() for r in rows]))
    assert _rows(capsys.readouterr().out) == want
    written = json.loads(out.read_text())
    assert written["rows"] == want
    assert written["_meta"]["schema"] == "scaling_projection_fullstep_v1"
    assert written["assumptions"]["spmm_rate_source"] == \
        meta["spmm_rate_source"]
    assert written["assumptions"]["spmm_rate_source"].startswith(
        pt.CAPTURE_NAME)


def test_bench_scaling_lockstep_floor_rows(capsys):
    from gcn_tpu_torch.data.synthetic import powerlaw_sbm
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.parallel.halo import _pair_boundaries
    from gcn_tpu_torch.parallel.partition import (band_degree_sort_order,
                                                  shard_graph_by_rows)
    from gcn_tpu_torch.reorder import reorder_graph

    argv = ["--lockstep-floor", "--devices", "4", "12",
            "--nodes-per-device", "128", "--chips-per-host", "4"]
    assert bench_scaling.main(argv) == 0
    out = capsys.readouterr().out
    assert "d=4: single host" in out
    (row,) = _rows(out)
    adj, _ = powerlaw_sbm(n=128 * 12, n_classes=12, avg_degree=14.0, seed=0)
    g, _ = reorder_graph(gcn_normalize(adj), "rabbit")
    g = g.permute(band_degree_sort_order(
        g, shard_graph_by_rows(g, 12).rows_per_shard))
    want = pt.lockstep_vs_matched_dcn(
        _pair_boundaries(shard_graph_by_rows(g, 12))[0], 12, 3, 4)
    assert {k: row[k] for k in want} == want
    assert row["devices"] == 12 and row["hosts"] == 3


@pytest.mark.parametrize("kernel", ["segsum", "ell"])
def test_bench_scaling_live_on_the_cpu(capsys, kernel):
    argv = ["--devices", "1", "2", "--nodes-per-device", "128", "--steps",
            "2", "--kernel", kernel, "--device", "cpu"]
    assert bench_scaling.main(argv) == 0
    rows = _rows(capsys.readouterr().out)
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    assert all(r["step_ms"] > 0 and r["kernel"] == kernel for r in rows)
    assert rows[1]["flat_exchange_rows"] > 0


def _gcn_tpu_script(name, args):
    """gcn_tpu's ``examples/name`` in a subprocess, its reorder library
    loaded from this process's private build (``torch_port_native``)."""
    env = dict(subprocess_env(), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        pinned_command(os.path.join(REPO, "examples", name), args),
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_ablate_reorder_host_columns_equal_gcn_tpu(capsys):
    args = ["-g", "synth-tiny", "--shards", "4", "--methods", "identity",
            "rcm", "rabbit"]
    want = _rows(_gcn_tpu_script("ablate_reorder.py", args))
    assert ablate_reorder.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = _rows(out)
    assert [r["method"] for r in got] == [r["method"] for r in want]
    for g, w in zip(got, want):
        assert g.pop("spmm_ms") > 0
        w.pop("spmm_ms")
        assert g == w
    assert "device=cpu" in out and "best fill" in out


def test_row_analysis_equals_gcn_tpu(capsys, tmp_path):
    want = _gcn_tpu_script("row_analysis.py", [
        "-g", "synth-tiny", "synth-small", "--normalized", "-o",
        str(tmp_path / "jax.svg")])
    assert row_analysis.main(["-g", "synth-tiny", "synth-small",
                              "--normalized", "-o",
                              str(tmp_path / "port.svg")]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[:-1] == want.splitlines()[:-1]
    assert (tmp_path / "port.svg").stat().st_size > 0


def test_time_sharded_tier_reckons_the_scales(monkeypatch):
    """The capture's scales from ``sharded_tier``: with every K1 call timed
    at 1 ms, the pass-block layout (two parts a band) costs the plain rate
    over edges / (2 x bands) ms, the monolithic one over edges / bands."""
    import torch

    from gcn_tpu_torch import time_sharded
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.reorder import reorder_graph

    monkeypatch.setattr(time_sharded, "device_ms", lambda fn, reps: 1.0)
    g, _ = reorder_graph(gcn_normalize(get_dataset("synth-tiny").adj),
                         "rabbit")
    tier = time_sharded.sharded_tier(g, 4, 32, 1e6, torch.device("cpu"), 1)
    edges = sum(tier["edges"])
    assert edges == g.nnz and len(tier["edges"]) == 4
    assert tier["production_parts"]["blocks_over_plain"] == \
        pytest.approx(1e6 / (edges / 8e-3))
    assert tier["sharded_over_plain"] == pytest.approx(1e6 / (edges / 4e-3))
    assert tier["blocks_t_over_plain"] == \
        tier["production_parts"]["blocks_over_plain"]


def test_time_links_runs_over_two_gloo_processes(tmp_path):
    """The link timer's exchanges over two gloo processes on the CPU (host
    clock; a rehearsal, not a measurement): a row a plan and width, and no
    capture written off the card."""
    from torch_port_dist_graphs import free_port

    out = tmp_path / "capture.json"
    port = str(free_port())
    procs = []
    for rank in (0, 1):
        env = dict(subprocess_env(), RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gcn_tpu_torch.time_links", "-g",
             "synth-tiny", "--device", "cpu", "--reps", "2", "-o",
             str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            stdout, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a link-timer process timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(stdout)
    rows = _rows(outs[0])
    assert [(r["plan"], r["width"]) for r in rows] == [
        ("ragged", 32), ("ragged", 128), ("padded", 32), ("padded", 128)]
    assert all(r["bytes"] == r["rows_sent"] * r["width"] * 4 > 0
               for r in rows)
    assert outs[1] == "" and not out.exists()
