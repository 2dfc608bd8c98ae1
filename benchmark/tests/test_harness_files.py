"""BENCHMARK.json, and the files it names, as the benchmark's contract
reads them; every configuration and job loads and names its source."""

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_run_length():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # the full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)


def test_names_units_and_lines():
    named = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"])


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.limits is not None
        assert set(cell.limits) == set(harness.compared_names(cell.config))
        assert cell.end_to_end and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(harness._module("metrics", m["name"]), "read")
        harness.program_class(cell.config)
        harness.reference_class(cell.config)


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_configuration_loads_and_names_its_source(entry):
    path = os.path.join(harness.ROOT, entry["file"])
    assert entry["file"].startswith("benchmark/")
    cfg = json.load(open(path))
    assert cfg["source"] == entry["source"]
    assert cfg["source"].startswith("https://")
    assert set(entry["reduced"]) == set(cfg["reduced"])
    for key in cfg["reduced"]:
        assert key in cfg and key in cfg["why_reduced"]
    assert cfg["assumed"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("traffic",
                         sorted({w["traffic"] for w in BENCH["workloads"]}))
def test_job_loads(traffic):
    job = json.load(open(os.path.join(harness.HERE, "jobs",
                                      f"{traffic}.json")))
    assert {"family", "fit_length_key", "mode", "what"} <= set(job)


def test_metrics_layers_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"setup_s"} < e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells
