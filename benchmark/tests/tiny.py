"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can run: the
same configuration, job and limits, on a few hundred rows and a dozen
iterations."""

from __future__ import annotations

import copy

from benchmark import harness

CELLS = ("gcn-arxiv.v6", "hgnn-modelnet40.dense", "gcn-arxiv.v4")


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.load_cell(workload)
    cfg = copy.deepcopy(cell.config)
    params = cfg["inputs"]["params"]
    if cfg["family"] == "gcn":
        params.update(nodes=600, features=16, classes=5,
                      per_class_train=10, n_val=50, n_test=50)
        cfg["hidden_channels"] = 32
        cfg["epochs"] = 12
    else:
        params.update(objects=300, features=48, mvcnn_columns=16)
        cfg["structure_columns"] = 16
        cfg["milestones"] = [6]
        cfg["late_steps_from"] = 6
        cfg["n_hid"] = 32
        cfg["max_epoch"] = 12
    cell.config = cfg
    return cell
