"""The comparison that decides ``correct`` fails what it must: each fault
planted under the timed path (``faults.py``), and the control (the
reference in TF32 put in the program's place), read against the cell's
own limits at a tiny size on the CPU; the sound program passes them."""

import pytest
import torch

from benchmark import faults, harness, run
from benchmark.tests.tiny import CELLS, tiny_cell

SEED = 2 ** 31 + 5


def _run(cell):
    rec = harness.run_cell(cell, SEED, 0.0, False, device="cpu")
    return run.result_line(cell, rec, False)


PLANTED = [(w, f) for w in CELLS
           for f in sorted(faults.for_family(tiny_cell(w).config["family"]))]


@pytest.mark.parametrize("workload,fault", PLANTED)
def test_fault_turns_correct_false(workload, fault):
    cell = tiny_cell(workload)
    family = cell.config["family"]
    with faults.for_family(family)[fault](family):
        line = _run(cell)
    assert line["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    cell = tiny_cell(workload)
    cfg = cell.config
    data = harness.make_inputs(cfg)
    dev = torch.device("cpu")
    prog = harness.program_class(cfg)(cfg, cell.job, data, dev,
                                      harness.Spans())
    p_probe = harness.init_params(prog.layers, 3, dev)
    sides = {}
    for precision in ("float64", "tf32"):
        problem = harness.reference_class(cfg)(cfg, data, dev, precision)
        sides[precision] = harness.reference_side_for(
            problem, SEED, 1, p_probe, prog.perm, prog.layers,
            cfg.get("late_steps_from"))
    readings = harness.compare(sides["tf32"], sides["float64"])
    assert any(readings[k] > cell.limits[k]
               for k in harness.compared_names(cfg))
