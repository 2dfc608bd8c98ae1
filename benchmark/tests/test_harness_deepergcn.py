"""The DeeperGCN cell (``deepergcn-arxiv.resplus``) at a tiny size on the
CPU: a whole run through ``harness.run_cell`` prints the contract's line
and holds neither JAX nor the JAX package, each fault of
``deepergcn_faults.py`` and the control (the reference in TF32 put in the
program's place) fail the cell's own limits, and ``deepergcn_work.py``'s
counts equal values worked out by hand."""

import copy
import json

import pytest
import torch

from benchmark import deepergcn_faults, deepergcn_work, harness, run, work
from benchmark.tests.test_harness_rehearsal import _python

WORKLOAD = "deepergcn-arxiv.resplus"
SEED = 2 ** 31 + 5


def tiny_cell() -> harness.Cell:
    """The cell at 600 vertices, 16 features, 5 classes, 4 layers of width
    16 and 12 epochs: the same job, limits, dropout and temperature."""
    cell = harness.load_cell(WORKLOAD)
    cfg = copy.deepcopy(cell.config)
    cfg["inputs"]["params"].update(nodes=600, features=16, classes=5,
                                   per_class_train=10, n_val=50, n_test=50)
    cfg.update(num_layers=4, hidden_channels=16, epochs=12)
    cell.config = cfg
    return cell


REHEARSE = """
import json, sys
from benchmark import harness, run
from benchmark.tests.test_harness_deepergcn import tiny_cell
cell = tiny_cell()
rec = harness.run_cell(cell, 2 ** 31 + 17, 0.0, False, device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
print(json.dumps(sorted(run.result_line(cell, rec, True)["metrics"])))
print(json.dumps(run.result_line(cell, rec, False)))
"""


def test_tiny_deepergcn_run_prints_the_contracts_line():
    modules, per_layer, last = _python(REHEARSE)[-3:]
    line = json.loads(last)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"step_ms", "setup_s"}
    assert set(line["compared"]) == {"loss", "grad", "grad_in", "update"}
    # the cell's per-layer metrics; on the CPU no trace is taken, so the
    # two that read one (device idle, the aggregation's roofline) are
    # silent
    assert {m["name"] for m in tiny_cell().per_layer} == {
        "prep_s", "loop_overhead_pct", "device_idle_pct",
        "softmax_agg_roofline_pct", "deepergcn_step_mfu_pct"}
    assert json.loads(per_layer) == ["deepergcn_step_mfu_pct",
                                     "loop_overhead_pct", "prep_s"]
    held = set(json.loads(modules))
    assert "gcn_tpu_torch" in held
    assert not held & {"jax", "jaxlib", "flax", "gcn_tpu"}


def test_deepergcn_reference_imports_nothing_of_the_program():
    code = ("import json, sys\n"
            "import benchmark.reference.deepergcn, benchmark.deepergcn_work\n"
            "import benchmark.metrics.softmax_agg_roofline_pct\n"
            "import benchmark.metrics.deepergcn_step_mfu_pct\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    held = set(json.loads(_python(code)[-1]))
    assert not held & {"gcn_tpu_torch", "gcn_tpu", "jax"}


@pytest.mark.parametrize("fault", sorted(deepergcn_faults.FAULTS))
def test_deepergcn_fault_turns_correct_false(fault):
    cell = tiny_cell()
    with deepergcn_faults.FAULTS[fault]():
        rec = harness.run_cell(cell, SEED, 0.0, False, device="cpu")
    assert run.result_line(cell, rec, False)["correct"] is False


def test_deepergcn_control_fails_the_limits():
    cell = tiny_cell()
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
            problem, SEED, 1, p_probe, prog.perm, prog.layers)
    readings = harness.compare(sides["tf32"], sides["float64"])
    assert any(readings[k] > cell.limits[k] for k in harness.COMPARED)


N, E = 169_343, 2_328_037   # ogbn-arxiv's shape, self loops included
LAYERS = ([("enc", 128, 128), ("conv0", 128, 128)]
          + [leaf for l in range(1, 28)
             for leaf in ((f"norm{l - 1}", 1, 128), (f"conv{l}", 128, 128))]
          + [("norm27", 1, 128), ("out", 128, 40)])


def test_shapes_from_the_leaves():
    assert deepergcn_work.shapes(LAYERS) == {
        "features": 128, "hidden": 128, "classes": 40, "convs": 28}
    assert sum(i * o + o for _, i, o in LAYERS) == 491_176


def test_aggregation_work_at_k128():
    # graph 4 B x 2,328,037 + 4 B x 169,344; m, a and the logsumexp
    # 4 B x 169,343 x 128 each
    graph, dense = 9_989_524, 86_703_616
    b, f = deepergcn_work.aggregation_work(N, E, 128, "forward")
    assert (b, f) == (graph + 3 * dense, 4 * E * 128)
    assert deepergcn_work.aggregation_work(N, E, 128, "eval")[0] == \
        graph + 2 * dense
    assert deepergcn_work.aggregation_work(N, E, 128, "backward")[0] == \
        graph + 4 * dense
    # bytes bound them: 0.081 / 0.055 / 0.107 ms, 0.242 ms a layer and
    # iteration, 6.77 ms for the 28 layers
    per = sum(work.bound_s(*deepergcn_work.aggregation_work(N, E, 128, c))
              for c in deepergcn_work.CALLS)
    assert abs(per - (3 * graph + 9 * dense) / 3.35e12) < 1e-15
    assert abs(28 * per - 6.7727e-3) < 1e-7


def test_fit_bound_counts_three_calls_a_layer_an_iteration_and_a_last_eval():
    calls = {c: work.bound_s(*deepergcn_work.aggregation_work(N, E, 128, c))
             for c in deepergcn_work.CALLS}
    want = 28 * (100 * sum(calls.values()) + calls["eval"])
    assert deepergcn_work.fit_aggregation_bound_s(N, E, LAYERS, 100) == want


def test_iteration_flops_of_the_cell():
    # a 128-wide product 2n x 128 x 128 = 5,549,031,424; the head 2n x
    # 128 x 40 = 1,734,072,320; the encoder as a conv
    conv, head = 5_549_031_424, 1_734_072_320
    fwd = 29 * conv + head
    bwd = conv + 2 * 28 * conv + 2 * head
    flops = deepergcn_work.iteration_flops(N, E, LAYERS)
    assert flops == 2 * fwd + bwd == 645_074_903_040
    # ~0.645 TFLOP: 9.63 ms at 67 TFLOP/s
    assert abs(flops / work.F32_FLOPS_PER_S - 0.00963) < 1e-5
