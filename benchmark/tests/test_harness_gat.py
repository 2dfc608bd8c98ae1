"""The GAT cell (``gat-arxiv.full``) at a tiny size on the CPU: a whole
run through ``harness.run_cell`` prints the contract's line and holds
neither JAX nor the JAX package, each fault of ``gat_faults.py`` and the
control (the reference in TF32 put in the program's place) fail the
cell's own limits, and ``gat_work.py``'s counts equal values worked out
by hand."""

import copy
import json

import pytest
import torch

from benchmark import gat_faults, gat_work, harness, run, work
from benchmark.tests.test_harness_rehearsal import _python

WORKLOAD = "gat-arxiv.full"
SEED = 2 ** 31 + 5


def tiny_cell() -> harness.Cell:
    """The cell at 600 vertices, 16 features, 5 classes, heads (2, 2, 3)
    of widths (8, 8, 5) and 12 epochs: the same job, limits and skip."""
    cell = harness.load_cell(WORKLOAD)
    cfg = copy.deepcopy(cell.config)
    cfg["inputs"]["params"].update(nodes=600, features=16, classes=5,
                                   per_class_train=10, n_val=50, n_test=50)
    cfg.update(heads=[2, 2, 3], hidden=[8, 8], epochs=12)
    cell.config = cfg
    return cell


REHEARSE = """
import json, sys
from benchmark import harness, run
from benchmark.tests.test_harness_gat import tiny_cell
cell = tiny_cell()
rec = harness.run_cell(cell, 2 ** 31 + 17, 0.0, False, device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
print(json.dumps(sorted(run.result_line(cell, rec, True)["metrics"])))
print(json.dumps(run.result_line(cell, rec, False)))
"""


def test_tiny_gat_run_prints_the_contracts_line():
    modules, per_layer, last = _python(REHEARSE)[-3:]
    line = json.loads(last)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"step_ms", "setup_s"}
    assert set(line["compared"]) == {"loss", "grad", "grad_in", "update"}
    # the cell's per-layer metrics; on the CPU no trace is taken, so the
    # two that read one (device idle, the attention's roofline) are silent
    assert {m["name"] for m in tiny_cell().per_layer} == {
        "prep_s", "loop_overhead_pct", "device_idle_pct",
        "gat_attn_roofline_pct", "gat_step_mfu_pct"}
    assert json.loads(per_layer) == ["gat_step_mfu_pct", "loop_overhead_pct",
                                     "prep_s"]
    held = set(json.loads(modules))
    assert "gcn_tpu_torch" in held
    assert not held & {"jax", "jaxlib", "flax", "gcn_tpu"}


def test_gat_reference_imports_nothing_of_the_program():
    code = ("import json, sys\n"
            "import benchmark.reference.gat, benchmark.gat_work\n"
            "import benchmark.metrics.gat_attn_roofline_pct\n"
            "import benchmark.metrics.gat_step_mfu_pct\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    held = set(json.loads(_python(code)[-1]))
    assert not held & {"gcn_tpu_torch", "gcn_tpu", "jax"}


@pytest.mark.parametrize("fault", sorted(gat_faults.FAULTS))
def test_gat_fault_turns_correct_false(fault):
    cell = tiny_cell()
    with gat_faults.FAULTS[fault]():
        rec = harness.run_cell(cell, SEED, 0.0, False, device="cpu")
    assert run.result_line(cell, rec, False)["correct"] is False


def test_gat_control_fails_the_limits():
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


LAYERS = [("gat1", 128, 1024), ("att1", 256, 8), ("gat2", 1024, 1024),
          ("att2", 256, 8), ("res2", 1024, 1024), ("att3", 40, 12),
          ("gat3", 1024, 240)]
N, E = 169_343, 2_328_037   # ogbn-arxiv's shape, self loops included


def test_layer_shapes_from_the_leaves():
    assert gat_work.layer_shapes(LAYERS) == [(128, 4, 256, False),
                                             (1024, 4, 256, True),
                                             (1024, 6, 40, False)]


def test_attention_work_at_4x256():
    # graph 4 B x 2,328,037 + 4 B x 169,344; wh and out 4 B x 169,343 x
    # 1,024 each; el, er and the logsumexp 4 B x 169,343 x 4 each
    b, f = gat_work.attention_work(N, E, 4, 256, "forward")
    assert b == 9_989_524 + 2 * 693_628_928 + 3 * 2_709_488
    assert f == 2 * 2_328_037 * 1_024 == 4_767_819_776
    b_eval, f_eval = gat_work.attention_work(N, E, 4, 256, "eval")
    assert (b - b_eval, f_eval) == (2_709_488, f)
    b, f = gat_work.attention_work(N, E, 4, 256, "backward")
    assert b == 9_989_524 + 4 * 693_628_928 + 6 * 2_709_488
    assert f == 4 * 2_328_037 * 1_024
    # bytes bound it: 1,405,375,844 B / 3.35e12 B/s ~ 0.42 ms
    fwd = work.bound_s(*gat_work.attention_work(N, E, 4, 256, "forward"))
    assert abs(fwd - 1_405_375_844 / 3.35e12) < 1e-18


def test_iteration_flops_of_the_cell():
    # h W: 2n x 128 x 1,024 = 44,392,251,392; 2n x 1,024 x 1,024 =
    # 355,138,011,136 (and the skip alike); 2n x 1,024 x 240 =
    # 83,235,471,360. Scores 4n HF: 693,628,928 and 162,569,280.
    # Attention 2E HF: 4,767,819,776 and 1,117,457,760.
    p1, p2, p3 = 44_392_251_392, 355_138_011_136, 83_235_471_360
    s12, s3, a12, a3 = 693_628_928, 162_569_280, 4_767_819_776, 1_117_457_760
    fwd = (p1 + s12 + a12) + (2 * p2 + s12 + a12) + (p3 + s3 + a3)
    # backward: layer 1's dW only; the others dW and dh
    bwd = ((p1 + 2 * s12 + 2 * a12) + (4 * p2 + 2 * s12 + 2 * a12)
           + (2 * p3 + 2 * s3 + 2 * a3))
    flops = gat_work.iteration_flops(N, E, LAYERS)
    assert flops == 2 * fwd + bwd == 3_356_034_426_496
    # ~3.36 TFLOP: 50.1 ms at 67 TFLOP/s
    assert abs(flops / work.F32_FLOPS_PER_S - 0.05009) < 1e-5


def test_fit_bound_counts_three_calls_a_layer_an_iteration_and_a_last_eval():
    per_layer = 0.0
    for _, heads, width, _ in gat_work.layer_shapes(LAYERS):
        calls = {c: work.bound_s(*gat_work.attention_work(N, E, heads,
                                                          width, c))
                 for c in gat_work.CALLS}
        per_layer += 100 * sum(calls.values()) + calls["eval"]
    assert gat_work.fit_attention_bound_s(N, E, LAYERS, 100) == per_layer
