"""A whole run of each cell at a tiny size on the CPU (the look for a
chip skipped), in a fresh process: its last line carries the contract's
keys, and neither it nor the references hold JAX or the JAX package."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny import CELLS

REHEARSE = """
import json, sys
from benchmark import harness, run
from benchmark.tests.tiny import tiny_cell
cell = tiny_cell(sys.argv[1])
rec = harness.run_cell(cell, 2 ** 31 + 17, 0.0, False, device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
print(json.dumps(run.result_line(cell, rec, False)))
"""


def _python(code, *args):
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_prints_the_contracts_line(workload):
    modules, last = _python(REHEARSE, workload)[-2:]
    line = json.loads(last)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"step_ms", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    held = set(json.loads(modules))
    assert "gcn_tpu_torch" in held
    assert not held & {"jax", "jaxlib", "flax", "gcn_tpu"}


def test_references_import_nothing_of_the_program():
    code = ("import json, sys\n"
            "import benchmark.reference.gcn, benchmark.reference.hgnn\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    held = set(json.loads(_python(code)[-1]))
    assert not held & {"gcn_tpu_torch", "gcn_tpu", "jax"}
