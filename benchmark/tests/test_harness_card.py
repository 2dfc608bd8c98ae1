"""On the card: one short run of each cell through the command line, its
last line correct. Run with ``python -m pytest benchmark/tests -m cuda``
on a machine with an NVIDIA GPU; skips elsewhere."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny import CELLS


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cells run on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", "2147483700", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
