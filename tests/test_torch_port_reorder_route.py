"""The parity modules' reorder guard (``tests/torch_port_native.py``):
gcn_tpu's native reorder library loads the same way in every test process
and in the gcn_tpu scripts they run, and a side that falls back to its
numpy passes fails the guard by name instead of as a permutation
mismatch.

gcn_tpu's loader marks the library missing for the life of a process when
it loads a file another process is still writing; the tests force that
state with ``monkeypatch``."""

import subprocess

import numpy as np
import pytest

from gcn_tpu.data import get_dataset as jx_get_dataset
from gcn_tpu.graph.normalize import gcn_normalize as jx_normalize
from gcn_tpu.reorder import compute_permutation as jx_permutation
from gcn_tpu.reorder import native as jx_native

from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.reorder import compute_permutation, native, route
from torch_port_dist_graphs import REPO, subprocess_env
from torch_port_native import (check_same_route, pin_native, pinned_command,
                               restore)

GRAPH = "synth-cora-hard"


def _perms(method="rabbit"):
    """(port, gcn_tpu) permutations of GRAPH after gcn_normalize."""
    g = gcn_normalize(get_dataset(GRAPH, seed=0).adj)
    jg = jx_normalize(jx_get_dataset(GRAPH, seed=0).adj)
    return compute_permutation(g, method), jx_permutation(jg, method)


def _fail_gcn_tpu_load(monkeypatch):
    """gcn_tpu's loader as a process leaves it after loading a half-written
    library: missing for good."""
    monkeypatch.setattr(jx_native, "_lib", None)
    monkeypatch.setattr(jx_native, "_load_failed", True)


def test_pin_native_restores_gcn_tpu_native_route(monkeypatch):
    _fail_gcn_tpu_load(monkeypatch)
    assert not jx_native.available()
    saved = pin_native()
    try:
        assert jx_native.available()
        assert route("rabbit") == "native"
        check_same_route("rabbit")
        ours, ref = _perms()
        np.testing.assert_array_equal(ours, ref)
    finally:
        restore(saved)
    assert jx_native._load_failed and jx_native._lib is None


def test_route_guard_names_gcn_tpu_when_it_fell_back(monkeypatch):
    """Without the helper, gcn_tpu's numpy rabbit differs from the port's
    native one on most vertices; the guard fails first, by name."""
    _fail_gcn_tpu_load(monkeypatch)
    assert route("rabbit") == "native"
    ours, ref = _perms()
    assert np.mean(ours != ref) > 0.5
    with pytest.raises(AssertionError, match="gcn_tpu fell back to its "
                                             "numpy passes"):
        check_same_route("rabbit")


def test_route_guard_names_the_port_when_it_fell_back(monkeypatch):
    saved = pin_native()
    try:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load_failed", True)
        assert jx_native.available()
        with pytest.raises(AssertionError, match="gcn_tpu_torch fell back "
                                                 "to its numpy passes"):
            check_same_route("rabbit")
    finally:
        restore(saved)


@pytest.mark.parametrize("method", ["degree_in", "identity"])
def test_route_guard_passes_numpy_only_methods(monkeypatch, method):
    """Methods the native library lacks take the same route on both
    sides, whatever gcn_tpu's loader says."""
    _fail_gcn_tpu_load(monkeypatch)
    check_same_route(method)
    ours, ref = _perms(method)
    np.testing.assert_array_equal(ours, ref)


def test_pinned_command_runs_a_script_on_the_private_build(tmp_path):
    """gcn_tpu's scripts run in a subprocess load the same private build,
    with the script's own arguments and ``__main__``."""
    script = tmp_path / "which.py"
    script.write_text(
        "import sys\n"
        "from gcn_tpu.reorder import native\n"
        "if __name__ == '__main__':\n"
        "    print(native._SO, native.available(), sys.argv[1:])\n")
    saved = pin_native()
    try:
        proc = subprocess.run(
            pinned_command(str(script), ["-g", "synth-tiny"]), cwd=REPO,
            env=dict(subprocess_env(), JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.split() == [jx_native._SO, "True", "['-g',",
                                       "'synth-tiny']"]
    finally:
        restore(saved)
