"""gcn_tpu's native reorder library, loaded the same way in every test
process, and a guard that both packages take the same reorder route.

gcn_tpu builds ``libgcnreorder.so`` in its source tree on first use
(``gcn_tpu/reorder/native.py``): ``make`` writes the file in place, and a
process that loads it while another one is still writing it treats the
library as missing for its whole life and silently takes the numpy passes,
whose permutations differ from the native ones. Under several test workers
that makes a parity test compare the port's native permutation with
gcn_tpu's numpy one.

``pin_native()`` builds a private copy of gcn_tpu's sources in a directory
of this process and points gcn_tpu's loader at it, so no other process
writes the file it loads: whether the library loads then depends only on
the host (a host without g++ has it on neither side). ``check_same_route``
names the side that fell back if the two packages still differ. The parity
modules use both through the ``native_reorder`` fixture::

    from torch_port_native import native_reorder  # noqa: F401 (autouse)

and run gcn_tpu's scripts in a subprocess through ``pinned_command``, whose
gcn_tpu loads the same private build.
"""

import atexit
import os
import shutil
import sys
import tempfile

import pytest

from gcn_tpu.reorder import _NATIVE_METHODS as JX_NATIVE_METHODS
from gcn_tpu.reorder import native as jx_native

from gcn_tpu_torch.reorder import route

# what pin_native() built: (csrc directory, library path, CDLL or None)
_private = None
# runs the script argv[3:] with gcn_tpu's reorder loader on argv[1:3]
_PINNED_RUN = (
    "import os, runpy, sys\n"
    "from gcn_tpu.reorder import native\n"
    "native._CSRC, native._SO = sys.argv[1:3]\n"
    "sys.argv = sys.argv[3:]\n"
    "sys.path.insert(0, os.path.dirname(sys.argv[0]))\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _build_private():
    csrc = os.path.join(tempfile.mkdtemp(prefix="gcn_tpu_reorder_"), "csrc")
    atexit.register(shutil.rmtree, os.path.dirname(csrc), True)
    # the sources only: a library in the tree may be half written
    shutil.copytree(jx_native._CSRC, csrc,
                    ignore=shutil.ignore_patterns("*.so", "*.o"))
    jx_native._CSRC = csrc
    jx_native._SO = os.path.join(csrc, os.path.basename(jx_native._SO))
    jx_native._lib, jx_native._load_failed = None, False
    return csrc, jx_native._SO, jx_native._try_load()


def pin_native():
    """Point gcn_tpu's reorder loader at this process's private build
    (made on the first call) and return gcn_tpu's previous loader state,
    for ``restore``."""
    global _private
    saved = (jx_native._CSRC, jx_native._SO, jx_native._lib,
             jx_native._load_failed)
    if _private is None:
        _private = _build_private()
    csrc, so, lib = _private
    jx_native._CSRC, jx_native._SO = csrc, so
    jx_native._lib, jx_native._load_failed = lib, lib is None
    return saved


def restore(saved):
    """Put gcn_tpu's loader back as ``pin_native`` found it."""
    (jx_native._CSRC, jx_native._SO, jx_native._lib,
     jx_native._load_failed) = saved


def pinned_command(script, args):
    """The command that runs the Python ``script`` with ``args`` in a
    subprocess whose gcn_tpu loads this process's private reorder build
    (``pin_native``, which the ``native_reorder`` fixture calls)."""
    if _private is None:
        raise RuntimeError("pin_native() has not built the private library")
    csrc, so, _ = _private
    return [sys.executable, "-c", _PINNED_RUN, csrc, so, script] + list(args)


def check_same_route(method="rabbit"):
    """Fail, naming the side that fell back to its numpy passes, unless
    gcn_tpu and the port compute ``method``'s permutation alike."""
    ours = route(method) == "native"
    theirs = method in JX_NATIVE_METHODS and jx_native.available()
    if ours != theirs:
        fell_back = "gcn_tpu" if ours else "gcn_tpu_torch"
        raise AssertionError(
            f"reorder route differs for {method!r}: {fell_back} fell back "
            f"to its numpy passes (gcn_tpu native: {theirs}, gcn_tpu_torch "
            f"native: {ours}); their permutations would differ")


@pytest.fixture(scope="module", autouse=True)
def native_reorder():
    """gcn_tpu on the private build for one module, both routes checked
    before its first test; gcn_tpu's loader restored after its last."""
    saved = pin_native()
    try:
        check_same_route()
        yield
    finally:
        restore(saved)
