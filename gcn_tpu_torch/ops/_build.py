"""Build the port's native libraries at first use.

Two kinds of shared library, both with a plain C interface loaded through
ctypes, both compiled from sources in the package into
``gcn_tpu_torch/_build/`` (never beside the sources):

  * CUDA kernels (``ops/csrc/*.cu``) with ``nvcc`` for ``sm_90a``;
  * host code (``reorder/csrc/reorder.cpp``) with ``g++``.

A library's file name carries a digest of its sources and flags (the headers
it includes are listed among its sources, hashed but not compiled), so a
stale binary can never be loaded after a source edit, and concurrent
builders (pytest workers) each write a private temporary file and rename it
into place. A failed build raises ``BuildError``: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# no -fopenmp: not every host has libgomp, and the library's two OpenMP
# pragmas (the row loop of gcn_csr_permute) give the same result serially
GXX_FLAGS = ["-O3", "-std=c++20", "-fPIC", "-shared"]

# library name -> sources (relative to the package) of each CUDA library,
# with the headers it includes
CUDA_LIBRARIES = {"gcnellspmm": ["ops/csrc/ell_spmm.cu"],
                  "gcnpanelspmm": ["ops/csrc/panel_spmm.cu"],
                  "gcncoospmm": ["ops/csrc/coo_spmm.cu"],
                  "gcngatattn": ["ops/csrc/gat_attn.cu",
                                 "ops/csrc/row_walk.cuh"],
                  "gcnsoftmaxagg": ["ops/csrc/softmax_agg.cu",
                                    "ops/csrc/row_walk.cuh"]}
_HEADERS = (".cuh", ".h", ".hpp")


class BuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (looked in $CUDA_HOME/bin, "
                     "/usr/local/cuda/bin and PATH): the CUDA kernels cannot "
                     "be built")


def _command(compiler: str, sources: Sequence[str]) -> List[str]:
    if compiler == "nvcc":
        return [_nvcc(), *NVCC_FLAGS, *sources]
    if compiler == "g++":
        return [os.environ.get("CXX", "g++"), *GXX_FLAGS, *sources]
    raise ValueError(f"unknown compiler {compiler!r}")


def library_path(name: str, sources: Sequence[str], compiler: str) -> str:
    h = hashlib.sha256(compiler.encode())
    flags = NVCC_FLAGS if compiler == "nvcc" else GXX_FLAGS
    h.update(" ".join(flags).encode())
    for s in sources:
        with open(os.path.join(_PKG, s), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_libraries(specs: Dict[str, Sequence[str]], compiler: str
                    ) -> Dict[str, tuple]:
    """Build every library of ``specs`` ({name: sources}) that is not built
    yet, one compiler process per library, all started together.

    Returns {name: (path, compiler output)}; the output is empty for a
    library that was already built. Raises BuildError on any failure.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    result = {}
    for name, sources in specs.items():
        out = library_path(name, sources, compiler)
        if os.path.exists(out):
            result[name] = (out, "")
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = _command(compiler, [os.path.join(_PKG, s) for s in sources
                                  if not s.endswith(_HEADERS)])
        try:
            proc = subprocess.Popen(cmd + ["-o", tmp],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise BuildError(f"cannot start {cmd[0]}: {e}") from e
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            failed.append(f"{name}: {compiler} exited {proc.returncode}:\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
        result[name] = (out, log)
    if failed:
        raise BuildError("native build failed\n" + "\n".join(failed))
    return result


_loaded: Dict[str, ctypes.CDLL] = {}


def load_library(name: str, sources: Sequence[str], compiler: str
                 ) -> ctypes.CDLL:
    """Build (if needed) and load one library; cached per process."""
    if name not in _loaded:
        path, _ = build_libraries({name: sources}, compiler)[name]
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]


def build_cuda_kernels() -> Dict[str, tuple]:
    """Build every CUDA library of the port in parallel (chip_smoke.py's
    build phase); returns {name: (path, nvcc/ptxas output)}."""
    return build_libraries(CUDA_LIBRARIES, "nvcc")
