"""ctypes binding for the native C++ reordering library (host code).

``csrc/reorder.cpp`` is a copy of ``gcn_tpu/reorder/csrc/reorder.cpp``; it
is compiled with g++ at first use into ``gcn_tpu_torch/_build/``
(``ops/_build.py``). When no host compiler is present the callers fall back
to the numpy passes, as ``gcn_tpu`` does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.ops import _build

SOURCES = ["reorder/csrc/reorder.cpp"]
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = _build.load_library("gcnreorder", SOURCES, "g++")
    except (_build.BuildError, OSError):
        _load_failed = True
        return None
    lib.gcn_reorder.restype = ctypes.c_int
    lib.gcn_reorder.argtypes = [ctypes.c_char_p, _i32p, _i32p, _f32p,
                                ctypes.c_int32, ctypes.c_int64, _i32p]
    lib.gcn_csr_permute.restype = ctypes.c_int
    lib.gcn_csr_permute.argtypes = [_i32p, _i32p, _f32p, _i32p,
                                    ctypes.c_int32, ctypes.c_int64,
                                    _i32p, _i32p, _f32p]
    _lib = lib
    return _lib


def available() -> bool:
    return _try_load() is not None


def _arrays(g: CSRGraph):
    return (np.ascontiguousarray(g.indptr, dtype=np.int32),
            np.ascontiguousarray(g.indices, dtype=np.int32),
            np.ascontiguousarray(g.data, dtype=np.float32))


def csr_permute(g: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """Native symmetric permutation with sorted columns (perm[new]=old)."""
    lib = _try_load()
    if lib is None:
        raise RuntimeError("native reorder library unavailable")
    n = g.shape[0]
    assert g.shape[0] == g.shape[1]
    indptr, indices, data = _arrays(g)
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    out_indptr = np.empty(n + 1, dtype=np.int32)
    out_indices = np.empty(g.nnz, dtype=np.int32)
    out_data = np.empty(g.nnz, dtype=np.float32)
    rc = lib.gcn_csr_permute(
        indptr.ctypes.data_as(_i32p), indices.ctypes.data_as(_i32p),
        data.ctypes.data_as(_f32p), perm.ctypes.data_as(_i32p),
        ctypes.c_int32(n), ctypes.c_int64(g.nnz),
        out_indptr.ctypes.data_as(_i32p), out_indices.ctypes.data_as(_i32p),
        out_data.ctypes.data_as(_f32p))
    if rc != 0:
        raise RuntimeError(f"native csr_permute failed with code {rc}")
    return CSRGraph(out_indptr, out_indices, out_data, g.shape)


def compute_permutation(g: CSRGraph, method: str) -> np.ndarray:
    lib = _try_load()
    if lib is None:
        raise RuntimeError("native reorder library unavailable")
    perm = np.empty(g.shape[0], dtype=np.int32)
    indptr, indices, data = _arrays(g)
    rc = lib.gcn_reorder(
        method.encode(), indptr.ctypes.data_as(_i32p),
        indices.ctypes.data_as(_i32p), data.ctypes.data_as(_f32p),
        ctypes.c_int32(g.shape[0]), ctypes.c_int64(g.nnz),
        perm.ctypes.data_as(_i32p))
    if rc != 0:
        raise RuntimeError(f"native reorder {method!r} failed with code {rc}")
    return perm
