"""ctypes binding for the native C++ ELL tiler (host code).

``csrc/tiler.cpp`` is a copy of ``gcn_tpu/tile/csrc/tiler.cpp``; it is
compiled with g++ at first use into ``gcn_tpu_torch/_build/``
(``ops/_build.py``). Its two-phase contract, ``ell_plan`` (the block count)
then ``ell_fill`` (the arrays into buffers the caller owns), is gcn_tpu's.
When no host compiler is present ``tile/ell.py`` tiles with numpy, as
``gcn_tpu`` does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from gcn_tpu_torch.ops import _build

SOURCES = ["tile/csrc/tiler.cpp"]
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = _build.load_library("gcntiler", SOURCES, "g++")
    except (_build.BuildError, OSError):
        _load_failed = True
        return None
    lib.ell_plan.restype = ctypes.c_int
    lib.ell_plan.argtypes = [_i32p, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_int64, _i64p, _i64p]
    lib.ell_fill.restype = ctypes.c_int
    lib.ell_fill.argtypes = [_i32p, _i32p, _f32p, ctypes.c_int64,
                             ctypes.c_int64, ctypes.c_int64, _i32p, _f32p,
                             _i32p]
    _lib = lib
    return _lib


def available() -> bool:
    return _try_load() is not None


def ell_arrays(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               n: int, r: int, p: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The native counterpart of ``tile.ell._ell_arrays`` without forced
    passes: ``(cols, vals, win)``."""
    lib = _try_load()
    if lib is None:
        raise RuntimeError("native tiler unavailable")
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float32)
    # the library reads indptr[0..n] and the edges they point at
    if (indptr.shape != (n + 1,) or indices.shape != data.shape
            or indptr[0] != 0 or indptr[-1] > indices.shape[0]
            or r <= 0 or p <= 0):
        raise ValueError("ell_arrays: indptr, indices and data do not "
                         f"describe {n} rows, or r={r} / p={p} <= 0")
    nw, nb = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.ell_plan(indptr.ctypes.data_as(_i32p), n, r, p,
                      ctypes.byref(nw), ctypes.byref(nb))
    if rc != 0:
        raise RuntimeError(f"ell_plan failed with code {rc}")
    cols = np.zeros((nb.value, p, r), dtype=np.int32)
    vals = np.zeros((nb.value, p, r), dtype=np.float32)
    win = np.zeros(nb.value, dtype=np.int32)
    rc = lib.ell_fill(indptr.ctypes.data_as(_i32p),
                      indices.ctypes.data_as(_i32p),
                      data.ctypes.data_as(_f32p), n, r, p,
                      cols.ctypes.data_as(_i32p), vals.ctypes.data_as(_f32p),
                      win.ctypes.data_as(_i32p))
    if rc != 0:
        raise RuntimeError(f"ell_fill failed with code {rc}")
    return cols, vals, win
