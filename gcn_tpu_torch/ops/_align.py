"""The x that the vector-load kernels (K1, K2) can read in place.

Both kernels read a row of x ``WIDTH`` elements at a time with one vector
load (16 bytes of f32, 8 bytes of bf16), so every row must start on a
``WIDTH * itemsize``-byte boundary and hold ``WIDTH``-element groups up to
its padded width. ``aligned_rows`` hands back x itself when it qualifies,
a strided view of row-contiguous rows included, and otherwise a copy whose
rows are zero-padded to a multiple of ``WIDTH`` elements.
"""

from __future__ import annotations

import torch

WIDTH = 4  # elements a vector load


def aligned_rows(x: torch.Tensor, kernel: str):
    """(x, ldx): x as ``kernel`` reads it, and its row stride in elements.

    x itself when its rows are contiguous, its row stride is a multiple of
    ``WIDTH``, its base is aligned to one vector and the storage holds the
    last row's padded width; else a zero-padded copy. Raises ValueError for
    an x whose rows are not contiguous (a transposed view).
    """
    n, k = x.shape
    if k > 1 and x.stride(1) != 1:
        raise ValueError(f"{kernel} needs an x with contiguous rows, got "
                         f"strides {tuple(x.stride())}")
    kw = -(-k // WIDTH) * WIDTH
    ldx = x.stride(0) if n > 1 else kw
    item = x.element_size()
    readable = x.untyped_storage().nbytes() // item - x.storage_offset()
    if (ldx % WIDTH == 0 and ldx >= kw and x.data_ptr() % (WIDTH * item) == 0
            and (n - 1) * ldx + kw <= readable):
        return x, ldx
    xp = x.new_zeros((n, kw))
    xp[:, :k] = x
    return xp, kw
