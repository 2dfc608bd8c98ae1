"""The row-window block-segment format (PanelAdj).

The port of ``gcn_tpu/tile/format.py``. The nonzeros, in CSR order, are cut
into blocks of ``NB`` slots; every block's rows lie inside one aligned
window of ``R`` rows (blocks are cut at window boundaries), and every
window owns at least one block. Padding slots carry ``val == 0``,
``col == 0`` and ``local_row == R``. Within a window the real slots come
first, in CSR order, and the padding after them, so ``local_row`` never
decreases along a window's slots: kernel K2 relies on that (``validate``
checks it).

  cols      int32[num_blocks, NB]   global column of each slot
  vals      f32[num_blocks, NB]     edge weight
  local_row int32[num_blocks, NB]   row - window base, in [0, R); R = pad
  row_base  int32[num_blocks]       window base row (R-aligned)
  win_off   int32[num_windows + 1]  blocks of window w are
                                    [win_off[w], win_off[w + 1])

``win_off`` is the port's addition (``gcn_tpu`` scalar-prefetches
``row_base // R`` instead): kernel K2 (``ops/panel_spmm.py``) gives each
window to one thread block, which finds its blocks through it. The
trailing all-padding blocks (``num_blocks`` is padded to a multiple of
``BLOCK_PAD``) count in the last window. ``t_*`` mirror the arrays for the
transpose (backward dX = A^T g) and alias the forward tensors when A is
symmetric. The defaults are ``gcn_tpu``'s, so that the arrays are equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_R = 128
DEFAULT_NB = 512
BLOCK_PAD = 16

_TENSORS = ("cols", "vals", "local_row", "row_base", "win_off", "t_cols",
            "t_vals", "t_local_row", "t_row_base", "t_win_off")


@dataclasses.dataclass(frozen=True)
class PanelAdj:
    """Row-window block-segment adjacency on one device (module
    docstring)."""

    cols: torch.Tensor        # int32[num_blocks, NB]
    vals: torch.Tensor        # f32[num_blocks, NB]
    local_row: torch.Tensor   # int32[num_blocks, NB]
    row_base: torch.Tensor    # int32[num_blocks]
    win_off: torch.Tensor     # int32[num_windows + 1]
    t_cols: torch.Tensor
    t_vals: torch.Tensor
    t_local_row: torch.Tensor
    t_row_base: torch.Tensor
    t_win_off: torch.Tensor
    n_rows: int
    n_cols: int
    nnz: int
    r: int
    nb: int
    symmetric: bool

    @property
    def num_blocks(self) -> int:
        return self.cols.shape[0]

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def pad_fraction(self) -> float:
        """Fraction of stored entries that are padding."""
        total = self.num_blocks * self.nb
        return 1.0 - self.nnz / total if total else 0.0

    def to(self, device) -> "PanelAdj":
        """A copy with every tensor on ``device`` (aliases stay aliases)."""
        moved = {}
        for name in _TENSORS:
            t = getattr(self, name)
            for done_name, done in moved.items():
                if getattr(self, done_name) is t:
                    moved[name] = done
                    break
            else:
                moved[name] = t.to(device)
        return dataclasses.replace(self, **moved)

    def validate(self) -> None:
        """Host-side format-invariant walker; raises AssertionError on the
        first violated invariant. Not for the hot path."""
        for name, cols, vals, lrow, base, off, n_rows, n_cols in (
                ("fwd", self.cols, self.vals, self.local_row, self.row_base,
                 self.win_off, self.n_rows, self.n_cols),
                ("bwd", self.t_cols, self.t_vals, self.t_local_row,
                 self.t_row_base, self.t_win_off, self.n_cols, self.n_rows)):
            cols, vals, lrow, base, off = (
                t.cpu().numpy() for t in (cols, vals, lrow, base, off))
            nw = -(-n_rows // self.r)
            assert cols.shape == vals.shape == lrow.shape == (
                base.shape[0], self.nb), name
            assert base.shape[0] % BLOCK_PAD == 0, name
            real = lrow < self.r
            assert (lrow >= 0).all() and (lrow <= self.r).all(), name
            assert (vals[~real] == 0).all(), f"{name}: padding holds a value"
            assert ((cols[real] >= 0) & (cols[real] < n_cols)).all(), \
                f"{name}: stored column out of range"
            assert int(real.sum()) == self.nnz, f"{name}: nnz mismatch"
            assert off.shape == (nw + 1,) and off[0] == 0 \
                and off[-1] == base.shape[0], f"{name}: win_off bounds"
            assert (np.diff(off) >= 1).all(), \
                f"{name}: every window must own a block"
            blk_win = np.repeat(np.arange(nw), np.diff(off))
            assert (base == blk_win * self.r).all(), \
                f"{name}: row_base disagrees with win_off"
            rises = np.diff(lrow.reshape(-1)) >= 0
            rises[off[1:-1] * self.nb - 1] = True   # a new window starts
            assert rises.all(), \
                f"{name}: local_row decreases inside a window"
