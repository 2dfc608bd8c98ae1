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
``row_base // R`` instead): kernel K2 (``ops/panel_spmm.py``) finds each
window's blocks through it. The trailing all-padding blocks (``num_blocks``
is padded to a multiple of ``BLOCK_PAD``) count in the last window. So is
K2's window split plan (``tile/tiler.py::split_plan``), made once on the
host:

  heavy       int32[n_heavy]                windows of more slots than
                                            the split threshold
  heavy_parts int32[n_heavy, SPLIT_PARTS+1] each heavy window's part
                                            offsets, in slots from its
                                            first slot
  light       int32[num_windows - n_heavy]  the other windows

``t_*`` mirror the arrays for the transpose (backward dX = A^T g) and alias
the forward tensors when A is symmetric. The defaults are ``gcn_tpu``'s, so
that the arrays are equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_R = 128
DEFAULT_NB = 512
BLOCK_PAD = 16
SPLIT_PARTS = 8   # K2's thread blocks a heavy window: one cluster
NUM_SMS = 132     # SMs of an H100 SXM: the split plan of a layout built
                  # off the card


def sm_count(device) -> int:
    """The SMs of ``device`` that a split plan shares work over: the
    card's own, or an H100's (``NUM_SMS``) for a layout built off the
    card."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return NUM_SMS


_TENSORS = ("cols", "vals", "local_row", "row_base", "win_off", "heavy",
            "heavy_parts", "light", "t_cols", "t_vals", "t_local_row",
            "t_row_base", "t_win_off", "t_heavy", "t_heavy_parts", "t_light")


@dataclasses.dataclass(frozen=True)
class PanelAdj:
    """Row-window block-segment adjacency on one device (module
    docstring)."""

    cols: torch.Tensor        # int32[num_blocks, NB]
    vals: torch.Tensor        # f32[num_blocks, NB]
    local_row: torch.Tensor   # int32[num_blocks, NB]
    row_base: torch.Tensor    # int32[num_blocks]
    win_off: torch.Tensor     # int32[num_windows + 1]
    heavy: torch.Tensor       # int32[n_heavy]
    heavy_parts: torch.Tensor  # int32[n_heavy, SPLIT_PARTS + 1]
    light: torch.Tensor       # int32[num_windows - n_heavy]
    t_cols: torch.Tensor
    t_vals: torch.Tensor
    t_local_row: torch.Tensor
    t_row_base: torch.Tensor
    t_win_off: torch.Tensor
    t_heavy: torch.Tensor
    t_heavy_parts: torch.Tensor
    t_light: torch.Tensor
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
    def plan(self):
        """K2's split plan of the forward arrays: (heavy, heavy_parts,
        light)."""
        return self.heavy, self.heavy_parts, self.light

    @property
    def t_plan(self):
        return self.t_heavy, self.t_heavy_parts, self.t_light

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
        for name, cols, vals, lrow, base, off, plan, n_rows, n_cols in (
                ("fwd", self.cols, self.vals, self.local_row, self.row_base,
                 self.win_off, self.plan, self.n_rows, self.n_cols),
                ("bwd", self.t_cols, self.t_vals, self.t_local_row,
                 self.t_row_base, self.t_win_off, self.t_plan, self.n_cols,
                 self.n_rows)):
            cols, vals, lrow, base, off = (
                t.cpu().numpy() for t in (cols, vals, lrow, base, off))
            heavy, parts, light = (t.cpu().numpy() for t in plan)
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
            slots = np.diff(off).astype(np.int64) * self.nb
            assert np.array_equal(np.union1d(heavy, light), np.arange(nw)) \
                and heavy.size + light.size == nw, \
                f"{name}: the split plan must list every window once"
            assert heavy.size == 0 or light.size == 0 \
                or slots[heavy].min() > slots[light].max(), \
                f"{name}: a light window holds as many slots as a heavy one"
            assert parts.shape == (heavy.size, SPLIT_PARTS + 1) \
                and (parts[:, 0] == 0).all() \
                and (parts[:, -1] == slots[heavy]).all() \
                and (np.diff(parts, axis=1) >= 0).all() \
                and (parts[:, 1:-1] % 8 == 0).all(), \
                f"{name}: heavy parts must tile each heavy window in order"
