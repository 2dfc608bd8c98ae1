"""CSR -> PanelAdj tiler (vectorized numpy).

The port of ``gcn_tpu/tile/tiler.py``: the same code, so the arrays equal
``gcn_tpu``'s (``tests/test_torch_port_panel.py`` checks it), plus, per
direction, ``win_off`` and the window split plan (``split_plan``) of kernel
K2, computed here on the host once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.tile.format import (BLOCK_PAD, DEFAULT_NB, DEFAULT_R,
                                       SPLIT_PARTS, PanelAdj, sm_count)
from gcn_tpu_torch.utils.device import resolve_device


def _tile_arrays(g: CSRGraph, r: int, nb: int):
    n = g.shape[0]
    e = g.nnz
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    win = rows // r                                   # window of each nnz
    num_windows = (n + r - 1) // r

    counts = np.bincount(win, minlength=num_windows)  # nnz per window
    # every window gets >= 1 block (possibly all padding), so every output
    # row is written
    blocks_per_win = np.maximum(1, -(-counts // nb))  # ceil
    block_offset = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(blocks_per_win, out=block_offset[1:])
    num_blocks = int(block_offset[-1])
    num_blocks_pad = max(BLOCK_PAD, -(-num_blocks // BLOCK_PAD) * BLOCK_PAD)

    win_start = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(counts, out=win_start[1:])
    ordinal = np.arange(e, dtype=np.int64) - win_start[win]  # pos in window
    dest_block = block_offset[win] + ordinal // nb
    dest_slot = ordinal % nb

    cols = np.zeros((num_blocks_pad, nb), dtype=np.int32)
    vals = np.zeros((num_blocks_pad, nb), dtype=np.float32)
    local_row = np.full((num_blocks_pad, nb), r, dtype=np.int32)  # pad -> R
    row_base = np.zeros(num_blocks_pad, dtype=np.int32)

    cols[dest_block, dest_slot] = g.indices
    vals[dest_block, dest_slot] = g.data
    local_row[dest_block, dest_slot] = (rows - win * r).astype(np.int32)
    # window base per block; trailing pad blocks re-visit the last window
    # (all-padding, so they only re-accumulate zeros)
    blk_win = np.repeat(np.arange(num_windows, dtype=np.int64), blocks_per_win)
    row_base[:num_blocks] = (blk_win * r).astype(np.int32)
    row_base[num_blocks:] = ((num_windows - 1) * r) if num_windows else 0
    # the trailing pad blocks count in the last window
    win_off = block_offset.astype(np.int32)
    win_off[-1] = num_blocks_pad
    return cols, vals, local_row, row_base, win_off


def default_split_slots(win_off: np.ndarray, nb: int, num_sms: int) -> int:
    """K2's split threshold: the per-SM mean of the direction's slots, all
    of them over the card's ``num_sms`` SMs. A window above it would hold
    more than one SM's fair share of the work; it is split across a
    cluster instead."""
    return max(1, -(-int(win_off[-1]) * nb // num_sms))


def split_plan(win_off: np.ndarray, nb: int, split_slots: int):
    """K2's window split plan for one direction: (heavy, parts, light).

    ``heavy`` int32 lists the windows of more than ``split_slots`` slots,
    ``light`` int32 the others, both ascending. Heavy window ``heavy[h]`` is
    walked by ``SPLIT_PARTS`` thread blocks of one cluster; part q covers
    its slots ``[parts[h, q], parts[h, q + 1])``, counted from the window's
    first slot: equal shares, each a multiple of 8 slots (one walker step),
    but the last.
    """
    slots = np.diff(np.asarray(win_off, np.int64)) * nb
    heavy = np.flatnonzero(slots > split_slots).astype(np.int32)
    light = np.flatnonzero(slots <= split_slots).astype(np.int32)
    total = slots[heavy]
    share = -(-(-(-total // SPLIT_PARTS)) // 8) * 8
    parts = np.minimum(total[:, None],
                       share[:, None] * np.arange(SPLIT_PARTS + 1))
    return heavy, parts.astype(np.int32), light


def panel_adjacency(
    g: CSRGraph,
    *,
    r: int = DEFAULT_R,
    nb: int = DEFAULT_NB,
    symmetric: Optional[bool] = None,
    device=None,
) -> PanelAdj:
    """Tile a CSR graph into the PanelAdj format on ``device``: the card by
    default (``utils.device.resolve_device``), ``device="cpu"`` for the
    CPU. K2's split plan (``split_plan``) cuts at each direction's
    ``default_split_slots`` for the card's SM count (``NUM_SMS``, an
    H100's, off the card)."""
    assert r % 8 == 0, "row window must be sublane-aligned"
    assert nb % 128 == 0, "block size must be lane-aligned"
    device = resolve_device(device)
    if symmetric is None:
        symmetric = g.shape[0] == g.shape[1] and g.is_symmetric()
    num_sms = sm_count(device)

    def dev(arrays):
        return tuple(torch.from_numpy(a).to(device) for a in arrays)

    def direction(graph):
        arrays = _tile_arrays(graph, r, nb)
        limit = default_split_slots(arrays[4], nb, num_sms)
        return dev(arrays + split_plan(arrays[4], nb, limit))

    fwd = direction(g)
    t = fwd if symmetric else direction(g.transpose())
    return PanelAdj(
        cols=fwd[0], vals=fwd[1], local_row=fwd[2], row_base=fwd[3],
        win_off=fwd[4], heavy=fwd[5], heavy_parts=fwd[6], light=fwd[7],
        t_cols=t[0], t_vals=t[1], t_local_row=t[2], t_row_base=t[3],
        t_win_off=t[4], t_heavy=t[5], t_heavy_parts=t[6], t_light=t[7],
        n_rows=g.shape[0], n_cols=g.shape[1], nnz=g.nnz,
        r=r, nb=nb, symmetric=bool(symmetric),
    )
