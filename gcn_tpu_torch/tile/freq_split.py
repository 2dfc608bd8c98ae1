"""Frequency-split ELL tables: a hot column prefix and a cold tail.

The port of ``gcn_tpu/tile/freq_split.py``. After a degree sort the hottest
columns are the first rows of x, and a small prefix of them covers most
edges. The split tiles the columns below ``hot_rows`` and the rest as two
rectangular EllAdj parts; each edge goes to exactly one side, so

    out = A_hot @ x[:H]  +  A_cold @ x[H:]

is two K1 launches summed, each differentiable through ``spmm_ell`` (the
parts carry their own transpose arrays, since they are not symmetric).
The split exists for the TPU's table residency envelope; on the H100 it is
kept for capability parity and is no default (``GCN`` takes it through
``adj_options={"freq_split": True}``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.tile.ell import EllAdj, ell_adjacency
from gcn_tpu_torch.utils.device import resolve_device

# gcn_tpu's gather-table residency budget (gcn_tpu/ops/ell_spmm.py,
# ``_TABLE_BUDGET_BYTES``): a TPU figure, copied so that both packages lay
# out equal arrays, not tuned for the H100.
TABLE_BUDGET_BYTES = 100 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class FreqSplitAdj:
    """Two-table split adjacency (see the module docstring). ``*_unperm``
    (int64, or None) map each part's rows back to global rows when the
    parts were re-sorted by their own degree (``part_sort``)."""

    hot: EllAdj                 # (n_rows, hot_rows): columns < hot_rows
    cold: Optional[EllAdj]      # (n_rows, n_cols - hot_rows), or None when
                                # hot_rows == n_cols (no cold part)
    hot_unperm: Optional[torch.Tensor]
    cold_unperm: Optional[torch.Tensor]
    hot_rows: int
    n_rows: int
    n_cols: int
    nnz: int
    hot_nnz: int

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def k_pad(self) -> int:
        """Both parts' k_pad: ``hoist_spmm``'s column chunk."""
        return self.hot.k_pad

    @property
    def hot_edge_fraction(self) -> float:
        return self.hot_nnz / max(self.nnz, 1)

    def validate(self) -> None:
        """Host-side walker over both parts' invariants and the split's
        bookkeeping; raises AssertionError on the first violation."""
        assert 0 < self.hot_rows <= self.n_cols, "hot_rows out of range"
        assert self.hot.shape == (self.n_rows, self.hot_rows), \
            "hot part shape mismatch"
        self.hot.validate()
        if self.cold is None:
            assert self.hot_rows == self.n_cols, \
                "missing cold part despite hot_rows < n_cols"
            assert self.hot_nnz == self.nnz, \
                "edges lost: no cold part but hot_nnz < nnz"
        else:
            assert self.cold.shape == (self.n_rows,
                                       self.n_cols - self.hot_rows), \
                "cold part shape mismatch"
            self.cold.validate()
            assert self.hot.nnz == self.hot_nnz, \
                "hot_nnz bookkeeping drifted from the hot part"
            assert self.hot.nnz + self.cold.nnz == self.nnz, \
                "edges lost across the split"
        for unperm in (self.hot_unperm, self.cold_unperm):
            if unperm is not None:
                u = np.sort(unperm.cpu().numpy())
                assert (u == np.arange(self.n_rows)).all(), \
                    "un-permute map is not a permutation"


def default_hot_rows(n_cols: int, table_bf16: bool = False) -> int:
    """Hot-table height: half of gcn_tpu's TPU residency envelope
    (``TABLE_BUDGET_BYTES`` of 128-lane rows), rounded down to a multiple
    of 8; ``n_cols`` (no split) when the whole table fits the envelope.
    The figure is the TPU's, kept so that both packages lay out equal
    arrays; it is not tuned for the H100."""
    dsize = 2 if table_bf16 else 4
    raw = TABLE_BUDGET_BYTES // (128 * dsize)
    if n_cols <= raw:
        return n_cols
    return max(8, min(raw // 2, n_cols)) // 8 * 8


def freq_split_order(g: CSRGraph, *, hot_rows: int = None,
                     table_bf16: bool = False):
    """Part-aware vertex order (order[new] = old): the hot prefix [0, H)
    and the tail [H, n) each re-sorted by cold-part degree, so the hot
    column set stays the prefix and both parts get homogeneous windows.
    A symmetric permutation, composed into the model's permutation chain
    before the split is built. None when there is nothing to split."""
    n, m = g.shape
    if hot_rows is None:
        hot_rows = default_hot_rows(m, table_bf16)
    if hot_rows >= m:
        return None
    rows_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    cold_deg = np.bincount(rows_of[g.indices >= hot_rows], minlength=n)
    pre = np.argsort(-cold_deg[:hot_rows], kind="stable")
    tail = hot_rows + np.argsort(-cold_deg[hot_rows:], kind="stable")
    return np.concatenate([pre, tail])


def ell_adjacency_freq(
    g: CSRGraph,
    *,
    hot_rows: int = None,
    table_bf16: bool = False,
    part_sort: bool = False,
    device=None,
    **kw,
) -> FreqSplitAdj:
    """Split ``g`` by column hotness and tile both sides on ``device`` (the
    card by default, ``device="cpu"`` for the CPU); ``kw`` goes to
    ``ell_adjacency`` for both parts. Rows should be degree-sorted first so
    that the hot columns are the prefix. ``part_sort`` re-sorts each
    part's rows by the part's own degree, and its output then goes through
    an un-permute gather."""
    device = resolve_device(device)
    n, m = g.shape
    if hot_rows is None:
        hot_rows = default_hot_rows(m, table_bf16)
    hot_rows = min(hot_rows, m)
    if hot_rows <= 0:
        raise ValueError("hot_rows must be positive")

    mask = g.indices < hot_rows
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))

    def part(keep, n_cols, shift):
        cnt = np.bincount(rows[keep], minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(cnt, out=indptr[1:])
        csr = CSRGraph(indptr, g.indices[keep] - shift, g.data[keep],
                       (n, n_cols))
        if not part_sort:
            return csr, None
        order = np.argsort(-cnt, kind="stable").astype(np.int64)
        counts = cnt[order]
        indptr2 = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr2[1:])
        ofs = np.arange(csr.nnz, dtype=np.int64) - np.repeat(
            indptr2[:-1], counts)
        src = np.repeat(indptr[order], counts) + ofs
        sorted_csr = CSRGraph(indptr2, csr.indices[src], csr.data[src],
                              (n, n_cols))
        unperm = np.empty(n, dtype=np.int64)
        unperm[order] = np.arange(n, dtype=np.int64)
        return sorted_csr, torch.from_numpy(unperm).to(device)

    def tile(csr):
        return ell_adjacency(csr, symmetric=False, table_bf16=table_bf16,
                             device=device, **kw)

    hot_g, hot_unperm = part(mask, hot_rows, 0)
    hot = tile(hot_g)
    cold = cold_unperm = None
    if hot_rows < m:
        cold_g, cold_unperm = part(~mask, m - hot_rows, hot_rows)
        cold = tile(cold_g)
    return FreqSplitAdj(hot=hot, cold=cold, hot_unperm=hot_unperm,
                        cold_unperm=cold_unperm, hot_rows=hot_rows,
                        n_rows=n, n_cols=m, nnz=g.nnz, hot_nnz=hot_g.nnz)


def spmm_ell_freq(fs: FreqSplitAdj, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x through the two tables: K1 on each part (on a CUDA x),
    differentiable in x through the slices and the un-permute gathers.
    ``x[:H]`` and ``x[H:]`` are views; K1 reads each in place when its
    base and row stride allow, else ``ops/_align.py`` copies it."""
    from gcn_tpu_torch.ops.ell_spmm import spmm_ell

    hot = spmm_ell(fs.hot, x[:fs.hot_rows])
    if fs.hot_unperm is not None:
        hot = hot[fs.hot_unperm]
    if fs.cold is None:
        return hot
    cold = spmm_ell(fs.cold, x[fs.hot_rows:])
    if fs.cold_unperm is not None:
        cold = cold[fs.cold_unperm]
    return hot + cold
