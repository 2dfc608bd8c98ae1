"""Device-side adjacency representations.

The host currency is ``gcn_tpu_torch.graph.CSRGraph`` (numpy). Before
training it is lowered onto a device as one of:

  * ``DenseAdj`` — a dense matrix; SpMM is ``torch.matmul``.
  * ``CooAdj``   — row-sorted COO padded to EDGE_PAD, with each row's edge
    count and offsets; SpMM sums each row's run of edges in edge order:
    on the card in one hand-written kernel (``ops/csrc/coo_spmm.cu``), on
    the CPU as a gather and ``segment_sum`` (in ``gcn_tpu`` this path is
    XLA's sorted ``segment_sum``, not a Pallas kernel).
  * ``EllAdj``   — the packed ELL layout of ``gcn_tpu_torch.tile.ell``,
    whose SpMM is the hand-written kernel K1 (``ops/ell_spmm.py``);
  * ``FreqSplitAdj`` — two such layouts, a hot column prefix and a cold
    tail (``gcn_tpu_torch.tile.freq_split``), with ``freq_split=True``.

The panel layout (``PanelAdj``, kernel K2) is built only by
``gcn_tpu_torch.tile.panel_adjacency``, as in ``gcn_tpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.utils.device import resolve_device

# Pad edge counts to a multiple of this, as gcn_tpu does.
EDGE_PAD = 1024
# A row of more edges than this is long: the card's COO kernel
# (ops/csrc/coo_spmm.cu) gives it a whole thread block, a shorter row a few
# lanes of a warp.
LONG_ROW = 256


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    if x.shape[0] == size:
        return x
    out = np.full((size,), fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def segment_lengths(rows: np.ndarray, n_rows: int) -> np.ndarray:
    """Each row's edge count (int64[n_rows]) over row-sorted ``rows``: the
    plan of the segment sum (``ops/spmm.py::segment_sum``), which adds
    each row's run of edges in edge order. Raises unless ``rows`` is
    sorted and in range, since the runs are read off in order (gcn_tpu's
    ``indices_are_sorted=True``)."""
    rows = np.asarray(rows)
    if (np.diff(rows) < 0).any():
        raise ValueError("segment_lengths needs row-sorted edges")
    if rows.size and (rows[0] < 0 or rows[-1] >= n_rows):
        raise ValueError(f"row index out of range [0, {n_rows})")
    return np.bincount(rows, minlength=n_rows).astype(np.int64)


def walk_order(row_len: np.ndarray):
    """(rows by edge count, longest first, ties in row order; how many of
    them are long, with more than ``LONG_ROW`` edges): the order in which
    the card's COO kernel hands the rows out, so that no long walk starts
    last. It does not change the order in which a row's edges are added."""
    order = np.argsort(-np.asarray(row_len), kind="stable")
    return order, int((np.asarray(row_len) > LONG_ROW).sum())


@dataclasses.dataclass(frozen=True)
class CooAdj:
    """Row-sorted COO adjacency, padded to EDGE_PAD with ``vals == 0`` and
    in-range indices (last row / column 0). ``t_*`` hold the transpose,
    aliased when symmetric. ``row_len`` / ``t_row_len`` are each
    direction's row edge counts (``segment_lengths``), which the CPU's
    SpMM sums by; ``row_ptr`` / ``t_row_ptr`` their exclusive cumulative
    sums (length rows + 1: row r's run of edges is ``[row_ptr[r],
    row_ptr[r + 1])``), which the card's kernel walks by, handing the rows
    out in the order of ``row_order`` / ``t_row_order`` (longest first,
    ``walk_order``), whose first ``long_rows`` / ``t_long_rows`` rows hold
    more than ``LONG_ROW`` edges."""

    rows: torch.Tensor  # int64[E_pad]
    cols: torch.Tensor  # int64[E_pad]
    vals: torch.Tensor  # float32[E_pad]
    t_rows: torch.Tensor
    t_cols: torch.Tensor
    t_vals: torch.Tensor
    n_rows: int
    n_cols: int
    nnz: int
    symmetric: bool
    row_len: torch.Tensor    # int64[n_rows]
    t_row_len: torch.Tensor  # int64[n_cols]
    row_ptr: torch.Tensor    # int64[n_rows + 1]
    t_row_ptr: torch.Tensor  # int64[n_cols + 1]
    row_order: torch.Tensor  # int64[n_rows]
    t_row_order: torch.Tensor  # int64[n_cols]
    long_rows: int
    t_long_rows: int

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)


@dataclasses.dataclass(frozen=True)
class DenseAdj:
    """Dense adjacency (small graphs); SpMM is a plain matmul."""

    mat: torch.Tensor
    nnz: int

    @property
    def n_rows(self):
        return self.mat.shape[0]

    @property
    def n_cols(self):
        return self.mat.shape[1]

    @property
    def shape(self):
        return tuple(self.mat.shape)


def _coo_arrays(g: CSRGraph, pad_to: Optional[int] = None):
    rows, cols, vals = g.to_coo()  # row-major, cols ascending
    e = rows.shape[0]
    e_pad = pad_to if pad_to is not None else max(
        EDGE_PAD, -(-e // EDGE_PAD) * EDGE_PAD)
    pad_row = max(g.shape[0] - 1, 0)
    rows = _pad_to(rows.astype(np.int64), e_pad, pad_row)
    cols = _pad_to(cols.astype(np.int64), e_pad, 0)
    vals = _pad_to(vals.astype(np.float32), e_pad, 0.0)
    return rows, cols, vals, e


def coo_adjacency(g: CSRGraph, *, symmetric: Optional[bool] = None,
                  device=None) -> CooAdj:
    """Row-sorted COO on ``device``: the card by default
    (``utils.device.resolve_device``), ``device="cpu"`` for the CPU; with
    each direction's row edge counts (``segment_lengths``), offsets and
    walk order (``walk_order``), made here on the host so that the SpMM
    never waits for them."""
    device = resolve_device(device)
    if symmetric is None:
        symmetric = g.shape[0] == g.shape[1] and g.is_symmetric()

    def upload(rows, cols, vals, n_rows):
        row_len = segment_lengths(rows, n_rows)
        row_ptr = np.concatenate([[0], np.cumsum(row_len)])
        order, n_long = walk_order(row_len)
        return [torch.from_numpy(a).to(device)
                for a in (rows, cols, vals, row_len, row_ptr, order)] + [
                    n_long]

    rows, cols, vals, e = _coo_arrays(g)
    fwd = upload(rows, cols, vals, g.shape[0])
    if symmetric:
        bwd = fwd
    else:
        tr, tc, tv, _ = _coo_arrays(g.transpose(), pad_to=rows.shape[0])
        bwd = upload(tr, tc, tv, g.shape[1])
    return CooAdj(*fwd[:3], *bwd[:3], n_rows=g.shape[0], n_cols=g.shape[1],
                  nnz=e, symmetric=bool(symmetric), row_len=fwd[3],
                  t_row_len=bwd[3], row_ptr=fwd[4], t_row_ptr=bwd[4],
                  row_order=fwd[5], t_row_order=bwd[5], long_rows=fwd[6],
                  t_long_rows=bwd[6])


def dense_adjacency(g: CSRGraph, device=None) -> DenseAdj:
    """The dense matrix on ``device`` (the card by default)."""
    device = resolve_device(device)
    return DenseAdj(mat=torch.from_numpy(g.to_dense()).to(device),
                    nnz=g.nnz)


def device_adjacency(g: CSRGraph, kind: str = "auto", device=None,
                     **kwargs):
    """Lower a host CSRGraph to a device representation on ``device``: the
    card by default (``utils.device.resolve_device``), ``device="cpu"`` for
    the CPU.

    kind: "dense" | "coo" | "ell" | "auto" ("auto" picks dense up to an
    8192x8192-equivalent area, coo beyond it, as gcn_tpu does).
    ``freq_split=True`` (kind "ell" only) builds the frequency-split
    two-table form (``tile/freq_split.py``); its parts are rectangular, so
    the ``symmetric`` option does not apply to it.
    """
    if kind == "auto":
        kind = "dense" if g.shape[0] * g.shape[1] <= 8192 ** 2 else "coo"
    freq_split = kwargs.pop("freq_split", False)
    if freq_split and kind != "ell":
        raise ValueError(
            f"freq_split requires kind='ell' (resolved kind is {kind!r})")
    if kind == "dense":
        return dense_adjacency(g, device=device)
    if kind == "coo":
        return coo_adjacency(g, device=device, **kwargs)
    if kind == "ell":
        if freq_split:
            from gcn_tpu_torch.tile.freq_split import ell_adjacency_freq

            kwargs.pop("symmetric", None)
            return ell_adjacency_freq(g, device=device, **kwargs)
        from gcn_tpu_torch.tile.ell import ell_adjacency

        return ell_adjacency(g, device=device, **kwargs)
    if kind == "panel":
        raise ValueError(
            "'panel' is a test-side reference implementation only; use "
            "'ell' (or build via gcn_tpu_torch.tile.panel_adjacency "
            "directly)")
    raise ValueError(f"unknown adjacency kind: {kind!r}")
