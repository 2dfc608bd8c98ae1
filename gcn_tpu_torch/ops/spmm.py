"""SpMM: sparse normalized adjacency x dense features.

One differentiable entry point, ``spmm(adj, x)``, for every representation:

  * ``DenseAdj`` — ``torch.matmul``;
  * ``CooAdj``   — each row's run of edges summed in edge order (gcn_tpu's
    sorted ``segment_sum``; no atomics, so two calls are bit-equal): on a
    CUDA tensor one hand-written kernel (``csrc/coo_spmm.cu``, built by
    ``_build.py``) that gathers, weighs and sums the x rows on chip and
    writes each output row once, or raises; on a CPU tensor the plain
    version, a gather and ``segment_sum``, with which the kernel is
    bit-equal; with the SDDMM edge-weight cotangent
    dvals[e] = <g[row_e], x[col_e]>;
  * ``EllAdj``   — kernel K1 (``ops/ell_spmm.py``);
  * ``FreqSplitAdj`` — K1 on each of its two tables
    (``tile/freq_split.py``);
  * ``PanelAdj`` — kernel K2 (``ops/panel_spmm.py``);
  * ``TwoHopAdj`` — a factored operator A1 @ A2, applied as
    ``spmm(a1, spmm(a2, x))`` over any of the above.

dX = A^T @ g always comes from the stored transpose arrays.

Each COO product counts once in ``utils.timers.counters`` under
``spmm_coo``, on either device; a launch of the kernel also counts under
``spmm_coo_k<k>`` at its width k, so the kernel's share of the products
is the sum of those over ``spmm_coo`` (1 on the card, 0 on the CPU).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from gcn_tpu_torch.ops import _build
from gcn_tpu_torch.ops._align import aligned_rows
from gcn_tpu_torch.ops.adjacency import CooAdj, DenseAdj, segment_lengths
from gcn_tpu_torch.utils.timers import counters

_BY_K = "spmm_coo_k"  # a kernel call at width k counts as "spmm_coo_k<k>"

_lib = None


def segment_sum(prod, row_len):
    """out[r] = the sum of row r's run of ``prod`` rows, the runs laid end
    to end with ``row_len[r]`` rows each (``ops.adjacency.segment_lengths``,
    a tensor on ``prod``'s device); an empty row is 0. Each run is added
    in order, one thread a row and column, with no atomics and no wait for
    the host: the sum is the same from call to call and can be captured
    into a CUDA graph, and on the CPU it is bit-equal to ``index_add_``
    over the same sorted rows."""
    return torch.segment_reduce(prod, "sum", lengths=row_len, axis=0,
                                unsafe=True)


@dataclasses.dataclass(frozen=True)
class RowGather:
    """The indices of a row gather on the device: ``idx``, rows of a table
    of ``row_len.numel()`` rows, and what its backward sums by: ``order``,
    a stable sort of ``idx``, and ``row_len``, each table row's count in
    ``idx`` (``segment_lengths`` of the sorted indices)."""

    idx: torch.Tensor
    order: torch.Tensor
    row_len: torch.Tensor


def row_gather(idx, n_rows, device) -> RowGather:
    """``RowGather`` of the host indices ``idx`` into a table of ``n_rows``
    rows, on ``device``: the sort is made once, on the host. Raises if an
    index is out of range."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    order = np.argsort(idx, kind="stable")
    row_len = segment_lengths(idx[order], n_rows)
    return RowGather(*(torch.as_tensor(a, device=device)
                       for a in (idx, order, row_len)))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, rows):
        ctx.rows = rows
        return table.index_select(0, rows.idx)

    @staticmethod
    def backward(ctx, ct):
        rows = ctx.rows
        return segment_sum(ct.index_select(0, rows.order), rows.row_len), \
            None


def gather_rows(table: torch.Tensor, rows) -> torch.Tensor:
    """``table[idx]`` whose gradient adds each table row's cotangents in
    the order of ``idx`` (``segment_sum`` over the stable sort): no atomics
    and no wait for the host, so it is the same from run to run and can be
    captured into a CUDA graph, and on the CPU it is bit-equal to
    ``index_add_`` of the cotangents. (The backward of ``index_select``,
    ``index_add_``, adds with atomics on the card; that of ``table[idx]``,
    ``index_put_`` with accumulate, across threads on the CPU past 32,768
    elements.) ``rows``: a ``RowGather``, or on the CPU a plain index
    tensor, then sorted at each call; a plain index off the CPU raises (its
    sort would wait for the host at each call: make a ``RowGather`` once
    with ``row_gather``)."""
    if isinstance(rows, torch.Tensor):
        if rows.device.type != "cpu":
            raise ValueError(
                f"gather_rows: a plain index tensor on {rows.device} would "
                f"be sorted on the host at each call; pass a RowGather "
                f"made once by row_gather")
        rows = row_gather(rows.numpy(), table.shape[0], rows.device)
    return _GatherRows.apply(table, rows)


def _kernel_library():
    global _lib
    if _lib is None:
        lib = _build.load_library(
            "gcncoospmm", _build.CUDA_LIBRARIES["gcncoospmm"], "nvcc")
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.gcn_coo_spmm.restype = ctypes.c_int
        lib.gcn_coo_spmm.argtypes = [vp, i64, vp, vp, vp, vp, i64, vp, i64,
                                     ctypes.c_int32, vp]
        _lib = lib
    return _lib


def _coo_spmm_kernel(cols, vals, x, row_ptr, order, long_rows):
    """Launch the COO kernel on the current stream: out[r] = the sum of
    vals[e] * x[cols[e]] over e in [row_ptr[r], row_ptr[r + 1]), in edge
    order, the rows handed out in ``order``, whose first ``long_rows`` are
    long (``adjacency.walk_order``). Raises on anything it cannot take and
    on a launch error. x and vals are float32; an x whose rows are not
    contiguous, or whose row stride or alignment the kernel's 16-byte loads
    cannot take, is copied (``aligned_rows``)."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    if x.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"the COO kernel takes float32 x and vals, got "
                        f"{x.dtype} and {vals.dtype}")
    arrays = (("cols", cols), ("vals", vals), ("row_ptr", row_ptr),
              ("order", order))
    for name, t in arrays:
        if name != "vals" and t.dtype != torch.int64:
            raise TypeError(f"the COO kernel takes int64 {name}")
    for name, t in arrays:
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"the COO kernel needs a contiguous 1-D {name}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    n_out, k = row_ptr.shape[0] - 1, x.shape[1]
    if cols.shape != vals.shape or order.shape != (max(n_out, 0),) \
            or not 0 <= long_rows <= order.shape[0]:
        raise ValueError("cols and vals must hold one entry an edge, order "
                         "one a row, and long_rows count some of them")
    out = torch.empty((n_out, k), dtype=torch.float32, device=x.device)
    if n_out <= 0 or k == 0:
        return out
    if k > 1 and x.stride(1) != 1:
        x = x.contiguous()
    x, ldx = aligned_rows(x, "the COO kernel")
    # the current stream: under a CUDA graph capture, the capturing one
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_library().gcn_coo_spmm(
        x.data_ptr(), ldx, cols.data_ptr(), vals.data_ptr(),
        row_ptr.data_ptr(), order.data_ptr(), long_rows, out.data_ptr(),
        n_out, k, stream)
    if rc != 0:
        raise RuntimeError(f"the COO kernel's launch failed: CUDA error {rc}")
    counters[f"{_BY_K}{k}"] += 1
    return out


def _segment_spmm_plain(cols, vals, x, row_len):
    """The COO product in torch ops: gather, weight, ``segment_sum``."""
    return segment_sum(x[cols] * vals.unsqueeze(1).to(x.dtype), row_len)


def _segment_spmm(adj, vals, x, t=False):
    """out[r] = sum_e [rows[e] == r] vals[e] * x[cols[e]] over the
    row-sorted edges of ``adj`` (its transpose arrays if ``t``), in edge
    order: the kernel for a CUDA x, the plain version for a CPU x; one
    count of ``spmm_coo`` either way."""
    counters["spmm_coo"] += 1
    if t:
        cols, row_len, row_ptr, order, long_rows = (
            adj.t_cols, adj.t_row_len, adj.t_row_ptr, adj.t_row_order,
            adj.t_long_rows)
    else:
        cols, row_len, row_ptr, order, long_rows = (
            adj.cols, adj.row_len, adj.row_ptr, adj.row_order,
            adj.long_rows)
    if x.device.type == "cpu":
        return _segment_spmm_plain(cols, vals, x, row_len)
    return _coo_spmm_kernel(cols, vals, x, row_ptr, order, long_rows)


class _SpmmCoo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vals, adj):
        ctx.adj = adj
        ctx.save_for_backward(x)
        return _segment_spmm(adj, vals, x)

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        (x,) = ctx.saved_tensors
        dx = dvals = None
        if ctx.needs_input_grad[0]:
            dx = _segment_spmm(adj, adj.t_vals, g, t=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dvals = (g[adj.rows] * x[adj.cols]).sum(dim=-1).to(
                adj.vals.dtype)
        return dx, dvals, None


@dataclasses.dataclass(frozen=True)
class TwoHopAdj:
    """Factored operator A = A1 @ A2, applied as two SpMMs.

    The hypergraph operator G factors as (Dv^-1/2 H W De^-1) @
    (H^T Dv^-1/2) (``graph.hypergraph.generate_G_factors``): the factors
    hold ~k entries a hyperedge where G holds ~k^2 a vertex. Each factor
    may be any adjacency representation; rectangular ones carry their own
    transpose arrays for the backward pass. It has no ``k_pad``, so
    ``hoist_spmm`` takes it in 32-column chunks, as gcn_tpu does."""

    a1: object
    a2: object

    @property
    def shape(self):
        return (self.a1.shape[0], self.a2.shape[1])


def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    """Differentiable sparse @ dense: returns ``A @ X`` of shape (m, k)."""
    shape = getattr(adj, "shape", None)
    if shape is not None and x.dim() == 2 and x.shape[0] != shape[1]:
        raise ValueError(
            f"spmm shape mismatch: adjacency is {shape}, features have "
            f"{x.shape[0]} rows (expected {shape[1]})")
    if isinstance(adj, TwoHopAdj):
        return spmm(adj.a1, spmm(adj.a2, x))
    if isinstance(adj, DenseAdj):
        return torch.matmul(adj.mat, x)
    if isinstance(adj, CooAdj):
        return _SpmmCoo.apply(x, adj.vals, adj)
    from gcn_tpu_torch.tile.ell import EllAdj
    from gcn_tpu_torch.tile.format import PanelAdj
    from gcn_tpu_torch.tile.freq_split import FreqSplitAdj

    if isinstance(adj, EllAdj):
        from gcn_tpu_torch.ops.ell_spmm import spmm_ell

        return spmm_ell(adj, x)
    if isinstance(adj, FreqSplitAdj):
        from gcn_tpu_torch.tile.freq_split import spmm_ell_freq

        return spmm_ell_freq(adj, x)
    if isinstance(adj, PanelAdj):
        from gcn_tpu_torch.ops.panel_spmm import spmm_panel

        return spmm_panel(adj, x)
    raise TypeError(f"unsupported adjacency representation: {type(adj)}")


def hoist_spmm(adj, x: torch.Tensor, chunk: int = None) -> torch.Tensor:
    """Aggregate ``A @ x`` once, in column chunks of ``chunk`` (the
    adjacency's k_pad by default): the training-invariant layer-1 A@X."""
    if chunk is None:
        chunk = getattr(adj, "k_pad", 32)
    with torch.no_grad():
        parts = [spmm(adj, x[:, c:c + chunk].contiguous())
                 for c in range(0, x.shape[1], chunk)]
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
