"""Panel SpMM over the PanelAdj layout: kernel K2 and its autograd.

The port of ``gcn_tpu/ops/panel_spmm.py``, which there is the independent
formulation that cross-checks the ELL kernel. It is reached through the
``spmm`` dispatch on a ``PanelAdj`` (``tile/tiler.py::panel_adjacency``),
never through ``device_adjacency``.

``panel_spmm`` computes ``out = A @ x`` on one direction of the layout
(``cols``/``vals``/``local_row``/``row_base``/``win_off`` and the split
``plan``) into ``n_out`` rows:

  * on a CUDA tensor it runs K2, the hand-written kernel in
    ``csrc/panel_spmm.cu`` (built by ``_build.py``), or raises. K2 fuses
    ``gcn_tpu``'s gather of the products (``_gather_products``) into its
    window scatter (``_scatter_kernel``): no products in device memory. One
    SpMM is two kernel launches: the plan's heavy windows, each split
    across a thread block cluster, on a side stream forked from the
    current one, and beside them its light ones; the current stream waits
    for both. It counts once in ``counters["spmm_panel"]``
    (``utils/timers.py``; a host call: the replays of a captured CUDA graph
    launch K2 without one). Under a
    capture the fork and the join are recorded into the graph; the side
    stream, its events and the kernels' shared-memory limit are made at
    the first call, which a captured fit makes in its eager warm-up;
  * on a CPU tensor it runs ``_panel_spmm_plain``, the same function in
    plain torch (products ``x[cols] * vals``, ``index_add_`` into
    ``row_base + local_row``, padding dropped).

K2 computes in f32 throughout, the counterpart of ``HIGHEST``. What
``gcn_tpu`` has here that has no Hopper counterpart is not ported:
``vmem_bytes_needed`` and ``_VMEM_LIMIT`` size the TPU's VMEM, and
``_PRECISION`` picks the MXU pass count.

``spmm_panel(adj, x)`` is the differentiable entry (``_SpmmPanel``): K2 on
the forward arrays into ``n_rows`` rows, and for dX K2 on the transpose
arrays into ``n_cols`` rows. The edge-weight cotangent is plain torch and
computed only when autograd asks for it. Its mask is ``local_row < R``, not
``vals != 0``, so a stored edge of weight 0.0 gets its true cotangent (as
in ``gcn_tpu``, ``panel_spmm.py:163-170``).
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops import _build
from gcn_tpu_torch.ops._align import aligned_rows
from gcn_tpu_torch.tile.format import SPLIT_PARTS
from gcn_tpu_torch.utils.timers import counters

_lib = None


def _kernel_library():
    global _lib
    if _lib is None:
        lib = _build.load_library(
            "gcnpanelspmm", _build.CUDA_LIBRARIES["gcnpanelspmm"], "nvcc")
        vp = ctypes.c_void_p
        i32 = ctypes.c_int32
        lib.gcn_panel_spmm_f32.restype = ctypes.c_int
        lib.gcn_panel_spmm_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32,
                                           vp, i32, vp, i32, i32, i32, i32,
                                           i32, vp]
        _lib = lib
    return _lib


def _check_operands(x, cols, vals, local_row, win_off, r, n_out, plan):
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    if cols.dim() != 2 or cols.shape != vals.shape \
            or cols.shape != local_row.shape:
        raise ValueError("cols/vals/local_row must share one "
                         "(num_blocks, NB) shape")
    nw = win_off.shape[0] - 1
    if nw * r < n_out:
        raise ValueError(f"{nw} windows of {r} rows cannot hold {n_out} "
                         f"output rows")
    heavy, parts, light = plan
    if parts.shape != (heavy.shape[0], SPLIT_PARTS + 1) \
            or heavy.shape[0] + light.shape[0] != nw:
        raise ValueError(f"the split plan must list each of the {nw} "
                         f"windows once, with {SPLIT_PARTS + 1} part "
                         f"offsets for a heavy one")
    for name, t in (("cols", cols), ("vals", vals), ("local_row", local_row),
                    ("win_off", win_off), ("heavy", heavy),
                    ("heavy_parts", parts), ("light", light)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _panel_spmm_kernel(x, cols, vals, local_row, win_off, r, n_out, plan):
    """Run K2 on the current stream: the plan's heavy windows (forked onto
    a side stream) and its light ones. Raises on anything it cannot take
    and on a launch error (also when R is too tall for the window's sum to
    fit shared memory)."""
    if x.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError("K2 takes float32 x and vals")
    heavy, parts, light = plan
    for name, t in (("cols", cols), ("local_row", local_row),
                    ("win_off", win_off), ("heavy", heavy),
                    ("heavy_parts", parts), ("light", light)):
        if t.dtype != torch.int32:
            raise TypeError(f"K2 takes int32 {name}")
    for name, t in (("cols", cols), ("vals", vals), ("local_row", local_row),
                    ("win_off", win_off), ("heavy", heavy),
                    ("heavy_parts", parts), ("light", light)):
        if not t.is_contiguous():
            raise ValueError(f"K2 needs a contiguous {name}")
    k = x.shape[1]
    out = torch.empty((n_out, k), dtype=torch.float32, device=x.device)
    if n_out == 0 or k == 0:
        return out
    x, ldx = aligned_rows(x, "K2")
    lib = _kernel_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.gcn_panel_spmm_f32(
        x.data_ptr(), cols.data_ptr(), vals.data_ptr(), local_row.data_ptr(),
        win_off.data_ptr(), heavy.data_ptr(), parts.data_ptr(),
        heavy.shape[0], light.data_ptr(), light.shape[0], out.data_ptr(),
        n_out, r, cols.shape[1], k, ldx, stream)
    if rc != 0:
        raise RuntimeError(f"K2 (panel_spmm) launch failed: CUDA error {rc}")
    counters["spmm_panel"] += 1
    return out


def _panel_spmm_plain(x, cols, vals, local_row, row_base, r, n_out):
    """K2's function in plain torch: the products ``x[cols] * vals`` of the
    real slots (``local_row < r``) added into rows ``row_base +
    local_row``. Float32 for float32 operands; float64 operands give an
    exact reference."""
    real = local_row < r
    rows = (row_base.unsqueeze(1) + local_row)[real].long()
    prod = x[cols[real].long()] * vals[real].unsqueeze(1)
    out = torch.zeros((n_out, x.shape[1]), dtype=prod.dtype,
                      device=x.device)
    return out.index_add_(0, rows, prod)


def panel_spmm(x, cols, vals, local_row, row_base, win_off, r, n_out, plan):
    """out (n_out, k) = A @ x on one direction of the panel layout: K2 for
    a CUDA tensor, the plain version for a CPU tensor. ``plan`` is the
    direction's split plan, (heavy, heavy_parts, light) (``PanelAdj.plan``
    or ``t_plan``); the plain version does not need it."""
    _check_operands(x, cols, vals, local_row, win_off, r, n_out, plan)
    if x.is_cuda:
        return _panel_spmm_kernel(x, cols, vals, local_row, win_off, r,
                                  n_out, plan)
    return _panel_spmm_plain(x, cols, vals, local_row, row_base, r, n_out)


def _panel_sddmm(adj, g, x):
    """dvals[b, j] = <g[row], x[cols[b, j]]> with row = min(row_base[b] +
    local_row[b, j], n_rows - 1); 0 where ``local_row == R`` (padding)."""
    rows = torch.clamp(adj.row_base.unsqueeze(1) + adj.local_row,
                       max=adj.n_rows - 1).long()
    dv = (g[rows] * x[adj.cols.long()]).sum(dim=-1)
    return torch.where(adj.local_row < adj.r, dv, torch.zeros_like(dv))


class _SpmmPanel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vals, adj):
        ctx.adj = adj
        ctx.save_for_backward(x)
        return panel_spmm(x, adj.cols, vals, adj.local_row, adj.row_base,
                          adj.win_off, adj.r, adj.n_rows, adj.plan)

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        (x,) = ctx.saved_tensors
        g = g.contiguous()
        dx = dvals = None
        if ctx.needs_input_grad[0]:
            dx = panel_spmm(g, adj.t_cols, adj.t_vals, adj.t_local_row,
                            adj.t_row_base, adj.t_win_off, adj.r,
                            adj.n_cols, adj.t_plan).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dvals = _panel_sddmm(adj, g, x).to(adj.vals.dtype)
        return dx, dvals, None


def spmm_panel(adj, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x over the PanelAdj format; differentiable in x and in
    ``adj.vals`` (when it requires grad)."""
    return _SpmmPanel.apply(x, adj.vals, adj)
