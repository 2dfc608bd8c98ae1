"""ELL SpMM over the packed EllAdj layout: kernel K1 and its autograd.

``ell_spmm`` computes ``out = A @ x`` on the ELL layout of one direction
(``cols``/``vals``/``win``/``win_off``) into the row space ``n_out``:

  * on a CUDA tensor it launches K1, the hand-written kernel in
    ``csrc/ell_spmm.cu`` (built by ``_build.py``), or raises;
  * on a CPU tensor it runs ``_ell_spmm_plain``, the same function in plain
    torch (gather, weight, sum over the P strides, ``index_add_`` of each
    pass-block into its window).

Both take ``gcn_tpu``'s two bf16 options: ``table_bf16`` rounds x to bf16
once per call (K1 then gathers bf16 rows and sums in f32);
``products_bf16`` rounds each pass-block's P-slot sum to bf16 before the
f32 window sum.

K1 replaces ``gcn_tpu/ops/ell_spmm.py::_reduce_kernel`` together with
``_gather_stride_sum`` and the grouped-span reduce: one launch computes the
whole ``_spmm_ell_impl``, whatever branch the TPU path would take. K1 reads
x one 4-element vector at a time; an x it cannot read in place is copied
into zero-padded rows first (``_align.aligned_rows``).

``spmm_ell(adj, x)`` is the differentiable entry (``_SpmmEll``): the forward
runs K1 on the forward arrays then ``_hub_epilogue`` (fold the virtual hub
rows back into real rows); the backward runs K1 on the transpose arrays
then ``_hub_epilogue`` over ``t_virt_map`` (``gcn_tpu``
``ell_spmm.py:362-368``). The edge-weight cotangent (``_ell_sddmm``) is
computed only when autograd asks for it: ``gcn_tpu`` relied on XLA
dead-code elimination for that, and torch has none.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops import _build
from gcn_tpu_torch.ops._align import aligned_rows

# kernel launches of K1; each launch adds one (read by chip_smoke.py), and
# one to the count of its width k (x's column count). These count the
# wrapper's host calls: a call inside a CUDA graph capture counts once, and
# the graph's replays (train/capture.py) launch K1 again without a call
spmm_ell_launches = 0
spmm_ell_launches_by_k = {}

_lib = None


def _kernel_library():
    global _lib
    if _lib is None:
        lib = _build.load_library(
            "gcnellspmm", _build.CUDA_LIBRARIES["gcnellspmm"], "nvcc")
        vp = ctypes.c_void_p
        i32 = ctypes.c_int32
        lib.gcn_ell_spmm.restype = ctypes.c_int
        lib.gcn_ell_spmm.argtypes = [vp, i32, vp, vp, vp, vp, i32, i32, i32,
                                     i32, i32, i32, vp]
        _lib = lib
    return _lib


def _check_operands(x, cols, vals, win_off, n_out):
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    if cols.dim() != 3 or cols.shape != vals.shape:
        raise ValueError("cols/vals must share one (num_blocks, P, R) shape")
    nw = win_off.shape[0] - 1
    if nw * cols.shape[2] < n_out:
        raise ValueError(f"{nw} windows of {cols.shape[2]} rows cannot hold "
                         f"{n_out} output rows")
    for name, t in (("x", x), ("cols", cols), ("vals", vals),
                    ("win_off", win_off)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _ell_spmm_kernel(x, cols, vals, win_off, n_out, products_bf16=False):
    """Launch K1 on the current stream; raises on anything it cannot take
    and on a launch error. x is float32, or bfloat16 for the table_bf16
    variant; its rows must be contiguous, and any other row stride or
    alignment than K1's vector loads take is copied (``aligned_rows``)."""
    global spmm_ell_launches
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("K1 takes float32 or bfloat16 x")
    if vals.dtype != torch.float32:
        raise TypeError("K1 takes float32 vals")
    if cols.dtype != torch.int32 or win_off.dtype != torch.int32:
        raise TypeError("K1 takes int32 cols and win_off")
    for name, t in (("cols", cols), ("vals", vals), ("win_off", win_off)):
        if not t.is_contiguous():
            raise ValueError(f"K1 needs a contiguous {name}")
    r = cols.shape[2]
    if r % 4 or cols.data_ptr() % 16 or vals.data_ptr() % 16:
        raise ValueError("K1 copies cols/vals 16 bytes at a time: R must be "
                         "a multiple of 4 and both arrays 16-byte aligned")
    k = x.shape[1]
    out = torch.empty((n_out, k), dtype=torch.float32, device=x.device)
    if n_out == 0 or k == 0:
        return out
    x, ldx = aligned_rows(x, "K1")
    lib = _kernel_library()
    # the current stream: under a CUDA graph capture, the capturing one
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.gcn_ell_spmm(
        x.data_ptr(), ldx, cols.data_ptr(), vals.data_ptr(),
        win_off.data_ptr(), out.data_ptr(), n_out, r, cols.shape[1], k,
        int(x.dtype == torch.bfloat16), int(products_bf16), stream)
    if rc != 0:
        raise RuntimeError(f"K1 (ell_spmm) launch failed: CUDA error {rc}")
    spmm_ell_launches += 1
    spmm_ell_launches_by_k[k] = spmm_ell_launches_by_k.get(k, 0) + 1
    return out


def _ell_spmm_plain(x, cols, vals, win, win_off, n_out,
                    products_bf16=False):
    """K1's function in plain torch: per pass-block products
    ``sum_j vals[b, j] * x[cols[b, j]]`` (R, k), added into window
    ``win[b]``. ``products_bf16`` rounds each pass-block product to bf16,
    as ``gcn_tpu``'s products_bf16 option does. Float32 for float32
    operands; float64 operands give an exact reference."""
    r = cols.shape[2]
    k = x.shape[1]
    prod = (x[cols] * vals.unsqueeze(-1)).sum(dim=1)          # (nb, r, k)
    if products_bf16:
        prod = prod.to(torch.bfloat16).to(prod.dtype)
    out = torch.zeros((win_off.shape[0] - 1, r, k), dtype=prod.dtype,
                      device=x.device)
    out.index_add_(0, win, prod)
    return out.reshape(-1, k)[:n_out]


def ell_spmm(x, cols, vals, win, win_off, n_out, *, table_bf16=False,
             products_bf16=False):
    """out (n_out, k) = A @ x on one direction of the ELL layout: K1 for a
    CUDA tensor, the plain version for a CPU tensor."""
    _check_operands(x, cols, vals, win_off, n_out)
    if x.is_cuda:
        if table_bf16:
            x = x.to(torch.bfloat16)
        return _ell_spmm_kernel(x, cols, vals, win_off, n_out, products_bf16)
    if table_bf16:
        x = x.to(torch.bfloat16).float()
    return _ell_spmm_plain(x, cols, vals, win, win_off, n_out, products_bf16)


def _hub_epilogue(out_virt, virt_map, n_hub, n_real):
    """Fold virtual hub-chunk rows back into real rows: an ``index_add_``
    over ``virt_map`` (XLA's segment_sum in gcn_tpu) plus an identity
    tail."""
    if n_hub == 0:
        return out_virt
    n_virt_hub = virt_map.shape[0]
    hub = out_virt.new_zeros((n_hub, out_virt.shape[1]))
    hub.index_add_(0, virt_map, out_virt[:n_virt_hub])
    rest = out_virt[n_virt_hub:n_virt_hub + (n_real - n_hub)]
    return torch.cat([hub, rest], dim=0)


def _ell_sddmm(cols, vals, win, g, x, r, n_rows):
    """dvals[b, j, i] = <g[win[b]*r + i], x[cols[b, j, i]]>, 0 at padding
    (``vals == 0``; a stored edge of weight exactly 0.0 is indistinguishable
    from padding and also gets 0, as in gcn_tpu)."""
    nb, _, rr = cols.shape
    k = g.shape[1]
    nw = -(-n_rows // r)
    gpad = g.new_zeros((nw * r, k))
    gpad[:n_rows] = g
    gblk = gpad.reshape(nw, rr, k)[win]                      # (nb, r, k)
    dv = (gblk.unsqueeze(1) * x[cols]).sum(dim=-1)          # (nb, p, r)
    return torch.where(vals != 0, dv, torch.zeros_like(dv))


class _SpmmEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vals, adj):
        ctx.adj = adj
        ctx.save_for_backward(x, vals)
        out = ell_spmm(x, adj.cols, vals, adj.win, adj.win_off,
                       adj.row_space, table_bf16=adj.table_bf16,
                       products_bf16=adj.products_bf16)
        return _hub_epilogue(out, adj.virt_map, adj.n_hub, adj.n_rows)

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        x, vals = ctx.saved_tensors
        g = g.contiguous()
        dx = dvals = None
        if ctx.needs_input_grad[0]:
            dx = ell_spmm(g, adj.t_cols, adj.t_vals, adj.t_win,
                          adj.t_win_off, adj.t_row_space,
                          table_bf16=adj.table_bf16,
                          products_bf16=adj.products_bf16)
            dx = _hub_epilogue(dx, adj.t_virt_map, adj.t_n_hub, adj.n_cols)
        if ctx.needs_input_grad[1]:
            if adj.n_hub:
                # SDDMM rows live in the VIRTUAL row space: expand g
                g = torch.cat([g[adj.virt_map], g[adj.n_hub:]], dim=0)
            dvals = _ell_sddmm(adj.cols, vals, adj.win, g, x, adj.r,
                               adj.row_space)
        return dx, dvals, None


def spmm_ell(adj, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x over the EllAdj format; differentiable in x and in
    ``adj.vals`` (when it requires grad)."""
    return _SpmmEll.apply(x, adj.vals, adj)
