"""ELL SpMM over the packed EllAdj layout: kernel K1 and its autograd.

``ell_spmm`` computes ``out = A @ x`` on the ELL layout of one direction
(``cols``/``vals``/``win``/``win_off``) into the row space ``n_out``:

  * on a CUDA tensor it launches K1, the hand-written kernel in
    ``csrc/ell_spmm.cu`` (built by ``_build.py``), or raises. K1 shares the
    windows' walks out by the direction's walk split ``plan``
    (``tile/ell.py::walk_split``, ``EllAdj.split`` / ``t_split``): the
    light windows in one launch, and the heavy ones, each cut across a
    thread block cluster, in a second launch on a side stream forked from
    the current one; the current stream waits for both. Without a plan
    ``ell_spmm`` makes it from ``win_off`` on the host, which reads
    ``win_off`` back (a synchronisation), and so raises under a CUDA graph
    capture;
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
rows back into real rows, in a fixed order); the backward runs K1 on the
transpose arrays then ``_hub_epilogue`` over ``t_virt_map`` (``gcn_tpu``
``ell_spmm.py:362-368``). The edge-weight cotangent (``_ell_sddmm``) is
computed only when autograd asks for it: ``gcn_tpu`` relied on XLA
dead-code elimination for that, and torch has none.
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops import _build
from gcn_tpu_torch.ops._align import aligned_rows
from gcn_tpu_torch.tile.ell import walk_split
from gcn_tpu_torch.utils.timers import counters

MAX_SPLIT_PARTS = 16  # K1's largest cluster (non-portable above 8)
_BY_K = "spmm_ell_k"  # K1's calls at width k count as "spmm_ell_k<k>"

_lib = None


def _kernel_library():
    global _lib
    if _lib is None:
        lib = _build.load_library(
            "gcnellspmm", _build.CUDA_LIBRARIES["gcnellspmm"], "nvcc")
        vp = ctypes.c_void_p
        i32 = ctypes.c_int32
        lib.gcn_ell_spmm.restype = ctypes.c_int
        lib.gcn_ell_spmm.argtypes = [vp, i32, vp, vp, vp, vp, vp, i32, i32,
                                     vp, i32, vp, i32, i32, i32, i32, i32,
                                     i32, vp]
        lib.gcn_ell_max_clusters.restype = ctypes.c_int
        lib.gcn_ell_max_clusters.argtypes = [i32, i32, i32]
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


def max_clusters(n_parts, r=128, p=4):
    """How many clusters of ``n_parts`` thread blocks of K1's heavy-window
    kernel the current card holds at once (``cudaOccupancyMaxActiveClusters``
    at rows of ``r`` and pass-blocks of ``p`` slots); 0 when none fit.
    Builds K1 on first use; on the card only."""
    n = _kernel_library().gcn_ell_max_clusters(n_parts, r, p)
    if n < 0:
        raise RuntimeError(f"K1 occupancy query failed: CUDA error {-n}")
    return n


def _plan_of(win_off, p, plan, device):
    """The walk split plan's (heavy, parts, light): those of ``plan`` (a
    ``WalkSplit``), or of one made from ``win_off`` (pass-blocks of ``p``
    slots) on the host for ``device`` when it is None, outside a CUDA graph
    capture."""
    if plan is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "K1 needs its walk split plan under a CUDA graph capture "
                "(making one reads win_off back to the host): pass plan= "
                "(EllAdj.split / t_split)")
        plan = walk_split(win_off.cpu().numpy(), p, device)
    return plan.heavy, plan.parts, plan.light


def _ell_spmm_kernel(x, cols, vals, win_off, n_out, products_bf16=False,
                     plan=None):
    """Launch K1 on the current stream, its heavy windows on a side stream
    forked from it; raises on anything it cannot take and on a launch
    error. x is float32, or bfloat16 for the table_bf16 variant; its rows
    must be contiguous, and any other row stride or alignment than K1's
    vector loads take is copied (``aligned_rows``). ``plan``: the walk
    split plan of ``win_off`` (``_plan_of``)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("K1 takes float32 or bfloat16 x")
    if vals.dtype != torch.float32:
        raise TypeError("K1 takes float32 vals")
    heavy, parts, light = _plan_of(win_off, cols.shape[1], plan, x.device)
    for name, t in (("cols", cols), ("win_off", win_off), ("heavy", heavy),
                    ("parts", parts), ("light", light)):
        if t.dtype != torch.int32:
            raise TypeError(f"K1 takes int32 {name}")
    for name, t in (("cols", cols), ("vals", vals), ("win_off", win_off),
                    ("heavy", heavy), ("parts", parts), ("light", light)):
        if not t.is_contiguous():
            raise ValueError(f"K1 needs a contiguous {name}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    nw = win_off.shape[0] - 1
    if (parts.dim() != 2 or parts.shape[0] != heavy.shape[0]
            or not 2 <= parts.shape[1] <= MAX_SPLIT_PARTS + 1
            or heavy.shape[0] + light.shape[0] != nw):
        raise ValueError(f"the walk split plan must list each of the {nw} "
                         f"windows once, with 2 to {MAX_SPLIT_PARTS + 1} "
                         f"part offsets for a heavy one")
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
        win_off.data_ptr(), heavy.data_ptr(), parts.data_ptr(),
        heavy.shape[0], parts.shape[1] - 1, light.data_ptr(), light.shape[0],
        out.data_ptr(), n_out, r, cols.shape[1], k,
        int(x.dtype == torch.bfloat16), int(products_bf16), stream)
    if rc != 0:
        raise RuntimeError(f"K1 (ell_spmm) launch failed: CUDA error {rc}")
    # a host call of one or two kernel launches (``WalkSplit.launches``);
    # a captured graph's replays launch K1 again without one
    counters["spmm_ell"] += 1
    counters[f"{_BY_K}{k}"] += 1
    return out


def calls_by_k(counts) -> dict:
    """K1's calls by width k in ``counts`` (``utils.timers.counters``, or
    a span's ``counts``), in order of k."""
    return dict(sorted((int(name[len(_BY_K):]), n)
                       for name, n in counts.items()
                       if name.startswith(_BY_K)))


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


def _ell_spmm_plain_split(x, cols, vals, win_off, plan, n_out,
                          products_bf16=False):
    """K1's function as the walk split plan shares it out, in plain torch:
    each light window's pass-blocks and each heavy window's part summed
    apart (the pass-block products as ``_ell_spmm_plain`` takes them), then
    a heavy window's part sums added in rank order (``index_add_``'s order
    on the CPU; on the card it adds atomically). ``plan`` is a
    ``WalkSplit`` on any device. Equal to
    ``_ell_spmm_plain`` up to reassociation when the plan covers each
    pass-block once; a check of the plan, not a kernel's version."""
    heavy, parts, light = (t.cpu().long() for t in _plan_of(
        win_off, cols.shape[1], plan, x.device))
    off = win_off.cpu().long()
    nw, r, k = off.shape[0] - 1, cols.shape[2], x.shape[1]
    prod = (x[cols] * vals.unsqueeze(-1)).sum(dim=1)          # (nb, r, k)
    if products_bf16:
        prod = prod.to(torch.bfloat16).to(prod.dtype)
    # segment of each pass-block: a light window, or one part of a heavy
    # one; segments of a window are numbered in rank order
    seg_of_block = torch.full((prod.shape[0],), -1, dtype=torch.long)
    seg_win = []
    for w in light.tolist():
        seg_of_block[off[w]:off[w + 1]] = len(seg_win)
        seg_win.append(w)
    for h, w in enumerate(heavy.tolist()):
        for q in range(parts.shape[1] - 1):
            lo, hi = (off[w] + parts[h, q:q + 2]).tolist()
            seg_of_block[lo:hi] = len(seg_win)
            seg_win.append(w)
    seg = seg_of_block.to(x.device)
    sums = torch.zeros((len(seg_win), r, k), dtype=prod.dtype,
                       device=x.device)
    sums.index_add_(0, seg[seg >= 0], prod[seg >= 0])
    out = torch.zeros((nw, r, k), dtype=prod.dtype, device=x.device)
    out.index_add_(0, torch.tensor(seg_win, device=x.device), sums)
    return out.reshape(-1, k)[:n_out]


def ell_spmm(x, cols, vals, win, win_off, n_out, *, table_bf16=False,
             products_bf16=False, plan=None):
    """out (n_out, k) = A @ x on one direction of the ELL layout: K1 for a
    CUDA tensor, shared out by the walk split ``plan`` (a ``WalkSplit``,
    made from ``win_off`` when None, outside a capture), the plain version
    for a CPU tensor (which needs no plan)."""
    _check_operands(x, cols, vals, win_off, n_out)
    if x.is_cuda:
        if table_bf16:
            x = x.to(torch.bfloat16)
        return _ell_spmm_kernel(x, cols, vals, win_off, n_out, products_bf16,
                                plan)
    if table_bf16:
        x = x.to(torch.bfloat16).float()
    return _ell_spmm_plain(x, cols, vals, win, win_off, n_out, products_bf16)


def _hub_epilogue(out_virt, adj, t=False):
    """Fold virtual hub-chunk rows back into real rows (gcn_tpu's sorted
    ``segment_sum`` over ``virt_map``) plus an identity tail; ``t`` folds
    the transpose's (``t_virt_map``).

    The fold follows ``adj.hub_steps`` (``tile.ell.hub_fold_plan``): one
    gather of the chunks the steps read (with a zero row appended when the
    plan reads one), then one add a step, so each hub adds its chunks in
    chunk order, ``((0 + c0) + c1) + ...``. Its result does not depend on
    the device's scheduling (``index_add_`` adds with atomics on CUDA, in
    an order that changes from run to run), equals ``index_add_``'s on the
    CPU bit for bit, and it has no host synchronisation or data-dependent
    shape, so it runs inside a captured CUDA graph. The hub sums are
    written over the last ``n_hub`` chunk rows of ``out_virt`` (read
    before, by the gather), so the result is a view of ``out_virt`` that
    ends in its identity tail, with no copy of that tail."""
    n_hub, virt_map = (adj.t_n_hub, adj.t_virt_map) if t else (
        adj.n_hub, adj.virt_map)
    if n_hub == 0:
        return out_virt
    idx, steps = (adj.t_hub_idx, adj.t_hub_steps) if t else (
        adj.hub_idx, adj.hub_steps)
    n_real = adj.n_cols if t else adj.n_rows
    n_virt_hub = virt_map.shape[0]
    chunks = out_virt[:n_virt_hub]
    if sum(steps) > n_virt_hub:       # some step reads the zero row
        chunks = torch.nn.functional.pad(chunks, (0, 0, 0, 1))
    parts = chunks.index_select(0, idx)
    first = n_virt_hub - n_hub
    hub = out_virt[first:n_virt_hub]
    torch.add(parts[:n_hub], 0.0, out=hub)
    at = n_hub
    for h in steps[1:]:
        hub[:h] += parts[at:at + h]
        at += h
    return out_virt[first:first + n_real]


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
                       products_bf16=adj.products_bf16, plan=adj.split)
        return _hub_epilogue(out, adj)

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
                          products_bf16=adj.products_bf16, plan=adj.t_split)
            dx = _hub_epilogue(dx, adj, t=True)
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
