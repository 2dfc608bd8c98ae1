"""Per-channel softmax aggregation over a graph's rows: the SoftMax_Agg of
DeeperGCN's GENConv (Li et al., arXiv:2006.07739, section 3.1), in the
stop-gradient form its ogbn-arxiv run trains (``softmax_sg``).

One differentiable entry point, ``softmax_aggregate(layout, m, t)``:

    alpha[v, u, c] = softmax_u(t m[u, c])        over u in N(v), per channel
    a[v, c]        = sum_u alpha[v, u, c] m[u, c]

with ``m`` (n, k) and ``layout`` a ``GatLayout`` of A + I
(``ops/gat_attn.py``). ``t`` is fixed and gets no gradient, and alpha is
held constant in the backward, as ``GENConv.aggregate`` computes it under
``torch.no_grad()``: the gradient reaches ``m`` through the value factor
only, ``dm[u, c] = sum_v alpha[v, u, c] da[v, c]``.

On a CUDA tensor it runs the hand-written kernels of
``csrc/softmax_agg.cu`` (built by ``_build.py``): one walk of the rows
with an online softmax per channel, which keeps each row's logsumexp for
the backward when ``m`` needs a gradient, and one walk of the transpose
rows that recomputes each weight from it; float32 only, k a multiple of 4
up to 256 (anything else raises). On a CPU tensor it runs the plain
version in torch ops (gather, ``segment_reduce`` max, exp,
``segment_sum``), alpha computed under ``torch.no_grad()``, differentiated
by autograd. There is no switch and no fallback.

Each call (forward or backward) counts once in ``utils.timers.counters``
under ``softmax_agg``, on either device; a call through the kernels also
counts under ``softmax_agg_k<k>``, so the kernels' share of the calls is
the sum of those over ``softmax_agg`` (1 on the card, 0 on the CPU).
"""

from __future__ import annotations

import ctypes

import torch

from gcn_tpu_torch.ops import _build
from gcn_tpu_torch.ops.gat_attn import GatLayout, _CountBackward
from gcn_tpu_torch.ops.spmm import segment_sum
from gcn_tpu_torch.utils.timers import counters

_BY_WIDTH = "softmax_agg_k{}"  # a call through the kernels, by width
MAX_WIDTH = 256

_lib = None


def _softmax_aggregate_plain(layout: GatLayout, m: torch.Tensor,
                             t: float) -> torch.Tensor:
    """The aggregation in torch ops: the rows of ``m`` gathered at each
    edge, each row's per-channel softmax of ``t`` times them by
    ``segment_reduce`` (max, then sum) under ``no_grad``, the weighted rows
    summed by ``segment_sum``. ``index_select`` gathers, whose backward on
    the CPU adds in order."""
    rows, row_len = layout.rows, layout.row_len
    g = m.index_select(0, layout.cols)                       # (E, k)
    with torch.no_grad():
        s = t * g
        top = torch.segment_reduce(s, "max", lengths=row_len, axis=0,
                                   unsafe=True)
        p = torch.exp(s - top.index_select(0, rows))
        alpha = p / segment_sum(p, row_len).index_select(0, rows)
    return segment_sum(alpha * g, row_len)


def _kernel_library():
    global _lib
    if _lib is None:
        lib = _build.load_library(
            "gcnsoftmaxagg", _build.CUDA_LIBRARIES["gcnsoftmaxagg"], "nvcc")
        vp, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_int32, ctypes.c_float)
        lib.gcn_softmax_agg_fwd.restype = ctypes.c_int
        lib.gcn_softmax_agg_fwd.argtypes = [vp, vp, vp, vp, i64, vp, vp,
                                            i64, i32, f32, vp]
        lib.gcn_softmax_agg_bwd.restype = ctypes.c_int
        lib.gcn_softmax_agg_bwd.argtypes = [vp, vp, vp, vp, vp, vp, i64, vp,
                                            i64, i32, f32, vp]
        _lib = lib
    return _lib


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"the softmax aggregation's {what} kernel failed "
                           f"to launch: CUDA error {rc}")


def _aligned(t):
    """``t`` contiguous and 16-byte aligned, as the kernels read it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(layout, m, t, keep_lse):
    """(a, lse or None) through the forward kernel."""
    n, k = m.shape
    out = torch.empty_like(m)
    lse = torch.empty_like(m) if keep_lse else None
    stream = torch.cuda.current_stream(m.device).cuda_stream
    _check(_kernel_library().gcn_softmax_agg_fwd(
        m.data_ptr(), layout.cols.data_ptr(), layout.row_ptr.data_ptr(),
        layout.row_order.data_ptr(), layout.long_rows, out.data_ptr(),
        None if lse is None else lse.data_ptr(), n, k, t, stream), "forward")
    counters[_BY_WIDTH.format(k)] += 1
    return out, lse


def _backward(layout, m, lse, da, t):
    """dm through the backward kernel: ``da`` weighted by the forward's
    softmax, recomputed from ``lse``, summed over each row's in-edges."""
    n, k = m.shape
    da = _aligned(da)
    dm = torch.empty_like(m)
    stream = torch.cuda.current_stream(m.device).cuda_stream
    _check(_kernel_library().gcn_softmax_agg_bwd(
        m.data_ptr(), lse.data_ptr(), da.data_ptr(),
        layout.t_cols.data_ptr(), layout.t_row_ptr.data_ptr(),
        layout.t_row_order.data_ptr(), layout.t_long_rows, dm.data_ptr(), n,
        k, t, stream), "backward")
    counters[_BY_WIDTH.format(k)] += 1
    return dm


class _SoftmaxAggKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, layout, t):
        out, lse = _forward(layout, m, t, keep_lse=True)
        ctx.layout, ctx.t = layout, t
        ctx.save_for_backward(m, lse)
        return out

    @staticmethod
    def backward(ctx, da):
        counters["softmax_agg"] += 1
        m, lse = ctx.saved_tensors
        return _backward(ctx.layout, m, lse, da, ctx.t), None, None


def _check_operands(layout, m):
    if m.dim() != 2 or m.shape[0] != layout.n:
        raise ValueError(f"m {tuple(m.shape)} does not fit a layout of "
                         f"{layout.n} rows")
    if layout.cols.device != m.device:
        raise ValueError(f"the layout is on {layout.cols.device}, m on "
                         f"{m.device}")
    if m.is_cuda:
        k = m.shape[1]
        if m.dtype != torch.float32:
            raise TypeError(f"the softmax aggregation's kernels take "
                            f"float32, got {m.dtype}")
        if k % 4 or not 0 < k <= MAX_WIDTH:
            raise ValueError(f"the softmax aggregation's kernels take a "
                             f"width that is a multiple of 4 up to "
                             f"{MAX_WIDTH}, got {k}")


def softmax_aggregate(layout: GatLayout, m: torch.Tensor,
                      t: float) -> torch.Tensor:
    """a (n, k): each row's per-channel softmax over its edges of ``t``
    times the source rows of ``m``, weighting those rows; the weights get
    no gradient. The kernels for CUDA tensors, the plain version for CPU
    ones."""
    _check_operands(layout, m)
    t = float(t)
    counters["softmax_agg"] += 1
    if m.device.type == "cpu":
        return _CountBackward.apply(_softmax_aggregate_plain(layout, m, t),
                                    "softmax_agg")
    m = _aligned(m)
    if torch.is_grad_enabled() and m.requires_grad:
        return _SoftmaxAggKernel.apply(m, layout, t)
    # an evaluation forward keeps no logsumexp
    return _forward(layout, m, t, keep_lse=False)[0]
