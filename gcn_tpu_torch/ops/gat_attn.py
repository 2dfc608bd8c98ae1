"""Multi-head edge-softmax attention over a graph's rows: the aggregation
of a GAT layer (Velickovic et al., arXiv:1710.10903, section 2.1).

One differentiable entry point, ``gat_attention(layout, wh, el, er)``:

    s_ij      = er[i, h] + el[j, h]                 over j in N(i)
    alpha_ij  = softmax_j(LeakyReLU(s_ij))          per row i and head h
    out[i, h] = sum_j alpha_ij wh[j, h]

with ``wh`` (n, H, F), ``el`` and ``er`` (n, H): each vertex's source and
destination scores, ``Wh . a_src`` and ``Wh . a_dst``. On a CUDA tensor
it runs the hand-written kernels of ``csrc/gat_attn.cu`` (built by
``_build.py``): one pass over the rows with an online softmax, and a
backward that walks the transpose; float32 only, anything else raises. On
a CPU tensor it runs the plain version in torch ops (gather,
``segment_reduce`` max, exp, ``segment_sum``, weight, ``segment_sum``),
differentiated by autograd. There is no switch and no fallback.

Its layout, ``GatLayout``, is made once by ``gat_layout`` from a
``CooAdj`` of A + I (``ops/adjacency.py``): the real edges only, so that
``CooAdj``'s padding edges, which close its last row's run, never enter a
softmax; each direction's row offsets and longest-first walk order; and
the transpose's map to each edge's forward position, which the backward
reads and writes the forward's per-edge values through.

Each call (forward or backward) counts once in ``utils.timers.counters``
under ``gat_attn``, on either device; a call through the kernels also
counts under ``gat_attn_h<H>_f<F>`` at its heads and width, so the
kernels' share of the calls is the sum of those over ``gat_attn`` (1 on
the card, 0 on the CPU).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from gcn_tpu_torch.ops import _build
from gcn_tpu_torch.ops.adjacency import CooAdj, segment_lengths, walk_order
from gcn_tpu_torch.ops.spmm import segment_sum
from gcn_tpu_torch.utils.timers import counters

_BY_SHAPE = "gat_attn_h{}_f{}"  # a call through the kernels, by (H, F)

_lib = None


@dataclasses.dataclass(frozen=True)
class GatLayout:
    """The edges of A + I as the attention walks them, on one device.

    Forward: ``rows`` / ``cols`` (int64[nnz]) sorted by row, row i's run
    ``[row_ptr[i], row_ptr[i + 1])`` (``row_len`` its counts), the rows
    handed out in ``row_order`` (longest first, ``walk_order``), whose
    first ``long_rows`` hold more than ``adjacency.LONG_ROW`` edges.
    Transpose: ``t_cols`` (int64[nnz]) the destination row i of each edge
    grouped by its source j, in row order within a source, ``t_edge`` its
    position in the forward arrays, and ``t_row_ptr``, ``t_row_order``,
    ``t_long_rows`` as above. No padding edge lies in any run."""

    rows: torch.Tensor
    cols: torch.Tensor
    row_len: torch.Tensor
    row_ptr: torch.Tensor
    row_order: torch.Tensor
    long_rows: int
    t_cols: torch.Tensor
    t_edge: torch.Tensor
    t_row_ptr: torch.Tensor
    t_row_order: torch.Tensor
    t_long_rows: int
    n: int
    nnz: int


def gat_layout(adj: CooAdj) -> GatLayout:
    """The attention's layout of ``adj`` (a square ``CooAdj`` of A + I),
    made on the host and uploaded to ``adj``'s device. The edge weights
    are not read: the attention computes its own."""
    if adj.n_rows != adj.n_cols:
        raise ValueError(f"attention needs a square adjacency, got "
                         f"{adj.shape}")
    n, e = adj.n_rows, adj.nnz
    rows = adj.rows[:e].cpu().numpy()
    cols = adj.cols[:e].cpu().numpy()
    t_edge = np.argsort(cols, kind="stable")   # by source, rows in order

    def direction(keys):
        row_len = segment_lengths(keys, n)
        order, n_long = walk_order(row_len)
        return row_len, np.concatenate([[0], np.cumsum(row_len)]), order, \
            n_long

    fwd, bwd = direction(rows), direction(cols[t_edge])

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            adj.rows.device)

    return GatLayout(rows=up(rows), cols=up(cols), row_len=up(fwd[0]),
                     row_ptr=up(fwd[1]), row_order=up(fwd[2]),
                     long_rows=fwd[3], t_cols=up(rows[t_edge]),
                     t_edge=up(t_edge), t_row_ptr=up(bwd[1]),
                     t_row_order=up(bwd[2]), t_long_rows=bwd[3], n=n,
                     nnz=e)


def _gat_attention_plain(layout, wh, el, er, negative_slope):
    """The attention in torch ops: the scores gathered at each edge, each
    row's softmax by ``segment_reduce`` (max, then sum), the rows of
    ``wh`` gathered, weighted and summed by ``segment_sum``. ``index_select``
    gathers, whose backward on the CPU adds in order."""
    rows, cols, row_len = layout.rows, layout.cols, layout.row_len
    s = er.index_select(0, rows) + el.index_select(0, cols)     # (E, H)
    e = torch.nn.functional.leaky_relu(s, negative_slope)
    top = torch.segment_reduce(e.detach(), "max", lengths=row_len, axis=0,
                               unsafe=True)
    p = torch.exp(e - top.index_select(0, rows))
    alpha = p / segment_sum(p, row_len).index_select(0, rows)
    return segment_sum(wh.index_select(0, cols) * alpha.unsqueeze(-1),
                       row_len)


def _kernel_library():
    global _lib
    if _lib is None:
        lib = _build.load_library(
            "gcngatattn", _build.CUDA_LIBRARIES["gcngatattn"], "nvcc")
        vp, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_int32, ctypes.c_float)
        lib.gcn_gat_attn_fwd.restype = ctypes.c_int
        lib.gcn_gat_attn_fwd.argtypes = [vp, vp, vp, vp, vp, vp, i64, vp,
                                         vp, i64, i32, i32, f32, vp]
        lib.gcn_gat_attn_bwd.restype = ctypes.c_int
        lib.gcn_gat_attn_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                         vp, i64, vp, vp, vp, i64, i32, i32,
                                         f32, vp]
        lib.gcn_gat_attn_rows.restype = ctypes.c_int
        lib.gcn_gat_attn_rows.argtypes = [vp, vp, vp, vp, i64, i32, i32,
                                          i32, vp]
        _lib = lib
    return _lib


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"the attention's {what} kernel failed to "
                           f"launch: CUDA error {rc}")


def _padded(t, f4):
    """(n, H, F) float32 ``t`` as the kernels read it: contiguous, 16-byte
    aligned, each head's row widened with zeros to ``f4`` elements, a
    multiple of 4."""
    t = t.contiguous()
    if t.shape[-1] == f4:
        return t if t.data_ptr() % 16 == 0 else t.clone()
    out = t.new_zeros(t.shape[:-1] + (f4,))
    out[..., :t.shape[-1]] = t
    return out


def _check_operands(layout, wh, el, er):
    n, h, _ = wh.shape
    if el.shape != (n, h) or er.shape != (n, h) or n != layout.n:
        raise ValueError(f"wh {tuple(wh.shape)}, el {tuple(el.shape)} and "
                         f"er {tuple(er.shape)} do not fit a layout of "
                         f"{layout.n} rows")
    for name, t in (("el", el), ("er", er), ("cols", layout.cols)):
        if t.device != wh.device:
            raise ValueError(f"{name} is on {t.device}, wh on {wh.device}")
    if wh.is_cuda and (wh.dtype, el.dtype, er.dtype) != (torch.float32,) * 3:
        raise TypeError(f"the attention's kernels take float32, got "
                        f"{wh.dtype}, {el.dtype} and {er.dtype}")


class _CountBackward(torch.autograd.Function):
    """The identity, whose backward counts one call of ``gat_attn``: the
    plain version's backward, which autograd runs op by op."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        counters["gat_attn"] += 1
        return g


class _GatAttentionKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wh, el, er, layout, negative_slope):
        n, heads, f = wh.shape
        f4 = -(-f // 4) * 4
        whp = _padded(wh, f4)
        el, er = el.contiguous(), er.contiguous()
        out = torch.empty((n, heads, f4), dtype=torch.float32,
                          device=wh.device)
        lse = torch.empty((n, heads), dtype=torch.float32, device=wh.device)
        stream = torch.cuda.current_stream(wh.device).cuda_stream
        _check(_kernel_library().gcn_gat_attn_fwd(
            whp.data_ptr(), el.data_ptr(), er.data_ptr(),
            layout.cols.data_ptr(), layout.row_ptr.data_ptr(),
            layout.row_order.data_ptr(), layout.long_rows, out.data_ptr(),
            lse.data_ptr(), n, heads, f4, negative_slope, stream), "forward")
        counters[_BY_SHAPE.format(heads, f)] += 1
        ctx.layout, ctx.negative_slope, ctx.f = layout, negative_slope, f
        ctx.save_for_backward(whp, el, er, out, lse)
        return out[..., :f] if f4 != f else out

    @staticmethod
    def backward(ctx, dout):
        counters["gat_attn"] += 1
        layout, f = ctx.layout, ctx.f
        whp, el, er, out, lse = ctx.saved_tensors
        n, heads, f4 = whp.shape
        dout = _padded(dout, f4)
        dev = whp.device
        dwh = torch.empty_like(whp)
        d = torch.empty((n, heads), dtype=torch.float32, device=dev)
        d_el = torch.empty_like(d)
        d_er = torch.empty_like(d)
        ds = torch.empty((layout.nnz, heads), dtype=torch.float32,
                         device=dev)
        lib = _kernel_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        # D[i, h] = dout[i, h] . out[i, h]
        _check(lib.gcn_gat_attn_rows(dout.data_ptr(), out.data_ptr(), None,
                                     d.data_ptr(), n, heads, f4, 0, stream),
               "row dot")
        _check(lib.gcn_gat_attn_bwd(
            whp.data_ptr(), el.data_ptr(), er.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), d.data_ptr(), layout.t_cols.data_ptr(),
            layout.t_edge.data_ptr(), layout.t_row_ptr.data_ptr(),
            layout.t_row_order.data_ptr(), layout.t_long_rows,
            dwh.data_ptr(), d_el.data_ptr(), ds.data_ptr(), n, heads, f4,
            ctx.negative_slope, stream), "backward")
        # d_er[i, h] = the sum of row i's ds, in edge order
        _check(lib.gcn_gat_attn_rows(ds.data_ptr(), None,
                                     layout.row_ptr.data_ptr(),
                                     d_er.data_ptr(), n, heads, f4, 1,
                                     stream), "row sum")
        counters[_BY_SHAPE.format(heads, f)] += 1
        dwh = dwh[..., :f] if f4 != f else dwh
        return dwh, d_el, d_er, None, None


def gat_attention(layout: GatLayout, wh: torch.Tensor, el: torch.Tensor,
                  er: torch.Tensor, negative_slope: float = 0.2
                  ) -> torch.Tensor:
    """out (n, H, F): each row's softmax over its edges of
    ``LeakyReLU(er[i] + el[j])``, per head, weighting the rows ``wh[j]``.
    The kernels for CUDA tensors, the plain version for CPU ones."""
    if wh.dim() != 3:
        raise ValueError(f"wh must be (n, heads, width), got "
                         f"{tuple(wh.shape)}")
    _check_operands(layout, wh, el, er)
    counters["gat_attn"] += 1
    if wh.device.type == "cpu":
        return _CountBackward.apply(
            _gat_attention_plain(layout, wh, el, er, negative_slope))
    return _GatAttentionKernel.apply(wh, el, er, layout,
                                     float(negative_slope))
