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
softmax; each direction's row offsets and walk order; and the
transpose's map to each edge's forward position, which the backward
reads and writes the forward's per-edge values through.

The walk order hands out the rows of more than ``HEAD_ROW`` edges first,
longest first (the kernels' ``long_rows``, past ``LONG_ROW``, lead), and
then every other row in the rabbit order of the pattern
(``reorder.compute_permutation``, made symmetric for it if it is not),
each run of ``RUN_ROWS`` rows of it longest first: a community's rows
are walked together, so the source rows they gather are still in L2
when the next of them gathers them again, and the rows that share a
warp have near equal lengths. The kernels add each row's edges in edge
order whatever the order in which the rows are handed out, so the order
changes no bit of any result. Each layout counts once under
``gat_layout_local_order`` in ``utils.timers.counters``.

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

from gcn_tpu_torch import reorder
from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.ops import _build
from gcn_tpu_torch.ops.adjacency import LONG_ROW, CooAdj, segment_lengths
from gcn_tpu_torch.ops.spmm import segment_sum
from gcn_tpu_torch.utils.timers import counters

_BY_SHAPE = "gat_attn_h{}_f{}"  # a call through the kernels, by (H, F)
# Rows of more edges than this are handed out first, longest first, so
# that no walk of 64-256 edges is left for the last wave.
HEAD_ROW = 64
# The other rows follow the rabbit order in runs of this many, each run
# longest first: the groups of a warp (4 (row, head)s at width 40) then
# walk rows of near equal length, and a run stays within a community.
RUN_ROWS = 1024

_lib = None


@dataclasses.dataclass(frozen=True)
class GatLayout:
    """The edges of A + I as the attention walks them, on one device.

    Forward: ``rows`` / ``cols`` (int64[nnz]) sorted by row, row i's run
    ``[row_ptr[i], row_ptr[i + 1])`` (``row_len`` its counts), the rows
    handed out in ``row_order``: first the rows of more than ``HEAD_ROW``
    edges, longest first, the first ``long_rows`` of them past
    ``adjacency.LONG_ROW``, then the others in the rabbit order of the
    pattern, each run of ``RUN_ROWS`` longest first.
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


def _local_order(row_len: np.ndarray, perm: np.ndarray):
    """(the rows of more than ``HEAD_ROW`` edges, longest first, ties in
    row order, then every other row in the order of ``perm``, each run
    of ``RUN_ROWS`` of them longest first, ties in that order; how many
    rows are long, past ``LONG_ROW``): the order in which the attention's
    kernels hand the rows out."""
    row_len = np.asarray(row_len)
    head = np.flatnonzero(row_len > HEAD_ROW)
    head = head[np.argsort(-row_len[head], kind="stable")]
    rest = perm[row_len[perm] <= HEAD_ROW]
    rest = rest[np.lexsort((-row_len[rest],
                            np.arange(rest.size) // RUN_ROWS))]
    return (np.concatenate([head, rest]).astype(np.int64),
            int((row_len > LONG_ROW).sum()))


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
    row_len = segment_lengths(rows, n)
    t_row_len = segment_lengths(cols[t_edge], n)
    row_ptr, t_row_ptr = (np.concatenate([[0], np.cumsum(c)])
                          for c in (row_len, t_row_len))
    pattern = CSRGraph(row_ptr, cols, np.ones(e, np.float32), (n, n))
    symmetric = (np.array_equal(rows, cols[t_edge])
                 and np.array_equal(cols, rows[t_edge]))
    perm = reorder.compute_permutation(
        pattern if symmetric else pattern.symmetrize(), "rabbit")
    order, n_long = _local_order(row_len, perm)
    t_order, t_n_long = _local_order(t_row_len, perm)
    counters["gat_layout_local_order"] += 1

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            adj.rows.device)

    return GatLayout(rows=up(rows), cols=up(cols), row_len=up(row_len),
                     row_ptr=up(row_ptr), row_order=up(order),
                     long_rows=n_long, t_cols=up(rows[t_edge]),
                     t_edge=up(t_edge), t_row_ptr=up(t_row_ptr),
                     t_row_order=up(t_order), t_long_rows=t_n_long, n=n,
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
    """The identity, whose backward counts one call under the counter
    ``name``: a plain version's backward, which autograd runs op by op."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        counters[ctx.name] += 1
        return g, None


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
            _gat_attention_plain(layout, wh, el, er, negative_slope),
            "gat_attn")
    return _GatAttentionKernel.apply(wh, el, er, layout,
                                     float(negative_slope))
