"""Halo exchange: send only the boundary activations a shard needs.

The port of the ragged plan and the pass-block overlap of
``gcn_tpu.parallel.halo``. After a locality reorder most edges are
intra-band, so each shard references a small boundary set of off-shard
rows. The plan (``build_halo_plan_ragged``, host numpy, arrays equal to
gcn_tpu's) decomposes the exchange into ns - 1 ring shifts: at offset t
shard s ships the rows shard (s + t) % ns needs, each offset at its own
payload height ``sizes[t - 1]`` (the largest boundary at that offset,
rounded up to 8; 0 = nothing moves at that offset).

  send_idx  int32[src, sum(sizes)]  per source shard: the local rows it
            ships, offset by offset, each segment padded to its size
  col_remap int32[dst, e_max]       per edge: a row of
            concat(zeros(8), halo segments in offset order, own band); the
            8 zero rows head the table so that padding edges (val 0, remap
            0) gather zeros

The exchange itself (``make_halo_exchange``) runs in two phases, so that
the caller can launch the interior aggregation between them: the first
gathers each owned shard's send rows (``_prep_send``), casts them for the
wire and issues every shift; ``wait()`` joins them and returns each owned
shard's halo table. A shift between two shards of one process is a copy on
the device; between processes it is one ``batch_isend_irecv`` of
point-to-point operations (NCCL on the card, gloo on the CPU). Its
gradient is the shift by -t of the cotangent, in the wire's dtype, as JAX
transposes ``ppermute`` and ``astype``.

The aggregation runs on K1 (``ops/ell_spmm.py``) per shard over the
pass-block partition (``build_sharded_ell_blocks``): an interior part that
gathers straight from the band and a halo part over concat(halo, band),
each its own ``EllAdj`` with transpose arrays, so that autograd through
``spmm_ell`` gives d(table) and the concat, the exchange and the
send-gather differentiate by themselves.

Not ported yet (ROADMAP.md, "Still to port"): the padded ``HaloPlan``
(``exchange="halo_padded"``), the hierarchical ``HierHaloPlan``, the
row-split parts and the monolithic ``build_sharded_ell`` with
``unpermute_rows``.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from gcn_tpu_torch.parallel.partition import ShardedGraph


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class RaggedHaloPlan:
    """Per-ring-offset exchange plan (see the module docstring); host
    numpy, every shard's arrays."""

    send_idx: np.ndarray
    col_remap: np.ndarray
    sizes: tuple
    n_shards: int
    n_rows: int

    @property
    def halo_rows(self) -> int:
        return 8 + sum(self.sizes)

    @property
    def exchange_fraction(self) -> float:
        """Rows a shard receives against the all-gather's full row
        count."""
        return sum(self.sizes) / max(self.n_rows, 1)


def _shard_edge_groups(cols_d, vals_d, rps, ns):
    """Group one shard's edge slots by SOURCE shard in a single sort.

    Returns ``(order, seg, lid_sorted)``: ``order`` permutes slots so
    sources ascend (padding slots, val 0, sort to a trailing sentinel group
    and enter no segment), ``seg[s]:seg[s+1]`` slices the slots whose
    column lives on shard s, ``lid_sorted`` their local ids."""
    src = cols_d // rps
    src = np.where(vals_d != 0, src, ns)   # padding -> sentinel group
    order = np.argsort(src, kind="stable")
    seg = np.searchsorted(src[order], np.arange(ns + 1))
    return order, seg, (cols_d % rps)[order]


def _pair_boundaries(sg: ShardedGraph):
    """``(needed, groups)``: needed[d, s] = sorted unique local ids on
    shard s that shard d's edges reference (s != d); groups[d] the
    ``_shard_edge_groups`` tuple for shard d."""
    ns, rps = sg.n_shards, sg.rows_per_shard
    needed = {}
    groups = []
    for d in range(ns):
        grp = _shard_edge_groups(sg.cols[d], sg.vals[d], rps, ns)
        groups.append(grp)
        _, seg, lid_sorted = grp
        for s in range(ns):
            if s != d:
                needed[d, s] = np.unique(lid_sorted[seg[s]:seg[s + 1]])
    return needed, groups


def build_halo_plan_ragged(sg: ShardedGraph) -> RaggedHaloPlan:
    """Per-offset boundary-exchange plan from a row-banded graph."""
    ns = sg.n_shards
    e_max = sg.cols.shape[1]
    needed, groups = _pair_boundaries(sg)

    sizes = []
    for t in range(1, ns):
        h = max((len(needed[(s + t) % ns, s]) for s in range(ns)),
                default=0)
        sizes.append(_round_up(h, 8) if h else 0)
    sizes = tuple(sizes)
    # receive-segment base row per t, behind the 8-row zero segment
    base = {}
    off = 8
    for t in range(1, ns):
        base[t] = off
        off += sizes[t - 1]

    send_idx = np.zeros((ns, sum(sizes)), dtype=np.int32)
    col_remap = np.zeros((ns, e_max), dtype=np.int32)
    for s in range(ns):
        o = 0
        for t in range(1, ns):
            if sizes[t - 1] == 0:
                continue
            u = needed[(s + t) % ns, s]
            send_idx[s, o:o + len(u)] = u
            o += sizes[t - 1]
    for d in range(ns):
        order, seg, lid_sorted = groups[d]
        for s in range(ns):
            slots = order[seg[s]:seg[s + 1]]
            lids = lid_sorted[seg[s]:seg[s + 1]]
            if s == d:
                col_remap[d, slots] = off + lids
                continue
            u = needed[d, s]
            pos = np.searchsorted(u, lids)
            if len(lids):
                assert np.array_equal(u[pos], lids), \
                    "halo plan missed a referenced boundary row"
            col_remap[d, slots] = base[(d - s) % ns] + pos
            # padding edges keep col_remap 0 -> the zero segment
    return RaggedHaloPlan(send_idx=send_idx, col_remap=col_remap,
                          sizes=sizes, n_shards=ns, n_rows=sg.n_rows)


# ---------------------------------------------------------------------------
# The pass-block partition of the lockstep per-shard ELL layout.
# ---------------------------------------------------------------------------


def _fit_counts(counts: np.ndarray) -> np.ndarray:
    """Make a per-window block-count sequence span-budget-friendly:
    identity if its runs already fit, else the nonincreasing envelope
    (reverse cummax) laddered to the segment budget (tile/ell.py)."""
    from gcn_tpu_torch.tile.ell import (_MAX_REDUCE_SEGMENTS, _pass_runs,
                                        _quantize_passes)

    budget = _MAX_REDUCE_SEGMENTS
    if (len(np.unique(counts)) <= budget
            and _pass_runs(counts) <= budget):
        return counts
    mono = np.maximum.accumulate(counts[::-1])[::-1]
    if len(np.unique(mono)) > budget:
        mono = _quantize_passes(mono, budget)
    return mono


def build_sharded_ell_blocks(sg: ShardedGraph, plan: RaggedHaloPlan, *,
                             r: int = None, k_pad: int = 32, shards=None,
                             device=None):
    """Pass-block partition of each band's lockstep layout:
    ``(interior, halo)``, two lists with one ``EllAdj`` per shard of
    ``shards`` (every shard by default), on ``device`` (the card by
    default, ``device="cpu"`` for the CPU).

    Within a band's monolithic layout (rows x concat(halo, band)) a row's
    columns sort ascending and halo ids precede band ids, so each row's
    halo edges fill its first slots; in window w only the pass-blocks
    below ``ceil(max halo degree / P)`` touch the halo. Cutting each
    window's blocks there gives an interior part (rps x rps, gathers
    straight from the band, launchable before the exchange completes) and
    a halo part (rps x (halo_rows + rps)). Outputs add: A @ table =
    interior @ band + halo @ table.

    The layout is gcn_tpu's LOCKSTEP one: every shard gets the same
    per-window pass counts (the maximum over shards, made span-friendly
    by ``_fit_counts``), as shard_map's uniform shapes need; the port
    keeps it so that its arrays equal gcn_tpu's. Hub rows are not split.
    Each shard's ``EllAdj`` carries its own ``win_off`` / ``t_win_off``
    and its own stored-edge count ``nnz``. The span plans (metadata that
    steers nothing on the card) follow gcn_tpu's span limit, including its
    GCN_TPU_SPAN_LIMIT override, so that they equal gcn_tpu's.
    """
    from gcn_tpu_torch.graph.csr import coo_to_csr
    from gcn_tpu_torch.tile.ell import (DEFAULT_R, EllAdj, _ell_arrays,
                                        _guard_spans, _span_plan,
                                        _win_offsets, _window_passes)
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    ns, rps = sg.n_shards, sg.rows_per_shard
    shards = range(ns) if shards is None else list(shards)
    if r is None:
        r = DEFAULT_R if rps >= DEFAULT_R else max(8, rps // 8 * 8)
    p = 128 // k_pad
    env = os.environ.get("GCN_TPU_SPAN_LIMIT")
    span_pass_limit = int(env) if env is not None else max(1, k_pad // 2)
    if span_pass_limit <= 0:
        span_pass_limit = 1 << 30
    halo_cols = plan.halo_rows
    nw = max(1, -(-rps // r))

    # per-shard monolithic CSRs (every shard: the lockstep counts need
    # them all) + per-row halo degrees
    g_all, halo_deg = [], []
    for d in range(ns):
        vals = sg.vals[d]
        remap = plan.col_remap[d]
        real = vals != 0
        rows_d = sg.rows_local[d][real]
        cols_d = remap[real]
        g_all.append(coo_to_csr(rows_d, cols_d, vals[real],
                                (rps, halo_cols + rps)))
        halo_deg.append(np.bincount(rows_d[cols_d < halo_cols],
                                    minlength=rps).astype(np.int64))

    # lockstep totals and halo cut, shard-uniform
    pf = _fit_counts(np.maximum.reduce(
        [_window_passes(g.indptr, rps, r, p) for g in g_all]))
    hb = np.zeros(nw, dtype=np.int64)
    for d in range(ns):
        hd = np.zeros(nw * r, dtype=np.int64)
        hd[:rps] = halo_deg[d]
        hb = np.maximum(hb, -(-hd.reshape(nw, r).max(axis=1) // p))
    hb = np.minimum(hb, pf)
    hp = _fit_counts(np.maximum(hb, 1))          # halo part
    ip = _fit_counts(np.maximum(pf - hb, 1))     # interior part

    def split_edges(d, which):
        """(rows, slot j within its part's row, column, value) of shard d's
        edges that fall in ``which`` part."""
        g = g_all[d]
        deg = np.diff(g.indptr).astype(np.int64)
        rows = np.repeat(np.arange(rps, dtype=np.int64), deg)
        j = np.arange(len(g.indices), dtype=np.int64) - np.repeat(
            g.indptr[:-1].astype(np.int64), deg)
        cut = hb[rows // r] * p
        if which == "halo":
            m = j < cut
            return rows[m], j[m], g.indices[m], g.data[m]
        m = j >= cut
        return rows[m], j[m] - cut[m], g.indices[m] - halo_cols, g.data[m]

    def layout_part(which, counts):
        """The part's forward (cols, vals) of each shard of ``shards``, its
        ``win`` and spans."""
        offs = np.zeros(nw + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        nb = int(offs[-1])
        arrays = []
        for d in shards:
            rows, j, cc, vv = split_edges(d, which)
            w = rows // r
            at = (offs[w] + j // p, j % p, rows - w * r)
            cols = np.zeros((nb, p, r), dtype=np.int32)
            vals = np.zeros((nb, p, r), dtype=np.float32)
            cols[at], vals[at] = cc, vv
            arrays.append((cols, vals))
        win = np.repeat(np.arange(nw, dtype=np.int32), counts)
        return arrays, win, _guard_spans(_span_plan(offs), span_pass_limit)

    def layout_transpose(which, n_rows_t):
        """The part's transpose (cols, vals) of each shard of ``shards`` at
        the pass counts of every shard's transpose (of the other shards
        only the degrees are needed), its ``win`` and spans."""
        edges = [split_edges(d, which) for d in range(ns)]
        indptrs = [np.concatenate([[0], np.cumsum(np.bincount(
            cc, minlength=n_rows_t))]) for _, _, cc, _ in edges]
        pt = _fit_counts(np.maximum.reduce(
            [_window_passes(ip_, n_rows_t, r, p) for ip_ in indptrs]))
        arrays = []
        for d in shards:
            rows, _, cc, vv = edges[d]
            t = coo_to_csr(cc, rows, vv, (n_rows_t, rps))
            cols, vals, _, _ = _ell_arrays(t.indptr, t.indices, t.data,
                                           n_rows_t, r, p, forced_passes=pt)
            arrays.append((cols, vals))
        off = np.zeros(len(pt) + 1, dtype=np.int64)
        np.cumsum(pt, out=off[1:])
        win = np.repeat(np.arange(len(pt), dtype=np.int32), pt)
        return arrays, win, _guard_spans(_span_plan(off), span_pass_limit)

    def dev(a):
        return torch.from_numpy(a).to(device)

    parts = []
    for which, counts, n_cols_part in (
            ("interior", ip, rps), ("halo", hp, halo_cols + rps)):
        fwd, win, spans = layout_part(which, counts)
        bwd, t_win, t_spans = layout_transpose(which, n_cols_part)
        nw_t = max(1, -(-n_cols_part // r))
        win_d, t_win_d = dev(win), dev(t_win)
        win_off = dev(_win_offsets(win, nw))
        t_win_off = dev(_win_offsets(t_win, nw_t))
        parts.append([EllAdj(
            cols=dev(cols), vals=dev(vals), win=win_d, win_off=win_off,
            t_cols=dev(t_cols), t_vals=dev(t_vals), t_win=t_win_d,
            t_win_off=t_win_off, n_rows=rps, n_cols=n_cols_part,
            nnz=int((vals != 0).sum()), r=r, k_pad=k_pad, symmetric=False,
            chunks=((0, cols.shape[0], 0, nw),),
            t_chunks=((0, t_cols.shape[0], 0, nw_t),),
            spans=spans, t_spans=t_spans, span_pass_limit=span_pass_limit)
            for (cols, vals), (t_cols, t_vals) in zip(fwd, bwd)])
    return parts[0], parts[1]


# ---------------------------------------------------------------------------
# The exchange.
# ---------------------------------------------------------------------------


def _prep_send(x_band, send_idx, pre, wire_dtype):
    """Gather send rows, apply the optional ``pre`` transform, cast for the
    wire. Returns (rows, out_dtype): out_dtype is what the halo table is
    cast back to on arrival.

    Narrow-range wire dtypes get a clip to the wire's finite range first:
    float8_e4m3fn tops out at 448, and JAX turns an overflow into NaN
    (torch's cast saturates), so the clip makes both packages send the
    same bytes. bf16 shares f32's exponent range, so it is not clipped.
    """
    rows = x_band.index_select(0, send_idx)
    if pre is not None:
        rows = pre(rows)
    out_dtype = rows.dtype
    if wire_dtype is not None:
        wmax = torch.finfo(wire_dtype).max
        if wmax < torch.finfo(out_dtype).max:
            rows = rows.clamp(-wmax, wmax)
        rows = rows.to(wire_dtype)
    return rows, out_dtype


def _ring_shift(mesh, sizes, src, dst, sign):
    """Every nonzero offset t moves owned shard a's segment t of ``src`` to
    segment t of ``dst`` on shard (a + sign * t) % ns: a copy when that
    shard is this process's, else a point-to-point send matched by a
    receive on its owner. Segments sit at the same rows in both (the plan's
    offset order). Returns the pending distributed work (empty without
    remote peers).

    Every rank walks the offsets and the destination shards in ascending
    order, for its sends and for its receives alike, so that each pair of
    ranks posts its messages in one order (NCCL matches point-to-point
    messages between two ranks by their order, gloo by the tag, which is
    unique per offset and destination shard). The messages travel as
    ``uint8`` views of their bytes: gloo and NCCL need not take
    float8_e4m3fn (or bfloat16) tensors, and a byte copy is exact.
    """
    ns = mesh.n_shards
    ops = []
    off = 0
    for t, h in enumerate(sizes, start=1):
        if h == 0:
            continue
        seg = slice(off, off + h)
        sends = []
        for a in mesh.shards:
            b = (a + sign * t) % ns
            piece = src[mesh.local_index(a)][seg]
            if mesh.owner(b) == mesh.rank:
                dst[mesh.local_index(b)][seg].copy_(piece)
            else:
                sends.append((b, piece))
        for b, piece in sorted(sends, key=lambda bp: bp[0]):
            ops.append(dist.P2POp(dist.isend, piece.view(torch.uint8),
                                  mesh.owner(b), tag=t * ns + b))
        for b in mesh.shards:
            a = (b - sign * t) % ns
            if mesh.owner(a) != mesh.rank:
                ops.append(dist.P2POp(
                    dist.irecv, dst[mesh.local_index(b)][seg].view(
                        torch.uint8), mesh.owner(a), tag=t * ns + b))
        off += h
    return dist.batch_isend_irecv(ops) if ops else []


class _HaloStart(torch.autograd.Function):
    """Issue every shift of the owned shards' (wire-dtype) send rows;
    returns their receive buffers, filled once ``_HaloWait`` has waited.
    Backward: the shift by -t of the buffers' cotangents, in the wire
    dtype."""

    @staticmethod
    def forward(ctx, pending, *rows):
        # ctx keeps the plan, not ``pending``: pending holds this node's
        # outputs until the wait, and ctx -> pending -> outputs -> ctx
        # would be a reference cycle
        ctx.mesh, ctx.sizes = pending.mesh, pending.sizes
        recv = [torch.empty_like(x) for x in rows]
        pending.works = _ring_shift(pending.mesh, pending.sizes, rows, recv,
                                    +1)
        pending.keep = rows     # the send buffers live until the wait
        return tuple(recv)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous() for g in grads]
        back = [torch.empty_like(g) for g in grads]
        for work in _ring_shift(ctx.mesh, ctx.sizes, grads, back, -1):
            work.wait()
        return (None, *back)


class _HaloWait(torch.autograd.Function):
    """Wait for the shifts, then build each owned shard's halo table,
    concat(zeros(8), received rows) in the compute dtype. Backward: the
    table's cotangent below the zero rows, cast to the wire dtype."""

    @staticmethod
    def forward(ctx, pending, *recv):
        for work in pending.works:
            work.wait()
        pending.works, pending.keep = [], None
        ctx.wire_dtype = recv[0].dtype if recv else None
        return tuple(torch.cat([r.new_zeros((8, r.shape[1]),
                                            dtype=pending.out_dtype),
                                r.to(pending.out_dtype)]) for r in recv)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(g[8:].to(ctx.wire_dtype).contiguous()
                        for g in grads))


class _PendingHalo:
    """One exchange in flight; ``wait()`` returns each owned shard's halo
    table, (8 + sum(sizes), k)."""

    def __init__(self, mesh, sizes, rows, out_dtype):
        self.mesh, self.sizes, self.out_dtype = mesh, sizes, out_dtype
        self.works, self.keep = [], None
        self.recv = _HaloStart.apply(self, *rows)

    def wait(self):
        recv, self.recv = self.recv, None
        return list(_HaloWait.apply(self, *recv))


def _exchange_halo_ragged(sizes, send_idx, x_bands, mesh, pre=None,
                          wire_dtype=None) -> _PendingHalo:
    """Start the per-offset exchange of the owned shards' boundary rows:
    ``send_idx`` and ``x_bands`` list the owned shards in order. ``pre``
    is applied to the gathered send rows before they leave (the
    boundary-rows-first trick: with ``rows -> rows @ W`` the payload is the
    transformed rows, so the full-band ``X @ W`` and the interior
    aggregation can run while they travel). ``wire_dtype`` (bfloat16,
    float8_e4m3fn) casts the payload for the wire only."""
    rows, out_dtype = [], None
    for x, idx in zip(x_bands, send_idx):
        one, out_dtype = _prep_send(x, idx, pre, wire_dtype)
        rows.append(one.contiguous())
    return _PendingHalo(mesh, sizes, rows, out_dtype)


def make_halo_exchange(plan: RaggedHaloPlan, wire_dtype=None):
    """exchange(send_idx, x_bands, mesh, pre=None) -> a pending exchange
    whose ``wait()`` gives the owned shards' halo tables."""
    return partial(_exchange_halo_ragged, plan.sizes, wire_dtype=wire_dtype)


# ---------------------------------------------------------------------------
# Sharded SpMMs over the exchange.
# ---------------------------------------------------------------------------


def dist_spmm_halo(shard_arrays, send_idx, x_bands, rows_per_shard, mesh,
                   exchange):
    """SpMM of the owned bands with the boundary-only exchange and a
    segment sum (``index_add``, the counterpart of XLA's segment_sum):
    ``shard_arrays`` are the owned shards' (rows_local, col_remap, vals)."""
    halos = exchange(send_idx, x_bands, mesh).wait()
    outs = []
    for (rows_local, col_remap, vals), halo, x in zip(shard_arrays, halos,
                                                      x_bands):
        table = torch.cat([halo, x])
        gathered = table[col_remap] * vals[:, None]
        outs.append(x.new_zeros((rows_per_shard, x.shape[1])).index_add(
            0, rows_local, gathered))
    return outs


def dist_spmm_halo_ell_overlap_blocks(ell_int, ell_halo, send_idx, x_bands,
                                      mesh, exchange):
    """Overlap via the pass-block partition: the exchange is issued first,
    the interior parts (K1 on the band) run while it travels, and the halo
    parts (K1 on concat(halo, band)) after the wait."""
    from gcn_tpu_torch.ops.ell_spmm import spmm_ell

    pending = exchange(send_idx, x_bands, mesh)
    interior = [spmm_ell(a, x) for a, x in zip(ell_int, x_bands)]
    halos = pending.wait()
    return [i + spmm_ell(a, torch.cat([h, x]))
            for i, a, h, x in zip(interior, ell_halo, halos, x_bands)]


def dist_spmm_halo_ell_overlap_blocks_xw(ell_int, ell_halo, send_idx,
                                         x_bands, w, mesh, exchange,
                                         chunk=None):
    """Fused ``A @ (X W)`` on the pass-block partition with the
    boundary-rows-first exchange and the k-chunked pipeline.

    The send rows are gathered from the RAW band and transformed by a
    small ``rows @ W`` before they leave, so every exchange is issued
    before the full-band ``X @ W`` and the interior K1. With ``chunk`` below
    W's width the exchange and the halo aggregation split into
    ceil(f_out / chunk) column slices: slice c's halo K1 runs while the
    later slices travel. Each output column depends only on its own halo
    column, so the slices are exact."""
    from gcn_tpu_torch.ops.ell_spmm import spmm_ell

    f_out = w.shape[1]
    if chunk is None or f_out <= chunk:
        cuts = [(0, f_out)]
    else:
        cuts = [(c0, min(c0 + chunk, f_out)) for c0 in range(0, f_out, chunk)]

    def pre_of(c0, c1):
        wc = w if (c0, c1) == (0, f_out) else w[:, c0:c1]
        return lambda rows: torch.matmul(rows, wc)

    pendings = [exchange(send_idx, x_bands, mesh, pre=pre_of(c0, c1))
                for c0, c1 in cuts]
    h = [torch.matmul(x, w) for x in x_bands]
    interior = [spmm_ell(a, hb) for a, hb in zip(ell_int, h)]
    parts = [[] for _ in h]
    for (c0, c1), pending in zip(cuts, pendings):
        for i, halo in enumerate(pending.wait()):
            hc = h[i] if (c0, c1) == (0, f_out) else h[i][:, c0:c1]
            parts[i].append(spmm_ell(ell_halo[i], torch.cat([halo, hc])))
    return [i + (p[0] if len(p) == 1 else torch.cat(p, dim=1))
            for i, p in zip(interior, parts)]
