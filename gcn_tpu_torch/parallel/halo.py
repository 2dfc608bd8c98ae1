"""Halo exchange: send only the boundary activations a shard needs.

The port of ``gcn_tpu.parallel.halo``. After a locality reorder most edges
are intra-band, so each shard references a small boundary set of off-shard
rows. Three host-numpy plans (arrays equal to gcn_tpu's) say which rows move
where, and each remaps every edge's column into its shard's gather table,
concat(halo, own band):

  * the ragged plan (``build_halo_plan_ragged``, the default): ns - 1 ring
    shifts; at offset t shard s ships the rows shard (s + t) % ns needs, each
    offset at its own payload height ``sizes[t - 1]`` (the largest boundary
    at that offset, rounded up to 8; 0 = nothing moves). The halo is
    concat(zeros(8), segments in offset order): padding edges (val 0,
    remap 0) gather the zero rows;
  * the padded plan (``build_halo_plan``): one all-to-all, every (src, dst)
    pair padded to the largest boundary ``h_max``. ``send_idx[src, dst]``
    lists the rows src ships to dst (zeros on the self slice), the halo is
    ns blocks of h_max rows, block s from shard s, with no zero head;
  * the hierarchical plan (``build_halo_plan_hier``, shard = host * n_chips
    + chip): ring shifts over the chip offsets for same-host boundaries,
    ring shifts over the host offsets of each source's UNION for the
    destination host's chips, then a fan-out of the received unions over
    the chips: ``"ragged"`` forwards, per (host offset, chip offset), only
    the rows the destination chip reads; ``"all_gather"`` gives every chip
    every union its host received, chip-major.

Every exchange moves rows along a route: a list of (source shard,
destination shard, source row, destination row, rows) moves, every shard's,
in one global order. On a mesh with a model axis each move runs once a
model slot, between the slots of that model index (``_slot_moves``): the
exchange of one slot's hidden shard joins the bands of that slot, and the
hierarchical plan's host and chip levels apply within it; the lists the
exchange takes are then over the owned slots. A move between two slots of
one process is a copy on the device; between processes the route's moves
go as point-to-point messages (``batch_isend_irecv``) or, for the padded
plan, as one ``all_to_all_single`` on the data group; NCCL on the card,
gloo on the CPU. Every rank posts
its messages in the route's global order, so each pair of ranks posts them
in one order (NCCL matches point-to-point messages between two ranks by
their order, gloo by the tag, a move's index). The messages travel as
``uint8`` views of their bytes: gloo and NCCL need not take float8_e4m3fn
or bfloat16 tensors, and a byte copy is exact. A route runs in two phases,
start and wait, so that the interior aggregation can run while it travels.
Its gradient is the route reversed, in the wire's dtype, as JAX transposes
``ppermute`` and ``all_to_all``; where a reversed route brings several
pieces to one row (the all_gather fan-out) they add, as JAX transposes
``all_gather``.

The aggregation runs on K1 (``ops/ell_spmm.py``) per shard over one of
three layouts, each an ``EllAdj`` per shard with transpose arrays, so that
autograd through ``spmm_ell`` gives d(table) and the concat and the
exchange differentiate by themselves. The send gather
(``gather_send_rows``) sums each band row's cotangents in send order, as
XLA's scatter-add transposes gcn_tpu's ``jnp.take``; ``index_select``'s
own backward adds them with atomics on the card, in no fixed order. A
segment of a plan (one destination) lists distinct rows, then pads with
row 0, which no stored edge reads, so its padding's cotangents are zero;
the backward adds one segment at a time, in segment order (``send_indices``
cuts the segments at the plan's payload heights):

  * the pass-block partition (``build_sharded_ell_blocks``, the train
    step's default): an interior part that gathers straight from the band
    and a halo part over concat(halo, band);
  * the monolithic layout (``build_sharded_ell(part="all")``) over
    concat(halo, band);
  * the row-split parts (``build_sharded_ell(part="interior" |
    "boundary")``): on-band edges over the band, off-band edges over the
    halo, each part's rows sorted by the part's degree (``part_order``) and
    restored to band order by ``unpermute_rows``.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gcn_tpu_torch.parallel.partition import ShardedGraph, rows_per_shard_for
from gcn_tpu_torch.parallel.spmm_dist import local_spmm


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Plans (host numpy, every shard's arrays).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RaggedHaloPlan:
    """Per-ring-offset exchange plan (see the module docstring).

    send_idx  int32[src, sum(sizes)]  per source shard: the local rows it
              ships, offset by offset, each segment padded to its size
    col_remap int32[dst, e_max]       per edge: a row of
              concat(zeros(8), halo segments in offset order, own band)
    """

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


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Padded all-to-all plan (see the module docstring).

    send_idx  int32[src, dst, h_max]  local rows src ships to dst; the self
              slice is zeros (local columns never leave the shard)
    col_remap int32[dst, e_max]       per edge: a row of concat(halo, own
              band): off-band edges ``src * h_max + position``, on-band
              edges ``n_shards * h_max + local row``; padding edges 0
    """

    send_idx: np.ndarray
    col_remap: np.ndarray
    h_max: int
    n_shards: int
    n_rows: int

    @property
    def exchange_fraction(self) -> float:
        """Rows a shard receives against the all-gather's full row
        count."""
        return self.n_shards * self.h_max / max(self.n_rows, 1)

    @property
    def halo_rows(self) -> int:
        return self.n_shards * self.h_max


@dataclasses.dataclass(frozen=True)
class HierHaloPlan:
    """Two-level (host x chip) exchange plan (see the module docstring).

    send_intra int32[ns, sum(intra_sizes)]  chip-offset segments (band rows)
    send_inter int32[ns, sum(inter_sizes)]  host-offset UNION segments (band
               rows)
    send_fan   int32[ns, max(sum(fan_sizes), 8)]  ragged fan-out: rows of
               the RECEIVED union buffer (the tail past sum(fan_sizes) is
               never read); zeros in all_gather mode
    col_remap  int32[ns, e_max]  into concat(zeros(8), intra segments,
               received unions, fan-out segments | all-gathered unions
               (chip-major), own band)
    fan_sizes  per-(host offset, chip offset) payload heights, host-offset
               major; None for the all_gather fan-out
    """

    send_intra: np.ndarray
    send_inter: np.ndarray
    send_fan: np.ndarray
    col_remap: np.ndarray
    intra_sizes: tuple
    inter_sizes: tuple
    fan_sizes: Optional[tuple]
    n_hosts: int
    n_chips: int
    n_rows: int

    @property
    def n_shards(self) -> int:
        return self.n_hosts * self.n_chips

    @property
    def halo_rows(self) -> int:
        if self.fan_sizes is None:
            return 8 + sum(self.intra_sizes) + self.n_chips * sum(
                self.inter_sizes)
        return (8 + sum(self.intra_sizes) + sum(self.inter_sizes)
                + sum(self.fan_sizes))

    @property
    def exchange_fraction(self) -> float:
        """Rows a shard receives over the chip and host offsets against the
        all-gather's full row count; the fan-out is counted apart."""
        return (sum(self.intra_sizes) + sum(self.inter_sizes)) / max(
            self.n_rows, 1)

    @property
    def dcn_fraction(self) -> float:
        """Rows a shard receives across hosts against the full row
        count."""
        return sum(self.inter_sizes) / max(self.n_rows, 1)

    @property
    def ici_gather_rows(self) -> int:
        """Rows a shard receives in the fan-out of the unions."""
        if self.fan_sizes is None:
            return (self.n_chips - 1) * sum(self.inter_sizes)
        return sum(self.fan_sizes)


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


def _remap_edges(col_remap, groups, d, base_of, band_off):
    """Fill shard d's ``col_remap``: an edge from shard s != d goes to
    ``base + position`` of its local id in ``u``, for ``(u, base) =
    base_of(s)``; an on-band edge to ``band_off + local id``; padding edges
    keep 0."""
    order, seg, lid_sorted = groups[d]
    for s in range(len(seg) - 1):
        slots = order[seg[s]:seg[s + 1]]
        lids = lid_sorted[seg[s]:seg[s + 1]]
        if s == d:
            col_remap[d, slots] = band_off + lids
            continue
        u, base = base_of(s)
        pos = np.searchsorted(u, lids)
        if len(lids):
            assert np.array_equal(u[pos], lids), \
                "halo plan missed a referenced boundary row"
        col_remap[d, slots] = base + pos


def _offset_sizes(needed, pairs):
    """Payload height of one offset: the largest boundary over its (dst,
    src) pairs, rounded up to 8 (0 when none needs a row)."""
    h = max((len(needed[pair]) for pair in pairs), default=0)
    return _round_up(h, 8) if h else 0


def build_halo_plan_ragged(sg: ShardedGraph) -> RaggedHaloPlan:
    """Per-offset boundary-exchange plan from a row-banded graph."""
    ns = sg.n_shards
    needed, groups = _pair_boundaries(sg)
    sizes = tuple(_offset_sizes(needed, [((s + t) % ns, s)
                                         for s in range(ns)])
                  for t in range(1, ns))
    # receive-segment base row per t, behind the 8-row zero segment
    base = {}
    off = 8
    for t in range(1, ns):
        base[t] = off
        off += sizes[t - 1]

    send_idx = np.zeros((ns, sum(sizes)), dtype=np.int32)
    col_remap = np.zeros((ns, sg.cols.shape[1]), dtype=np.int32)
    for s in range(ns):
        o = 0
        for t in range(1, ns):
            if sizes[t - 1] == 0:
                continue
            u = needed[(s + t) % ns, s]
            send_idx[s, o:o + len(u)] = u
            o += sizes[t - 1]
    for d in range(ns):
        _remap_edges(col_remap, groups, d,
                     lambda s: (needed[d, s], base[(d - s) % ns]), off)
    return RaggedHaloPlan(send_idx=send_idx, col_remap=col_remap,
                          sizes=sizes, n_shards=ns, n_rows=sg.n_rows)


def build_halo_plan(sg: ShardedGraph) -> HaloPlan:
    """Padded all-to-all boundary-exchange plan from a row-banded graph."""
    ns = sg.n_shards
    needed, groups = _pair_boundaries(sg)
    h_max = max(1, max(len(u) for u in needed.values())) if needed else 1
    h_max = _round_up(h_max, 8)

    send_idx = np.zeros((ns, ns, h_max), dtype=np.int32)
    col_remap = np.zeros((ns, sg.cols.shape[1]), dtype=np.int32)
    for (d, s), u in needed.items():
        send_idx[s, d, :len(u)] = u
    for d in range(ns):
        _remap_edges(col_remap, groups, d,
                     lambda s: (needed[d, s], s * h_max), ns * h_max)
    return HaloPlan(send_idx=send_idx, col_remap=col_remap, h_max=h_max,
                    n_shards=ns, n_rows=sg.n_rows)


def build_halo_plan_hier(sg: ShardedGraph, n_hosts: int, n_chips: int,
                         fanout: str = "ragged") -> HierHaloPlan:
    """Hierarchical exchange plan; shard id = host * n_chips + chip.

    ``fanout``: "ragged" (the default) forwards only the per-destination
    needed subsets of each received union over the chip offsets;
    "all_gather" gives every chip every union its host received."""
    if fanout not in ("ragged", "all_gather"):
        raise ValueError("fanout must be 'ragged' or 'all_gather'")
    ns = sg.n_shards
    if ns != n_hosts * n_chips:
        raise ValueError(f"{n_hosts} x {n_chips} does not factor {ns} shards")
    nh, nc = n_hosts, n_chips
    needed, groups = _pair_boundaries(sg)

    # same host: per-chip-offset sizes, the max over hosts and chips
    intra_sizes = tuple(_offset_sizes(needed, [
        (hh * nc + (c + t) % nc, hh * nc + c)
        for hh in range(nh) for c in range(nc)]) for t in range(1, nc))
    # across hosts: the union over the destination host's chips, per source
    union = {}
    for s in range(ns):
        for hd in range(nh):
            if hd != s // nc:
                union[hd, s] = np.unique(np.concatenate(
                    [needed[hd * nc + c, s] for c in range(nc)]))
    inter_sizes = tuple(_offset_sizes(union, [
        ((s // nc + th) % nh, s) for s in range(ns)])
        for th in range(1, nh))

    intra_base = {}
    off = 8
    for t in range(1, nc):
        intra_base[t] = off
        off += intra_sizes[t - 1]
    inter_base = off  # received unions start here
    sum_inter = sum(inter_sizes)
    ioff = {}
    o = 0
    for th in range(1, nh):
        ioff[th] = o
        o += inter_sizes[th - 1]

    # ragged fan-out: per (host offset, chip offset), the forwarder (h, c)
    # holds union[h, s] for s = ((h - th) % nh) * nc + c and ships the
    # subset needed[(h, (c + tc) % nc), s], only rows the destination reads
    fan_sizes = None
    fan_off = {}
    if fanout == "ragged":
        fan_sizes = tuple(_offset_sizes(needed, [
            (hh * nc + (c + tc) % nc, ((hh - th) % nh) * nc + c)
            for hh in range(nh) for c in range(nc)])
            for th in range(1, nh) for tc in range(1, nc))
        fan_base = 8 + sum(intra_sizes) + sum_inter
        o, i = 0, 0
        for th in range(1, nh):
            for tc in range(1, nc):
                fan_off[th, tc] = fan_base + o
                o += fan_sizes[i]
                i += 1
        band_off = fan_base + sum(fan_sizes)
    else:
        band_off = inter_base + nc * sum_inter

    send_intra = np.zeros((ns, sum(intra_sizes)), dtype=np.int32)
    send_inter = np.zeros((ns, sum_inter), dtype=np.int32)
    # min width 8, as gcn_tpu's (a zero-element array would lose its
    # sharding there); the pad is never read
    send_fan = np.zeros((ns, max(sum(fan_sizes or ()), 8)), dtype=np.int32)
    for s in range(ns):
        hs, cs = divmod(s, nc)
        o = 0
        for t in range(1, nc):
            if intra_sizes[t - 1] == 0:
                continue
            u = needed[hs * nc + (cs + t) % nc, s]
            send_intra[s, o:o + len(u)] = u
            o += intra_sizes[t - 1]
        o = 0
        for th in range(1, nh):
            if inter_sizes[th - 1] == 0:
                continue
            u = union[(hs + th) % nh, s]
            send_inter[s, o:o + len(u)] = u
            o += inter_sizes[th - 1]
        if fanout == "ragged":
            # (hs, cs) as the FORWARDER: rows of its received union buffer
            o, i = 0, 0
            for th in range(1, nh):
                src = ((hs - th) % nh) * nc + cs
                u = union[hs, src]
                for tc in range(1, nc):
                    if fan_sizes[i]:
                        sub = needed[hs * nc + (cs + tc) % nc, src]
                        send_fan[s, o:o + len(sub)] = ioff[th] + \
                            np.searchsorted(u, sub)
                        o += fan_sizes[i]
                    i += 1

    def base_of(d, s):
        hd, cd = divmod(d, nc)
        hs, cs = divmod(s, nc)
        th, tc = (hd - hs) % nh, (cd - cs) % nc
        if hs == hd:
            return needed[d, s], intra_base[tc]
        if fanout == "ragged" and tc:
            # arrives in the fan-out segment holding exactly needed[d, s]
            return needed[d, s], fan_off[th, tc]
        if fanout == "ragged":
            # same chip index: read the received union in place
            return union[hd, s], inter_base + ioff[th]
        return union[hd, s], inter_base + cs * sum_inter + ioff[th]

    col_remap = np.zeros((ns, sg.cols.shape[1]), dtype=np.int32)
    for d in range(ns):
        _remap_edges(col_remap, groups, d, partial(base_of, d), band_off)
    return HierHaloPlan(
        send_intra=send_intra, send_inter=send_inter, send_fan=send_fan,
        col_remap=col_remap, intra_sizes=intra_sizes,
        inter_sizes=inter_sizes, fan_sizes=fan_sizes, n_hosts=nh,
        n_chips=nc, n_rows=sg.n_rows)


@dataclasses.dataclass(frozen=True)
class SendRows:
    """One shard's send gather on the device: ``idx``, the rows it ships,
    in the plan's segments, each ``segments`` entry a (start, stop) of
    ``idx``."""

    idx: torch.Tensor
    segments: tuple


def send_rows(idx, heights, n_rows, device) -> SendRows:
    """``SendRows`` of one shard's host indices ``idx``, rows of a table of
    ``n_rows`` rows, in segments of ``heights`` rows each (the plan's
    payload heights, 0 = no segment), on ``device``. Raises unless the
    segments cover ``idx`` and every index is in range."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    ends = np.cumsum([h for h in heights if h], dtype=np.int64)
    if (ends[-1] if ends.size else 0) != idx.size or (
            idx.size and (idx.min() < 0 or idx.max() >= n_rows)):
        raise ValueError(f"send rows: segments {heights} over {idx.size} "
                         f"indices into {n_rows} rows")
    starts = np.concatenate([[0], ends[:-1]])
    return SendRows(torch.as_tensor(idx, device=device),
                    tuple(zip(starts.tolist(), ends.tolist())))


def send_indices(plan, shards, device):
    """Each shard of ``shards``' send rows on ``device`` (``SendRows``), as
    the plan's exchange takes them: one gather from the band (ragged: its
    offsets' segments; padded: its ns slices of h_max, flattened), or
    (intra, inter, fan) for the hierarchical plan: two gathers from the
    band and the ragged fan-out's from the received unions (empty for the
    all_gather fan-out)."""
    rps = rows_per_shard_for(plan.n_rows, plan.n_shards)
    if isinstance(plan, HierHaloPlan):
        fan = plan.fan_sizes or ()
        return [(send_rows(plan.send_intra[s], plan.intra_sizes, rps, device),
                 send_rows(plan.send_inter[s], plan.inter_sizes, rps, device),
                 send_rows(plan.send_fan[s][:sum(fan)], fan,
                           sum(plan.inter_sizes), device))
                for s in shards]
    heights = (plan.sizes if isinstance(plan, RaggedHaloPlan)
               else (plan.h_max,) * plan.n_shards)
    return [send_rows(plan.send_idx[s], heights, rps, device)
            for s in shards]


class _SendGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, rows):
        ctx.rows, ctx.n_rows = rows, table.shape[0]
        return table.index_select(0, rows.idx)

    @staticmethod
    def backward(ctx, ct):
        rows = ctx.rows
        grad = ct.new_zeros((ctx.n_rows, ct.shape[1]))
        for a, b in rows.segments:
            grad.index_add_(0, rows.idx[a:b], ct[a:b])
        return grad, None


def gather_send_rows(table: torch.Tensor, rows) -> torch.Tensor:
    """``table.index_select(0, rows.idx)``, whose gradient adds one segment
    at a time, in segment order (``index_select``'s own backward adds with
    atomics on the card, in no fixed order). A segment repeats no row but
    its padding's row 0, whose cotangents the exchange gives as zero, so
    each table row's cotangents sum in send order, the same from run to
    run, with no wait for the host (capturable into a CUDA graph); on the
    CPU the gradient is bit-equal to ``index_add_`` of any cotangents.
    ``rows`` may also be a plain index tensor on the CPU, one segment
    (the CPU's ``index_add_`` adds in index order); off the CPU it
    raises."""
    if isinstance(rows, torch.Tensor):
        if rows.device.type != "cpu":
            raise ValueError(
                f"gather_send_rows: a plain index tensor on {rows.device} "
                f"has no segments to add in order; pass send_indices' "
                f"SendRows")
        rows = SendRows(rows, ((0, rows.numel()),))
    return _SendGather.apply(table, rows)


# ---------------------------------------------------------------------------
# The sharded ELL layouts.
# ---------------------------------------------------------------------------


def _layout_defaults(rps, r, k_pad, span_pass_limit):
    """gcn_tpu's defaults: the window height (the tiler's, but never past
    the band), and the span limit (the argument, else GCN_TPU_SPAN_LIMIT,
    else k_pad / 2; 0 or less: no limit)."""
    from gcn_tpu_torch.tile.ell import DEFAULT_R

    if r is None:
        r = DEFAULT_R if rps >= DEFAULT_R else max(8, rps // 8 * 8)
    if span_pass_limit is None:
        env = os.environ.get("GCN_TPU_SPAN_LIMIT")
        span_pass_limit = (int(env) if env is not None
                           else max(1, k_pad // 2))
    if span_pass_limit <= 0:
        span_pass_limit = 1 << 30
    return r, span_pass_limit


def _indptr_of(cols, n):
    """CSR row pointer of the transpose of edges with these columns."""
    return np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=n))])


def build_sharded_ell(sg: ShardedGraph, plan, *, r: int = None,
                      k_pad: int = 32, products_bf16: bool = False,
                      part: str = "all", span_pass_limit: int = None,
                      table_bf16: bool = False, part_order: bool = False,
                      shards=None, device=None):
    """One ``EllAdj`` per shard of ``shards`` (every shard by default) over
    its halo-remapped band matrix, on ``device`` (the card by default,
    ``device="cpu"`` for the CPU).

    ``part``: "all", one matrix over concat(halo, band) (n_cols =
    halo_rows + rps); "interior", the on-band edges only, columns in [0,
    rps) (gathers straight from the band, independent of the exchange);
    "boundary", the off-band edges only, over the halo [0, halo_rows).

    The layout is gcn_tpu's LOCKSTEP one: every shard gets the same
    per-window pass counts, the maximum over shards, laddered to the
    48-segment budget only when it is already nonincreasing (not
    ``_fit_counts``' envelope), as shard_map's uniform shapes need; the
    port keeps it so that its arrays equal gcn_tpu's. Each ``EllAdj``
    carries its own ``win_off`` / ``t_win_off`` and stored-edge count
    ``nnz``. ``span_pass_limit``, ``products_bf16`` and ``table_bf16`` as in
    ``build_sharded_ell_blocks``.

    ``part_order`` (the parts only): each band's rows sorted by the PART's
    degree before tiling. Returns ``(adjs, take_idx, back_idx)``: the part's
    output is in sorted order and ``unpermute_rows(out, take_idx[i],
    back_idx[i])`` restores band order (take_idx: each band row's rank;
    back_idx: the sorted order, take_idx's inverse).
    """
    from gcn_tpu_torch.graph.csr import coo_to_csr
    from gcn_tpu_torch.tile.ell import (EllAdj, _MAX_REDUCE_SEGMENTS,
                                        _ell_arrays, _guard_spans,
                                        _quantize_passes, _span_plan,
                                        _win_offsets, _window_passes,
                                        walk_split)
    from gcn_tpu_torch.utils.device import resolve_device

    if part not in ("all", "interior", "boundary"):
        raise ValueError("part must be 'all', 'interior' or 'boundary'")
    if part_order and part == "all":
        raise ValueError("part_order applies to the interior and boundary "
                         "parts")
    device = resolve_device(device)
    ns, rps = sg.n_shards, sg.rows_per_shard
    shards = range(ns) if shards is None else list(shards)
    r, span_pass_limit = _layout_defaults(rps, r, k_pad, span_pass_limit)
    p = 128 // k_pad
    halo_cols = plan.halo_rows
    n_cols = {"all": halo_cols + rps, "interior": rps,
              "boundary": halo_cols}[part]

    # every shard's CSR: the lockstep counts need them all
    graphs, takes, backs = [], {}, {}
    for d in range(ns):
        vals = sg.vals[d]
        remap = plan.col_remap[d]
        real = vals != 0
        cols_d = remap
        if part == "interior":
            real = real & (remap >= halo_cols)
            cols_d = remap - halo_cols
        elif part == "boundary":
            real = real & (remap < halo_cols)
        rows_d = sg.rows_local[d][real]
        if part_order:
            deg = np.bincount(rows_d, minlength=rps)
            perm = np.argsort(-deg, kind="stable").astype(np.int32)
            rank = np.empty(rps, dtype=np.int32)
            rank[perm] = np.arange(rps, dtype=np.int32)
            rows_d = rank[rows_d]
            takes[d], backs[d] = rank, perm
        graphs.append(coo_to_csr(rows_d, cols_d[real], vals[real],
                                 (rps, n_cols)))

    def shared_passes(indptrs, n):
        ps = np.maximum.reduce([_window_passes(ip, n, r, p)
                                for ip in indptrs])
        if (len(np.unique(ps)) > _MAX_REDUCE_SEGMENTS
                and bool((np.diff(ps) <= 0).all())):
            ps = _quantize_passes(ps, _MAX_REDUCE_SEGMENTS)
        return ps

    pf = shared_passes([g.indptr for g in graphs], rps)
    pt = shared_passes([_indptr_of(g.indices, n_cols) for g in graphs],
                       n_cols)

    def layout(g, n, passes):
        cols, vals, win, off = _ell_arrays(g.indptr, g.indices, g.data, n, r,
                                           p, forced_passes=passes)
        return cols, vals, win, _guard_spans(_span_plan(off),
                                             span_pass_limit)

    def dev(a):
        return torch.from_numpy(a).to(device)

    adjs = []
    for d in shards:
        cols, vals, win, spans = layout(graphs[d], rps, pf)
        t_cols, t_vals, t_win, t_spans = layout(graphs[d].transpose(),
                                                n_cols, pt)
        win_off = _win_offsets(win, len(pf))
        t_win_off = _win_offsets(t_win, len(pt))
        adjs.append(EllAdj(
            cols=dev(cols), vals=dev(vals), win=dev(win),
            win_off=dev(win_off), t_cols=dev(t_cols),
            t_vals=dev(t_vals), t_win=dev(t_win),
            t_win_off=dev(t_win_off), split=walk_split(win_off, p, device),
            t_split=walk_split(t_win_off, p, device), n_rows=rps,
            n_cols=n_cols, nnz=graphs[d].nnz, r=r, k_pad=k_pad,
            symmetric=False, products_bf16=products_bf16,
            chunks=((0, cols.shape[0], 0, -(-rps // r)),),
            t_chunks=((0, t_cols.shape[0], 0, -(-n_cols // r)),),
            spans=spans, t_spans=t_spans, table_bf16=table_bf16,
            span_pass_limit=span_pass_limit))
    if part_order:
        return (adjs, [dev(takes[d].astype(np.int64)) for d in shards],
                [dev(backs[d].astype(np.int64)) for d in shards])
    return adjs


def _fit_counts(counts: np.ndarray, budget: int = None) -> np.ndarray:
    """Make a per-window block-count sequence span-budget-friendly:
    identity if its runs already fit, else the nonincreasing envelope
    (reverse cummax) laddered to the segment budget (tile/ell.py);
    ``budget`` tightens the default budget of 48 segments."""
    from gcn_tpu_torch.tile.ell import (_MAX_REDUCE_SEGMENTS, _pass_runs,
                                        _quantize_passes)

    budget = budget or _MAX_REDUCE_SEGMENTS
    if (len(np.unique(counts)) <= budget
            and _pass_runs(counts) <= budget):
        return counts
    mono = np.maximum.accumulate(counts[::-1])[::-1]
    if len(np.unique(mono)) > budget:
        mono = _quantize_passes(mono, budget)
    return mono


def build_sharded_ell_blocks(sg: ShardedGraph, plan, *,
                             r: int = None, k_pad: int = 32,
                             span_pass_limit: int = None,
                             products_bf16: bool = False,
                             table_bf16: bool = False,
                             part_segment_budget: int = None, shards=None,
                             device=None):
    """Pass-block partition of each band's lockstep layout:
    ``(interior, halo)``, two lists with one ``EllAdj`` per shard of
    ``shards`` (every shard by default), on ``device`` (the card by
    default, ``device="cpu"`` for the CPU); ``plan`` is any of the three.

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
    steers nothing on the card) follow ``span_pass_limit``, else the
    GCN_TPU_SPAN_LIMIT environment variable, else k_pad / 2, as gcn_tpu's
    do (0 or less: no limit). ``products_bf16`` and ``table_bf16`` are
    K1's two bf16 options, carried by every part. ``part_segment_budget``
    tightens ``_fit_counts``' budget for the two parts' forward counts.
    """
    from gcn_tpu_torch.graph.csr import coo_to_csr
    from gcn_tpu_torch.tile.ell import (EllAdj, _ell_arrays, _guard_spans,
                                        _span_plan, _win_offsets,
                                        _window_passes, walk_split)
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    ns, rps = sg.n_shards, sg.rows_per_shard
    shards = range(ns) if shards is None else list(shards)
    r, span_pass_limit = _layout_defaults(rps, r, k_pad, span_pass_limit)
    p = 128 // k_pad
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
    hp = _fit_counts(np.maximum(hb, 1), part_segment_budget)       # halo
    ip = _fit_counts(np.maximum(pf - hb, 1), part_segment_budget)  # interior

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
        pt = _fit_counts(np.maximum.reduce(
            [_window_passes(_indptr_of(cc, n_rows_t), n_rows_t, r, p)
             for _, _, cc, _ in edges]))
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
        win_off = _win_offsets(win, nw)
        t_win_off = _win_offsets(t_win, nw_t)
        split, t_split = (walk_split(win_off, p, device),
                          walk_split(t_win_off, p, device))
        win_off, t_win_off = dev(win_off), dev(t_win_off)
        parts.append([EllAdj(
            cols=dev(cols), vals=dev(vals), win=win_d, win_off=win_off,
            t_cols=dev(t_cols), t_vals=dev(t_vals), t_win=t_win_d,
            t_win_off=t_win_off, split=split, t_split=t_split, n_rows=rps,
            n_cols=n_cols_part,
            nnz=int((vals != 0).sum()), r=r, k_pad=k_pad, symmetric=False,
            products_bf16=products_bf16,
            chunks=((0, cols.shape[0], 0, nw),),
            t_chunks=((0, t_cols.shape[0], 0, nw_t),),
            spans=spans, t_spans=t_spans, table_bf16=table_bf16,
            span_pass_limit=span_pass_limit)
            for (cols, vals), (t_cols, t_vals) in zip(fwd, bwd)])
    return parts[0], parts[1]


class _Unpermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, take_idx, back_idx):
        ctx.save_for_backward(back_idx)
        return y.index_select(0, take_idx)

    @staticmethod
    def backward(ctx, ct):
        (back_idx,) = ctx.saved_tensors
        return ct.index_select(0, back_idx), None, None


def unpermute_rows(y: torch.Tensor, take_idx: torch.Tensor,
                   back_idx: torch.Tensor) -> torch.Tensor:
    """``y[take_idx]`` whose gradient is the gather by ``back_idx`` (the
    forward permutation, take_idx's inverse), as gcn_tpu's custom VJP: a
    part computed in part-degree-sorted row order back to band order,
    with no scatter-add in the backward."""
    return _Unpermute.apply(y, take_idx, back_idx)


# ---------------------------------------------------------------------------
# The exchange: routes of row moves.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Route:
    """Row moves between shards: ``moves[i] = (a, b, src_row, dst_row,
    rows)`` takes rows ``src_row:src_row + rows`` of shard a's send buffer
    (``src_rows`` high) to rows ``dst_row:...`` of shard b's receive buffer
    (``dst_rows`` high); every shard's moves, in one global order.
    ``all_to_all``: between processes one ``all_to_all_single`` (else
    point-to-point messages tagged ``tag0`` + the move's index). ``sums``:
    several moves read one send row, so the reversed route adds."""

    moves: tuple
    src_rows: int
    dst_rows: int
    all_to_all: bool = False
    tag0: int = 0
    sums: bool = False


def _shift_moves(sizes, dest, n_shards):
    """Segment i of every shard's send buffer to the same rows of shard
    ``dest(a, i)``'s receive buffer, for each nonzero ``sizes[i]``."""
    moves, off = [], 0
    for i, h in enumerate(sizes):
        if h:
            moves += [(a, dest(a, i), off, off, h) for a in range(n_shards)]
            off += h
    return tuple(moves)


def _slot_moves(mesh, moves, tag0):
    """The band-level ``moves`` on every model slot: move i between bands a
    and b runs between slots a * m + j and b * m + j for each model index j
    (the exchange of one model slot joins the bands of that slot), tagged
    (tag0 + i) * m + j. On a 1-D mesh (m = 1) the moves themselves."""
    m = mesh.n_model
    return [((a * m + j, b * m + j, s0, d0, h), (tag0 + i) * m + j)
            for i, (a, b, s0, d0, h) in enumerate(moves) for j in range(m)]


def _transfer(mesh, moves, src, dst, all_to_all, tag0, add):
    """Start ``moves`` from the owned slots' ``src`` buffers into their
    ``dst`` buffers (lists in owned order): copies now for moves within this
    process, the rest in flight. Returns ``finish()``, which waits for them.
    ``add``: each piece adds into its rows (in their dtype) instead of
    overwriting them. Every move stays within one data group, so the
    all-to-all runs on this rank's."""
    rank = mesh.rank
    li = mesh.local_index
    owner = mesh.owner
    group_pos = {r: i for i, r in enumerate(mesh.data_ranks)}
    k = src[0].shape[1]

    def put(view, piece):
        if add:
            view.add_(piece.to(view.dtype))
        else:
            view.copy_(piece)

    ops, after = [], []
    sends = [[] for _ in group_pos]
    recvs = [[] for _ in group_pos]
    for (a, b, s0, d0, h), tag in _slot_moves(mesh, moves, tag0):
        mine_a, mine_b = owner(a) == rank, owner(b) == rank
        if mine_a and mine_b:
            put(dst[li(b)][d0:d0 + h], src[li(a)][s0:s0 + h])
        elif mine_a:
            piece = src[li(a)][s0:s0 + h]
            if all_to_all:
                sends[group_pos[owner(b)]].append(piece)
            else:
                ops.append(dist.P2POp(dist.isend, piece.view(torch.uint8),
                                      owner(b), tag=tag))
        elif mine_b:
            view = dst[li(b)][d0:d0 + h]
            if all_to_all:
                recvs[group_pos[owner(a)]].append(view)
                continue
            buf = view
            if add:
                buf = src[0].new_empty((h, k))
                after.append((view, buf))
            ops.append(dist.P2POp(dist.irecv, buf.view(torch.uint8),
                                  owner(a), tag=tag))
    works = dist.batch_isend_irecv(ops) if ops else []
    keep = [ops]               # the message buffers live until the wait
    if all_to_all and mesh.data_parallel:
        out_rows = [sum(v.shape[0] for v in views) for views in recvs]
        inp = torch.cat([piece for pieces in sends for piece in pieces]
                        or [src[0][:0]])
        out = src[0].new_empty((sum(out_rows), k))
        works.append(dist.all_to_all_single(
            out.view(torch.uint8), inp.view(torch.uint8),
            output_split_sizes=out_rows,
            input_split_sizes=[sum(p.shape[0] for p in pieces)
                               for pieces in sends],
            group=mesh.data_group, async_op=True))
        keep.append(inp)
        o = 0
        for views in recvs:
            for view in views:
                after.append((view, out[o:o + view.shape[0]]))
                o += view.shape[0]

    def finish():
        for work in works:
            work.wait()
        for view, piece in after:
            put(view, piece)
        keep.clear()

    return finish


class _Start(torch.autograd.Function):
    """Start a route on the owned shards' send buffers; returns their
    receive buffers, filled once ``_Wait`` has waited. Backward: the route
    reversed on the buffers' cotangents (a sum in float32 where the route
    ``sums``), cast to the send buffers' dtype."""

    @staticmethod
    def forward(ctx, pending, *send):
        # ctx keeps the route, not ``pending``: pending holds this node's
        # outputs until the wait, and ctx -> pending -> outputs -> ctx
        # would be a reference cycle
        route = ctx.route = pending.route
        ctx.mesh = pending.mesh
        recv = [s.new_empty((route.dst_rows, s.shape[1])) for s in send]
        pending.finish = _transfer(pending.mesh, route.moves, send, recv,
                                   route.all_to_all, route.tag0, add=False)
        return tuple(recv)

    @staticmethod
    def backward(ctx, *grads):
        route = ctx.route
        grads = [g.contiguous() for g in grads]
        acc = torch.float32 if route.sums else grads[0].dtype
        back = [g.new_zeros((route.src_rows, g.shape[1]), dtype=acc)
                for g in grads]
        moves = tuple((b, a, d0, s0, h) for a, b, s0, d0, h in route.moves)
        _transfer(ctx.mesh, moves, grads, back, route.all_to_all,
                  route.tag0, add=route.sums)()
        return (None, *(b.to(g.dtype) for b, g in zip(back, grads)))


class _Wait(torch.autograd.Function):
    """Wait for a started route; returns its receive buffers, now filled.
    Backward: the identity."""

    @staticmethod
    def forward(ctx, pending, *recv):
        finish, pending.finish = pending.finish, None
        finish()
        ctx.mark_dirty(*recv)
        return recv

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _Pending:
    """One route in flight over the owned shards' send buffers."""

    def __init__(self, mesh, route, send):
        self.mesh, self.route, self.finish = mesh, route, None
        self.recv = _Start.apply(self, *send)

    def wait(self):
        """The owned shards' receive buffers."""
        recv, self.recv = self.recv, None
        return list(_Wait.apply(self, *recv))


class _PendingHalo:
    """An exchange in flight; ``wait()`` returns each owned shard's halo
    table, in the compute dtype."""

    def __init__(self, finish):
        self._finish = finish

    def wait(self):
        finish, self._finish = self._finish, None
        return finish()


def _prep_send(x_band, send_idx, pre, wire_dtype):
    """Gather send rows, apply the optional ``pre`` transform, cast for the
    wire. Returns (rows, out_dtype): out_dtype is what the halo table is
    cast back to on arrival.

    Narrow-range wire dtypes get a clip to the wire's finite range first:
    float8_e4m3fn tops out at 448, and JAX turns an overflow into NaN
    (torch's cast saturates), so the clip makes both packages send the
    same bytes. bf16 shares f32's exponent range, so it is not clipped.
    """
    rows = gather_send_rows(x_band, send_idx)
    if pre is not None:
        rows = pre(rows)
    out_dtype = rows.dtype
    if wire_dtype is not None:
        wmax = torch.finfo(wire_dtype).max
        if wmax < torch.finfo(out_dtype).max:
            rows = rows.clamp(-wmax, wmax)
        rows = rows.to(wire_dtype)
    return rows, out_dtype


def _prep_all(x_bands, send_idx, pre, wire_dtype):
    """``_prep_send`` of every owned shard: (rows list, out_dtype)."""
    rows = [_prep_send(x, idx, pre, wire_dtype) for x, idx in
            zip(x_bands, send_idx)]
    return [r.contiguous() for r, _ in rows], rows[0][1]


def _exchange_halo(route, zero_head, send_idx, x_bands, mesh, pre=None,
                   wire_dtype=None) -> _PendingHalo:
    """Start the one-route exchange of the owned shards' boundary rows
    (``send_idx`` and ``x_bands`` list the owned shards in order): the
    ragged plan's ring shifts, whose halo sits behind ``zero_head``'s 8 zero
    rows (the padding edges' target), or the padded all-to-all of each
    owned shard's ns x h_max send rows (the self slice included, as
    gcn_tpu's all_to_all ships it; halo block s of shard d holds what s
    sent d). ``pre`` is applied to the gathered send rows before they leave
    (the boundary-rows-first trick: with ``rows -> rows @ W`` the payload is
    the transformed rows, so the full-band ``X @ W`` and the interior
    aggregation can run while they travel). ``wire_dtype`` (bfloat16,
    float8_e4m3fn) casts the payload for the wire only."""
    rows, out_dtype = _prep_all(x_bands, send_idx, pre, wire_dtype)
    pending = _Pending(mesh, route, rows)

    def finish():
        recv = pending.wait()
        if zero_head:
            recv = [torch.cat([r.new_zeros((8, r.shape[1])), r])
                    for r in recv]
        return [r.to(out_dtype) for r in recv]

    return _PendingHalo(finish)


def _exchange_halo_hier(routes, ragged_fan, send_idx, x_bands, mesh,
                        pre=None, wire_dtype=None) -> _PendingHalo:
    """Start the two-level exchange: the chip-offset shifts of the
    same-host rows and the host-offset shifts of the unions; the wait then
    fans the received unions out over the chips (the ragged subsets,
    gathered from the received buffer, or every union to every same-host
    chip) and builds the halo. ``pre`` and ``wire_dtype`` apply to both
    send sets, and the fan-out travels in the wire dtype too."""
    intra_route, inter_route, fan_route = routes
    rows_i, out_dtype = _prep_all(x_bands, [i[0] for i in send_idx], pre,
                                  wire_dtype)
    rows_e, _ = _prep_all(x_bands, [i[1] for i in send_idx], pre,
                          wire_dtype)
    intra = _Pending(mesh, intra_route, rows_i)
    inter = _Pending(mesh, inter_route, rows_e)

    def finish():
        recv_i = intra.wait()
        recv_e = inter.wait()
        if not ragged_fan:
            fan = _Pending(mesh, fan_route, recv_e).wait()
            parts = zip(recv_i, fan)
        else:
            # the unions in the compute dtype: the ragged fan-out reads
            # them twice (in place and gathered), and their cotangents add
            # there (float8 has no add)
            unions = [u.to(out_dtype) for u in recv_e]
            fan = _Pending(mesh, fan_route, [
                gather_send_rows(u, idx[2]).to(r.dtype)
                for u, idx, r in zip(unions, send_idx, recv_e)]).wait()
            parts = zip(recv_i, unions, fan)
        return [torch.cat([p[0].new_zeros((8, p[0].shape[1]),
                                          dtype=out_dtype)]
                          + [t.to(out_dtype) for t in p]) for p in parts]

    return _PendingHalo(finish)


def make_halo_exchange(plan, wire_dtype=None):
    """exchange(send_idx, x_bands, mesh, pre=None) -> a pending exchange
    whose ``wait()`` gives the owned shards' halo tables, for any of the
    three plans (``send_idx`` as ``send_indices`` gives it). The routes are
    built once, here."""
    if isinstance(plan, HierHaloPlan):
        nh, nc = plan.n_hosts, plan.n_chips
        ns = nh * nc
        sum_i, sum_e = sum(plan.intra_sizes), sum(plan.inter_sizes)

        def chip_shift(a, t):
            return a // nc * nc + (a % nc + t) % nc

        intra = _shift_moves(plan.intra_sizes,
                             lambda a, i: chip_shift(a, i + 1), ns)
        inter = _shift_moves(
            plan.inter_sizes,
            lambda a, i: ((a // nc + i + 1) % nh) * nc + a % nc, ns)
        tag = len(intra) + len(inter)
        if plan.fan_sizes is None:
            # every union to every chip of its host, chip-major
            fan = _Route(tuple((a, chip_shift(a, t), 0, a % nc * sum_e,
                                sum_e) for t in range(nc) for a in range(ns)
                               if sum_e), sum_e, nc * sum_e, tag0=tag,
                         sums=True)
        else:
            fan_rows = sum(plan.fan_sizes)
            fan = _Route(_shift_moves(
                plan.fan_sizes, lambda a, i: chip_shift(a, i % (nc - 1) + 1),
                ns), fan_rows, fan_rows, tag0=tag)
        routes = (_Route(intra, sum_i, sum_i),
                  _Route(inter, sum_e, sum_e, tag0=len(intra)), fan)
        return partial(_exchange_halo_hier, routes,
                       plan.fan_sizes is not None, wire_dtype=wire_dtype)
    ns = plan.n_shards
    if isinstance(plan, RaggedHaloPlan):
        rows = sum(plan.sizes)
        route = _Route(_shift_moves(plan.sizes,
                                    lambda a, i: (a + i + 1) % ns, ns),
                       rows, rows)
        return partial(_exchange_halo, route, True, wire_dtype=wire_dtype)
    h = plan.h_max
    route = _Route(tuple((a, b, b * h, a * h, h) for a in range(ns)
                         for b in range(ns)), ns * h, ns * h,
                   all_to_all=True)
    return partial(_exchange_halo, route, False, wire_dtype=wire_dtype)


# ---------------------------------------------------------------------------
# Sharded SpMMs over the exchange.
# ---------------------------------------------------------------------------


def dist_spmm_halo(shard_arrays, send_idx, x_bands, mesh, exchange):
    """SpMM of the owned bands with the boundary-only exchange and a
    segment sum (``spmm_dist.local_spmm``, the counterpart of XLA's sorted
    segment_sum, in a fixed order): ``shard_arrays`` are the owned shards'
    (col_remap, vals, row_len)."""
    halos = exchange(send_idx, x_bands, mesh).wait()
    return [local_spmm(col_remap, vals, torch.cat([halo, x]), row_len)
            for (col_remap, vals, row_len), halo, x in zip(
                shard_arrays, halos, x_bands)]


def dist_spmm_halo_ell(ell, send_idx, x_bands, mesh, exchange):
    """K1 on each owned shard's monolithic layout (``build_sharded_ell``,
    part "all") over concat(halo, band), after the exchange."""
    from gcn_tpu_torch.ops.ell_spmm import spmm_ell

    halos = exchange(send_idx, x_bands, mesh).wait()
    return [spmm_ell(a, torch.cat([h, x]))
            for a, h, x in zip(ell, halos, x_bands)]


def _unpermuted(outs, unperm):
    if unperm is None:
        return outs
    return [unpermute_rows(o, *u) for o, u in zip(outs, unperm)]


def _overlap(ell_int, ell_halo, send_idx, x_bands, mesh, exchange, table,
             int_unperm=None, bnd_unperm=None):
    """The exchange issued first, the interior parts (K1 on the band) while
    it travels, the halo parts (K1 on ``table(halo, band)``) after the
    wait; each part back in band order before the add."""
    from gcn_tpu_torch.ops.ell_spmm import spmm_ell

    pending = exchange(send_idx, x_bands, mesh)
    interior = _unpermuted([spmm_ell(a, x) for a, x in zip(ell_int,
                                                           x_bands)],
                           int_unperm)
    halo = _unpermuted([spmm_ell(a, table(h, x)) for a, h, x in
                        zip(ell_halo, pending.wait(), x_bands)], bnd_unperm)
    return [i + h for i, h in zip(interior, halo)]


def _overlap_xw(ell_int, ell_halo, send_idx, x_bands, w, mesh, exchange,
                chunk, table, int_unperm=None, bnd_unperm=None):
    """Fused ``A @ (X W)`` with the boundary-rows-first exchange and the
    k-chunked pipeline.

    The send rows are gathered from the RAW band and transformed by a
    small ``rows @ W`` before they leave, so every exchange is issued
    before the full-band ``X @ W`` and the interior K1. With ``chunk`` below
    W's width the exchange and the halo aggregation split into
    ceil(f_out / chunk) column slices: slice c's halo K1 runs while the
    later slices travel. Each output column depends only on its own halo
    column, so the slices are exact. The halo K1 reads ``table(halo
    slice, h slice)``."""
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
    interior = _unpermuted([spmm_ell(a, hb) for a, hb in zip(ell_int, h)],
                           int_unperm)
    parts = [[] for _ in h]
    for (c0, c1), pending in zip(cuts, pendings):
        for i, halo in enumerate(pending.wait()):
            hc = h[i] if (c0, c1) == (0, f_out) else h[i][:, c0:c1]
            parts[i].append(spmm_ell(ell_halo[i], table(halo, hc)))
    halo = _unpermuted([p[0] if len(p) == 1 else torch.cat(p, dim=1)
                        for p in parts], bnd_unperm)
    return [i + b for i, b in zip(interior, halo)]


def _band_table(halo, band):
    return torch.cat([halo, band])


def _halo_only(halo, band):
    return halo


def dist_spmm_halo_ell_overlap_blocks(ell_int, ell_halo, send_idx, x_bands,
                                      mesh, exchange):
    """Overlap via the pass-block partition: the exchange is issued first,
    the interior parts (K1 on the band) run while it travels, and the halo
    parts (K1 on concat(halo, band)) after the wait."""
    return _overlap(ell_int, ell_halo, send_idx, x_bands, mesh, exchange,
                    _band_table)


def dist_spmm_halo_ell_overlap_blocks_xw(ell_int, ell_halo, send_idx,
                                         x_bands, w, mesh, exchange,
                                         chunk=None):
    """Fused ``A @ (X W)`` on the pass-block partition (``_overlap_xw``:
    the halo part reads concat(halo, band))."""
    return _overlap_xw(ell_int, ell_halo, send_idx, x_bands, w, mesh,
                       exchange, chunk, _band_table)


def dist_spmm_halo_ell_overlap(ell_interior, ell_boundary, send_idx,
                               x_bands, mesh, exchange, int_unperm=None,
                               bnd_unperm=None):
    """Overlap via the row-split parts: the interior parts (K1 on the band)
    run while the exchange travels, the boundary parts (K1 on the halo)
    after the wait. ``int_unperm`` / ``bnd_unperm``: each owned shard's
    (take_idx, back_idx) from ``build_sharded_ell(part_order=True)``, which
    restore each part's output to band order before the add."""
    return _overlap(ell_interior, ell_boundary, send_idx, x_bands, mesh,
                    exchange, _halo_only, int_unperm, bnd_unperm)


def dist_spmm_halo_ell_overlap_xw(ell_interior, ell_boundary, send_idx,
                                  x_bands, w, mesh, exchange, chunk=None,
                                  int_unperm=None, bnd_unperm=None):
    """Fused ``A @ (X W)`` on the row-split parts (``_overlap_xw``: the
    boundary part reads the halo alone), each part restored to band order
    as in ``dist_spmm_halo_ell_overlap``."""
    return _overlap_xw(ell_interior, ell_boundary, send_idx, x_bands, w,
                       mesh, exchange, chunk, _halo_only, int_unperm,
                       bnd_unperm)
