"""Analytic weak-scaling projection from exact exchange volumes, on the
H100's own rates.

The port of ``gcn_tpu.parallel.projection``. The halo planners
(``parallel/halo.py``) run on host numpy at any shard count, so the rows
each card ships per SpMM, within a node and between nodes, come from the
real plans of a weak-scaled graph run through the real pipeline (rabbit
reorder, in-band degree sort, row-band shards); they equal gcn_tpu's,
integer for integer. Only the TIME conversion is a model:

    t_comp  = edges_per_device / spmm_rate
    t_comm  = ici_bytes / bw_ici + dcn_bytes / bw_dcn
    exposed = max(0, t_comm - overlap_frac * t_comp)
    eff     = t_comp / (t_comp + exposed)

where overlap_frac is the interior-edge fraction (the overlap hides the
exchange behind the interior aggregation). The names of the tiers are
gcn_tpu's; on this machine "ici" is NVLink within an HGX H100 node of
``chips_per_host`` = 8 cards and "dcn" is the network between nodes.
Every efficiency is reported at 0.5x/1x/2x the link bandwidths, plus the
smallest bandwidth scale at which the 90% target holds.

The rates are the card's own, read from the capture the package commits
(``captures/h100.json``): K1's plain rate at synth-arxiv k = 32 and the
sharded layouts' cost over it at k_pad 32 and 128, and the f32 matmul rate
at the full step's shapes (``time_sharded.py``); NVLink's one-direction
bandwidth over NCCL (``time_links.py``). ``bw_dcn`` cannot be measured on
one machine: its default is an assumption, one 400 Gb/s NDR NIC a card as
on a DGX H100 node, and the meta of a projection says so. ``DEFAULTS`` and
``FULLSTEP_DEFAULTS`` hold the capture's values and stand in only when the
capture is missing, tagged ``"DEFAULTS (no capture)"``.

Flat multi-node exchanges are charged entirely at the network's rate: each
ring offset is one lockstep round, and once shards span nodes nearly every
offset holds a cross-node pair, so the round completes at the slowest
link's rate. The hierarchical plan (``build_halo_plan_hier``) exists for
this regime.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np

CAPTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "captures", "h100.json")
CAPTURE_NAME = "gcn_tpu_torch/captures/h100.json"

# The capture's values (NVIDIA H100 80GB HBM3, 700.00 W), used only when
# the capture is missing. bw_* are per-card effective one-direction
# bandwidths in bytes/s: bw_ici the port's exchange over NVLink and NCCL
# (time_links.py; host time included), bw_dcn the assumed 400 Gb/s NIC a
# card. spmm_edges_per_s is K1's plain rate at synth-arxiv k = 32
# (time_sharded.py).
DEFAULTS = dict(
    chips_per_host=8,
    feat_width=32,
    bytes_per_elt=4,
    spmm_edges_per_s=3.3740e10,
    bw_ici=4.8398e10,
    bw_dcn=5.0e10,
)
BW_DCN_SOURCE = ("assumed, not measured: one 400 Gb/s NDR NIC a card, as on "
                 "a DGX H100 node")
NO_CAPTURE = "DEFAULTS (no capture)"

BW_SCALES = (0.5, 1.0, 2.0)


def load_capture(path: Optional[str] = None) -> Optional[dict]:
    """The committed capture of the card's rates, or None when it is
    missing or unreadable."""
    try:
        with open(path or CAPTURE) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _source(cap: dict, path: Optional[str]) -> str:
    name = path or CAPTURE_NAME
    return f"{name} ({cap.get('card', 'card not named')})"


def measured_spmm_rate(path: Optional[str] = None):
    """(edges/s, source): K1's plain rate at synth-arxiv k = 32 from the
    capture (``time_sharded.py``); ``DEFAULTS``, tagged as such, when the
    capture is missing."""
    cap = load_capture(path)
    try:
        return float(cap["spmm"]["edges_per_s"]), _source(cap, path)
    except (TypeError, KeyError, ValueError):
        return DEFAULTS["spmm_edges_per_s"], NO_CAPTURE


def measured_mxu_flops(path: Optional[str] = None):
    """(flop/s, source): the f32 matmul rate at the full step's shapes, TF32
    off, from the capture (``time_sharded.py``)."""
    cap = load_capture(path)
    try:
        return float(cap["matmul"]["flops_per_s"]), _source(cap, path)
    except (TypeError, KeyError, ValueError):
        return FULLSTEP_DEFAULTS["mxu_flops"], NO_CAPTURE


def measured_bw_ici(path: Optional[str] = None):
    """(bytes/s, source): the rate a card's halo exchange moves its rows
    over NVLink and NCCL, the port's own exchange timed whole at the plans'
    sizes (``time_links.py``: host time included), from the capture; the
    source says where the figure was assumed rather than measured."""
    cap = load_capture(path)
    try:
        links = cap["links"]
        src = _source(cap, path)
        if not links.get("measured", False):
            src += ", assumed: " + links.get("basis", "not measured")
        return float(links["bw_ici"]), src
    except (TypeError, KeyError, ValueError):
        return DEFAULTS["bw_ici"], NO_CAPTURE


@dataclasses.dataclass(frozen=True)
class ProjectionRow:
    """Exchange volumes (exact) + modeled efficiencies for one d."""

    devices: int
    hosts: int
    n_rows: int
    edges_per_device: int        # max real slots over shards (lockstep)
    boundary_edge_frac: float    # mean fraction of edges leaving the band
    flat_rows: int               # ragged plan rows/device/SpMM
    allgather_rows: int          # what a full all-gather would ship
    hier_ici_rows: int           # intra segments + union fan-out (0 if 1 host)
    hier_dcn_rows: int           # per-host union segments (0 if 1 host)
    eff_flat: dict               # {bw_scale: efficiency}
    eff_hier: Optional[dict]     # None on a single host
    min_bw_scale_90: float       # bandwidth scale where eff >= 0.9 (best plan)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["eff_flat"] = {str(k): round(v, 4) for k, v in d["eff_flat"].items()}
        if d["eff_hier"] is not None:
            d["eff_hier"] = {
                str(k): round(v, 4) for k, v in d["eff_hier"].items()}
        d["boundary_edge_frac"] = round(d["boundary_edge_frac"], 4)
        d["min_bw_scale_90"] = round(d["min_bw_scale_90"], 3)
        return d


def _efficiency(t_comp, ici_bytes, dcn_bytes, overlap_frac,
                bw_ici, bw_dcn, scale):
    t_comm = ici_bytes / (bw_ici * scale) + dcn_bytes / (bw_dcn * scale)
    exposed = max(0.0, t_comm - overlap_frac * t_comp)
    return t_comp / (t_comp + exposed)


def _min_scale_for(target, t_comp, ici_bytes, dcn_bytes, overlap_frac,
                   bw_ici, bw_dcn):
    """Smallest joint bandwidth scale with eff >= target (closed form)."""
    base_comm = ici_bytes / bw_ici + dcn_bytes / bw_dcn
    if base_comm == 0:
        return 0.0
    # eff >= target  <=>  exposed <= t_comp*(1/target - 1)
    budget = t_comp * (1.0 / target - 1.0) + overlap_frac * t_comp
    if budget <= 0:
        return float("inf")
    return base_comm / budget


def project_weak_scaling(
    devices: Sequence[int],
    nodes_per_device: int = 8192,
    *,
    reorder: str = "rabbit",
    avg_degree: float = 14.0,
    seed: int = 0,
    chips_per_host: int = DEFAULTS["chips_per_host"],
    feat_width: int = DEFAULTS["feat_width"],
    bytes_per_elt: int = DEFAULTS["bytes_per_elt"],
    spmm_edges_per_s: Optional[float] = None,
    bw_ici: Optional[float] = None,
    bw_dcn: float = DEFAULTS["bw_dcn"],
) -> list:
    """Build REAL halo plans at each device count on a weak-scaled SBM
    and convert the exchanged bytes to projected weak-scaling efficiency.

    Everything before the time conversion runs the production pipeline on
    host numpy, no device involved, so the planners' outputs are exact at
    any shard count. ``spmm_edges_per_s`` and ``bw_ici`` default to the
    capture's (``measured_spmm_rate``, ``measured_bw_ici``).
    """
    from gcn_tpu_torch.data.synthetic import sbm
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.parallel.halo import (build_halo_plan_hier,
                                             build_halo_plan_ragged)
    from gcn_tpu_torch.parallel.partition import (band_degree_sort_order,
                                                  shard_graph_by_rows)
    from gcn_tpu_torch.reorder import reorder_graph

    if spmm_edges_per_s is None:
        spmm_edges_per_s = measured_spmm_rate()[0]
    if bw_ici is None:
        bw_ici = measured_bw_ici()[0]
    bytes_per_row = feat_width * bytes_per_elt
    rows = []
    for d in devices:
        n = nodes_per_device * d
        adj, _ = sbm(n=n, n_classes=max(8, d), avg_degree=avg_degree,
                     seed=seed)
        g = gcn_normalize(adj)
        if reorder:
            g, _ = reorder_graph(g, reorder)
        sg0 = shard_graph_by_rows(g, d)
        bperm = band_degree_sort_order(g, sg0.rows_per_shard)
        g = g.permute(bperm)
        sg = shard_graph_by_rows(g, d)

        vals = np.asarray(sg.vals)
        cols = np.asarray(sg.cols)
        real = vals != 0
        edges_dev = int(real.sum(axis=1).max())
        src_shard = cols // sg.rows_per_shard
        own = src_shard == np.arange(d)[:, None]
        nreal = max(int(real.sum()), 1)
        boundary_frac = float((real & ~own).sum() / nreal)
        overlap_frac = 1.0 - boundary_frac

        pr = build_halo_plan_ragged(sg)
        flat_rows = int(sum(pr.sizes))
        if d <= chips_per_host:
            hosts = 1
        elif d % chips_per_host == 0:
            hosts = d // chips_per_host
        else:
            # refuse rather than silently charging a multi-host slice
            # at ICI rate (a d=12, cph=8 run spans 2 hosts)
            raise ValueError(
                f"devices={d} exceeds chips_per_host={chips_per_host} "
                f"but does not divide it; pass a chips_per_host that "
                f"tiles the slice")
        t_comp = edges_dev / spmm_edges_per_s

        # flat plan: all-ICI on one host, all-DCN once shards span hosts
        flat_bytes = flat_rows * bytes_per_row
        flat_ici = flat_bytes if hosts == 1 else 0.0
        flat_dcn = 0.0 if hosts == 1 else flat_bytes
        eff_flat = {s: _efficiency(t_comp, flat_ici, flat_dcn,
                                   overlap_frac, bw_ici, bw_dcn, s)
                    for s in BW_SCALES}
        best = (flat_ici, flat_dcn)

        hier_ici_rows = hier_dcn_rows = 0
        eff_hier = None
        if hosts > 1:
            ph = build_halo_plan_hier(sg, hosts, chips_per_host)
            hier_ici_rows = int(sum(ph.intra_sizes)) + int(
                ph.ici_gather_rows)
            hier_dcn_rows = int(sum(ph.inter_sizes))
            h_ici = hier_ici_rows * bytes_per_row
            h_dcn = hier_dcn_rows * bytes_per_row
            eff_hier = {s: _efficiency(t_comp, h_ici, h_dcn, overlap_frac,
                                       bw_ici, bw_dcn, s)
                        for s in BW_SCALES}
            if eff_hier[1.0] >= eff_flat[1.0]:
                best = (h_ici, h_dcn)

        min_scale = _min_scale_for(0.9, t_comp, best[0], best[1],
                                   overlap_frac, bw_ici, bw_dcn)
        rows.append(ProjectionRow(
            devices=d, hosts=hosts, n_rows=n, edges_per_device=edges_dev,
            boundary_edge_frac=boundary_frac, flat_rows=flat_rows,
            allgather_rows=(d - 1) * sg.rows_per_shard,
            hier_ici_rows=hier_ici_rows, hier_dcn_rows=hier_dcn_rows,
            eff_flat=eff_flat, eff_hier=eff_hier,
            min_bw_scale_90=min_scale,
        ))
    return rows


# ---------------------------------------------------------------------------
# Full-training-step projection.
#
# The model above charges ONE exchange against ONE SpMM and hides it
# behind the interior aggregation only. The step does more:
#
#   * 4 exchanges per 2-layer training step (fwd + bwd per layer), each
#     shipping TRANSFORMED rows at that layer's OUTPUT width (the fused
#     boundary-rows-first form, halo.dist_spmm_halo_ell_overlap_xw) —
#     at realistic widths (nfeat 1433 -> nhid 128) this is far fewer
#     bytes than raw-feature exchange;
#   * each exchange hides behind the full-band X@W matmul AND the
#     interior aggregation (both independent of the collective);
#   * with the k-chunked pipelined exchange (exchange_chunk), the
#     BOUNDARY aggregation of already-received feature slices also runs
#     under the remaining slices' collectives, so per-exchange exposed
#     time is max(0, t_comm - t_interior - t_matmul - (C-1)/C*t_boundary)
#     with C = ceil(f_out / chunk) slices.
#
# Everything byte-shaped is still EXACT planner output; the time
# conversion adds the f32 matmul rate (mxu_flops, the name gcn_tpu gave
# it) and the sharded kernels' cost over the plain one, each read from the
# capture with its provenance.
# ---------------------------------------------------------------------------

FULLSTEP_DEFAULTS = dict(
    nfeat=128,        # synth-arxiv feature width (data/registry.py)
    nhid=128,         # a realistic hidden width
    nclass=40,
    mxu_flops=1.2573e13,  # the capture's f32 matmul flop/s at the
                       # full step's shapes, TF32 off (NVIDIA H100 80GB
                       # HBM3, 700.00 W; time_sharded.py)
    exchange_chunk=32,  # = ELL k_pad; train_step's default
    bytes_per_elt=2,    # bf16 wire (exchange_dtype="bf16")
)
# the capture's (blocks_over_plain, sharded_over_plain) by tier (NVIDIA
# H100 80GB HBM3, 700.00 W; time_sharded.py), used only without it
KERNEL_SCALES = {"k_pad_32": (10.621, 8.987),
                 "k_pad_128": (3.636, 3.116)}


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class FullStepRow:
    """Exact per-step exchange volumes + modeled full-step efficiency."""

    devices: int
    hosts: int
    n_rows: int
    edges_per_device: int
    interior_frac: float        # fraction of real slots with own-band src
    dcn_rows: int               # per device per exchange (hier unions,
                                # lockstep per-offset-max — wire truth)
    dcn_rows_mean: int          # per-source mean (the balanced floor;
                                # ratio to dcn_rows = lockstep padding)
    ici_rows: int               # intra segments + union fan-out (or flat)
    t_comp_ms: float            # plain-rate full-step compute (baseline)
    step_ms: float              # best-form step wall at scale 1.0
    eff: dict                   # {bw_scale: eff}, best form per phase,
                                # chunked; vs the plain-rate baseline —
                                # sharded-kernel slot inflation included
                                # (measured_kernel_scales)
    eff_split: dict             # forced overlap-split form
    eff_mono: dict              # forced monolithic form
    eff_unchunked: dict         # best form, no k-chunk pipeline
    min_bw_scale_90: float      # joint bw scale where best eff >= 0.9
    hub_delta_rows: Optional[int]   # best hub-replication DCN delta
    hub_best: Optional[dict]        # its parameters (None on 1 host)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("eff", "eff_split", "eff_mono", "eff_unchunked"):
            d[k] = {str(s): round(v, 4) for s, v in d[k].items()}
        d["interior_frac"] = round(d["interior_frac"], 4)
        d["t_comp_ms"] = round(d["t_comp_ms"], 4)
        d["step_ms"] = round(d["step_ms"], 4)
        d["min_bw_scale_90"] = round(d["min_bw_scale_90"], 3)
        return d


def _hier_volumes(needed, d, n_hosts, n_chips, hub_min_demand=0):
    """(inter_rows, intra_plus_fan_rows, inter_rows_mean, hub_stats)
    from boundary sets. ``inter_rows`` is the lockstep per-offset-max
    total (what the rounds of one payload height ship, padding
    included); ``inter_rows_mean`` is the per-source mean: their ratio
    is the padding a per-offset-uniform payload pays for source
    imbalance.

    The "ici" counts match the hierarchical plan's ragged fan-out
    (``build_halo_plan_hier(fanout="ragged")``): received unions are
    read in place at chip offset 0 and only each destination's needed
    subset moves at the other chip offsets.

    hub_min_demand > 0 evaluates the hub-replication variant: rows
    referenced by >= that many remote hosts are pulled out of every
    union and instead all-gathered (host-axis ring: (n_hosts-1) *
    hub_per_shard network rows a device). Returns the variant's volumes
    so the projection can compare plans on exact bytes.
    """
    union = {}
    for s in range(d):
        hs = s // n_chips
        for hd in range(n_hosts):
            if hd == hs:
                continue
            union[hd, s] = np.unique(np.concatenate(
                [needed[hd * n_chips + c, s] for c in range(n_chips)]))
    hubset = frozenset()
    hub_stats = None
    if hub_min_demand > 0:
        demand = {}
        for (hd, s), u in union.items():
            for lid in u.tolist():
                demand[(s, lid)] = demand.get((s, lid), 0) + 1
        hubset = frozenset(k for k, v in demand.items()
                           if v >= hub_min_demand)
        own = np.zeros(d, np.int64)
        for (s, _l) in hubset:
            own[s] += 1
        hps = _ceil_to(int(own.max()), 8) if hubset else 0
        hub_stats = dict(min_demand=hub_min_demand, n_hubs=len(hubset),
                         hub_per_shard=hps,
                         allgather_dcn_rows=(n_hosts - 1) * hps)
    inter = 0
    inter_mean = 0.0
    for th in range(1, n_hosts):
        sizes = [sum(1 for l in union[(s // n_chips + th) % n_hosts,
                                      s].tolist()
                     if (s, l) not in hubset)
                 for s in range(d)]
        h = max(sizes)
        inter += _ceil_to(h, 8) if h else 0
        inter_mean += sum(sizes) / max(len(sizes), 1)
    intra = 0
    for t in range(1, n_chips):
        h = max(
            sum(1 for l in needed[hh * n_chips + (c + t) % n_chips,
                                  hh * n_chips + c].tolist()
                if (hh * n_chips + c, l) not in hubset)
            for hh in range(n_hosts) for c in range(n_chips))
        intra += _ceil_to(h, 8) if h else 0
    # ragged fan-out rows: per (host offset, chip offset != 0), the
    # destination's needed subset of the union (hub rows excluded —
    # they'd be replicated)
    fan = 0
    for th in range(1, n_hosts):
        for tc in range(1, n_chips):
            h = max(
                sum(1 for l in needed[
                    hh * n_chips + (c + tc) % n_chips,
                    ((hh - th) % n_hosts) * n_chips + c].tolist()
                    if (((hh - th) % n_hosts) * n_chips + c, l)
                    not in hubset)
                for hh in range(n_hosts) for c in range(n_chips))
            fan += _ceil_to(h, 8) if h else 0
    intra += fan
    if hub_stats is not None:
        inter += hub_stats["allgather_dcn_rows"]
        intra += (n_chips - 1) * n_hosts * hub_stats["hub_per_shard"]
    return inter, intra, int(inter_mean), hub_stats


def lockstep_vs_matched_dcn(needed, d, n_hosts, n_chips):
    """Measure the lockstep per-offset padding floor against a
    size-matched round schedule.

    The hierarchical plan's network exchange runs n_hosts-1 rounds; each
    round ships one payload height, so it pads every source's payload to
    the round's max. The plan groups pairs by HOST OFFSET (round t:
    source host hs -> hs+t). But a round may pair hosts any way: any
    schedule where, per chip lane, each round's host->host map is a
    perfect matching is equally implementable. This computes, on the
    exact union sizes:

      lockstep    — the shipped offset schedule's padded total
      matched     — a feasible size-matched schedule: rounds built by
                    ascending bottleneck matching (big payloads
                    co-scheduled with big), per chip lane
      rank_bound  — the schedule-relaxed floor (every sender sorts its
                    payloads desc; round r pads to the max r-th-largest)
                    — not generally feasible, the true lower envelope
                    of ANY round schedule
      mean        — the per-source mean (padding-free, infeasible with
                    static shapes)

    Returns a dict of the four row totals (per device per exchange).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_bipartite_matching

    sizes = np.zeros((d, n_hosts), np.int64)
    for s in range(d):
        hs = s // n_chips
        for hd in range(n_hosts):
            if hd == hs:
                continue
            u = np.unique(np.concatenate(
                [needed[hd * n_chips + c, s] for c in range(n_chips)]))
            sizes[s, hd] = len(u)

    lockstep = 0
    for th in range(1, n_hosts):
        lockstep += _ceil_to(int(max(
            sizes[s, (s // n_chips + th) % n_hosts]
            for s in range(d))), 8)

    # schedule-relaxed rank bound
    per_sender = np.sort(
        np.asarray([[sizes[s, hd] for hd in range(n_hosts)
                     if hd != s // n_chips] for s in range(d)]),
        axis=1)[:, ::-1]                       # (d, n_hosts-1) desc
    rank_bound = int(sum(_ceil_to(int(per_sender[:, r].max()), 8)
                         for r in range(n_hosts - 1)))

    mean = int(sizes.sum() / d)

    # feasible matched schedule: per round, the smallest threshold T
    # such that EVERY chip lane still has a perfect host-matching using
    # only remaining pairs of size <= T (ascending bottleneck greedy)
    remaining = [
        np.fromfunction(
            lambda i, j: (i != j), (n_hosts, n_hosts), dtype=int)
        for _ in range(n_chips)]

    def lane_sizes(c):
        m = np.zeros((n_hosts, n_hosts), np.int64)
        for hs in range(n_hosts):
            m[hs] = sizes[hs * n_chips + c]
        return m

    lane_sz = [lane_sizes(c) for c in range(n_chips)]

    def feasible(c, T):
        adj = sp.csr_matrix(remaining[c] & (lane_sz[c] <= T))
        match = maximum_bipartite_matching(adj, perm_type="column")
        return (match >= 0).all(), match

    matched = 0
    all_sizes = np.unique(sizes[sizes >= 0])
    for _r in range(n_hosts - 1):
        # smallest global T feasible for every lane this round
        lo, hi = 0, len(all_sizes) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if all(feasible(c, all_sizes[mid])[0]
                   for c in range(n_chips)):
                hi = mid
            else:
                lo = mid + 1
        T = all_sizes[lo]
        round_max = 0
        for c in range(n_chips):
            ok, match = feasible(c, T)
            assert ok
            for hs in range(n_hosts):
                hd = int(match[hs])
                if hd == hs:   # matching includes the diagonal? excluded
                    raise AssertionError("self pair matched")
                round_max = max(round_max, int(lane_sz[c][hs, hd]))
                remaining[c][hs, hd] = False
        matched += _ceil_to(round_max, 8)
    return dict(lockstep=int(lockstep), matched=int(matched),
                rank_bound=rank_bound, mean=mean)


def measured_kernel_scales(path: Optional[str] = None, wide: bool = False):
    """((split_scale, mono_scale), source): the sharded K1 layouts' cost
    relative to the plain K1, from the capture (``time_sharded.py``: every
    band of synth-arxiv's 8-shard pipeline, forward, against K1 on the whole
    graph). ``split_scale`` is the pass-block partition's (the step's
    overlap default; ``production_parts.blocks_over_plain``), ``mono_scale``
    the monolithic layout's (``sharded_over_plain``). ``wide`` selects the
    k_pad = 128 tier, the one a step at hidden widths above 64 runs, else
    k_pad = 32."""
    tier = "k_pad_128" if wide else "k_pad_32"
    cap = load_capture(path)
    try:
        d = cap[tier]
        s = float(d["production_parts"]["blocks_over_plain"])
        m = float(d["sharded_over_plain"])
        return (s, m), f"{_source(cap, path)} {tier}"
    except (TypeError, KeyError, ValueError):
        return KERNEL_SCALES[tier], f"{NO_CAPTURE} {tier}"


def _fullstep_phases(edges_dev, interior, rps, dcn_rows, ici_rows, *,
                     nfeat, nhid, nclass, rate, mxu_flops, bytes_per_elt,
                     bw_ici, bw_dcn, exchange_chunk,
                     split_scale=1.0, mono_scale=1.0):
    """(phases, t_base) for a 2-layer train step: the shared time model
    behind project_weak_scaling_fullstep and recommend_wire_dtype.

    Each phase carries BOTH implemented forms' costs: the overlap SPLIT
    (interior/boundary parts at ``split_scale`` x the plain kernel rate;
    exchange hides behind X@W + interior + the k-chunk share of the
    boundary) and the MONOLITHIC table (``mono_scale`` x plain; the
    single SpMM needs the halo first, so only X@W hides). ``t_base`` is
    the plain-rate compute — the single-device baseline weak-scaling
    efficiency is measured against.
    """
    k32 = edges_dev / rate  # full-band SpMM at k=32
    phases = []
    t_base = 0.0
    for fin, fout in ((nfeat, nhid), (nhid, nclass)) * 2:
        k_eff = max(_ceil_to(fout, 32), 32)
        t_sp = k32 * (k_eff / 32.0)
        t_mm = 2.0 * rps * fin * fout / mxu_flops
        t_sp_split = t_sp * split_scale
        t_int = interior * t_sp_split
        t_bnd = t_sp_split - t_int
        t_comm = (dcn_rows * fout * bytes_per_elt / bw_dcn
                  + ici_rows * fout * bytes_per_elt / bw_ici)
        C = max(-(-fout // exchange_chunk), 1) if exchange_chunk else 1
        phases.append(dict(t_comm=t_comm, t_int=t_int, t_mm=t_mm,
                           t_bnd=t_bnd, C=C,
                           t_sp_split=t_sp_split,
                           t_sp_mono=t_sp * mono_scale))
        t_base += t_sp + t_mm
    return phases, t_base


def recommend_wire_dtype(sg, plan, *, widths=None,
                         spmm_edges_per_s=None,
                         mxu_flops=None,
                         bw_ici=None,
                         bw_dcn=DEFAULTS["bw_dcn"],
                         exchange_chunk=32, target=0.9):
    """Auto halo-wire policy: ('bf16'|'fp8', details).

    fp8 (float8_e4m3fn payload, ~6% max per-element rounding on boundary
    rows) pays ONLY in the network-byte-bound regime: below it the bf16
    wire already hides behind compute and fp8 just spends accuracy
    headroom. Policy, evaluated on the EXACT volumes of the plan this
    training run built (the full-step projection's time model, the
    capture's rates wherever a rate is not passed):

      * single-level plan (no network tier) -> bf16;
      * hierarchical plan: project the full-step efficiency at bf16 and
        fp8 wires; pick fp8 iff bf16 misses ``target`` and fp8 improves
        it by 5% or more.

    Every input is host data of the plan and the capture, the same on
    every rank, so every process of a run resolves the same wire.

    Accuracy basis: the port's fp8 wire trained to the end on the H100,
    three seeds a wire, against the f32 and bf16 wires
    (``gcn_tpu_torch/results/fp8_wire_eval.json``, written by
    ``python -m gcn_tpu_torch.bench_fp8_wire``: synth-pubmed, 8 bands, the
    ragged and the 2 x 4 hierarchical exchange, 60 iterations).
    """
    if not hasattr(plan, "inter_sizes"):
        return "bf16", dict(reason="single-level exchange: no DCN tier, "
                                   "never DCN-byte-bound")
    nfeat, nhid, nclass = widths or (FULLSTEP_DEFAULTS["nfeat"],
                                     FULLSTEP_DEFAULTS["nhid"],
                                     FULLSTEP_DEFAULTS["nclass"])
    if spmm_edges_per_s is None:
        rate, rate_src = measured_spmm_rate()
    else:
        rate, rate_src = float(spmm_edges_per_s), "caller"
    if mxu_flops is None:
        mxu_flops = measured_mxu_flops()[0]
    if bw_ici is None:
        bw_ici = measured_bw_ici()[0]
    vals = np.asarray(sg.vals)
    cols = np.asarray(sg.cols)
    real = vals != 0
    edges_dev = int(real.sum(axis=1).max())
    own = (cols // sg.rows_per_shard) == np.arange(sg.n_shards)[:, None]
    interior = float((real & own).sum() / max(int(real.sum()), 1))
    dcn_rows = int(sum(plan.inter_sizes))
    ici_rows = int(sum(plan.intra_sizes)) + int(plan.ici_gather_rows)
    scales, scales_src = measured_kernel_scales(wide=nhid > 64)
    effs = {}
    for name, bpe in (("bf16", 2), ("fp8", 1)):
        phases, t_base = _fullstep_phases(
            edges_dev, interior, sg.rows_per_shard, dcn_rows, ici_rows,
            nfeat=nfeat, nhid=nhid, nclass=nclass, rate=rate,
            mxu_flops=mxu_flops, bytes_per_elt=bpe, bw_ici=bw_ici,
            bw_dcn=bw_dcn, exchange_chunk=exchange_chunk,
            split_scale=scales[0], mono_scale=scales[1])
        effs[name] = t_base / _fullstep_total(
            phases, 1.0, chunked=bool(exchange_chunk))
    # relative margin: in the deeply comm-bound regime efficiencies are
    # small but fp8's halved bytes still mean a ~2x faster step — an
    # absolute eff margin would wrongly keep bf16 there
    wire = ("fp8" if effs["bf16"] < target
            and effs["fp8"] >= effs["bf16"] * 1.05 else "bf16")
    return wire, dict(eff_bf16=round(effs["bf16"], 4),
                      eff_fp8=round(effs["fp8"], 4),
                      dcn_rows=dcn_rows, ici_rows=ici_rows,
                      interior_frac=round(interior, 4),
                      spmm_rate_source=rate_src,
                      kernel_scales_source=scales_src, target=target)


def _phase_total(ph, scale, chunked, form):
    """One exchange phase's wall time for one implementation form."""
    t_comm = ph["t_comm"] / scale
    if form == "mono":
        return (ph["t_sp_mono"] + ph["t_mm"]
                + max(0.0, t_comm - ph["t_mm"]))
    hide = ph["t_int"] + ph["t_mm"]
    if chunked and ph["C"] > 1:
        hide += (ph["C"] - 1) / ph["C"] * ph["t_bnd"]
    return (ph["t_sp_split"] + ph["t_mm"] + max(0.0, t_comm - hide))


def _fullstep_total(phases, scale, chunked, form="best"):
    """Full-step wall time at a bandwidth scale. form='best' picks the
    cheaper of split/monolithic per phase (both are implemented;
    overlap= selects them in make_sharded_gcn_train_step)."""
    total = 0.0
    for ph in phases:
        if form == "best":
            total += min(_phase_total(ph, scale, chunked, "split"),
                         _phase_total(ph, scale, chunked, "mono"))
        else:
            total += _phase_total(ph, scale, chunked, form)
    return total


def _min_scale_fullstep(phases, t_base, target=0.9):
    """Smallest bw scale with best-form chunked eff >= target."""
    def eff(scale):
        return t_base / _fullstep_total(phases, scale, True)

    if eff(1e-4) >= target:
        return 1e-4
    lo, hi = 1e-4, 1.0
    while eff(hi) < target:
        hi *= 2.0
        if hi > 1e5:
            return float("inf")
    for _ in range(60):
        mid = (lo + hi) / 2.0
        if eff(mid) >= target:
            hi = mid
        else:
            lo = mid
    return hi


def project_weak_scaling_fullstep(
    devices: Sequence[int],
    nodes_per_device: int = 8192,
    *,
    workload: str = "powerlaw",
    reorder: str = "rabbit",
    avg_degree: float = 14.0,
    seed: int = 0,
    chips_per_host: int = DEFAULTS["chips_per_host"],
    nfeat: int = FULLSTEP_DEFAULTS["nfeat"],
    nhid: int = FULLSTEP_DEFAULTS["nhid"],
    nclass: int = FULLSTEP_DEFAULTS["nclass"],
    bytes_per_elt: int = FULLSTEP_DEFAULTS["bytes_per_elt"],
    spmm_edges_per_s: Optional[float] = None,
    mxu_flops: Optional[float] = None,
    bw_ici: Optional[float] = None,
    bw_dcn: float = DEFAULTS["bw_dcn"],
    exchange_chunk: int = FULLSTEP_DEFAULTS["exchange_chunk"],
    hub_check: bool = True,
    kernel_scales: Optional[tuple] = None,
):
    """Full-2-layer-train-step weak-scaling projection on exact volumes.

    workload: "powerlaw" (degree-corrected SBM, the realistic class: the
    real graphs are heavy-tailed, see ``analysis/rows.py``), "sbm" (the
    near-adversarial uniform-degree case), or "geometric" (the spatial
    class: road networks, meshes, point clouds, where the reorder recovers
    near-planar bands). Returns (rows, meta): rows are FullStepRow per
    device count, meta records every rate with its provenance (the
    capture's unless the caller passed it; ``bw_dcn`` is assumed).
    """
    from gcn_tpu_torch.data.synthetic import geometric, powerlaw_sbm, sbm
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.parallel.halo import (_pair_boundaries,
                                             build_halo_plan_ragged)
    from gcn_tpu_torch.parallel.partition import (band_degree_sort_order,
                                                  shard_graph_by_rows)
    from gcn_tpu_torch.reorder import reorder_graph

    gen = {"powerlaw": powerlaw_sbm, "sbm": sbm,
           "geometric": geometric}[workload]
    if spmm_edges_per_s is None:
        rate, rate_src = measured_spmm_rate()
    else:
        rate, rate_src = float(spmm_edges_per_s), "caller"
    if kernel_scales is None:
        (split_scale, mono_scale), scales_src = measured_kernel_scales(
            wide=nhid > 64)
    else:
        (split_scale, mono_scale), scales_src = kernel_scales, "caller"
    if mxu_flops is None:
        mxu_flops, mxu_src = measured_mxu_flops()
    else:
        mxu_src = "caller"
    if bw_ici is None:
        bw_ici, ici_src = measured_bw_ici()
    else:
        ici_src = "caller"

    rows = []
    for d in devices:
        n = nodes_per_device * d
        adj, _ = gen(n=n, n_classes=max(8, d), avg_degree=avg_degree,
                     seed=seed)
        g = gcn_normalize(adj)
        if reorder:
            g, _ = reorder_graph(g, reorder)
        sg0 = shard_graph_by_rows(g, d)
        g = g.permute(band_degree_sort_order(g, sg0.rows_per_shard))
        sg = shard_graph_by_rows(g, d)
        rps = sg.rows_per_shard

        vals = np.asarray(sg.vals)
        cols = np.asarray(sg.cols)
        real = vals != 0
        edges_dev = int(real.sum(axis=1).max())
        own = (cols // rps) == np.arange(d)[:, None]
        interior = float((real & own).sum() / max(int(real.sum()), 1))

        if d <= chips_per_host:
            hosts = 1
        elif d % chips_per_host == 0:
            hosts = d // chips_per_host
        else:
            raise ValueError(
                f"devices={d} exceeds chips_per_host={chips_per_host} "
                f"but does not divide it")

        hub_delta = hub_best = None
        dcn_rows_mean = 0
        if hosts == 1:
            pr = build_halo_plan_ragged(sg)
            dcn_rows, ici_rows = 0, int(sum(pr.sizes))
        else:
            needed, _ = _pair_boundaries(sg)
            inter, intra, inter_mean, _ = _hier_volumes(needed, d, hosts,
                                                        chips_per_host)
            dcn_rows = inter
            dcn_rows_mean = inter_mean
            ici_rows = intra   # fan-out rows included (ragged fan-out)
            if hub_check:
                # exact-volume hub-replication comparison: sweep the
                # demand threshold, keep the best variant's DCN delta
                best = None
                for md in sorted({hosts - 1, max(2, (hosts - 1) // 2),
                                  2}, reverse=True):
                    # md=1 replicates rows a single host wants — can
                    # only tie union shipping, never beat it
                    if md < 2 or (hosts - 1) < md:
                        continue
                    i2, a2, _, st = _hier_volumes(needed, d, hosts,
                                                  chips_per_host,
                                                  hub_min_demand=md)
                    if best is None or i2 < best[0]:
                        best = (i2, a2, st)
                if best is not None:
                    hub_delta = int(best[0] - dcn_rows)
                    hub_best = dict(best[2],
                                    dcn_rows=int(best[0]),
                                    ici_rows=int(best[1]))

        # --- time model: 2-layer step = 4 exchange phases -----------------
        phases, t_base = _fullstep_phases(
            edges_dev, interior, rps, dcn_rows, ici_rows,
            nfeat=nfeat, nhid=nhid, nclass=nclass, rate=rate,
            mxu_flops=mxu_flops, bytes_per_elt=bytes_per_elt,
            bw_ici=bw_ici, bw_dcn=bw_dcn, exchange_chunk=exchange_chunk,
            split_scale=split_scale, mono_scale=mono_scale)

        def eff_at(form, chunked=True):
            return {s: t_base / _fullstep_total(phases, s, chunked, form)
                    for s in BW_SCALES}

        rows.append(FullStepRow(
            devices=d, hosts=hosts, n_rows=n,
            edges_per_device=edges_dev, interior_frac=interior,
            dcn_rows=int(dcn_rows), dcn_rows_mean=int(dcn_rows_mean),
            ici_rows=int(ici_rows),
            t_comp_ms=t_base * 1e3,
            step_ms=_fullstep_total(phases, 1.0, True) * 1e3,
            eff=eff_at("best"), eff_split=eff_at("split"),
            eff_mono=eff_at("mono"),
            eff_unchunked=eff_at("best", chunked=False),
            min_bw_scale_90=_min_scale_fullstep(phases, t_base),
            hub_delta_rows=hub_delta, hub_best=hub_best,
        ))
    meta = dict(workload=workload, reorder=reorder,
                nodes_per_device=nodes_per_device,
                avg_degree=avg_degree, seed=seed,
                chips_per_host=chips_per_host,
                nfeat=nfeat, nhid=nhid, nclass=nclass,
                bytes_per_elt=bytes_per_elt,
                spmm_edges_per_s=rate, spmm_rate_source=rate_src,
                kernel_scale_split=split_scale,
                kernel_scale_mono=mono_scale,
                kernel_scales_source=scales_src,
                mxu_flops=mxu_flops, mxu_flops_source=mxu_src,
                bw_ici_B_per_s=bw_ici, bw_ici_source=ici_src,
                bw_dcn_B_per_s=bw_dcn, bw_dcn_source=(
                    BW_DCN_SOURCE if bw_dcn == DEFAULTS["bw_dcn"]
                    else "caller"),
                exchange_chunk=exchange_chunk,
                model="full 2-layer train step: 4 boundary-first "
                      "exchanges at layer-OUTPUT widths; per phase the "
                      "cheaper of the overlap-split form (parts at the "
                      "MEASURED split kernel scale; exchange hides "
                      "behind X@W + interior + (C-1)/C of the k-chunked "
                      "boundary aggregation) and the monolithic form "
                      "(measured mono scale; only X@W hides). eff is vs "
                      "the plain-rate single-device baseline, so the "
                      "sharded layouts' cost counts against efficiency. "
                      "Byte counts exact planner outputs, time conversion "
                      "modeled")
    return rows, meta
