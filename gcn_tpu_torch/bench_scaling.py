#!/usr/bin/env python3
"""Weak scaling of the sharded GCN training step: measured on the cards, or
projected on the host from exact exchange volumes. The counterpart of
gcn_tpu's ``examples/bench_scaling.py``.

The graph grows with the device count (n = nodes_per_device x d: an SBM of
8 classes, average degree 14, rabbit, 64 class features, the in-band
degree sort), and the report is the step time and the weak-scaling
efficiency t(1)/t(d) (the ``segsum`` kernel by default, as gcn_tpu's; K1
with ``--kernel ell``; hidden 32, dropout 0.5). In one process the d bands
of each count run on one card (``--device cpu`` for the CPU):

    python -m gcn_tpu_torch.bench_scaling --devices 1 2 4 [--kernel ell]

Under ``torchrun`` it is one band a card at d = the world size, one row a
run; ``--out FILE`` collects the rows of several runs, and each row's
efficiency is against that file's d = 1 row of the same options:

    for p in 1 2 4; do torchrun --nproc-per-node $p -m \\
        gcn_tpu_torch.bench_scaling --kernel ell --out scaling.json; done

``--project``, ``--fullstep`` and ``--lockstep-floor`` run on the host only
(``parallel/projection.py``): the real halo plans at each device count, the
exchanged bytes converted to projected efficiency at the card's rates (the
capture's unless a flag overrides them; ``--bw-dcn`` is an assumption)::

    python -m gcn_tpu_torch.bench_scaling --fullstep --workload powerlaw \\
        --devices 8 16 32 --nodes-per-device 8192 --halo-wire bf16

They print gcn_tpu's JSON rows, and ``--out`` writes the artifact
(``scaling_projection_v2``, ``scaling_projection_fullstep_v1``,
``lockstep_floor_v1``) where it is told.
"""

import argparse
import json
import os
import sys
import time


def bench_devices(d, nodes_per_device, steps, kernel, exchange,
                  exchange_dtype=None, seed=0, mesh=None, device=None):
    """(seconds a step, exchange stats) of the sharded step at d bands: on
    ``mesh`` (this process's part of a multi-process run) or, without one,
    every band in this process on ``device``."""
    import numpy as np
    import torch

    from gcn_tpu_torch.data.synthetic import class_features, sbm
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.models.gcn_core import init_gcn_params
    from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                        build_halo_plan_hier,
                                        build_halo_plan_ragged, create_mesh,
                                        create_mesh_hier,
                                        make_sharded_gcn_train_step,
                                        rows_per_shard_for,
                                        shard_graph_by_rows)
    from gcn_tpu_torch.reorder import reorder_graph
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.checkpoint import named_leaves

    n = nodes_per_device * d
    adj, labels = sbm(n=n, n_classes=8, avg_degree=14.0, seed=seed)
    g = gcn_normalize(adj)
    g, perm = reorder_graph(g, "rabbit")
    x = class_features(labels, feat_dim=64, seed=seed)[perm]
    labels = labels[perm]
    # the in-band degree sort: per-shard ELL fill without disturbing the
    # community-aligned bands
    bperm = band_degree_sort_order(g, rows_per_shard_for(n, d))
    g, x, labels = g.permute(bperm), x[bperm], labels[bperm]

    if mesh is None:
        mesh = create_mesh(d, device)
    hosts = None
    if exchange == "halo_hier":
        hosts = max(h for h in (1, 2, 4) if d % h == 0 and h <= d)
        mesh = create_mesh_hier(hosts, d // hosts, mesh.device)
    dev = mesh.device
    sg = shard_graph_by_rows(g, d)
    step, _, shard_fn = make_sharded_gcn_train_step(
        mesh, sg, dropout=0.5, exchange=exchange, kernel=kernel,
        exchange_dtype=exchange_dtype)

    # per-level exchange accounting (rows a device a layer)
    stats = {}
    if d > 1 and exchange != "all_gather":
        stats["flat_exchange_rows"] = sum(build_halo_plan_ragged(sg).sizes)
        if hosts and hosts > 1:
            ph = build_halo_plan_hier(sg, hosts, d // hosts)
            stats["ici_intra_rows"] = sum(ph.intra_sizes)
            stats["dcn_union_rows"] = sum(ph.inter_sizes)
            stats["ici_fanout_rows"] = ph.ici_gather_rows
    a, xs, ys, ms = shard_fn(x, labels, np.ones(n, np.float32))
    params = init_gcn_params(torch.Generator().manual_seed(0), 64, 32, 8,
                             device=dev)
    opt = adam_l2([t.requires_grad_(True) for _, t in named_leaves(params)],
                  0.01, 5e-4)
    float(step(params, opt, (1, 0), a, xs, ys, ms))    # kernel build, warm
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step(params, opt, (1, i + 1), a, xs, ys, ms)
    float(loss)
    return (time.perf_counter() - t0) / steps, stats


def run_live(args):
    """The measured weak scaling: one row a device count."""
    import torch
    import torch.distributed as dist

    from gcn_tpu_torch.parallel import initialize_multihost

    # under torchrun (which sets RANK), one band a process, even for one
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = (initialize_multihost(device=args.device)
            if "RANK" in os.environ else None)
    counts = [world] if mesh else (args.devices or [1, 2, 4])
    rank0 = mesh is None or mesh.rank == 0
    runs = []
    if args.out and rank0 and os.path.exists(args.out):
        with open(args.out) as f:
            runs = json.load(f).get("rows", [])
    same = dict(nodes_per_device=args.nodes_per_device,
                kernel=args.kernel, exchange=args.exchange,
                wire=args.wire, steps=args.steps)
    t1 = next((r["step_ms"] for r in runs if r["devices"] == 1
               and all(r.get(k) == v for k, v in same.items())), None)
    for d in counts:
        t, stats = bench_devices(d, args.nodes_per_device, args.steps,
                                 args.kernel, args.exchange, args.wire_dtype,
                                 mesh=mesh, device=args.device)
        if t1 is None and (mesh is None or d == 1):
            # one process: against the first count, as gcn_tpu's; under
            # torchrun: against the d = 1 run
            t1 = t * 1e3
        dev = mesh.device if mesh else torch.device(args.device or "cuda")
        row = {"devices": d, "processes": world, "step_ms": t * 1e3,
               "weak_scaling_efficiency": (t1 / (t * 1e3) if t1 else None),
               **same, **stats,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")}
        runs.append(row)
        if rank0:
            print(json.dumps(row), flush=True)
    if args.out and rank0:
        with open(args.out, "w") as f:
            json.dump({"harness": "gcn_tpu_torch/bench_scaling.py",
                       "rows": runs}, f, indent=1)
        print(f"wrote {args.out}")
    if mesh is not None:
        dist.destroy_process_group()
    return 0


def run_projection_fullstep(args):
    from gcn_tpu_torch.parallel.projection import (
        project_weak_scaling_fullstep)

    counts = args.devices or [8, 32, 64]
    rows, meta = project_weak_scaling_fullstep(
        counts, nodes_per_device=args.nodes_per_device,
        workload=args.workload, chips_per_host=args.chips_per_host,
        nfeat=args.nfeat, nhid=args.nhid, nclass=args.nclass,
        bw_ici=args.bw_ici, bw_dcn=args.bw_dcn,
        spmm_edges_per_s=args.spmm_rate, mxu_flops=args.mxu_flops,
        bytes_per_elt=args.wire_bytes,
        exchange_chunk=None if args.no_chunk else 32)
    out = {"assumptions": meta, "rows": [r.to_json() for r in rows]}
    for r in out["rows"]:
        print(json.dumps(r))
    if args.out:
        from gcn_tpu_torch.utils.artifacts import write_artifact
        write_artifact(args.out, out,
                       harness="gcn_tpu_torch/bench_scaling.py --fullstep",
                       schema="scaling_projection_fullstep_v1",
                       allow=["min_bw_scale_90", "hub_delta_rows"])
        print(f"wrote {args.out}")
    return 0


def run_lockstep_floor(args):
    """The lockstep network padding floor against a size-matched round
    schedule, on exact planner volumes (host only)."""
    from gcn_tpu_torch.data.synthetic import geometric, powerlaw_sbm, sbm
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.parallel.halo import _pair_boundaries
    from gcn_tpu_torch.parallel.partition import (band_degree_sort_order,
                                                  shard_graph_by_rows)
    from gcn_tpu_torch.parallel.projection import lockstep_vs_matched_dcn
    from gcn_tpu_torch.reorder import reorder_graph

    gen = {"powerlaw": powerlaw_sbm, "sbm": sbm,
           "geometric": geometric}[args.workload]
    counts = args.devices or [64, 256]
    rows = []
    for d in counts:
        if d <= args.chips_per_host:
            print(f"d={d}: single host, no DCN: skipped")
            continue
        assert d % args.chips_per_host == 0
        hosts = d // args.chips_per_host
        n = args.nodes_per_device * d
        adj, _ = gen(n=n, n_classes=max(8, d), avg_degree=14.0, seed=0)
        g = gcn_normalize(adj)
        g, _ = reorder_graph(g, "rabbit")
        sg0 = shard_graph_by_rows(g, d)
        g = g.permute(band_degree_sort_order(g, sg0.rows_per_shard))
        sg = shard_graph_by_rows(g, d)
        needed, _ = _pair_boundaries(sg)
        r = lockstep_vs_matched_dcn(needed, d, hosts,
                                    args.chips_per_host)
        r.update(devices=d, hosts=hosts, n_rows=n,
                 matched_saving=round(r["lockstep"] / max(r["matched"], 1),
                                      4),
                 lockstep_over_mean=round(
                     r["lockstep"] / max(r["mean"], 1), 4),
                 rank_bound_over_mean=round(
                     r["rank_bound"] / max(r["mean"], 1), 4))
        rows.append(r)
        print(json.dumps(r))
    if args.out:
        from gcn_tpu_torch.utils.artifacts import write_artifact
        write_artifact(args.out, {
            "workload": args.workload,
            "nodes_per_device": args.nodes_per_device,
            "chips_per_host": args.chips_per_host,
            "definition": "rows/device/exchange totals: lockstep = "
                          "shipped offset schedule (pads each round to "
                          "its max); matched = feasible size-matched "
                          "bottleneck-matching schedule; rank_bound = "
                          "schedule-relaxed floor (not generally "
                          "feasible); mean = padding-free per-source "
                          "mean (infeasible with static shapes)",
            "rows": rows,
        }, harness="gcn_tpu_torch/bench_scaling.py --lockstep-floor",
            schema="lockstep_floor_v1")
        print(f"wrote {args.out}")
    return 0


def run_projection(args):
    from gcn_tpu_torch.parallel.projection import (DEFAULTS,
                                                   measured_bw_ici,
                                                   measured_spmm_rate,
                                                   project_weak_scaling)

    rate, rate_src = ((args.spmm_rate, "caller") if args.spmm_rate
                      else measured_spmm_rate())
    bw_ici, ici_src = ((args.bw_ici, "caller") if args.bw_ici
                       else measured_bw_ici())
    counts = args.devices or [8, 32, 128, 256]
    rows = project_weak_scaling(
        counts, nodes_per_device=args.nodes_per_device,
        chips_per_host=args.chips_per_host, bw_ici=bw_ici,
        bw_dcn=args.bw_dcn, spmm_edges_per_s=rate,
        bytes_per_elt=args.wire_bytes)
    out = {
        # every entry records the value used for the rows
        "assumptions": {
            "chips_per_host": args.chips_per_host,
            "feat_width": DEFAULTS["feat_width"],
            "bytes_per_elt": args.wire_bytes,
            "bw_ici_B_per_s": bw_ici, "bw_ici_source": ici_src,
            "bw_dcn_B_per_s": args.bw_dcn,
            "spmm_edges_per_s": rate, "spmm_rate_source": rate_src,
            "nodes_per_device": args.nodes_per_device,
            "note": "byte counts are exact plan outputs; only the "
                    "time conversion is modeled (projection.py)",
        },
        "rows": [r.to_json() for r in rows],
    }
    for r in out["rows"]:
        print(json.dumps(r))
    if args.out:
        from gcn_tpu_torch.utils.artifacts import write_artifact
        # min_bw_scale_90 can exceed 1 (a scale, not an efficiency)
        write_artifact(args.out, out,
                       harness="gcn_tpu_torch/bench_scaling.py --project",
                       schema="scaling_projection_v2",
                       allow=["min_bw_scale_90"])
        print(f"wrote {args.out}")
    return 0


def main(argv=None):
    from gcn_tpu_torch.parallel.projection import DEFAULTS

    ap = argparse.ArgumentParser(
        description="Weak scaling of the sharded GCN step (PyTorch)")
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="device counts to sweep (one process: default "
                         "1 2 4; under torchrun: the world size)")
    ap.add_argument("--nodes-per-device", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--kernel", default="segsum", choices=["segsum", "ell"])
    ap.add_argument("--exchange", default="halo",
                    choices=["halo", "halo_padded", "halo_hier",
                             "all_gather"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu, for the live mode")
    ap.add_argument("--project", action="store_true",
                    help="host-only projection of flat and hierarchical "
                         "plans (projection.project_weak_scaling)")
    ap.add_argument("--lockstep-floor", action="store_true",
                    help="host-only: the lockstep network padding floor "
                         "against a size-matched round schedule "
                         "(projection.lockstep_vs_matched_dcn)")
    ap.add_argument("--fullstep", action="store_true",
                    help="full-train-step projection: 4 boundary-first "
                         "exchanges at layer-output widths, k-chunked "
                         "pipeline credit, hub-replication check "
                         "(projection.project_weak_scaling_fullstep)")
    ap.add_argument("--workload", default="powerlaw",
                    choices=["powerlaw", "sbm", "geometric"])
    ap.add_argument("--nfeat", type=int, default=128)
    ap.add_argument("--nhid", type=int, default=128)
    ap.add_argument("--nclass", type=int, default=40)
    ap.add_argument("--no-chunk", action="store_true",
                    help="disable the k-chunk pipeline credit")
    ap.add_argument("--chips-per-host", type=int,
                    default=DEFAULTS["chips_per_host"])
    ap.add_argument("--bw-ici", type=float, default=None,
                    help="NVLink bandwidth a card, B/s (default: the "
                         "capture's, projection.measured_bw_ici)")
    ap.add_argument("--bw-dcn", type=float, default=DEFAULTS["bw_dcn"],
                    help="network bandwidth a card between nodes, B/s "
                         "(default: the assumed 400 Gb/s NIC a card)")
    ap.add_argument("--spmm-rate", type=float, default=None,
                    help="K1's plain edges/s (default: the capture's, "
                         "projection.measured_spmm_rate)")
    ap.add_argument("--mxu-flops", type=float, default=None,
                    help="f32 matmul flop/s (default: the capture's, "
                         "projection.measured_mxu_flops)")
    ap.add_argument("--halo-bf16", action="store_true",
                    help="exchange_dtype='bf16': 2 B an element on the "
                         "wire (live run and projections)")
    ap.add_argument("--halo-wire", default=None,
                    choices=["f32", "bf16", "fp8"],
                    help="wire dtype: f32 4 B an element, bf16 2, fp8 1 "
                         "(float8_e4m3fn, clipped), live run and "
                         "projections. Overrides --halo-bf16.")
    ap.add_argument("--out", default=None,
                    help="write the JSON here (live: collect the rows of "
                         "several runs)")
    args = ap.parse_args(argv)
    # one resolved wire for the live run and the projections
    args.wire = args.halo_wire or ("bf16" if args.halo_bf16 else "f32")
    args.wire_dtype = None if args.wire == "f32" else args.wire
    args.wire_bytes = {"f32": 4, "bf16": 2, "fp8": 1}[args.wire]

    if args.lockstep_floor:
        return run_lockstep_floor(args)
    if args.fullstep:
        return run_projection_fullstep(args)
    if args.project:
        return run_projection(args)
    return run_live(args)


if __name__ == "__main__":
    sys.exit(main())
