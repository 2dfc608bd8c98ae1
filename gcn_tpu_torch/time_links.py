#!/usr/bin/env python3
"""NVLink's one-direction bandwidth a card, over NCCL, at the sizes of the
halo exchanges the port runs: the ``bw_ici`` of ``parallel/projection.py``.

    torchrun --nproc-per-node 4 -m gcn_tpu_torch.time_links \\
        [-g GRAPH] [--widths 32 128] [-o gcn_tpu_torch/captures/h100.json]

One process a card (NCCL), one band each. The graph (synth-arxiv, seed 15)
goes through ``gcn_normalize``, rabbit and the in-band degree sort at
world-size bands, as ``train_gcn_dist`` prepares it; then for the ragged
plan (ring shifts as point-to-point rounds, ``batch_isend_irecv``) and the
padded plan (one ``all_to_all_single``), at each width, the port's own
exchange (``make_halo_exchange``, f32 wire) runs on a random band: the
send rows gathered, shipped and received into the halo table. Each of
``--reps`` exchanges starts after a device sync and a barrier; CUDA events
around it give its time on each rank, and an exchange's time is the slowest
rank's. A row's bandwidth is the rows a card sends to other cards times the
width times 4 B, over the median exchange time: the ragged plan sends its
offsets' payload heights (``sum(sizes)``), the padded plan (ns - 1) x h_max
(its self slice stays on the card).

Rank 0 merges the result into the capture's ``links`` entry (``-o``), with
``bw_ici`` the ragged plan's at the widest width (the default exchange at
the projection's default hidden width), the card's name and power limit and
the NCCL version; the other entries stay. Prints one JSON line a row, then
the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import sys
import time

from gcn_tpu_torch.time_sharded import CAPTURE, SEED, smi_line


def time_exchange(plan, mesh, rows, width, reps):
    """Median over ``reps`` of the slowest rank's ms for one exchange of
    ``plan`` from bands of ``rows`` x ``width`` f32 (host-clock ms on the
    CPU)."""
    import torch
    import torch.distributed as dist

    from gcn_tpu_torch.parallel import make_halo_exchange, send_indices

    dev = mesh.device
    ex = make_halo_exchange(plan)
    send_idx = send_indices(plan, mesh.shards, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + mesh.rank)
    x = [torch.randn(rows, width, device=dev, generator=gen)
         for _ in mesh.shards]
    for _ in range(3):
        ex(send_idx, x, mesh).wait()
    ms = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            dist.barrier()
            start.record()
            ex(send_idx, x, mesh).wait()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            dist.barrier()
            t0 = time.perf_counter()
            ex(send_idx, x, mesh).wait()
            ms.append((time.perf_counter() - t0) * 1e3)
    slowest = torch.tensor(ms, device=dev)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    return statistics.median(slowest.tolist())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-g", "--graph", default="synth-arxiv")
    ap.add_argument("--widths", type=int, nargs="+", default=[32, 128])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("-o", "--out", default=CAPTURE)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (gloo, host clock; "
                         "for trying the script, not for the capture)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                        build_halo_plan,
                                        build_halo_plan_ragged,
                                        initialize_multihost,
                                        rows_per_shard_for,
                                        shard_graph_by_rows)
    from gcn_tpu_torch.reorder import reorder_graph

    if args.device != "cpu" and not torch.cuda.is_available():
        print("time_links: no CUDA device is available", file=sys.stderr)
        return 2
    mesh = initialize_multihost(device=args.device)
    ns = mesh.n_shards
    data = get_dataset(args.graph, seed=SEED)
    g, _ = reorder_graph(gcn_normalize(data.adj), "rabbit")
    g = g.permute(band_degree_sort_order(g, rows_per_shard_for(
        g.shape[0], ns)))
    sg = shard_graph_by_rows(g, ns)
    rows = []
    for name, plan in (("ragged", build_halo_plan_ragged(sg)),
                       ("padded", build_halo_plan(sg))):
        sent = (sum(plan.sizes) if name == "ragged"
                else (ns - 1) * plan.h_max)
        for width in args.widths:
            ms = time_exchange(plan, mesh, sg.rows_per_shard, width,
                               args.reps)
            row = {"plan": name, "cards": ns, "width": width,
                   "rows_sent": int(sent), "bytes": int(sent * width * 4),
                   "ms": ms, "bytes_per_s": sent * width * 4 / (ms * 1e-3)}
            rows.append(row)
            if mesh.rank == 0:
                print(json.dumps(row), flush=True)
    if mesh.rank == 0 and mesh.device.type == "cuda":
        card = smi_line()
        best = [r for r in rows if r["plan"] == "ragged"
                and r["width"] == max(args.widths)][0]
        try:
            with open(args.out) as f:
                cap = json.load(f)
        except (OSError, ValueError):
            cap = {}
        cap["links"] = {
            "script": "gcn_tpu_torch/time_links.py", "card": card,
            "cards": ns, "graph": args.graph, "measured": True,
            "bw_ici": best["bytes_per_s"],
            "basis": f"the ragged plan's exchange at width "
                     f"{best['width']}, f32, over NCCL between {ns} cards",
            "nccl": ".".join(map(str, torch.cuda.nccl.version())),
            "torch": torch.__version__, "rows": rows}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(cap, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}")
        print(card)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
