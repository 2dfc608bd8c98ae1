#!/usr/bin/env python3
"""Reorder ablation: what each vertex order buys the single-card SpMM and the
row-band exchange. The counterpart of gcn_tpu's
``examples/ablate_reorder.py``.

The order acts through two channels: ELL fill (degree-homogeneous windows,
the degree sort composed after the reorder, cut slot padding and so K1's
work) and the row-band boundary (community clustering, rabbit, shrinks the
halo the shards exchange). For each reorder method, alone, then with the
global degree sort and with the in-band degree sort, one JSON row: the ELL
pad fraction, the SpMM's ms (``spmm_ell`` at width ``-k``: K1 on the card,
median of 30 calls behind a spin kernel; the plain version's host-clock ms
with ``--device cpu``), the row-band boundary fraction and the ragged and
padded plans' exchange fractions at ``--shards`` shards:

    python -m gcn_tpu_torch.ablate_reorder -g synth-arxiv --shards 4
"""

import argparse
import json
import statistics
import sys
import time


def spmm_ms(adj, x, device):
    """The SpMM's median ms: K1 on the card, the plain version on the
    CPU (host clock)."""
    import torch

    from gcn_tpu_torch.ops.ell_spmm import spmm_ell

    with torch.no_grad():
        if device.type == "cuda":
            from gcn_tpu_torch.utils.chain_timing import device_ms

            return device_ms(lambda: spmm_ell(adj, x), 30)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            spmm_ell(adj, x)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure(g, method, deg_sort, shards, k, device):
    """deg_sort: "none" | "global" | "band" (in-band: keeps shard bands)."""
    import numpy as np
    import torch

    from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                        build_halo_plan,
                                        build_halo_plan_ragged,
                                        rows_per_shard_for,
                                        shard_graph_by_rows)
    from gcn_tpu_torch.reorder import reorder_graph
    from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency

    g2, _ = reorder_graph(g, method)
    if deg_sort == "global":
        g2 = g2.permute(degree_sort_order(g2))
    elif deg_sort == "band":
        g2 = g2.permute(band_degree_sort_order(
            g2, rows_per_shard_for(g2.shape[0], shards)))
    adj = ell_adjacency(g2, symmetric=True, device=device)
    sg = shard_graph_by_rows(g2, shards)
    plan = build_halo_plan(sg)
    plan_ragged = build_halo_plan_ragged(sg)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (g2.shape[0], k)).astype(np.float32) * 0.01, device=device)
    return {
        "method": method + {"none": "", "global": "+degsort",
                            "band": "+band-degsort"}[deg_sort],
        "pad_fraction": round(adj.pad_fraction, 4),
        "spmm_ms": spmm_ms(adj, x, device),
        "boundary_fraction": round(sg.boundary_fraction(), 4),
        "halo_exchange_fraction": round(plan_ragged.exchange_fraction, 4),
        "halo_exchange_fraction_padded": round(plan.exchange_fraction, 4),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Reorder ablation: ELL fill, SpMM time, halo size")
    ap.add_argument("-g", "--graph", default="synth-pubmed")
    ap.add_argument("-k", "--width", type=int, default=32)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--methods", nargs="*",
                    default=["identity", "degree", "rcm", "gorder",
                             "gorder3", "rabbit"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    data = get_dataset(args.graph)
    g = gcn_normalize(data.adj)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[{args.graph}] n={g.shape[0]} nnz={g.nnz} device={name}")
    rows = []
    for method in args.methods:
        for deg_sort in ("none", "global", "band"):
            if deg_sort != "none" and method in ("identity", "degree"):
                continue  # composed permutation identical to plain degree
            r = measure(g, method, deg_sort, args.shards, args.width,
                        device)
            rows.append(r)
            print(json.dumps(r), flush=True)
    best_fill = min(rows, key=lambda r: r["pad_fraction"])
    best_halo = min(rows, key=lambda r: r["halo_exchange_fraction"])
    print(f"\nbest fill: {best_fill['method']} "
          f"(pad {best_fill['pad_fraction']}); "
          f"best halo: {best_halo['method']} "
          f"(exchange {best_halo['halo_exchange_fraction']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
