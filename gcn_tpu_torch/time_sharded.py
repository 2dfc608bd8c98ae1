#!/usr/bin/env python3
"""The sharded K1 layouts' cost over the plain K1, and the f32 matmul rate,
on one GPU: the rates ``parallel/projection.py`` reads from the capture.

    python3 -m gcn_tpu_torch.time_sharded [-g GRAPH] [--proportion 8]
        [--k-pads 32 128] [--commit HASH] [-o gcn_tpu_torch/captures/h100.json]

The counterpart of gcn_tpu's ``examples/bench_sharded_1dev.py``, in one
process on the card. The graph (synth-arxiv, seed 15) goes through
``gcn_normalize`` and rabbit, then

  * the plain K1: the degree sort and ``ell_adjacency`` at each k_pad, K1
    forward on the whole graph at width k = k_pad;
  * the production proportions: the in-band degree sort at
    ``--proportion`` shards and the ragged plan, then K1 forward on every
    band's pass-block parts (``build_sharded_ell_blocks``: the step's
    overlap default) and on every band's monolithic layout
    (``build_sharded_ell``), at the same k_pad and width; their transpose
    arrays too (recorded, not read by the projection);
  * the like-for-like check of ``chip_smoke.py``: the same at 4 shards,
    band 0's parts forward at k = 32 (its [dist] rows);
  * the f32 matmul rate (TF32 off, as in the port) at the full step's
    shapes: X @ W, dX and dW of both layers at 8,192 rows, 128 -> 128 ->
    40 (the projection's ``nodes_per_device`` and widths).

Every time is the median ms of ``--reps`` calls queued behind a ~0.1 s spin
kernel, CUDA events around each call (``utils/chain_timing.py::device_ms``).
A rate over edges counts the stored edges (not padding slots); a
layout's cost over the plain K1 is the plain rate over the layout's
(``blocks_over_plain``: every band's two parts summed; ``sharded_over_plain``:
the monolithic layout's). The results merge into the capture (``-o``),
keeping its ``links`` entry (``time_links.py``), with the card's name and
power limit and the torch version. Prints one JSON line, then the card's
name and power limit.
"""

import argparse
import json
import os
import sys
import time

from gcn_tpu_torch.utils.chain_timing import device_ms, smi_line

SEED = 15
CAPTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "captures", "h100.json")
# the full step's f32 matmuls at the projection's defaults: (m, k, n) of
# X @ W, dX = G @ W^T and dW = X^T @ G for 128 -> 128 and 128 -> 40
MATMUL_ROWS = 8192
MATMUL_SHAPES = tuple(s for fin, fout in ((128, 128), (128, 40))
                      for s in ((MATMUL_ROWS, fin, fout),
                                (MATMUL_ROWS, fout, fin),
                                (fin, MATMUL_ROWS, fout)))


def matmul_rate(device, reps=30, shapes=MATMUL_SHAPES):
    """(flop/s, [ms of each shape]): the f32 matmul rate over ``shapes``
    ((m, k, n) each), total flops over total time."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    ms = []
    for m, k, n in shapes:
        a = torch.randn(m, k, device=device, generator=gen)
        b = torch.randn(k, n, device=device, generator=gen)
        ms.append(device_ms(lambda: torch.matmul(a, b), reps))
    flops = sum(2.0 * m * k * n for m, k, n in shapes)
    return flops / (sum(ms) * 1e-3), ms


def k1_ms(a, x, t, reps):
    """K1's median ms on one direction of the EllAdj ``a`` reading ``x``."""
    from gcn_tpu_torch.ops import ell_spmm as es

    if t:
        args = (a.t_cols, a.t_vals, a.t_win, a.t_win_off, a.t_row_space)
    else:
        args = (a.cols, a.vals, a.win, a.win_off, a.row_space)
    return device_ms(lambda: es.ell_spmm(x, *args), reps)


def sharded_tier(g_rabbit, n_shards, k_pad, plain_rate, dev, reps,
                 bands=None, transposes=True):
    """K1 forward (and through the transpose arrays) on each band's
    pass-block parts and monolithic layout at ``n_shards`` shards and width
    k = k_pad; returns the tier's dict with the costs over ``plain_rate``
    (edges/s)."""
    import torch

    from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                        build_halo_plan_ragged,
                                        build_sharded_ell,
                                        build_sharded_ell_blocks,
                                        rows_per_shard_for,
                                        shard_graph_by_rows)

    n = g_rabbit.shape[0]
    g = g_rabbit.permute(band_degree_sort_order(
        g_rabbit, rows_per_shard_for(n, n_shards)))
    sg = shard_graph_by_rows(g, n_shards)
    plan = build_halo_plan_ragged(sg)
    bands = list(range(n_shards)) if bands is None else bands
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = {"n_shards": n_shards, "bands": bands,
           "rows_per_shard": sg.rows_per_shard,
           "halo_rows": plan.halo_rows}
    interior, halo = build_sharded_ell_blocks(sg, plan, k_pad=k_pad,
                                              shards=bands, device=dev)
    rows = {key: [] for key in ("edges", "interior_ms", "halo_ms",
                                "interior_t_ms", "halo_t_ms",
                                "monolithic_ms", "monolithic_t_ms")}
    for ai, ah in zip(interior, halo):
        xb = torch.randn(ai.n_cols, k_pad, device=dev, generator=gen)
        xt = torch.randn(ah.n_cols, k_pad, device=dev, generator=gen)
        ct = torch.randn(ai.n_rows, k_pad, device=dev, generator=gen)
        rows["edges"].append(ai.nnz + ah.nnz)
        rows["interior_ms"].append(k1_ms(ai, xb, False, reps))
        rows["halo_ms"].append(k1_ms(ah, xt, False, reps))
        if transposes:
            rows["interior_t_ms"].append(k1_ms(ai, ct, True, reps))
            rows["halo_t_ms"].append(k1_ms(ah, ct, True, reps))
    del interior, halo
    torch.cuda.empty_cache()
    for am in build_sharded_ell(sg, plan, k_pad=k_pad, shards=bands,
                                device=dev):
        x = torch.randn(am.n_cols, k_pad, device=dev, generator=gen)
        ct = torch.randn(am.n_rows, k_pad, device=dev, generator=gen)
        rows["monolithic_ms"].append(k1_ms(am, x, False, reps))
        if transposes:
            rows["monolithic_t_ms"].append(k1_ms(am, ct, True, reps))
    torch.cuda.empty_cache()
    edges = sum(rows["edges"])

    def over_plain(*keys):
        ms = sum(sum(rows[k]) for k in keys)
        return plain_rate / (edges / (ms * 1e-3)) if ms else None

    out.update({k: v for k, v in rows.items() if v})
    out["production_parts"] = {
        "blocks_over_plain": over_plain("interior_ms", "halo_ms"),
        "blocks_edges_per_s": edges / (sum(rows["interior_ms"])
                                       + sum(rows["halo_ms"])) * 1e3}
    out["sharded_over_plain"] = over_plain("monolithic_ms")
    if transposes:
        out["blocks_t_over_plain"] = over_plain("interior_t_ms",
                                                "halo_t_ms")
        out["sharded_t_over_plain"] = over_plain("monolithic_t_ms")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-g", "--graph", default="synth-arxiv")
    ap.add_argument("--proportion", type=int, default=8,
                    help="shards of the production-proportion layouts")
    ap.add_argument("--k-pads", type=int, nargs="+", default=[32, 128])
    ap.add_argument("--check-shards", type=int, default=4,
                    help="shards of chip_smoke.py's like-for-like check "
                         "(band 0 at k = 32)")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--commit", default=None,
                    help="the commit measured (the checkout may lack .git)")
    ap.add_argument("-o", "--out", default=CAPTURE)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_sharded: no CUDA device is available", file=sys.stderr)
        return 2
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.ops import _build
    from gcn_tpu_torch.reorder import native, reorder_graph
    from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi_line()
    print(card, flush=True)
    t0 = time.time()
    _build.build_cuda_kernels()
    _build.build_libraries({"gcnreorder": native.SOURCES}, "g++")
    print(f"[build] {time.time() - t0:.1f}s", flush=True)

    data = get_dataset(args.graph, seed=SEED)
    g_rabbit, _ = reorder_graph(gcn_normalize(data.adj), "rabbit")
    g = g_rabbit.permute(degree_sort_order(g_rabbit))
    n, nnz = g.shape[0], g.nnz
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cap = {}
    for k_pad in args.k_pads:
        adj = ell_adjacency(g, k_pad=k_pad, symmetric=True, device=dev)
        x = torch.randn(n, k_pad, device=dev, generator=gen)
        plain = k1_ms(adj, x, False, args.reps)
        rate = nnz / (plain * 1e-3)
        del adj
        print(f"[plain] {args.graph} n={n} nnz={nnz} k_pad={k_pad}: K1 "
              f"{plain:.4f} ms, {rate:.4e} edges/s", flush=True)
        tier = sharded_tier(g_rabbit, args.proportion, k_pad, rate, dev,
                            args.reps)
        tier.update(k=k_pad, plain_ms=plain, plain_edges_per_s=rate)
        print(f"[{args.proportion} shards, k_pad {k_pad}] blocks over "
              f"plain {tier['production_parts']['blocks_over_plain']:.3f}, "
              f"monolithic over plain {tier['sharded_over_plain']:.3f}; "
              f"transpose arrays {tier['blocks_t_over_plain']:.3f} / "
              f"{tier['sharded_t_over_plain']:.3f}", flush=True)
        cap[f"k_pad_{k_pad}"] = tier
        if k_pad == 32:
            cap["spmm"] = {"graph": args.graph, "seed": SEED, "k": 32,
                           "k_pad": 32, "nnz": nnz, "ms": plain,
                           "edges_per_s": rate}
            check = sharded_tier(g_rabbit, args.check_shards, 32, rate,
                                 dev, args.reps, bands=[0],
                                 transposes=False)
            print(f"[check: {args.check_shards} shards, band 0, k=32] "
                  f"interior {check['interior_ms'][0]:.4f} + halo "
                  f"{check['halo_ms'][0]:.4f} ms over "
                  f"{check['edges'][0]} edges: blocks over plain "
                  f"{check['production_parts']['blocks_over_plain']:.3f}",
                  flush=True)
            cap["check"] = check
    flops, ms = matmul_rate(dev, args.reps)
    cap["matmul"] = {"shapes": [list(s) for s in MATMUL_SHAPES], "ms": ms,
                     "flops_per_s": flops, "tf32": False}
    print(f"[matmul] f32 {flops:.4e} flop/s over {len(ms)} shapes "
          f"(ms {[round(v, 4) for v in ms]})", flush=True)

    try:
        with open(args.out) as f:
            old = json.load(f)
    except (OSError, ValueError):
        old = {}
    out = {"schema": "h100_capture_v1", "card": card,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "commit": args.commit, "script": "gcn_tpu_torch/time_sharded.py",
           "protocol": "median of reps calls behind a ~0.1 s spin kernel, "
                       "CUDA events around each call; rates over stored "
                       "edges",
           **cap}
    if "links" in old:
        out["links"] = old["links"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k in ("card", "spmm", "matmul")}))
    print(f"wrote {args.out}")
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
