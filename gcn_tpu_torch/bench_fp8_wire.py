#!/usr/bin/env python3
"""What the halo exchange's wire (f32, bf16 or fp8) does to training: the
counterpart of gcn_tpu's ``examples/bench_fp8_wire.py``.

    python -m gcn_tpu_torch.bench_fp8_wire [--legs GRAPH:EXCHANGE:HIDDEN:ITERS
        ...] [--shards 8] [--seeds 15 16 17] [-o PATH] [--device cpu]
    torchrun --nproc-per-node 4 -m gcn_tpu_torch.bench_fp8_wire [...]

The fp8 wire (``exchange_dtype="fp8"``: float8_e4m3fn, clipped,
``parallel/halo.py::_prep_send``) quarters the exchange's bytes and rounds
the boundary rows it carries, forward and backward. For each leg (gcn_tpu's
default legs: synth-pubmed at hidden 16 for 60 iterations, with the ragged
halo exchange and with the 2 x 4 hierarchical one), each wire and each
seed, the sharded 2-layer GCN (``make_sharded_gcn_train_step``, dropout
0.5, Adam lr 0.01 with L2 5e-4, parameters and dropout from the seed)
trains on ``--shards`` row bands after rabbit and the in-band degree sort,
as gcn_tpu's script; one row: ``loss_final``, ``acc_train``,
``acc_test``, ``finite`` and ``wall_s``; then the summary table of mean,
min and max test accuracy a leg and wire.

In one process all the bands live on one card (or the CPU with
``--device cpu``); under ``torchrun`` each process owns shards / P bands
of its own card (NCCL). The numbers are the wire's numerics on the card,
which are what the artifact records; ``wall_s`` is the host clock of a
run. ``recommend_wire_dtype`` (``parallel/projection.py``) cites this
artifact as the basis of fp8's accuracy.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(HERE, "results", "fp8_wire_eval.json")
DEFAULT_LEGS = ("synth-pubmed:halo:16:60", "synth-pubmed:halo_hier:16:60")
WIRES = (None, "bf16", "fp8")


def leg_mesh(mesh, exchange):
    """The mesh the exchange takes: 2 x shards/2 for halo_hier."""
    from gcn_tpu_torch.parallel import create_mesh_hier

    if exchange != "halo_hier":
        return mesh
    return create_mesh_hier(2, mesh.n_shards // 2, mesh.device)


def run_one(mesh, graph, hidden, iters, seed, wire, exchange, dropout=0.5,
            params0=None):
    """Train one (leg, wire, seed); returns the row's numbers and the
    per-iteration losses. ``params0`` (numpy, gcn_tpu's layout) replaces
    the seed's initial parameters."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gcn_tpu_torch.convert import params_from_numpy
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.models.gcn_core import init_gcn_params
    from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                        make_sharded_gcn_train_step,
                                        pad_rows, rows_per_shard_for,
                                        shard_graph_by_rows)
    from gcn_tpu_torch.reorder import reorder_graph
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.checkpoint import named_leaves

    mesh = leg_mesh(mesh, exchange)
    dev = mesh.device
    data = get_dataset(graph, seed=seed)
    g = gcn_normalize(data.adj)
    x, labels = data.features.astype(np.float32), data.labels
    n = data.num_nodes
    mask_tr = np.zeros(n, np.float32)
    mask_tr[np.asarray(data.idx_train)] = 1.0
    mask_te = np.zeros(n, np.float32)
    mask_te[np.asarray(data.idx_test)] = 1.0
    g, perm = reorder_graph(g, "rabbit")
    x, labels, mask_tr, mask_te = (x[perm], labels[perm], mask_tr[perm],
                                   mask_te[perm])
    bperm = band_degree_sort_order(g, rows_per_shard_for(n, mesh.n_shards))
    g, x, labels = g.permute(bperm), x[bperm], labels[bperm]
    mask_tr, mask_te = mask_tr[bperm], mask_te[bperm]
    sg = shard_graph_by_rows(g, mesh.n_shards)
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(
        mesh, sg, dropout=dropout, exchange=exchange, exchange_dtype=wire)
    adj, xs, ys, ms = shard_fn(x, labels, mask_tr)
    params = (params_from_numpy(params0, dev) if params0 is not None
              else init_gcn_params(torch.Generator().manual_seed(seed),
                                   data.num_features, hidden,
                                   data.num_classes, device=dev))
    opt = adam_l2([t.requires_grad_(True) for _, t in named_leaves(params)],
                  0.01, 5e-4)
    losses = [float(step(params, opt, (seed + 1, i), adj, xs, ys, ms))
              for i in range(iters)]
    pred = eval_fn(params, adj, xs).argmax(1).cpu().numpy()
    lo = mesh.shards[0] * sg.rows_per_shard
    own = slice(lo, lo + pred.shape[0])
    hit = pred == pad_rows(labels, sg)[own]
    counts = torch.tensor([c for m in (mask_tr, mask_te)
                           for c in ((hit & (pad_rows(m, sg)[own] > 0)).sum(),
                                     (pad_rows(m, sg)[own] > 0).sum())],
                          dtype=torch.float64, device=dev)
    if mesh.distributed:
        dist.all_reduce(counts)
    return {"loss_final": losses[-1],
            "acc_train": float(counts[0] / counts[1]),
            "acc_test": float(counts[2] / counts[3]),
            "finite": bool(np.all(np.isfinite(losses)))}, losses


def summarize(rows, legs):
    """{leg: {wire: mean, min and max test accuracy}}."""
    import numpy as np

    summary = {}
    for graph, exch, _, _ in legs:
        leg = f"{graph}/{exch}"
        summary[leg] = {}
        for w in ("f32", "bf16", "fp8"):
            accs = [r["acc_test"] for r in rows if r["wire"] == w
                    and r["graph"] == graph and r["exchange"] == exch]
            if accs:
                summary[leg][w] = {"acc_test_mean": float(np.mean(accs)),
                                   "acc_test_min": float(np.min(accs)),
                                   "acc_test_max": float(np.max(accs))}
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", nargs="+", default=list(DEFAULT_LEGS),
                    metavar="GRAPH:EXCHANGE:HIDDEN:ITERS")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--seeds", type=int, nargs="+", default=[15, 16, 17])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("-o", "--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from gcn_tpu_torch.parallel import create_mesh, initialize_multihost
    from gcn_tpu_torch.utils.artifacts import write_artifact
    from gcn_tpu_torch.utils.chain_timing import stamp

    legs = []
    for spec in args.legs:
        graph, exch, hid, iters = spec.split(":")
        legs.append((graph, exch, int(hid), int(iters)))
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh = initialize_multihost(n_shards=args.shards, device=args.device)
    else:
        mesh = create_mesh(args.shards, args.device)
    if mesh.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for graph, exch, hid, iters in legs:
        for wire in WIRES:
            for seed in args.seeds:
                t0 = time.time()
                r, _ = run_one(mesh, graph, hid, iters, seed, wire, exch)
                r.update(graph=graph, exchange=exch, hidden=hid, iters=iters,
                         wire=wire or "f32", seed=seed,
                         wall_s=time.time() - t0)
                rows.append(r)
                if mesh.rank == 0:
                    print(f"{graph}/{exch} {r['wire']:>4} seed {seed}: loss "
                          f"{r['loss_final']:.4f} acc_test "
                          f"{r['acc_test']:.4f} ({r['wall_s']:.1f}s)",
                          flush=True)
    summary = summarize(rows, legs)
    if mesh.rank == 0:
        print("\n| leg | wire | mean acc | min..max |")
        print("|---|---|---|---|")
        for leg, by_wire in summary.items():
            for w, s in by_wire.items():
                print(f"| {leg} | {w} | {s['acc_test_mean']:.4f} | "
                      f"{s['acc_test_min']:.4f}..{s['acc_test_max']:.4f} |")
        write_artifact(args.out, {
            "config": {"legs": [list(leg) for leg in legs],
                       "shards": args.shards, "processes": mesh.world_size,
                       "seeds": args.seeds,
                       "protocol": "full sharded training per (leg, wire, "
                                   "seed): rabbit + in-band degree sort, "
                                   "dropout 0.5, adam_l2(0.01, 5e-4); "
                                   "wall_s is the host clock of a run"},
            "runs": rows, "summary": summary},
            harness="gcn_tpu_torch/bench_fp8_wire.py",
            schema="fp8_wire_eval_torch_v1", extra_meta=stamp(mesh.device))
        print(f"wrote {args.out}")
        if mesh.device.type == "cuda":
            print(stamp(mesh.device)["card"])
    if mesh.distributed:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
