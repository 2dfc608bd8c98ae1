"""Row-band sharded GCN training driver, the counterpart of
``examples/train_gcn_dist.py``.

Full-batch 2-layer GCN with the graph cut into ``--shards`` row bands,
trained through ``parallel.make_sharded_gcn_train_step`` (the ragged halo
exchange, the fused boundary-rows-first overlap on K1, an optional bf16 or
fp8 wire). One process owns every shard:

    python -m gcn_tpu_torch.train_gcn_dist --shards 4 -g synth-arxiv -k 32

Under ``torchrun`` it is P processes with shards / P bands each (NCCL on
the cards, gloo with ``--device cpu``):

    torchrun --nproc-per-node 2 -m gcn_tpu_torch.train_gcn_dist \\
        --shards 4 -g synth-arxiv -k 32

Same flags as the gcn_tpu driver, less ``--hier`` and ``--halo-wire
auto``; ``--save-state`` / ``--resume-state`` write and read the training
state in gcn_tpu's checkpoint layout (``utils/checkpoint.py``). The dropout
stream is a function of (seed, iteration, band), so a resumed run equals an
uninterrupted one. Runs on the card unless ``--device cpu`` is given; rank
0 prints.
"""

import argparse
import os
import sys
import time

from gcn_tpu_torch.reorder import METHODS


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Row-band sharded full-batch GCN training (PyTorch)")
    ap.add_argument("-g", "--graph", default="synth-pubmed")
    ap.add_argument("-k", "--hidden", type=int, default=16)
    ap.add_argument("-i", "--train-iters", type=int, default=100)
    ap.add_argument("--shards", type=int, default=None,
                    help="row bands (default: one a process)")
    ap.add_argument("--exchange", default="halo",
                    choices=["halo", "halo_padded", "halo_hier",
                             "all_gather"])
    ap.add_argument("--halo-bf16", action="store_true",
                    help="exchange_dtype='bf16': bf16 payload on the wire "
                         "(forward and backward), cast back on arrival")
    ap.add_argument("--halo-wire", default=None,
                    choices=["f32", "bf16", "fp8"],
                    help="wire dtype of the halo payload: bf16 halves the "
                         "bytes, fp8 (float8_e4m3fn, clipped) quarters "
                         "them. Overrides --halo-bf16.")
    ap.add_argument("--no-overlap", action="store_true",
                    help="the monolithic layout without overlap (not "
                         "ported yet)")
    ap.add_argument("--reorder", default="rabbit", choices=METHODS,
                    help="vertex reorder (rabbit shrinks the halo; the "
                         "in-band degree sort is composed after it)")
    ap.add_argument("--exchange-chunk", type=int, default=32,
                    help="k-chunk the exchange and the halo aggregation at "
                         "layer widths past this (0 = one piece)")
    ap.add_argument("--k-pad", type=int, default=0,
                    choices=[0, 8, 16, 32, 64, 128],
                    help="ELL slot width of the per-shard layouts (0 = "
                         "auto: the widest SpMM operand, capped at 128)")
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--save-state", default=None, metavar="PATH",
                    help="write the resumable training state (params, "
                         "optimizer, iteration) after the run")
    ap.add_argument("--resume-state", default=None, metavar="PATH",
                    help="continue from a --save-state checkpoint")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.models.gcn_core import init_gcn_params
    from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                        build_halo_plan_ragged, create_mesh,
                                        initialize_multihost,
                                        make_sharded_gcn_train_step,
                                        pad_rows, rows_per_shard_for,
                                        shard_graph_by_rows)
    from gcn_tpu_torch.reorder import reorder_graph
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.checkpoint import (load_training_state,
                                                named_leaves,
                                                save_training_state)

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh = initialize_multihost(n_shards=args.shards, device=args.device)
    else:
        mesh = create_mesh(args.shards or 1, args.device)
    d = mesh.n_shards

    def log(*a):
        if mesh.rank == 0:
            print(*a, flush=True)

    dev = mesh.device
    log(f"torch device: {dev} "
        f"({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
        f"), {mesh.world_size} process(es), {mesh.shards_per_rank} shard(s) "
        f"each")
    t0 = time.time()
    data = get_dataset(args.graph, seed=args.seed)
    g = gcn_normalize(data.adj)
    x, labels = data.features, data.labels
    n = data.num_nodes
    mask_tr = np.zeros(n, np.float32)
    mask_tr[np.asarray(data.idx_train)] = 1.0
    mask_te = np.zeros(n, np.float32)
    mask_te[np.asarray(data.idx_test)] = 1.0
    log(f"[{args.graph}] n={n} nnz={g.nnz} f={data.num_features} "
        f"classes={data.num_classes} (loaded {time.time() - t0:.2f}s)")

    # reorder for halo locality, then the in-band degree sort for ELL fill
    t0 = time.time()
    if args.reorder and args.reorder != "identity":
        g, perm = reorder_graph(g, args.reorder)
        x, labels = x[perm], labels[perm]
        mask_tr, mask_te = mask_tr[perm], mask_te[perm]
    bperm = band_degree_sort_order(g, rows_per_shard_for(n, d))
    g, x, labels = g.permute(bperm), x[bperm], labels[bperm]
    mask_tr, mask_te = mask_tr[bperm], mask_te[bperm]
    sg = shard_graph_by_rows(g, d)
    log(f"reorder+shard: {time.time() - t0:.2f}s, {d} bands of "
        f"{sg.rows_per_shard} rows")

    wire = ({"f32": None, "bf16": "bf16", "fp8": "fp8"}[args.halo_wire]
            if args.halo_wire else ("bf16" if args.halo_bf16 else None))
    t0 = time.time()
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(
        mesh, sg, dropout=args.dropout, exchange=args.exchange,
        overlap=not args.no_overlap, exchange_dtype=wire,
        exchange_chunk=args.exchange_chunk or None,
        k_pad=args.k_pad or next(
            k for k in (32, 64, 128)
            if k >= min(max(args.hidden, data.num_classes), 128)))
    adj, xs, ys, ms = shard_fn(x.astype(np.float32), labels, mask_tr)
    log(f"plan and layouts: {time.time() - t0:.2f}s")

    adam_index = 1 if args.weight_decay else 0
    params = init_gcn_params(torch.Generator().manual_seed(args.seed),
                             data.num_features, args.hidden,
                             data.num_classes, device=dev)
    it0, adam_state = 0, None
    if args.resume_state:
        state = load_training_state(args.resume_state, params,
                                    adam_index=adam_index)
        params, adam_state, it0 = (state.params, state.adam_state,
                                   state.iteration)
        log(f"resumed from {args.resume_state} at iteration {it0}")
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    opt = adam_l2(leaves, args.lr, args.weight_decay)
    if adam_state:
        full = opt.state_dict()
        full["state"] = adam_state
        opt.load_state_dict(full)

    t0 = time.time()
    losses = []
    for i in range(it0, it0 + args.train_iters):
        loss = step(params, opt, (args.seed + 1, i), adj, xs, ys, ms)
        losses.append(float(loss))
        if i == it0:
            log(f"first step (kernel build included) "
                f"{time.time() - t0:.2f}s")
            t0 = time.time()
        if i % 10 == 0:
            log(f"Epoch {i:4d}, training loss: {losses[-1]:.6f}")
    per_it = (time.time() - t0) / max(args.train_iters - 1, 1)
    log(f"fit done: {per_it * 1e3:.2f} ms/iter warm ({args.train_iters} "
        f"iters, final loss {losses[-1]:.6f})")
    if args.save_state and mesh.rank == 0:
        save_training_state(args.save_state, params,
                            opt.state_dict()["state"],
                            it0 + args.train_iters, adam_index=adam_index)
        log(f"saved training state to {args.save_state}")

    # accuracy over the owned rows, the counts summed over the processes
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
    acc_tr, acc = (float(counts[0] / counts[1]), float(counts[2] / counts[3]))
    log(f"Train accuracy= {acc_tr:.4f}")
    log(f"Test set results: accuracy= {acc:.4f}")
    if args.exchange == "halo":
        log(f"exchange fraction: "
            f"{build_halo_plan_ragged(sg).exchange_fraction:.3f}")
    if mesh.distributed:
        dist.destroy_process_group()
    return acc


if __name__ == "__main__":
    sys.exit(0 if main() > 0 else 1)
