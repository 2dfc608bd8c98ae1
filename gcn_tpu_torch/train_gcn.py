"""CLI training driver of the port, the counterpart of examples/train_gcn.py.

Usage:
    python -m gcn_tpu_torch.train_gcn -g synth-arxiv -k 32 -i 200 \
        --variant v6 [--reorder METHOD] [--adj dense|coo|ell|auto] \
        [--table-bf16] [--products-bf16] [--freq-split] [--span-limit N] \
        [--save-path P] [--load-path P] [--profile-ops] [--history-json H] \
        [--save-state PATH] [--resume-state PATH] [--device cuda|cpu]

Prints the dataset line, the loss every 10 steps, the timing report and the
final ``Test set results: loss= … accuracy= …`` line; logs its arguments and
result to ``profiling-gcn.log``. ``--save-path`` writes the trained
parameters and ``--load-path`` evaluates saved ones instead of training
(either package's files); ``--profile-ops`` prints the per-op table after
the fit; ``--history-json`` writes the per-step records. ``--save-state``
writes the resumable training state after the fit and ``--resume-state``
continues from one (either package's). Runs on the card unless
``--device cpu`` is given.
"""

import argparse
import sys
import time

from gcn_tpu_torch.reorder import METHODS


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a 2-layer GCN (PyTorch)")
    ap.add_argument("-g", "--graph", default="synth-small")
    ap.add_argument("-k", "--hidden", type=int, default=16)
    ap.add_argument("-i", "--train-iters", type=int, default=100)
    ap.add_argument("--variant", default="v4",
                    choices=["v1", "v2", "v3", "v4", "v5", "v6"])
    ap.add_argument("--adj", default=None,
                    choices=["dense", "coo", "ell", "auto"],
                    help="adjacency representation")
    ap.add_argument("--reorder", default=None, choices=METHODS,
                    help="vertex reorder (v6 default: rabbit)")
    ap.add_argument("--with-val", action="store_true")
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--verbose", action="store_true", default=True,
                    help="print the loss every 10 steps")
    ap.add_argument("--save-path", default=None,
                    help="save trained params (npz) after fit")
    ap.add_argument("--load-path", default=None,
                    help="load params instead of training and report their "
                         "test accuracy")
    ap.add_argument("--profile-ops", action="store_true",
                    help="after fit, print the per-op xw/af/bi timing table")
    ap.add_argument("--history-json", default=None,
                    help="write per-iteration loss (+val) records as JSON")
    ap.add_argument("--table-bf16", action="store_true",
                    help="ELL: gather x as bf16 rows, sum in f32")
    ap.add_argument("--products-bf16", action="store_true",
                    help="ELL: round each pass-block's sum to bf16")
    ap.add_argument("--freq-split", action="store_true",
                    help="ELL: frequency-split tables, a hot column prefix "
                         "and a cold tail (tile/freq_split.py)")
    ap.add_argument("--span-limit", type=int, default=None,
                    help="ELL: span_pass_limit, the hub split's cap in "
                         "pass-blocks a window (0 = no cap; default "
                         "k_pad / 2)")
    ap.add_argument("--save-state", default=None,
                    help="after fit, save the full resumable training "
                         "state (params, optimizer, iteration, dropout)")
    ap.add_argument("--resume-state", default=None,
                    help="resume training from a --save-state checkpoint")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.utils.device import resolve_device
    from gcn_tpu_torch.utils.profiling import setup_logging

    device = resolve_device(args.device)
    log = setup_logging()
    log.info("args: %s", vars(args))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"torch device: {device} ({name})")
    t0 = time.time()
    data = get_dataset(args.graph, seed=args.seed)
    print(f"[{args.graph}] n={data.num_nodes} nnz={data.adj.nnz} "
          f"f={data.num_features} classes={data.num_classes} "
          f"(loaded in {time.time()-t0:.2f}s)")
    adj_options = {}
    if args.table_bf16:
        adj_options["table_bf16"] = True
    if args.products_bf16:
        adj_options["products_bf16"] = True
    if args.freq_split:
        adj_options["freq_split"] = True
    if args.span_limit is not None:
        adj_options["span_pass_limit"] = args.span_limit
    model = GCN(data.num_features, args.hidden, data.num_classes,
                variant=args.variant, adj_kind=args.adj,
                reorder=args.reorder, seed=args.seed,
                adj_options=adj_options, device=device)
    if args.load_path:
        from gcn_tpu_torch.train.metrics import accuracy

        model.load(args.load_path)
        lp = model.predict(data.features, data.adj)
        acc = float(accuracy(
            lp, torch.as_tensor(data.labels, device=device),
            torch.as_tensor(np.asarray(data.idx_test), device=device)))
        print(f"Loaded params: test accuracy= {acc:.4f}")
        if args.history_json:
            print("--history-json ignored with --load-path (no training ran)")
        return acc

    t0 = time.time()
    model.fit(data.features, data.adj, data.labels, data.idx_train,
              idx_val=data.idx_val if args.with_val else None,
              train_iters=args.train_iters, verbose=args.verbose,
              resume_from=args.resume_state)
    print(f"fit done in {time.time()-t0:.2f}s "
          f"({model._iters_done} total iters)")
    if args.save_state:
        model.save_state(args.save_state)
        print(f"training state saved to {args.save_state}")
    print(model.timers.report())
    acc = model.test(data.idx_test)
    log.info("graph=%s variant=%s hidden=%d iters=%d acc=%.4f fit_s=%.2f",
             args.graph, args.variant, args.hidden, args.train_iters, acc,
             time.time() - t0)
    if args.save_path:
        model.save(args.save_path)
        print(f"saved params to {args.save_path}")
    if args.profile_ops:
        model.profile_ops()
    if args.history_json:
        import json

        with open(args.history_json, "w") as f:
            json.dump({"graph": args.graph, "variant": args.variant,
                       "hidden": args.hidden, "acc_test": acc,
                       "best_iter": model.best_iter,
                       "history": model.history}, f)
        print(f"wrote {args.history_json}")
    return acc


if __name__ == "__main__":
    sys.exit(0 if main() > 0 else 1)
