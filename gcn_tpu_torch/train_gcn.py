"""CLI training driver of the port, the counterpart of examples/train_gcn.py.

Usage:
    python -m gcn_tpu_torch.train_gcn -g synth-arxiv -k 32 -i 200 \
        --variant v6 [--reorder rabbit] [--adj coo|dense|ell|auto] \
        [--table-bf16] [--products-bf16] [--freq-split] \
        [--save-state PATH] [--resume-state PATH] [--device cuda|cpu]

Prints the dataset line, the timing report and the final
``Test set results: loss= … accuracy= …`` line. ``--save-state`` writes
the resumable training state after the fit and ``--resume-state``
continues from one (either package's). Runs on the card unless
``--device cpu`` is given.
"""

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a 2-layer GCN (PyTorch)")
    ap.add_argument("-g", "--graph", default="synth-small")
    ap.add_argument("-k", "--hidden", type=int, default=16)
    ap.add_argument("-i", "--train-iters", type=int, default=100)
    ap.add_argument("--variant", default="v4",
                    choices=["v1", "v2", "v3", "v4", "v5", "v6"])
    ap.add_argument("--adj", default=None,
                    help="adjacency representation: dense|coo|ell|auto")
    ap.add_argument("--reorder", default=None, help="identity|degree|rabbit")
    ap.add_argument("--with-val", action="store_true")
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--table-bf16", action="store_true",
                    help="ELL: gather x as bf16 rows, sum in f32")
    ap.add_argument("--products-bf16", action="store_true",
                    help="ELL: round each pass-block's sum to bf16")
    ap.add_argument("--freq-split", action="store_true",
                    help="ELL: frequency-split tables, a hot column prefix "
                         "and a cold tail (tile/freq_split.py)")
    ap.add_argument("--save-state", default=None,
                    help="after fit, save the full resumable training "
                         "state (params, optimizer, iteration, dropout)")
    ap.add_argument("--resume-state", default=None,
                    help="resume training from a --save-state checkpoint")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
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
    model = GCN(data.num_features, args.hidden, data.num_classes,
                variant=args.variant, adj_kind=args.adj,
                reorder=args.reorder, seed=args.seed,
                adj_options=adj_options, device=device)
    t0 = time.time()
    model.fit(data.features, data.adj, data.labels, data.idx_train,
              idx_val=data.idx_val if args.with_val else None,
              train_iters=args.train_iters, verbose=True,
              resume_from=args.resume_state)
    print(f"fit done in {time.time()-t0:.2f}s "
          f"({model._iters_done} total iters)")
    if args.save_state:
        model.save_state(args.save_state)
        print(f"training state saved to {args.save_state}")
    print(model.timers.report())
    return model.test(data.idx_test)


if __name__ == "__main__":
    sys.exit(0 if main() > 0 else 1)
