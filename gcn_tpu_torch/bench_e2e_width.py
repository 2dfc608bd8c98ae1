#!/usr/bin/env python3
"""GCN at the widths users train (hidden 64 and 128) on the card: the
counterpart of gcn_tpu's ``examples/bench_e2e_width.py``.

    python -m gcn_tpu_torch.bench_e2e_width [-g synth-arxiv] [-i 200]
        [--variants v4,v6] [--hiddens 64,128] [-o PATH] [--device cpu]

For each variant and hidden width, two full fits through the public API
(``GCN(...).fit``, the default captured loop, ``jit_loop=True``; seeds 15
and 16) on the graph of seed 0, and for each:

  * ``acc_test`` (and ``acc_test_seed16``);
  * ``setup_s``: the fit's wall time outside its training loop (reorder,
    tiling, upload, the layer-1 hoist, the final evaluation), and
    ``extra_s``: the loop's wall time beyond its iterations at the median
    step (the eager warm-up iterations and the capture; on the CPU, the
    loop's spread) — gcn_tpu's compile time has no counterpart here;
  * ``fit_step_ms``: the fit's own median step (dropout 0.5; replays);
  * ``step_ms_captured`` / ``step_ms_eager``: ``bench.py``'s train-step
    protocol at this width on the first fit's adjacency and layer-1 input
    (``utils/chain_timing.py::train_step_ms``: dropout 0, 20 steps, the
    captured step replayed, or eager steps);
  * ``busy_share``: the captured step's device-busy share over 10 replays
    under torch.profiler, its device ms and its K1 ms a step;
  * ``k_pad`` / ``p`` of the ELL layout (v6: 64 at hidden 64, 128 at
    hidden 128), or the adjacency kind (v4: torch's COO product), and the
    K1 launches of a 5-step eager fit (``spmm_ell_launches_by_k``).

With ``--device cpu`` the fits run on the CPU and every time is null.
Prints one JSON line a row, a summary table, and writes the artifact.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(HERE, "results", "e2e_width_arxiv.json")
SEEDS = (15, 16)


def fit(data, variant, hidden, iters, seed, device, jit_loop=True):
    """(model, test accuracy, wall s) of one fit through ``GCN.fit``."""
    import torch

    from gcn_tpu_torch.models import GCN

    model = GCN(data.num_features, hidden, data.num_classes,
                variant=variant, seed=seed, device=device)
    t0 = time.time()
    model.fit(data.features, data.adj, data.labels, data.idx_train,
              train_iters=iters, jit_loop=jit_loop)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.time() - t0
    return model, float(model.test(data.idx_test, verbose=False)), wall_s


def loop_s(model):
    """The fit's training loop, s: the captured loop's ``fit_scan`` timer
    (warm-up, capture and replays)."""
    return model.timers("fit_scan").d.total_ms / 1e3


def model_step(model, idx_train):
    """One training step of the fitted model's own (forward, masked NLL,
    backward, Adam) as a function, on its adjacency and layer-1 input."""
    import torch

    from gcn_tpu_torch.models.gcn_core import gcn_forward
    from gcn_tpu_torch.train.metrics import masked_nll
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.checkpoint import named_leaves

    params = {name: {k: t.detach().clone().requires_grad_(True)
                     for k, t in layer.items()}
              for name, layer in model.params.items()}
    opt = adam_l2([t for _, t in named_leaves(params)], model.lr,
                  model.weight_decay)
    idx = model._remap_idx(idx_train)
    feats = (model._hoisted_ax if model._hoisted_ax is not None
             else model.features)
    orders = model._orders()
    gen = torch.Generator(device=model.device).manual_seed(0)

    def step():
        opt.zero_grad(set_to_none=True)
        lp = gcn_forward(params, feats, model.adj_norm, orders=orders,
                         dropout_rate=model.dropout, train=True,
                         generator=gen)
        masked_nll(lp, model.labels, idx).backward()
        opt.step()

    return step, gen


def k1_launches(data, variant, hidden, device):
    """K1's launches by width in a 5-step eager fit (the host counter sees
    every launch of the eager flavor)."""
    from gcn_tpu_torch.ops import ell_spmm as es

    es.spmm_ell_launches_by_k.clear()
    fit(data, variant, hidden, 5, SEEDS[0], device, jit_loop=False)
    return dict(sorted(es.spmm_ell_launches_by_k.items()))


def measure(data, variant, hidden, iters, device):
    """One row (the module docstring)."""
    from gcn_tpu_torch.tile.ell import EllAdj
    from gcn_tpu_torch.train.capture import WARMUP, CapturedLoop
    from gcn_tpu_torch.utils import chain_timing as ct

    on_card = device.type == "cuda"
    runs = [fit(data, variant, hidden, iters, seed, device)
            for seed in SEEDS]
    model = runs[0][0]
    adj = model.adj_norm
    row = {"graph": data.name, "variant": variant, "hidden": hidden,
           "iters": iters, "hoisted": model._hoisted_ax is not None,
           "adjacency": type(adj).__name__,
           "k_pad": adj.k_pad if isinstance(adj, EllAdj) else None,
           "p": adj.p if isinstance(adj, EllAdj) else None,
           "acc_test": runs[0][1], "acc_test_seed16": runs[1][1],
           "k1_launches_5_eager_steps": {
               str(k): v for k, v in k1_launches(data, variant, hidden,
                                                 device).items()}}
    for i, (m, _, wall_s) in enumerate(runs):
        tag = "" if i == 0 else "_seed16"
        step_ms = m.timers("step").d.median_ms
        row[f"fit_wall_s{tag}"] = wall_s
        row[f"setup_s{tag}"] = max(wall_s - loop_s(m), 0.0)
        row[f"extra_s{tag}"] = max(loop_s(m) - iters * step_ms / 1e3, 0.0)
        row[f"fit_step_ms{tag}"] = step_ms if on_card else None
    if not on_card:
        row.update(step_ms_captured=None, step_ms_eager=None,
                   busy_share=None, busy_ms=None, k1_ms=None)
        return row
    feats = (model._hoisted_ax if model._hoisted_ax is not None
             else model.features)
    idx = model._remap_idx(data.idx_train)
    for flavor, jit_loop in (("captured", True), ("eager", False)):
        row[f"step_ms_{flavor}"] = ct.train_step_ms(
            adj, feats, model.labels, idx, hidden, model.nclass,
            jit_loop=jit_loop)
    step, gen = model_step(model, data.idx_train)
    loop = CapturedLoop(step, device, gen)
    loop.run(WARMUP + 1)        # the eager warm-up, then the capture
    busy = ct.device_busy(loop.graph.replay, 10)
    row.update(busy_share=busy["busy_share"], busy_ms=busy["busy_ms"],
               replay_wall_ms=busy["wall_ms"], k1_ms=busy["kernel_ms"])
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-g", "--graph", default="synth-arxiv")
    ap.add_argument("-i", "--train-iters", type=int, default=200)
    ap.add_argument("--variants", default="v4,v6")
    ap.add_argument("--hiddens", default="64,128")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("-o", "--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    import torch

    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.utils.artifacts import write_artifact
    from gcn_tpu_torch.utils.chain_timing import stamp
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    data = get_dataset(args.graph, seed=0)
    print(f"[{args.graph}] n={data.num_nodes} nnz={data.adj.nnz} "
          f"f={data.num_features} classes={data.num_classes}", flush=True)
    rows = []
    for variant in args.variants.split(","):
        for hidden in (int(h) for h in args.hiddens.split(",")):
            rows.append(measure(data, variant, hidden, args.train_iters,
                                device))
            print(json.dumps(rows[-1]), flush=True)
    write_artifact(args.out, {
        "protocol": "two fits through GCN.fit (jit_loop=True, seeds 15 "
                    "and 16; the graph of seed 0); setup_s = fit wall - "
                    "loop (fit_scan), extra_s = loop - iters x median "
                    "step; step_ms_*: chain_timing.train_step_ms on the "
                    "first fit's arrays (dropout 0, 20 steps, replays or "
                    "eager steps between CUDA events); busy_share: 10 "
                    "replays of the fitted model's step under "
                    "torch.profiler",
        "rows": rows}, harness="gcn_tpu_torch/bench_e2e_width.py",
        schema="e2e_width_torch_v1", extra_meta=stamp(device))
    print(f"wrote {args.out}")
    print("\n| variant | hidden | k_pad | acc | step ms captured | eager | "
          "busy | setup s | extra s |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['variant']} | {r['hidden']} | {r['k_pad']} | "
              f"{r['acc_test']:.4f} | {r['step_ms_captured']} | "
              f"{r['step_ms_eager']} | {r['busy_share']} | "
              f"{r['setup_s']:.2f} | {r['extra_s']:.2f} |")
    if device.type == "cuda":
        print(stamp(device)["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
