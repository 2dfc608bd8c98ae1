#!/usr/bin/env python3
"""HGNN at ModelNet40's shape on the card, both forms of G: the
counterpart of gcn_tpu's ``examples/bench_hgnn.py``.

    python -m gcn_tpu_torch.bench_hgnn [--n 12311] [--f 2048] [--nhid 128]
        [--classes 40] [--k-neigs 10] [--paths dense,factored] [-o PATH]
        [--device cpu]

The workload is ModelNet40's shape (12,311 objects, 2,048 features, 40
classes, a KNN-10 hypergraph on the first 64 feature columns; synthetic
features of seed 0, as gcn_tpu's script). For each form of G:

  * ``dense``: G = Dv^-1/2 H W De^-1 H^T Dv^-1/2 as one CSR
    (``generate_G_from_H``), lowered as ``HGNN`` lowers it;
  * ``factored``: G = A1 @ A2 never formed (``generate_G_factors``,
    ``TwoHopAdj``), each factor lowered alike;

one row: ``nnz`` (G's, or the two factors' summed), ``build_s`` (G or the
factors, and the lowering), ``spmm_ms`` (one G @ h at k = n_hid: ``spmm``,
chained calls behind a spin kernel, ``utils/chain_timing.py``),
``fwd_ms`` (the evaluation forward), ``epoch_ms`` (a training epoch:
forward with dropout 0.5, cross entropy, backward, Adam with L2 decay;
layer 1 hoisted as the model runs it) and ``epoch_2spmm_ms`` (layer 1 not
hoisted: G applied in both layers, pyhgnn's HGNN_conv). The epochs are
timed in the captured flavor: the epoch captured into a CUDA graph
(``train/capture.py``) and its replays timed behind a spin kernel.

With ``--device cpu`` the forms are built and each timed path runs once on
the CPU (a rehearsal); every time is null. Prints one JSON line a form
and writes the artifact.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(HERE, "results", "hgnn_bench.json")


def hypergraph(n, f, classes, k_neigs, seed=0):
    """(features, labels, idx_train, H) of the synthetic workload."""
    from gcn_tpu_torch.data.synthetic import synthetic_visual_features
    from gcn_tpu_torch.graph.hypergraph import construct_H_with_KNN

    fts, labels, idx_train, _ = synthetic_visual_features(
        n=n, f=f, classes=classes, seed=seed)
    h = construct_H_with_KNN(fts[:, :64], k_neig=k_neigs, is_prob=True,
                             m_prob=1.0)
    return fts, labels, idx_train, h


def build(path, h, lowerer):
    """(device operator, nnz) of one form of G."""
    from gcn_tpu_torch.graph.hypergraph import (generate_G_factors,
                                                generate_G_from_H)
    from gcn_tpu_torch.ops.spmm import TwoHopAdj

    if path == "dense":
        g = generate_G_from_H(h)
        return lowerer._lower(g), g.nnz
    a1, a2 = generate_G_factors(h)
    return TwoHopAdj(lowerer._lower(a1), lowerer._lower(a2)), a1.nnz + a2.nnz


def epoch_fn(adj, x, labels, idx, n_hid, n_class, hoisted, device):
    """One training epoch as a function, and its dropout generator."""
    import torch

    from gcn_tpu_torch.models.hgnn import (cross_entropy, hgnn_forward,
                                           init_hgnn_params)
    from gcn_tpu_torch.ops.spmm import hoist_spmm, spmm
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.checkpoint import named_leaves

    params = init_hgnn_params(torch.Generator().manual_seed(0), x.shape[1],
                              n_hid, n_class, device=device)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    lr = torch.tensor(1e-3, device=device) if device.type == "cuda" else 1e-3
    opt = adam_l2(leaves, lr, 5e-4)
    gx = rs = None
    if hoisted:
        with torch.no_grad():
            gx = hoist_spmm(adj, x)
            rs = spmm(adj, x.new_ones((x.shape[0], 1)))[:, 0]
    gen = torch.Generator(device=device).manual_seed(1)

    def epoch():
        opt.zero_grad(set_to_none=True)
        logits = hgnn_forward(params, x, adj, dropout=0.5, train=True,
                              generator=gen, gx=gx, g_rowsum=rs)
        cross_entropy(logits, labels, idx).backward()
        opt.step()

    return epoch, gen


def captured_ms(epoch, gen, device, reps):
    """The captured epoch's median replay ms (None on the CPU, after two
    epochs run)."""
    from gcn_tpu_torch.train.capture import WARMUP, CapturedLoop
    from gcn_tpu_torch.utils.chain_timing import device_ms

    loop = CapturedLoop(epoch, device, gen)
    loop.run(WARMUP + 1 if device.type == "cuda" else 2)
    if device.type != "cuda":
        return None
    return device_ms(loop.graph.replay, reps)


def measure(path, h, fts, labels, idx_train, args, device):
    """One form's row (the module docstring)."""
    import numpy as np
    import torch

    from gcn_tpu_torch.models.hgnn import HGNN, hgnn_forward, \
        init_hgnn_params
    from gcn_tpu_torch.ops.spmm import spmm
    from gcn_tpu_torch.utils.chain_timing import on_device_ms

    lowerer = HGNN(args.f, args.classes, n_hid=args.nhid, device=device)
    t0 = time.time()
    adj, nnz = build(path, h, lowerer)
    if device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.time() - t0
    x = torch.as_tensor(fts, device=device)
    yl = torch.as_tensor(labels, dtype=torch.int64, device=device)
    idx = torch.as_tensor(np.asarray(idx_train), dtype=torch.int64,
                          device=device)
    hx = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (args.n, args.nhid)).astype(np.float32) * 0.01, device=device)
    spmm_ms = on_device_ms(device, lambda v: spmm(adj, v), hx, args.reps)
    params = init_hgnn_params(torch.Generator().manual_seed(0), args.f,
                              args.nhid, args.classes, device=device)
    fwd_ms = on_device_ms(device, lambda: hgnn_forward(params, x, adj),
                          reps=args.reps)
    row = {"nnz": int(nnz), "build_s": build_s, "spmm_ms": spmm_ms,
           "fwd_ms": fwd_ms}
    for key, hoisted in (("epoch_ms", True), ("epoch_2spmm_ms", False)):
        epoch, gen = epoch_fn(adj, x, yl, idx, args.nhid, args.classes,
                              hoisted, device)
        row[key] = captured_ms(epoch, gen, device, args.reps)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=12311)
    ap.add_argument("--f", type=int, default=2048)
    ap.add_argument("--nhid", type=int, default=128)
    ap.add_argument("--classes", type=int, default=40)
    ap.add_argument("--k-neigs", type=int, default=10)
    ap.add_argument("--paths", default="dense,factored")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("-o", "--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    import torch

    from gcn_tpu_torch.utils.artifacts import write_artifact
    from gcn_tpu_torch.utils.chain_timing import stamp
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    fts, labels, idx_train, h = hypergraph(args.n, args.f, args.classes,
                                           args.k_neigs)
    print(f"hypergraph built in {time.time() - t0:.1f}s (n={args.n} "
          f"f={args.f} K={args.k_neigs})", flush=True)
    rows = {}
    for path in args.paths.split(","):
        rows[path] = measure(path, h, fts, labels, idx_train, args, device)
        print(json.dumps({path: rows[path]}), flush=True)
    out = {"workload": {"n": args.n, "f": args.f, "n_hid": args.nhid,
                        "classes": args.classes, "k_neigs": args.k_neigs,
                        "note": "ModelNet40's shape, synthetic features "
                                "of seed 0"},
           "protocol": "spmm_ms, fwd_ms: median of --reps calls behind a "
                       "spin kernel (CUDA events; spmm chained); epochs: "
                       "one epoch captured into a CUDA graph, median of "
                       "--reps replays behind a spin kernel; epoch_ms "
                       "hoists layer 1, epoch_2spmm_ms applies G in both "
                       "layers",
           "paths": rows}
    if all(rows.get(p, {}).get("spmm_ms") for p in ("dense", "factored")):
        out["factored_over_dense_spmm"] = (rows["factored"]["spmm_ms"]
                                           / rows["dense"]["spmm_ms"])
    write_artifact(args.out, out, harness="gcn_tpu_torch/bench_hgnn.py",
                   schema="hgnn_bench_torch_v1", extra_meta=stamp(device))
    print(f"wrote {args.out}")
    if device.type == "cuda":
        print(stamp(device)["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
