#!/usr/bin/env python3
"""The slot-width (k_pad) sweep of K1 on the card: the counterpart of
gcn_tpu's ``examples/bench_kpad.py``.

    python -m gcn_tpu_torch.bench_kpad [-g synth-arxiv synth-reddit]
        [--ks 32 64 128] [--k-pads 32 64 128] [-o PATH] [--device cpu]

A layout's slot width k_pad sets P = 128 // k_pad slots a row of a
pass-block: 4 at k_pad 32, 2 at 64 and 1 at 128 (``GCN`` picks the widest
SpMM operand's, ``models/gcn.py``). For each graph (seed 0, through
``gcn_normalize``, rabbit and the degree sort, as gcn_tpu's script) and each
k_pad, the serving layout (``ell_adjacency(span_pass_limit=0)``: no hub
split, so K1 alone, through ``spmm_ell``) is built once; then for each
width k:

  * K1 against its plain version evaluated in float64 (32 columns at a
    time), at the f32 tolerance of ``chip_smoke.py`` (rtol 1e-5, atol 1e-6
    x max|out|), before anything is timed;
  * gcn_tpu's columns: ``ell_ms`` (median of ``--reps`` chained calls
    behind a spin kernel, ``utils/chain_timing.py``), ``edges_per_s``
    (stored edges over it), ``slots``, ``pad_fraction``, ``spans``;
  * ``plain_ms``: K1's plain version (``ops/ell_spmm.py``) on the card,
    median of 3 chained calls; ``sparse_mm_ms``: ``torch.sparse.mm`` on
    the same CSR, timed as K1;
  * ``bound_ms`` / ``bound_by``: the least time of the same SpMM on an
    H100 (``chain_timing.spmm_work``: 8 B a stored edge, the window
    offsets, x read once, the rows written once; as ``chip_smoke.py``'s
    ``k1_bound``), and ``x_mb``, x's size (the L2 holds 50 MB).

With ``--device cpu`` the layouts, host columns and the float64 check run
on the CPU (K1's plain version) and every time is null: a CPU run gives no
device time. Prints one JSON line a row and writes the artifact
(``utils/artifacts.py``, stamped with the card's name and power limit).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(HERE, "results", "kpad_sweep.json")
RTOL, ATOL_OF_MAX = 1e-5, 1e-6


def k1_error(adj, x):
    """K1 (``ell_spmm`` on the forward arrays) against its plain version in
    float64, 32 columns at a time; raises past the f32 tolerance. Returns
    the max abs error."""
    import torch

    from gcn_tpu_torch.ops import ell_spmm as es

    args = (adj.cols, adj.vals, adj.win, adj.win_off, adj.row_space)
    with torch.no_grad():
        got = es.ell_spmm(x, *args).double()
        want = torch.cat([es._ell_spmm_plain(
            x[:, c:c + 32].double(), adj.cols, adj.vals.double(),
            *args[2:]) for c in range(0, x.shape[1], 32)], dim=1)
    scale = want.abs().max().item()
    diff = (got - want).abs()
    if not bool((diff <= RTOL * want.abs() + ATOL_OF_MAX * scale).all()):
        raise SystemExit(f"K1 disagrees with its float64 plain version at "
                         f"k_pad {adj.k_pad}, k {x.shape[1]}")
    return diff.max().item()


def sweep_graph(name, ks, k_pads, device, reps):
    """The rows of one graph (the module docstring)."""
    import numpy as np
    import torch

    from gcn_tpu_torch.bench import prepared_graph
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.tile.ell import ell_adjacency
    from gcn_tpu_torch.utils.chain_timing import (bound_ms, on_device_ms,
                                                  spmm_work)

    t0 = time.time()
    g = prepared_graph(name)[1]
    n, e = g.shape[0], g.nnz
    print(f"[{name}] n={n} nnz={e} (rabbit + degree sort "
          f"{time.time() - t0:.1f}s)", flush=True)
    csr = g.to_torch(device)
    rng = np.random.default_rng(0)
    xs = {k: torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32)
                             * 0.01, device=device) for k in ks}
    rows = []
    for kp in k_pads:
        t0 = time.time()
        adj = ell_adjacency(g, symmetric=True, span_pass_limit=0, k_pad=kp,
                            device=device)
        build_s = time.time() - t0
        args = (adj.cols, adj.vals, adj.win, adj.win_off, adj.row_space)
        for k in ks:
            x = xs[k]
            err = k1_error(adj, x)
            ms = on_device_ms(device, lambda v: es.ell_spmm(v, *args), x,
                              reps)
            plain_ms = on_device_ms(
                device, lambda v: es._ell_spmm_plain(v, *args), x, 3)
            lib = on_device_ms(device, lambda v: torch.sparse.mm(csr, v), x,
                               reps)
            b_ms, b_by = bound_ms(*spmm_work(e, adj.win_off.numel(), n, n,
                                             k))
            rows.append({
                "graph": name, "k": k, "k_pad": kp, "p": adj.p,
                "ell_ms": ms,
                "edges_per_s": None if ms is None else e / (ms * 1e-3),
                "slots": int(adj.cols.numel()),
                "pad_fraction": round(adj.pad_fraction, 4),
                "spans": len(adj.spans), "plain_ms": plain_ms,
                "sparse_mm_ms": lib,
                "bound_ms": b_ms, "bound_by": b_by,
                "x_mb": n * k * 4 / 1e6, "max_abs_err": err,
                "build_s": build_s})
            print(json.dumps(rows[-1]), flush=True)
        del adj
    return {"n": n, "nnz": e}, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-g", "--graphs", nargs="+",
                    default=["synth-arxiv", "synth-reddit"])
    ap.add_argument("--ks", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--k-pads", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("-o", "--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    from gcn_tpu_torch.ops import _build
    from gcn_tpu_torch.utils.artifacts import write_artifact
    from gcn_tpu_torch.utils.chain_timing import stamp
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        _build.build_cuda_kernels()
    graphs, rows = {}, []
    for name in args.graphs:
        graphs[name], graph_rows = sweep_graph(name, args.ks, args.k_pads,
                                               device, args.reps)
        rows.extend(graph_rows)
    write_artifact(args.out, {
        "graphs": graphs,
        "protocol": "serving layout (span_pass_limit=0), rabbit + degree "
                    "sort, seed 0; K1 through ell_spmm checked against its "
                    "float64 plain version, then the median of --reps "
                    "chained calls behind a spin kernel (CUDA events); "
                    "torch.sparse.mm on the same CSR timed alike; bound: "
                    "8 B a stored edge + window offsets + x and the rows "
                    "once at 3.35 TB/s against 2 flop an edge and column "
                    "at 67 TFLOP/s",
        "rows": rows}, harness="gcn_tpu_torch/bench_kpad.py",
        schema="kpad_sweep_torch_v1", extra_meta=stamp(device))
    print(f"wrote {args.out}")
    if device.type == "cuda":
        print(stamp(device)["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
