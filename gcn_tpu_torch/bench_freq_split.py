#!/usr/bin/env python3
"""One ELL table against the frequency split, where x spills the card's L2:
the counterpart of gcn_tpu's ``examples/bench_freq_split.py``.

    python -m gcn_tpu_torch.bench_freq_split [-g synth-amazon] [-k 32]
        [--f32] [--skip-single] [--part-order] [--order-sweep]
        [--hot-rows H] [-o PATH] [--device cpu]

The graph (seed 0) goes through ``gcn_normalize``, rabbit and the degree
sort, each stage's host seconds printed. Then, in the serving layout
(``span_pass_limit=0``) with a bfloat16 gather table (gcn_tpu's default;
``--f32`` for float32):

  * ``single``: ``ell_adjacency`` + ``spmm_ell`` (K1 once): ms, ns a slot,
    slots, pad fraction, and ``torch.sparse.mm`` on the same CSR with the
    bytes bound (``utils/chain_timing.py::spmm_work``) beside it;
  * ``freq_split``: ``ell_adjacency_freq`` + ``spmm_ell_freq`` (K1 on the
    hot part, columns below ``hot_rows``, and on the cold part): hot rows,
    the hot part's share of the edges, each part's slots and pad fraction,
    ms and ns a slot; ``--part-order`` applies ``freq_split_order`` first
    (the model does so when the split is on); ``--hot-rows`` forces the
    hot height (default ``default_hot_rows``);
  * the split's output against the single table's (the same bf16 x, f32
    sums: the f32 tolerance), and ``speedup`` = single ms / split ms;
  * each one's plain version (``plain_ms``, median of 3 chained calls).

Times are medians of chained calls behind a spin kernel. gcn_tpu's
``q`` / ``q_cold`` / ``budget_mb`` columns describe the TPU's packed gather
table (``_pack_q``, ``_TABLE_BUDGET_BYTES``); K1 has no packed table, so
they are left out. ``--order-sweep`` lays out gcn_tpu's candidate row
orders (within the hot prefix and the cold tail) on the host and prints
each one's slot counts and pad fractions; on the card it also times each
one's ``spmm_ell_freq`` (gcn_tpu converted slots to time with TPU rates,
which no port number may rest on). With ``--device cpu`` every time is
null.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL_OF_MAX = 1e-5, 1e-6


def prepared(name, stages):
    """The graph after gcn_normalize, rabbit and the degree sort; each
    stage's host seconds into ``stages``."""
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.reorder import reorder_graph
    from gcn_tpu_torch.tile.ell import degree_sort_order

    t0 = time.time()
    data = get_dataset(name, seed=0)
    stages["data_s"] = time.time() - t0
    t0 = time.time()
    g = gcn_normalize(data.adj)
    stages["normalize_s"] = time.time() - t0
    t0 = time.time()
    g, _ = reorder_graph(g, "rabbit")
    stages["rabbit_s"] = time.time() - t0
    t0 = time.time()
    g = g.permute(degree_sort_order(g))
    stages["degree_sort_s"] = time.time() - t0
    return g


def parts_of(fs):
    """Slots and pad fraction of each part, and of both."""
    parts = [fs.hot] + ([fs.cold] if fs.cold is not None else [])
    slots = sum(int(p.cols.numel()) for p in parts)
    return {"hot_slots": int(fs.hot.cols.numel()),
            "cold_slots": (int(fs.cold.cols.numel()) if fs.cold is not None
                           else 0),
            "hot_pad_fraction": round(fs.hot.pad_fraction, 4),
            "cold_pad_fraction": (round(fs.cold.pad_fraction, 4)
                                  if fs.cold is not None else None),
            "slots": slots,
            "pad_fraction": round(sum(p.pad_fraction * p.cols.numel()
                                      for p in parts) / slots, 4)}


def plain_spmm(adj, x):
    """K1's plain version on one serving-layout table (no hub rows), on x
    rounded to bfloat16 first when the table is bf16, as K1 reads it."""
    import torch

    from gcn_tpu_torch.ops import ell_spmm as es

    if adj.table_bf16:
        x = x.to(torch.bfloat16).float()
    return es._ell_spmm_plain(x, adj.cols, adj.vals, adj.win, adj.win_off,
                              adj.row_space)


def plain_split(fs, x):
    """The plain version of ``spmm_ell_freq``: each part's, summed."""
    out = plain_spmm(fs.hot, x[:fs.hot_rows])
    if fs.cold is not None:
        out = out + plain_spmm(fs.cold, x[fs.hot_rows:])
    return out


def max_abs_err(got, want):
    """Max abs error of ``got``; raises past the f32 tolerance."""
    got, want = got.double(), want.double()
    scale = want.abs().max().item()
    diff = (got - want).abs()
    if not bool((diff <= RTOL * want.abs() + ATOL_OF_MAX * scale).all()):
        raise SystemExit("the split disagrees with the single table")
    return diff.max().item()


def order_sweep(g, args, device, bf16):
    """gcn_tpu's candidate orders: slots on the host, ms on the card."""
    import numpy as np
    import torch

    from gcn_tpu_torch.tile.freq_split import (default_hot_rows,
                                               ell_adjacency_freq,
                                               spmm_ell_freq)
    from gcn_tpu_torch.utils.chain_timing import on_device_ms

    n = g.shape[0]
    h_rows = args.hot_rows or default_hot_rows(n, bf16)
    if h_rows >= n:
        print(f"{args.g}: the table is not split (n={n}, hot_rows "
              f"{h_rows})", flush=True)
        return {"h_rows": h_rows, "rows": []}
    rows_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    mask = g.indices < h_rows
    hot_deg = np.bincount(rows_of[mask], minlength=n)
    cold_deg = np.bincount(rows_of[~mask], minlength=n)

    def seg_order(key_pre, key_tail):
        pre = np.argsort(-key_pre[:h_rows], kind="stable")
        tail = h_rows + np.argsort(-key_tail[h_rows:], kind="stable")
        return np.concatenate([pre, tail])

    candidates = {
        "shipped (global degree)": None,
        "cold-degree within segments": seg_order(cold_deg, cold_deg),
        "hot-degree within segments": seg_order(hot_deg, hot_deg),
        "cold-degree tail only": np.concatenate(
            [np.arange(h_rows),
             h_rows + np.argsort(-cold_deg[h_rows:], kind="stable")]),
        "hot-prefix by hot, tail by cold": seg_order(hot_deg, cold_deg),
    }
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (n, args.k)).astype(np.float32) * 0.01, device=device)
    table = []
    for name, order in candidates.items():
        g2 = g if order is None else g.permute(order)
        fs = ell_adjacency_freq(g2, table_bf16=bf16, span_pass_limit=0,
                                hot_rows=h_rows, device=device)
        row = {"order": name, **parts_of(fs),
               "ms": on_device_ms(device, lambda v: spmm_ell_freq(fs, v),
                                  x, args.reps)}
        table.append(row)
        print(json.dumps(row), flush=True)
        del fs
    return {"h_rows": h_rows, "rows": table}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-g", default="synth-amazon")
    ap.add_argument("-k", type=int, default=32)
    ap.add_argument("--f32", action="store_true",
                    help="float32 gather tables (default bfloat16, "
                         "gcn_tpu's)")
    ap.add_argument("--skip-single", action="store_true",
                    help="skip the single-table baseline")
    ap.add_argument("--order-sweep", action="store_true",
                    help="lay out gcn_tpu's candidate row orders (slots; "
                         "ms on the card)")
    ap.add_argument("--part-order", action="store_true",
                    help="apply freq_split_order before the split")
    ap.add_argument("--hot-rows", type=int, default=None,
                    help="the hot part's height (default_hot_rows)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("-o", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gcn_tpu_torch.ops.ell_spmm import spmm_ell
    from gcn_tpu_torch.tile.ell import ell_adjacency
    from gcn_tpu_torch.tile.freq_split import (ell_adjacency_freq,
                                               freq_split_order,
                                               spmm_ell_freq)
    from gcn_tpu_torch.utils.artifacts import write_artifact
    from gcn_tpu_torch.utils.chain_timing import (bound_ms, on_device_ms,
                                                  spmm_work, stamp)
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    bf16 = not args.f32
    stages = {}
    g = prepared(args.g, stages)
    n, e = g.shape[0], g.nnz
    print(f"{args.g}: n={n} nnz={e}; host s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items()), flush=True)
    out = {"graph": args.g, "n": n, "nnz": e, "k": args.k,
           "table_dtype": "bf16" if bf16 else "f32",
           "x_mb": n * args.k * 4 / 1e6, "host": stages}
    tag = args.g.replace("synth-", "")
    if args.order_sweep:
        out.update(order_sweep(g, args, device, bf16))
        path = args.o or os.path.join(HERE, "results",
                                      f"freq_split_order_{tag}.json")
        write_artifact(path, out,
                       harness="gcn_tpu_torch/bench_freq_split.py "
                               "--order-sweep",
                       schema="freq_split_order_torch_v1",
                       extra_meta=stamp(device))
        print(f"wrote {path}")
        return 0

    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (n, args.k)).astype(np.float32) * 0.01, device=device)
    want = None
    if not args.skip_single:
        t0 = time.time()
        adj = ell_adjacency(g, symmetric=True, table_bf16=bf16,
                            span_pass_limit=0, device=device)
        build_s = time.time() - t0
        ms = on_device_ms(device, lambda v: spmm_ell(adj, v), x, args.reps)
        plain_ms = on_device_ms(device, lambda v: plain_spmm(adj, v), x, 3)
        csr = g.to_torch(device)
        lib = on_device_ms(device, lambda v: torch.sparse.mm(csr, v), x,
                           args.reps)
        b_ms, b_by = bound_ms(*spmm_work(e, adj.win_off.numel(), n, n,
                                         args.k))
        slots = int(adj.cols.numel())
        out["single"] = {
            "ms": ms, "ns_per_slot": None if ms is None else
            ms * 1e6 / slots, "slots": slots,
            "pad_fraction": round(adj.pad_fraction, 4),
            "plain_ms": plain_ms, "sparse_mm_ms": lib, "bound_ms": b_ms,
            "bound_by": b_by, "build_s": build_s}
        print(f"single table: {json.dumps(out['single'])}", flush=True)
        with torch.no_grad():
            want = spmm_ell(adj, x)
        del adj, csr

    t0 = time.time()
    g_split = g
    if args.part_order:
        po = freq_split_order(g, hot_rows=args.hot_rows, table_bf16=bf16)
        if po is not None:
            g_split = g.permute(po)
            x = x[torch.as_tensor(po, device=device)]
            if want is not None:
                want = want[torch.as_tensor(po, device=device)]
        out["part_order"] = po is not None
    fs = ell_adjacency_freq(g_split, hot_rows=args.hot_rows,
                            table_bf16=bf16, span_pass_limit=0,
                            device=device)
    build_s = time.time() - t0
    ms = on_device_ms(device, lambda v: spmm_ell_freq(fs, v), x, args.reps)
    plain_ms = on_device_ms(device, lambda v: plain_split(fs, v), x, 3)
    part = parts_of(fs)
    out["freq_split"] = {
        "hot_rows": fs.hot_rows,
        "hot_edge_fraction": round(fs.hot_edge_fraction, 4), **part,
        "ms": ms, "ns_per_slot": None if ms is None else
        ms * 1e6 / part["slots"], "plain_ms": plain_ms,
        "build_s": build_s}
    if want is not None:
        with torch.no_grad():
            out["freq_split"]["max_abs_err_vs_single"] = max_abs_err(
                spmm_ell_freq(fs, x), want)
    out["edges_per_s_freq"] = None if ms is None else e / (ms * 1e-3)
    print(f"freq split: {json.dumps(out['freq_split'])}", flush=True)
    if out.get("single", {}).get("ms") and ms:
        out["speedup"] = out["single"]["ms"] / ms
        print(f"speedup: {out['speedup']:.3f}x", flush=True)
    path = args.o or os.path.join(HERE, "results",
                                  f"freq_split_{tag}.json")
    write_artifact(path, out, harness="gcn_tpu_torch/bench_freq_split.py",
                   schema="freq_split_torch_v1", allow=["speedup"],
                   extra_meta=stamp(device))
    print(f"wrote {path}")
    if device.type == "cuda":
        print(stamp(device)["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
