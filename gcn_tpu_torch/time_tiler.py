#!/usr/bin/env python3
"""Host seconds of the ELL tiler: the native C++ tiler against numpy.

    python3 gcn_tpu_torch/time_tiler.py [-g GRAPH ...] [--k-pad K]
                                        [--reps N]

For each graph (default synth-arxiv, synth-reddit and synth-yelp, seed 15):
``gcn_normalize``, then the degree sort (``degree_sort_order``), as the v6
path tiles it. Then, on the host, the median of ``--reps`` runs of

  * ``tile``: the tiler alone on the forward direction's (hub-split) row
    pointer, ``native.ell_arrays`` against ``_ell_arrays`` (no pass ladder);
  * ``ell_adjacency``: the whole layout (both directions, hub split, span
    and chunk plans; ``device="cpu"``, so no upload) with
    ``prefer_native=True`` and ``False``, with the route each direction
    took (``tile_route``).

Both routes' arrays are checked equal, element for element. Prints one JSON
line per graph, then the card's name and power limit where ``nvidia-smi``
is present (the host it runs on is the card's).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _median_s(fn, reps):
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def time_graph(name, k_pad, reps):
    import numpy as np

    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.tile import native
    from gcn_tpu_torch.tile.ell import (_ell_arrays, _split_hub_rows,
                                        degree_sort_order, ell_adjacency)

    t0 = time.perf_counter()
    data = get_dataset(name, seed=15)
    g = gcn_normalize(data.adj)
    g = g.permute(degree_sort_order(g))
    prep_s = time.perf_counter() - t0
    p = 128 // k_pad
    r = 128
    cap = max(1, k_pad // 2) * p
    split = _split_hub_rows(g.indptr, cap)
    indptr, n_rows = ((split[0], split[3]) if split is not None
                      else (g.indptr, g.shape[0]))
    t_nat, nat = _median_s(lambda: native.ell_arrays(
        indptr, g.indices, g.data, n_rows, r, p), reps)
    t_np, ref = _median_s(lambda: _ell_arrays(
        indptr, g.indices, g.data, n_rows, r, p)[:3], reps)
    same_tile = all(np.array_equal(a, b) for a, b in zip(nat, ref))
    t_adj_nat, a_nat = _median_s(lambda: ell_adjacency(
        g, k_pad=k_pad, prefer_native=True, device="cpu"), reps)
    t_adj_np, a_np = _median_s(lambda: ell_adjacency(
        g, k_pad=k_pad, prefer_native=False, device="cpu"), reps)
    same_adj = all(
        np.array_equal(getattr(a_nat, f).numpy(), getattr(a_np, f).numpy())
        for f in ("cols", "vals", "win", "win_off", "t_cols", "t_vals",
                  "t_win", "t_win_off"))
    return {"graph": name, "n": g.shape[0], "nnz": g.nnz, "k_pad": k_pad,
            "slots": int(a_nat.cols.numel()), "n_hub": a_nat.n_hub,
            "prep_s": prep_s, "reps": reps,
            "tile_native_s": t_nat, "tile_numpy_s": t_np,
            "tile_equal": bool(same_tile),
            "ell_adjacency_native_s": t_adj_nat,
            "ell_adjacency_numpy_s": t_adj_np,
            "routes": [a_nat.tiler, a_nat.t_tiler],
            "numpy_routes": [a_np.tiler, a_np.t_tiler],
            "ell_adjacency_equal": bool(same_adj)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-g", "--graphs", nargs="+",
                    default=["synth-arxiv", "synth-reddit", "synth-yelp"])
    ap.add_argument("--k-pad", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    from gcn_tpu_torch.tile import native

    if not native.available():
        sys.exit("the native tiler did not build (g++)")
    ok = True
    for name in args.graphs:
        row = time_graph(name, args.k_pad, args.reps)
        ok = ok and row["tile_equal"] and row["ell_adjacency_equal"]
        print(json.dumps(row), flush=True)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "nvidia-smi not present"
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
