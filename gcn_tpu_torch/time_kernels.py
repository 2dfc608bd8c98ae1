#!/usr/bin/env python3
"""Time kernels K1 (each variant) and K2 of the gcn_tpu_torch package under
one or more repository roots on one GPU, under two chains, so that two
versions of a kernel are compared like for like.

    python3 gcn_tpu_torch/time_kernels.py ROOT [ROOT ...]

Each ROOT runs in a process of its own, in the order given (compare a
parent and a change as ``parent change change parent``): the package is
imported from ROOT, its kernels are built there (nvcc), and synth-arxiv
(seed 15) is tiled after rabbit and degree sort, as ``chip_smoke.py``
does. Each kernel is timed at synth-arxiv forward, k=32, as the median of
30 chained calls, each fed the first rows of the previous output, with
CUDA events around every call, under two chains:

  * ``host``: the events are recorded as the host issues each call, so a
    call shorter than its wrapper's Python time reads the host's pace;
  * ``device``: the chain is queued behind a ~0.1 s spin kernel, so the
    host is done enqueueing before the card reaches it and the events read
    device time (``utils/chain_timing.py::chain_ms``).

K1 is called through ``ell_spmm`` on the forward arrays, K2 through
``spmm_panel`` (its differentiable entry, under ``no_grad``), whose
signatures every version of the package shares. Prints one JSON line per
ROOT, then the card's name and power limit.

    python3 gcn_tpu_torch/time_kernels.py --hgnn-layouts

times K1 alone at k=128 on HGNN's G at ModelNet40's shape, built as
``chip_smoke.py`` builds it (n=12,311, 2048 features, seed 15; a KNN-10
hypergraph on the first 64 feature columns), in three layouts: as
``HGNN._lower`` tiles it (rows in the hypergraph's order, k_pad 128), and two
the model does not build: G degree-sorted (padding cut, hub rows split, as
GCN v6's graph is) at k_pad 128 and at k_pad 32, beside ``torch.sparse.mm``
on the same CSR. Prints one line per layout, then the card's name and power
limit.
"""

import importlib.util
import json
import os
import subprocess
import sys

SEED = 15
REPS = 30


def _chain_timing():
    """This file's own ``utils/chain_timing.py``: a ROOT's package may
    predate it, and every ROOT is timed by the same method."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "utils",
                        "chain_timing.py")
    spec = importlib.util.spec_from_file_location("_chain_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_timing = _chain_timing()
chain_ms, smi_line = _timing.chain_ms, _timing.smi_line


def time_root(root):
    """Times the kernels of the package under ``root``; prints one JSON
    line."""
    sys.path[0] = root
    import torch

    import gcn_tpu_torch
    if not os.path.abspath(gcn_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"gcn_tpu_torch was imported from "
                         f"{gcn_tpu_torch.__file__}, not from {root}")
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.ops import _build
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.ops import panel_spmm as ps
    from gcn_tpu_torch.reorder import native, reorder_graph
    from gcn_tpu_torch.tile import panel_adjacency
    from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency

    _build.build_cuda_kernels()
    _build.build_libraries({"gcnreorder": native.SOURCES}, "g++")
    if not native.available():
        raise SystemExit("the native reorder library does not load")
    dev = torch.device("cuda")
    g = gcn_normalize(get_dataset("synth-arxiv", seed=SEED).adj)
    g, _ = reorder_graph(g, "rabbit")
    g = g.permute(degree_sort_order(g))
    adj = ell_adjacency(g, k_pad=32, symmetric=True, device=dev)
    padj = panel_adjacency(g, symmetric=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(g.shape[0], 32, device=dev, generator=gen)

    def k1(**opts):
        return lambda v: es.ell_spmm(v, adj.cols, adj.vals, adj.win,
                                     adj.win_off, adj.row_space, **opts)

    kernels = {"ell_spmm": k1(), "table_bf16": k1(table_bf16=True),
               "products_bf16": k1(products_bf16=True),
               "panel_spmm": lambda v: ps.spmm_panel(padj, v)}
    result = {"root": root, "host_ms": {}, "device_ms": {}}
    with torch.no_grad():
        for name, fn in kernels.items():
            result["host_ms"][name] = chain_ms(fn, x, REPS, spin=False)
            result["device_ms"][name] = chain_ms(fn, x, REPS)
    print(json.dumps(result), flush=True)


def hgnn_layouts():
    """K1 at k=128 on HGNN's G in three layouts (the module docstring)."""
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import torch

    from gcn_tpu_torch.data.synthetic import synthetic_visual_features
    from gcn_tpu_torch.graph.hypergraph import (construct_H_with_KNN,
                                                generate_G_from_H)
    from gcn_tpu_torch.ops import _build
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency

    _build.build_cuda_kernels()
    dev = torch.device("cuda")
    fts = synthetic_visual_features(n=12311, f=2048, classes=40,
                                    seed=SEED)[0]
    g = generate_G_from_H(construct_H_with_KNN(fts[:, :64], k_neig=10,
                                               is_prob=True, m_prob=1.0))
    gs = g.permute(degree_sort_order(g))
    n = g.shape[0]
    x = torch.randn(n, 128, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    csr = g.to_torch(dev)
    print(f"HGNN G, n={n} nnz={g.nnz}, k=128: torch.sparse.mm (CSR) "
          f"{chain_ms(lambda v: torch.sparse.mm(csr, v), x, REPS):.4f} "
          f"ms", flush=True)
    for label, graph, k_pad in (("as HGNN lowers it", g, 128),
                                ("degree-sorted", gs, 128),
                                ("degree-sorted, k_pad 32", gs, 32)):
        a = ell_adjacency(graph, k_pad=k_pad, device=dev)
        ms = chain_ms(lambda v: es.ell_spmm(v, a.cols, a.vals, a.win,
                                            a.win_off, a.row_space),
                      x, REPS)
        print(f"  {label}: P={a.p} slots={a.cols.numel()} pad="
              f"{a.pad_fraction:.3f} max blocks/window="
              f"{int(a.win_off.diff().max())} n_hub={a.n_hub}: K1 "
              f"{ms:.4f} ms", flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        time_root(os.path.abspath(argv[1]))
        return 0
    layouts = argv == ["--hgnn-layouts"]
    if not layouts and (not argv or argv[0].startswith("-")):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    if layouts:
        hgnn_layouts()
    else:
        for root in argv:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root], check=True, timeout=900)
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
