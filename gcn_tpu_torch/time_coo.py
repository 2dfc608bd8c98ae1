#!/usr/bin/env python3
"""Time the COO product (the adjacency GCN v1-v5 train on past 8,192 rows)
on one GPU.

    python3 gcn_tpu_torch/time_coo.py [-k 32 40 64 128]

It times, on synth-arxiv (seed 0, after ``gcn_normalize``) in its own
vertex order (GCN v4's: no reorder) and after rabbit and the
degree sort (``bench.py``'s order), at each width k, these ways to compute
``out[r] = sum_e [rows[e] == r] vals[e] * x[cols[e]]`` over the row-sorted
COO arrays of ``coo_adjacency``:

  * ``products``: the gather and weight ``x[cols] * vals`` alone, and
    ``products index_select``: the same with ``torch.index_select`` as the
    gather;
  * ``index_add``: the products added with ``index_add_`` (atomic adds on
    the card, in an order that changes from call to call);
  * ``segment_sum``: the products summed by ``torch.segment_reduce`` over
    each row's run of edges (one thread a row and column, in edge order);
  * ``chunked C``: the same in two levels: each row's run cut into chunks
    of at most C edges, the chunks summed in edge order, then each row's
    chunks in chunk order;
  * ``spmm``: the package's own ``spmm`` on the ``CooAdj``: on the card
    the COO kernel (``ops/csrc/coo_spmm.cu``), which ``spmm_equal``
    compares with ``segment_sum`` (the kernel's plain version) bit for
    bit;
  * ``torch.sparse.mm`` on the same CSR, the library yardstick;

each as the median of 30 calls behind a spin kernel between CUDA events
(``utils/chain_timing.py::device_ms``), against the float64 sum (f32
tolerance), with two calls compared bit for bit and one call captured into
a CUDA graph and replayed against an eager call; and the bytes bound of
the product (``chain_timing.spmm_work``: 8 B an edge, x's rows read once,
the output written once). One JSON line a (order, k), then the card's name
and power limit. The v4 training step that runs the product is the
benchmark's ``gcn-arxiv.v4`` cell (``python3 -m benchmark.run``).
"""

import argparse
import json
import os
import sys

REPS = 30
CHUNKS = (16, 32, 64, 128)


def _chunk_plan(row_len, chunk):
    """(chunk lengths, chunks a row): each row's run cut into chunks of at
    most ``chunk`` edges, an empty row one chunk of none."""
    import numpy as np

    per_row = np.maximum(-(-row_len // chunk), 1)
    lens = np.full(int(per_row.sum()), chunk, dtype=np.int64)
    last = np.cumsum(per_row) - 1
    lens[last] = row_len - (per_row - 1) * chunk
    return lens, per_row


def reductions(k_list):
    import torch

    from gcn_tpu_torch.bench import prepared_graph
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.ops.adjacency import coo_adjacency
    from gcn_tpu_torch.ops.spmm import segment_sum, spmm
    from gcn_tpu_torch.utils import chain_timing as ct

    dev = torch.device("cuda")
    orders = {"own": gcn_normalize(get_dataset("synth-arxiv", seed=0).adj),
              "rabbit+degree": prepared_graph("synth-arxiv")[1]}
    for order, g in orders.items():
        n = g.shape[0]
        adj = coo_adjacency(g, symmetric=True, device=dev)
        row_len = adj.row_len.cpu().numpy()
        rows, cols, vals = adj.rows, adj.cols, adj.vals[:, None]
        plans = {c: tuple(torch.as_tensor(a, device=dev)
                          for a in _chunk_plan(row_len, c)) for c in CHUNKS}
        csr = g.to_torch(dev)

        def products(x):
            return x[cols] * vals

        def index_add(x):
            return x.new_zeros((n, x.shape[1])).index_add_(0, rows,
                                                           products(x))

        def one_level(x):
            return segment_sum(products(x), adj.row_len)

        def chunked(c):
            seg_len, per_row = plans[c]

            def fn(x):
                return segment_sum(segment_sum(products(x), seg_len),
                                   per_row)
            return fn

        def products_index_select(x):
            return torch.index_select(x, 0, cols) * vals

        ways = {"products": products,
                "products index_select": products_index_select,
                "index_add": index_add,
                "segment_sum": one_level}
        ways.update({f"chunked {c}": chunked(c) for c in CHUNKS})
        ways["spmm"] = lambda x: spmm(adj, x)
        ways["torch.sparse.mm"] = lambda x: torch.sparse.mm(csr, x)
        for k in k_list:
            x = torch.randn(n, k, device=dev,
                            generator=torch.Generator(dev).manual_seed(k))
            want = x.double().new_zeros((n, k)).index_add_(
                0, rows, x.double()[cols] * adj.vals.double()[:, None])
            line = {"order": order, "k": k, "n": n, "nnz": g.nnz,
                    "e_pad": int(rows.numel()),
                    "longest_row": int(row_len.max()),
                    "chunks": {str(c): int(plans[c][0].numel())
                               for c in CHUNKS}}
            b, f = ct.spmm_work(g.nnz, 0, n, n, k)
            line["bound_ms"], line["bound_by"] = ct.bound_ms(b, f)
            for name, fn in ways.items():
                with torch.no_grad():
                    ms = ct.device_ms(lambda: fn(x), REPS)
                    row = {"ms": ms}
                    if not name.startswith("products"):
                        a, a2 = fn(x), fn(x)
                        err = (a.double() - want).abs()
                        scale = want.abs().max().item()
                        row["max_abs_err"] = err.max().item()
                        row["ok"] = bool((err <= 1e-5 * want.abs()
                                          + 1e-6 * scale).all())
                        row["repeat_equal"] = torch.equal(a, a2)
                        row["captured_equal"] = _captured_equal(fn, x, a)
                line[name] = row
            with torch.no_grad():
                line["spmm_equal"] = torch.equal(ways["spmm"](x),
                                                 one_level(x))
            print(json.dumps(line), flush=True)
        del adj, csr, plans
        torch.cuda.empty_cache()


def _captured_equal(fn, x, eager):
    """One call of ``fn(x)`` captured into a CUDA graph and replayed:
    whether the replay's output equals ``eager`` bit for bit, or the
    capture's error."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn(x)
    except Exception as exc:  # report what capture raised, keep timing
        torch.cuda.synchronize()
        return f"capture failed: {type(exc).__name__}: {exc}"[:200]
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(out, eager)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-k", type=int, nargs="+", default=[32, 40, 64, 128])
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from gcn_tpu_torch.utils.chain_timing import smi_line

    reductions(args.k)
    print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
