#!/usr/bin/env python3
"""Time the COO product (the adjacency GCN v1-v5 train on past 8,192 rows)
and the v4 training step on one GPU.

    python3 gcn_tpu_torch/time_coo.py [-k 32 40 64 128]
    python3 gcn_tpu_torch/time_coo.py --steps ROOT [ROOT ...]

The first form times, on synth-arxiv (seed 0, after ``gcn_normalize``) in
its own vertex order (GCN v4's: no reorder) and after rabbit and the
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
and power limit.

The second form times GCN v4 on synth-arxiv (seed 0, dropout 0) at hidden
32, 64 and 128 with the package under each ROOT, each ROOT in a process
of its own, in the order given (compare a parent and a change as ``parent
change change parent``):

  * ``captured_ms`` / ``eager_ms``: the ROOT's own
    ``chain_timing.train_step_ms`` in each loop flavor (what that tree's
    scripts report);
  * ``eager_synced_ms``: this file's reading of the eager step: CUDA
    events around each of 10 steps, each step waited for before the next
    (the time a user's eager loop takes a step);
  * ``eager_profile`` / ``replay_profile``: 10 eager steps and 10 replays
    of the captured step under torch.profiler (this file's own
    ``chain_timing.device_busy``): wall and device-busy ms a step, the
    device ms a step (``kernel_ms``) of the COO product's gather and its
    ``index_add_`` or segment sum (the multiply is an elementwise kernel,
    listed by name) or of the COO kernel, and the kernels that take most
    device time, by name.

One JSON line per ROOT and hidden width, then the card's name and power
limit. The package is imported from ROOT, and builds its COO kernel, where
it has one, at the first product.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPS = 30
CHUNKS = (16, 32, 64, 128)
HIDDENS = (32, 64, 128)
PROFILE_STEPS = 10
# kernel names of the COO product's gather (``vectorized_gather_kernel``),
# atomic add (``indexFuncLargeIndex``) and segment sum, and the COO kernel
COO_NEEDLES = ("gather", "indexFunc", "segment_reduce", "coo_spmm")
TOP_KERNELS = 8


def _chain_timing():
    """This file's own ``utils/chain_timing.py``: every ROOT is timed by
    the same method."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "utils",
                        "chain_timing.py")
    spec = importlib.util.spec_from_file_location("_chain_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_timing = _chain_timing()


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
            b, f = _timing.spmm_work(g.nnz, 0, n, n, k)
            line["bound_ms"], line["bound_by"] = _timing.bound_ms(b, f)
            for name, fn in ways.items():
                with torch.no_grad():
                    ms = _timing.device_ms(lambda: fn(x), REPS)
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


def _eager_synced_ms(step, steps):
    """Median ms of ``steps`` eager steps, CUDA events around each, each
    step waited for before the next."""
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    out = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def time_root_steps(root):
    """The v4 rows of the package under ``root``; one JSON line a width."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.models.gcn_core import gcn_forward
    from gcn_tpu_torch.train.capture import WARMUP, CapturedLoop
    from gcn_tpu_torch.train.metrics import masked_nll
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils import chain_timing as ct

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    data = get_dataset("synth-arxiv", seed=0)
    for hidden in HIDDENS:
        model = GCN(data.num_features, hidden, data.num_classes,
                    dropout=0.0, variant="v4", seed=15, device=dev)
        model.fit(data.features, data.adj, data.labels, data.idx_train,
                  train_iters=3)
        adj, feats = model.adj_norm, model._hoisted_ax
        idx = model._remap_idx(data.idx_train)
        row = {"root": root, "variant": "v4", "hidden": hidden,
               "adjacency": type(adj).__name__,
               "orders": list(model._orders())}
        for flavor, jit_loop in (("captured", True), ("eager", False)):
            row[f"{flavor}_ms"] = ct.train_step_ms(
                adj, feats, model.labels, idx, hidden, model.nclass,
                jit_loop=jit_loop, orders=model._orders())
        params = {name: {k: t.detach().clone().requires_grad_(True)
                         for k, t in layer.items()}
                  for name, layer in model.params.items()}
        opt = adam_l2([t for layer in params.values()
                       for t in layer.values()], model.lr,
                      model.weight_decay)

        def step():
            opt.zero_grad(set_to_none=True)
            lp = gcn_forward(params, feats, adj, orders=model._orders(),
                             dropout_rate=0.0, train=True)
            masked_nll(lp, model.labels, idx).backward()
            opt.step()

        row["eager_synced_ms"] = _eager_synced_ms(step, PROFILE_STEPS)
        row["eager_profile"] = _timing.device_busy(
            step, PROFILE_STEPS, COO_NEEDLES, top=TOP_KERNELS)
        loop = CapturedLoop(step, dev)
        loop.run(WARMUP + 1)        # the eager warm-up, then the capture
        row["replay_profile"] = _timing.device_busy(
            loop.graph.replay, PROFILE_STEPS, COO_NEEDLES, top=TOP_KERNELS)
        print(json.dumps(row), flush=True)
        del model, loop, opt, params
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-k", type=int, nargs="+", default=[32, 40, 64, 128])
    ap.add_argument("--steps", nargs="+", metavar="ROOT")
    ap.add_argument("--one-root", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one_root:
        time_root_steps(args.one_root)
        return 0
    if args.steps:
        for root in args.steps:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one-root", root], check=True)
    else:
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        reductions(args.k)
    print(_timing.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
