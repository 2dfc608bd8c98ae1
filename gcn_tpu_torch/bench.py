#!/usr/bin/env python3
"""The one-line SpMM benchmark on the card: the counterpart of gcn_tpu's
``bench.py``.

    python -m gcn_tpu_torch.bench [--dataset synth-arxiv] [-k 32]
        [--device cpu]

Prints one JSON line, last, with ``bench.py``'s keys under the port's own
metric name, ``torch_spmm_edges_per_s_arxiv_k32`` (the graph's name and k
in it), so that no reader takes it for a TPU figure. Step by step, as
``bench.py``'s ``main``:

  1. the graph (seed 0) through ``gcn_normalize``, rabbit and the degree
     sort; x0 is a seed-0 normal draw times 0.01 at width k;
  2. ``value`` and ``ell_ms``: K1 through ``spmm_ell`` on the serving
     layout (``ell_adjacency(span_pass_limit=0)``: no hub split, so the
     hub rows' long windows are walked whole), stored edges over its time;
     ``ell_ms_train_default``: the training layout (the default hub split);
  3. ``vs_baseline``: the port's own COO ``spmm`` (``coo_adjacency``: a
     sorted segment sum in edge order, gcn_tpu's ``segment_sum``, what
     ``bench.py`` divides by; on the card the COO kernel) over K1;
     ``sparse_mm_ms``: ``torch.sparse.mm`` on the same CSR, the cuSPARSE
     yardstick;
  4. the roofline is the bytes bound, not ``bench.py``'s measured gather
     rate: on the card the chained torch gather takes several times K1's
     time a stored edge, so a gather floor would put K1 far above 100%.
     ``roofline_ms`` is the least time an H100 could take for the serving
     SpMM (``chain_timing.spmm_work`` and ``bound_ms``: 8 B a stored edge,
     the window offsets, x's rows read once and the output rows written
     once at 3.35 TB/s, or the flops at 67 TFLOP/s if that is longer),
     ``roofline_pct`` is 100 x it over ``ell_ms`` (above 100 is a fault,
     and it raises), and ``roofline_ns_per_slot`` is it over the
     layout's slots, so ``roofline_ms = slots x ns_slot`` as in
     ``bench.py``. The measured gather (``chain_timing.gather_ns_per_row``
     at n x k) is printed apart as ``gather_ns_per_row``;
  5. the training step (forward, masked NLL, backward, Adam with L2 5e-4;
     hidden 32, dropout 0; ``chain_timing.train_step_ms``) on the training
     layout, with the features, labels and training rows in the reordered
     graph's order: ``train_step_ms`` the generic form (raw features,
     orders ``("a_xw", "ax_w")``, 4 SpMMs a step), ``train_step_hoisted_ms``
     the hoisted form (A @ X, orders ``("xw", "ax_w")``, 2 SpMMs), each the
     captured step replayed (``jit_loop=True``, gcn_tpu's scan), and the
     eager steps of each beside them.

Every time is the median of chained calls behind a spin kernel between
CUDA events (``utils/chain_timing.py``); nothing is subtracted, and
``event_floor_ms`` shows what an empty pair of events reads. ``bench.py``'s
relay work-arounds (fresh inputs, scalar readbacks, a wall-clock budget and
-1 sentinels) are not ported: a step that fails raises, and the module
exits non-zero. ``detail.card`` is ``chain_timing.stamp``: the card's name
and power limit. With ``--device cpu`` every step runs once on the CPU and
every time is null; the host columns (``n``, ``nnz``, ``k``, ``slots``,
``pad_fraction``) and the bound are still printed.
"""

import argparse
import json
import sys

NHID = 32
WEIGHT_DECAY = 5e-4
REPS = 30
STEPS = 20
CPU_STEPS = 2


def metric_name(dataset, k):
    """``torch_spmm_edges_per_s_arxiv_k32`` for synth-arxiv at k = 32."""
    short = dataset.removeprefix("synth-").replace("-", "_")
    return f"torch_spmm_edges_per_s_{short}_k{k}"


def prepared_graph(dataset="synth-arxiv"):
    """(data, graph, perm): ``dataset`` (seed 0) through gcn_normalize,
    rabbit and the degree sort, with perm[new] = old."""
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.reorder import reorder_graph
    from gcn_tpu_torch.tile.ell import degree_sort_order

    data = get_dataset(dataset, seed=0)
    g, perm = reorder_graph(gcn_normalize(data.adj), "rabbit")
    ds = degree_sort_order(g)
    return data, g.permute(ds), perm[ds]


def _step_ms(device, *args, **kw):
    """``chain_timing.train_step_ms`` on the card; on the CPU a short fit,
    which rehearses the step, and None."""
    from gcn_tpu_torch.utils import chain_timing as ct

    if device.type != "cuda":
        ct.train_step_fit(*args, steps=CPU_STEPS, **kw)
        return None
    return ct.train_step_ms(*args, steps=STEPS, **kw)


def _ratio(a, b):
    return None if a is None or b is None else a / b


def layouts(g, device):
    """(serving, training): the ELL layouts of ``g`` that ``measure``
    times, ``bench.py``'s ``span_pass_limit=0`` one and the default hub
    split."""
    from gcn_tpu_torch.tile.ell import ell_adjacency

    return (ell_adjacency(g, symmetric=True, span_pass_limit=0,
                          device=device),
            ell_adjacency(g, symmetric=True, device=device))


def measure(data, g, perm, k=32, device="cuda", dataset="synth-arxiv",
            adjs=None):
    """The JSON line of the module docstring for ``dataset`` prepared as
    (data, g, perm) by ``prepared_graph``, at width k on ``device``;
    ``adjs`` is ``layouts(g, device)`` where the caller has built it."""
    import numpy as np
    import torch

    from gcn_tpu_torch.ops.adjacency import coo_adjacency
    from gcn_tpu_torch.ops.ell_spmm import spmm_ell
    from gcn_tpu_torch.ops.spmm import hoist_spmm, spmm
    from gcn_tpu_torch.utils import chain_timing as ct

    device = torch.device(device)
    on_card = device.type == "cuda"
    n, e = g.shape[0], g.nnz
    x0 = torch.as_tensor(
        np.random.default_rng(0).standard_normal((n, k)).astype(np.float32)
        * 0.01, device=device)

    adj_ell, adj_train = adjs or layouts(g, device)
    t_ell = ct.on_device_ms(device, lambda x: spmm_ell(adj_ell, x), x0,
                            REPS)
    t_train = ct.on_device_ms(device, lambda x: spmm_ell(adj_train, x), x0,
                              REPS)
    adj_coo = coo_adjacency(g, symmetric=True, device=device)
    t_coo = ct.on_device_ms(device, lambda x: spmm(adj_coo, x), x0, REPS)
    del adj_coo
    csr = g.to_torch(device)
    t_lib = ct.on_device_ms(device, lambda x: torch.sparse.mm(csr, x), x0,
                            REPS)
    del csr

    slots = int(adj_ell.cols.numel())
    roofline_ms, _ = ct.bound_ms(*ct.spmm_work(e, adj_ell.win_off.numel(),
                                               n, n, k))
    roofline_pct = _ratio(100.0 * roofline_ms, t_ell)
    if roofline_pct is not None and roofline_pct > 100.0:
        raise RuntimeError(
            f"K1 at {roofline_pct:.1f}% of its bound ({t_ell} ms against "
            f"{roofline_ms} ms): the timing or the bound is wrong")

    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    feats = torch.as_tensor(data.features[perm], device=device)
    labels = torch.as_tensor(data.labels[perm], device=device)
    idx = torch.as_tensor(inv[np.asarray(data.idx_train)], device=device)
    step = (adj_train, feats, labels, idx, NHID, data.num_classes)
    generic = dict(orders=("a_xw", "ax_w"), weight_decay=WEIGHT_DECAY)
    t_step = _step_ms(device, *step, jit_loop=True, **generic)
    t_step_eager = _step_ms(device, *step, jit_loop=False, **generic)
    ax = hoist_spmm(adj_train, feats)
    hoisted = (adj_train, ax) + step[2:]
    t_hoisted = _step_ms(device, *hoisted, jit_loop=True,
                         weight_decay=WEIGHT_DECAY)
    t_hoisted_eager = _step_ms(device, *hoisted, jit_loop=False,
                               weight_decay=WEIGHT_DECAY)

    return {
        "metric": metric_name(dataset, k),
        "value": _ratio(e * 1e3, t_ell),
        "unit": "edges/s",
        "vs_baseline": _ratio(t_coo, t_ell),
        "detail": {
            "ell_ms": t_ell,
            "ell_ms_train_default": t_train,
            "coo_baseline_ms": t_coo,
            "roofline_ms": roofline_ms,
            "roofline_pct": roofline_pct,
            "roofline_ns_per_slot": roofline_ms * 1e6 / slots,
            "slots": slots,
            "train_step_ms": t_step,
            "train_step_hoisted_ms": t_hoisted,
            "n": n, "nnz": e, "k": k,
            "pad_fraction": adj_ell.pad_fraction,
            "sparse_mm_ms": t_lib,
            "gather_ns_per_row": (ct.gather_ns_per_row(n, k, reps=REPS)
                                  if on_card else None),
            "event_floor_ms": ct.event_floor_ms(REPS) if on_card else None,
            "train_step_eager_ms": t_step_eager,
            "train_step_hoisted_eager_ms": t_hoisted_eager,
            "card": ct.stamp(device),
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="synth-arxiv")
    ap.add_argument("-k", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from gcn_tpu_torch.ops import _build
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        _build.build_cuda_kernels()
    data, g, perm = prepared_graph(args.dataset)
    line = measure(data, g, perm, args.k, device, args.dataset)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
