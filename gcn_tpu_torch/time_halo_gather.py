#!/usr/bin/env python3
"""The sharded step's gathers on one GPU: whether their backward adds in a
fixed order, and what the sharded step costs, under one or more
repository roots.

    python3 gcn_tpu_torch/time_halo_gather.py ROOT [ROOT ...]

Each ROOT runs in a process of its own, in the order given (compare a
parent and a change as ``parent change change parent``): the package is
imported from ROOT and its kernels are built there (nvcc). The graph is
``chip_smoke.py``'s sharded one: synth-arxiv (seed 15) after
``gcn_normalize`` and rabbit, in-band degree sorted at 4 shards; the
smoke's parameters (``GCN(seed=15)``, hidden 32), ``exchange_chunk`` 32,
``k_pad`` 32, every shard in this process.

  * [determinism] for each of ``FLAVORS`` (the default step, overlap on;
    ``overlap=False``; the all_gather baseline; the ragged plan under the
    segment sum, ``kernel="segsum"``): two runs of 2 steps at dropout 0
    from the same start; whether the losses and every parameter are
    bit-equal, and how many parameter entries differ;
  * [step] each flavor's median step ms at dropout 0.5 (eager, CUDA events
    around each step, the last 10 of ``STEPS``), then ``PROFILED`` steps
    under torch.profiler: the device ms a step under each gather's
    autograd node (``GATHER_NODES``: ``index_select``'s, advanced
    indexing's, or the package's own fixed-order gathers, whichever the
    package has) and of every kernel, copy and set;
  * [gather backward] on each shard's send rows of the ragged plan
    (``send_indices``), a band of 32 random columns and one fixed random
    cotangent, zero at the plan's padding as the exchange gives it:
    ``CALLS`` backward passes each of the step's own send gather
    (``halo._prep_send``) and of ``index_select`` (whose backward is an
    atomic ``index_add_``): the most band rows whose gradient differs from
    the first call's, by shard, beside the rows each shard sends twice or
    more; each one's device ms of a forward and backward
    (``utils/chain_timing.py::device_ms``) and the forward's alone.

Prints one JSON line per ROOT, then the card's name and power limit.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys

SEED = 15
NS = 4
HIDDEN = 32
CHUNK = 32
CALLS = 20
STEPS = 20
PROFILED = 5
GATHER_NODES = ("IndexSelectBackward0", "IndexBackward0",
                "_GatherRowsBackward", "_SendGatherBackward")
FLAVORS = (("default", {}), ("overlap=False", {"overlap": False}),
           ("all_gather", {"exchange": "all_gather"}),
           ("halo segsum", {"kernel": "segsum"}))


def _smi_line():
    """This file's own ``utils/chain_timing.py``'s ``smi_line``: every
    ROOT is read by the same method."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "utils",
                        "chain_timing.py")
    spec = importlib.util.spec_from_file_location("_chain_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.smi_line()


def sharded_problem():
    """(sharded graph, features, labels, train mask, numpy parameters) of
    ``chip_smoke.py``'s [dist] phase."""
    import numpy as np

    from gcn_tpu_torch.convert import params_to_numpy
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                        rows_per_shard_for,
                                        shard_graph_by_rows)
    from gcn_tpu_torch.reorder import reorder_graph

    data = get_dataset("synth-arxiv", seed=SEED)
    g, perm = reorder_graph(gcn_normalize(data.adj), "rabbit")
    n = g.shape[0]
    bperm = band_degree_sort_order(g, rows_per_shard_for(n, NS))
    g, perm = g.permute(bperm), perm[bperm]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    mask = np.zeros(n, np.float32)
    mask[inv[np.asarray(data.idx_train)]] = 1.0
    p0 = params_to_numpy(GCN(data.num_features, HIDDEN, data.num_classes,
                             seed=SEED, device="cpu").init_params())
    return (shard_graph_by_rows(g, NS), data.features[perm],
            data.labels[perm], mask, p0)


def padding(plan, sg, s):
    """Shard ``s``'s positions in its ragged send rows that pad a segment
    past the rows its destination needs."""
    import numpy as np

    from gcn_tpu_torch.parallel.halo import _pair_boundaries

    needed, _ = _pair_boundaries(sg)
    pad, o = [], 0
    for t, h in enumerate(plan.sizes, 1):
        pad.extend(range(o + len(needed[(s + t) % NS, s]), o + h))
        o += h
    return np.asarray(pad, dtype=np.int64)


def gather_backward(plan, sg, dev):
    """The [gather backward] readings (the module docstring)."""
    import numpy as np
    import torch

    from gcn_tpu_torch.parallel import halo
    from gcn_tpu_torch.utils.chain_timing import device_ms

    send = halo.send_indices(plan, range(NS), dev)
    rps = sg.rows_per_shard
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def index(i):
        return getattr(i, "idx", i)

    gathers = {
        "step": lambda x, i: halo._prep_send(x, i, None, None)[0],
        "index_select": lambda x, i: x.index_select(0, index(i))}
    out = {"repeated_rows": [
        int((np.bincount(plan.send_idx[s].reshape(-1)) > 1).sum())
        for s in range(NS)], "device_ms": {}}
    for name, gather in gathers.items():
        worst, ms = [], []
        for s, i in enumerate(send):
            x = torch.randn(rps, HIDDEN, device=dev, generator=gen,
                            requires_grad=True)
            ct = torch.randn(index(i).numel(), HIDDEN, device=dev,
                             generator=gen)
            ct[torch.as_tensor(padding(plan, sg, s), device=dev)] = 0

            def call():
                return torch.autograd.grad(gather(x, i), x, ct)[0]

            grads = [call() for _ in range(CALLS)]
            worst.append(max(int((g != grads[0]).any(1).sum())
                             for g in grads[1:]))
            ms.append(device_ms(call))
        out[name] = worst
        out["device_ms"][name] = ms
    x = torch.randn(rps, HIDDEN, device=dev, generator=gen)
    out["device_ms"]["forward_only"] = [
        device_ms(lambda: x.index_select(0, index(i))) for i in send]
    return out


def node_ms(prof, steps):
    """Device ms a step under each gather's autograd node, with its calls
    a step."""
    out = {}
    for evt in prof.key_averages():
        if evt.key in GATHER_NODES:
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = evt.cuda_time_total
            out[evt.key] = {"ms": total / 1e3 / steps,
                            "calls": evt.count / steps}
    return out


def time_root(root):
    """The readings of the package under ``root``; prints one JSON line."""
    sys.path[0] = root
    import torch
    from torch.profiler import ProfilerActivity, profile

    import gcn_tpu_torch
    if not os.path.abspath(gcn_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"gcn_tpu_torch was imported from "
                         f"{gcn_tpu_torch.__file__}, not from {root}")
    from gcn_tpu_torch.convert import params_from_numpy
    from gcn_tpu_torch.ops import _build
    from gcn_tpu_torch.parallel import (build_halo_plan_ragged, create_mesh,
                                        make_sharded_gcn_train_step)
    from gcn_tpu_torch.reorder import native
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.checkpoint import named_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_cuda_kernels()
    _build.build_libraries({"gcnreorder": native.SOURCES}, "g++")
    if not native.available():
        raise SystemExit("the native reorder library does not load")
    dev = torch.device("cuda")
    sg, x, labels, mask, p0 = sharded_problem()
    mesh = create_mesh(NS, dev)

    def start(shard_fn):
        params = params_from_numpy(p0, dev)
        opt = adam_l2([t.requires_grad_(True)
                       for _, t in named_leaves(params)])
        return params, opt, shard_fn(x, labels, mask)

    def run(step, state, i):
        params, opt, batch = state
        return step(params, opt, (SEED + 1, i), *batch)

    result = {"root": root, "determinism": {}, "step_ms": {},
              "gather_nodes": {}, "busy_ms": {}}
    for label, opts in FLAVORS:
        step, _, shard_fn = make_sharded_gcn_train_step(
            mesh, sg, dropout=0.0, exchange_chunk=CHUNK, k_pad=32, **opts)
        runs = [start(shard_fn) for _ in range(2)]
        losses = [[float(run(step, s, i)) for i in range(2)] for s in runs]
        differ = sum(int((a != b).sum()) for (_, a), (_, b) in zip(
            named_leaves(runs[0][0]), named_leaves(runs[1][0])))
        result["determinism"][label] = {
            "bit_equal": losses[0] == losses[1] and differ == 0,
            "losses": losses, "params_differing": differ}
        del runs
        step, _, shard_fn = make_sharded_gcn_train_step(
            mesh, sg, dropout=0.5, exchange_chunk=CHUNK, k_pad=32, **opts)
        state = start(shard_fn)
        ms = []
        for i in range(STEPS):
            t0, t1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            t0.record()
            run(step, state, i)
            t1.record()
            ms.append((t0, t1))
        torch.cuda.synchronize()
        result["step_ms"][label] = statistics.median(
            s.elapsed_time(e) for s, e in ms[-10:])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(STEPS, STEPS + PROFILED):
                run(step, state, i)
            torch.cuda.synchronize()
        busy = sum(evt.time_range.elapsed_us() for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(evt, "is_user_annotation", False))
        result["gather_nodes"][label] = node_ms(prof, PROFILED)
        result["busy_ms"][label] = busy / 1e3 / PROFILED
        del state, step
        torch.cuda.empty_cache()
    result["gather_backward"] = gather_backward(build_halo_plan_ragged(sg),
                                                sg, dev)
    print(json.dumps(result), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        time_root(os.path.abspath(argv[1]))
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("time_halo_gather: no CUDA device is available",
              file=sys.stderr)
        return 2
    for root in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True, timeout=900)
    print(_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
