#!/usr/bin/env python3
"""Chip smoke test of gcn_tpu_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py          # from the repository root; needs a GPU

Drives the port's main path on the card — v6 GCN training on synth-arxiv
at its full width (n=169,343, 128 features, hidden 32, 40 classes) through
``gcn_tpu_torch.models.GCN`` — and holds every kernel of that path against
its plain PyTorch version. Phases (each failure exits non-zero):

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build from the repository's sources (nvcc, one process per
     source, all started together) and its time;
  3. K1 (the ELL SpMM) against its plain version on the card at the main
     path's shapes: synth-arxiv forward at k=32, the layer-1 hoist at
     k=128 (4 column tiles), the backward on the transpose arrays, and a
     non-symmetric rectangular matrix forward and backward; tolerance f32
     rtol 1e-5 and atol 1e-6 * max|out| (sums are reassociated);
  4. K1's time (CUDA events, median of 30 chained calls), the plain
     version's, ``torch.sparse.mm`` on the same CSR as the library
     yardstick, and the bound reckoned from this run's inputs;
  5. a 5-step v6 fit (dropout 0) on the card and on the CPU from the same
     parameters: per-step losses agree at rtol 1e-4;
  6. the main path: a default 20-step v6 fit on the card (dropout 0.5,
     seed 15) with K1's launch count read around it; the loss falls, the
     output is finite, of shape (n, 40) and normalized, and K1 ran 4 (hoist)
     + 2 per step + 1 (eval) times;
  7. where a step's time goes: 10 more steps under torch.profiler.

Then one JSON line per kernel (``{"kernels": [...]}``), the nvidia-smi
line again, and last ``{"ok": true, "device": {...}}``. Without a GPU, or
without the repository beside it, it exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
RTOL = 1e-5
ATOL_OF_MAX = 1e-6
SEED = 15


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else fail("nvidia-smi printed nothing")


def compare(name, got, want):
    """Max errors of ``got`` against ``want``; fails past the tolerance."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    scale = want.abs().max().item()
    diff = (got - want).abs()
    limit = RTOL * want.abs() + ATOL_OF_MAX * scale
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp_min(ATOL_OF_MAX * scale)).max().item()
    ok = bool((diff <= limit).all())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"max|out|={scale:.3e} -> {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


def time_chain(fn, x, n_out_rows, reps):
    """Median ms per call of ``reps`` chained calls, each fed the first
    rows of the previous output (CUDA events around every call)."""
    import torch

    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    cur = x
    for start, end in events:
        start.record()
        out = fn(cur)
        end.record()
        cur = out[:n_out_rows]
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def profile_steps(model, idx_train, steps):
    """Where a v6 training step's time goes: ``steps`` steps of the fitted
    model's own step (forward, masked NLL, backward, Adam) under
    torch.profiler; prints device time by kernel and the device's busy
    share of the wall time (the profiler's own host cost included)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gcn_tpu_torch.models.gcn_core import gcn_forward
    from gcn_tpu_torch.models.layers import auto_order
    from gcn_tpu_torch.ops.spmm import hoist_spmm
    from gcn_tpu_torch.train.metrics import masked_nll
    from gcn_tpu_torch.train.optim import adam_l2

    params = {name: {k: t.detach().clone().requires_grad_(True)
                     for k, t in layer.items()}
              for name, layer in model.params.items()}
    opt = adam_l2([t for layer in params.values() for t in layer.values()],
                  model.lr, model.weight_decay)
    inv = np.empty_like(model.perm)
    inv[model.perm] = np.arange(model.perm.shape[0])
    idx = torch.as_tensor(inv[np.asarray(idx_train)], device=model.device)
    feats = hoist_spmm(model.adj_norm, model.features)
    orders = ("xw", auto_order(model.nhid, model.nclass))
    gen = torch.Generator(device=model.device).manual_seed(0)

    def step():
        opt.zero_grad(set_to_none=True)
        lp = gcn_forward(params, feats, model.adj_norm, orders=orders,
                         dropout_rate=model.dropout, with_relu=True,
                         train=True, generator=gen)
        loss = masked_nll(lp, model.labels, idx)
        loss.backward()
        opt.step()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    n_kernels = 0
    for evt in prof.events():
        # device work only: kernels, copies, sets (not annotation ranges)
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        n_kernels += 1
        by_name[evt.name] = (by_name.get(evt.name, 0.0)
                             + evt.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    print(f"[profile] {steps} steps under torch.profiler: wall "
          f"{wall_ms / steps:.3f} ms/step, device busy {busy_ms / steps:.3f}"
          f" ms/step ({100 * busy_ms / wall_ms:.1f}% busy), "
          f"{n_kernels / steps:.1f} device activities/step", flush=True)
    if not by_name:
        print("  the profiler recorded no device time: not measured")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms / steps:8.4f} ms/step  {name[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.csr import coo_to_csr
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.ops import _build
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.ops.spmm import hoist_spmm
    from gcn_tpu_torch.reorder import native, reorder_graph
    from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.time()

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    built = _build.build_cuda_kernels()
    build_s = time.time() - t0
    print(f"[build] CUDA kernels built in {build_s:.2f}s", flush=True)
    for name, (path, log) in built.items():
        print(f"  {name}: {os.path.relpath(path)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    t0 = time.time()
    _build.build_libraries({"gcnreorder": native.SOURCES}, "g++")
    if not native.available():
        fail("the native reorder library does not load")
    print(f"[build] host reorder library in {time.time() - t0:.2f}s",
          flush=True)

    # ---- 3. K1 against its plain version at the main path's shapes -------
    t0 = time.time()
    data = get_dataset("synth-arxiv", seed=SEED)
    g = gcn_normalize(data.adj)
    g, perm = reorder_graph(g, "rabbit")
    ds = degree_sort_order(g)
    g = g.permute(ds)
    perm = perm[ds]
    adj = ell_adjacency(g, k_pad=32, symmetric=True, device=dev)
    n = g.shape[0]
    print(f"[data] synth-arxiv n={n} nnz={g.nnz} f={data.num_features} "
          f"classes={data.num_classes} n_hub={adj.n_hub} "
          f"n_virt={adj.n_virt} blocks={adj.num_blocks} "
          f"P={adj.p} R={adj.r} slots={adj.cols.numel()} "
          f"spans={len(adj.spans)} chunks={len(adj.chunks)} "
          f"pad={adj.pad_fraction:.3f} ({time.time() - t0:.1f}s)",
          flush=True)

    def k1(a, x, t=False):
        if t:
            return es.ell_spmm(x, a.t_cols, a.t_vals, a.t_win, a.t_win_off,
                               a.t_row_space)
        return es.ell_spmm(x, a.cols, a.vals, a.win, a.win_off, a.row_space)

    def plain(a, x, t=False):
        if t:
            return es._ell_spmm_plain(x, a.t_cols, a.t_vals, a.t_win,
                                      a.t_win_off, a.t_row_space)
        return es._ell_spmm_plain(x, a.cols, a.vals, a.win, a.win_off,
                                  a.row_space)

    print("[K1 vs plain]", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = []
    x32 = torch.randn(n, 32, device=dev, generator=gen)
    errs.append(compare("arxiv fwd k=32", k1(adj, x32), plain(adj, x32)))
    feats = torch.as_tensor(data.features[perm], device=dev)
    errs.append(compare("arxiv k=128 one launch", k1(adj, feats),
                        plain(adj, feats)))
    errs.append(compare("arxiv hoist k=128 (4 tiles)",
                        hoist_spmm(adj, feats),
                        es._hub_epilogue(plain(adj, feats), adj.virt_map,
                                         adj.n_hub, n)))
    ct = torch.randn(n, 32, device=dev, generator=gen)
    errs.append(compare("arxiv bwd (transpose arrays)", k1(adj, ct, True),
                        plain(adj, ct, True)))
    # non-symmetric rectangular matrix with hub rows: distinct transpose
    rng = np.random.default_rng(SEED)
    nr, nc = 60_000, 25_000
    src = np.concatenate([np.repeat(np.arange(16), 3000),
                          rng.integers(16, nr, 700_000)])
    dst = rng.integers(0, nc, src.shape[0])
    rg = coo_to_csr(src, dst, rng.random(src.shape[0]), (nr, nc))
    radj = ell_adjacency(rg, k_pad=32, device=dev)
    if radj.symmetric or radj.n_hub == 0:
        fail("rectangular check graph lost its asymmetry or hub rows")
    xr = torch.randn(nc, 32, device=dev, generator=gen)
    gr = torch.randn(nr, 32, device=dev, generator=gen)
    errs.append(compare("rect fwd k=32", k1(radj, xr), plain(radj, xr)))
    errs.append(compare("rect bwd (transpose arrays)", k1(radj, gr, True),
                        plain(radj, gr, True)))
    xg = xr.clone().requires_grad_(True)
    es.spmm_ell(radj, xg).backward(gr)
    radj_cpu = radj.to("cpu")
    xc = xr.cpu().requires_grad_(True)
    es.spmm_ell(radj_cpu, xc).backward(gr.cpu())
    errs.append(compare("rect autograd dX, card vs cpu", xg.grad.cpu(),
                        xc.grad))
    torch.cuda.synchronize()
    max_abs_err = max(errs)

    # ---- 4. timing at the main path's shape ------------------------------
    print("[K1 timing] synth-arxiv forward, k=32", flush=True)
    k1_ms = time_chain(lambda x: k1(adj, x), x32, n, 30)
    plain_ms = time_chain(lambda x: plain(adj, x), x32, n, 5)
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(g.indptr, dtype=torch.int64),
        torch.as_tensor(g.indices, dtype=torch.int64),
        torch.as_tensor(g.data), size=g.shape, device=dev)
    lib_ms = time_chain(lambda x: torch.sparse.mm(csr, x), x32, n, 30)
    lib_diff = (es._hub_epilogue(k1(adj, x32), adj.virt_map, adj.n_hub, n)
                - torch.sparse.mm(csr, x32)).abs().max().item()
    print(f"  torch.sparse.mm vs K1 + epilogue: max abs diff {lib_diff:.3e}")
    k = 32
    bytes_moved = (adj.cols.numel() * 4 + adj.vals.numel() * 4
                   + adj.win_off.numel() * 4 + n * k * 4
                   + adj.row_space * k * 4)
    flops = 2 * g.nnz * k
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  K1 {k1_ms:.4f} ms | plain {plain_ms:.4f} ms | "
          f"torch.sparse.mm (CSR) {lib_ms:.4f} ms", flush=True)
    print(f"  bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({bytes_moved / 1e6:.1f} MB at 3.35 TB/s; {flops / 1e6:.1f} "
          f"Mflop at 67 TFLOP/s f32) -> K1 at "
          f"{100 * bound_ms / k1_ms:.1f}% of bound", flush=True)

    # ---- 5. 5-step fit, card against CPU, same parameters ----------------
    print("[fit 5 steps, dropout 0] card vs cpu", flush=True)
    nfeat, nhid, ncls = data.num_features, 32, data.num_classes
    p0 = params_to_numpy(GCN(nfeat, nhid, ncls, seed=SEED,
                             device="cpu").init_params())
    hist = {}
    for device in ("cuda", "cpu"):
        t0 = time.time()
        m = GCN(nfeat, nhid, ncls, dropout=0.0, variant="v6", seed=SEED,
                device=device)
        m.params = params_from_numpy(p0, device)
        m.fit(data.features, data.adj, data.labels, data.idx_train,
              train_iters=5, initialize=False)
        hist[device] = [h["loss_train"] for h in m.history]
        print(f"  {device}: losses {hist[device]} "
              f"({time.time() - t0:.1f}s)", flush=True)
    lc, lp = np.array(hist["cuda"]), np.array(hist["cpu"])
    if not np.allclose(lc, lp, rtol=1e-4, atol=0):
        fail(f"card and cpu losses disagree: {lc} vs {lp}")
    print(f"  max rel diff {np.max(np.abs(lc - lp) / np.abs(lp)):.2e} "
          f"(rtol 1e-4) ok", flush=True)

    # ---- 6. the main path ------------------------------------------------
    steps = 20
    print(f"[main path] GCN v6 fit, {steps} steps, hidden {nhid}, "
          f"dropout 0.5, seed {SEED}", flush=True)
    model = GCN(nfeat, nhid, ncls, variant="v6", seed=SEED, device="cuda")
    t0 = time.time()
    es.spmm_ell_launches = 0
    model.fit(data.features, data.adj, data.labels, data.idx_train,
              train_iters=steps)
    torch.cuda.synchronize()
    launches = es.spmm_ell_launches
    fit_s = time.time() - t0
    losses = [h["loss_train"] for h in model.history]
    acc = model.test(data.idx_test)
    step_ms = model.timers("step").d.median_ms
    hoist_ms = model.timers("hoist_ax").d.median_ms
    out = model.output
    print(f"  losses first {losses[0]:.6f} last {losses[-1]:.6f}; "
          f"fit {fit_s:.2f}s (preprocessing included); hoist "
          f"{hoist_ms:.3f} ms; median step {step_ms:.3f} ms "
          f"(last {model.timers('step').d.count} steps); test accuracy "
          f"{acc:.4f}", flush=True)
    expected = 4 + 2 * steps + 1
    print(f"  K1 launches on the main path: {launches} (expected "
          f"{expected} = 4 hoist + 2 x {steps} steps + 1 eval)", flush=True)
    if launches != expected:
        fail(f"K1 launched {launches} times on the main path, "
             f"expected {expected}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    if tuple(out.shape) != (n, ncls) or not torch.isfinite(out).all():
        fail(f"output shape {tuple(out.shape)} or values not finite")
    norm = torch.logsumexp(out, dim=1).abs().max().item()
    if norm > 1e-4:
        fail(f"log-probs are not normalized (max |logsumexp| {norm:.2e})")
    profile_steps(model, data.idx_train, 10)
    print(f"[done] {time.time() - t_start:.1f}s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "ell_spmm",
        "route": "cuda",
        "source": "gcn_tpu_torch/ops/csrc/ell_spmm.cu",
        "replaces": "gcn_tpu/ops/ell_spmm.py:55",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
