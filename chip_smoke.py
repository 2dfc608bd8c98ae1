#!/usr/bin/env python3
"""Chip smoke test of gcn_tpu_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py          # from the repository root; needs a GPU

Drives the port's paths on the card — v6 GCN training through
``gcn_tpu_torch.models.GCN`` over the ELL layout (kernel K1) at
synth-arxiv's full width (n=169,343, 128 features, hidden 32, 40 classes),
functional GCN training over the panel layout (``panel_adjacency``,
``hoist_spmm``, ``gcn_forward``, ``fit_gcn``; kernel K2), a resumed GCN
run, GCN over the frequency-split tables, row-band sharded GCN training
through ``gcn_tpu_torch.parallel.make_sharded_gcn_train_step`` (four
shards in this process, K1 on every shard's parts; then 4 bands x 2 model
slots, K1 on each slot's hidden shard), and HGNN training
through ``gcn_tpu_torch.models.HGNN`` at ModelNet40's shape on both forms
of G (K1) — and holds every kernel against its plain PyTorch version.
Phases (each failure exits non-zero):

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build from the repository's sources (nvcc, one process per
     source, all started together) and its time;
  3. K1 (the ELL SpMM) against its plain version on the card at the main
     path's shapes: synth-arxiv forward at k=32 on the training layout and
     on phase 15's serving layout (``bench.layouts``: no hub split, each
     hub row's window walked whole, longer than the hub cap), the layer-1
     hoist at k=128 (4 column tiles), the backward on the transpose arrays,
     and a non-symmetric rectangular matrix forward and backward; tolerance
     f32 rtol 1e-5 and atol 1e-6 * max|out| (sums are reassociated), against
     the plain version evaluated in float64 (two f32 orders of the
     rectangular matrix's 3000-term rows can differ by more than that). K1's
     bf16 variants at synth-arxiv forward k=32 and on the rectangular
     matrix's transpose arrays: table_bf16 at the f32 tolerance (the same
     bf16 inputs, f32 sums), products_bf16 at rtol and atol 2e-2 (a bf16
     ulp can flip when f32 sums are taken in another order), and
     products_bf16 really rounds: >= 99% of its elements equal the plain
     version at the f32 tolerance and >= 50% differ from f32 K1 by more;
     then the shapes K1's design adds: windows at the 16-pass-block hub
     cap beside windows of one, widths k = 1, 4, 33, 200, x views that K1
     reads in place (row stride 36) or copies (an unaligned base, a row
     stride of 33), and two calls of each variant bit-equal;
  4. K1's time (CUDA events, median of 30 chained calls), its bf16
     variants', the plain versions', ``torch.sparse.mm`` on the same CSR as
     the library yardstick, and the bound reckoned from this run's inputs;
     [hub fold]: two calls of ``spmm_ell`` (K1 and the hub fold) bit-equal
     forward and dX at k=32, the fold against the former ``index_add_``
     fold at rtol 1e-6, and both folds' device ms;
     [K1 walk split]: K1's walk split plan (``EllAdj.split``; every layout
     of every phase prints its own as a "[K1 plan]" line: heavy windows,
     the cluster size C, the longest walk under the plan and unsplit, and
     the kernel launches a call, from which the captured fits' kernel
     records are reckoned); the main path's layout must have no heavy
     window; on the serving layout at k_pad 32, 64 and 128 (P = 4, 2, 1),
     whose hub windows are cut across clusters, K1 at k = k_pad in its
     four variants (f32, table_bf16, products_bf16, both) against its
     plain version (the tolerances above), two calls bit-equal, the plan's
     plain sums against the plain version in float64, and K1's time beside
     its plain version's, ``torch.sparse.mm``'s and the bound;
  5. K2 (the panel SpMM) against its plain version in float64, at the f32
     tolerance:
     synth-arxiv forward at k=32 and k=128, the layer-1 hoist at k=128 (4
     chunks), the rectangular matrix forward and its transpose arrays, a
     graph with edgeless windows, autograd dX card against CPU; the split
     plan remade at other thresholds (every window split across a cluster,
     with runs that cross part boundaries and parts of padding only; no
     window split), an unaligned x and a row stride of 33, and two calls
     bit-equal; then K2 against K1 + hub epilogue on the same graph and x
     (the cross-check K2 exists for), and K2's timing beside its bound,
     with its heavy-window launch and its light one timed apart;
  6. a 5-step v6 fit (dropout 0) on the card and on the CPU from the same
     parameters: per-step losses agree at rtol 1e-4; the same 5 steps with
     each bf16 option agree with the card's f32 losses at 2e-2 and count
     their K1 launches (the eager flavor, ``jit_loop=False``, whose host
     counter sees every launch; so do phases 7, 8, 11 and 13's main runs);
  7. the main path, eager: a 20-step v6 fit on the card (dropout 0.5,
     seed 15) with K1's launch count read around it; the loss falls, the
     output is finite, of shape (n, 40) and normalized, and K1 ran 4 (hoist)
     + 2 per step + 1 (eval) times;
  8. the panel path: 5 steps (dropout 0) from phase 6's parameters, whose
     losses agree with the ELL path's at rtol 1e-4; then 20 steps (dropout
     0.5, seed 15) with K1's and K2's launch counts read around it: the
     loss falls, the output is finite and normalized, K2 ran 4 (hoist) + 2
     per step + 1 (eval) times and K1 none;
     [captured fit]: the default flavor, ``jit_loop=True`` (one CUDA graph
     of a step, replayed), on the main path and the panel path against
     phases 7 and 8 from the same parameters and generator (losses and
     log-probs bit-equal: every sum of the step is taken in a fixed order,
     the hub fold's too; the generator's state equal), both flavors'
     median step, the wrappers' host calls (the
     warm-up steps and the captured one) and, in a second captured run
     under torch.profiler, the kernel records of K1 (4 + 2 x 20 + 1) and
     K2 (its launches an SpMM x 45); then 10 captured steps (replays)
     under torch.profiler with the device-busy share;
     [wide k_pad]: the layouts GCN builds at hidden 64 (k_pad 64, P=2)
     and 128 (k_pad 128, P=1): K1 against its float64 plain version at
     the widths their fits launch (the hoist at k = k_pad, layer 2 at
     k=40), a 20-step v6 fit at each hidden width in both loop flavors
     with K1's launches counted (the host counter eager, kernel records
     captured) and captured bit-equal to eager, and K1's time at each
     width beside its bound and torch.sparse.mm;
     [ladder]: GCN v1-v5, which train over the COO product (``CooAdj``:
     ``adj_kind="auto"`` past 8,192 rows) on synth-arxiv in its own order:
     the row edge counts cover the padded edges; two products bit-equal,
     forward and dX; the product against its float64 plain version at the
     f32 tolerance (k=32 and 40, dX at 32); 5-step fits (dropout 0) card
     against CPU from phase 6's parameters (rtol 1e-4); 20-step fits
     (dropout 0.5, seed 15) captured against eager, bit-equal, K1 and K2
     never launched; the product's time beside ``torch.sparse.mm``, the
     bound and the former ``index_add_`` reduction (kept here only as a
     timing reference); v4's captured and eager median step;
  9. where a v6 step's time goes: 10 more eager steps under
     torch.profiler, with K1's device ms per step;
 10. resume: 10 v6 steps, ``save_state``, 10 more from it; the 20 losses
     equal the main path's at rtol 1e-6;
 11. the frequency split on phase 3's graph with ``freq_split_order``
     applied and hot_rows 32,768 forced (so a cold part exists):
     ``spmm_ell_freq`` against single-table K1 at k=32 forward and dX at
     the f32 tolerance, whether K1 reads the slices x[:H] and x[H:] in
     place, a 5-step v6 fit with ``freq_split`` whose losses equal phase
     6's at rtol 1e-4 and whose K1 launches equal 2 x (4 + 2 x 5 + 1), the
     two-table time beside the single table's, and each part alone, forward
     and through its transpose arrays, against its float64 plain version,
     with its K1 time;
 12. row-band sharded GCN on synth-arxiv (rabbit, then the in-band degree
     sort; 4 shards in this process; hidden 32, k_pad 32, exchange_chunk
     32): the ragged plan and the pass-block parts' slots; K1 against its
     float64 plain version on shard 0's interior and halo parts, forward
     and through their transpose arrays, at the widths the step launches
     (interior 32 and 40, halo 32 and 8); 5 steps (dropout 0) against the
     port's unsharded functional GCN on the same graph (losses at rtol
     1e-4, eval log-probs at atol 1e-4 + rtol 1e-5), the all_gather +
     segsum baseline against the halo path (rtol 1e-4), the bf16 and fp8
     wires against f32 (rtol 0.05, atol 0.02) and fp8 with the features
     scaled by 1e4 (finite); 20 steps at dropout 0.5 with K1's launches
     equal to the count reckoned from the code (``dist_launches``), the
     median step from CUDA events and the test accuracy; its step under
     torch.profiler; 10 + 10 steps resumed through
     ``save_training_state`` against the 20 at rtol 1e-6; and K1's time in
     each of the 8 uses beside ``torch.sparse.mm`` and the bound. Between
     the wires and the 20 steps, the sharded repairs: shard 0's parts
     rebuilt with ``table_bf16`` (K1 against the float64 plain version of
     bf16-rounded x, f32 tolerance), and 5 steps with ``with_relu=False``
     against the unsharded functional GCN under the same flag (the
     tolerances above);
     [dist determinism], for every sharded flavor as the phases below
     build it (the default step, the all_gather baseline, the bf16 and
     fp8 wires, each of [dist flavors] and each of [model axis]): two runs
     of 2 steps at dropout 0 from the same start leave bit-equal losses
     and parameters (``check_determinism``: the halo send gather's
     gradient and every other sum of the step in a fixed order);
     [dist flavors], on the same 4 shards: ``overlap=False`` (the
     monolithic layout), ``overlap="split"`` (the row-split parts in
     part-degree order), ``exchange="halo_padded"`` and
     ``exchange="halo_hier"`` on a 2 x 2 mesh with each fan-out and on 1 x
     4 and 4 x 1 meshes with the ragged fan-out: the plan
     and each new layout's slots; K1 against its float64 plain version on
     shard 0's new layouts at the widths the step launches (the padded and
     hierarchical plans change only the halo part: the interior part must
     equal the ragged plan's); 5 steps (dropout 0) against the unsharded
     functional GCN (the tolerances above) with K1's launches equal to the
     count reckoned from the code; for overlap=False and split, 20 steps at
     dropout 0.5 with K1's launches as reckoned, the median step and a
     profile of the step; and K1's time in each new use beside
     ``torch.sparse.mm`` and the bound;
     [model axis], the same 4 bands x 2 model slots in this process
     (``create_mesh_2d``, ``model_axis="model"``; ``create_mesh_hier_model``
     2 x 2 x 2 for ``halo_hier``): K1 at k = 16 (the hidden shard) on slot
     0's interior and halo parts, forward and transpose, against its
     float64 plain version; 5 steps (dropout 0) of halo with each overlap,
     halo_padded, halo_hier and all_gather + segsum against the 1-D
     4-shard step's losses (rtol 1e-4), log-probs (atol 1e-4 + rtol 1e-5)
     and parameters (rtol 1e-5, atol 1e-4) and the unsharded losses, with
     K1's launches equal to the count reckoned from the layout
     (``model_launches``); 20 steps of the default flavor at dropout 0.5
     with K1's launches as reckoned, the median step and a profile beside
     the 1-D step's; and K1's time in each use beside ``torch.sparse.mm``
     and the bound;
     [projection]: the committed capture of the card's rates
     (``gcn_tpu_torch/captures/h100.json``) must name this card and hold
     every rate, and its K1 plain rate, its 4-shard sharded scale and its
     f32 matmul rate must lie within 0.5x-2x of this run's (phase 4's K1
     time, the [dist] rows of shard 0's parts, the matmul re-timed); the
     sharded step with ``exchange_dtype="auto"``, widths (128, 32, 40), on
     the ragged plan (it must pick bf16) and on the 2 x 2 hierarchical
     plan, 5 steps at dropout 0 through K1 (launches as reckoned), each
     bit-equal to the step with the resolved wire named; and the full-step
     projection on the capture's rates (powerlaw, 8,192 nodes a card, d =
     8, 16, 32, 8 cards a node, bf16 and fp8 wires), one JSON row per d;
 13. HGNN at ModelNet40's shape (n=12,311, 2048 features, 40 classes; a
     KNN-10 hypergraph on the first 64 feature columns, the host seconds
     printed): K1 against its plain version in float64 on G (k_pad 128, P
     = 1) at k=128, 40 and 1 and on each factor of G forward and through
     its transpose arrays at k=128, 40, 32 and 1, the factored product
     against the chain at rtol 1e-4; K1's time beside ``torch.sparse.mm``
     and the bound in every use the fits launch, at its width (the hoist,
     each epoch, the row sum); 5 epochs card against CPU for both forms
     (losses at rtol 1e-4); the published recipe (n_hid 128, dropout 0.5,
     lr 1e-3, weight decay 5e-4, milestones [100], gamma 0.9) for 200
     epochs on each form, eager, where the loss falls, the output is
     finite, test accuracy is above 0.5, and K1's launches equal the count
     reckoned from the code (``hgnn_launches``); [captured fit] the same
     200 epochs in the default captured flavor against them (losses rtol
     1e-4, logits rtol and atol 1e-4, best val accuracy within one row,
     the generator's state equal) with both flavors' median epoch; and 10
     + 10 epochs resumed across a milestone at 5 against 20 at rtol 1e-6;
 14. [orders]: synth-arxiv after ``gcn_normalize``, each of the 9 reorder
     methods (its host seconds and route, native or numpy), then the degree
     sort and ``ell_adjacency(k_pad=32)`` on the card (slots, padding
     share, the longest window walk); K1 forward at k=32 against its
     float64 plain version at the f32 tolerance; K1's median of 30 calls
     beside its plain version, ``torch.sparse.mm`` on the same CSR and the
     bound;
 15. [bench]: the one-line benchmark (``gcn_tpu_torch.bench``, the
     counterpart of ``bench.py``) on phase 3's graph: its JSON line
     printed; it times the layouts that phase 3 checked K1 on, and fails
     unless the roofline share is at most 100%, the training layout's
     ``spmm_ell`` (K1 and the hub fold) is within 10% of phase 4's K1 and
     fold times, and the serving layout's K1 within 10% of its median of
     30 calls timed here beside the line; ``bench_kpad``'s committed
     serving row (``gcn_tpu_torch/results/kpad_sweep.json``) is printed
     beside it, for information;
 16. [train_gcn flags], in a process of its own (``--train-gcn-flags``;
     torch.profiler dropped records late in the one long process):
     ``train_gcn.main`` on the card, synth-arxiv -k 32
     -i 20 --variant v6 --reorder gorder --profile-ops --save-path P
     --history-json H: the loss falls, K1 launches 4 + 2 x 20 + 1 times in
     the fit (the default captured loop: kernel records under
     torch.profiler) and 4 a profile iteration, the profile's rows are
     gcn_tpu's for the hoisted v6 orders, each finite and positive; then
     --load-path P reaches the same test accuracy.

Then one JSON line of kernel rows (``{"kernels": [...]}``: K1 at the main
path's shape, K2 (each with ``captured_launches``, the captured fit's
kernel records, and ``captured_host_calls``), K1 on the serving layouts
(with their plans), and K1 at HGNN's, the
frequency split's and the sharded parts' shapes (every flavor's new
layouts too, and the model axis's hidden shard), each
with the launches at its width of the run that uses it, and K1 after each
reorder method (``use`` names it; ``launches``: the [orders] phase's own
calls, or the train_gcn fit's for gorder); every bound counts 8 B a stored
edge, not the layout's padding slots, and the operator's own
rows written), the nvidia-smi line again, and
last ``{"ok": true, "device": {...}}``. Without a GPU, or
without the repository beside it, it exits non-zero and prints no result.
"""

import json
import logging
import os
import statistics
import subprocess
import sys
import time

from gcn_tpu_torch.utils.chain_timing import bound_ms as least_ms
from gcn_tpu_torch.utils.chain_timing import chain_ms, smi_line, spmm_work

RTOL = 1e-5
ATOL_OF_MAX = 1e-6
BF16_TOL = 2e-2
SEED = 15


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def compare(name, got, want, rtol=RTOL, atol=None):
    """Max errors of ``got`` against ``want``; fails past the tolerance
    (rtol * |want| + atol, where atol is ATOL_OF_MAX * max|want| unless it
    is given)."""
    import torch

    got, want = got.double(), want.double()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    scale = want.abs().max().item()
    diff = (got - want).abs()
    limit = rtol * want.abs() + (ATOL_OF_MAX * scale if atol is None
                                 else atol)
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp_min(ATOL_OF_MAX * scale)).max().item()
    ok = bool((diff <= limit).all())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"max|out|={scale:.3e} -> {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


def share_within(got, want):
    """Share of the elements of ``got`` within the f32 tolerance of
    ``want``."""
    limit = RTOL * want.abs() + ATOL_OF_MAX * want.abs().max()
    return ((got - want).abs() <= limit).float().mean().item()


def check_rounds(name, got, want, unrounded):
    """products_bf16 must really round each pass-block's sum: nearly every
    element equals the plain rounded version at the f32 tolerance (only a
    bf16 ulp flipped by another order of f32 sums differs), and most differ
    from K1's f32 result by more than that tolerance."""
    same = share_within(got, want)
    moved = 1.0 - share_within(got, unrounded)
    ok = same >= 0.99 and moved >= 0.5
    print(f"  {name}: {100 * same:.3f}% equal the plain rounded version at "
          f"f32 tolerance (>= 99%), {100 * moved:.3f}% differ from f32 K1 "
          f"(>= 50%) -> {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name}: K1 does not round each pass-block's sum to bf16")


def check_repeat(name, fn):
    """Two calls of ``fn`` must give bit-equal results (no atomics, a fixed
    order of summation)."""
    import torch

    a, b = fn(), fn()
    ok = torch.equal(a, b)
    print(f"  determinism {name}: two calls bit-equal -> "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name}: two calls differ")


def with_split(padj, split_slots):
    """``padj`` (symmetric) with K2's split plan remade at ``split_slots``
    slots."""
    import dataclasses

    import torch

    from gcn_tpu_torch.tile.tiler import split_plan

    plan = tuple(torch.from_numpy(a).to(padj.win_off.device) for a in
                 split_plan(padj.win_off.cpu().numpy(), padj.nb, split_slots))
    return dataclasses.replace(
        padj, heavy=plan[0], heavy_parts=plan[1], light=plan[2],
        t_heavy=plan[0], t_heavy_parts=plan[1], t_light=plan[2])


def split_features(padj):
    """(runs crossing a part boundary, parts of padding only) over the
    forward plan's heavy windows."""
    import numpy as np

    off = padj.win_off.cpu().numpy()
    lrow = padj.local_row.cpu().numpy().reshape(-1)
    heavy, parts, _ = (t.cpu().numpy() for t in padj.plan)
    starts = (off[heavy].astype(np.int64) * padj.nb)[:, None] + parts
    inner = starts[:, 1:-1][parts[:, 1:-1] < parts[:, -1:]]
    cross = int(((lrow[inner - 1] == lrow[inner])
                 & (lrow[inner] < padj.r)).sum())
    pad_only = 0
    for lo, hi in zip(starts[:, :-1].ravel(), starts[:, 1:].ravel()):
        pad_only += int(hi > lo and (lrow[lo:hi] == padj.r).all())
    return cross, pad_only


def profile_steps(model, idx_train, steps, captured=False):
    """Where a v6 training step's time goes: ``steps`` steps of the fitted
    model's own step (forward, masked NLL, backward, Adam) under
    torch.profiler; prints device time by kernel and the device's busy
    share of the wall time (the profiler's own host cost included). With
    ``captured`` the step is captured into a CUDA graph by the port's
    ``CapturedLoop`` (the loop of ``jit_loop=True``) and each profiled
    step is one replay."""
    import numpy as np
    import torch

    from gcn_tpu_torch.train.capture import WARMUP, CapturedLoop

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

    if not captured:
        profile_device("[profile]", step, steps)
        return
    loop = CapturedLoop(step, model.device, gen)
    loop.run(WARMUP + 1)            # the eager warm-up, then the capture
    profile_device("[captured profile]", loop.graph.replay, steps)


def profile_device(label, step, steps):
    """Run ``step`` 3 times, then ``steps`` times under torch.profiler;
    print the wall and device-busy ms a step (the profiler's own host cost
    included), K1's device ms a step and the top kernels by device time;
    return the three ms a step (``wall``, ``busy``, ``k1``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    k1_ms = sum(ms for name, ms in by_name.items() if "ell_spmm" in name)
    print(f"{label} {steps} steps under torch.profiler: wall "
          f"{wall_ms / steps:.3f} ms/step, device busy {busy_ms / steps:.3f}"
          f" ms/step ({100 * busy_ms / wall_ms:.1f}% busy), "
          f"{n_kernels / steps:.1f} device activities/step; K1 "
          f"{k1_ms / steps:.4f} device ms/step", flush=True)
    if not by_name:
        print("  the profiler recorded no device time: not measured")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms / steps:8.4f} ms/step  {name[:90]}")
    return dict(wall=wall_ms / steps, busy=busy_ms / steps,
                k1=k1_ms / steps)


def kernel_records(fn, needle):
    """(``fn()``, the device kernels whose name holds ``needle``) with
    ``fn`` run under torch.profiler: the kernels a CUDA graph's replays
    launch are counted too, which the wrappers' host counters cannot
    see."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # margins inside the trace window, whose ends are host times: a
        # kernel whose converted device time falls past an end is dropped
        time.sleep(0.1)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    events = prof.events()
    device = torch.autograd.DeviceType.CUDA
    starts = sorted(evt.time_range.start for evt in events
                    if evt.device_type == device and needle in evt.name)
    replays = [evt.time_range.start for evt in events
               if evt.device_type != device
               and evt.name == "cudaGraphLaunch"]
    first = min(replays, default=float("inf"))
    print(f"  kernel_records({needle!r}): {len(starts)} records, "
          f"{sum(1 for t in starts if t < first)} before the first of "
          f"{len(replays)} graph launches; "
          f"{sum(1 for evt in events if evt.device_type == device)} device "
          f"records in all", flush=True)
    return out, len(starts)


def k1_arrays(adj, t=False):
    """(cols, vals, win, win_off, n_out, n_in) of one direction of an
    EllAdj: the forward arrays, or (``t``) the transpose arrays."""
    if t:
        return (adj.t_cols, adj.t_vals, adj.t_win, adj.t_win_off,
                adj.t_row_space, adj.n_rows)
    return (adj.cols, adj.vals, adj.win, adj.win_off, adj.row_space,
            adj.n_cols)


def k1_plan(adj, t=False):
    """K1's walk split plan of one direction of an EllAdj."""
    return adj.t_split if t else adj.split


def plan_line(label, adj, t=False):
    """Print K1's walk split plan of one direction of ``adj``: the heavy
    windows, cut across clusters of C thread blocks, and the longest walk
    of one thread block under the plan against the layout's longest window
    walk (pass-blocks); return the plan."""
    plan = k1_plan(adj, t)
    off = adj.t_win_off if t else adj.win_off
    print(f"  [K1 plan] {label}: {plan.n_heavy} heavy windows of "
          f"{off.numel() - 1} in clusters of C={plan.clusters}, "
          f"{plan.n_light} light; longest walk {plan.walk} pass-blocks under "
          f"the plan, {int(off.diff().max())} unsplit; {plan.launches} "
          f"kernel launch(es) a call", flush=True)
    return plan


def spmm_bound(nnz, win_off, n_in, n_out, k):
    """The least time of an SpMM over ``nnz`` stored edges at this run's
    inputs: 8 B an edge (its column and value; padding slots are layout,
    not work), ``win_off``, x's ``n_in`` rows read once and the operator's
    ``n_out`` rows written once, over the HBM rate; 2 flop an edge and
    column over the f32 peak. Returns (ms, "bytes" | "operations")."""
    return bound(*spmm_work(nnz, win_off.numel(), n_in, n_out, k))


def k1_bound(adj, k, t=False):
    """K1's least time on one direction of ``adj`` at width ``k``: the
    SpMM's bound over the operator's own rows (not its virtual hub
    rows)."""
    win_off = adj.t_win_off if t else adj.win_off
    n_out, n_in = (adj.n_cols, adj.n_rows) if t else (adj.n_rows, adj.n_cols)
    return spmm_bound(adj.nnz, win_off, n_in, n_out, k)


def k1_use(label, adj, t, x, csr, launches, path, replaces, reps=30):
    """Time K1 on one direction of ``adj`` at x's width (CUDA events, the
    chain behind a spin kernel), its plain version and ``torch.sparse.mm``
    on ``csr``; print them beside the bound; return a ``kernels`` row whose
    ``launches`` are the run's K1 launches at that width (``launches`` is
    ``read_launches()`` of the run on ``path``; ``max_abs_err`` is filled
    in by the caller)."""
    import torch

    from gcn_tpu_torch.ops import ell_spmm as es

    cols, vals, win, win_off, n_out, n_in = k1_arrays(adj, t)
    k = x.shape[1]
    plan = k1_plan(adj, t)
    ms = chain_ms(lambda v: es.ell_spmm(v, cols, vals, win, win_off,
                                        n_out, plan=plan), x, reps, n_in)
    plain_ms = chain_ms(lambda v: es._ell_spmm_plain(
        v, cols, vals, win, win_off, n_out), x, 3, n_in)
    lib_ms = chain_ms(lambda v: torch.sparse.mm(csr, v), x, reps, n_in)
    print(f"[K1 timing] {label}: K1 {ms:.4f} ms | plain {plain_ms:.4f} ms "
          f"| torch.sparse.mm (CSR) {lib_ms:.4f} ms", flush=True)
    bound_ms, bound_by = k1_bound(adj, k, t)
    print(f"  K1 at {100 * bound_ms / ms:.1f}% of the bound (by "
          f"{bound_by})", flush=True)
    return {"name": f"ell_spmm: {label}", "route": "cuda",
            "source": "gcn_tpu_torch/ops/csrc/ell_spmm.cu",
            "replaces": replaces, "launches": launches[1].get(k, 0),
            "launches_by_k": launches[1], "path": path,
            "max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def k2_bound(padj, n_in, k):
    """K2's least time at this run's inputs: the SpMM's bound (its
    ``local_row`` array and padding slots are layout, not work)."""
    return spmm_bound(padj.nnz, padj.win_off, n_in, padj.n_rows, k)


def bound(bytes_moved, flops):
    ms, by = least_ms(bytes_moved, flops)
    print(f"  bound {ms * 1e3:.2f} us ({bytes_moved / 1e6:.1f} MB at 3.35 "
          f"TB/s; {flops / 1e6:.1f} Mflop at 67 TFLOP/s f32)", flush=True)
    return ms, by


def panel_fit(params, feats, padj, labels, idx, steps, dropout, device,
              jit_loop=True):
    """The panel path through the port's functional API: layer-1 A@X
    hoisted (``feats``, computed by the caller with ``hoist_spmm``), then
    ``fit_gcn`` with ``adam_l2`` over ``gcn_forward`` on the PanelAdj, in
    the loop flavor ``jit_loop`` (the captured one by default)."""
    import torch

    from gcn_tpu_torch.models.gcn_core import gcn_forward
    from gcn_tpu_torch.models.layers import auto_order
    from gcn_tpu_torch.train.loop import fit_gcn
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.timers import Timers

    nhid, ncls = params["gc2"]["w"].shape
    orders = ("xw", auto_order(nhid, ncls))
    gen = torch.Generator(device=device).manual_seed(SEED)

    def forward(p, train):
        return gcn_forward(p, feats, padj, orders=orders,
                           dropout_rate=dropout, train=train, generator=gen)

    return fit_gcn(params, adam_l2, forward, labels, idx, train_iters=steps,
                   timers=Timers(device), generator=gen, jit_loop=jit_loop)


K1_REPLACES = "gcn_tpu/ops/ell_spmm.py:55"
HGNN_N = 12311          # ModelNet40's object count (pyhgnn config.yaml)
HGNN_F = 2048           # its feature width (examples/bench_hgnn.py)
HGNN_EPOCHS = 200       # across the milestone at 100
HGNN_RECIPE = dict(n_hid=128, dropout=0.5, lr=1e-3, weight_decay=5e-4,
                   milestones=[100], gamma=0.9)
FREQ_HOT_ROWS = 32768   # forced below synth-arxiv's n, so a cold part exists


def reset_launches():
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.ops import panel_spmm as ps

    es.spmm_ell_launches = ps.spmm_panel_launches = 0
    es.spmm_ell_launches_by_k.clear()


def read_launches():
    """(K1 launches, K1 launches by width) since ``reset_launches``."""
    from gcn_tpu_torch.ops import ell_spmm as es

    return es.spmm_ell_launches, dict(sorted(
        es.spmm_ell_launches_by_k.items()))


def hgnn_launches(adj, in_ch, epochs):
    """K1 launches of an HGNN fit with validation, reckoned from the code:
    the hoist (one SpMM a column chunk of ``k_pad``, 32 for a TwoHopAdj,
    which has none), the row sum, per epoch the forward, dX and the
    validation forward, and the final evaluation; a TwoHopAdj SpMM is two
    launches."""
    per_spmm = 2 if hasattr(adj, "a1") else 1
    chunks = -(-in_ch // getattr(adj, "k_pad", 32))
    return per_spmm * (chunks + 1 + 3 * epochs + 1)


def losses_of(model):
    return [h["loss_train"] for h in model.history]


def check_close_losses(name, got, want, rtol):
    import numpy as np

    got, want = np.array(got), np.array(want)
    if got.shape != want.shape:
        fail(f"{name}: {got.size} losses against {want.size}")
    diff = np.max(np.abs(got - want) / np.abs(want))
    ok = np.allclose(got, want, rtol=rtol, atol=0)
    print(f"  {name}: max rel diff {diff:.2e} (rtol {rtol:g}) -> "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name}: {got.tolist()} vs {want.tolist()}")


def hgnn_phases(dev):
    """HGNN at ModelNet40's shape (n = 12,311 objects, 2048 features, 40
    classes; a KNN-10 hypergraph on the first 64 feature columns), both
    forms of G: K1 against its plain version, K1's time, 5 epochs card
    against CPU, the published recipe for 200 epochs with K1's launches
    counted, and a resume across a milestone. Returns the ``kernels``
    rows of K1 at HGNN's shapes."""
    import tempfile

    import numpy as np
    import torch

    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.data.synthetic import synthetic_visual_features
    from gcn_tpu_torch.graph.hypergraph import (construct_H_with_KNN,
                                                generate_G_factors,
                                                generate_G_from_H)
    from gcn_tpu_torch.models import HGNN
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.ops.spmm import TwoHopAdj, spmm
    from gcn_tpu_torch.train.capture import WARMUP

    n, f, classes = HGNN_N, HGNN_F, 40
    t0 = time.time()
    fts, labels, idx_train, idx_test = synthetic_visual_features(
        n=n, f=f, classes=classes, seed=SEED)
    t_feat = time.time() - t0
    t0 = time.time()
    h = construct_H_with_KNN(fts[:, :64], k_neig=10, is_prob=True,
                             m_prob=1.0)
    t_h = time.time() - t0
    t0 = time.time()
    g = generate_G_from_H(h)
    t_g = time.time() - t0
    t0 = time.time()
    a1, a2 = generate_G_factors(h)
    t_fac = time.time() - t0
    del h
    print(f"[hgnn data] ModelNet40's shape: n={n} f={f} classes={classes}; "
          f"G nnz={g.nnz}; A1 {a1.shape} nnz={a1.nnz}; A2 {a2.shape} "
          f"nnz={a2.nnz}; host seconds: features {t_feat:.1f}, KNN H "
          f"(n x n distances) {t_h:.1f}, G {t_g:.1f}, factors {t_fac:.1f}",
          flush=True)
    lowerer = HGNN(f, classes, device=dev, **HGNN_RECIPE)
    t0 = time.time()
    gadj = lowerer._lower(g)
    t_tile_g = time.time() - t0
    t0 = time.time()
    fadj = TwoHopAdj(lowerer._lower(a1), lowerer._lower(a2))
    t_tile_f = time.time() - t0
    for label, a, secs in (("G", gadj, t_tile_g), ("A1", fadj.a1, t_tile_f),
                           ("A2", fadj.a2, None)):
        blocks = a.win_off.diff()
        print(f"  {label}: {type(a).__name__} k_pad={a.k_pad} P={a.p} "
              f"R={a.r} symmetric={a.symmetric} blocks={a.num_blocks} "
              f"slots={a.cols.numel()} pad={a.pad_fraction:.3f} "
              f"spans={len(a.spans)} chunks={len(a.chunks)} "
              f"n_hub={a.n_hub} max blocks/window={int(blocks.max())}"
              + (f" (tiled in {secs:.1f}s)" if secs is not None else ""),
              flush=True)
        plan_line(label, a)
        if not a.symmetric:
            plan_line(f"{label} transpose arrays", a, True)
    if gadj.k_pad != 128 or gadj.p != 1:
        fail("HGNN's G is not on the k_pad 128 (P = 1) layout")

    def exact(a, x, t=False):
        cols, vals, win, win_off, n_out, _ = k1_arrays(a, t)
        return es._ell_spmm_plain(x.double(), cols, vals.double(), win,
                                  win_off, n_out)

    def k1(a, x, t=False):
        cols, vals, win, win_off, n_out, _ = k1_arrays(a, t)
        return es.ell_spmm(x, cols, vals, win, win_off, n_out,
                           plan=k1_plan(a, t))

    if a1.shape != (n, n) or a2.shape != (n, n):
        fail("the KNN hypergraph has not one hyperedge a vertex")
    print("[HGNN K1 vs plain] float64 plain version, f32 tolerance; G is "
          "symmetric (its transpose arrays are its own)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = {k: torch.randn(n, k, device=dev, generator=gen)
          for k in (128, 40, 32, 1)}
    # every direction and width the fits launch K1 at (the hoist: G at 128,
    # each factor at 32; each epoch at 40, the factors' dX through their
    # transpose arrays; the row sum at 1), and the factors at 128
    operands = {"G": (gadj, False, g), "A1": (fadj.a1, False, a1),
                "A1 transpose arrays": (fadj.a1, True, a1.transpose()),
                "A2": (fadj.a2, False, a2),
                "A2 transpose arrays": (fadj.a2, True, a2.transpose())}
    checks = [("G", k) for k in (128, 40, 1)] + [
        (name, k) for name in list(operands)[1:] for k in (128, 40, 32, 1)]
    errs = {}
    for name, k in checks:
        a, t, _ = operands[name]
        errs[name, k] = compare(f"{name} k={k}", k1(a, xs[k], t),
                                exact(a, xs[k], t))
    for k in (128, 40):
        compare(f"factored G (TwoHopAdj) vs the chain, k={k}",
                spmm(fadj, xs[k]), spmm(gadj, xs[k]), rtol=1e-4)
    torch.cuda.synchronize()

    print("[HGNN fit 5 epochs, dropout 0] card vs cpu, both forms of G",
          flush=True)
    p0 = params_to_numpy(HGNN(f, classes, seed=SEED,
                              device="cpu").init_params())
    forms = (("dense G", g), ("factored G", (a1, a2)))
    for form, G in forms:
        hist = {}
        for device in (dev, "cpu"):
            t0 = time.time()
            m = HGNN(f, classes, device=device,
                     **dict(HGNN_RECIPE, dropout=0.0))
            m.params = params_from_numpy(p0, device)
            m.fit(fts, G, labels, idx_train, idx_val=idx_test,
                  num_epochs=5)
            hist[device] = losses_of(m)
            print(f"  {form} {device}: losses {hist[device]} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        check_close_losses(f"{form} card vs cpu", hist[dev], hist["cpu"],
                           1e-4)

    runs, eager_models = {}, {}
    for form, G in forms:
        print(f"[HGNN main path] {form}, {HGNN_EPOCHS} epochs, the published "
              f"recipe {HGNN_RECIPE}, seed {SEED}, the eager flavor",
              flush=True)
        model = HGNN(f, classes, seed=SEED, device=dev, **HGNN_RECIPE)
        t0 = time.time()
        reset_launches()
        # the eager flavor: the host counter counts every K1 launch
        model.fit(fts, G, labels, idx_train, idx_val=idx_test,
                  num_epochs=HGNN_EPOCHS, jit_loop=False)
        torch.cuda.synchronize()
        launches = read_launches()
        fit_s = time.time() - t0
        losses = losses_of(model)
        acc = model.test(idx_test)
        out = model.output
        expected = hgnn_launches(model.g_adj, f, HGNN_EPOCHS)
        print(f"  losses first {losses[0]:.6f} last {losses[-1]:.6f}; fit "
              f"{fit_s:.2f}s (lowering G included); hoist "
              f"{model.timers('hoist_gx').d.median_ms:.3f} ms; median epoch "
              f"{model.median_epoch_ms:.3f} ms; best val accuracy "
              f"{model.best_acc:.4f}; test accuracy {acc:.4f}", flush=True)
        print(f"  K1 launches: {launches[0]} by width {launches[1]} "
              f"(expected {expected} from the code)", flush=True)
        if launches[0] != expected:
            fail(f"HGNN {form}: K1 launched {launches[0]} times, expected "
                 f"{expected}")
        if not losses[-1] < losses[0]:
            fail(f"HGNN {form}: loss did not fall")
        if tuple(out.shape) != (n, classes) or not torch.isfinite(out).all():
            fail(f"HGNN {form}: output shape {tuple(out.shape)} or values "
                 f"not finite")
        if not acc > 0.5:
            fail(f"HGNN {form}: test accuracy {acc:.4f} is not above 0.5")
        runs[form] = launches
        eager_models[form] = model

    print(f"[captured fit] HGNN, both forms of G, {HGNN_EPOCHS} epochs: the "
          f"default flavor (jit_loop=True) against the eager fits above "
          f"(losses rtol 1e-4, logits rtol and atol 1e-4; best val "
          f"accuracy within one row)", flush=True)
    for form, G in forms:
        eager = eager_models[form]
        cap = HGNN(f, classes, seed=SEED, device=dev, **HGNN_RECIPE)
        t0 = time.time()
        reset_launches()
        cap.fit(fts, G, labels, idx_train, idx_val=idx_test,
                num_epochs=HGNN_EPOCHS)
        torch.cuda.synchronize()
        host = read_launches()[0]
        host_expected = hgnn_launches(cap.g_adj, f, WARMUP + 1)
        print(f"  {form}: fit {time.time() - t0:.2f}s (lowering G "
              f"included), fit_scan {cap.timers('fit_scan').d.total_ms:.3f}"
              f" ms; best val accuracy {cap.best_acc:.4f} (eager "
              f"{eager.best_acc:.4f}); K1 {host} host calls (expected "
              f"{host_expected}: the hoist, the row sum, {WARMUP} warm-up "
              f"epochs, the captured one, the evaluation)", flush=True)
        captured_report(f"HGNN {form} epoch", (losses_of(cap), cap.output),
                        (losses_of(eager), eager.output),
                        (cap.median_epoch_ms, eager.median_epoch_ms),
                        rtol=1e-4, atol=1e-4)
        if host != host_expected:
            fail(f"captured HGNN {form}: {host} K1 host calls")
        if abs(cap.best_acc - eager.best_acc) > 1.0 / len(idx_test) + 1e-7:
            fail(f"captured HGNN {form}: best val accuracy "
                 f"{cap.best_acc} against {eager.best_acc}")
        if not torch.equal(cap._rng_state, eager._rng_state):
            fail(f"captured HGNN {form} leaves another dropout stream")

    print("[HGNN resume] dense G, 10 + save_state + 10 epochs against 20, "
          "milestone at 5, dropout 0.5", flush=True)
    kw = dict(HGNN_RECIPE, milestones=[5])
    ref = HGNN(f, classes, seed=SEED, device=dev, **kw)
    ref.fit(fts, g, labels, idx_train, num_epochs=20)
    first = HGNN(f, classes, seed=SEED, device=dev, **kw)
    first.fit(fts, g, labels, idx_train, num_epochs=10)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hgnn_state")
        first.save_state(path)
        second = HGNN(f, classes, seed=SEED, device=dev, **kw)
        second.fit(fts, g, labels, idx_train, num_epochs=10,
                   resume_from=path)
    check_close_losses("HGNN 10 + 10 vs 20", losses_of(first)
                       + losses_of(second), losses_of(ref), 1e-6)
    compare("HGNN resumed output vs uninterrupted", second.output,
            ref.output)

    # K1's time in the uses the fits launch, at the widths they launch
    uses = (("G", 128, "dense G", "the hoist"),
            ("G", 40, "dense G", "each epoch: forward, dX, validation"),
            ("G", 1, "dense G", "the row sum"),
            ("A2", 32, "factored G", "the hoist"),
            ("A1", 32, "factored G", "the hoist"),
            ("A2", 40, "factored G", "each epoch: forward, validation"),
            ("A1", 40, "factored G", "each epoch: forward, validation"),
            ("A1 transpose arrays", 40, "factored G", "each epoch: dX"),
            ("A2 transpose arrays", 40, "factored G", "each epoch: dX"),
            ("A2", 1, "factored G", "the row sum"),
            ("A1", 1, "factored G", "the row sum"))
    rows = []
    for name, k, form, use in uses:
        a, t, csr_g = operands[name]
        row = k1_use(f"HGNN {name} k={k} ({use})", a, t, xs[k],
                     csr_g.to_torch(dev), runs[form],
                     f"HGNN {form}, {HGNN_EPOCHS} epochs", K1_REPLACES)
        row["max_abs_err"] = errs[name, k]
        rows.append(row)
    return rows


def freq_phases(dev, g, data, p0, ell_losses, adj):
    """The frequency-split tables on synth-arxiv (rabbit and degree sort,
    then ``freq_split_order``), with hot_rows 32768 forced so that a cold
    part exists: against single-table K1 forward and backward, a 5-step v6
    fit against the ELL path's, and its time beside the single table's,
    on the same order and on ``adj`` (the main path's layout of ``g``).
    Returns the ``kernels`` rows of K1 on the two parts."""
    import scipy.sparse as sp
    import torch

    from gcn_tpu_torch.convert import params_from_numpy
    from gcn_tpu_torch.graph.csr import CSRGraph
    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.ops._align import aligned_rows
    from gcn_tpu_torch.tile.ell import ell_adjacency
    from gcn_tpu_torch.tile.freq_split import (ell_adjacency_freq,
                                               freq_split_order,
                                               spmm_ell_freq)

    hot_rows = FREQ_HOT_ROWS
    t0 = time.time()
    g = g.permute(freq_split_order(g, hot_rows=hot_rows))
    fs = ell_adjacency_freq(g, hot_rows=hot_rows, k_pad=32, device=dev)
    single = ell_adjacency(g, k_pad=32, symmetric=True, device=dev)
    fs.validate()
    n = g.shape[0]
    print(f"[freq split] synth-arxiv, hot_rows={hot_rows}: hot part "
          f"{fs.hot.shape} nnz={fs.hot.nnz} ({100 * fs.hot_edge_fraction:.1f}"
          f"% of edges) blocks={fs.hot.num_blocks} pad="
          f"{fs.hot.pad_fraction:.3f} n_hub={fs.hot.n_hub}; cold part "
          f"{fs.cold.shape} nnz={fs.cold.nnz} blocks={fs.cold.num_blocks} "
          f"pad={fs.cold.pad_fraction:.3f} n_hub={fs.cold.n_hub}; single "
          f"table blocks={single.num_blocks} ({time.time() - t0:.1f}s)",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn(n, 32, device=dev, generator=gen)
    ct = torch.randn(n, 32, device=dev, generator=gen)
    for label, part in (("x[:H]", x[:hot_rows]), ("x[H:]", x[hot_rows:])):
        xin, _ = aligned_rows(part, "K1")
        how = "in place" if xin.data_ptr() == part.data_ptr() else "a copy"
        print(f"  {label}: base {part.data_ptr() % 16} bytes past a 16-byte "
              f"boundary, K1 reads it {how}", flush=True)
    compare("spmm_ell_freq vs single-table K1, fwd k=32",
            spmm_ell_freq(fs, x), es.spmm_ell(single, x))
    compare("spmm_ell_freq fwd vs the float64 plain version",
            spmm_ell_freq(fs, x), es._hub_epilogue(
                es._ell_spmm_plain(x.double(), single.cols,
                                   single.vals.double(), single.win,
                                   single.win_off, single.row_space),
                single))
    xf = x.clone().requires_grad_(True)
    spmm_ell_freq(fs, xf).backward(ct)
    xs = x.clone().requires_grad_(True)
    es.spmm_ell(single, xs).backward(ct)
    compare("spmm_ell_freq vs single-table K1, dX k=32", xf.grad, xs.grad)
    torch.cuda.synchronize()

    print("[freq split fit 5 steps, dropout 0] against the ELL path",
          flush=True)
    m = GCN(data.num_features, 32, data.num_classes, dropout=0.0,
            variant="v6", seed=SEED, device=dev,
            adj_options={"freq_split": True, "hot_rows": hot_rows})
    m.params = params_from_numpy(p0, dev)
    reset_launches()
    # the eager flavor: the host counter counts every K1 launch
    m.fit(data.features, data.adj, data.labels, data.idx_train,
          train_iters=5, initialize=False, jit_loop=False)
    torch.cuda.synchronize()
    launches = read_launches()
    parts = 2 * (-(-data.num_features // 32) + 2 * 5 + 1)
    print(f"  losses {losses_of(m)}; K1 launches {launches[0]} by width "
          f"{launches[1]} (expected {parts} = 2 parts x (4 hoist + 2 x 5 "
          f"steps + 1 eval))", flush=True)
    if type(m.adj_norm).__name__ != "FreqSplitAdj" or m.adj_norm.cold is None:
        fail("the freq-split fit did not build two tables")
    if launches[0] != parts:
        fail(f"freq-split fit: {launches[0]} K1 launches, expected {parts}")
    check_close_losses("freq-split vs ELL path", losses_of(m), ell_losses,
                       1e-4)

    freq_ms = chain_ms(lambda v: spmm_ell_freq(fs, v), x, 30, n)
    single_ms = chain_ms(lambda v: es.spmm_ell(single, v), x, 30, n)
    main_ms = chain_ms(lambda v: es.spmm_ell(adj, v), x, 30, n)
    print(f"[freq split timing] k=32: spmm_ell_freq {freq_ms:.4f} ms (two "
          f"K1 launches, the sum) | single-table spmm_ell on the same order "
          f"{single_ms:.4f} ms (n_hub={single.n_hub}) | on the main path's "
          f"degree order {main_ms:.4f} ms (n_hub={adj.n_hub}; K1 + hub "
          f"epilogue both)", flush=True)
    full = sp.csr_matrix((g.data, g.indices, g.indptr), shape=g.shape)
    rows = []
    for label, part, lo, hi in (("hot", fs.hot, 0, hot_rows),
                                ("cold", fs.cold, hot_rows, n)):
        plan_line(f"freq-split {label} part", part)
        # the part alone: forward on x[lo:hi], dX through its transpose
        # arrays, each against its float64 plain version
        part_err = 0.0
        for t, xin in ((False, x[lo:hi]), (True, ct)):
            cols, vals, win, win_off, n_out, _ = k1_arrays(part, t)
            part_err = max(part_err, compare(
                f"{label} part {'transpose arrays' if t else 'fwd'} k=32, "
                f"K1 vs plain", es.ell_spmm(xin, cols, vals, win, win_off,
                                            n_out, plan=k1_plan(part, t)),
                es._ell_spmm_plain(xin.double(), cols, vals.double(), win,
                                   win_off, n_out)))
        csr = CSRGraph.from_scipy(full[:, lo:hi].tocsr()).to_torch(dev)
        row = k1_use(f"freq-split {label} part {part.shape} k=32", part,
                     False, x[lo:hi].contiguous(), csr, launches,
                     "GCN v6 with freq_split, synth-arxiv, 5 steps",
                     K1_REPLACES)
        row["max_abs_err"] = part_err
        rows.append(row)
    return rows


DIST_SHARDS = 4
DIST_CHUNK = 32
# the sharded step's K1 uses on a shard: (part, transpose arrays, width, use)
# at hidden 32 and 40 classes with exchange_chunk 32
DIST_USES = (("interior", False, 32, "layer 1 forward"),
             ("interior", True, 32, "layer 1 dX"),
             ("interior", False, 40, "layer 2 forward"),
             ("interior", True, 40, "layer 2 dX"),
             ("halo", False, 32, "layer 1 forward, layer 2's first chunk"),
             ("halo", True, 32, "layer 1 dX, layer 2's first chunk dX"),
             ("halo", False, 8, "layer 2's second chunk"),
             ("halo", True, 8, "layer 2's second chunk dX"))


def ell_csr(a, t, device):
    """The operator of an EllAdj without hub rows (``t``: its transpose) as
    a torch sparse CSR tensor of its stored edges, for ``torch.sparse.mm``;
    read from the forward arrays, which hold every edge once."""
    import numpy as np

    from gcn_tpu_torch.graph.csr import coo_to_csr

    cols, vals = a.cols.cpu().numpy(), a.vals.cpu().numpy()
    rows = np.broadcast_to(a.win.cpu().numpy()[:, None, None] * a.r
                           + np.arange(a.r)[None, None, :], cols.shape)
    real = vals != 0
    rows, cols, vals = rows[real], cols[real], vals[real]
    if t:
        return coo_to_csr(cols, rows, vals,
                          (a.n_cols, a.n_rows)).to_torch(device)
    return coo_to_csr(rows, cols, vals, (a.n_rows, a.n_cols)).to_torch(device)


def check_determinism(label, step, shard_fn, start, fit):
    """[dist determinism]: two runs of 2 steps of ``step`` at dropout 0
    from the same start (``start(shard_fn)``) must leave the same losses
    and parameters, bit for bit."""
    import torch

    from gcn_tpu_torch.utils.checkpoint import named_leaves

    runs = [start(shard_fn) for _ in range(2)]
    losses = [fit(step, state, 2)[0] for state in runs]
    differ = sum(int((a != b).sum()) for (_, a), (_, b) in zip(
        named_leaves(runs[0][0]), named_leaves(runs[1][0])))
    same = losses[0] == losses[1] and differ == 0
    print(f"[dist determinism] {label}: two runs of 2 steps bit-equal "
          f"(losses and parameters) -> {'ok' if same else 'MISMATCH'} "
          f"(losses {losses[0]} / {losses[1]}, {differ} parameter entries "
          f"differ)", flush=True)
    if not same:
        fail(f"two runs of the sharded step ({label}) differ")
    del runs
    torch.cuda.empty_cache()


def dist_launches(n_shards, widths, chunk, steps):
    """K1 launches of a sharded fit reckoned from the code: per shard and
    layer of output width f, one interior launch and one halo launch a
    k-chunk (ceil(f / chunk) chunks when f exceeds the chunk, else one);
    the backward as many again; then one eval forward."""
    fwd = sum(1 + (-(-f // chunk) if f > chunk else 1) for f in widths)
    return n_shards * (2 * fwd * steps + fwd)


def dist_phases(dev, data, g_rabbit, perm_rabbit, p0, plain_ms):
    """Row-band sharded GCN on synth-arxiv, four shards in this process
    on the card: the plan, K1 on shard 0's parts against its float64 plain
    version, sharded against unsharded, the all_gather baseline, the bf16
    and fp8 wires, a 20-step run with K1's launches counted, a profile of
    its step, a resume, and the ``kernels`` rows of K1 on the parts.
    Returns the rows."""
    import tempfile

    import numpy as np
    import torch

    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.models.gcn_core import gcn_forward
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                        build_halo_plan_ragged,
                                        build_sharded_ell_blocks,
                                        create_mesh,
                                        make_sharded_gcn_train_step,
                                        rows_per_shard_for,
                                        shard_graph_by_rows)
    from gcn_tpu_torch.tile.ell import ell_adjacency
    from gcn_tpu_torch.train.loop import fit_gcn
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.checkpoint import (load_training_state,
                                                named_leaves,
                                                save_training_state)
    from gcn_tpu_torch.utils.timers import Timers

    ns, n = DIST_SHARDS, g_rabbit.shape[0]
    nhid, ncls = p0["gc1"]["w"].shape[1], data.num_classes
    t0 = time.time()
    bperm = band_degree_sort_order(g_rabbit, rows_per_shard_for(n, ns))
    g = g_rabbit.permute(bperm)
    perm = perm_rabbit[bperm]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    x, labels = data.features[perm], data.labels[perm]
    idx_train = inv[np.asarray(data.idx_train)]
    mask_tr = np.zeros(n, np.float32)
    mask_tr[idx_train] = 1.0
    idx_test = torch.as_tensor(inv[np.asarray(data.idx_test)], device=dev)
    sg = shard_graph_by_rows(g, ns)
    t_sort = time.time() - t0
    t0 = time.time()
    plan = build_halo_plan_ragged(sg)
    t_plan = time.time() - t0

    def start(shard_fn, feats=x, p=p0):
        """(params, opt, (adj, xs, ys, ms)) from numpy parameters ``p``."""
        params = params_from_numpy(p, dev)
        opt = adam_l2([t.requires_grad_(True)
                       for _, t in named_leaves(params)])
        return params, opt, shard_fn(feats, labels, mask_tr)

    def fit(step, state, steps, it0=0, events=False):
        """``steps`` sharded steps on ``state`` with the dropout stream
        (SEED + 1, iteration); returns the losses and, with ``events``,
        each step's CUDA-event ms."""
        params, opt, (adj, xs, ys, ms) = state
        losses, marks = [], []
        for i in range(it0, it0 + steps):
            if events:
                marks.append((torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True)))
                marks[-1][0].record()
            losses.append(step(params, opt, (SEED + 1, i), adj, xs, ys, ms))
            if events:
                marks[-1][1].record()
        torch.cuda.synchronize()
        return ([float(v) for v in losses],
                [s.elapsed_time(e) for s, e in marks])

    def evaluate(eval_fn, state):
        return eval_fn(state[0], state[2][0], state[2][1])[:n]

    mesh = create_mesh(ns, dev)
    t0 = time.time()
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(
        mesh, sg, dropout=0.0, exchange_chunk=DIST_CHUNK, k_pad=32)
    torch.cuda.synchronize()
    t_make = time.time() - t0
    print(f"[dist] synth-arxiv, {ns} shards in one process on {dev}: "
          f"{sg.rows_per_shard} rows a shard; ragged plan sizes "
          f"{plan.sizes}, exchange fraction {plan.exchange_fraction:.4f}, "
          f"boundary fraction {sg.boundary_fraction():.4f}; host seconds: "
          f"band sort and shard {t_sort:.2f}, plan {t_plan:.2f}, "
          f"make_sharded_gcn_train_step (plan and layouts, upload "
          f"included) {t_make:.2f}", flush=True)
    state = start(shard_fn)
    # the step's own layouts: shard_fn's adjacency of the ELL path is
    # ((interior parts, halo parts), send_idx), one entry an owned shard
    parts = dict(zip(("interior", "halo"), state[2][0][0]))
    for name, part in parts.items():
        for t in (False, True):
            a = part[0]
            slots = a.t_cols.numel() if t else a.cols.numel()
            off = a.t_win_off if t else a.win_off
            print(f"  {name} part, {'transpose arrays' if t else 'forward'} "
                  f"({a.n_cols if t else a.n_rows} x "
                  f"{a.n_rows if t else a.n_cols}): {slots} slots a shard "
                  f"(lockstep); stored edges by shard "
                  f"{[p.nnz for p in part]}, pad fractions "
                  f"{[round(1 - p.nnz / slots, 3) for p in part]}; "
                  f"{off.numel() - 1} windows, up to "
                  f"{int(off.diff().max())} pass-blocks a window",
                  flush=True)
            plan_line(f"{name} part, shard 0, "
                      f"{'transpose arrays' if t else 'forward'}", a, t)

    print("[dist K1 vs plain] shard 0's parts at the widths the step "
          "launches, float64 plain version, f32 tolerance", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    xs_k, errs = {}, {}
    for name, t, k, _ in DIST_USES:
        cols, vals, win, win_off, n_out, n_in = k1_arrays(parts[name][0], t)
        xk = xs_k[name, t, k] = torch.randn(n_in, k, device=dev,
                                            generator=gen)
        errs[name, t, k] = compare(
            f"{name} {'transpose arrays' if t else 'fwd'} k={k}",
            es.ell_spmm(xk, cols, vals, win, win_off, n_out,
                        plan=k1_plan(parts[name][0], t)),
            es._ell_spmm_plain(xk.double(), cols, vals.double(), win,
                               win_off, n_out))
    torch.cuda.synchronize()

    print("[dist fit 5 steps, dropout 0] sharded vs the unsharded "
          "functional GCN (gcn_forward over ell_adjacency) on the same "
          "band-sorted graph", flush=True)
    halo_l, _ = fit(step, state, 5)
    halo_lp = evaluate(eval_fn, state)
    halo_params = params_to_numpy(state[0])
    uadj = ell_adjacency(g, k_pad=32, symmetric=True, device=dev)
    feats = torch.as_tensor(x, device=dev)
    res = fit_gcn(params_from_numpy(p0, dev), adam_l2,
                  lambda p, train: gcn_forward(p, feats, uadj,
                                               dropout_rate=0.0,
                                               train=train),
                  torch.as_tensor(labels, device=dev),
                  torch.as_tensor(idx_train, device=dev), train_iters=5,
                  timers=Timers(dev))
    unsharded = [h["loss_train"] for h in res.history]
    unsharded_lp = res.log_probs
    print(f"  sharded losses {halo_l}\n  unsharded losses {unsharded}",
          flush=True)
    check_close_losses("sharded vs unsharded", halo_l, unsharded, 1e-4)
    compare("sharded vs unsharded eval log-probs", halo_lp, res.log_probs,
            rtol=1e-5, atol=1e-4)
    agg = make_sharded_gcn_train_step(mesh, sg, dropout=0.0,
                                      exchange="all_gather")
    ag_l, _ = fit(agg[0], start(agg[2]), 5)
    print(f"  all_gather + segsum baseline losses {ag_l}", flush=True)
    check_close_losses("all_gather baseline vs halo", ag_l, halo_l, 1e-4)
    check_determinism("default (ragged plan, overlap on)", step, shard_fn,
                      start, fit)
    check_determinism("all_gather baseline", agg[0], agg[2], start, fit)

    print("[dist wires] 5 steps, dropout 0, against the f32 wire (rtol "
          "0.05, atol 0.02)", flush=True)
    for wire in ("bf16", "fp8"):
        w_step, _, w_shard = make_sharded_gcn_train_step(
            mesh, sg, dropout=0.0, exchange_dtype=wire,
            exchange_chunk=DIST_CHUNK, k_pad=32)
        wl, _ = fit(w_step, start(w_shard), 5)
        ok = np.allclose(wl, halo_l, rtol=0.05, atol=0.02) and wl[-1] < wl[0]
        print(f"  {wire}: losses {wl} -> {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"the {wire} wire does not track f32: {wl} vs {halo_l}")
        check_determinism(f"the {wire} wire", w_step, w_shard, start, fit)
        if wire == "fp8":
            big, _ = fit(w_step, start(w_shard, x * 1e4), 1)
            print(f"  fp8 with features x 1e4: loss {big[0]:.6g}",
                  flush=True)
            if not np.isfinite(big[0]):
                fail("the fp8 wire overflowed with features x 1e4")

    print("[sharded repairs] shard 0's parts rebuilt with table_bf16: K1 "
          "against the float64 plain version of bf16-rounded x, f32 "
          "tolerance", flush=True)
    bf16_parts = build_sharded_ell_blocks(sg, plan, k_pad=32,
                                          table_bf16=True, shards=[0],
                                          device=dev)
    for name, part in zip(("interior", "halo"), bf16_parts):
        a = part[0]
        if not a.table_bf16:
            fail(f"the {name} part lost table_bf16")
        xk = torch.randn(a.n_cols, 32, device=dev, generator=gen)
        before = es.spmm_ell_launches
        got = es.spmm_ell(a, xk)
        torch.cuda.synchronize()
        if es.spmm_ell_launches != before + 1:
            fail(f"table_bf16 {name} part: K1 did not launch once")
        compare(f"table_bf16 {name} part fwd k=32", got,
                es._ell_spmm_plain(xk.to(torch.bfloat16).double(), a.cols,
                                   a.vals.double(), a.win, a.win_off,
                                   a.n_rows))
    del bf16_parts
    print("[sharded repairs] with_relu=False, 5 steps, dropout 0: sharded "
          "vs the unsharded functional GCN under the same flag", flush=True)
    nr_step, nr_eval, nr_shard = make_sharded_gcn_train_step(
        mesh, sg, dropout=0.0, with_relu=False, exchange_chunk=DIST_CHUNK,
        k_pad=32)
    nr_state = start(nr_shard)
    nr_l, _ = fit(nr_step, nr_state, 5)
    nr_lp = evaluate(nr_eval, nr_state)
    res = fit_gcn(params_from_numpy(p0, dev), adam_l2,
                  lambda p, train: gcn_forward(p, feats, uadj,
                                               dropout_rate=0.0,
                                               with_relu=False,
                                               train=train),
                  torch.as_tensor(labels, device=dev),
                  torch.as_tensor(idx_train, device=dev), train_iters=5,
                  timers=Timers(dev))
    nr_want = [h["loss_train"] for h in res.history]
    print(f"  sharded losses {nr_l}\n  unsharded losses {nr_want}",
          flush=True)
    check_close_losses("with_relu=False sharded vs unsharded", nr_l,
                       nr_want, 1e-4)
    compare("with_relu=False sharded vs unsharded eval log-probs", nr_lp,
            res.log_probs, rtol=1e-5, atol=1e-4)

    steps = 20
    print(f"[dist main path] make_sharded_gcn_train_step, {steps} steps, "
          f"hidden {nhid}, dropout 0.5, seed {SEED}, exchange_chunk "
          f"{DIST_CHUNK}", flush=True)
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(
        mesh, sg, dropout=0.5, exchange_chunk=DIST_CHUNK, k_pad=32)
    state = start(shard_fn)
    reset_launches()
    t0 = time.time()
    losses, step_ms = fit(step, state, steps, events=True)
    lp = evaluate(eval_fn, state)
    torch.cuda.synchronize()
    launches = read_launches()
    fit_s = time.time() - t0
    acc = (lp[idx_test].argmax(1).cpu().numpy()
           == labels[idx_test.cpu().numpy()]).mean()
    expected = dist_launches(ns, (nhid, ncls), DIST_CHUNK, steps)
    dist_step_ms = statistics.median(step_ms[-10:])
    print(f"  losses first {losses[0]:.6f} last {losses[-1]:.6f}; fit "
          f"{fit_s:.2f}s; median step {dist_step_ms:.3f}"
          f" ms (CUDA events, last 10 steps); test accuracy {acc:.4f}",
          flush=True)
    print(f"  K1 launches: {launches[0]} by width {launches[1]} (expected "
          f"{expected} from the code)", flush=True)
    if launches[0] != expected:
        fail(f"sharded run: {launches[0]} K1 launches, expected {expected}")
    if not losses[-1] < losses[0]:
        fail("sharded run: loss did not fall")
    if tuple(lp.shape) != (n, ncls) or not torch.isfinite(lp).all():
        fail(f"sharded output shape {tuple(lp.shape)} or values not finite")
    it = iter(range(steps, 10 ** 9))
    dist_profile = profile_device("[dist profile]", lambda: step(
        state[0], state[1], (SEED + 1, next(it)), *state[2]), 5)

    print("[dist resume] 10 + save_training_state + 10 steps against the "
          "20", flush=True)
    first = start(shard_fn)
    l1, _ = fit(step, first, 10)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dist_state")
        save_training_state(path, first[0], first[1].state_dict()["state"],
                            10)
        saved = load_training_state(path, first[0])
    second = start(shard_fn, p=params_to_numpy(saved.params))
    full = second[1].state_dict()
    full["state"] = saved.adam_state
    second[1].load_state_dict(full)
    l2, _ = fit(step, second, 10, it0=saved.iteration)
    check_close_losses("dist 10 + 10 vs 20", l1 + l2, losses, 1e-6)

    rows = [sharded_k1_row(parts[name][0], t, xs_k[name, t, k],
                           f"sharded {name} part, shard 0, "
                           f"{'transpose arrays' if t else 'forward'} k={k} "
                           f"({use})", launches,
                           f"sharded GCN, {ns} shards, {steps} steps",
                           errs[name, t, k])
            for name, t, k, use in DIST_USES]
    run = dict(mesh=mesh, sg=sg, g=g, start=start, fit=fit,
               evaluate=evaluate, unsharded=unsharded,
               unsharded_lp=unsharded_lp, interior=parts["interior"][0],
               halo=parts["halo"][0],
               labels=labels, idx_test=idx_test, n=n, nhid=nhid, ncls=ncls,
               nfeat=p0["gc1"]["w"].shape[0],
               dist_losses=halo_l, dist_lp=halo_lp, dist_params=halo_params,
               dist_step_ms=dist_step_ms, dist_profile=dist_profile,
               dist_launches=launches, steps=steps)
    del state, first, second, parts, xs_k
    dist_rows = list(rows)
    rows += dist_flavor_phases(dev, run)
    rows += model_axis_phase(dev, run)
    projection_phase(dev, run, dist_rows, plain_ms, g.nnz)
    return rows


def sharded_k1_row(a, t, xk, label, launches, path, err):
    """K1's time on one direction of a sharded layout ``a`` at xk's width
    (CUDA events, the chain behind a spin kernel; each call reads the same
    x: a part's output can be shorter than its input), its plain version's
    and ``torch.sparse.mm``'s on the part's CSR, beside the bound; returns
    the ``kernels`` row (``launches``: ``read_launches()`` of the run on
    ``path``; ``err``: the check's max abs error)."""
    import torch

    from gcn_tpu_torch.ops import ell_spmm as es

    cols, vals, win, win_off, n_out, n_in = k1_arrays(a, t)
    k = xk.shape[1]
    plan = k1_plan(a, t)
    ms = chain_ms(lambda _: es.ell_spmm(xk, cols, vals, win, win_off,
                                        n_out, plan=plan), xk, 30, n_in)
    plain_ms = chain_ms(lambda _: es._ell_spmm_plain(
        xk, cols, vals, win, win_off, n_out), xk, 3, n_in)
    csr = ell_csr(a, t, xk.device)
    lib_ms = chain_ms(lambda _: torch.sparse.mm(csr, xk), xk, 30, n_in)
    print(f"[K1 timing] {label}: K1 {ms:.4f} ms | plain {plain_ms:.4f} "
          f"ms | torch.sparse.mm (CSR) {lib_ms:.4f} ms", flush=True)
    bound_ms, bound_by = spmm_bound(a.nnz, win_off, n_in, n_out, k)
    print(f"  K1 at {100 * bound_ms / ms:.1f}% of the bound (by "
          f"{bound_by})", flush=True)
    return {"name": f"ell_spmm: {label}", "route": "cuda",
            "source": "gcn_tpu_torch/ops/csrc/ell_spmm.cu",
            "replaces": K1_REPLACES, "launches": launches[1].get(k, 0),
            "launches_by_k": launches[1], "path": path, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


# the flavors of the sharded step beside the default: (label, options, a
# host x chip mesh, 20 timed steps); each new K1 layout's uses, as
# DIST_USES': the monolithic layout ("all") unchunked, a forward and a dX a
# layer; the split parts as the pass-block ones; the padded and
# hierarchical plans change only the halo part (the interior part's columns
# are band rows under every plan)
DIST_FLAVORS = (
    ("overlap=False", dict(overlap=False), None, True),
    ("overlap='split'", dict(overlap="split"), None, True),
    ("halo_padded", dict(exchange="halo_padded"), None, False),
    ("halo_hier 2x2, ragged fan-out", dict(exchange="halo_hier"), (2, 2),
     False),
    ("halo_hier 2x2, all_gather fan-out",
     dict(exchange="halo_hier", hier_fanout="all_gather"), (2, 2), False),
    ("halo_hier 1x4, ragged fan-out", dict(exchange="halo_hier"), (1, 4),
     False),
    ("halo_hier 4x1, ragged fan-out", dict(exchange="halo_hier"), (4, 1),
     False))
MONOLITHIC_USES = (("all", False, 32, "layer 1 forward"),
                   ("all", True, 32, "layer 1 dX"),
                   ("all", False, 40, "layer 2 forward"),
                   ("all", True, 40, "layer 2 dX"))
SPLIT_USES = tuple(("boundary" if part == "halo" else part, t, k, use)
                   for part, t, k, use in DIST_USES)
HALO_USES = tuple(u for u in DIST_USES if u[0] == "halo")


def monolithic_launches(n_shards, steps):
    """K1 launches of a sharded fit on the monolithic layout, reckoned from
    the code: per shard and layer one forward (no k-chunks: the exchange
    precedes K1) and one dX; then one eval forward a layer."""
    return n_shards * (4 * steps + 2)


def dist_flavor_phases(dev, run):
    """[dist flavors]: each of DIST_FLAVORS on synth-arxiv's 4 shards in
    this process: its plan and slots, K1 on shard 0's new layouts against
    the float64 plain version, 5 steps at dropout 0 against the unsharded
    functional GCN (K1's launches as reckoned); for the timed ones 20 steps
    at dropout 0.5 with K1's launches, the median step and a profile; and
    the ``kernels`` rows of every new K1 use."""
    import numpy as np
    import torch

    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.parallel import (build_halo_plan, build_halo_plan_hier,
                                        create_mesh_hier,
                                        make_sharded_gcn_train_step)

    sg, ns, n = run["sg"], run["sg"].n_shards, run["n"]
    widths = (run["nhid"], run["ncls"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows = []
    for label, opts, hier, timed in DIST_FLAVORS:
        mesh = create_mesh_hier(*hier, dev) if hier else run["mesh"]
        t0 = time.time()
        if opts.get("exchange") == "halo_padded":
            plan = build_halo_plan(sg)
            desc = (f"padded plan h_max {plan.h_max}, halo rows "
                    f"{plan.halo_rows}")
        elif hier:
            plan = build_halo_plan_hier(sg, *hier,
                                        fanout=opts.get("hier_fanout",
                                                        "ragged"))
            desc = (f"hier plan intra {plan.intra_sizes}, inter "
                    f"{plan.inter_sizes}, fan {plan.fan_sizes}, DCN "
                    f"fraction {plan.dcn_fraction:.4f}, fan-out rows "
                    f"{plan.ici_gather_rows}, halo rows {plan.halo_rows}")
        else:
            plan = None
            desc = "ragged plan (as [dist])"
        t_plan = time.time() - t0
        t0 = time.time()
        step, eval_fn, shard_fn = make_sharded_gcn_train_step(
            mesh, sg, dropout=0.0, exchange_chunk=DIST_CHUNK, k_pad=32,
            **opts)
        torch.cuda.synchronize()
        t_make = time.time() - t0
        frac = f", exchange fraction {plan.exchange_fraction:.4f}" if plan \
            else ""
        print(f"[dist flavors] {label}: {desc}{frac}; host seconds: plan "
              f"{t_plan:.2f}, make_sharded_gcn_train_step {t_make:.2f}",
              flush=True)
        state = run["start"](shard_fn)
        extra = state[2][0][0]
        if opts.get("overlap") is False:
            parts, uses = {"all": extra}, MONOLITHIC_USES
        elif opts.get("overlap") == "split":
            parts, uses = {"interior": extra[0], "boundary": extra[1]}, \
                SPLIT_USES
        else:
            parts, uses = {"halo": extra[1]}, HALO_USES
            same = all(torch.equal(getattr(extra[0][0], f),
                                   getattr(run["interior"], f))
                       for f in ("cols", "vals", "win_off", "t_cols",
                                 "t_vals", "t_win_off"))
            print(f"  interior part equal to the ragged plan's: {same}",
                  flush=True)
            if not same:
                fail(f"{label}: the interior part depends on the plan")
        for name, part in parts.items():
            for t in (False, True):
                a = part[0]
                slots = a.t_cols.numel() if t else a.cols.numel()
                off = a.t_win_off if t else a.win_off
                print(f"  {name} {'transpose arrays' if t else 'forward'} "
                      f"({a.n_cols if t else a.n_rows} x "
                      f"{a.n_rows if t else a.n_cols}): {slots} slots a "
                      f"shard; stored edges by shard {[p.nnz for p in part]}"
                      f", pad fraction {1 - a.nnz / slots:.3f} (shard 0); "
                      f"{off.numel() - 1} windows, up to "
                      f"{int(off.diff().max())} pass-blocks a window",
                      flush=True)
                plan_line(f"{label} {name}, shard 0, "
                          f"{'transpose arrays' if t else 'forward'}", a, t)
        print(f"  K1 vs plain, shard 0, float64 plain version, f32 "
              f"tolerance", flush=True)
        xs_k, errs = {}, {}
        for name, t, k, _ in uses:
            cols, vals, win, win_off, n_out, n_in = k1_arrays(parts[name][0],
                                                              t)
            xk = xs_k[name, t, k] = torch.randn(n_in, k, device=dev,
                                                generator=gen)
            errs[name, t, k] = compare(
                f"{name} {'transpose arrays' if t else 'fwd'} k={k}",
                es.ell_spmm(xk, cols, vals, win, win_off, n_out,
                            plan=k1_plan(parts[name][0], t)),
                es._ell_spmm_plain(xk.double(), cols, vals.double(), win,
                                   win_off, n_out))
        torch.cuda.synchronize()
        reckon = (monolithic_launches if opts.get("overlap") is False
                  else lambda ns_, s: dist_launches(ns_, widths, DIST_CHUNK,
                                                    s))
        reset_launches()
        losses, _ = run["fit"](step, state, 5)
        lp = run["evaluate"](eval_fn, state)
        torch.cuda.synchronize()
        launches = read_launches()
        print(f"  5 steps, dropout 0: losses {losses}; K1 launches "
              f"{launches[0]} (expected {reckon(ns, 5)})", flush=True)
        if launches[0] != reckon(ns, 5):
            fail(f"{label}: {launches[0]} K1 launches in 5 steps, expected "
                 f"{reckon(ns, 5)}")
        check_close_losses(f"{label} vs unsharded", losses, run["unsharded"],
                           1e-4)
        compare(f"{label} vs unsharded eval log-probs", lp,
                run["unsharded_lp"], rtol=1e-5, atol=1e-4)
        check_determinism(label, step, shard_fn, run["start"], run["fit"])
        path = f"sharded GCN {label}, {ns} shards, 5 steps, dropout 0"
        if timed:
            steps = 20
            step, eval_fn, shard_fn = make_sharded_gcn_train_step(
                mesh, sg, dropout=0.5, exchange_chunk=DIST_CHUNK, k_pad=32,
                **opts)
            state = run["start"](shard_fn)
            reset_launches()
            losses, step_ms = run["fit"](step, state, steps, events=True)
            lp = run["evaluate"](eval_fn, state)
            torch.cuda.synchronize()
            launches = read_launches()
            idx_test = run["idx_test"]
            acc = (lp[idx_test].argmax(1).cpu().numpy()
                   == run["labels"][idx_test.cpu().numpy()]).mean()
            print(f"  {steps} steps, dropout 0.5, seed {SEED}: losses first "
                  f"{losses[0]:.6f} last {losses[-1]:.6f}; median step "
                  f"{statistics.median(step_ms[-10:]):.3f} ms (CUDA events, "
                  f"last 10 steps); test accuracy {acc:.4f}; K1 launches "
                  f"{launches[0]} by width {launches[1]} (expected "
                  f"{reckon(ns, steps)} from the code)", flush=True)
            if launches[0] != reckon(ns, steps):
                fail(f"{label}: {launches[0]} K1 launches, expected "
                     f"{reckon(ns, steps)}")
            if not losses[-1] < losses[0]:
                fail(f"{label}: loss did not fall")
            if (tuple(lp.shape) != (n, run["ncls"])
                    or not torch.isfinite(lp).all()):
                fail(f"{label}: output shape {tuple(lp.shape)} or values "
                     f"not finite")
            it = iter(range(steps, 10 ** 9))
            profile_device(f"[dist flavors profile] {label}", lambda: step(
                state[0], state[1], (SEED + 1, next(it)), *state[2]), 5)
            path = f"sharded GCN {label}, {ns} shards, {steps} steps"
        for name, t, k, use in uses:
            rows.append(sharded_k1_row(
                parts[name][0], t, xs_k[name, t, k],
                f"sharded {label} {name} part, shard 0, "
                f"{'transpose arrays' if t else 'forward'} k={k} ({use})",
                launches, path, errs[name, t, k]))
        del state, parts, extra, xs_k
        torch.cuda.empty_cache()
    return rows


# the model axis: 4 bands x 2 model slots in this process; each flavor's
# (label, options, a host x chip x model mesh, K1 parts a layer and slot)
MODEL_AXIS = (4, 2)
MODEL_FLAVORS = (
    ("halo, overlap=True", dict(), None, 2),
    ("halo, overlap='split'", dict(overlap="split"), None, 2),
    ("halo, overlap=False", dict(overlap=False), None, 1),
    ("halo_padded", dict(exchange="halo_padded"), None, 2),
    ("halo_hier 2x2x2", dict(exchange="halo_hier"), (2, 2, 2), 2),
    ("all_gather + segsum", dict(exchange="all_gather"), None, 0))
# the default flavor's K1 uses on a slot, all at k = nhid / m: both layers'
# aggregation of the hidden shard (forward) and its dX
MODEL_USES = (("interior", False, "layers 1 and 2 forward"),
              ("interior", True, "layers 1 and 2 dX"),
              ("halo", False, "layers 1 and 2 forward"),
              ("halo", True, "layers 1 and 2 dX"))


def model_launches(n_slots, parts, steps):
    """K1 launches of a model-axis fit reckoned from the layout: per slot
    and layer ``parts`` forward launches (the unfused forms: no k-chunks)
    and as many dX; then one eval forward a layer."""
    return n_slots * parts * (4 * steps + 2)


def model_axis_phase(dev, run):
    """[model axis]: tensor parallelism over the hidden width on
    synth-arxiv's 4 bands (run's sharded graph) x 2 model slots in this
    process: each flavor's 5 steps (dropout 0) against the 1-D 4-shard
    step's losses, log-probs and parameters and the unsharded losses, with
    K1's launches as reckoned; K1 at k = nhid / 2 on slot 0's parts against
    its float64 plain version; 20 timed steps of the default flavor at
    dropout 0.5 with a profile, beside the 1-D step's; the ``kernels`` rows
    of K1's uses on the hidden shard."""
    import numpy as np
    import torch

    from gcn_tpu_torch.convert import params_to_numpy
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.parallel import (create_mesh_2d,
                                        create_mesh_hier_model,
                                        gather_model_params,
                                        make_sharded_gcn_train_step)

    sg, n = run["sg"], run["n"]
    nd, nm = MODEL_AXIS
    k = run["nhid"] // nm
    n_slots = nd * nm
    mesh2 = create_mesh_2d(nd, nm, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    print(f"[model axis] synth-arxiv, {nd} bands x {nm} model slots in one "
          f"process on {dev}: x {n} x {run['nfeat']} column-sharded "
          f"({run['nfeat'] // nm} a slot), hidden {run['nhid']} "
          f"reduce-scattered "
          f"into shards of {k}, K1 at k={k} on every slot; 1-D 4-shard "
          f"losses {run['dist_losses']}", flush=True)
    parts = xs_k = errs = None
    for label, opts, hier, n_parts in MODEL_FLAVORS:
        mesh = create_mesh_hier_model(*hier, dev) if hier else mesh2
        t0 = time.time()
        step, eval_fn, shard_fn = make_sharded_gcn_train_step(
            mesh, sg, dropout=0.0, model_axis="model", k_pad=32, **opts)
        torch.cuda.synchronize()
        t_make = time.time() - t0
        state = run["start"](shard_fn)
        if parts is None:
            # the default flavor's own parts: one entry an owned slot
            parts = dict(zip(("interior", "halo"), state[2][0][0]))
            print(f"  K1 vs plain, slot 0 (band 0, model 0), k={k}, float64 "
                  f"plain version, f32 tolerance", flush=True)
            xs_k, errs = {}, {}
            for name, t, _ in MODEL_USES:
                cols, vals, win, win_off, n_out, n_in = k1_arrays(
                    parts[name][0], t)
                xk = xs_k[name, t] = torch.randn(n_in, k, device=dev,
                                                 generator=gen)
                errs[name, t] = compare(
                    f"{name} {'transpose arrays' if t else 'fwd'} k={k}",
                    es.ell_spmm(xk, cols, vals, win, win_off, n_out,
                                plan=k1_plan(parts[name][0], t)),
                    es._ell_spmm_plain(xk.double(), cols, vals.double(),
                                       win, win_off, n_out))
            torch.cuda.synchronize()
        reset_launches()
        losses, _ = run["fit"](step, state, 5)
        lp = run["evaluate"](eval_fn, state)
        torch.cuda.synchronize()
        launches = read_launches()
        want = model_launches(n_slots, n_parts, 5)
        print(f"  {label}: make_sharded_gcn_train_step {t_make:.2f}s; 5 "
              f"steps, dropout 0: losses {losses}; K1 launches "
              f"{launches[0]} by width {launches[1]} (expected {want})",
              flush=True)
        if launches[0] != want or set(launches[1]) - {k}:
            fail(f"model axis {label}: K1 launches {launches}, expected "
                 f"{want} at k={k}")
        check_close_losses(f"{label} vs the 1-D step", losses,
                           run["dist_losses"], 1e-4)
        check_close_losses(f"{label} vs unsharded", losses,
                           run["unsharded"], 1e-4)
        compare(f"{label} vs the 1-D step's eval log-probs", lp,
                run["dist_lp"], rtol=1e-5, atol=1e-4)
        got = params_to_numpy(gather_model_params(state[0], mesh))
        for layer, leaves in run["dist_params"].items():
            for name, want_p in leaves.items():
                compare(f"{label} vs the 1-D step's {layer}.{name}",
                        torch.as_tensor(got[layer][name]),
                        torch.as_tensor(want_p), rtol=1e-5, atol=1e-4)
        del state
        check_determinism(f"model axis {label}", step, shard_fn,
                          run["start"], run["fit"])
        torch.cuda.empty_cache()

    steps = run["steps"]
    print(f"[model axis main path] the default flavor, {steps} steps, "
          f"dropout 0.5, seed {SEED}", flush=True)
    step, eval_fn, shard_fn = make_sharded_gcn_train_step(
        mesh2, sg, dropout=0.5, model_axis="model", k_pad=32)
    state = run["start"](shard_fn)
    reset_launches()
    losses, step_ms = run["fit"](step, state, steps, events=True)
    lp = run["evaluate"](eval_fn, state)
    torch.cuda.synchronize()
    launches = read_launches()
    idx_test = run["idx_test"]
    acc = (lp[idx_test].argmax(1).cpu().numpy()
           == run["labels"][idx_test.cpu().numpy()]).mean()
    want = model_launches(n_slots, 2, steps)
    median = statistics.median(step_ms[-10:])
    print(f"  losses first {losses[0]:.6f} last {losses[-1]:.6f}; median "
          f"step {median:.3f} ms (CUDA events, last 10 steps) against the "
          f"1-D step's {run['dist_step_ms']:.3f}; test accuracy {acc:.4f}; "
          f"K1 launches {launches[0]} by width {launches[1]} (expected "
          f"{want}; the 1-D run's {run['dist_launches'][0]} by width "
          f"{run['dist_launches'][1]})", flush=True)
    if launches[0] != want:
        fail(f"model axis run: {launches[0]} K1 launches, expected {want}")
    if not losses[-1] < losses[0]:
        fail("model axis run: loss did not fall")
    if (tuple(lp.shape) != (n, run["ncls"])
            or not torch.isfinite(lp).all()):
        fail(f"model axis output shape {tuple(lp.shape)} or values not "
             f"finite")
    it = iter(range(steps, 10 ** 9))
    prof = profile_device("[model axis profile]", lambda: step(
        state[0], state[1], (SEED + 1, next(it)), *state[2]), 5)
    one = run["dist_profile"]
    print(f"  model axis against the 1-D step under torch.profiler: wall "
          f"{prof['wall']:.3f} vs {one['wall']:.3f} ms/step, device busy "
          f"{prof['busy']:.3f} vs {one['busy']:.3f}, K1 {prof['k1']:.4f} vs "
          f"{one['k1']:.4f} device ms/step", flush=True)
    path = (f"sharded GCN with a model axis, {nd} bands x {nm} model slots, "
            f"{steps} steps")
    rows = [sharded_k1_row(parts[name][0], t, xs_k[name, t],
                           f"model axis {name} part, slot 0 (band 0, model "
                           f"0), {'transpose arrays' if t else 'forward'} "
                           f"k={k} ({use})", launches, path, errs[name, t])
            for name, t, use in MODEL_USES]
    del state, parts, xs_k
    torch.cuda.empty_cache()
    return rows


# the projection's rates re-measured here must fall within these ratios of
# the committed capture's, else the capture is stale
CAPTURE_RATIO = (0.5, 2.0)
AUTO_WIDTHS = (128, 32, 40)
PROJECTION_DEVICES = (8, 16, 32)


class _Records(logging.Handler):
    """Collects the messages of a logger (the sharded step's auto wire)."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def projection_phase(dev, run, rows, plain_ms, nnz):
    """[projection]: the committed capture of the card's rates held against
    this run's own (K1's plain rate from the main path's timing, the
    sharded scale from the [dist] rows of shard 0's parts, the f32 matmul
    rate re-measured), within CAPTURE_RATIO; the sharded step with
    ``exchange_dtype="auto"`` on the 4-shard ragged plan (which must resolve
    to bf16) and on the 2 x 2 hierarchical plan, 5 steps at dropout 0
    through K1, each bit-equal to the same step with the resolved wire
    named; and the full-step projection on the capture's rates (powerlaw,
    8,192 nodes a card, d = 8, 16, 32, 8 cards a node, bf16 and fp8)."""
    import numpy as np

    from gcn_tpu_torch.parallel import (build_halo_plan_hier,
                                        create_mesh_hier,
                                        make_sharded_gcn_train_step)
    from gcn_tpu_torch.parallel import projection as pj
    from gcn_tpu_torch.time_sharded import matmul_rate

    cap = pj.load_capture()
    if cap is None:
        fail(f"the capture {pj.CAPTURE_NAME} is missing or unreadable")
    card = smi_line()
    print(f"[projection] capture {pj.CAPTURE_NAME}: {cap.get('card')}, "
          f"torch {cap.get('torch')}, commit {cap.get('commit')}; this "
          f"card: {card}", flush=True)
    if cap.get("card", "").split(",")[0] != card.split(",")[0]:
        fail(f"the capture names another card: {cap.get('card')}")
    try:
        want = {
            "K1 plain rate (edges/s)": cap["spmm"]["edges_per_s"],
            "sharded scale, 4 shards, band 0's parts, k=32":
                cap["check"]["production_parts"]["blocks_over_plain"],
            "f32 matmul rate (flop/s)": cap["matmul"]["flops_per_s"]}
        rates = [cap[t]["production_parts"]["blocks_over_plain"]
                 for t in ("k_pad_32", "k_pad_128")]
        rates += [cap[t]["sharded_over_plain"]
                  for t in ("k_pad_32", "k_pad_128")]
        rates.append(cap["links"]["bw_ici"])
    except (KeyError, TypeError) as e:
        fail(f"the capture lacks a rate: {e!r}")
    if not all(isinstance(v, (int, float)) and v > 0
               for v in list(want.values()) + rates):
        fail("the capture holds a rate that is not a positive number")
    rate = nnz / (plain_ms * 1e-3)
    by_use = {use[:3]: r for use, r in zip(DIST_USES, rows)}
    edges = run["interior"].nnz + run["halo"].nnz
    part_ms = (by_use["interior", False, 32]["ms"]
               + by_use["halo", False, 32]["ms"])
    flops, _ = matmul_rate(dev)
    got = {"K1 plain rate (edges/s)": rate,
           "sharded scale, 4 shards, band 0's parts, k=32":
               part_ms * 1e-3 * rate / edges,
           "f32 matmul rate (flop/s)": flops}
    for name, v in want.items():
        ratio = got[name] / v
        ok = CAPTURE_RATIO[0] <= ratio <= CAPTURE_RATIO[1]
        print(f"  {name}: capture {v:.4e}, this run {got[name]:.4e}, ratio "
              f"{ratio:.3f} -> {'ok' if ok else 'STALE'}", flush=True)
        if not ok:
            fail(f"{name}: the capture's {v:.4e} against this run's "
                 f"{got[name]:.4e}: the capture is stale")
    print(f"  the capture's production scales (8 shards, every band, "
          f"forward): pass-block {rates[0]:.3f} / {rates[1]:.3f}, "
          f"monolithic {rates[2]:.3f} / {rates[3]:.3f} at k_pad 32 / 128; "
          f"bw_ici {rates[4]:.4e} B/s ({pj.measured_bw_ici()[1]}; not "
          f"re-measured on one card)", flush=True)

    records = _Records()
    step_log = logging.getLogger("gcn_tpu_torch.parallel.train_step")
    step_log.addHandler(records)
    step_log.setLevel(logging.INFO)
    sg, ns = run["sg"], run["sg"].n_shards
    widths = (run["nhid"], run["ncls"])
    for label, mesh, opts in (
            ("ragged, 4 shards", run["mesh"], {}),
            ("halo_hier 2x2", create_mesh_hier(2, 2, dev),
             dict(exchange="halo_hier"))):
        records.messages.clear()
        step, _, shard_fn = make_sharded_gcn_train_step(
            mesh, sg, dropout=0.0, exchange_dtype="auto", widths=AUTO_WIDTHS,
            exchange_chunk=DIST_CHUNK, k_pad=32, **opts)
        if len(records.messages) != 1:
            fail(f"auto wire, {label}: {records.messages}")
        wire = records.messages[0].split("-> ")[1].split(" ")[0]
        print(f"[projection auto wire] {label}, widths {AUTO_WIDTHS}: "
              f"{records.messages[0]}", flush=True)
        if wire not in ("bf16", "fp8"):
            fail(f"auto wire, {label}: resolved to {wire!r}")
        if not opts and wire != "bf16":
            fail(f"auto wire on the ragged plan resolved to {wire}, not bf16")
        reset_launches()
        auto_l, _ = run["fit"](step, run["start"](shard_fn), 5)
        launches = read_launches()
        # 5 steps, no eval forward
        expected = 5 * (dist_launches(ns, widths, DIST_CHUNK, 1)
                        - dist_launches(ns, widths, DIST_CHUNK, 0))
        step, _, shard_fn = make_sharded_gcn_train_step(
            mesh, sg, dropout=0.0, exchange_dtype=wire, widths=AUTO_WIDTHS,
            exchange_chunk=DIST_CHUNK, k_pad=32, **opts)
        named_l, _ = run["fit"](step, run["start"](shard_fn), 5)
        same = auto_l == named_l
        print(f"  5 steps, dropout 0: auto {auto_l}; {wire} named "
              f"{named_l}: bit-equal {same}; K1 launches {launches[0]} "
              f"(expected {expected})", flush=True)
        if not same:
            fail(f"auto wire, {label}: losses differ from the {wire} step")
        if launches[0] != expected:
            fail(f"auto wire, {label}: {launches[0]} K1 launches, expected "
                 f"{expected}")
        check_close_losses(f"auto wire {label} vs f32", auto_l,
                           run["dist_losses"], 0.05)
    step_log.removeHandler(records)
    hier = build_halo_plan_hier(sg, 2, 2)
    print(f"  the 2 x 2 plan's volumes: intra {hier.intra_sizes}, inter "
          f"{hier.inter_sizes}, fan-out rows {hier.ici_gather_rows}",
          flush=True)

    for wire, bpe in (("bf16", 2), ("fp8", 1)):
        t0 = time.time()
        prows, meta = pj.project_weak_scaling_fullstep(
            list(PROJECTION_DEVICES), nodes_per_device=8192,
            workload="powerlaw", chips_per_host=8, bytes_per_elt=bpe)
        print(f"[projection fullstep] {wire} wire, powerlaw, 8192 nodes a "
              f"card, 8 a node ({time.time() - t0:.1f}s on the host); rates:"
              f" spmm {meta['spmm_edges_per_s']:.4e} "
              f"({meta['spmm_rate_source']}), scales "
              f"{meta['kernel_scale_split']:.3f} / "
              f"{meta['kernel_scale_mono']:.3f}, mxu "
              f"{meta['mxu_flops']:.4e}, bw_ici {meta['bw_ici_B_per_s']:.4e}"
              f", bw_dcn {meta['bw_dcn_B_per_s']:.4e} "
              f"({meta['bw_dcn_source']})", flush=True)
        for r in prows:
            j = r.to_json()
            if not (0 < j["eff"]["1.0"] <= 1 and np.isfinite(j["step_ms"])):
                fail(f"projection row out of range: {j}")
            print(f"  {json.dumps(j)}", flush=True)


def orders_phase(dev, data):
    """K1 under every vertex order of gcn_tpu's reorder family, on
    synth-arxiv after ``gcn_normalize``: each method's host seconds and
    route, the degree-sorted ELL layout at k_pad 32, K1 forward at k = 32
    against its float64 plain version, and K1's time beside its plain
    version's, ``torch.sparse.mm``'s and the bound. Returns the methods'
    ``kernels`` rows (``launches``: the phase's own K1 calls on that
    layout)."""
    import torch

    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.reorder import METHODS, reorder_graph, route
    from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency

    g0 = gcn_normalize(data.adj)
    n = g0.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn(n, 32, device=dev, generator=gen)
    print(f"[orders] synth-arxiv n={n} nnz={g0.nnz} after gcn_normalize: "
          f"each method, then the degree sort and ell_adjacency(k_pad=32)",
          flush=True)
    rows = []
    for method in METHODS:
        t0 = time.time()
        g, _ = reorder_graph(g0, method)
        t_reorder = time.time() - t0
        t0 = time.time()
        g = g.permute(degree_sort_order(g))
        adj = ell_adjacency(g, k_pad=32, symmetric=True, device=dev)
        t_tile = time.time() - t0
        blocks = adj.win_off.diff()
        print(f"[orders] {method}: reorder {t_reorder:.2f} s on the host "
              f"({route(method)} route); degree sort and tiling "
              f"{t_tile:.2f} s; slots={adj.cols.numel()} "
              f"pad={adj.pad_fraction:.3f} n_hub={adj.n_hub} longest "
              f"window walk {int(blocks.max())} pass-blocks", flush=True)
        cols, vals, win, win_off, n_out, n_in = k1_arrays(adj)
        reset_launches()
        err = compare(f"{method} fwd k=32, K1 vs plain",
                      es.ell_spmm(x, cols, vals, win, win_off, n_out,
                                  plan=adj.split),
                      es._ell_spmm_plain(x.double(), cols, vals.double(),
                                         win, win_off, n_out))
        ms = chain_ms(lambda v: es.ell_spmm(v, cols, vals, win, win_off,
                                            n_out, plan=adj.split), x, 30,
                      n_in)
        torch.cuda.synchronize()
        launches = read_launches()
        plain_ms = chain_ms(lambda v: es._ell_spmm_plain(
            v, cols, vals, win, win_off, n_out), x, 3, n_in)
        csr = g.to_torch(dev)
        lib_ms = chain_ms(lambda v: torch.sparse.mm(csr, v), x, 30, n)
        bound_ms, bound_by = k1_bound(adj, 32)
        print(f"[K1 timing] after {method}: K1 {ms:.4f} ms | plain "
              f"{plain_ms:.4f} ms | torch.sparse.mm (CSR) {lib_ms:.4f} ms | "
              f"bound {bound_ms:.5f} ms ({100 * bound_ms / ms:.1f}% of it, "
              f"by {bound_by})", flush=True)
        rows.append({
            "name": f"ell_spmm: synth-arxiv fwd k=32 after {method} and the "
                    f"degree sort", "use": method, "route": "cuda",
            "source": "gcn_tpu_torch/ops/csrc/ell_spmm.cu",
            "replaces": K1_REPLACES, "launches": launches[0],
            "launches_by_k": launches[1], "path": "[orders] phase",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "reorder_s": t_reorder, "reorder_route": route(method),
            "slots": adj.cols.numel(), "pad_fraction": adj.pad_fraction,
            "longest_walk": int(blocks.max())})
        del adj, csr
    best = min(rows, key=lambda r: r["ms"])
    print(f"[orders] K1's best time is after {best['use']}: "
          f"{best['ms']:.4f} ms (rabbit "
          f"{next(r['ms'] for r in rows if r['use'] == 'rabbit'):.4f} ms)",
          flush=True)
    return rows


BENCH_WITHIN = 0.10     # the benchmark's K1 times against this run's
KPAD_SWEEP = os.path.join("gcn_tpu_torch", "results", "kpad_sweep.json")


def kpad_serving_ms():
    """``bench_kpad``'s committed serving K1 time at synth-arxiv, k =
    k_pad = 32 (``gcn_tpu_torch/results/kpad_sweep.json``), and its
    card."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, KPAD_SWEEP)) as f:
        sweep = json.load(f)
    row = next(r for r in sweep["rows"] if r["graph"] == "synth-arxiv"
               and r["k"] == r["k_pad"] == 32)
    return row["ell_ms"], sweep["_meta"]["card"]


def bench_phase(dev, data, g, perm, adjs, x, k1_ms, fold_ms):
    """[bench]: the one-line benchmark ``gcn_tpu_torch.bench`` on the main
    path's graph ``g`` (rabbit and the degree sort, ``perm[new] = old``)
    and its layouts ``adjs`` (``bench.layouts``, on which [K1 vs plain]
    checked K1): its line printed, its roofline share at most 100%, its
    training-layout time within BENCH_WITHIN of this run's [K1 timing] row
    ``k1_ms`` plus its [hub fold] row ``fold_ms`` (the benchmark times
    ``spmm_ell``, K1 and the fold, as ``bench.py`` times gcn_tpu's whole
    ``spmm_ell``), and its serving K1 time within BENCH_WITHIN of K1's
    median of 30 calls on that layout at ``x`` timed here (no hub rows,
    so no fold). ``bench_kpad``'s committed serving row is printed beside
    them."""
    from gcn_tpu_torch import bench
    from gcn_tpu_torch.ops.ell_spmm import spmm_ell

    t0 = time.time()
    line = bench.measure(data, g, perm, 32, dev, adjs=adjs)
    print(f"[bench] {json.dumps(line)}", flush=True)
    d = line["detail"]
    if not d["roofline_pct"] <= 100.0:
        fail(f"bench roofline_pct {d['roofline_pct']} above 100")
    serving_ms = chain_ms(lambda v: spmm_ell(adjs[0], v), x, 30, g.shape[0])
    for key, ref, what in (("ell_ms_train_default", k1_ms + fold_ms,
                            "this run's [K1 timing] + [hub fold] rows"),
                           ("ell_ms", serving_ms,
                            "K1 on the serving layout timed here")):
        off = abs(d[key] / ref - 1.0)
        print(f"[bench] {key} {d[key]:.4f} ms against {what} {ref:.4f} "
              f"ms: {100 * off:.1f}% off (limit "
              f"{100 * BENCH_WITHIN:.0f}%)", flush=True)
        if off > BENCH_WITHIN:
            fail(f"bench {key} {d[key]} ms is {100 * off:.1f}% off {what} "
                 f"{ref} ms")
    kpad_ms, kpad_card = kpad_serving_ms()
    print(f"[bench] bench_kpad's committed serving row: {kpad_ms:.4f} ms "
          f"({kpad_card}; seed 0, for information)", flush=True)
    print(f"[bench] {line['value']:.4g} edges/s, vs_baseline "
          f"{line['vs_baseline']:.3f}, K1 serving at "
          f"{d['roofline_pct']:.2f}% of its bound, torch.sparse.mm "
          f"{d['sparse_mm_ms']:.4f} ms; train step {d['train_step_ms']:.4f}"
          f" / hoisted {d['train_step_hoisted_ms']:.4f} ms captured, "
          f"{d['train_step_eager_ms']:.4f} / "
          f"{d['train_step_hoisted_eager_ms']:.4f} eager "
          f"({time.time() - t0:.1f}s)", flush=True)


# profile_ops' rows of v6 at hidden 32 and 40 classes: layer 1 hoisted (no
# af row), layer 2 on (AX)W
PROFILE_ROWS = ["l1_xw", "l1_bi", "l2_af", "l2_xw", "l2_bi", "fwd", "bwd"]


TRAIN_GCN_FLAGS = "--train-gcn-flags"


def train_gcn_flags_in_child(order_rows):
    """``train_gcn_flags_phase`` in a process of its own (this script with
    ``--train-gcn-flags``), waited for: torch.profiler dropped one of the
    fit's eager K1 records (and 13 other device records) when this phase
    ran late in the smoke's one long process (twice in two runs), never
    in a fresh one. The gorder row of ``order_rows`` takes the fit's
    count."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           TRAIN_GCN_FLAGS], capture_output=True, text=True,
                          timeout=900)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        print("\n".join(lines) + "\n" + proc.stderr[-3000:], flush=True)
        fail(f"the [train_gcn flags] process exited {proc.returncode}")
    print("\n".join(lines[:-1]), flush=True)
    launches, by_k, path = json.loads(lines[-1])
    for row in order_rows:
        if row["use"] == "gorder":
            row["launches"], row["path"] = launches, path
            row["launches_by_k"] = {int(k): n for k, n in by_k.items()}


def train_gcn_flags_phase():
    """``train_gcn.main`` on the card with the flags this slice adds:
    synth-arxiv, v6 after gorder, 20 steps, --profile-ops, --save-path and
    --history-json; then --load-path of the saved params. The CLI runs the
    default captured loop, so K1's launches in the fit are counted from
    the profiler's kernel records (``GCN.fit`` runs under torch.profiler)
    and the host counter reads the warm-up steps and the captured call;
    the profile's launches are read around it on the host counter (it
    runs its ops eagerly). Returns the fit's K1 launches, by width, and
    the run's command line."""
    import tempfile

    from gcn_tpu_torch import train_gcn
    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.train.capture import WARMUP

    steps, method = 20, "gorder"
    seen = {}
    profile_ops, fit = GCN.profile_ops, GCN.fit

    def profiled(self, *args, **kw):
        reset_launches()
        seen["timers"] = profile_ops(self, *args, **kw)
        seen["profile"] = read_launches()
        return seen["timers"]

    def profiled_fit(self, *args, **kw):
        reset_launches()
        out, seen["fit_records"] = kernel_records(
            lambda: fit(self, *args, **kw), "ell_spmm")
        seen["fit"] = read_launches()
        seen["per_call"] = self.adj_norm.split.launches
        return out

    with tempfile.TemporaryDirectory() as tmp:
        params = os.path.join(tmp, "params.npz")
        hist_path = os.path.join(tmp, "history.json")
        argv = ["-g", "synth-arxiv", "-k", "32", "-i", str(steps),
                "--variant", "v6", "--reorder", method]
        shown = argv + ["--profile-ops", "--save-path", "P",
                        "--history-json", "H"]
        print(f"[train_gcn flags] train_gcn.main({shown})", flush=True)
        GCN.profile_ops, GCN.fit = profiled, profiled_fit
        try:
            acc = train_gcn.main(argv + ["--profile-ops", "--save-path",
                                         params, "--history-json",
                                         hist_path])
        finally:
            GCN.profile_ops, GCN.fit = profile_ops, fit
        with open(hist_path) as f:
            hist = json.load(f)
        print("[train_gcn flags] --load-path P", flush=True)
        loaded = train_gcn.main(argv + ["--load-path", params])
    losses = [h["loss_train"] for h in hist["history"]]
    fit_host, records = seen["fit"], seen["fit_records"]
    # kernel records: K1's launches a call, from the layout's walk split
    expected = (4 + 2 * steps + 1) * seen["per_call"]
    host_expected = 4 + 2 * (WARMUP + 1) + 1
    timers = seen["timers"]
    profile_expected = (20 + 5) * 4     # l2_af, fwd, and bwd's two a row
    print(f"[train_gcn flags] losses first {losses[0]:.6f} last "
          f"{losses[-1]:.6f}; test accuracy {acc:.4f}, after --load-path "
          f"{loaded:.4f}; history keys {sorted(hist)}", flush=True)
    print(f"  K1 launches: fit {records} kernel records under "
          f"torch.profiler (expected {expected} = (4 hoist + 2 x {steps} "
          f"steps + 1 eval) x {seen['per_call']} a call), {fit_host[0]} "
          f"host calls by width "
          f"{fit_host[1]} (expected {host_expected}: {WARMUP} warm-up steps "
          f"and the captured one); profile {seen['profile'][0]} (expected "
          f"{profile_expected})", flush=True)
    print(f"  profile_ops rows {timers.names()}, median device ms: "
          + ", ".join(f"{name} {timers(name).d.median_ms:.4f}"
                      for name in timers.names()), flush=True)
    if records != expected or fit_host[0] != host_expected:
        fail(f"train_gcn fit: {records} K1 kernel records, {fit_host[0]} "
             f"host calls, expected {expected} and {host_expected}")
    if seen["profile"][0] != profile_expected:
        fail(f"profile_ops: {seen['profile'][0]} K1 launches, expected "
             f"{profile_expected}")
    if len(losses) != steps or not losses[-1] < losses[0]:
        fail(f"train_gcn: {len(losses)} losses, {losses[0]} -> {losses[-1]}")
    if timers.names() != PROFILE_ROWS:
        fail(f"profile_ops rows {timers.names()}, expected {PROFILE_ROWS}")
    for name in timers.names():
        samples = timers(name).d.samples
        if len(samples) != 20 or not all(
                0 < v < float("inf") for v in samples):
            fail(f"profile_ops row {name}: {samples}")
    if loaded != acc:
        fail(f"--load-path test accuracy {loaded} != the fit's {acc}")
    # every K1 call of this fit is at k = 32 (the hoist's tiles, layer 2
    # and its dX): the records are the launches at that width
    if len(fit_host[1]) != 1:
        fail(f"train_gcn fit: K1 called at widths {fit_host[1]}")
    (k,) = fit_host[1]
    return records, {k: records}, (f"train_gcn -g synth-arxiv -k 32 -i "
                                   f"{steps} --variant v6 --reorder "
                                   f"{method}")


def gcn_resume_phase(dev, data, uninterrupted):
    """GCN v6 on synth-arxiv: 10 steps, ``save_state``, a resume of 10,
    against the main path's uninterrupted 20 (dropout 0.5)."""
    import tempfile

    from gcn_tpu_torch.models import GCN

    print("[GCN resume] v6 synth-arxiv, 10 + save_state + 10 steps against "
          "the main path's 20, dropout 0.5", flush=True)
    kw = dict(variant="v6", seed=SEED, device=dev)
    first = GCN(data.num_features, 32, data.num_classes, **kw)
    first.fit(data.features, data.adj, data.labels, data.idx_train,
              train_iters=10)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gcn_state")
        first.save_state(path)
        second = GCN(data.num_features, 32, data.num_classes, **kw)
        second.fit(data.features, data.adj, data.labels, data.idx_train,
                   train_iters=10, resume_from=path)
    if second._iters_done != 20:
        fail(f"resumed run reports {second._iters_done} iterations")
    check_close_losses("GCN 10 + 10 vs 20", losses_of(first)
                       + losses_of(second), uninterrupted, 1e-6)


# captured against eager on the card: the same kernels in the same order
# and the same capturable Adam, and every sum in a fixed order (K1 and K2
# by design, the hub fold in chunk order, ``ops/ell_spmm.py``), so the
# GCN paths are held bit-equal (``exact``: losses and log-probs); HGNN's
# 200 epochs keep the card-vs-CPU rtol 1e-4, logits rtol and atol 1e-4
# (test_torch_port_hgnn.py's)
CAPTURED_RTOL = 1e-5


def captured_report(label, captured, eager, ms, rtol=CAPTURED_RTOL,
                    atol=1e-4, exact=False):
    """Hold a captured fit's (losses, output) against the eager fit's
    from the same parameters and generator; print both flavors' median
    step or epoch, ``ms`` = (captured, eager). ``exact`` fails unless both
    are bit-equal."""
    import torch

    bitwise = (captured[0] == eager[0] and torch.equal(captured[1],
                                                      eager[1]))
    print(f"  {label}: median {ms[0]:.4f} ms captured against {ms[1]:.4f} "
          f"ms eager ({ms[1] / ms[0]:.2f}x); bit-equal: {bitwise}",
          flush=True)
    if exact and not bitwise:
        fail(f"{label}: the captured fit is not bit-equal to the eager one")
    check_close_losses(f"{label} captured vs eager losses", captured[0],
                       eager[0], rtol)
    compare(f"{label} captured vs eager output", captured[1], eager[1],
            rtol=rtol, atol=atol)


def captured_gcn_phase(dev, data, eager, panel):
    """[captured fit]: the default loop flavor (``jit_loop=True``), one
    CUDA graph of a training step replayed, on the main path (GCN v6,
    synth-arxiv, 20 steps, dropout 0.5, seed 15) and on the panel path,
    against the eager fits of phases 7 and 8 from the same parameters and
    generator seed. The wrappers' host counters count the warm-up steps
    and the captured call; the kernels the replays launch are counted
    from the profiler's kernel records, in a second captured run. Then the
    captured step's device-busy share under torch.profiler. Returns
    {path: (profiler records, host calls)}."""
    import torch

    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.ops import panel_spmm as ps
    from gcn_tpu_torch.train.capture import WARMUP

    steps = len(eager.history)
    nfeat, nhid, ncls = data.num_features, eager.nhid, eager.nclass
    host_expected = 4 + 2 * (WARMUP + 1) + 1
    records_expected = 4 + 2 * steps + 1

    def main_path():
        m = GCN(nfeat, nhid, ncls, variant="v6", seed=SEED, device=dev)
        m.fit(data.features, data.adj, data.labels, data.idx_train,
              train_iters=steps)
        return m

    print(f"[captured fit] GCN v6 main path, {steps} steps, dropout 0.5, "
          f"seed {SEED}: the default flavor (jit_loop=True) against the "
          f"[main path]'s eager fit", flush=True)
    t0 = time.time()
    reset_launches()
    cap = main_path()
    torch.cuda.synchronize()
    host = es.spmm_ell_launches
    acc = cap.test(data.idx_test, verbose=False)
    acc_eager = eager.test(data.idx_test, verbose=False)
    print(f"  fit {time.time() - t0:.2f}s (preprocessing included); "
          f"fit_scan {cap.timers('fit_scan').d.total_ms:.3f} ms; test "
          f"accuracy {acc:.4f} (eager {acc_eager:.4f}); generator state "
          f"equal to the eager fit's: "
          f"{torch.equal(cap._rng_state, eager._rng_state)}", flush=True)
    captured_report("main path step", (losses_of(cap), cap.output),
                    (losses_of(eager), eager.output),
                    (cap.timers("step").d.median_ms,
                     eager.timers("step").d.median_ms), exact=True)
    if not torch.equal(cap._rng_state, eager._rng_state):
        fail("the captured fit leaves another dropout stream")
    if abs(acc - acc_eager) > 2.0 / len(data.idx_test):
        fail(f"captured test accuracy {acc} against eager {acc_eager}")
    cap2, records = kernel_records(main_path, "ell_spmm")
    # K1's kernel launches a call, reckoned from the layout's walk split
    per_call = cap.adj_norm.split.launches
    plan_line("main path (GCN v6's layout)", cap.adj_norm)
    print(f"  K1: {host} host calls (expected {host_expected} = 4 hoist + "
          f"2 x ({WARMUP} warm-up + 1 captured) + 1 eval); {records} "
          f"kernel records under torch.profiler (expected "
          f"{records_expected * per_call} = (4 + 2 x {steps} + 1) x "
          f"{per_call} a call)", flush=True)
    if host != host_expected or records != records_expected * per_call:
        fail(f"captured main path: K1 {host} host calls, {records} "
             f"records")
    check_close_losses("main path profiled captured run vs the first",
                       losses_of(cap2), losses_of(cap), CAPTURED_RTOL)
    profile_steps(cap, data.idx_train, 10, captured=True)

    pfeats_of, padj, labels, idx_train, init, panel_eager = panel
    print(f"[captured fit] panel path, {steps} steps, dropout 0.5, seed "
          f"{SEED}: the default flavor against phase 8's eager fit",
          flush=True)
    kernels_per_spmm = int(padj.heavy.numel() > 0) + int(
        padj.light.numel() > 0)

    def panel_path():
        return panel_fit(init, pfeats_of(), padj, labels, idx_train, steps,
                         0.5, dev)

    reset_launches()
    pres = panel_path()
    torch.cuda.synchronize()
    phost, k1_host = ps.spmm_panel_launches, es.spmm_ell_launches
    captured_report("panel path step", (losses_of(pres), pres.log_probs),
                    (losses_of(panel_eager), panel_eager.log_probs),
                    (pres.timers("step").d.median_ms,
                     panel_eager.timers("step").d.median_ms), exact=True)
    if not torch.equal(pres.rng_state, panel_eager.rng_state):
        fail("the captured panel fit leaves another dropout stream")
    _, precords = kernel_records(panel_path, "panel_spmm")
    precords_expected = kernels_per_spmm * records_expected
    print(f"  K2: {phost} host calls (expected {host_expected}), K1 "
          f"{k1_host}; {precords} kernel records under torch.profiler "
          f"(expected {precords_expected} = {kernels_per_spmm} launches "
          f"an SpMM x {records_expected})", flush=True)
    if (phost != host_expected or k1_host != 0
            or precords != precords_expected):
        fail(f"captured panel path: K2 {phost} host calls, {precords} "
             f"records, K1 {k1_host}")
    return {"main": (records, host), "panel": (precords, phost)}


LADDER = ("v1", "v2", "v3", "v4", "v5")
LADDER_STEPS = 20


def coo_index_add(adj, x, t=False):
    """The COO product as the port had it before its fixed-order segment
    sum: the products added with ``index_add_`` (atomic adds on the card),
    kept here only as the [ladder] phase's timing reference; ``t`` runs it
    over the transpose arrays. In float64 when ``x`` is (the plain
    version the checks hold the product to)."""
    rows, cols, vals, n_out = ((adj.t_rows, adj.t_cols, adj.t_vals,
                                adj.n_cols) if t else
                               (adj.rows, adj.cols, adj.vals, adj.n_rows))
    prod = x[cols] * vals.to(x.dtype)[:, None]
    return prod.new_zeros((n_out, x.shape[1])).index_add_(0, rows, prod)


def ladder_phase(dev, data, p0):
    """[ladder]: GCN v1-v5, the variants that train over the COO product
    (``adj_kind="auto"`` resolves to ``CooAdj`` past 8,192 rows), on
    synth-arxiv in its own vertex order (no reorder, as v1-v5 run): the
    product's row edge counts; two calls bit-equal, forward and dX; the
    product against its float64 plain version at the f32 tolerance; 5-step
    fits (dropout 0) card against CPU from phase 6's parameters (rtol
    1e-4); 20-step fits (dropout 0.5, seed 15) captured against eager, bit
    for bit, with K1 and K2 never launched; the product's device ms beside
    ``torch.sparse.mm`` and the former ``index_add_`` reduction, at k = 32
    and 40 (layer 2's widths at hidden 32); v4's captured and eager median
    step. Returns a summary dict, printed as one JSON line."""
    import torch

    from gcn_tpu_torch.convert import params_from_numpy
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.ops import panel_spmm as ps
    from gcn_tpu_torch.ops.adjacency import CooAdj, device_adjacency
    from gcn_tpu_torch.ops.spmm import spmm

    t0 = time.time()
    nfeat, nhid, ncls = data.num_features, 32, data.num_classes
    g = gcn_normalize(data.adj)
    # what GCN v1-v5 build: no reorder, kind "auto" past 8,192 rows
    adj = device_adjacency(g, "auto", device=dev, symmetric=True)
    if not isinstance(adj, CooAdj):
        fail(f"'auto' built {type(adj).__name__} on synth-arxiv, not CooAdj")
    row_len = adj.row_len.cpu().numpy()
    e_pad = adj.rows.numel()
    print(f"[ladder] GCN v1-v5 on synth-arxiv (own order, n={adj.n_rows}, "
          f"nnz={adj.nnz}): CooAdj of {e_pad} padded edges, row edge "
          f"counts sum {int(row_len.sum())}, longest row {row_len.max()}, "
          f"{int((row_len == 0).sum())} empty rows ({time.time() - t0:.1f}s)",
          flush=True)
    if int(row_len.sum()) != e_pad or (row_len < 0).any():
        fail("the COO row edge counts do not cover the padded edges")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = {k: torch.randn(adj.n_cols, k, device=dev, generator=gen)
          for k in (32, 40)}
    ct = torch.randn(adj.n_rows, 32, device=dev, generator=gen)

    def dx(x):
        xg = x.clone().requires_grad_(True)
        return torch.autograd.grad(spmm(adj, xg), xg, ct)[0]

    check_repeat("COO spmm fwd k=32", lambda: spmm(adj, xs[32]))
    check_repeat("COO spmm dX k=32", lambda: dx(xs[32]))
    errs = [compare(f"COO spmm fwd k={k}", spmm(adj, x),
                    coo_index_add(adj, x.double()))
            for k, x in xs.items()]
    errs.append(compare("COO spmm dX k=32 (transpose arrays)", dx(xs[32]),
                        coo_index_add(adj, ct.double(), t=True)))
    atomic_same = torch.equal(coo_index_add(adj, xs[32]),
                              coo_index_add(adj, xs[32]))
    print(f"  the former index_add_ reduction's two calls bit-equal: "
          f"{atomic_same} (atomic adds)", flush=True)

    print("[ladder] 5-step fits, dropout 0, card vs cpu from phase 6's "
          "parameters", flush=True)
    for v in LADDER:
        hist = {}
        for device in (dev, "cpu"):
            t1 = time.time()
            m = GCN(nfeat, nhid, ncls, dropout=0.0, variant=v, seed=SEED,
                    device=device)
            m.params = params_from_numpy(p0, device)
            m.fit(data.features, data.adj, data.labels, data.idx_train,
                  train_iters=5, initialize=False, jit_loop=False)
            hist[str(device)] = (losses_of(m), time.time() - t1)
        print(f"  {v}: cuda {hist[str(dev)][0]} ({hist[str(dev)][1]:.1f}s); "
              f"cpu {hist['cpu'][1]:.1f}s", flush=True)
        check_close_losses(f"{v} card vs cpu", hist[str(dev)][0],
                           hist["cpu"][0], 1e-4)

    print(f"[ladder] {LADDER_STEPS}-step fits, dropout 0.5, seed {SEED}: "
          f"the default captured flavor against the eager one", flush=True)
    steps_ms = {}
    for v in LADDER:
        runs = {}
        for jit_loop in (False, True):
            reset_launches()
            m = GCN(nfeat, nhid, ncls, variant=v, seed=SEED, device=dev)
            m.fit(data.features, data.adj, data.labels, data.idx_train,
                  train_iters=LADDER_STEPS, jit_loop=jit_loop)
            torch.cuda.synchronize()
            if read_launches()[0] or ps.spmm_panel_launches:
                fail(f"{v} launched K1 or K2 over its CooAdj")
            if not isinstance(m.adj_norm, CooAdj):
                fail(f"{v} trained over {type(m.adj_norm).__name__}")
            runs[jit_loop] = m
        eager, cap = runs[False], runs[True]
        if not losses_of(eager)[-1] < losses_of(eager)[0]:
            fail(f"{v}: the loss did not fall")
        if not torch.isfinite(eager.output).all():
            fail(f"{v}: the output is not finite")
        steps_ms[v] = (cap.timers("step").d.median_ms,
                       eager.timers("step").d.median_ms)
        print(f"  {v}: orders {eager._orders()}, loss "
              f"{losses_of(eager)[0]:.4f} -> {losses_of(eager)[-1]:.4f}, "
              f"test accuracy {eager.test(data.idx_test, verbose=False):.4f}",
              flush=True)
        captured_report(f"{v} step", (losses_of(cap), cap.output),
                        (losses_of(eager), eager.output), steps_ms[v],
                        exact=True)
        if not torch.equal(cap._rng_state, eager._rng_state):
            fail(f"{v}: the captured fit leaves another dropout stream")

    print("[ladder] the COO product's time on the card (median of 30 "
          "chained calls)", flush=True)
    csr = g.to_torch(dev)
    times = {}
    for k, x in xs.items():
        times[k] = {
            "coo_ms": chain_ms(lambda y: spmm(adj, y), x, 30),
            "index_add_ms": chain_ms(lambda y: coo_index_add(adj, y), x, 30),
            "sparse_mm_ms": chain_ms(lambda y: torch.sparse.mm(csr, y), x,
                                     30),
            "bound_ms": least_ms(*spmm_work(adj.nnz, 0, adj.n_cols,
                                            adj.n_rows, k))[0]}
        r = times[k]
        print(f"  k={k}: segment sum {r['coo_ms']:.4f} ms | the former "
              f"index_add_ {r['index_add_ms']:.4f} ms | torch.sparse.mm "
              f"{r['sparse_mm_ms']:.4f} ms | bound {r['bound_ms']:.5f} ms",
              flush=True)
    print(f"  v4 median step: {steps_ms['v4'][0]:.4f} ms captured, "
          f"{steps_ms['v4'][1]:.4f} ms eager", flush=True)
    summary = {"coo": {str(k): v for k, v in times.items()},
               "max_abs_err": max(errs),
               "steps_ms": {v: {"captured": c, "eager": e}
                            for v, (c, e) in steps_ms.items()}}
    print(f"[ladder] {json.dumps(summary)}", flush=True)
    return summary


def index_add_fold(out_virt, adj):
    """The hub fold as the port had it before its fixed order: an
    ``index_add_`` over ``virt_map`` (atomic adds on the card), the
    baseline of the [hub fold] phase."""
    import torch

    n_virt_hub = adj.virt_map.shape[0]
    hub = out_virt.new_zeros((adj.n_hub, out_virt.shape[1]))
    hub.index_add_(0, adj.virt_map, out_virt[:n_virt_hub])
    rest = out_virt[n_virt_hub:n_virt_hub + (adj.n_rows - adj.n_hub)]
    return torch.cat([hub, rest], dim=0)


def hub_fold_phase(dev, adj, x, ct):
    """[hub fold] on the main path's layout (synth-arxiv, k_pad 32) at
    k=32: two calls of ``spmm_ell`` bit-equal forward and dX; the fold
    (``ops/ell_spmm.py::_hub_epilogue``) against the former ``index_add_``
    fold at rtol 1e-6 (f32 reassociation); both folds' device ms on K1's
    output. Returns (fold ms, index_add_ fold ms)."""
    import torch

    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.utils.chain_timing import device_ms

    print(f"[hub fold] synth-arxiv k=32: {adj.n_hub} hub rows in "
          f"{adj.virt_map.numel()} chunks, {len(adj.hub_steps)} steps "
          f"(the largest chunk count), {adj.hub_idx.numel()} rows read",
          flush=True)

    def forward_and_dx():
        xg = x.clone().requires_grad_(True)
        out = es.spmm_ell(adj, xg)
        out.backward(ct)
        return torch.cat([out.detach(), xg.grad])

    check_repeat("spmm_ell forward and dX (K1 + the hub fold)",
                 forward_and_dx)
    with torch.no_grad():
        virt = es.ell_spmm(x, adj.cols, adj.vals, adj.win, adj.win_off,
                           adj.row_space, plan=adj.split)
        # the fold writes its sums over K1's output: a copy each
        compare("fold vs the index_add_ fold",
                es._hub_epilogue(virt.clone(), adj),
                index_add_fold(virt, adj), rtol=1e-6)
        atomic_same = torch.equal(index_add_fold(virt, adj),
                                  index_add_fold(virt, adj))
        # the fold's work does not depend on the values it overwrites
        scratch = virt.clone()
        fold_ms = device_ms(lambda: es._hub_epilogue(scratch, adj), 30)
        old_ms = device_ms(lambda: index_add_fold(virt, adj), 30)
    print(f"  the index_add_ fold's two calls bit-equal: {atomic_same} "
          f"(atomic adds); fold {fold_ms:.4f} ms against the index_add_ "
          f"fold's {old_ms:.4f} ms (device ms, median of 30 behind a spin "
          f"kernel)", flush=True)
    return fold_ms, old_ms


WIDE_HIDDENS = (64, 128)    # GCN picks k_pad 64 and 128 at synth-arxiv
# K1's four variants: f32, a bf16 table, bf16 pass-block sums, both
K1_VARIANTS = ({}, {"table_bf16": True}, {"products_bf16": True},
               {"table_bf16": True, "products_bf16": True})


def check_k1_variants(label, a, x, t=False):
    """K1 on one direction of ``a`` under its walk split plan, in each of
    the four variants, against its plain version: in float64 at the f32
    tolerance (a bf16 table: the plain version of the rounded x), or
    (products_bf16) the f32 plain version of the same x at rtol and atol
    BF16_TOL with >= 99% of the elements at the f32 tolerance; then two
    calls bit-equal. Returns the f32 check's max abs error."""
    import torch

    from gcn_tpu_torch.ops import ell_spmm as es

    cols, vals, win, win_off, n_out, _ = k1_arrays(a, t)
    plan = k1_plan(a, t)
    err = None
    for opts in K1_VARIANTS:
        name = f"{label} {'+'.join(opts) or 'f32'}"
        got = es.ell_spmm(x, cols, vals, win, win_off, n_out, plan=plan,
                          **opts)
        xr = x.to(torch.bfloat16).float() if opts.get("table_bf16") else x
        if opts.get("products_bf16"):
            want = es._ell_spmm_plain(xr, cols, vals, win, win_off, n_out,
                                      True)
            compare(name, got, want, BF16_TOL, atol=BF16_TOL)
            same = share_within(got, want)
            if same < 0.99:
                fail(f"{name}: {100 * same:.3f}% of the elements at the f32 "
                     f"tolerance")
        else:
            e = compare(name, got, es._ell_spmm_plain(
                xr.double(), cols, vals.double(), win, win_off, n_out))
            err = e if not opts else err
    check_repeat(label, lambda: es.ell_spmm(x, cols, vals, win, win_off,
                                            n_out, plan=plan))
    return err


def walk_split_phase(dev, g, adj, serving, csr):
    """[K1 walk split]: K1's walk split plan on the main path's layout
    (no heavy window: one launch, as before the split) and on the serving
    layout (``bench.layouts``: no hub split) at k_pad 32, 64 and 128 (P =
    4, 2, 1), whose hub windows are cut across clusters; on each serving
    layout, at k = k_pad, K1 in its four variants against its plain
    version, the plan's plain sums (parts apart, then in rank order)
    against the plain version in float64 (the plan covers each pass-block
    once), and K1's time beside its plain version's, ``torch.sparse.mm``'s
    and the bound. Returns the ``kernels`` rows."""
    import torch

    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.tile.ell import ell_adjacency

    print("[K1 walk split] synth-arxiv: the main path's layout and the "
          "serving layouts (no hub split)", flush=True)
    if plan_line("main path, k_pad 32", adj).n_heavy:
        fail("the main path's layout has heavy windows")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows = []
    for kp in (32, 64, 128):
        a = serving if kp == 32 else ell_adjacency(
            g, symmetric=True, span_pass_limit=0, k_pad=kp, device=dev)
        plan = plan_line(f"serving, k_pad {kp} (P={a.p})", a)
        if a.n_hub or not (plan.n_heavy and plan.n_light):
            fail(f"the serving layout at k_pad {kp} has {a.n_hub} hub rows, "
                 f"{plan.n_heavy} heavy and {plan.n_light} light windows")
        x = torch.randn(g.shape[0], kp, device=dev, generator=gen)
        reset_launches()
        err = check_k1_variants(f"serving k_pad {kp} fwd k={kp}", a, x)
        cols, vals, win, win_off, n_out, _ = k1_arrays(a)
        compare(f"serving k_pad {kp}: the plan's plain sums (float64)",
                es._ell_spmm_plain_split(x.double(), cols, vals.double(),
                                         win_off, plan, n_out),
                es._ell_spmm_plain(x.double(), cols, vals.double(), win,
                                   win_off, n_out))
        row = k1_use(f"serving layout (no hub split), k_pad {kp}, k={kp}",
                     a, False, x, csr, ({}, {}),
                     "[K1 walk split] phase's own calls", K1_REPLACES)
        torch.cuda.synchronize()
        launches = read_launches()
        row.update(max_abs_err=err, k_pad=kp, p=a.p,
                   launches=launches[1].get(kp, 0),
                   launches_by_k=launches[1], heavy_windows=plan.n_heavy,
                   clusters=plan.clusters, walk=plan.walk,
                   unsplit_walk=int(a.win_off.diff().max()))
        rows.append(row)
        del a
    return rows


def wide_kpad_phase(dev, g, data):
    """[wide k_pad]: the layouts ``GCN`` builds at hidden 64 (k_pad 64,
    P=2) and 128 (k_pad 128, P=1) on synth-arxiv (rabbit, degree sort, the
    training default's hub split): K1 against its float64 plain version
    at the widths their fits launch (the hoist at k = k_pad, layer 2 at
    k=40), a 20-step v6 fit in both loop flavors (eager: the host counter;
    captured: kernel records under torch.profiler, bit-equal to eager), and
    K1's time at each width beside its bound and ``torch.sparse.mm``.
    Returns the ``kernels`` rows."""
    import torch

    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.tile.ell import ell_adjacency
    from gcn_tpu_torch.train.capture import WARMUP

    gen = torch.Generator(device=dev).manual_seed(SEED)
    nfeat, ncls = data.num_features, data.num_classes
    csr = g.to_torch(dev)
    rows = []
    for hidden in WIDE_HIDDENS:
        kp = hidden
        adj = ell_adjacency(g, k_pad=kp, symmetric=True, device=dev)
        print(f"[wide k_pad] k_pad {kp} (P={adj.p}): slots "
              f"{adj.cols.numel()} pad {adj.pad_fraction:.3f} n_hub "
              f"{adj.n_hub} fold steps {len(adj.hub_steps)} max blocks a "
              f"window {int(adj.win_off.diff().max())}", flush=True)
        plan_line(f"k_pad {kp}", adj)
        xs = {k: torch.randn(g.shape[0], k, device=dev, generator=gen)
              for k in (kp, 40)}
        errs = {}
        for k, x in xs.items():
            errs[k] = compare(
                f"K1 k_pad {kp} fwd k={k}",
                es.ell_spmm(x, adj.cols, adj.vals, adj.win, adj.win_off,
                            adj.row_space, plan=adj.split),
                es._ell_spmm_plain(x.double(), adj.cols, adj.vals.double(),
                                   adj.win, adj.win_off, adj.row_space))
        steps = 20
        hoist = -(-nfeat // kp)
        expected = hoist + 2 * steps + 1

        def fit(jit_loop):
            m = GCN(nfeat, hidden, ncls, variant="v6", seed=SEED,
                    device=dev)
            m.fit(data.features, data.adj, data.labels, data.idx_train,
                  train_iters=steps, jit_loop=jit_loop)
            return m

        reset_launches()
        eager = fit(False)
        torch.cuda.synchronize()
        launches = read_launches()
        if eager.adj_norm.k_pad != kp:
            fail(f"GCN at hidden {hidden} built k_pad "
                 f"{eager.adj_norm.k_pad}, not {kp}")
        reset_launches()
        cap = fit(True)
        torch.cuda.synchronize()
        host = read_launches()[0]
        _, records = kernel_records(lambda: fit(True), "ell_spmm")
        per_call = eager.adj_norm.split.launches
        print(f"  hidden {hidden}: K1 launches {launches[0]} eager "
              f"{launches[1]} (expected {expected} = {hoist} hoist + 2 x "
              f"{steps} + 1); captured {records} kernel records (expected "
              f"{expected * per_call}: {per_call} a call), {host} "
              f"host calls (expected {hoist + 2 * (WARMUP + 1) + 1}); loss "
              f"{losses_of(eager)[0]:.4f} -> {losses_of(eager)[-1]:.4f}, "
              f"test accuracy {eager.test(data.idx_test, verbose=False):.4f}",
              flush=True)
        if (launches[0] != expected or records != expected * per_call
                or host != hoist + 2 * (WARMUP + 1) + 1):
            fail(f"hidden {hidden}: K1 launches {launches}, records "
                 f"{records}, host calls {host}")
        if not losses_of(eager)[-1] < losses_of(eager)[0]:
            fail(f"hidden {hidden}: the loss did not fall")
        captured_report(f"hidden {hidden} step",
                        (losses_of(cap), cap.output),
                        (losses_of(eager), eager.output),
                        (cap.timers("step").d.median_ms,
                         eager.timers("step").d.median_ms), exact=True)
        for k, x in xs.items():
            use = "the layer-1 hoist" if k == kp else "layer 2, fwd and dX"
            row = k1_use(f"k_pad {kp}, k={k} ({use})", adj, False, x, csr,
                         launches, f"GCN v6 hidden {hidden}, {steps} "
                         f"steps (eager)", K1_REPLACES)
            row.update(max_abs_err=errs[k], k_pad=kp, p=adj.p,
                       captured_launches=records)
            rows.append(row)
        del adj
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:] == [TRAIN_GCN_FLAGS]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps(train_gcn_flags_phase()), flush=True)
        return 0
    import numpy as np

    from gcn_tpu_torch import bench
    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.csr import coo_to_csr
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.ops import _build
    from gcn_tpu_torch.ops import ell_spmm as es
    from gcn_tpu_torch.ops import panel_spmm as ps
    from gcn_tpu_torch.ops.spmm import hoist_spmm
    from gcn_tpu_torch.reorder import native, reorder_graph
    from gcn_tpu_torch.tile import panel_adjacency
    from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency
    from gcn_tpu_torch.tile.tiler import default_split_slots

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
    g_rabbit, perm_rabbit = g, perm
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

    def k1(a, x, t=False, **opts):
        if t:
            return es.ell_spmm(x, a.t_cols, a.t_vals, a.t_win, a.t_win_off,
                               a.t_row_space, plan=a.t_split, **opts)
        return es.ell_spmm(x, a.cols, a.vals, a.win, a.win_off, a.row_space,
                           plan=a.split, **opts)

    def plain(a, x, t=False, table_bf16=False, products_bf16=False,
              f64=False):
        """K1's plain version; ``f64`` evaluates it in float64, the exact
        reference of the f32 checks."""
        if table_bf16:
            x = x.to(torch.bfloat16).float()
        dt = torch.float64 if f64 else torch.float32
        if t:
            return es._ell_spmm_plain(x.to(dt), a.t_cols, a.t_vals.to(dt),
                                      a.t_win, a.t_win_off, a.t_row_space,
                                      products_bf16)
        return es._ell_spmm_plain(x.to(dt), a.cols, a.vals.to(dt), a.win,
                                  a.win_off, a.row_space, products_bf16)

    def exact(a, x, t=False, **opts):
        return plain(a, x, t, f64=True, **opts)

    print("[K1 vs plain]", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = []
    x32 = torch.randn(n, 32, device=dev, generator=gen)
    errs.append(compare("arxiv fwd k=32", k1(adj, x32), exact(adj, x32)))
    # bench.py's layouts: the serving one walks each hub row's window whole
    bench_adjs = bench.layouts(g, dev)
    walk = int(bench_adjs[0].win_off.diff().max())
    if bench_adjs[0].n_hub or walk <= adj.span_pass_limit:
        fail(f"the serving layout has {bench_adjs[0].n_hub} hub rows and "
             f"its longest walk is {walk} pass-blocks (the hub cap "
             f"{adj.span_pass_limit})")
    errs.append(compare(f"serving fwd k=32 (no hub split, walks up to "
                        f"{walk} pass-blocks)", k1(bench_adjs[0], x32),
                        exact(bench_adjs[0], x32)))
    plan_line("serving", bench_adjs[0])
    feats = torch.as_tensor(data.features[perm], device=dev)
    errs.append(compare("arxiv k=128 one launch", k1(adj, feats),
                        exact(adj, feats)))
    errs.append(compare("arxiv hoist k=128 (4 tiles)",
                        hoist_spmm(adj, feats),
                        es._hub_epilogue(exact(adj, feats), adj)))
    ct = torch.randn(n, 32, device=dev, generator=gen)
    errs.append(compare("arxiv bwd (transpose arrays)", k1(adj, ct, True),
                        exact(adj, ct, True)))
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
    errs.append(compare("rect fwd k=32", k1(radj, xr), exact(radj, xr)))
    errs.append(compare("rect bwd (transpose arrays)", k1(radj, gr, True),
                        exact(radj, gr, True)))
    xg = xr.clone().requires_grad_(True)
    es.spmm_ell(radj, xg).backward(gr)
    radj_cpu = radj.to("cpu")
    xc = xr.cpu().requires_grad_(True)
    es.spmm_ell(radj_cpu, xc).backward(gr.cpu())
    errs.append(compare("rect autograd dX, card vs cpu", xg.grad.cpu(),
                        xc.grad))
    torch.cuda.synchronize()

    print("[K1 bf16 vs plain]", flush=True)
    bf16_err = {"table_bf16": 0.0, "products_bf16": 0.0}
    for label, a, x, t in (("arxiv fwd k=32", adj, x32, False),
                           ("rect bwd (transpose arrays)", radj, gr, True)):
        o = {"table_bf16": True}
        bf16_err["table_bf16"] = max(bf16_err["table_bf16"], compare(
            f"table_bf16 {label}", k1(a, x, t, **o), exact(a, x, t, **o)))
        o = {"products_bf16": True}
        got, want = k1(a, x, t, **o), plain(a, x, t, **o)
        bf16_err["products_bf16"] = max(bf16_err["products_bf16"], compare(
            f"products_bf16 {label}", got, want, BF16_TOL, atol=BF16_TOL))
        check_rounds(f"products_bf16 {label}", got, want, k1(a, x, t))
    torch.cuda.synchronize()

    print("[K1 redesign cases] synth-arxiv forward", flush=True)
    blocks = adj.win_off.diff()
    print(f"  pass-blocks a window: max {int(blocks.max())} (the hub cap "
          f"{adj.span_pass_limit}), min {int(blocks.min())}, "
          f"{int((blocks == 1).sum())} windows of one", flush=True)
    if int(blocks.max()) > adj.span_pass_limit:
        fail("a window of the hub-split layout passes the hub cap")
    views = {"k=1": x32[:, :1].contiguous(), "k=4": x32[:, :4].contiguous(),
             "k=33": torch.randn(n, 33, device=dev, generator=gen),
             "k=200": torch.randn(n, 200, device=dev, generator=gen),
             "row stride 36, read in place":
                 torch.randn(n, 36, device=dev, generator=gen)[:, :32],
             "row stride 33, copied":
                 torch.randn(n, 33, device=dev, generator=gen)[:, :32],
             "unaligned base, copied": torch.randn(
                 n * 32 + 1, device=dev, generator=gen)[1:].view(n, 32)}
    for label, x in views.items():
        errs.append(compare(label, k1(adj, x), exact(adj, x)))
    for opts in ({}, {"table_bf16": True}, {"products_bf16": True}):
        check_repeat(f"K1 {next(iter(opts), 'f32')}",
                     lambda: k1(adj, x32, **opts))
    torch.cuda.synchronize()

    max_abs_err = max(errs)

    # ---- 4. K1 timing at the main path's shape ---------------------------
    print("[K1 timing] synth-arxiv forward, k=32", flush=True)
    k1_ms = chain_ms(lambda x: k1(adj, x), x32, 30, n)
    plain_ms = chain_ms(lambda x: plain(adj, x), x32, 5, n)
    csr = g.to_torch(dev)
    lib_ms = chain_ms(lambda x: torch.sparse.mm(csr, x), x32, 30, n)
    lib_diff = (es._hub_epilogue(k1(adj, x32), adj)
                - torch.sparse.mm(csr, x32)).abs().max().item()
    print(f"  torch.sparse.mm vs K1 + epilogue: max abs diff {lib_diff:.3e}")
    bf16_ms = {}
    for option in ("table_bf16", "products_bf16"):
        o = {option: True}
        bf16_ms[option] = (
            chain_ms(lambda x: k1(adj, x, **o), x32, 30, n),
            chain_ms(lambda x: plain(adj, x, **o), x32, 5, n))
    print(f"  K1 {k1_ms:.4f} ms | plain {plain_ms:.4f} ms | "
          f"torch.sparse.mm (CSR) {lib_ms:.4f} ms", flush=True)
    for option, (ms, pms) in bf16_ms.items():
        note = " (the cast of x included)" if option == "table_bf16" else ""
        print(f"  K1 {option} {ms:.4f} ms{note} | plain {pms:.4f} ms",
              flush=True)
    bound_ms, bound_by = k1_bound(adj, 32)
    print(f"  K1 at {100 * bound_ms / k1_ms:.1f}% of the bound "
          f"(by {bound_by})", flush=True)
    fold_ms = hub_fold_phase(dev, adj, x32, ct)
    split_rows = walk_split_phase(dev, g, adj, bench_adjs[0], csr)

    # ---- 5. K2 against its plain version, against K1, and its time -------
    t0 = time.time()
    padj = panel_adjacency(g, symmetric=True, device=dev)
    wblocks = padj.win_off.diff()
    top = sorted(wblocks.tolist(), reverse=True)[:8]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split_slots = default_split_slots(padj.win_off.cpu().numpy(), padj.nb,
                                      sms)
    print(f"[panel] synth-arxiv windows={padj.win_off.numel() - 1} "
          f"blocks={padj.num_blocks} slots={padj.cols.numel()} "
          f"pad={padj.pad_fraction:.3f} max blocks/window="
          f"{int(wblocks.max())} ({time.time() - t0:.1f}s); largest "
          f"windows (blocks) {top}; split threshold {split_slots} "
          f"slots ({sms} SMs): {padj.heavy.numel()} heavy windows "
          f"{padj.heavy.tolist()[:8]}, {padj.light.numel()} light",
          flush=True)

    def k2(a, x, t=False):
        if t:
            return ps.panel_spmm(x, a.t_cols, a.t_vals, a.t_local_row,
                                 a.t_row_base, a.t_win_off, a.r, a.n_cols,
                                 a.t_plan)
        return ps.panel_spmm(x, a.cols, a.vals, a.local_row, a.row_base,
                             a.win_off, a.r, a.n_rows, a.plan)

    def plain2(a, x, t=False, f64=False):
        """K2's plain version; ``f64`` evaluates it in float64."""
        dt = torch.float64 if f64 else torch.float32
        if t:
            return ps._panel_spmm_plain(x.to(dt), a.t_cols, a.t_vals.to(dt),
                                        a.t_local_row, a.t_row_base, a.r,
                                        a.n_cols)
        return ps._panel_spmm_plain(x.to(dt), a.cols, a.vals.to(dt),
                                    a.local_row, a.row_base, a.r, a.n_rows)

    def exact2(a, x, t=False):
        return plain2(a, x, t, f64=True)

    print("[K2 vs plain]", flush=True)
    errs2 = [compare("arxiv fwd k=32", k2(padj, x32), exact2(padj, x32)),
             compare("arxiv fwd k=128", k2(padj, feats),
                     exact2(padj, feats)),
             compare("arxiv hoist k=128 (4 chunks)", hoist_spmm(padj, feats),
                     exact2(padj, feats))]
    rpadj = panel_adjacency(rg, device=dev)
    if rpadj.symmetric or int(rpadj.win_off[:2].diff()) < 2:
        fail("rectangular panel graph lost its asymmetry or multi-block "
             "window")
    errs2.append(compare("rect fwd k=32", k2(rpadj, xr), exact2(rpadj, xr)))
    errs2.append(compare("rect transpose arrays", k2(rpadj, gr, True),
                         exact2(rpadj, gr, True)))
    ne = 50_000
    src = np.concatenate([rng.integers(0, 10_000, 150_000),
                          rng.integers(10_500, ne, 600_000)])
    eg = coo_to_csr(src, rng.integers(0, ne, src.shape[0]),
                    rng.random(src.shape[0]), (ne, ne))
    epadj = panel_adjacency(eg, device=dev)
    lr = epadj.local_row.cpu().numpy()
    off = epadj.win_off.cpu().numpy()
    if all((lr[off[w]:off[w + 1]] < epadj.r).any()
           for w in range(off.shape[0] - 1)):
        fail("edgeless-window graph has no window of zeros")
    xe = torch.randn(ne, 32, device=dev, generator=gen)
    errs2.append(compare("edgeless windows fwd k=32", k2(epadj, xe),
                         exact2(epadj, xe)))
    xg = xr.clone().requires_grad_(True)
    ps.spmm_panel(rpadj, xg).backward(gr)
    xc = xr.cpu().requires_grad_(True)
    ps.spmm_panel(rpadj.to("cpu"), xc).backward(gr.cpu())
    errs2.append(compare("rect autograd dX, card vs cpu", xg.grad.cpu(),
                         xc.grad))
    print("[K2 redesign cases] synth-arxiv forward, k=32", flush=True)
    for limit in (0, 1 << 30):
        sadj = with_split(padj, limit)
        label = (f"split threshold {limit}: {sadj.heavy.numel()} heavy "
                 f"windows")
        if limit == 0:
            cross, pad_only = split_features(sadj)
            label += (f", {cross} runs across part boundaries, {pad_only} "
                      f"parts of padding only")
            if not cross or not pad_only:
                fail("the split check lacks boundary runs or padding parts")
        errs2.append(compare(label, k2(sadj, x32), exact2(padj, x32)))
    for label in ("row stride 33, copied", "unaligned base, copied"):
        x = views[label]
        errs2.append(compare(label, k2(padj, x), exact2(padj, x)))
    check_repeat("K2", lambda: k2(padj, x32))
    print("[K2 vs K1] synth-arxiv, same graph and x", flush=True)
    errs2.append(compare("K2 vs K1 + hub epilogue, k=32", k2(padj, x32),
                         es._hub_epilogue(k1(adj, x32), adj)))
    torch.cuda.synchronize()
    max_abs_err2 = max(errs2)
    print("[K2 timing] synth-arxiv forward, k=32", flush=True)
    k2_ms = chain_ms(lambda x: k2(padj, x), x32, 30, n)
    plain2_ms = chain_ms(lambda x: plain2(padj, x), x32, 5, n)

    def k2_split_ms(a):
        """K2's heavy-window launch and its light one, each alone (the
        other's rows are left unwritten), in ms."""
        heavy, parts, light = a.plan

        def launch(x, plan):
            return ps._panel_spmm_kernel(x, a.cols, a.vals, a.local_row,
                                         a.win_off, a.r, n, plan)

        return (chain_ms(lambda x: launch(x, (heavy, parts, light[:0])),
                         x32, 30, n),
                chain_ms(lambda x: launch(x, (heavy[:0], parts[:0], light)),
                         x32, 30, n))

    heavy_ms, light_ms = k2_split_ms(padj)
    print(f"  K2 {k2_ms:.4f} ms: heavy-window launch {heavy_ms:.4f} ms "
          f"({padj.heavy.numel()} windows x 8 CTAs), light launch "
          f"{light_ms:.4f} ms ({padj.light.numel()} windows) | plain "
          f"{plain2_ms:.4f} ms | torch.sparse.mm (CSR) {lib_ms:.4f} ms",
          flush=True)
    bound2_ms, bound2_by = k2_bound(padj, n, 32)
    print(f"  K2 at {100 * bound2_ms / k2_ms:.1f}% of the bound "
          f"(by {bound2_by})", flush=True)

    # ---- 6. 5-step fit, card against CPU, same parameters ----------------
    print("[fit 5 steps, dropout 0] card vs cpu", flush=True)
    nfeat, nhid, ncls = data.num_features, 32, data.num_classes
    p0 = params_to_numpy(GCN(nfeat, nhid, ncls, seed=SEED,
                             device="cpu").init_params())
    hist = {}
    bf16_launches = {}
    runs = (("cuda", {}), ("cpu", {}), ("table_bf16", {"table_bf16": True}),
            ("products_bf16", {"products_bf16": True}))
    for name, opts in runs:
        device = "cpu" if name == "cpu" else "cuda"
        t0 = time.time()
        m = GCN(nfeat, nhid, ncls, dropout=0.0, variant="v6", seed=SEED,
                adj_options=opts, device=device)
        m.params = params_from_numpy(p0, device)
        es.spmm_ell_launches = 0
        # the eager flavor: the host counter counts every K1 launch
        m.fit(data.features, data.adj, data.labels, data.idx_train,
              train_iters=5, initialize=False, jit_loop=False)
        bf16_launches[name] = es.spmm_ell_launches
        hist[name] = [h["loss_train"] for h in m.history]
        print(f"  {name}: losses {hist[name]} ({bf16_launches[name]} K1 "
              f"launches, {time.time() - t0:.1f}s)", flush=True)
    lc, lp = np.array(hist["cuda"]), np.array(hist["cpu"])
    if not np.allclose(lc, lp, rtol=1e-4, atol=0):
        fail(f"card and cpu losses disagree: {lc} vs {lp}")
    print(f"  max rel diff {np.max(np.abs(lc - lp) / np.abs(lp)):.2e} "
          f"(rtol 1e-4) ok", flush=True)
    for option in ("table_bf16", "products_bf16"):
        lb = np.array(hist[option])
        if not np.allclose(lb, lc, rtol=BF16_TOL, atol=0):
            fail(f"{option} losses disagree with f32: {lb} vs {lc}")
        if bf16_launches[option] != 4 + 2 * 5 + 1:
            fail(f"{option}: {bf16_launches[option]} K1 launches, "
                 f"expected 15")
        print(f"  {option} vs f32 on the card: max rel diff "
              f"{np.max(np.abs(lb - lc) / np.abs(lc)):.2e} (rtol "
              f"{BF16_TOL}) ok", flush=True)

    # ---- 7. the main path ------------------------------------------------
    steps = 20
    print(f"[main path] GCN v6 fit, {steps} steps, hidden {nhid}, "
          f"dropout 0.5, seed {SEED}, the eager flavor (jit_loop=False: "
          f"the host counter counts every K1 launch; the default captured "
          f"flavor is the [captured fit] phase's)", flush=True)
    model = GCN(nfeat, nhid, ncls, variant="v6", seed=SEED, device="cuda")
    t0 = time.time()
    es.spmm_ell_launches = 0
    model.fit(data.features, data.adj, data.labels, data.idx_train,
              train_iters=steps, jit_loop=False)
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

    # ---- 8. the panel path -----------------------------------------------
    print("[panel path] functional fit over PanelAdj, same reordered graph",
          flush=True)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    labels = torch.as_tensor(data.labels[perm], device=dev)
    idx_train = torch.as_tensor(inv[np.asarray(data.idx_train)], device=dev)
    es.spmm_ell_launches = ps.spmm_panel_launches = 0
    pfeats = hoist_spmm(padj, feats)
    res = panel_fit(params_from_numpy(p0, dev), pfeats, padj, labels,
                    idx_train, 5, 0.0, dev, jit_loop=False)
    lpan = np.array([h["loss_train"] for h in res.history])
    if not np.allclose(lpan, lc, rtol=1e-4, atol=0):
        fail(f"panel and ELL path losses disagree: {lpan} vs {lc}")
    print(f"  5 steps, dropout 0: losses {lpan.tolist()}; max rel diff to "
          f"the ELL path {np.max(np.abs(lpan - lc) / np.abs(lc)):.2e} "
          f"(rtol 1e-4) ok", flush=True)
    init = GCN(nfeat, nhid, ncls, seed=SEED, device=dev).init_params()
    t0 = time.time()
    es.spmm_ell_launches = ps.spmm_panel_launches = 0
    pfeats = hoist_spmm(padj, feats)
    # the eager flavor: the host counter counts every K2 launch
    res = panel_fit(init, pfeats, padj, labels, idx_train, steps, 0.5, dev,
                    jit_loop=False)
    panel_eager = res
    torch.cuda.synchronize()
    launches2, k1_in_panel = ps.spmm_panel_launches, es.spmm_ell_launches
    plosses = [h["loss_train"] for h in res.history]
    pout = res.log_probs
    idx_test = torch.as_tensor(inv[np.asarray(data.idx_test)], device=dev)
    pacc = (pout[idx_test].argmax(1) == labels[idx_test]).float().mean()
    print(f"  {steps} steps, dropout 0.5, seed {SEED}: losses first "
          f"{plosses[0]:.6f} last {plosses[-1]:.6f}; fit "
          f"{time.time() - t0:.2f}s; median step "
          f"{res.timers('step').d.median_ms:.3f} ms (last "
          f"{res.timers('step').d.count} steps); test accuracy "
          f"{pacc.item():.4f}", flush=True)
    print(f"  K2 launches on the panel path: {launches2} (expected "
          f"{expected} = 4 hoist + 2 x {steps} steps + 1 eval); K1 "
          f"launches: {k1_in_panel}", flush=True)
    if launches2 != expected or k1_in_panel != 0:
        fail(f"panel path: K2 launched {launches2} times (expected "
             f"{expected}), K1 {k1_in_panel} times (expected 0)")
    if not plosses[-1] < plosses[0]:
        fail(f"panel path loss did not fall: {plosses[0]} -> {plosses[-1]}")
    if tuple(pout.shape) != (n, ncls) or not torch.isfinite(pout).all():
        fail(f"panel output shape {tuple(pout.shape)} or values not finite")
    pnorm = torch.logsumexp(pout, dim=1).abs().max().item()
    if pnorm > 1e-4:
        fail(f"panel log-probs are not normalized ({pnorm:.2e})")

    # ---- [captured fit]: the default loop flavor -------------------------
    captured = captured_gcn_phase(
        dev, data, model, (lambda: hoist_spmm(padj, feats), padj, labels,
                           idx_train, init, panel_eager))

    wide_rows = wide_kpad_phase(dev, g, data)
    ladder_phase(dev, data, p0)

    # ---- 9. where a v6 step's time goes ----------------------------------
    profile_steps(model, data.idx_train, 10)

    # ---- 10.-13. resumable state, the frequency split, sharded, HGNN ------
    gcn_resume_phase(dev, data, losses)
    freq_rows = freq_phases(dev, g, data, p0, hist["cuda"], adj)
    dist_rows = dist_phases(dev, data, g_rabbit, perm_rabbit, p0, k1_ms)
    hgnn_rows = hgnn_phases(dev)
    order_rows = orders_phase(dev, data)
    bench_phase(dev, data, g, perm, bench_adjs, x32, k1_ms, fold_ms[0])
    train_gcn_flags_in_child(order_rows)
    print(f"[done] {time.time() - t_start:.1f}s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "ell_spmm",
        "route": "cuda",
        "source": "gcn_tpu_torch/ops/csrc/ell_spmm.cu",
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
        "table_bf16_ms": bf16_ms["table_bf16"][0],
        "table_bf16_plain_ms": bf16_ms["table_bf16"][1],
        "table_bf16_max_abs_err": bf16_err["table_bf16"],
        "table_bf16_launches": bf16_launches["table_bf16"],
        "products_bf16_ms": bf16_ms["products_bf16"][0],
        "products_bf16_plain_ms": bf16_ms["products_bf16"][1],
        "products_bf16_max_abs_err": bf16_err["products_bf16"],
        "products_bf16_launches": bf16_launches["products_bf16"],
        "captured_launches": captured["main"][0],
        "captured_host_calls": captured["main"][1],
        "hub_fold_ms": fold_ms[0],
        "index_add_fold_ms": fold_ms[1],
    }, {
        "name": "panel_spmm",
        "route": "cuda",
        "source": "gcn_tpu_torch/ops/csrc/panel_spmm.cu",
        "replaces": "gcn_tpu/ops/panel_spmm.py:66",
        "launches": launches2,
        "max_abs_err": max_abs_err2,
        "ms": k2_ms,
        "plain_ms": plain2_ms,
        "bound_ms": bound2_ms,
        "bound_by": bound2_by,
        "library_ms": lib_ms,
        "heavy_ms": heavy_ms,
        "light_ms": light_ms,
        "heavy_windows": padj.heavy.numel(),
        "captured_launches": captured["panel"][0],
        "captured_host_calls": captured["panel"][1],
    }] + split_rows + wide_rows + hgnn_rows + freq_rows + dist_rows
        + order_rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
