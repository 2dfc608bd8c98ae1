"""Timing on the card: the port's counterpart of ``bench.py``'s protocol.

gcn_tpu times a chained ``fori_loop`` behind a scalar readback and
subtracts a measured round trip (``bench.py:44`` ``_sync_overhead``,
``:55`` ``bench_spmm``, ``:174`` ``_gather_ns_per_row``, ``:190``
``bench_train_step``). On the card the method is:

  * the calls are queued behind a ~0.1 s spin kernel
    (``torch.cuda._sleep``), so the host is done enqueueing before the
    card reaches them and the events read device time, not the wrapper's
    Python time (a call under ~0.1 ms is otherwise paced by the host);
  * CUDA events around each call; the median of the calls;
  * a chained call reads the first rows of the previous call's output, so
    no call can start before the one it depends on;
  * a training step is the captured step (``jit_loop=True``) replayed,
    timed by CUDA events between replays (``train/capture.py``), or the
    eager step between events.

Nothing is subtracted: ``event_floor_ms`` reports what an empty pair of
events reads, the counterpart of ``_sync_overhead``. The timing functions
run on a CUDA device only; ``on_device_ms`` is the scripts' entry, which
on the CPU runs the call once and returns no time. ``smi_line`` needs
``nvidia-smi``. The bounds (``spmm_work``, ``bound_ms``) are the H100's
data-sheet rates.
"""

from __future__ import annotations

import statistics
import subprocess

# cycles of the spin kernel the timed calls queue behind: ~0.1 s on an H100
SPIN_CYCLES = 200_000_000
WARMUP_CALLS = 3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def smi_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out[0]


def spmm_work(nnz: int, n_win_off: int, n_in: int, n_out: int, k: int):
    """(bytes, flops) an SpMM over ``nnz`` stored edges needs: 8 B an edge
    (its column and value; padding slots are layout, not work), the
    ``n_win_off`` window offsets, x's ``n_in`` rows read once and the
    ``n_out`` rows written once, at width k; 2 flop an edge and column."""
    return (nnz * 8 + n_win_off * 4 + n_in * k * 4 + n_out * k * 4,
            2 * nnz * k)


def bound_ms(bytes_moved: float, flops: float):
    """The least time of work that moves ``bytes_moved`` and does
    ``flops`` f32 operations on an H100: (ms, "bytes" | "operations"),
    the larger of the two over the HBM rate and the f32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _timed(call, reps: int, spin: bool = True) -> float:
    """Median ms of ``reps`` calls of ``call(i)`` between CUDA events,
    queued behind the spin kernel when ``spin``."""
    import torch

    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    for i, (start, end) in enumerate(events):
        start.record()
        call(i)
        end.record()
    torch.cuda.synchronize()
    return float(statistics.median(s.elapsed_time(e) for s, e in events))


def chain_ms(fn, x, reps: int = 30, n_out_rows: int = None,
             spin: bool = True) -> float:
    """Median ms per call of ``reps`` chained calls of ``fn``, each fed
    the first ``n_out_rows`` rows (default: x's) of the previous output
    (``bench_spmm``'s counterpart). ``spin=False`` records the events as
    the host issues the calls, so a call shorter than its wrapper's Python
    time reads the host's pace."""
    import torch

    for _ in range(WARMUP_CALLS):
        fn(x)
    torch.cuda.synchronize()
    rows = x.shape[0] if n_out_rows is None else n_out_rows
    cur = [x]

    def call(_):
        cur[0] = fn(cur[0])[:rows]

    return _timed(call, reps, spin)


def device_ms(fn, reps: int = 30) -> float:
    """Median ms of ``reps`` calls of ``fn()`` on the same inputs, queued
    behind the spin kernel: for calls whose output cannot feed the next
    (a part's output is shorter than its input)."""
    import torch

    for _ in range(WARMUP_CALLS):
        fn()
    torch.cuda.synchronize()
    return _timed(lambda _: fn(), reps)


def event_floor_ms(reps: int = 30) -> float:
    """What a pair of CUDA events around nothing reads behind the spin
    kernel: the floor every time here carries (``_sync_overhead``'s
    counterpart; reported, not subtracted)."""
    return _timed(lambda _: None, reps)


def gather_chain(n: int, k: int, dtype=None, seed: int = 0,
                 idx_len: int = 2_000_000, device="cuda"):
    """``(step, x0, rows)``: one call of the chained row gather plus stride
    sum, ``x' = sum_j x[idx[j]]`` over ``stride = min(8, idx_len // n)``
    index rows of n each (gcn_tpu's ``bench_chained_gather``), on an (n, k)
    table of ``dtype`` (float32 by default; bfloat16 is summed in float32
    and fed back as bfloat16); ``rows`` gathered a call."""
    import numpy as np
    import torch

    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    stride = min(8, max(1, idx_len // n))
    x0 = torch.tensor(rng.standard_normal((n, k)).astype(np.float32) * 0.01,
                      device=device).to(dtype)
    idx = torch.tensor(rng.integers(0, n, (stride, n)), device=device)

    def step(acc):
        out = acc[idx[0]].float()
        for j in range(1, stride):
            out = out + acc[idx[j]].float()
        return (out * 0.999).to(dtype)

    return step, x0, stride * n


def gather_ns_per_row(n: int, k: int, dtype=None, reps: int = 30,
                      seed: int = 0, idx_len: int = 2_000_000,
                      device="cuda") -> float:
    """ns per gathered row of ``gather_chain``'s chain
    (``bench.py::_gather_ns_per_row``'s counterpart)."""
    step, x0, rows = gather_chain(n, k, dtype, seed, idx_len, device)
    return chain_ms(step, x0, reps) * 1e6 / rows


def stream_gb_per_s(mb: int = 512, reps: int = 20, device="cuda") -> float:
    """The stream rate of a chained ``y = y * c + d`` over an ``mb``-MB
    float32 buffer, in GB/s (1e9 B/s): one kernel a call (``torch.lerp``
    toward a constant, ``y + w (e - y)``), which reads the buffer once and
    writes it once."""
    import torch

    y0 = torch.ones(mb * 1024 * 1024 // 4, device=device)
    end = torch.full((), 1e-3, device=device)
    ms = chain_ms(lambda y: torch.lerp(y, end, 1e-4), y0, reps)
    return 2 * mb * 1024 * 1024 / (ms * 1e-3) / 1e9


def train_step_fit(adj, feats, labels, idx_train, nhid: int, nclass: int,
                   steps: int = 20, jit_loop: bool = True,
                   weight_decay: float = 5e-4, seed: int = 0,
                   orders=("xw", "ax_w"), params=None):
    """The fit ``train_step_ms`` times (``fit_gcn``'s result): ``steps``
    GCN training steps (forward, masked NLL, backward, Adam with L2 decay;
    dropout 0) from ``params`` (a seeded ``init_gcn_params`` draw by
    default), with ``orders`` the layers' contraction orders."""
    import torch

    from gcn_tpu_torch.models.gcn_core import gcn_forward, init_gcn_params
    from gcn_tpu_torch.train.loop import fit_gcn
    from gcn_tpu_torch.train.optim import adam_l2

    if params is None:
        params = init_gcn_params(torch.Generator().manual_seed(seed),
                                 feats.shape[1], nhid, nclass,
                                 device=feats.device)

    def forward(p, train):
        return gcn_forward(p, feats, adj, orders=orders, dropout_rate=0.0,
                           train=train)

    return fit_gcn(params, lambda ps: adam_l2(ps, 0.01, weight_decay),
                   forward, labels, idx_train, train_iters=steps,
                   mode="no_val", jit_loop=jit_loop)


def train_step_ms(adj, feats, labels, idx_train, nhid: int, nclass: int,
                  steps: int = 20, jit_loop: bool = True,
                  weight_decay: float = 5e-4, seed: int = 0,
                  orders=("xw", "ax_w")) -> float:
    """Median ms of a GCN training step (``train_step_fit``),
    ``bench.py::bench_train_step``'s counterpart: ``feats`` is the layer-1
    input, raw features with ``orders=("a_xw", "ax_w")`` (4 SpMMs a step)
    or A @ X with the default ``("xw", "ax_w")`` (layer 1 a plain product,
    2 SpMMs); layer 2 contracts (A h) W at k = nhid. ``jit_loop``: the
    captured step replayed (CUDA events between replays), else eager
    steps between events; the median skips the fit's warm-up steps in
    both flavors."""
    res = train_step_fit(adj, feats, labels, idx_train, nhid, nclass, steps,
                         jit_loop, weight_decay, seed, orders)
    return res.timers("step").d.median_ms


def on_device_ms(device, fn, x=None, reps: int = 30, n_out_rows=None):
    """A script's timing call on ``device``: ``chain_ms`` (or, without
    ``x``, ``device_ms``) on a CUDA device; on the CPU one call, which
    rehearses the path, and None, since a CPU run gives no device time."""
    import torch

    if torch.device(device).type != "cuda":
        with torch.no_grad():
            fn() if x is None else fn(x)
        return None
    with torch.no_grad():
        if x is None:
            return device_ms(fn, reps)
        return chain_ms(fn, x, reps, n_out_rows)


def stamp(device) -> dict:
    """Where a script's numbers come from: the card's name and power limit
    (``smi_line``) and torch's version, or the CPU."""
    import torch

    dev = torch.device(device)
    meta = {"device": dev.type, "torch": torch.__version__}
    if dev.type == "cuda":
        meta.update(card=smi_line(), kind=torch.cuda.get_device_name(dev),
                    cuda=torch.version.cuda)
    return meta


def covered(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals: time that
    two streams are both busy counts once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_busy(step, steps: int = 10, needles=("ell_spmm",),
                top: int = 0) -> dict:
    """``step`` run 3 times, then ``steps`` times under torch.profiler:
    the wall ms a step (the profiler's own host cost included), the device
    busy ms a step (the union of its kernels', copies' and sets' intervals,
    so overlapping streams count once), their ratio ``busy_share``, the
    device activities a step, the device ms a step of the kernels whose
    name holds one of ``needles`` (K1's by default) and, with ``top``, the
    ``top`` kernels that take most device time ([ms a step, name]). On the
    card only."""
    import time

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
    intervals, by_name = [], {}
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        intervals.append((evt.time_range.start, evt.time_range.end))
        by_name[evt.name] = (by_name.get(evt.name, 0.0)
                             + evt.time_range.elapsed_us() / 1e3)
    busy = covered(intervals) / 1e3
    kernel = sum(ms for name, ms in by_name.items()
                 if any(s in name for s in needles))
    out = {"wall_ms": wall_ms / steps, "busy_ms": busy / steps,
           "busy_share": busy / wall_ms if wall_ms else 0.0,
           "activities": len(intervals) / steps,
           "kernel_ms": kernel / steps}
    if top:
        most = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        out["top"] = [[round(ms / steps, 5), name[:100]]
                      for name, ms in most]
    return out
