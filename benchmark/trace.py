"""One whole fit under ``torch.profiler``: the device's busy time as the
union of its activities' intervals (overlapping streams count once), the
traced window's length, the device operations that took most time and
the longest idle gaps, each named by the host operation under way.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

WINDOW = "benchmark.traced_fit"
TOP = 10


def profile(run) -> dict:
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            run()
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = read(prof.events())
    del prof
    gc.collect()
    out["read_s"] = time.perf_counter() - t0
    return out


def _is_device(evt) -> bool:
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False))


def read(events) -> dict:
    window = [e for e in events if e.name == WINDOW
              and e.device_type == torch.autograd.DeviceType.CPU]
    if not window:
        raise RuntimeError("the traced window left no host record")
    ws, we = window[0].time_range.start, window[0].time_range.end
    dev, by_name = [], {}
    cpu_s, cpu_e, cpu_n = [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if _is_device(e):
            s, t = max(s, ws), min(t, we)
            if t > s:
                dev.append((s, t))
                by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
        elif e.device_type == torch.autograd.DeviceType.CPU \
                and e.name != WINDOW:
            cpu_s.append(s)
            cpu_e.append(t)
            cpu_n.append(e.name)
    dev.sort()
    busy, gaps, cur_s, cur_e = 0.0, [], None, ws
    edge = ws
    for s, t in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > edge:
                gaps.append((edge, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
        edge = cur_e
    if cur_s is not None:
        busy += cur_e - cur_s
    if we > edge:
        gaps.append((edge, we))
    cpu_s, cpu_e = np.asarray(cpu_s), np.asarray(cpu_e)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    idle = []
    for a, b in longest:
        mid = 0.5 * (a + b)
        under = np.flatnonzero((cpu_s <= mid) & (cpu_e >= mid))
        name = "(no host operation)"
        if under.size:
            name = cpu_n[under[np.argmin(cpu_e[under] - cpu_s[under])]]
        idle.append([name, (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy / 1e6, "window_s": (we - ws) / 1e6,
            "device_ops": [[name[:160], us / 1e6] for name, us in ops],
            "idle_gaps": idle, "device_activities": len(dev)}
