"""The program's spans and call counters (``gcn_tpu_torch.utils.timers``)
read per fit, and the device's idle time under the spans of a traced fit.

A run's record holds the window's spans under ``program_spans``: one dict
a finished span (``name``, ``id``, ``fit``, ``parent``, ``start_ns``,
``end_ns``, ``attrs``, ``counts``), as ``records`` makes them from
``recording()``. Each fit is a ``fit`` span whose children ``fit.prepare``,
``fit.loop`` and ``fit.finish`` tile it; inside ``fit.loop``,
``loop.warmup``, ``loop.capture`` and ``loop.replay``, and after the
replays the wait for the device (``drain``: ``fit.loop`` less its
children). Under ``torch.profiler`` the same spans are host events on the
profiler's clock, so the device's idle gaps of a traced fit
(``trace.read``) fall under them (``idle_under``).
"""

from __future__ import annotations

import dataclasses
import re
import statistics

import torch

FIT = "fit"
LOOP = ("loop.warmup", "loop.capture", "loop.replay")
PHASES = ("fit.prepare",) + LOOP + ("drain", "fit.finish")
# a call counter of the SpMM: "spmm_ell", "spmm_panel", "spmm_coo"; the
# per-width "spmm_ell_k<k>" repeat "spmm_ell"
_SPMM = re.compile(r"^spmm_[a-z]+$")


def records(spans) -> list:
    """The spans of a ``recording()`` as plain dicts."""
    return [dataclasses.asdict(s) for s in spans]


def _ms(s) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def per_fit(spans) -> list:
    """One dict a fit, in order: ``fit`` and each phase of ``PHASES`` in
    ms (0 where the fit has no such span)."""
    fits = {}
    for s in spans or ():
        if s["fit"] is not None:
            fits.setdefault(s["fit"], []).append(s)
    out = []
    for fid in sorted(fits):
        ms = {}
        for s in fits[fid]:
            ms[s["name"]] = ms.get(s["name"], 0.0) + _ms(s)
        if FIT not in ms:
            continue
        row = {name: ms.get(name, 0.0) for name in (FIT,) + PHASES}
        row["drain"] = ms.get("fit.loop", 0.0) - sum(ms.get(n, 0.0)
                                                    for n in LOOP)
        out.append(row)
    return out


def median_ms(spans) -> dict:
    """Each phase's median ms a fit; {} without a fit."""
    fits = per_fit(spans)
    if not fits:
        return {}
    return {name: statistics.median(f[name] for f in fits)
            for name in (FIT,) + PHASES}


def median_share(spans, names) -> float:
    """The median over the fits of the phases ``names`` over ``fit``, in
    %; None without a fit."""
    fits = [f for f in per_fit(spans) if f[FIT] > 0]
    if not fits:
        return None
    return statistics.median(100.0 * sum(f[n] for n in names) / f[FIT]
                             for f in fits)


def calls_per_iter(spans) -> float:
    """The SpMM's host calls an iteration: the ``spmm_*`` counts (not the
    per-width ones) of the ``loop.capture`` spans, each one captured
    iteration, over their number; None without a capture."""
    captures = [s for s in spans or () if s["name"] == "loop.capture"]
    if not captures:
        return None
    return sum(n for s in captures for name, n in s["counts"].items()
               if _SPMM.match(name)) / len(captures)


def idle_under(events, gaps, names=LOOP) -> dict:
    """{name: [idle s, length s]} of each span in ``names`` that the
    profiler's ``events`` hold as host events: the parts of the device's
    idle ``gaps`` ((start, end) on the profiler's clock, us) that lie
    inside the span's ranges, and the ranges' length."""
    out = {}
    for e in events:
        if (e.name not in names
                or e.device_type != torch.autograd.DeviceType.CPU):
            continue
        s, t = e.time_range.start, e.time_range.end
        idle = sum(max(0.0, min(t, b) - max(s, a)) for a, b in gaps)
        prev = out.get(e.name, [0.0, 0.0])
        out[e.name] = [prev[0] + idle / 1e6, prev[1] + (t - s) / 1e6]
    return out
