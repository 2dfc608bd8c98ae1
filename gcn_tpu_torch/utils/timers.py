"""Named accumulating timers.

The port of ``gcn_tpu.utils.timers`` with the same surface:

  * ``timers('name').h`` — host time (on the card: enqueue time only);
  * ``timers('name').d`` — device time: CUDA events around the region on a
    CUDA device (the end event is waited for on exit), the host clock on
    the CPU. ``t.fence(x)`` marks the region's result, as in gcn_tpu.

Each timer also keeps its per-call samples, so a median can be read.
``Marks`` stamps a loop's iterations on the device's stream without waiting
for it, for loops that must not stop the host each iteration: HGNN's
epochs in both loop flavors, and a captured fit's replays
(``train/capture.py``), whose intervals become the samples of the "step"
timer (``Timer.add``) beside the ``fit_scan`` timer of the whole loop, so
that step and epoch medians read alike in both flavors.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

import torch


class Timer:
    """Accumulating timer (ms); CUDA events when ``cuda`` is set."""

    def __init__(self, name: str = "", cuda: bool = False):
        self.name = name
        self.cuda = cuda
        self.samples: List[float] = []
        self._t0: Optional[int] = None
        self._start = None

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.samples.append(self._start.elapsed_time(end))
            self._start = None
        else:
            self.samples.append((time.perf_counter_ns() - self._t0) / 1e6)
            self._t0 = None
        return False

    def fence(self, value):
        """Mark the region's result; the device timer waits for the whole
        stream on exit, which covers it."""
        return value

    def add(self, samples) -> None:
        """Add samples (ms) measured elsewhere: the time between a captured
        loop's replays (``Marks``)."""
        self.samples.extend(float(v) for v in samples)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def total_ms(self) -> float:
        return float(sum(self.samples))

    @property
    def avg_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    @property
    def median_ms(self) -> float:
        return statistics.median(self.samples) if self.samples else 0.0

    def reset(self):
        self.samples = []


class _Named:
    """Accessor returned by Timers(name): host vs device timing."""

    def __init__(self, host: Timer, dev: Timer):
        self.h = host
        self.d = dev


class Timers:
    """Dict of named host/device timer pairs. ``device`` sets what ``.d``
    measures: CUDA events on a CUDA device, the host clock otherwise."""

    def __init__(self, device=None):
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._host: Dict[str, Timer] = {}
        self._dev: Dict[str, Timer] = {}

    def __call__(self, name: str) -> _Named:
        if name not in self._host:
            self._host[name] = Timer(name + ".h")
            self._dev[name] = Timer(name + ".d", cuda=self._cuda)
        return _Named(self._host[name], self._dev[name])

    def names(self):
        return list(self._host.keys())

    def reset(self, name: Optional[str] = None):
        for n in ([name] if name is not None else self.names()):
            self._host[n].reset()
            self._dev[n].reset()

    def report(self) -> str:
        lines = [f"{'timer':<16}{'calls':>8}{'host ms':>12}{'avg ms':>10}"
                 f"{'dev ms':>12}{'avg ms':>10}"]
        for name in self.names():
            h, d = self._host[name], self._dev[name]
            lines.append(
                f"{name:<16}{max(h.count, d.count):>8}{h.total_ms:>12.3f}"
                f"{h.avg_ms:>10.4f}{d.total_ms:>12.3f}{d.avg_ms:>10.4f}")
        return "\n".join(lines)


class Marks:
    """Time stamps between a loop's iterations: CUDA events on a CUDA
    device, recorded on the current stream and read only after the loop
    (one wait at the end instead of one an iteration), the host clock on
    the CPU."""

    def __init__(self, device):
        self._cuda = torch.device(device).type == "cuda"
        self._marks = []

    def mark(self) -> None:
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._marks.append(event)
        else:
            self._marks.append(time.perf_counter_ns())

    def intervals_ms(self) -> List[float]:
        """ms between consecutive marks (waits for the last one)."""
        if len(self._marks) < 2:
            return []
        if self._cuda:
            self._marks[-1].synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self._marks, self._marks[1:])]
        return [(b - a) / 1e6 for a, b in zip(self._marks, self._marks[1:])]
