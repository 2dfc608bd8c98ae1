"""Named accumulating timers.

The port of ``gcn_tpu.utils.timers`` with the same surface:

  * ``timers('name').h`` — host time (on the card: enqueue time only);
  * ``timers('name').d`` — device time: CUDA events around the region on a
    CUDA device (the end event is waited for on exit), the host clock on
    the CPU. ``t.fence(x)`` marks the region's result, as in gcn_tpu.

Each timer also keeps its per-call samples, so a median can be read.
``Marks`` stamps a loop's iterations on the device's stream without waiting
for it, for loops that must not stop the host each iteration: the
iterations of ``train/loop.fit_gcn`` in both its flavors, whose intervals
become the samples of the "step" timer (``Timer.add``) and HGNN's
``epoch_ms``, beside the ``fit_scan`` timer of the whole loop.

The fit's phases are spans (``span``): ``fit``, the root of each fit
(``train/loop.fit_gcn``), and its children ``fit.prepare``
(entry to the first iteration), ``fit.loop`` (the ``fit_scan`` region, its
wait for the device included) and ``fit.finish`` (the host reads and the
final evaluation); inside ``fit.loop``, ``CapturedLoop.run`` opens
``loop.warmup``, ``loop.capture`` (on the card) and ``loop.replay``;
``GAT.fit`` opens ``gat.layout`` (its layout and upload) and ``HGNN.fit``
``hgnn.prepare`` (G's lowering, the uploads, the G X hoist) before its
``fit``. A
span is a shared no-op unless a ``recording()`` is open, which collects
the finished spans, or ``torch.profiler`` is tracing, where each span is
also a ``record_function`` range on the profiler's clock, beside the
kernels.
No span is opened inside a captured iteration.

``counters`` counts the program's host calls by name: ``spmm_ell`` (K1,
``ops/ell_spmm.py``) and ``spmm_ell_k<k>`` (K1 at width k), ``spmm_panel``
(K2, ``ops/panel_spmm.py``), ``spmm_coo`` (each product of the COO SpMM,
``ops/spmm.py``, forward or backward, on either device) and
``spmm_coo_k<k>`` (a launch of its CUDA kernel at width k), ``gat_attn``
(each call of GAT's attention, ``ops/gat_attn.py``, forward or backward,
on either device), ``gat_attn_h<H>_f<F>`` (such a call through its
CUDA kernels, by heads and width) and ``gat_layout_local_order`` (each
attention layout made, its rows walked in community order). A call
inside a CUDA graph capture counts once and the graph's replays count
nothing, so a captured fit's calls an iteration are the ``counts`` of
its ``loop.capture`` span.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import statistics
import time
from typing import Dict, List, Optional

import torch

# the program's host calls by name (see the module's docstring)
counters: collections.Counter = collections.Counter()

# the root span of a fit; every span inside it carries its id
FIT = "fit"


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


@dataclasses.dataclass
class Span:
    """A finished span: its ``name``, its ``id``, the id of its ``fit``
    (the enclosing ``fit`` span's, None outside one) and of its ``parent``
    span, its host start and end (``time.perf_counter_ns``), its ``attrs``
    (such as ``iters``, the iterations it ran) and ``counts``, the increase
    of each of ``counters`` over it."""

    name: str
    id: int
    fit: Optional[int]
    parent: Optional[int]
    start_ns: int
    end_ns: int
    attrs: dict
    counts: dict

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_recordings: List[List[Span]] = []   # the open recordings, innermost last
_open: List["_OpenSpan"] = []        # the open spans, innermost last
_ids = itertools.count()


class _OpenSpan:
    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        parent = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.fit = (self.id if self.name == FIT
                    else None if parent is None else parent.fit)
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._before = dict(counters)
        _open.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        _open.remove(self)
        if self._range is not None:
            self._range.__exit__(*exc)
        if _recordings:
            before = self._before
            counts = {k: v - before.get(k, 0) for k, v in counters.items()
                      if v != before.get(k, 0)}
            done = Span(self.name, self.id, self.fit, self.parent,
                        self.start_ns, end_ns, self.attrs, counts)
            for spans in _recordings:
                spans.append(done)
        return False


class _NoSpan:
    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context manager around one phase of the program, named ``name``
    with attributes ``attrs`` (``set`` adds more inside it). Inside a
    ``recording()`` the finished span is recorded; under an active
    ``torch.profiler`` it is a ``record_function`` range. Otherwise it is
    a shared no-op."""
    if not _recordings and not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return _OpenSpan(name, attrs)


@contextlib.contextmanager
def recording():
    """Yields a list to which each span that finishes inside the block is
    appended, children before their parent."""
    spans: List[Span] = []
    _recordings.append(spans)
    try:
        yield spans
    finally:
        _recordings.pop()
