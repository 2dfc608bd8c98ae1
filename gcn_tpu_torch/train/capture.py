"""A training loop run as replays of one captured CUDA graph.

gcn_tpu runs a whole fit as one ``lax.scan`` (``jit_loop=True``, the
default of ``fit_gcn``, ``GCN.fit`` and ``HGNN.fit``): one dispatch, no
host round trip between iterations. The port's counterpart is
``CapturedLoop``, which runs the one training loop, ``train/loop.py``'s
``fit_gcn``, in both its flavors: the loop writes one training iteration
as a ``body()`` that reads and writes only device tensors (parameters
updated in place, the iteration's index and its results in preallocated
buffers, selects instead of branches), and ``run(n)`` runs it ``n``
times:

  * on a CUDA device, the first ``WARMUP`` iterations run eagerly (they
    are the fit's own iterations: Adam's state, K2's side stream and its
    kernels' shared-memory limits come into being there, never under
    capture), then one call of ``body`` is captured into a
    ``torch.cuda.CUDAGraph`` and replayed for every remaining iteration.
    The whole loop runs on one side stream, which waits for the caller's
    stream first and is waited for after; the host never waits for the
    card between iterations. Kernels K1 and K2 launch inside the graph. A
    capture or a replay that fails raises: nothing falls back to plain
    calls;
  * on the CPU, or given the device None (the eager flavor,
    ``jit_loop=False``), ``body`` runs ``n`` times uncaptured: the same
    arithmetic, on the CPU testable against gcn_tpu.

The dropout generator is registered with the graph
(``register_generator_state``), so every replay draws new masks and
advances the generator as the eager iteration would. A fit that stops
early still replays its stopped iterations (a graph has no branch), and
those advance the generator too; ``generator_state_after(n)`` is the state
that ``n`` executed iterations leave, which the fit sets at the end.

``run`` opens three spans (``utils/timers.py``): ``loop.warmup`` (the
eager iterations), ``loop.capture`` (on the card) and ``loop.replay`` (the
rest: replays on the card, plain calls on the CPU), each with its
``iters``. The call counters (``utils.timers.counters``) count host calls
of the wrappers: in a captured loop, the warm-up iterations and the one
captured call, which ``loop.capture``'s ``counts`` hold. The replays
launch the captured kernels again without a host call, so the kernels'
launches in a captured fit are counted from the profiler's kernel records
(``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from gcn_tpu_torch.utils.timers import Marks, span

# eager iterations before the capture: the first creates Adam's state, the
# second runs the steady-state path once before it is captured
WARMUP = 2

# a CUDA generator's state: the seed, then the Philox offset (8 bytes each)
_SEED_BYTES = 8


def _offset(state: torch.Tensor) -> int:
    return int.from_bytes(bytes(state[_SEED_BYTES:].tolist()), "little")


def _with_offset(state: torch.Tensor, offset: int) -> torch.Tensor:
    out = state.clone()
    out[_SEED_BYTES:] = torch.tensor(
        list(offset.to_bytes(len(state) - _SEED_BYTES, "little")),
        dtype=state.dtype)
    return out


class CapturedLoop:
    """Runs ``body`` as a fit's iterations: eager warm-up, then replays of
    one captured CUDA graph on a CUDA ``device``; plain calls on the CPU
    or when ``device`` is None (``fit_gcn``'s eager flavor)."""

    def __init__(self, body: Callable[[], None], device,
                 generator: Optional[torch.Generator] = None):
        self.body = body
        self.device = None if device is None else torch.device(device)
        self.cuda = self.device is not None and self.device.type == "cuda"
        self.generator = generator
        self.graph = None
        # the generator's state before the loop and after each iteration
        # that ran uncaptured
        self._states: List[torch.Tensor] = []

    def _note_state(self) -> None:
        if self.generator is not None:
            self._states.append(self.generator.get_state())

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, stream=torch.cuda.current_stream()):
            self.body()
        self.graph = graph

    def run(self, n: int, before: Optional[Callable[[int], None]] = None,
            marks: Optional[Marks] = None) -> None:
        """Run ``n`` iterations. ``before(i)`` runs on the host before
        iteration ``i`` (it may enqueue device work, such as a learning
        rate's ``fill_``); ``marks`` is stamped before every iteration and
        after the last, so the capture falls in the last warm-up
        iteration's interval."""
        self._states = []
        self._note_state()
        if not self.cuda:
            self._run(n, before, marks)
            return
        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            self._run(n, before, marks)
        caller.wait_stream(side)

    def _run(self, n, before, marks):
        def start(i):
            if before is not None:
                before(i)
            if marks is not None:
                marks.mark()

        warm = min(n, WARMUP)
        with span("loop.warmup", iters=warm):
            for i in range(warm):
                start(i)
                self.body()
                self._note_state()
        if n > warm:
            if self.cuda and self.graph is None:
                with span("loop.capture"):
                    self._capture()
            with span("loop.replay", iters=n - warm):
                for i in range(warm, n):
                    start(i)
                    if self.cuda:
                        self.graph.replay()
                    else:
                        self.body()
                        self._note_state()
        if marks is not None:
            marks.mark()
        if self.generator is not None and self.graph is not None:
            # the linear model of the offset that generator_state_after
            # relies on must hold for the iterations that ran
            want = self.generator_state_after(n)
            if not torch.equal(want, self.generator.get_state()):
                raise RuntimeError(
                    "the dropout generator did not advance by the same "
                    "offset every iteration of the captured loop")

    def generator_state_after(self, n: int) -> torch.Tensor:
        """The generator's state after the first ``n`` iterations of the
        last ``run``: recorded for an uncaptured one, else the last
        recorded state's Philox offset advanced by the same increment for
        each replayed iteration (every replay advances it by one eager
        iteration's draws)."""
        if self.generator is None:
            raise ValueError("the loop has no generator")
        if n < len(self._states):
            return self._states[n]
        last, prev = self._states[-1], self._states[-2]
        if len(last) != 2 * _SEED_BYTES or not torch.equal(
                last[:_SEED_BYTES], prev[:_SEED_BYTES]):
            raise RuntimeError("the generator's state is not a CUDA "
                               "generator's seed and Philox offset")
        step = _offset(last) - _offset(prev)
        return _with_offset(last, _offset(last)
                            + step * (n - len(self._states) + 1))
