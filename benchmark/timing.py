"""Device time of one call, by the chain method: a frozen copy of the
port's ``utils/chain_timing.py`` (``_timed``, ``device_ms``).

The calls are queued behind a ~0.1 s spin kernel, so the host has
enqueued them all before the card reaches them and the CUDA events around
each read device time, not the wrapper's Python time; the median of the
calls is the reading. On a CUDA device only.
"""

from __future__ import annotations

import statistics

SPIN_CYCLES = 200_000_000   # ~0.1 s on an H100
WARMUP_CALLS = 3


def device_ms(fn, reps: int = 30) -> float:
    """Median ms of ``reps`` calls of ``fn()`` on the same inputs."""
    import torch

    for _ in range(WARMUP_CALLS):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(statistics.median(s.elapsed_time(e) for s, e in events))
