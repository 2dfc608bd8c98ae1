"""Profiling hooks: device traces on ``torch.profiler`` and file logging.

The port of ``gcn_tpu.utils.profiling``. ``device_trace`` complements the
named timers (``utils/timers.py``) when a question needs op-level detail:
it records the host and, on a CUDA device, the card's kernels, and writes
a Chrome trace (open it in Perfetto or chrome://tracing).
``setup_logging`` logs to a file like the reference's training script
(``profiling-gcn.log``).
"""

from __future__ import annotations

import contextlib
import logging
import os


@contextlib.contextmanager
def device_trace(log_dir: str = "gcn_tpu_torch_trace"):
    """Record a torch.profiler trace of the block into
    ``<log_dir>/trace.json``; yields ``log_dir``.

    Usage:
        with device_trace("trace"):
            train_step(...)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def setup_logging(path: str = "profiling-gcn.log",
                  level: int = logging.INFO) -> logging.Logger:
    """The ``gcn_tpu_torch`` logger: records at ``level`` and above to the
    file ``path``, warnings also to the console. Handlers are added once a
    process; later calls return the same logger."""
    logger = logging.getLogger("gcn_tpu_torch")
    logger.setLevel(level)
    if not logger.handlers:
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setLevel(logging.WARNING)
        logger.addHandler(sh)
    return logger
