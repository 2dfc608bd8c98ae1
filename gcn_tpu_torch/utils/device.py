"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``). Without a CUDA device this raises
    instead of drifting onto the CPU: pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: gcn_tpu_torch runs on the card by "
            "default; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
