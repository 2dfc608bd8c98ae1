"""The parameters a fit starts from, made on the device from a seed.

Both layers of the two-layer models draw W (in, out) and b (out,) from
U(-1/sqrt(out), 1/sqrt(out)) (pygcn's and pyhgnn's initialisation), all
leaves from one ``torch.rand`` call of a generator on ``device``. The
benchmark hands the same draw to the program and to the reference.
"""

from __future__ import annotations

import torch

SEED_MOD = 2 ** 62


def derived_seed(seed: int, index: int, stream: int) -> int:
    """A generator seed for fit ``index`` of run ``seed``; ``stream`` 0 for
    its parameters, 1 for its dropout stream. Never 0."""
    return (seed * 1_000_003 + index * 7_919 + stream * 104_729) % (
        SEED_MOD - 1) + 1


def init_params(layers, seed: int, device, dtype=torch.float32) -> dict:
    """``{name: {"w": (in, out), "b": (out,)}}`` for ``layers``, a list of
    (name, in, out)."""
    total = sum(i * o + o for _, i, o in layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device, dtype=dtype)
    params, off = {}, 0
    for name, n_in, n_out in layers:
        stdv = 1.0 / n_out ** 0.5
        w = u[off:off + n_in * n_out].view(n_in, n_out)
        off += n_in * n_out
        b = u[off:off + n_out]
        off += n_out
        params[name] = {"w": (2.0 * w - 1.0) * stdv,
                        "b": (2.0 * b - 1.0) * stdv}
    return params


def leaves(params: dict) -> list:
    """The leaves in the order both sides list them: layer by layer, W then
    b (the order the port hands parameters to its optimizer)."""
    return [t for layer in params.values() for t in layer.values()]
