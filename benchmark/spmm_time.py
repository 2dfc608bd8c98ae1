"""The SpMM's device time at the widths the step uses, by the frozen chain
method (``timing.py``), beside the least time its work needs
(``work.py``): the reads of ``spmm_roofline_pct``.

A call is the port's public ``ops.spmm.spmm`` on the fit's own adjacency,
forward and transpose together, as a training step runs them: the
forward, then the gradient of x (``A^T g``) through autograd.
"""

from __future__ import annotations

import torch

from benchmark import timing, work


def measure(adj, n: int, nnz: int, widths, device) -> list:
    from gcn_tpu_torch.ops.spmm import spmm

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for k in widths:
        x = torch.rand((n, k), generator=gen, device=device
                       ).requires_grad_(True)
        g = torch.rand((n, k), generator=gen, device=device)

        def call():
            out = spmm(adj, x)
            torch.autograd.grad(out, x, g)

        ms = timing.device_ms(call)
        bytes_moved, flops = work.csr_spmm_work(nnz, n, n, k)
        rows.append({"k": k, "time_s": ms / 1e3,
                     "bound_s": 2 * work.bound_s(bytes_moved, flops)})
    return rows
