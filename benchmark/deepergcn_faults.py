"""Faults of the DeeperGCN cell, for the check of its comparison: each must
turn ``correct`` false. Like ``faults.py``'s, each patches the program's
module attributes for the duration of a ``with`` block and touches no
file:

  * ``half_batch``: the loss takes the mean over the first half of the
    training rows only;
  * ``state_unchanged``: the optimizer's step leaves every parameter and
    its own state as they were;
  * ``temperature_one``: the aggregation's softmax reads t as 1 in place
    of the configuration's;
  * ``weights_differentiated``: the gradient also flows through the
    aggregation's softmax weights, which the run holds constant
    (``softmax_sg``): ``dm = (1 + t m) B(da) - t B(a da)``, with ``B(g)``
    the kernels' own backward (g weighted by the forward's softmax and
    summed over each source's in-edges); the plain version differentiated
    whole on the CPU.

The readings at full size, on the chip (program readings under each
fault, as ``benchmark.calibrate`` takes them):

    python3 -m benchmark.deepergcn_faults --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import calibrate, faults, harness


def temperature_one():
    from gcn_tpu_torch.ops import softmax_agg

    real = softmax_agg.softmax_aggregate
    return faults._patched(softmax_agg, "softmax_aggregate",
                           lambda layout, m, t: real(layout, m, 1.0))


class _Differentiated(torch.autograd.Function):
    """The kernels' forward, and a backward through the weights too."""

    @staticmethod
    def forward(ctx, m, layout, t):
        from gcn_tpu_torch.ops import softmax_agg

        out, lse = softmax_agg._forward(layout, m, t, keep_lse=True)
        ctx.layout, ctx.t = layout, t
        ctx.save_for_backward(m, lse, out)
        return out

    @staticmethod
    def backward(ctx, da):
        from gcn_tpu_torch.ops import softmax_agg

        m, lse, out = ctx.saved_tensors
        layout, t = ctx.layout, ctx.t
        value = softmax_agg._backward(layout, m, lse, da, t)
        spread = softmax_agg._backward(layout, m, lse, out * da, t)
        return value * (1.0 + t * m) - t * spread, None, None


def _plain_through_weights(layout, m, t):
    """The plain version with its softmax weights differentiated."""
    from gcn_tpu_torch.ops.spmm import segment_sum

    rows, row_len = layout.rows, layout.row_len
    g = m.index_select(0, layout.cols)
    s = t * g
    top = torch.segment_reduce(s.detach(), "max", lengths=row_len, axis=0,
                               unsafe=True)
    p = torch.exp(s - top.index_select(0, rows))
    alpha = p / segment_sum(p, row_len).index_select(0, rows)
    return segment_sum(alpha * g, row_len)


def weights_differentiated():
    from gcn_tpu_torch.ops import softmax_agg

    real = softmax_agg.softmax_aggregate

    def through_weights(layout, m, t):
        if m.device.type == "cpu":
            return _plain_through_weights(layout, m, t)
        if torch.is_grad_enabled() and m.requires_grad:
            return _Differentiated.apply(softmax_agg._aligned(m), layout,
                                         float(t))
        return real(layout, m, t)

    return faults._patched(softmax_agg, "softmax_aggregate", through_weights)


# DeeperGCN trains through GCN's fit_gcn, masked_nll and adam_l2, so GCN's
# plants of the first two faults are DeeperGCN's too
FAULTS = {"half_batch": lambda: faults.half_batch("gcn"),
          "state_unchanged": lambda: faults.state_unchanged("gcn"),
          "temperature_one": temperature_one,
          "weights_differentiated": weights_differentiated}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="deepergcn-arxiv.resplus")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    cfg = cell.config
    data = harness.make_inputs(cfg)
    prog = harness.program_class(cfg)(cfg, cell.job, data, device,
                                      harness.Spans())
    problem = harness.reference_class(cfg)(cfg, data, device, "float64")
    iters = int(cfg[cell.job["fit_length_key"]])
    for seed in args.seeds:
        for name, plant in FAULTS.items():
            with plant():
                readings = calibrate.program_readings(
                    prog, cfg, iters, seed, problem, device)[0]
            print(json.dumps({"workload": args.workload,
                              "kind": f"fault:{name}", "seed": seed,
                              **{k: readings[k]
                                 for k in harness.compared_names(cfg)}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
