"""Faults of the GAT cell, for the check of its comparison: each must
turn ``correct`` false. Like ``faults.py``'s, each patches the program's
module attributes for the duration of a ``with`` block and touches no
file:

  * ``half_batch``: the loss takes the mean over the first half of the
    training rows only;
  * ``state_unchanged``: the optimizer's step leaves every parameter and
    its own state as they were;
  * ``slope_zero``: the attention's logits take LeakyReLU's negative slope
    as 0 (a ReLU) in place of the configuration's.

The readings at full size, on the chip (program readings under each
fault, as ``benchmark.calibrate`` takes them):

    python3 -m benchmark.gat_faults --workload gat-arxiv.full --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import calibrate, faults, harness


def slope_zero():
    from gcn_tpu_torch.ops import gat_attn

    real = gat_attn.gat_attention
    return faults._patched(
        gat_attn, "gat_attention",
        lambda layout, wh, el, er, negative_slope=0.2: real(
            layout, wh, el, er, 0.0))


# GAT trains through GCN's fit_gcn, masked_nll and adam_l2, so GCN's plants
# of the first two faults are GAT's too
FAULTS = {"half_batch": lambda: faults.half_batch("gcn"),
          "state_unchanged": lambda: faults.state_unchanged("gcn"),
          "slope_zero": slope_zero}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="gat-arxiv.full")
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
