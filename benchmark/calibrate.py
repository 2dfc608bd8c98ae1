"""The readings that the limits of a cell's compared numbers are set from,
on the chip, in one process (set-up once):

    python3 -m benchmark.calibrate --workload NAME --seeds 101 102 ... \
        [--control-seeds ...] [--fault-seeds ...] [--out PATH]

For each seed, the program's readings as a run takes them (the probe's
first steps, its late steps where the configuration asks, and a whole
window fit against the float64 reference); for each control seed, the
control's: the reference computed in TF32 put in the program's place; for
each fault seed, the program's readings with each fault of ``faults.py``
that the family can have planted. One JSON line a reading, then a summary:
the largest program reading and the smallest control and fault readings
of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import faults, harness


def program_readings(prog, cfg, iters, seed, problem, device):
    """The program's readings as a run takes them: the probe, a whole
    window fit, and where asked the probe's late steps."""
    late_from = cfg.get("late_steps_from")
    probe = harness.first_steps(prog, seed, device)
    window_fit = harness.fit_from_seed(prog, seed, 1, iters, device)[1]
    if late_from is not None:
        harness.late_steps(prog, probe, seed, late_from, device)
    side = harness.program_side(probe, window_fit, cfg["adam_betas"][0])
    ref = harness.reference_side_for(problem, seed, 1, probe.p0, prog.perm,
                                     prog.layers, late_from)
    return {**harness.compare(side, ref), **detail(side, ref)}, ref, probe.p0


def detail(side, ref) -> dict:
    """Each step's loss gap and each leaf's update gap, to look at."""
    import statistics

    def gaps(prog, refs):
        norms = [harness._norm(r) for r in refs]
        median = statistics.median(norms)
        return [abs((0.0 if p is None else harness._norm(p)) - r)
                / max(r, median) for p, r in zip(prog, norms)]

    def loss_gaps(prog, refs):
        return [abs(p - r) / abs(r) for p, r in zip(prog, refs)]

    out = {"loss_steps": loss_gaps(side.fit_losses, ref.fit_losses),
           "grad_leaves": gaps(side.grad1, ref.grad1),
           "update_leaves": gaps(side.delta, ref.delta)}
    if ref.late_losses is not None and side.late_losses is not None:
        out["late_loss_steps"] = loss_gaps(side.late_losses, ref.late_losses)
        out["late_update_leaves"] = gaps(side.late_delta, ref.late_delta)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    cfg, job = cell.config, cell.job
    t0 = time.perf_counter()
    data = harness.make_inputs(cfg)
    prog = harness.program_class(cfg)(cfg, job, data, device,
                                      harness.Spans())
    problem = harness.reference_class(cfg)(cfg, data, device, "float64")
    control = harness.reference_class(cfg)(cfg, data, device, "tf32")
    iters = int(cfg[job["fit_length_key"]])
    print(f"set-up {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    rows = []

    def emit(kind, seed, readings):
        row = {"workload": args.workload, "kind": kind, "seed": seed,
               **readings}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.fault_seeds)):
        readings, ref, p_probe = program_readings(prog, cfg, iters, seed,
                                                  problem, device)
        if seed in args.seeds:
            emit("program", seed, readings)
        if seed in args.control_seeds:
            side = harness.reference_side_for(
                control, seed, 1, p_probe, prog.perm, prog.layers,
                cfg.get("late_steps_from"))
            emit("control", seed, {**harness.compare(side, ref),
                                   **detail(side, ref)})
        if seed in args.fault_seeds:
            for name, plant in faults.for_family(cfg["family"]).items():
                with plant(cfg["family"]):
                    emit(f"fault:{name}", seed, program_readings(
                        prog, cfg, iters, seed, problem, device)[0])
    summary = {"workload": args.workload, "elapsed_s":
               time.perf_counter() - t0}
    for k in harness.compared_names(cfg):
        by_kind = {}
        for r in rows:
            by_kind.setdefault(r["kind"], []).append(r[k])
        summary[k] = {kind: (max(v) if kind == "program" else min(v))
                      for kind, v in by_kind.items()}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [{"summary": summary}]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
