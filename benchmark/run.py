"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. In order: set-up (inputs, the program's
preparation, the first steps, a warm-up fit), the measured window of whole
fits, the reads of the traced run (``--trace 1``), the comparison with the
plain reference, and one JSON line, the last of standard output, with the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``). Each compared number and its limit are also the last
lines of standard error. Exits non-zero, and prints no result, without
the CUDA devices the cell asks for, or if the run holds JAX or the JAX
package.
"""

from __future__ import annotations

import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def _caches_in_checkout():
    """Every build and kernel cache at a fixed place inside the checkout,
    the bytecode of the modules imported from here on too, so that only a
    checkout's first run compiles them (torch's lazy imports cost ~8 s of
    compiling where its installation carries no bytecode)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(_HERE, ".cache", sub)
    sys.pycache_prefix = os.path.join(_HERE, ".cache", "pycache")
    sys.dont_write_bytecode = False


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, rec, trace: bool) -> dict:
    """The contract's JSON object; ``compared`` comes last."""
    import torch

    from benchmark import harness

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = harness._module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    fits = rec["fits"]
    failed = sum(1 for f in fits
                 if not all(map(_finite, f.losses)))
    readings, limits = rec["readings"], cell.limits
    names = harness.compared_names(cell.config)
    correct = (failed == 0 and bool(fits)
               and all(readings[k] <= limits[k] for k in names))
    dev = rec["device"]
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell.chips,
              "memory_peak_bytes": rec.get("memory_peak_bytes", 0)}
    out = {"correct": correct, "attempted": len(fits), "failed": failed,
           "metrics": metrics, "device": device}
    prof = rec.get("profile")
    if trace and prof:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["compared"] = {k: {"value": _json_number(readings[k]),
                           "limit": limits[k]}
                       for k in names}
    return out


def _finite(x) -> bool:
    return x == x and abs(x) != float("inf")


def _json_number(x) -> float:
    """A reading that JSON can carry: a non-finite one as the largest
    float (it fails every limit alike)."""
    return x if _finite(x) else sys.float_info.max


def main(argv=None) -> int:
    import json

    args = _parse(argv)
    _caches_in_checkout()
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    if cell.limits is None:
        print(f"no limits file for {args.workload}", file=sys.stderr)
        return 2
    rec = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace))
    line = result_line(cell, rec, bool(args.trace))
    held = harness.forbidden_modules()
    if held:
        print(f"the run holds {', '.join(held)}", file=sys.stderr)
        return 3
    fits = rec["fits"]
    print("setup " + json.dumps({**rec["setup_parts"],
                                 **rec["prep_spans"],
                                 "setup_s": rec["setup_s"],
                                 "n": rec["work"]["n"],
                                 "nnz": rec["work"]["nnz"]}),
          file=sys.stderr)
    print("fits " + json.dumps({
        "count": len(fits), "iters": fits[0].iters,
        "wall_s": [f.wall_s for f in fits],
        "loop_s": [f.loop_s for f in fits],
        "replay_s": [f.replay_s for f in fits],
        "reference_s": rec["reference_s"],
        "update_leaves": rec["readings"]["update_leaves"]}),
          file=sys.stderr)
    for k, v in line["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
