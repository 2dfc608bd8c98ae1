#!/usr/bin/env python3
"""The card's row-gather rate on either side of the L2: the counterpart of
gcn_tpu's ``examples/bench_gather.py``.

    python -m gcn_tpu_torch.bench_gather [--sizes 50000 ... 932000]
        [--ks 32 128] [--stream-mb 512] [-o PATH] [--device cpu]

K1 reads one x row a stored edge, so its time rests on how fast the card
gathers rows from an (n, k) table. For each table height n and width k:
the chained row gather plus stride sum ``x' = sum_j x[idx[j]]`` (torch's
indexing, ``utils/chain_timing.py::gather_ns_per_row``: each call's
output is the next call's table, so no gather can be skipped), in ns a
gathered row, for a float32 and a bfloat16 table, beside the table's size
(the H100's L2 holds 50 MB) and the ns a row the HBM rate alone would
allow (k x 4 or 2 bytes at 3.35 TB/s). Then the stream rate of a 512 MB
chained ``y = y * c + d`` (``stream_gb_per_s``), and what a pair of CUDA
events around nothing reads behind the spin kernel (``event_floor_ms``,
the floor of every time the port's scripts record). The gather is a
measurement of the card, not a port of a kernel.

gcn_tpu's packed-table variant (``bench_packed_gather``, Q table rows in
one 128-lane row) is a TPU lane layout that K1 does not have, so it is
left out. With ``--device cpu`` the chain runs once at each size on the
CPU (a rehearsal) and every rate is null.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(HERE, "results", "gather_microbench.json")
SIZES = [50_000, 169_343, 233_000, 466_000, 932_000]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=SIZES)
    ap.add_argument("--ks", type=int, nargs="+", default=[32, 128])
    ap.add_argument("--stream-mb", type=int, default=512)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("-o", "--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    import torch

    from gcn_tpu_torch.utils import chain_timing as ct
    from gcn_tpu_torch.utils.artifacts import write_artifact
    from gcn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    rows = []
    for k in args.ks:
        for n in args.sizes:
            row = {"n": n, "k": k, "table_mb_f32": n * k * 4 / 1e6}
            for name, dtype in (("f32", torch.float32),
                                ("bf16", torch.bfloat16)):
                if on_card:
                    row[f"{name}_ns_per_row"] = ct.gather_ns_per_row(
                        n, k, dtype, args.reps, device=device)
                else:
                    step, x0, _ = ct.gather_chain(n, k, dtype, idx_len=n,
                                                  device=device)
                    step(x0)
                    row[f"{name}_ns_per_row"] = None
                row[f"{name}_hbm_ns_per_row"] = (
                    k * dtype.itemsize / ct.HBM_BYTES_PER_S * 1e9)
            rows.append(row)
            print(json.dumps(row), flush=True)
    stream = (ct.stream_gb_per_s(args.stream_mb, device=device)
              if on_card else None)
    floor = ct.event_floor_ms(args.reps) if on_card else None
    print(json.dumps({"stream_gb_per_s": stream, "stream_mb": args.stream_mb,
                      "event_floor_ms": floor}), flush=True)
    write_artifact(args.out, {
        "protocol": "chained row gather + stride sum (torch indexing, "
                    "stride min(8, 2e6 // n)), median of --reps calls "
                    "behind a spin kernel (CUDA events), ns per gathered "
                    "row; stream: chained y = y * c + d over --stream-mb "
                    "MB, 2 x MB moved a call",
        "rows": rows, "stream_gb_per_s": stream, "event_floor_ms": floor,
        "stream_mb": args.stream_mb,
        "hbm_gb_per_s": ct.HBM_BYTES_PER_S / 1e9},
        harness="gcn_tpu_torch/bench_gather.py",
        schema="gather_microbench_torch_v1", extra_meta=ct.stamp(device))
    print(f"wrote {args.out}")
    if on_card:
        print(ct.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
