#!/usr/bin/env python3
"""Row-skew analysis: nnz-per-row CDFs of datasets or CSV dumps, and the
log-x step chart that motivates the tiling design. The counterpart of
gcn_tpu's ``examples/row_analysis.py``; host only.

    python -m gcn_tpu_torch.row_analysis -g synth-pubmed synth-arxiv -o row.svg
    python -m gcn_tpu_torch.row_analysis --csv dumps/*.csv -o row.svg
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="nnz-per-row CDFs of datasets or CSV dumps")
    ap.add_argument("-g", "--graphs", nargs="*", default=["synth-pubmed"],
                    help="dataset names from the registry")
    ap.add_argument("--csv", nargs="*", default=[],
                    help="CSV matrix dumps (writecsv format)")
    ap.add_argument("-o", "--out", default="row.svg")
    ap.add_argument("--normalized", action="store_true",
                    help="analyze the GCN-normalized adjacency (adds self "
                         "loops) instead of the raw one")
    args = ap.parse_args(argv)

    import numpy as np

    from gcn_tpu_torch.analysis import plot_row_cdfs, row_cdf
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.graph.normalize import gcn_normalize
    from gcn_tpu_torch.utils.writecsv import read as csv_read

    graphs = {}
    for name in args.graphs:
        g = get_dataset(name).adj
        if args.normalized:
            g = gcn_normalize(g)
        graphs[name] = g
    for path in args.csv:
        graphs[path] = csv_read(path)
    if not graphs:
        ap.error("nothing to analyze")

    for name, g in graphs.items():
        x, y = row_cdf(g)
        deg = x.astype(float)
        counts = np.diff(np.concatenate([[0.0], y])) * g.shape[0]
        mean = float((deg * counts).sum() / counts.sum())
        print(f"{name}: n={g.shape[0]} nnz={g.nnz} mean_deg={mean:.1f} "
              f"max_deg={int(x[-1])}")
    out = plot_row_cdfs(graphs, args.out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
