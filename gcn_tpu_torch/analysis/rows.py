"""Row-skew analysis: nnz-per-row CDFs.

The port's copy of ``gcn_tpu.analysis.rows``. Input is a CSRGraph, a scipy
matrix or a graph read back from ``utils/writecsv.py``; output is the step
CDF (x = nnz, y = fraction of rows) and optionally a log-x plot.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def nnz_per_row(g) -> np.ndarray:
    if hasattr(g, "indptr"):
        return np.diff(np.asarray(g.indptr))
    raise TypeError("expected CSRGraph or scipy CSR")


def row_cdf(g) -> Tuple[np.ndarray, np.ndarray]:
    """-> (sorted unique nnz values, cumulative fraction of rows)."""
    deg = nnz_per_row(g)
    vals, counts = np.unique(deg, return_counts=True)
    return vals, np.cumsum(counts) / deg.size


def plot_row_cdfs(graphs: Dict[str, object], out_path: str = "row.svg"):
    """Log-x step plot of nnz-per-row CDFs, one curve per named graph
    (needs matplotlib, imported here only)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, g in graphs.items():
        x, y = row_cdf(g)
        ax.step(np.maximum(x, 1), y, where="post", label=name)
    ax.set_xscale("log")
    ax.set_xlabel("nnz per row")
    ax.set_ylabel("fraction of rows")
    ax.legend(loc="lower right", fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
