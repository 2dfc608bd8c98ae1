"""CSR -> CSV matrix dumps for offline analysis.

The port's copy of ``gcn_tpu.utils.writecsv`` (the same bytes for the same
graph): three CSV rows, indptr, indices and data, which
``analysis/rows.py`` and the reference's row-analysis tools read.
``append`` writes each row in chunks of a million values, for graphs too
large to turn into one string.
"""

from __future__ import annotations

import os

import numpy as np

from gcn_tpu_torch.graph.csr import CSRGraph


def write(g, name: str, out_dir: str = ".", append: bool = False) -> str:
    """Dump a CSRGraph (or scipy sparse) to ``<out_dir>/<name>.csv``."""
    if not isinstance(g, CSRGraph):
        g = CSRGraph.from_scipy(g.tocsr())
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.csv")
    rows = (g.indptr, g.indices, g.data)
    with open(path, "w") as f:
        for arr in rows:
            if append:
                chunk = 1_000_000
                for lo in range(0, len(arr), chunk):
                    prefix = "" if lo == 0 else ","
                    f.write(prefix + ",".join(
                        map(str, arr[lo:lo + chunk].tolist())))
                f.write("\n")
            else:
                f.write(",".join(map(str, arr.tolist())) + "\n")
    return path


def read(path: str) -> CSRGraph:
    """Read a matrix written by ``write`` back into a CSRGraph."""
    with open(path) as f:
        indptr = np.array(f.readline().strip().split(","), dtype=np.int64)
        indices = np.array(f.readline().strip().split(","), dtype=np.int32)
        data_line = f.readline().strip()
        data = (np.array(data_line.split(","), dtype=np.float32)
                if data_line else np.zeros(0, np.float32))
    n = len(indptr) - 1
    m = int(indices.max()) + 1 if len(indices) else n
    return CSRGraph(indptr=indptr.astype(np.int64), indices=indices,
                    data=data, shape=(n, max(n, m)))
