"""Graph partitioning for row-band sharded training.

The port of ``gcn_tpu.parallel.partition``. 1-D row partition: shard d owns
a contiguous band of rows (and the same band of feature, label and mask
rows). A locality reorder first (Rabbit, ``gcn_tpu_torch.reorder``) makes
the bands community-aligned, so most edges stay on their shard and the
boundary set that crosses shards shrinks.

All shards carry identical array shapes (rows padded to an equal band,
edges padded to the largest shard's count), as gcn_tpu needs for
shard_map; the port keeps the shapes so that its arrays equal gcn_tpu's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gcn_tpu_torch.graph.csr import CSRGraph


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """COO shards stacked on a leading shard axis (host numpy).

    rows_local: int32[n_shards, e_max]  row - shard*rows_per_shard, sorted;
                padding entries point at the last local row with val 0.
    cols:       int32[n_shards, e_max]  global column ids.
    vals:       f32[n_shards, e_max].

    The planners below read these on the host; the device arrays are made
    by the train step's ``shard_fn`` for the shards a process owns.
    """

    rows_local: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    n_rows: int
    n_cols: int
    rows_per_shard: int
    n_shards: int
    nnz: int

    @property
    def n_rows_padded(self) -> int:
        return self.rows_per_shard * self.n_shards

    def boundary_fraction(self) -> float:
        """Fraction of edges whose source column lives off-shard: the
        exchange traffic's figure of merit for a partition."""
        shard_of_col = self.cols // self.rows_per_shard
        shard_ids = np.arange(self.n_shards)[:, None]
        off = (shard_of_col != shard_ids) & (self.vals != 0)
        return float(off.sum() / max(self.nnz, 1))


def rows_per_shard_for(n: int, n_shards: int) -> int:
    """Band height shard_graph_by_rows will use for (n, n_shards)."""
    return _round_up(_round_up(n, n_shards) // n_shards, 8)


def shard_graph_by_rows(g: CSRGraph, n_shards: int,
                        pad_edges_to: Optional[int] = None) -> ShardedGraph:
    """Partition a (square) graph into equal contiguous row bands."""
    n = g.shape[0]
    rows_per_shard = rows_per_shard_for(n, n_shards)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    shard = rows // rows_per_shard
    counts = np.bincount(shard, minlength=n_shards)
    e_max = int(counts.max()) if g.nnz else 0
    e_max = max(_round_up(max(e_max, 128), 128), 128)
    if pad_edges_to is not None:
        assert pad_edges_to >= e_max
        e_max = pad_edges_to

    rows_local = np.full((n_shards, e_max), rows_per_shard - 1,
                         dtype=np.int32)
    cols = np.zeros((n_shards, e_max), dtype=np.int32)
    vals = np.zeros((n_shards, e_max), dtype=np.float32)
    # position within shard: nnz are row-sorted so per-shard order holds
    shard_start = np.zeros(n_shards + 1, dtype=np.int64)
    np.cumsum(counts, out=shard_start[1:])
    pos = np.arange(g.nnz, dtype=np.int64) - shard_start[shard]
    rows_local[shard, pos] = (rows - shard * rows_per_shard).astype(np.int32)
    cols[shard, pos] = g.indices
    vals[shard, pos] = g.data
    return ShardedGraph(
        rows_local=rows_local, cols=cols, vals=vals,
        n_rows=n, n_cols=g.shape[1],
        rows_per_shard=rows_per_shard, n_shards=n_shards, nnz=g.nnz,
    )


def band_degree_sort_order(g: CSRGraph, rows_per_shard: int) -> np.ndarray:
    """perm[new]=old sorting rows by degree descending WITHIN each row band.

    Every row stays in its band, so the boundary sets only relabel, and the
    per-shard ELL windows become degree-homogeneous. Apply AFTER the
    community reorder and BEFORE shard_graph_by_rows and tiling.
    """
    n = g.shape[0]
    deg = np.diff(g.indptr)
    perm = np.empty(n, dtype=np.int32)
    for lo in range(0, n, rows_per_shard):
        hi = min(n, lo + rows_per_shard)
        order = np.argsort(-deg[lo:hi], kind="stable")
        perm[lo:hi] = lo + order
    return perm


def pad_rows(x: np.ndarray, sg: ShardedGraph, fill=0) -> np.ndarray:
    """Pad a per-row array (features/labels/masks) to the sharded row
    count."""
    n_pad = sg.n_rows_padded
    if x.shape[0] == n_pad:
        return x
    pad_width = [(0, n_pad - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill)
