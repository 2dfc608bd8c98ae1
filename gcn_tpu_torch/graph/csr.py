"""Host-side CSR graph container (numpy).

The port's own copy of ``gcn_tpu.graph.csr``: int32 indptr/indices and
float32 values, the single host-side graph currency from which the device
adjacencies (``gcn_tpu_torch.ops``) are built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Compressed-sparse-row adjacency.

    Attributes:
        indptr:  int32[m+1] row pointers.
        indices: int32[nnz] column ids.
        data:    float32[nnz] edge weights.
        shape:   (m, n).
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: Tuple[int, int]

    def __post_init__(self):
        self.indptr = np.ascontiguousarray(self.indptr, dtype=np.int32)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.int32)
        self.data = np.ascontiguousarray(self.data, dtype=np.float32)
        self.shape = (int(self.shape[0]), int(self.shape[1]))

    @classmethod
    def from_scipy(cls, mat) -> "CSRGraph":
        m = mat.tocsr()
        m.sort_indices()
        return cls(m.indptr, m.indices, m.data, m.shape)

    @classmethod
    def from_coo(cls, rows: np.ndarray, cols: np.ndarray,
                 vals: Optional[np.ndarray], shape: Tuple[int, int], *,
                 sum_duplicates: bool = True) -> "CSRGraph":
        return coo_to_csr(rows, cols, vals, shape,
                          sum_duplicates=sum_duplicates)

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "CSRGraph":
        rows, cols = np.nonzero(dense)
        return coo_to_csr(rows, cols, dense[rows, cols], dense.shape)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def col_degrees(self) -> np.ndarray:
        return np.bincount(self.indices,
                           minlength=self.shape[1]).astype(np.int64)

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return csr_to_coo(self)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=self.shape)

    def to_torch(self, device=None):
        """This matrix as a torch sparse CSR tensor on ``device``: the
        operand of ``torch.sparse.mm``, the SpMM kernels' library
        yardstick."""
        import torch

        return torch.sparse_csr_tensor(
            torch.as_tensor(self.indptr, dtype=torch.int64),
            torch.as_tensor(self.indices, dtype=torch.int64),
            torch.as_tensor(self.data), size=self.shape, device=device)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float32)
        rows, cols, vals = self.to_coo()
        np.add.at(out, (rows, cols), vals)
        return out

    def transpose(self) -> "CSRGraph":
        rows, cols, vals = self.to_coo()
        return coo_to_csr(cols, rows, vals, (self.shape[1], self.shape[0]),
                          sum_duplicates=False)

    def copy(self) -> "CSRGraph":
        return CSRGraph(self.indptr.copy(), self.indices.copy(),
                        self.data.copy(), self.shape)

    def symmetrize(self, *, binarize: bool = True) -> "CSRGraph":
        """A := A + A^T (optionally binarized), diagonal removed."""
        assert self.shape[0] == self.shape[1], \
            "symmetrize needs a square matrix"
        r, c, v = self.to_coo()
        rows = np.concatenate([r, c])
        cols = np.concatenate([c, r])
        vals = np.concatenate([v, v])
        keep = rows != cols
        g = coo_to_csr(rows[keep], cols[keep], vals[keep], self.shape)
        if binarize:
            g = CSRGraph(g.indptr, g.indices, np.ones_like(g.data), g.shape)
        return g

    def with_self_loops(self, fill: float = 1.0) -> "CSRGraph":
        """A := A + fill*I: existing diagonal entries are bumped in place,
        missing ones inserted at their sorted position."""
        assert self.shape[0] == self.shape[1]
        n = self.shape[0]
        rows = np.repeat(np.arange(n, dtype=np.int64),
                         np.diff(self.indptr))
        is_diag = self.indices == rows
        has_diag = np.zeros(n, dtype=bool)
        has_diag[rows[is_diag]] = True
        data = self.data.copy()
        data[is_diag] += np.float32(fill)
        if has_diag.all():
            return CSRGraph(self.indptr, self.indices, data, self.shape)
        # rows lacking a diagonal: insert at the in-row sorted position =
        # row start + (# entries with col < row)
        need = np.flatnonzero(~has_diag)
        less = np.bincount(rows[self.indices < rows], minlength=n)
        pos = self.indptr[need].astype(np.int64) + less[need]
        indices = np.insert(self.indices, pos, need.astype(np.int32))
        data = np.insert(data, pos, np.float32(fill))
        add = np.zeros(n + 1, dtype=np.int64)
        add[1:] = np.cumsum(~has_diag)
        indptr = self.indptr.astype(np.int64) + add
        return CSRGraph(indptr, indices, data, self.shape)

    def to_dag(self) -> "CSRGraph":
        """Orient every edge low id -> high id. Anti-parallel pairs land on
        one (min, max) entry and add; self loops stay."""
        r, c, v = self.to_coo()
        return coo_to_csr(np.minimum(r, c), np.maximum(r, c), v,
                          self.shape)

    def eliminate_zeros(self) -> "CSRGraph":
        r, c, v = self.to_coo()
        keep = v != 0
        return coo_to_csr(r[keep], c[keep], v[keep], self.shape,
                          sum_duplicates=False)

    def permute(self, perm_new_to_old: np.ndarray) -> "CSRGraph":
        """Symmetric permutation ``out[i, j] = self[p[i], p[j]]`` with
        ``p[new] = old``; column ids within each row come out sorted."""
        p = np.asarray(perm_new_to_old, dtype=np.int64)
        assert self.shape[0] == self.shape[1] == p.shape[0]
        # native O(nnz) row gather + per-row sorts when the host library
        # builds; the numpy route pays a global (row, col) lexsort
        from gcn_tpu_torch.reorder import native as _reorder_native

        if _reorder_native.available():
            return _reorder_native.csr_permute(self, p)
        inv = np.empty_like(p)
        inv[p] = np.arange(p.shape[0])  # inv[old] = new
        r, c, v = self.to_coo()
        return coo_to_csr(inv[r], inv[c], v, self.shape,
                          sum_duplicates=False)

    def permute_rows(self, perm_new_to_old: np.ndarray) -> "CSRGraph":
        """Row-only permutation ``out[i, :] = self[p[i], :]``; each row keeps
        its column order."""
        p = np.asarray(perm_new_to_old, dtype=np.int64)
        counts = np.diff(self.indptr)[p]
        indptr = np.zeros(self.shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        # each new row's entries are the old row's range: one gather
        src = (np.repeat(self.indptr[p].astype(np.int64) - indptr[:-1],
                         counts) + np.arange(indptr[-1], dtype=np.int64))
        return CSRGraph(indptr, self.indices[src], self.data[src],
                        self.shape)

    def validate(self) -> None:
        """Raise AssertionError on the first broken CSR invariant, as
        gcn_tpu's ``validate``."""
        m, n = self.shape
        if self.indptr.shape != (m + 1,):
            raise AssertionError
        if not (self.indptr[0] == 0 and self.indptr[-1] == self.nnz):
            raise AssertionError
        if not np.all(np.diff(self.indptr) >= 0):
            raise AssertionError("indptr must be nondecreasing")
        if self.nnz and not (self.indices.min() >= 0
                             and self.indices.max() < n):
            raise AssertionError
        if self.data.shape != self.indices.shape:
            raise AssertionError

    def is_symmetric(self) -> bool:
        t = self.transpose()
        return (np.array_equal(t.indptr, self.indptr)
                and np.array_equal(t.indices, self.indices)
                and np.allclose(t.data, self.data))

    def isomorphism_checksum(self) -> np.ndarray:
        """Per-vertex permutation-invariant checksum: for each vertex, a sum
        over incident edges of (own degree + 1)(neighbour degree + 1)(edge
        weight). Graphs related by a relabelling have equal sorted arrays."""
        deg = self.row_degrees().astype(np.float64)
        r, c, v = self.to_coo()
        contrib = (deg[r] + 1.0) * (deg[c] + 1.0) * v.astype(np.float64)
        out = np.zeros(self.shape[0], dtype=np.float64)
        np.add.at(out, r, contrib)
        return out


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, vals: Optional[np.ndarray],
               shape: Tuple[int, int], *,
               sum_duplicates: bool = True) -> CSRGraph:
    """Build CSR from COO triples; rows grouped, columns sorted ascending."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if vals is None:
        vals = np.ones(rows.shape[0], dtype=np.float32)
    vals = np.asarray(vals, dtype=np.float32)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and rows.shape[0]:
        key_same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if key_same.any():
            group = np.concatenate([[0], np.cumsum(~key_same)])
            new_vals = np.zeros(group[-1] + 1, dtype=np.float64)
            np.add.at(new_vals, group, vals.astype(np.float64))
            first = np.concatenate([[True], ~key_same])
            rows, cols = rows[first], cols[first]
            vals = new_vals.astype(np.float32)
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRGraph(indptr.astype(np.int32), cols.astype(np.int32), vals,
                    shape)


def csr_to_coo(g: CSRGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rows = np.repeat(np.arange(g.shape[0], dtype=np.int32),
                     np.diff(g.indptr))
    return rows, g.indices.copy(), g.data.copy()
