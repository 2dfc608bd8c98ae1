"""The port's COO product (``CooAdj``, the adjacency GCN v1-v5 train on past
8,192 rows) against gcn_tpu's gather and sorted ``segment_sum``.

The port sums each row's run of edges in edge order by the row edge
counts made with the layout (``segment_lengths``), with no atomics; the
card's kernel, which walks the same runs by their offsets, is held to that
plain version in ``test_torch_port_cuda.py``. On the
CPU that is bit-equal to the ``index_add_`` it replaces, which adds in
edge order there; gcn_tpu's XLA sums are held at the f32 tolerance of
``test_torch_port_sddmm.py`` (products and fits) and ``test_torch_port_
model.py`` (atol 1e-4 plus rtol 1e-5 on the log-probs after 10 Adam
steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.data import get_dataset as jx_get_dataset
from gcn_tpu.models import GCN as JxGCN
from gcn_tpu.models.gcn_core import init_gcn_params as jx_init
from gcn_tpu.ops.adjacency import coo_adjacency as jx_coo_adjacency
from gcn_tpu.ops.spmm import spmm as jx_spmm
from gcn_tpu.parallel import partition as jx_part
from gcn_tpu.parallel.spmm_dist import local_spmm as jx_local_spmm
from torch_port_graphs import TOL, graphs

from gcn_tpu_torch.convert import params_from_numpy
from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.models import GCN
from gcn_tpu_torch.ops.adjacency import (EDGE_PAD, LONG_ROW, coo_adjacency,
                                         segment_lengths, walk_order)
from gcn_tpu_torch.ops.spmm import (_coo_spmm_kernel, _segment_spmm_plain,
                                    segment_sum, spmm)
from gcn_tpu_torch.parallel.partition import shard_graph_by_rows
from gcn_tpu_torch.parallel.spmm_dist import local_spmm
from gcn_tpu_torch.utils.timers import counters


def _graph(kind):
    """(port graph, gcn_tpu graph): a symmetric graph, or a rectangular
    one; both with empty rows (and, the rectangular one, empty
    columns) and a nnz that is no multiple of EDGE_PAD, so padding edges
    exist."""
    rng = np.random.default_rng(21 if kind == "symmetric" else 22)
    if kind == "symmetric":
        n, e = 120, 700
        src = rng.integers(0, n - 20, e)      # rows n-20.. stay empty
        dst = rng.integers(0, n - 20, e)
        vals = rng.random(e).astype(np.float32)
        return graphs(np.concatenate([src, dst]), np.concatenate([dst, src]),
                      np.concatenate([vals, vals]), (n, n))
    n, m, e = 90, 50, 600
    src = np.concatenate([np.zeros(70, np.int64),   # a long row
                          rng.integers(1, n - 10, e)])
    dst = rng.integers(0, m - 5, src.shape[0])
    return graphs(src, dst, rng.random(src.shape[0]).astype(np.float32),
                  (n, m))


def _index_add(rows, prod, n):
    """The reduction the port had: ``index_add_`` over the sorted rows."""
    return prod.new_zeros((n, prod.shape[1])).index_add_(0, rows, prod)


@pytest.mark.parametrize("kind", ["symmetric", "rectangular"])
def test_coo_spmm_matches_gcn_tpu(kind):
    """Forward, dX (over the transpose arrays) and the SDDMM dvals against
    gcn_tpu's ``spmm`` on its own ``CooAdj`` of the same graph."""
    g, jg = _graph(kind)
    adj = coo_adjacency(g, device="cpu")
    jadj = jx_coo_adjacency(jg)
    assert adj.symmetric == jadj.symmetric == (kind == "symmetric")
    for name in ("rows", "cols", "vals", "t_rows", "t_cols", "t_vals"):
        np.testing.assert_array_equal(getattr(adj, name).numpy(),
                                      np.asarray(getattr(jadj, name)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((g.shape[1], 12)).astype(np.float32)
    ct = rng.standard_normal((g.shape[0], 12)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    vals = adj.vals.clone().requires_grad_(True)
    out = spmm(dataclasses.replace(adj, vals=vals), xt)
    out.backward(torch.tensor(ct))
    jout, vjp = jax.vjp(jx_spmm, jadj, jnp.asarray(x))
    jd_adj, jdx = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(jd_adj.vals),
                               **TOL)


@pytest.mark.parametrize("kind", ["symmetric", "rectangular"])
@pytest.mark.parametrize("k", [1, 7, 32])
def test_segment_sum_bit_equal_to_index_add(kind, k):
    """On the CPU the fixed-order sum equals ``index_add_`` bit for bit,
    forward and over the transpose arrays (dX)."""
    g, _ = _graph(kind)
    adj = coo_adjacency(g, device="cpu")
    gen = torch.Generator().manual_seed(k)
    for rows, cols, vals, row_len, n_out, n_in in (
            (adj.rows, adj.cols, adj.vals, adj.row_len, adj.n_rows,
             adj.n_cols),
            (adj.t_rows, adj.t_cols, adj.t_vals, adj.t_row_len, adj.n_cols,
             adj.n_rows)):
        x = torch.randn(n_in, k, generator=gen)
        prod = x[cols] * vals[:, None]
        assert torch.equal(segment_sum(prod, row_len),
                           _index_add(rows, prod, n_out))
    x = torch.randn(adj.n_cols, k, generator=gen, requires_grad=True)
    ct = torch.randn(adj.n_rows, k, generator=gen)
    spmm(adj, x).backward(ct)
    assert torch.equal(x.grad, _index_add(adj.t_rows, ct[adj.t_cols]
                                          * adj.t_vals[:, None], adj.n_cols))


@pytest.mark.parametrize("kind,field", [
    ("symmetric", "row_len"), ("rectangular", "row_len"),
    ("symmetric", "row_ptr"), ("rectangular", "row_ptr"),
    ("symmetric", "row_order"), ("rectangular", "row_order")],
    ids=["symmetric", "rectangular", "symmetric-row_ptr",
         "rectangular-row_ptr", "symmetric-row_order",
         "rectangular-row_order"])
def test_row_lengths_cover_the_padded_edges(kind, field):
    """Each direction's counts are non-negative, one a row, and sum to the
    padded edge count; the padding edges are counted in row n-1; its
    offsets (``row_ptr``, the card kernel's) are ``[0] + cumsum`` of the
    counts, from 0 to the padded edge count; its walk order (``row_order``,
    ``long_rows``) is ``walk_order`` of the counts; a symmetric adjacency
    aliases all three."""
    g, _ = _graph(kind)
    adj = coo_adjacency(g, device="cpu")
    e_pad = adj.rows.shape[0]
    assert e_pad % EDGE_PAD == 0 and e_pad > g.nnz
    for row_len, row_ptr, order, n_long, n_out, other in (
            (adj.row_len, adj.row_ptr, adj.row_order, adj.long_rows,
             adj.n_rows, g),
            (adj.t_row_len, adj.t_row_ptr, adj.t_row_order, adj.t_long_rows,
             adj.n_cols, g.transpose())):
        assert row_len.dtype == torch.int64 and row_len.shape == (n_out,)
        assert (row_len >= 0).all() and int(row_len.sum()) == e_pad
        if field == "row_ptr":
            assert row_ptr.dtype == torch.int64
            assert row_ptr.shape == (n_out + 1,)
            np.testing.assert_array_equal(
                row_ptr.numpy(), np.concatenate([[0], np.cumsum(row_len)]))
            assert int(row_ptr[0]) == 0 and int(row_ptr[-1]) == e_pad
            continue
        if field == "row_order":
            assert order.dtype == torch.int64 and order.shape == (n_out,)
            want, want_long = walk_order(row_len.numpy())
            np.testing.assert_array_equal(order.numpy(), want)
            assert n_long == want_long
            continue
        csr_len = np.diff(other.indptr)
        np.testing.assert_array_equal(row_len[:-1].numpy(), csr_len[:-1])
        assert int(row_len[-1]) == csr_len[-1] + e_pad - g.nnz
        assert (row_len == 0).any()          # the empty rows
    alias = {"row_len": adj.t_row_len is adj.row_len,
             "row_ptr": adj.t_row_ptr is adj.row_ptr,
             "row_order": adj.t_row_order is adj.row_order}[field]
    assert alias == (kind == "symmetric")


def test_walk_order_hands_out_the_longest_rows_first():
    """The kernel's walk order is a permutation of the rows by edge count,
    longest first and ties in row order, and counts the rows of more than
    ``LONG_ROW`` edges, which lead it."""
    row_len = np.array([3, LONG_ROW + 1, 0, 3, 5 * LONG_ROW, LONG_ROW, 7])
    order, n_long = walk_order(row_len)
    np.testing.assert_array_equal(order, [4, 1, 5, 6, 0, 3, 2])
    assert n_long == 2
    assert (row_len[order[:n_long]] > LONG_ROW).all()
    assert (row_len[order[n_long:]] <= LONG_ROW).all()
    order, n_long = walk_order(np.zeros(0, np.int64))
    assert order.shape == (0,) and n_long == 0


@pytest.mark.parametrize("kind", ["symmetric", "rectangular"])
def test_cpu_product_takes_the_plain_path(kind):
    """On the CPU the COO product, forward and dX, is the plain version
    (gather, weight, ``segment_sum``): it counts under ``spmm_coo`` and
    leaves every ``spmm_coo_k<k>`` count, the card kernel's, at 0."""
    g, _ = _graph(kind)
    adj = coo_adjacency(g, device="cpu")
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(adj.n_cols, 5, generator=gen, requires_grad=True)
    counters.clear()
    out = spmm(adj, x)
    (dx,) = torch.autograd.grad(out, x, torch.ones_like(out))
    assert counters["spmm_coo"] == 2
    assert not [name for name in counters if name.startswith("spmm_coo_k")]
    assert torch.equal(out, _segment_spmm_plain(adj.cols, adj.vals,
                                                x.detach(), adj.row_len))
    assert torch.equal(dx, _segment_spmm_plain(
        adj.t_cols, adj.t_vals, torch.ones_like(out), adj.t_row_len))


def test_kernel_wrapper_refuses_what_the_kernel_cannot_take():
    """The card kernel's wrapper checks its operands before it builds or
    launches anything: float32 x and vals, int64 cols, offsets and walk
    order, one entry an edge and one a row, all on x's device."""
    g, _ = _graph("symmetric")
    adj = coo_adjacency(g, device="cpu")
    x = torch.randn(adj.n_cols, 4)
    args = dict(cols=adj.cols, vals=adj.vals, x=x, row_ptr=adj.row_ptr,
                order=adj.row_order, long_rows=adj.long_rows)
    for change, error in (
            (dict(x=x.double()), TypeError),
            (dict(vals=adj.vals.double()), TypeError),
            (dict(cols=adj.cols.int()), TypeError),
            (dict(row_ptr=adj.row_ptr.int()), TypeError),
            (dict(order=adj.row_order.int()), TypeError),
            (dict(vals=adj.vals[:-1]), ValueError),
            (dict(order=adj.row_order[:-1]), ValueError),
            (dict(long_rows=adj.n_rows + 1), ValueError),
            (dict(x=x[0]), ValueError),
            (dict(cols=adj.cols.to("meta")), ValueError)):
        with pytest.raises(error):
            _coo_spmm_kernel(**{**args, **change})


def test_segment_lengths_refuses_unsorted_rows():
    """The counts are read off the runs in order, so rows must be sorted
    (gcn_tpu's ``indices_are_sorted=True``) and in range."""
    np.testing.assert_array_equal(segment_lengths(np.array([0, 0, 2]), 4),
                                  [2, 0, 1, 0])
    with pytest.raises(ValueError, match="row-sorted"):
        segment_lengths(np.array([0, 2, 1]), 3)
    with pytest.raises(ValueError, match="out of range"):
        segment_lengths(np.array([0, 3]), 3)


def test_local_spmm_matches_gcn_tpu():
    """The all_gather baseline's per-shard product against gcn_tpu's
    ``local_spmm`` on each shard of a row-band partition, whose local rows
    the port's partitioner leaves sorted (the padding in the last local
    row) and ``segment_lengths`` accepts."""
    g, jg = _graph("symmetric")
    sg = shard_graph_by_rows(g, 4)
    jsg = jx_part.shard_graph_by_rows(jg, 4)
    np.testing.assert_array_equal(sg.rows_local, np.asarray(jsg.rows_local))
    x = np.random.default_rng(5).standard_normal(
        (sg.n_rows_padded, 9)).astype(np.float32)
    for s in range(sg.n_shards):
        assert (np.diff(sg.rows_local[s]) >= 0).all()
        row_len = torch.as_tensor(segment_lengths(sg.rows_local[s],
                                                  sg.rows_per_shard))
        got = local_spmm(torch.as_tensor(sg.cols[s], dtype=torch.int64),
                         torch.as_tensor(sg.vals[s]), torch.tensor(x),
                         row_len)
        want = jx_local_spmm(jnp.asarray(jsg.rows_local[s]),
                             jnp.asarray(jsg.cols[s]),
                             jnp.asarray(jsg.vals[s]), jnp.asarray(x),
                             sg.rows_per_shard)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4", "v5"])
def test_variant_fit_over_coo_matches_gcn_tpu(variant):
    """v1-v5 over ``adj_kind="coo"`` (dropout 0, gcn_tpu's initial
    parameters): per-step losses at rtol 1e-4 and the log-probs at atol
    1e-4 plus rtol 1e-5 against gcn_tpu's fit."""
    data = jx_get_dataset("synth-tiny", seed=2)
    nfeat, nclass = data.num_features, data.num_classes
    kw = dict(dropout=0.0, variant=variant, seed=4, adj_kind="coo")
    ref = JxGCN(nfeat, 8, nclass, **kw)
    ref.fit(data.features, data.adj, data.labels, data.idx_train,
            train_iters=10)
    ours = GCN(nfeat, 8, nclass, device="cpu", **kw)
    assert ours._orders() == ref._orders()
    ours.params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jx_init(jax.random.PRNGKey(4), nfeat, 8, nclass)), "cpu")
    pdata = get_dataset("synth-tiny", seed=2)
    ours.fit(pdata.features, pdata.adj, pdata.labels, pdata.idx_train,
             train_iters=10, initialize=False)
    assert type(ours.adj_norm).__name__ == "CooAdj"
    np.testing.assert_allclose([h["loss_train"] for h in ours.history],
                               [h["loss_train"] for h in ref.history],
                               rtol=1e-4)
    np.testing.assert_allclose(ours.output.numpy(), np.asarray(ref.output),
                               rtol=1e-5, atol=1e-4)
