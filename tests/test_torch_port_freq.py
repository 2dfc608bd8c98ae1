"""The port's frequency-split ELL tables against gcn_tpu's on the CPU: the
layout (arrays equal), the part-aware order, the SpMM forward and dX, and
the v6 GCN trained over it.

Tolerances: the tilers are the same numpy code, so arrays are equal; SpMM
outputs agree at rtol and atol 1e-5 (f32 sums in another order); 5-step
losses at rtol 1e-4 and final log-probs at rtol 1e-5 plus atol 1e-4, as
for the single-table path (tests/test_torch_port_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.models import GCN as JxGCN
from gcn_tpu.models.gcn_core import init_gcn_params as jx_init
from gcn_tpu.tile import freq_split as jx_fs
from gcn_tpu.tile.ell import ell_adjacency as jx_ell
from torch_port_graphs import TOL, powerlaw_graph, random_graph

from gcn_tpu_torch import train_gcn
from gcn_tpu_torch.convert import params_from_numpy
from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.models import GCN
from gcn_tpu_torch.ops import ell_spmm as es
from gcn_tpu_torch.ops.spmm import hoist_spmm, spmm
from gcn_tpu_torch.tile import freq_split as fs
from gcn_tpu_torch.tile.ell import ell_adjacency

_ELL_TENSORS = ("cols", "vals", "win", "t_cols", "t_vals", "t_win",
                "virt_map", "t_virt_map")
_ELL_META = ("n_rows", "n_cols", "nnz", "r", "k_pad", "symmetric", "chunks",
             "t_chunks", "spans", "t_spans", "n_virt", "n_hub", "t_n_virt",
             "t_n_hub", "table_bf16")


def _ell_equal(ours, ref):
    for name in _ELL_TENSORS:
        a, b = getattr(ours, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    for name in _ELL_META:
        assert getattr(ours, name) == getattr(ref, name), name


def _split_equal(ours, ref):
    for name in ("hot_rows", "n_rows", "n_cols", "nnz", "hot_nnz", "shape",
                 "k_pad", "hot_edge_fraction"):
        assert getattr(ours, name) == getattr(ref, name), name
    _ell_equal(ours.hot, ref.hot)
    assert (ours.cold is None) == (ref.cold is None)
    if ours.cold is not None:
        _ell_equal(ours.cold, ref.cold)
    for name in ("hot_unperm", "cold_unperm"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# (hot_rows, part_sort, k_pad): a split with a cold part, the same with
# per-part sorting, a wide k_pad (P = 1), and no cold part
CASES = {
    "split": (150, False, 32),
    "split_part_sort": (150, True, 32),
    "split_k_pad_128": (150, False, 128),
    "no_cold_part": (None, False, 32),
    "hot_rows_past_n": (10_000, True, 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ell_adjacency_freq_equals_gcn_tpu(case):
    hot_rows, part_sort, k_pad = CASES[case]
    g, jg = powerlaw_graph(31, n=1000, sort=True)
    kw = dict(hot_rows=hot_rows, part_sort=part_sort, k_pad=k_pad, r=16)
    ours = fs.ell_adjacency_freq(g, device="cpu", **kw)
    ref = jx_fs.ell_adjacency_freq(jg, **kw)
    _split_equal(ours, ref)
    assert (ours.cold is not None) == (hot_rows is not None
                                       and hot_rows < g.shape[1])
    ours.validate()


@pytest.mark.parametrize("case", ["split", "split_part_sort",
                                  "split_k_pad_128", "no_cold_part"])
def test_spmm_ell_freq_matches_gcn_tpu(case):
    """Forward and dX through both tables, against gcn_tpu's and against
    the single-table layout."""
    hot_rows, part_sort, k_pad = CASES[case]
    g, jg = powerlaw_graph(32, n=1000, sort=True)
    kw = dict(hot_rows=hot_rows, part_sort=part_sort, k_pad=k_pad, r=16)
    ours = fs.ell_adjacency_freq(g, device="cpu", **kw)
    ref = jx_fs.ell_adjacency_freq(jg, **kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((g.shape[1], 24)).astype(np.float32)
    ct = rng.standard_normal((g.shape[0], 24)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    out = spmm(ours, xt)
    out.backward(torch.tensor(ct))
    jout, vjp = jax.vjp(jax.jit(lambda xx: jx_fs.spmm_ell_freq(ref, xx)),
                        jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct))[0]), **TOL)
    single = ell_adjacency(g, k_pad=k_pad, r=16, device="cpu")
    xs = torch.tensor(x, requires_grad=True)
    want = es.spmm_ell(single, xs)
    want.backward(torch.tensor(ct))
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), xs.grad.numpy(), **TOL)
    np.testing.assert_allclose(hoist_spmm(ours, torch.tensor(x)).numpy(),
                               want.detach().numpy(), **TOL)


@pytest.mark.parametrize("n_cols", [1000, 204_800, 204_801, 3_000_000])
@pytest.mark.parametrize("table_bf16", [False, True])
def test_default_hot_rows_equals_gcn_tpu(n_cols, table_bf16):
    assert (fs.default_hot_rows(n_cols, table_bf16)
            == jx_fs.default_hot_rows(n_cols, table_bf16))


def test_freq_split_order_equals_gcn_tpu():
    g, jg = powerlaw_graph(33, n=1000, sort=True)
    for hot_rows in (150, 500):
        po = fs.freq_split_order(g, hot_rows=hot_rows)
        np.testing.assert_array_equal(
            po, jx_fs.freq_split_order(jg, hot_rows=hot_rows))
        assert sorted(po[:hot_rows]) == list(range(hot_rows))
    assert fs.freq_split_order(g) is None   # the whole table fits hot


def test_ell_adjacency_freq_defaults_to_the_card():
    g, _ = random_graph(34, symmetric=True, sort=True)
    if torch.cuda.is_available():
        assert fs.ell_adjacency_freq(g, hot_rows=64).hot.cols.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fs.ell_adjacency_freq(g, hot_rows=64)


@pytest.mark.parametrize("nhid", [4, 16])
def test_freq_split_fit_matches_gcn_tpu(nhid):
    """v6 over the split tables (hot_rows 64 forces a cold part on
    synth-tiny's 200 rows): the permutation, with freq_split_order
    composed in, and 5 steps (dropout 0) equal gcn_tpu's."""
    from gcn_tpu.data import get_dataset as jx_get_dataset

    data = jx_get_dataset("synth-tiny", seed=0)
    opts = {"freq_split": True, "hot_rows": 64}
    kw = dict(dropout=0.0, variant="v6", seed=3, adj_options=opts)
    nfeat, nclass = data.num_features, data.num_classes
    ref = JxGCN(nfeat, nhid, nclass, **kw)
    ref.fit(data.features, data.adj, data.labels, data.idx_train,
            train_iters=5)
    ours = GCN(nfeat, nhid, nclass, device="cpu", **kw)
    ours.params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jx_init(jax.random.PRNGKey(3), nfeat, nhid, nclass)),
        "cpu")
    pdata = get_dataset("synth-tiny", seed=0)
    ours.fit(pdata.features, pdata.adj, pdata.labels, pdata.idx_train,
             train_iters=5, initialize=False)
    assert isinstance(ours.adj_norm, fs.FreqSplitAdj)
    assert ours.adj_norm.cold is not None
    np.testing.assert_array_equal(ours.perm, ref.perm)
    np.testing.assert_allclose([h["loss_train"] for h in ours.history],
                               [h["loss_train"] for h in ref.history],
                               rtol=1e-4)
    np.testing.assert_allclose(ours.output.numpy(), np.asarray(ref.output),
                               rtol=1e-5, atol=1e-4)


def test_freq_split_fit_matches_single_table():
    """The same 5 steps over one table: losses at rtol 1e-4."""
    data = get_dataset("synth-tiny", seed=1)
    losses = []
    for opts in ({}, {"freq_split": True, "hot_rows": 48}):
        m = GCN(data.num_features, 8, data.num_classes, dropout=0.0,
                variant="v6", seed=2, adj_options=opts, device="cpu")
        m.fit(data.features, data.adj, data.labels, data.idx_train,
              train_iters=5)
        losses.append([h["loss_train"] for h in m.history])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def test_cli_freq_split_on_cpu(capsys):
    acc = train_gcn.main(["-g", "synth-tiny", "-k", "8", "-i", "5",
                          "--variant", "v6", "--freq-split", "--device",
                          "cpu"])
    assert "Test set results: loss= " in capsys.readouterr().out
    assert 0.0 <= acc <= 1.0


def test_single_table_tiler_is_unchanged():
    """The parts go through the same tiler as one table: a split whose hot
    prefix is every column is that one table."""
    g, jg = powerlaw_graph(35, n=1000, sort=True)
    whole = fs.ell_adjacency_freq(g, hot_rows=g.shape[1], r=16,
                                  device="cpu")
    _ell_equal(whole.hot, jx_ell(jg, r=16, symmetric=False))
