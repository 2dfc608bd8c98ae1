"""The port's host pipeline equals gcn_tpu's: datasets, normalization,
reordering (every method, native and numpy) and the ELL tiler give the same
arrays (synth-tiny and synth-pubmed; k_pad 32 and 128; with and without hub
splitting)."""

import numpy as np
import pytest
import torch

from gcn_tpu.data import get_dataset as jx_get_dataset
from gcn_tpu.graph.normalize import gcn_normalize as jx_normalize
from gcn_tpu.reorder import compute_permutation as jx_permutation
from gcn_tpu.reorder import native as jx_native
from gcn_tpu.tile.ell import degree_sort_order as jx_degree_sort
from gcn_tpu.tile.ell import ell_adjacency as jx_ell

from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.reorder import METHODS, compute_permutation, reorder_graph
from gcn_tpu_torch.reorder import native
from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency
from torch_port_native import native_reorder  # noqa: F401 (autouse)

DATASETS = ("synth-tiny", "synth-pubmed")
# a heavy-tailed graph whose hub rows the tiler splits (the SBM datasets
# above have none), built by both packages' powerlaw_sbm
POWERLAW = "powerlaw-3000"


def _graphs(name):
    if name == POWERLAW:
        from gcn_tpu.data.synthetic import powerlaw_sbm as jx_powerlaw

        from gcn_tpu_torch.data.synthetic import powerlaw_sbm

        kw = dict(n=3000, n_classes=5, avg_degree=13.7, seed=0)
        return powerlaw_sbm(**kw)[0], jx_powerlaw(**kw)[0]
    return get_dataset(name, seed=0).adj, jx_get_dataset(name, seed=0).adj


def _csr_equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.fixture(scope="module")
def pipelines():
    """name -> (port graph after rabbit + degree sort, jax one)."""
    out = {}
    for name in DATASETS + (POWERLAW,):
        g, jg = _graphs(name)
        g = gcn_normalize(g)
        g, _ = reorder_graph(g, "rabbit")
        g = g.permute(degree_sort_order(g))
        jg = jx_normalize(jg)
        from gcn_tpu.reorder import reorder_graph as jx_reorder

        jg, _ = jx_reorder(jg, "rabbit")
        jg = jg.permute(jx_degree_sort(jg))
        out[name] = (g, jg)
    return out


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_and_normalize_bit_equal(name):
    ours, ref = get_dataset(name, seed=3), jx_get_dataset(name, seed=3)
    _csr_equal(ours.adj, ref.adj)
    for field in ("features", "labels", "idx_train", "idx_val", "idx_test"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _csr_equal(gcn_normalize(ours.adj), jx_normalize(ref.adj))


def _normalized(name):
    """(port graph, jax graph) of ``name`` after gcn_normalize."""
    if name in DATASETS + ("synth-cora-hard",):
        return (gcn_normalize(get_dataset(name, seed=0).adj),
                jx_normalize(jx_get_dataset(name, seed=0).adj))
    g, jg = _graphs(name)
    return gcn_normalize(g), jx_normalize(jg)


@pytest.mark.parametrize("name", DATASETS + ("synth-cora-hard", POWERLAW))
@pytest.mark.parametrize("method", METHODS)
def test_reorder_permutation_equal(name, method):
    if not (native.available() and jx_native.available()):
        pytest.skip("a native reorder library did not build")
    g, jg = _normalized(name)
    perm = compute_permutation(g, method)
    np.testing.assert_array_equal(perm, jx_permutation(jg, method))
    g2, perm2 = reorder_graph(g, method)
    np.testing.assert_array_equal(perm2, perm)
    _csr_equal(g2, jg.permute(perm))


@pytest.mark.parametrize("method", METHODS)
def test_numpy_fallbacks_match_reference_numpy(method):
    """The numpy passes (used where no host compiler exists) equal
    gcn_tpu's numpy passes, on synth-tiny and the powerlaw graph, and the
    numpy permute equals the native one."""
    for name in ("synth-tiny", POWERLAW):
        g, jg = _normalized(name)
        np.testing.assert_array_equal(
            compute_permutation(g, method, prefer_native=False),
            jx_permutation(jg, method, prefer_native=False), err_msg=name)
    g, _ = _normalized("synth-tiny")
    perm = compute_permutation(g, method, prefer_native=False)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    r, c, v = g.to_coo()
    numpy_route = CSRGraph.from_coo(inv[r], inv[c], v, g.shape,
                                    sum_duplicates=False)
    _csr_equal(g.permute(perm), numpy_route)


def _ell_equal(ours, ref):
    for name in ("cols", "vals", "win", "t_cols", "t_vals", "t_win"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("virt_map", "t_virt_map"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("n_rows", "n_cols", "nnz", "r", "k_pad", "symmetric",
                 "chunks", "t_chunks", "spans", "t_spans",
                 "span_pass_limit", "n_virt", "n_hub", "t_n_virt",
                 "t_n_hub", "products_bf16", "table_bf16"):
        assert getattr(ours, name) == getattr(ref, name), name


@pytest.mark.parametrize("name", DATASETS + (POWERLAW,))
@pytest.mark.parametrize("k_pad", [32, 128])
@pytest.mark.parametrize("hub_split", [True, False])
def test_ell_adjacency_array_equal(pipelines, name, k_pad, hub_split):
    g, jg = pipelines[name]
    _csr_equal(g, jg)
    ours = ell_adjacency(g, k_pad=k_pad, symmetric=True, hub_split=hub_split,
                         device="cpu")
    ref = jx_ell(jg, k_pad=k_pad, symmetric=True, hub_split=hub_split)
    _ell_equal(ours, ref)
    if name == POWERLAW and k_pad == 32:
        assert (ours.n_hub > 0) == hub_split, "fixture must split hub rows"
    ours.validate()
    # win_off is the first block of each window
    win = ours.win.numpy()
    off = ours.win_off.numpy()
    assert off[0] == 0 and off[-1] == len(win)
    assert len(off) == ours.num_windows + 1
    for w in range(ours.num_windows):
        assert (win[off[w]:off[w + 1]] == w).all()


def test_ell_adjacency_nonsymmetric_equal():
    """Rectangular matrix: the transpose arrays are tiled on their own."""
    rng = np.random.default_rng(5)
    src = np.concatenate([np.zeros(300, np.int64), rng.integers(1, 96, 400)])
    dst = rng.integers(0, 256, 700)
    vals = rng.random(700).astype(np.float32)
    from gcn_tpu.graph.csr import coo_to_csr as jx_coo

    from gcn_tpu_torch.graph.csr import coo_to_csr

    g = coo_to_csr(src, dst, vals, (96, 256))
    jg = jx_coo(src, dst, vals, (96, 256))
    ours = ell_adjacency(g, r=8, k_pad=32, device="cpu")
    ref = jx_ell(jg, r=8, k_pad=32)
    assert not ours.symmetric and ours.n_hub > 0
    _ell_equal(ours, ref)
    ours.validate()


def test_ell_adjacency_device_move_keeps_aliases():
    g = gcn_normalize(get_dataset("synth-tiny", seed=0).adj)
    adj = ell_adjacency(g, k_pad=32, symmetric=True, device="cpu")
    moved = adj.to(torch.device("cpu"))
    assert moved.t_cols is moved.cols and moved.t_win_off is moved.win_off


def _default_device_builders():
    """Each public layout builder, the weight carrier and the parameter
    initializers, called with no device."""
    from gcn_tpu_torch.convert import params_from_numpy
    from gcn_tpu_torch.models.gcn_core import init_gcn_params
    from gcn_tpu_torch.models.hgnn import init_hgnn_params
    from gcn_tpu_torch.models.layers import init_linear
    from gcn_tpu_torch.ops.adjacency import (coo_adjacency, dense_adjacency,
                                             device_adjacency)

    g = gcn_normalize(get_dataset("synth-tiny", seed=0).adj)
    params = {"gc1": {"w": np.ones((3, 2), np.float32)}}
    return {
        "ell_adjacency": (lambda **d: ell_adjacency(g, **d),
                          lambda a: a.cols),
        "coo_adjacency": (lambda **d: coo_adjacency(g, **d),
                          lambda a: a.rows),
        "dense_adjacency": (lambda **d: dense_adjacency(g, **d),
                            lambda a: a.mat),
        "device_adjacency_ell": (lambda **d: device_adjacency(g, "ell", **d),
                                 lambda a: a.cols),
        "device_adjacency_coo": (lambda **d: device_adjacency(g, "coo", **d),
                                 lambda a: a.rows),
        "device_adjacency_dense": (
            lambda **d: device_adjacency(g, "dense", **d), lambda a: a.mat),
        "params_from_numpy": (lambda **d: params_from_numpy(params, **d),
                              lambda p: p["gc1"]["w"]),
        "init_linear": (lambda **d: init_linear(torch.Generator(), 3, 2, **d),
                        lambda p: p["w"]),
        "init_gcn_params": (
            lambda **d: init_gcn_params(torch.Generator(), 3, 4, 2, **d),
            lambda p: p["gc2"]["b"]),
        "init_hgnn_params": (
            lambda **d: init_hgnn_params(torch.Generator(), 3, 4, 2, **d),
            lambda p: p["hgc1"]["w"]),
    }


@pytest.mark.parametrize("name", ["ell_adjacency", "coo_adjacency",
                                  "dense_adjacency", "device_adjacency_ell",
                                  "device_adjacency_coo",
                                  "device_adjacency_dense",
                                  "params_from_numpy", "init_linear",
                                  "init_gcn_params", "init_hgnn_params"])
def test_builders_default_to_the_card(name):
    """No device means the card: without a GPU each builder raises rather
    than building on the CPU; ``device="cpu"`` builds on the CPU."""
    build, tensor = _default_device_builders()[name]
    if torch.cuda.is_available():
        assert tensor(build()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert tensor(build(device="cpu")).device.type == "cpu"
