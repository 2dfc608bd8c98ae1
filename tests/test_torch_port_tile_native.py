"""The port's native ELL tiler and the rest of its CSRGraph against
gcn_tpu's, on the CPU.

``gcn_tpu_torch/tile/csrc/tiler.cpp`` (a copy of gcn_tpu's) builds with g++
into ``gcn_tpu_torch/_build/``; its arrays equal the numpy tiler's and
gcn_tpu's, element for element, through ``ell_adjacency`` with and without
``prefer_native`` (whichever route gcn_tpu takes on this host) at P = 4 and
P = 1, on the shared test graphs and a hub-split graph. Where the pass
ladder applies, both packages take the numpy layout. ``copy``, ``to_dag``,
``eliminate_zeros``, ``permute_rows`` and ``validate`` equal gcn_tpu's:
arrays, dtypes, column order and the error raised.
"""

import numpy as np
import pytest

from gcn_tpu.graph.csr import CSRGraph as JxCSR
from gcn_tpu.tile.ell import ell_adjacency as jx_ell

from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.ops import _build
from gcn_tpu_torch.tile import native
from gcn_tpu_torch.tile.ell import _ell_arrays, ell_adjacency, tile_route
from torch_port_graphs import hub_graph, powerlaw_graph, random_graph
from torch_port_graphs import sbm_graph

GRAPHS = {
    "random": lambda: random_graph(21, symmetric=True, sort=True),
    "random_unsorted": lambda: random_graph(22, n=300, m=2500),
    "sbm": sbm_graph,
    "powerlaw": lambda: powerlaw_graph(23, sort=True),
    "hub_split": lambda: hub_graph(24),
}
FIELDS = ("cols", "vals", "win", "t_cols", "t_vals", "t_win")


def test_native_tiler_builds_into_the_build_directory():
    assert native.available()
    path = _build.library_path("gcntiler", native.SOURCES, "g++")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert _build._loaded["gcntiler"]._name == path


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("r,p", [(8, 4), (16, 4), (8, 1), (32, 1)])
def test_native_arrays_equal_numpy(name, r, p):
    """The native tiler alone against the numpy tiler, no forced passes."""
    g, _ = GRAPHS[name]()
    n = g.shape[0]
    want = _ell_arrays(g.indptr, g.indices, g.data, n, r, p)[:3]
    got = native.ell_arrays(g.indptr, g.indices, g.data, n, r, p)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_native_tiler_rejects_arrays_that_do_not_fit():
    """Checked before any pointer reaches the library."""
    g, _ = GRAPHS["random"]()
    n = g.shape[0]
    for args in ((g.indptr[:-1], g.indices, g.data, n, 8, 4),
                 (g.indptr, g.indices[:-1], g.data, n, 8, 4),
                 (g.indptr, g.indices, g.data, n + 1, 8, 4),
                 (g.indptr, g.indices, g.data, n, 0, 4)):
        with pytest.raises(ValueError):
            native.ell_arrays(*args)


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("k_pad", [32, 128], ids=["P4", "P1"])
def test_ell_adjacency_equals_gcn_tpu_on_every_route(name, k_pad):
    """Native and numpy routes of the port against both of gcn_tpu's; the
    hub-split graph splits its hub rows at P = 4."""
    g, jg = GRAPHS[name]()
    kw = dict(r=16, k_pad=k_pad)
    want = jx_ell(jg, prefer_native=False, **kw)
    runs = [jx_ell(jg, prefer_native=True, **kw)]
    for prefer in (True, False):
        runs.append(ell_adjacency(g, prefer_native=prefer, device="cpu",
                                  **kw))
    if name == "hub_split" and k_pad == 32:
        assert runs[1].n_hub > 0
    for adj in runs:
        for f in FIELDS:
            a, b = np.asarray(getattr(adj, f)), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert adj.spans == want.spans and adj.chunks == want.chunks
    for f in ("win_off", "t_win_off"):
        assert np.array_equal(getattr(runs[1], f), getattr(runs[2], f))


def test_prefer_native_routes():
    """The native tiler lays out where no ladder applies; prefer_native
    False takes numpy; the laddered case (the degree-sorted power-law graph
    at P = 1: more than 48 distinct pass counts) takes the numpy layout at
    the ladder whatever prefer_native says."""
    g, _ = GRAPHS["sbm"]()
    a = ell_adjacency(g, r=16, device="cpu")
    assert (a.tiler, a.t_tiler) == ("native", "native")
    b = ell_adjacency(g, r=16, prefer_native=False, device="cpu")
    assert (b.tiler, b.t_tiler) == ("numpy", "numpy")
    assert tile_route(g.indptr, g.shape[0], 16, 4) == ("native", None)
    h, _ = GRAPHS["powerlaw"]()
    for prefer in (True, False):
        c = ell_adjacency(h, r=8, k_pad=128, prefer_native=prefer,
                          device="cpu")
        assert (c.tiler, c.t_tiler) == ("ladder", "ladder")
    assert ell_adjacency(h, r=8, k_pad=32, device="cpu").tiler == "native"


def _pair(seed, n=60, e=400, zeros=True):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, e), rng.integers(0, n, e)
    v = rng.standard_normal(e).astype(np.float32)
    if zeros:
        v[::5] = 0.0
    jg = JxCSR.from_coo(r, c, v, (n, n), sum_duplicates=False)
    return CSRGraph(jg.indptr, jg.indices, jg.data, jg.shape), jg


def _same(a, b):
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("method", ["copy", "to_dag", "eliminate_zeros",
                                    "permute_rows"])
def test_csr_methods_equal_gcn_tpu(method):
    g, jg = _pair(31)
    perm = np.random.default_rng(4).permutation(g.shape[0])
    args = (perm,) if method == "permute_rows" else ()
    got, want = getattr(g, method)(*args), getattr(jg, method)(*args)
    _same(got, want)
    if method == "copy":
        assert got.indices is not g.indices and got.data is not g.data
    if method == "permute_rows":
        # each row keeps its column order (sorted, as the source's)
        assert np.array_equal(got.indices[got.indptr[0]:got.indptr[1]],
                              g.indices[g.indptr[perm[0]]:
                                        g.indptr[perm[0] + 1]])
    empty, jempty = (CSRGraph([0] * 5, [], [], (4, 4)),
                     JxCSR([0] * 5, [], [], (4, 4)))
    eargs = (np.arange(4)[::-1],) if method == "permute_rows" else ()
    _same(getattr(empty, method)(*eargs), getattr(jempty, method)(*eargs))


@pytest.mark.parametrize("break_it", [None, "indptr_len", "indptr_end",
                                      "decreasing", "col_range",
                                      "data_len"])
def test_validate_equals_gcn_tpu(break_it):
    g, jg = _pair(32, zeros=False)
    arrays = dict(indptr=g.indptr.copy(), indices=g.indices.copy(),
                  data=g.data.copy())
    if break_it == "indptr_len":
        arrays["indptr"] = arrays["indptr"][:-1]
    elif break_it == "indptr_end":
        arrays["indptr"][-1] += 1
    elif break_it == "decreasing":
        arrays["indptr"][3] = arrays["indptr"][4] + 1
    elif break_it == "col_range":
        arrays["indices"][0] = g.shape[1]
    elif break_it == "data_len":
        arrays["data"] = arrays["data"][:-1]
    outcomes = []
    for cls in (CSRGraph, JxCSR):
        graph = cls(arrays["indptr"], arrays["indices"], arrays["data"],
                    g.shape)
        try:
            graph.validate()
            outcomes.append(None)
        except AssertionError as e:
            outcomes.append(("AssertionError", str(e)))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (break_it is None)
