"""The port's PanelAdj tiler and panel SpMM against gcn_tpu's, on the same
inputs made with numpy.

The tiler's arrays are equal to gcn_tpu's, array for array, and obey
tests/test_tile.py's invariants plus the port's ``win_off``. On the CPU
``spmm_panel`` takes K2's plain version; it is held against
``gcn_tpu.ops.panel_spmm.spmm_panel`` (its Pallas kernel in interpret
mode), forward, dX and the edge-weight cotangent, at rtol/atol 1e-5 (f32
sums in another order). The kernel itself is held against the plain
version on the card in test_torch_port_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.panel_spmm import spmm_panel as jx_spmm_panel
from gcn_tpu.tile import panel_adjacency as jx_panel
from torch_port_graphs import PANEL_GRAPHS, TOL, graphs

from gcn_tpu_torch.ops import panel_spmm as ps
from gcn_tpu_torch.ops.adjacency import device_adjacency
from gcn_tpu_torch.ops.spmm import hoist_spmm, spmm
from gcn_tpu_torch.tile import PanelAdj, panel_adjacency
from gcn_tpu_torch.utils.timers import counters

_ARRAYS = ("cols", "vals", "local_row", "row_base", "t_cols", "t_vals",
           "t_local_row", "t_row_base")


@pytest.mark.parametrize("name", sorted(PANEL_GRAPHS))
def test_panel_arrays_equal_gcn_tpu(name):
    g, jg = PANEL_GRAPHS[name]()
    adj, jadj = panel_adjacency(g, device="cpu"), jx_panel(jg)
    for key in _ARRAYS:
        np.testing.assert_array_equal(getattr(adj, key).numpy(),
                                      np.asarray(getattr(jadj, key)),
                                      err_msg=key)
    for key in ("n_rows", "n_cols", "nnz", "r", "nb", "symmetric",
                "num_blocks", "shape", "pad_fraction"):
        assert getattr(adj, key) == getattr(jadj, key), key
    if adj.symmetric:
        assert adj.t_cols is adj.cols and adj.t_win_off is adj.win_off
    adj.validate()


@pytest.mark.parametrize("name", sorted(PANEL_GRAPHS))
def test_panel_tiler_invariants(name):
    """tests/test_tile.py's invariants, and win_off against row_base."""
    g, _ = PANEL_GRAPHS[name]()
    adj = panel_adjacency(g, device="cpu")
    cols, vals, lrow, base, off = (
        t.numpy() for t in (adj.cols, adj.vals, adj.local_row, adj.row_base,
                            adj.win_off))
    real = lrow < adj.r
    assert int(real.sum()) == g.nnz
    assert np.all(vals[~real] == 0)
    assert np.all(lrow[real] >= 0) and np.all(base % adj.r == 0)
    rows = (base[:, None] + lrow)[real]
    assert np.array_equal(np.bincount(rows, minlength=g.shape[0]),
                          g.row_degrees())
    assert np.isclose(vals.sum(), g.data.sum(), rtol=1e-5)
    dense = np.zeros(g.shape, np.float32)
    np.add.at(dense, (rows, cols[real]), vals[real])
    np.testing.assert_allclose(dense, g.to_dense(), atol=1e-6)
    nw = -(-g.shape[0] // adj.r)
    assert off.shape == (nw + 1,) and off[-1] == adj.num_blocks
    assert (np.diff(off) >= 1).all()
    for w in range(nw):
        assert (base[off[w]:off[w + 1]] == w * adj.r).all()
    if name == "powerlaw":
        assert g.row_degrees().max() > adj.nb
        assert np.diff(off).max() > 1
    if name == "empty_window":
        assert not real[off[1]:off[2]].any()


def test_panel_validate_catches_broken_layouts():
    g, _ = PANEL_GRAPHS["rect"]()
    adj = panel_adjacency(g, device="cpu")
    bad = adj.win_off.clone()
    bad[1] += 1
    with pytest.raises(AssertionError, match="win_off"):
        dataclasses.replace(adj, win_off=bad).validate()
    # K2 needs each window's rows in CSR order: swap two slots of rows
    lrow = adj.local_row.clone()
    lrow[0, [0, 40]] = lrow[0, [40, 0]]
    assert lrow[0, 0] != lrow[0, 40]
    with pytest.raises(AssertionError, match="decreases"):
        dataclasses.replace(adj, local_row=lrow).validate()


def _zero_weight_graph():
    """Non-symmetric, with one stored edge of weight exactly 0.0."""
    rng = np.random.default_rng(25)
    src = rng.integers(0, 260, 2400)
    dst = rng.integers(0, 180, 2400)
    vals = rng.random(2400).astype(np.float32)
    src[0], dst[0], vals[0] = 7, 11, 0.0
    keep = ~((src == 7) & (dst == 11))
    keep[0] = True
    return graphs(src[keep], dst[keep], vals[keep], (260, 180))


@pytest.mark.parametrize("name", ["sbm", "powerlaw", "zero_weight"])
def test_spmm_panel_matches_gcn_tpu(name):
    """Forward, dX and dvals against jax.vjp of gcn_tpu's spmm_panel."""
    g, jg = (_zero_weight_graph() if name == "zero_weight"
             else PANEL_GRAPHS[name]())
    adj, jadj = panel_adjacency(g, device="cpu"), jx_panel(jg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((g.shape[1], 8)).astype(np.float32)
    ct = rng.standard_normal((g.shape[0], 8)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    vals = adj.vals.clone().requires_grad_(True)
    out = spmm(dataclasses.replace(adj, vals=vals), xt)
    out.backward(torch.tensor(ct))
    jout, vjp = jax.vjp(jx_spmm_panel, jadj, jnp.asarray(x))
    jd_adj, jdx = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    jdv = np.asarray(jd_adj.vals)
    np.testing.assert_allclose(vals.grad.numpy(), jdv, **TOL)
    if name == "zero_weight":
        # the stored 0.0 edge gets its true cotangent, not the padding's 0
        slot = ((adj.local_row.numpy() < adj.r) & (adj.vals.numpy() == 0))
        assert slot.sum() == 1
        assert vals.grad.numpy()[slot][0] == jdv[slot][0] != 0
    dense = g.to_dense().astype(np.float64)
    np.testing.assert_allclose(out.detach().numpy(), dense @ x, **TOL)


def test_dvals_not_computed_unless_asked(monkeypatch):
    called = []
    real = ps._panel_sddmm
    monkeypatch.setattr(ps, "_panel_sddmm",
                        lambda *a: called.append(1) or real(*a))
    g, _ = PANEL_GRAPHS["sbm"]()
    adj = panel_adjacency(g, device="cpu")
    x = torch.randn(g.shape[0], 8, requires_grad=True)
    ps.spmm_panel(adj, x).sum().backward()
    assert not called and x.grad is not None
    vals = adj.vals.clone().requires_grad_(True)
    ps.spmm_panel(dataclasses.replace(adj, vals=vals), x).sum().backward()
    assert called and vals.grad is not None


def test_hoist_over_panel_matches_whole_and_never_launches_on_cpu():
    g, _ = PANEL_GRAPHS["sbm"]()
    adj = panel_adjacency(g, device="cpu")
    x = torch.randn(g.shape[0], 80)
    before = counters["spmm_panel"]
    np.testing.assert_allclose(hoist_spmm(adj, x).numpy(),
                               ps.spmm_panel(adj, x).detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    assert counters["spmm_panel"] == before


def test_panel_kind_and_shape_mismatch_raise():
    g, _ = PANEL_GRAPHS["rect"]()
    with pytest.raises(ValueError, match="test-side reference"):
        device_adjacency(g, "panel")
    adj = panel_adjacency(g, device="cpu")
    assert isinstance(adj, PanelAdj) and not adj.symmetric
    with pytest.raises(ValueError, match="shape mismatch"):
        spmm(adj, torch.zeros(g.shape[0], 4))


def test_panel_adjacency_defaults_to_the_card():
    """No device means the card: without a GPU the tiler raises rather than
    building on the CPU."""
    g, _ = PANEL_GRAPHS["sbm"]()
    if torch.cuda.is_available():
        assert panel_adjacency(g).cols.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            panel_adjacency(g)


def test_panel_to_keeps_aliases():
    g, _ = PANEL_GRAPHS["sbm"]()
    adj = panel_adjacency(g, device="cpu").to("cpu")
    assert adj.symmetric and adj.t_vals is adj.vals
    assert adj.t_win_off is adj.win_off
