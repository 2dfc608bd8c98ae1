"""Edge-weight gradients, the bf16 options, the COO/dense SpMMs and the
kernel build of the port, held against gcn_tpu where it has a counterpart."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.adjacency import device_adjacency as jx_device_adjacency
from gcn_tpu.ops.ell_spmm import spmm_ell as jx_spmm_ell
from gcn_tpu.ops.spmm import spmm as jx_spmm
from gcn_tpu.tile.ell import ell_adjacency as jx_ell
from torch_port_graphs import (TOL, fwd_bwd_pair, hub_graph, random_graph,
                               rect_graph)

from gcn_tpu_torch.ops import _build
from gcn_tpu_torch.ops import ell_spmm as es
from gcn_tpu_torch.ops.adjacency import device_adjacency
from gcn_tpu_torch.ops.spmm import hoist_spmm, spmm
from gcn_tpu_torch.tile.ell import ell_adjacency
from gcn_tpu_torch.utils.timers import counters


@pytest.mark.parametrize("hub", [False, True])
def test_dvals_matches_gcn_tpu_sddmm(hub):
    """vals.grad through a vals-requiring call == gcn_tpu's d_adj.vals
    (the ELL SDDMM), slot for slot."""
    g, jg = (hub_graph(13) if hub
             else random_graph(14, symmetric=True, sort=True))
    adj = ell_adjacency(g, r=8, k_pad=32, device="cpu")
    jadj = jx_ell(jg, r=8, k_pad=32)
    assert (adj.n_hub > 0) == hub
    rng = np.random.default_rng(1)
    x = rng.standard_normal((g.shape[0], 16)).astype(np.float32)
    ct = rng.standard_normal((g.shape[0], 16)).astype(np.float32)
    vals = adj.vals.clone().requires_grad_(True)
    out = es.spmm_ell(dataclasses.replace(adj, vals=vals), torch.tensor(x))
    out.backward(torch.tensor(ct))
    _, vjp = jax.vjp(lambda a: jx_spmm_ell(a, jnp.asarray(x)), jadj)
    jdv = np.asarray(vjp(jnp.asarray(ct))[0].vals)
    np.testing.assert_allclose(vals.grad.numpy(), jdv, **TOL)


def test_dvals_not_computed_unless_asked(monkeypatch):
    """The SDDMM runs only when autograd asks for vals."""
    called = []
    real = es._ell_sddmm
    monkeypatch.setattr(es, "_ell_sddmm",
                        lambda *a: called.append(1) or real(*a))
    g, _ = random_graph(15, symmetric=True, sort=True)
    adj = ell_adjacency(g, r=8, k_pad=32, device="cpu")
    x = torch.randn(g.shape[0], 8, requires_grad=True)
    es.spmm_ell(adj, x).sum().backward()
    assert not called and x.grad is not None
    vals = adj.vals.clone().requires_grad_(True)
    es.spmm_ell(dataclasses.replace(adj, vals=vals), x).sum().backward()
    assert called and vals.grad is not None


# table_bf16 rounds x identically in both packages (f32 after that);
# products_bf16 rounds f32 sums taken in another order, so a bf16 ulp
@pytest.mark.parametrize("option,tol", [("table_bf16", 1e-5),
                                        ("products_bf16", 2e-2)])
def test_bf16_options_on_cpu_match_gcn_tpu(option, tol):
    g, jg = random_graph(16, symmetric=True, sort=True)
    kw = dict(r=8, k_pad=32, **{option: True})
    out, dx, jout, jdx = fwd_bwd_pair(ell_adjacency(g, device="cpu", **kw),
                                      jx_ell(jg, **kw), 16)
    np.testing.assert_allclose(out, jout, rtol=tol, atol=tol)
    np.testing.assert_allclose(dx, jdx, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["coo", "dense"])
def test_coo_and_dense_match_gcn_tpu(kind):
    """Forward, dX and (coo) the SDDMM dvals, on a non-symmetric graph."""
    g, jg = rect_graph(17, n=64, m=64, e=400)
    adj = device_adjacency(g, kind, device="cpu")
    jadj = jx_device_adjacency(jg, kind)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    ct = rng.standard_normal((64, 8)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    if kind == "coo":
        vals = adj.vals.clone().requires_grad_(True)
        adj = dataclasses.replace(adj, vals=vals)
    out = spmm(adj, xt)
    out.backward(torch.tensor(ct))
    jout, vjp = jax.vjp(jx_spmm, jadj, jnp.asarray(x))
    jd_adj, jdx = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    if kind == "coo":
        np.testing.assert_allclose(vals.grad.numpy(),
                                   np.asarray(jd_adj.vals), **TOL)


def test_hoist_spmm_matches_whole():
    g, _ = random_graph(18, symmetric=True, sort=True)
    adj = ell_adjacency(g, r=8, k_pad=32, device="cpu")
    x = torch.randn(g.shape[0], 80)
    np.testing.assert_allclose(hoist_spmm(adj, x).numpy(),
                               es.spmm_ell(adj, x).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_spmm_shape_check_and_cpu_never_launches_kernel():
    g, _ = random_graph(19, symmetric=True, sort=True)
    adj = ell_adjacency(g, r=8, k_pad=32, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        spmm(adj, torch.zeros(g.shape[0] + 1, 4))
    before = counters["spmm_ell"]
    spmm(adj, torch.zeros(g.shape[0], 4))
    assert counters["spmm_ell"] == before


def test_freq_split_not_ported_raises():
    """freq_split is ported: device_adjacency builds it for kind "ell" and,
    as gcn_tpu does, raises ValueError for any other kind."""
    from gcn_tpu_torch.tile.freq_split import FreqSplitAdj

    g, _ = random_graph(20, symmetric=True, sort=True)
    adj = device_adjacency(g, "ell", device="cpu", freq_split=True,
                           hot_rows=64, r=16)
    assert isinstance(adj, FreqSplitAdj) and adj.cold is not None
    for kind in ("coo", "dense"):
        with pytest.raises(ValueError, match="freq_split requires"):
            device_adjacency(g, kind, device="cpu", freq_split=True)


def test_failed_nvcc_build_raises(monkeypatch, tmp_path):
    """A compiler failure raises BuildError; nothing falls back."""
    false = shutil.which("false")
    if false is None:
        pytest.skip("no `false` binary")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: false)
    with pytest.raises(_build.BuildError, match="exited"):
        _build.build_cuda_kernels()
    assert not list(tmp_path.glob("*.so"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build_cuda_kernels()
