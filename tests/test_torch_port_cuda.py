"""Kernel K1 on the card, held against its plain version (marked ``cuda``;
each test skips without a GPU, since a CUDA kernel has no CPU mode).

This file imports neither jax nor gcn_tpu, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tolerance: f32 rtol 1e-5 and atol 1e-6 * max|out| (sums reassociated).
"""

import numpy as np
import pytest
import torch

from gcn_tpu_torch.graph.csr import coo_to_csr
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.ops import ell_spmm as es
from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel K1 has no CPU mode)")
    return torch.device("cuda")


def _hub_graph(seed=0, n=400):
    """Symmetric, degree-sorted, with hub rows that the tiler splits."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(300, np.int64), np.ones(250, np.int64),
                          rng.integers(2, n, 2000)])
    dst = rng.integers(0, n, src.shape[0])
    g = gcn_normalize(coo_to_csr(src, dst, None, (n, n)).symmetrize())
    return g.permute(degree_sort_order(g))


def _rect_graph(seed=1, n=300, m=700):
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(400, np.int64), rng.integers(1, n, 3000)])
    dst = rng.integers(0, m, src.shape[0])
    return coo_to_csr(src, dst, rng.random(src.shape[0]), (n, m))


def _close(got, want):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 32, 48, 128, 200])
@pytest.mark.parametrize("hub_split", [True, False])
def test_kernel_matches_plain_on_card(cuda, k, hub_split):
    g = _hub_graph()
    adj = ell_adjacency(g, r=8, k_pad=32, hub_split=hub_split, device=cuda)
    assert (adj.n_hub > 0) == hub_split
    x = torch.randn(g.shape[0], k, device=cuda)
    before = es.spmm_ell_launches
    got = es.ell_spmm(x, adj.cols, adj.vals, adj.win, adj.win_off,
                      adj.row_space)
    torch.cuda.synchronize()
    assert es.spmm_ell_launches == before + 1
    _close(got, es._ell_spmm_plain(x, adj.cols, adj.vals, adj.win,
                                   adj.win_off, adj.row_space))


@pytest.mark.cuda
def test_autograd_on_card_matches_cpu(cuda):
    """Forward and dX (transpose arrays of a non-symmetric matrix)."""
    g = _rect_graph()
    adj = ell_adjacency(g, r=8, k_pad=32)
    assert not adj.symmetric and adj.n_hub > 0
    x = torch.randn(g.shape[1], 16, requires_grad=True)
    ct = torch.randn(g.shape[0], 16)
    out = es.spmm_ell(adj, x)
    out.backward(ct)
    xc = x.detach().to(cuda).requires_grad_(True)
    out_c = es.spmm_ell(adj.to(cuda), xc)
    out_c.backward(ct.to(cuda))
    _close(out_c.detach().cpu(), out.detach())
    _close(xc.grad.cpu(), x.grad)


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(cuda):
    g = _hub_graph()
    adj = ell_adjacency(g, r=8, k_pad=32, device=cuda)
    with pytest.raises(TypeError):
        es.ell_spmm(torch.randn(g.shape[0], 8, device=cuda,
                                dtype=torch.float64),
                    adj.cols, adj.vals, adj.win, adj.win_off, adj.row_space)
    with pytest.raises(ValueError, match="contiguous"):
        es.ell_spmm(torch.randn(8, g.shape[0], device=cuda).t(), adj.cols,
                    adj.vals, adj.win, adj.win_off, adj.row_space)
    bf16 = ell_adjacency(g, r=8, k_pad=32, table_bf16=True, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        es.spmm_ell(bf16, torch.randn(g.shape[0], 8, device=cuda))


@pytest.mark.cuda
def test_v6_fit_on_card_matches_cpu(cuda):
    """Three v6 steps from the same parameters, card against CPU."""
    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.models import GCN

    data = get_dataset("synth-small", seed=0)
    losses = []
    p0 = None
    for device in ("cpu", cuda):
        m = GCN(data.num_features, 16, data.num_classes, variant="v6",
                dropout=0.0, device=device)
        p0 = p0 if p0 is not None else params_to_numpy(m.init_params())
        m.params = params_from_numpy(p0, device)
        m.fit(data.features, data.adj, data.labels, data.idx_train,
              train_iters=3, initialize=False)
        losses.append([h["loss_train"] for h in m.history])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
