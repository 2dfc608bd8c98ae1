"""The plain references: TF32 rounding, the hand-written Adam, float32
against float64, and the hypergraph and normalisation built as the
configurations' sources define them (held against the port's host
functions, which follow the same sources)."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import common, hgnn
from benchmark.tests.tiny import tiny_cell


def test_tf32_rounds_to_nearest_even():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -10, one + 2 ** -11,
                      one + 3 * 2 ** -11, -(one + 3 * 2 ** -11),
                      one + 2 ** -11 + 2 ** -20], dtype=torch.float32)
    want = [one, one + 2 ** -10, one, one + 2 ** -9, -(one + 2 ** -9),
            one + 2 ** -10]
    assert common.tf32(x).tolist() == want


def test_adam_steps_equal_torch_adam_with_l2():
    gen = torch.Generator().manual_seed(0)
    p0 = [torch.randn(5, 3, generator=gen, dtype=torch.float64),
          torch.randn(3, generator=gen, dtype=torch.float64)]
    target = torch.randn(5, 3, generator=gen, dtype=torch.float64)

    def loss_fn(params, mask):
        w, b = params
        return (((w + b) * mask - target) ** 2).sum()

    masks = [torch.rand(5, 3, generator=gen, dtype=torch.float64) > 0.3
             for _ in range(4)]
    got = common.adam_steps(loss_fn, p0, masks, lrs=[0.01] * 4,
                            weight_decay=5e-4, betas=(0.9, 0.999),
                            eps=1e-8)
    params = [p.clone().requires_grad_(True) for p in p0]
    opt = torch.optim.Adam(params, lr=0.01, weight_decay=5e-4)
    for mask in masks:
        opt.zero_grad()
        loss_fn(params, mask).backward()
        opt.step()
    for a, b in zip(got.params, params):
        torch.testing.assert_close(a, b.detach(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("workload", ["gcn-arxiv.v6",
                                      "hgnn-modelnet40.dense"])
def test_float32_reference_against_float64(workload):
    cell = tiny_cell(workload)
    data = harness.make_inputs(cell.config)
    side = {}
    layers = [("a", data["features"].shape[1], 32),
              ("b", 32, int(data["labels"].max()) + 1)]
    p0 = harness.leaves(harness.init_params(layers, 7, "cpu"))
    for precision in ("float64", "float32"):
        problem = harness.reference_class(cell.config)(
            cell.config, data, "cpu", precision)
        side[precision] = problem.steps(p0, 11, 3)
    lo, hi = side["float32"], side["float64"]
    for a, b in zip(lo.losses, hi.losses):
        assert abs(a - b) <= 1e-6 * abs(b)
    for a, b in zip(lo.params, hi.params):
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-7)
    assert harness.worst_leaf(lo.grad1, hi.grad1) < 1e-5


def test_hypergraph_matches_the_sources_construction():
    from gcn_tpu_torch.graph.hypergraph import (construct_H_with_KNN,
                                                generate_G_from_H)

    rng = np.random.default_rng(3)
    x = rng.standard_normal((120, 12)).astype(np.float32)
    h_ref = hgnn.knn_incidence(torch.as_tensor(x, dtype=torch.float64), 10,
                               1.0, True)
    h_port = construct_H_with_KNN(x, 10, is_prob=True, m_prob=1.0)
    np.testing.assert_allclose(h_ref.numpy(), h_port, rtol=1e-6,
                               atol=1e-7)
    g_ref = hgnn.operator_g(h_ref).numpy()
    g_port = generate_G_from_H(h_port).to_dense()
    np.testing.assert_allclose(g_ref, g_port, rtol=1e-5, atol=1e-7)


def test_gcn_a_hat_matches_the_normalisation():
    from gcn_tpu_torch.graph.csr import CSRGraph
    from gcn_tpu_torch.graph.normalize import gcn_normalize

    cell = tiny_cell("gcn-arxiv.v6")
    data = harness.make_inputs(cell.config)
    problem = harness.reference_class(cell.config)(cell.config, data,
                                                    "cpu", "float64")
    n = data["n"]
    g = gcn_normalize(CSRGraph(data["indptr"], data["indices"],
                               np.ones(len(data["indices"]), np.float32),
                               (n, n)))
    np.testing.assert_allclose(problem.a_hat.mat.to_dense().numpy(),
                               g.to_dense(), rtol=1e-6, atol=1e-8)
