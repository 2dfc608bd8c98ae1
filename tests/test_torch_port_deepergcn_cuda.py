"""DeeperGCN's softmax aggregation kernels (``ops/csrc/softmax_agg.cu``) on
the card, held against their plain version in float64, and the captured
``DeeperGCN.fit`` against the eager one (marked ``cuda``; each test skips
without a GPU, since a CUDA kernel has no CPU mode).

This file imports neither jax nor gcn_tpu:

    python -m pytest tests/test_torch_port_deepergcn_cuda.py -m cuda --noconftest -q

The graph has ogbn-arxiv's shape cut to 20,000 vertices, with self loops:
hubs whose rows hold more than ``LONG_ROW`` edges and an isolated last
vertex. Tolerance against the plain version computed in float64: rtol
1e-4 and atol 1e-5 of the largest element, for float32 sums over rows of
up to ~1,000 edges taken in another order, and an exp per element and
edge.
"""

import numpy as np
import pytest
import torch

from gcn_tpu_torch.graph.csr import coo_to_csr
from gcn_tpu_torch.models import DeeperGCN
from gcn_tpu_torch.models.gat import self_loop_layout
from gcn_tpu_torch.ops import softmax_agg
from gcn_tpu_torch.ops.adjacency import LONG_ROW
from gcn_tpu_torch.utils.timers import counters, recording

N = 20_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    hubs = np.repeat(np.arange(4), [1000, 600, 300, 200])
    src = np.concatenate([hubs, rng.integers(5, N - 1, 120_000)])
    dst = np.concatenate([rng.integers(5, N - 1, hubs.size),
                          rng.integers(5, N - 1, 120_000)])
    return coo_to_csr(src, dst, None, (N, N)).symmetrize()


def _inputs(k, device, scale=1.0, seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    m = scale * torch.rand((N, k), generator=gen, device=device) + 1e-7
    return m, torch.randn((N, k), generator=gen, device=device)


def _close(got, want, rtol=1e-4, atol_of_max=1e-5):
    want = want.to(got.dtype)
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=atol_of_max * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("k,t,scale", [(128, 0.1, 1.0), (128, 0.1, 800.0),
                                       (16, 1.0, 3.0), (200, 0.1, 5.0)])
def test_kernels_match_plain_on_card(cuda, k, t, scale):
    """At the cell's width, with t m up to ~80 at scale 800, and at
    narrower and wider widths (a group of 4 lanes; two float4s a lane)."""
    lay = self_loop_layout(_graph(), cuda)
    assert lay.long_rows == 3 and int(lay.row_len.max()) > LONG_ROW
    assert int(lay.row_len[-1]) == 1
    m, da = _inputs(k, cuda, scale)
    m.requires_grad_(True)
    got = softmax_agg.softmax_aggregate(lay, m, t)
    g_got, = torch.autograd.grad(got, m, da)
    m64 = m.detach().double().requires_grad_(True)
    want = softmax_agg._softmax_aggregate_plain(lay, m64, t)
    g_want, = torch.autograd.grad(want, m64, da.double())
    _close(got, want)
    _close(g_got, g_want)
    # the isolated last vertex aggregates its own row alone
    torch.testing.assert_close(got[-1], m[-1].detach(), rtol=1e-6, atol=0)
    with torch.no_grad():   # the evaluation forward, which keeps no lse
        assert torch.equal(softmax_agg.softmax_aggregate(lay, m, t), got)


@pytest.mark.cuda
def test_two_calls_are_bit_equal_on_card(cuda):
    lay = self_loop_layout(_graph(), cuda)
    m, da = _inputs(128, cuda)
    m.requires_grad_(True)
    runs = []
    for _ in range(2):
        out = softmax_agg.softmax_aggregate(lay, m, 0.1)
        runs.append([out, *torch.autograd.grad(out, m, da)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take_on_card(cuda):
    lay = self_loop_layout(_graph(), cuda)
    m, _ = _inputs(128, cuda)
    with pytest.raises(TypeError, match="float32"):
        softmax_agg.softmax_aggregate(lay, m.double(), 0.1)
    with pytest.raises(ValueError, match="multiple of 4"):
        softmax_agg.softmax_aggregate(lay, m[:, :126].contiguous(), 0.1)


def _fit(device, jit_loop, iters=10):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, 32)).astype(np.float32)
    labels = rng.integers(0, 7, N)
    model = DeeperGCN(32, 7, num_layers=6, hidden=128, seed=2,
                      device=device)
    model.fit(x, _graph(), labels, np.arange(0, N, 4),
              idx_val=np.arange(1, N, 4), train_iters=iters, mode="val",
              jit_loop=jit_loop)
    return model


@pytest.mark.cuda
def test_captured_fit_is_bit_equal_to_eager_on_card(cuda):
    eager, captured = _fit(cuda, False), _fit(cuda, True)
    assert [h["loss_train"] for h in captured.history] == \
        [h["loss_train"] for h in eager.history]
    assert captured.best_iter == eager.best_iter
    for tree in ("params", "buffers"):
        a, b = getattr(eager, tree), getattr(captured, tree)
        for name, layer in a.items():
            for k, t in layer.items():
                assert torch.equal(b[name][k], t), (tree, name, k)
    assert torch.equal(captured.output, eager.output)


@pytest.mark.cuda
def test_every_aggregation_takes_the_kernels_on_card(cuda):
    before = dict(counters)
    _fit(cuda, False, iters=3)
    calls = counters["softmax_agg"] - before.get("softmax_agg", 0)
    launches = counters["softmax_agg_k128"] - before.get(
        "softmax_agg_k128", 0)
    # 6 layers: 6 forward, 6 backward and 6 evaluation calls an
    # iteration, then the final evaluation's 6
    assert calls == 3 * 18 + 6 and launches == calls
    with recording() as spans:
        _fit(cuda, True)
    cap = next(s for s in spans if s.name == "loop.capture")
    assert cap.counts["softmax_agg"] == cap.counts["softmax_agg_k128"] == 18
