"""GAT's attention kernels (``ops/csrc/gat_attn.cu``) on the card, held
against their plain version, and the captured GAT fit against the eager
one (marked ``cuda``; each test skips without a GPU, since a CUDA kernel
has no CPU mode).

This file imports neither jax nor gcn_tpu:

    python -m pytest tests/test_torch_port_gat_cuda.py -m cuda --noconftest -q

The graph has ogbn-arxiv's shape cut to 20,000 vertices: hubs whose rows
hold more than ``LONG_ROW`` edges, an isolated last vertex beside
``CooAdj``'s padding, and a number of edges that is not a multiple of
``EDGE_PAD``; a second graph of the same size plants 40 communities
behind a shuffled vertex order, where the layout's community order and
``walk_order``'s longest-first one must give the same bits. Tolerance
against the plain version computed in float64: rtol 1e-4 and atol 1e-5
of the largest element, for float32 sums over rows of up to ~1,000
edges taken in another order, and an exp per edge.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gcn_tpu_torch.data.synthetic import sbm
from gcn_tpu_torch.graph.csr import coo_to_csr
from gcn_tpu_torch.models.gat import GAT
from gcn_tpu_torch.ops import gat_attn
from gcn_tpu_torch.ops.adjacency import (EDGE_PAD, LONG_ROW,
                                         device_adjacency, walk_order)
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


def _layout(device):
    g = _graph().with_self_loops()
    return gat_attn.gat_layout(device_adjacency(g, "coo", device=device))


def _inputs(heads, width, device, seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device)
            for shape in ((N, heads, width), (N, heads), (N, heads))]


def _close(got, want, rtol=1e-4, atol_of_max=1e-5):
    want = want.to(got.dtype)
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=atol_of_max * want.abs().max().item())


SHAPES = [(4, 256), (6, 40), (2, 7), (1, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("heads,width", SHAPES)
def test_kernels_match_plain_on_card(cuda, heads, width):
    lay = _layout(cuda)
    assert lay.long_rows == 3 and lay.nnz % EDGE_PAD != 0
    assert int(lay.row_len[-1]) == 1 and int(lay.row_len.max()) > LONG_ROW
    wh, el, er = [t.requires_grad_(True) for t in _inputs(heads, width, cuda)]
    dout = torch.randn((N, heads, width), device=cuda)
    got = gat_attn.gat_attention(lay, wh, el, er)
    g_got = torch.autograd.grad(got, (wh, el, er), dout)
    w64 = [t.detach().double().requires_grad_(True) for t in (wh, el, er)]
    want = gat_attn._gat_attention_plain(lay, *w64, 0.2)
    g_want = torch.autograd.grad(want, w64, dout.double())
    _close(got, want)
    # the isolated last vertex attends to itself alone
    torch.testing.assert_close(got[-1], wh[-1], rtol=1e-6, atol=0)
    for a, b in zip(g_got, g_want):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,width", SHAPES[:2])
def test_two_calls_are_bit_equal_on_card(cuda, heads, width):
    lay = _layout(cuda)
    wh, el, er = [t.requires_grad_(True) for t in _inputs(heads, width, cuda)]
    dout = torch.randn((N, heads, width), device=cuda)
    runs = []
    for _ in range(2):
        out = gat_attn.gat_attention(lay, wh, el, er)
        runs.append([out, *torch.autograd.grad(out, (wh, el, er), dout)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _community_layout(device):
    """A + I of 40 planted communities in shuffled vertex order, with
    hubs of up to 1,000 neighbours, laid out by ``gat_layout``."""
    g, _ = sbm(N, 40, avg_degree=14.0, p_in_frac=0.9, seed=5)
    r, c, _ = g.to_coo()
    hubs = np.repeat(np.arange(3), [1000, 600, 300])
    far = np.random.default_rng(6).integers(3, N, hubs.size)
    g = coo_to_csr(np.concatenate([r, hubs]), np.concatenate([c, far]),
                   None, (N, N)).symmetrize().with_self_loops()
    return gat_attn.gat_layout(device_adjacency(g, "coo", device=device))


def _results(lay, leaves, dout):
    """out, lse (the forward's saved row logsumexp) and the cotangents of
    wh, el and er."""
    out = gat_attn.gat_attention(lay, *leaves)
    lse = out.grad_fn.saved_tensors[4]
    return [out.detach(), lse, *torch.autograd.grad(out, leaves, dout)]


@pytest.mark.cuda
@pytest.mark.parametrize("heads,width", SHAPES[:2])
def test_community_order_is_bit_equal_to_longest_first_on_card(cuda, heads,
                                                               width):
    """The rows' order decides which group walks a row and when, never
    the order of a row's sums: the layout's community order and
    ``walk_order``'s longest-first order give the same bits."""
    lay = _community_layout(cuda)
    assert lay.long_rows == lay.t_long_rows == 3
    longest = dataclasses.replace(
        lay, row_order=torch.from_numpy(walk_order(
            lay.row_len.cpu().numpy())[0]).to(cuda),
        t_row_order=torch.from_numpy(walk_order(
            torch.diff(lay.t_row_ptr).cpu().numpy())[0]).to(cuda))
    assert not torch.equal(longest.row_order, lay.row_order)
    assert torch.equal(longest.row_order[:3], lay.row_order[:3])
    leaves = [t.requires_grad_(True) for t in _inputs(heads, width, cuda)]
    dout = torch.randn((N, heads, width), device=cuda)
    for name, a, b in zip(("out", "lse", "dwh", "d_el", "d_er"),
                          _results(lay, leaves, dout),
                          _results(longest, leaves, dout)):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_kernels_refuse_float64_on_card(cuda):
    lay = _layout(cuda)
    wh, el, er = (t.double() for t in _inputs(2, 8, cuda))
    with pytest.raises(TypeError, match="float32"):
        gat_attn.gat_attention(lay, wh, el, er)


def _fit(device, jit_loop, iters=6):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, 32)).astype(np.float32)
    labels = rng.integers(0, 7, N)
    model = GAT(32, 7, heads=(4, 4, 6), hidden=(64, 64), seed=2,
                device=device)
    model.fit(x, _graph(), labels, np.arange(0, N, 4),
              idx_val=np.arange(1, N, 4), train_iters=iters, mode="val",
              jit_loop=jit_loop)
    return model


@pytest.mark.cuda
def test_captured_gat_fit_is_bit_equal_to_eager_on_card(cuda):
    eager, captured = _fit(cuda, False), _fit(cuda, True)
    assert [h["loss_train"] for h in captured.history] == \
        [h["loss_train"] for h in eager.history]
    for name, layer in eager.params.items():
        for k, t in layer.items():
            assert torch.equal(captured.params[name][k], t), (name, k)
    assert torch.equal(captured.output, eager.output)


@pytest.mark.cuda
def test_every_attention_call_takes_the_kernels_on_card(cuda):
    before = dict(counters)
    _fit(cuda, False, iters=3)
    calls = counters["gat_attn"] - before.get("gat_attn", 0)
    launches = sum(v - before.get(k, 0) for k, v in counters.items()
                   if k.startswith("gat_attn_h"))
    # 9 calls an iteration, then the final evaluation's 3 forward calls
    # (the eager flavor runs the captured one's iteration and finish)
    assert calls == 3 * 9 + 3 and launches == calls
    with recording() as spans:
        _fit(cuda, True)
    cap = next(s for s in spans if s.name == "loop.capture")
    assert cap.counts["gat_attn"] == 9
    assert sum(v for k, v in cap.counts.items()
               if k.startswith("gat_attn_h")) == 9
