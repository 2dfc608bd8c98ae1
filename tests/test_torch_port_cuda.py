"""Kernels K1 (ELL SpMM) and K2 (panel SpMM) on the card, held against
their plain versions (marked ``cuda``; each test skips without a GPU, since
a CUDA kernel has no CPU mode).

This file imports neither jax nor gcn_tpu, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tolerance: f32 rtol 1e-5 and atol 1e-6 * max|out| (sums reassociated);
fits card against CPU: losses at rtol 1e-4; K1's products_bf16 at rtol and
atol 2e-2, since a bf16 ulp can flip when the f32 sums it rounds are taken
in another order.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from gcn_tpu_torch.graph.csr import coo_to_csr
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.ops import ell_spmm as es
from gcn_tpu_torch.ops import panel_spmm as ps
from gcn_tpu_torch.tile import panel_adjacency
from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency
from gcn_tpu_torch.tile.tiler import default_split_slots, split_plan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
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


def _close(got, want, rtol=1e-5, atol_of_max=1e-6):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol_of_max * scale)


def _share_close(got, want, rtol=1e-5, atol_of_max=1e-6):
    """Share of the elements of ``got`` within ``_close``'s tolerance."""
    limit = rtol * want.abs() + atol_of_max * want.abs().max()
    return ((got - want).abs() <= limit).float().mean().item()


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
    adj = ell_adjacency(g, r=8, k_pad=32, device="cpu")
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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32, 128])
@pytest.mark.parametrize("option,rtol", [("table_bf16", 1e-5),
                                         ("products_bf16", 2e-2)])
def test_kernel_bf16_options_match_plain_on_card(cuda, k, option, rtol):
    """The bf16 variants of K1 launch (one launch each) and agree with the
    plain version given the same option: table_bf16 at the f32 tolerance,
    products_bf16 at rtol and atol 2e-2. products_bf16 must also really
    round: nearly every element equals the plain version at the f32
    tolerance (a bf16 ulp may flip), and most differ from f32 K1 by more."""
    g = _hub_graph()
    adj = ell_adjacency(g, r=8, k_pad=32, device=cuda)
    x = torch.randn(g.shape[0], k, device=cuda)
    arrays = (adj.cols, adj.vals, adj.win, adj.win_off)
    opts = {option: True}
    before = es.spmm_ell_launches
    got = es.ell_spmm(x, *arrays, adj.row_space, **opts)
    torch.cuda.synchronize()
    assert es.spmm_ell_launches == before + 1
    want = es.ell_spmm(x.cpu(), *(a.cpu() for a in arrays), adj.row_space,
                       **opts)
    if option == "table_bf16":
        _close(got.cpu(), want, rtol=rtol)
        return
    torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=rtol)
    f32 = es.ell_spmm(x, *arrays, adj.row_space)
    assert _share_close(got.cpu(), want) >= 0.99
    assert _share_close(got, f32) <= 0.5


def _panel_graphs():
    """(name, graph): hub rows spanning several blocks, a rectangular
    non-symmetric matrix, and a graph with 128+ edgeless rows in a row."""
    rng = np.random.default_rng(3)
    n = 700
    src = np.concatenate([np.zeros(1300, np.int64), np.ones(600, np.int64),
                          rng.integers(2, n, 4000)])
    hub = gcn_normalize(coo_to_csr(src, rng.integers(0, n, src.shape[0]),
                                   None, (n, n)).symmetrize())
    rows = np.concatenate([rng.integers(0, 100, 800),
                           rng.integers(300, 400, 800)])
    gap = coo_to_csr(rows, rng.integers(0, 400, rows.shape[0]),
                     rng.random(rows.shape[0]), (400, 400))
    return [("hub", hub.permute(degree_sort_order(hub))),
            ("rect", _rect_graph()), ("empty_window", gap)]


def _panel_direction(adj, t):
    """(arrays, n_in, n_out, plan) of the forward or the transpose."""
    if t:
        return ((adj.t_cols, adj.t_vals, adj.t_local_row, adj.t_row_base,
                 adj.t_win_off), adj.n_rows, adj.n_cols, adj.t_plan)
    return ((adj.cols, adj.vals, adj.local_row, adj.row_base, adj.win_off),
            adj.n_cols, adj.n_rows, adj.plan)


# k % 4 != 0 goes through the wrapper's zero-padded copy of x
@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 32, 33, 48, 128])
@pytest.mark.parametrize("r,nb", [(128, 512), (16, 128)])
def test_panel_kernel_matches_plain_on_card(cuda, k, r, nb):
    for name, g in _panel_graphs():
        adj = panel_adjacency(g, r=r, nb=nb, device=cuda)
        for t in (False, True):
            arrays, n_in, n_out, plan = _panel_direction(adj, t)
            x = torch.randn(n_in, k, device=cuda)
            before = ps.spmm_panel_launches
            got = ps.panel_spmm(x, *arrays, adj.r, n_out, plan)
            torch.cuda.synchronize()
            assert ps.spmm_panel_launches == before + 1, name
            want = ps._panel_spmm_plain(x, *arrays[:4], adj.r, n_out)
            _close(got, want)


@pytest.mark.cuda
def test_panel_kernel_on_unaligned_x(cuda):
    """x that starts 4 bytes past a 16-byte boundary (k % 4 == 0) goes
    through the wrapper's aligned copy and agrees all the same."""
    adj = panel_adjacency(_rect_graph(), device=cuda)
    k = 32
    x = torch.randn(adj.n_cols * k + 1, device=cuda)[1:].view(adj.n_cols, k)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    arrays = (adj.cols, adj.vals, adj.local_row, adj.row_base, adj.win_off)
    _close(ps.panel_spmm(x, *arrays, adj.r, adj.n_rows, adj.plan),
           ps._panel_spmm_plain(x, *arrays[:4], adj.r, adj.n_rows))


@pytest.mark.cuda
def test_panel_autograd_on_card_matches_cpu(cuda):
    """Forward, dX and dvals of a non-symmetric matrix, card against CPU."""
    import dataclasses

    adj = panel_adjacency(_rect_graph(), device="cpu")
    assert not adj.symmetric
    x = torch.randn(adj.n_cols, 16, requires_grad=True)
    ct = torch.randn(adj.n_rows, 16)
    vals = adj.vals.clone().requires_grad_(True)
    out = ps.spmm_panel(dataclasses.replace(adj, vals=vals), x)
    out.backward(ct)
    adj_c = adj.to(cuda)
    xc = x.detach().to(cuda).requires_grad_(True)
    vc = adj_c.vals.clone().requires_grad_(True)
    out_c = ps.spmm_panel(dataclasses.replace(adj_c, vals=vc), xc)
    out_c.backward(ct.to(cuda))
    _close(out_c.detach().cpu(), out.detach())
    _close(xc.grad.cpu(), x.grad)
    _close(vc.grad.cpu(), vals.grad)


@pytest.mark.cuda
def test_panel_kernel_rejects_bad_operands(cuda):
    adj = panel_adjacency(_rect_graph(), device=cuda)
    arrays = (adj.cols, adj.vals, adj.local_row, adj.row_base, adj.win_off)
    with pytest.raises(TypeError):
        ps.panel_spmm(torch.randn(adj.n_cols, 8, device=cuda,
                                  dtype=torch.float64), *arrays, adj.r,
                      adj.n_rows, adj.plan)
    with pytest.raises(ValueError, match="contiguous"):
        ps.panel_spmm(torch.randn(8, adj.n_cols, device=cuda).t(), *arrays,
                      adj.r, adj.n_rows, adj.plan)
    with pytest.raises(ValueError, match="windows"):
        ps.panel_spmm(torch.randn(adj.n_cols, 8, device=cuda), *arrays,
                      adj.r, adj.n_rows + adj.r, adj.plan)


def _ell_arrays(adj, t=False):
    if t:
        return (adj.t_cols, adj.t_vals, adj.t_win, adj.t_win_off,
                adj.t_row_space)
    return adj.cols, adj.vals, adj.win, adj.win_off, adj.row_space


def _cap_graph(seed=0, n=1500, hub=383):
    """Symmetric, degree-sorted: one hub of degree 384 (self loop
    included), which the hub split cuts into chunks of exactly 64 slots
    (16 pass-blocks of P = 4), and a sparse tail of one-block windows."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(hub, np.int64), rng.integers(1, n, 2000)])
    dst = np.concatenate([np.arange(1, hub + 1), rng.integers(0, n, 2000)])
    g = gcn_normalize(coo_to_csr(src, dst, None, (n, n)).symmetrize())
    return g.permute(degree_sort_order(g))


@pytest.mark.cuda
@pytest.mark.parametrize("r,hub_split", [(8, True), (128, True), (8, False)])
@pytest.mark.parametrize("option", [None, "table_bf16", "products_bf16"])
def test_kernel_window_extents_on_card(cuda, r, hub_split, option):
    """Windows at the 16-pass-block hub cap (and, without the hub split,
    past it) beside windows of one pass-block, in every variant."""
    g = _cap_graph()
    adj = ell_adjacency(g, r=r, k_pad=32, hub_split=hub_split, device=cuda)
    blocks = adj.win_off.diff()
    assert int(blocks.min()) == 1
    assert (int(blocks.max()) == adj.span_pass_limit if hub_split
            else int(blocks.max()) > adj.span_pass_limit)
    x = torch.randn(g.shape[0], 32, device=cuda)
    opts = {option: True} if option else {}
    arrays = _ell_arrays(adj)
    got = es.ell_spmm(x, *arrays, **opts)
    want = es.ell_spmm(x.cpu(), *(a.cpu() for a in arrays[:4]), arrays[4],
                       **opts)
    if option == "products_bf16":
        torch.testing.assert_close(got.cpu(), want, rtol=2e-2, atol=2e-2)
        assert _share_close(got.cpu(), want) >= 0.99
    else:
        _close(got.cpu(), want)


@pytest.mark.cuda
def test_kernel_empty_windows_on_card(cuda):
    """Windows that own no pass-block come out as zero rows."""
    rng = np.random.default_rng(5)
    per_window = np.array([2, 0, 1, 0, 3, 1, 0])
    r, p, n_in = 8, 4, 50
    nb = int(per_window.sum())
    win_off = np.concatenate([[0], np.cumsum(per_window)]).astype(np.int32)
    win = np.repeat(np.arange(per_window.size), per_window).astype(np.int32)
    cols = rng.integers(0, n_in, (nb, p, r)).astype(np.int32)
    vals = rng.random((nb, p, r)).astype(np.float32)
    arrays = [torch.from_numpy(a) for a in (cols, vals, win, win_off)]
    n_out = per_window.size * r - 3
    x = torch.randn(n_in, 32)
    want = es.ell_spmm(x, *arrays, n_out)
    got = es.ell_spmm(x.to(cuda), *(a.to(cuda) for a in arrays), n_out)
    assert not want[r:2 * r].any()
    _close(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 32, 33, 128, 200])
@pytest.mark.parametrize("view", ["contiguous", "unaligned", "stride_k_plus_1",
                                  "stride_k_plus_4"])
def test_kernel_widths_and_x_views_on_card(cuda, k, view):
    """Every width through K1's column tiles, and x views that the vector
    loads read in place (a row stride that is a multiple of 4) or that the
    wrapper first copies (an unaligned base, a stride of k + 1)."""
    g = _hub_graph()
    adj = ell_adjacency(g, r=128, k_pad=32, device=cuda)
    n = g.shape[0]
    if view == "contiguous":
        x = torch.randn(n, k, device=cuda)
    elif view == "unaligned":
        x = torch.randn(n * k + 1, device=cuda)[1:].view(n, k)
    else:
        extra = 1 if view == "stride_k_plus_1" else 4
        x = torch.randn(n, k + extra, device=cuda)[:, :k]
    arrays = _ell_arrays(adj)
    got = es.ell_spmm(x, *arrays)
    want = es._ell_spmm_plain(x.contiguous(), *arrays)
    _close(got, want)


@pytest.mark.cuda
def test_kernels_are_deterministic_on_card(cuda):
    """Two calls of each kernel on the same inputs are bit-equal."""
    g = _hub_graph()
    adj = ell_adjacency(g, r=128, k_pad=32, device=cuda)
    x = torch.randn(g.shape[0], 64, device=cuda)
    for opts in ({}, {"table_bf16": True}, {"products_bf16": True}):
        a = es.ell_spmm(x, *_ell_arrays(adj), **opts)
        b = es.ell_spmm(x, *_ell_arrays(adj), **opts)
        assert torch.equal(a, b), opts
    padj = _with_split(panel_adjacency(_split_graph(), device=cuda), 0)
    arrays, n_in, n_out, plan = _panel_direction(padj, False)
    assert plan[0].numel() > 0
    x = torch.randn(n_in, 64, device=cuda)
    a = ps.panel_spmm(x, *arrays, padj.r, n_out, plan)
    b = ps.panel_spmm(x, *arrays, padj.r, n_out, plan)
    assert torch.equal(a, b)


def _split_graph(seed=4, n=3000):
    """Degree-sorted powerlaw graph whose first window holds 85 of ~480
    blocks: far past K2's split threshold."""
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(1.0, n) * 4 + 1).astype(np.int64), 1500)
    deg[:3] = (1500, 900, 700)
    src = np.repeat(np.arange(n), deg)
    g = gcn_normalize(coo_to_csr(src, rng.integers(0, n, src.shape[0]),
                                 None, (n, n)).symmetrize())
    return g.permute(degree_sort_order(g))


def _with_split(adj, split_slots):
    """``adj`` with K2's split plan remade at ``split_slots`` slots (the
    graph is symmetric: the transpose plan is the forward one)."""
    plan = tuple(torch.from_numpy(a).to(adj.win_off.device) for a in
                 split_plan(adj.win_off.cpu().numpy(), adj.nb, split_slots))
    return dataclasses.replace(
        adj, heavy=plan[0], heavy_parts=plan[1], light=plan[2],
        t_heavy=plan[0], t_heavy_parts=plan[1], t_light=plan[2])


def _split_features(adj):
    """(runs crossing a part boundary, parts of padding only) over the
    forward plan's heavy windows."""
    off = adj.win_off.cpu().numpy()
    lrow = adj.local_row.cpu().numpy().reshape(-1)
    heavy, parts, _ = (t.cpu().numpy() for t in adj.plan)
    cross = pad_only = 0
    for h, w in enumerate(heavy):
        s0 = int(off[w]) * adj.nb
        for q in range(1, parts.shape[1] - 1):
            b = s0 + parts[h, q]
            cross += int(parts[h, q] < parts[h, -1]
                         and lrow[b - 1] == lrow[b] < adj.r)
        for q in range(parts.shape[1] - 1):
            seg = lrow[s0 + parts[h, q]:s0 + parts[h, q + 1]]
            pad_only += int(seg.size > 0 and (seg == adj.r).all())
    return cross, pad_only


@pytest.mark.cuda
@pytest.mark.parametrize("split_slots", [None, 0, 6000, 1 << 30])
@pytest.mark.parametrize("k", [8, 32, 33, 128])
def test_panel_split_windows_match_plain_on_card(cuda, split_slots, k):
    """Heavy windows split across a cluster, beside light ones: every
    window heavy (0; runs cross part boundaries, and some parts hold only
    padding), a mix (6000), none (1 << 30) and the default threshold, the
    per-SM mean of slots over the card's SMs."""
    adj = panel_adjacency(_split_graph(), device=cuda)
    if split_slots is not None:
        adj = _with_split(adj, split_slots)
    adj.validate()
    n_heavy = adj.heavy.numel()
    if split_slots == 0:
        cross, pad_only = _split_features(adj)
        assert n_heavy == adj.win_off.numel() - 1
        assert cross > 0 and pad_only > 0
    elif split_slots == 6000:
        assert 0 < n_heavy < adj.win_off.numel() - 1
    elif split_slots == 1 << 30:
        assert n_heavy == 0
    else:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        limit = default_split_slots(adj.win_off.cpu().numpy(), adj.nb, sms)
        slots = adj.win_off.diff().cpu().numpy() * adj.nb
        assert adj.heavy.tolist() == np.flatnonzero(slots > limit).tolist()
        assert adj.heavy[0] == 0
    arrays, n_in, n_out, plan = _panel_direction(adj, False)
    x = torch.randn(n_in, k, device=cuda)
    before = ps.spmm_panel_launches
    got = ps.panel_spmm(x, *arrays, adj.r, n_out, plan)
    torch.cuda.synchronize()
    assert ps.spmm_panel_launches == before + 1
    _close(got, ps._panel_spmm_plain(x, *arrays[:4], adj.r, n_out))


def _hypergraph(seed=6, n=600):
    """The KNN hypergraph of a feature cloud: G (symmetric in exact
    arithmetic) and its two factors, n x n_e and n_e x n, not symmetric."""
    from gcn_tpu_torch.graph.hypergraph import (construct_H_with_KNN,
                                                generate_G_factors,
                                                generate_G_from_H)

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    h = construct_H_with_KNN(x, 10)
    return generate_G_from_H(h), generate_G_factors(h)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, 40, 1])
def test_kernel_on_k_pad_128_layout_on_card(cuda, k):
    """K1 on a P = 1 layout (k_pad 128, HGNN's G at n_hid 128), forward
    and through the transpose arrays, against the plain version, at the
    widths HGNN launches it: the hoist, each epoch, the row sum."""
    g, _ = _hypergraph()
    adj = ell_adjacency(g, k_pad=128, device=cuda)
    assert adj.p == 1
    for t in (False, True):
        arrays = _ell_arrays(adj, t)
        x = torch.randn(g.shape[0], k, device=cuda)
        before = es.spmm_ell_launches
        got = es.ell_spmm(x, *arrays)
        torch.cuda.synchronize()
        assert es.spmm_ell_launches == before + 1
        _close(got, es._ell_spmm_plain(x, *arrays))


@pytest.mark.cuda
@pytest.mark.parametrize("k_pad", [32, 128])
def test_kernel_on_hypergraph_factors_on_card(cuda, k_pad):
    """The two factors of G (rectangular in general, never symmetric):
    forward and the transpose arrays at the widths HGNN launches them (the
    hoist's 32-column chunks, each epoch's 40, the row sum's 1) and at
    128, and TwoHopAdj through autograd, card against CPU."""
    from gcn_tpu_torch.ops.spmm import TwoHopAdj, spmm

    _, factors = _hypergraph()
    adjs = [ell_adjacency(f, k_pad=k_pad, device="cpu") for f in factors]
    for a in adjs:
        assert not a.symmetric
        ac = a.to(cuda)
        for t in (False, True):
            arrays = _ell_arrays(ac, t)
            for k in (128, 40, 32, 1):
                x = torch.randn(a.n_rows if t else a.n_cols, k, device=cuda)
                _close(es.ell_spmm(x, *arrays),
                       es._ell_spmm_plain(x, *arrays))
    two_hop = TwoHopAdj(*adjs)
    x = torch.randn(two_hop.shape[1], 40, requires_grad=True)
    ct = torch.randn(two_hop.shape[0], 40)
    spmm(two_hop, x).backward(ct)
    xc = x.detach().to(cuda).requires_grad_(True)
    before = es.spmm_ell_launches
    out = spmm(TwoHopAdj(*(a.to(cuda) for a in adjs)), xc)
    out.backward(ct.to(cuda))
    torch.cuda.synchronize()
    assert es.spmm_ell_launches == before + 4
    _close(xc.grad.cpu(), x.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 33])
def test_kernel_on_freq_split_parts_on_card(cuda, k):
    """K1 on the hot and cold parts (rectangular, with transpose arrays)
    through spmm_ell_freq, forward and dX, card against CPU; the slices
    x[:H] and x[H:] are read in place or copied by the wrapper."""
    from gcn_tpu_torch.tile.freq_split import (ell_adjacency_freq,
                                               spmm_ell_freq)

    g = _split_graph()
    fs = ell_adjacency_freq(g, hot_rows=301, r=128, device="cpu")
    assert fs.cold is not None
    fs_c = ell_adjacency_freq(g, hot_rows=301, r=128, device=cuda)
    x = torch.randn(g.shape[0], k, requires_grad=True)
    ct = torch.randn(g.shape[0], k)
    out = spmm_ell_freq(fs, x)
    out.backward(ct)
    xc = x.detach().to(cuda).requires_grad_(True)
    before = es.spmm_ell_launches
    out_c = spmm_ell_freq(fs_c, xc)
    out_c.backward(ct.to(cuda))
    torch.cuda.synchronize()
    assert es.spmm_ell_launches == before + 4
    _close(out_c.detach().cpu(), out.detach())
    _close(xc.grad.cpu(), x.grad)


@pytest.mark.cuda
def test_hgnn_fit_on_card_matches_cpu(cuda):
    """Three HGNN epochs over ELL-lowered G (k_pad 128) and its factors,
    card against CPU from the same parameters (dropout 0)."""
    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.models import HGNN

    g, factors = _hypergraph()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((g.shape[0], 64)).astype(np.float32)
    labels = rng.integers(0, 5, g.shape[0])
    for G in (g, factors):
        losses, p0 = [], None
        for device in ("cpu", cuda):
            m = HGNN(64, 5, n_hid=128, dropout=0.0, adj_kind="ell",
                     milestones=(2,), device=device)
            p0 = p0 if p0 is not None else params_to_numpy(m.init_params())
            m.params = params_from_numpy(p0, device)
            m.fit(x, G, labels, np.arange(400), idx_val=np.arange(400, 600),
                  num_epochs=3)
            losses.append([h["loss_train"] for h in m.history])
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def _sharded_problem(device, n_shards=4):
    """A community graph cut into ``n_shards`` in-band degree-sorted bands,
    with its ragged plan and pass-block parts on ``device``."""
    from gcn_tpu_torch.data.synthetic import class_features, sbm
    from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                        build_halo_plan_ragged,
                                        build_sharded_ell_blocks,
                                        rows_per_shard_for,
                                        shard_graph_by_rows)

    adj, labels = sbm(n=2000, n_classes=5, avg_degree=10.0, seed=11)
    g = gcn_normalize(adj)
    perm = band_degree_sort_order(g, rows_per_shard_for(2000, n_shards))
    g = g.permute(perm)
    x = class_features(labels, feat_dim=24, seed=11)[perm]
    sg = shard_graph_by_rows(g, n_shards)
    plan = build_halo_plan_ragged(sg)
    parts = build_sharded_ell_blocks(sg, plan, k_pad=32, device=device)
    return g, sg, x, labels[perm], parts


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 40, 8])
@pytest.mark.parametrize("part", ["interior", "halo"])
@pytest.mark.parametrize("t", [False, True])
def test_kernel_on_sharded_parts_on_card(cuda, k, part, t):
    """K1 on every shard's interior and halo part, forward and through the
    transpose arrays, at the widths the sharded step launches."""
    _, _, _, _, parts = _sharded_problem(cuda)
    for a in parts[part == "halo"]:
        cols, vals, win, win_off, n_out, n_in = (
            (a.t_cols, a.t_vals, a.t_win, a.t_win_off, a.n_cols, a.n_rows)
            if t else (a.cols, a.vals, a.win, a.win_off, a.n_rows,
                       a.n_cols))
        x = torch.randn(n_in, k, device=cuda)
        before = es.spmm_ell_launches
        got = es.ell_spmm(x, cols, vals, win, win_off, n_out)
        torch.cuda.synchronize()
        assert es.spmm_ell_launches == before + 1
        _close(got, es._ell_spmm_plain(x.double(), cols, vals.double(), win,
                                       win_off, n_out).float())


@pytest.mark.cuda
def test_sharded_fit_on_card_matches_cpu(cuda):
    """Two sharded steps at dropout 0, four shards in one process, card
    against CPU from the same parameters: losses at rtol 1e-4, eval
    log-probs at atol 1e-4 + rtol 1e-5; the card's run launches K1 for
    every per-shard SpMM and the CPU's none."""
    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.models.gcn_core import init_gcn_params
    from gcn_tpu_torch.parallel import (create_mesh,
                                        make_sharded_gcn_train_step)
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.checkpoint import named_leaves

    g, sg, x, labels, _ = _sharded_problem("cpu")
    p0 = params_to_numpy(init_gcn_params(torch.Generator().manual_seed(3),
                                         24, 40, 5, device="cpu"))
    mask = np.zeros(g.shape[0], np.float32)
    mask[::3] = 1.0
    runs = {}
    for device in ("cpu", cuda):
        step, eval_fn, shard_fn = make_sharded_gcn_train_step(
            create_mesh(4, device), sg, dropout=0.0)
        adj, xs, ys, ms = shard_fn(x, labels, mask)
        params = params_from_numpy(p0, device)
        opt = adam_l2([t.requires_grad_(True)
                       for _, t in named_leaves(params)])
        before = es.spmm_ell_launches
        losses = [float(step(params, opt, (1, i), adj, xs, ys, ms))
                  for i in range(2)]
        lp = eval_fn(params, adj, xs).cpu()
        runs[str(device)] = (losses, lp, es.spmm_ell_launches - before)
    (l_cpu, lp_cpu, k1_cpu), (l_card, lp_card, k1_card) = runs.values()
    assert k1_cpu == 0
    # per shard and step, forward: layer 1 interior + two halo chunks (32
    # and 8 of its 40 columns), layer 2 interior + halo; as many backward;
    # 5 per shard in eval
    assert k1_card == 4 * (2 * 10 + 5)
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    torch.testing.assert_close(lp_card, lp_cpu, rtol=1e-5, atol=1e-4)


def _reordered_graph(method, n=2000):
    """A heavy-tailed community graph after ``method``, then the degree
    sort, as the v6 pipeline lays it out."""
    from gcn_tpu_torch.data.synthetic import powerlaw_sbm
    from gcn_tpu_torch.reorder import reorder_graph

    g, _ = powerlaw_sbm(n=n, n_classes=6, avg_degree=12.0, seed=13)
    g, _ = reorder_graph(gcn_normalize(g), method)
    return g.permute(degree_sort_order(g))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["identity", "degree", "degree_in",
                                    "degree_out", "dfs", "rcm", "gorder",
                                    "gorder3", "rabbit"])
@pytest.mark.parametrize("k", [8, 32])
def test_kernel_after_each_order_on_card(cuda, method, k):
    """K1 on the layout every reorder method gives, forward and through
    the transpose arrays, against its float64 plain version; the SpMM with
    its hub epilogue against the dense product."""
    g = _reordered_graph(method)
    adj = ell_adjacency(g, k_pad=32, symmetric=True, device=cuda)
    x = torch.randn(g.shape[0], k, device=cuda)
    for t in (False, True):
        cols, vals, win, win_off, n_out = _ell_arrays(adj, t)
        _close(es.ell_spmm(x, cols, vals, win, win_off, n_out),
               es._ell_spmm_plain(x.double(), cols, vals.double(), win,
                                  win_off, n_out).float())
    dense = torch.tensor(g.to_dense(), device=cuda, dtype=torch.float64)
    _close(es.spmm_ell(adj, x), (dense @ x.double()).float())


@pytest.mark.cuda
@pytest.mark.parametrize("option", ["table_bf16", "products_bf16"])
@pytest.mark.parametrize("part", ["interior", "halo"])
def test_kernel_on_sharded_parts_with_bf16_on_card(cuda, option, part):
    """``build_sharded_ell_blocks``' bf16 flags reach K1 on every shard's
    part: table_bf16 against the float64 plain version of bf16-rounded x
    at the f32 tolerance, products_bf16 against its plain version at 2e-2
    (a bf16 ulp can flip)."""
    from gcn_tpu_torch.parallel import (build_halo_plan_ragged,
                                        build_sharded_ell_blocks)

    _, sg, _, _, _ = _sharded_problem("cpu")
    parts = build_sharded_ell_blocks(sg, build_halo_plan_ragged(sg),
                                     k_pad=32, device=cuda,
                                     **{option: True})
    for a in parts[part == "halo"]:
        assert getattr(a, option)
        x = torch.randn(a.n_cols, 32, device=cuda)
        before = es.spmm_ell_launches
        got = es.spmm_ell(a, x)
        torch.cuda.synchronize()
        assert es.spmm_ell_launches == before + 1
        if option == "table_bf16":
            want = es._ell_spmm_plain(x.to(torch.bfloat16).double(), a.cols,
                                      a.vals.double(), a.win, a.win_off,
                                      a.n_rows).float()
            _close(got, want)
        else:
            want = es._ell_spmm_plain(x, a.cols, a.vals, a.win, a.win_off,
                                      a.n_rows, True)
            torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def _flavor_layouts(device, part, plan="ragged"):
    """The community graph's monolithic layout (``part="all"``) or one
    row-split part in part-degree order, every shard's, on ``device``."""
    from gcn_tpu_torch.parallel import (build_halo_plan,
                                        build_halo_plan_ragged,
                                        build_sharded_ell)

    _, sg, _, _, _ = _sharded_problem("cpu")
    build = build_halo_plan if plan == "padded" else build_halo_plan_ragged
    out = build_sharded_ell(sg, build(sg), part=part, k_pad=32,
                            part_order=part != "all", device=device)
    return out if part == "all" else out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 40, 8])
@pytest.mark.parametrize("part,plan", [("all", "ragged"), ("all", "padded"),
                                       ("interior", "ragged"),
                                       ("boundary", "ragged"),
                                       ("boundary", "padded")])
@pytest.mark.parametrize("t", [False, True])
def test_kernel_on_monolithic_and_split_parts_on_card(cuda, k, part, plan,
                                                       t):
    """K1 on every shard's monolithic layout and row-split parts, forward
    and through the transpose arrays, at the sharded step's widths, against
    the float64 plain version."""
    for a in _flavor_layouts(cuda, part, plan):
        cols, vals, win, win_off, n_out, n_in = (
            (a.t_cols, a.t_vals, a.t_win, a.t_win_off, a.n_cols, a.n_rows)
            if t else (a.cols, a.vals, a.win, a.win_off, a.n_rows,
                       a.n_cols))
        x = torch.randn(n_in, k, device=cuda)
        before = es.spmm_ell_launches
        got = es.ell_spmm(x, cols, vals, win, win_off, n_out)
        torch.cuda.synchronize()
        assert es.spmm_ell_launches == before + 1
        _close(got, es._ell_spmm_plain(x.double(), cols, vals.double(), win,
                                       win_off, n_out).float())


@pytest.mark.cuda
def test_unpermute_rows_on_card(cuda):
    """unpermute_rows on the card: the forward and the gather-only gradient
    equal the CPU's, for the split part's own take_idx / back_idx."""
    from gcn_tpu_torch.parallel import (build_halo_plan_ragged,
                                        build_sharded_ell, unpermute_rows)

    _, sg, _, _, _ = _sharded_problem("cpu")
    _, takes, backs = build_sharded_ell(sg, build_halo_plan_ragged(sg),
                                        part="boundary", part_order=True,
                                        shards=[0], device=cuda)
    y = torch.randn(sg.rows_per_shard, 40)
    ct = torch.randn(sg.rows_per_shard, 40)
    grads = []
    for device in ("cpu", cuda):
        yd = y.detach().to(device).requires_grad_(True)
        out = unpermute_rows(yd, takes[0].to(device), backs[0].to(device))
        (out * ct.to(device)).sum().backward()
        grads.append((out.detach().cpu(), yd.grad.cpu()))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("flavor,launches", [
    (dict(overlap=False), 4 * (2 * 4 + 2)),
    (dict(overlap="split"), 4 * (2 * 10 + 5)),
    (dict(exchange="halo_padded"), 4 * (2 * 10 + 5)),
    (dict(exchange="halo_hier"), 4 * (2 * 10 + 5)),
    (dict(exchange="halo_hier", hier_fanout="all_gather", overlap=False),
     4 * (2 * 4 + 2))])
def test_sharded_flavors_on_card_match_cpu(cuda, flavor, launches):
    """Two sharded steps of each flavor at dropout 0, four shards in one
    process (2 x 2 for the hierarchical exchange), card against CPU from
    the same parameters: losses at rtol 1e-4, eval log-probs at atol 1e-4 +
    rtol 1e-5; the card's K1 launches as reckoned (monolithic: a forward
    and a dX a layer, 2 in eval; the fused forms: the interior and one halo
    launch a 32-column chunk, as many for dX, 5 in eval), the CPU's none."""
    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.models.gcn_core import init_gcn_params
    from gcn_tpu_torch.parallel import (create_mesh, create_mesh_hier,
                                        make_sharded_gcn_train_step)
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.checkpoint import named_leaves

    g, sg, x, labels, _ = _sharded_problem("cpu")
    p0 = params_to_numpy(init_gcn_params(torch.Generator().manual_seed(3),
                                         24, 40, 5, device="cpu"))
    mask = np.zeros(g.shape[0], np.float32)
    mask[::3] = 1.0
    runs = {}
    for device in ("cpu", cuda):
        mesh = (create_mesh_hier(2, 2, device)
                if flavor.get("exchange") == "halo_hier"
                else create_mesh(4, device))
        step, eval_fn, shard_fn = make_sharded_gcn_train_step(
            mesh, sg, dropout=0.0, **flavor)
        adj, xs, ys, ms = shard_fn(x, labels, mask)
        params = params_from_numpy(p0, device)
        opt = adam_l2([t.requires_grad_(True)
                       for _, t in named_leaves(params)])
        before = es.spmm_ell_launches
        losses = [float(step(params, opt, (1, i), adj, xs, ys, ms))
                  for i in range(2)]
        lp = eval_fn(params, adj, xs).cpu()
        runs[str(device)] = (losses, lp, es.spmm_ell_launches - before)
    (l_cpu, lp_cpu, k1_cpu), (l_card, lp_card, k1_card) = runs.values()
    assert k1_cpu == 0
    assert k1_card == launches
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    torch.testing.assert_close(lp_card, lp_cpu, rtol=1e-5, atol=1e-4)


# ---- the sharded step's gathers -------------------------------------------
#
# A row that several shards need is sent several times, so the send
# gather's gradient adds several cotangents into one band row. It adds one
# plan segment at a time, whose rows repeat only as the padding's row 0
# (``parallel/halo.py::gather_send_rows``), not with ``index_select``'s
# atomic backward; the
# edge gather of the all_gather baseline and the segment sum sums each
# row's run over a sort made with the arrays (``ops/spmm.py::gather_rows``).


@functools.lru_cache(maxsize=1)
def _smoke_plan():
    """(ragged plan, band rows, each shard's padding positions in its send
    rows) at the smoke's scale: synth-arxiv (seed 15, ``gcn_normalize``)
    in-band degree sorted at 4 bands; made once."""
    from gcn_tpu_torch.data import get_dataset
    from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                        build_halo_plan_ragged,
                                        rows_per_shard_for,
                                        shard_graph_by_rows)
    from gcn_tpu_torch.parallel.halo import _pair_boundaries

    g = gcn_normalize(get_dataset("synth-arxiv", seed=15).adj)
    g = g.permute(band_degree_sort_order(g, rows_per_shard_for(g.shape[0],
                                                               4)))
    sg = shard_graph_by_rows(g, 4)
    plan = build_halo_plan_ragged(sg)
    needed, _ = _pair_boundaries(sg)
    pads = []
    for s in range(4):
        pad, o = [], 0
        for t, h in enumerate(plan.sizes, 1):
            pad.extend(range(o + len(needed[(s + t) % 4, s]), o + h))
            o += h
        pads.append(np.asarray(pad, dtype=np.int64))
    return plan, sg.rows_per_shard, pads


@pytest.mark.cuda
def test_send_gather_backward_deterministic_on_card(cuda):
    """On every shard of the smoke-sized ragged plan (tens of thousands of
    rows sent more than once), two backward passes of the send gather are
    bit-equal, and equal ``index_add_`` in float64 at the f32 tolerance
    (the cotangents zero at the padding, as the exchange gives them)."""
    from gcn_tpu_torch.parallel import send_indices
    from gcn_tpu_torch.parallel.halo import gather_send_rows

    plan, rps, pads = _smoke_plan()
    for rows, pad in zip(send_indices(plan, range(4), cuda), pads):
        assert int((torch.bincount(rows.idx) > 1).sum()) > 10_000
        x = torch.randn(rps, 32, device=cuda)
        ct = torch.randn(rows.idx.numel(), 32, device=cuda).index_fill_(
            0, torch.as_tensor(pad, device=cuda), 0)
        grads = []
        for _ in range(2):
            xg = x.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(gather_send_rows(xg, rows), xg,
                                             ct)[0])
        assert torch.equal(grads[0], grads[1])
        _close(grads[0].double(), torch.zeros(
            rps, 32, dtype=torch.float64, device=cuda).index_add_(
                0, rows.idx, ct.double()))


@pytest.mark.cuda
@pytest.mark.parametrize("gather", ["send", "rows"])
def test_gathers_capturable_on_card(cuda, gather):
    """The send gather and ``gather_rows``, forward and backward, neither
    wait for the host (sync debug mode "error" raises on a synchronizing
    call) nor fail to capture into a CUDA graph, and a replay equals the
    eager call bit for bit."""
    from gcn_tpu_torch.ops.spmm import gather_rows, row_gather
    from gcn_tpu_torch.parallel import send_indices
    from gcn_tpu_torch.parallel.halo import gather_send_rows

    plan, rps, pads = _smoke_plan()
    rows = send_indices(plan, [0], cuda)[0]
    fn = gather_send_rows
    x = torch.randn(rps, 32, device=cuda, requires_grad=True)
    ct = torch.randn(rows.idx.numel(), 32, device=cuda)
    if gather == "rows":
        rows, fn = row_gather(rows.idx.cpu().numpy(), rps, cuda), gather_rows
    else:
        # zero at the padding, as the exchange gives them
        ct.index_fill_(0, torch.as_tensor(pads[0], device=cuda), 0)

    def body():
        out = fn(x, rows)
        return out.detach(), torch.autograd.grad(out, x, ct)[0]

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = body()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = body()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], eager[0])
    assert torch.equal(captured[1], eager[1])


# ---- the captured fit (jit_loop=True): replays of one CUDA graph --------
#
# Captured against eager on the card, from the same parameters and the
# same dropout generator. The two flavors run the same kernels in the same
# order and the same capturable Adam, and every sum of the step is taken
# in a fixed order: K1 and K2 by design, the hub fold of K1's layout in
# chunk order (``ops/ell_spmm.py::_hub_epilogue``). So the record (history
# length, best_iter, iters_run), the losses, the log-probs and the
# generator's state are bit-equal.


def _kernel_records(fn, needle):
    """Run ``fn`` under torch.profiler; the device kernels whose name
    holds ``needle``, replays of a CUDA graph included."""
    import time

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # margins inside the trace window, whose ends are host times: a
        # kernel whose converted device time falls past an end is dropped
        time.sleep(0.1)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and needle in e.name)
    return out, n


def _functional_fit(adj, x, labels, idx_train, idx_val, steps, jit_loop,
                    device, dropout=0.5, mode="val", patience=500, lr=0.01):
    from gcn_tpu_torch.models.gcn_core import gcn_forward, init_gcn_params
    from gcn_tpu_torch.models.layers import auto_order
    from gcn_tpu_torch.ops.spmm import hoist_spmm
    from gcn_tpu_torch.train.loop import fit_gcn
    from gcn_tpu_torch.train.optim import adam_l2

    params = init_gcn_params(torch.Generator().manual_seed(3), x.shape[1],
                             16, 5, device=device)
    feats = hoist_spmm(adj, x)
    gen = torch.Generator(device=device).manual_seed(11)

    def forward(p, train):
        return gcn_forward(p, feats, adj, orders=("xw", auto_order(16, 5)),
                           dropout_rate=dropout, train=train, generator=gen)

    return fit_gcn(params, lambda ps: adam_l2(ps, lr), forward, labels,
                   idx_train, idx_val, train_iters=steps, mode=mode,
                   patience=patience, generator=gen, jit_loop=jit_loop)


def _same_fit(got, want):
    assert len(got.history) == len(want.history)
    assert got.iters_run == want.iters_run
    assert got.best_iter == want.best_iter
    assert got.history == want.history
    assert torch.equal(got.log_probs, want.log_probs)
    assert torch.equal(got.rng_state, want.rng_state)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ell", "panel"])
def test_captured_gcn_fit_matches_eager_on_card(cuda, layout):
    """GCN at dropout 0.5 over K1 (hub-split ELL) or K2 (a panel layout
    whose heavy windows fork onto K2's side stream inside the graph), 12
    steps with the best-val snapshot; the profiler counts the captured
    fit's kernel launches, which equal the eager fit's host count and the
    final evaluation's."""
    if layout == "ell":
        g = _hub_graph()
        adj = ell_adjacency(g, r=8, k_pad=32, device=cuda)
        needle, counter = "ell_spmm", lambda: es.spmm_ell_launches
    else:
        g = _split_graph()
        # heavy windows beside light ones: the SpMM forks and joins
        adj = _with_split(panel_adjacency(g, device=cuda), 6000)
        assert adj.heavy.numel() > 0 and adj.light.numel() > 0
        needle, counter = "panel_spmm", lambda: ps.spmm_panel_launches
    n = g.shape[0]
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((n, 24)), dtype=torch.float32,
                     device=cuda)
    labels = torch.tensor(rng.integers(0, 5, n), device=cuda)
    idx_train = torch.arange(0, n // 2, device=cuda)
    idx_val = torch.arange(n // 2, n, device=cuda)
    before = counter()
    eager = _functional_fit(adj, x, labels, idx_train, idx_val, 12, False,
                            cuda)
    host_count = counter() - before
    captured, records = _kernel_records(
        lambda: _functional_fit(adj, x, labels, idx_train, idx_val, 12,
                                True, cuda), needle)
    _same_fit(captured, eager)
    # the captured fit recomputes the best snapshot's log-probs at the end
    # (gcn_tpu's scan does too): one SpMM more than the eager fit, which
    # keeps them from the snapshot's step; K1 and K2 are two launches an
    # SpMM where both kinds of window exist
    per_call = 2 if layout == "panel" else adj.split.launches
    assert records == per_call * (host_count + 1)


@pytest.mark.cuda
def test_captured_early_stop_matches_eager_on_card(cuda):
    """An early-stopped captured fit replays its stopped iterations, which
    change nothing: the record, the parameters and the generator's state
    equal the eager fit's, which stops."""
    g = _hub_graph()
    adj = ell_adjacency(g, r=8, k_pad=32, device=cuda)
    n = g.shape[0]
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((n, 24)), dtype=torch.float32,
                     device=cuda)
    labels = torch.tensor(rng.integers(0, 5, n), device=cuda)
    idx_train = torch.arange(0, 40, device=cuda)
    idx_val = torch.arange(200, n, device=cuda)
    kw = dict(mode="early_stop", patience=3, lr=0.05, dropout=0.3)
    eager = _functional_fit(adj, x, labels, idx_train, idx_val, 60, False,
                            cuda, **kw)
    captured = _functional_fit(adj, x, labels, idx_train, idx_val, 60,
                               True, cuda, **kw)
    assert eager.iters_run < 60
    _same_fit(captured, eager)
    for layer in eager.final_params:
        for key in eager.final_params[layer]:
            torch.testing.assert_close(captured.final_params[layer][key],
                                       eager.final_params[layer][key],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_captured_hgnn_fit_matches_eager_on_card(cuda):
    """HGNN over both forms of G at dropout 0.5, 12 epochs across the
    milestone at 5 (the rate a device tensor the graph reads), with the
    best-val snapshot: captured against eager."""
    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.models import HGNN

    g, factors = _hypergraph()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((g.shape[0], 64)).astype(np.float32)
    labels = rng.integers(0, 5, g.shape[0])
    for G in (g, factors):
        runs, p0 = {}, None
        for jit_loop in (False, True):
            m = HGNN(64, 5, n_hid=128, adj_kind="ell", milestones=(5,),
                     device=cuda)
            p0 = p0 if p0 is not None else params_to_numpy(m.init_params())
            m.params = params_from_numpy(p0, cuda)
            m.fit(x, G, labels, np.arange(400), idx_val=np.arange(400, 600),
                  num_epochs=12, jit_loop=jit_loop)
            runs[jit_loop] = m
        eager, captured = runs[False], runs[True]
        assert "fit_scan" in captured.timers.names()
        for key in ("loss_train", "acc_val"):
            np.testing.assert_allclose([h[key] for h in captured.history],
                                       [h[key] for h in eager.history],
                                       rtol=1e-5)
        assert captured.best_acc == pytest.approx(eager.best_acc, abs=1e-6)
        torch.testing.assert_close(captured.output, eager.output, rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(captured._rng_state, eager._rng_state)
        assert captured._schedule_at == eager._schedule_at == 12
        assert len(captured.epoch_ms) == 12


@pytest.mark.cuda
def test_capture_that_cannot_proceed_raises(cuda):
    """A forward that reads a device value on the host cannot be
    captured, and an optimizer that is not capturable refuses the
    capture: both raise, and nothing falls back to the eager loop."""
    from gcn_tpu_torch.models.gcn_core import init_gcn_params
    from gcn_tpu_torch.train.loop import fit_gcn
    from gcn_tpu_torch.train.optim import adam_l2

    g = _hub_graph()
    adj = ell_adjacency(g, r=8, k_pad=32, device=cuda)
    n = g.shape[0]
    x = torch.randn(n, 24, device=cuda)
    labels = torch.randint(0, 5, (n,), device=cuda)
    idx = torch.arange(n, device=cuda)
    params = init_gcn_params(torch.Generator().manual_seed(0), 24, 16, 5,
                             device=cuda)

    def forward(p, train):
        from gcn_tpu_torch.models.gcn_core import gcn_forward

        out = gcn_forward(p, x, adj, dropout_rate=0.0, train=train)
        if train and float(out.sum()) != float(out.sum()):
            raise AssertionError("unreachable: a NaN output")
        return out

    with pytest.raises(RuntimeError):
        fit_gcn(params, adam_l2, forward, labels, idx, train_iters=5)
    torch.cuda.synchronize()

    def plain_forward(p, train):
        from gcn_tpu_torch.models.gcn_core import gcn_forward

        return gcn_forward(p, x, adj, dropout_rate=0.0, train=train)

    with pytest.raises(RuntimeError):
        fit_gcn(params, lambda ps: torch.optim.Adam(ps, lr=0.01),
                plain_forward, labels, idx, train_iters=5)
    torch.cuda.synchronize()
    res = fit_gcn(params, adam_l2, plain_forward, labels, idx,
                  train_iters=5)
    assert res.iters_run == 5 and torch.isfinite(res.log_probs).all()


# ---- the model axis: tensor parallelism over the hidden width ------------


@pytest.mark.cuda
def test_model_axis_meshes_default_to_the_card(cuda):
    from gcn_tpu_torch.parallel import create_mesh_2d, create_mesh_hier_model

    assert create_mesh_2d(4, 2).device.type == "cuda"
    assert create_mesh_hier_model(2, 2, 2).device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("flavor,parts", [
    (dict(), 2), (dict(overlap="split"), 2), (dict(overlap=False), 1),
    (dict(exchange="halo_padded"), 2), (dict(exchange="halo_hier"), 2),
    (dict(kernel="segsum"), 0), (dict(exchange="all_gather"), 0)])
def test_model_axis_step_on_card_matches_cpu(cuda, flavor, parts):
    """Two model-axis steps at dropout 0, 4 bands x 2 model slots in one
    process (2 x 2 x 2 for the hierarchical exchange), card against CPU from
    the same parameters: losses at rtol 1e-4, eval log-probs at atol 1e-4 +
    rtol 1e-5, post-step parameters at rtol 1e-5 + atol 1e-6. K1 runs on
    each slot's hidden shard (20 of 40 columns, then 5 classes' 20 hidden
    columns): ``parts`` launches a layer and slot forward, as many for dX,
    none on the CPU."""
    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.models.gcn_core import init_gcn_params
    from gcn_tpu_torch.parallel import (create_mesh_2d,
                                        create_mesh_hier_model,
                                        gather_model_params,
                                        make_sharded_gcn_train_step)
    from gcn_tpu_torch.train.optim import adam_l2
    from gcn_tpu_torch.utils.checkpoint import named_leaves

    g, sg, x, labels, _ = _sharded_problem("cpu")
    p0 = params_to_numpy(init_gcn_params(torch.Generator().manual_seed(3),
                                         24, 40, 5, device="cpu"))
    mask = np.zeros(g.shape[0], np.float32)
    mask[::3] = 1.0
    runs = {}
    for device in ("cpu", cuda):
        mesh = (create_mesh_hier_model(2, 2, 2, device)
                if flavor.get("exchange") == "halo_hier"
                else create_mesh_2d(4, 2, device))
        step, eval_fn, shard_fn = make_sharded_gcn_train_step(
            mesh, sg, dropout=0.0, model_axis="model", **flavor)
        adj, xs, ys, ms = shard_fn(x, labels, mask)
        assert xs[0].shape[1] == 12
        params = params_from_numpy(p0, device)
        opt = adam_l2([t.requires_grad_(True)
                       for _, t in named_leaves(params)])
        before = es.spmm_ell_launches
        losses = [float(step(params, opt, (1, i), adj, xs, ys, ms))
                  for i in range(2)]
        lp = eval_fn(params, adj, xs).cpu()
        runs[str(device)] = (losses, lp, es.spmm_ell_launches - before,
                             gather_model_params(params, mesh))
    (l_cpu, lp_cpu, k1_cpu, p_cpu), (l_card, lp_card, k1_card, p_card) = \
        runs.values()
    assert k1_cpu == 0
    assert k1_card == 8 * parts * (4 * 2 + 2)
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    torch.testing.assert_close(lp_card, lp_cpu, rtol=1e-5, atol=1e-4)
    for layer in p_cpu:
        for k in p_cpu[layer]:
            torch.testing.assert_close(p_card[layer][k].cpu(),
                                       p_cpu[layer][k], rtol=1e-5,
                                       atol=1e-6)


# ---- the hub fold in chunk order, and K1 at P = 2 ----------------------


@pytest.mark.cuda
def test_hub_fold_deterministic_on_card(cuda):
    """``spmm_ell`` through the hub fold: two calls bit-equal forward and
    dX on the card, and the fold of the same K1 output bit-equal on the
    card and on the CPU (the same adds in the same order)."""
    g = _hub_graph()
    adj = ell_adjacency(g, r=8, k_pad=32, device=cuda)
    assert adj.n_hub > 0 and len(adj.hub_steps) > 2
    x = torch.randn(g.shape[0], 24, device=cuda)
    ct = torch.randn(g.shape[0], 24, device=cuda)

    def run():
        xg = x.clone().requires_grad_(True)
        out = es.spmm_ell(adj, xg)
        out.backward(ct)
        return out.detach(), xg.grad

    (o1, d1), (o2, d2) = run(), run()
    assert torch.equal(o1, o2) and torch.equal(d1, d2)
    virt = es.ell_spmm(x, adj.cols, adj.vals, adj.win, adj.win_off,
                       adj.row_space)
    on_cpu = es._hub_epilogue(virt.cpu(), adj.to("cpu"))
    assert torch.equal(es._hub_epilogue(virt, adj).cpu(), on_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 40, 1, 96])
def test_kernel_on_k_pad_64_layout_on_card(cuda, k):
    """K1 on a P = 2 layout (k_pad 64: GCN at hidden 64), with the hub
    split, forward and through the transpose arrays, against the plain
    version: the hoist's width, layer 2's, the narrowest and a width of
    three column tiles."""
    g = _hub_graph()
    adj = ell_adjacency(g, r=8, k_pad=64, device=cuda)
    assert adj.p == 2 and adj.n_hub > 0
    for t in (False, True):
        arrays = _ell_arrays(adj, t)
        x = torch.randn(g.shape[0], k, device=cuda)
        before = es.spmm_ell_launches
        got = es.ell_spmm(x, *arrays)
        torch.cuda.synchronize()
        assert es.spmm_ell_launches == before + 1
        _close(got, es._ell_spmm_plain(x.double(), arrays[0],
                                       arrays[1].double(),
                                       *arrays[2:]).float())


@pytest.mark.cuda
def test_bench_on_card(cuda, capsys):
    """``python -m gcn_tpu_torch.bench`` on a small graph on the card: one
    JSON line, every time finite and positive, K1 within its bound."""
    from gcn_tpu_torch import bench

    assert bench.main(["--dataset", "synth-cora-hard", "-k", "16"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    d = line["detail"]
    times = [line["value"], line["vs_baseline"]] + [
        d[key] for key in ("ell_ms", "ell_ms_train_default",
                           "coo_baseline_ms", "sparse_mm_ms",
                           "train_step_ms", "train_step_hoisted_ms",
                           "train_step_eager_ms",
                           "train_step_hoisted_eager_ms",
                           "gather_ns_per_row", "event_floor_ms")]
    assert all(np.isfinite(t) and t > 0 for t in times), line
    assert 0 < d["roofline_pct"] <= 100
    assert d["card"]["kind"] == torch.cuda.get_device_name(cuda)


def _variant(option):
    return {None: {}, "table_bf16": {"table_bf16": True},
            "products_bf16": {"products_bf16": True},
            "both": {"table_bf16": True, "products_bf16": True}}[option]


def _check_k1(adj, x, plan, opts, t=False):
    """K1 on one direction under ``plan`` against its plain version: in
    float64 at the f32 tolerance, or (products_bf16) the f32 plain version
    at rtol and atol 2e-2 with >= 99% of the elements at the f32
    tolerance; returns K1's output."""
    arrays = _ell_arrays(adj, t)
    got = es.ell_spmm(x, *arrays, plan=plan, **opts)
    xr = x.to(torch.bfloat16).float() if opts.get("table_bf16") else x
    if opts.get("products_bf16"):
        want = es._ell_spmm_plain(xr, *arrays, True)
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
        assert _share_close(got, want) >= 0.99
    else:
        cols, vals, win, win_off, n_out = arrays
        _close(got, es._ell_spmm_plain(xr.double(), cols, vals.double(),
                                       win, win_off, n_out).float())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 33, 128])
@pytest.mark.parametrize("option", [None, "table_bf16", "products_bf16",
                                    "both"])
@pytest.mark.parametrize("k_pad", [32, 64, 128])
def test_kernel_split_windows_match_plain_on_card(cuda, k_pad, option, k):
    """The serving layout (no hub split) of a power-law graph: its hub
    windows walk far past the per-SM mean and are cut across a cluster,
    beside light windows walked whole, at P = 4, 2 and 1, in every variant,
    forward; n_out (3000) is not a multiple of R (16)."""
    adj = ell_adjacency(_split_graph(), r=16, k_pad=k_pad,
                        span_pass_limit=0, device=cuda)
    assert adj.split.n_heavy and adj.split.n_light
    assert adj.split.walk < int(adj.win_off.diff().max())
    x = torch.randn(adj.n_cols, k, device=cuda)
    _check_k1(adj, x, adj.split, _variant(option))


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [8, 16])
@pytest.mark.parametrize("which", ["only heavy", "only light", "default"])
@pytest.mark.parametrize("k_pad", [32, 128])
def test_kernel_split_plans_on_card(cuda, k_pad, which, parts):
    """Plans that make every window heavy (one-block windows give empty
    parts), none, or the default split, with clusters of 8 and of 16 (a
    non-portable size), forward and through the transpose arrays of a
    rectangular graph; two calls bit-equal; the plan's plain sums equal the
    plain version's."""
    from gcn_tpu_torch.tile.ell import walk_split

    blocks = {"only heavy": 0, "only light": 1 << 30, "default": None}
    g = _rect_graph(n=3000, m=1200)
    adj = ell_adjacency(g, k_pad=k_pad, span_pass_limit=0, device=cuda)
    x = {False: torch.randn(adj.n_cols, 40, device=cuda),
         True: torch.randn(adj.n_rows, 40, device=cuda)}
    for t in (False, True):
        off = (adj.t_win_off if t else adj.win_off).cpu().numpy()
        plan = walk_split(off, adj.p, cuda, parts=parts,
                          split_blocks=blocks[which])
        if which == "only heavy":
            assert plan.n_light == 0 and plan.launches == 1
        elif which == "only light":
            assert plan.n_heavy == 0 and plan.launches == 1
        for opts in ({}, {"products_bf16": True}):
            got = _check_k1(adj, x[t], plan, opts, t)
            again = es.ell_spmm(x[t], *_ell_arrays(adj, t), plan=plan,
                                **opts)
            assert torch.equal(got, again)
        cols, vals, win, win_off, n_out = _ell_arrays(adj, t)
        xd = x[t].double()
        torch.testing.assert_close(
            es._ell_spmm_plain_split(xd, cols, vals.double(), win_off, plan,
                                     n_out),
            es._ell_spmm_plain(xd, cols, vals.double(), win, win_off, n_out),
            rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_kernel_split_needs_a_plan_under_capture(cuda):
    """Without a plan K1 makes one from win_off (a read-back) eagerly, and
    raises inside a CUDA graph capture instead of synchronising."""
    adj = ell_adjacency(_split_graph(), k_pad=32, span_pass_limit=0,
                        device=cuda)
    x = torch.randn(adj.n_cols, 32, device=cuda)
    arrays = _ell_arrays(adj)
    eager = es.ell_spmm(x, *arrays)
    assert torch.equal(eager, es.ell_spmm(x, *arrays, plan=adj.split))
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with pytest.raises(RuntimeError, match="plan"):
            with torch.cuda.graph(graph, stream=stream):
                es.ell_spmm(x, *arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("k_pad", [32, 128])
def test_captured_fit_over_split_windows_matches_eager_on_card(cuda, k_pad):
    """GCN at dropout 0.5 over a layout with heavy windows (the serving
    layout, at P = 4 and 1): inside the captured graph K1 forks its cluster
    launch onto its side stream and joins it; the captured fit equals the
    eager one bit for bit, and the profiler counts two kernel launches a
    K1 call."""
    g = _split_graph()
    adj = ell_adjacency(g, r=16, k_pad=k_pad, span_pass_limit=0,
                        device=cuda)
    assert adj.split.launches == 2
    n = g.shape[0]
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.standard_normal((n, 24)), dtype=torch.float32,
                     device=cuda)
    labels = torch.tensor(rng.integers(0, 5, n), device=cuda)
    idx_train = torch.arange(0, n // 2, device=cuda)
    idx_val = torch.arange(n // 2, n, device=cuda)
    before = es.spmm_ell_launches
    eager = _functional_fit(adj, x, labels, idx_train, idx_val, 12, False,
                            cuda)
    host_count = es.spmm_ell_launches - before
    captured, records = _kernel_records(
        lambda: _functional_fit(adj, x, labels, idx_train, idx_val, 12,
                                True, cuda), "ell_spmm")
    _same_fit(captured, eager)
    assert records == 2 * (host_count + 1)


@pytest.mark.cuda
def test_captured_hgnn_fit_over_split_windows_is_bit_equal(cuda):
    """HGNN over G (k_pad 128, P = 1), whose layout has heavy windows:
    the captured fit's losses and output equal the eager fit's bit for
    bit."""
    from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
    from gcn_tpu_torch.models import HGNN

    g, _ = _hypergraph()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((g.shape[0], 64)).astype(np.float32)
    labels = rng.integers(0, 5, g.shape[0])
    runs, p0 = {}, None
    for jit_loop in (False, True):
        m = HGNN(64, 5, n_hid=128, adj_kind="ell", milestones=(5,),
                 device=cuda)
        p0 = p0 if p0 is not None else params_to_numpy(m.init_params())
        m.params = params_from_numpy(p0, cuda)
        m.fit(x, g, labels, np.arange(400), idx_val=np.arange(400, 600),
              num_epochs=12, jit_loop=jit_loop)
        runs[jit_loop] = m
    eager, captured = runs[False], runs[True]
    assert eager.g_adj.split.n_heavy > 0
    assert [h["loss_train"] for h in captured.history] == \
        [h["loss_train"] for h in eager.history]
    assert torch.equal(captured.output, eager.output)


# ---- the COO product (GCN v1-v5 past 8,192 rows) -------------------------
#
# A gather, then each row's run of edges summed in edge order by the row
# edge counts made with the layout (``ops/spmm.py::segment_sum``): no
# atomics, so calls and captured fits are bit-equal on the card too.


def _coo_graph(seed=6, n=9000):
    """Symmetric, normalized, in its own row order, with a few rows of
    over a thousand edges and n past 8,192, so that ``GCN`` resolves
    ``adj_kind="auto"`` to ``CooAdj``."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, 3).repeat(1200),
                          rng.integers(0, n, 60_000)])
    dst = rng.integers(0, n, src.shape[0])
    return gcn_normalize(coo_to_csr(src, dst, None, (n, n)).symmetrize())


def _coo_plain(adj, x, t=False):
    """The product in float64 (``index_add_`` over the sorted rows)."""
    rows, cols, vals, n_out = ((adj.t_rows, adj.t_cols, adj.t_vals,
                                adj.n_cols) if t else
                               (adj.rows, adj.cols, adj.vals, adj.n_rows))
    prod = x.double()[cols] * vals.double()[:, None]
    return prod.new_zeros((n_out, x.shape[1])).index_add_(0, rows, prod)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 40])
def test_coo_spmm_deterministic_on_card(cuda, k):
    """Two COO products bit-equal, forward and dX, each against its
    float64 plain version at the f32 tolerance."""
    from gcn_tpu_torch.ops.adjacency import coo_adjacency
    from gcn_tpu_torch.ops.spmm import spmm

    adj = coo_adjacency(_coo_graph(), device=cuda)
    assert int(adj.row_len.max()) > 1000
    x = torch.randn(adj.n_cols, k, device=cuda)
    ct = torch.randn(adj.n_rows, k, device=cuda)

    def fwd_dx():
        xg = x.clone().requires_grad_(True)
        out = spmm(adj, xg)
        return out.detach(), torch.autograd.grad(out, xg, ct)[0]

    (o1, d1), (o2, d2) = fwd_dx(), fwd_dx()
    assert torch.equal(o1, o2) and torch.equal(d1, d2)
    _close(o1.double(), _coo_plain(adj, x))
    _close(d1.double(), _coo_plain(adj, ct, t=True))


@pytest.mark.cuda
def test_coo_spmm_capturable_without_host_sync(cuda):
    """The product and its dX neither wait for the host (sync debug mode
    "error" raises on a synchronizing call) nor fail to capture, and a
    replay equals the eager call bit for bit; on a rectangular graph,
    whose transpose has counts of its own."""
    from gcn_tpu_torch.ops.adjacency import coo_adjacency
    from gcn_tpu_torch.ops.spmm import spmm

    adj = coo_adjacency(_rect_graph(), device=cuda)
    assert adj.t_row_len is not adj.row_len
    x = torch.randn(adj.n_cols, 32, device=cuda, requires_grad=True)
    ct = torch.randn(adj.n_rows, 32, device=cuda)

    def body():
        out = spmm(adj, x)
        return out.detach(), torch.autograd.grad(out, x, ct)[0]

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = body()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = body()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], eager[0])
    assert torch.equal(captured[1], eager[1])


@pytest.mark.cuda
def test_captured_v4_fit_matches_eager_on_card(cuda):
    """GCN v4 (the default variant) past 8,192 rows trains over
    ``CooAdj``: the captured fit's losses, output and dropout stream equal
    the eager fit's bit for bit, and K1 never launches."""
    from gcn_tpu_torch.models import GCN
    from gcn_tpu_torch.ops.adjacency import CooAdj

    g = _coo_graph()
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((g.shape[0], 48)).astype(np.float32)
    labels = rng.integers(0, 6, g.shape[0])
    runs = {}
    for jit_loop in (False, True):
        before = es.spmm_ell_launches
        m = GCN(48, 32, 6, seed=2, device=cuda)
        m.fit(feats, g, labels, np.arange(3000), train_iters=15,
              jit_loop=jit_loop)
        assert es.spmm_ell_launches == before
        runs[jit_loop] = m
    eager, captured = runs[False], runs[True]
    assert isinstance(eager.adj_norm, CooAdj)
    assert [h["loss_train"] for h in captured.history] == \
        [h["loss_train"] for h in eager.history]
    assert torch.equal(captured.output, eager.output)
    assert torch.equal(captured._rng_state, eager._rng_state)


@pytest.mark.cuda
def test_eager_fit_times_its_steps_on_the_card(cuda):
    """An eager fit given no timers times each step with CUDA events that
    it waits for, so the step's median is the card's time, not the host's
    time to enqueue it."""
    from gcn_tpu_torch.ops.adjacency import coo_adjacency

    adj = coo_adjacency(_coo_graph(), device=cuda)
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((adj.n_rows, 24)),
                     dtype=torch.float32, device=cuda)
    labels = torch.tensor(rng.integers(0, 5, adj.n_rows), device=cuda)
    idx = torch.arange(0, adj.n_rows // 2, device=cuda)
    res = _functional_fit(adj, x, labels, idx, None, 14, False, cuda,
                          mode="no_val")
    step = res.timers("step").d
    assert step.cuda and step.count == 4
