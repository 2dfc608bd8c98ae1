"""Row-band sharded training of the port (``gcn_tpu_torch.parallel``)
against gcn_tpu's (``gcn_tpu.parallel``), on the CPU.

Host structures are array-equal: the row partition, the in-band degree
sort, the ragged halo plan and both parts of the pass-block ELL layout, in
both directions, shard by shard (an empty band among the cases; also with
each of the layout's options: the span limit, the parts' segment budget,
the bf16 flags). The
sharded step matches gcn_tpu's on a 4-device mesh at dropout 0: per-step
losses at rtol 1e-4, eval log-probs at atol 1e-4 + rtol 1e-5 (the parity
tolerances of tests/test_torch_port_model.py; f32 sums in other orders).
The bf16 and fp8 wires track f32 as in tests/test_parallel.py (rtol 0.05,
atol 0.02), and agree with gcn_tpu's same wire at the loss tolerance (a
bf16 rounding can flip one ulp where the f32 values it rounds differ in
their last bit, so eval log-probs there hold at atol 1e-3). Two gloo
processes of two shards each match one process of four at rtol 1e-5, and
the dist CLI resumes exactly. ``with_relu`` and ``with_bias`` match
gcn_tpu's, in one process and in two. ``exchange_dtype="auto"`` resolves the
wire gcn_tpu's auto step resolves (both packages' policies patched to one
set of rates) and then equals the named wire's step bit for bit; over two
gloo processes every rank resolves the same wire; the CLI's ``--halo-wire
auto`` ends where the named wire ends.
"""

import dataclasses
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gcn_tpu.parallel import partition as jx_part
from gcn_tpu.parallel.halo import build_halo_plan_ragged as jx_plan
from gcn_tpu.parallel.halo import build_sharded_ell_blocks as jx_blocks

from gcn_tpu_torch.convert import params_from_numpy
from gcn_tpu_torch.models.gcn_core import gcn_forward
from gcn_tpu_torch.ops import ell_spmm as es
from gcn_tpu_torch.ops.adjacency import segment_lengths
from gcn_tpu_torch.parallel import (band_degree_sort_order,
                                    build_halo_plan_ragged,
                                    build_sharded_ell,
                                    build_sharded_ell_blocks, create_mesh,
                                    create_mesh_hier,
                                    make_sharded_gcn_train_step, pad_rows,
                                    rows_per_shard_for, shard_graph_by_rows)
from gcn_tpu_torch.tile.ell import _win_offsets, ell_adjacency
from gcn_tpu_torch.train.metrics import masked_nll
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils.checkpoint import named_leaves
from torch_port_dist_graphs import GRAPHS, NS, REPO, STEPS
from torch_port_dist_graphs import gloo_run as _gloo_run
from torch_port_dist_graphs import jax_run as _jax_run
from torch_port_dist_graphs import one_process_of_gloo_problem
from torch_port_dist_graphs import port_graph as _port
from torch_port_dist_graphs import port_run as _port_run
from torch_port_dist_graphs import powerlaw_graph as _powerlaw_graph
from torch_port_dist_graphs import problem as _problem
from torch_port_dist_graphs import sbm_graph as _sbm_graph
from torch_port_dist_graphs import subprocess_env as _env
from torch_port_dist_graphs import free_port as _free_port
from torch_port_dist_graphs import gloo_outputs as _gloo_outputs


@pytest.mark.parametrize("name", list(GRAPHS))
def test_partition_equals_gcn_tpu(name):
    jg = GRAPHS[name]()
    g = _port(jg)
    rps = rows_per_shard_for(g.shape[0], NS)
    assert rps == jx_part.rows_per_shard_for(g.shape[0], NS)
    np.testing.assert_array_equal(band_degree_sort_order(g, rps),
                                  jx_part.band_degree_sort_order(jg, rps))
    sg, jsg = shard_graph_by_rows(g, NS), jx_part.shard_graph_by_rows(jg, NS)
    for f in ("rows_local", "cols", "vals"):
        np.testing.assert_array_equal(getattr(sg, f),
                                      np.asarray(getattr(jsg, f)), f)
    for f in ("n_rows", "n_cols", "rows_per_shard", "n_shards", "nnz"):
        assert getattr(sg, f) == getattr(jsg, f), f
    assert sg.boundary_fraction() == jsg.boundary_fraction()
    x = np.arange(g.shape[0] * 3, dtype=np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(pad_rows(x, sg), jx_part.pad_rows(x, jsg))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_ragged_plan_equals_gcn_tpu(name):
    jg = GRAPHS[name]()
    plan = build_halo_plan_ragged(shard_graph_by_rows(_port(jg), NS))
    ref = jx_plan(jx_part.shard_graph_by_rows(jg, NS))
    np.testing.assert_array_equal(plan.send_idx, np.asarray(ref.send_idx))
    np.testing.assert_array_equal(plan.col_remap, np.asarray(ref.col_remap))
    assert plan.sizes == ref.sizes
    assert plan.halo_rows == ref.halo_rows
    assert plan.exchange_fraction == ref.exchange_fraction


@pytest.mark.parametrize("name,k_pad,r", [
    ("sbm", 32, None), ("powerlaw", 32, 32), ("powerlaw", 128, 32),
    ("powerlaw", 32, None), ("empty_band", 32, None)])
def test_pass_block_parts_equal_gcn_tpu(name, k_pad, r):
    """Both parts, both directions, every shard: the port's per-shard
    EllAdj holds shard d's slice of gcn_tpu's stacked arrays."""
    jg = GRAPHS[name]()
    sg = shard_graph_by_rows(_port(jg), NS)
    jsg = jx_part.shard_graph_by_rows(jg, NS)
    parts = build_sharded_ell_blocks(sg, build_halo_plan_ragged(sg),
                                     k_pad=k_pad, r=r, device="cpu")
    refs = jx_blocks(jsg, jx_plan(jsg), k_pad=k_pad, r=r)
    for ours, ref in zip(parts, refs):
        assert len(ours) == NS
        for d, a in enumerate(ours):
            for f in ("cols", "vals", "win", "t_cols", "t_vals", "t_win"):
                np.testing.assert_array_equal(
                    getattr(a, f).numpy(), np.asarray(getattr(ref, f))[d], f)
            for f in ("n_rows", "n_cols", "r", "k_pad", "spans", "t_spans",
                      "chunks", "t_chunks", "span_pass_limit"):
                assert getattr(a, f) == getattr(ref, f), f
            assert a.n_hub == 0 and a.virt_map is None
            np.testing.assert_array_equal(
                a.win_off.numpy(), _win_offsets(a.win.numpy(),
                                                a.num_windows))
            assert a.nnz == int((a.vals != 0).sum())
            a.validate()
    # a process that owns some shards lays out only those, identically
    some = build_sharded_ell_blocks(sg, build_halo_plan_ragged(sg),
                                    k_pad=k_pad, r=r, shards=[1, 3],
                                    device="cpu")
    for ours, sub in zip(parts, some):
        for d, a in zip((1, 3), sub):
            for f in ("cols", "vals", "win_off", "t_cols", "t_vals",
                      "t_win_off"):
                assert torch.equal(getattr(a, f), getattr(ours[d], f)), f


# the options gcn_tpu's build_sharded_ell_blocks takes: the span limit off
# (0), a segment budget tighter than the parts' 48, each bf16 flag
PART_OPTIONS = {
    "span_pass_limit_0": dict(span_pass_limit=0),
    "span_pass_limit_3": dict(span_pass_limit=3),
    "part_segment_budget_8": dict(part_segment_budget=8),
    "products_bf16": dict(products_bf16=True),
    "table_bf16": dict(table_bf16=True),
}


@pytest.mark.parametrize("option", list(PART_OPTIONS))
def test_pass_block_parts_options_equal_gcn_tpu(option):
    """Each option gives gcn_tpu's arrays and fields, shard by shard; the
    bf16 flags ride on every part, and the budget of 8 cuts the parts'
    forward counts to at most 8 runs."""
    kw = PART_OPTIONS[option]
    jg = GRAPHS["powerlaw"]()
    sg = shard_graph_by_rows(_port(jg), NS)
    jsg = jx_part.shard_graph_by_rows(jg, NS)
    parts = build_sharded_ell_blocks(sg, build_halo_plan_ragged(sg), r=8,
                                     device="cpu", **kw)
    refs = jx_blocks(jsg, jx_plan(jsg), r=8, **kw)
    for ours, ref in zip(parts, refs):
        for d, a in enumerate(ours):
            for f in ("cols", "vals", "win", "t_cols", "t_vals", "t_win"):
                np.testing.assert_array_equal(
                    getattr(a, f).numpy(), np.asarray(getattr(ref, f))[d], f)
            for f in ("spans", "t_spans", "chunks", "t_chunks",
                      "span_pass_limit", "products_bf16", "table_bf16"):
                assert getattr(a, f) == getattr(ref, f), f
            a.validate()
        if option == "part_segment_budget_8":
            runs = np.count_nonzero(np.diff(ours[0].win_off.diff().numpy()))
            assert runs + 1 <= 8
    if option.startswith("span_pass_limit"):
        assert parts[0][0].span_pass_limit == (
            1 << 30 if kw["span_pass_limit"] == 0 else 3)


def test_pass_block_parts_span_limit_argument_beats_env(monkeypatch):
    """The argument comes first, GCN_TPU_SPAN_LIMIT second, as in
    gcn_tpu."""
    sg = shard_graph_by_rows(_port(_powerlaw_graph()), NS)
    plan = build_halo_plan_ragged(sg)
    monkeypatch.setenv("GCN_TPU_SPAN_LIMIT", "2")
    from_env = build_sharded_ell_blocks(sg, plan, r=8, device="cpu")
    given = build_sharded_ell_blocks(sg, plan, r=8, span_pass_limit=5,
                                     device="cpu")
    assert from_env[0][0].span_pass_limit == 2
    assert given[0][0].span_pass_limit == 5


@pytest.mark.parametrize("k_pad", [32, 128])
def test_pass_block_parts_sum_to_the_product(k_pad):
    """interior @ band + halo @ concat(halo table, band) == A @ x, shard by
    shard, forward and through the transpose arrays (float64)."""
    g = _port(_powerlaw_graph())
    sg = shard_graph_by_rows(g, NS)
    plan = build_halo_plan_ragged(sg)
    a_int, a_halo = build_sharded_ell_blocks(sg, plan, k_pad=k_pad, r=32,
                                             device="cpu")
    rps, hc = sg.rows_per_shard, plan.halo_rows
    rng = np.random.default_rng(5)
    x = rng.standard_normal((sg.n_rows_padded, 40))
    dense = np.zeros((sg.n_rows_padded,) * 2)
    dense[:g.shape[0], :g.shape[1]] = g.to_dense()
    ct = rng.standard_normal((sg.n_rows_padded, 40))
    dx = np.zeros_like(x)
    for d in range(NS):
        band = slice(d * rps, (d + 1) * rps)
        table = np.zeros((hc + rps, 40))
        table[hc:] = x[band]
        real = sg.vals[d] != 0
        remap, cols = plan.col_remap[d][real], sg.cols[d][real]
        halo = remap < hc
        table[remap[halo]] = x[cols[halo]]

        def k1(a, v, t=False):
            cols_, vals, win, win_off, n = (
                (a.t_cols, a.t_vals, a.t_win, a.t_win_off, a.n_cols) if t
                else (a.cols, a.vals, a.win, a.win_off, a.n_rows))
            return es._ell_spmm_plain(torch.tensor(v), cols_, vals.double(),
                                      win, win_off, n).numpy()

        np.testing.assert_allclose(
            k1(a_int[d], x[band]) + k1(a_halo[d], table), dense[band] @ x,
            rtol=1e-12, atol=1e-12)
        # transpose arrays: the cotangent of the band and of the table
        g_int, g_tab = k1(a_int[d], ct[band], True), k1(a_halo[d], ct[band],
                                                       True)
        dx[band] += g_int + g_tab[hc:]
        # each halo row of the table holds one source row
        rows_h, first = np.unique(remap[halo], return_index=True)
        np.add.at(dx, cols[halo][first], g_tab[rows_h])
    np.testing.assert_allclose(dx, dense.T @ ct, rtol=1e-12, atol=1e-12)


def test_overlap_blocks_spmm_matches_segment_sum():
    """The unfused pass-block SpMM (interior K1 on the band, halo K1 on
    concat(halo, band), plain versions here) equals the halo segment sum,
    forward and in the gradient through the exchange."""
    from gcn_tpu_torch.parallel import halo

    g = _port(_powerlaw_graph())
    sg = shard_graph_by_rows(g, NS)
    plan = build_halo_plan_ragged(sg)
    mesh = create_mesh(NS, "cpu")
    a_int, a_halo = build_sharded_ell_blocks(sg, plan, r=32, device="cpu")
    idx = [torch.as_tensor(plan.send_idx[s], dtype=torch.int64)
           for s in range(NS)]
    coo = [(torch.as_tensor(plan.col_remap[s], dtype=torch.int64),
            torch.as_tensor(sg.vals[s]),
            torch.as_tensor(segment_lengths(sg.rows_local[s],
                                            sg.rows_per_shard)))
           for s in range(NS)]
    ex = halo.make_halo_exchange(plan)
    rng = np.random.default_rng(6)
    ct = torch.tensor(rng.standard_normal((sg.n_rows_padded, 24)),
                      dtype=torch.float32)
    outs, grads = [], []
    for run in (lambda xs: halo.dist_spmm_halo_ell_overlap_blocks(
            a_int, a_halo, idx, xs, mesh, ex),
                lambda xs: halo.dist_spmm_halo(coo, idx, xs, mesh, ex)):
        x = torch.tensor(rng.standard_normal((sg.n_rows_padded, 24)),
                         dtype=torch.float32) if not outs else x.detach()
        x.requires_grad_(True)
        out = torch.cat(run(list(x.split(sg.rows_per_shard))))
        (out * ct).sum().backward()
        outs.append(out.detach())
        grads.append(x.grad)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


CONFIGS = {
    "halo_chunked": dict(exchange_chunk=16),
    "halo_unchunked": dict(exchange_chunk=None),
    "halo_auto_chunk": dict(),
    "halo_segsum": dict(kernel="segsum"),
    "all_gather": dict(exchange="all_gather"),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sharded_step_matches_gcn_tpu(config):
    """nhid 40 > chunk 16: layer 1's exchange goes in 3 slices
    (16/16/8), layer 2 (4 classes) in one."""
    jg, x, labels, mask, p0 = _problem()
    want_l, want_lp = _jax_run(jg, x, labels, mask, p0, **CONFIGS[config])
    got_l, got_lp = _port_run(_port(jg), x, labels, mask, p0,
                              **CONFIGS[config])
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=0)
    np.testing.assert_allclose(got_lp, want_lp, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("with_relu,with_bias", [(False, False),
                                                 (False, True),
                                                 (True, False)])
def test_relu_and_bias_flags_match_gcn_tpu(with_relu, with_bias):
    """``with_relu`` and ``with_bias`` as gcn_tpu means them, at dropout 0
    (the parameters hold a bias exactly when ``with_bias``)."""
    jg, x, labels, mask, p0 = _problem(with_bias=with_bias)
    kw = dict(with_relu=with_relu, with_bias=with_bias, exchange_chunk=16)
    want_l, want_lp = _jax_run(jg, x, labels, mask, p0, **kw)
    got_l, got_lp = _port_run(_port(jg), x, labels, mask, p0, **kw)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=0)
    np.testing.assert_allclose(got_lp, want_lp, rtol=1e-5, atol=1e-4)


def test_without_relu_no_dropout_is_drawn():
    """Dropout applies only after the relu: without it, dropout 0.5 gives
    the dropout-0 run."""
    jg, x, labels, mask, p0 = _problem()
    runs = [_port_run(_port(jg), x, labels, mask, p0, dropout=rate,
                      with_relu=False) for rate in (0.0, 0.5)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("wire", ["bf16", "fp8"])
def test_wire_matches_gcn_tpu(wire):
    jg, x, labels, mask, p0 = _problem()
    kw = dict(exchange_dtype=wire, exchange_chunk=16)
    want_l, want_lp = _jax_run(jg, x, labels, mask, p0, **kw)
    got_l, got_lp = _port_run(_port(jg), x, labels, mask, p0, **kw)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=0)
    np.testing.assert_allclose(got_lp, want_lp, rtol=1e-5, atol=1e-3)


def test_bf16_wire_tracks_f32():
    jg, x, labels, mask, p0 = _problem(nhid=8)
    g = _port(jg)
    f32, _ = _port_run(g, x, labels, mask, p0, steps=5)
    bf16, _ = _port_run(g, x, labels, mask, p0, steps=5,
                        exchange_dtype="bf16")
    np.testing.assert_allclose(bf16, f32, rtol=0.05, atol=0.02)
    assert bf16[-1] < bf16[0]


def test_fp8_wire_tracks_f32_and_saturates_safely():
    """float8_e4m3fn: close to f32, converging, equal accuracy; features
    scaled by 1e4 (far past the wire's 448) clip instead of overflowing."""
    jg, x, labels, mask, p0 = _problem(nhid=8)
    g = _port(jg)
    acc = {}
    for wire in (None, "fp8"):
        losses, lp = _port_run(g, x, labels, mask, p0, steps=40,
                               exchange_dtype=wire)
        assert np.isfinite(losses).all() and losses[-1] < losses[0], wire
        acc[wire] = float((lp[:g.shape[0]].argmax(1) == labels).mean())
    assert acc[None] >= 0.9, acc
    assert abs(acc["fp8"] - acc[None]) <= 0.04, acc
    losses, _ = _port_run(g, x * 1e4, labels, mask, p0, steps=1,
                          exchange_dtype="fp8")
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("wire", [None, "bf16", "fp8"])
def test_chunked_exchange_matches_one_piece(wire):
    """Each halo column depends only on its own column: the k-chunked
    exchange equals the one-piece exchange, on every wire."""
    jg, x, labels, mask, p0 = _problem()
    g = _port(jg)
    runs = [_port_run(g, x, labels, mask, p0, dropout=0.5,
                      exchange_dtype=wire, exchange_chunk=c)
            for c in (16, None)]
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-5, atol=1e-6)


def test_sharded_matches_unsharded_port():
    """The sharded step equals the port's unsharded functional GCN
    (``gcn_forward`` over ``ell_adjacency``, A(XW) in both layers) on the
    same band-sorted graph."""
    jg, x, labels, mask, p0 = _problem()
    g = _port(jg)
    g = g.permute(band_degree_sort_order(g, rows_per_shard_for(256, NS)))
    adj = ell_adjacency(g, k_pad=32, symmetric=True, device="cpu")
    params = params_from_numpy(p0, "cpu")
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    opt = adam_l2(leaves, 0.01, 5e-4)
    xt = torch.tensor(x)
    idx = torch.arange(g.shape[0])
    # the same rows as the sharded run: x, labels permuted like g
    perm = band_degree_sort_order(_port(jg), rows_per_shard_for(256, NS))
    xt, yt = xt[perm], torch.tensor(labels)[perm]
    want = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = masked_nll(gcn_forward(params, xt, adj, dropout_rate=0.0,
                                      train=True), yt, idx)
        loss.backward()
        opt.step()
        want.append(float(loss.detach()))
    with torch.no_grad():
        want_lp = gcn_forward(params, xt, adj).numpy()
    got, got_lp = _port_run(g, x[perm], labels[perm], mask, p0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    np.testing.assert_allclose(got_lp[:g.shape[0]], want_lp, rtol=1e-5,
                               atol=1e-4)


# the rates both packages' wire policies read, the same in both: a network of
# 1 MB/s makes the hierarchical plan byte-bound, so auto picks fp8 there
AUTO_RATES = dict(spmm_edges_per_s=3.3e10, mxu_flops=1.3e13, bw_ici=3.0e11,
                  bw_dcn=1.0e6)


def _patch_wire_policy(monkeypatch):
    """Both packages' ``recommend_wire_dtype`` at AUTO_RATES and the same
    kernel scales (each step imports it from its projection module when it
    resolves the wire)."""
    from functools import partial

    from gcn_tpu.parallel import projection as jx_proj
    from gcn_tpu_torch.parallel import projection as pt_proj

    for proj in (jx_proj, pt_proj):
        monkeypatch.setattr(proj, "measured_kernel_scales",
                            lambda *a, **k: ((1.0, 1.0), "patched"))
        monkeypatch.setattr(proj, "recommend_wire_dtype",
                            partial(proj.recommend_wire_dtype, **AUTO_RATES))


def _resolved(caplog, package):
    """The wires ``package``'s sharded step logged for exchange_dtype="auto"
    (its logger's "auto halo wire -> WIRE (why)" records)."""
    return [r.getMessage().split("-> ")[1].split(" ")[0]
            for r in caplog.records
            if r.name == f"{package}.parallel.train_step"]


@pytest.mark.parametrize("exchange,hier,wire", [("halo", None, "bf16"),
                                                ("halo_hier", (2, 2), "fp8")])
def test_auto_wire_equals_named_wire_and_gcn_tpu(monkeypatch, caplog,
                                                 exchange, hier, wire):
    """``exchange_dtype="auto"`` with ``widths`` resolves on the plan the
    step builds (the ragged plan to bf16 by rule, the 2 x 2 plan to fp8 at
    AUTO_RATES), as gcn_tpu's auto step does; its losses and log-probs are
    the named wire's, bit for bit, and gcn_tpu's auto step's at that wire's
    tolerance (test_wire_matches_gcn_tpu's), at dropout 0."""
    import logging

    _patch_wire_policy(monkeypatch)
    caplog.set_level(logging.INFO)
    jg, x, labels, mask, p0 = _problem()
    g = _port(jg)
    kw = dict(exchange=exchange, exchange_chunk=16, widths=(16, 40, 4))
    got_l, got_lp = _port_run(g, x, labels, mask, p0, hier=hier,
                              exchange_dtype="auto", **kw)
    want_l, want_lp = _jax_run(jg, x, labels, mask, p0, hier=hier,
                               exchange_dtype="auto", **kw)
    assert _resolved(caplog, "gcn_tpu_torch") == [wire]
    assert _resolved(caplog, "gcn_tpu") == [wire]
    named_l, named_lp = _port_run(g, x, labels, mask, p0, hier=hier,
                                  exchange_dtype=wire, **kw)
    np.testing.assert_array_equal(got_l, named_l)
    np.testing.assert_array_equal(got_lp, named_lp)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=0)
    np.testing.assert_allclose(got_lp, want_lp, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("hier", [None, (2, 2)])
def test_auto_wire_is_one_wire_over_gloo_processes(hier):
    """Two gloo processes of two shards resolve the same wire from the
    capture's rates (the inputs are host data, the same on every rank) and
    take the steps of one process of four."""
    extra = dict(exchange="halo_hier", hier=hier) if hier else {}
    outs = _gloo_outputs(exchange_dtype="auto", widths=[16, 40, 4],
                         dropout=0.0, **extra)
    wires = [re.findall(r"auto halo wire -> (\w+)", o) for o in outs]
    assert len(wires[0]) == 1 and wires[0] == wires[1], wires
    losses = [json.loads(re.search(r"LOSSES (\[.*\])", o).group(1))
              for o in outs]
    assert losses[0] == losses[1]
    want, _ = one_process_of_gloo_problem(
        dropout=0.0, exchange_dtype="auto", widths=(16, 40, 4),
        exchange=extra.get("exchange", "halo"), hier=hier)
    np.testing.assert_allclose(losses[0], want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kw", [dict(overlap="block"),
                                dict(exchange="all_gather", kernel="ell"),
                                dict(exchange="all_gather",
                                     exchange_dtype="bf16"),
                                dict(exchange="all_gather",
                                     exchange_dtype="auto"),
                                # a 1-D mesh has no model axis and no "rows"
                                dict(model_axis="model"),
                                dict(axis="rows")])
def test_bad_options_raise(kw):
    sg = shard_graph_by_rows(_port(_sbm_graph()[0]), NS)
    with pytest.raises(ValueError):
        make_sharded_gcn_train_step(create_mesh(NS, "cpu"), sg, **kw)


def test_mesh_owns_contiguous_shards():
    mesh = create_mesh(NS, "cpu")
    assert list(mesh.shards) == [0, 1, 2, 3] and not mesh.distributed
    two = dataclasses.replace(mesh, rank=1, world_size=2)
    assert list(two.shards) == [2, 3]
    assert [two.owner(s) for s in range(NS)] == [0, 0, 1, 1]
    assert two.local_index(3) == 1


def test_dist_entry_points_default_to_the_card():
    sg = shard_graph_by_rows(_port(_sbm_graph()[0]), NS)
    plan = build_halo_plan_ragged(sg)
    if torch.cuda.is_available():
        assert create_mesh(NS).device.type == "cuda"
        assert create_mesh_hier(2, 2).device.type == "cuda"
        assert build_sharded_ell_blocks(sg, plan)[0][0].cols.is_cuda
        assert build_sharded_ell(sg, plan)[0].cols.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_mesh(NS)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_mesh_hier(2, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_sharded_ell_blocks(sg, plan)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_sharded_ell(sg, plan)


def test_two_gloo_processes_match_one_process():
    """Two processes of two shards each (gloo point-to-point exchanges,
    all-reduced gradients) against one process of four, dropout 0.5."""
    losses, lp = _gloo_run(dropout=0.5)
    assert losses[0] == losses[1]
    want, want_lp = one_process_of_gloo_problem()
    np.testing.assert_allclose(losses[0], want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(lp, want_lp, rtol=1e-5, atol=1e-5)


def test_two_gloo_processes_without_relu_and_bias_match_gcn_tpu():
    """``with_relu=False, with_bias=False`` over two gloo processes of two
    shards against gcn_tpu's four-device step, dropout 0."""
    jg, x, labels, mask, p0 = _problem(with_bias=False)
    kw = dict(with_relu=False, with_bias=False, exchange_chunk=16)
    want_l, want_lp = _jax_run(jg, x, labels, mask, p0, steps=4, **kw)
    losses, lp = _gloo_run(dropout=0.0, with_relu=False, with_bias=False,
                           params=p0)
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], want_l, rtol=1e-4, atol=0)
    np.testing.assert_allclose(lp, want_lp, rtol=1e-5, atol=1e-4)


def _cli(args, env=None, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "gcn_tpu_torch.train_gcn_dist", "-g",
         "synth-tiny", "-k", "8", "--shards", "4", "--device", "cpu"] + args,
        cwd=REPO, env=env or _env(), capture_output=True, text=True,
        timeout=timeout)


def _final_loss(out):
    line = [ln for ln in out.splitlines() if "final loss" in ln][-1]
    return float(line.rsplit("final loss", 1)[1].strip(" )"))


def test_dist_cli_resume_matches_uninterrupted(tmp_path):
    """6 iterations straight == 3, save, resume 3 more (dropout 0.5: the
    stream is a function of (seed, iteration, band))."""
    st = str(tmp_path / "dist_state")
    full = _cli(["-i", "6", "--dropout", "0.5"])
    assert full.returncode == 0, full.stderr[-2000:]
    assert "Test set results" in full.stdout
    assert "exchange fraction" in full.stdout
    a = _cli(["-i", "3", "--dropout", "0.5", "--save-state", st])
    assert a.returncode == 0, a.stderr[-2000:]
    b = _cli(["-i", "3", "--dropout", "0.5", "--resume-state", st])
    assert b.returncode == 0, b.stderr[-2000:]
    assert "resumed from" in b.stdout
    assert abs(_final_loss(full.stdout) - _final_loss(b.stdout)) < 1e-6


def test_dist_cli_two_processes_match_one():
    """The CLI under torchrun's environment (two gloo processes of two
    shards) ends where one process of four ends."""
    one = _cli(["-i", "4"])
    assert one.returncode == 0, one.stderr[-2000:]
    port = str(_free_port())
    procs = []
    for rank in (0, 1):
        env = dict(_env(), RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gcn_tpu_torch.train_gcn_dist", "-g",
             "synth-tiny", "-k", "8", "--shards", "4", "--device", "cpu",
             "-i", "4"], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a CLI process timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    assert "2 process(es), 2 shard(s) each" in outs[0]
    assert outs[1] == ""          # only rank 0 prints
    assert _final_loss(outs[0]) == pytest.approx(_final_loss(one.stdout),
                                                 rel=1e-5)


@pytest.mark.parametrize("hier", [[], ["--exchange", "halo_hier", "--hier",
                                       "2", "2"]])
def test_dist_cli_auto_wire_equals_the_named_wire(hier):
    """``--halo-wire auto`` prints the wire it resolves (bf16 on the ragged
    plan) and ends at the loss of that wire named, at dropout 0."""
    auto = _cli(["-i", "3", "--dropout", "0", "--halo-wire", "auto"] + hier)
    assert auto.returncode == 0, auto.stderr[-2000:]
    wire = re.search(r"auto halo wire -> (\w+)", auto.stdout).group(1)
    if not hier:
        assert wire == "bf16"
    named = _cli(["-i", "3", "--dropout", "0", "--halo-wire", wire] + hier)
    assert named.returncode == 0, named.stderr[-2000:]
    assert _final_loss(auto.stdout) == _final_loss(named.stdout)
