"""The sharded path's host structures of the port (``gcn_tpu_torch.parallel``)
against gcn_tpu's (``gcn_tpu.parallel``), on the CPU: the padded plan, the
hierarchical plan (both fan-outs, at 2 x 2, 1 x 4 and 4 x 1) and
``build_sharded_ell`` (every ``part``, with and without ``part_order``, over
the ragged, padded and hierarchical plans, at k_pad 32 and 128, with the
bf16 flags and the span limit) are equal element for element, shard by
shard. Beside them, what the arrays mean (float64, 1e-12): the monolithic
part and the two row-split parts compute the band product forward and
through their transpose arrays, every plan's exchange (both fan-outs of
the hierarchical one) gives the dense product and gradient under the
segment sum, the monolithic and unfused split SpMMs over the exchange equal
the segment sum, and ``unpermute_rows`` matches ``index_select`` under
autograd.
"""

import numpy as np
import pytest
import torch

from gcn_tpu.parallel import partition as jx_part
from gcn_tpu.parallel.halo import build_halo_plan as jx_padded
from gcn_tpu.parallel.halo import build_halo_plan_hier as jx_hier
from gcn_tpu.parallel.halo import build_halo_plan_ragged as jx_ragged
from gcn_tpu.parallel.halo import build_sharded_ell as jx_ell

from gcn_tpu_torch.ops import ell_spmm as es
from gcn_tpu_torch.ops.adjacency import segment_lengths
from gcn_tpu_torch.parallel import (build_halo_plan, build_halo_plan_hier,
                                    build_halo_plan_ragged,
                                    build_sharded_ell, create_mesh,
                                    create_mesh_hier, make_halo_exchange,
                                    send_indices, shard_graph_by_rows,
                                    unpermute_rows)
from gcn_tpu_torch.parallel import halo
from gcn_tpu_torch.tile.ell import _win_offsets
from torch_port_dist_graphs import GRAPHS, NS, port_graph

PLANS = {"ragged": (build_halo_plan_ragged, jx_ragged),
         "padded": (build_halo_plan, jx_padded),
         "hier": (lambda sg: build_halo_plan_hier(sg, 2, 2),
                  lambda sg: jx_hier(sg, 2, 2))}


def _sharded(name):
    jg = GRAPHS[name]()
    return (shard_graph_by_rows(port_graph(jg), NS),
            jx_part.shard_graph_by_rows(jg, NS))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_padded_plan_equals_gcn_tpu(name):
    sg, jsg = _sharded(name)
    plan, ref = build_halo_plan(sg), jx_padded(jsg)
    np.testing.assert_array_equal(plan.send_idx, np.asarray(ref.send_idx))
    np.testing.assert_array_equal(plan.col_remap, np.asarray(ref.col_remap))
    for f in ("h_max", "n_shards", "n_rows", "halo_rows",
              "exchange_fraction"):
        assert getattr(plan, f) == getattr(ref, f), f
    # no zero head: the halo is ns blocks of h_max rows
    assert plan.halo_rows == NS * plan.h_max
    for s in range(NS):
        assert not plan.send_idx[s, s].any()


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("hosts,chips", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("fanout", ["ragged", "all_gather"])
def test_hier_plan_equals_gcn_tpu(name, hosts, chips, fanout):
    sg, jsg = _sharded(name)
    plan = build_halo_plan_hier(sg, hosts, chips, fanout=fanout)
    ref = jx_hier(jsg, hosts, chips, fanout=fanout)
    for f in ("send_intra", "send_inter", "send_fan", "col_remap"):
        np.testing.assert_array_equal(getattr(plan, f),
                                      np.asarray(getattr(ref, f)), f)
    for f in ("intra_sizes", "inter_sizes", "fan_sizes", "n_hosts",
              "n_chips", "n_rows", "halo_rows", "exchange_fraction",
              "dcn_fraction", "ici_gather_rows"):
        assert getattr(plan, f) == getattr(ref, f), f
    assert plan.send_fan.shape[1] >= 8
    assert plan.n_shards == NS


def test_hier_plan_refuses_a_wrong_factorization():
    sg, _ = _sharded("sbm")
    with pytest.raises(ValueError, match="does not factor"):
        build_halo_plan_hier(sg, 3, 2)
    with pytest.raises(ValueError, match="fanout"):
        build_halo_plan_hier(sg, 2, 2, fanout="tree")


# (plan, part, part_order, k_pad, r, options)
ELL_CASES = [
    ("ragged", "all", False, 32, None, {}),
    ("ragged", "all", False, 128, 32, {}),
    ("ragged", "interior", False, 32, None, {}),
    ("ragged", "boundary", False, 32, None, {}),
    ("ragged", "interior", True, 32, None, {}),
    ("ragged", "boundary", True, 32, None, {}),
    ("ragged", "interior", True, 128, 32, {}),
    ("ragged", "boundary", True, 128, 32, {}),
    ("padded", "all", False, 32, None, {}),
    ("padded", "all", False, 128, 32, {}),
    ("padded", "interior", True, 32, None, {}),
    ("padded", "boundary", True, 32, None, {}),
    ("padded", "boundary", False, 128, 32, {}),
    ("hier", "all", False, 32, None, {}),
    ("hier", "boundary", True, 32, None, {}),
    ("ragged", "all", False, 32, 8, dict(span_pass_limit=0)),
    ("ragged", "boundary", True, 32, 8, dict(span_pass_limit=3)),
    ("padded", "all", False, 32, 8, dict(products_bf16=True)),
    ("ragged", "interior", True, 32, 8, dict(table_bf16=True)),
]


@pytest.mark.parametrize("name", ["powerlaw", "sbm", "empty_band"])
@pytest.mark.parametrize("plan_name,part,part_order,k_pad,r,opts", ELL_CASES)
def test_sharded_ell_equals_gcn_tpu(name, plan_name, part, part_order, k_pad,
                                    r, opts):
    """Forward and transpose arrays and every field, shard by shard (the
    port's EllAdj holds shard d's slice of gcn_tpu's stacked arrays), and
    the part order's take_idx / back_idx."""
    sg, jsg = _sharded(name)
    build, jx_build = PLANS[plan_name]
    kw = dict(part=part, part_order=part_order, k_pad=k_pad, r=r, **opts)
    ours = build_sharded_ell(sg, build(sg), device="cpu", **kw)
    ref = jx_ell(jsg, jx_build(jsg), **kw)
    if part_order:
        ours, takes, backs = ours
        ref, jtakes, jbacks = ref
        for d in range(NS):
            np.testing.assert_array_equal(takes[d].numpy(),
                                          np.asarray(jtakes)[d])
            np.testing.assert_array_equal(backs[d].numpy(),
                                          np.asarray(jbacks)[d])
            # take_idx is each band row's rank, back_idx its inverse
            np.testing.assert_array_equal(takes[d][backs[d]].numpy(),
                                          np.arange(sg.rows_per_shard))
    assert len(ours) == NS
    for d, a in enumerate(ours):
        for f in ("cols", "vals", "win", "t_cols", "t_vals", "t_win"):
            np.testing.assert_array_equal(
                getattr(a, f).numpy(), np.asarray(getattr(ref, f))[d], f)
        for f in ("n_rows", "n_cols", "r", "k_pad", "spans", "t_spans",
                  "chunks", "t_chunks", "span_pass_limit", "products_bf16",
                  "table_bf16"):
            assert getattr(a, f) == getattr(ref, f), f
        np.testing.assert_array_equal(
            a.win_off.numpy(), _win_offsets(a.win.numpy(), a.num_windows))
        assert a.nnz == int((a.vals != 0).sum())
        a.validate()


def test_sharded_ell_lays_out_only_the_given_shards():
    sg, _ = _sharded("powerlaw")
    plan = build_halo_plan(sg)
    every, takes, backs = build_sharded_ell(sg, plan, part="boundary",
                                            part_order=True, r=32,
                                            device="cpu")
    some, s_takes, s_backs = build_sharded_ell(
        sg, plan, part="boundary", part_order=True, r=32, shards=[1, 3],
        device="cpu")
    for i, d in enumerate((1, 3)):
        for f in ("cols", "vals", "win_off", "t_cols", "t_vals",
                  "t_win_off"):
            assert torch.equal(getattr(some[i], f), getattr(every[d], f)), f
        assert torch.equal(s_takes[i], takes[d])
        assert torch.equal(s_backs[i], backs[d])


def test_sharded_ell_refuses_bad_parts():
    sg, _ = _sharded("sbm")
    plan = build_halo_plan_ragged(sg)
    with pytest.raises(ValueError, match="part_order"):
        build_sharded_ell(sg, plan, part="all", part_order=True,
                          device="cpu")
    with pytest.raises(ValueError, match="part must be"):
        build_sharded_ell(sg, plan, part="halo", device="cpu")


def _dense_problem(plan_name, k=24, seed=5):
    g = port_graph(GRAPHS["powerlaw"]())
    sg = shard_graph_by_rows(g, NS)
    plan = PLANS[plan_name][0](sg)
    rng = np.random.default_rng(seed)
    dense = np.zeros((sg.n_rows_padded,) * 2)
    dense[:g.shape[0], :g.shape[1]] = g.to_dense()
    x = rng.standard_normal((sg.n_rows_padded, k))
    ct = rng.standard_normal((sg.n_rows_padded, k))
    return sg, plan, dense, x, ct


def _tables(sg, plan, x, d):
    """Shard d's halo region (each referenced row placed where col_remap
    points) and its band, as float64 arrays."""
    rps, hc = sg.rows_per_shard, plan.halo_rows
    halo_t = np.zeros((hc, x.shape[1]))
    real = sg.vals[d] != 0
    remap, cols = plan.col_remap[d][real], sg.cols[d][real]
    off = remap < hc
    halo_t[remap[off]] = x[cols[off]]
    return halo_t, x[d * rps:(d + 1) * rps], remap[off], cols[off]


def _k1(a, v, t=False):
    """K1's float64 plain version on one direction of ``a``."""
    cols, vals, win, win_off, n = (
        (a.t_cols, a.t_vals, a.t_win, a.t_win_off, a.n_cols) if t
        else (a.cols, a.vals, a.win, a.win_off, a.n_rows))
    return es._ell_spmm_plain(torch.tensor(v), cols, vals.double(), win,
                              win_off, n).numpy()


def _scatter_halo(dx, g_halo, remap, cols):
    """Add the cotangent of each referenced halo row onto its source row
    (each halo row holds one source row)."""
    rows_h, first = np.unique(remap, return_index=True)
    np.add.at(dx, cols[first], g_halo[rows_h])


@pytest.mark.parametrize("plan_name", ["ragged", "padded", "hier"])
@pytest.mark.parametrize("k_pad", [32, 128])
def test_monolithic_part_computes_the_band_product(plan_name, k_pad):
    sg, plan, dense, x, ct = _dense_problem(plan_name)
    adjs = build_sharded_ell(sg, plan, k_pad=k_pad, r=32, device="cpu")
    rps, hc = sg.rows_per_shard, plan.halo_rows
    dx = np.zeros_like(x)
    for d, a in enumerate(adjs):
        band = slice(d * rps, (d + 1) * rps)
        halo_t, xb, remap, cols = _tables(sg, plan, x, d)
        np.testing.assert_allclose(_k1(a, np.concatenate([halo_t, xb])),
                                   dense[band] @ x, rtol=1e-12, atol=1e-12)
        g_tab = _k1(a, ct[band], True)
        dx[band] += g_tab[hc:]
        _scatter_halo(dx, g_tab, remap, cols)
    np.testing.assert_allclose(dx, dense.T @ ct, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("plan_name", ["ragged", "padded", "hier"])
@pytest.mark.parametrize("part_order", [False, True])
def test_split_parts_compute_the_band_product(plan_name, part_order):
    """interior @ band + boundary @ halo, each restored to band order ==
    the band product; their transpose arrays give A^T ct."""
    sg, plan, dense, x, ct = _dense_problem(plan_name)
    kw = dict(k_pad=32, r=32, part_order=part_order, device="cpu")
    parts = [build_sharded_ell(sg, plan, part=p, **kw)
             for p in ("interior", "boundary")]
    rps = sg.rows_per_shard
    dx = np.zeros_like(x)
    for d in range(NS):
        band = slice(d * rps, (d + 1) * rps)
        halo_t, xb, remap, cols = _tables(sg, plan, x, d)
        outs, backs = [], []
        for built, v in zip(parts, (xb, halo_t)):
            if part_order:
                adjs, takes, perms = built
                a, take, back = adjs[d], takes[d].numpy(), perms[d].numpy()
            else:
                a, take, back = built[d], np.arange(rps), np.arange(rps)
            outs.append(_k1(a, v)[take])
            # the cotangent enters the part in its sorted row order
            backs.append(_k1(a, ct[band][back], True))
        np.testing.assert_allclose(outs[0] + outs[1], dense[band] @ x,
                                   rtol=1e-12, atol=1e-12)
        dx[band] += backs[0]
        _scatter_halo(dx, backs[1], remap, cols)
    np.testing.assert_allclose(dx, dense.T @ ct, rtol=1e-12, atol=1e-12)


def test_unpermute_rows_matches_index_select():
    """Forward y[take_idx]; the gradient, a gather by back_idx, equals
    index_select's autograd (a scatter-add) for a permutation."""
    rng = np.random.default_rng(3)
    perm = torch.as_tensor(rng.permutation(50))
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(50)
    y = torch.tensor(rng.standard_normal((50, 7)), requires_grad=True)
    ct = torch.tensor(rng.standard_normal((50, 7)))
    out = unpermute_rows(y, rank, perm)
    (out * ct).sum().backward()
    y2 = y.detach().clone().requires_grad_(True)
    ref = y2.index_select(0, rank)
    (ref * ct).sum().backward()
    assert torch.equal(out, ref)
    assert torch.equal(y.grad, y2.grad)
    # the port's part order: take_idx the rank, back_idx the order
    assert torch.equal(out[perm], y.detach())


@pytest.mark.parametrize("plan_name,hosts,chips", [
    ("ragged", None, None), ("padded", None, None), ("hier_ragged", 2, 2),
    ("hier_all_gather", 2, 2), ("hier_ragged", 1, 4),
    ("hier_all_gather", 4, 1)])
@pytest.mark.parametrize("wire", [None, "bf16"])
def test_exchange_segment_sum_matches_dense(plan_name, hosts, chips, wire):
    """Each plan's exchange under the segment sum, in one process: the
    product and the gradient of x equal the dense ones (f32; the bf16
    wire rounds the halo rows, both ways)."""
    g = port_graph(GRAPHS["powerlaw"]())
    sg = shard_graph_by_rows(g, NS)
    if plan_name.startswith("hier"):
        plan = build_halo_plan_hier(sg, hosts, chips,
                                    fanout=plan_name[5:])
        mesh = create_mesh_hier(hosts, chips, "cpu")
    else:
        plan = PLANS[plan_name][0](sg)
        mesh = create_mesh(NS, "cpu")
    wire_dtype = {None: None, "bf16": torch.bfloat16}[wire]
    ex = make_halo_exchange(plan, wire_dtype)
    idx = send_indices(plan, range(NS), "cpu")
    coo = [(torch.as_tensor(plan.col_remap[s], dtype=torch.int64),
            torch.as_tensor(sg.vals[s]),
            torch.as_tensor(segment_lengths(sg.rows_local[s],
                                            sg.rows_per_shard)))
           for s in range(NS)]
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((sg.n_rows_padded, 12)),
                     dtype=torch.float32, requires_grad=True)
    ct = torch.tensor(rng.standard_normal((sg.n_rows_padded, 12)),
                      dtype=torch.float32)
    out = torch.cat(halo.dist_spmm_halo(coo, idx,
                                        list(x.split(sg.rows_per_shard)),
                                        mesh, ex))
    (out * ct).sum().backward()
    dense = np.zeros((sg.n_rows_padded,) * 2)
    dense[:g.shape[0], :g.shape[1]] = g.to_dense()
    tol = dict(rtol=1e-5, atol=1e-5) if wire is None else dict(rtol=2e-2,
                                                               atol=2e-2)
    np.testing.assert_allclose(out.detach().numpy(),
                               dense @ x.detach().double().numpy(), **tol)
    np.testing.assert_allclose(x.grad.numpy(), dense.T @ ct.double().numpy(),
                               **tol)


@pytest.mark.parametrize("plan_name", ["ragged", "padded", "hier"])
def test_layout_spmms_match_the_segment_sum(plan_name):
    """The monolithic SpMM (``dist_spmm_halo_ell``) and the unfused split
    overlap (``dist_spmm_halo_ell_overlap``, parts restored by
    ``unpermute_rows``), K1's plain version, equal the halo segment sum,
    forward and in the gradient through the exchange."""
    g = port_graph(GRAPHS["powerlaw"]())
    sg = shard_graph_by_rows(g, NS)
    plan = PLANS[plan_name][0](sg)
    mesh = (create_mesh_hier(2, 2, "cpu") if plan_name == "hier"
            else create_mesh(NS, "cpu"))
    ex = make_halo_exchange(plan)
    idx = send_indices(plan, range(NS), "cpu")
    coo = [(torch.as_tensor(plan.col_remap[s], dtype=torch.int64),
            torch.as_tensor(sg.vals[s]),
            torch.as_tensor(segment_lengths(sg.rows_local[s],
                                            sg.rows_per_shard)))
           for s in range(NS)]
    mono = build_sharded_ell(sg, plan, r=32, device="cpu")
    e_int, i_take, i_back = build_sharded_ell(
        sg, plan, part="interior", part_order=True, r=32, device="cpu")
    e_bnd, b_take, b_back = build_sharded_ell(
        sg, plan, part="boundary", part_order=True, r=32, device="cpu")
    runs = {
        "segsum": lambda xs: halo.dist_spmm_halo(coo, idx, xs, mesh, ex),
        "monolithic": lambda xs: halo.dist_spmm_halo_ell(mono, idx, xs,
                                                         mesh, ex),
        "split": lambda xs: halo.dist_spmm_halo_ell_overlap(
            e_int, e_bnd, idx, xs, mesh, ex,
            int_unperm=list(zip(i_take, i_back)),
            bnd_unperm=list(zip(b_take, b_back)))}
    rng = np.random.default_rng(6)
    x0 = torch.tensor(rng.standard_normal((sg.n_rows_padded, 24)),
                      dtype=torch.float32)
    ct = torch.tensor(rng.standard_normal((sg.n_rows_padded, 24)),
                      dtype=torch.float32)
    got = {}
    for name, run in runs.items():
        x = x0.clone().requires_grad_(True)
        out = torch.cat(run(list(x.split(sg.rows_per_shard))))
        (out * ct).sum().backward()
        got[name] = (out.detach(), x.grad)
    for name in ("monolithic", "split"):
        torch.testing.assert_close(got[name][0], got["segsum"][0],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[name][1], got["segsum"][1],
                                   rtol=1e-5, atol=1e-5)
