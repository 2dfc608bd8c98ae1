"""K1's walk split plan on the CPU.

The plan (``tile/ell.py::walk_split_plan``) is made on the host with the
layout, so what the card's cluster launch relies on is checked here: every
window listed once, heavy and light apart and ascending, each heavy
window's parts tiling its pass-blocks in order, short walks kept whole,
the same plan from every function that lays out an ``EllAdj``, and the
plan's sums (``_ell_spmm_plain_split``: parts summed apart, then added in
rank order) equal to K1's plain version in float64 to 1e-12 and to
``gcn_tpu``'s ``spmm_ell`` (Pallas in interpret mode), forward and dX, at
rtol/atol 1e-5 in f32 and with a bf16 table (f32 sums in another order)
and 2e-2 with bf16 products (a bf16 ulp). The layouts are the serving
ones (``span_pass_limit=0``: no hub split) of graphs with planted hubs,
whose hub windows walk far past the split threshold, at P = 4, 2 and 1.
The kernel itself is held against its plain version on the card in
test_torch_port_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.ell_spmm import spmm_ell as jx_spmm_ell
from gcn_tpu.tile.ell import ell_adjacency as jx_ell
from torch_port_graphs import graphs

from gcn_tpu_torch.ops import ell_spmm as es
from gcn_tpu_torch.parallel import (build_halo_plan_ragged,
                                    build_sharded_ell,
                                    build_sharded_ell_blocks,
                                    shard_graph_by_rows)
from gcn_tpu_torch.tile.ell import (WALK_SPLIT_PARTS, check_walk_split,
                                    default_split_blocks, ell_adjacency,
                                    walk_split, walk_split_plan)
from gcn_tpu_torch.tile.format import NUM_SMS

K_PADS = (32, 64, 128)          # P = 4, 2, 1


def planted_hub_graph(seed, n=1200, hubs=(600, 420, 300, 150, 90)):
    """Symmetric, normalized, degree-sorted: a few hub rows of the given
    degrees over a sparse tail, in both packages."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.repeat(np.arange(len(hubs)), hubs),
                          rng.integers(len(hubs), n, 3 * n)])
    dst = rng.integers(0, n, src.shape[0])
    return graphs(src, dst, rng.random(src.shape[0]).astype(np.float32),
                  (n, n), symmetric=True, sort=True, binarize=False)


def serving(g, k_pad, **kw):
    return ell_adjacency(g, r=8, k_pad=k_pad, span_pass_limit=0,
                         device="cpu", **kw)


def _plan_np(split):
    return tuple(t.numpy() for t in (split.heavy, split.parts, split.light))


@pytest.mark.parametrize("split_blocks", [None, 0, 3, 1 << 30])
@pytest.mark.parametrize("k_pad", K_PADS)
def test_walk_split_plan_covers_every_window(k_pad, split_blocks):
    g, _ = planted_hub_graph(1)
    off = serving(g, k_pad).win_off.numpy()
    nblk = np.diff(off.astype(np.int64))
    p = 128 // k_pad
    limit = (default_split_blocks(off, NUM_SMS, p) if split_blocks is None
             else split_blocks)
    heavy, parts, light = walk_split_plan(off, NUM_SMS, p,
                                          split_blocks=split_blocks)
    check_walk_split(off, heavy, parts, light)
    assert heavy.dtype == parts.dtype == light.dtype == np.int32
    assert sorted(heavy.tolist() + light.tolist()) == list(range(len(nblk)))
    assert not set(heavy.tolist()) & set(light.tolist())
    assert (np.diff(heavy) > 0).all() and (np.diff(light) > 0).all()
    assert (nblk[heavy] > limit).all() and (nblk[light] <= limit).all()
    assert parts.shape == (len(heavy), WALK_SPLIT_PARTS + 1)
    for h, w in enumerate(heavy):
        covered = np.concatenate([np.arange(parts[h, q], parts[h, q + 1])
                                  for q in range(WALK_SPLIT_PARTS)])
        assert np.array_equal(covered, np.arange(nblk[w]))
        share = np.diff(parts[h])
        assert share.max() == -(-nblk[w] // WALK_SPLIT_PARTS)
    if split_blocks is None:
        # the planted hubs walk past the threshold; the tail does not
        assert len(heavy) and len(light)


@pytest.mark.parametrize("parts", [1, 8, 16])
def test_walk_split_parts_and_walk(parts):
    g, _ = planted_hub_graph(2)
    adj = serving(g, 32)
    off = adj.win_off.numpy()
    split = walk_split(off, 4, "cpu", parts=parts)
    heavy, offs, light = _plan_np(split)
    check_walk_split(off, heavy, offs, light)
    assert split.clusters == parts and offs.shape[1] == parts + 1
    nblk = np.diff(off.astype(np.int64))
    longest = max(nblk[light].max(), np.diff(offs, axis=1).max())
    assert split.walk == longest
    assert (longest < nblk.max()) == (parts > 1)
    assert split.launches == 2 and split.n_heavy + split.n_light == len(nblk)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_short_walks_stay_whole(p):
    """No walk of 16 steps (max(P, 4) slot rows each) or fewer is split,
    however few pass-blocks the direction has: the training layout's hub
    split caps its walks at 16 pass-blocks of P = 4."""
    floor = 16 * max(p, 4) // p
    off = np.concatenate([[0], np.cumsum([floor, floor + 1] + [1] * 50)])
    split = walk_split(off.astype(np.int32), p, "cpu")
    assert split.heavy.tolist() == [1] and split.n_light == 51
    assert split.launches == 2 and split.walk == floor
    whole = walk_split(off[:2].astype(np.int32), p, "cpu")
    assert whole.n_heavy == 0 and whole.launches == 1


@pytest.mark.parametrize("k_pad", K_PADS)
def test_ell_adjacency_carries_the_plan(k_pad):
    g, _ = planted_hub_graph(3)
    adj = serving(g, k_pad)
    adj.validate()
    assert adj.t_split is adj.split            # symmetric: aliased
    want = walk_split_plan(adj.win_off.numpy(), NUM_SMS, adj.p)
    for got, ref in zip(_plan_np(adj.split), want):
        np.testing.assert_array_equal(got, ref)
    rg, _ = graphs(*_rect_coo(4), (300, 120))
    radj = ell_adjacency(rg, r=8, k_pad=k_pad, span_pass_limit=0,
                         device="cpu")
    radj.validate()
    for split, off in ((radj.split, radj.win_off), (radj.t_split,
                                                     radj.t_win_off)):
        for got, ref in zip(_plan_np(split),
                            walk_split_plan(off.numpy(), NUM_SMS, radj.p)):
            np.testing.assert_array_equal(got, ref)
    moved = radj.to("cpu")
    assert moved.split.walk == radj.split.walk


def _rect_coo(seed):
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(400, np.int64),
                          rng.integers(1, 300, 900)])
    dst = np.concatenate([rng.integers(0, 120, 400),
                          rng.integers(0, 120, 900)])
    return src, dst, rng.random(src.shape[0]).astype(np.float32)


def test_validate_rejects_a_bad_plan():
    g, _ = planted_hub_graph(5)
    adj = serving(g, 32)
    split = adj.split
    bad = dataclasses.replace(split, light=split.light[1:])
    with pytest.raises(AssertionError, match="every window once"):
        dataclasses.replace(adj, split=bad).validate()
    parts = split.parts.clone()
    parts[0, -1] -= 1
    with pytest.raises(AssertionError, match="parts tile"):
        dataclasses.replace(adj, split=dataclasses.replace(
            split, parts=parts)).validate()


def test_kernel_wrapper_rejects_a_plan_that_misses_a_window():
    g, _ = planted_hub_graph(6)
    adj = serving(g, 32)
    x = torch.zeros(adj.n_cols, 8)
    bad = dataclasses.replace(adj.split, light=adj.split.light[1:])
    with pytest.raises(ValueError, match="each of the"):
        es._ell_spmm_kernel(x, adj.cols, adj.vals, adj.win_off,
                            adj.row_space, plan=bad)


@pytest.mark.parametrize("k_pad", [32, 128])
def test_sharded_layouts_carry_the_plan(k_pad):
    g, _ = planted_hub_graph(7, n=960)
    sg = shard_graph_by_rows(g, 4)
    plan = build_halo_plan_ragged(sg)
    interior, halo = build_sharded_ell_blocks(sg, plan, r=8, k_pad=k_pad,
                                              device="cpu")
    mono = build_sharded_ell(sg, plan, r=8, k_pad=k_pad, device="cpu")
    heavy_seen = 0
    for adj in interior + halo + mono:
        adj.validate()
        for split, off in ((adj.split, adj.win_off),
                           (adj.t_split, adj.t_win_off)):
            heavy_seen += split.n_heavy
            for got, ref in zip(_plan_np(split),
                                walk_split_plan(off.numpy(), NUM_SMS,
                                                adj.p)):
                np.testing.assert_array_equal(got, ref)
    assert heavy_seen


def _f64(t):
    return t.double()


@pytest.mark.parametrize("products_bf16", [False, True])
@pytest.mark.parametrize("parts", [8, 16])
@pytest.mark.parametrize("k_pad", K_PADS)
def test_plain_split_equals_plain_in_float64(k_pad, parts, products_bf16):
    g, _ = planted_hub_graph(8)
    adj = serving(g, k_pad)
    split = walk_split(adj.win_off.numpy(), adj.p, "cpu", parts=parts,
                       split_blocks=2)
    assert split.n_heavy and split.n_light
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (adj.n_cols, 33)))
    want = es._ell_spmm_plain(x, adj.cols, _f64(adj.vals), adj.win,
                              adj.win_off, adj.row_space, products_bf16)
    got = es._ell_spmm_plain_split(x, adj.cols, _f64(adj.vals), adj.win_off,
                                   split, adj.row_space, products_bf16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


# table_bf16 rounds x identically in both packages (f32 after that);
# products_bf16 rounds f32 sums taken in another order, so a bf16 ulp
@pytest.mark.parametrize("option,tol", [(None, 1e-5), ("table_bf16", 1e-5),
                                        ("products_bf16", 2e-2)])
@pytest.mark.parametrize("k_pad", K_PADS)
def test_plain_split_matches_gcn_tpu(k_pad, option, tol):
    """Forward over the forward arrays and dX over the transpose arrays,
    each summed by its own plan, against gcn_tpu's spmm_ell and its VJP."""
    g, jg = planted_hub_graph(9)
    opts = {option: True} if option else {}
    kw = dict(r=8, k_pad=k_pad, span_pass_limit=0, **opts)
    adj = ell_adjacency(g, device="cpu", **kw)
    jadj = jx_ell(jg, **kw)
    assert adj.n_hub == 0 and adj.split.n_heavy
    rng = np.random.default_rng(1)
    x = rng.standard_normal((adj.n_cols, 8)).astype(np.float32)
    ct = rng.standard_normal((adj.n_rows, 8)).astype(np.float32)

    def table(v):
        v = torch.tensor(v)
        return v.to(torch.bfloat16).float() if option == "table_bf16" else v

    pb = option == "products_bf16"
    out = es._ell_spmm_plain_split(table(x), adj.cols, adj.vals, adj.win_off,
                                   adj.split, adj.row_space, pb)
    dx = es._ell_spmm_plain_split(table(ct), adj.t_cols, adj.t_vals,
                                  adj.t_win_off, adj.t_split,
                                  adj.t_row_space, pb)
    jout, vjp = jax.vjp(lambda xx: jx_spmm_ell(jadj, xx), jnp.asarray(x))
    jdx = vjp(jnp.asarray(ct))[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=tol,
                               atol=tol)
