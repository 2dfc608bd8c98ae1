"""Inputs shared by the port's SpMM tests: graphs made with numpy from a
seed and built by both packages, the branch cases of gcn_tpu's
``_spmm_ell_impl`` that the port's single kernel must cover, and the graphs
of the panel (PanelAdj) tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gcn_tpu.data.synthetic import sbm as jx_sbm
from gcn_tpu.graph.csr import coo_to_csr as jx_coo
from gcn_tpu.graph.normalize import gcn_normalize as jx_normalize
from gcn_tpu.ops.ell_spmm import spmm_ell as jx_spmm_ell
from gcn_tpu.tile.ell import degree_sort_order as jx_degree_sort
from gcn_tpu.tile.ell import ell_adjacency as jx_ell

from gcn_tpu_torch.data.synthetic import sbm
from gcn_tpu_torch.graph.csr import coo_to_csr
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.ops import ell_spmm as es
from gcn_tpu_torch.tile.ell import degree_sort_order, ell_adjacency
from gcn_tpu_torch.tile.tiler import split_plan

# f32 sums taken in another order than gcn_tpu's
TOL = dict(rtol=1e-5, atol=1e-5)


def graphs(src, dst, vals, shape, symmetric=False, sort=False,
           binarize=True):
    """The same COO through both packages' CSR pipelines."""
    g = coo_to_csr(src, dst, vals, shape)
    jg = jx_coo(src, dst, vals, shape)
    if symmetric:
        g = gcn_normalize(g.symmetrize(binarize=binarize))
        jg = jx_normalize(jg.symmetrize(binarize=binarize))
    if sort:
        g = g.permute(degree_sort_order(g))
        jg = jg.permute(jx_degree_sort(jg))
    return g, jg


def random_graph(seed, n=150, m=1100, **kw):
    rng = np.random.default_rng(seed)
    return graphs(rng.integers(0, n, m), rng.integers(0, n, m),
                  rng.random(m).astype(np.float32), (n, n), **kw)


def hub_graph(seed):
    """Two hub rows well above span_pass_limit * P plus a normal tail."""
    rng = np.random.default_rng(seed)
    n = 96
    src = np.concatenate([np.zeros(200, np.int64), np.ones(180, np.int64),
                          rng.integers(2, n, 500)])
    dst = np.concatenate([rng.permutation(n)[:90].repeat(3)[:200],
                          rng.integers(0, n, 180), rng.integers(0, n, 500)])
    return graphs(src, dst, rng.random(880).astype(np.float32), (n, n),
                  symmetric=True, sort=True, binarize=False)


def unsorted_graph(seed):
    """Heavy-tailed degrees in random row order: spans guarded off."""
    rng = np.random.default_rng(seed)
    n = 2000
    deg = np.minimum((rng.pareto(1.0, n) * 6 + 1).astype(np.int64), 200)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.shape[0])
    g = coo_to_csr(src, dst, None, (n, n)).symmetrize()
    jg = jx_coo(src, dst, None, (n, n)).symmetrize()
    return g, jg


def rect_graph(seed, n=96, m=40, e=500, hub=False):
    """Non-square, non-symmetric; ``hub`` makes row 0 a (split) hub."""
    rng = np.random.default_rng(seed)
    if hub:
        src = np.concatenate([np.zeros(300, np.int64),
                              rng.integers(1, n, e)])
    else:
        src = rng.integers(0, n, e)
    dst = rng.integers(0, m, src.shape[0])
    return graphs(src, dst, rng.random(src.shape[0]).astype(np.float32),
                  (n, m))


def fwd_bwd_pair(adj, jadj, k, seed=0):
    """(port out, port dx, jax out, jax dx) on one numpy x and cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((adj.n_cols, k)).astype(np.float32)
    ct = rng.standard_normal((adj.n_rows, k)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    out = es.spmm_ell(adj, xt)
    out.backward(torch.tensor(ct))
    jout, vjp = jax.vjp(lambda xx: jx_spmm_ell(jadj, xx), jnp.asarray(x))
    jdx = vjp(jnp.asarray(ct))[0]
    return (out.detach().numpy(), xt.grad.numpy(), np.asarray(jout),
            np.asarray(jdx))


# name: (graphs, ell_adjacency kwargs, k, check that the branch is reached)
CASES = {
    "grouped_spans": (lambda: random_graph(1, symmetric=True, sort=True),
                      dict(r=8, k_pad=32), 8,
                      lambda a: a.spans and len(a.chunks) == 1),
    "hub_split": (lambda: hub_graph(2), dict(r=8, k_pad=32), 8,
                  lambda a: a.n_hub > 0),
    "merged_hub_region": (lambda: hub_graph(3),
                          dict(r=8, k_pad=32, hub_split=False), 8,
                          lambda a: any(pw > a.span_pass_limit
                                        for _, _, pw, _, _ in a.spans)),
    "small_span_limit": (lambda: hub_graph(4),
                         dict(r=8, k_pad=32, hub_split=False,
                              span_pass_limit=2), 8,
                         lambda a: any(pw > 2 for _, _, pw, _, _ in
                                       a.spans)),
    "row_chunked": (lambda: random_graph(5, n=200, m=1600, symmetric=True,
                                         sort=True),
                    dict(r=16, k_pad=32, chunk_slots=1024), 16,
                    lambda a: len(a.chunks) > 1),
    "unsorted_guarded": (lambda: unsorted_graph(6), dict(r=8, k_pad=32), 8,
                         lambda a: a.spans == ()),
    "rectangular": (lambda: rect_graph(7), dict(r=16, k_pad=32), 8,
                    lambda a: not a.symmetric),
    "rect_hub_split": (lambda: rect_graph(8, m=256, e=400, hub=True),
                       dict(r=8, k_pad=32), 8,
                       lambda a: a.n_hub > 0 and not a.symmetric),
    "k_below_k_pad": (lambda: random_graph(9, symmetric=True, sort=True),
                      dict(r=16, k_pad=32), 4, lambda a: True),
    "k_above_k_pad": (lambda: random_graph(10, symmetric=True, sort=True),
                      dict(r=16, k_pad=32), 48, lambda a: True),
    "k_128_k_pad_32": (lambda: random_graph(11, symmetric=True, sort=True),
                       dict(r=16, k_pad=32), 128, lambda a: True),
    "k_pad_128_ladder": (lambda: hub_graph(12), dict(r=8, k_pad=128), 8,
                         lambda a: a.p == 1),
}


def check_case(case):
    """Port vs gcn_tpu, forward and dX, and the port vs dense f64."""
    make, kw, k, branch = CASES[case]
    g, jg = make()
    adj, jadj = ell_adjacency(g, device="cpu", **kw), jx_ell(jg, **kw)
    assert branch(adj), f"fixture does not reach the {case} branch"
    out, dx, jout, jdx = fwd_bwd_pair(adj, jadj, k)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(dx, jdx, **TOL)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((g.shape[1], k)).astype(np.float32)
    dense = g.to_dense().astype(np.float64)
    np.testing.assert_allclose(out, dense @ x.astype(np.float64), **TOL)


def sbm_graph():
    """The SBM graph of tests/test_tile.py, normalized, in both packages."""
    g, _ = sbm(n=700, n_classes=5, avg_degree=9.0, seed=2)
    jg, _ = jx_sbm(n=700, n_classes=5, avg_degree=9.0, seed=2)
    return gcn_normalize(g), jx_normalize(jg)


def powerlaw_graph(seed, n=3000, sort=False):
    """Pareto degrees, symmetric and normalized; the hubs pass NB = 512.
    ``sort`` orders the rows by degree, so the first windows are heavy."""
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(1.0, n) * 4 + 1).astype(np.int64), 1500)
    deg[:3] = (1500, 900, 700)
    src = np.repeat(np.arange(n), deg)
    return graphs(src, rng.integers(0, n, src.shape[0]), None, (n, n),
                  symmetric=True, sort=sort)


def empty_window_graph(seed, n=400):
    """Rows 100..299 have no edge: window 1 of R = 128 holds only zeros."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, 100, 700),
                          rng.integers(300, n, 700)])
    return graphs(src, rng.integers(0, n, src.shape[0]),
                  rng.random(src.shape[0]).astype(np.float32), (n, n))


# name: graphs of the panel tests (default R = 128, NB = 512)
PANEL_GRAPHS = {
    "sbm": sbm_graph,
    "powerlaw": lambda: powerlaw_graph(21),
    "rect": lambda: rect_graph(22, n=300, m=200, e=2500),
    "n_not_multiple_of_r": lambda: random_graph(23, n=333, m=3000,
                                                symmetric=True),
    "empty_window": lambda: empty_window_graph(24),
}


def with_split(adj, split_slots):
    """``adj`` with K2's split plan remade at ``split_slots`` slots, to
    force (0) or forbid (a huge value) the split of every window."""
    def plan(win_off):
        return tuple(torch.from_numpy(a).to(win_off.device) for a in
                     split_plan(win_off.cpu().numpy(), adj.nb, split_slots))

    fwd = plan(adj.win_off)
    t = fwd if adj.symmetric else plan(adj.t_win_off)
    return dataclasses.replace(
        adj, heavy=fwd[0], heavy_parts=fwd[1], light=fwd[2], t_heavy=t[0],
        t_heavy_parts=t[1], t_light=t[2])
