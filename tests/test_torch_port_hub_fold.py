"""The port's fixed-order hub fold against the ``index_add_`` fold it
replaces and against gcn_tpu's sorted ``segment_sum``.

The fold (``ops/ell_spmm.py::_hub_epilogue``, plan from
``tile/ell.py::hub_fold_plan``) adds each hub's chunks in chunk order, so
on the CPU it is bit-equal to ``index_add_`` (``torch.equal`` and the same
bits); against gcn_tpu's ``segment_sum`` it holds at rtol 1e-6 (XLA may
reassociate). Layouts: hubs of one chunk beside hubs of many (a plan with
padding), the degree-sorted layouts' largest chunk counts, and none.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.ell_spmm import _hub_epilogue as jx_hub_epilogue
from gcn_tpu.ops.ell_spmm import spmm_ell as jx_spmm_ell
from gcn_tpu.tile.ell import ell_adjacency as jx_ell

from gcn_tpu_torch.ops import ell_spmm as es
from gcn_tpu_torch.tile.ell import ell_adjacency, hub_fold_plan
from torch_port_graphs import graphs


def _index_add_fold(out_virt, virt_map, n_hub, n_real):
    """The fold as the port had it: ``index_add_`` over ``virt_map``."""
    n_virt_hub = virt_map.shape[0]
    hub = out_virt.new_zeros((n_hub, out_virt.shape[1]))
    hub.index_add_(0, virt_map, out_virt[:n_virt_hub])
    rest = out_virt[n_virt_hub:n_virt_hub + (n_real - n_hub)]
    return torch.cat([hub, rest], dim=0)


def _plan_adj(virt_map, n_real):
    """A stand-in with the fields the fold reads, for any virt_map."""
    vm = np.asarray(virt_map, np.int64)
    idx, steps = hub_fold_plan(vm)
    n_hub = int(vm.max()) + 1 if len(vm) else 0
    return types.SimpleNamespace(
        n_hub=n_hub, virt_map=torch.tensor(vm, dtype=torch.int32),
        hub_idx=torch.from_numpy(idx), hub_steps=steps, n_rows=n_real)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _powerlaw_graph(seed, n=600, m=9000):
    """Heavy-tailed, symmetric, degree-sorted: hubs of 2 up to many
    chunks at the default cap."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1) ** 1.1
    src = rng.choice(n, m, p=w / w.sum())
    dst = rng.integers(0, n, m)
    return graphs(src, dst, rng.random(m).astype(np.float32), (n, n),
                  symmetric=True, sort=True, binarize=False)


def _rect_graph(seed, n=200, m=500):
    """Rectangular; hub rows 0-1 and hub columns 0-2 lead a light tail,
    so both directions split and fold."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(300, np.int64), np.ones(140, np.int64),
                          rng.integers(2, n, 1200)])
    dst = rng.integers(3, m, src.shape[0])
    heavy = rng.random(src.shape[0])
    dst = np.where(heavy < 0.15, 0, np.where(heavy < 0.25, 1,
                                             np.where(heavy < 0.3, 2, dst)))
    return graphs(src, dst, rng.random(src.shape[0]).astype(np.float32),
                  (n, m))


@pytest.mark.parametrize("virt_map", [
    [0, 0, 1, 2, 2, 2, 3],              # one-chunk hubs among others
    [0, 1, 1, 1, 1, 1, 2, 2, 3],        # a later hub holds the most
    [0, 0, 0, 1, 1, 2, 2, 3, 3],        # nonincreasing: no padding
    [0, 1, 2],                          # one chunk each
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fold_bit_equal_to_index_add(virt_map, dtype):
    rng = np.random.default_rng(len(virt_map))
    n_tail = 5
    adj = _plan_adj(virt_map, max(virt_map) + 1 + n_tail)
    out = torch.tensor(rng.standard_normal((len(virt_map) + n_tail, 7)),
                       dtype=dtype)
    want = _index_add_fold(out, adj.virt_map, adj.n_hub, adj.n_rows)
    got = es._hub_epilogue(out.clone(), adj)
    assert torch.equal(got, want)
    if dtype == torch.float32:
        assert torch.equal(_bits(got), _bits(want))


def test_fold_plan_steps():
    """Chunk c of hub h is read at step c, in hub order; rows a hub lacks
    read the zero row; a nonincreasing chunk count needs no padding."""
    idx, steps = hub_fold_plan(np.array([0, 0, 1, 2, 2, 2, 3]))
    assert steps == (4, 3, 3)
    np.testing.assert_array_equal(idx, [0, 2, 3, 6, 1, 7, 4, 7, 7, 5])
    idx, steps = hub_fold_plan(np.array([0, 0, 0, 1, 1, 2]))
    assert steps == (3, 2, 1) and (idx < 6).all()
    with pytest.raises(ValueError):
        hub_fold_plan(np.array([1, 0]))


@pytest.mark.parametrize("case", ["powerlaw", "rect", "none"])
def test_fold_on_layouts_matches_index_add_and_gcn_tpu(case):
    """Both directions of real layouts: bit-equal to ``index_add_``, and
    equal to gcn_tpu's ``segment_sum`` fold at rtol 1e-6."""
    if case == "rect":
        g, jg = _rect_graph(3)
        kw = dict(span_pass_limit=4)
    else:
        g, jg = _powerlaw_graph(2)
        kw = dict(span_pass_limit=4 if case == "powerlaw" else 1 << 10)
    adj = ell_adjacency(g, k_pad=32, device="cpu", **kw)
    jadj = jx_ell(jg, k_pad=32, **kw)
    if case == "none":
        assert adj.n_hub == 0 and adj.hub_idx is None
    else:
        assert adj.n_hub > 1 and len(adj.hub_steps) > 2
        assert adj.t_n_hub > 1 and len(adj.t_hub_steps) > 2
    adj.validate()
    rng = np.random.default_rng(4)
    for t in (False, True):
        n_hub, vm, n_real, space = (
            (adj.t_n_hub, adj.t_virt_map, adj.n_cols, adj.t_row_space) if t
            else (adj.n_hub, adj.virt_map, adj.n_rows, adj.row_space))
        out = torch.tensor(rng.standard_normal((space, 33)),
                           dtype=torch.float32)
        got = es._hub_epilogue(out.clone(), adj, t)
        if n_hub:
            assert torch.equal(_bits(got), _bits(
                _index_add_fold(out, vm, n_hub, n_real)))
        jvm, jn_hub = ((jadj.t_virt_map, jadj.t_n_hub) if t
                       else (jadj.virt_map, jadj.n_hub))
        want = np.asarray(jx_hub_epilogue(jnp.asarray(out.numpy()), jvm,
                                          jn_hub, n_real))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", ["powerlaw", "rect"])
def test_spmm_ell_through_the_fold_matches_gcn_tpu(case):
    """``spmm_ell``'s output and dX on hub layouts against gcn_tpu's, at
    the SpMM parity tests' tolerance (rtol/atol 1e-5)."""
    import jax

    g, jg = _powerlaw_graph(5) if case == "powerlaw" else _rect_graph(6)
    adj = ell_adjacency(g, k_pad=32, span_pass_limit=4, device="cpu")
    jadj = jx_ell(jg, k_pad=32, span_pass_limit=4)
    assert adj.n_hub and (case == "powerlaw" or adj.t_n_hub)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((g.shape[1], 24)).astype(np.float32)
    ct = rng.standard_normal((g.shape[0], 24)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    out = es.spmm_ell(adj, xt)
    out.backward(torch.tensor(ct))
    jout, vjp = jax.vjp(lambda v: jx_spmm_ell(jadj, v), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)


def test_validate_catches_a_stale_fold_plan():
    import dataclasses

    g, _ = _powerlaw_graph(2)
    adj = ell_adjacency(g, k_pad=32, span_pass_limit=4, device="cpu")
    bad = dataclasses.replace(adj, hub_idx=adj.hub_idx.flip(0))
    with pytest.raises(AssertionError, match="hub fold plan"):
        bad.validate()
    moved = adj.to("cpu")
    assert moved.hub_steps == adj.hub_steps
    assert torch.equal(moved.hub_idx, adj.hub_idx)
    assert moved.t_hub_idx is moved.hub_idx


def test_captured_style_fit_bit_equal_to_eager_on_hub_layout():
    """On the CPU the captured loop's body runs uncaptured: a fit over a
    hub-split layout through the fold is bit-equal in both flavors."""
    from gcn_tpu_torch.models.gcn_core import gcn_forward, init_gcn_params
    from gcn_tpu_torch.models.layers import auto_order
    from gcn_tpu_torch.ops.spmm import hoist_spmm
    from gcn_tpu_torch.train.loop import fit_gcn
    from gcn_tpu_torch.train.optim import adam_l2

    g, _ = _powerlaw_graph(8)
    adj = ell_adjacency(g, k_pad=32, span_pass_limit=4, device="cpu")
    assert adj.n_hub
    n = g.shape[0]
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.standard_normal((n, 12)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, 4, n))
    runs = []
    for jit_loop in (False, True):
        params = init_gcn_params(torch.Generator().manual_seed(3), 12, 16,
                                 4, device="cpu")
        feats = hoist_spmm(adj, x)
        gen = torch.Generator().manual_seed(11)

        def forward(p, train, feats=feats, gen=gen):
            return gcn_forward(p, feats, adj,
                               orders=("xw", auto_order(16, 4)),
                               dropout_rate=0.5, train=train, generator=gen)

        runs.append(fit_gcn(params, lambda ps: adam_l2(ps, 0.01), forward,
                            labels, torch.arange(0, n // 2),
                            torch.arange(n // 2, n), train_iters=8,
                            mode="val", generator=gen, jit_loop=jit_loop))
    eager, captured = runs
    assert [h["loss_train"] for h in captured.history] == \
        [h["loss_train"] for h in eager.history]
    assert torch.equal(captured.log_probs, eager.log_probs)
