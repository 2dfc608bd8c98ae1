"""The port's default training loop, ``jit_loop=True``: the whole fit as
replays of one captured CUDA graph on the card, the same device-side body
run uncaptured on the CPU (``gcn_tpu_torch/train/capture.py``).

On the CPU the captured flavor is held against gcn_tpu's own default, the
``lax.scan`` of ``_fit_scanned`` (gcn_tpu/train/loop.py:187-316) and
HGNN's scanned body (gcn_tpu/models/hgnn.py:204-243), for ``fit_gcn``,
``GCN.fit`` and ``HGNN.fit`` (both forms of G) in every mode. Dropout 0
and gcn_tpu's parameters carried over (``params_from_numpy``), since the
two frameworks' random streams differ. The record (history length and
iterations, ``best_iter``, ``iters_run``) is equal, and so are the counts
of correct validation rows behind the val accuracies and HGNN's best
accuracy (compared at rtol 1e-6: the two frameworks' f32 means of the
same count can differ by an ulp); losses agree at rtol 1e-4 and outputs
at atol 1e-4 + rtol 1e-5 (HGNN logits rtol and atol 1e-4), the
tolerances and reasons of
tests/test_torch_port_model.py and tests/test_torch_port_hgnn.py: f32
sums in another order, compounded over the Adam steps.

Against the port's own eager flavor (``jit_loop=False``) the captured one
is bit-equal on the CPU, dropout on: both run the same arithmetic in the
same order. That holds for the generator's state after an early-stopped
run too, whose stopped iterations are computed and discarded. A resume
across the flavors repeats the uninterrupted run at rtol 1e-6.
"""

import inspect
import os

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.data import get_dataset as jx_get_dataset
from gcn_tpu.graph import hypergraph as jx_hg
from gcn_tpu.graph.normalize import gcn_normalize as jx_normalize
from gcn_tpu.models import GCN as JxGCN
from gcn_tpu.models.gcn_core import gcn_forward as jx_gcn_forward
from gcn_tpu.models.gcn_core import init_gcn_params as jx_init_gcn
from gcn_tpu.models.hgnn import HGNN as JxHGNN
from gcn_tpu.models.hgnn import init_hgnn_params as jx_init_hgnn
from gcn_tpu.models.layers import auto_order as jx_auto_order
from gcn_tpu.ops.spmm import hoist_spmm as jx_hoist
from gcn_tpu.reorder import reorder_graph as jx_reorder
from gcn_tpu.tile import degree_sort_order as jx_degree_sort
from gcn_tpu.tile import panel_adjacency as jx_panel
from gcn_tpu.train.loop import fit_gcn as jx_fit
from gcn_tpu.train.optim import adam_l2 as jx_adam

from gcn_tpu_torch import train_gcn
from gcn_tpu_torch.convert import params_from_numpy
from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.graph import hypergraph as hg
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.models import GCN, HGNN
from gcn_tpu_torch.models.gcn_core import gcn_forward
from gcn_tpu_torch.models.layers import auto_order
from gcn_tpu_torch.ops.spmm import hoist_spmm
from gcn_tpu_torch.reorder import reorder_graph
from gcn_tpu_torch.tile import degree_sort_order, panel_adjacency
from gcn_tpu_torch.train import capture
from gcn_tpu_torch.train.loop import fit_gcn
from gcn_tpu_torch.train.optim import adam_l2
from torch_port_native import native_reorder  # noqa: F401 (autouse)

# (mode, learning rate, steps): early_stop with patience 3 at a rate where
# the val loss turns up, so that the run stops before its last step
MODES = [("no_val", 0.01, 12), ("val", 0.01, 12), ("early_stop", 0.05, 60)]
# the panel fits train on the first 20 training rows in early_stop, where
# the val loss turns up after ~20 steps
PANEL_MODES = MODES[:2] + [("early_stop", 0.05, 60)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return torch.equal(a, b)


def _losses(history, key="loss_train"):
    return [float(h[key]) for h in history]


def _same_record(got, want, got_iters, want_iters):
    assert [h["iter"] for h in got] == [int(h["iter"]) for h in want]
    assert got_iters == want_iters
    for key in ("loss_train", "loss_val"):
        if key in want[0]:
            np.testing.assert_allclose(_losses(got, key),
                                       _losses(want, key), rtol=1e-4)
    if "acc_val" in want[0]:
        # equal counts of correct rows: the two frameworks' f32 means of
        # them may differ by an ulp, far below one row's 1 / n_val
        np.testing.assert_allclose(_losses(got, "acc_val"),
                                   _losses(want, "acc_val"), rtol=1e-6)


def test_fit_entry_points_default_to_the_captured_loop():
    """fit_gcn, GCN.fit and HGNN.fit take ``jit_loop``, True by default,
    as gcn_tpu's three do."""
    for ours, ref in ((fit_gcn, jx_fit), (GCN.fit, JxGCN.fit),
                      (HGNN.fit, JxHGNN.fit)):
        got = inspect.signature(ours).parameters["jit_loop"]
        want = inspect.signature(ref).parameters["jit_loop"]
        assert got.default is want.default is True
        assert got.kind == inspect.Parameter.KEYWORD_ONLY


# ---- fit_gcn over the panel layout (K2's path) --------------------------


def _panel_problem():
    """synth-tiny after rabbit and the degree sort, in both packages: the
    panel layout, layer 1 hoisted, gcn_tpu's parameters at a hidden width
    below the class count (layer 2 on (AX)W, as on the synth-arxiv main
    path)."""
    jdata = jx_get_dataset("synth-tiny", seed=1)
    data = get_dataset("synth-tiny", seed=1)
    nhid = data.num_classes - 1
    orders = ("xw", auto_order(nhid, data.num_classes))
    assert orders[1] == jx_auto_order(nhid, data.num_classes) == "ax_w"
    jg, perm = jx_reorder(jx_normalize(jdata.adj), "rabbit")
    ds = jx_degree_sort(jg)
    jg, perm = jg.permute(ds), perm[ds]
    g, perm2 = reorder_graph(gcn_normalize(data.adj), "rabbit")
    ds2 = degree_sort_order(g)
    g, perm2 = g.permute(ds2), perm2[ds2]
    np.testing.assert_array_equal(perm, perm2)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    params = _np(jx_init_gcn(jax.random.PRNGKey(3), data.num_features,
                             nhid, data.num_classes))
    return dict(jg=jg, g=g, perm=perm, inv=inv, params=params, orders=orders,
                jdata=jdata, data=data)


def _port_panel_fit(pb, mode, lr, steps, jit_loop, dropout=0.0, **kw):
    data, perm, inv = pb["data"], pb["perm"], pb["inv"]
    adj = panel_adjacency(pb["g"], device="cpu")
    feats = hoist_spmm(adj, torch.tensor(data.features[perm]))
    gen = torch.Generator().manual_seed(9)

    def forward(p, train):
        return gcn_forward(p, feats, adj, orders=pb["orders"],
                           dropout_rate=dropout, train=train, generator=gen)

    idx_val = (torch.tensor(inv[np.asarray(data.idx_val)])
               if mode != "no_val" else None)
    return fit_gcn(params_from_numpy(pb["params"], "cpu"),
                   lambda ps: adam_l2(ps, lr), forward,
                   torch.tensor(data.labels[perm]),
                   torch.tensor(_panel_train(pb, mode)), idx_val,
                   train_iters=steps, mode=mode, patience=3,
                   generator=gen, jit_loop=jit_loop, **kw)


def _panel_train(pb, mode):
    idx = pb["inv"][np.asarray(pb["data"].idx_train)]
    return idx[:20] if mode == "early_stop" else idx


@pytest.fixture(scope="module")
def panel_problem():
    return _panel_problem()


@pytest.mark.parametrize("mode,lr,steps", PANEL_MODES)
def test_fit_gcn_matches_gcn_tpu_scan(panel_problem, mode, lr, steps):
    pb = panel_problem
    jdata, perm, inv = pb["jdata"], pb["perm"], pb["inv"]
    jadj = jx_panel(pb["jg"])
    jfeats = jx_hoist(jadj, jax.numpy.asarray(jdata.features[perm]))

    def jforward(p, fd, train, rng):
        return jx_gcn_forward(p, fd[0], fd[1], orders=pb["orders"],
                              dropout_rate=0.0, train=train, rng=rng)

    ref = jx_fit(pb["params"], jx_adam(lr=lr), jforward,
                 jdata.labels[perm], _panel_train(pb, mode),
                 (inv[np.asarray(jdata.idx_val)] if mode != "no_val"
                  else None),
                 forward_data=(jfeats, jadj), train_iters=steps, mode=mode,
                 patience=3, jit_loop=True)
    ours = _port_panel_fit(pb, mode, lr, steps, jit_loop=True)
    if mode == "early_stop":
        assert ref.iters_run < steps
    _same_record(ours.history, ref.history, ours.iters_run, ref.iters_run)
    assert ours.best_iter == ref.best_iter
    np.testing.assert_allclose(ours.log_probs.numpy(),
                               np.asarray(ref.log_probs), rtol=1e-5,
                               atol=1e-4)
    assert "fit_scan" in ours.timers.names()


@pytest.mark.parametrize("mode,lr,steps", PANEL_MODES)
def test_fit_gcn_captured_equals_eager(panel_problem, mode, lr, steps):
    """Dropout 0.5: the same masks from the same generator, the same
    arithmetic, so every result and the generator's state are equal."""
    runs = [_port_panel_fit(panel_problem, mode, lr, steps, jit_loop,
                            dropout=0.5) for jit_loop in (True, False)]
    captured, eager = runs
    if mode == "early_stop":
        assert eager.iters_run < steps
    assert captured.history == eager.history
    assert captured.best_iter == eager.best_iter
    assert captured.iters_run == eager.iters_run == len(eager.history)
    assert torch.equal(captured.log_probs, eager.log_probs)
    assert _tree_equal(captured.params, eager.params)
    assert _tree_equal(captured.final_params, eager.final_params)
    assert _tree_equal(captured.opt_state, eager.opt_state)
    assert torch.equal(captured.rng_state, eager.rng_state)
    # the step timer keeps the replays after the reference's first 10
    # steps, stopped ones included (they ran)
    assert captured.timers("step").d.count == steps - 10


# ---- GCN.fit, v6 over the ELL layout (K1's path) ------------------------


def _gcn_fit(jit_loop, mode, lr, steps, dropout=0.0, params=None, **kw):
    data = get_dataset("synth-tiny", seed=1)
    model = GCN(data.num_features, 8, data.num_classes, variant="v6",
                dropout=dropout, seed=5, lr=lr, device="cpu")
    if params is not None:
        model.params = params_from_numpy(params, "cpu")
    model.fit(data.features, data.adj, data.labels, data.idx_train,
              idx_val=data.idx_val if mode != "no_val" else None,
              train_iters=steps, mode=mode, patience=3,
              initialize=params is None, jit_loop=jit_loop, **kw)
    return model


@pytest.mark.parametrize("mode,lr,steps", MODES)
def test_gcn_fit_matches_gcn_tpu_scan(mode, lr, steps):
    data = jx_get_dataset("synth-tiny", seed=1)
    kw = dict(dropout=0.0, variant="v6", seed=5, lr=lr)
    ref = JxGCN(data.num_features, 8, data.num_classes, **kw)
    ref.fit(data.features, data.adj, data.labels, data.idx_train,
            idx_val=data.idx_val if mode != "no_val" else None,
            train_iters=steps, mode=mode, patience=3, jit_loop=True)
    params = _np(jx_init_gcn(jax.random.PRNGKey(5), data.num_features, 8,
                             data.num_classes))
    ours = _gcn_fit(True, mode, lr, steps, params=params)
    if mode == "early_stop":
        assert ref._iters_done < steps
    _same_record(ours.history, ref.history, ours._iters_done,
                 ref._iters_done)
    assert ours.best_iter == ref.best_iter
    np.testing.assert_allclose(ours.output.numpy(), np.asarray(ref.output),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode,lr,steps", MODES)
def test_gcn_fit_captured_equals_eager(mode, lr, steps):
    captured, eager = (_gcn_fit(jit_loop, mode, lr, steps, dropout=0.5)
                       for jit_loop in (True, False))
    if mode == "early_stop":
        assert eager._iters_done < steps
    assert captured.history == eager.history
    assert captured.best_iter == eager.best_iter
    assert captured._iters_done == eager._iters_done
    assert torch.equal(captured.output, eager.output)
    assert _tree_equal(captured._final_params, eager._final_params)
    assert torch.equal(captured._rng_state, eager._rng_state)


# ---- HGNN.fit, both forms of G -------------------------------------------


def _cloud(seed=2, n=160, f=24, classes=4):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n).astype(np.int64)
    centroids = rng.standard_normal((classes, f)).astype(np.float32) * 2
    x = centroids[labels] + rng.standard_normal((n, f)).astype(np.float32)
    return x, labels


def _g_form(h, form, port):
    mod = hg if port else jx_hg
    return (mod.generate_G_from_H(h) if form == "dense"
            else mod.generate_G_factors(h))


@pytest.mark.parametrize("form", ["dense", "factored"])
@pytest.mark.parametrize("with_val", [True, False])
def test_hgnn_fit_matches_gcn_tpu_scan(form, with_val):
    x, labels = _cloud()
    h = hg.construct_H_with_KNN(x, 6)
    kw = dict(n_hid=16, dropout=0.0, milestones=(4,), adj_kind="ell")
    idx_tr, idx_v = np.arange(100), np.arange(100, 160)
    fit_kw = dict(idx_val=idx_v if with_val else None, num_epochs=8)
    ref = JxHGNN(24, 4, **kw)
    ref.params = jx_init_hgnn(jax.random.PRNGKey(0), 24, 16, 4)
    ref.fit(x, _g_form(h, form, False), labels, idx_tr, jit_loop=True,
            **fit_kw)
    ours = HGNN(24, 4, device="cpu", **kw)
    ours.params = params_from_numpy(
        _np(jx_init_hgnn(jax.random.PRNGKey(0), 24, 16, 4)), "cpu")
    ours.fit(x, _g_form(h, form, True), labels, idx_tr, jit_loop=True,
             **fit_kw)
    assert len(ours.history) == 8
    assert ours._epochs_done == ref._epochs_done == 8
    # the same count of correct rows (the f32 means differ by an ulp)
    assert ours.best_acc == pytest.approx(ref.best_acc, rel=1e-6)
    np.testing.assert_allclose(ours.output.numpy(), np.asarray(ref.output),
                               rtol=1e-4, atol=1e-4)
    for layer in ("hgc1", "hgc2"):
        for key in ("w", "b"):
            np.testing.assert_allclose(
                ours._final_params[layer][key].numpy(),
                np.asarray(ref._final_params[layer][key]), rtol=1e-4,
                atol=1e-5)
    assert "fit_scan" in ours.timers.names()


@pytest.mark.parametrize("form", ["dense", "factored"])
def test_hgnn_fit_captured_equals_eager(form):
    x, labels = _cloud()
    h = hg.construct_H_with_KNN(x, 6)
    runs = []
    for jit_loop in (True, False):
        m = HGNN(24, 4, n_hid=16, dropout=0.5, milestones=(4,),
                 adj_kind="ell", device="cpu")
        m.fit(x, _g_form(h, form, True), labels, np.arange(100),
              idx_val=np.arange(100, 160), num_epochs=8, jit_loop=jit_loop)
        runs.append(m)
    captured, eager = runs
    assert captured.history == eager.history
    assert captured.best_acc == eager.best_acc
    assert torch.equal(captured.output, eager.output)
    assert _tree_equal(captured.params, eager.params)
    assert _tree_equal(captured._final_params, eager._final_params)
    assert torch.equal(captured._rng_state, eager._rng_state)
    assert captured._schedule_at == eager._schedule_at == 8
    assert len(captured.epoch_ms) == len(eager.epoch_ms) == 8


# ---- resumes across the two flavors --------------------------------------


@pytest.mark.parametrize("first,second", [(True, False), (False, True)])
def test_gcn_resume_across_flavors(tmp_path, first, second):
    """10 steps in one flavor, save_state, 10 in the other, against 20
    uninterrupted (dropout 0.5: the generator's state rides along)."""
    ref = _gcn_fit(True, "no_val", 0.01, 20, dropout=0.5)
    a = _gcn_fit(first, "no_val", 0.01, 10, dropout=0.5)
    a.save_state(str(tmp_path / "state"))
    b = _gcn_fit(second, "no_val", 0.01, 10, dropout=0.5,
                 resume_from=str(tmp_path / "state"))
    assert b._iters_done == 20
    np.testing.assert_allclose(_losses(a.history) + _losses(b.history),
                               _losses(ref.history), rtol=1e-6)
    torch.testing.assert_close(b.output, ref.output, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("form", ["dense", "factored"])
@pytest.mark.parametrize("first,second", [(True, False), (False, True)])
def test_hgnn_resume_across_flavors(tmp_path, form, first, second):
    """10 + 10 epochs across the flavors against 20, with milestones at 5
    and 15: the first part and the resumed one each cross one."""
    x, labels = _cloud()
    G = _g_form(hg.construct_H_with_KNN(x, 6), form, True)
    kw = dict(n_hid=16, dropout=0.5, milestones=(5, 15), adj_kind="ell",
              device="cpu")

    def fit(jit_loop, epochs, **fit_kw):
        m = HGNN(24, 4, **kw)
        m.fit(x, G, labels, np.arange(100), num_epochs=epochs,
              jit_loop=jit_loop, **fit_kw)
        return m

    ref = fit(True, 20)
    a = fit(first, 10)
    a.save_state(str(tmp_path / "state"))
    b = fit(second, 10, resume_from=str(tmp_path / "state"))
    assert b._schedule_at == 20
    np.testing.assert_allclose(_losses(a.history) + _losses(b.history),
                               _losses(ref.history), rtol=1e-6)
    torch.testing.assert_close(b.output, ref.output, rtol=1e-6, atol=1e-6)


# ---- the loop's own pieces -----------------------------------------------


def test_generator_state_after_replays_extrapolates_the_offset():
    """On the card the replayed iterations are not recorded: their state
    is the last recorded one's Philox offset advanced by one iteration's
    increment each (a CUDA generator's state: seed, then offset)."""
    loop = capture.CapturedLoop(lambda: None, "cpu", torch.Generator())

    def state(seed, offset):
        return torch.tensor(list(seed.to_bytes(8, "little"))
                            + list(offset.to_bytes(8, "little")),
                            dtype=torch.uint8)

    loop._states = [state(7, 0), state(7, 12), state(7, 24)]
    assert torch.equal(loop.generator_state_after(1), state(7, 12))
    assert torch.equal(loop.generator_state_after(2), state(7, 24))
    assert torch.equal(loop.generator_state_after(5), state(7, 60))
    loop._states[-1] = state(8, 24)
    with pytest.raises(RuntimeError, match="seed and Philox offset"):
        loop.generator_state_after(5)


def test_cli_reports_the_fit_scan_timer(capsys):
    train_gcn.main(["-g", "synth-tiny", "-k", "8", "-i", "12",
                    "--variant", "v6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fit_scan" in out and "step" in out
