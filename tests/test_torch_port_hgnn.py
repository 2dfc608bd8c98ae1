"""The port's HGNN against gcn_tpu's on the CPU: the hypergraph functions,
the forward over each form of G, the layer-1 expansion, training, the
``.mat`` loader, the YAML config and the CLI.

Inputs are made with numpy from a seed; parameters are gcn_tpu's, carried
over as numpy arrays, since the two frameworks' random streams differ.
Tolerances: the hypergraph functions are the same numpy code, so their arrays are
equal; one forward agrees at rtol 1e-5 (f32 sums in another order); after
10 Adam epochs logits agree at rtol and atol 1e-4 (the reordering
compounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.graph import hypergraph as jx_hg
from gcn_tpu.models.hgnn import HGNN as JxHGNN
from gcn_tpu.models.hgnn import hgnn_forward as jx_hgnn_forward
from gcn_tpu.models.hgnn import init_hgnn_params as jx_init
from gcn_tpu.ops.adjacency import device_adjacency as jx_device_adjacency
from gcn_tpu.ops.spmm import TwoHopAdj as JxTwoHopAdj

from gcn_tpu_torch import train_hgnn
from gcn_tpu_torch.convert import params_from_numpy
from gcn_tpu_torch.graph import hypergraph as hg
from gcn_tpu_torch.models.hgnn import HGNN, cross_entropy, hgnn_forward
from gcn_tpu_torch.ops.adjacency import CooAdj, DenseAdj, device_adjacency
from gcn_tpu_torch.ops.spmm import TwoHopAdj, spmm
from gcn_tpu_torch.tile.ell import EllAdj
from gcn_tpu_torch.utils.timers import counters
from torch_port_native import native_reorder  # noqa: F401 (autouse)


def _cloud(seed, n=160, f=24, classes=4):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n).astype(np.int64)
    centroids = rng.standard_normal((classes, f)).astype(np.float32) * 2
    x = centroids[labels] + rng.standard_normal((n, f)).astype(np.float32)
    return x, labels


def _csr_equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def _jax_params(seed, f, n_hid, n_class):
    return jax.tree_util.tree_map(
        np.asarray, jx_init(jax.random.PRNGKey(seed), f, n_hid, n_class))


def test_distances_and_knn_incidence_equal_gcn_tpu():
    x, _ = _cloud(0)
    np.testing.assert_array_equal(hg.euclidean_distances(x),
                                  jx_hg.euclidean_distances(x))
    for k, is_prob in ((5, True), (8, False)):
        h = hg.construct_H_with_KNN(x, k, is_prob=is_prob, m_prob=1.5)
        np.testing.assert_array_equal(
            h, jx_hg.construct_H_with_KNN(x, k, is_prob=is_prob,
                                          m_prob=1.5))
        # the vectorized version stays bit-equal to the reference loop
        np.testing.assert_array_equal(
            h, hg._construct_H_with_KNN_loop(x, k, is_prob=is_prob,
                                             m_prob=1.5))


def test_knn_with_duplicate_points_equals_gcn_tpu():
    """>= k exact duplicates (ties, where the loop's argsort and the
    vectorized argpartition may pick other neighbours): every center
    stays in its own hyperedge, and the arrays equal gcn_tpu's."""
    x, _ = _cloud(1, n=40)
    x[10:20] = x[10]
    h = hg.construct_H_with_KNN(x, 4)
    assert (np.diag(h) > 0).all()
    np.testing.assert_array_equal(h, jx_hg.construct_H_with_KNN(x, 4))


def test_G_and_factors_equal_gcn_tpu():
    x, _ = _cloud(2)
    h = hg.construct_H_with_KNN(x, 6)
    w = np.random.default_rng(2).random(h.shape[1])
    _csr_equal(hg.generate_G_from_H(h), jx_hg.generate_G_from_H(h))
    _csr_equal(hg.generate_G_from_H(h, w), jx_hg.generate_G_from_H(h, w))
    for ours, ref in zip(hg.generate_G_factors(h),
                         jx_hg.generate_G_factors(h)):
        _csr_equal(ours, ref)
    for ours, ref in zip(hg.generate_G_from_H([h, h[:, :50]]),
                         jx_hg.generate_G_from_H([h, h[:, :50]])):
        _csr_equal(ours, ref)


@pytest.mark.parametrize("split", [False, True])
def test_multi_modality_incidence_equals_gcn_tpu(split):
    a, _ = _cloud(3, n=50, f=8)
    b, _ = _cloud(4, n=50, f=5)
    ours = hg.construct_H_with_KNN_multi([a, b], [3, 6],
                                         split_diff_scale=split)
    ref = jx_hg.construct_H_with_KNN_multi([a, b], [3, 6],
                                           split_diff_scale=split)
    for o, r in zip(ours if split else [ours], ref if split else [ref]):
        np.testing.assert_array_equal(o, r)
    np.testing.assert_array_equal(
        hg.feature_concat(a, None, b[:, None, :], normal_col=True),
        jx_hg.feature_concat(a, None, b[:, None, :], normal_col=True))
    np.testing.assert_array_equal(hg.hyperedge_concat(a, None, b),
                                  jx_hg.hyperedge_concat(a, None, b))


def _g_forms(h, kind):
    """(port adjacency, gcn_tpu adjacency) of one form of G: the chain
    lowered as ``kind``, or (``factored``) its two ELL factors."""
    if kind == "factored":
        a1, a2 = hg.generate_G_factors(h)
        j1, j2 = jx_hg.generate_G_factors(h)
        kw = dict(k_pad=32, r=16)
        return (TwoHopAdj(device_adjacency(a1, "ell", device="cpu", **kw),
                          device_adjacency(a2, "ell", device="cpu", **kw)),
                JxTwoHopAdj(jx_device_adjacency(j1, "ell", **kw),
                            jx_device_adjacency(j2, "ell", **kw)))
    kw = dict(k_pad=128 if kind == "ell_kpad128" else 32, r=16)
    kind = "ell" if kind.startswith("ell") else kind
    if kind != "ell":
        kw = {}
    return (device_adjacency(hg.generate_G_from_H(h), kind, device="cpu",
                             **kw),
            jx_device_adjacency(jx_hg.generate_G_from_H(h), kind, **kw))


@pytest.mark.parametrize("kind", ["dense", "ell", "ell_kpad128",
                                  "factored"])
def test_hgnn_forward_matches_gcn_tpu(kind):
    """One forward (and the layer-1 expansion) over dense G, G as ELL at
    k_pad 32 and 128 (P = 1), and the two ELL factors; rtol 1e-5."""
    x, _ = _cloud(5)
    h = hg.construct_H_with_KNN(x, 7)
    adj, jadj = _g_forms(h, kind)
    if kind.startswith("ell"):
        assert isinstance(adj, EllAdj) and adj.p == 128 // adj.k_pad
    params = _jax_params(1, x.shape[1], 20, 4)
    ours = hgnn_forward(params_from_numpy(params, "cpu"), torch.tensor(x),
                        adj, train=False)
    ref = jx_hgnn_forward(params, jnp.asarray(x), jadj, train=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # G(XW + 1b^T) == (GX)W + (G1)b^T
    gx = spmm(adj, torch.tensor(x))
    rowsum = spmm(adj, torch.ones(x.shape[0], 1))[:, 0]
    hoisted = hgnn_forward(params_from_numpy(params, "cpu"), None, adj,
                           train=False, gx=gx, g_rowsum=rowsum)
    np.testing.assert_allclose(hoisted.numpy(), ours.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("chunk_slots", [None, 4096])
def test_G_ell_layout_equals_gcn_tpu(chunk_slots):
    """G and its factors tiled at k_pad 128 (P = 1, HGNN's n_hid 128): the
    arrays and the wide-k_pad metadata (the scaled chunk plan, span limit
    64, the pass ladder) equal gcn_tpu's."""
    from gcn_tpu.tile.ell import ell_adjacency as jx_ell

    from gcn_tpu_torch.tile.ell import ell_adjacency

    x, _ = _cloud(12, n=700)
    h = hg.construct_H_with_KNN(x, 10)
    kw = dict(k_pad=128) if chunk_slots is None else dict(
        k_pad=128, chunk_slots=chunk_slots)
    pairs = [(hg.generate_G_from_H(h), jx_hg.generate_G_from_H(h))]
    pairs += list(zip(hg.generate_G_factors(h), jx_hg.generate_G_factors(h)))
    for g, jg in pairs:
        ours = ell_adjacency(g, device="cpu", **kw)
        ref = jx_ell(jg, **kw)
        assert ours.p == 1 and ours.span_pass_limit == 64
        for name in ("cols", "vals", "win", "t_cols", "t_vals", "t_win"):
            np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        for name in ("chunks", "t_chunks", "spans", "t_spans", "symmetric",
                     "n_hub", "t_n_hub"):
            assert getattr(ours, name) == getattr(ref, name), name
        if chunk_slots:
            assert len(ours.chunks) > 1
        ours.validate()


def test_factored_G_matches_chain():
    """TwoHopAdj of the two ELL factors equals the materialized chain at
    rtol 1e-4 (gcn_tpu's test tolerance), forward and dX."""
    x, _ = _cloud(6)
    h = hg.construct_H_with_KNN(x, 6)
    two_hop, _ = _g_forms(h, "factored")
    chain, _ = _g_forms(h, "ell")
    rng = np.random.default_rng(6)
    xin = rng.standard_normal((x.shape[0], 8)).astype(np.float32)
    ct = torch.tensor(rng.standard_normal((x.shape[0], 8)).astype(
        np.float32))
    grads = []
    for adj in (two_hop, chain):
        xt = torch.tensor(xin, requires_grad=True)
        out = spmm(adj, xt)
        out.backward(ct)
        grads.append((out.detach().numpy(), xt.grad.numpy()))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cross_entropy_matches_gcn_tpu():
    from gcn_tpu.models.hgnn import cross_entropy as jx_ce

    rng = np.random.default_rng(7)
    logits = rng.standard_normal((30, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 30)
    idx = rng.permutation(30)[:12]
    ours = cross_entropy(torch.tensor(logits), torch.tensor(labels),
                         torch.tensor(idx))
    ref = jx_ce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(idx))
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)


def _fit_pair(kind, epochs=10, milestones=(4,), adj_kind="ell"):
    x, labels = _cloud(8)
    h = hg.construct_H_with_KNN(x, 6)
    if kind == "factored":
        g, jg = hg.generate_G_factors(h), jx_hg.generate_G_factors(h)
    else:
        g, jg = hg.generate_G_from_H(h), jx_hg.generate_G_from_H(h)
    idx = np.random.default_rng(8).permutation(x.shape[0])
    kw = dict(in_ch=x.shape[1], n_class=4, n_hid=16, dropout=0.0, seed=0,
              milestones=milestones, lr=0.01, adj_kind=adj_kind)
    ref = JxHGNN(**kw)
    params = _jax_params(0, x.shape[1], 16, 4)
    ref.params = jax.tree_util.tree_map(jnp.asarray, params)
    ref.fit(x, jg, labels, idx[:100], idx_val=idx[100:], num_epochs=epochs)
    ours = HGNN(device="cpu", **kw)
    ours.params = params_from_numpy(params, "cpu")
    ours.fit(x, g, labels, idx[:100], idx_val=idx[100:], num_epochs=epochs)
    return ours, ref, idx


@pytest.mark.parametrize("kind,adj_kind", [("chain", "dense"),
                                           ("chain", "ell"),
                                           ("factored", "ell"),
                                           ("chain", "coo"),
                                           ("factored", "coo")])
def test_hgnn_fit_matches_gcn_tpu(kind, adj_kind):
    """10 epochs across a milestone at 4 (dropout 0): the final output
    and best_acc equal gcn_tpu's (rtol and atol 1e-4)."""
    ours, ref, idx = _fit_pair(kind, adj_kind=adj_kind)
    np.testing.assert_allclose(ours.output.numpy(), np.asarray(ref.output),
                               rtol=1e-4, atol=1e-4)
    assert ours.best_acc == pytest.approx(ref.best_acc, abs=1e-6)
    assert ours.test(idx[100:], verbose=False) == pytest.approx(
        ref.test(idx[100:], verbose=False), abs=1e-6)
    assert len(ours.history) == 10 and len(ours.epoch_ms) == 10
    assert ours.history[-1]["loss_train"] < ours.history[0]["loss_train"]


def test_hgnn_fit_runs_through_the_ell_path_on_cpu():
    """On the CPU, ELL-lowered G runs K1's plain version: no launch."""
    before = counters["spmm_ell"]
    ours, _, _ = _fit_pair("chain", epochs=2)
    assert isinstance(ours.g_adj, EllAdj)
    assert counters["spmm_ell"] == before


def test_lower_area_rule():
    """"auto" is dense up to an 8192 x 8192-equivalent area and COO past
    it, for a square operator and for a tall or wide one; "ell" is K1's
    layout at k_pad 128 when n_hid > 64, 32 otherwise."""
    from gcn_tpu_torch.graph.csr import coo_to_csr

    small = coo_to_csr(np.arange(10), np.arange(10), None, (10, 10))
    tall = coo_to_csr(np.arange(10), np.zeros(10, np.int64), None,
                      (100_000, 600))
    square = coo_to_csr(np.arange(10), np.arange(10), None, (9000, 9000))
    past_tall = coo_to_csr(np.arange(10), np.zeros(10, np.int64), None,
                           (100_000, 700))
    past_wide = coo_to_csr(np.zeros(10, np.int64), np.arange(10), None,
                           (700, 100_000))
    for n_hid, k_pad in ((128, 128), (64, 32)):
        m = HGNN(4, 2, n_hid=n_hid, device="cpu")
        assert isinstance(m._lower(small), DenseAdj)
        assert isinstance(m._lower(tall), DenseAdj)
        for g in (square, past_tall, past_wide):
            big = m._lower(g)
            assert isinstance(big, CooAdj) and big.shape == g.shape
        ell = HGNN(4, 2, n_hid=n_hid, adj_kind="ell", device="cpu")
        big = ell._lower(square)
        assert isinstance(big, EllAdj) and big.k_pad == k_pad


def test_auto_fit_past_the_area_runs_the_coo_product():
    """An "auto" fit over a G of more than 8,192 rows lowers G to
    ``CooAdj`` and runs every G-product as a COO product (its plain
    version on the CPU), never K1's: the hoist's chunks and the row sum
    once, then 3 an epoch (forward, dX, the validation forward) and the
    final evaluation."""
    import scipy.sparse as sp

    n, f, epochs = 8300, 40, 2
    rng = np.random.default_rng(3)
    # one hyperedge a vertex: the vertex and 5 others
    members = np.concatenate([np.arange(n)[:, None],
                              rng.integers(0, n, (n, 5))], axis=1)
    h = sp.csr_matrix((np.ones(members.size),
                       (members.ravel(), np.arange(n).repeat(6))), (n, n))
    g = hg.generate_G_from_H(h)
    x = rng.standard_normal((n, f)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    before = {c: counters[c] for c in ("spmm_coo", "spmm_ell")}
    m = HGNN(f, 3, n_hid=16, device="cpu")
    m.fit(x, g, labels, np.arange(500), idx_val=np.arange(500, 900),
          num_epochs=epochs)
    assert isinstance(m.g_adj, CooAdj) and m.g_adj.shape == (n, n)
    assert counters["spmm_ell"] == before["spmm_ell"]
    chunks = -(-f // 32)
    assert counters["spmm_coo"] - before["spmm_coo"] == \
        chunks + 1 + 3 * epochs + 1


def test_lr_schedule_is_multistep():
    """``lr_at`` (the resume position) equals MultiStepLR's rate at each
    epoch, lr * gamma ** #(milestones <= epoch), repeated milestones
    included."""
    m = HGNN(4, 2, lr=0.01, gamma=0.5, milestones=(3, 6, 6), device="cpu")
    w = torch.zeros(1, requires_grad=True)
    opt = torch.optim.Adam([w], lr=0.01)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, [3, 6, 6], 0.5)
    for epoch in range(10):
        want = 0.01 * 0.5 ** sum(epoch >= s for s in (3, 6, 6))
        assert m.lr_at(epoch) == pytest.approx(want, rel=1e-12)
        assert opt.param_groups[0]["lr"] == pytest.approx(want, rel=1e-12)
        opt.step()
        sched.step()


def test_hgnn_defaults_to_the_card():
    if torch.cuda.is_available():
        assert HGNN(4, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HGNN(4, 2)


def test_mat_loader_equals_gcn_tpu(tmp_path):
    """load_ft and load_features_and_hypergraph on a savemat fixture (the
    HGNN release's layout: X a cell array of MVCNN and GVCNN features,
    1-based Y, indices 1 = train): arrays equal gcn_tpu's."""
    import scipy.io as scio

    from gcn_tpu.data import hypergraph_mat as jx_mat

    from gcn_tpu_torch.data import hypergraph_mat as mat

    rng = np.random.default_rng(9)
    n = 40
    cell = np.empty((1, 2), dtype=object)
    cell[0, 0] = rng.random((n, 16))
    cell[0, 1] = rng.random((n, 8))
    path = str(tmp_path / "toy.mat")
    scio.savemat(path, {"X": cell, "Y": rng.integers(1, 5, (n, 1)),
                        "indices": (rng.random((n, 1)) < 0.8) * 1.0})
    for name in ("MVCNN", "GVCNN"):
        for ours, ref in zip(mat.load_ft(path, name),
                             jx_mat.load_ft(path, name)):
            np.testing.assert_array_equal(ours, ref)
    kw = dict(k_neigs=[3, 5], use_mvcnn_feature=True,
              use_mvcnn_feature_for_structure=True)
    ours = mat.load_features_and_hypergraph(path, **kw)
    ref = jx_mat.load_features_and_hypergraph(path, **kw)
    assert ours[0].shape == (n, 24) and ours[4].shape == (n, 4 * n)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="HGNN data release"):
        mat.load_ft(str(tmp_path / "absent.mat"))


def test_get_config_equals_gcn_tpu(tmp_path, monkeypatch):
    """configs/hgnn.yaml through get_config (the !join and !concat tags)
    gives gcn_tpu's config, key for key."""
    import os

    from gcn_tpu.utils.config import get_config as jx_get_config

    from gcn_tpu_torch.utils.config import CONFIG_DIR, get_config

    monkeypatch.chdir(tmp_path)
    cfg = get_config(os.path.join(CONFIG_DIR, "hgnn.yaml"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = jx_get_config(os.path.join(repo, "gcn_tpu", "configs",
                                     "hgnn.yaml"), make_dirs=False)
    assert cfg == ref
    assert cfg["result_sub_folder"] == os.path.join(
        ".", "results", "hgnn", "hypergraph_NTU2012")
    assert os.path.isdir(cfg["ckpt_folder"])


def test_synthetic_visual_features_equal_examples():
    import importlib.util
    import os

    from gcn_tpu_torch.data.synthetic import synthetic_visual_features

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "train_hgnn_example", os.path.join(repo, "examples",
                                           "train_hgnn.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for ours, ref in zip(synthetic_visual_features(n=90, f=32, seed=3),
                         example.synthetic_visual_features(n=90, f=32,
                                                           seed=3)):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("factored", [False, True])
def test_cli_on_cpu_prints_test_line(capsys, factored):
    argv = ["--synthetic", "--synthetic-n", "300", "--epochs", "40",
            "--device", "cpu"] + (["--factored"] if factored else [])
    acc = train_hgnn.main(argv)
    out = capsys.readouterr().out
    assert "[synthetic] n=300 f=2048 classes=40 hyperedges=300" in out
    assert "HGNN test accuracy: " in out and 0.0 <= acc <= 1.0
