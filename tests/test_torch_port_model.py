"""The port's v6 GCN training against gcn_tpu's, its checkpoints, its CLI
and its device default.

Training parity: dropout 0 and gcn_tpu's initial parameters carried over
(``params_from_numpy``), since the two frameworks' random streams differ.
Per-iteration losses agree at rtol 1e-4 and the final log-probs at atol
1e-4 plus rtol 1e-5: f32 sums in another order, compounded over 20 Adam
steps, and log-probs reach |lp| ~ 30 where the relative term dominates.
"""

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.data import get_dataset as jx_get_dataset
from gcn_tpu.models import GCN as JxGCN
from gcn_tpu.models.gcn_core import init_gcn_params as jx_init
from gcn_tpu.utils.checkpoint import load_params as jx_load_params
from gcn_tpu.utils.checkpoint import save_params as jx_save_params

from gcn_tpu_torch import train_gcn
from gcn_tpu_torch.convert import params_from_numpy, params_to_numpy
from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.models import GCN
from gcn_tpu_torch.models.gcn_core import gcn_forward
from gcn_tpu_torch.ops.adjacency import device_adjacency
from gcn_tpu_torch.graph.normalize import gcn_normalize


def _jax_params(seed, nfeat, nhid, nclass):
    params = jx_init(jax.random.PRNGKey(seed), nfeat, nhid, nclass)
    return jax.tree_util.tree_map(np.asarray, params)


# nhid 4 < 7 classes puts layer 2 on (AX)W, the order of the synth-arxiv
# main path; nhid 16 puts it on A(XW)
@pytest.mark.parametrize("nhid", [4, 16])
def test_v6_fit_matches_gcn_tpu(nhid):
    data = jx_get_dataset("synth-cora-hard", seed=0)
    nfeat, nclass = data.num_features, data.num_classes
    kw = dict(dropout=0.0, variant="v6", seed=3)
    ref = JxGCN(nfeat, nhid, nclass, **kw)
    ref.fit(data.features, data.adj, data.labels, data.idx_train,
            train_iters=20)

    ours = GCN(nfeat, nhid, nclass, device="cpu", **kw)
    assert ours._orders() == ref._orders()
    ours.params = params_from_numpy(_jax_params(3, nfeat, nhid, nclass),
                                    "cpu")
    pdata = get_dataset("synth-cora-hard", seed=0)
    ours.fit(pdata.features, pdata.adj, pdata.labels, pdata.idx_train,
             train_iters=20, initialize=False)

    np.testing.assert_array_equal(ours.perm, ref.perm)
    got = [h["loss_train"] for h in ours.history]
    want = [h["loss_train"] for h in ref.history]
    assert len(got) == len(want) == 20
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(ours.output.numpy(), np.asarray(ref.output),
                               rtol=1e-5, atol=1e-4)
    assert ours.best_iter == ref.best_iter
    acc = ours.test(pdata.idx_test, verbose=False)
    assert acc == pytest.approx(ref.test(data.idx_test, verbose=False),
                                abs=2e-3)


# val: best-val snapshot (loss, then accuracy); early_stop: patience 3 at a
# learning rate where the val loss turns up and the run stops at step 33
@pytest.mark.parametrize("mode,lr,iters", [("val", 0.01, 15),
                                           ("early_stop", 0.05, 80)])
def test_val_modes_match_gcn_tpu(mode, lr, iters):
    """The loop's val modes on v4 (no reordering) against gcn_tpu's."""
    data = jx_get_dataset("synth-tiny", seed=1)
    kw = dict(dropout=0.0, variant="v4", seed=5, lr=lr)
    fit_kw = dict(train_iters=iters, mode=mode, patience=3)
    ref = JxGCN(data.num_features, 8, data.num_classes, **kw)
    ref.fit(data.features, data.adj, data.labels, data.idx_train,
            idx_val=data.idx_val, **fit_kw)
    ours = GCN(data.num_features, 8, data.num_classes, device="cpu", **kw)
    ours.params = params_from_numpy(
        _jax_params(5, data.num_features, 8, data.num_classes), "cpu")
    pdata = get_dataset("synth-tiny", seed=1)
    ours.fit(pdata.features, pdata.adj, pdata.labels, pdata.idx_train,
             idx_val=pdata.idx_val, initialize=False, **fit_kw)
    assert len(ours.history) == len(ref.history)
    if mode == "early_stop":
        assert len(ours.history) < iters
    for key in ("loss_train", "loss_val"):
        np.testing.assert_allclose([h[key] for h in ours.history],
                                   [h[key] for h in ref.history], rtol=1e-4)
    assert ours.best_iter == ref.best_iter
    np.testing.assert_allclose(ours.output.numpy(), np.asarray(ref.output),
                               rtol=1e-5, atol=1e-4)


def test_checkpoints_interchange(tmp_path):
    """A gcn_tpu checkpoint loads into the port and gives the same forward;
    a port checkpoint loads into gcn_tpu."""
    data = get_dataset("synth-tiny", seed=0)
    jparams = _jax_params(7, data.num_features, 8, data.num_classes)
    jx_save_params(str(tmp_path / "jax.npz"), jparams)
    model = GCN(data.num_features, 8, data.num_classes, device="cpu")
    model.load(str(tmp_path / "jax.npz"))
    adj = device_adjacency(gcn_normalize(data.adj), "dense", device="cpu")
    x = torch.tensor(data.features)
    got = gcn_forward(model.params, x, adj, train=False)
    want = gcn_forward(params_from_numpy(jparams, "cpu"), x, adj,
                       train=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    model.save(str(tmp_path / "port"))
    back = jx_load_params(str(tmp_path / "port"), jparams)
    for layer in ("gc1", "gc2"):
        for key in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(back[layer][key]),
                                          jparams[layer][key])
    assert params_to_numpy(model.params)["gc2"]["w"].dtype == np.float32


def test_predict_on_fresh_graph_matches_fit_output():
    data = get_dataset("synth-tiny", seed=2)
    model = GCN(data.num_features, 8, data.num_classes, variant="v6",
                dropout=0.0, device="cpu")
    model.fit(data.features, data.adj, data.labels, data.idx_train,
              train_iters=5)
    torch.testing.assert_close(model.predict(data.features, data.adj),
                               model.output, rtol=1e-5, atol=1e-5)


def test_no_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GCN(16, 8, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gcn.main(["-g", "synth-tiny", "-i", "1"])


def test_cli_on_cpu_prints_test_line(capsys):
    acc = train_gcn.main(["-g", "synth-tiny", "-k", "8", "-i", "5",
                          "--variant", "v6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[synth-tiny] n=200" in out
    assert "Test set results: loss= " in out and 0.0 <= acc <= 1.0
