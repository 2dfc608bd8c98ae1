"""Resumable training state: ``save_state`` / ``fit(resume_from=...)`` of
the port's GCN and HGNN, against the uninterrupted run and across the two
packages in both directions (gcn_tpu's checkpoint keys, optax's Adam and
schedule state mapped to torch.optim.Adam and MultiStepLR).

Tolerances: within the port a resume repeats the uninterrupted run's
arithmetic, so losses agree at rtol 1e-6 (dropout on, the generator's
state saved and restored). Across the packages (dropout 0, since the port
cannot continue a JAX key) they are the parity tolerances of
tests/test_torch_port_model.py: losses rtol 1e-4, outputs rtol 1e-5 plus
atol 1e-4 (HGNN logits rtol and atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gcn_tpu.data import get_dataset as jx_get_dataset
from gcn_tpu.graph.hypergraph import construct_H_with_KNN
from gcn_tpu.graph.hypergraph import generate_G_from_H as jx_generate_G
from gcn_tpu.models import GCN as JxGCN
from gcn_tpu.models.gcn_core import init_gcn_params as jx_init_gcn
from gcn_tpu.models.hgnn import HGNN as JxHGNN
from gcn_tpu.models.hgnn import init_hgnn_params as jx_init_hgnn

from gcn_tpu_torch import train_gcn
from gcn_tpu_torch.convert import params_from_numpy
from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.graph.hypergraph import generate_G_from_H
from gcn_tpu_torch.models import GCN, HGNN

ITERS = 6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _losses(model):
    return [h["loss_train"] for h in model.history]


def _gcn_data():
    return get_dataset("synth-tiny", seed=4)


def _gcn(weight_decay=5e-4, dropout=0.0, **kw):
    data = _gcn_data()
    return GCN(data.num_features, 8, data.num_classes, variant="v6",
               dropout=dropout, seed=7, weight_decay=weight_decay,
               device="cpu", **kw)


def _gcn_fit(model, iters, **kw):
    data = _gcn_data()
    return model.fit(data.features, data.adj, data.labels, data.idx_train,
                     train_iters=iters, **kw)


def _jx_gcn(weight_decay):
    data = jx_get_dataset("synth-tiny", seed=4)
    return JxGCN(data.num_features, 8, data.num_classes, variant="v6",
                 dropout=0.0, seed=7, weight_decay=weight_decay)


def _jx_gcn_fit(model, iters, **kw):
    data = jx_get_dataset("synth-tiny", seed=4)
    return model.fit(data.features, data.adj, data.labels, data.idx_train,
                     train_iters=iters, **kw)


def test_gcn_resume_matches_uninterrupted(tmp_path):
    """fit 6 + save_state + resume 6 == fit 12, with dropout 0.5: the
    Adam state and the dropout stream continue where they stopped."""
    ref = _gcn_fit(_gcn(dropout=0.5), 2 * ITERS)
    first = _gcn_fit(_gcn(dropout=0.5), ITERS)
    path = str(tmp_path / "state")
    first.save_state(path)
    second = _gcn_fit(_gcn(dropout=0.5), ITERS, resume_from=path)
    assert second._iters_done == 2 * ITERS
    assert [h["iter"] for h in second.history] == list(range(ITERS,
                                                             2 * ITERS))
    assert second.best_iter == ref.best_iter == 2 * ITERS - 1
    np.testing.assert_allclose(_losses(first) + _losses(second),
                               _losses(ref), rtol=1e-6)
    np.testing.assert_allclose(second.output.numpy(), ref.output.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weight_decay", [5e-4, 0.0])
def test_gcn_tpu_state_resumes_in_port(tmp_path, weight_decay):
    """gcn_tpu fit 6 + save_state, then the port resumes 6: the port's
    steps equal gcn_tpu's uninterrupted steps 6..11. The JAX dropout key
    cannot be continued, which the port says."""
    ref = _jx_gcn_fit(_jx_gcn(weight_decay), 2 * ITERS)
    first = _jx_gcn_fit(_jx_gcn(weight_decay), ITERS)
    path = str(tmp_path / "jax_state")
    first.save_state(path)
    ours = _gcn(weight_decay)
    with pytest.warns(UserWarning, match="JAX key"):
        _gcn_fit(ours, ITERS, resume_from=path)
    assert ours._iters_done == 2 * ITERS
    np.testing.assert_allclose(_losses(ours), _losses(ref)[ITERS:],
                               rtol=1e-4)
    np.testing.assert_allclose(ours.output.numpy(), np.asarray(ref.output),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("weight_decay", [5e-4, 0.0])
def test_port_state_resumes_in_gcn_tpu(tmp_path, weight_decay):
    """The port fits 6 from gcn_tpu's parameters and saves; gcn_tpu
    resumes 6 and matches its own uninterrupted 12."""
    ref = _jx_gcn_fit(_jx_gcn(weight_decay), 2 * ITERS)
    ours = _gcn(weight_decay)
    data = _gcn_data()
    ours.params = params_from_numpy(_np(jx_init_gcn(
        jax.random.PRNGKey(7), data.num_features, 8, data.num_classes)),
        "cpu")
    _gcn_fit(ours, ITERS, initialize=False)
    path = str(tmp_path / "port_state")
    ours.save_state(path)
    back = _jx_gcn(weight_decay)
    _jx_gcn_fit(back, ITERS, resume_from=path)
    assert back._iters_done == 2 * ITERS
    np.testing.assert_allclose(_losses(back), _losses(ref)[ITERS:],
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(back.output),
                               np.asarray(ref.output), rtol=1e-5, atol=1e-4)


def test_gcn_checkpoint_keys_equal_gcn_tpu(tmp_path):
    """Same keys, shapes and dtypes as gcn_tpu's training state, plus the
    port's own dropout stream."""
    ours = _gcn_fit(_gcn(dropout=0.5), 2)
    ours.save_state(str(tmp_path / "port"))
    ref = _jx_gcn_fit(_jx_gcn(5e-4), 2)
    ref.save_state(str(tmp_path / "jax"))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        own = {"__torch_rng__", "__torch_rng_device__"}
        assert set(a.files) - own == set(b.files) - {"__rng__"}
        for key in set(b.files) - {"__rng__"}:
            assert a[key].shape == b[key].shape, key
            assert a[key].dtype == b[key].dtype, key
        assert int(a["opt//1//.count"]) == 2 and str(
            a["__torch_rng_device__"]) == "cpu"


def test_generator_of_another_device_restarts_with_warning(tmp_path):
    """A dropout stream saved for another device type restarts from the
    seed (the two generators' states are not interchangeable)."""
    ours = _gcn_fit(_gcn(dropout=0.5), 2)
    path = str(tmp_path / "state")
    ours.save_state(path)
    with np.load(path + ".npz") as f:
        stored = dict(f)
    stored["__torch_rng_device__"] = np.asarray("cuda")
    np.savez(path + ".npz", **stored)
    with pytest.warns(UserWarning, match="a cuda generator's state"):
        _gcn_fit(_gcn(dropout=0.5), 1, resume_from=path)


def test_resume_with_other_weight_decay_raises(tmp_path):
    ours = _gcn_fit(_gcn(weight_decay=0.0), 2)
    ours.save_state(str(tmp_path / "state"))
    with pytest.raises(KeyError, match="adam stage"):
        _gcn_fit(_gcn(), 1, resume_from=str(tmp_path / "state"))


def test_cli_save_and_resume_state(tmp_path, capsys):
    path = str(tmp_path / "cli_state")
    argv = ["-g", "synth-tiny", "-k", "8", "-i", "3", "--variant", "v6",
            "--device", "cpu"]
    train_gcn.main(argv + ["--save-state", path])
    out = capsys.readouterr().out
    assert f"training state saved to {path}" in out
    acc = train_gcn.main(argv + ["--resume-state", path])
    out = capsys.readouterr().out
    assert "(6 total iters)" in out and 0.0 <= acc <= 1.0


# ---- HGNN ------------------------------------------------------------------

def _hgnn_data():
    rng = np.random.default_rng(11)
    labels = rng.integers(0, 4, 120).astype(np.int64)
    x = (rng.standard_normal((4, 16)).astype(np.float32)[labels] * 2
         + rng.standard_normal((120, 16)).astype(np.float32))
    return x, labels, construct_H_with_KNN(x, 6)


HGNN_KW = dict(in_ch=16, n_class=4, n_hid=16, lr=0.01, seed=0,
               milestones=(4,), gamma=0.5, adj_kind="ell")


def _hgnn_fit(model, epochs, **kw):
    x, labels, h = _hgnn_data()
    g = (generate_G_from_H(h) if isinstance(model, HGNN)
         else jx_generate_G(h))
    return model.fit(x, g, labels, np.arange(90), num_epochs=epochs, **kw)


def test_hgnn_resume_matches_uninterrupted(tmp_path):
    """5 + save_state + 5 == 10 epochs across the milestone at 4, dropout
    0.5: Adam state, schedule position and dropout stream continue."""
    ref = _hgnn_fit(HGNN(device="cpu", dropout=0.5, **HGNN_KW), 10)
    first = _hgnn_fit(HGNN(device="cpu", dropout=0.5, **HGNN_KW), 5)
    path = str(tmp_path / "hgnn_state")
    first.save_state(path)
    second = _hgnn_fit(HGNN(device="cpu", dropout=0.5, **HGNN_KW), 5,
                       resume_from=path)
    assert second._epochs_done == 10
    assert [h["epoch"] for h in second.history] == list(range(5, 10))
    np.testing.assert_allclose(_losses(first) + _losses(second),
                               _losses(ref), rtol=1e-6)
    np.testing.assert_allclose(second.output.numpy(), ref.output.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_hgnn_states_interchange_with_gcn_tpu(tmp_path):
    """gcn_tpu 5 epochs + save -> the port resumes 5; the port 5 epochs
    (from gcn_tpu's parameters) + save -> gcn_tpu resumes 5. Both match
    gcn_tpu's uninterrupted 10 across the milestone (dropout 0)."""
    ref = _hgnn_fit(JxHGNN(dropout=0.0, **HGNN_KW), 10)

    jx_first = _hgnn_fit(JxHGNN(dropout=0.0, **HGNN_KW), 5)
    jx_first.save_state(str(tmp_path / "jax"))
    ours = HGNN(device="cpu", dropout=0.0, **HGNN_KW)
    with pytest.warns(UserWarning, match="JAX key"):
        _hgnn_fit(ours, 5, resume_from=str(tmp_path / "jax"))
    np.testing.assert_allclose(ours.output.numpy(), np.asarray(ref.output),
                               rtol=1e-4, atol=1e-4)

    first = HGNN(device="cpu", dropout=0.0, **HGNN_KW)
    first.params = params_from_numpy(_np(jx_init_hgnn(
        jax.random.PRNGKey(0), 16, 16, 4)), "cpu")
    _hgnn_fit(first, 5)
    first.save_state(str(tmp_path / "port"))
    back = JxHGNN(dropout=0.0, **HGNN_KW)
    _hgnn_fit(back, 5, resume_from=str(tmp_path / "port"))
    assert back._epochs_done == 10
    np.testing.assert_allclose(np.asarray(back.output),
                               np.asarray(ref.output), rtol=1e-4, atol=1e-4)
    with np.load(tmp_path / "port.npz") as f:
        assert int(f["opt//2//.count"]) == 5 and int(f["opt//1//.count"]) == 5
    np.testing.assert_allclose(
        np.asarray(jnp.asarray(ours.output)), np.asarray(back.output),
        rtol=1e-4, atol=1e-4)
