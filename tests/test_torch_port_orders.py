"""The port's v6 GCN under the other reorder methods, its per-op profile,
its adjacency dump and the train_gcn flags, against gcn_tpu's.

Training parity as in tests/test_torch_port_model.py: dropout 0, gcn_tpu's
initial parameters carried over, per-step losses at rtol 1e-4 and final
log-probs at atol 1e-4 plus rtol 1e-5 (f32 sums in another order over 20
Adam steps). Host outputs (permutations, CSV files, profile row names,
history keys) are held equal.
"""

import importlib.util
import json
import logging
import os
import sys

import jax
import numpy as np
import pytest

from gcn_tpu.data import get_dataset as jx_get_dataset
from gcn_tpu.models import GCN as JxGCN
from gcn_tpu.models.gcn_core import init_gcn_params as jx_init

from gcn_tpu_torch import train_gcn
from gcn_tpu_torch.convert import params_from_numpy
from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.models import GCN
from torch_port_native import native_reorder  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_params(seed, nfeat, nhid, nclass):
    params = jx_init(jax.random.PRNGKey(seed), nfeat, nhid, nclass)
    return jax.tree_util.tree_map(np.asarray, params)


def _fit_pair(name, nhid, iters, fit_kw=None, **kw):
    """(port model, gcn_tpu model) fitted from the same parameters."""
    fit_kw = fit_kw or {}
    data = jx_get_dataset(name, seed=0)
    nfeat, nclass = data.num_features, data.num_classes
    ref = JxGCN(nfeat, nhid, nclass, **kw)
    ref.fit(data.features, data.adj, data.labels, data.idx_train,
            train_iters=iters, **fit_kw)
    ours = GCN(nfeat, nhid, nclass, device="cpu", **kw)
    ours.params = params_from_numpy(_jax_params(kw.get("seed", 0), nfeat,
                                                nhid, nclass), "cpu")
    pdata = get_dataset(name, seed=0)
    ours.fit(pdata.features, pdata.adj, pdata.labels, pdata.idx_train,
             train_iters=iters, initialize=False, **fit_kw)
    return ours, ref


# nhid 4 < 7 classes: layer 2 on (AX)W, the order of the synth-arxiv path
@pytest.mark.parametrize("method", ["dfs", "rcm", "gorder"])
def test_v6_after_reorder_matches_gcn_tpu(method):
    ours, ref = _fit_pair("synth-cora-hard", 4, 20, dropout=0.0,
                          variant="v6", reorder=method, seed=3)
    np.testing.assert_array_equal(ours.perm, ref.perm)
    got = [h["loss_train"] for h in ours.history]
    want = [h["loss_train"] for h in ref.history]
    assert len(got) == len(want) == 20
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(ours.output.numpy(), np.asarray(ref.output),
                               rtol=1e-5, atol=1e-4)


# (variant, nhid): v6 with layer 2 on (AX)W and on A(XW); v1 unhoisted
@pytest.mark.parametrize("variant,nhid", [("v6", 2), ("v6", 8),
                                          ("v1", 8), ("v3", 8)])
def test_profile_ops_rows_match_gcn_tpu(variant, nhid):
    ours, ref = _fit_pair("synth-tiny", nhid, 2, dropout=0.0,
                          variant=variant)
    t = ours.profile_ops(n_iters=3, warmup=1, verbose=False)
    want = ref.profile_ops(n_iters=1, warmup=0, verbose=False)
    assert t.names() == want.names()
    if variant == "v6":
        assert "l1_af" not in t.names()      # hoisted: no layer-1 SpMM
    for name in t.names():
        dev = t(name).d
        assert dev.count == 3, name
        assert all(np.isfinite(s) and s > 0 for s in dev.samples), name


def test_profile_ops_needs_a_fit():
    data = get_dataset("synth-tiny")
    with pytest.raises(RuntimeError, match="fit"):
        GCN(data.num_features, 8, data.num_classes, device="cpu"
            ).profile_ops()


def test_fit_dump_adj_csv_matches_gcn_tpu(tmp_path):
    kw = dict(name="tiny-adj", train_iters=1)
    data = jx_get_dataset("synth-tiny", seed=0)
    ref = JxGCN(data.num_features, 8, data.num_classes, variant="v6")
    ref.fit(data.features, data.adj, data.labels, data.idx_train,
            dump_adj_csv=str(tmp_path / "ref"), **kw)
    pdata = get_dataset("synth-tiny", seed=0)
    ours = GCN(pdata.num_features, 8, pdata.num_classes, variant="v6",
               device="cpu")
    ours.fit(pdata.features, pdata.adj, pdata.labels, pdata.idx_train,
             dump_adj_csv=str(tmp_path / "ours"), **kw)
    got = (tmp_path / "ours" / "tiny-adj.csv").read_bytes()
    assert got == (tmp_path / "ref" / "tiny-adj.csv").read_bytes()
    assert len(got.splitlines()) == 3


def _jax_cli(argv, monkeypatch):
    """examples/train_gcn.py's main() with ``argv``."""
    spec = importlib.util.spec_from_file_location(
        "jx_train_gcn", os.path.join(REPO, "examples", "train_gcn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["train_gcn.py"] + argv)
    return mod.main()


BASE = ["-g", "synth-tiny", "-k", "8", "-i", "5", "--variant", "v6"]


def test_cli_flags_match_gcn_tpu(tmp_path, monkeypatch, capsys):
    """--save-path then --load-path gives the fit's accuracy, also with
    params gcn_tpu saved; --history-json writes gcn_tpu's keys;
    --profile-ops prints the table; the run is logged."""
    monkeypatch.chdir(tmp_path)
    acc = train_gcn.main(BASE + [
        "--device", "cpu", "--reorder", "gorder", "--profile-ops",
        "--save-path", "ours.npz", "--history-json", "ours.json"])
    out = capsys.readouterr().out
    assert "saved params to ours.npz" in out and "l2_af" in out
    assert "bwd" in out.split("Test set results")[1]
    loaded = train_gcn.main(BASE + ["--device", "cpu", "--reorder",
                                    "gorder", "--load-path", "ours.npz"])
    assert loaded == pytest.approx(acc, abs=1e-6)
    assert "Loaded params: test accuracy=" in capsys.readouterr().out

    jx_acc = _jax_cli(BASE + ["--reorder", "gorder", "--save-path",
                              "ref.npz", "--history-json", "ref.json"],
                      monkeypatch)
    jx_loaded = _jax_cli(BASE + ["--reorder", "gorder", "--load-path",
                                 "ref.npz"], monkeypatch)
    assert jx_loaded == pytest.approx(jx_acc, abs=1e-6)
    from_jax = train_gcn.main(BASE + ["--device", "cpu", "--reorder",
                                      "gorder", "--load-path", "ref.npz"])
    assert from_jax == pytest.approx(jx_loaded, abs=1e-6)

    ours, ref = (json.load(open(f)) for f in ("ours.json", "ref.json"))
    assert sorted(ours) == sorted(ref)
    for key in ("graph", "variant", "hidden"):
        assert ours[key] == ref[key]
    assert len(ours["history"]) == len(ref["history"]) == 5
    assert [sorted(h) for h in ours["history"]] == [sorted(h) for h in
                                                    ref["history"]]
    assert ours["acc_test"] == pytest.approx(acc)
    logs = [h.baseFilename for h in
            logging.getLogger("gcn_tpu_torch").handlers
            if isinstance(h, logging.FileHandler)]
    assert any("graph=synth-tiny variant=v6" in open(f).read()
               for f in logs)


@pytest.mark.parametrize("method", ["degree_in", "rcm", "gorder3"])
def test_cli_takes_the_other_reorder_methods(method, capsys):
    acc = train_gcn.main(["-g", "synth-tiny", "-k", "8", "-i", "2",
                          "--variant", "v6", "--reorder", method,
                          "--span-limit", "0", "--device", "cpu"])
    assert 0.0 <= acc <= 1.0
    assert "Test set results" in capsys.readouterr().out


def test_cli_rejects_an_unknown_method():
    with pytest.raises(SystemExit):
        train_gcn.main(["-g", "synth-tiny", "--reorder", "nope",
                        "--device", "cpu"])
