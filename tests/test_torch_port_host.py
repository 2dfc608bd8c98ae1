"""The port's host-side modules against gcn_tpu's, on the CPU: reorder
statistics and order files, row permutation, row normalization, micro-F1,
the geometric generator, sparse class features, split masks, the planetoid
and GraphSAINT loaders and the registry's real names, the CSV dumps, the
row analysis, the artifact checks, logging and the device trace.

Host numpy code is held bit-equal (arrays with ``assert_array_equal``,
files byte for byte); the loaders read fixture files written as
tests/test_data_loaders.py writes them.
"""

import json
import logging
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gcn_tpu.data import get_dataset as jx_get_dataset
from gcn_tpu.data import graphsaint as jx_graphsaint
from gcn_tpu.data import planetoid as jx_planetoid
from gcn_tpu.data import synthetic as jx_synthetic
from gcn_tpu.graph import normalize as jx_normalize
from gcn_tpu.ops import permute as jx_permute
from gcn_tpu.reorder import load_order as jx_load_order
from gcn_tpu.reorder import python_impl as jx_python_impl
from gcn_tpu.reorder import reorder_stats as jx_reorder_stats
from gcn_tpu.reorder import save_order as jx_save_order
from gcn_tpu.train.metrics import micro_f1 as jx_micro_f1
from gcn_tpu.analysis import rows as jx_rows
from gcn_tpu.utils import artifacts as jx_artifacts
from gcn_tpu.utils import writecsv as jx_writecsv

from gcn_tpu_torch.analysis import rows
from gcn_tpu_torch.data import get_dataset, graphsaint, planetoid, synthetic
from gcn_tpu_torch.graph import normalize
from gcn_tpu_torch.graph.csr import CSRGraph, coo_to_csr
from gcn_tpu_torch.ops import permute
from gcn_tpu_torch.reorder import (load_order, python_impl, reorder_stats,
                                   save_order)
from gcn_tpu_torch.train.metrics import micro_f1
from gcn_tpu_torch.utils import artifacts, writecsv
from gcn_tpu_torch.utils.profiling import device_trace, setup_logging
from torch_port_native import native_reorder  # noqa: F401 (autouse)

GRAPHS = ("synth-tiny", "synth-cora-hard")


def _pair(name):
    """(port graph, jax graph) of a dataset's adjacency."""
    return (get_dataset(name, seed=0).adj,
            jx_get_dataset(name, seed=0).adj)


def _csr_equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def _data_equal(ours, ref):
    """GraphData field by field."""
    assert ours.name == ref.name
    _csr_equal(ours.adj, ref.adj)
    for f in ("features", "labels", "idx_train", "idx_val", "idx_test"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------- reorder


@pytest.mark.parametrize("name", GRAPHS)
def test_reorder_stats_and_modularity_equal(name):
    g, jg = _pair(name)
    g, jg = normalize.gcn_normalize(g), jx_normalize.gcn_normalize(jg)
    assert reorder_stats(g) == jx_reorder_stats(jg)
    order, comm = python_impl.rabbit_order(g, return_communities=True)
    jorder, jcomm = jx_python_impl.rabbit_order(jg, return_communities=True)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(comm, jcomm)
    assert python_impl.modularity(g, comm) == jx_python_impl.modularity(
        jg, jcomm)
    np.testing.assert_array_equal(python_impl.bfs_order(g, start=7),
                                  jx_python_impl.bfs_order(jg, start=7))


def test_order_files_equal_and_round_trip(tmp_path):
    g, _ = _pair("synth-cora-hard")
    perm = python_impl.gorder_order(g)
    save_order(str(tmp_path / "ours.txt"), perm)
    jx_save_order(str(tmp_path / "ref.txt"), perm)
    assert ((tmp_path / "ours.txt").read_bytes()
            == (tmp_path / "ref.txt").read_bytes())
    back = load_order(str(tmp_path / "ref.txt"), g.shape[0])
    assert back.dtype == np.int32
    np.testing.assert_array_equal(back, perm)
    np.testing.assert_array_equal(
        back, jx_load_order(str(tmp_path / "ours.txt"), g.shape[0]))
    with pytest.raises(ValueError, match="perm shape"):
        load_order(str(tmp_path / "ours.txt"), g.shape[0] + 1)


# ---------------------------------------------------- permute and metrics


def test_permute_rows_equal_and_differentiable(rng):
    n = 50
    x = rng.standard_normal((n, 7)).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    xt = torch.tensor(x, requires_grad=True)
    y = permute.permute_rows(xt, perm)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jx_permute.permute_rows(
            jnp.asarray(x), perm)))
    inv = permute.inverse_permutation(perm)
    np.testing.assert_array_equal(inv, jx_permute.inverse_permutation(perm))
    np.testing.assert_array_equal(
        permute.permute_rows(y, inv).detach().numpy(), x)
    ct = torch.tensor(rng.standard_normal((n, 7)), dtype=torch.float32)
    (y * ct).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), ct.numpy()[inv])
    idx = rng.integers(0, n, 12)
    got = permute.remap_indices(idx, perm)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jx_permute.remap_indices(idx, perm)))


def _graph_with_empty_row(seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(1, 60, 300), rng.integers(1, 60, 300)
    return coo_to_csr(src, dst, rng.random(300).astype(np.float32), (60, 60))


@pytest.mark.parametrize("loops", [None, True, False])
def test_row_normalize_equal(loops):
    from gcn_tpu.graph.csr import CSRGraph as JxCSR

    for g, _ in (_pair("synth-tiny"), (_graph_with_empty_row(3), None)):
        jg = JxCSR(g.indptr, g.indices, g.data, g.shape)
        _csr_equal(normalize.row_normalize(g, add_self_loops=loops),
                   jx_normalize.row_normalize(jg, add_self_loops=loops))


def test_row_normalize_features_equal(rng):
    x = rng.random((40, 9)).astype(np.float32)
    x[3] = 0.0
    got = normalize.row_normalize_features(x)
    assert got.dtype == np.float32 and (got[3] == 0).all()
    np.testing.assert_array_equal(got,
                                  jx_normalize.row_normalize_features(x))


def test_micro_f1_equal(rng):
    pred, labels = rng.integers(0, 5, 300), rng.integers(0, 5, 300)
    got = micro_f1(torch.tensor(pred), torch.tensor(labels))
    assert got.item() == float(jx_micro_f1(jnp.asarray(pred),
                                           jnp.asarray(labels)))


# ------------------------------------------------------------- generators


@pytest.mark.parametrize("kw", [dict(n=3000, seed=0),
                                dict(n=2000, n_classes=6, avg_degree=9.0,
                                     seed=5, shuffle=False)])
def test_geometric_equal(kw):
    g, labels = synthetic.geometric(**kw)
    jg, jlabels = jx_synthetic.geometric(**kw)
    _csr_equal(g, jg)
    np.testing.assert_array_equal(labels, jlabels)


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.9])
def test_class_features_sparsity_equal(sparsity):
    labels = np.random.default_rng(4).integers(0, 6, 500)
    got = synthetic.class_features(labels, feat_dim=24, seed=2,
                                   sparsity=sparsity)
    np.testing.assert_array_equal(got, jx_synthetic.class_features(
        labels, feat_dim=24, seed=2, sparsity=sparsity))
    assert abs((got == 0).mean() - sparsity) < 0.05


@pytest.mark.parametrize("name", GRAPHS)
def test_masks_equal(name):
    ours = get_dataset(name, seed=1).masks()
    ref = jx_get_dataset(name, seed=1).masks()
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- loaders


def _random_sym_adj(rng, n, m):
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    a = sp.coo_matrix((np.ones(keep.sum(), np.float32),
                       (src[keep], dst[keep])), shape=(n, n)).tocsr()
    a = a + a.T
    a.data[:] = 1.0
    return a


def _write_npz(root, rng, name="cora", n=80, f=12, c=4):
    adj = _random_sym_adj(rng, n, 300)
    feats = sp.csr_matrix((rng.random((n, f)) > 0.5).astype(np.float32))
    labels = rng.integers(0, c, n).astype(np.int64)
    np.savez(root / f"{name}.npz",
             adj_data=adj.data, adj_indices=adj.indices,
             adj_indptr=adj.indptr, adj_shape=np.array(adj.shape),
             attr_data=feats.data, attr_indices=feats.indices,
             attr_indptr=feats.indptr, attr_shape=np.array(feats.shape),
             labels=labels)


def _write_pubmed(root, rng):
    n_train, n_test, n_rest, f, c = 20, 10, 30, 8, 3
    n = n_train + n_rest + n_test
    objs = {
        "x": sp.csr_matrix(rng.random((n_train, f)).astype(np.float32)),
        "y": np.eye(c)[rng.integers(0, c, n_train)],
        "tx": sp.csr_matrix(rng.random((n_test, f)).astype(np.float32)),
        "ty": np.eye(c)[rng.integers(0, c, n_test)],
        "allx": sp.csr_matrix(rng.random((n_train + n_rest, f))
                              .astype(np.float32)),
        "ally": np.eye(c)[rng.integers(0, c, n_train + n_rest)],
        "graph": {i: [int(j) for j in rng.integers(0, n, 3)]
                  for i in range(n)},
    }
    for part, obj in objs.items():
        with open(root / f"ind.pubmed.{part}", "wb") as fh:
            pickle.dump(obj, fh)
    test_idx = rng.permutation(np.arange(n_train + n_rest, n))
    with open(root / "ind.pubmed.test.index", "w") as fh:
        fh.write("\n".join(str(i) for i in test_idx))


def _write_graphsaint(root, rng, name="flickr", n=60, f=10, c=5):
    d = root / name
    os.makedirs(d)
    adj = _random_sym_adj(rng, n, 200)
    sp.save_npz(d / "adj_full.npz", adj)
    tr_mask = np.isin(np.arange(n), np.arange(0, 30))
    sp.save_npz(d / "adj_train.npz", sp.csr_matrix(
        adj.multiply(tr_mask[:, None]).multiply(tr_mask[None, :])))
    np.save(d / "feats.npy", rng.random((n, f)).astype(np.float64))
    # half the nodes in the multi-label form, for the argmax squash
    cm = {str(i): (rng.integers(0, c).item() if i % 2 else
                   [int(v) for v in np.eye(c, dtype=int)[rng.integers(0, c)]])
          for i in range(n)}
    with open(d / "class_map.json", "w") as fh:
        json.dump(cm, fh)
    with open(d / "role.json", "w") as fh:
        json.dump({"tr": list(range(30)), "va": list(range(30, 45)),
                   "te": list(range(45, 60))}, fh)


@pytest.mark.parametrize("setting", ["gcn", "nettack"])
def test_planetoid_npz_equal(tmp_path, rng, setting):
    _write_npz(tmp_path, rng)
    ours = planetoid.load("cora", str(tmp_path), setting=setting, seed=3)
    ref = jx_planetoid.load("cora", str(tmp_path), setting=setting, seed=3)
    _data_equal(ours, ref)
    assert ours.adj.is_symmetric()


def test_planetoid_pubmed_pickles_equal(tmp_path, rng):
    _write_pubmed(tmp_path, rng)
    _data_equal(planetoid.load("pubmed", str(tmp_path), setting="gcn"),
                jx_planetoid.load("pubmed", str(tmp_path), setting="gcn"))


@pytest.mark.parametrize("normalize_feats", [True, False])
def test_graphsaint_equal(tmp_path, rng, normalize_feats):
    _write_graphsaint(tmp_path, rng)
    ours = graphsaint.load("flickr", str(tmp_path), normalize=normalize_feats)
    ref = jx_graphsaint.load("flickr", str(tmp_path),
                             normalize=normalize_feats)
    _data_equal(ours, ref)
    np.testing.assert_array_equal(
        graphsaint.standard_scale(ref.features, np.arange(10)),
        jx_graphsaint.standard_scale(ref.features, np.arange(10)))


@pytest.mark.parametrize("load,jx_load,name", [
    (planetoid.load, jx_planetoid.load, "citeseer"),
    (planetoid.load, jx_planetoid.load, "pubmed"),
    (graphsaint.load, jx_graphsaint.load, "reddit"),
])
def test_missing_files_raise_as_gcn_tpu(tmp_path, load, jx_load, name):
    with pytest.raises(FileNotFoundError) as ours:
        load(name, str(tmp_path))
    with pytest.raises(FileNotFoundError) as ref:
        jx_load(name, str(tmp_path))
    path = str(ref.value).split("'")[1]
    assert path.startswith(str(tmp_path))
    assert repr(path) in str(ours.value)
    assert str(ref.value).split("fetch it from ")[1].split(" and ")[0] in \
        str(ours.value)


def test_registry_routes_real_names(tmp_path, rng, monkeypatch):
    _write_npz(tmp_path, rng, name="citeseer")
    _write_graphsaint(tmp_path, rng, name="ppi")
    for name in ("citeseer", "ppi"):
        _data_equal(get_dataset(name, root=str(tmp_path)),
                    jx_get_dataset(name, root=str(tmp_path)))
    monkeypatch.setenv("GCN_TPU_DATA", str(tmp_path))
    _data_equal(get_dataset("citeseer"), jx_get_dataset("citeseer"))
    empty = tmp_path / "empty"
    empty.mkdir()
    for name in ("cora", "pubmed", "yelp"):
        with pytest.raises(FileNotFoundError):
            get_dataset(name, root=str(empty))
    with pytest.raises(KeyError):
        get_dataset("not-a-dataset")
    # the synthetic names keep their positional seed behind root
    _data_equal(get_dataset("synth-tiny", None, 4),
                jx_get_dataset("synth-tiny", None, 4))


def test_masks_of_a_loaded_dataset_equal(tmp_path, rng):
    _write_npz(tmp_path, rng)
    ours = planetoid.load("cora", str(tmp_path), setting="gcn").masks()
    ref = jx_planetoid.load("cora", str(tmp_path), setting="gcn").masks()
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- csv, rows, artifacts


@pytest.mark.parametrize("append", [False, True])
def test_writecsv_bytes_equal(tmp_path, append):
    g, jg = _pair("synth-cora-hard")
    g, jg = normalize.gcn_normalize(g), jx_normalize.gcn_normalize(jg)
    ours = writecsv.write(g, "m", str(tmp_path / "ours"), append=append)
    ref = jx_writecsv.write(jg, "m", str(tmp_path / "ref"), append=append)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    back, jback = writecsv.read(ref), jx_writecsv.read(ours)
    _csr_equal(back, jback)
    _csr_equal(back, g)
    scipy_in = writecsv.write(g.to_scipy(), "s", str(tmp_path / "ours"))
    assert open(scipy_in, "rb").read() == open(ref, "rb").read()


def test_row_analysis_equal(tmp_path):
    g, jg = _pair("synth-cora-hard")
    np.testing.assert_array_equal(rows.nnz_per_row(g),
                                  jx_rows.nnz_per_row(jg))
    for a, b in zip(rows.row_cdf(g), jx_rows.row_cdf(jg)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rows.row_cdf(g.to_scipy())[1],
                                  jx_rows.row_cdf(jg)[1])
    with pytest.raises(TypeError):
        rows.nnz_per_row(np.zeros(3))
    out = rows.plot_row_cdfs({"g": g, "t": get_dataset("synth-tiny").adj},
                             str(tmp_path / "row.svg"))
    assert os.path.getsize(out) > 0


ARTIFACTS = [
    {"a_ms": 1.0, "eff": 0.5, "x_pct": 50.0, "nested": {"eff": {"0.5": 0.9}}},
    {"a_ms": -1.0, "b_s": -2, "n_rows": 3},
    {"eff_hier": 1.2, "effective_gbps": 900.0, "hit_fraction": -0.1},
    {"roofline_pct": 101.0, "delta_ms": -3.0, "v": float("nan")},
    {"list": [{"t_ms": -1}, {"frac": 2.0}], "flag": True, "name": "x"},
]


@pytest.mark.parametrize("i", range(len(ARTIFACTS)))
def test_artifact_checks_equal(tmp_path, i):
    obj = ARTIFACTS[i]
    for allow in ((), ("delta_ms",)):
        got = artifacts.validate_artifact(obj, allow=allow)
        want = jx_artifacts.validate_artifact(obj, allow=allow)
        assert repr(got) == repr(want)
    kw = dict(harness="h.py", schema="s/1", allow=("delta_ms",),
              extra_meta={"card": "c"})
    if jx_artifacts.validate_artifact(obj, allow=kw["allow"]):
        with pytest.raises(artifacts.ArtifactError):
            artifacts.write_artifact(str(tmp_path / "o.json"), obj, **kw)
        assert issubclass(artifacts.ArtifactError, ValueError)
        return
    ours = artifacts.write_artifact(str(tmp_path / "o" / "a.json"), obj, **kw)
    ref = jx_artifacts.write_artifact(str(tmp_path / "r" / "a.json"), obj,
                                      **kw)
    assert ours == ref
    assert ((tmp_path / "o" / "a.json").read_bytes()
            == (tmp_path / "r" / "a.json").read_bytes())


# ---------------------------------------------------- logging and traces


@pytest.fixture
def fresh_logger():
    """The port's logger without handlers (another test of this process
    may have set it up on another file), restored afterwards."""
    logger = logging.getLogger("gcn_tpu_torch")
    saved = logger.handlers[:]
    logger.handlers.clear()
    yield logger
    for h in logger.handlers:
        h.close()
    logger.handlers[:] = saved


def test_setup_logging(tmp_path, fresh_logger):
    log = setup_logging(str(tmp_path / "t.log"))
    assert log is fresh_logger and log.name == "gcn_tpu_torch"
    log.info("hello")
    log.debug("not at INFO")
    for h in log.handlers:
        h.flush()
    text = open(tmp_path / "t.log").read()
    assert "INFO hello" in text and "not at INFO" not in text
    again = setup_logging(str(tmp_path / "other.log"))
    assert again is log and len(log.handlers) == 2
    assert not (tmp_path / "other.log").exists()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as d:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    path = os.path.join(d, "trace.json")
    events = json.load(open(path))["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
