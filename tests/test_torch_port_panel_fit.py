"""Functional GCN training over a PanelAdj in both packages, and the port
CLI's bf16 options.

The panel path: normalize, rabbit, degree sort, ``panel_adjacency``, layer 1
hoisted with ``hoist_spmm``, ``gcn_forward`` with orders ("xw",
``auto_order``), ``fit_gcn`` with ``adam_l2``. Dropout 0 and gcn_tpu's
initial parameters carried over (``params_from_numpy``), since the two
frameworks' random streams differ. Per-step losses agree at rtol 1e-4 and
the final log-probs at test_torch_port_model.py's tolerance (atol 1e-4 plus
rtol 1e-5): f32 sums in another order, compounded over the Adam steps.
"""

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.data import get_dataset as jx_get_dataset
from gcn_tpu.graph.normalize import gcn_normalize as jx_normalize
from gcn_tpu.models.gcn_core import gcn_forward as jx_gcn_forward
from gcn_tpu.models.gcn_core import init_gcn_params as jx_init
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
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.models.gcn_core import gcn_forward
from gcn_tpu_torch.models.layers import auto_order
from gcn_tpu_torch.ops import panel_spmm as ps
from gcn_tpu_torch.ops.spmm import hoist_spmm
from gcn_tpu_torch.reorder import reorder_graph
from gcn_tpu_torch.tile import degree_sort_order, panel_adjacency
from gcn_tpu_torch.train.loop import fit_gcn
from gcn_tpu_torch.train.optim import adam_l2
from torch_port_native import native_reorder  # noqa: F401 (autouse)


def _reordered(g, reorder, degree_sort):
    g, perm = reorder(g, "rabbit")
    ds = degree_sort(g)
    return g.permute(ds), perm[ds]


def test_panel_fit_matches_gcn_tpu():
    # nhid 4 < 6 classes puts layer 2 on (AX)W, the order of the
    # synth-arxiv main path: every step runs the panel SpMM and its dX
    steps, nhid = 5, 4
    jdata = jx_get_dataset("synth-small", seed=0)
    data = get_dataset("synth-small", seed=0)
    nfeat, nclass = data.num_features, data.num_classes
    orders = ("xw", auto_order(nhid, nclass))
    assert orders[1] == jx_auto_order(nhid, nclass) == "ax_w"

    jg, jperm = _reordered(jx_normalize(jdata.adj), jx_reorder,
                           jx_degree_sort)
    g, perm = _reordered(gcn_normalize(data.adj), reorder_graph,
                         degree_sort_order)
    np.testing.assert_array_equal(perm, jperm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    idx = inv[np.asarray(data.idx_train)]
    params = jax.tree_util.tree_map(
        np.asarray, jx_init(jax.random.PRNGKey(3), nfeat, nhid, nclass))

    jadj = jx_panel(jg)
    jfeats = jx_hoist(jadj, jax.numpy.asarray(jdata.features[perm]))

    def jforward(p, fd, train, rng):
        return jx_gcn_forward(p, fd[0], fd[1], orders=orders,
                              dropout_rate=0.0, train=train, rng=rng)

    ref = jx_fit(params, jx_adam(), jforward, jdata.labels[perm], idx,
                 forward_data=(jfeats, jadj), train_iters=steps)

    adj = panel_adjacency(g, device="cpu")
    feats = hoist_spmm(adj, torch.tensor(data.features[perm]))
    before = ps.spmm_panel_launches

    def forward(p, train):
        return gcn_forward(p, feats, adj, orders=orders, dropout_rate=0.0,
                           train=train)

    ours = fit_gcn(params_from_numpy(params, "cpu"), adam_l2, forward,
                   torch.tensor(data.labels[perm]), torch.tensor(idx),
                   train_iters=steps)
    assert ps.spmm_panel_launches == before  # the CPU runs the plain version

    got = [h["loss_train"] for h in ours.history]
    want = [float(h["loss_train"]) for h in ref.history]
    assert len(got) == len(want) == steps and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(ours.log_probs.numpy(),
                               np.asarray(ref.log_probs), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("flag", ["--table-bf16", "--products-bf16"])
def test_cli_bf16_options_on_cpu(flag, capsys, monkeypatch):
    """The flags reach the ELL adjacency as adj_options, as
    examples/train_gcn.py's do."""
    from gcn_tpu_torch.models import gcn

    seen = []
    real = gcn.device_adjacency

    def spy(g, kind, **kw):
        adj = real(g, kind, **kw)
        seen.append((adj.table_bf16, adj.products_bf16))
        return adj

    monkeypatch.setattr(gcn, "device_adjacency", spy)
    acc = train_gcn.main(["-g", "synth-tiny", "-k", "8", "-i", "3",
                          "--variant", "v6", "--device", "cpu", flag])
    assert "Test set results: loss= " in capsys.readouterr().out
    assert 0.0 <= acc <= 1.0
    assert seen == [(flag == "--table-bf16", flag == "--products-bf16")]
