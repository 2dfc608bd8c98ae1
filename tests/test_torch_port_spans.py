"""The fit's spans and the call counters of ``gcn_tpu_torch/utils/timers.py``
on the CPU, and a captured fit's spans on the card (marked ``cuda``).

Under ``recording()`` a fit gives one span tree, whatever its model and
flavor: ``fit``, its children ``fit.prepare``, ``fit.loop`` and
``fit.finish`` in that order and covering it, and inside ``fit.loop``
``loop.warmup`` and ``loop.replay`` (``loop.capture`` exists on the card
only, in the captured flavor). An HGNN fit opens ``hgnn.prepare`` before
its ``fit``, as a root span of its own. Under ``torch.profiler`` every span
is a host event of its name. The COO product counts each of its products in
``counters["spmm_coo"]``, so a hoisted two-layer fit with validation makes
three calls an iteration, in its warm-up as in the rest. A GAT fit opens
``gat.layout`` before its ``fit``, as a root span of its own, and counts
nine attention calls an iteration in ``counters["gat_attn"]``: three
training forwards, three backwards and three evaluation forwards.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gcn_tpu_torch.data import get_dataset
from gcn_tpu_torch.graph import hypergraph as hg
from gcn_tpu_torch.graph.normalize import gcn_normalize
from gcn_tpu_torch.models.gat import GAT
from gcn_tpu_torch.models.gcn_core import gcn_forward, init_gcn_params
from gcn_tpu_torch.models.hgnn import HGNN
from gcn_tpu_torch.ops.adjacency import device_adjacency
from gcn_tpu_torch.ops.spmm import hoist_spmm, spmm
from gcn_tpu_torch.train.capture import WARMUP
from gcn_tpu_torch.train.loop import fit_gcn
from gcn_tpu_torch.train.optim import adam_l2
from gcn_tpu_torch.utils import timers
from gcn_tpu_torch.utils.timers import counters, recording, span

ITERS = 6
FLAVORS = ("gcn_captured", "gcn_eager", "hgnn")


def _gcn(jit_loop, kind="coo", device="cpu"):
    data = get_dataset("synth-tiny", seed=1)
    adj = device_adjacency(gcn_normalize(data.adj), kind, device=device)
    feats = hoist_spmm(adj, torch.as_tensor(data.features,
                                            dtype=torch.float32,
                                            device=device))
    p0 = init_gcn_params(torch.Generator().manual_seed(0),
                         data.num_features, 8, data.num_classes,
                         device=device)
    gen = torch.Generator(device=device).manual_seed(3)

    def forward(p, train):
        return gcn_forward(p, feats, adj, orders=("xw", "a_xw"),
                           dropout_rate=0.5, train=train, generator=gen)

    def tensor(a):
        return torch.as_tensor(a, device=device)

    def run():
        fit_gcn(p0, adam_l2, forward, tensor(data.labels),
                tensor(data.idx_train), tensor(data.idx_val),
                train_iters=ITERS, mode="val", generator=gen,
                jit_loop=jit_loop)
    return run


def _hgnn():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((80, 24)).astype(np.float32)
    labels = rng.integers(0, 4, 80)
    g = hg.generate_G_from_H(hg.construct_H_with_KNN(x, 5))

    def run():
        HGNN(24, 4, n_hid=16, adj_kind="coo", device="cpu").fit(
            x, g, labels, np.arange(50), idx_val=np.arange(50, 80),
            num_epochs=ITERS)
    return run


def _fit(flavor):
    if flavor == "hgnn":
        return _hgnn()
    return _gcn(jit_loop=flavor == "gcn_captured")


def _tree(spans):
    """{name: span} of one fit, checking that no name repeats."""
    by_name = {s.name: s for s in spans}
    assert len(by_name) == len(spans), [s.name for s in spans]
    return by_name


@pytest.mark.parametrize("flavor", FLAVORS)
def test_fit_records_the_span_tree(flavor):
    run = _fit(flavor)
    with recording() as spans:
        run()
    tree = _tree(spans)
    loop_children = ["loop.warmup", "loop.replay"]
    roots = ["hgnn.prepare"] if flavor == "hgnn" else []
    assert set(tree) == {*roots, "fit", "fit.prepare", "fit.loop",
                         "fit.finish", *loop_children}
    fit = tree["fit"]
    assert fit.parent is None and spans[-1] is fit
    assert {s.fit for s in spans if s.name not in roots} == {fit.id}
    parents = {"fit.prepare": "fit", "fit.loop": "fit", "fit.finish": "fit",
               **{name: "fit.loop" for name in loop_children}}
    for name, parent in parents.items():
        child, up = tree[name], tree[parent]
        assert child.parent == up.id
        assert up.start_ns <= child.start_ns <= child.end_ns <= up.end_ns
    phases = [tree[n] for n in ("fit.prepare", "fit.loop", "fit.finish")]
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    assert fit.ms - sum(s.ms for s in phases) < 1.0
    loop = [tree[n] for n in loop_children]
    assert tree["fit.loop"].ms - sum(s.ms for s in loop) < 1.0
    iters = {s.name: s.attrs["iters"] for s in loop}
    assert sum(iters.values()) == ITERS
    assert iters["loop.warmup"] == WARMUP


def test_hgnn_fit_opens_its_prepare_span_before_the_fit():
    """G's lowering, the uploads and the G X hoist are ``hgnn.prepare``,
    a root span that ends before the ``fit`` span starts."""
    with recording() as spans:
        _hgnn()()
    tree = _tree(spans)
    prepare, fit = tree["hgnn.prepare"], tree["fit"]
    assert prepare.parent is None and prepare.fit is None
    assert prepare.start_ns <= prepare.end_ns <= fit.start_ns
    assert prepare.counts["spmm_coo"] > 0
    assert {s.fit for s in spans if s is not prepare} == {fit.id}


def test_two_fits_give_two_ids():
    run = _fit("gcn_captured")
    with recording() as spans:
        run()
        run()
    fits = [s for s in spans if s.name == "fit"]
    assert len(fits) == 2 and fits[0].id != fits[1].id
    for f in fits:
        assert sum(s.fit == f.id for s in spans) == len(spans) // 2


def test_nothing_is_recorded_outside_recording():
    run = _fit("hgnn")
    assert span("fit") is span("loop.replay") is timers._NO_SPAN
    run()
    with recording() as spans:
        pass
    assert spans == []
    with recording() as spans:
        run()
    with recording() as later:
        pass
    assert spans and later == []


@pytest.mark.parametrize("flavor", FLAVORS)
def test_spans_are_profiler_host_events(flavor):
    run = _fit(flavor)
    with recording() as spans:
        run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    host = {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU}
    assert {s.name for s in spans} <= host


def test_coo_product_forward_and_backward_count_two():
    data = get_dataset("synth-tiny", seed=1)
    adj = device_adjacency(gcn_normalize(data.adj), "coo", device="cpu")
    x = torch.randn(data.adj.shape[0], 3, requires_grad=True)
    before = counters["spmm_coo"]
    spmm(adj, x).sum().backward()
    assert counters["spmm_coo"] == before + 2


@pytest.mark.parametrize("flavor", ["gcn_captured", "hgnn"])
def test_calls_an_iteration_are_the_same_in_warmup_and_replay(flavor):
    run = _fit(flavor)
    with recording() as spans:
        run()
    tree = _tree(spans)
    warm, rest = tree["loop.warmup"], tree["loop.replay"]
    assert warm.counts["spmm_coo"] / WARMUP == 3
    assert rest.counts["spmm_coo"] / rest.attrs["iters"] == 3


def _gat():
    data = get_dataset("synth-tiny", seed=1)

    def run():
        GAT(data.num_features, data.num_classes, heads=(2, 2, 3),
            hidden=(8, 8), device="cpu").fit(
                data.features, data.adj, data.labels, data.idx_train,
                data.idx_val, train_iters=ITERS, mode="val")
    return run


def test_gat_fit_opens_its_layout_span_before_the_fit():
    with recording() as spans:
        _gat()()
    tree = _tree(spans)
    layout, fit = tree["gat.layout"], tree["fit"]
    assert layout.parent is None and layout.fit is None
    assert layout.start_ns <= layout.end_ns <= fit.start_ns
    assert {s.fit for s in spans if s is not layout} == {fit.id}


def test_gat_attention_counts_nine_calls_an_iteration():
    with recording() as spans:
        _gat()()
    tree = _tree(spans)
    warm, rest = tree["loop.warmup"], tree["loop.replay"]
    assert warm.counts["gat_attn"] / WARMUP == 9
    assert rest.counts["gat_attn"] / rest.attrs["iters"] == 9
    # the final evaluation's forward
    assert tree["fit.finish"].counts["gat_attn"] == 3
    # no call went through the kernels on the CPU
    assert not any(k.startswith("gat_attn_h") for k in tree["fit"].counts)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,counter", [("coo", "spmm_coo"),
                                          ("ell", "spmm_ell")])
def test_captured_fit_spans_on_card(cuda, kind, counter):
    """On the card the loop captures: ``loop.capture`` sits between the
    warm-up and the replays and holds one iteration's three calls, and
    the replays make no host call."""
    run = _gcn(jit_loop=True, kind=kind, device=cuda)
    with recording() as spans:
        run()
    tree = _tree(spans)
    warm, cap, rest = (tree[n] for n in ("loop.warmup", "loop.capture",
                                         "loop.replay"))
    assert cap.parent == tree["fit.loop"].id
    assert warm.end_ns <= cap.start_ns <= cap.end_ns <= rest.start_ns
    assert warm.counts[counter] / WARMUP == cap.counts[counter] == 3
    assert counter not in rest.counts
