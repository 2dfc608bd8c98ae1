"""The readers of the program's spans and counters (``spans.py`` and the
five metrics that read it) on hand-built records, and on a real
recording of a fit on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans

MS = 1_000_000   # ns


def _span(name, sid, fit, parent, start_ms, end_ms, counts=None, **attrs):
    return {"name": name, "id": sid, "fit": fit, "parent": parent,
            "start_ns": int(start_ms * MS), "end_ns": int(end_ms * MS),
            "attrs": attrs, "counts": counts or {}}


def _fit(fid, t0, prepare, warm, capture, replay, drain, finish, calls):
    """One fit's spans, children before parents, each phase's ms given."""
    t = [t0]
    for d in (prepare, warm, capture, replay, drain, finish):
        t.append(t[-1] + d)
    loop = fid + 2
    return [
        _span("fit.prepare", fid + 1, fid, fid, t[0], t[1]),
        _span("loop.warmup", fid + 3, fid, loop, t[1], t[2],
              {"spmm_ell": 2 * calls}, iters=2),
        _span("loop.capture", fid + 4, fid, loop, t[2], t[3],
              {"spmm_ell": calls, "spmm_ell_k40": calls}),
        _span("loop.replay", fid + 5, fid, loop, t[3], t[4], iters=498),
        _span("fit.loop", loop, fid, fid, t[1], t[5],
              {"spmm_ell": 3 * calls}),
        _span("fit.finish", fid + 6, fid, fid, t[5], t[6],
              {"spmm_ell": 1}),
        _span("fit", fid, fid, None, t[0], t[6]),
    ]


RECORD = {"program_spans": (
    _fit(0, 0.0, 5.0, 4.0, 3.0, 80.0, 2.0, 6.0, 3)        # 100 ms
    + _fit(10, 200.0, 10.0, 8.0, 2.0, 170.0, 4.0, 6.0, 3)  # 200 ms
    + _fit(20, 500.0, 20.0, 4.0, 4.0, 160.0, 4.0, 8.0, 3)  # 200 ms
    + [_span("outside", 99, None, None, 0.0, 1e4)])}


def _read(name, rec=RECORD):
    return harness._module("metrics", name).read(rec)


def test_phases_per_fit_and_their_medians():
    fits = spans.per_fit(RECORD["program_spans"])
    assert [f["fit"] for f in fits] == pytest.approx([100.0, 200.0, 200.0])
    assert fits[0]["drain"] == pytest.approx(2.0)
    for f in fits:
        assert sum(f[p] for p in spans.PHASES) == pytest.approx(f["fit"])
    med = spans.median_ms(RECORD["program_spans"])
    assert med["fit.prepare"] == pytest.approx(10.0)
    assert med["loop.replay"] == pytest.approx(160.0)
    assert spans.median_ms([]) == {}


def test_share_readers_take_the_median_over_fits():
    # fit.prepare: 5 %, 5 %, 10 %; warm-up and capture 7 %, 5 %, 4 %;
    # fit.finish 6 %, 3 %, 4 %
    assert _read("fit_prepare_pct") == pytest.approx(5.0)
    assert _read("loop_start_pct") == pytest.approx(5.0)
    assert _read("fit_finish_pct") == pytest.approx(4.0)


def test_calls_per_iter_reads_the_captures_without_the_widths():
    assert _read("spmm_calls_per_iter") == pytest.approx(3.0)
    two = {"program_spans": [
        _span("loop.capture", 1, 0, None, 0, 1,
              {"spmm_coo": 3, "spmm_ell_k40": 7, "other": 5}),
        _span("loop.capture", 2, 3, None, 0, 1, {"spmm_coo": 2})]}
    assert _read("spmm_calls_per_iter", two) == pytest.approx(2.5)


@pytest.mark.parametrize("name", ["fit_prepare_pct", "loop_start_pct",
                                  "fit_finish_pct", "replay_idle_pct",
                                  "spmm_calls_per_iter"])
def test_readers_find_nothing_in_a_record_without_spans(name):
    assert _read(name, {"fits": [], "profile": {"busy_s": 1.0}}) is None
    assert _read(name, {"program_spans": [], "profile": {}}) is None


def test_idle_under_the_replay_range_and_its_reader():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def event(name, start, end, device=cpu):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [event("loop.warmup", 0.0, 100.0),
              event("loop.replay", 100.0, 1100.0),
              event("loop.replay", 100.0, 1100.0, device=cuda),
              event("aten::mm", 100.0, 1100.0)]
    gaps = [(50.0, 120.0), (500.0, 510.0), (1090.0, 1300.0)]
    idle = spans.idle_under(events, gaps)
    assert idle["loop.replay"] == pytest.approx([40e-6, 1000e-6])
    assert idle["loop.warmup"] == pytest.approx([50e-6, 100e-6])
    rec = {"profile": {"span_idle": idle}}
    assert _read("replay_idle_pct", rec) == pytest.approx(4.0)


def test_a_recorded_fit_reads_as_its_phases():
    """A captured fit of the program on the CPU, through ``records``."""
    import numpy as np

    from gcn_tpu_torch.graph import hypergraph as hg
    from gcn_tpu_torch.models.hgnn import HGNN
    from gcn_tpu_torch.utils.timers import recording

    rng = np.random.default_rng(0)
    x = rng.standard_normal((60, 16)).astype(np.float32)
    g = hg.generate_G_from_H(hg.construct_H_with_KNN(x, 4))
    with recording() as got:
        HGNN(16, 3, n_hid=8, adj_kind="coo", device="cpu").fit(
            x, g, rng.integers(0, 3, 60), np.arange(40),
            idx_val=np.arange(40, 60), num_epochs=5)
    rec = {"program_spans": spans.records(got)}
    (fit,) = spans.per_fit(rec["program_spans"])
    assert fit["loop.capture"] == 0.0 and fit["loop.replay"] > 0.0
    assert sum(fit[p] for p in spans.PHASES) == pytest.approx(
        fit["fit"], abs=1.0)
    for name in ("fit_prepare_pct", "loop_start_pct", "fit_finish_pct"):
        assert 0.0 < _read(name, rec) < 100.0
    # the CPU captures nothing
    assert _read("spmm_calls_per_iter", rec) is None
