"""The port's weak-scaling projection (``gcn_tpu_torch.parallel.projection``)
against gcn_tpu's (``gcn_tpu.parallel.projection``), on the CPU.

With every rate passed explicitly (and both packages' ``measured_*``
readers patched to the same values where a function reads them itself),
the two projections are one computation over equal planner outputs:
integers equal, floats within rtol 1e-12; only the provenance strings
differ. Then gcn_tpu's own property tests (tests/test_projection.py) over
the port, and the port's provenance: its rates are the H100 capture's.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

from gcn_tpu.data.synthetic import powerlaw_sbm as jx_powerlaw
from gcn_tpu.graph.normalize import gcn_normalize as jx_normalize
from gcn_tpu.parallel import halo as jx_halo
from gcn_tpu.parallel import partition as jx_part
from gcn_tpu.parallel import projection as jx
from gcn_tpu.reorder import reorder_graph as jx_reorder

from gcn_tpu_torch.parallel import halo as pt_halo
from gcn_tpu_torch.parallel import partition as pt_part
from gcn_tpu_torch.parallel import projection as pt
from torch_port_dist_graphs import port_graph

RATES = dict(spmm_edges_per_s=3.3e10, bw_ici=3.0e11, bw_dcn=5.0e10)
FULL = dict(RATES, mxu_flops=1.3e13, kernel_scales=(25.0, 24.0))
SMALL = dict(nodes_per_device=512, chips_per_host=4, reorder="degree",
             seed=3)
# the provenance keys (where a rate came from) and the model's prose, which
# the packages word differently by design
SOURCES = ("spmm_rate_source", "kernel_scales_source", "mxu_flops_source",
           "bw_ici_source", "bw_dcn_source", "model")


def assert_same(got, want, where="result"):
    """Integers and strings equal, floats within rtol 1e-12 (inf equal),
    recursively through dicts, lists and tuples."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), (where, got, want)
        assert got == want or math.isclose(got, want, rel_tol=1e-12), \
            (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def without_sources(d):
    return {k: v for k, v in d.items() if k not in SOURCES}


@pytest.fixture(scope="module")
def flat_rows():
    return (pt.project_weak_scaling([4, 16], **SMALL, **RATES),
            jx.project_weak_scaling([4, 16], **SMALL, **RATES))


@pytest.fixture(scope="module")
def fullstep():
    """Each workload's full-step projection in both packages."""
    return {w: (pt.project_weak_scaling_fullstep(
                    [4, 12], workload=w, hub_check=True, **SMALL, **FULL),
                jx.project_weak_scaling_fullstep(
                    [4, 12], workload=w, hub_check=True, **SMALL, **FULL))
            for w in ("powerlaw", "sbm", "geometric")}


def test_project_weak_scaling_equals_gcn_tpu(flat_rows):
    got, want = flat_rows
    assert [r.devices for r in got] == [4, 16]
    for g, w in zip(got, want):
        assert_same(dataclasses.asdict(g), dataclasses.asdict(w))
        assert_same(g.to_json(), w.to_json())


@pytest.mark.parametrize("workload", ["powerlaw", "sbm", "geometric"])
def test_fullstep_equals_gcn_tpu(fullstep, workload):
    (got, gmeta), (want, wmeta) = fullstep[workload]
    assert [r.devices for r in got] == [4, 12]
    for g, w in zip(got, want):
        assert_same(dataclasses.asdict(g), dataclasses.asdict(w))
        assert_same(g.to_json(), w.to_json())
    # the port's meta adds the provenance of every rate; the rest is equal
    assert_same(without_sources(gmeta), without_sources(wmeta))
    assert gmeta["spmm_rate_source"] == wmeta["spmm_rate_source"] == "caller"
    assert gmeta["bw_dcn_source"].startswith("assumed")


def _powerlaw_shards(pkg, d):
    """(needed boundaries, sharded graph) of a heavy-tailed graph at d
    bands, through ``pkg``'s (gcn_tpu's or the port's) pipeline."""
    adj, _ = jx_powerlaw(n=256 * d, n_classes=d, avg_degree=14.0, seed=0)
    g = jx_normalize(adj)
    g, _ = jx_reorder(g, "degree")
    if pkg is pt:
        g = port_graph(g)
        part, halo = pt_part, pt_halo
    else:
        part, halo = jx_part, jx_halo
    sg0 = part.shard_graph_by_rows(g, d)
    g = g.permute(part.band_degree_sort_order(g, sg0.rows_per_shard))
    sg = part.shard_graph_by_rows(g, d)
    return halo._pair_boundaries(sg)[0], sg


def test_lockstep_vs_matched_equals_gcn_tpu():
    got = pt.lockstep_vs_matched_dcn(_powerlaw_shards(pt, 12)[0], 12, 3, 4)
    want = jx.lockstep_vs_matched_dcn(_powerlaw_shards(jx, 12)[0], 12, 3, 4)
    assert_same(got, want)
    assert want["rank_bound"] <= want["matched"] <= want["lockstep"]


@pytest.mark.parametrize("plan,bw_dcn", [
    ("ragged", 5.0e10), ("hier 2x2", 5.0e10), ("hier 2x2", 1.0e6),
    ("hier 3x4", 5.0e10), ("hier 3x4", 1.0e6)])
def test_recommend_wire_dtype_equals_gcn_tpu(monkeypatch, plan, bw_dcn):
    """Both wires' branches: at a network of 1 MB/s the hierarchical plans
    are byte-bound and fp8 wins."""
    for pkg in (pt, jx):
        monkeypatch.setattr(pkg, "measured_kernel_scales",
                            lambda *a, **k: ((25.0, 24.0), "patched"))
    shape = (2, 2) if "2x2" in plan else (3, 4)
    d = 4 if plan == "ragged" else shape[0] * shape[1]
    out = {}
    for pkg, halo in ((pt, pt_halo), (jx, jx_halo)):
        _, sg = _powerlaw_shards(pkg, d)
        p = (halo.build_halo_plan_ragged(sg) if plan == "ragged"
             else halo.build_halo_plan_hier(sg, *shape))
        out[pkg] = pkg.recommend_wire_dtype(
            sg, p, widths=(64, 32, 8), spmm_edges_per_s=3.3e10,
            mxu_flops=1.3e13, bw_ici=3.0e11, bw_dcn=bw_dcn)
    (gw, gwhy), (ww, wwhy) = out[pt], out[jx]
    assert gw == ww
    assert_same(without_sources(gwhy), without_sources(wwhy))
    if plan == "ragged":
        assert gw == "bf16"
    elif bw_dcn == 1.0e6:
        assert gw == "fp8"


# gcn_tpu's own property tests (tests/test_projection.py), over the port


def test_projection_shapes_and_bounds(flat_rows):
    for r in flat_rows[0]:
        assert r.edges_per_device > 0
        assert 0.0 <= r.boundary_edge_frac <= 1.0
        assert 0 < r.flat_rows <= r.allgather_rows
        for eff in r.eff_flat.values():
            assert 0.0 < eff <= 1.0
        assert r.min_bw_scale_90 > 0.0


def test_projection_bandwidth_monotone(flat_rows):
    for r in flat_rows[0]:
        for effs in (r.eff_flat, r.eff_hier):
            if effs is None:
                continue
            vals = [effs[s] for s in sorted(effs)]
            assert vals == sorted(vals)


def test_projection_hier_beats_flat_on_dcn(flat_rows):
    single, multi = flat_rows[0]
    assert single.hosts == 1 and single.eff_hier is None
    assert multi.hosts == 4
    assert 0 < multi.hier_dcn_rows <= multi.flat_rows
    assert multi.eff_hier[1.0] >= multi.eff_flat[1.0]


def test_fullstep_shapes_and_bounds(fullstep):
    rows, meta = fullstep["powerlaw"][0]
    assert rows[0].hosts == 1 and rows[1].hosts == 3
    assert meta["spmm_rate_source"] == "caller"
    for r in rows:
        assert r.edges_per_device > 0
        assert 0.0 <= r.interior_frac <= 1.0
        assert r.t_comp_ms > 0
        for s in r.eff:
            assert 0.0 < r.eff[s] <= 1.0
            # the k-chunk pipeline can only widen the overlap window
            assert r.eff[s] >= r.eff_unchunked[s] - 1e-12
        assert r.min_bw_scale_90 > 0


def test_fullstep_hub_check_is_exact_and_reported(fullstep):
    single, multi = fullstep["powerlaw"][0][0]
    assert single.hub_best is None and single.hub_delta_rows is None
    assert multi.hub_best is not None
    assert multi.hub_best["dcn_rows"] == multi.dcn_rows + \
        multi.hub_delta_rows
    assert multi.hub_best["min_demand"] >= 2


def test_fullstep_row_json_round_trips(fullstep):
    rows, meta = fullstep["powerlaw"][0]
    s = json.dumps({"assumptions": meta,
                    "rows": [r.to_json() for r in rows]})
    back = json.loads(s)
    assert back["rows"] == json.loads(json.dumps([r.to_json()
                                                  for r in rows]))
    assert "eff_unchunked" in s and "spmm_rate_source" in s


def test_rates_come_from_the_h100_capture():
    """The rate, the scales, the matmul rate and the link bandwidth name the
    port's committed capture and an NVIDIA card; nothing reads gcn_tpu's
    TPU captures; the defaults are not the TPU's."""
    cap = pt.load_capture()
    assert cap is not None and cap["card"].startswith("NVIDIA")
    sources = []
    rate, src = pt.measured_spmm_rate()
    assert rate == cap["spmm"]["edges_per_s"]
    sources.append(src)
    for wide, tier in ((False, "k_pad_32"), (True, "k_pad_128")):
        (s, m), src = pt.measured_kernel_scales(wide=wide)
        assert s == cap[tier]["production_parts"]["blocks_over_plain"]
        assert m == cap[tier]["sharded_over_plain"]
        assert tier in src
        sources.append(src)
    flops, src = pt.measured_mxu_flops()
    assert flops == cap["matmul"]["flops_per_s"]
    sources.append(src)
    bw, src = pt.measured_bw_ici()
    assert bw == cap["links"]["bw_ici"]
    sources.append(src)
    for src in sources:
        assert src.startswith(pt.CAPTURE_NAME) and "NVIDIA" in src, src
        assert "BENCH_r" not in src and "results/" not in src, src
    tpu = {346e6, 9.0e10, 6.25e9, 5.0e13}
    assert not tpu & {pt.DEFAULTS["spmm_edges_per_s"], pt.DEFAULTS["bw_ici"],
                      pt.DEFAULTS["bw_dcn"],
                      pt.FULLSTEP_DEFAULTS["mxu_flops"]}
    # the defaults hold the capture's values
    assert pt.DEFAULTS["spmm_edges_per_s"] == pytest.approx(rate, rel=1e-3)
    assert pt.FULLSTEP_DEFAULTS["mxu_flops"] == pytest.approx(flops,
                                                              rel=1e-3)
    assert pt.DEFAULTS["bw_ici"] == pytest.approx(bw, rel=1e-3)


def test_missing_capture_falls_back_to_tagged_defaults(tmp_path):
    missing = str(tmp_path / "none.json")
    assert pt.measured_spmm_rate(missing) == (
        pt.DEFAULTS["spmm_edges_per_s"], "DEFAULTS (no capture)")
    scales, src = pt.measured_kernel_scales(missing, wide=True)
    assert scales == pt.KERNEL_SCALES["k_pad_128"]
    assert src.startswith("DEFAULTS (no capture)")
    assert pt.measured_bw_ici(missing)[1] == "DEFAULTS (no capture)"
    assert pt.measured_mxu_flops(missing)[1] == "DEFAULTS (no capture)"
    assert np.isfinite(pt.DEFAULTS["bw_dcn"])
