"""Every flavor of the port's sharded step against gcn_tpu's, on the CPU.

``make_sharded_gcn_train_step`` over the ragged, padded and hierarchical
(2 x 2, both fan-outs) exchanges, with the pass-block partition, the
row-split parts (chunked and not) and the monolithic layout on K1's plain
version, and with the segment sum, matches gcn_tpu's step on its 4-device
CPU mesh at dropout 0: per-step losses at rtol 1e-4, eval log-probs at atol
1e-4 + rtol 1e-5 (tests/test_torch_port_dist.py's tolerances; the bf16 wire
at atol 1e-3 there, as in that file). The three overlaps give one result.
Two (and four) gloo processes match one process at rtol 1e-5 for the
padded all-to-all, the hierarchical exchange and the split parts, and the
dist CLI runs each flavor to the default's loss.
"""

import subprocess
import sys

import numpy as np
import pytest

from gcn_tpu_torch.parallel import create_mesh, shard_graph_by_rows
from gcn_tpu_torch.parallel import make_sharded_gcn_train_step
from torch_port_dist_graphs import (NS, REPO, gloo_run, jax_run,
                                    one_process_of_gloo_problem, port_graph,
                                    port_run, problem, sbm_graph,
                                    subprocess_env)

HIER = dict(exchange="halo_hier", hier=(2, 2))
CONFIGS = {
    "halo_no_overlap_chunked": dict(overlap=False, exchange_chunk=16),
    "halo_no_overlap_unchunked": dict(overlap=False, exchange_chunk=None),
    "halo_split_chunked": dict(overlap="split", exchange_chunk=16),
    "halo_split_unchunked": dict(overlap="split", exchange_chunk=None),
    "padded_blocks": dict(exchange="halo_padded", exchange_chunk=16),
    "padded_split": dict(exchange="halo_padded", overlap="split",
                         exchange_chunk=16),
    "padded_no_overlap": dict(exchange="halo_padded", overlap=False),
    "padded_segsum": dict(exchange="halo_padded", kernel="segsum"),
    "hier_blocks": dict(HIER, exchange_chunk=16),
    "hier_split": dict(HIER, overlap="split", exchange_chunk=16),
    "hier_no_overlap": dict(HIER, overlap=False),
    "hier_segsum": dict(HIER, kernel="segsum"),
    "hier_all_gather_blocks": dict(HIER, hier_fanout="all_gather",
                                   exchange_chunk=16),
    "hier_all_gather_segsum": dict(HIER, hier_fanout="all_gather",
                                   kernel="segsum"),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_flavor_matches_gcn_tpu(config):
    """nhid 40 > chunk 16: the fused forms' layer-1 exchange goes in 3
    slices (16/16/8), layer 2 (4 classes) in one."""
    jg, x, labels, mask, p0 = problem()
    want_l, want_lp = jax_run(jg, x, labels, mask, p0, **CONFIGS[config])
    got_l, got_lp = port_run(port_graph(jg), x, labels, mask, p0,
                             **CONFIGS[config])
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=0)
    np.testing.assert_allclose(got_lp, want_lp, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(HIER, exchange_dtype="bf16"),
                                dict(exchange="halo_padded", overlap=False,
                                     exchange_dtype="bf16")],
                         ids=["hier_bf16", "padded_no_overlap_bf16"])
def test_flavor_wire_matches_gcn_tpu(kw):
    """The bf16 wire on both send sets and the fan-out (hierarchical), and
    on the padded all-to-all; eval log-probs at atol 1e-3 (a bf16 ulp can
    flip where the f32 values it rounds differ in their last bit)."""
    jg, x, labels, mask, p0 = problem()
    want_l, want_lp = jax_run(jg, x, labels, mask, p0, exchange_chunk=16,
                              **kw)
    got_l, got_lp = port_run(port_graph(jg), x, labels, mask, p0,
                             exchange_chunk=16, **kw)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=0)
    np.testing.assert_allclose(got_lp, want_lp, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("exchange", [dict(), dict(exchange="halo_padded"),
                                      HIER,
                                      dict(HIER, hier_fanout="all_gather")],
                         ids=["halo", "halo_padded", "hier_ragged",
                              "hier_all_gather"])
def test_overlaps_match_the_monolithic_layout(exchange):
    """The pass-block and the split overlaps end where the monolithic
    layout ends, at dropout 0.5 (the same masks: seeded by band)."""
    jg, x, labels, mask, p0 = problem()
    g = port_graph(jg)
    runs = [port_run(g, x, labels, mask, p0, steps=4, dropout=0.5,
                     overlap=overlap, exchange_chunk=16, **exchange)
            for overlap in (False, "blocks", "split")]
    for losses, lp in runs[1:]:
        np.testing.assert_allclose(losses, runs[0][0], rtol=1e-5, atol=0)
        np.testing.assert_allclose(lp, runs[0][1], rtol=1e-5, atol=1e-5)


def test_hier_needs_a_host_by_chip_mesh():
    sg = shard_graph_by_rows(port_graph(sbm_graph()[0]), NS)
    with pytest.raises(ValueError, match="create_mesh_hier"):
        make_sharded_gcn_train_step(create_mesh(NS, "cpu"), sg,
                                    exchange="halo_hier")


@pytest.mark.parametrize("kw,world", [
    (dict(exchange="halo_padded"), 2),
    (dict(exchange="halo_hier", hier=(2, 2)), 2),
    (dict(exchange="halo_hier", hier=(1, 4), overlap=False), 2),
    (dict(overlap="split"), 2),
    (dict(exchange="halo_hier", hier=(2, 2), hier_fanout="all_gather",
          exchange_dtype="bf16"), 4),
    (dict(exchange="halo_hier", hier=(2, 2), overlap="split"), 4),
], ids=["padded_2", "hier_2x2_2", "hier_1x4_no_overlap_2", "split_2",
        "hier_all_gather_bf16_4", "hier_split_4"])
def test_gloo_processes_match_one_process(kw, world):
    """Processes of 4 / world shards each (gloo point-to-point messages or
    the padded plan's all_to_all_single, all-reduced gradients) against one
    process of four, dropout 0.5. Over two processes a host is a process
    (1 x 4: the chip shifts cross processes); over four, every phase of the
    hierarchical exchange does."""
    losses, lp = gloo_run(dropout=0.5, world=world, **kw)
    assert all(ls == losses[0] for ls in losses)
    want, want_lp = one_process_of_gloo_problem(**kw)
    np.testing.assert_allclose(losses[0], want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(lp, want_lp, rtol=1e-5, atol=1e-5)


def _cli(args):
    proc = subprocess.run(
        [sys.executable, "-m", "gcn_tpu_torch.train_gcn_dist", "-g",
         "synth-tiny", "-k", "8", "--shards", "4", "--device", "cpu", "-i",
         "5"] + args, cwd=REPO, env=subprocess_env(), capture_output=True,
        text=True, timeout=240)
    return proc


def _final_loss(out):
    line = [ln for ln in out.splitlines() if "final loss" in ln][-1]
    return float(line.rsplit("final loss", 1)[1].strip(" )"))


def test_dist_cli_flavors_reach_the_default_loss():
    """--no-overlap, --exchange halo_padded and --exchange halo_hier --hier
    2 2 train to the default's final loss (dropout 0.5: the masks are
    seeded by band) and print their plan's exchange fraction; --hier that
    does not factor the shards is refused."""
    default = _cli([])
    assert default.returncode == 0, default.stderr[-2000:]
    for args, fraction in ((["--no-overlap"], "exchange fraction: "),
                           (["--exchange", "halo_padded"],
                            "exchange fraction: "),
                           (["--exchange", "halo_hier", "--hier", "2", "2"],
                            "(across hosts ")):
        run = _cli(args)
        assert run.returncode == 0, run.stderr[-2000:]
        assert "Test set results" in run.stdout and fraction in run.stdout
        assert _final_loss(run.stdout) == pytest.approx(
            _final_loss(default.stdout), rel=1e-5)
    bad = _cli(["--exchange", "halo_hier", "--hier", "3", "2"])
    assert bad.returncode != 0
    assert "does not factor" in bad.stderr
