"""K2's window split plan and the x-alignment helper of K1 and K2, on the
CPU.

The plan (``tile/tiler.py::split_plan``) is made on the host, so what the
card's cluster launch relies on is checked here: each heavy window's
parts tile its slots in order, light windows stay whole, and summing the
parts' plain products in rank order gives ``gcn_tpu``'s ``spmm_panel``
(its Pallas kernel in interpret mode) at rtol/atol 1e-5 (f32 sums in
another order). The kernel itself is held against the plain version on
the card in test_torch_port_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.ops.panel_spmm import spmm_panel as jx_spmm_panel
from gcn_tpu.tile import panel_adjacency as jx_panel
from torch_port_graphs import PANEL_GRAPHS, TOL, powerlaw_graph, with_split

from gcn_tpu_torch.ops import panel_spmm as ps
from gcn_tpu_torch.ops._align import aligned_rows
from gcn_tpu_torch.tile import panel_adjacency
from gcn_tpu_torch.tile.format import NUM_SMS, SPLIT_PARTS
from gcn_tpu_torch.tile.tiler import default_split_slots, split_plan


def _sorted_powerlaw():
    return powerlaw_graph(31, sort=True)


def _panel(g, split_slots=None):
    """The CPU layout, its split plan remade at ``split_slots`` (None: the
    default plan)."""
    adj = panel_adjacency(g, device="cpu")
    return adj if split_slots is None else with_split(adj, split_slots)


@pytest.mark.parametrize("split_slots", [0, 1000, 6000, None, 1 << 30])
def test_split_plan_tiles_each_heavy_window(split_slots):
    g, _ = _sorted_powerlaw()
    adj = _panel(g, split_slots)
    adj.validate()
    off = adj.win_off.numpy().astype(np.int64)
    slots = np.diff(off) * adj.nb
    limit = (default_split_slots(off, adj.nb, NUM_SMS) if split_slots is None
             else split_slots)
    heavy, parts, light = (t.numpy() for t in adj.plan)
    assert sorted(heavy.tolist() + light.tolist()) == list(range(len(slots)))
    assert (slots[heavy] > limit).all()
    assert (slots[light] <= limit).all()
    for h, w in enumerate(heavy):
        covered = np.concatenate([np.arange(parts[h, q], parts[h, q + 1])
                                  for q in range(SPLIT_PARTS)])
        assert np.array_equal(covered, np.arange(slots[w]))
        assert (parts[h, 1:-1] % 8 == 0).all()
    if split_slots is None:
        assert limit == -(-int(off[-1]) * adj.nb // NUM_SMS)
        assert heavy.tolist() and heavy[0] == 0
    if split_slots == 1 << 30:
        assert heavy.size == 0 and parts.shape == (0, SPLIT_PARTS + 1)


@pytest.mark.parametrize("split_slots", [0, 6000])
def test_split_parts_sum_to_gcn_tpu(split_slots):
    """Each part's plain products over its slot range, summed in rank order
    with the light windows', equal gcn_tpu's spmm_panel."""
    g, jg = _sorted_powerlaw()
    adj = _panel(g, split_slots)
    heavy, parts, light = (t.numpy() for t in adj.plan)
    assert heavy.size > 0 and (split_slots == 0 or light.size > 0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((g.shape[1], 8)).astype(np.float32)
    xt = torch.from_numpy(x)
    flat = {k: getattr(adj, k).reshape(-1, 1) for k in
            ("cols", "vals", "local_row")}
    row_base = adj.row_base.repeat_interleave(adj.nb).reshape(-1, 1)
    off = adj.win_off.numpy().astype(np.int64) * adj.nb

    def plain(lo, hi):
        return ps._panel_spmm_plain(xt, flat["cols"][lo:hi],
                                    flat["vals"][lo:hi],
                                    flat["local_row"][lo:hi],
                                    row_base[lo:hi, 0], adj.r, adj.n_rows)

    out = torch.zeros((adj.n_rows, 8))
    for w in light:
        out += plain(off[w], off[w + 1])
    for h, w in enumerate(heavy):
        acc = torch.zeros_like(out)
        for q in range(SPLIT_PARTS):
            acc = acc + plain(off[w] + parts[h, q], off[w] + parts[h, q + 1])
        out += acc
    want = np.asarray(jx_spmm_panel(jx_panel(jg), jnp.asarray(x)))
    np.testing.assert_allclose(out.numpy(), want, **TOL)


def test_split_plan_of_direct_window_offsets():
    """split_plan on hand-made offsets: equal shares of whole walker steps
    (8 slots), the last part taking the rest."""
    heavy, parts, light = split_plan(np.array([0, 5, 6, 8]), 128, 256)
    assert heavy.tolist() == [0] and light.tolist() == [1, 2]
    assert parts.tolist() == [[0, 80, 160, 240, 320, 400, 480, 560, 640]]
    heavy, parts, _ = split_plan(np.array([0, 1]), 8, 0)
    assert parts.tolist() == [[0, 8, 8, 8, 8, 8, 8, 8, 8]]


def test_validate_and_to_cover_the_plan():
    g, _ = PANEL_GRAPHS["rect"]()
    adj = _panel(g, 2048)
    assert not adj.symmetric and adj.heavy.numel() and adj.light.numel()
    adj.validate()
    moved = adj.to("cpu")
    for key in ("heavy", "heavy_parts", "light", "t_heavy", "t_heavy_parts",
                "t_light"):
        assert torch.equal(getattr(moved, key), getattr(adj, key)), key
    sym = panel_adjacency(_sorted_powerlaw()[0], device="cpu").to("cpu")
    assert sym.t_heavy is sym.heavy and sym.t_light is sym.light
    with pytest.raises(AssertionError, match="split plan"):
        dataclasses.replace(adj, light=adj.light[1:]).validate()
    bad = adj.heavy_parts.clone()
    bad[0, 1] += 1
    with pytest.raises(AssertionError, match="heavy parts"):
        dataclasses.replace(adj, heavy_parts=bad).validate()
    # a heavy window no larger than a light one
    swapped = dataclasses.replace(adj, heavy=adj.light[:1],
                                  light=torch.cat([adj.heavy,
                                                   adj.light[1:]]))
    with pytest.raises(AssertionError, match="light window"):
        swapped.validate()


def _storage_view(n, k, stride, offset=0, dtype=torch.float32):
    base = torch.arange(offset + n * stride, dtype=dtype)
    return base[offset:].as_strided((n, k), (stride, 1))


@pytest.mark.parametrize("case,copied,ldx", [
    ("contiguous k=32", False, 32),
    ("contiguous k=33", True, 36),
    ("row stride 36, k=32", False, 36),
    ("row stride 33, k=32", True, 32),
    ("unaligned base", True, 32),
    ("bf16 8-byte aligned", False, 32),
    ("bf16 unaligned", True, 32),
])
def test_aligned_rows_copies_only_when_it_must(case, copied, ldx):
    x = {
        "contiguous k=32": lambda: torch.randn(10, 32),
        "contiguous k=33": lambda: torch.randn(10, 33),
        "row stride 36, k=32": lambda: torch.randn(10, 36)[:, :32],
        "row stride 33, k=32": lambda: torch.randn(10, 33)[:, :32],
        "unaligned base": lambda: _storage_view(10, 32, 32, offset=1),
        "bf16 8-byte aligned": lambda: _storage_view(
            10, 32, 32, offset=4, dtype=torch.bfloat16),
        "bf16 unaligned": lambda: _storage_view(
            10, 32, 32, offset=2, dtype=torch.bfloat16),
    }[case]()
    got, got_ldx = aligned_rows(x, "K")
    assert got_ldx == ldx
    assert (got.data_ptr() != x.data_ptr()) == copied
    assert got.data_ptr() % (4 * x.element_size()) == 0
    assert torch.equal(got[:, :x.shape[1]], x)
    if copied:
        assert got.is_contiguous() and not got[:, x.shape[1]:].any()


def test_aligned_rows_refuses_transposed_rows():
    with pytest.raises(ValueError, match="contiguous rows"):
        aligned_rows(torch.randn(8, 10).t(), "K")
    # a last row whose padded width runs past the storage is copied
    x = torch.randn(4 * 36)[:3 * 36 + 33].as_strided((4, 33), (36, 1))
    got, ldx = aligned_rows(x, "K")
    assert ldx == 36 and got.data_ptr() == x.data_ptr()
    x = torch.randn(3 * 36 + 33).as_strided((4, 33), (36, 1))
    got, ldx = aligned_rows(x, "K")
    assert ldx == 36 and got.data_ptr() != x.data_ptr()
