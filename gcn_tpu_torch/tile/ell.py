"""Degree-sorted packed-stride ELL format (EllAdj): the fast SpMM layout.

The port of ``gcn_tpu/tile/ell.py``. Rows, sorted by degree descending, are
cut into windows of R rows; window w takes ``passes_w = ceil(max degree in
the window / P)`` pass-blocks of shape (P, R), where slot (j, i) of a block
holds one edge of the window's row i. The tiler below is the same
vectorized numpy code, so the arrays equal ``gcn_tpu``'s
(``tests/test_torch_port_data.py`` checks it): hub-row splitting
(``_split_hub_rows``), the pass ladder (``_ladder_passes``,
``_quantize_passes``), the span and chunk plans. Where no ladder applies,
the C++ tiler (``tile/native.py``, gcn_tpu's ``tiler.cpp``) lays out the
same arrays when it builds, as in gcn_tpu (``tile_route``).

On the H100 one hand-written kernel (``ops/ell_spmm.py``, K1) computes the
whole product whatever branch the TPU path would take, so ``spans`` and
``chunks`` are kept as metadata (and for parity) but steer nothing here.
The kernel walks each window's pass-blocks through ``win_off``
(num_windows + 1, the first block of each window), which takes the place
of the TPU's scalar-prefetched ``win``, and shares the walks out by the
walk split plan (``walk_split_plan``, ``EllAdj.split``) made here on the
host with the layout: a window that walks more than half the per-SM mean
of pass-blocks, and more than 16 of K1's steps, is cut across a thread
block cluster.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from gcn_tpu_torch.graph.csr import CSRGraph
from gcn_tpu_torch.tile.format import sm_count
from gcn_tpu_torch.utils.device import resolve_device

DEFAULT_R = 128      # rows per output window
DEFAULT_K_PAD = 32   # feature lanes per slot; P = 128 // k_pad slots/row
DEFAULT_CHUNK_SLOTS = 8_000_000

WALK_SPLIT_PARTS = 8  # K1's thread blocks a heavy window: one cluster
                      # (portable; 16 was slower at P = 2 and 1, PERF.md)
MIN_SPLIT_STEPS = 16  # K1's steps (max(P, 4) slot rows) a walk takes whole

_TENSORS = ("cols", "vals", "win", "win_off", "t_cols", "t_vals", "t_win",
            "t_win_off", "virt_map", "t_virt_map", "hub_idx", "t_hub_idx")


@dataclasses.dataclass(frozen=True)
class WalkSplit:
    """K1's walk split plan of one direction, on the device of its layout
    (``walk_split_plan``): ``heavy`` int32 (n_heavy,) and ``light`` int32
    (n_light,) list the windows, ``parts`` int32 (n_heavy, C + 1) each heavy
    window's pass-block offsets from its first block, C the cluster size;
    ``walk`` is the longest walk of one thread block under the plan, in
    pass-blocks. The counts are the tensors' shapes, known on the host."""

    heavy: torch.Tensor
    parts: torch.Tensor
    light: torch.Tensor
    walk: int

    @property
    def n_heavy(self) -> int:
        return self.heavy.shape[0]

    @property
    def n_light(self) -> int:
        return self.light.shape[0]

    @property
    def clusters(self) -> int:
        """C, the thread blocks of a heavy window's cluster."""
        return self.parts.shape[1] - 1

    @property
    def launches(self) -> int:
        """K1's kernel launches a call: one a non-empty list."""
        return int(self.n_heavy > 0) + int(self.n_light > 0)

    def to(self, device) -> "WalkSplit":
        return dataclasses.replace(self, heavy=self.heavy.to(device),
                                   parts=self.parts.to(device),
                                   light=self.light.to(device))


@dataclasses.dataclass(frozen=True)
class EllAdj:
    """Packed fixed-stride ELL adjacency on one device.

    ``cols`` int32 / ``vals`` float32 are (num_blocks, P, R); ``win`` int32
    (num_blocks,) is each block's output window, nondecreasing, every window
    visited; ``win_off`` int32 (num_windows + 1,) the first block of each
    window. ``t_*`` mirror them for A^T (backward dX), aliased when
    symmetric. ``virt_map`` (int32, real row of each virtual hub row) is
    None when no hub row was split; ``hub_idx`` / ``hub_steps`` are the
    same split as the fold's fixed-order plan (``hub_fold_plan``).
    ``tiler`` / ``t_tiler``: the host route that laid out each direction
    (``tile_route``). ``split`` / ``t_split``: K1's walk split plan of each
    direction (``walk_split``), aliased when symmetric.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    win: torch.Tensor
    win_off: torch.Tensor
    t_cols: torch.Tensor
    t_vals: torch.Tensor
    t_win: torch.Tensor
    t_win_off: torch.Tensor
    n_rows: int
    n_cols: int
    nnz: int
    r: int
    k_pad: int
    symmetric: bool
    chunks: tuple
    t_chunks: tuple
    products_bf16: bool = False
    spans: tuple = ()
    t_spans: tuple = ()
    table_bf16: bool = False
    span_pass_limit: int = 16
    virt_map: Optional[torch.Tensor] = None
    t_virt_map: Optional[torch.Tensor] = None
    n_virt: int = 0
    n_hub: int = 0
    t_n_virt: int = 0
    t_n_hub: int = 0
    tiler: str = "numpy"
    t_tiler: str = "numpy"
    hub_idx: Optional[torch.Tensor] = None
    t_hub_idx: Optional[torch.Tensor] = None
    hub_steps: tuple = ()
    t_hub_steps: tuple = ()
    split: Optional[WalkSplit] = None
    t_split: Optional[WalkSplit] = None

    @property
    def p(self) -> int:
        return 128 // self.k_pad

    @property
    def num_blocks(self) -> int:
        return self.cols.shape[0]

    @property
    def row_space(self) -> int:
        """Height of the forward reduce's row space (virtual rows when hub
        splitting is active, else real rows)."""
        return self.n_virt or self.n_rows

    @property
    def t_row_space(self) -> int:
        return self.t_n_virt or self.n_cols

    @property
    def num_windows(self) -> int:
        return -(-self.row_space // self.r)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def pad_fraction(self) -> float:
        total = self.cols.numel()
        return 1.0 - self.nnz / total if total else 0.0

    def to(self, device) -> "EllAdj":
        """A copy with every tensor on ``device`` (aliases stay aliases)."""
        moved = {}
        for name in _TENSORS:
            t = getattr(self, name)
            if t is None:
                continue
            for done_name, done in moved.items():
                if getattr(self, done_name) is t:
                    moved[name] = done
                    break
            else:
                moved[name] = t.to(device)
        if self.split is not None:
            moved["split"] = self.split.to(device)
            moved["t_split"] = (moved["split"] if self.t_split is self.split
                                else self.t_split.to(device))
        return dataclasses.replace(self, **moved)

    def validate(self) -> None:
        """Host-side format-invariant walker; raises AssertionError on the
        first violated invariant. Not for the hot path."""
        for name, cols, vals, win, win_off, n_cols, spans, split in (
                ("fwd", self.cols, self.vals, self.win, self.win_off,
                 self.n_cols, self.spans, self.split),
                ("bwd", self.t_cols, self.t_vals, self.t_win, self.t_win_off,
                 self.n_rows, self.t_spans, self.t_split)):
            cols_h = cols.cpu().numpy()
            vals_h = vals.cpu().numpy()
            win_h = win.cpu().numpy()
            assert cols_h.shape == vals_h.shape == (win_h.shape[0],
                                                    self.p, self.r), name
            assert (np.diff(win_h) >= 0).all(), \
                f"{name}: win must be nondecreasing"
            nw = int(win_h.max()) + 1 if win_h.size else 0
            assert set(win_h.tolist()) == set(range(nw)), \
                f"{name}: every window must be visited"
            assert np.array_equal(win_off.cpu().numpy(),
                                  _win_offsets(win_h, nw)), \
                f"{name}: win_off disagrees with win"
            real = vals_h != 0
            assert (cols_h[real] >= 0).all() and \
                (cols_h[real] < n_cols).all(), \
                f"{name}: stored column out of range"
            assert int(real.sum()) <= self.nnz, \
                f"{name}: more stored entries than nnz"
            for b0, b1, pw, ws, we in spans:
                assert b1 - b0 == (we - ws) * pw, f"{name}: bad span"
                assert (win_h[b0:b1] == np.repeat(
                    np.arange(ws, we), pw)).all(), \
                    f"{name}: span/window mismatch"
            if split is not None:
                check_walk_split(win_off.cpu().numpy(),
                                 *(t.cpu().numpy() for t in (
                                     split.heavy, split.parts, split.light)))
        for name, vm, n_hub, n_virt, n_real, idx, steps in (
                ("fwd", self.virt_map, self.n_hub, self.n_virt, self.n_rows,
                 self.hub_idx, self.hub_steps),
                ("bwd", self.t_virt_map, self.t_n_hub, self.t_n_virt,
                 self.n_cols, self.t_hub_idx, self.t_hub_steps)):
            if n_hub == 0:
                assert vm is None and idx is None and steps == (), name
                continue
            vm_h = vm.cpu().numpy()
            assert (np.diff(vm_h) >= 0).all(), \
                f"{name}: virt_map must be nondecreasing"
            assert set(vm_h.tolist()) == set(range(n_hub)), \
                f"{name}: virt_map must cover every hub row"
            assert n_virt == len(vm_h) + (n_real - n_hub), \
                f"{name}: virtual row count mismatch"
            want_idx, want_steps = hub_fold_plan(vm_h)
            assert steps == want_steps and np.array_equal(
                idx.cpu().numpy(), want_idx), \
                f"{name}: hub fold plan disagrees with virt_map"


def degree_sort_order(g: CSRGraph) -> np.ndarray:
    """perm[new] = old, rows by degree descending (stable: preserves the
    incoming — e.g. Rabbit community — order among equal degrees)."""
    deg = np.diff(g.indptr)
    return np.argsort(-deg, kind="stable").astype(np.int32)


def _win_offsets(win: np.ndarray, num_windows: int) -> np.ndarray:
    """First block of each window (+ the end), checking the invariants the
    kernel relies on: ``win`` nondecreasing and every window visited."""
    win = np.asarray(win)
    if (np.diff(win) < 0).any():
        raise ValueError("win must be nondecreasing")
    off = np.searchsorted(win, np.arange(num_windows + 1)).astype(np.int32)
    if (np.diff(off) <= 0).any():
        raise ValueError("every window must own at least one pass-block")
    return off


def _split_hub_rows(indptr: np.ndarray, cap: int):
    """Refine CSR row boundaries so no row exceeds ``cap`` nnz.

    Each hub row (deg > cap) becomes ceil(deg/cap) near-equal virtual
    chunks. Only applied when the hub rows form a PREFIX (true after
    degree_sort_order); otherwise returns None. Returns (virt_indptr,
    virt_map, n_hub, n_virt) where virt_map[vr] is the real row of virtual
    hub row vr; virtual rows beyond it are the real rows n_hub.. shifted.
    """
    deg = np.diff(indptr).astype(np.int64)
    hub = deg > cap
    n_hub = int(hub.sum())
    if n_hub == 0 or hub[n_hub:].any() or not hub[:n_hub].all():
        return None
    n = len(deg)
    m = -(-deg[:n_hub] // cap)                   # chunks per hub row
    n_virt_hub = int(m.sum())
    virt_map = np.repeat(np.arange(n_hub, dtype=np.int32),
                         m).astype(np.int32)
    ends = np.zeros(n_virt_hub, dtype=np.int64)
    pos = 0
    for r in range(n_hub):
        d, mr = int(deg[r]), int(m[r])
        q, rem = divmod(d, mr)
        sizes = np.full(mr, q, dtype=np.int64)
        sizes[:rem] += 1
        ends[pos:pos + mr] = indptr[r] + np.cumsum(sizes)
        pos += mr
    virt_indptr = np.concatenate([
        np.zeros(1, dtype=np.int64), ends,
        indptr[n_hub + 1:].astype(np.int64)])
    return virt_indptr, virt_map, n_hub, n_virt_hub + (n - n_hub)


def hub_fold_plan(virt_map: np.ndarray):
    """The hub fold's fixed-order plan: ``(idx, steps)``.

    ``virt_map`` (nondecreasing) gives hub h its chunks, the virtual rows
    ``first[h] .. first[h] + m[h] - 1``. Step c adds chunk c of the first
    ``steps[c]`` hubs into their sums, so each hub's chunks add in chunk
    order, ``((0 + c0) + c1) + ...``, in ``len(steps)`` steps (the largest
    chunk count) whatever the data. ``idx`` (int64) lists the virtual rows
    the steps read, step after step: the (n_hub, max_chunks) chunk table's
    columns, each cut to ``steps[c]`` rows, ``steps[c]`` being one past the
    last hub with more than c chunks. A hub before that with fewer chunks
    reads row ``len(virt_map)``: the fold's zero row, so the add is exact.
    """
    vm = np.asarray(virt_map, dtype=np.int64)
    if (np.diff(vm) < 0).any():
        raise ValueError("virt_map must be nondecreasing")
    m = np.bincount(vm)
    first = np.concatenate([[0], np.cumsum(m)[:-1]])
    idx, steps = [], []
    for c in range(int(m.max())):
        h = int(np.flatnonzero(m > c)[-1]) + 1
        idx.append(np.where(m[:h] > c, first[:h] + c, len(vm)))
        steps.append(h)
    return np.concatenate(idx).astype(np.int64), tuple(steps)


def default_split_blocks(win_off: np.ndarray, num_sms: int, p: int) -> int:
    """K1's split threshold, in pass-blocks of ``p`` slots: half the per-SM
    mean of the direction's pass-blocks, all of them over the card's
    ``num_sms`` SMs (K2's rule, ``tile/tiler.py::default_split_slots``,
    counted in pass-blocks and halved), and never below a walk of
    ``MIN_SPLIT_STEPS`` of K1's steps (max(P, 4) slot rows each). With
    clusters of 8, half the mean was the fastest of 0.25, 0.5, 1 and 2
    times it on synth-arxiv's serving layouts at P = 4, 2 and 1; a walk of
    16 steps or fewer ran faster whole (``time_kernels.py --walk-split``
    and ``--hgnn-layouts``, PERF.md)."""
    half_mean = -(-int(win_off[-1]) // (2 * num_sms))
    return max(half_mean, MIN_SPLIT_STEPS * max(p, 4) // p)


def walk_split_plan(win_off: np.ndarray, num_sms: int, p: int,
                    parts: int = WALK_SPLIT_PARTS,
                    split_blocks: Optional[int] = None):
    """K1's walk split plan for one direction of pass-blocks of ``p``
    slots: (heavy, parts, light).

    ``heavy`` int32 lists the windows that walk more than ``split_blocks``
    pass-blocks (``default_split_blocks`` by default), ``light`` int32 the
    others, both ascending. Heavy window ``heavy[h]`` is walked by ``parts``
    thread blocks of one cluster; block q covers its pass-blocks
    ``[parts[h, q], parts[h, q + 1])``, counted from the window's first
    block: contiguous, ascending, equal shares but the last.
    """
    if split_blocks is None:
        split_blocks = default_split_blocks(win_off, num_sms, p)
    nblk = np.diff(np.asarray(win_off, np.int64))
    heavy = np.flatnonzero(nblk > split_blocks).astype(np.int32)
    light = np.flatnonzero(nblk <= split_blocks).astype(np.int32)
    total = nblk[heavy]
    share = -(-total // parts)
    offs = np.minimum(total[:, None], share[:, None] * np.arange(parts + 1))
    return heavy, offs.astype(np.int32), light


def check_walk_split(win_off, heavy, parts, light) -> None:
    """Raise AssertionError unless the plan lists every window of
    ``win_off`` once, each list ascending, and each heavy window's parts
    tile its pass-blocks in ascending order."""
    nblk = np.diff(np.asarray(win_off, np.int64))
    both = np.concatenate([heavy, light])
    assert np.array_equal(np.sort(both), np.arange(len(nblk))), \
        "walk split: every window once"
    assert (np.diff(heavy) > 0).all() and (np.diff(light) > 0).all(), \
        "walk split: windows ascending"
    assert parts.ndim == 2 and parts.shape[0] == len(heavy) \
        and parts.shape[1] >= 2, "walk split: part offsets"
    assert (parts[:, 0] == 0).all() and (np.diff(parts, axis=1) >= 0).all() \
        and np.array_equal(parts[:, -1], nblk[heavy]), \
        "walk split: parts tile each heavy window"


def walk_split(win_off: np.ndarray, p: int, device, **kw) -> WalkSplit:
    """``walk_split_plan`` for the SMs of ``device`` (``sm_count``), its
    arrays on ``device``; ``kw`` goes to the plan."""
    device = torch.device(device)
    heavy, parts, light = walk_split_plan(win_off, sm_count(device), p,
                                          **kw)
    nblk = np.diff(np.asarray(win_off, np.int64))
    walk = max(int(nblk[light].max(initial=0)),
               int(np.diff(parts, axis=1).max(initial=0)))
    return WalkSplit(*(torch.from_numpy(a).to(device)
                       for a in (heavy, parts, light)), walk=walk)


def _window_passes(indptr: np.ndarray, n: int, r: int, p: int) -> np.ndarray:
    """Per-window pass counts (>=1: every window is always written)."""
    deg = np.diff(indptr).astype(np.int64)
    num_windows = max(1, -(-n // r))
    deg_pad = np.zeros(num_windows * r, dtype=np.int64)
    deg_pad[:n] = deg
    wmax = deg_pad.reshape(num_windows, r).max(axis=1)
    return np.maximum(1, -(-wmax // p))


def _ell_arrays(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                n: int, r: int, p: int,
                forced_passes: Optional[np.ndarray] = None):
    deg = np.diff(indptr).astype(np.int64)
    num_windows = max(1, -(-n // r))
    passes = _window_passes(indptr, n, r, p)
    if forced_passes is not None:
        assert len(forced_passes) == num_windows
        assert (forced_passes >= passes).all(), \
            "forced passes must cover every row's real degree"
        passes = np.asarray(forced_passes, dtype=np.int64)
    pass_off = np.zeros(num_windows + 1, dtype=np.int64)
    np.cumsum(passes, out=pass_off[1:])
    num_blocks = int(pass_off[-1])

    e = len(indices)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    j = np.arange(e, dtype=np.int64) - np.repeat(indptr[:-1].astype(np.int64),
                                                 deg)
    w = rows // r
    blk = pass_off[w] + j // p
    cols = np.zeros((num_blocks, p, r), dtype=np.int32)
    vals = np.zeros((num_blocks, p, r), dtype=np.float32)
    cols[blk, j % p, rows - w * r] = indices
    vals[blk, j % p, rows - w * r] = data
    win = np.repeat(np.arange(num_windows, dtype=np.int32), passes)
    return cols, vals, win, pass_off


def _span_plan(pass_off: np.ndarray) -> tuple:
    """Contiguous window spans with equal pass count:
    (block_start, block_end, passes, win_start, win_end) per span."""
    passes = np.diff(pass_off)
    nw = len(passes)
    spans = []
    ws = 0
    while ws < nw:
        we = ws
        while we < nw and passes[we] == passes[ws]:
            we += 1
        spans.append((int(pass_off[ws]), int(pass_off[we]),
                      int(passes[ws]), ws, we))
        ws = we
    return tuple(spans)


# reduce-segment budget of the TPU path's grouped reduce; it shapes the pass
# ladder, so the port keeps it for identical layouts
_MAX_REDUCE_SEGMENTS = 48


def _quantize_passes(passes: np.ndarray, max_values: int) -> np.ndarray:
    """Round per-window pass counts UP to an optimal ladder of at most
    ``max_values`` distinct values (minimizing total padded slots): a 1-D
    partition DP over the ascending distinct values."""
    v, c = np.unique(passes, return_counts=True)  # ascending
    V = len(v)
    if V <= max_values:
        return passes
    C = np.concatenate([[0], np.cumsum(c)])
    S = max_values
    f = np.full((V + 1, S + 1), np.inf)
    f[0, 0] = 0.0
    arg = np.zeros((V + 1, S + 1), dtype=np.int64)
    for j in range(1, V + 1):
        fs = f[:j]
        cost_tail = v[j - 1] * (C[j] - C[:j])  # windows i..j-1 pad to v[j-1]
        for s in range(1, S + 1):
            tot = fs[:, s - 1] + cost_tail
            i = int(np.argmin(tot))
            f[j, s] = tot[i]
            arg[j, s] = i
    s = int(np.argmin(f[V]))
    j = V
    mapped = np.empty(V, dtype=passes.dtype)
    while j > 0:
        i = arg[j, s]
        mapped[i:j] = v[j - 1]
        j, s = i, s - 1
    lut = dict(zip(v.tolist(), mapped.tolist()))
    return np.vectorize(lut.__getitem__)(passes).astype(passes.dtype)


def _guard_spans(spans: tuple, span_pass_limit: int) -> tuple:
    """Drop the span plan when it would need more reduce segments than the
    budget (unsorted graphs, or too many distinct pass values)."""
    segments = 0
    prev_hub = False
    for _, _, pw, _, _ in spans:
        hub = pw > span_pass_limit
        if not hub or not prev_hub:
            segments += 1
        prev_hub = hub
    return () if segments > _MAX_REDUCE_SEGMENTS else spans


def _chunk_plan(pass_off: np.ndarray, p: int, r: int,
                max_slots: int) -> tuple:
    """Split blocks into chunks of <= max_slots slots at window starts."""
    num_windows = len(pass_off) - 1
    max_blocks = max(1, max_slots // (p * r))
    chunks = []
    ws = 0
    while ws < num_windows:
        we = int(np.searchsorted(pass_off, pass_off[ws] + max_blocks,
                                 side="right")) - 1
        we = max(we, ws + 1)
        chunks.append((int(pass_off[ws]), int(pass_off[we]), ws, int(we)))
        ws = we
    return tuple(chunks)


def _pass_runs(passes: np.ndarray) -> int:
    if len(passes) == 0:
        return 0
    return int(1 + np.count_nonzero(np.diff(passes)))


def _ladder_passes(indptr, n, r, p):
    """The <=48-value pass ladder when it would keep the grouped reduce,
    else None: a nonincreasing envelope of the window pass counts (gated at
    +15% slots), quantized when it has too many distinct values."""
    passes = _window_passes(indptr, n, r, p)
    if (len(np.unique(passes)) <= _MAX_REDUCE_SEGMENTS
            and _pass_runs(passes) <= _MAX_REDUCE_SEGMENTS):
        return None
    mono = np.maximum.accumulate(passes[::-1])[::-1]
    if mono.sum() > 1.15 * passes.sum():
        return None
    if len(np.unique(mono)) > _MAX_REDUCE_SEGMENTS:
        mono = _quantize_passes(mono, _MAX_REDUCE_SEGMENTS)
    return mono


def tile_route(indptr, n, r, p, prefer_native=True):
    """Which tiler lays out these rows, in gcn_tpu's order: ``"ladder"``
    (the numpy layout at the pass ladder, whenever one applies),
    ``"native"`` (the C++ tiler, when ``prefer_native`` and it builds) or
    ``"numpy"``. Returns ``(route, ladder passes or None)``."""
    ladder = _ladder_passes(indptr, n, r, p)
    if ladder is not None:
        return "ladder", ladder
    if prefer_native:
        from gcn_tpu_torch.tile import native

        if native.available():
            return "native", None
    return "numpy", None


def _tile(indptr, indices, data, n, r, p, prefer_native=True):
    """``(cols, vals, win, pass_off, route)`` by ``tile_route``'s route."""
    route, ladder = tile_route(indptr, n, r, p, prefer_native)
    if route == "native":
        from gcn_tpu_torch.tile import native

        cols, vals, win = native.ell_arrays(indptr, indices, data, n, r, p)
        nw = max(1, -(-n // r))
        off = np.searchsorted(win, np.arange(nw + 1)).astype(np.int64)
        return cols, vals, win, off, route
    return (*_ell_arrays(indptr, indices, data, n, r, p,
                         forced_passes=ladder), route)


def _direction(g: CSRGraph, cap: int, hub_split: bool, r: int, p: int,
               chunk_slots: int, span_pass_limit: int, prefer_native: bool):
    """Tile one direction: numpy arrays + metadata."""
    n = g.shape[0]
    split = _split_hub_rows(g.indptr, cap) if hub_split else None
    hub_idx, hub_steps = None, ()
    if split is not None:
        indptr, virt_map, n_hub, n_virt = split
        hub_idx, hub_steps = hub_fold_plan(virt_map)
    else:
        indptr, virt_map, n_hub, n_virt = g.indptr, None, 0, 0
    cols, vals, win, off, route = _tile(
        indptr, g.indices, g.data,
        max(n_virt, n) if split is not None else n, r, p, prefer_native)
    return dict(cols=cols, vals=vals, win=win, tiler=route,
                win_off=_win_offsets(win, len(off) - 1),
                chunks=_chunk_plan(off, p, r, chunk_slots),
                spans=_guard_spans(_span_plan(off), span_pass_limit),
                virt_map=virt_map, n_hub=n_hub, n_virt=n_virt,
                hub_idx=hub_idx, hub_steps=hub_steps)


def ell_adjacency(
    g: CSRGraph,
    *,
    r: int = DEFAULT_R,
    k_pad: int = DEFAULT_K_PAD,
    symmetric: Optional[bool] = None,
    prefer_native: bool = True,
    chunk_slots: int = DEFAULT_CHUNK_SLOTS,
    products_bf16: bool = False,
    table_bf16: bool = False,
    span_pass_limit: Optional[int] = None,
    hub_split: Optional[bool] = None,
    device=None,
) -> EllAdj:
    """Tile a CSR graph into the EllAdj format on ``device``: the card by
    default (``utils.device.resolve_device``), ``device="cpu"`` for the CPU.

    Same arguments and defaults as ``gcn_tpu.tile.ell.ell_adjacency``
    (including the GCN_TPU_SPAN_LIMIT / GCN_TPU_HUB_SPLIT environment
    overrides, so that both packages lay out the same arrays).
    ``prefer_native`` tiles with the C++ tiler (``tile/native.py``) where
    no pass ladder applies and it builds; its arrays equal numpy's.
    ``tiler`` / ``t_tiler`` of the result say which route each direction
    took (``tile_route``).
    """
    assert r % 8 == 0, "row window must be a multiple of 8"
    assert k_pad in (8, 16, 32, 64, 128), "k_pad must divide 128"
    device = resolve_device(device)
    if span_pass_limit is None:
        env = os.environ.get("GCN_TPU_SPAN_LIMIT")
        span_pass_limit = (int(env) if env is not None
                           else max(1, k_pad // 2))
    if chunk_slots == DEFAULT_CHUNK_SLOTS and k_pad > DEFAULT_K_PAD:
        chunk_slots = chunk_slots * DEFAULT_K_PAD // k_pad
    if span_pass_limit <= 0:          # 0 / negative = unlimited (serving)
        span_pass_limit = 1 << 30
    if hub_split is None:
        hub_split = os.environ.get("GCN_TPU_HUB_SPLIT", "1") != "0"
    hub_split = hub_split and span_pass_limit < (1 << 30)
    p = 128 // k_pad
    if symmetric is None:
        symmetric = g.shape[0] == g.shape[1] and g.is_symmetric()
    n, m = g.shape
    cap = span_pass_limit * p
    if g.nnz and (np.asarray(g.data) == 0).any():
        import warnings

        warnings.warn(
            "source CSR stores explicit zero-valued entries; their "
            "edge-weight gradients through spmm_ell are zero (use the coo "
            "path to train adjacency weights through 0.0)")
    fwd = _direction(g, cap, hub_split, r, p, chunk_slots, span_pass_limit,
                     prefer_native)
    bwd = fwd if symmetric else _direction(g.transpose(), cap, hub_split, r,
                                           p, chunk_slots, span_pass_limit,
                                           prefer_native)

    def dev(a):
        return None if a is None else torch.from_numpy(a).to(device)

    keys = ("cols", "vals", "win", "win_off", "virt_map", "hub_idx")
    arrays = {key: dev(fwd[key]) for key in keys}
    t_arrays = arrays if symmetric else {key: dev(bwd[key]) for key in keys}
    split = walk_split(fwd["win_off"], p, device)
    t_split = split if symmetric else walk_split(bwd["win_off"], p, device)
    return EllAdj(
        cols=arrays["cols"], vals=arrays["vals"], win=arrays["win"],
        win_off=arrays["win_off"],
        t_cols=t_arrays["cols"], t_vals=t_arrays["vals"],
        t_win=t_arrays["win"], t_win_off=t_arrays["win_off"],
        n_rows=n, n_cols=m, nnz=g.nnz, r=r, k_pad=k_pad,
        symmetric=bool(symmetric), chunks=fwd["chunks"],
        t_chunks=bwd["chunks"], products_bf16=products_bf16,
        spans=fwd["spans"], t_spans=bwd["spans"], table_bf16=table_bf16,
        span_pass_limit=span_pass_limit,
        virt_map=arrays["virt_map"], t_virt_map=t_arrays["virt_map"],
        n_virt=fwd["n_virt"], n_hub=fwd["n_hub"],
        t_n_virt=bwd["n_virt"], t_n_hub=bwd["n_hub"],
        tiler=fwd["tiler"], t_tiler=bwd["tiler"],
        hub_idx=arrays["hub_idx"], t_hub_idx=t_arrays["hub_idx"],
        hub_steps=fwd["hub_steps"], t_hub_steps=bwd["hub_steps"],
        split=split, t_split=t_split,
    )
