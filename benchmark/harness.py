"""One run of one cell: set-up, the first steps, the measured window, the
comparison with the plain reference, and the result line.

Everything that belongs to one configuration, job, family or metric is
found by name: ``configs/<config>.json``, ``jobs/<traffic>.json``,
``limits/<workload>.json``, the input generator ``inputs/<generator>.py``,
the program's side ``families/<family>.py`` and its plain reference
``reference/<family>.py``, and each metric's reader
``metrics/<metric>.py`` (dots and dashes in a name read as ``_``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import os
import random
import statistics
import sys
import time
from typing import List, Optional

import torch

from benchmark.weights import derived_seed, init_params, leaves

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N_STEPS = 3                  # the first steps the reference follows
PROBE = 2 ** 20              # the fit index of the first-steps probe
PROFILED = 2 ** 20 + 1       # the fit index of the traced fit
COMPARED = ("loss", "grad", "grad_in", "update")
LATE = ("late_loss", "late_update")   # where a config has late_steps_from
OUTPUT_LEAVES = 2            # the last layer's W and b
FORBIDDEN = ("jax", "jaxlib", "flax", "gcn_tpu")
_T_IMPORT = time.perf_counter()


@dataclasses.dataclass
class Fit:
    """What the harness keeps of one fit."""

    iters: int
    losses: List[float]
    wall_s: float
    replay_s: float
    loop_s: float = 0.0               # the captured loop (the fit_scan timer)
    exp_avg: Optional[list] = None    # Adam's first moments, leaf by leaf
    final: Optional[list] = None      # the last iterate's leaves
    index: int = -1


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    job: dict
    limits: Optional[dict]
    end_to_end: list
    per_layer: list


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; the import of this
    module where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


class Spans:
    """Host-clock spans of set-up, by name (s)."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name: str, device=None):
        return _Span(self, name, device)


class _Span:
    def __init__(self, spans, name, device):
        self.spans, self.name, self.device = spans, name, device

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and torch.device(
                self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        self.spans.seconds[self.name] = (
            self.spans.seconds.get(self.name, 0.0)
            + time.perf_counter() - self.t0)
        return False


def _read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` under ``root``, with its
    configuration, job and limits; raises if any is missing."""
    bench = _read_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(root, cfg_entry["file"])
    job = _read_json(HERE, "jobs", f"{w['traffic']}.json")
    if job["family"] != config["family"]:
        raise ValueError(f"job {w['traffic']!r} drives {job['family']}, "
                         f"configuration {w['config']!r} is "
                         f"{config['family']}")
    limits_path = os.path.join(HERE, "limits", f"{workload}.json")
    limits = (_read_json(limits_path) if os.path.exists(limits_path)
              else None)

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(name=workload, chips=int(w["chips"]), config=config,
                job=job, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def _module(kind: str, name: str):
    return importlib.import_module(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}")


def make_inputs(config: dict) -> dict:
    spec = config["inputs"]
    return _module("inputs", spec["generator"]).make(**spec["params"])


def program_class(config: dict):
    return _module("families", config["family"]).Program


def reference_class(config: dict):
    return _module("reference", config["family"]).Problem


@dataclasses.dataclass
class Side:
    """The numbers one side gives for the comparison: a window fit's first
    training losses, the gradient the optimizer took at step 1 of the
    probe, the probe's parameter change after its first steps, and, where
    the configuration asks for it (``late_steps_from`` L), the probe's
    losses at steps L to L + N_STEPS - 1 and its parameter change over
    them."""

    fit_losses: List[float]
    grad1: list
    delta: list
    late_losses: Optional[List[float]] = None
    late_delta: Optional[list] = None


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().to(torch.float64)))


def worst_leaf(prog: list, ref: list, keep=None) -> float:
    """The largest gap between the two sides' norms of a leaf, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; ``keep`` selects the leaves compared. A missing leaf on the
    program's side counts as zero; a non-finite one reads inf."""
    ref_n = [_norm(r) for r in ref]
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    median = statistics.median(ref_n[i] for i in idx)
    worst = 0.0
    for i in idx:
        p = 0.0 if prog[i] is None else _norm(prog[i])
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, abs(p - ref_n[i]) / max(ref_n[i], median))
    return worst


def worst_loss(prog: List[float], ref: List[float]) -> float:
    """The largest relative gap of a step's loss; inf where the program
    gave fewer steps or a non-finite loss."""
    if len(prog) < len(ref):
        return math.inf
    return max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
               for p, r in zip(prog, ref))


def compare(prog: Side, ref: Side) -> dict:
    """The compared numbers, program against reference.

    ``grad`` is taken over the output layer's leaves (the last
    ``OUTPUT_LEAVES``), ``grad_in`` over the first layer's. No relu gate
    lies between the output layer and the loss; before the first layer
    one does, and a gate whose pre-activation float32 cannot tell from
    zero opens on one side and not the other on some seeds (up to ~2e-6 of
    the norm, PERF.md), so ``grad_in`` has a limit of its own, set above
    those flips: it holds the first layer's backward, which Adam's
    nearly scale-free step hides from ``update``. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone under Adam, and are left out of both changes' comparison."""
    g_norms = [_norm(g) for g in ref.grad1]
    floor = 1e-3 * statistics.median(g_norms)
    out, first = slice(-OUTPUT_LEAVES, None), slice(None, -OUTPUT_LEAVES)
    keep = [g >= floor for g in g_norms]
    readings = {"loss": worst_loss(prog.fit_losses, ref.fit_losses),
                "grad": worst_leaf(prog.grad1[out], ref.grad1[out]),
                "grad_in": worst_leaf(prog.grad1[first], ref.grad1[first]),
                "update": worst_leaf(prog.delta, ref.delta, keep=keep),
                "update_leaves": sum(keep)}
    if ref.late_losses is not None:
        readings["late_loss"] = (
            math.inf if prog.late_losses is None
            else worst_loss(prog.late_losses, ref.late_losses))
        readings["late_update"] = (
            math.inf if prog.late_delta is None
            else worst_leaf(prog.late_delta, ref.late_delta, keep=keep))
    return readings


def _change(after: list, before: list) -> list:
    return [a.to(torch.float64) - b.to(torch.float64)
            for a, b in zip(after, before)]


@dataclasses.dataclass
class Probe:
    """The program's fits from the probe's parameters and dropout stream:
    1 and N_STEPS iterations, and where asked L and L + N_STEPS."""

    p0: dict
    first: Fit
    third: Fit
    late: Optional[List[Fit]] = None


def fit_from_seed(prog, seed: int, index: int, iters: int, device):
    """Fit ``index`` of run ``seed``: fresh parameters and a dropout stream
    drawn from both; returns the parameters and the fit."""
    p0 = init_params(prog.layers, derived_seed(seed, index, 0), device)
    out = prog.fit(p0, derived_seed(seed, index, 1), iters)
    out.index = index
    return p0, out


def first_steps(prog, seed: int, device) -> Probe:
    p0, first = fit_from_seed(prog, seed, PROBE, 1, device)
    third = fit_from_seed(prog, seed, PROBE, N_STEPS, device)[1]
    return Probe(p0=p0, first=first, third=third)


def late_steps(prog, probe: Probe, seed: int, late_from: int, device):
    """The probe again, stopped after ``late_from`` and after ``late_from``
    + N_STEPS iterations."""
    probe.late = [fit_from_seed(prog, seed, PROBE, n, device)[1]
                  for n in (late_from, late_from + N_STEPS)]


def program_side(probe: Probe, fit: Fit, beta1: float) -> Side:
    """Adam's first moment after one step is (1 - beta1) times the
    gradient it was handed."""
    grad1 = [None if m is None else m / (1.0 - beta1)
             for m in probe.first.exp_avg]
    side = Side(fit_losses=fit.losses[:N_STEPS], grad1=grad1,
                delta=_change(probe.third.final, leaves(probe.p0)))
    if probe.late is not None:
        before, after = probe.late
        side.late_losses = after.losses[before.iters:]
        side.late_delta = _change(after.final, before.final)
    return side


def compared_names(cfg: dict) -> tuple:
    """The numbers compared in a cell of configuration ``cfg``."""
    return COMPARED + (LATE if cfg.get("late_steps_from") else ())


def free_device_memory():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda") -> dict:
    """One run of ``cell``; returns the record every metric reads."""
    device = torch.device(device)
    cfg, job = cell.config, cell.job
    rec = {"device": device, "seed": seed,
           "setup_parts": {"before_inputs": process_age_s()}}
    t = time.perf_counter()
    data = make_inputs(cfg)
    rec["setup_parts"]["inputs"] = time.perf_counter() - t
    spans = Spans()
    prog = program_class(cfg)(cfg, job, data, device, spans)
    rec["prep_spans"] = dict(spans.seconds)
    iters = int(cfg[job["fit_length_key"]])
    late_from = cfg.get("late_steps_from")

    # set-up drives the fit from the seed through its first steps, then
    # warms up a whole fit
    t = time.perf_counter()
    probe = first_steps(prog, seed, device)
    rec["setup_parts"]["first_steps"] = time.perf_counter() - t
    rec["setup_parts"]["warmup_fit"] = fit_from_seed(
        prog, seed, 0, iters, device)[1].wall_s
    rec["setup_s"] = process_age_s()

    fits, index = [], 1
    t0 = time.perf_counter()
    while True:
        out = fit_from_seed(prog, seed, index, iters, device)[1]
        out.exp_avg = out.final = None
        fits.append(out)
        index += 1
        if time.perf_counter() - t0 >= seconds:
            break
    rec["window_s"] = time.perf_counter() - t0
    rec["fits"] = fits
    rec["window_iters"] = sum(f.iters for f in fits)
    if device.type == "cuda":
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if trace and device.type == "cuda":
        # one more whole fit, after the window so that the profiler's cost
        # stays out of it
        from benchmark import trace as tracing

        rec["profile"] = tracing.profile(
            lambda: fit_from_seed(prog, seed, PROFILED, iters, device))
    rec["work"] = {"n": prog.n, "nnz": prog.nnz, "layers": prog.layers,
                   "spmm_widths": prog.spmm_widths}
    if trace and device.type == "cuda":
        from benchmark import spmm_time

        rec["spmm"] = spmm_time.measure(prog.adj, prog.n, prog.nnz,
                                        prog.spmm_widths, device)
    if late_from is not None:
        late_steps(prog, probe, seed, late_from, device)

    # the reference follows the probe and a window fit drawn from the seed
    sampled = fits[random.Random(seed).randrange(len(fits))]
    prog_side = program_side(probe, sampled, cfg["adam_betas"][0])
    perm, layers, p_probe = prog.perm, prog.layers, probe.p0
    del prog, probe
    free_device_memory()
    t = time.perf_counter()
    problem = reference_class(cfg)(cfg, data, device, "float64")
    ref = reference_side_for(problem, seed, sampled.index, p_probe, perm,
                             layers, late_from)
    rec["reference_s"] = time.perf_counter() - t
    rec["readings"] = compare(prog_side, ref)
    rec["sampled_fit"] = sampled.index
    return rec


def reference_side_for(problem, seed: int, index: int, p_probe: dict,
                       perm, layers, late_from=None) -> Side:
    """A reference ``problem`` over the first steps of the probe (and its
    steps from ``late_from`` on, where given) and of window fit ``index``
    of run ``seed``."""
    p_probe = leaves(p_probe)
    n_steps = N_STEPS if late_from is None else late_from + N_STEPS
    at = {N_STEPS} | ({late_from} if late_from is not None else set())
    probe = problem.steps(p_probe, derived_seed(seed, PROBE, 1), n_steps,
                          perm, at=at)
    p_fit = leaves(init_params(layers, derived_seed(seed, index, 0),
                               problem.device))
    fit = problem.steps(p_fit, derived_seed(seed, index, 1), N_STEPS, perm)
    side = Side(fit_losses=fit.losses, grad1=probe.grad1,
                delta=_change(probe.at[N_STEPS], p_probe))
    if late_from is not None:
        side.late_losses = probe.losses[late_from:]
        side.late_delta = _change(probe.params, probe.at[late_from])
    return side


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run must not hold,
    compared whole (``gcn_tpu_torch`` is not ``gcn_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
