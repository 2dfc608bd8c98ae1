"""The work of the DeeperGCN cell, counted from sizes only (rows n, edges
with self loops E, the hidden width k, the layers), never from how the
program lays the graph out: the yardstick of ``softmax_agg_roofline_pct``
and ``deepergcn_step_mfu_pct``. Peaks are ``work.py``'s (the H100 SXM
data sheet's 3.35 TB/s and 67 TFLOP/s of float32).

The shapes are read off the leaves' (name, in, out) as the program lists
them: ``enc`` (features, k), ``conv<l>`` (k, k) a GENConv layer, ``norm<l>``
(1, k), ``out`` (k, classes).
"""

from __future__ import annotations

from benchmark import work

CALLS = ("forward", "eval", "backward")


def shapes(layers) -> dict:
    """{"features", "hidden", "classes", "convs"} of the leaves."""
    by = {name: (n_in, n_out) for name, n_in, n_out in layers}
    convs = sum(1 for name in by if name.startswith("conv"))
    return {"features": by["enc"][0], "hidden": by["enc"][1],
            "classes": by["out"][1], "convs": convs}


def aggregation_work(n: int, nnz: int, k: int, call: str):
    """(bytes, flops) of one softmax aggregation call at width k, each
    operand read once and each result written once: the graph (a 4-byte
    column an edge and the row offsets) and m (n x k floats) read, a
    written, with the rows' logsumexp (n x k) kept by a training forward
    but not by an evaluation one; the backward reads the graph, m, the
    logsumexp and da and writes dm. 4 flops a gathered element forward
    (the logit, its exponent, the weighted sum's and the normaliser's
    adds) and backward (the exponent, its exp's product with da, the
    add)."""
    graph = 4 * nnz + 4 * (n + 1)
    dense = 4 * n * k
    flops = 4 * nnz * k
    if call == "forward":
        return graph + 3 * dense, flops
    if call == "eval":
        return graph + 2 * dense, flops
    if call == "backward":
        return graph + 4 * dense, flops
    raise ValueError(f"unknown call {call!r}")


def fit_aggregation_bound_s(n: int, nnz: int, layers, iters: int) -> float:
    """The least time of a whole fit's aggregation: each GENConv layer's
    training forward, evaluation forward and backward every iteration, and
    the evaluation forward of the fit's end, at the larger of the bytes
    and the flops bound of each call."""
    s = shapes(layers)
    per = {call: work.bound_s(*aggregation_work(n, nnz, s["hidden"], call))
           for call in CALLS}
    return s["convs"] * (iters * sum(per.values()) + per["eval"])


def iteration_flops(n: int, nnz: int, layers) -> int:
    """Matrix-product flops of one training iteration, the evaluation
    forward included (the job's mode ``val``):

      forward: the encoder x W 2n f k, each GENConv's (h + a) W 2n k k,
        the head 2n k c;
      backward: each product's dW, and dh for all but the encoder (whose
        input needs no gradient): 2n in out each.

    The aggregation, batch norm, dropout, the softmax and the optimizer
    are left out: they are not matrix products."""
    s = shapes(layers)
    n_in, k, c = s["features"], s["hidden"], s["classes"]
    enc, conv, head = 2 * n * n_in * k, 2 * n * k * k, 2 * n * k * c
    fwd = enc + s["convs"] * conv + head
    bwd = enc + 2 * s["convs"] * conv + 2 * head
    return 2 * fwd + bwd
