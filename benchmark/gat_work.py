"""The work of the GAT cell, counted from sizes only (rows n, edges with
self loops E, each layer's heads H and width F), never from how the
program lays the graph out: the yardstick of ``gat_attn_roofline_pct``
and ``gat_step_mfu_pct``. Peaks are ``work.py``'s (the H100 SXM data
sheet's 3.35 TB/s and 67 TFLOP/s of float32).

The shapes are read off the leaves' (name, in, out) as the program lists
them: ``gat<l>`` (in, H x F), ``att<l>`` (F, 2 x H), ``res<l>`` where the
layer has the skip.
"""

from __future__ import annotations

from benchmark import work

CALLS = ("forward", "eval", "backward")


def layer_shapes(layers) -> list:
    """[(in, H, F, skip)] a layer, in order."""
    by = {name: (n_in, n_out) for name, n_in, n_out in layers}
    out, l = [], 1
    while f"gat{l}" in by:
        width, two_heads = by[f"att{l}"]
        out.append((by[f"gat{l}"][0], two_heads // 2, width,
                    f"res{l}" in by))
        l += 1
    return out


def attention_work(n: int, nnz: int, heads: int, width: int, call: str):
    """(bytes, flops) of one attention call at (H, F), each operand read
    once and each result written once: the graph (a 4-byte column an
    edge and the row offsets), wh (n x H x F floats), the scores el and er
    (n x H each) read and out written forward, with the rows' logsumexp
    (n x H) kept for the backward by a training forward but not by an
    evaluation one; the backward reads the graph, wh, out, dout, el, er and
    the logsumexp and writes dwh, d_el and d_er. 2 flops a gathered float
    forward (weigh and add), 4 backward (the dot with dout and alpha dout
    added)."""
    graph = 4 * nnz + 4 * (n + 1)
    dense, scores = 4 * n * heads * width, 4 * n * heads
    edge_floats = nnz * heads * width
    if call == "forward":
        return graph + 2 * dense + 3 * scores, 2 * edge_floats
    if call == "eval":
        return graph + 2 * dense + 2 * scores, 2 * edge_floats
    if call == "backward":
        return graph + 4 * dense + 6 * scores, 4 * edge_floats
    raise ValueError(f"unknown call {call!r}")


def fit_attention_bound_s(n: int, nnz: int, layers, iters: int) -> float:
    """The least time of a whole fit's attention: each layer's training
    forward, evaluation forward and backward every iteration, and the
    evaluation forward of the fit's end, at the larger of the bytes and
    the flops bound of each call."""
    total = 0.0
    for _, heads, width, _ in layer_shapes(layers):
        per = {call: work.bound_s(*attention_work(n, nnz, heads, width,
                                                  call))
               for call in CALLS}
        total += iters * sum(per.values()) + per["eval"]
    return total


def iteration_flops(n: int, nnz: int, layers) -> int:
    """Matrix-product flops of one training iteration, the evaluation
    forward included (the job's mode ``val``):

      forward, a layer: h W 2n in HF, the scores Wh . a 4nHF, the
        attention's weighted sums 2E HF, the skip h W_res 2n in HF;
      backward: the products' dW and, past the first layer (whose input
        needs no gradient), dh: 2n in HF each; the scores 8nHF; the
        attention 4E HF (dwh and the dots with dout); the skip as h W.

    Element-wise work (biases, LeakyReLU, exp, ELU, softmax, the optimizer)
    is left out."""
    fwd = bwd = 0
    for l, (n_in, heads, width, skip) in enumerate(layer_shapes(layers)):
        hf = heads * width
        proj, score, agg = 2 * n * n_in * hf, 4 * n * hf, 2 * nnz * hf
        grads = 1 if l == 0 else 2
        fwd += proj + score + agg + (proj if skip else 0)
        bwd += grads * proj + 2 * score + 2 * agg + (grads * proj if skip
                                                      else 0)
    return 2 * fwd + bwd
