"""step_mfu_pct: the matrix-product flops of one training iteration
(``work.two_layer_iteration_flops`` from the configuration's shapes and
stored edges) over the window's time an iteration times the H100's
float32 peak, in %."""

from benchmark import work


def read(rec):
    shape = rec.get("work")
    if not shape or not rec.get("window_iters"):
        return None
    (_, f, h), (_, _, c) = shape["layers"]
    flops = work.two_layer_iteration_flops(shape["n"], f, h, c,
                                           shape["nnz"])
    step_s = rec["window_s"] / rec["window_iters"]
    return 100.0 * flops / (step_s * work.F32_FLOPS_PER_S)
