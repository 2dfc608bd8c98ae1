"""deepergcn_step_mfu_pct: the matrix-product flops of one DeeperGCN
training iteration with its evaluation forward
(``deepergcn_work.iteration_flops`` from the configuration's shapes) over
the window's time an iteration times the H100's float32 peak, in %."""

from benchmark import deepergcn_work, work


def read(rec):
    shape = rec.get("work")
    if not shape or not rec.get("window_iters"):
        return None
    flops = deepergcn_work.iteration_flops(shape["n"], shape["nnz"],
                                           shape["layers"])
    step_s = rec["window_s"] / rec["window_iters"]
    return 100.0 * flops / (step_s * work.F32_FLOPS_PER_S)
