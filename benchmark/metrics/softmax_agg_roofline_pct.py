"""softmax_agg_roofline_pct: the least time of one traced whole fit's
softmax aggregation work (``deepergcn_work.fit_aggregation_bound_s``:
each GENConv layer's training forward, evaluation forward and backward
every iteration and the fit's final evaluation forward, at 3.35 TB/s or
67 TFLOP/s) over the device time of the traced fit's operations whose
names hold ``softmax_agg`` (the kernels of ``ops/csrc/softmax_agg.cu``,
from torch.profiler's top operations), in %. Both kernels, the forward
(training and evaluation alike) and the backward walk, are among the
fit's longest operations, so ``trace.read``'s top 10 hold their whole
time. None where the run traced no such kernel."""

from benchmark import deepergcn_work


def read(rec):
    prof, shape, fits = rec.get("profile"), rec.get("work"), rec.get("fits")
    if not prof or not shape or not fits:
        return None
    busy = sum(s for name, s in prof["device_ops"] if "softmax_agg" in name)
    if not busy:
        return None
    bound = deepergcn_work.fit_aggregation_bound_s(
        shape["n"], shape["nnz"], shape["layers"], fits[0].iters)
    return 100.0 * bound / busy
