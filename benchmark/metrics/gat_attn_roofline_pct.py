"""gat_attn_roofline_pct: the least time of one traced whole fit's
attention work (``gat_work.fit_attention_bound_s``: each layer's training
forward, evaluation forward and backward every iteration and the fit's
final evaluation forward, at 3.35 TB/s or 67 TFLOP/s) over the device
time of the traced fit's operations whose names hold ``gat_attn`` (the
kernels of ``ops/csrc/gat_attn.cu``, from torch.profiler's top
operations), in %. ``trace.read`` keeps the top 10 operations only: a
kernel of the attention outside them (the backward's row passes,
``gat_attn_rows``, at ``gat-arxiv.full``) leaves its time out, so the
share is then an upper estimate."""

from benchmark import gat_work


def read(rec):
    prof, shape, fits = rec.get("profile"), rec.get("work"), rec.get("fits")
    if not prof or not shape or not fits:
        return None
    busy = sum(s for name, s in prof["device_ops"] if "gat_attn" in name)
    if not busy:
        return None
    bound = gat_work.fit_attention_bound_s(shape["n"], shape["nnz"],
                                           shape["layers"], fits[0].iters)
    return 100.0 * bound / busy
