"""step_ms: the window's wall time, from its start to the end of its last
whole fit, over the training iterations of those fits (host clock)."""


def read(rec):
    if not rec.get("window_iters"):
        return None
    return rec["window_s"] * 1e3 / rec["window_iters"]
