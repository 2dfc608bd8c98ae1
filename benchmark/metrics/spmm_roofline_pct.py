"""spmm_roofline_pct: the least time the SpMM's work needs on the H100
(``work.csr_spmm_work`` at 3.35 TB/s or 67 TFLOP/s, forward and
transpose at each width the step uses), over the device time of the
port's ``spmm`` doing it (``spmm_time.measure``), in %."""


def read(rec):
    rows = rec.get("spmm")
    if not rows:
        return None
    return 100.0 * sum(r["bound_s"] for r in rows) / sum(
        r["time_s"] for r in rows)
