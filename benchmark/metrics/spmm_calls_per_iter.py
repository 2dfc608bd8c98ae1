"""spmm_calls_per_iter: the SpMM's host calls in one captured iteration,
the program's ``spmm_*`` counters (K1, K2 or the COO product; not the
per-width counts) over the window fits' ``loop.capture`` spans, over
their number (``spans.calls_per_iter``)."""

from benchmark import spans


def read(rec):
    return spans.calls_per_iter(rec.get("program_spans"))
