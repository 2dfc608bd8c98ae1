"""loop_start_pct: the median over the window's fits of the program's
``loop.warmup`` and ``loop.capture`` spans (the eager iterations before
the capture, and the capture) over its ``fit`` span, in %
(``spans.median_share``)."""

from benchmark import spans


def read(rec):
    return spans.median_share(rec.get("program_spans"),
                              ("loop.warmup", "loop.capture"))
