"""fit_finish_pct: the median over the window's fits of the program's
``fit.finish`` span (the host reads after the loop, the generator's
state, the snapshots, the final evaluation) over its ``fit`` span, in %
(``spans.median_share``)."""

from benchmark import spans


def read(rec):
    return spans.median_share(rec.get("program_spans"), ("fit.finish",))
