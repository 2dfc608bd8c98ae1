"""fit_prepare_pct: the median over the window's fits of the program's
``fit.prepare`` span (entry to the first iteration: the parameters'
copies, the optimizer, the loop's buffers; in HGNN the inputs' upload and
the G X hoist) over its ``fit`` span, in % (``spans.median_share``)."""

from benchmark import spans


def read(rec):
    return spans.median_share(rec.get("program_spans"), ("fit.prepare",))
