"""prep_s: the program's host preparation in set-up (normalize, reorder,
tiling or H and G, upload, the layer-1 hoist), the sum of the harness's
spans around those calls (host clock)."""


def read(rec):
    spans = rec.get("prep_spans")
    return sum(spans.values()) if spans else None
