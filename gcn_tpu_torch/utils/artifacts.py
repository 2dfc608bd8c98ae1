"""Measurement artifacts that refuse physically impossible values.

The port's copy of ``gcn_tpu.utils.artifacts`` (the same schema checks).
A harness that writes a JSON result goes through :func:`write_artifact`,
which

* rejects negative values for any key that names a duration, rate or size
  (``*_ms``, ``*_s``, ``*_ns``, ``*_us``, ``*_per_s``, ``*_rows``,
  ``*_bytes``, ``*_slots``, ``*_iters``, ``*_edges``),
* rejects efficiencies and fractions outside [0, 1 + eps] (``eff*``,
  ``*_frac``, ``*_fraction``) and percentages outside [0, 100] (``*pct``),
* rejects NaN,
* stamps the writing harness and a schema tag under ``_meta``.

Keys where a negative or out-of-range value is expected (a signed delta)
are exempted with ``allow``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterable, Optional

_NONNEG_SUFFIXES = ("_ms", "_s", "_ns", "_us", "_per_s", "_rows", "_bytes",
                    "_slots", "_iters", "_edges")
# unit-interval keys; word stems such as "effective_gbps" must not match
_UNIT_FRACTION = re.compile(
    r"^(eff(_\w+)?|\w*efficiency|\w*_frac(tion)?|frac(tion)?)$")
_PCT = re.compile(r"(^|_)\w*pct$")
_EPS = 1e-6


class ArtifactError(ValueError):
    """A harness tried to write a physically impossible measurement."""


def _walk(obj, path=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _walk(v, f"{path}.{k}" if path else str(k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, obj


def _key_leaf(path: str) -> str:
    """Last non-numeric key segment: the values of a dict keyed by a number
    ("eff.0.5") are judged by the dict's name."""
    for seg in reversed(path.split(".")):
        seg = re.sub(r"\[\d+\]$", "", seg)
        if seg and not re.fullmatch(r"\d+", seg):
            return seg
    return path


def validate_artifact(obj, allow: Iterable[str] = ()) -> list:
    """Return a list of (path, value, reason) violations; [] when clean."""
    allow = set(allow)
    bad = []
    for path, v in _walk(obj):
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        leaf = _key_leaf(path).lower()
        if leaf in allow or any(a in path for a in allow):
            continue
        if v != v:  # NaN
            bad.append((path, v, "NaN"))
            continue
        if leaf.endswith(_NONNEG_SUFFIXES) and v < 0:
            bad.append((path, v, "negative duration/size"))
        elif _UNIT_FRACTION.search(leaf) and not (-_EPS <= v <= 1 + _EPS):
            bad.append((path, v, "fraction outside [0,1]"))
        elif _PCT.search(leaf) and not (-_EPS <= v <= 100 + _EPS):
            bad.append((path, v, "percentage outside [0,100]"))
    return bad


def write_artifact(path: str, obj: dict, *, harness: str, schema: str,
                   allow: Iterable[str] = (),
                   extra_meta: Optional[dict] = None) -> dict:
    """Validate ``obj``, stamp provenance, and write it as JSON.

    Raises :class:`ArtifactError` listing every violation instead of
    writing a nonsensical value.
    """
    bad = validate_artifact(obj, allow=allow)
    if bad:
        lines = "\n".join(f"  {p} = {v!r}: {r}" for p, v, r in bad)
        raise ArtifactError(
            f"refusing to write {path}: {len(bad)} impossible value(s)\n"
            f"{lines}\n(pass allow=[...] only for keys where the sign is "
            f"semantically meaningful)")
    meta = {"harness": harness, "schema": schema}
    if extra_meta:
        meta.update(extra_meta)
    out = {"_meta": meta}
    out.update(obj)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out
