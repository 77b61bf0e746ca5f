"""Small helpers of the port: the part of the reference's
``jepsen_tpu/util.py`` that its checkers need."""

from __future__ import annotations

from typing import Iterable


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """Compact ``#{1-3 5}`` rendering of an integer set (util.clj:549)."""
    xs = sorted(set(xs))
    if not xs:
        return "#{}"
    parts = []
    lo = prev = xs[0]
    for x in xs[1:]:
        if x == prev + 1:
            prev = x
            continue
        parts.append(f"{lo}" if lo == prev else f"{lo}-{prev}")
        lo = prev = x
    parts.append(f"{lo}" if lo == prev else f"{lo}-{prev}")
    return "#{" + " ".join(parts) + "}"
