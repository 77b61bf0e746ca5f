"""Adya G2 predicate-based anti-dependency workload.

The port of the checker half of the reference's
``jepsen_tpu/workloads/adya.py``, which mirrors jepsen.tests.adya
(jepsen/src/jepsen/tests/adya.clj): per key, two concurrent txns each try
a predicate read + insert; under serializability at most one insert per
key may succeed (adya.clj:12-59 documents the client contract). The checker counts ok inserts per key
(adya.clj:61-87).

``g2_gen`` and ``g2`` run tests rather than check them; they raise
``ValueError`` naming the slice that brings them (the test runner).
"""

from __future__ import annotations

from typing import Optional

from .. import independent
from ..checker import Checker, checker_fn
from . import RUNNER_SLICE


def g2_gen():
    raise ValueError(RUNNER_SLICE)


def g2_checker() -> Checker:
    """At most one ok insert per key (adya.clj:61-87)."""

    def chk(test, history, opts):
        keys: dict = {}
        for op in history:
            if op.f != "insert":
                continue
            v = op.value
            if not independent.is_tuple(v) and not (
                isinstance(v, (list, tuple)) and len(v) == 2
            ):
                continue
            k = v[0] if independent.is_tuple(v) else None
            if k is None:
                continue
            keys.setdefault(k, 0)
            if op.is_ok:
                keys[k] += 1
        insert_count = sum(1 for c in keys.values() if c > 0)
        illegal = {k: c for k, c in sorted(keys.items()) if c > 1}
        return {
            "valid": not illegal,
            "key_count": len(keys),
            "legal_count": insert_count - len(illegal),
            "illegal_count": len(illegal),
            "illegal": illegal,
        }

    return checker_fn(chk, "adya-g2")


def g2(opts: Optional[dict] = None) -> dict:
    raise ValueError(RUNNER_SLICE)
