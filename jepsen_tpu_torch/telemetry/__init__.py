"""Telemetry of the port's drivers and checker: the metrics
:class:`Registry` that ``metrics=`` takes (``ops.wgl.check_encoded_device``,
``ops.wgl_c.check_encoded_native``, ``parallel.frontier.check_encoded_sharded``,
``parallel.batch.check_encoded_batch``, the Elle engine and its front
doors), the :class:`Heartbeat` progress callback, and the test map's
gate. A trimmed copy of the reference's ``jepsen_tpu/telemetry``: the
registry, the heartbeat and :func:`of_test`; the sinks and readers stay in
the reference, and its readers take a port run's registry unchanged.

Everything hangs off ``test["telemetry?"]``: :func:`of_test` returns the
test's registry, made on first ask and kept under
``test["telemetry-registry"]``, or None when telemetry is off, and every
instrumentation site guards on that None."""

from __future__ import annotations

import threading as _threading
from typing import Optional

from .heartbeat import Heartbeat  # noqa: F401
from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,  # noqa: F401
                       Registry, bucket_quantile)

_of_test_lock = _threading.Lock()


def enabled(test: Optional[dict]) -> bool:
    """Is telemetry requested on this test map?"""
    return bool(test and test.get("telemetry?"))


def of_test(test: Optional[dict]) -> Optional[Registry]:
    """The test's registry, made on first ask, or None when telemetry is
    off. Made under a lock: composed checkers ask from parallel threads,
    and two registries would split the series."""
    if not enabled(test):
        return None
    reg = test.get("telemetry-registry")
    if reg is None:
        with _of_test_lock:
            reg = test.get("telemetry-registry")
            if reg is None:
                reg = test["telemetry-registry"] = Registry()
    return reg


__all__ = ["Counter", "DEFAULT_BUCKETS", "Gauge", "Heartbeat", "Histogram", "Registry",
           "bucket_quantile", "enabled", "of_test"]
