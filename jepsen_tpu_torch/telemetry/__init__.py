"""Telemetry of the port's drivers and checker: the metrics
:class:`Registry` that ``metrics=`` takes (``ops.wgl.check_encoded_device``,
``ops.wgl_c.check_encoded_native``, ``parallel.frontier.check_encoded_sharded``,
``parallel.batch.check_encoded_batch``, the Elle engine and its front
doors), the :class:`Heartbeat` progress callback, and the test map's
gate. A copy of the reference's ``jepsen_tpu/telemetry``: the registry
with ``timed_phase`` (``core.run``'s ``run_phase_seconds``), the
heartbeat, the flight recorder, the metric sinks ``store_metrics`` writes
(``metrics.jsonl``, ``metrics.prom``), the roofline attribution, device
trace and memory watermarks of :mod:`.profile` (``profile.json``), the
busy timelines of :mod:`.utilization`, the run records and the trend and
gate of :mod:`.ledger`, the alerting plane of :mod:`.alerts` (imported
only where an alert option is set), the backend's scrape payload of
:mod:`.fleet`, and :func:`of_test`. The rest of the fleet's federation
comes with the scale-out router.

Everything hangs off ``test["telemetry?"]``: :func:`of_test` returns the
test's registry, made on first ask and kept under
``test["telemetry-registry"]``, or None when telemetry is off, and every
instrumentation site guards on that None."""

from __future__ import annotations

import threading as _threading
from typing import Optional

from . import flight, profile  # noqa: F401
from .export import (export_jsonl, export_prometheus, jsonl_lines,  # noqa: F401
                     prometheus_text, store_metrics)
from .flight import FlightRecorder, store_flight_record  # noqa: F401
from .heartbeat import Heartbeat  # noqa: F401
from .profile import attribute, memory_watermarks, store_profile, trace_capture  # noqa: F401
from .registry import (DECISION_LATENCY_BUCKETS, DEFAULT_BUCKETS, Counter,  # noqa: F401
                       Gauge, Histogram, Registry, bucket_quantile, timed_phase)

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


__all__ = ["Counter", "DECISION_LATENCY_BUCKETS", "DEFAULT_BUCKETS", "FlightRecorder",
           "Gauge", "Heartbeat", "Histogram", "Registry", "attribute", "bucket_quantile",
           "enabled", "export_jsonl", "export_prometheus", "flight", "jsonl_lines",
           "memory_watermarks", "of_test", "profile", "prometheus_text",
           "store_flight_record", "store_metrics", "store_profile", "timed_phase",
           "trace_capture"]
