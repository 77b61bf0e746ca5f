"""Device-dispatch resilience: bounded retries and per-path circuit
breakers, the port of the reference's ``jepsen_tpu/parallel/resilience.py``.

One runtime error on the card (an out-of-memory, a failed launch, an
injected fault) would otherwise propagate out of the batched search and
fold a whole scheduler round unknown. This layer sits between "the device
failed" and "the verdict degraded":

- :func:`call` runs a device thunk with BOUNDED retries and exponential
  backoff for *transient* errors. A deterministic error (a failed kernel
  build, a ``ValueError`` from a plan, a ``TypeError``) is never retried:
  it would fail the same way each time.
- :class:`CircuitBreaker`: after ``failure_threshold`` consecutive
  transient failures the breaker OPENS, callers stop dispatching to the
  device path (the scheduler demotes its rounds to the host oracle) until
  ``cooldown_s`` has passed, and then ONE half-open probe goes through;
  its success closes the breaker, its failure opens it again.

A retry re-runs a deterministic function (the same verdict, or a fresh
failure), and a failover re-decides members on the host oracle: no
verdict is made up, and a member nobody could decide folds unknown.

``JEPSEN_NO_FAILOVER=1`` is the kill switch and wins everywhere: retries,
breakers and failovers all turn off, and errors propagate.

Telemetry: ``wgl_retry_total{reason}`` (every retried attempt),
``circuit_state{device}`` (0 closed, 1 half-open, 2 open) and
``circuit_transitions_total{device,state}``; the scheduler adds
``service_failovers_total{engine}`` when it demotes a round.
"""

from __future__ import annotations

import logging
import os
import threading
import time as _time
from typing import Callable, Optional

LOG = logging.getLogger("jepsen.resilience")

# Substrings of transient runtime failures: the reference's gRPC-style
# status prefixes and out-of-memory texts, and "CUDA error", which starts
# the text of torch's runtime error on the card (torch.AcceleratorError,
# "CUDA error: ...", torch 2.11 on an H100) and of the port's own kernel
# launch failures (ops/wgl_level.py, elle/ops.py: "<kernel>: CUDA error
# <code> (...)"). A sticky error (an illegal address leaves the context
# unusable) counts as transient too, as INTERNAL does in the reference:
# its retries fail at once, the breaker opens and the scheduler fails the
# round over to the host oracle.
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "INTERNAL",
    "out of memory",
    "Out of memory",
    "CUDA error",
)

# Exception type names treated as transient, matched by name so that this
# module imports neither torch nor the chaos harness: the reference's
# XlaRuntimeError, the injected ChaosError, and the card's counterparts of
# XlaRuntimeError/RESOURCE_EXHAUSTED, torch.OutOfMemoryError (also
# torch.cuda.OutOfMemoryError) and torch.AcceleratorError.
_TRANSIENT_TYPES = ("XlaRuntimeError", "ChaosError", "OutOfMemoryError",
                    "AcceleratorError")

# Deterministic failures, never transient whatever their text says: a
# failed kernel or native build (_build.BuildError, native.NativeBuildError)
# and the argument errors of a plan or a call.
_DETERMINISTIC_TYPES = ("BuildError", "NativeBuildError")


class CircuitOpenError(RuntimeError):
    """Raised by :func:`call` when the breaker is open and no probe is due:
    the caller fails over at once (no device attempt was made)."""


def failover_disabled() -> bool:
    """The ``JEPSEN_NO_FAILOVER=1`` kill switch, read at each call."""
    return os.environ.get("JEPSEN_NO_FAILOVER", "") == "1"


def is_transient(exc: BaseException) -> bool:
    """Worth retrying and failing over? Deterministic errors (a build
    failure, ``ValueError``, ``TypeError``, ``KeyError``, an assertion) are
    not: they fail the same way on every attempt."""
    names = [t.__name__ for t in type(exc).__mro__]
    if isinstance(exc, (ValueError, TypeError)) or any(n in _DETERMINISTIC_TYPES
                                                       for n in names):
        return False
    if any(n in _TRANSIENT_TYPES for n in names):
        return True
    msg = str(exc)
    return any(m in msg for m in _TRANSIENT_MARKERS)


_STATE_VALUE = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    """Per-device-path breaker: closed -> (``failure_threshold``
    consecutive transient failures) -> open -> (``cooldown_s``) ->
    half-open probe -> closed on success, open on failure."""

    def __init__(self, key: str, failure_threshold: int = 3, cooldown_s: float = 30.0,
                 metrics=None):
        self.key = key
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.metrics = metrics
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {"key": self.key, "state": self._state,
                    "consecutive_failures": self._failures}

    def engaged(self) -> bool:
        """Would :meth:`allow` refuse now? Read-only: it never changes the
        state nor takes the half-open probe, so a caller that only wants to
        demote up front (the scheduler) leaves the probe to :func:`call`."""
        if failover_disabled():
            return False
        with self._lock:
            if self._state == "closed":
                return False
            if self._state == "open":
                return _time.monotonic() - self._opened_at < self.cooldown_s
            return True  # half_open: a probe is in flight

    def allow(self) -> bool:
        """May the caller dispatch now? An open breaker whose cooldown has
        passed turns half-open and admits ONE probe; otherwise an open or
        half-open breaker refuses."""
        if failover_disabled():
            return True
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if _time.monotonic() - self._opened_at >= self.cooldown_s:
                    self._set_locked("half_open")
                    return True
                return False
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != "closed":
                self._set_locked("closed")

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half_open":
                # the probe failed: open again, with a fresh cooldown
                self._opened_at = _time.monotonic()
                self._set_locked("open")
            elif self._state == "closed" and self._failures >= self.failure_threshold:
                self._opened_at = _time.monotonic()
                self._set_locked("open")

    def _set_locked(self, state: str) -> None:
        self._state = state
        if state == "closed":
            self._failures = 0
        m = self.metrics
        if m is not None:
            try:
                m.gauge("circuit_state",
                        "Per-device-path circuit breaker state (0 closed, 1 half-open, "
                        "2 open)", labelnames=("device",)).labels(
                            device=self.key).set(_STATE_VALUE[state])
                m.counter("circuit_transitions_total", "Circuit breaker state transitions",
                          labelnames=("device", "state")).labels(
                              device=self.key, state=state).inc()
            except Exception:  # noqa: BLE001 - observability only
                LOG.warning("circuit gauge update failed", exc_info=True)


# One breaker per device path ("batch", "sharded"), shared by every caller
# in the process: repeated failures anywhere open it for everyone.
_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker(key: str, metrics=None, **kw) -> CircuitBreaker:
    """The shared breaker of one device path, made on first use. The first
    caller that passes a registry attaches it."""
    with _breakers_lock:
        b = _breakers.get(key)
        if b is None:
            b = _breakers[key] = CircuitBreaker(key, metrics=metrics, **kw)
        elif metrics is not None and b.metrics is None:
            b.metrics = metrics
        return b


def reset_breakers() -> None:
    """Forget every breaker (test isolation)."""
    with _breakers_lock:
        _breakers.clear()


def call(fn: Callable, *, retries: int = 2, base_delay_s: float = 0.05,
         max_delay_s: float = 2.0, reason: str = "device", metrics=None,
         breaker: Optional[CircuitBreaker] = None):
    """Run ``fn()`` with at most ``retries`` retries of :func:`is_transient`
    failures, sleeping ``base_delay_s * 2**attempt`` (at most
    ``max_delay_s``) between attempts; each retried attempt counts in
    ``wgl_retry_total{reason}``. A breaker gates the first attempt
    (:class:`CircuitOpenError` when it is open) and is fed every outcome.
    Under ``JEPSEN_NO_FAILOVER=1`` this is a plain ``fn()``."""
    if failover_disabled():
        return fn()
    if breaker is not None and not breaker.allow():
        raise CircuitOpenError(f"circuit {breaker.key!r} is open; not dispatching")
    attempt = 0
    while True:
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 - classified below
            transient = is_transient(e)
            if breaker is not None and (transient or breaker.state == "half_open"):
                # A failed half-open probe must resolve the probe whatever
                # the error, or the breaker stays half-open for ever.
                breaker.record_failure()
            if not transient or attempt >= retries:
                raise
            if metrics is not None:
                try:
                    metrics.counter("wgl_retry_total",
                                    "Transient device-dispatch failures retried, by reason",
                                    labelnames=("reason",)).labels(reason=reason).inc()
                except Exception:  # noqa: BLE001 - observability only
                    pass
            delay = min(base_delay_s * (2 ** attempt), max_delay_s)
            LOG.warning("transient %s failure (%s: %s); retry %d/%d in %.2fs", reason,
                        type(e).__name__, e, attempt + 1, retries, delay)
            _time.sleep(delay)
            attempt += 1
            # another caller's failures may have opened the breaker meanwhile
            if breaker is not None and not breaker.allow():
                raise CircuitOpenError(f"circuit {breaker.key!r} opened mid-retry") from e
            continue
        if breaker is not None:
            breaker.record_success()
        return result
