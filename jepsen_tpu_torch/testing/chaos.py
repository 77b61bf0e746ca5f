"""Named injectable fault points at the checking pipeline's seams.

A partial failure must degrade a verdict to *unknown*, never flip it.
Production code crosses a handful of named **fault points** (one
``chaos.fire(point)`` call each, a dict lookup when nothing is armed);
tests arm a point with :func:`inject`, and the next crossing raises,
sleeps or ends the process, at the seam where a real fault would hit.

The port's seams:

- ``scheduler.worker``: the online scheduler's worker loop, after a batch
  is taken from its inbox (``online/scheduler.py`` ``_run_loop``). A raise
  kills the worker; its one bounded restart folds the in-flight segments
  unknown and keeps the stream deciding.
- ``device.dispatch``: the scheduler's oracle call (``_oracle_call``),
  each chunk of the batched search (``parallel/batch.py``) and of the
  sharded search (``parallel/frontier.py``, inside the retried chunk), and
  each closure dispatch of the Elle engine (``elle/engine.py``). A raise
  stands for a CUDA runtime error or an out-of-memory on the card: the
  resilience layer (``parallel/resilience.py``) retries it, the scheduler
  then fails the round over to the host oracle member by member, and the
  Elle engine folds the graph to its host path.
- ``host.stack``: the batch's table stacking on the host (its first rung,
  and the point in each rung's first chunk where the next rung's tables
  are made ready). A raise rides the batch's retry and failover path.

- ``ingest.parse``: each raw trace line the ingestion parses
  (``ingest/adapters.py`` ``parse_trace``). A raise costs exactly that
  line, counted unmapped, and folds the verdict one-sidedly to unknown
  (``ingest_unmapped_op``).

``service.pump``, ``journal.fsync``, ``router.probe``,
``backend.process`` and ``router.crash`` are the reference package's
seams in the multi-tenant service, its journal and its router, which
this package does not have yet. They stay registered, with their blast
radius in :data:`EXPECTED_UNKNOWN_CAUSES`, so that the map of causes is
the reference's.

Modes: ``raise`` (raise ``exc`` on the Nth crossing, ``times`` times),
``delay`` (sleep ``delay_s``: a slow device or disk) and ``crash``
(``os._exit(exit_code)``, for process-kill tests only).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional, Type

# The registered fault points (`inject` refuses a misspelt one, so a chaos
# test cannot silently test nothing).
POINTS = (
    "service.pump",
    "scheduler.worker",
    "device.dispatch",
    "host.stack",
    "journal.fsync",
    "router.probe",
    "backend.process",
    "router.crash",
    "ingest.parse",
)

MODES = ("raise", "delay", "crash")

# The one-sided degradation contract, per seam: an unknown verdict made
# under an injected fault at `point` may carry ONLY these taxonomy codes
# (checker/provenance.py), and never the `unattributed` backstop.
_PIPELINE_UNKNOWN_CAUSES = frozenset({
    "max_configs", "carry_lost", "poisoned_key", "lost_segments",
    "undelivered_ops", "deadline", "worker_died", "round_failed",
    "failover_exhausted", "journal_gap",
})
_ROUTER_UNKNOWN_CAUSES = (frozenset({"backend_lost", "migration_interrupted"})
                          | _PIPELINE_UNKNOWN_CAUSES)
EXPECTED_UNKNOWN_CAUSES: dict[str, frozenset] = {
    "service.pump": frozenset({"lost_segments", "undelivered_ops", "deadline"}),
    # a double worker crash is terminal: pending segments fold
    # worker_died; the first crash's round may fold round_failed, and
    # carry losses cascade per key
    "scheduler.worker": frozenset({"worker_died", "round_failed", "carry_lost",
                                   "lost_segments"}),
    # an oracle fault fails over to the host oracle; only an exhausted
    # failover (or a round lost with it) degrades
    "device.dispatch": frozenset({"failover_exhausted", "round_failed", "carry_lost"}),
    "host.stack": frozenset({"failover_exhausted", "round_failed", "carry_lost"}),
    # journal faults cost durability, never a verdict
    "journal.fsync": frozenset(),
    "router.probe": _ROUTER_UNKNOWN_CAUSES,
    "backend.process": _ROUTER_UNKNOWN_CAUSES,
    "router.crash": _ROUTER_UNKNOWN_CAUSES,
    "ingest.parse": frozenset({"ingest_unmapped_op"}) | _PIPELINE_UNKNOWN_CAUSES,
}


class ChaosError(RuntimeError):
    """The default injected fault. ``parallel.resilience.is_transient``
    classifies it transient: it stands in for the card's runtime errors
    that the retry and failover path exists for."""


class _Fault:
    __slots__ = ("point", "mode", "on_call", "times", "exc", "delay_s", "exit_code")

    def __init__(self, point: str, mode: str, on_call: int, times: int,
                 exc: Optional[Type[BaseException]], delay_s: float, exit_code: int):
        self.point = point
        self.mode = mode
        self.on_call = on_call
        self.times = times
        self.exc = exc or ChaosError
        self.delay_s = delay_s
        self.exit_code = exit_code

    def trigger(self, n: int) -> None:
        """Fire the fault on crossings [on_call, on_call + times)."""
        if n < self.on_call or n >= self.on_call + self.times:
            return
        if self.mode == "delay":
            time.sleep(self.delay_s)
            return
        if self.mode == "crash":
            # no atexit, no finally, no flush: what a SIGKILL leaves
            os._exit(self.exit_code)
        raise self.exc(f"chaos: injected fault at {self.point!r} (call {n})")


_lock = threading.Lock()
_active: dict[str, _Fault] = {}
_calls: dict[str, int] = {}
_fired: dict[str, int] = {}


def fire(point: str) -> None:
    """The production seam: one dict membership test when nothing is
    armed; when ``point`` is armed, count the crossing and let the fault
    decide whether this is its call."""
    if point not in _active:
        return
    with _lock:
        f = _active.get(point)
        if f is None:
            return
        n = _calls[point] = _calls.get(point, 0) + 1
        will = f.on_call <= n < f.on_call + f.times
        if will:
            _fired[point] = _fired.get(point, 0) + 1
    if will:
        f.trigger(n)


def calls(point: str) -> int:
    """Crossings of ``point`` while it was armed."""
    with _lock:
        return _calls.get(point, 0)


def fired(point: str) -> int:
    """Times ``point`` triggered its fault."""
    with _lock:
        return _fired.get(point, 0)


def reset() -> None:
    """Disarm everything (test teardown)."""
    with _lock:
        _active.clear()
        _calls.clear()
        _fired.clear()


@contextlib.contextmanager
def inject(point: str, mode: str = "raise", *, on_call: int = 1, times: int = 1,
           exc: Optional[Type[BaseException]] = None, delay_s: float = 0.05,
           exit_code: int = 9):
    """Arm ``point`` with one fault for the duration of the block.

    ``on_call``: the 1-based crossing the fault first triggers on;
    ``times``: how many consecutive crossings trigger; ``exc``: the
    exception class of ``raise`` mode (default :class:`ChaosError`, which
    the resilience layer treats as transient). Arming an armed point
    raises. The counters clear on entry and stay readable after the block
    (:func:`calls`, :func:`fired`) until the point is armed again or
    :func:`reset`."""
    if point not in POINTS:
        raise ValueError(f"unknown chaos point {point!r}; known: {POINTS}")
    if mode not in MODES:
        raise ValueError(f"unknown chaos mode {mode!r}; known: {MODES}")
    if on_call < 1 or times < 1:
        raise ValueError("on_call and times must be >= 1")
    f = _Fault(point, mode, on_call, times, exc, delay_s, exit_code)
    with _lock:
        if point in _active:
            raise RuntimeError(f"chaos point {point!r} already armed")
        _active[point] = f
        _calls.pop(point, None)
        _fired.pop(point, None)
    try:
        yield f
    finally:
        with _lock:
            _active.pop(point, None)
