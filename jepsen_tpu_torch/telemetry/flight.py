"""Run flight recorder: a bounded ring of recent telemetry events plus
phase deadlines, flushed as a post-mortem ``flightrecord.json`` when
something goes wrong (an exception, a phase past its deadline, or the run
past its wall budget). The port of the reference's
``jepsen_tpu/telemetry/flight.py``; the online scheduler's ``flight=``
records its ``online.drain``, ``online.dispatch``, ``online.fold`` and
``online.failover`` phases in one.

The JSON names the offending phase: the first phase that overshot its
deadline or raised, else the phase during which the budget ran out, else
the phase still open at flush time, else the longest phase.

Disabled is free: :func:`phase` with a ``None`` recorder returns one
shared no-op context manager.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time as _time
from collections import deque
from typing import Any, Optional

# Shared no-op context manager for the disabled path: nullcontext is
# stateless, so ONE instance serves every `with` — no per-call object.
_NOOP_CM = contextlib.nullcontext()


def phase(recorder: Optional["FlightRecorder"], name: str,
          deadline_s: Optional[float] = None):
    """``with flight.phase(rec, "analyze"):`` — no-op when rec is None
    (the zero-overhead disabled path; always the same object)."""
    if recorder is None:
        return _NOOP_CM
    return recorder.phase(name, deadline_s=deadline_s)


class FlightRecorder:
    """Bounded event ring + phase ledger with deadlines and a run budget.

    ``budget_s``: overall wall budget; :meth:`breached` and the
    ``budget_breach`` flush reason key off it. ``max_events`` bounds the
    note ring (oldest notes fall off). All methods are thread-safe —
    a script's phases and checker threads feed one recorder.
    """

    def __init__(self, budget_s: Optional[float] = None,
                 max_events: int = 512, max_phases: int = 4096):
        self.budget_s = budget_s
        self._t0 = _time.monotonic()
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        # Bounded like the note ring: the online scheduler enters three
        # ledger phases per decide round, so a long monitored stream
        # would otherwise grow the ledger (and every flightrecord.json
        # flush) without limit. Post-mortems want the RECENT window
        # anyway; a phase dict evicted while still open is mutated
        # harmlessly by its context manager.
        self._phases: deque = deque(maxlen=max_phases)
        self._open: list[dict] = []  # stack of phases in flight
        self._seq: Optional[dict] = None  # current begin()-phase

    # -- feeding ----------------------------------------------------------

    def elapsed(self) -> float:
        return _time.monotonic() - self._t0

    def note(self, name: str, **fields: Any) -> None:
        """Append one event to the ring (bounded; oldest drop off)."""
        with self._lock:
            self._events.append(
                {"t": round(self.elapsed(), 3), "name": name, **fields})

    @contextlib.contextmanager
    def phase(self, name: str, deadline_s: Optional[float] = None):
        ph = {"phase": name, "start_s": round(self.elapsed(), 3)}
        if deadline_s is not None:
            ph["deadline_s"] = round(float(deadline_s), 3)
        with self._lock:
            self._phases.append(ph)
            self._open.append(ph)
        try:
            yield ph
        except BaseException as e:
            ph["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            end = self.elapsed()
            with self._lock:
                ph["end_s"] = round(end, 3)
                ph["wall_s"] = round(end - ph["start_s"], 3)
                if deadline_s is not None and ph["wall_s"] > deadline_s:
                    ph["overshoot_s"] = round(ph["wall_s"] - deadline_s, 3)
                if ph in self._open:
                    self._open.remove(ph)

    # Sequential phase API for linear flows (a script's phases): begin()
    # closes the previous begin()-phase and opens the next, so a
    # straight-line script needs one call per leg instead of a nested
    # context manager per block.

    def begin(self, name: str, deadline_s: Optional[float] = None) -> None:
        now = self.elapsed()
        ph = {"phase": name, "start_s": round(now, 3)}
        if deadline_s is not None:
            ph["deadline_s"] = round(float(deadline_s), 3)
        with self._lock:
            self._end_locked(now)
            self._phases.append(ph)
            self._open.append(ph)
            self._seq = ph

    def end(self) -> None:
        with self._lock:
            self._end_locked(self.elapsed())

    def _end_locked(self, end: float) -> None:
        """Close the current begin()-phase; caller holds the lock."""
        ph = self._seq
        if ph is None:
            return
        ph["end_s"] = round(end, 3)
        ph["wall_s"] = round(end - ph["start_s"], 3)
        if ph.get("deadline_s") is not None \
                and ph["wall_s"] > ph["deadline_s"]:
            ph["overshoot_s"] = round(ph["wall_s"] - ph["deadline_s"], 3)
        if ph in self._open:
            self._open.remove(ph)
        self._seq = None

    # -- diagnosis --------------------------------------------------------

    def breached(self) -> bool:
        return self.budget_s is not None and self.elapsed() > self.budget_s

    def offending_phase(self) -> Optional[str]:
        """The phase to blame, in order of specificity: first deadline
        overshoot; else the phase running when the budget ran out; else
        the phase still open now; else the longest completed phase."""
        with self._lock:
            phases = list(self._phases)
            open_ = list(self._open)
        for ph in phases:
            if "overshoot_s" in ph or "error" in ph:
                return ph["phase"]
        if self.budget_s is not None:
            for ph in phases:
                end = ph.get("end_s", self.elapsed())
                if ph["start_s"] <= self.budget_s < end:
                    return ph["phase"]
        if open_:
            return open_[-1]["phase"]
        done = [p for p in phases if "wall_s" in p]
        if done:
            return max(done, key=lambda p: p["wall_s"])["phase"]
        return None

    # -- flushing ---------------------------------------------------------

    def snapshot(self, reason: Optional[str] = None,
                 registry=None, extra: Optional[dict] = None) -> dict:
        """The full record as a dict (what :meth:`flush` writes).
        ``registry``: a telemetry Registry whose newest events are
        appended as ``registry_tail`` (the last 100 — the minutes before
        the crash, FDR-style)."""
        if reason is None:
            reason = "budget_breach" if self.breached() else "manual"
        with self._lock:
            phases = [dict(p) for p in self._phases]
            events = list(self._events)
        out = {
            "reason": reason,
            "elapsed_s": round(self.elapsed(), 3),
            "budget_s": self.budget_s,
            "budget_breached": self.breached(),
            "offending_phase": self.offending_phase(),
            "phases": phases,
            "events": events,
        }
        if registry is not None:
            try:
                out["registry_tail"] = registry.events()[-100:]
            except Exception:  # diagnostics never mask the flush
                pass
        if extra:
            out.update(extra)
        return out

    def flush(self, path, reason: Optional[str] = None, registry=None,
              extra: Optional[dict] = None) -> str:
        """Atomically write the record to ``path`` (tmp + rename) and
        return the path. Never raises — a broken post-mortem writer must
        not add its own crash to the incident."""
        try:
            snap = self.snapshot(reason=reason, registry=registry,
                                 extra=extra)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(snap, f, indent=1, sort_keys=True, default=str)
            os.replace(tmp, path)
        except Exception:
            pass
        return str(path)


def store_flight_record(test: dict, recorder: FlightRecorder,
                        reason: Optional[str] = None,
                        registry=None) -> Optional[str]:
    """Flush ``flightrecord.json`` into the test's store directory (next
    to metrics.jsonl); None when the test has no store."""
    from .. import store

    if not store.wanted(test):
        return None
    p = store.path_mk(test, "flightrecord.json")
    return recorder.flush(p, reason=reason, registry=registry)
