"""The public online-monitor surface: tee the live op stream into the
segmenter, dispatch closed segments on the background scheduler, abort
the run on a violation, and persist ``online.json``. The port of the
reference's ``jepsen_tpu/online/monitor.py``.

Wiring (core.py / cli.py):

- ``--online`` sets ``test["online?"]``; :func:`of_test` then builds an
  :class:`OnlineMonitor` from the test map (it needs a model —
  ``test["model"]``, or ``test["online"]["model"]``) and ``core.run``
  installs ``monitor.observe`` as the interpreter's ``op-observer`` and
  ``monitor.stop_event`` as its ``stop-event``.
- ``--online-abort`` / ``test["online-abort?"]`` arms
  ``abort_on_violation``: the first invalid segment sets the stop event,
  the interpreter stops dispatching (the generator never drains), and
  the monitor records ``ops_to_detection`` / ``seconds_to_detection``.
- ``test["device"]`` (the CLI's ``--device``) is the torch device of the
  scheduler's device oracle: the card unless it says ``"cpu"``. The
  ``auto`` engine (the default) reaches the card too when a round
  batches more than one member, so a monitor of a device-capable model
  built without a card and without ``"cpu"`` raises.
- With ``--online`` absent the monitor is never built: the off path
  allocates no thread and registers no ``online_*`` metric.

Telemetry (guarded on the test's registry): the scheduler feeds
``online_segments_total{verdict}``, ``online_decided_watermark`` and
``online_scheduler_backlog``; the monitor feeds
``online_open_segment_ops`` (ops buffered in the still-open segment),
``online_detection_seconds``, the ``decision_latency_seconds``
histogram (per-op invoke→watermark-covered lag, wide buckets) and the
``online_watermark_stall_seconds`` gauge (0 while the watermark
advances; climbs once it freezes past ``stall_after_s`` with ops still
flowing — a flight-recorder ``online.watermark_stall`` phase opens
alongside so ``offending_phase`` blames the stall). ``live_snapshot()``
is the payload the reference's web ``/live`` endpoint serves per poll.
"""

from __future__ import annotations

import json
import logging
import threading
import time as _time
from collections import deque
from typing import Any, Optional

from ..telemetry.registry import DECISION_LATENCY_BUCKETS, Histogram
from .segmenter import Segmenter
from .scheduler import SegmentScheduler

LOG = logging.getLogger("jepsen.online")

# Wall seconds the watermark may sit still while ops keep flowing
# before the stall detector fires (gauge + flight-recorder phase).
STALL_AFTER_S = 5.0


class OnlineMonitor:
    """Consume history ops while the run executes; maintain a live
    folded linearizability verdict.

    ``observe(op)`` is called from the interpreter's scheduler thread
    for every history-bound op (invocations AND completions — the
    segmenter needs both to see quiescence); it must stay cheap, so it
    only buffers into the segmenter and hands closed segments to the
    worker thread.
    """

    def __init__(
        self,
        model,
        abort_on_violation: bool = False,
        engine: str = "auto",
        metrics=None,
        max_configs: int = 500_000,
        batch_f: int = 256,
        collector=None,
        flight=None,
        stall_after_s: float = STALL_AFTER_S,
        name: Optional[str] = None,
        device=None,
    ) -> None:
        self.model = model
        self.abort_on_violation = abort_on_violation
        self.metrics = metrics
        self.collector = collector
        self.flight = flight
        self.stall_after_s = float(stall_after_s)
        self.name = name
        self.stop_event = threading.Event()
        self._t0 = _time.monotonic()
        self._ops_observed = 0
        self._detection: Optional[dict] = None
        self._finished: Optional[dict] = None
        self._lock = threading.Lock()
        # Decision-latency chain (always tracked while the monitor runs
        # — the run opted in with --online): ONE histogram, living on
        # the telemetry registry when the run has one (so it exports
        # through metrics.jsonl/.prom) and standalone otherwise.
        # _lat_lock is leaf-level: never held while taking the
        # monitor/scheduler locks, so the scheduler worker's watermark
        # callback (fired under the scheduler lock) can observe
        # latencies without any ordering hazard.
        self._lat_lock = threading.Lock()
        _lat_help = ("Per-op lag from observed invocation to decided-"
                     "watermark coverage")
        self._lat = (
            metrics.histogram("decision_latency_seconds", _lat_help,
                              buckets=DECISION_LATENCY_BUCKETS)
            if metrics is not None else
            Histogram("decision_latency_seconds", _lat_help,
                      buckets=DECISION_LATENCY_BUCKETS))
        # (index, monotonic_ns at observe) per invocation, in index
        # order; popped as the watermark covers them.
        self._lat_pending: "deque[tuple[int, int]]" = deque()
        self._last_advance = _time.monotonic()
        self._stall_cm = None  # open flight phase while stalled
        self._stall_gauge = (
            metrics.gauge(
                "online_watermark_stall_seconds",
                "Seconds the decided watermark has been frozen while "
                "ops keep flowing (0 = advancing)")
            if metrics is not None else None)
        self.segmenter = Segmenter()
        self.scheduler = SegmentScheduler(
            model, engine=engine, metrics=metrics,
            max_configs=max_configs, batch_f=batch_f,
            on_violation=self._on_violation,
            on_watermark=self._on_watermark,
            collector=collector, flight=flight, device=device)
        self._open_gauge = (
            metrics.gauge(
                "online_open_segment_ops",
                "Ops buffered in the online monitor's still-open segment")
            if metrics is not None else None)

    # -- live path -----------------------------------------------------------

    def observe(self, op: Any) -> None:
        """Tee one history op from the interpreter (exception-safe: a
        monitor bug must never sink the run)."""
        try:
            with self._lock:
                self._ops_observed += 1
                segs = self.segmenter.offer(op)
                last = self.segmenter.last_op
                if last is not None and last.is_client and last.is_invoke:
                    # Inside _lock so concurrent interpreter threads
                    # append in index order — the watermark pop loop
                    # assumes a sorted pending deque. Lock order:
                    # _lock > _lat_lock, never reversed (_on_watermark
                    # takes only the leaf _lat_lock).
                    with self._lat_lock:
                        if not self._lat_pending:
                            # The stall clock starts when the first
                            # UNCOVERED op appears — without this, the
                            # first invoke after a quiet gap longer
                            # than stall_after_s (client think time, a
                            # paused workload) reads the pre-gap
                            # timestamp and fires a spurious stall.
                            self._last_advance = _time.monotonic()
                        self._lat_pending.append(
                            (last.index, _time.monotonic_ns()))
            self._check_stall()
            if segs:
                self.scheduler.submit(segs)
            if self._open_gauge is not None:
                self._open_gauge.set(self.segmenter.open_ops)
        except Exception:  # noqa: BLE001
            LOG.warning("online monitor observe failed", exc_info=True)

    def _on_watermark(self, w: int) -> None:
        """Scheduler callback (worker thread, scheduler lock held): the
        watermark now covers every index <= w — observe each pending
        invocation's decision latency, emit its op span, clear the stall
        state. Touches only the leaf _lat_lock."""
        now_ns = _time.monotonic_ns()
        col = self.collector
        with self._lat_lock:
            self._last_advance = _time.monotonic()
            if self._stall_gauge is not None:
                self._stall_gauge.set(0.0)
            self._stall_exit_locked()
            while self._lat_pending and self._lat_pending[0][0] <= w:
                idx, t_ns = self._lat_pending.popleft()
                lat = max(now_ns - t_ns, 0) / 1e9
                self._lat.observe(lat)
                if col is not None:
                    col.record("op.decision", start_ns=t_ns,
                               end_ns=now_ns, trace_id=f"op-{idx}",
                               stage="op", index=idx)

    # -- watermark-stall detector -------------------------------------------

    def _check_stall(self) -> None:
        """Fired per observed op (ops ARE flowing when this runs): if
        the watermark has sat still past stall_after_s with decisions
        outstanding, raise the stall gauge and open a flight-recorder
        phase so ``offending_phase`` blames the stall."""
        with self._lat_lock:
            if not self._lat_pending:
                self._last_advance = _time.monotonic()
                return
            stalled_s = _time.monotonic() - self._last_advance
            if stalled_s < self.stall_after_s:
                return
            if self._stall_gauge is not None:
                self._stall_gauge.set(round(stalled_s, 3))
            if self.flight is not None and self._stall_cm is None:
                try:
                    cm = self.flight.phase("online.watermark_stall")
                    cm.__enter__()
                    self._stall_cm = cm
                    self.flight.note(
                        "online_watermark_stall",
                        watermark=self.scheduler.decided_through_index,
                        ops_observed=self._ops_observed,
                        stalled_s=round(stalled_s, 3))
                except Exception:  # noqa: BLE001 - diagnostics only
                    self._stall_cm = None

    def _stall_exit_locked(self) -> None:
        """Close the open stall phase (caller holds _lat_lock)."""
        cm = self._stall_cm
        if cm is not None:
            self._stall_cm = None
            try:
                cm.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass

    def _stall_seconds(self) -> float:
        with self._lat_lock:
            if not self._lat_pending:
                return 0.0
            s = _time.monotonic() - self._last_advance
            return round(s, 3) if s >= self.stall_after_s else 0.0

    def _on_violation(self, violation: dict) -> None:
        if self.segmenter.mixed_keys:
            # A refutation in a mixed keyed/keyless stream is not
            # trustworthy (see Segmenter.mixed_keys): the fold will
            # degrade to "unknown", so neither record a detection nor
            # abort a run offline might call valid.
            LOG.warning(
                "online monitor: invalid segment in a mixed "
                "keyed/keyless stream ignored (fold degrades to unknown)")
            return
        with self._lock:
            if self._detection is None:
                self._detection = {
                    "ops_to_detection": self._ops_observed,
                    "seconds_to_detection": round(
                        _time.monotonic() - self._t0, 4),
                }
                if self.metrics is not None:
                    self.metrics.gauge(
                        "online_detection_seconds",
                        "Wall seconds from the first observed op to the "
                        "first invalid segment verdict").set(
                            self._detection["seconds_to_detection"])
        if self.abort_on_violation:
            LOG.warning(
                "online monitor detected a linearizability violation "
                "(segment seq %s); aborting the run",
                violation.get("segment", {}).get("seq"))
            self.stop_event.set()

    @property
    def aborted(self) -> bool:
        return self.stop_event.is_set()

    @property
    def decided_through_index(self) -> int:
        return self.scheduler.decided_through_index

    def live_snapshot(self) -> dict:
        """One point-in-time operational view — what the web ``/live``
        endpoint serves per poll. Deliberately lock-light: scheduler
        counters come from one locked stats() snapshot, everything else
        is a racy-but-monotone read (a dashboard tolerates being one op
        behind; it must never contend with the hot observe path)."""
        sched = self.scheduler.stats()
        snap: dict = {
            "run": self.name,
            "t": round(_time.time(), 3),
            "ops_observed": self._ops_observed,
            "decided_through_index": sched["decided_through_index"],
            "verdict": str(sched["verdict"]),
            "aborted": self.aborted,
            "open_segment_ops": self.segmenter.open_ops,
            "open_invocations": self.segmenter.open_invocations,
            "segments_decided": sched["segments_decided"],
            "segments_unknown": sched["segments_unknown"],
            "scheduler_backlog": sched["backlog"],
            "queue_depths": self.scheduler.queue_depths(),
            "watermark_stall_seconds": self._stall_seconds(),
            "decision_latency": self._lat.stats(),
        }
        with self._lat_lock:
            snap["undecided_ops"] = len(self._lat_pending)
        reg = self.metrics
        if reg is not None:
            # Per-shard utilization straight off the newest sharded /
            # batch chunk events — the kernel layer's existing telemetry
            # rather than new plumbing.
            ev = reg.last_event("wgl_sharded_chunk")
            if ev is not None:
                cap = ev.get("global_capacity") or 0
                snap["shards"] = {
                    "n_shards": ev.get("n_shards"),
                    "configs": ev.get("count"),
                    "configs_max": ev.get("count_max"),
                    "configs_min": ev.get("count_min"),
                    "utilization": (round(ev["count"] / cap, 4)
                                    if cap else None),
                    "exchange": ev.get("exchange"),
                }
            bv = reg.last_event("wgl_batch_chunk")
            if bv is not None:
                snap["batch"] = {
                    "F": bv.get("F"), "active": bv.get("active"),
                    "batch": bv.get("batch"),
                    "occupancy": (round(bv["active"] / bv["batch"], 4)
                                  if bv.get("batch") else None),
                }
            # Device-saturation estimate off the newest stamped chunk
            # event (O(1) — last_event only, never a full event scan on
            # the poll path): busy fraction of the window since that
            # chunk began. The full per-device timeline + gap
            # attribution is the /utilization page's job, post-run.
            newest = None
            for name in ("wgl_sharded_chunk", "wgl_batch_chunk",
                         "wgl_chunk"):
                e = reg.last_event(name)
                if e is not None and e.get("t1") is not None and (
                        newest is None
                        or e["t1"] > newest[1].get("t1", 0)):
                    newest = (name, e)
            if newest is not None:
                name, e = newest
                now = _time.time()
                span = max(now - float(e.get("t0") or e["t1"]), 1e-9)
                wall = float(e.get("chunk_wall_s") or e.get("wall_s")
                             or 0.0)
                snap["device_busy"] = {
                    "source": name,
                    "n_devices": int(e.get("n_shards")
                                     or e.get("n_devices") or 1),
                    "last_chunk_age_s": round(
                        max(now - float(e["t1"]), 0.0), 3),
                    "busy_frac_recent": round(
                        min(wall / span, 1.0), 4),
                }
        if self._detection is not None:
            snap.update(self._detection)
        return snap

    # -- completion ----------------------------------------------------------

    def finish(self, timeout: Optional[float] = 300.0) -> dict:
        """Flush the terminal segment, drain the scheduler, and return
        the folded result (idempotent). A deterministic device error of
        the scheduler's oracle (a failed kernel build, a refused plan) is
        raised here, as ``offline.drive`` raises it: its rounds folded
        ``round_failed`` and no host verdict stands in for them. The
        folded result is kept, so a second call returns it."""
        if self._finished is not None:
            return self._finished
        with self._lock:
            tail = self.segmenter.finish()
        if tail:
            try:
                self.scheduler.submit(tail)
            except RuntimeError:
                # Scheduler already closed (worker died): the fold
                # degrades to unknown; finish must still return.
                LOG.warning("online scheduler closed before the "
                            "terminal segment; fold degrades to unknown")
        self.scheduler.close(timeout=timeout)
        with self._lat_lock:
            self._stall_exit_locked()
            if self._stall_gauge is not None:
                self._stall_gauge.set(0.0)
            undecided = len(self._lat_pending)
        res = self.scheduler.result()
        lat = self._lat.stats()
        lat["undecided_ops"] = undecided  # invocations never covered
        out = {
            "valid": res["valid"],
            "ops_observed": self._ops_observed,
            "decided_through_index": res["decided_through_index"],
            "segments_decided": res["segments_decided"],
            "aborted": self.aborted,
            "abort_on_violation": self.abort_on_violation,
            # Watermark-covered lag, NOT per-op verdicts: p99 here is
            # "how long after an op ran did the fold cover it", the
            # ROADMAP item-3 serving-stack signal.
            "decision_latency": lat,
        }
        if self._detection is not None:
            out.update(self._detection)
        if res.get("violation") is not None:
            out["violation"] = res["violation"]
        from ..checker import provenance as _prov

        prov_counts = dict(
            (res.get("provenance") or {}).get("causes") or {})
        if self.segmenter.mixed_keys:
            # Streaming cannot reproduce independent.subhistory's
            # broadcast of keyless ops into every key (including keys
            # the stream hasn't shown yet) — no definite verdict is
            # safe here.
            out["valid"] = "unknown"
            out["info"] = ("mixed keyed/keyless stream: online split "
                           "cannot match independent.subhistory; "
                           "verdict degraded to unknown")
            _prov.add_counts(prov_counts, ["mixed_keys"])
            _prov.count_metric(self.metrics,
                               [_prov.cause("mixed_keys")])
        if prov_counts:
            # The online.json provenance block: the scheduler's cause
            # union plus the monitor-level degradations above.
            out["provenance"] = _prov.block(prov_counts)
        out["segments"] = res["segments"]
        self._finished = out
        if self.scheduler.fatal_error is not None:
            raise self.scheduler.fatal_error
        return out


# ---------------------------------------------------------------------------
# Test-map glue (core.run / cli).


def of_test(test: dict):
    """Build the test's monitor when ``test["online?"]`` is set and a
    model is available; None otherwise (core.run skips the whole
    subsystem on None — the zero-overhead off path)."""
    if not test.get("online?"):
        return None
    opts = dict(test.get("online") or {})
    model = opts.get("model") or test.get("model")
    if model is None:
        if opts.get("abort_on_violation") or test.get("online-abort?"):
            # A user who armed abort-on-violation is RELYING on the
            # monitor; degrading to "no monitor, full-length run" would
            # silently void that protection — fail the run instead.
            raise ValueError(
                "--online-abort requires a model on the test map "
                "(test['model'] or test['online']['model']) — without "
                "one no monitor runs and no abort can ever fire")
        LOG.warning(
            "--online requested but the test map carries no model "
            "(test['model'] or test['online']['model']); online "
            "monitoring disabled")
        return None
    from .. import telemetry as jtelemetry

    return OnlineMonitor(
        model,
        abort_on_violation=bool(
            opts.get("abort_on_violation", test.get("online-abort?"))),
        engine=opts.get("engine", test.get("online-engine") or "auto"),
        metrics=jtelemetry.of_test(test),
        max_configs=int(opts.get("max_configs", 500_000)),
        batch_f=int(opts.get("batch_f", 256)),
        # Decision-latency tracing rides the run's existing trace
        # collector and flight recorder (both created by core.run on
        # telemetry runs BEFORE the monitor is built; absent = plain
        # monitoring, no spans).
        collector=test.get("trace-collector"),
        flight=test.get("flight-recorder"),
        stall_after_s=float(opts.get("stall_after_s", STALL_AFTER_S)),
        name=test.get("name"),
        device=opts.get("device", test.get("device")),
    )


def store_online(test: dict, result: dict) -> Optional[str]:
    """Write ``online.json`` into the run's store directory (the file the
    reference's web ``/online`` page renders). Never raises."""
    if not (test.get("name") and test.get("start-time")) or test.get(
            "no-store?"):
        return None
    try:
        from .. import store

        p = store.path_mk(test, "online.json")
        tmp = p.with_suffix(".json.tmp")
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True, default=str)
        tmp.replace(p)
        return str(p)
    except Exception:  # noqa: BLE001 - artifacts never sink the run
        LOG.warning("could not store online.json", exc_info=True)
        return None
