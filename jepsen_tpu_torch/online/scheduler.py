"""Background segment dispatcher: batched decisions, the verdict fold and
the monotone ``decided_through_index`` watermark, shared by many
independent *streams*. The port of the reference's
``jepsen_tpu/online/scheduler.py``.

A worker thread drains the segment queue. Each round collects every
*ready* segment (a KeySegment is ready when its key's previous segment is
decided, so its carried initial states are known; distinct keys and
distinct streams pipeline freely, one key's segments decide in order),
encodes each (segment x carried state) pair as one member, and decides the
group. Two segments of different streams are as independent as two of
different keys, so one round co-batches members of many streams into one
device program, while each stream keeps its own carry chain, watermark and
folded verdict.

Deciding is two-stage. Non-terminal members go to the exhaustive host
enumerator (``segmenter.segment_states``) first: one search gives both the
verdict and the carried end states. The engine's oracle then takes what
the enumerator cannot: terminal segments (their carry is never consumed)
and budget-tripped rescues (the trip loses the carry, not the verdict):

- ``engine="device"``: the oracle members go through the batched search
  (``parallel.batch.check_encoded_batch``) as one program on ``device``
  (the card unless the caller passes ``device="cpu"``); members it leaves
  unknown are checked again one by one (``ops.wgl.check_encoded_device``);
- ``engine="host"``: the host oracle (``ops.wgl_host.check_encoded``);
- ``engine="auto"``: device when the model has a device step and a round
  hands the oracle more than one member, host otherwise.

Containment: when the ``"batch"`` circuit breaker
(``parallel.resilience``) is open, a device round is demoted to the host
up front; when the device oracle fails past its retries, the round fails
over to the host oracle member by member. Both show in the round's
``online_round`` event (``failover``), in ``service_failovers_total`` and
in the result maps' ``failover`` summary (rounds, members, causes); a
member nobody could decide folds unknown with a typed cause. Only a
transient device failure (``resilience.is_transient``) or an open circuit
fails over: a deterministic one (a failed kernel build, a ``ValueError``
or ``TypeError``) folds its rounds ``round_failed`` and is kept as
``fatal_error``, which ``offline.drive`` raises. A worker crash (the
``scheduler.worker`` chaos seam) gets one bounded restart.

Verdict fold, per stream: a segment is valid iff any member (candidate
initial state) linearizes, and its carry becomes the union of the valid
members' end states; invalid iff every member is refuted; unknown
otherwise, and every later segment of that key folds unknown too. The
folded verdict is ``checker.merge_valid`` over the stream's segments,
which equals the single search's verdict on that stream's history.

The device calls run on the worker thread. The drivers keep no state
between calls beyond the kernel library (loaded under ``_build``'s lock)
and the launch counts, and launch on the thread's current stream, so a
caller's thread and the worker may both reach the card.
"""

from __future__ import annotations

import collections as _collections
import contextlib as _contextlib
import logging
import queue
import threading
import time as _time
from typing import Any, Callable, Optional

from .. import trace as jtrace
from ..checker import provenance as _prov
from ..devices import resolve_device
from ..models import Model
from ..parallel import resilience as _resilience
from ..telemetry import flight as _flight
from ..testing import chaos as _chaos
from .segmenter import (
    SINGLE_KEY,
    KeySegment,
    encode_segment,
    segment_states,
)

LOG = logging.getLogger("jepsen.online")

# The implicit stream the single-tenant OnlineMonitor submits under.
DEFAULT_STREAM = "__default__"


class _StreamState:
    """Per-stream fold state (all fields guarded by the scheduler's
    ``_lock`` except the hook references, which are write-once at
    registration)."""

    __slots__ = ("carry", "seq_outstanding", "seq_end", "next_seq",
                 "watermark", "n_decided", "n_invalid", "n_unknown",
                 "violation", "segments", "on_watermark", "on_violation",
                 "on_segment", "carry_poisoned", "cause_counts")

    def __init__(self, on_watermark=None, on_violation=None,
                 on_segment=None):
        # key -> carried decoded-state list; absent = model's own init
        # (None member sentinel); "unknown" = carry lost.
        self.carry: dict[Any, Any] = {}
        self.seq_outstanding: dict[int, int] = {}
        self.seq_end: dict[int, int] = {}
        self.next_seq = 0  # first seq of this stream not fully decided
        self.watermark = -1
        self.n_decided = 0
        self.n_invalid = 0
        self.n_unknown = 0
        self.violation: Optional[dict] = None
        self.segments: list[dict] = []  # bounded display rows
        self.on_watermark = on_watermark
        self.on_violation = on_violation
        # on_segment(row, key, carry, watermark): fired under _lock for
        # EVERY decided segment — the service's crash-safe verdict
        # journal writes its record here, inside the fold lock, so a
        # journaled watermark never runs ahead of the fold state.
        self.on_segment = on_segment
        # A journal replay that could not round-trip some key's carry
        # sets this: every future segment of the stream dispatches
        # with a LOST carry (folds unknown) — checking an unknown key
        # from the model's init state could wrongly refute.
        self.carry_poisoned = False
        # Why-unknown union over every decided segment: {code: count}
        # per the closed provenance taxonomy (docs/verdicts.md). The
        # display rows are bounded; this map is the exact fold.
        self.cause_counts: dict[str, int] = {}


class SegmentScheduler:
    """Decide one or more streams of KeySegments concurrently with the
    workload(s).

    ``on_violation(record)`` fires (once per stream, from the worker
    thread) when a segment of the DEFAULT stream folds invalid — the
    monitor uses it for abort_on_violation and the detection metrics;
    service tenants register their own hooks via
    :meth:`register_stream`. ``metrics`` is a telemetry Registry or
    None; series: ``online_segments_total{verdict}``,
    ``online_decided_watermark`` and ``online_scheduler_backlog`` (the
    latter two carry a ``{tenant}`` label family next to the unlabeled
    total — existing dashboards and the ``/live`` poll keep reading the
    total; per-tenant children appear only for non-default streams).

    Decision-latency tracing (all optional, all None on the off path):
    ``on_watermark(index)`` fires from the worker thread whenever a
    stream's decided watermark advances (called with the scheduler lock
    held — the callback must not call back into the scheduler);
    ``collector`` is a ``trace.Collector`` receiving linked spans per
    decided segment (stage ``segment``, children stage ``member``,
    engine calls stage ``oracle`` whose span id is pushed as
    ``trace_span`` event tags so kernel chunk events link back);
    ``flight`` is a FlightRecorder whose ledger gets ``online.drain`` /
    ``online.dispatch`` / ``online.fold`` phase entries, so
    ``offending_phase`` can blame a stalled or crashed online run.
    """

    def __init__(
        self,
        model: Model,
        engine: str = "auto",
        metrics=None,
        # Matches the offline host oracle's default (wgl_host
        # check_encoded) — a smaller online budget would fold "unknown"
        # where offline decides, breaking the differential contract.
        max_configs: int = 500_000,
        batch_f: int = 256,
        on_violation: Optional[Callable[[dict], None]] = None,
        max_segment_rows: int = 2000,
        on_watermark: Optional[Callable[[int], None]] = None,
        collector=None,
        flight=None,
        max_ready_per_stream: Optional[int] = None,
        mesh=None,
        device=None,
    ) -> None:
        if engine not in ("auto", "device", "host"):
            raise ValueError(f"unknown online engine {engine!r}")
        self.model = model
        self.engine = engine
        # Device mesh for the batched oracle (offline driver's
        # ``--engine sharded``): forwarded to check_encoded_batch so one
        # co-batched round shards its members across the mesh's dp axis.
        self.mesh = mesh
        # The torch device of the device oracle: the card unless the caller
        # asks for the CPU (a mesh's device when one is given). The host
        # engine, and a model with no device step, never reach it.
        if mesh is not None and device is None:
            device = mesh.device
        self.device = (resolve_device(device)
                       if engine != "host" and model.device_capable else device)
        self.metrics = metrics
        self.max_configs = max_configs
        self.batch_f = batch_f
        self.max_segment_rows = max_segment_rows
        self.collector = collector
        self.flight = flight
        if max_ready_per_stream is not None and max_ready_per_stream < 1:
            raise ValueError("max_ready_per_stream must be >= 1")
        self.max_ready_per_stream = max_ready_per_stream

        self._lock = threading.Lock()
        self._inbox: "queue.SimpleQueue[Optional[tuple]]" = (
            queue.SimpleQueue())
        # (stream, key) -> FIFO of undecided KeySegments in seq order.
        # Keyed (not a flat list) so a ready-take round is O(live keys),
        # not O(pending segments): an offline 1M-op plan parks tens of
        # thousands of segments here at once, and the flat list's
        # sort-and-scan per round made the whole drain quadratic.
        self._pending: dict[tuple, _collections.deque] = {}
        # (stream, key) -> segments submitted but not yet decided
        # (guarded by _lock; the /live dashboard's queue-depth view).
        self._key_depth: dict[tuple, int] = {}
        # stream -> total undecided segments (same increments, kept so
        # the pump's per-sweep flow-control poll is O(1) instead of a
        # full _key_depth scan under the hot lock).
        self._stream_depth: dict[Any, int] = {}
        self._streams: dict[Any, _StreamState] = {
            DEFAULT_STREAM: _StreamState(on_watermark, on_violation)}
        self._violation: Optional[dict] = None  # first, any stream
        self._closed = False
        self._dead = False  # worker thread died; fold can't reach True
        self._idle = threading.Event()
        self._idle.set()
        # Batches submitted but not yet fully decided; guards the idle
        # event so wait_idle can't slip between a submit's clear() and
        # its put(). Per-stream counts back each stream's own fold.
        self._inflight = 0
        self._inflight_by_stream: dict[Any, int] = {}
        self._cnt_lock = threading.Lock()
        # Worker self-healing (fault-tolerance PR): one bounded restart
        # before the terminal _dead fold. _round_taken / _requeue are
        # the crash-recovery breadcrumbs the restart reconciles.
        self._restarts_left = 1
        self._saw_close = False
        self._round_taken: Optional[list] = None
        self._requeue: Optional[tuple] = None
        # Oracle rounds failed over to the host (guarded by _lock), and
        # the first deterministic device failure (a failed kernel build, a
        # plan's ValueError/TypeError): no host verdict stands in for
        # that, so its rounds fold round_failed and fatal_error re-raises
        # it to an offline caller.
        self._failovers: list[dict] = []
        self.fatal_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="jepsen-online-scheduler", daemon=True)
        self._thread.start()

    # -- public surface ------------------------------------------------------

    def register_stream(self, stream: Any,
                        on_watermark: Optional[Callable] = None,
                        on_violation: Optional[Callable] = None,
                        on_segment: Optional[Callable] = None) -> None:
        """Declare a stream (idempotent for hookless re-registration)
        and attach its watermark/violation/segment hooks. Hooks fire
        from the worker thread with the scheduler lock held, like the
        ctor's."""
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                self._streams[stream] = _StreamState(on_watermark,
                                                     on_violation,
                                                     on_segment)
            elif (on_watermark is not None or on_violation is not None
                  or on_segment is not None):
                if st.n_decided or st.seq_outstanding:
                    raise RuntimeError(
                        f"stream {stream!r} already has work; hooks must "
                        "be registered before the first submit")
                st.on_watermark = on_watermark or st.on_watermark
                st.on_violation = on_violation or st.on_violation
                st.on_segment = on_segment or st.on_segment

    def restore_stream(self, stream: Any, *, watermark: int = -1,
                       next_seq: int = 0,
                       carry: Optional[dict] = None,
                       n_decided: int = 0, n_invalid: int = 0,
                       n_unknown: int = 0,
                       violation: Optional[dict] = None,
                       segments: Optional[list] = None,
                       carry_poisoned: bool = False,
                       cause_counts: Optional[dict] = None,
                       on_watermark: Optional[Callable] = None,
                       on_violation: Optional[Callable] = None,
                       on_segment: Optional[Callable] = None) -> None:
        """Seed one stream's fold state from a replayed verdict journal
        (service restart): the restored watermark/seq counter resume
        where the journaled fold left off, ``carry`` maps each key to
        its journaled end-state list (or ``"unknown"`` where the carry
        was lost — including keys the journal could not round-trip),
        and the verdict counters reproduce the journaled fold. Must run
        before the stream's first submit; the restored fold obeys the
        same one-sided contract (a restored ``n_unknown`` keeps the
        stream from ever folding definite-True it didn't earn)."""
        with self._lock:
            st = self._streams.get(stream)
            if st is not None and (st.n_decided or st.seq_outstanding):
                raise RuntimeError(
                    f"stream {stream!r} already has work; restore must "
                    "precede the first submit")
            st = _StreamState(on_watermark, on_violation, on_segment)
            st.watermark = watermark
            st.next_seq = next_seq
            st.carry = dict(carry or {})
            st.n_decided = n_decided
            st.n_invalid = n_invalid
            st.n_unknown = n_unknown
            st.violation = violation
            st.segments = list(segments or [])[:self.max_segment_rows]
            st.carry_poisoned = bool(carry_poisoned)
            st.cause_counts = dict(cause_counts or {})
            self._streams[stream] = st
            if violation is not None and self._violation is None:
                self._violation = violation

    def remove_stream(self, stream: Any) -> bool:
        """Drop one stream's fold state (the service's live-migration
        release: after the tenant's journal was handed to the target
        backend, keeping the old fold would double-count it in
        ``result()``/``stats()``). Refuses — returning False, state
        untouched — while the stream still has submitted-but-undecided
        work: discarding an in-flight fold could lose an invalid
        verdict the journal never saw. The DEFAULT stream is never
        removable (the monitor's watermark property reads it)."""
        if stream == DEFAULT_STREAM:
            return False
        with self._cnt_lock:
            with self._lock:
                st = self._streams.get(stream)
                if st is None:
                    return True
                if (st.seq_outstanding
                        or self._inflight_by_stream.get(stream)
                        or self._stream_depth.get(stream)):
                    return False
                del self._streams[stream]
                self._stream_depth.pop(stream, None)
                for dk in [k for k in self._key_depth
                           if k[0] == stream]:
                    del self._key_depth[dk]
                return True

    def submit(self, segments: list[KeySegment],
               stream: Any = DEFAULT_STREAM) -> None:
        """Enqueue all KeySegments of one cut (atomically, so the
        watermark's per-seq accounting sees the full set) under
        ``stream``'s carry chain."""
        if not segments:
            return
        # The closed check, in-flight accounting AND the enqueue share
        # the lock close() flips the flag under: a submit that passed
        # the check cannot land its batch after close()'s None marker
        # (which would strand it in a queue no thread reads and wedge
        # the idle event forever).
        with self._cnt_lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            # In-flight accounting lands BEFORE the depth bump becomes
            # visible under _lock: a stream_result/stream_stats reader
            # who sees any trace of this batch must already find the
            # stream in flight (folding unknown), never a transient
            # definite True over just-submitted work.
            self._inflight += 1
            self._inflight_by_stream[stream] = (
                self._inflight_by_stream.get(stream, 0) + 1)
            # Depth accounting rides inside the same critical section as
            # the enqueue (lock order: _cnt_lock > _lock, matched
            # nowhere in reverse): the worker cannot decide-and-
            # decrement a segment before its increment lands.
            with self._lock:
                if stream not in self._streams:
                    self._streams[stream] = _StreamState()
                for seg in segments:
                    dk = (stream, seg.key)
                    self._key_depth[dk] = self._key_depth.get(dk, 0) + 1
                self._stream_depth[stream] = (
                    self._stream_depth.get(stream, 0) + len(segments))
                self._set_backlog_locked(stream)
            self._idle.clear()
            self._inbox.put((stream, list(segments)))

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Stop accepting segments and wait for the queue to drain."""
        with self._cnt_lock:
            if not self._closed:
                self._closed = True
                self._inbox.put(None)
        self._thread.join(timeout)

    @property
    def decided_through_index(self) -> int:
        return self._streams[DEFAULT_STREAM].watermark

    def stream_watermark(self, stream: Any) -> int:
        with self._lock:
            st = self._streams.get(stream)
            return st.watermark if st is not None else -1

    @property
    def backlog(self) -> int:
        """Segments submitted and not yet decided (all streams)."""
        with self._lock:
            return sum(self._stream_depth.values())

    def stream_backlog(self, stream: Any) -> int:
        """Undecided segments of one stream — the service's pump polls
        this every sweep as its flow-control signal (O(1))."""
        with self._lock:
            return self._stream_depth.get(stream, 0)

    def streams(self) -> list:
        with self._lock:
            return list(self._streams)

    def queue_depths(self) -> dict:
        """Per-key undecided-segment counts (keys repr'd for JSON) —
        the /live dashboard's queue view. Non-default streams prefix
        their tenant name."""
        def _disp(stream, key):
            k = "(single)" if key == SINGLE_KEY else repr(key)
            return k if stream == DEFAULT_STREAM else f"{stream}:{k}"

        with self._lock:
            return {_disp(s, k): v
                    for (s, k), v in sorted(self._key_depth.items(),
                                            key=lambda kv: repr(kv[0]))}

    def stats(self) -> dict:
        """One locked snapshot of the fold counters for the live view
        (global counters; the watermark is the default stream's — the
        monitor's single-stream shape)."""
        with self._lock:
            return {
                "segments_decided": sum(
                    st.n_decided for st in self._streams.values()),
                "segments_invalid": sum(
                    st.n_invalid for st in self._streams.values()),
                "segments_unknown": sum(
                    st.n_unknown for st in self._streams.values()),
                "decided_through_index":
                    self._streams[DEFAULT_STREAM].watermark,
                "backlog": sum(self._stream_depth.values()),
                "verdict": self._fold_locked(),
            }

    def stream_stats(self, stream: Any) -> dict:
        """One locked snapshot of ONE stream's fold counters — the
        service's per-tenant live row."""
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                return {"registered": False}
            out = {
                "segments_decided": st.n_decided,
                "segments_invalid": st.n_invalid,
                "segments_unknown": st.n_unknown,
                "decided_through_index": st.watermark,
                "backlog": self._stream_depth.get(stream, 0),
                "verdict": self._stream_fold_locked(stream, st),
            }
            prov = _prov.block(self._prov_counts_locked(stream, st))
            if prov is not None:
                out["provenance"] = prov
            return out

    @property
    def verdict(self) -> Any:
        with self._lock:
            return self._fold_locked()

    @property
    def violation(self) -> Optional[dict]:
        return self._violation

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted segment has been decided (the
        differential tests' sync point; the monitor's finish uses
        close)."""
        return self._idle.wait(timeout)

    def result(self) -> dict:
        """The monitor's single-stream result: global fold + the
        default stream's watermark/rows (identical to the pre-service
        shape when only the default stream ever submitted)."""
        with self._lock:
            st = self._streams[DEFAULT_STREAM]
            out = {
                "valid": self._fold_locked(),
                "decided_through_index": st.watermark,
                "segments_decided": sum(
                    s.n_decided for s in self._streams.values()),
                "segments": [row for s in self._streams.values()
                             for row in s.segments],
            }
            prov = _prov.block(_prov.merge_counts(
                *(self._prov_counts_locked(s, stv)
                  for s, stv in self._streams.items())))
            if prov is not None:
                out["provenance"] = prov
            if self._violation is not None:
                out["violation"] = self._violation
            fo = self._failover_locked()
            if fo is not None:
                out["failover"] = fo
            return out

    def stream_result(self, stream: Any) -> dict:
        """One stream's folded result — what the service's drain
        returns per tenant. A stream with submitted-but-undecided work
        folds unknown (a definite True must cover the whole stream)."""
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                return {"valid": "unknown", "error": "unknown stream"}
            out = {
                "valid": self._stream_fold_locked(stream, st),
                "decided_through_index": st.watermark,
                "segments_decided": st.n_decided,
                "segments_unknown": st.n_unknown,
                "segments": list(st.segments),
            }
            prov = _prov.block(self._prov_counts_locked(stream, st))
            if prov is not None:
                out["provenance"] = prov
            if st.violation is not None:
                out["violation"] = st.violation
            fo = self._failover_locked(stream)
            if fo is not None:
                out["failover"] = fo
            return out

    def _prov_counts_locked(self, stream: Any, st: _StreamState) -> dict:
        """A stream's cause counts, plus the process-level degradation
        a dead worker imposes on every stream it left unknown (a
        stream can fold unknown off `_dead` alone, with no segment of
        its own recorded — its provenance must still answer why)."""
        counts = st.cause_counts
        if (self._dead and not counts.get("worker_died")
                and self._stream_fold_locked(stream, st) == "unknown"):
            counts = _prov.merge_counts(counts, {"worker_died": 1})
        return counts

    # -- worker --------------------------------------------------------------

    def _ingest(self, stream: Any, batch: list[KeySegment]) -> None:
        st = self._streams[stream]
        for seg in batch:
            st.seq_outstanding[seg.seq] = (
                st.seq_outstanding.get(seg.seq, 0) + 1)
            st.seq_end[seg.seq] = seg.end_index
            dq = self._pending.setdefault(
                (stream, seg.key), _collections.deque())
            if dq and seg.seq < dq[-1].seq:
                # Out-of-seq arrival (a submitter that batches cuts
                # non-monotonically): restore seq order so the FIFO
                # head stays the key's earliest segment — per-key
                # in-order dispatch is a soundness invariant.
                rows = sorted([*dq, seg], key=lambda s: s.seq)
                dq.clear()
                dq.extend(rows)
            else:
                dq.append(seg)

    def _pending_items(self):
        """Every undecided (stream, segment) pair — crash/death paths
        only; round-hot code goes through _take_ready."""
        for (stream, _key), dq in self._pending.items():
            for seg in dq:
                yield stream, seg

    def _run(self) -> None:
        # Top-level guard: an exception anywhere outside _decide_round's
        # own recovery (ingest, bookkeeping, even _record_locked inside
        # the recovery handler) must not kill the worker with _idle
        # cleared — that would wedge wait_idle()/close() (and bench's
        # pacing loop) forever. A first crash is RECOVERED from
        # (bounded: once — a crash loop must still converge to the
        # honest unknown): the interrupted round's already-ingested
        # segments re-drain, a popped-but-uningested batch is requeued,
        # and the loop re-enters. A second crash — or one mid-shutdown
        # — is terminal: death folds every stream unknown (_dead),
        # never a definite True over undecided ops.
        try:
            while True:
                try:
                    self._run_loop()
                    return
                except Exception:  # noqa: BLE001 - recovery below
                    if self._restarts_left <= 0 or self._saw_close:
                        raise
                    self._restarts_left -= 1
                    LOG.warning(
                        "online scheduler worker crashed; restarting "
                        "(%d restart(s) left)", self._restarts_left,
                        exc_info=True)
                    self._recover_after_crash()
        except Exception:  # noqa: BLE001 - the monitor must survive
            LOG.warning("online scheduler worker died; streams fold "
                        "unknown", exc_info=True)
            with self._lock:
                self._dead = True
                # Every submitted-but-undecided segment gets a
                # worker_died record — not just the ingested ones: the
                # in-hand batch (_requeue) and anything still in the
                # inbox were submitted too, and dropping them silently
                # would leave their streams unknown with no provenance.
                # Each goes through _ingest (identity-deduped against a
                # partial ingest, like _recover_after_crash) so its seq
                # accounting is registered BEFORE any record decrements
                # it — recording an unregistered segment would drive
                # seq_outstanding negative and could advance the
                # watermark over a cut whose siblings are not yet
                # recorded.
                seen = {id(s) for _st, s in self._pending_items()}
                if self._requeue is not None:
                    stream, batch = self._requeue
                    remaining = [s for s in batch if id(s) not in seen]
                    if remaining:
                        self._ingest(stream, remaining)
                    self._requeue = None
                while True:
                    try:
                        more = self._inbox.get_nowait()
                    except queue.Empty:
                        break
                    if more is not None:
                        self._ingest(more[0], list(more[1]))
                for stream, seg in list(self._pending_items()):
                    self._streams[stream].carry[seg.key] = "unknown"
                    try:
                        self._record_locked(
                            stream, seg,
                            {"valid": "unknown",
                             "error": "scheduler worker died",
                             "causes": [_prov.cause("worker_died")]},
                            None)
                    except Exception:  # noqa: BLE001
                        pass
                self._pending.clear()
                # Streams the death folds unknown WITHOUT a segment of
                # their own (all-decided streams, or ones whose causes
                # the loop above already recorded) materialize the
                # worker_died cause NOW, so verdict_causes_total and
                # the snapshot provenance blocks agree — the /verdicts
                # page treats the two as interchangeable.
                for s2, st2 in self._streams.items():
                    if (not st2.cause_counts.get("worker_died")
                            and self._stream_fold_locked(s2, st2)
                            == "unknown"):
                        _prov.add_counts(st2.cause_counts,
                                         ["worker_died"])
                        _prov.count_metric(
                            self.metrics, [_prov.cause("worker_died")],
                            tenant="" if s2 == DEFAULT_STREAM
                            else str(s2))
        finally:
            # However the worker exits, nothing may wait on it again:
            # further submits must raise, and the idle event must fire.
            with self._cnt_lock:
                self._closed = True
                self._inflight = 0
                self._inflight_by_stream.clear()
            self._idle.set()

    def _recover_after_crash(self) -> None:
        """Reconcile after a worker crash, before re-entering the loop
        (the bounded-restart satellite). A batch popped from the inbox
        but not (fully) ingested is ingested NOW — never requeued at
        the back of the inbox, where a later batch of the same
        (stream, key) would overtake it and dispatch from the wrong
        carried state (per-key in-order is a soundness invariant, not
        a fairness nicety). Segments of it that a PARTIAL ingest
        already appended to _pending are skipped (identity dedup): a
        duplicate would be re-dispatched after the first copy's fold
        replaced the key's carry with its own end states, and
        re-checking the same ops from their final state can REFUTE a
        valid history — False outranks unknown in the fold, so this is
        a verdict flip, not a degradation. Everything the crashed
        round had ingested re-drains here; the round's taken batches
        then release their in-flight counts exactly as the round would
        have."""
        item, self._requeue = self._requeue, None
        taken, self._round_taken = self._round_taken or [], None
        if item is not None:
            stream, batch = item
            already = {id(s) for st2, s in self._pending_items()
                       if st2 == stream}
            remaining = [s for s in batch if id(s) not in already]
            if remaining:
                self._ingest(stream, remaining)
            taken.append(stream)
        if self.metrics is not None:
            self.metrics.counter(
                "online_worker_restarts_total",
                "Online scheduler worker threads restarted after a "
                "crash (bounded; a second crash folds streams "
                "unknown)").inc()
        # Re-drain what the crashed round left pending. A crash HERE
        # propagates to the terminal death path (restarts are spent).
        with _flight.phase(self.flight, "online.drain"):
            self._drain_ready()
        self._release_taken(taken)

    def _release_taken(self, taken: list) -> None:
        """Release the in-flight counts of one round's taken batches
        and fire the idle event when everything submitted has been
        decided — shared by the normal round end and crash recovery
        (ONE copy of the accounting, so the rarely-exercised recovery
        path cannot drift)."""
        with self._cnt_lock:
            self._inflight -= len(taken)
            for s in taken:
                left = self._inflight_by_stream.get(s, 1) - 1
                if left <= 0:
                    self._inflight_by_stream.pop(s, None)
                else:
                    self._inflight_by_stream[s] = left
            if self._inflight <= 0:
                self._inflight = 0
                self._idle.set()

    def _run_loop(self) -> None:
        while True:
            item = self._inbox.get()
            taken: list = []  # streams of the batches taken this round
            self._round_taken = taken
            closing = item is None
            if closing:
                self._saw_close = True
            if not closing:
                # Crash breadcrumb: until ingest completes, this batch
                # exists only in this local — a restart must requeue
                # it, not leak its in-flight count.
                self._requeue = item
                _chaos.fire("scheduler.worker")
                self._ingest(*item)
                self._requeue = None
                taken.append(item[0])
                # Opportunistically drain everything already queued so
                # one round sees the widest possible batch.
                while True:
                    try:
                        more = self._inbox.get_nowait()
                    except queue.Empty:
                        break
                    if more is None:
                        closing = True
                        self._saw_close = True
                        break
                    self._requeue = more
                    self._ingest(*more)
                    self._requeue = None
                    taken.append(more[0])
            # The drain phase sits OUTSIDE _drain_ready's recovery
            # catch: a crash inside a round crosses (and errors) only
            # the inner dispatch/fold phases, so offending_phase blames
            # the exact stage rather than the whole drain.
            with _flight.phase(self.flight, "online.drain"):
                self._drain_ready()
            # _drain_ready leaves _pending empty (the earliest pending
            # segment of a (stream, key) is always ready and the
            # fairness cap only splits rounds, never strands work), so
            # idleness is just "every submitted batch has been
            # decided". On close, everything submitted before the
            # marker has now been decided, so the in-flight count
            # (undecidedness for the fold) zeros outright.
            if closing:
                with self._cnt_lock:
                    self._inflight = 0
                    self._inflight_by_stream.clear()
                    self._idle.set()
            else:
                self._release_taken(taken)
            self._round_taken = None
            if closing:
                return

    def _drain_ready(self) -> None:
        while True:
            ready = self._take_ready()
            if not ready:
                return
            done: set = set()  # id() of segments _decide_round recorded
            try:
                self._decide_round(ready, done)
            except Exception as e:  # noqa: BLE001 - monitor must survive
                LOG.warning("online segment round failed; folding unknown",
                            exc_info=True)
                with self._lock:
                    for stream, seg in ready:
                        if id(seg) in done:  # recorded before the raise
                            continue
                        # The key's carry is lost with the round: later
                        # segments have no initial state to check from.
                        self._streams[stream].carry[seg.key] = "unknown"
                        self._record_locked(
                            stream, seg,
                            {"valid": "unknown", "error": "round failed",
                             "causes": [_prov.cause(
                                 "round_failed",
                                 error=type(e).__name__)]},
                            None)

    def _take_ready(self) -> list[tuple]:
        """Pop every pending segment whose (stream, key) has no earlier
        pending segment (per-key in-order; ready keys batch together,
        across streams). ``max_ready_per_stream`` caps one stream's
        contribution per round — deferred segments keep strict per-key
        order (a capped-out key blocks its later segments too)."""
        ready: list[tuple] = []
        per_stream: dict = {}
        cap = self.max_ready_per_stream
        # One segment per (stream, key) — the FIFO head, which _ingest
        # keeps seq-minimal. Sorting the HEADS (one per live key, not
        # one per pending segment) preserves the old lowest-seq-first
        # pick order when the fairness cap has to defer keys.
        for dk, dq in sorted(self._pending.items(),
                             key=lambda kv: kv[1][0].seq):
            stream = dk[0]
            if cap is not None and per_stream.get(stream, 0) >= cap:
                continue
            per_stream[stream] = per_stream.get(stream, 0) + 1
            ready.append((stream, dq.popleft()))
        for dk in [dk for dk, dq in self._pending.items() if not dq]:
            del self._pending[dk]
        return ready

    # -- deciding ------------------------------------------------------------

    def _decide_round(self, ready: list[tuple], done: set) -> None:
        with _flight.phase(self.flight, "online.dispatch"):
            members, results, durs, oracle_idx, engine, oracle_span = \
                self._dispatch_round(ready, done)
        if not members:
            return
        oracle_set = set(oracle_idx)
        with _flight.phase(self.flight, "online.fold"):
            i = 0
            for stream, seg, encs in members:
                rs = results[i:i + len(encs)]
                # Segments no member of which reached the oracle were
                # decided wholly by the stage-1 host enumerator — label
                # them so, whatever engine the round's oracle ran.
                seg_engine = (engine if any(
                    k in oracle_set for k in range(i, i + len(encs)))
                    else "host")
                seg_wall = sum(durs[i:i + len(encs)])
                member_spans = [
                    (durs[k],
                     "oracle" if k in oracle_set else "enumerator",
                     oracle_span if k in oracle_set else None)
                    for k in range(i, i + len(encs))]
                i += len(encs)
                self._fold_segment(stream, seg, encs, rs, seg_wall,
                                   seg_engine, member_spans=member_spans)
                done.add(id(seg))

    def _dispatch_round(self, ready: list[tuple], done: set):
        # Build members; segments whose carry is lost fold unknown now.
        members = []  # (stream, seg, [EncodedHistory ...]) ready order
        for stream, seg in ready:
            st = self._streams[stream]
            carried = ("unknown" if st.carry_poisoned
                       else st.carry.get(seg.key))
            if carried == "unknown":
                with self._lock:
                    self._record_locked(
                        stream, seg,
                        {"valid": "unknown",
                         "info": "carried state unknown",
                         # poisoned_key = the whole stream's carries are
                         # poisoned (journal replay); carry_lost = this
                         # key's carry was lost upstream.
                         "causes": [_prov.cause(
                             "poisoned_key" if st.carry_poisoned
                             else "carry_lost")]}, None)
                done.add(id(seg))
                continue
            encs = encode_segment(self.model, seg, carried)
            members.append((stream, seg, encs))
        if not members:
            return members, [], [], [], "none", None
        flat = [e for _s, _seg, encs in members for e in encs]
        seg_of = [seg for _s, seg, encs in members for _ in encs]
        stream_of = [s for s, _seg, encs in members for _ in encs]
        # Stage 1: non-terminal members decide via the exhaustive
        # enumerator — one BFS yields both the verdict and the carried
        # end-state set, so the common valid path never pays a second
        # decision.
        # Stage 2: the engine's decide oracle (first-accept host check /
        # batched device search) takes what the enumerator can't: terminal
        # segments (their carry is never consumed, and a big
        # non-quiescent tail must decide wherever offline does, not trip
        # the enumeration budget) and budget-tripped rescues (the trip
        # loses the CARRY, not the verdict).
        results: list = [None] * len(flat)
        durs = [0.0] * len(flat)  # per-member decide seconds
        oracle_idx: list[int] = []
        for idx, (seg, e) in enumerate(zip(seg_of, flat)):
            if seg.terminal:
                oracle_idx.append(idx)
                continue
            t1 = _time.perf_counter()
            r = segment_states(e, max_configs=self.max_configs)
            durs[idx] = _time.perf_counter() - t1
            if r.get("valid") == "unknown":
                oracle_idx.append(idx)
            else:
                results[idx] = r
        oracle_span = None
        failover = False
        if oracle_idx:
            engine = self.engine
            if engine == "auto":
                engine = ("device" if self.model.device_capable
                          and len(oracle_idx) > 1 else "host")
            if (engine == "device"
                    and not _resilience.failover_disabled()
                    and _resilience.breaker(
                        "batch", metrics=self.metrics).engaged()):
                # The batch pipeline's circuit is OPEN: demote the
                # round up-front — no doomed device attempt, no retry
                # ladder. engaged() is read-only, so when the cooldown
                # elapses the round proceeds and the RETRY LAYER's
                # allow() admits (and owns) the one half-open probe.
                failover = True
                self._count_failover("device")
                self._note_failover("device", "circuit_open", oracle_idx,
                                    stream_of)
                engine = "host"
            oracle_encs = [flat[i] for i in oracle_idx]
            col = self.collector
            if col is not None:
                # The oracle span covers the whole engine call (one
                # batched device program can decide members of MANY
                # segments, across MANY streams); member spans point at
                # it via oracle_span, and the span id rides as
                # `trace_span` tags on the kernel chunk events emitted
                # inside the call.
                oracle_span = col.mint_id()
            tag_cm = (jtrace.span_tags(trace_span=oracle_span)
                      if oracle_span is not None
                      else _contextlib.nullcontext())
            t1 = _time.perf_counter()
            t1_ns = _time.monotonic_ns()
            with tag_cm:
                try:
                    decided = self._oracle_call(engine, oracle_encs)
                except Exception as e:  # noqa: BLE001 - failover below
                    if _resilience.failover_disabled():
                        raise
                    if engine == "device" and not (
                            _resilience.is_transient(e)
                            or isinstance(e, _resilience.CircuitOpenError)):
                        # Deterministic: the host must not decide for a
                        # broken device path. The round folds
                        # round_failed; later device rounds fail at once.
                        if self.fatal_error is None:
                            self.fatal_error = e
                        raise
                    # The round's oracle failed past its own retries
                    # (device) or outright (host): demote to per-member
                    # host re-dispatch. Verdicts are never fabricated —
                    # every member is genuinely re-decided, and a
                    # member nobody can decide folds unknown, degrading
                    # definite-True coverage exactly like
                    # lost_segments.
                    LOG.warning(
                        "%s oracle round failed (%s: %s); failing over "
                        "to per-member host re-dispatch",
                        engine, type(e).__name__, e)
                    failover = True
                    self._count_failover(engine)
                    self._note_failover(engine, type(e).__name__,
                                        oracle_idx, stream_of)
                    with _flight.phase(self.flight, "online.failover"):
                        decided = self._host_redispatch(oracle_encs)
                    engine = "host"
            if col is not None:
                col.record(
                    "online.oracle", start_ns=t1_ns,
                    end_ns=_time.monotonic_ns(), span_id=oracle_span,
                    stage="oracle", engine=engine,
                    members=len(oracle_idx),
                    seqs=sorted({seg_of[i].seq for i in oracle_idx}))
            # A device batch decides all members in one program; split
            # its wall evenly rather than charging it to the last row.
            per_member = (_time.perf_counter() - t1) / len(oracle_idx)
            for idx, r in zip(oracle_idx, decided):
                durs[idx] += per_member
                # `detail` keeps the oracle's own diagnostics so a
                # refuted segment need not re-run a BFS to produce its
                # witness (host shape: max_linearized + stuck_configs).
                results[idx] = {"valid": r.get("valid"),
                                "end_states": None,
                                "enumeration_exhausted": True,
                                "detail": r,
                                # Lift the engine's structured causes
                                # so the fold unions them per segment.
                                "causes": _prov.of(r)}
        else:
            engine = "host" if self.engine == "auto" else self.engine
        if self.metrics is not None:
            # One point per dispatch round: the co-batching telemetry
            # the service's fairness/occupancy assertions (and the
            # service_streams bench leg) read — which streams shared
            # this round, and which reached the oracle's single batched
            # program.
            per_round: dict[str, int] = {}
            per_segs: dict[str, int] = {}
            for s, _seg, encs in members:
                per_round[str(s)] = per_round.get(str(s), 0) + len(encs)
                per_segs[str(s)] = per_segs.get(str(s), 0) + 1
            self.metrics.event(
                "online_round", t=round(_time.time(), 6),
                members=len(flat), segments=len(members), engine=engine,
                streams=per_round, stream_segments=per_segs,
                oracle_members=len(oracle_idx),
                oracle_streams=sorted(
                    {str(stream_of[i]) for i in oracle_idx}),
                failover=failover)
        return members, results, durs, oracle_idx, engine, oracle_span

    def _oracle_call(self, engine: str, encs: list) -> list[dict]:
        """One engine oracle call for a round's members. The
        ``device.dispatch`` chaos seam fires here for BOTH engines —
        the injected-fault path the failover exists for is the same
        whether the oracle is the batched device pipeline or the host
        check."""
        _chaos.fire("device.dispatch")
        if engine == "device":
            if self.fatal_error is not None:
                raise self.fatal_error
            return self._decide_device(encs)
        from ..ops import wgl_host

        return [wgl_host.check_encoded(e, max_configs=self.max_configs)
                for e in encs]

    def _host_redispatch(self, encs: list) -> list[dict]:
        """Failover target: re-dispatch every member of a failed
        oracle round to the host oracle, individually guarded — one
        member's failure costs that member an unknown, not the
        round."""
        from ..ops import wgl_host

        out = []
        for e in encs:
            try:
                out.append(wgl_host.check_encoded(
                    e, max_configs=self.max_configs))
            except Exception as ex:  # noqa: BLE001 - degrade, not round
                LOG.warning("host re-dispatch failed for one member; "
                            "folding it unknown", exc_info=True)
                out.append(_prov.attach(
                    {"valid": "unknown",
                     "info": "failover re-dispatch failed"},
                    "failover_exhausted", error=type(ex).__name__))
        return out

    def _note_failover(self, engine: str, cause: str, oracle_idx: list,
                       stream_of: list) -> None:
        with self._lock:
            self._failovers.append({
                "engine": engine, "cause": cause, "members": len(oracle_idx),
                "streams": sorted({str(stream_of[i]) for i in oracle_idx})})

    def _failover_locked(self, stream: Any = None) -> Optional[dict]:
        """The failover summary of the result maps (of one stream, or of
        all): oracle rounds whose members the host re-decided, by the
        failed engine's cause (an exception's type, or ``circuit_open``
        for a round the open breaker demoted). None when no round failed
        over, so a run without a fault has the reference's map."""
        rows = [r for r in self._failovers
                if stream is None or str(stream) in r["streams"]]
        if not rows:
            return None
        causes: dict = {}
        for r in rows:
            causes[r["cause"]] = causes.get(r["cause"], 0) + 1
        return {"rounds": len(rows),
                "members": sum(r["members"] for r in rows),
                "engines": sorted({r["engine"] for r in rows}),
                "causes": causes}

    def _count_failover(self, engine: str) -> None:
        if self.metrics is not None:
            c = self.metrics.counter(
                "service_failovers_total",
                "Oracle rounds demoted to host re-dispatch (engine "
                "failure past its retries, or an open circuit), by "
                "failed engine (unlabeled = all engines)",
                labelnames=("engine",), aggregate=True)
            c.inc()  # the unlabeled total
            c.labels(engine=engine).inc()

    def _decide_device(self, encs: list) -> list[dict]:
        """One batched search over all members on the scheduler's device
        (``parallel.batch``); members it leaves unknown are checked again
        one by one with the single device search, like the lifted
        checker's batch seam. The current CUDA device is per thread, so
        the worker makes the scheduler's device current for the round."""
        import torch

        from ..ops import wgl
        from ..parallel.batch import check_encoded_batch

        dev = torch.device(self.device) if self.device is not None else None
        on_card = (torch.cuda.device(dev)
                   if dev is not None and dev.type == "cuda"
                   else _contextlib.nullcontext())
        with on_card:
            results = check_encoded_batch(
                encs, f=self.batch_f, mesh=self.mesh,
                metrics=self.metrics, device=self.device)
            for i, r in enumerate(results):
                if r.get("valid") == "unknown":
                    results[i] = wgl.check_encoded_device(
                        encs[i], metrics=self.metrics, device=self.device)
        return results

    def _fold_segment(self, stream: Any, seg: KeySegment, encs,
                      member_results, wall_s: float, engine: str,
                      member_spans=None) -> None:
        st = self._streams[stream]
        valid_states: list = []
        carry_lost = False
        verdicts = []
        for e, r in zip(encs, member_results):
            v = r.get("valid")
            verdicts.append(v)
            if seg.terminal:
                continue  # terminal end states are never consumed
            if v is True:
                # Oracle-decided members (enumeration_exhausted) carry
                # no end states: the budget trip loses the carry, not
                # the verdict.
                states = r.get("end_states")
                if states is None:
                    carry_lost = True
                else:
                    valid_states.extend(states)
            elif v is not False:
                # An unknown member might still linearize from its
                # candidate state into end states we cannot enumerate:
                # narrowing the carry to the decided-valid members'
                # states would be unsound (a later segment could refute
                # from the narrowed set where offline is valid).
                carry_lost = True
        if any(v is True for v in verdicts):
            verdict = True
        elif all(v is False for v in verdicts):
            verdict = False
        else:
            verdict = "unknown"
        refutation = None
        if verdict is False and st.violation is None:
            # Witness diagnostics for the stream's FIRST violation only
            # (later refuted segments just fold; re-deriving a witness
            # per segment would delay the abort signal the detection
            # metrics measure). Prefer the oracle detail a refuted
            # member already carries; fall back to one host BFS when
            # the members were stage-1-decided (the enumerator returns
            # no stuck configs). st.violation has a single writer —
            # this worker thread — so the unlocked read is safe.
            refutation = next(
                (r.get("detail") for r in member_results
                 if r.get("valid") is False
                 and (r.get("detail") or {}).get("stuck_configs")),
                None)
            if refutation is None:
                from ..ops import wgl_host

                try:
                    refutation = wgl_host.check_encoded(
                        encs[0], max_configs=self.max_configs)
                except Exception:  # noqa: BLE001 - diagnostics only
                    refutation = {"valid": False}
        col = self.collector
        sid = None
        if col is not None:
            # Member spans, children of the segment span _record_locked
            # will emit under this minted id (the parent is recorded
            # after its children — the collector just appends).
            now_ns = _time.monotonic_ns()
            sid = col.mint_id()
            for k, (dur_s, path, oracle_span) in enumerate(
                    member_spans or []):
                attrs = {"member": k, "path": path}
                if oracle_span is not None:
                    attrs["oracle_span"] = oracle_span
                col.record(
                    "online.member", parent_id=sid, stage="member",
                    start_ns=now_ns - int(dur_s * 1e9), end_ns=now_ns,
                    verdict=str(member_results[k].get("valid")
                                if k < len(member_results) else None),
                    **attrs)
        with self._lock:
            if seg.terminal:
                pass  # no later segment consumes this key's carry
            elif verdict is True:
                if carry_lost:
                    # A lost enumeration on ANY valid member poisons the
                    # whole carry — narrowing to the members that did
                    # enumerate would be unsound.
                    st.carry[seg.key] = "unknown"
                else:
                    seen = set()
                    uniq = []
                    for s in valid_states:
                        if s not in seen:
                            seen.add(s)
                            uniq.append(s)
                    st.carry[seg.key] = uniq
            elif verdict == "unknown":
                st.carry[seg.key] = "unknown"
            rec: dict = {"valid": verdict}
            if verdict == "unknown":
                # Union of the undecided members' structured causes —
                # the per-segment provenance the fold carries upward
                # (per-key via the lost carry, per-stream via the
                # cause-count union in _record_locked).
                seg_causes: list = []
                for r in member_results:
                    if r.get("valid") not in (True, False):
                        seg_causes.extend(_prov.of(r))
                rec["causes"] = _prov.ensure(seg_causes, stage="fold")
            self._record_locked(stream, seg, rec,
                                refutation, wall_s=wall_s, engine=engine,
                                members=len(encs), span_id=sid)

    # -- bookkeeping (callers hold the lock) ---------------------------------

    def _set_backlog_locked(self, stream: Any) -> None:
        """Backlog gauge + timeline event after one stream's depth
        changed (caller holds _lock): the unlabeled total for existing
        dashboards/the /live poll, THAT stream's {tenant} child (only
        one stream moves per call — re-setting every tenant's child
        here would be O(tenants) work under the hot lock), and the
        stamped online_backlog transition event the idle-gap
        attribution reads."""
        if self.metrics is None:
            return
        g = self.metrics.gauge(
            "online_scheduler_backlog",
            "Segments submitted to the online scheduler and not yet "
            "decided (unlabeled = all streams; {tenant} children for "
            "service streams)",
            labelnames=("tenant",), aggregate=True)
        n_bl = sum(self._stream_depth.values())
        g.set(n_bl)
        if stream != DEFAULT_STREAM:
            g.labels(tenant=str(stream)).set(
                self._stream_depth.get(stream, 0))
        # Stamped transition: the gauge only holds "now", but idle-gap
        # attribution (starved vs no-work) needs the backlog's value
        # OVER TIME — the online_backlog event stream is that timeline.
        self.metrics.event(
            "online_backlog", t=round(_time.time(), 6), backlog=n_bl)

    def _record_locked(self, stream: Any, seg: KeySegment, result: dict,
                       refutation: Optional[dict], wall_s: float = 0.0,
                       engine: str = "none", members: int = 0,
                       span_id: Optional[str] = None) -> None:
        st = self._streams[stream]
        row = {
            "seq": seg.seq,
            "key": None if seg.key == SINGLE_KEY else repr(seg.key),
            "ops": seg.n_ops,
            "start_index": seg.start_index,
            "end_index": seg.end_index,
            "terminal": seg.terminal,
            "valid": result.get("valid"),
            "engine": engine,
            "members": members,
            "wall_s": round(wall_s, 4),
        }
        if stream != DEFAULT_STREAM:
            row["tenant"] = str(stream)
        if result.get("info"):
            row["info"] = result["info"]
        causes = list(result.get("causes") or [])
        if result.get("valid") not in (True, False):
            # EVERY degraded record carries at least one taxonomy cause
            # (the backstop is `unattributed`, which the chaos matrix
            # asserts never actually appears).
            causes = _prov.ensure(causes, stage="record")
        if causes:
            # Stamp the fold's own context — seq plus the segment
            # span id — into copies (cause dicts are shared through the
            # member result dicts).
            extra = {"seq": seg.seq}
            if span_id is not None:
                extra["trace_span"] = span_id
            causes = _prov.annotate(causes, **extra)
            row["causes"] = causes[:_prov.MAX_CAUSES_PER_ROW]
            if len(causes) > _prov.MAX_CAUSES_PER_ROW:
                # The display list is bounded; the EXACT counts ride
                # alongside so the journal (and a restart's rebuilt
                # Pareto) never undercount a many-member segment.
                row["cause_counts"] = _prov.add_counts({}, causes)
            _prov.add_counts(st.cause_counts, causes)
            _prov.count_metric(
                self.metrics, causes,
                tenant="" if stream == DEFAULT_STREAM else str(stream))
        col = self.collector
        if col is not None:
            # Segment span: cut → decided (queue wait included), member
            # children already recorded against span_id when the fold
            # path minted one. Emitted HERE — the one recording seam
            # every path crosses — so carry-lost, failed-round and
            # worker-died segments keep the documented invariant that
            # an op trace resolves to exactly one covering segment span
            # (the collector lock is leaf-level; holding _lock here is
            # safe). See trace.py's module docstring.
            now_ns = _time.monotonic_ns()
            extra = ({"tenant": str(stream)}
                     if stream != DEFAULT_STREAM else {})
            col.record(
                "online.segment", span_id=span_id, stage="segment",
                start_ns=seg.cut_ns or now_ns, end_ns=now_ns,
                seq=seg.seq, key=row["key"],
                start_index=seg.start_index, end_index=seg.end_index,
                terminal=seg.terminal, verdict=str(result.get("valid")),
                engine=engine, members=members,
                decide_s=round(wall_s, 6), **extra)
        v = result.get("valid")
        st.n_decided += 1
        if v is False:
            st.n_invalid += 1
        elif v is not True:
            st.n_unknown += 1
        if len(st.segments) < self.max_segment_rows:
            st.segments.append(row)
        if v is False and st.violation is None:
            st.violation = {
                "segment": dict(row),
                "refutation": {
                    k: refutation.get(k)
                    for k in ("max_linearized", "configs_explored",
                              "stuck_configs")
                } if refutation else None,
            }
            if stream != DEFAULT_STREAM:
                st.violation["tenant"] = str(stream)
            if self._violation is None:
                self._violation = st.violation
            cb = st.on_violation
            if cb is not None:
                try:
                    cb(st.violation)
                except Exception:  # noqa: BLE001
                    LOG.warning("on_violation callback failed",
                                exc_info=True)
        # Per-key queue depth (the /live view): this segment is decided.
        dk = (stream, seg.key)
        d = self._key_depth.get(dk, 1) - 1
        if d <= 0:
            self._key_depth.pop(dk, None)
        else:
            self._key_depth[dk] = d
        sd = self._stream_depth.get(stream, 1) - 1
        if sd <= 0:
            self._stream_depth.pop(stream, None)
        else:
            self._stream_depth[stream] = sd
        # Watermark: advance over the stream's contiguous fully-decided
        # prefix.
        before = st.watermark
        left = st.seq_outstanding.get(seg.seq, 0) - 1
        st.seq_outstanding[seg.seq] = left
        while st.seq_outstanding.get(st.next_seq) == 0:
            st.watermark = max(st.watermark, st.seq_end[st.next_seq])
            del st.seq_outstanding[st.next_seq]
            del st.seq_end[st.next_seq]
            st.next_seq += 1
        if st.watermark > before and st.on_watermark is not None:
            # Called with the scheduler lock held (documented in the
            # ctor): the monitor's/service's handler takes only its own
            # latency lock, so the op decision-latency histogram
            # observes at the exact moment coverage lands.
            try:
                st.on_watermark(st.watermark)
            except Exception:  # noqa: BLE001 - observers never sink us
                LOG.warning("on_watermark callback failed", exc_info=True)
        if self.metrics is not None:
            self.metrics.counter(
                "online_segments_total",
                "Segments decided by the online monitor, by verdict",
                labelnames=("verdict",)).labels(
                    verdict=str(result.get("valid"))).inc()
            wg = self.metrics.gauge(
                "online_decided_watermark",
                "Highest history index through which the online verdict "
                "is decided (unlabeled = the monitor's stream; {tenant} "
                "children for service streams)",
                labelnames=("tenant",), aggregate=True)
            if stream == DEFAULT_STREAM:
                wg.set(st.watermark)
            else:
                wg.labels(tenant=str(stream)).set(st.watermark)
                self.metrics.counter(
                    "service_segments_total",
                    "Service-stream segments decided, by tenant and "
                    "verdict",
                    labelnames=("tenant", "verdict")).labels(
                        tenant=str(stream),
                        verdict=str(result.get("valid"))).inc()
            self._set_backlog_locked(stream)
        cb_seg = st.on_segment
        if cb_seg is not None:
            # Fired under _lock — the one recording seam EVERY fold
            # path crosses (decided, carry-lost, failed-round,
            # worker-died), so the verdict journal sees every segment
            # and its journaled watermark can never run ahead of the
            # fold. The raw key rides alongside the display row (whose
            # key is repr'd) so replay can round-trip the carry map. A
            # POISONED stream journals "unknown", never the stale
            # st.carry entry its dispatch ignored — the file must
            # carry the state the fold actually used, not the one it
            # refused (defense in depth: the poisoning evidence also
            # persists in the file, but a future compaction must not
            # be one bug away from resurrecting stale carries).
            try:
                cb_seg(dict(row), seg.key,
                       "unknown" if st.carry_poisoned
                       else st.carry.get(seg.key),
                       st.watermark)
            except Exception:  # noqa: BLE001 - journal never sinks fold
                LOG.warning("on_segment callback failed", exc_info=True)

    def _stream_fold_locked(self, stream: Any, st: _StreamState) -> Any:
        if st.n_invalid:
            return False
        if (st.n_unknown or st.seq_outstanding or self._dead
                or self._inflight_by_stream.get(stream)):
            return "unknown"
        return True

    def _fold_locked(self) -> Any:
        # merge_valid over EVERY decided segment of EVERY stream, via
        # counters — the display tables are bounded, the fold must not
        # be. Submitted but not-yet-decided segments (a close() that
        # timed out mid-round) fold unknown: a definite True must cover
        # the whole stream.
        if any(st.n_invalid for st in self._streams.values()):
            return False
        if (self._inflight or self._dead
                or any(st.n_unknown or st.seq_outstanding
                       for st in self._streams.values())):
            return "unknown"
        return True
