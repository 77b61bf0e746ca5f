"""The always-on multi-tenant checking service. The port of the
reference's ``jepsen_tpu/service/service.py``.

One resident :class:`Service` accepts many concurrent tenant streams
(ndjson-over-HTTP via ``jepsen_tpu_torch.service.http``, or the
in-process :meth:`Service.submit` seam tests and the simulated generator
use), runs one ``online`` segmenter per tenant, and feeds ONE shared
:class:`~jepsen_tpu_torch.online.scheduler.SegmentScheduler` whose
dispatch loop co-batches ready (segment × carried-state) members *across
tenants* into the batched device search on ``device`` — the "distinct
keys pipeline" generalized to distinct tenants, so device batches fill
from whoever has work while each tenant keeps its own in-order fold,
watermark, and verdict (sharing a batch never changes a verdict: each
tenant's verdict equals the single search's on its history alone).

The device: ``Service(model, device=None)`` (or
``ServiceConfig.device``) decides on the card unless the caller passes
``device="cpu"``; a service whose engine can reach the device oracle
raises at construction where there is no card. A deterministic device
error of a round (a failed kernel build, a refused plan) is raised out
of :meth:`Service.flush` and :meth:`Service.drain`; only a transient
error or an open circuit fails a round over to the host, and then the
tenant's results say so (``failover``).

Production controls:

- **Admission**: at most ``max_tenants`` concurrent streams
  (:class:`TenantLimitError`), a per-tenant ops/s token bucket
  (:class:`QuotaExceededError`) — both typed, both HTTP-429-mappable.
- **Backpressure**: every tenant's ingest queue is BOUNDED
  (``queue_limit``); when the pump falls behind, ``backpressure=
  "reject"`` raises :class:`IngestQueueFullError` (the 429 path) and
  ``"block"`` makes :meth:`submit` wait up to ``block_timeout_s`` —
  memory never grows unboundedly. The pump additionally stops draining
  a tenant whose undecided scheduler backlog passed
  ``max_inflight_segments``, so pressure propagates ingest-ward
  instead of piling segments behind the device.
- **Fairness**: per-(tenant, key) in-order dispatch guarantees every
  tenant with ready work lands in every round; ``max_ready_per_tenant``
  caps a flooding tenant's share of any single round.
- **Isolation on violation**: with ``abort_on_violation`` a tenant
  whose stream folds invalid is ABORTED — further submits raise
  :class:`TenantAbortedError`, ``ops_to_detection`` /
  ``seconds_to_detection`` are recorded — while every other tenant's
  stream keeps deciding undisturbed (``--online-abort`` semantics,
  scoped to one tenant).
- **Graceful drain**: :meth:`drain` stops admission, flushes the
  queues, folds each tenant's terminal segment, and returns per-tenant
  partial results (verdict, watermark, decision-latency summary,
  violation witness), appending one ledger record per tenant stream.

Telemetry rides the existing stack: ``online_scheduler_backlog`` /
``online_decided_watermark`` grow ``{tenant}`` children next to their
unlabeled totals, ``decision_latency_seconds`` is registered with a
``{tenant}`` label family plus the aggregate, ``online_round`` events
carry the per-round stream mix (the co-batching assertion), and
``live_snapshot()`` feeds the web ``/live`` page one row per tenant.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time as _time
from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Optional

from ..checker import provenance as _prov
from ..online.scheduler import SegmentScheduler
from ..online.segmenter import Segmenter
from ..telemetry import flight as _flight
from ..telemetry.registry import DECISION_LATENCY_BUCKETS, Histogram
from ..testing import chaos as _chaos

LOG = logging.getLogger("jepsen.service")


def _decode_kv(op: Any) -> Any:
    """Rehydrate the wire encoding of ``independent`` [k v] values.

    JSON cannot distinguish a plain vector value from a key/value pair,
    so ``client.op_json`` serializes KV values as ``{"kv": [k, v]}`` —
    this (the one ingestion seam both transports share) turns the
    marker back into the live ``independent.KV``, which the tenant's
    segmenter needs to run the P-compositional key split server-side
    (the offline fleet fanout's whole parallelism axis)."""
    v = op.get("value") if isinstance(op, dict) else None
    if (isinstance(v, dict) and len(v) == 1
            and isinstance(v.get("kv"), (list, tuple))
            and len(v["kv"]) == 2):
        from .. import independent as ind

        return dict(op, value=ind.KV(*v["kv"]))
    return op


# ---------------------------------------------------------------------------
# Typed rejections (the ingestion layer maps these to HTTP statuses).


class ServiceError(Exception):
    """Base class of every typed service rejection.

    ``retry_after_s`` (instance attribute, set at raise time where the
    raiser can estimate it) rides to the HTTP layer as a standard
    ``Retry-After`` header next to the ``retryable`` flag: a quota
    rejection carries the token bucket's refill estimate, a full-queue
    rejection a short drain hint, a draining 503 the fixed restart
    hint."""

    http_status = 400
    code = "service_error"
    retry_after_s: Optional[float] = None
    # None = derive from status (429 retryable, everything else not);
    # a migration 503 overrides to True — the tenant comes back on
    # another backend, and the client must keep retrying through it.
    retryable: Optional[bool] = None


# Fixed Retry-After hints where no live estimate exists: a full ingest
# queue usually drains within a pump sweep or two; a draining service
# needs a deploy-scale pause before the replacement listens.
QUEUE_RETRY_AFTER_S = 1.0
DRAIN_RETRY_AFTER_S = 30.0


class ServiceClosedError(ServiceError):
    """The service is draining or closed — no new work is admitted."""

    http_status = 503
    code = "draining"
    retry_after_s = DRAIN_RETRY_AFTER_S


class AdmissionError(ServiceError):
    """Admission control rejected the submit (the 429 family)."""

    http_status = 429
    code = "admission"


class TenantLimitError(AdmissionError):
    code = "tenant_limit"
    retry_after_s = 30.0  # capacity frees on another tenant's drain


class QuotaExceededError(AdmissionError):
    code = "quota_exceeded"


class IngestQueueFullError(AdmissionError):
    code = "ingest_queue_full"


class TenantAbortedError(ServiceError):
    """The tenant's stream folded invalid with abort armed."""

    http_status = 409
    code = "tenant_aborted"


class UnknownTenantError(ServiceError):
    """The named tenant does not live on this backend."""

    http_status = 404
    code = "unknown_tenant"


class TenantMigratingError(ServiceError):
    """The tenant is mid-migration (released, or a second concurrent
    release): the client should back off briefly and resume against
    the router, which will hold the new placement."""

    http_status = 503
    code = "migrating"
    retry_after_s = 1.0
    retryable = True


class TenantAdoptConflictError(ServiceError):
    """Double-adopt refusal: the tenant (or its journal) already lives
    on this backend — adopting it again would fork the fold."""

    http_status = 409
    code = "already_adopted"


class TenantMigratedError(ServiceError):
    """The tenant was released to another backend: this backend must
    never silently re-admit it as a fresh stream (the fork would check
    its tail from the model's init state — a potential flip). Clients
    go through the router, which holds the new placement; only an
    explicit ``adopt`` (journal in hand) may re-own the name here."""

    http_status = 410
    code = "migrated"
    retryable = False


class AdoptUnsupportedError(ServiceError):
    """Adopt/release need a journal: without ``journal_dir`` this
    backend has no checkpoint to restore from or hand over."""

    http_status = 400
    code = "no_journal"


class StaleEpochError(ServiceError):
    """The caller's placement epoch is below this backend's fence: a
    newer router generation has taken ownership of the fleet, and
    honoring a stale ex-router's in-flight ``/release``/``/adopt``
    would split tenant ownership (two routers flipping placement
    independently — the fork the fence exists to prevent)."""

    http_status = 409
    code = "stale_epoch"
    retryable = False


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServiceConfig:
    """Service-wide policy knobs (every tenant shares them)."""

    engine: str = "auto"
    max_tenants: int = 64
    # ops/s admitted per tenant; None = unlimited. The bucket's burst
    # defaults to two seconds' worth of quota.
    quota_ops_per_s: Optional[float] = None
    quota_burst: Optional[float] = None
    queue_limit: int = 4096
    backpressure: str = "reject"  # "reject" (429) | "block"
    block_timeout_s: float = 30.0
    abort_on_violation: bool = False
    max_configs: int = 500_000
    batch_f: int = 256
    # Fairness: max segments one tenant contributes to a single
    # scheduler round (see SegmentScheduler.max_ready_per_stream).
    max_ready_per_tenant: int = 64
    # Flow control: the pump stops draining a tenant whose undecided
    # scheduler backlog passed this high-water mark, so the bounded
    # ingest queue (not the scheduler) absorbs the flood.
    max_inflight_segments: int = 512
    register_live: bool = True  # expose live_snapshot on web /live
    ledger: bool = True  # append one record per tenant stream on drain
    store_root: Optional[str] = None
    # Crash safety: when set, every decided segment appends one record
    # to <journal_dir>/<tenant>.jsonl under the fold lock, and a
    # restarted service REPLAYS the directory — reconnecting clients
    # resume from their journaled watermark instead of resubmitting
    # history.
    journal_dir: Optional[str] = None
    journal_fsync: bool = False  # fsync every record (slow, kill-safe)
    # Alerting plane (telemetry/alerts.py): evaluate the built-in rule
    # catalogue over this service's own registry/health on the pump
    # cadence (throttled to ALERT_EVAL_INTERVAL_S — no new thread) and
    # serve GET /alerts. Off by default; enabling any of the three
    # lazily imports telemetry/alerts.py. alerts_path makes the
    # lifecycle durable (alerts.jsonl, ConsistentLines discipline);
    # alerts_sink fans transitions to a webhook/ndjson target.
    alerts: bool = False
    alerts_path: Optional[str] = None
    alerts_sink: Optional[str] = None
    # The torch device of the scheduler's device oracle: None is the
    # card; "cpu" runs the plain versions of the kernels on the host.
    device: Any = None

    def __post_init__(self):
        if self.backpressure not in ("reject", "block"):
            raise ValueError(
                f"backpressure must be 'reject' or 'block', "
                f"got {self.backpressure!r}")
        if self.max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")


class _Tenant:
    """One tenant stream's service-side state."""

    def __init__(self, name: str, cfg: ServiceConfig):
        self.name = name
        self.queue: "queue.Queue" = queue.Queue(maxsize=cfg.queue_limit)
        self.segmenter = Segmenter()
        self.aborted = threading.Event()
        self.lock = threading.Lock()       # counters + token bucket
        self.lat_lock = threading.Lock()   # leaf: pending-latency deque
        self.lat_pending: "deque[tuple[int, int]]" = deque()
        self.ops_ingested = 0   # accepted into the queue
        self.ops_observed = 0   # fed through the segmenter
        # Segments the closed scheduler refused (a drain-deadline race):
        # the ops are observed but their verdict contribution is lost,
        # so a definite True can no longer cover the stream.
        self.lost_segments = False
        # Ingest-side taints: {taxonomy code: count} of trace lines /
        # ops the ?adapter= front door could not explain — the checked
        # history is incomplete, so the drain fold degrades ANY
        # definite verdict (True or False) to unknown, one-sidedly.
        self.taints: dict = {}
        self.rejected = {"quota": 0, "queue": 0, "aborted": 0}
        self.detection: Optional[dict] = None
        self.journal = None           # TenantJournal when journaling
        self.resumed: Optional[dict] = None  # journal replay summary
        # Highest watermark a SUCCESSFUL journal append has recorded —
        # the resume point a release/crash hands over (a swallowed
        # append must not advance it; the /healthz lag reads it).
        self.journaled_watermark = -1
        # release() flips this: the tenant is mid-migration, submits
        # 503 with a short Retry-After while the router flips placement.
        self.released = threading.Event()
        self.t0 = _time.monotonic()
        self.registered_at = _time.time()
        # Propagated cross-process trace context: (trace_id, parent
        # span id) from the newest submit that carried the headers,
        # and the span id of the service.ingest span recorded for it
        # (decide spans parent to it). Guarded by self.lock.
        self.trace: Optional[tuple] = None
        self.trace_span: Optional[str] = None
        # Whether an ingest span was recorded under self.trace ON THIS
        # backend: an adopt joins the context (so decide spans parent
        # right) without consuming the resumed feed's ingest span.
        self.trace_ingested = False
        # Token bucket (guarded by self.lock).
        self.allowance = float(cfg.quota_burst
                               if cfg.quota_burst is not None
                               else (cfg.quota_ops_per_s or 0) * 2.0)
        self.last_refill = _time.monotonic()


class Service:
    """The resident daemon: ``submit(tenant, op)`` in, per-tenant
    verdicts out, one shared device pipeline underneath."""

    def __init__(self, model, config: Optional[ServiceConfig] = None,
                 *, metrics=None, collector=None, flight=None,
                 name: str = "service", device=None,
                 **overrides) -> None:
        cfg = config or ServiceConfig()
        if device is not None:
            overrides["device"] = device
        if overrides:
            cfg = replace(cfg, **overrides)
        self.model = model
        self.config = cfg
        self.metrics = metrics
        # The span sink shared with the scheduler below: propagated
        # trace context (client → router → here) is recorded against
        # it, so cross-process spans land next to the in-process
        # op/segment/member/oracle chain and join on stream + index.
        self.collector = collector
        self.name = name
        self._tenants: dict[str, _Tenant] = {}
        # Tombstones of tenants released to another backend: _admit
        # refuses them (TenantMigratedError) so a stray direct-to-
        # backend retry can't fork the stream as a fresh tenant; an
        # explicit adopt (journal in hand) clears the tombstone.
        self._released_tenants: set[str] = set()
        self._tlock = threading.Lock()
        # Epoch fence (multi-router HA): the highest placement epoch
        # any /fence, /release or /adopt has presented; calls carrying
        # a LOWER epoch are refused with the typed 409 StaleEpochError
        # (guarded by _tlock).
        self._fence_epoch = -1
        self._draining = False
        self._drain_lock = threading.Lock()
        self._finished: Optional[dict] = None
        self._t0 = _time.monotonic()
        self.scheduler = SegmentScheduler(
            model, engine=cfg.engine, metrics=metrics,
            max_configs=cfg.max_configs, batch_f=cfg.batch_f,
            collector=collector, flight=flight,
            max_ready_per_stream=cfg.max_ready_per_tenant,
            device=cfg.device)
        self.device = self.scheduler.device
        # ONE decision-latency histogram family: the aggregate child is
        # the service-wide summary, {tenant} children the per-tenant
        # p99s the bench leg and /live rows report.
        _help = ("Per-op lag from observed invocation to decided-"
                 "watermark coverage, by tenant (unlabeled = all "
                 "tenants)")
        self._lat = (
            metrics.histogram("decision_latency_seconds", _help,
                              labelnames=("tenant",),
                              buckets=DECISION_LATENCY_BUCKETS,
                              aggregate=True)
            if metrics is not None else
            Histogram("decision_latency_seconds", _help,
                      labelnames=("tenant",),
                      buckets=DECISION_LATENCY_BUCKETS, aggregate=True))
        self.flight = flight
        # Journal replay runs BEFORE the pump thread exists: a raising
        # replay (model mismatch, unreadable dir) fails the ctor
        # without leaking a thread — including the scheduler's worker,
        # which already started above and must be closed on the way
        # out — and no submit can race the restore (restore_stream
        # requires a work-free stream).
        if cfg.journal_dir:
            try:
                with _flight.phase(flight, "service.replay"):
                    self._replay_journals(cfg.journal_dir)
            except BaseException:
                self.scheduler.close(timeout=10.0)
                raise
        # Alerting plane: built ONLY when configured (the off-path pin
        # — telemetry/alerts.py is never imported otherwise), and
        # evaluated from the pump thread on a throttle, never a new
        # thread.
        self.alert_engine = None
        self._sentinel = None
        self._alerts_mod = None
        self._next_alert_eval = 0.0
        self._alert_prev_ops: Optional[tuple] = None
        if cfg.alerts or cfg.alerts_path or cfg.alerts_sink:
            from ..telemetry import alerts as _alerts

            self._alerts_mod = _alerts
            sink = (_alerts.AlertSink(cfg.alerts_sink)
                    if cfg.alerts_sink else None)
            self._sentinel = _alerts.RegressionSentinel()
            self.alert_engine = _alerts.AlertEngine(
                metrics=metrics, path=cfg.alerts_path, sink=sink,
                source=self.name)
        self._wake = threading.Event()
        self._pump_stop = threading.Event()
        self._pump_thread = threading.Thread(
            target=self._pump, name="jepsen-service-pump", daemon=True)
        self._pump_thread.start()
        if cfg.register_live:
            try:
                from .. import web

                web.register_live_source(self.name, self.live_snapshot)
            except Exception:  # noqa: BLE001 - observability only
                LOG.warning("could not register live source",
                            exc_info=True)

    # -- the crash-safe verdict journal ---------------------------------------

    def _replay_journals(self, journal_dir: str) -> None:
        """Service restart: rebuild every journaled tenant's fold
        state (watermark, verdict counters, per-key carries, violation
        witness) and reopen its journal for appends. Raises the typed
        :class:`journal.JournalModelMismatchError` when a journal was
        written for a different model family — carried states must
        never cross folds."""
        from . import journal as _journal

        from urllib.parse import unquote as _unquote

        # Tombstones survive restarts: a `.jsonl.migrated` file marks
        # a tenant released to another backend — re-admitting it fresh
        # here would fork its history (the TenantMigratedError class
        # docstring's flip). An adopt (journal in hand) still clears
        # the tombstone.
        try:
            for name in os.listdir(journal_dir):
                if name.endswith(".jsonl.migrated"):
                    self._released_tenants.add(
                        _unquote(name[:-len(".jsonl.migrated")]))
        except FileNotFoundError:
            pass
        for tenant, path in _journal.scan(journal_dir).items():
            rep = _journal.replay(path, self.model)
            with self._tlock:
                if len(self._tenants) >= self.config.max_tenants:
                    raise TenantLimitError(
                        f"journal dir holds more tenants than "
                        f"max_tenants={self.config.max_tenants}")
                t = self._tenants[tenant] = _Tenant(tenant, self.config)
            self._restore_tenant(t, path, rep)
        if self.metrics is not None and self._tenants:
            self.metrics.gauge(
                "service_tenants",
                "Tenant streams currently admitted").set(
                    len(self._tenants))

    def _restore_tenant(self, t: _Tenant, path: str, rep: dict,
                        adopt_cause: Optional[str] = None) -> None:
        """Restore ONE tenant's fold state from a replayed journal —
        the one seam the ctor replay AND the router's ``adopt`` share
        (the two registration paths must not drift). The caller has
        already inserted ``t`` into ``_tenants``; ``adopt_cause`` is
        the migration reason the router passes (``backend_lost``)."""
        from . import journal as _journal

        tenant = t.name
        if rep.get("fresh"):
            # Empty journal / torn header (a crash inside the very
            # first write): nothing to restore — admit the tenant
            # fresh and REWRITE the header so the reopened file is
            # replayable next time. An ADOPT that lands here is
            # different: the router migrated a tenant it knows existed
            # on a lost backend, so the stream has a decided past no
            # carry enumerates — checking anything from the model's
            # init state could wrongly refute. Pin the stream unknown
            # with the migration cause (poisoned carries): strictly
            # one-sided, never a flip.
            if adopt_cause is None:
                self.scheduler.register_stream(
                    tenant, **self._stream_hooks(t))
            else:
                cc = _prov.add_counts({}, [adopt_cause])
                self.scheduler.restore_stream(
                    tenant, watermark=-1, next_seq=0, carry={},
                    carry_poisoned=True, n_decided=1, n_unknown=1,
                    cause_counts=cc, **self._stream_hooks(t))
                _prov.count_metric(self.metrics,
                                   [_prov.cause(adopt_cause)],
                                   tenant=tenant)
                t.resumed = {"records": 0, "watermark": -1,
                             "torn_tail": bool(rep.get("torn_tail")),
                             "degraded": True, "cause": adopt_cause}
            t.journal = _journal.TenantJournal(
                path, tenant, self.model,
                fsync=self.config.journal_fsync, fresh_header=True,
                truncate=True)
            LOG.warning("tenant %s: journal was empty/torn; "
                        "admitted %s", tenant,
                        "fresh" if adopt_cause is None
                        else f"pinned unknown ({adopt_cause})")
            return
        t.resumed = {
            "records": rep["records"],
            "watermark": rep["watermark"],
            "torn_tail": rep["torn_tail"],
        }
        if adopt_cause is not None:
            t.resumed["cause"] = adopt_cause
        if rep.get("degraded"):
            # Swallowed-append gap: the restored fold is pinned
            # unknown and carries are poisoned (journal.replay);
            # surface it on the tenant row too.
            t.resumed["degraded"] = True
        t.segmenter.resume(rep["watermark"] + 1, rep["next_seq"])
        if rep["violation"] is not None:
            t.detection = {}  # detection clock predates this run
            if self.config.abort_on_violation:
                t.aborted.set()
        self.scheduler.restore_stream(
            tenant,
            watermark=rep["watermark"],
            next_seq=rep["next_seq"],
            carry=rep["carry"],
            carry_poisoned=rep["carry_poisoned"],
            n_decided=rep["n_decided"],
            n_invalid=rep["n_invalid"],
            n_unknown=rep["n_unknown"],
            violation=rep["violation"],
            segments=rep["segments"],
            cause_counts=rep.get("cause_counts"),
            **self._stream_hooks(t))
        t.journal = _journal.TenantJournal(
            path, tenant, self.model,
            fsync=self.config.journal_fsync, fresh_header=False,
            truncate_to=(rep["consistent_bytes"]
                         if rep["torn_tail"] else None))
        t.journaled_watermark = rep["watermark"]
        self._set_journal_lag(t, rep["watermark"])
        LOG.info("tenant %s resumed from journal: watermark %d, "
                 "%d records%s", tenant, rep["watermark"],
                 rep["records"],
                 " (torn tail)" if rep["torn_tail"] else "")

    def _stream_hooks(self, t: _Tenant) -> dict:
        """The one hook triple every stream registration path
        (fresh admit, journal restore, empty-journal re-admit) wires —
        kept in one place so the paths cannot drift."""
        return {
            "on_watermark": lambda w, _t=t: self._on_watermark(_t, w),
            "on_violation": lambda v, _t=t: self._on_violation(_t, v),
            "on_segment": (lambda row, key, carry, w, _t=t:
                           self._on_segment(_t, row, key, carry, w)),
        }

    def _on_segment(self, t: _Tenant, row: dict, key: Any, carry: Any,
                    watermark: int) -> None:
        # Scheduler worker thread, fold lock held: the journal record
        # lands before any reader can observe the new fold state, so a
        # journaled watermark never runs ahead of it. Append failures
        # are swallowed inside append_segment (durability lost, verdict
        # unaffected).
        if t.journal is not None:
            if t.journal.append_segment(row, key, carry, watermark):
                # Only a SUCCESSFUL append advances the durable resume
                # point — a swallowed append's watermark was never
                # written, and handing it over would promise coverage
                # the file cannot deliver.
                t.journaled_watermark = watermark
        self._set_journal_lag(t, watermark)

    def _set_journal_lag(self, t: _Tenant, watermark: int) -> None:
        """``journal_lag_ops{tenant}``: ops this tenant has observed
        (by index) that a journaled watermark does not yet cover —
        what a crash right now would force the client to resubmit.
        Only meaningful WITH a journal: without one the gauge would
        imply a bounded loss that does not exist."""
        if self.metrics is None or t.journal is None:
            return
        lag = max(t.segmenter.next_index - (watermark + 1), 0)
        self.metrics.gauge(
            "journal_lag_ops",
            "Observed ops not yet covered by the journaled watermark, "
            "by tenant (what a crash would lose)",
            labelnames=("tenant",), aggregate=True).labels(
                tenant=t.name).set(lag)

    # -- admission -----------------------------------------------------------

    def register(self, tenant: str) -> None:
        """Admit a tenant explicitly (submit() auto-admits). Raises
        :class:`ServiceClosedError` / :class:`TenantLimitError`."""
        self._admit(tenant)

    def _admit(self, tenant: str) -> _Tenant:
        if not isinstance(tenant, str) or not tenant:
            raise ServiceError(f"invalid tenant name {tenant!r}")
        with self._tlock:
            if self._draining:
                raise ServiceClosedError("service is draining")
            t = self._tenants.get(tenant)
            if t is not None:
                return t
            if tenant in self._released_tenants:
                raise TenantMigratedError(
                    f"tenant {tenant!r} was migrated off this "
                    "backend; submit through the router")
            if len(self._tenants) >= self.config.max_tenants:
                raise TenantLimitError(
                    f"max_tenants={self.config.max_tenants} reached; "
                    f"tenant {tenant!r} rejected")
            t = self._tenants[tenant] = _Tenant(tenant, self.config)
            self.scheduler.register_stream(
                tenant, **self._stream_hooks(t))
            if self.config.journal_dir:
                from . import journal as _journal

                try:
                    t.journal = _journal.TenantJournal(
                        _journal.tenant_path(self.config.journal_dir,
                                             tenant),
                        tenant, self.model,
                        fsync=self.config.journal_fsync)
                except Exception:  # noqa: BLE001 - durability only
                    LOG.warning("could not open journal for tenant %s",
                                tenant, exc_info=True)
            if self.metrics is not None:
                self.metrics.gauge(
                    "service_tenants",
                    "Tenant streams currently admitted").set(
                        len(self._tenants))
            return t

    def _take_token(self, t: _Tenant) -> None:
        rate = self.config.quota_ops_per_s
        if rate is None:
            return
        with t.lock:
            now = _time.monotonic()
            burst = (self.config.quota_burst
                     if self.config.quota_burst is not None
                     else rate * 2.0)
            t.allowance = min(burst,
                              t.allowance + (now - t.last_refill) * rate)
            t.last_refill = now
            if t.allowance < 1.0:
                t.rejected["quota"] += 1
                self._count_reject(t, "quota")
                err = QuotaExceededError(
                    f"tenant {t.name!r} over its {rate} ops/s quota")
                # Refill estimate: seconds until the bucket holds one
                # whole token again — the HTTP Retry-After value.
                err.retry_after_s = round((1.0 - t.allowance) / rate, 3)
                raise err
            t.allowance -= 1.0

    def _count_reject(self, t: _Tenant, reason: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                "service_rejects_total",
                "Submits rejected by admission control / backpressure",
                labelnames=("tenant", "reason")).labels(
                    tenant=t.name, reason=reason).inc()

    # -- live migration (the router's adopt/release seams) -------------------

    def _check_epoch(self, epoch: Optional[int]) -> None:
        """The fencing primitive: a ``/release``/``/adopt`` carrying a
        placement epoch BELOW the fence is a stale ex-router's
        in-flight migration — refuse it (typed 409) before it can
        split ownership; an equal-or-higher epoch ratchets the fence
        up. Epoch-less calls (direct operator curl, pre-epoch tests)
        pass: fencing is opt-in per caller, the ratchet only ever
        rises."""
        if epoch is None:
            return
        if not isinstance(epoch, int):
            raise ServiceError(f"invalid epoch {epoch!r}")
        with self._tlock:
            if epoch < self._fence_epoch:
                raise StaleEpochError(
                    f"epoch {epoch} is stale: this backend is fenced "
                    f"at epoch {self._fence_epoch} (a newer router "
                    "generation owns the fleet)")
            self._fence_epoch = epoch

    def fence(self, epoch: int) -> dict:
        """Raise the epoch fence explicitly (``POST /fence`` — a
        restarted router fences every live backend at its new epoch
        during reconciliation, so a stale ex-router is refused even on
        backends its own migrations never touched)."""
        if not isinstance(epoch, int):
            raise ServiceError(f"invalid epoch {epoch!r}")
        self._check_epoch(epoch)
        return {"ok": True, "epoch": epoch, "service": self.name}

    def adopt(self, tenant: str, journal_text: Any,
              cause: Optional[str] = None,
              epoch: Optional[int] = None,
              trace: Optional[tuple] = None) -> dict:
        """Adopt one migrated tenant: write its journal (handed over
        by the router — the tenant's complete checkpoint) under this
        backend's ``journal_dir`` and replay it behind ADMISSION —
        draining, double-adopt (typed 409) and ``max_tenants`` all
        refuse before a byte of fold state lands. On success the
        tenant is live here exactly as after a restart: the
        reconnecting client resumes from the returned watermark, and
        resubmitted covered ops are dropped server-side. ``cause``
        (``backend_lost``) pins a journal that restores NOTHING to an
        unknown fold — the tenant demonstrably had a past this backend
        cannot check from. A failed adopt removes the written file so
        the NEXT restart's ctor replay cannot trip over it."""
        from . import journal as _journal

        self._check_epoch(epoch)  # fencing outranks every other check
        if not self.config.journal_dir:
            raise AdoptUnsupportedError(
                "this backend runs without --journal-dir; it cannot "
                "adopt a migrated tenant")
        if not isinstance(tenant, str) or not tenant:
            raise ServiceError(f"invalid tenant name {tenant!r}")
        if cause is not None:
            _prov.cause(cause)  # closed-taxonomy validation, up front
        data = (journal_text.encode("utf-8")
                if isinstance(journal_text, str) else bytes(journal_text))
        path = _journal.tenant_path(self.config.journal_dir, tenant)
        # Phase 1, under _tlock: admission checks + a GATED
        # placeholder (released ⇒ submits 503 with Retry-After while
        # the restore runs). The expensive replay happens OUTSIDE the
        # lock — _admit shares _tlock, and holding it through a
        # 100k-record replay would freeze every OTHER tenant's
        # ingestion on this backend.
        with self._tlock:
            if self._draining:
                raise ServiceClosedError("service is draining")
            if tenant in self._tenants:
                raise TenantAdoptConflictError(
                    f"tenant {tenant!r} already lives on this backend")
            if len(self._tenants) >= self.config.max_tenants:
                raise TenantLimitError(
                    f"max_tenants={self.config.max_tenants} reached; "
                    f"cannot adopt tenant {tenant!r}")
            if os.path.exists(path):
                raise TenantAdoptConflictError(
                    f"a journal for tenant {tenant!r} already exists "
                    "on this backend")
            t = self._tenants[tenant] = _Tenant(tenant, self.config)
            t.released.set()  # gate: not ready until phase 3
            # An adopt legitimately re-owns a name this backend once
            # released (a rebalance round-trip): clear the tombstone —
            # but remember it, so a FAILED adopt restores it (dropping
            # it would re-open the fresh-stream fork the tombstone
            # exists to prevent, until the next restart re-scans the
            # .migrated file).
            was_tombstoned = tenant in self._released_tenants
            self._released_tenants.discard(tenant)

        def _undo():
            with self._tlock:
                self._tenants.pop(tenant, None)
                if was_tombstoned:
                    self._released_tenants.add(tenant)
            for p in (tmp, path):
                try:
                    os.remove(p)
                except OSError:
                    pass

        # Phase 2, no lock: write the journal and replay it.
        tmp = f"{path}.{os.getpid()}.adopt"
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
            rep = _journal.replay(path, self.model)
        except BaseException:
            _undo()
            raise
        # Phase 3, under _tlock: wire the restored fold in and open
        # the gate. restore_stream requires a work-free stream — the
        # gate guaranteed no submit touched the placeholder.
        with self._tlock:
            try:
                if self._draining:
                    raise ServiceClosedError("service is draining")
                self._restore_tenant(t, path, rep, adopt_cause=cause)
            except BaseException:
                self._tenants.pop(tenant, None)
                if was_tombstoned:
                    self._released_tenants.add(tenant)
                try:
                    os.remove(path)
                except OSError:
                    pass
                raise
            t.released.clear()
            # A re-adopt back onto a backend that once released this
            # tenant: the old `.migrated` artifact is now stale — the
            # fresh journal is authoritative — and leaving it would
            # let a FUTURE migration's rescue path hand out an ancient
            # checkpoint.
            try:
                os.remove(path + ".migrated")
            except OSError:
                pass
            if self.metrics is not None:
                self.metrics.gauge(
                    "service_tenants",
                    "Tenant streams currently admitted").set(
                        len(self._tenants))
        LOG.info("adopted tenant %s (watermark %d, %d records%s)",
                 tenant, rep.get("watermark", -1),
                 rep.get("records", 0),
                 f", cause={cause}" if cause else "")
        # The resume end of a migration handover: recorded against the
        # router-propagated trace context so the tenant's life on THIS
        # backend joins the same trace that covered its life on the
        # source backend and the router's migration span between them.
        self._record_trace(t, trace, "service.adopt",
                           watermark=rep.get("watermark", -1),
                           cause=cause, epoch=epoch)
        return {
            "tenant": tenant,
            "watermark": rep.get("watermark", -1),
            "records": rep.get("records", 0),
            "fresh": bool(rep.get("fresh")),
            "torn_tail": bool(rep.get("torn_tail")),
            "resumed": dict(t.resumed) if t.resumed is not None else None,
        }

    def release(self, tenant: str,
                timeout: Optional[float] = 30.0,
                epoch: Optional[int] = None) -> dict:
        """Live-migration handover of one tenant: stop admitting its
        ops (submits 503 with ``Retry-After`` — the router holds the
        client off while placement flips), QUIESCE it (queue drained,
        every accepted op fed, no undecided segments — so the journal
        is a complete checkpoint through the fold watermark), then
        close the journal, hand its content back, rename the file
        (``.migrated`` — a restart of THIS backend must not re-replay
        a tenant that now lives elsewhere) and forget the tenant. A
        quiesce that outlives ``timeout`` still hands over the journal
        — the un-fed tail sits above the journaled watermark, so the
        client's resume re-submits it on the target: coverage lost,
        never a verdict flipped."""
        from . import journal as _journal

        self._check_epoch(epoch)  # fencing outranks every other check
        with self._tlock:
            if self._draining:
                raise ServiceClosedError("service is draining")
            t = self._tenants.get(tenant)
            if t is None:
                raise UnknownTenantError(
                    f"tenant {tenant!r} does not live on this backend")
            if t.journal is None:
                raise AdoptUnsupportedError(
                    f"tenant {tenant!r} has no journal; there is no "
                    "checkpoint to hand over")
            if t.released.is_set():
                raise TenantMigratingError(
                    f"tenant {tenant!r} is already being released")
            t.released.set()
        deadline = ((_time.monotonic() + timeout)
                    if timeout is not None else None)
        quiesced = False
        while True:
            with t.lock:
                fed = t.ops_observed == t.ops_ingested
            if (fed and t.queue.qsize() == 0
                    and self.scheduler.stream_backlog(tenant) == 0):
                quiesced = True
                break
            self._wake.set()
            if deadline is not None and _time.monotonic() > deadline:
                break
            _time.sleep(0.002)
        # After quiesce no appender is left (on_segment fires under the
        # fold lock BEFORE the backlog reaches 0), so the file content
        # IS the checkpoint. Close first: a post-handover append must
        # fail (counted, swallowed), never extend a handed-over file.
        t.journal.close()
        path = _journal.tenant_path(self.config.journal_dir, tenant)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            # The handover failed BEFORE anything moved: un-release so
            # the tenant is not wedged behind a permanent 503 — reopen
            # the journal for appends where the file still exists
            # (where it vanished, appends stay swallowed-and-counted:
            # rewriting a fresh header over a stream with a decided
            # past would make the NEXT restart check it from init).
            if os.path.exists(path):
                try:
                    t.journal = _journal.TenantJournal(
                        path, tenant, self.model,
                        fsync=self.config.journal_fsync,
                        fresh_header=False)
                except Exception:  # noqa: BLE001 - durability only
                    LOG.warning("could not reopen journal for tenant "
                                "%s after a failed release", tenant,
                                exc_info=True)
            t.released.clear()
            raise ServiceError(
                f"journal for tenant {tenant!r} unreadable: {e}")
        try:
            os.replace(path, path + ".migrated")
        except OSError:
            pass
        with self._tlock:
            self._tenants.pop(tenant, None)
            # Tombstone: a stray direct-to-backend retry must get a
            # typed 410, never a silent fresh stream (fork).
            self._released_tenants.add(tenant)
            if self.metrics is not None:
                self.metrics.gauge(
                    "service_tenants",
                    "Tenant streams currently admitted").set(
                        len(self._tenants))
        removed = self.scheduler.remove_stream(tenant)
        LOG.info("released tenant %s (journaled watermark %d, "
                 "quiesced=%s)", tenant, t.journaled_watermark,
                 quiesced)
        return {
            "tenant": tenant,
            "watermark": t.journaled_watermark,
            "quiesced": quiesced,
            "stream_removed": removed,
            "journal": data.decode("utf-8", "replace"),
        }

    def health_snapshot(self) -> dict:
        """The enriched ``GET /healthz`` document: liveness plus the
        per-tenant overload signals (undecided-segment backlog,
        ``journal_lag_ops``, ``degraded``) the router — or any
        external load balancer — needs for placement and rebalancing
        decisions without scraping ``/metrics``."""
        with self._tlock:
            items = list(self._tenants.items())
            draining = self._draining
        tenants: dict[str, dict] = {}
        for name, t in items:
            ss = self.scheduler.stream_stats(name)
            row: dict = {
                "backlog": ss.get("backlog", 0) or 0,
                "queue_depth": t.queue.qsize(),
                "watermark": ss.get("decided_through_index"),
                "degraded": bool(
                    t.lost_segments or ss.get("segments_unknown")
                    or (t.journal is not None
                        and t.journal.append_failures)),
            }
            if t.journal is not None:
                row["journal_lag_ops"] = max(
                    t.segmenter.next_index
                    - (t.journaled_watermark + 1), 0)
                if t.journal.append_failures:
                    # Durability compromised (the journal_errors alert
                    # predicate reads this; degraded above already
                    # folded it in).
                    row["journal_append_failures"] = \
                        t.journal.append_failures
            tenants[name] = row
        return {
            "ok": True,
            "service": self.name,
            "draining": draining,
            "fence_epoch": self._fence_epoch,
            "tenant_count": len(items),
            "scheduler_backlog": self.scheduler.backlog,
            "tenants": tenants,
        }

    # -- ingestion -----------------------------------------------------------

    def _record_trace(self, t: _Tenant, trace: Optional[tuple],
                      name: str, **attrs) -> None:
        """Record one point-span against the propagated trace context
        (no-op without a collector or context). The first span a new
        context mints (``service.ingest``) is remembered as the parent
        for this tenant's later ``service.decide`` spans — the
        cross-process hop stays one tree per backend visit."""
        if self.collector is None:
            return
        ctx = trace
        with t.lock:
            if ctx is None:
                ctx = t.trace
            elif ctx != t.trace:
                t.trace = ctx
                t.trace_span = None  # new context: new subtree root
                t.trace_ingested = False
            parent_span = t.trace_span
        if ctx is None:
            return
        now = _time.monotonic_ns()
        rec = self.collector.record(
            name, start_ns=now, end_ns=now, trace_id=ctx[0],
            parent_id=parent_span if parent_span is not None else ctx[1],
            stage="service", tenant=t.name, service=self.name, **attrs)
        if parent_span is None:
            with t.lock:
                t.trace_span = rec["span_id"]

    def submit(self, tenant: str, op: Any,
               trace: Optional[tuple] = None) -> None:
        """Accept one history op for ``tenant`` (auto-admitting it).
        Raises the typed rejections documented on the class; an
        accepted op WILL be fed through the tenant's segmenter (unless
        drain's deadline truncates the stream — reported per tenant as
        ``undelivered_ops``). ``trace`` is the propagated cross-process
        trace context ``(trace_id, parent_span_id)`` — recorded once
        per context as a ``service.ingest`` span, not per op."""
        t = self._admit(tenant)
        if trace is not None and self.collector is not None:
            with t.lock:
                is_new = trace != t.trace or not t.trace_ingested
            if is_new:
                self._record_trace(
                    t, trace, "service.ingest",
                    next_index=t.segmenter.next_index)
                with t.lock:
                    t.trace_ingested = True
        if t.released.is_set():
            raise TenantMigratingError(
                f"tenant {t.name!r} is being migrated to another "
                "backend; retry against the router")
        if t.aborted.is_set():
            t.rejected["aborted"] += 1
            self._count_reject(t, "aborted")
            raise TenantAbortedError(
                f"tenant {t.name!r} aborted on a linearizability "
                "violation")
        self._take_token(t)
        # The ingest timestamp rides the queue with the op: decision
        # latency must include queue wait (a flow-controlled tenant's
        # ops CAN sit here for seconds — a p99 stamped at pump-feed
        # time would hide exactly the regression the benchcmp gate
        # watches).
        item = (_decode_kv(op), _time.monotonic_ns())
        try:
            if self.config.backpressure == "block":
                t.queue.put(item, timeout=self.config.block_timeout_s)
            else:
                t.queue.put_nowait(item)
        except queue.Full:
            t.rejected["queue"] += 1
            self._count_reject(t, "queue")
            err = IngestQueueFullError(
                f"tenant {t.name!r} ingest queue full "
                f"({self.config.queue_limit} ops)")
            err.retry_after_s = QUEUE_RETRY_AFTER_S
            raise err from None
        with t.lock:
            t.ops_ingested += 1
        self._wake.set()

    def taint(self, tenant: str, code: str, count: int = 1) -> None:
        """Record ``count`` occurrences of a typed degradation the
        caller observed while producing this tenant's ops (the ingest
        front door's unmapped trace lines: ``ingest_unmapped_op``).
        A tainted tenant's drain verdict folds one-sidedly to unknown
        — the checked history is known to be incomplete, so neither a
        definite True nor a definite False may stand. ``code`` must be
        in the closed provenance taxonomy."""
        _prov.cause(code)  # closed-taxonomy validation
        if count < 1:
            return
        t = self._admit(tenant)
        with t.lock:
            t.taints[code] = t.taints.get(code, 0) + int(count)

    # -- the pump ------------------------------------------------------------

    # Ops drained per tenant per sweep: small enough that a flooding
    # tenant cannot monopolize the pump between a trickle tenant's
    # visits, large enough to amortize the sweep.
    PUMP_BATCH = 256

    def _pump(self) -> None:
        # Single consumer for every tenant queue: offers ops to each
        # tenant's segmenter IN ORDER and submits closed segments to
        # the shared scheduler. Exception-guarded — a pump death stops
        # consumption, which the bounded queues turn into backpressure
        # rather than silent loss.
        try:
            while not self._pump_stop.is_set():
                if not self._pump_once():
                    self._wake.wait(0.05)
                    self._wake.clear()
                # Alerting rides the existing sweep cadence (throttled
                # inside; no-op without an alert config).
                self._maybe_evaluate_alerts()
        except Exception:  # noqa: BLE001
            LOG.error("service pump died; ingest queues will fill",
                      exc_info=True)

    def _pump_once(self) -> bool:
        """One round-robin sweep over the tenants; returns whether any
        op moved."""
        # Chaos seam, BEFORE any op is popped: an injected raise kills
        # the pump with every accepted op still queued — the bounded
        # queues turn the death into backpressure, and drain's
        # synchronous flush feeds everything in order, so the fault
        # costs latency, never a verdict.
        _chaos.fire("service.pump")
        with self._tlock:
            tenants = list(self._tenants.values())
        moved = False
        for t in tenants:
            # Flow control: a tenant whose undecided segments passed
            # the high-water mark stops being drained — its bounded
            # queue fills and submit() pushes back — EXCEPT while
            # draining, when the goal is to finish what was accepted.
            if (not self._draining
                    and self.scheduler.stream_backlog(t.name)
                    >= self.config.max_inflight_segments):
                continue
            for _ in range(self.PUMP_BATCH):
                try:
                    item = t.queue.get_nowait()
                except queue.Empty:
                    break
                moved = True
                self._feed(t, item)
        return moved

    def _feed(self, t: _Tenant, item: tuple) -> None:
        op, t_ns = item
        try:
            segs = t.segmenter.offer(op)
        except Exception:  # noqa: BLE001 - one tenant's malformed op
            # must never kill the shared pump (ingest is an external
            # surface); the op is counted and dropped, the stream's
            # already-accepted prefix keeps deciding.
            LOG.warning("tenant %s: dropping malformed op", t.name,
                        exc_info=True)
            with t.lock:
                t.ops_observed += 1
                t.rejected["malformed"] = (
                    t.rejected.get("malformed", 0) + 1)
            self._count_reject(t, "malformed")
            return
        last = t.segmenter.last_op
        if last is not None and last.is_client and last.is_invoke:
            # The pump is the single feeder, so appends land in index
            # order — the watermark pop loop's invariant. Stamped with
            # the INGEST time carried through the queue, and appended
            # BEFORE the scheduler submit so a fast decide can't fire
            # the watermark past an invocation not yet pending.
            with t.lat_lock:
                t.lat_pending.append((last.index, t_ns))
        if segs:
            try:
                self.scheduler.submit(segs, stream=t.name)
            except RuntimeError:
                # Scheduler closed (worker died / drain raced): these
                # segments are LOST — mark the stream so drain degrades
                # a would-be definite True to unknown (it no longer
                # covers the whole stream); the pump must survive.
                t.lost_segments = True
                LOG.warning("scheduler rejected segments of tenant %s",
                            t.name)
        # Counted observed only AFTER any segments were submitted:
        # flush()'s "everything accepted is decided" reads
        # ops_observed == ops_ingested, then waits for scheduler
        # idleness — counting earlier would let flush return between
        # the count and the submit.
        with t.lock:
            t.ops_observed += 1

    # -- the alert plane ----------------------------------------------------

    def _maybe_evaluate_alerts(self, now: Optional[float] = None
                               ) -> list:
        """One throttled alert pass (the pump-loop hook): samples from
        this service's registry, the /healthz document, and the
        change-point sentinel fed the live sustained-ops/s and p99
        windows. Fully guarded — alerting must never kill the pump."""
        eng = self.alert_engine
        if eng is None:
            return []
        now = _time.monotonic() if now is None else now
        if now < self._next_alert_eval:
            return []
        self._next_alert_eval = (
            now + self._alerts_mod.ALERT_EVAL_INTERVAL_S)
        try:
            sentinel: list = []
            if self._sentinel is not None:
                with self._tlock:
                    tenants = list(self._tenants.values())
                total = 0
                for t in tenants:
                    with t.lock:
                        total += t.ops_observed
                if self._alert_prev_ops is not None:
                    t_prev, n_prev = self._alert_prev_ops
                    dt = now - t_prev
                    if dt > 0:
                        self._sentinel.observe(
                            f"{self.name}:ops_per_s",
                            (total - n_prev) / dt,
                            lower_is_better=False)
                self._alert_prev_ops = (now, total)
                p99 = self._lat.quantile(0.99)
                if p99 is not None:
                    self._sentinel.observe(
                        f"{self.name}:p99_decision_latency_s", p99,
                        lower_is_better=True)
                sentinel = self._sentinel.active()
            return eng.evaluate({
                "samples": (self.metrics.collect()
                            if self.metrics is not None else []),
                "health": self.health_snapshot(),
                "sentinel": sentinel,
            })
        except Exception:  # noqa: BLE001 - observability only
            LOG.warning("alert evaluation failed", exc_info=True)
            return []

    def alerts_snapshot(self) -> dict:
        """The service ``GET /alerts`` document ({"enabled": False}
        without an alert config)."""
        if self.alert_engine is None:
            return {"enabled": False, "service": self.name}
        return {"service": self.name, **self.alert_engine.snapshot()}

    # -- scheduler hooks (worker thread, scheduler lock held) ----------------

    def _on_watermark(self, t: _Tenant, w: int) -> None:
        now_ns = _time.monotonic_ns()
        popped = 0
        with t.lat_lock:
            while t.lat_pending and t.lat_pending[0][0] <= w:
                _idx, t_ns = t.lat_pending.popleft()
                lat = max(now_ns - t_ns, 0) / 1e9
                self._lat.observe(lat)  # aggregate (all tenants)
                self._lat.labels(tenant=t.name).observe(lat)
                popped += 1
        if popped and self.collector is not None:
            # One decide span per watermark advance (never per op):
            # the propagated trace's proof that ops SUBMITTED under it
            # were DECIDED here — the "…→ resume → decide" tail of the
            # cross-process chain.
            self._record_trace(t, None, "service.decide",
                               watermark=w, ops_covered=popped)

    def _on_violation(self, t: _Tenant, violation: dict) -> None:
        with t.lock:
            if t.detection is None:
                t.detection = {
                    "ops_to_detection": t.ops_observed,
                    "seconds_to_detection": round(
                        _time.monotonic() - t.t0, 4),
                }
        if self.config.abort_on_violation:
            LOG.warning(
                "service tenant %s hit a linearizability violation "
                "(segment seq %s); aborting that tenant",
                t.name, violation.get("segment", {}).get("seq"))
            t.aborted.set()

    # -- observation ---------------------------------------------------------

    def tenants(self) -> list[str]:
        with self._tlock:
            return sorted(self._tenants)

    def tenant_snapshot(self, tenant: str) -> Optional[dict]:
        with self._tlock:
            t = self._tenants.get(tenant)
        if t is None:
            return None
        ss = self.scheduler.stream_stats(t.name)
        with t.lat_lock:
            undecided = len(t.lat_pending)
        with t.lock:
            snap = {
                "ops_ingested": t.ops_ingested,
                "ops_observed": t.ops_observed,
                "rejected": dict(t.rejected),
            }
        snap.update({
            "queue_depth": t.queue.qsize(),
            "watermark": ss.get("decided_through_index"),
            "backlog": ss.get("backlog"),
            "segments_decided": ss.get("segments_decided"),
            "verdict": str(ss.get("verdict")),
            "undecided_ops": undecided,
            "aborted": t.aborted.is_set(),
            # Degraded = this tenant's definite-True coverage is
            # already compromised (lost segments at a closed
            # scheduler, unknown-folded segments from a crashed round
            # / failover that couldn't decide) — the /live row flag.
            "degraded": bool(t.lost_segments or t.taints
                             or ss.get("segments_unknown")),
            "decision_latency": self._lat.stats(
                labels={"tenant": t.name}),
        })
        # Why-unknown provenance: the scheduler's per-stream cause
        # union plus the service-layer degradations this tenant hit.
        prov_counts = dict(
            (ss.get("provenance") or {}).get("causes") or {})
        if t.lost_segments:
            _prov.add_counts(prov_counts, ["lost_segments"])
        if t.taints:
            with t.lock:
                prov_counts = _prov.merge_counts(
                    prov_counts,
                    {code: int(n) for code, n in t.taints.items()})
        if prov_counts:
            snap["provenance"] = _prov.block(prov_counts)
            # The /live row's one-glance answer to "why unknown".
            snap["dominant_unknown_cause"] = _prov.dominant(prov_counts)
        if t.resumed is not None:
            snap["resumed_from_journal"] = dict(t.resumed)
        if t.segmenter.dropped_covered:
            # Resubmitted ops at/below the stream's high-water mark
            # the server dropped — the restored-journal floor, or a
            # LIVE stream's lost-response/rewind overlap (re-checking
            # either from the current carries could flip a verdict:
            # the resume protocol is enforced, not trusted).
            snap["resubmitted_ops_dropped"] = \
                t.segmenter.dropped_covered
        if t.journal is not None and t.journal.append_failures:
            # Durability (not verdict) is compromised: a crash now
            # would lose more than the journaled watermark admits.
            snap["journal_append_failures"] = t.journal.append_failures
            snap["degraded"] = True
        if t.detection is not None:
            snap.update(t.detection)
        return snap

    def live_snapshot(self) -> dict:
        """One point-in-time operational view — the web ``/live``
        line: service totals plus one row per tenant (watermark,
        queue/backlog depths, verdict, per-tenant decision latency).
        Tenants are listed in REGISTRATION order (stable across
        polls)."""
        with self._tlock:
            items = sorted(self._tenants.items(),
                           key=lambda kv: kv[1].registered_at)
        rows = {name: self.tenant_snapshot(name) for name, _t in items}
        totals_obs = sum((r or {}).get("ops_observed") or 0
                         for r in rows.values())
        doc = {
            "run": self.name,
            "service": True,
            "t": round(_time.time(), 3),
            "draining": self._draining,
            "tenant_count": len(rows),
            "ops_observed": totals_obs,
            "scheduler_backlog": self.scheduler.backlog,
            "queue_depths": self.scheduler.queue_depths(),
            "decision_latency": self._lat.stats(),
            "tenants": rows,
        }
        if self.alert_engine is not None:
            # The /live badge row: which rules are firing right now.
            doc["alerts"] = sorted(self.alert_engine.firing())
        return doc

    # -- drain / shutdown ----------------------------------------------------

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted op has been fed through its
        segmenter AND the scheduler has decided everything submitted —
        the tests'/bench's sync point (drain() is the terminal one)."""
        deadline = ((_time.monotonic() + timeout)
                    if timeout is not None else None)
        while True:
            with self._tlock:
                tenants = list(self._tenants.values())
            settled = all(t.queue.qsize() == 0 for t in tenants)
            if settled:
                for t in tenants:
                    with t.lock:
                        if t.ops_observed != t.ops_ingested:
                            settled = False
                            break
            if settled and self.scheduler.wait_idle(0.05):
                self._raise_fatal()
                return True
            self._wake.set()
            if deadline is not None and _time.monotonic() > deadline:
                return False
            _time.sleep(0.002)

    def drain(self, timeout: Optional[float] = 120.0) -> dict:
        """Graceful shutdown: stop admitting, flush every tenant's
        queue through its segmenter, fold the terminal segments, close
        the shared scheduler, and return per-tenant partial results.
        Idempotent — a second (or concurrent: the CLI's Ctrl-C racing
        an HTTP POST /drain) call returns the first result. A
        deterministic device error of any round is raised instead, by
        every call (the result is kept as ``finished``)."""
        with self._drain_lock:
            fin = self._drain_locked(timeout)
        self._raise_fatal()
        return fin

    @property
    def finished(self) -> Optional[dict]:
        """The drain result, once a drain has run (None before)."""
        return self._finished

    def _drain_locked(self, timeout: Optional[float]) -> dict:
        if self._finished is not None:
            return self._finished
        deadline = ((_time.monotonic() + timeout)
                    if timeout is not None else None)
        with self._tlock:
            self._draining = True
            tenants = list(self._tenants.values())
        # Stop the pump and flush the accepted backlog synchronously:
        # deterministic in-order feeding per tenant, immune to a
        # stalled/dead pump, and the scheduler keeps deciding
        # concurrently underneath. The pump MUST actually be gone
        # before drain touches the segmenters — two concurrent feeders
        # would corrupt them — so if it outlives the deadline (a
        # pathologically slow sweep), the sync flush and the terminal
        # fold are SKIPPED; the unfed ops surface as undelivered_ops.
        self._pump_stop.set()
        self._wake.set()
        while self._pump_thread.is_alive():
            self._pump_thread.join(0.1)
            if deadline is not None and _time.monotonic() > deadline:
                break
        pump_gone = not self._pump_thread.is_alive()
        if not pump_gone:
            LOG.warning("service pump still running at the drain "
                        "deadline; skipping the synchronous flush")
        for t in (tenants if pump_gone else ()):
            # Anything still queued past the deadline is reported,
            # never silently dropped.
            while True:
                if deadline is not None and _time.monotonic() > deadline:
                    break
                try:
                    item = t.queue.get_nowait()
                except queue.Empty:
                    break
                self._feed(t, item)
            tail = t.segmenter.finish()
            if tail:
                try:
                    self.scheduler.submit(tail, stream=t.name)
                except RuntimeError:
                    LOG.warning("scheduler closed before tenant %s's "
                                "terminal segment", t.name)
        left = (max(deadline - _time.monotonic(), 1.0)
                if deadline is not None else None)
        self.scheduler.close(timeout=left)
        wall = _time.monotonic() - self._t0
        results: dict[str, dict] = {}
        for t in tenants:
            res = self.scheduler.stream_result(t.name)
            lat = self._lat.stats(labels={"tenant": t.name})
            with t.lat_lock:
                lat["undecided_ops"] = len(t.lat_pending)
            with t.lock:
                out = {
                    "valid": res["valid"],
                    "ops_ingested": t.ops_ingested,
                    "ops_observed": t.ops_observed,
                    "rejected": dict(t.rejected),
                }
                # Count-based, not a queue-size snapshot: an op whose
                # blocked put() raced past the flush (or one stranded
                # by a skipped flush) is ACCEPTED-but-unfed and must
                # surface here, not vanish.
                undelivered = t.ops_ingested - t.ops_observed
            out.update({
                "decided_through_index": res["decided_through_index"],
                "segments_decided": res["segments_decided"],
                "aborted": t.aborted.is_set(),
                "decision_latency": lat,
                "segments": res["segments"],
            })
            svc_causes: list = []
            if undelivered > 0:
                out["undelivered_ops"] = undelivered
                # A queue truncated by the drain deadline means the
                # verdict covers only the observed prefix.
                out["info"] = ("drain deadline truncated the stream; "
                               "verdict covers the observed prefix")
                svc_causes.append(_prov.cause("undelivered_ops",
                                              count=undelivered))
            if t.lost_segments and out["valid"] is True:
                # Segments were dropped at a closed scheduler: a
                # definite True must cover the whole stream, and this
                # one cannot. (An invalid verdict stands — the
                # refutation evidence is real regardless.)
                out["valid"] = "unknown"
                out["info"] = ("segments lost after scheduler close; "
                               "verdict degraded to unknown")
            if t.lost_segments:
                svc_causes.append(_prov.cause("lost_segments"))
            # Per-tenant provenance: the scheduler's per-stream cause
            # union plus the service-layer degradations above.
            prov_counts = _prov.add_counts(dict(
                (res.get("provenance") or {}).get("causes") or {}),
                svc_causes)
            with t.lock:
                taints = dict(t.taints)
            if taints:
                # Ingest taints (unexplained trace lines behind the
                # ?adapter= front door): the checked history is
                # incomplete, so BOTH a definite True (a dropped write
                # could be the anomaly) and a definite False (a
                # dropped write could explain the impossible read)
                # fold to unknown. One-sided — never a flip.
                out["tainted_ops"] = int(sum(taints.values()))
                if out["valid"] != "unknown":
                    out["valid"] = "unknown"
                    out["info"] = ("ingest taints (unexplained trace "
                                   "lines); verdict degraded to "
                                   "unknown")
                svc_causes.extend(
                    _prov.cause(code, count=int(n))
                    for code, n in sorted(taints.items()))
                prov_counts = _prov.merge_counts(
                    prov_counts,
                    {code: int(n) for code, n in taints.items()})
            if out["valid"] not in (True, False) and not prov_counts:
                # The one unknown no segment record explains: work
                # still in flight when the drain deadline closed the
                # scheduler (undecided ≠ degraded, but the tenant's
                # answer is still unknown and must say why).
                dl = _prov.cause("deadline")
                svc_causes.append(dl)
                _prov.add_counts(prov_counts, [dl])
            if svc_causes:
                _prov.count_metric(self.metrics, svc_causes,
                                   tenant=t.name)
            if prov_counts:
                out["provenance"] = _prov.block(prov_counts)
            if t.resumed is not None:
                out["resumed_from_journal"] = dict(t.resumed)
            if t.segmenter.dropped_covered:
                out["resubmitted_ops_dropped"] = \
                    t.segmenter.dropped_covered
            if t.journal is not None:
                if t.journal.append_failures:
                    out["journal_append_failures"] = \
                        t.journal.append_failures
                t.journal.close()
            if t.detection is not None:
                out.update(t.detection)
            if res.get("violation") is not None:
                out["violation"] = res["violation"]
            if res.get("failover") is not None:
                # Rounds of this tenant the host re-decided after a
                # transient device failure or an open circuit.
                out["failover"] = res["failover"]
            results[t.name] = out
        if self.config.register_live:
            try:
                from .. import web

                web.unregister_live_source(self.name)
            except Exception:  # noqa: BLE001
                pass
        if self.alert_engine is not None:
            # One final pass (the pump is gone) so a condition that
            # only materialized during drain still transitions, then
            # seal the journal.
            self._next_alert_eval = 0.0
            self._maybe_evaluate_alerts()
            self.alert_engine.close()
        fin = {
            "service": self.name,
            "tenants": results,
            "tenant_count": len(results),
            "wall_s": round(wall, 3),
            "valid": self._merge(results),
            # Service-wide latency (the aggregate child): the bench
            # leg's p99 — per-tenant p99s don't compose into it.
            "decision_latency": self._lat.stats(),
        }
        run_prov = _prov.block(_prov.merge_counts(
            *((r.get("provenance") or {}).get("causes")
              for r in results.values())))
        if run_prov is not None:
            fin["provenance"] = run_prov
        self._finished = fin
        if self.config.ledger:
            self._append_ledger(results, wall)
        return fin

    def _raise_fatal(self) -> None:
        """Raise the scheduler's deterministic device error, if a round
        hit one: its segments folded ``round_failed`` and no host verdict
        stands in for them."""
        if self.scheduler.fatal_error is not None:
            raise self.scheduler.fatal_error

    def _merge(self, results: dict) -> Any:
        # The one safety-critical fold, shared with every other path
        # (checker.clj:33-47 priority: False > unknown > True).
        from ..checker import merge_valid

        return merge_valid(r.get("valid") for r in results.values())

    def _append_ledger(self, results: dict, wall: float) -> None:
        """One ledger record per tenant stream (kind="service") — the
        cross-run trend the /runs page and `ledger --check` gate."""
        try:
            from ..telemetry import ledger as jledger

            path = jledger.default_path(self.config.store_root)
            engine = self.config.engine
            for tenant, r in results.items():
                rec = {
                    "kind": "service",
                    "run": f"{self.name}/{tenant}",
                    "workload": "service_stream",
                    "engine": engine,
                    "ops": r.get("ops_observed"),
                    "verdict": str(r.get("valid")),
                }
                if wall > 0 and r.get("ops_observed"):
                    rec["ops_per_s"] = round(
                        r["ops_observed"] / wall, 1)
                p99 = (r.get("decision_latency") or {}).get("p99_s")
                if p99 is not None:
                    rec["p99_decision_latency_s"] = p99
                prov = r.get("provenance")
                if prov:
                    # The cross-run trend's why-unknown column: the
                    # advisor joins this with the perf metrics.
                    rec["dominant_cause"] = prov.get("dominant")
                    rec["causes"] = prov.get("causes")
                jledger.append(rec, path=path)
        except Exception:  # noqa: BLE001 - the ledger never sinks drain
            LOG.warning("service ledger append failed", exc_info=True)
