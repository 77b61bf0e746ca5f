"""Tenant router: horizontal scale-out for the checking service. The port
of the reference's ``jepsen_tpu/service/router.py``: the same placement,
migration, supervision and fencing protocol over the same HTTP
endpoints, so the port's router fronts the reference's backends and the
reference's router fronts the port's.

One :class:`~jepsen_tpu_torch.service.service.Service` process lives or
dies as a unit — the per-tenant verdict journal makes a *restart* of
that unit lossless (the journal is the tenant's complete checkpoint),
and this module cashes that in for *horizontal* resilience: a front-end
that places tenants across N backend service processes (each with its
own scheduler and its own ``--journal-dir``) and survives losing an
ENTIRE backend the same way the single process survives a restart — by
journal replay, one-sided, never a flipped verdict.

The device: the router is a proxy and never touches the card (it
creates no CUDA context). Each backend decides its tenants' segments on
its own ``--device``: :func:`spawn_backends` hands ``--device`` to every
child, the card unless the caller passes ``device="cpu"``. A child whose
engine reaches the device oracle and that finds no card exits 255 before
it binds, and :func:`spawn_backends` raises: no backend comes up on the
CPU unless asked to.

The pieces:

- **Sticky placement** — a tenant's first submit places it on the
  least-loaded live backend; every later submit proxies to the same
  backend (the fold is stateful; bouncing a tenant would fork it).
- **Health checking** — a probe loop GETs each backend's ``/healthz``
  (carrying per-tenant backlog / ``journal_lag_ops`` / degraded flags)
  under a deadline, feeding a per-backend
  :class:`~jepsen_tpu_torch.parallel.resilience.CircuitBreaker`:
  ``failure_threshold`` consecutive failures open the circuit and the
  backend is declared LOST (a spawned child's exit is detected
  directly).
- **Journal-backed migration** — losing a backend (or an overload
  rebalance) moves each of its tenants: quiesce + ``POST
  /release/<tenant>`` on a live source (the journal handover), or —
  when the backend is dead — read the journal straight from its
  ``--journal-dir`` (the journal IS the checkpoint; there is nothing
  else to save), then ``POST /adopt/<tenant>`` on the target (replay
  behind admission) and atomically flip placement. Clients mid-stream
  get 503 + ``Retry-After`` and resume from the journaled watermark
  exactly as after a restart; resubmitted covered ops are dropped
  server-side. Soundness is the quiescent-cut argument: every journal
  record ends at a cut carrying the exact feasible end-state set, so
  the target re-decides nothing that was covered and checks everything
  above the watermark from the carried states.
- **Load-adaptive rebalancing** — :func:`plan_rebalance` is a pure
  function over the ``/healthz`` overload signals (scheduler backlog,
  queue depths, ``journal_lag_ops``); when one backend's load exceeds
  the least-loaded's by ``rebalance_ratio`` (and an absolute floor),
  the heaviest tenant is live-migrated off it.
- **Failure attribution** — a tenant that cannot be migrated (no
  target, no checkpoint, adopt refused, ``JEPSEN_NO_MIGRATION=1``) is
  ORPHANED: its router-level row folds ``unknown`` with the typed
  ``backend_lost`` / ``migration_interrupted`` causes
  (checker/provenance.py) — degraded one-sidedly, never flipped.
- **Self-healing** (``service/supervisor.py``) — a dead spawned
  backend is RESPAWNED (bounded exponential backoff, flap-damping
  circuit, ``JEPSEN_NO_RESPAWN=1`` kill-switch) against the same
  ``--journal-dir``; once the replacement passes ``/healthz`` the
  router re-adopts tenants toward it (:func:`plan_readopt` over the
  live ``/migrate`` machinery) so capacity returns to N.
- **Crash-safe router state** — with ``state_path`` the placement
  map, orphan records and a monotone placement *epoch* persist to an
  append-only ``router_state.jsonl``; a restarted router replays it
  and reconciles against live ``/healthz`` + journal-dir reality (a
  record is a hint, reality wins), and the epoch rides every
  ``/release``/``/adopt`` so a stale ex-router's in-flight migration
  is refused with a typed 409 ``stale_epoch``.
- **Rolling restart** — ``POST /roll`` (CLI ``--roll``) drains,
  respawns and re-adopts one backend at a time through the live
  ``/release`` path: zero-unknown-verdict upgrades.
- **Chaos seams** — ``router.probe`` (an injected raise counts as a
  failed health probe: the false-positive path), ``backend.process``
  (the router SIGKILLs one of its own spawned backend children: a
  real kill-9 of a real process) and ``router.crash`` (the router
  itself dies mid-migration — after the checkpoint, before the
  adopt; the restarted router must recover or orphan, never fork).

``JEPSEN_NO_MIGRATION=1`` is the operational kill-switch: no
migrations, no rebalancing — dead backends simply orphan their
tenants (checked per attempt, like every other kill-switch).
``JEPSEN_NO_RESPAWN=1`` does the same for the respawn half.

Telemetry: ``router_placements_total{backend}``,
``router_migrations_total{reason}``,
``router_failed_probes_total{backend}``, ``router_orphaned_tenants``,
``router_migration_seconds``, ``router_respawns_total{backend,
outcome}``, ``router_respawn_seconds``, ``router_epoch``. The router
registers on the web ``/live`` feed and aggregates ``/tenants``
across backends.

**Fleet observability** (``RouterConfig.federate``, on by default
when a registry is attached): every supervision tick also scrapes
each live backend's ``GET /metrics.json`` and feeds
:class:`~jepsen_tpu_torch.telemetry.fleet.FleetFederation` — the
merged fleet registry (counters sum, gauges keep per-backend children
+ fleet totals, histograms bucket-merge so the fleet p99 is real) is
served on the router's own ``GET /metrics`` alongside the router's
registry, with per-backend scrape staleness
(``fleet_scrape_age_seconds{backend}`` et al.) so a dead or
respawning backend reads as STALE, never silently-zero.
:class:`~jepsen_tpu_torch.telemetry.fleet.SloMonitor` turns the
federated histograms into availability / decision-latency burn-rate
gauges. Router operations (placement, migration, respawn, roll, epoch
bump) are minted as spans on the attached collector, and client trace
context (``X-Trace-Id``/``X-Parent-Span``) is forwarded through the
submit proxy and the migration ``/adopt`` — one tenant's life across
kill-9 + migration + resume is ONE trace. ``GET /fleet`` joins the
``router_state.jsonl`` timeline with per-backend utilization for the
web fleet page.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time as _time
from dataclasses import dataclass, replace
from typing import Callable, Optional
from urllib import error as _uerror
from urllib import request as _urequest
from urllib.parse import parse_qs, quote, unquote, urlsplit

from ..checker import provenance as _prov
from ..parallel import resilience as _resilience
from ..telemetry import fleet as _fleet
from ..testing import chaos as _chaos
from .. import trace as _trace
from . import journal as _journal
from . import supervisor as _supervisor

LOG = logging.getLogger("jepsen.router")

MIGRATION_SECONDS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                             10.0, 30.0, 60.0)


def migration_disabled() -> bool:
    """``JEPSEN_NO_MIGRATION=1`` — checked per attempt, so flipping the
    env in a live router takes effect (the kill-switch contract)."""
    return os.environ.get("JEPSEN_NO_MIGRATION", "") == "1"


class NoBackendError(RuntimeError):
    """No live backend is available to place a tenant on."""


@dataclass(frozen=True)
class RouterConfig:
    """Router policy knobs."""

    probe_interval_s: float = 1.0
    probe_timeout_s: float = 2.0
    # Consecutive probe failures before a backend's circuit opens and
    # it is declared lost (resilience.CircuitBreaker semantics; the
    # cooldown paces half-open re-probes of a backend that may heal).
    failure_threshold: int = 3
    probe_cooldown_s: float = 30.0
    http_timeout_s: float = 10.0
    release_timeout_s: float = 30.0
    drain_timeout_s: float = 120.0
    # Retry-After hint on migration/unreachable 503s: a migration is a
    # release+replay+flip, normally sub-second at bench scale.
    migrate_retry_after_s: float = 1.0
    # Load-adaptive rebalancing off the /healthz overload signals.
    rebalance: bool = True
    rebalance_min_load: float = 256.0
    rebalance_ratio: float = 4.0
    # journal_lag_ops (ops) -> load units (undecided segments are the
    # base unit; ~100 ops of journal lag weigh like one segment).
    lag_weight: float = 0.01
    register_live: bool = True
    # Self-healing: respawn a dead spawned backend (bounded backoff +
    # flap damping — see service/supervisor.py; JEPSEN_NO_RESPAWN=1
    # overrides) and re-adopt tenants toward the replacement.
    respawn: bool = True
    respawn_base_backoff_s: float = 0.25
    respawn_max_backoff_s: float = 15.0
    respawn_window_s: float = 60.0
    respawn_max_failures: int = 5
    # Crash-safe router state: when set, placement/orphans/epoch
    # persist to this append-only jsonl and a restarted router replays
    # + reconciles it.
    state_path: Optional[str] = None
    # Fleet observability: scrape each live backend's /metrics.json on
    # the probe cadence, merge into one fleet registry and drive the
    # SLO burn-rate monitor (needs a metrics registry to matter).
    federate: bool = True
    # Alerting plane (telemetry/alerts.py): evaluate the built-in rule
    # catalogue over the FEDERATED totals on this same tick — one rule
    # set covers the fleet. Off by default; enabling any of the three
    # lazily imports telemetry/alerts.py. alerts_path defaults to an
    # alerts.jsonl next to state_path, so a kill-9'd router restarted
    # on the same state dir replays its firing set.
    alerts: bool = False
    alerts_path: Optional[str] = None
    alerts_sink: Optional[str] = None


class Backend:
    """One backend service process as the router sees it."""

    def __init__(self, name: str, url: str,
                 journal_dir: Optional[str] = None,
                 proc: Optional[subprocess.Popen] = None,
                 metrics=None, failure_threshold: int = 3,
                 cooldown_s: float = 30.0,
                 respawner: Optional[Callable] = None) -> None:
        self.name = name
        self.url = url.rstrip("/")
        self.journal_dir = journal_dir
        self.proc = proc
        # The (re)spawn recipe: callable(backend) replaces proc/url
        # with a fresh healthy incarnation on the SAME journal dir
        # (service/supervisor.py). None = not respawnable (attached
        # --backend-urls backends).
        self.respawner = respawner
        self.supervisor: Optional[_supervisor.BackendSupervisor] = None
        # One breaker per backend: the consecutive-failure /
        # cooldown / half-open-probe protocol is exactly the device
        # path's (parallel/resilience.py) with "device" = "backend".
        self.breaker = _resilience.CircuitBreaker(
            f"router:{name}", failure_threshold=failure_threshold,
            cooldown_s=cooldown_s, metrics=metrics)
        self.health: Optional[dict] = None  # last good /healthz doc
        # Wall-clock time `health` was observed at: every aggregation
        # that re-serves the doc stamps this alongside it, so a
        # 10-seconds-stale row from a dying backend renders as 10
        # seconds old instead of masquerading as current.
        self.health_at: Optional[float] = None
        self.down = False  # declared lost; tenants migrated away
        # Mid-rolling-restart: excluded from NEW placement (a tenant
        # placed after the drain snapshot would be killed un-drained)
        # but still LIVE to everything else — probes keep running and
        # _checkpoint must not steal journals from under it.
        self.rolling = False

    def snapshot(self) -> dict:
        out = {
            "url": self.url,
            "state": "lost" if self.down else self.breaker.state,
            "down": self.down,
        }
        if self.proc is not None:
            out["pid"] = self.proc.pid
            out["exited"] = self.proc.poll()
        if self.health is not None:
            out["tenant_count"] = self.health.get("tenant_count")
            out["scheduler_backlog"] = self.health.get(
                "scheduler_backlog")
            if self.health_at is not None:
                out["observed_at"] = round(self.health_at, 3)
                out["health_age_s"] = round(
                    max(_time.time() - self.health_at, 0.0), 3)
        if self.supervisor is not None:
            sup = self.supervisor.snapshot()
            out["respawns"] = sup["respawns"]
            if sup["gave_up"]:
                # The typed supervision health state: the flap circuit
                # tripped and this backend stays down until an
                # operator intervenes (advisor rule respawn_backend).
                out["state"] = "respawn_gave_up"
                out["respawn_gave_up"] = True
        return out


# ---------------------------------------------------------------------------
# Pure rebalance planning (closed-form-testable; the advisor's
# rebalance_tenants rule applies the same load model to bench rounds).


def backend_load(health: Optional[dict],
                 lag_weight: float = 0.01) -> float:
    """One backend's load in scheduler-backlog units from its
    ``/healthz`` doc: undecided segments + queued ops + weighted
    journal lag (what a migration NOW would force clients to
    resubmit)."""
    h = health or {}
    tenants = h.get("tenants") or {}
    load = float(h.get("scheduler_backlog") or 0)
    for row in tenants.values():
        row = row or {}
        load += float(row.get("queue_depth") or 0)
        load += lag_weight * float(row.get("journal_lag_ops") or 0)
    return load


def tenant_load(row: Optional[dict], lag_weight: float = 0.01) -> float:
    r = row or {}
    return (float(r.get("backlog") or 0)
            + float(r.get("queue_depth") or 0)
            + lag_weight * float(r.get("journal_lag_ops") or 0))


def plan_rebalance(health_by_backend: dict, placement: dict, *,
                   min_load: float = 256.0, ratio: float = 4.0,
                   lag_weight: float = 0.01
                   ) -> Optional[tuple[str, str, str]]:
    """Pick at most ONE (tenant, src, dst) live migration: fires only
    when the loaded backend exceeds both an absolute floor and
    ``ratio``× the least-loaded backend, and moves the heaviest tenant
    (deterministic tie-break). Pure, and mirrored by the
    advisor's ``rebalance_tenants`` rule."""
    if len(health_by_backend) < 2:
        return None
    loads = {n: backend_load(h, lag_weight)
             for n, h in health_by_backend.items()}
    src = max(sorted(loads), key=lambda n: loads[n])
    dst = min(sorted(loads), key=lambda n: loads[n])
    if src == dst:
        return None
    if loads[src] < min_load or loads[src] < ratio * (loads[dst] + 1.0):
        return None
    rows = (health_by_backend[src] or {}).get("tenants") or {}
    cands = [t for t, n in placement.items()
             if n == src and t in rows]
    if not cands:
        return None
    tenant = max(sorted(cands),
                 key=lambda t: tenant_load(rows[t], lag_weight))
    if tenant_load(rows[tenant], lag_weight) <= 0:
        return None
    return tenant, src, dst


def plan_readopt(placement: dict, target: str,
                 live: set) -> Optional[tuple[str, str]]:
    """Pick at most ONE (tenant, src) move toward ``target`` — a
    just-respawned (or just-rolled), empty backend. Count-based, not
    load-based: the respawned backend has no health doc yet and the
    survivors may be idle, so `plan_rebalance`'s overload thresholds
    would never fire; capacity, not load, is what the re-adoption
    restores. Fires while the most-loaded OTHER live backend holds at
    least two more tenants than ``target`` (so every move strictly
    shrinks the imbalance and the loop terminates); deterministic
    tie-breaks, pure."""
    if target not in live:
        return None
    counts = {n: 0 for n in live}
    for t, n in placement.items():
        if n in counts:
            counts[n] += 1
    others = sorted(n for n in live if n != target)
    if not others:
        return None
    src = max(others, key=lambda n: (counts[n], n))
    if counts[src] - counts.get(target, 0) < 2:
        return None
    cands = sorted(t for t, n in placement.items() if n == src)
    if not cands:
        return None
    return cands[0], src


# ---------------------------------------------------------------------------


class Router:
    """The scale-out front-end: sticky tenant placement over N backend
    service processes, health-checked, with journal-backed live
    migration. See the module docstring."""

    def __init__(self, backends: list[Backend],
                 config: Optional[RouterConfig] = None, *,
                 metrics=None, collector=None, name: str = "router",
                 **overrides) -> None:
        cfg = config or RouterConfig()
        if overrides:
            cfg = replace(cfg, **overrides)
        if not backends:
            raise ValueError("router needs at least one backend")
        self.config = cfg
        self.name = name
        self.metrics = metrics
        # Span sink for router operations (place / migrate / respawn /
        # roll / epoch bump) — each span carries the epoch, and
        # migration spans join the tenant's client trace id so the
        # cross-process trace covers the handover.
        self.collector = collector
        self._backends: dict[str, Backend] = {}
        for b in backends:
            if b.name in self._backends:
                raise ValueError(f"duplicate backend name {b.name!r}")
            self._backends[b.name] = b
            # ONE source of truth for the probe-circuit policy: the
            # router's config re-arms every backend breaker, so a
            # Backend constructed with different defaults cannot
            # silently diverge from what the router believes (and
            # logs) about its own thresholds.
            b.breaker.failure_threshold = cfg.failure_threshold
            b.breaker.cooldown_s = cfg.probe_cooldown_s
        self._lock = threading.RLock()
        self._placement: dict[str, str] = {}  # tenant -> backend name
        self._migrating: set[str] = set()
        # tenant -> (trace_id, parent_span_id): the last trace context
        # a submit carried, so router-side spans (placement, the
        # covering migration span) and the forwarded /adopt join the
        # client's trace instead of starting disconnected ones.
        self._tenant_traces: dict[str, tuple] = {}
        # tenant -> {"from": backend, "causes": {code: n}, "note": …}:
        # tenants the router could NOT move — their router-level rows
        # fold unknown with these causes, never a definite verdict.
        self._orphans: dict[str, dict] = {}
        self.migrations: list[dict] = []  # bounded audit trail
        self._draining = False
        self._finished: Optional[dict] = None
        self._stop = threading.Event()
        self._roll_lock = threading.Lock()
        # Supervision: one respawn supervisor per respawnable backend.
        self._supervisors: dict[str, _supervisor.BackendSupervisor] = {}
        if cfg.respawn:
            policy = _supervisor.RespawnPolicy(
                base_backoff_s=cfg.respawn_base_backoff_s,
                max_backoff_s=cfg.respawn_max_backoff_s,
                window_s=cfg.respawn_window_s,
                max_failures_in_window=cfg.respawn_max_failures)
            for b in backends:
                if b.respawner is not None:
                    sup = _supervisor.BackendSupervisor(
                        b, b.respawner, policy, metrics=metrics,
                        on_ready=self._on_backend_respawned)
                    b.supervisor = sup
                    self._supervisors[b.name] = sup
        # Crash-safe router state: replay the journal (placement /
        # orphans / epoch are HINTS), bump the epoch past everything
        # replayed (this router generation supersedes any prior one),
        # then reconcile the hints against live reality BEFORE the
        # health loop starts.
        self._epoch = 1
        self._state: Optional[_supervisor.RouterState] = None
        state_rep: Optional[dict] = None
        if cfg.state_path:
            state_rep = _supervisor.replay_state(cfg.state_path)
            self._epoch = state_rep["epoch"] + 1
            self._placement = dict(state_rep["placement"])
            self._orphans = {t: dict(o)
                             for t, o in state_rep["orphans"].items()}
            self._state = _supervisor.RouterState(
                cfg.state_path, epoch=self._epoch,
                truncate_to=(state_rep["consistent_bytes"]
                             if state_rep["torn_tail"] else None))
        if metrics is not None:
            metrics.gauge(
                "router_epoch",
                "This router generation's placement epoch (every "
                "/release and /adopt carries it; stale epochs are "
                "fenced with a typed 409)").set(self._epoch)
        # Fleet federation + SLO burn-rate monitor: the supervision
        # tick scrapes each backend's /metrics.json into `federation`
        # and feeds the merged view to `slo` (None when federation is
        # off or there is no registry to export through).
        self.federation: Optional[_fleet.FleetFederation] = None
        self.slo: Optional[_fleet.SloMonitor] = None
        self._slo_doc: Optional[dict] = None
        if cfg.federate and metrics is not None:
            self.federation = _fleet.FleetFederation(metrics)
            self.slo = _fleet.SloMonitor(metrics)
        # Alerting plane: built ONLY when configured (the off-path pin
        # — telemetry/alerts.py is never imported otherwise).
        self.alert_engine = None
        self._sentinel = None
        if cfg.alerts or cfg.alerts_path or cfg.alerts_sink:
            from ..telemetry import alerts as _alerts

            apath = cfg.alerts_path
            if apath is None and cfg.state_path:
                apath = os.path.join(
                    os.path.dirname(os.path.abspath(cfg.state_path)),
                    "alerts.jsonl")
            sink = (_alerts.AlertSink(cfg.alerts_sink)
                    if cfg.alerts_sink else None)
            self._sentinel = _alerts.RegressionSentinel()
            self.alert_engine = _alerts.AlertEngine(
                metrics=metrics, path=apath, sink=sink,
                source=self.name)
        if state_rep is not None:
            # The epoch bump IS a fleet-visible operation: every
            # /release//adopt from here on carries the new epoch.
            self._span("router.epoch_bump",
                       prev_epoch=state_rep["epoch"])
        if state_rep is not None and (state_rep["records"]
                                      or state_rep["torn_tail"]):
            self._reconcile()
        self._thread = threading.Thread(
            target=self._health_loop, name="jepsen-router-health",
            daemon=True)
        self._thread.start()
        if cfg.register_live:
            try:
                from .. import web

                web.register_live_source(self.name, self.live_snapshot)
                web.register_fleet_source(self.name,
                                          self.fleet_snapshot)
            except Exception:  # noqa: BLE001 - observability only
                LOG.warning("could not register router live source",
                            exc_info=True)

    # -- tracing -------------------------------------------------------------

    def _span(self, name: str, *, t0_ns: Optional[int] = None,
              trace: Optional[tuple] = None, **attrs) -> None:
        """Mint one router-operation span (no-op without a collector).
        ``trace`` is a (trace_id, parent_span_id) propagation tuple;
        ``t0_ns`` makes it a covering span instead of a point."""
        if self.collector is None:
            return
        now = _time.monotonic_ns()
        tid = pid = None
        if trace:
            tid = trace[0]
            pid = trace[1] if len(trace) > 1 else None
        try:
            self.collector.record(
                name, start_ns=t0_ns if t0_ns is not None else now,
                end_ns=now, trace_id=tid, parent_id=pid,
                stage="router", router=self.name, epoch=self._epoch,
                **attrs)
        except Exception:  # noqa: BLE001 - observability only
            LOG.debug("router span %s failed", name, exc_info=True)

    def _trace_for(self, tenant: str) -> Optional[tuple]:
        with self._lock:
            return self._tenant_traces.get(tenant)

    # -- metrics -------------------------------------------------------------

    def _count_placement(self, backend: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                "router_placements_total",
                "Tenant placements decided by the router (first "
                "placement + every migration flip), by backend",
                labelnames=("backend",)).labels(backend=backend).inc()

    def _count_failed_probe(self, backend: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                "router_failed_probes_total",
                "Backend health probes that failed (timeout, refused, "
                "unhealthy, chaos-injected), by backend",
                labelnames=("backend",)).labels(backend=backend).inc()

    def _count_migration(self, reason: str, seconds: float) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                "router_migrations_total",
                "Journal-backed tenant migrations completed, by reason "
                "(backend_lost / rebalance)",
                labelnames=("reason",)).labels(reason=reason).inc()
            self.metrics.histogram(
                "router_migration_seconds",
                "Wall seconds per tenant migration (checkpoint "
                "handover + adopt replay + placement flip)",
                buckets=MIGRATION_SECONDS_BUCKETS).observe(seconds)

    def _set_orphans_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge(
                "router_orphaned_tenants",
                "Tenants whose backend was lost and whose migration "
                "could not complete — their verdicts fold unknown "
                "(backend_lost / migration_interrupted)").set(
                    len(self._orphans))

    # -- backend HTTP --------------------------------------------------------

    def _request(self, b: Backend, path: str,
                 data: Optional[bytes] = None,
                 timeout: Optional[float] = None,
                 headers: Optional[dict] = None) -> tuple[int, dict]:
        """One backend call; never raises. status 0 = unreachable."""
        req = _urequest.Request(
            b.url + path, data=data,
            method="POST" if data is not None else "GET",
            headers=headers or {})
        try:
            with _urequest.urlopen(
                    req, timeout=timeout
                    or self.config.http_timeout_s) as r:
                doc = json.loads(r.read().decode() or "{}")
                return r.status, doc if isinstance(doc, dict) else {}
        except _uerror.HTTPError as e:
            try:
                doc = json.loads(e.read().decode() or "{}")
            except ValueError:
                doc = {}
            return e.code, doc if isinstance(doc, dict) else {}
        except Exception as e:  # noqa: BLE001 - dead socket, timeout
            return 0, {"error": "unreachable", "detail": str(e)}

    # -- placement + ingestion proxy -----------------------------------------

    def _place(self, tenant: str) -> Backend:
        with self._lock:
            name = self._placement.get(tenant)
            if name is not None:
                b = self._backends.get(name)
                if b is not None:
                    return b
            cands = [b for b in self._backends.values()
                     if not b.down and not b.rolling]
            if not cands:
                raise NoBackendError("no live backend to place on")
            # Prefer backends whose probe circuit is quiet: a breaker
            # opened by submit-path failures marks a backend the
            # supervision tick has not yet declared lost — placing a
            # NEW tenant there would just bounce. Fall back to any
            # not-down backend when every circuit is engaged.
            quiet = [b for b in cands if not b.breaker.engaged()]
            counts: dict[str, int] = {}
            for _t, n in self._placement.items():
                counts[n] = counts.get(n, 0) + 1
            b = min(quiet or cands,
                    key=lambda bb: (counts.get(bb.name, 0), bb.name))
            self._placement[tenant] = b.name
        self._count_placement(b.name)
        self._state_append({"kind": "place", "tenant": tenant,
                            "backend": b.name})
        self._span("router.place", trace=self._trace_for(tenant),
                   tenant=tenant, backend=b.name)
        LOG.info("placed tenant %s on backend %s", tenant, b.name)
        return b

    def _state_append(self, rec: dict) -> None:
        if self._state is not None:
            self._state.append(rec)

    def placement(self) -> dict[str, str]:
        with self._lock:
            return dict(self._placement)

    def submit(self, tenant: str, body: bytes,
               trace: Optional[tuple] = None) -> tuple[int, dict]:
        """Proxy one ndjson POST to the tenant's backend. Returns
        (status, response doc); 503s carry ``retry_after_s`` +
        ``retryable`` so the resume-aware client backs off and
        re-anchors on the journaled watermark. ``trace`` is the
        client's (trace_id, parent_span_id) propagation context —
        remembered per tenant (so the covering migration span and the
        forwarded ``/adopt`` join the same trace) and forwarded on the
        proxied request."""
        cfg = self.config
        if trace is not None and trace[0]:
            with self._lock:
                self._tenant_traces[tenant] = trace
        with self._lock:
            if self._draining:
                return 503, {"error": "draining", "tenant": tenant,
                             "accepted": 0, "retryable": False}
            migrating = tenant in self._migrating
            orphan = self._orphans.get(tenant)
        if orphan is not None:
            # The tenant's state is unrecoverable: the honest answer
            # is a terminal refusal, not a silent fresh stream that
            # would fork its history.
            return 503, {"error": "orphaned", "tenant": tenant,
                         "accepted": 0, "retryable": False,
                         "causes": dict(orphan.get("causes") or {})}
        if migrating:
            return 503, {"error": "migrating", "tenant": tenant,
                         "accepted": 0, "retryable": True,
                         "retry_after_s": cfg.migrate_retry_after_s}
        try:
            b = self._place(tenant)
        except NoBackendError:
            return 503, {"error": "no_backend", "tenant": tenant,
                         "accepted": 0, "retryable": True,
                         "retry_after_s": cfg.migrate_retry_after_s}
        hdrs = None
        if trace is not None and trace[0]:
            hdrs = _trace.trace_headers(
                trace[0], trace[1] if len(trace) > 1 else None)
        status, doc = self._request(
            b, f"/submit/{quote(tenant, safe='')}", data=body,
            headers=hdrs)
        if status == 0:
            # Fast-path death detection: the proxy saw the dead socket
            # before the probe loop did. Feed the breaker and let the
            # supervision tick decide; the client retries against the
            # migrated placement.
            b.breaker.record_failure()
            self._count_failed_probe(b.name)
            return 503, {"error": "backend_unreachable",
                         "tenant": tenant, "accepted": 0,
                         "retryable": True,
                         "retry_after_s": cfg.migrate_retry_after_s}
        doc.setdefault("backend", b.name)
        return status, doc

    # -- health / supervision ------------------------------------------------

    def _probe(self, b: Backend) -> dict:
        # Chaos seam INSIDE the probe's failure domain: an injected
        # raise is indistinguishable from a timed-out /healthz — the
        # false-positive migration path under test.
        _chaos.fire("router.probe")
        with _urequest.urlopen(b.url + "/healthz",
                               timeout=self.config.probe_timeout_s) as r:
            doc = json.loads(r.read().decode() or "{}")
        if not isinstance(doc, dict) or not doc.get("ok"):
            raise RuntimeError(f"backend {b.name} unhealthy: {doc!r}")
        return doc

    def _chaos_kill_tick(self) -> None:
        """``backend.process``: an armed raise is the KILL ORDER — the
        router SIGKILLs one live spawned backend child (a real kill-9:
        torn journal line, dead socket) and then recovers through its
        own probe/migration machinery."""
        try:
            _chaos.fire("backend.process")
        except Exception:  # noqa: BLE001 - the armed fault
            victim = next(
                (b for b in self._backends.values()
                 if b.proc is not None and b.proc.poll() is None
                 and not b.down), None)
            if victim is None:
                LOG.warning("chaos backend.process fired with no live "
                            "spawned backend to kill")
                return
            LOG.warning("chaos: kill -9 backend %s (pid %d)",
                        victim.name, victim.proc.pid)
            victim.proc.kill()

    def _health_loop(self) -> None:
        while not self._stop.wait(self.config.probe_interval_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - supervision must survive
                LOG.warning("router health tick failed", exc_info=True)

    def _tick(self) -> None:
        self._chaos_kill_tick()
        for b in list(self._backends.values()):
            if b.down:
                continue
            if b.proc is not None and b.proc.poll() is not None:
                # A spawned child's exit needs no probe quorum.
                self._on_backend_down(
                    b, f"process exited rc={b.proc.poll()}")
                continue
            if b.breaker.state == "open":
                # The circuit can open BETWEEN ticks off submit-path
                # failures (the --backend-urls case with no child to
                # poll): without this, the tick would silently skip
                # the backend for a whole cooldown while clients
                # exhaust their retries against a dead placement.
                self._on_backend_down(
                    b, "circuit open (consecutive submit/probe "
                       "failures)")
                continue
            if not b.breaker.allow():
                continue  # open, cooldown pending: skip doomed probes
            try:
                doc = self._probe(b)
            except Exception as e:  # noqa: BLE001 - probe failure
                b.breaker.record_failure()
                self._count_failed_probe(b.name)
                LOG.warning("probe of backend %s failed (%s: %s)",
                            b.name, type(e).__name__, e)
                if b.breaker.state == "open":
                    self._on_backend_down(
                        b, "probe circuit open "
                        f"({self.config.failure_threshold} consecutive "
                        "failures)")
                continue
            b.breaker.record_success()
            b.health = doc
            b.health_at = _time.time()
            self._scrape_metrics(b)
        if self.federation is not None:
            # A backend that is down (or has never answered a scrape)
            # must read as STALE in the fleet view — its last-good
            # snapshot stays in the merge (its counters really did
            # happen) but the staleness gauges mark the numbers as
            # frozen, never silently current. Expected is every
            # CONFIGURED backend (down included — a kill-9'd backend
            # mid-respawn still belongs to the fleet); a snapshot held
            # for a name no longer configured at all is decommissioned
            # and expires instead of pinning the staleness signal.
            self.federation.stale_backends(
                expected=list(self._backends))
            if self.slo is not None:
                try:
                    self._slo_doc = self.slo.observe(
                        self.federation.merged())
                except Exception:  # noqa: BLE001 - observability only
                    LOG.warning("SLO observe failed", exc_info=True)
        if self.alert_engine is not None:
            try:
                self._evaluate_alerts()
            except Exception:  # noqa: BLE001 - observability only
                LOG.warning("alert evaluation failed", exc_info=True)
        if (self.config.rebalance and not self._draining
                and not migration_disabled()):
            self._maybe_rebalance()

    def _scrape_metrics(self, b: Backend) -> None:
        """Federation scrape, piggybacked on a SUCCESSFUL probe (same
        cadence, same failure domain): pull the backend's live
        registry snapshot and merge it under ``backend=<name>``."""
        if self.federation is None:
            return
        status, doc = self._request(
            b, "/metrics.json",
            timeout=max(self.config.probe_timeout_s, 2.0))
        if status == 200 and isinstance(doc.get("samples"), list):
            self.federation.record_scrape(b.name, doc)
        else:
            self.federation.record_failure(b.name)

    def _on_backend_down(self, b: Backend, why: str) -> None:
        if b.down:
            return
        b.down = True
        b.breaker.record_failure()
        LOG.warning("backend %s declared LOST (%s); migrating its "
                    "tenants", b.name, why)
        self._state_append({"kind": "lost", "backend": b.name,
                            "why": why})
        self._span("router.backend_lost", backend=b.name, why=why)
        sup = self._supervisors.get(b.name)
        if sup is not None:
            sup.note_exit()  # count the death in the flap window
        self._migrate_lost_tenants(b)
        if sup is not None:
            # Start the respawn worker only AFTER the migrations
            # stole/renamed every recoverable journal: a replacement
            # child booting mid-steal would replay a journal the
            # router is about to hand to another backend — the same
            # tenant live on two backends (the fork this module
            # exists to prevent). Journals that could NOT be migrated
            # (orphans) deliberately stay in place for the child's
            # replay + the rescue path.
            sup.kick()

    def _migrate_lost_tenants(self, b: Backend) -> None:
        with self._lock:
            tenants = sorted(t for t, n in self._placement.items()
                             if n == b.name)
            self._migrating.update(tenants)
        for t in tenants:
            try:
                self._migrate(t, b, reason="backend_lost")
            except Exception:  # noqa: BLE001 - incl. chaos raise
                # A migration that RAISES (the router.crash seam's
                # raise mode, an unexpected bug) must not abort the
                # loop: the remaining tenants would sit in _migrating
                # forever (terminal 503s, rebalancing wedged
                # router-wide) with no typed record anywhere. The
                # raising tenant gets an honest typed orphan — a
                # later successful migration / respawn rescue clears
                # it.
                LOG.warning("migration of tenant %s raised mid-"
                            "flight; orphaning", t, exc_info=True)
                self._orphan(t, b,
                             ["backend_lost", "migration_interrupted"],
                             note="migration raised mid-flight")
                with self._lock:
                    self._migrating.discard(t)

    # -- self-healing (service/supervisor.py drives these) -------------------

    def _fence_backend(self, b: Backend) -> bool:
        """Apply this generation's epoch fence to one backend (a few
        attempts). A refusal is meaningful: a NEWER router generation
        has fenced it higher, and this router must not bring it into
        its own fleet."""
        for _ in range(3):
            status, _doc = self._request(
                b, f"/fence?epoch={self._epoch}", data=b"")
            if status == 200:
                return True
            _time.sleep(0.1)
        return False

    def _bring_up(self, b: Backend, why: str) -> bool:
        """The ONE bring-up sequence respawn and roll share: fence the
        fresh child at this generation's epoch (its in-memory fence
        starts empty — serving unfenced would admit a stale
        ex-router's in-flight /adopt), then mark it live and record
        it. False = NOT brought up (fence refused/unreachable, or the
        router is draining): the backend stays down."""
        if not self._fence_backend(b):
            LOG.error("backend %s passed /healthz but the epoch "
                      "fence could not be applied; keeping it DOWN",
                      b.name)
            return False
        with self._lock:
            if self._draining:
                return False
            b.down = False
            b.health = None
            b.health_at = None
        b.breaker.record_success()
        if self.federation is not None:
            # The replacement process starts its counters from its
            # journal replay, NOT from the dead generation's totals:
            # dropping the old snapshot here is what makes the fleet
            # merge generation-safe (no double count across respawns —
            # the next scrape replaces, never accumulates).
            self.federation.forget(b.name)
        self._state_append({"kind": "respawned", "backend": b.name,
                            "url": b.url, "why": why})
        self._span("router.respawn", backend=b.name, why=why,
                   url=b.url)
        return True

    def _on_backend_respawned(self, b: Backend) -> bool:
        """The supervisor's on_ready hook: the replacement child
        passed /healthz — fence + mark the backend live, rescue any
        orphans its journal replay restored, and re-adopt tenants
        toward it so capacity returns to N. Returning False tells the
        supervisor the bring-up failed (counted as a failed attempt,
        backed off and retried under the flap circuit)."""
        if not self._bring_up(b, "respawn"):
            with self._lock:
                draining = self._draining
            return draining  # draining: nothing left to retry
        LOG.info("backend %s is back (%s); re-adopting tenants",
                 b.name, b.url)
        self._rescue_orphans(b)
        self._readopt(b)
        return True

    def _rescue_orphans(self, b: Backend) -> None:
        """Orphans of this backend whose journals were never migrated
        away are restored by the respawned child's own journal replay —
        they are LIVE there again. Flip placement back and clear the
        orphan record (this IS the 'later migration that succeeds',
        executed by the restart instead of a move)."""
        with self._lock:
            mine = sorted(t for t, o in self._orphans.items()
                          if o.get("from") == b.name)
        if not mine:
            return
        status, doc = self._request(
            b, "/tenants", timeout=max(self.config.probe_timeout_s,
                                       2.0))
        if status != 200:
            return
        rows = doc.get("tenants") or {}
        for t in mine:
            if t not in rows:
                continue
            with self._lock:
                self._placement[t] = b.name
                if self._orphans.pop(t, None) is not None:
                    self._set_orphans_gauge()
            self._count_placement(b.name)
            self._state_append({"kind": "place", "tenant": t,
                                "backend": b.name,
                                "why": "respawn_rescue"})
            self._state_append({"kind": "orphan_clear", "tenant": t})
            LOG.info("orphaned tenant %s restored by the respawn of "
                     "backend %s", t, b.name)

    def _readopt(self, target: Backend) -> int:
        """Re-adopt tenants toward a just-respawned (or just-rolled)
        backend via live migrations until the placement counts are
        balanced (plan_readopt). Stops at the first refusal — a
        half-balanced fleet still serves."""
        if migration_disabled():
            return 0
        moved = 0
        while moved < 256:
            with self._lock:
                placement = dict(self._placement)
                live = {bb.name for bb in self._backends.values()
                        if not bb.down}
            plan = plan_readopt(placement, target.name, live)
            if plan is None:
                break
            tenant, _src = plan
            try:
                if not self.migrate(tenant, target=target.name,
                                    reason="readopt"):
                    break
            except Exception:  # noqa: BLE001 - re-adoption is
                # best-effort: a half-balanced fleet still serves.
                LOG.warning("re-adoption of tenant %s raised",
                            tenant, exc_info=True)
                break
            moved += 1
        return moved

    def _reconcile(self) -> None:
        """Router restart: the replayed state is a HINT — probe every
        backend, fence the live ones at this generation's epoch, and
        make reality win: a tenant a live backend actually hosts is
        placed there; a backend dead while the router was down gets
        the exact watched-death treatment (journal-backed migration or
        typed orphaning); a tenant placed on a live backend that does
        NOT host it (an interrupted migration's released stream) is
        recovered through the ordinary checkpoint-rescue path."""
        cfg = self.config
        alive: dict[str, dict] = {}
        for b in self._backends.values():
            doc = None
            # Match the declared liveness policy: a backend only
            # counts as dead-at-restart after failure_threshold
            # consecutive probe failures, same as the watched path.
            for _ in range(max(cfg.failure_threshold, 1)):
                try:
                    doc = self._probe(b)
                    break
                except Exception:  # noqa: BLE001 - probe failure
                    self._count_failed_probe(b.name)
                    _time.sleep(0.05)
            if doc is None:
                continue
            b.health = doc
            b.health_at = _time.time()
            alive[b.name] = doc.get("tenants") or {}
            # Fence: this router generation supersedes any prior one;
            # a stale ex-router's in-flight /adopt into this backend
            # now gets the typed 409. A refusal here means a NEWER
            # router already owns the fleet — surface it loudly (full
            # concurrent-router HA is the ROADMAP's named remainder).
            if not self._fence_backend(b):
                LOG.error("backend %s refused epoch %d at reconcile "
                          "— a newer router generation may own this "
                          "fleet", b.name, self._epoch)
        # Reality wins, pass 1: tenants a live backend actually hosts.
        for name, rows in alive.items():
            for t in rows:
                with self._lock:
                    stale = self._placement.get(t) != name
                    if stale:
                        self._placement[t] = name
                    cleared = self._orphans.pop(t, None) is not None
                    if cleared:
                        self._set_orphans_gauge()
                if stale or cleared:
                    self._count_placement(name)
                    self._state_append({"kind": "place", "tenant": t,
                                        "backend": name,
                                        "why": "reconcile"})
                    if cleared:
                        self._state_append({"kind": "orphan_clear",
                                            "tenant": t})
        # Pass 2: backends dead while the router was down — exactly as
        # if the router had watched them die. Mark ALL dead first so a
        # dead backend can never be picked as a migration target.
        dead = [b for b in self._backends.values()
                if b.name not in alive and not b.down]
        for b in dead:
            b.down = True
            b.breaker.record_failure()
            self._state_append({"kind": "lost", "backend": b.name,
                                "why": "dead at router restart"})
            sup = self._supervisors.get(b.name)
            if sup is not None:
                sup.note_exit()
            LOG.warning("backend %s dead at router restart; migrating "
                        "its tenants", b.name)
        for b in dead:
            self._migrate_lost_tenants(b)
        for b in dead:
            # Respawn only after the steals (same ordering as
            # _on_backend_down: a child booting mid-steal would
            # re-own a journal the router is handing elsewhere).
            sup = self._supervisors.get(b.name)
            if sup is not None:
                sup.kick()
        # Pass 3: placed on a live backend that does not host it — an
        # interrupted migration released the stream (the `.migrated`
        # checkpoint is recoverable) or the tenant was never admitted
        # (no checkpoint: the placement stays a hint and the next
        # submit admits it fresh, which is correct — it has no decided
        # past anywhere).
        hosted = {t for rows in alive.values() for t in rows}
        with self._lock:
            placement = dict(self._placement)
            orphans = set(self._orphans)
        for t, n in sorted(placement.items()):
            if n not in alive or t in hosted or t in orphans:
                continue
            src = self._backends.get(n)
            if src is None:
                continue
            with self._lock:
                if t in self._migrating:
                    continue
                self._migrating.add(t)
            try:
                self._migrate(t, src, reason="router_restart")
            except Exception:  # noqa: BLE001 - recovery best-effort
                LOG.warning("restart recovery of tenant %s raised; "
                            "it stays placed as a hint", t,
                            exc_info=True)
                with self._lock:
                    self._migrating.discard(t)

    # -- migration -----------------------------------------------------------

    def migrate(self, tenant: str, target: Optional[str] = None,
                reason: str = "manual") -> bool:
        """Operator/rebalance entry point: live-migrate one tenant off
        its current backend (release → adopt → flip)."""
        # Resolve and validate EVERYTHING before marking the tenant
        # migrating: a raise after the mark (with _migrate's finally
        # never entered) would wedge the tenant in 503-migrating
        # forever and stall rebalancing router-wide.
        with self._lock:
            src_name = self._placement.get(tenant)
            if src_name is None:
                raise KeyError(f"tenant {tenant!r} is not placed")
            src = self._backends[src_name]
            dst = None
            if target is not None:
                dst = self._backends.get(target)
                if dst is None:
                    raise KeyError(
                        f"unknown target backend {target!r}")
            if tenant in self._migrating:
                return False
            self._migrating.add(tenant)
        return self._migrate(tenant, src, reason=reason, target=dst)

    def _pick_target(self, exclude: Backend) -> Optional[Backend]:
        with self._lock:
            cands = [b for b in self._backends.values()
                     if not b.down and not b.rolling
                     and b.name != exclude.name]
            if not cands:
                return None
            counts: dict[str, int] = {}
            for _t, n in self._placement.items():
                counts[n] = counts.get(n, 0) + 1
            return min(cands,
                       key=lambda bb: (counts.get(bb.name, 0), bb.name))

    def _checkpoint(self, tenant: str, src: Backend
                    ) -> tuple[Optional[str], Optional[str]]:
        """Obtain the tenant's journal checkpoint: live release first
        (also the recovery from a FALSE-POSITIVE probe death — a
        healthy backend answers and quiesces), else off the source's
        journal_dir. Returns (journal_text, adopt_cause)."""
        # Socket timeout strictly ABOVE the backend's own quiesce
        # deadline: a release that takes the full quiesce window must
        # not be abandoned on the wire just as it completes. The
        # epoch rides along: a stale ex-router's release is fenced
        # with a typed 409 before it can quiesce anything.
        status, doc = self._request(
            src, f"/release/{quote(tenant, safe='')}"
                 f"?epoch={self._epoch}", data=b"",
            timeout=self.config.release_timeout_s + 15.0)
        if status == 200 and isinstance(doc.get("journal"), str):
            return doc["journal"], None
        dead = src.down or (src.proc is not None
                            and src.proc.poll() is not None)
        path = (_journal.tenant_path(src.journal_dir, tenant)
                if src.journal_dir else None)
        if path and dead:
            # The backend is demonstrably gone: its journal file IS
            # the checkpoint (the journal's whole point). Renamed after
            # reading so a RESTARTED backend on the same dir cannot
            # re-own a tenant that now lives elsewhere. NEVER taken
            # from a live backend (a transient connect blip must not
            # seize the file from under the owner's open fd — split
            # ownership).
            try:
                with open(path, "rb") as f:
                    data = f.read()
                try:
                    os.replace(path, path + ".migrated")
                except OSError:
                    pass
                return data.decode("utf-8", "replace"), "backend_lost"
            except OSError:
                pass
        if path:
            # Release may have COMPLETED server-side with the response
            # lost on the wire: the source then already renamed the
            # file `.migrated` and tombstoned the tenant — the renamed
            # file is a complete checkpoint nobody owns, safe to adopt
            # whether or not the process is alive. (A successful adopt
            # back onto this backend deletes the stale artifact, so a
            # leftover here always describes the LATEST release.)
            try:
                with open(path + ".migrated", "rb") as f:
                    return (f.read().decode("utf-8", "replace"),
                            "backend_lost" if dead else None)
            except OSError:
                pass
        return None, None

    def _migrate(self, tenant: str, src: Backend, reason: str,
                 target: Optional[Backend] = None) -> bool:
        t0 = _time.monotonic()
        t0_ns = _time.monotonic_ns()
        entry: dict = {"tenant": tenant, "from": src.name,
                       "reason": reason, "ok": False}
        # Orphaning is for tenants whose SOURCE is gone (reason
        # backend_lost): a refused migration off a LIVE backend —
        # kill-switch, typo'd target, transient checkpoint failure —
        # must leave the tenant serving where it is, not destroy a
        # healthy stream behind a terminal 503.
        lost = reason == "backend_lost"
        try:
            if migration_disabled():
                entry["error"] = "migration_disabled"
                if lost:
                    self._orphan(tenant, src,
                                 ["backend_lost",
                                  "migration_interrupted"],
                                 note="JEPSEN_NO_MIGRATION=1")
                return False
            dst = target if target is not None \
                else self._pick_target(exclude=src)
            if dst is None or dst.down or dst.rolling:
                entry["error"] = "no_target"
                if lost:
                    self._orphan(tenant, src, ["backend_lost"],
                                 note="no live target backend")
                return False
            entry["to"] = dst.name
            jtext, cause = self._checkpoint(tenant, src)
            if jtext is None:
                entry["error"] = "no_checkpoint"
                if lost:
                    self._orphan(tenant, src, ["backend_lost"],
                                 note="no journal checkpoint "
                                      "recoverable")
                return False
            # Chaos seam: the router dying MID-MIGRATION — checkpoint
            # in hand, adopt not yet issued. `crash` mode is the real
            # kill-9 (the restarted router's reconcile must recover
            # the released stream or orphan it, never fork it);
            # `raise` aborts the migration at the same point
            # in-process.
            _chaos.fire("router.crash")
            path = f"/adopt/{quote(tenant, safe='')}" \
                   f"?epoch={self._epoch}"
            if cause:
                path += f"&cause={quote(cause, safe='')}"
            # Forward the tenant's trace context on the adopt: the
            # TARGET backend's service.adopt span then joins the same
            # trace the client and the source backend recorded under.
            tctx = self._trace_for(tenant)
            hdrs = (_trace.trace_headers(tctx[0],
                                         tctx[1] if len(tctx) > 1
                                         else None)
                    if tctx and tctx[0] else None)
            status, doc = self._request(dst, path,
                                        data=jtext.encode("utf-8"),
                                        headers=hdrs)
            if status != 200:
                entry["error"] = (f"adopt_{status}_"
                                  f"{doc.get('error') or 'failed'}")
                # A live release already made the SOURCE forget the
                # tenant — the checkpoint now exists only in this
                # router's memory. Spill it next to the source's
                # journals so an operator can re-adopt by hand instead
                # of losing a recoverable stream.
                self._spill_checkpoint(tenant, src, jtext)
                self._orphan(
                    tenant, src,
                    ["backend_lost", "migration_interrupted"]
                    if reason == "backend_lost"
                    else ["migration_interrupted"],
                    note=f"adopt on {dst.name} failed: {status} "
                         f"{doc.get('error')}")
                return False
            with self._lock:
                self._placement[tenant] = dst.name
                # "Orphaned ... until a later migration succeeds"
                # this IS the later migration — a
                # recovered tenant must serve again, not stay bricked
                # behind the stale orphan record.
                cleared = self._orphans.pop(tenant, None) is not None
                if cleared:
                    self._set_orphans_gauge()
            self._count_placement(dst.name)
            # The durable placement flip; "from" is the tombstone of
            # the previous owner (its `.migrated` file enforces it
            # backend-side).
            self._state_append({"kind": "place", "tenant": tenant,
                                "backend": dst.name,
                                "from": src.name})
            if cleared:
                self._state_append({"kind": "orphan_clear",
                                    "tenant": tenant})
            entry["ok"] = True
            entry["watermark"] = doc.get("watermark")
            LOG.info("migrated tenant %s %s -> %s (%s, watermark %s)",
                     tenant, src.name, dst.name, reason,
                     doc.get("watermark"))
            return True
        finally:
            seconds = _time.monotonic() - t0
            entry["seconds"] = round(seconds, 4)
            with self._lock:
                self.migrations.append(entry)
                if len(self.migrations) > 1000:
                    del self.migrations[:-1000]
                self._migrating.discard(tenant)
            if entry["ok"]:
                self._count_migration(reason, seconds)
            # EXACTLY ONE covering span per migration attempt (the
            # whole checkpoint → adopt → flip window), joined to the
            # tenant's client trace; a completed handover is the one
            # span with ok=True.
            extra = ({"error": entry["error"]}
                     if entry.get("error") else {})
            self._span("router.migrate", t0_ns=t0_ns,
                       trace=self._trace_for(tenant), tenant=tenant,
                       src=src.name, dst=entry.get("to"),
                       reason=reason, ok=entry["ok"], **extra)

    def _spill_checkpoint(self, tenant: str, src: Backend,
                          jtext: str) -> None:
        if not src.journal_dir:
            return
        try:
            path = (_journal.tenant_path(src.journal_dir, tenant)
                    + ".orphaned")
            with open(path, "w", encoding="utf-8") as f:
                f.write(jtext)
            LOG.warning("spilled tenant %s's checkpoint to %s",
                        tenant, path)
        except OSError:
            LOG.warning("could not spill tenant %s's checkpoint",
                        tenant, exc_info=True)

    def _orphan(self, tenant: str, src: Backend, codes: list,
                note: str = "") -> None:
        with self._lock:
            o = self._orphans.setdefault(
                tenant, {"from": src.name, "causes": {}})
            _prov.add_counts(o["causes"], codes)
            if note:
                o["note"] = note
            self._set_orphans_gauge()
            rec = {"kind": "orphan", "tenant": tenant,
                   "from": o["from"], "causes": dict(o["causes"])}
            if note:
                rec["note"] = note
        self._state_append(rec)
        _prov.count_metric(self.metrics,
                           [_prov.cause(c) for c in codes],
                           tenant=tenant)
        LOG.warning("tenant %s ORPHANED (%s): %s — verdict folds "
                    "unknown", tenant, "/".join(codes), note)

    # -- rebalancing ---------------------------------------------------------

    def _maybe_rebalance(self) -> None:
        cfg = self.config
        with self._lock:
            if self._migrating:
                return  # one migration at a time keeps causality easy
            # A mid-roll backend is being EMPTIED — it reads as the
            # least-loaded and would attract exactly the tenant the
            # roll is about to kill un-drained.
            health = {n: b.health for n, b in self._backends.items()
                      if not b.down and not b.rolling
                      and b.health is not None}
            placement = dict(self._placement)
        plan = plan_rebalance(health, placement,
                              min_load=cfg.rebalance_min_load,
                              ratio=cfg.rebalance_ratio,
                              lag_weight=cfg.lag_weight)
        if plan is None:
            return
        tenant, src, dst = plan
        LOG.info("rebalance: migrating tenant %s %s -> %s",
                 tenant, src, dst)
        try:
            self.migrate(tenant, target=dst, reason="rebalance")
        except KeyError:
            pass  # placement changed under us; next tick re-plans

    # -- rolling restart -----------------------------------------------------

    def roll(self) -> dict:
        """Rolling restart (``POST /roll`` / CLI ``--roll``): one
        backend at a time, drain-migrate its tenants via the live
        ``/release`` path, restart the process (respawner: fresh
        child, same journal dir), wait for ``/healthz``, re-adopt a
        fair share back — the fleet never drops below N-1 and every
        move is a quiesced journal handover, so an upgrade costs zero
        unknown verdicts. A backend whose tenants cannot all be moved
        is NOT restarted (the moved ones stay moved; the fleet still
        serves)."""
        with self._lock:
            if self._draining:
                return {"router": self.name, "ok": False,
                        "error": "draining", "backends": []}
        if not self._roll_lock.acquire(blocking=False):
            return {"router": self.name, "ok": False,
                    "error": "roll_in_progress", "backends": []}
        try:
            return self._roll_locked()
        finally:
            self._roll_lock.release()

    def _roll_locked(self) -> dict:
        roll_t0_ns = _time.monotonic_ns()
        out: dict = {"router": self.name, "ok": True,
                     "epoch": self._epoch, "backends": []}
        for b in list(self._backends.values()):
            entry: dict = {"backend": b.name}
            out["backends"].append(entry)
            if b.down:
                entry["skipped"] = "down"
                continue
            if b.respawner is None:
                entry["skipped"] = "no_respawner"
                continue
            t0 = _time.monotonic()
            # Out of NEW placement from before the drain snapshot: a
            # tenant placed onto the emptying backend after the
            # snapshot would be killed un-drained, breaking the
            # zero-unknown contract. `rolling` (unlike `down`) keeps
            # the backend fully LIVE for everything else — probes,
            # its existing tenants' ingestion, and _checkpoint's
            # never-steal-from-a-live-backend invariant.
            b.rolling = True
            try:
                with self._lock:
                    tenants = sorted(t for t, n in
                                     self._placement.items()
                                     if n == b.name)
                moved = []
                fail = None
                for t in tenants:
                    try:
                        if self.migrate(t, reason="roll"):
                            moved.append(t)
                        else:
                            fail = t
                            break
                    except Exception:  # noqa: BLE001 - a raising
                        # drain-migrate = this backend is not safely
                        # drainable; don't restart it.
                        fail = t
                        break
                entry["drained"] = moved
                if fail is not None:
                    # A healthy stream must never be restarted out
                    # from under itself: skip this backend's restart
                    # entirely.
                    entry["error"] = f"drain_migrate_failed:{fail}"
                    out["ok"] = False
                    continue
                # Marked down BEFORE the process dies so the
                # supervision tick cannot race the exit into a
                # spurious lost-backend migration + supervisor kick.
                b.down = True
                try:
                    if b.proc is not None and b.proc.poll() is None:
                        b.proc.terminate()
                        try:
                            b.proc.wait(timeout=10)
                        except Exception:  # noqa: BLE001
                            b.proc.kill()
                            b.proc.wait(timeout=5)
                    b.respawner(b)
                except Exception as e:  # noqa: BLE001 - spawn failed
                    entry["error"] = f"respawn_failed: {e}"
                    out["ok"] = False
                    # Hand the corpse to the supervisor — its backoff
                    # / flap circuit decides what happens next.
                    sup = self._supervisors.get(b.name)
                    if sup is not None:
                        sup.note_exit()
                        sup.kick()
                    continue
            finally:
                b.rolling = False
            if not self._bring_up(b, "roll"):
                entry["error"] = "bring_up_failed"
                out["ok"] = False
                # The child runs but cannot join the fleet (fence
                # unreachable/refused): leave it down and let the
                # supervisor's backoff / flap circuit own it.
                sup = self._supervisors.get(b.name)
                if sup is not None:
                    sup.note_exit()
                    sup.kick()
                continue
            entry["readopted"] = self._readopt(b)
            entry["seconds"] = round(_time.monotonic() - t0, 4)
            LOG.info("rolled backend %s in %.2fs (%d drained, %d "
                     "re-adopted)", b.name, entry["seconds"],
                     len(moved), entry["readopted"])
        self._span("router.roll", t0_ns=roll_t0_ns, ok=out["ok"],
                   backends=len(out["backends"]))
        return out

    # -- aggregation ---------------------------------------------------------

    def tenants_snapshot(self) -> dict:
        """Router-level ``GET /tenants``: every tenant's row from its
        OWN backend, plus synthesized unknown rows for orphans — the
        one place a reconnecting client reads its watermark from,
        wherever the tenant lives now."""
        with self._lock:
            placement = dict(self._placement)
            orphans = {t: dict(o) for t, o in self._orphans.items()}
        rows: dict[str, dict] = {}
        backends_doc: dict[str, dict] = {}
        for b in self._backends.values():
            backends_doc[b.name] = b.snapshot()
            if b.down:
                continue
            # Probe-class timeout, not the proxy one: this aggregation
            # backs every /live tick and every reconnecting client's
            # watermark read — one slow backend must not freeze it for
            # N × http_timeout_s.
            status, doc = self._request(
                b, "/tenants",
                timeout=max(self.config.probe_timeout_s, 2.0))
            if status != 200:
                backends_doc[b.name]["unreachable"] = True
                continue
            for t, row in (doc.get("tenants") or {}).items():
                if placement.get(t) == b.name and t not in orphans:
                    row = dict(row or {})
                    row["backend"] = b.name
                    rows[t] = row
        for t, o in orphans.items():
            causes = dict(o.get("causes") or {})
            rows[t] = {
                "verdict": "unknown",
                "orphaned": True,
                "degraded": True,
                "backend": o.get("from"),
                "provenance": _prov.block(causes),
                "dominant_unknown_cause": _prov.dominant(causes),
            }
        if self.federation is not None:
            # Per-backend scrape freshness on every aggregated row:
            # the /live fleet strip and /fleet page render row AGE
            # instead of presenting a stale dead-backend row as
            # current.
            for n, m in self.federation.meta().items():
                if n in backends_doc:
                    backends_doc[n]["scrape_age_s"] = \
                        m.get("scrape_age_s")
                    backends_doc[n]["scrapes"] = m.get("scrapes")
                    backends_doc[n]["scrape_stale"] = m.get("stale")
        return {
            "router": self.name,
            "t": round(_time.time(), 3),
            "epoch": self._epoch,
            "tenant_count": len(rows),
            "tenants": rows,
            "backends": backends_doc,
            "migrations": len(self.migrations),
        }

    def health_snapshot(self) -> dict:
        """Router ``GET /healthz``: router liveness + the backend
        table (state, last-known load)."""
        with self._lock:
            n_orphans = len(self._orphans)
            n_migrating = len(self._migrating)
        return {
            "ok": True,
            "router": self.name,
            "draining": self._draining,
            "epoch": self._epoch,
            "backends": {n: b.snapshot()
                         for n, b in self._backends.items()},
            "orphaned_tenants": n_orphans,
            "migrating_tenants": n_migrating,
        }

    def live_snapshot(self) -> dict:
        """The web ``/live`` row: the service-shaped tenant table (the
        dashboard renders it unchanged) plus the backend table."""
        snap = self.tenants_snapshot()
        rows = snap["tenants"]
        return {
            "run": self.name,
            "service": True,
            "router": True,
            "t": snap["t"],
            "epoch": self._epoch,
            "draining": self._draining,
            "tenant_count": len(rows),
            "ops_observed": sum((r or {}).get("ops_observed") or 0
                                for r in rows.values()),
            "scheduler_backlog": sum(
                (b.health or {}).get("scheduler_backlog") or 0
                for b in self._backends.values() if not b.down),
            "decision_latency": {},
            "tenants": rows,
            "backends": snap["backends"],
        }

    def stats(self) -> dict:
        """Router counters for bench/tests (migration audit included;
        ``backend_loads`` feeds the advisor's rebalance rule)."""
        with self._lock:
            migrations = [dict(m) for m in self.migrations]
            orphans = {t: dict(o) for t, o in self._orphans.items()}
            placement = dict(self._placement)
        sups = {n: s.snapshot() for n, s in self._supervisors.items()}
        respawn_secs = [s["last_respawn_s"] for s in sups.values()
                        if s["last_respawn_s"] is not None]
        return {
            "placement": placement,
            "migrations": migrations,
            "orphaned": orphans,
            "epoch": self._epoch,
            # The fleet-capacity block the advisor's respawn_backend
            # rule consumes (bench embeds it): is the fleet below its
            # configured N, and is the supervision layer still
            # working on that or has it stopped (disabled / flapped
            # out)?
            "fleet": {
                "configured_backends": len(self._backends),
                "live_backends": sum(
                    1 for b in self._backends.values() if not b.down),
                "respawn_disabled": (not self.config.respawn
                                     or _supervisor.respawn_disabled()),
                "respawn_gave_up": sorted(
                    n for n, s in sups.items() if s["gave_up"]),
                "respawns": sum(s["respawns"] for s in sups.values()),
                "respawn_seconds": (max(respawn_secs)
                                    if respawn_secs else None),
                **self._fleet_stats(),
            },
            # LIVE backends only (like _maybe_rebalance): a lost
            # backend's last-good health doc is stale — feeding it to
            # the advisor would compute skew against (and point advice
            # at) a backend that no longer exists.
            "backend_loads": {
                n: {
                    "load": backend_load(b.health,
                                         self.config.lag_weight),
                    "scheduler_backlog": (b.health or {}).get(
                        "scheduler_backlog") or 0,
                    "journal_lag_ops": sum(
                        (r or {}).get("journal_lag_ops") or 0
                        for r in ((b.health or {}).get("tenants")
                                  or {}).values()),
                }
                for n, b in self._backends.items() if not b.down
            },
        }

    # -- fleet observability -------------------------------------------------

    def _alert_fleet_ctx(self) -> dict:
        """The light fleet block the alert predicates read each tick —
        capacity/respawn state + staleness, WITHOUT the per-backend
        utilization reconstruction ``_fleet_stats`` pays for (this
        runs on the probe cadence; reconstruction is page-cadence)."""
        sups = {n: s.snapshot() for n, s in self._supervisors.items()}
        out: dict = {
            "configured_backends": len(self._backends),
            "live_backends": sum(
                1 for b in self._backends.values() if not b.down),
            "respawn_disabled": (not self.config.respawn
                                 or _supervisor.respawn_disabled()),
            "respawn_gave_up": sorted(
                n for n, s in sups.items() if s["gave_up"]),
        }
        if self.federation is not None:
            out["stale_backends"] = self.federation.stale_backends(
                expected=list(self._backends))
        return out

    def _evaluate_alerts(self) -> None:
        """One alert pass over the federated totals (the `_tick`
        hook): the rule set sees the fleet as ONE system — merged
        samples, the SLO doc, capacity/respawn state, and the
        change-point sentinel's live p99 series."""
        eng = self.alert_engine
        if eng is None:
            return
        from ..telemetry import alerts as _alerts

        merged = (self.federation.merged()
                  if self.federation is not None else [])
        sentinel: list = []
        if self._sentinel is not None:
            tail = _alerts.decision_tail(merged)
            if tail is not None and tail[1] is not None:
                self._sentinel.observe("fleet:p99_decision_latency_s",
                                       tail[1], lower_is_better=True)
            sentinel = self._sentinel.active()
        eng.evaluate({
            "samples": merged,
            "slo": self._slo_doc,
            "fleet": self._alert_fleet_ctx(),
            "sentinel": sentinel,
        })

    def alerts_snapshot(self) -> dict:
        """The router ``GET /alerts`` document ({"enabled": False}
        without an alert config)."""
        if self.alert_engine is None:
            return {"enabled": False, "router": self.name}
        return {"router": self.name, **self.alert_engine.snapshot()}

    def _fleet_stats(self) -> dict:
        """The federated slice of ``stats()['fleet']`` — what bench
        embeds and the advisor's slo_burn / backend_underutilized /
        scrape_stale rules consume. Empty when federation is off."""
        fed = self.federation
        if fed is None:
            return {}
        expected = list(self._backends)
        util: dict[str, dict] = {}
        for n in fed.backends():
            u = fed.utilization(n)
            if u is not None:
                util[n] = {
                    "utilization_pct": u.get("utilization_pct"),
                    "source": u.get("source"),
                }
        vals = [u["utilization_pct"] for u in util.values()
                if isinstance(u.get("utilization_pct"),
                              (int, float))]
        lat = fed.histogram_stats("decision_latency_seconds")
        return {
            "federation": fed.meta(expected=expected),
            "stale_backends": sorted(
                fed.stale_backends(expected=expected)),
            "utilization": util,
            "min_backend_utilization_pct": (round(min(vals), 2)
                                            if vals else None),
            "p99_decision_latency_s": ((lat or {}).get("p99_s")),
            "slo": self._slo_doc,
        }

    def _state_timeline(self, limit: int = 500) -> list[dict]:
        """The raw ``router_state.jsonl`` event stream (placement
        flips, orphans, lost/respawned backends, epoch headers) for
        the /fleet timeline — newest ``limit`` records, torn tail
        skipped. Empty without ``state_path``."""
        path = self.config.state_path
        if not path:
            return []
        out: list[dict] = []
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail / mid-write line
                    if isinstance(rec, dict):
                        out.append(rec)
        except OSError:
            return []
        return out[-limit:]

    def fleet_snapshot(self) -> dict:
        """The web ``/fleet`` document: every backend's state +
        scrape freshness + utilization, the router-state timeline,
        and the current SLO burn rates — the fleet as ONE system."""
        with self._lock:
            placement = dict(self._placement)
            orphans = sorted(self._orphans)
        fed = self.federation
        meta = fed.meta(expected=list(self._backends)) \
            if fed is not None else {}
        backends: dict[str, dict] = {}
        for n, b in self._backends.items():
            row = b.snapshot()
            m = meta.get(n)
            if m:
                row["scrape_age_s"] = m.get("scrape_age_s")
                row["scrapes"] = m.get("scrapes")
                row["scrape_failures"] = m.get("scrape_failures")
                row["scrape_stale"] = m.get("stale")
            if fed is not None:
                row["utilization"] = fed.utilization(n)
            row["tenants"] = sorted(t for t, bn in placement.items()
                                    if bn == n)
            backends[n] = row
        timeline = self._state_timeline()
        if self.alert_engine is not None:
            # Alert transitions join the placement/respawn event
            # stream: one timeline answers "what fired while that
            # backend was being respawned?".
            timeline = sorted(
                timeline + self.alert_engine.timeline_rows(),
                key=lambda r: (r.get("t") or 0))
        doc: dict = {
            "router": self.name,
            "t": round(_time.time(), 3),
            "epoch": self._epoch,
            "draining": self._draining,
            "backends": backends,
            "orphaned": orphans,
            "migrations": len(self.migrations),
            "timeline": timeline,
        }
        if fed is not None:
            doc["decision_latency"] = fed.histogram_stats(
                "decision_latency_seconds")
            doc["slo"] = self._slo_doc
            doc["stale_backends"] = sorted(fed.stale_backends(
                expected=list(self._backends)))
        if self.alert_engine is not None:
            doc["alerts"] = {
                "firing": self.alert_engine.firing(),
                "recent": self.alert_engine.history(20),
            }
        return doc

    def metrics_text(self) -> str:
        """Router ``GET /metrics``: the router's own registry plus the
        federated per-backend + fleet-total series. The family sets
        are disjoint by construction (backends emit service/scheduler
        families, the router emits ``router_*``/``fleet_*``/``slo_*``)
        so plain concatenation is a valid exposition."""
        parts: list[str] = []
        if self.metrics is not None:
            from ..telemetry import export as _export

            parts.append(_export.prometheus_text(self.metrics))
        if self.federation is not None:
            parts.append(self.federation.prometheus_text())
        return "\n".join(p for p in parts if p)

    # -- drain / shutdown ----------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Drain every live backend, merge the per-tenant results
        (orphans fold unknown with their causes), stop supervision and
        reap spawned children. Idempotent."""
        with self._lock:
            if self._finished is not None:
                return self._finished
            self._draining = True
        timeout = timeout if timeout is not None \
            else self.config.drain_timeout_s
        self._stop.set()
        # Let an in-flight supervision tick (and its migrations)
        # finish before draining the backends: a /drain racing a
        # mid-tick adopt would 503 it and spuriously orphan a tenant
        # whose migration had every right to complete.
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=min(timeout, 60.0))
        results: dict[str, dict] = {}
        per_backend: dict[str, dict] = {}
        p99s: list[float] = []
        with self._lock:
            placement = dict(self._placement)
            orphans = {t: dict(o) for t, o in self._orphans.items()}
        for b in self._backends.values():
            if b.down:
                per_backend[b.name] = {"error": "lost"}
                continue
            status, doc = self._request(b, "/drain", data=b"",
                                        timeout=timeout)
            if status != 200:
                per_backend[b.name] = {
                    "error": f"drain_{status}_"
                             f"{doc.get('error') or 'failed'}"}
                # Its tenants' verdicts are unrecoverable now.
                for t, n in placement.items():
                    if n == b.name and t not in orphans:
                        orphans[t] = {"from": b.name,
                                      "causes": {"backend_lost": 1}}
                continue
            per_backend[b.name] = {
                "valid": doc.get("valid"),
                "wall_s": doc.get("wall_s"),
                "tenant_count": doc.get("tenant_count"),
            }
            lat = doc.get("decision_latency") or {}
            if isinstance(lat.get("p99_s"), (int, float)):
                p99s.append(float(lat["p99_s"]))
            for t, r in (doc.get("tenants") or {}).items():
                if placement.get(t) == b.name and t not in orphans:
                    r = dict(r or {})
                    r["backend"] = b.name
                    results[t] = r
        for t, o in orphans.items():
            causes = dict(o.get("causes") or {})
            results[t] = {
                "valid": "unknown",
                "orphaned": True,
                "backend": o.get("from"),
                "provenance": _prov.block(causes),
                "info": "tenant orphaned by a lost backend; verdict "
                        "degraded to unknown",
            }
        # A tenant whose backend died between the last probe and this
        # drain (or whose migration the drain interrupted) has no row
        # anywhere — it must surface as an honest unknown, never
        # vanish from the results document.
        with self._lock:
            interrupted = set(self._migrating)
        for t, n in placement.items():
            if t in results:
                continue
            causes = {"migration_interrupted": 1} if t in interrupted \
                else {"backend_lost": 1}
            _prov.count_metric(self.metrics,
                               [_prov.cause(c) for c in causes],
                               tenant=t)
            results[t] = {
                "valid": "unknown",
                "backend": n,
                "provenance": _prov.block(causes),
                "info": "tenant unreachable at drain (backend lost / "
                        "migration interrupted); verdict degraded to "
                        "unknown",
            }
        from ..checker import merge_valid

        with self._lock:
            migrations = [dict(m) for m in self.migrations]
        # The federated fleet p99 is the REAL cross-process quantile
        # (bucket-merged histograms, not a max of per-backend p99s);
        # the conservative worst-backend max remains the fallback when
        # federation is off or never scraped.
        fleet_p99 = None
        if self.federation is not None:
            lat = self.federation.histogram_stats(
                "decision_latency_seconds")
            if lat and isinstance(lat.get("p99_s"), (int, float)):
                fleet_p99 = lat["p99_s"]
        fin = {
            "router": self.name,
            "tenants": results,
            "tenant_count": len(results),
            "backends": per_backend,
            "valid": merge_valid(r.get("valid")
                                 for r in results.values()),
            "p99_decision_latency_s": (
                fleet_p99 if fleet_p99 is not None
                else (max(p99s) if p99s else None)),
            "fleet_p99_decision_latency_s": fleet_p99,
            "migrations": migrations,
        }
        run_prov = _prov.block(_prov.merge_counts(
            *(((r.get("provenance") or {}).get("causes"))
              for r in results.values())))
        if run_prov is not None:
            fin["provenance"] = run_prov
        self._finished = fin
        for sup in self._supervisors.values():
            sup.close()
        if self.alert_engine is not None:
            self.alert_engine.close()
        if self._state is not None:
            self._state.close()
        self._shutdown_children()
        if self.config.register_live:
            try:
                from .. import web

                web.unregister_live_source(self.name)
                web.unregister_fleet_source(self.name)
            except Exception:  # noqa: BLE001
                pass
        return fin

    def _shutdown_children(self) -> None:
        for b in self._backends.values():
            p = b.proc
            if p is None or p.poll() is not None:
                continue
            try:
                p.terminate()
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001
                try:
                    p.kill()
                    p.wait(timeout=5)
                except Exception:  # noqa: BLE001
                    pass

    def close(self) -> None:
        """Stop supervision without draining (test teardown)."""
        self._stop.set()
        self._thread.join(timeout=5)
        for sup in self._supervisors.values():
            sup.close()
        if self.alert_engine is not None:
            self.alert_engine.close()
        if self._state is not None:
            self._state.close()
        self._shutdown_children()
        if self.config.register_live:
            try:
                from .. import web

                web.unregister_live_source(self.name)
                web.unregister_fleet_source(self.name)
            except Exception:  # noqa: BLE001
                pass


# ---------------------------------------------------------------------------
# Spawning real backend processes (the router CLI / bench / e2e tests).


def spawn_backends(n: int, *, journal_root: str,
                   model: str = "cas-register", engine: str = "auto",
                   max_configs: int = 500_000,
                   name_prefix: str = "backend",
                   extra_args: tuple = (), env: Optional[dict] = None,
                   metrics=None, failure_threshold: int = 3,
                   cooldown_s: float = 30.0,
                   wait_ready_s: float = 120.0,
                   device=None) -> list[Backend]:
    """Spawn N backend service processes (``python -m
    jepsen_tpu_torch.service``), each with its own ``--journal-dir`` under
    ``journal_root``, and wait for their ``/healthz``. Each child
    binds **port 0** and reports the bound port through an atomically
    written ``--port-file`` — probing a free port and then binding it
    has a TOCTOU hole (another process could take the probed port
    between probe and bind), which would crash-loop exactly the
    respawn path that needs to rebind. The returned Backends carry
    the child handles (exit detection, the ``backend.process`` chaos
    seam) and a :class:`~jepsen_tpu_torch.service.supervisor.
    ProcessRespawner` so the router's supervision layer can respawn
    them.

    ``device`` is every child's ``--device``: ``None`` is the card,
    ``"cpu"`` runs the device engines' plain versions on the host. A
    child whose engine reaches the device oracle and that finds no card
    exits 255 before it binds, and this raises (``RuntimeError``). The
    default engine is the service CLI's ``auto`` (the reference spawns
    ``host`` children: it pins them to the CPU). The checkout that holds
    this package goes first on every child's ``PYTHONPATH``."""
    env = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    backends: list[Backend] = []
    try:
        for i in range(n):
            name = f"{name_prefix}-{i}"
            jdir = os.path.join(journal_root, name)
            port_file = os.path.join(journal_root, f"{name}.port")
            cmd = [sys.executable, "-m", "jepsen_tpu_torch.service",
                   "--port", "0", "--port-file", port_file,
                   "--model", model, "--engine", engine,
                   "--max-configs", str(max_configs),
                   "--journal-dir", jdir, "--name", name,
                   "--device", str(device or "cuda"),
                   *extra_args]
            respawner = _supervisor.ProcessRespawner(
                cmd, port_file=port_file, env=env,
                wait_ready_s=wait_ready_s)
            os.makedirs(journal_root, exist_ok=True)
            b = Backend(name, "http://127.0.0.1:0", journal_dir=jdir,
                        metrics=metrics,
                        failure_threshold=failure_threshold,
                        cooldown_s=cooldown_s, respawner=respawner)
            respawner.spawn(b)
            backends.append(b)
        deadline = _time.monotonic() + wait_ready_s
        for b in backends:
            b.respawner.await_ready(b, deadline=deadline)
        return backends
    except BaseException:
        for b in backends:
            if b.proc is not None and b.proc.poll() is None:
                b.proc.kill()
                b.proc.wait(timeout=10)
        raise


# ---------------------------------------------------------------------------
# The router's own HTTP front door (same machinery as service/http.py).


def make_router_handler(router: Router):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            LOG.debug(fmt, *args)

        def _json(self, code: int, doc: dict) -> None:
            import math

            body = json.dumps(doc, sort_keys=True,
                              default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            ra = doc.get("retry_after_s")
            if code in (429, 503) and isinstance(ra, (int, float)):
                self.send_header("Retry-After",
                                 str(max(1, math.ceil(ra))))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = unquote(urlsplit(self.path).path)
            try:
                if path in ("/", "/tenants", "/tenants/"):
                    self._json(200, router.tenants_snapshot())
                elif path == "/healthz":
                    self._json(200, router.health_snapshot())
                elif path in ("/live", "/live/"):
                    self._json(200, router.live_snapshot())
                elif path in ("/backends", "/backends/"):
                    self._json(200, router.health_snapshot())
                elif path == "/metrics":
                    body = router.metrics_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length",
                                     str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path in ("/fleet", "/fleet/"):
                    self._json(200, router.fleet_snapshot())
                elif path in ("/alerts", "/alerts/"):
                    self._json(200, router.alerts_snapshot())
                else:
                    self._json(404, {"error": "not_found"})
            except Exception as e:  # noqa: BLE001
                LOG.warning("router error serving %s", path,
                            exc_info=True)
                self._json(500, {"error": "internal",
                                 "detail": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            parts = urlsplit(self.path)
            path = unquote(parts.path)
            query = parse_qs(parts.query)
            try:
                if path.startswith("/submit/"):
                    tenant = path[len("/submit/"):].strip("/")
                    length = int(self.headers.get("Content-Length")
                                 or 0)
                    # Same bounded-memory contract as the backend's
                    # transport layer: the proxy must not buffer what
                    # the backend would refuse anyway.
                    from .http import MAX_BODY_BYTES

                    if length > MAX_BODY_BYTES:
                        self._json(413, {
                            "error": "body_too_large",
                            "tenant": tenant, "accepted": 0,
                            "max_bytes": MAX_BODY_BYTES})
                        return
                    body = self.rfile.read(length)
                    tid = self.headers.get(_trace.TRACE_HEADER)
                    trace = ((tid,
                              self.headers.get(_trace.PARENT_HEADER))
                             if tid else None)
                    status, doc = router.submit(tenant, body,
                                                trace=trace)
                    self._json(status, doc)
                elif path.startswith("/migrate/"):
                    tenant = path[len("/migrate/"):].strip("/")
                    target = (query.get("target") or [None])[0]
                    ok = router.migrate(tenant, target=target)
                    self._json(200 if ok else 409,
                               {"tenant": tenant, "migrated": ok})
                elif path in ("/roll", "/roll/"):
                    doc = router.roll()
                    self._json(200 if doc.get("ok") else 409, doc)
                elif path in ("/drain", "/drain/"):
                    self._json(200, router.drain())
                else:
                    self._json(404, {"error": "not_found"})
            except KeyError as e:
                self._json(404, {"error": "unknown_tenant",
                                 "detail": str(e)})
            except Exception as e:  # noqa: BLE001
                LOG.warning("router error serving %s", path,
                            exc_info=True)
                self._json(500, {"error": "internal",
                                 "detail": f"{type(e).__name__}: {e}"})

    return Handler


def server(router: Router, port: int = 0):
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer(("", port), make_router_handler(router))


def serve(router: Router, port: int = 8088,
          port_file: Optional[str] = None) -> None:
    """Serve forever (the ``jepsen_tpu_torch.service --router`` CLI).
    ``port_file`` receives the BOUND port, written atomically after bind
    (``port=0`` binds an ephemeral one), as the backends' daemon does."""
    srv = server(router, port)
    if port_file:
        tmp = f"{port_file}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(str(srv.server_address[1]))
        os.replace(tmp, port_file)
    LOG.info("Router %s fronting %d backend(s) on http://0.0.0.0:%d",
             router.name, len(router._backends),
             srv.server_address[1])
    print(f"Router {router.name} fronting "
          f"{len(router._backends)} backend(s) on "
          f"http://0.0.0.0:{srv.server_address[1]} "
          "(POST /submit/<tenant>, GET /tenants, POST /drain)",
          flush=True)
    srv.serve_forever()
