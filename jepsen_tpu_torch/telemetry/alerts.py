"""Alerting & watchdog plane: a live rule engine over the samples the
observability stack already exports, with a durable alert lifecycle and
a change-point regression sentinel. The port of the reference's
``jepsen_tpu/telemetry/alerts.py``: the same rules, thresholds, records
and ``alerts.jsonl`` format, so either package replays the other's file.

Everything the stack can *measure* — federated fleet samples, SLO burn
gauges, verdict provenance, the cross-run ledger — was consumed
passively (the advisor is a post-hoc CLI, ``ledger --check`` runs
between bench rounds). This module is the online consumer: a pure
rule-evaluation engine (:class:`AlertRule` = name + severity +
closed-form predicate over a context snapshot + ``for_s`` hold) driving
a typed lifecycle state machine

    inactive -> pending -> firing -> resolved -> (inactive)

with a monotone per-alert generation counter (a re-fire after resolve
gets a new generation; history keeps every transition), persisted as an
append-only ``alerts.jsonl`` under the same
:class:`service.journal.ConsistentLines` torn-final-line discipline the
tenant journal and ``router_state.jsonl`` share — a kill-9'd router
restarted over the same file replays to the same firing set.

Evaluation is driven by the hosts' EXISTING cadences (the service's
pump sweep, the router's probe tick — no new threads), the rules are
closed-form over a context dict so tests pin them synthetically, and
the advisor imports its overlapping predicates FROM here
(:func:`slo_hot_windows`, :func:`stale_backend_list`,
:func:`respawn_capacity_deficit`, :func:`tail_is_pathological`,
:func:`journal_gap_count`) so there is exactly one definition of
"when" for each shared condition.

The context dict (any key may be absent — every predicate degrades to
"not firing" on missing input, never raises):

- ``samples``  — a ``Registry.collect()`` / ``fleet.merged()`` list;
- ``slo``      — a ``fleet.SloMonitor.observe()`` document;
- ``fleet``    — the router's fleet-stats block (``stale_backends``,
  ``configured_backends`` / ``live_backends``, respawn state);
- ``health``   — a service ``health_snapshot()`` document;
- ``sentinel`` — active :class:`RegressionSentinel` findings;
- ``now``      — the evaluation wall-clock stamp.

Off is the default and costs nothing: hosts only import this module
when an alert config is present (pinned by a poisoned-import test, the
same convention the telemetry/utilization layers follow).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import logging
import math
import os
import sys
import time as _time
from typing import Any, Callable, Optional

LOG = logging.getLogger("jepsen.alerts")

SEVERITIES = ("high", "medium", "info")
STATES = ("inactive", "pending", "firing", "resolved")

# ---------------------------------------------------------------------------
# Thresholds — the ONE source both the alert catalogue and the advisor
# read (advisor.py re-exports these under its historic
# names, the same objects).

# SLO burn-rate alert thresholds (the classic multiwindow pair): a
# fast-window burn this hot exhausts the error budget in hours; a
# slow-window burn this hot is a sustained leak. Gauges come from
# telemetry.fleet.SloMonitor via the router's federated scrape.
SLO_FAST_BURN_THRESHOLD = 14.0
SLO_SLOW_BURN_THRESHOLD = 6.0
# p99/p50 decision-latency ratio past which the tail is pathological.
TAIL_RATIO_THRESHOLD = 20.0
# journal_lag_ops past which a crash would cost a resubmission storm.
JOURNAL_LAG_ALERT_OPS = 10_000
# online_watermark_stall_seconds past which coverage is wedged (the
# gauge itself already holds 0 for stall_after_s before climbing).
WATERMARK_STALL_ALERT_S = 10.0
# Hosts evaluate at most this often on their own cadence.
ALERT_EVAL_INTERVAL_S = 1.0
# A sentinel finding keeps its perf_regression alert firing this long.
REGRESSION_ACTIVE_S = 600.0

# ---------------------------------------------------------------------------
# Shared closed-form predicates (advisor.py imports these).


def slo_hot_windows(slo: Optional[dict]) -> dict:
    """``{"<window>_<kind>": {burn_rate, threshold}}`` for every SLO
    window burning past its multiwindow threshold — the advisor's
    ``slo_burn`` rule and the ``slo_burn`` alert share this exactly."""
    windows = (slo or {}).get("windows") or {}
    hot: dict = {}
    for wname, thresh in (("fast", SLO_FAST_BURN_THRESHOLD),
                          ("slow", SLO_SLOW_BURN_THRESHOLD)):
        w = windows.get(wname) or {}
        for kind in ("availability", "latency"):
            burn = w.get(f"{kind}_burn_rate")
            if isinstance(burn, (int, float)) and burn > thresh:
                hot[f"{wname}_{kind}"] = {"burn_rate": burn,
                                          "threshold": thresh}
    return hot


def stale_backend_list(fleet: Optional[dict]) -> list:
    """Backends whose federation scrape is past the staleness horizon,
    from a router fleet-stats block."""
    if not isinstance(fleet, dict):
        return []
    return sorted(fleet.get("stale_backends") or [])


def respawn_capacity_deficit(fleet: Optional[dict]) -> Optional[dict]:
    """Evidence dict when the fleet runs below its configured backend
    count AND the self-healing layer is out of play (respawn disabled,
    or the flap circuit gave up) — None while the supervisor is still
    on it, exactly the advisor's ``respawn_backend`` gate."""
    fleet = fleet if isinstance(fleet, dict) else {}
    conf = fleet.get("configured_backends")
    live = fleet.get("live_backends")
    if not isinstance(conf, int) or not isinstance(live, int) \
            or live >= conf:
        return None
    disabled = bool(fleet.get("respawn_disabled"))
    gave_up = list(fleet.get("respawn_gave_up") or [])
    if not disabled and not gave_up:
        return None
    return {"configured_backends": conf, "live_backends": live,
            "respawn_disabled": disabled, "respawn_gave_up": gave_up}


def tail_is_pathological(p50: Any, p99: Any) -> bool:
    """p99/p50 past TAIL_RATIO_THRESHOLD — the advisor's
    ``latency_tail`` rule and the ``latency_tail`` alert share this."""
    return (isinstance(p50, (int, float)) and isinstance(
        p99, (int, float)) and p50 > 0
        and p99 / p50 > TAIL_RATIO_THRESHOLD)


def journal_gap_count(causes: Optional[dict]) -> int:
    """``journal_gap`` occurrences in a provenance cause-count map."""
    if not isinstance(causes, dict):
        return 0
    n = causes.get("journal_gap")
    return int(n) if isinstance(n, (int, float)) else 0


# ---------------------------------------------------------------------------
# Sample helpers (predicates over a collect()/merged() list).


def sample_children(samples: Any, name: str) -> list[dict]:
    if not isinstance(samples, list):
        return []
    return [s for s in samples
            if isinstance(s, dict) and s.get("name") == name]


def decision_tail(samples: Any) -> Optional[tuple]:
    """(p50, p99) off the unlabeled ``decision_latency_seconds``
    histogram total, or None without one."""
    from .registry import bucket_quantile

    for s in sample_children(samples, "decision_latency_seconds"):
        if (s.get("labels") or {}) != {} or s.get("type") != "histogram":
            continue
        buckets = s.get("buckets") or {}
        try:
            items = sorted(((float(k), int(v))
                            for k, v in buckets.items()
                            if k != "+Inf"), key=lambda kv: kv[0])
        except (TypeError, ValueError):
            return None
        if not items or not s.get("count"):
            return None
        bounds = [k for k, _ in items]
        counts = [v for _, v in items]
        counts.append(int(s["count"]) - sum(counts))  # the +Inf tail
        return (bucket_quantile(bounds, counts, 0.5),
                bucket_quantile(bounds, counts, 0.99))
    return None


# ---------------------------------------------------------------------------
# Rule predicates (each: ctx -> evidence dict when firing, else None).


def _pred_slo_burn(ctx: dict) -> Optional[dict]:
    hot = slo_hot_windows(ctx.get("slo"))
    return {"hot_windows": hot} if hot else None


def _pred_scrape_stale(ctx: dict) -> Optional[dict]:
    stale = stale_backend_list(ctx.get("fleet"))
    return {"stale_backends": stale} if stale else None


def _pred_respawn_gave_up(ctx: dict) -> Optional[dict]:
    return respawn_capacity_deficit(ctx.get("fleet"))


def _pred_journal_errors(ctx: dict) -> Optional[dict]:
    bad: dict = {}
    health = ctx.get("health") or {}
    for tenant, row in sorted((health.get("tenants") or {}).items()):
        if not isinstance(row, dict):
            continue
        fails = row.get("journal_append_failures")
        if isinstance(fails, (int, float)) and fails > 0:
            bad.setdefault(tenant, {})["append_failures"] = int(fails)
        lag = row.get("journal_lag_ops")
        if isinstance(lag, (int, float)) and lag > JOURNAL_LAG_ALERT_OPS:
            bad.setdefault(tenant, {})["journal_lag_ops"] = lag
    for s in sample_children(ctx.get("samples"), "journal_lag_ops"):
        v = s.get("value")
        tenant = (s.get("labels") or {}).get("tenant")
        if tenant and isinstance(v, (int, float)) \
                and v > JOURNAL_LAG_ALERT_OPS:
            bad.setdefault(tenant, {})["journal_lag_ops"] = v
    return {"tenants": bad} if bad else None


def _pred_watermark_stall(ctx: dict) -> Optional[dict]:
    stalls = {}
    for s in sample_children(ctx.get("samples"),
                             "online_watermark_stall_seconds"):
        v = s.get("value")
        if isinstance(v, (int, float)) and v > WATERMARK_STALL_ALERT_S:
            key = ",".join(f"{k}={v2}" for k, v2 in sorted(
                (s.get("labels") or {}).items())) or "total"
            stalls[key] = v
    return {"stall_seconds": stalls} if stalls else None


def _pred_circuit_open(ctx: dict) -> Optional[dict]:
    opened = {}
    for s in sample_children(ctx.get("samples"), "circuit_state"):
        v = s.get("value")
        dev = (s.get("labels") or {}).get("device")
        if dev and isinstance(v, (int, float)) and v >= 2:
            opened[dev] = v
    return {"open_circuits": opened} if opened else None


def _pred_unattributed(ctx: dict) -> Optional[dict]:
    n = 0
    for s in sample_children(ctx.get("samples"), "verdict_causes_total"):
        if (s.get("labels") or {}).get("code") == "unattributed":
            v = s.get("value")
            if isinstance(v, (int, float)):
                n += int(v)
    prov = (ctx.get("health") or {}).get("provenance")
    if isinstance(prov, dict):
        n += int(prov.get("unattributed") or 0)
    return {"unattributed": n} if n else None


def _pred_latency_tail(ctx: dict) -> Optional[dict]:
    tail = decision_tail(ctx.get("samples"))
    if tail is None:
        return None
    p50, p99 = tail
    if p50 is None or p99 is None or not tail_is_pathological(p50, p99):
        return None
    return {"p50_s": p50, "p99_s": p99, "ratio": round(p99 / p50, 1)}


def _pred_perf_regression(ctx: dict) -> Optional[dict]:
    findings = [f for f in (ctx.get("sentinel") or [])
                if isinstance(f, dict)]
    return {"findings": findings} if findings else None


# ---------------------------------------------------------------------------
# The rule type + built-in catalogue.


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One closed-form alert: ``predicate(ctx)`` returns an evidence
    dict while the condition holds, else None. ``for_s`` is the
    pending hold before firing; ``resolve_for_s`` the clean hold
    before a firing alert resolves (hysteresis). ``expected_causes``
    names the provenance codes this condition legitimately rides with
    (the chaos matrix's vocabulary) and ``kill_switch`` the env var
    that silences the subsystem the alert watches."""

    name: str
    severity: str
    predicate: Callable[[dict], Optional[dict]]
    for_s: float = 0.0
    resolve_for_s: float = 0.0
    summary: str = ""
    expected_causes: frozenset = frozenset()
    kill_switch: Optional[str] = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"known: {SEVERITIES}")
        if self.for_s < 0 or self.resolve_for_s < 0:
            raise ValueError("for_s / resolve_for_s must be >= 0")

    def describe(self) -> dict:
        return {"name": self.name, "severity": self.severity,
                "for_s": self.for_s,
                "resolve_for_s": self.resolve_for_s,
                "summary": self.summary,
                "expected_causes": sorted(self.expected_causes),
                "kill_switch": self.kill_switch}


def catalogue() -> list[AlertRule]:
    """The built-in rule set, covering every live signal the repo
    already exports."""
    return [
        AlertRule(
            "slo_burn", "high", _pred_slo_burn,
            summary="fleet SLO error budget burning past the "
                    "fast/slow multiwindow thresholds"),
        AlertRule(
            "scrape_stale", "medium", _pred_scrape_stale,
            summary="federation scrapes stale — fleet totals "
                    "partially frozen"),
        AlertRule(
            "respawn_gave_up", "high", _pred_respawn_gave_up,
            kill_switch="JEPSEN_NO_RESPAWN",
            expected_causes=frozenset({"backend_lost",
                                       "migration_interrupted"}),
            summary="fleet below configured capacity and respawn "
                    "will not restore it"),
        AlertRule(
            "journal_errors", "high", _pred_journal_errors,
            expected_causes=frozenset({"journal_gap"}),
            summary="journal appends failing or journal lag past its "
                    "ceiling — a crash now costs a resubmission storm"),
        AlertRule(
            "watermark_stall", "medium", _pred_watermark_stall,
            summary="decided watermark frozen with ops still flowing"),
        AlertRule(
            "circuit_open", "medium", _pred_circuit_open,
            kill_switch="JEPSEN_NO_FAILOVER",
            expected_causes=frozenset({"failover_exhausted",
                                       "round_failed"}),
            summary="a device-path circuit breaker is open — rounds "
                    "are failing over to host re-dispatch"),
        AlertRule(
            "latency_tail", "medium", _pred_latency_tail,
            for_s=ALERT_EVAL_INTERVAL_S * 2,
            summary="decision-latency tail pathological "
                    "(p99/p50 past threshold)"),
        AlertRule(
            "perf_regression", "medium", _pred_perf_regression,
            summary="change-point sentinel detected a sustained "
                    "mean shift in a watched perf series"),
        # The canary: the provenance contract says every degradation
        # carries a typed cause — this alert firing is itself a bug
        # (the chaos matrix's invariant, promoted to production).
        AlertRule(
            "unattributed_causes", "high", _pred_unattributed,
            summary="a verdict degraded with no typed cause — the "
                    "provenance taxonomy leaked (must never fire)"),
    ]


# Per chaos seam (testing/chaos.py POINTS): the ONLY alerts an
# injected fault there may raise: fired alerts must be a subset of this
# set for the armed seam, and a clean run raises none. The canary
# appears in NO set.
_FLEET_ALERTS = frozenset({"scrape_stale", "slo_burn",
                           "respawn_gave_up", "latency_tail",
                           "perf_regression"})
EXPECTED_ALERTS: dict[str, frozenset] = {
    # perf_regression rides every seam: a fault-induced throughput /
    # latency shift IS a change-point, and the sentinel is allowed to
    # say so alongside the fault's own typed alert.
    "service.pump": frozenset({"slo_burn", "watermark_stall",
                               "latency_tail", "perf_regression"}),
    "scheduler.worker": frozenset({"slo_burn", "watermark_stall",
                                   "latency_tail", "perf_regression"}),
    "device.dispatch": frozenset({"circuit_open", "slo_burn",
                                  "latency_tail", "perf_regression"}),
    "host.stack": frozenset({"circuit_open", "slo_burn",
                             "latency_tail", "perf_regression"}),
    "journal.fsync": frozenset({"journal_errors", "perf_regression"}),
    # A parse fault costs exactly the lines it hit — a typed
    # ingest_unmapped_op verdict cause, not an operational page.
    "ingest.parse": frozenset({"perf_regression"}),
    "router.probe": _FLEET_ALERTS,
    "backend.process": _FLEET_ALERTS,
    "router.crash": _FLEET_ALERTS,
}


# ---------------------------------------------------------------------------
# Change-point regression sentinel (CUSUM, closed form, no deps).


class Cusum:
    """Streaming two-sided CUSUM mean-shift detector.

    The first ``min_n`` samples calibrate a reference mean/σ
    (Welford); afterwards each sample's standardized deviation
    ``z = (x - μ) / σ`` drives the classic recursions

        g⁺ = max(0, g⁺ + z − k)        g⁻ = max(0, g⁻ − z − k)

    and :meth:`update` returns ``"up"`` / ``"down"`` when either sum
    crosses ``h`` (≈ k=0.5, h=5 detects a 1σ sustained shift within a
    handful of samples while a white-noise walk stays below h with
    drift −k). On detection the detector re-anchors on the new level
    (recalibrates), so a later shift back fires again."""

    def __init__(self, k: float = 0.5, h: float = 5.0,
                 min_n: int = 8):
        if min_n < 2:
            raise ValueError("min_n must be >= 2")
        self.k, self.h, self.min_n = float(k), float(h), int(min_n)
        self._reset()

    def _reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0
        self.sigma = 0.0
        self.gp = 0.0
        self.gn = 0.0

    def update(self, x: float) -> Optional[str]:
        x = float(x)
        if not math.isfinite(x):
            return None
        if self.n < self.min_n:
            # Calibration window (Welford).
            self.n += 1
            d = x - self.mean
            self.mean += d / self.n
            self._m2 += d * (x - self.mean)
            if self.n == self.min_n:
                var = self._m2 / (self.n - 1)
                # σ floor: a dead-flat reference window must still
                # standardize finitely (any real change then fires).
                self.sigma = max(math.sqrt(max(var, 0.0)),
                                 abs(self.mean) * 1e-3, 1e-9)
            return None
        z = (x - self.mean) / self.sigma
        self.gp = max(0.0, self.gp + z - self.k)
        self.gn = max(0.0, self.gn - z - self.k)
        shift = "up" if self.gp > self.h else \
            "down" if self.gn > self.h else None
        if shift is not None:
            self._reset()  # re-anchor on the new level
        return shift


class RegressionSentinel:
    """Per-series change-point watch: one :class:`Cusum` per named
    series (ledger ``(kind, workload, engine, metric)`` keys, live
    ``sustained ops/s`` / p99 windows). :meth:`observe` feeds one
    sample and returns a finding dict when a shift lands in the
    series' regression direction; :meth:`active` lists findings still
    inside ``REGRESSION_ACTIVE_S`` — the ``perf_regression`` alert's
    context input."""

    def __init__(self, k: float = 0.5, h: float = 5.0, min_n: int = 8,
                 history_limit: int = 64):
        self._mk = lambda: Cusum(k=k, h=h, min_n=min_n)
        self._detectors: dict[str, Cusum] = {}
        self._findings: collections.deque = collections.deque(
            maxlen=history_limit)

    def observe(self, series: str, value: Any, *,
                lower_is_better: bool = False,
                t: Optional[float] = None) -> Optional[dict]:
        if not isinstance(value, (int, float)) \
                or not math.isfinite(float(value)):
            return None
        det = self._detectors.setdefault(series, self._mk())
        baseline = det.mean if det.n >= det.min_n else None
        shift = det.update(float(value))
        if shift is None:
            return None
        regression = (shift == "up") if lower_is_better \
            else (shift == "down")
        finding = {"series": series, "shift": shift,
                   "value": float(value), "baseline": baseline,
                   "regression": regression,
                   "t": float(t) if t is not None else _time.time()}
        if regression:
            self._findings.append(finding)
        return finding

    def observe_ledger(self, records: list, *,
                       now: Optional[float] = None) -> list[dict]:
        """Feed a loaded ledger's gated metric series through the
        per-(kind, workload, engine, metric) detectors; returns the
        regression findings raised."""
        from . import ledger as _ledger

        out = []
        for rec in records:
            if not isinstance(rec, dict):
                continue
            gkey = _ledger.group_key(rec)
            for name, key, direction in _ledger.LEDGER_METRICS:
                if direction == "info":
                    continue
                v = rec.get(key)
                if not isinstance(v, (int, float)) \
                        or isinstance(v, bool):
                    continue
                series = "/".join(str(k) for k in gkey) + ":" + name
                f = self.observe(series, v,
                                 lower_is_better=(direction == "lower"),
                                 t=now if now is not None
                                 else rec.get("ts"))
                if f is not None and f["regression"]:
                    out.append(f)
        return out

    def active(self, now: Optional[float] = None,
               within_s: float = REGRESSION_ACTIVE_S) -> list[dict]:
        now = _time.time() if now is None else now
        return [f for f in self._findings
                if now - f["t"] <= within_s]


# ---------------------------------------------------------------------------
# Webhook / ndjson sink (service/client.py's bounded-backoff idiom:
# emit() NEVER raises, zero-progress attempts back off exponentially
# and give up after max_retries).


class AlertSink:
    """Fan one transition record out to an HTTP webhook (``http(s)://``
    target — one JSON POST per record) or an ndjson file (any other
    target)."""

    def __init__(self, target: str, *, max_retries: int = 3,
                 base_backoff_s: float = 0.05, max_backoff_s: float = 2.0,
                 timeout_s: float = 5.0, sleep=_time.sleep):
        self.target = target
        self.is_http = target.startswith(("http://", "https://"))
        self.max_retries = max_retries
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.timeout_s = timeout_s
        self.sleep = sleep
        self.emitted = 0
        self.failures = 0

    def emit(self, record: dict) -> dict:
        if not self.is_http:
            try:
                d = os.path.dirname(self.target)
                if d:
                    os.makedirs(d, exist_ok=True)
                with open(self.target, "a", encoding="utf-8") as f:
                    f.write(json.dumps(record, sort_keys=True,
                                       default=str) + "\n")
                self.emitted += 1
                return {"ok": True, "status": 200, "attempts": 1}
            except OSError as e:
                self.failures += 1
                return {"ok": False, "status": 0, "attempts": 1,
                        "error": str(e)}
        import urllib.error
        import urllib.request

        body = json.dumps(record, sort_keys=True,
                          default=str).encode("utf-8")
        consec = 0
        while True:
            try:
                req = urllib.request.Request(
                    self.target, data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as r:
                    self.emitted += 1
                    return {"ok": True, "status": r.status,
                            "attempts": consec + 1}
            except urllib.error.HTTPError as e:
                status, retryable = e.code, e.code in (429, 503)
            except (urllib.error.URLError, OSError, TimeoutError):
                status, retryable = 0, True
            consec += 1
            if not retryable or consec >= self.max_retries:
                self.failures += 1
                return {"ok": False, "status": status,
                        "attempts": consec}
            self.sleep(min(self.base_backoff_s * (2 ** (consec - 1)),
                           self.max_backoff_s))


# ---------------------------------------------------------------------------
# The lifecycle engine + durable alerts.jsonl.


class _RuleState:
    __slots__ = ("state", "since", "clear_since", "generation",
                 "evidence")

    def __init__(self):
        self.state = "inactive"
        self.since: Optional[float] = None
        self.clear_since: Optional[float] = None
        self.generation = 0
        self.evidence: Optional[dict] = None


class AlertEngine:
    """Evaluates a rule set over context snapshots on the host's
    cadence, maintains the typed per-rule lifecycle, appends every
    transition to a durable ``alerts.jsonl`` (ConsistentLines
    discipline: reopening truncates a torn tail, replay restores the
    firing set and the monotone generation counters), exports
    ``alerts_total{rule,severity}`` / ``alerts_firing{rule}``, and
    fans transitions out to an optional :class:`AlertSink`."""

    def __init__(self, rules: Optional[list] = None, *,
                 metrics=None, path: Optional[str] = None,
                 sink: Optional[AlertSink] = None, source: str = "",
                 history_limit: int = 512, now=_time.time):
        self.rules = list(rules) if rules is not None else catalogue()
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.metrics = metrics
        self.sink = sink
        self.source = source
        self.path = path
        self.now = now
        self.eval_seconds = 0.0
        self.evaluations = 0
        self.append_failures = 0
        self.replayed = 0
        self.replay_torn = False
        self._history: collections.deque = collections.deque(
            maxlen=history_limit)
        self._state: dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self._f = None
        if path:
            self._open_journal(path)

    # -- durability ----------------------------------------------------------

    def _open_journal(self, path: str) -> None:
        """Replay the consistent prefix (restoring firing states and
        generation counters), truncate any torn tail, reopen for
        line-buffered append — the TenantJournal reopen discipline."""
        from ..service.journal import ConsistentLines

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        consistent = 0
        if os.path.exists(path):
            lines = ConsistentLines(path)
            for rec in lines:
                self._restore(rec)
                self.replayed += 1
            self.replay_torn = lines.torn
            consistent = lines.consistent_bytes
            if lines.torn:
                try:
                    with open(path, "r+b") as tf:
                        tf.truncate(consistent)
                except OSError:
                    LOG.warning("could not truncate torn tail of %s",
                                path, exc_info=True)
        self._f = open(path, "a", buffering=1, encoding="utf-8")

    def _restore(self, rec: dict) -> None:
        rule = rec.get("rule")
        st = self._state.get(rule)
        if st is None:
            return  # a rule removed from the catalogue: history only
        state = rec.get("state")
        if state not in STATES:
            return
        gen = rec.get("generation")
        if isinstance(gen, int):
            st.generation = max(st.generation, gen)
        st.state = "inactive" if state == "resolved" else state
        st.since = rec.get("t") if isinstance(
            rec.get("t"), (int, float)) else None
        st.clear_since = None
        st.evidence = rec.get("evidence") \
            if isinstance(rec.get("evidence"), dict) else None
        self._history.append(dict(rec))

    def _append(self, rec: dict) -> None:
        if self._f is None:
            return
        try:
            self._f.write(json.dumps(rec, sort_keys=True,
                                     default=str) + "\n")
        except (OSError, ValueError):
            self.append_failures += 1
            if self.append_failures == 1:
                LOG.warning("alerts.jsonl append failing (%s); alert "
                            "durability lost, evaluation continues",
                            self.path, exc_info=True)

    # -- evaluation ----------------------------------------------------------

    def _record(self, rule: AlertRule, state: str, now: float,
                st: _RuleState) -> dict:
        rec = {"t": now, "rule": rule.name, "severity": rule.severity,
               "state": state, "generation": st.generation,
               "evidence": st.evidence, "source": self.source}
        self._history.append(rec)
        self._append(rec)
        if self.metrics is not None:
            firing = self.metrics.gauge(
                "alerts_firing",
                "Alert rules currently firing (1 per firing rule; "
                "the unlabeled total is the firing count)",
                labelnames=("rule",), aggregate=True)
            if state == "firing":
                total = self.metrics.counter(
                    "alerts_total",
                    "Alert firing transitions, by rule and severity",
                    labelnames=("rule", "severity"), aggregate=True)
                total.labels(rule=rule.name,
                             severity=rule.severity).inc()
                total.inc()  # the unlabeled all-rules child
                firing.labels(rule=rule.name).set(1)
            elif state in ("resolved", "inactive"):
                firing.labels(rule=rule.name).set(0)
            if state in ("firing", "resolved", "inactive"):
                firing.set(len(self.firing()))
        if self.sink is not None:
            try:
                self.sink.emit(rec)
            except Exception:  # noqa: BLE001 - sink must never bite
                LOG.warning("alert sink raised", exc_info=True)
        return rec

    def evaluate(self, ctx: dict, now: Optional[float] = None) -> list:
        """One pass over every rule; returns the transition records
        emitted (possibly empty). Never raises out of a predicate —
        a broken rule reads as not-firing."""
        t0 = _time.perf_counter()
        now = self.now() if now is None else now
        ctx = dict(ctx or {})
        ctx.setdefault("now", now)
        out = []
        for rule in self.rules:
            try:
                ev = rule.predicate(ctx)
            except Exception:  # noqa: BLE001
                LOG.warning("alert predicate %s raised", rule.name,
                            exc_info=True)
                ev = None
            st = self._state[rule.name]
            if ev:
                st.clear_since = None
                st.evidence = ev
                if st.state == "inactive":
                    st.since = now
                    if rule.for_s > 0:
                        st.state = "pending"
                        out.append(self._record(rule, "pending", now,
                                                st))
                    else:
                        st.state = "firing"
                        st.generation += 1
                        out.append(self._record(rule, "firing", now,
                                                st))
                elif st.state == "pending" \
                        and now - (st.since or now) >= rule.for_s:
                    st.state = "firing"
                    st.generation += 1
                    st.since = now
                    out.append(self._record(rule, "firing", now, st))
            else:
                if st.state == "pending":
                    st.state = "inactive"
                    st.since = None
                    out.append(self._record(rule, "inactive", now, st))
                elif st.state == "firing":
                    if rule.resolve_for_s > 0:
                        if st.clear_since is None:
                            st.clear_since = now
                        if now - st.clear_since < rule.resolve_for_s:
                            continue
                    st.state = "inactive"
                    st.since = None
                    st.clear_since = None
                    out.append(self._record(rule, "resolved", now, st))
        self.eval_seconds += _time.perf_counter() - t0
        self.evaluations += 1
        return out

    # -- views ---------------------------------------------------------------

    def firing(self) -> dict:
        """rule -> {severity, since, generation, evidence} for every
        currently-firing rule (the restart-replay pin's subject)."""
        out = {}
        for rule in self.rules:
            st = self._state[rule.name]
            if st.state == "firing":
                out[rule.name] = {"severity": rule.severity,
                                  "since": st.since,
                                  "generation": st.generation,
                                  "evidence": st.evidence}
        return out

    def fired_rules(self) -> set:
        """Every rule that has fired at least once this process
        generation (history + replay) — the chaos matrix's subject."""
        return {rec["rule"] for rec in self._history
                if rec.get("state") == "firing"}

    def history(self, limit: int = 40) -> list[dict]:
        return list(self._history)[-limit:]

    def timeline_rows(self, limit: int = 40) -> list[dict]:
        """Alert transitions shaped for the /fleet timeline join
        (kind="alert" next to place/respawn/epoch rows)."""
        return [{"kind": "alert", "t": rec.get("t"),
                 "rule": rec.get("rule"), "state": rec.get("state"),
                 "severity": rec.get("severity"),
                 "generation": rec.get("generation")}
                for rec in self.history(limit)]

    def snapshot(self) -> dict:
        """The ``GET /alerts`` document."""
        return {"enabled": True, "source": self.source,
                "path": self.path,
                "rules": [r.describe() for r in self.rules],
                "firing": self.firing(),
                "recent": self.history(),
                "evaluations": self.evaluations,
                "eval_seconds": round(self.eval_seconds, 6),
                "append_failures": self.append_failures,
                "replayed": self.replayed,
                "replay_torn": self.replay_torn}

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None


# ---------------------------------------------------------------------------
# Offline emitters (the `ledger --check --alerts` pipeline) + replay.


def replay(path: str) -> dict:
    """Fold an ``alerts.jsonl`` consistent prefix into
    ``{"records", "firing", "torn"}`` without constructing an engine —
    the CLI's and the ledger emitter's shared reader."""
    from ..service.journal import ConsistentLines

    records: list[dict] = []
    last: dict[str, dict] = {}
    torn = False
    if os.path.exists(path):
        lines = ConsistentLines(path)
        for rec in lines:
            records.append(rec)
            if rec.get("rule"):
                last[rec["rule"]] = rec
        torn = lines.torn
    firing = {r: {"severity": rec.get("severity"),
                  "since": rec.get("t"),
                  "generation": rec.get("generation"),
                  "evidence": rec.get("evidence")}
              for r, rec in sorted(last.items())
              if rec.get("state") in ("firing", "pending")
              and rec.get("state") == "firing"}
    return {"records": records, "firing": firing, "torn": torn}


def append_finding(path: str, evidence: dict, *,
                   rule: str = "perf_regression",
                   severity: str = "medium", source: str = "ledger",
                   now: Optional[float] = None) -> Optional[dict]:
    """Append one firing record for an offline finding (the
    ``ledger --check --alerts`` seam), continuing the file's monotone
    generation counter. Never raises; returns the record or None."""
    try:
        folded = replay(path)
        gen = max((r.get("generation") or 0
                   for r in folded["records"]
                   if r.get("rule") == rule), default=0) + 1
        rec = {"t": _time.time() if now is None else now, "rule": rule,
               "severity": severity, "state": "firing",
               "generation": gen, "evidence": evidence,
               "source": source}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
        return rec
    except OSError:
        LOG.warning("could not append alert finding to %s", path,
                    exc_info=True)
        return None


# ---------------------------------------------------------------------------
# CLI: tail / replay an alerts.jsonl.


def _render_record(rec: dict) -> str:
    t = rec.get("t")
    stamp = _time.strftime("%H:%M:%S", _time.localtime(t)) \
        if isinstance(t, (int, float)) else "?"
    return (f"{stamp}  {rec.get('state', '?'):8s} "
            f"[{rec.get('severity', '?')}] {rec.get('rule', '?')}"
            f"  gen={rec.get('generation')}"
            + (f"  source={rec['source']}" if rec.get("source") else ""))


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.alerts",
        description="Replay or tail a durable alerts.jsonl (the "
                    "alert plane's transition journal).")
    p.add_argument("path", help="alerts.jsonl to read")
    p.add_argument("--firing", action="store_true",
                   help="print only the restored firing set")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("--follow", action="store_true",
                   help="keep polling for appended records (Ctrl-C "
                        "to stop)")
    p.add_argument("--interval", type=float, default=1.0,
                   help="--follow poll interval seconds")
    ns = p.parse_args(argv)

    if not os.path.exists(ns.path):
        print(f"alerts: no such file {ns.path!r}", file=sys.stderr)
        return 2
    folded = replay(ns.path)
    if ns.as_json:
        doc = {"firing": folded["firing"], "torn": folded["torn"]}
        if not ns.firing:
            doc["records"] = folded["records"]
        print(json.dumps(doc, indent=1, sort_keys=True, default=str))
    elif ns.firing:
        if not folded["firing"]:
            print("no alerts firing")
        for rule, row in folded["firing"].items():
            print(f"FIRING [{row['severity']}] {rule} "
                  f"gen={row['generation']} since={row['since']}")
    else:
        for rec in folded["records"]:
            print(_render_record(rec))
        print(f"-- {len(folded['records'])} transition(s), "
              f"{len(folded['firing'])} firing"
              + (", torn tail dropped" if folded["torn"] else ""))
    if ns.follow:
        seen = len(folded["records"])
        try:
            while True:
                _time.sleep(ns.interval)
                folded = replay(ns.path)
                for rec in folded["records"][seen:]:
                    print(_render_record(rec), flush=True)
                seen = max(seen, len(folded["records"]))
        except KeyboardInterrupt:
            pass
    return 1 if folded["firing"] and ns.firing else 0


if __name__ == "__main__":
    sys.exit(main())
