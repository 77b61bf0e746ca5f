"""Fleet-wide metrics federation, scrape staleness and SLO burn rates.
The port of the reference's ``jepsen_tpu/telemetry/fleet.py``: the merged
samples and the Prometheus text are the reference's on the same scrape
payloads.

The router fronts N backend processes (live migration, respawn
supervision, epoch fencing), but every registry is per-process: nothing
could answer "is every backend saturated?" or give a *real* fleet p99.
This module makes the fleet observable as ONE system.

Federation model
----------------
Each backend serves its live registry over ``GET /metrics`` (Prometheus
text exposition, for humans and external scrapers) and
``GET /metrics.json`` (:func:`scrape_payload` — the samples, help
strings and the bounded event ring). The router scrapes the JSON form
on its probe cadence: re-parsing our own text exposition would discard
the event ring the utilization reconstruction needs, and histograms
would arrive cumulated. :class:`FleetFederation` REPLACES each
backend's snapshot wholesale on every successful scrape — it never
accumulates across scrapes, so a respawned backend's fresh (lower)
counters simply replace the dead generation's: no double-count across
generations, by construction.

Merge rules (:func:`merge_samples`)
-----------------------------------
Every family is re-labeled into per-backend children
(``name{...,backend="b0"}``) plus ONE cross-backend total per original
labelset:

- counters and gauges: totals sum across backends (a gauge total is the
  fleet-wide level, e.g. ``service_tenants`` = tenants anywhere);
- histograms: per-bucket counts merge (``count``/``sum`` add), so the
  fleet p99 is a real quantile of the merged distribution — NOT an
  average of per-backend averages. Histogram children whose bucket
  bounds differ across backends keep their per-backend children but get
  no total: merging mismatched buckets would fabricate a distribution.

Staleness
---------
A scrape failure keeps the last snapshot but lets its age grow
(``fleet_scrape_age_seconds{backend}``, ``fleet_scrape_failures_total``)
— a dead or mid-respawn backend reads as *stale*, never as
silently-zero. ``fleet_backends_stale`` counts backends whose age
passed the threshold (or that were expected but never scraped).

SLO burn rates (:class:`SloMonitor`)
------------------------------------
Two fleet SLOs computed from the federated totals over a fast and a
slow window (the multiwindow burn-rate alerting shape): availability
(rejects vs. attempts) and decision latency (share of ops decided
slower than the target). ``burn rate = bad-fraction / error budget`` —
1.0 means the budget burns exactly at the sustainable rate; the advisor
thresholds live in :mod:`jepsen_tpu_torch.advisor` (``slo_burn``).

Everything here is pure over ``Registry.collect()``-shaped sample
lists, so the merge, staleness and burn semantics are testable
closed-form, without processes.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Iterable, Optional, Sequence

from . import export as _export
from .registry import bucket_quantile

# Tail of the backend event ring shipped per scrape: bounds the payload
# while keeping the recent window the utilization Gantt renders.
MAX_SCRAPE_EVENTS = 20_000

# A backend whose last successful scrape is older than this reads as
# stale (the router default: a handful of probe intervals).
SCRAPE_STALE_AFTER_S = 5.0

# SLO defaults: 99.9% of submits accepted; 99% of accepted ops decided
# within 30 s (the decision-latency bucket bound right above the online
# monitor's worst healthy tail).
SLO_AVAILABILITY_TARGET = 0.999
SLO_LATENCY_TARGET_S = 30.0
SLO_LATENCY_RATIO = 0.99
SLO_FAST_WINDOW_S = 60.0
SLO_SLOW_WINDOW_S = 600.0


def scrape_payload(registry, *, service: Optional[str] = None,
                   max_events: int = MAX_SCRAPE_EVENTS) -> dict:
    """The backend side of one federation scrape: every metric sample,
    the help strings (so the router's merged exposition keeps them) and
    the tail of the bounded event ring (the chunk/backlog events the
    fleet utilization view reconstructs from)."""
    with registry._lock:
        helps = {n: m.help for n, m in registry._metrics.items()
                 if m.help}
    events = registry.events()
    if max_events is not None and len(events) > max_events:
        events = events[-max_events:]
    return {
        "v": 1,
        "service": service,
        "t": round(_time.time(), 3),
        "samples": registry.collect(),
        "helps": helps,
        "events": events,
    }


def _bounds_counts(buckets: dict) -> tuple[list[float], list[int]]:
    """Split a sample's ``buckets`` dict into ascending finite bounds +
    counts (with the ``+Inf`` count appended last) — the
    :func:`bucket_quantile` calling convention."""
    finite = sorted((float(k), int(v)) for k, v in buckets.items()
                    if k != "+Inf")
    bounds = [b for b, _ in finite]
    counts = [c for _, c in finite]
    counts.append(int(buckets.get("+Inf", 0)))
    return bounds, counts


def stats_from_sample(sample: dict,
                      quantiles: Sequence[float] = (0.5, 0.9, 0.99)
                      ) -> dict:
    """``Histogram.stats()``-shaped summary of one histogram sample
    (works on merged fleet totals just as well as raw children)."""
    bounds, counts = _bounds_counts(sample.get("buckets") or {})
    out: dict = {"count": int(sample.get("count") or 0),
                 "sum_s": round(float(sample.get("sum") or 0.0), 6)}
    for q in quantiles:
        v = bucket_quantile(bounds, counts, q)
        out[f"p{int(round(q * 100))}_s"] = (
            round(v, 6) if v is not None else None)
    return out


def merge_samples(per_backend: dict[str, list[dict]]) -> list[dict]:
    """Federate per-backend sample lists into one fleet view: every
    sample re-labeled with ``backend=<name>``, plus one cross-backend
    total per (family, original labelset) — see the module docstring
    for the per-type merge rules. Output is sorted by (name, labels)
    like ``Registry.collect()``."""
    children: list[dict] = []
    totals: dict[tuple, Optional[dict]] = {}
    for b in sorted(per_backend):
        for s in per_backend[b]:
            labels = dict(s.get("labels") or {})
            child = dict(s)
            child["labels"] = {**labels, "backend": b}
            children.append(child)
            key = (s.get("name"), tuple(sorted(labels.items())))
            tot = totals.get(key)
            if s.get("type") == "histogram":
                sb = s.get("buckets") or {}
                if key not in totals:
                    totals[key] = {
                        "name": s.get("name"), "type": "histogram",
                        "labels": labels, "count": 0, "sum": 0.0,
                        "buckets": {k: 0 for k in sb},
                    }
                    tot = totals[key]
                elif tot is not None and set(tot["buckets"]) != set(sb):
                    # Mismatched bucket bounds: merging would fabricate
                    # a distribution — keep children, drop the total.
                    totals[key] = None
                    continue
                if tot is None:
                    continue
                tot["count"] += int(s.get("count") or 0)
                tot["sum"] += float(s.get("sum") or 0.0)
                for k, v in sb.items():
                    tot["buckets"][k] += int(v)
            else:
                if key not in totals:
                    totals[key] = {
                        "name": s.get("name"), "type": s.get("type"),
                        "labels": labels, "value": 0.0,
                    }
                    tot = totals[key]
                if tot is not None:
                    tot["value"] += float(s.get("value") or 0.0)
    out = children + [t for t in totals.values() if t is not None]
    out.sort(key=lambda s: (s.get("name") or "",
                            tuple(sorted((s.get("labels") or {}).items()))))
    return out


def prometheus_text_for(samples: Iterable[dict],
                        helps: Optional[dict] = None) -> str:
    """Prometheus text exposition of a sample list (the federated
    ``GET /metrics`` body — :func:`export.prometheus_text` is the same
    renderer, but bound to a live :class:`Registry`)."""
    helps = helps or {}
    by_name: dict[str, list[dict]] = {}
    kinds: dict[str, str] = {}
    for s in samples:
        by_name.setdefault(s["name"], []).append(s)
        kinds.setdefault(s["name"], s.get("type") or "untyped")
    lines: list[str] = []
    for name in sorted(by_name):
        kind = kinds[name]
        if helps.get(name):
            lines.append(f"# HELP {name} {helps[name]}")
        lines.append(f"# TYPE {name} {kind}")
        for s in by_name[name]:
            labels = s.get("labels") or {}
            if kind == "histogram":
                cum = 0
                bounds, counts = _bounds_counts(s.get("buckets") or {})
                for le, c in zip([*map(str, bounds), "+Inf"], counts):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_export._label_str(labels, {'le': le})} {cum}")
                lines.append(f"{name}_sum{_export._label_str(labels)} "
                             f"{_export._fmt(s.get('sum') or 0.0)}")
                lines.append(f"{name}_count{_export._label_str(labels)} "
                             f"{int(s.get('count') or 0)}")
            else:
                lines.append(f"{name}{_export._label_str(labels)} "
                             f"{_export._fmt(s.get('value') or 0.0)}")
    return "\n".join(lines) + ("\n" if lines else "")


def backlog_occupancy(events: Iterable[dict],
                      *, until: Optional[float] = None) -> Optional[dict]:
    """Backend-busy share from the ``online_backlog`` gauge timeline:
    the fraction of the observed window during which the scheduler held
    undecided segments. The fallback saturation proxy when a backend
    ran no device kernels (host engine) and so emitted no stamped chunk
    events for the chunk-based busy-span reconstruction."""
    pts = sorted(
        (float(e["t"]), float(e.get("backlog") or 0))
        for e in events
        if e.get("name") == "online_backlog" and e.get("t") is not None)
    if not pts:
        return None
    w0 = pts[0][0]
    w1 = max(until if until is not None else pts[-1][0], pts[-1][0])
    if w1 <= w0:
        return None
    intervals: list[list[float]] = []
    for i, (t, v) in enumerate(pts):
        if v <= 0:
            continue
        t1 = pts[i + 1][0] if i + 1 < len(pts) else w1
        if intervals and t <= intervals[-1][1]:
            intervals[-1][1] = max(intervals[-1][1], t1)
        else:
            intervals.append([t, t1])
    busy = sum(b - a for a, b in intervals)
    makespan = w1 - w0
    return {
        "utilization_pct": round(busy / makespan * 100.0, 2),
        "window": {"t0": round(w0, 6), "t1": round(w1, 6),
                   "makespan_s": round(makespan, 6)},
        "intervals": [[round(a - w0, 6), round(b - w0, 6)]
                      for a, b in intervals],
    }


class _ScrapedRegistry:
    """Read-only shim over one scraped event ring, shaped just enough
    for ``utilization.reconstruct`` (which only reads ``events()`` and
    tolerates a registry that refuses writes)."""

    def __init__(self, events: list[dict]):
        self._events = list(events)

    def events(self, name: Optional[str] = None) -> list[dict]:
        if name is None:
            return list(self._events)
        return [e for e in self._events if e.get("name") == name]

    def gauge(self, *_a, **_k):  # pragma: no cover - exercised via reconstruct
        raise RuntimeError("scraped snapshot is read-only")


class FleetFederation:
    """The router-side scrape store: one replace-on-scrape snapshot per
    backend, merged on demand (see the module docstring for the
    semantics this class pins)."""

    def __init__(self, metrics=None, *,
                 stale_after_s: float = SCRAPE_STALE_AFTER_S):
        self.metrics = metrics
        self.stale_after_s = float(stale_after_s)
        self._lock = threading.Lock()
        self._snaps: dict[str, dict] = {}
        self._failures: dict[str, int] = {}
        if metrics is not None:
            self._g_age = metrics.gauge(
                "fleet_scrape_age_seconds",
                "Seconds since each backend's last successful metrics "
                "scrape (a dead/respawning backend's age grows while "
                "its last snapshot is kept — stale, never silently "
                "zero)", labelnames=("backend",))
            self._c_scrapes = metrics.counter(
                "fleet_scrapes_total",
                "Successful federation scrapes per backend",
                labelnames=("backend",))
            self._c_fail = metrics.counter(
                "fleet_scrape_failures_total",
                "Failed federation scrapes per backend (the snapshot "
                "is kept and ages)", labelnames=("backend",))
            self._g_stale = metrics.gauge(
                "fleet_backends_stale",
                "Backends whose scrape age passed the staleness "
                "threshold (or that were expected but never scraped)")

    # -- the scrape side -----------------------------------------------------

    def record_scrape(self, backend: str, payload: dict,
                      *, now: Optional[float] = None) -> None:
        """REPLACE ``backend``'s snapshot (generation-replace: a
        respawned backend's fresh counters supersede the dead
        generation's — no cross-generation double count)."""
        now = _time.time() if now is None else float(now)
        snap = {
            "samples": list(payload.get("samples") or ()),
            "helps": dict(payload.get("helps") or {}),
            "events": list(payload.get("events") or ()),
            "service": payload.get("service"),
            "at": now,
        }
        with self._lock:
            prev = self._snaps.get(backend)
            snap["scrapes"] = (prev["scrapes"] + 1) if prev else 1
            self._snaps[backend] = snap
        if self.metrics is not None:
            self._c_scrapes.labels(backend=backend).inc()
            self._g_age.labels(backend=backend).set(0.0)

    def record_failure(self, backend: str) -> None:
        with self._lock:
            self._failures[backend] = self._failures.get(backend, 0) + 1
        if self.metrics is not None:
            self._c_fail.labels(backend=backend).inc()

    def forget(self, backend: str) -> None:
        with self._lock:
            self._snaps.pop(backend, None)
            self._failures.pop(backend, None)

    # -- staleness -----------------------------------------------------------

    def ages(self, *, now: Optional[float] = None) -> dict[str, float]:
        """Scrape age per backend (also refreshes the
        ``fleet_scrape_age_seconds`` gauges)."""
        now = _time.time() if now is None else float(now)
        with self._lock:
            ages = {b: max(now - s["at"], 0.0)
                    for b, s in self._snaps.items()}
        if self.metrics is not None:
            for b, a in ages.items():
                self._g_age.labels(backend=b).set(round(a, 3))
        return ages

    def stale_backends(self, expected: Optional[Iterable[str]] = None,
                       *, now: Optional[float] = None) -> list[str]:
        """Backends whose snapshot aged past the threshold, plus any
        ``expected`` name never scraped at all.

        When ``expected`` is given it is the CURRENT config: a
        snapshot held for a backend no longer listed is decommissioned
        — once its age passes the threshold it is expired (forgotten)
        rather than reported, so removing a backend from config can't
        pin the staleness signal (and its alert) forever. Until expiry
        the snapshot still merges (a just-removed backend's counters
        drain out after ``stale_after_s``, not instantly)."""
        expected_set = set(expected) if expected is not None else None
        ages = self.ages(now=now)
        if expected_set is not None:
            for b, a in ages.items():
                if b not in expected_set and a > self.stale_after_s:
                    self.forget(b)
                    if self.metrics is not None:
                        self._g_age.labels(backend=b).set(0.0)
            ages = {b: a for b, a in ages.items() if b in expected_set}
        stale = {b for b, a in ages.items() if a > self.stale_after_s}
        stale.update(b for b in (expected_set or ()) if b not in ages)
        out = sorted(stale)
        if self.metrics is not None:
            self._g_stale.set(len(out))
        return out

    # -- the merged view -----------------------------------------------------

    def backends(self) -> list[str]:
        with self._lock:
            return sorted(self._snaps)

    def merged(self) -> list[dict]:
        with self._lock:
            per = {b: s["samples"] for b, s in self._snaps.items()}
        return merge_samples(per)

    def helps(self) -> dict[str, str]:
        out: dict[str, str] = {}
        with self._lock:
            for b in sorted(self._snaps):
                for n, h in self._snaps[b]["helps"].items():
                    out.setdefault(n, h)
        return out

    def prometheus_text(self) -> str:
        return prometheus_text_for(self.merged(), self.helps())

    def fleet_histogram(self, name: str,
                        labels: Optional[dict] = None) -> Optional[dict]:
        """The cross-backend TOTAL sample of one histogram family (the
        merged distribution; ``labels`` selects a labeled child's
        total, default the aggregate/unlabeled one)."""
        want = dict(labels or {})
        for s in self.merged():
            if (s.get("name") == name and s.get("type") == "histogram"
                    and s.get("labels") == want):
                return s
        return None

    def histogram_stats(self, name: str, labels: Optional[dict] = None,
                        quantiles: Sequence[float] = (0.5, 0.9, 0.99)
                        ) -> Optional[dict]:
        s = self.fleet_histogram(name, labels)
        return None if s is None else stats_from_sample(s, quantiles)

    # -- per-backend introspection (the /fleet page + bench block) -----------

    def meta(self, *, now: Optional[float] = None,
             expected: Optional[Iterable[str]] = None) -> dict[str, dict]:
        """Per-backend scrape bookkeeping: last-scrape stamp/age,
        scrape + failure counts, staleness. With ``expected`` (the
        current config), a held snapshot for an unlisted backend is
        flagged ``decommissioned`` — it merges until
        :meth:`stale_backends` expires it, but no longer counts
        against fleet health."""
        now = _time.time() if now is None else float(now)
        expected_set = set(expected) if expected is not None else None
        with self._lock:
            snaps = dict(self._snaps)
            failures = dict(self._failures)
        out: dict[str, dict] = {}
        for b in sorted(set(snaps) | set(failures)):
            s = snaps.get(b)
            row: dict = {
                "scrapes": s["scrapes"] if s else 0,
                "scrape_failures": failures.get(b, 0),
            }
            if expected_set is not None and b not in expected_set:
                row["decommissioned"] = True
            if s is not None:
                age = max(now - s["at"], 0.0)
                row["scraped_at"] = round(s["at"], 3)
                row["scrape_age_s"] = round(age, 3)
                row["stale"] = age > self.stale_after_s
                if s.get("service"):
                    row["service"] = s["service"]
            else:
                row["stale"] = True
            out[b] = row
        return out

    def events(self, backend: str) -> list[dict]:
        with self._lock:
            s = self._snaps.get(backend)
            return list(s["events"]) if s else []

    def utilization(self, backend: str) -> Optional[dict]:
        """This backend's saturation view from its scraped event ring:
        the chunk-based busy-span reconstruction when the backend
        ran device kernels, else the ``online_backlog`` occupancy
        proxy. None when the snapshot carries neither."""
        evs = self.events(backend)
        if not evs:
            return None
        from . import utilization as _util

        util = _util.reconstruct(_ScrapedRegistry(evs))
        if util is not None:
            summ = util.get("summary") or {}
            return {
                "source": "chunks",
                "utilization_pct": summ.get("mean_utilization_pct"),
                "window": util.get("window"),
                "summary": summ,
                "devices": util.get("devices"),
            }
        occ = backlog_occupancy(evs)
        if occ is not None:
            return {"source": "backlog", **occ}
        return None


class SloMonitor:
    """Fleet SLO burn rates over the federated totals (see the module
    docstring). ``observe`` is called once per scrape sweep with the
    merged sample list; it keeps a bounded history of cumulative
    totals and computes windowed deltas — counter resets from a
    backend-generation replace clamp to zero rather than going
    negative."""

    def __init__(self, metrics=None, *,
                 availability_target: float = SLO_AVAILABILITY_TARGET,
                 latency_target_s: float = SLO_LATENCY_TARGET_S,
                 latency_ratio: float = SLO_LATENCY_RATIO,
                 fast_window_s: float = SLO_FAST_WINDOW_S,
                 slow_window_s: float = SLO_SLOW_WINDOW_S,
                 latency_family: str = "decision_latency_seconds",
                 rejects_family: str = "service_rejects_total"):
        if not 0.0 < availability_target < 1.0:
            raise ValueError("availability_target must be in (0, 1)")
        if not 0.0 < latency_ratio < 1.0:
            raise ValueError("latency_ratio must be in (0, 1)")
        self.availability_target = float(availability_target)
        self.latency_target_s = float(latency_target_s)
        self.latency_ratio = float(latency_ratio)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.latency_family = latency_family
        self.rejects_family = rejects_family
        self._points: deque = deque()
        self._lock = threading.Lock()
        self.metrics = metrics
        if metrics is not None:
            self._g_avail = metrics.gauge(
                "slo_availability_burn_rate",
                "Fleet availability error-budget burn rate per window "
                "(1.0 = budget burning at exactly the sustainable "
                "rate)", labelnames=("window",))
            self._g_lat = metrics.gauge(
                "slo_latency_burn_rate",
                "Fleet decision-latency error-budget burn rate per "
                "window (share of ops slower than the target vs. the "
                "allowed share)", labelnames=("window",))

    def _totals(self, merged: list[dict]) -> tuple[int, int, float]:
        """(decided ops, decided slower than target, rejected ops)
        from the fleet totals — samples WITHOUT a ``backend`` label,
        so per-backend children are never double-counted."""
        decided = slow = 0
        rejects = 0.0
        for s in merged:
            labels = s.get("labels") or {}
            if "backend" in labels:
                continue
            if (s.get("name") == self.latency_family
                    and s.get("type") == "histogram" and not labels):
                decided = int(s.get("count") or 0)
                within = sum(
                    int(v) for k, v in (s.get("buckets") or {}).items()
                    if k != "+Inf"
                    and float(k) <= self.latency_target_s)
                slow = max(decided - within, 0)
            elif (s.get("name") == self.rejects_family
                    and s.get("type") == "counter"):
                rejects += float(s.get("value") or 0.0)
        return decided, slow, rejects

    def observe(self, merged: list[dict],
                *, now: Optional[float] = None) -> dict:
        now = _time.time() if now is None else float(now)
        decided, slow, rejects = self._totals(merged)
        with self._lock:
            self._points.append((now, decided, slow, rejects))
            while (self._points
                   and self._points[0][0] < now - self.slow_window_s):
                self._points.popleft()
            points = list(self._points)
        windows: dict[str, dict] = {}
        for wname, ws in (("fast", self.fast_window_s),
                          ("slow", self.slow_window_s)):
            base = None
            for p in points:
                if p[0] >= now - ws:
                    base = p
                    break
            if base is None:
                base = points[0]
            d_dec = max(decided - base[1], 0)
            d_slow = max(slow - base[2], 0)
            d_rej = max(rejects - base[3], 0.0)
            attempts = d_dec + d_rej
            avail_bad = (d_rej / attempts) if attempts > 0 else 0.0
            avail_burn = avail_bad / (1.0 - self.availability_target)
            lat_bad = (d_slow / d_dec) if d_dec > 0 else 0.0
            lat_burn = lat_bad / (1.0 - self.latency_ratio)
            if self.metrics is not None:
                self._g_avail.labels(window=wname).set(
                    round(avail_burn, 4))
                self._g_lat.labels(window=wname).set(round(lat_burn, 4))
            windows[wname] = {
                "window_s": ws,
                "availability_burn_rate": round(avail_burn, 4),
                "latency_burn_rate": round(lat_burn, 4),
                "attempts": attempts,
                "rejected": d_rej,
                "decided": d_dec,
                "slow": d_slow,
            }
        return {
            "availability_target": self.availability_target,
            "latency_target_s": self.latency_target_s,
            "latency_ratio": self.latency_ratio,
            "windows": windows,
        }
