"""Thread-safe metrics registry: counters, gauges and histograms with
labels, plus a bounded append-only *event* stream for per-chunk and
per-level series.

A trimmed copy of the reference's ``jepsen_tpu/telemetry/registry.py``
(the Prometheus client-library data model without the dependency): a
:class:`Registry` owns named metrics, a metric owns one child per
label-value tuple, children hold the numbers. It keeps what the port's
drivers and checker record (counters, gauges, histograms, events); the
names, fields and ``collect``/``summary`` shapes are the reference's, so
the reference's readers (``telemetry.utilization``, ``telemetry.profile``)
take a port run's registry unchanged. The kernels never see any of this: the drivers
fold each chunk's flags and stats ring into it on the host.
"""

from __future__ import annotations

import bisect
import threading
import time as _time
from collections import deque
from typing import Any, Optional, Sequence

# Latency buckets (seconds), 0.5 ms .. 10 s.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Decision-latency buckets (seconds) of the online monitor's invoke ->
# watermark-covered lag: past DEFAULT_BUCKETS' 10 s, so a backlogged
# scheduler's 30 s stall does not read like a 30 min one.
DECISION_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0,
)


def bucket_quantile(bounds: Sequence[float], counts: Sequence[int],
                    q: float) -> Optional[float]:
    """Prometheus-style ``histogram_quantile`` over per-bucket (not
    cumulative) counts: the bucket the q-rank falls in, interpolated
    linearly (its lower edge the previous bound, 0 for the first).
    ``counts`` may carry a trailing +Inf bucket; a rank there clamps to
    the highest finite bound. None when empty."""
    counts = list(counts)
    total = sum(counts)
    if total <= 0:
        return None
    rank = max(q, 0.0) * total
    cum = 0
    lo = 0.0
    for i, b in enumerate(bounds):
        c = counts[i] if i < len(counts) else 0
        cum += c
        if cum >= rank:
            if c <= 0:
                return float(b)
            frac = (rank - (cum - c)) / c
            return lo + (float(b) - lo) * frac
        lo = float(b)
    return float(bounds[-1])


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def max(self, value: float) -> None:
        """Ratchet: keep the largest value seen (frontier peaks)."""
        with self._lock:
            if value > self.value:
                self.value = float(value)


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock: threading.Lock, buckets: Sequence[float]):
        self._lock = lock
        self.buckets = tuple(buckets)  # upper bounds, ascending, no +Inf
        self.counts = [0] * (len(self.buckets) + 1)  # the last is +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            counts = list(self.counts)
        return bucket_quantile(self.buckets, counts, q)


class Metric:
    """One named metric; holds a child per label-value tuple.
    ``aggregate=True`` on a labeled metric also keeps one unlabeled child
    (under the empty label tuple) that the metric-level methods update."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (), aggregate: bool = False):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.aggregate = bool(aggregate)
        self._lock = threading.Lock()
        self._children: dict[tuple, Any] = {}
        if not self.labelnames:
            self._default = self.labels()
        elif self.aggregate:
            self._default = self._children.setdefault((), self._make_child())

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **labelvalues: Any):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(f"metric {self.name} takes labels {self.labelnames}, "
                             f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def samples(self) -> list[dict]:
        with self._lock:
            items = sorted(self._children.items())
        out = []
        for key, child in items:
            s: dict = {"name": self.name, "type": self.kind,
                       "labels": dict(zip(self.labelnames, key))}
            if isinstance(child, _HistogramChild):
                with child._lock:
                    s["count"] = child.count
                    s["sum"] = child.sum
                    s["buckets"] = dict(zip([*map(str, child.buckets), "+Inf"],
                                            list(child.counts)))
            else:
                s["value"] = child.value
            out.append(s)
        return out


class Counter(Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    @property
    def value(self) -> float:
        return self._default.value


class Gauge(Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild(self._lock)

    def set(self, value: float) -> None:
        self._default.set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    def max(self, value: float) -> None:
        self._default.max(value)

    @property
    def value(self) -> float:
        return self._default.value


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS, aggregate: bool = False):
        b = tuple(sorted(float(x) for x in buckets if x != float("inf")))
        if not b:
            raise ValueError("histogram needs at least one finite bucket")
        self.buckets = b
        super().__init__(name, help, labelnames, aggregate=aggregate)

    def _make_child(self):
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile of the unlabeled child."""
        return self._default.quantile(q)

    def stats(self, quantiles: Sequence[float] = (0.5, 0.9, 0.99),
              labels: Optional[dict] = None) -> dict:
        """Count, sum and interpolated quantiles (``{"count", "sum_s",
        "p50_s", ...}``) of the unlabeled child, or of the child
        ``labels`` names."""
        child = self._default if labels is None else self.labels(**labels)
        with child._lock:
            counts = list(child.counts)
            out: dict = {"count": child.count, "sum_s": round(child.sum, 6)}
        for q in quantiles:
            v = bucket_quantile(self.buckets, counts, q)
            out[f"p{int(round(q * 100))}_s"] = round(v, 6) if v is not None else None
        return out


class Registry:
    """Named-metric registry + bounded event stream.

    Register-or-get semantics: asking twice for the same name returns the
    same metric; asking with a different type or labelset raises (a silent
    second registration would split the series)."""

    def __init__(self, max_events: int = 100_000):
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}
        self._events: deque = deque(maxlen=max_events)
        # name -> newest event with that name, so last_event() is O(1)
        self._last_by_name: dict[str, dict] = {}
        self.created_at = _time.time()

    def _get_or_make(self, cls, name, help, labelnames, aggregate=False, **extra) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, aggregate=aggregate,
                                              **extra)
                return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(f"metric {name} already registered as {m.kind} with "
                             f"labels {m.labelnames}")
        if aggregate and not m.aggregate:
            raise ValueError(f"metric {name} already registered without an aggregate child")
        return m

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                aggregate: bool = False) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames, aggregate=aggregate)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = (),
              aggregate: bool = False) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames, aggregate=aggregate)

    def histogram(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  aggregate: bool = False) -> Histogram:
        m = self._get_or_make(Histogram, name, help, labelnames, aggregate=aggregate,
                              buckets=buckets)
        want = tuple(sorted(float(x) for x in buckets if x != float("inf")))
        if m.buckets != want:
            raise ValueError(f"metric {name} already registered with buckets {m.buckets}")
        return m

    def event(self, name: str, **fields: Any) -> None:
        """Append one point to the event stream. Bounded: the oldest points
        fall off past ``max_events``."""
        with self._lock:
            ev = {"name": name, **fields}
            self._events.append(ev)
            self._last_by_name[name] = ev

    def events(self, name: Optional[str] = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if name is None:
            return evs
        return [e for e in evs if e.get("name") == name]

    def last_event(self, name: str) -> Optional[dict]:
        """Newest event with this name, or None."""
        with self._lock:
            e = self._last_by_name.get(name)
            return dict(e) if e is not None else None

    def collect(self) -> list[dict]:
        """Samples of every metric, sorted by (name, labels)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: list[dict] = []
        for _name, m in metrics:
            out.extend(m.samples())
        return out

    def summary(self) -> dict:
        """Flat ``name{labels}`` -> value dict (a histogram folds to its
        count and sum)."""
        out: dict = {}
        for s in self.collect():
            labels = s.get("labels") or {}
            key = s["name"]
            if labels:
                inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                key = f"{key}{{{inner}}}"
            if s["type"] == "histogram":
                out[key] = {"count": s["count"], "sum": round(s["sum"], 6)}
            else:
                v = s["value"]
                out[key] = int(v) if float(v).is_integer() else round(v, 6)
        return out


def timed_phase(registry: Optional[Registry], phase: str, recorder=None):
    """Context manager recording the wall seconds of a run phase into
    ``run_phase_seconds{phase=...}`` (no-op when registry is None).
    ``recorder``: an optional ``flight.FlightRecorder``, which enters the
    same phase in its ledger, so a crashed run's flightrecord.json names
    the lifecycle phase that died."""
    from contextlib import contextmanager

    from . import flight as _flight

    @contextmanager
    def _cm():
        t0 = _time.perf_counter()
        try:
            with _flight.phase(recorder, phase):
                yield
        finally:
            if registry is not None:
                registry.gauge(
                    "run_phase_seconds",
                    "Wall seconds per test-lifecycle phase",
                    labelnames=("phase",),
                ).labels(phase=phase).set(_time.perf_counter() - t0)

    return _cm()
