"""Results browser: serve the ``store/`` tree over HTTP.

The port of the reference's ``jepsen_tpu/web.py``, host-only, with its
pages and their HTML unchanged. It mirrors jepsen.web
(jepsen/src/jepsen/web.clj): a table of tests (name, start time,
validity) linking into each run's files, plain file serving for
history.edn / results.edn / jepsen.log / plots, and zip download of a run
(web.clj:48-69, served by the CLI's ``serve``, cli.clj:323-340); plus the
pages of the observability plane over each run's stored artifacts:
``/metrics`` (metrics.jsonl), ``/profile`` (profile.json's roofline
attribution and memory watermarks), ``/utilization`` (its busy timelines
and occupancy Gantt), ``/runs`` (the ledger's trend), ``/online`` and
``/verdicts``.

Live operational view: ``/live`` serves an ndjson poll of every
registered *live source*, one JSON line per run in flight, fed by the
online monitor's ``live_snapshot()`` (decided-watermark frontier,
per-key queue depths, scheduler backlog, decision-latency quantiles,
watermark-stall seconds, per-shard utilization). ``core.run`` registers a
source while a monitored run executes (and an in-process server with
``live-port``); ``/live.html`` is a self-refreshing dashboard over the
same feed. With no live run the endpoint still answers one well-formed
``{"live_runs": 0}`` line. The multi-tenant service
(:mod:`jepsen_tpu_torch.service`) registers its ``live_snapshot`` as a live
source, with one row per tenant and, when its alerting plane is on, the
rules firing; ``/alerts`` and ``/alerts.json`` render those. The
scale-out router (:mod:`jepsen_tpu_torch.service.router`) registers its
``live_snapshot`` as a live source and its ``fleet_snapshot`` as a fleet
source: ``/fleet`` and ``/fleet.json`` render every backend's state,
scrape freshness and utilization, the ``router_state.jsonl`` timeline and
the SLO burn rates (their empty forms while no router runs).
"""

from __future__ import annotations

import html
import io
import json
import logging
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Callable, Optional
from urllib.parse import unquote

from . import store

LOG = logging.getLogger("jepsen.web")


# ---------------------------------------------------------------------------
# Live sources: process-global so the serving handler (which only knows
# the store root) can reach in-flight runs registered by core.run.

_LIVE_LOCK = threading.Lock()
# key -> (registration ordinal, snapshot fn). The ordinal pins a STABLE
# registration-order listing: with many concurrent runs/services a
# poller must see the same row order every poll, and re-registering a
# key (a replaced source) must keep its original slot rather than
# jump to the end.
_LIVE_SOURCES: dict[str, tuple[int, Callable[[], dict]]] = {}
_LIVE_SEQ = 0


def register_live_source(key: str, fn: Callable[[], dict]) -> None:
    """Expose ``fn()`` (a dict snapshot, e.g. ``OnlineMonitor.
    live_snapshot`` or ``Service.live_snapshot``) as one ``/live`` line
    under ``key`` until unregistered. Re-registering a key replaces its
    source in place (the listing slot is the FIRST registration's)."""
    global _LIVE_SEQ
    with _LIVE_LOCK:
        prev = _LIVE_SOURCES.get(key)
        if prev is not None:
            _LIVE_SOURCES[key] = (prev[0], fn)
        else:
            _LIVE_SOURCES[key] = (_LIVE_SEQ, fn)
            _LIVE_SEQ += 1


def unregister_live_source(key: str) -> None:
    with _LIVE_LOCK:
        _LIVE_SOURCES.pop(key, None)


# Fleet sources: a router's ``fleet_snapshot()`` (backend states +
# scrape freshness + utilization, the router_state timeline, SLO burn
# rates) — the ``/fleet`` page renders every registered one. Same
# stable-ordinal registry semantics as the live sources.
_FLEET_SOURCES: dict[str, tuple[int, Callable[[], dict]]] = {}


def register_fleet_source(key: str, fn: Callable[[], dict]) -> None:
    """Expose ``fn()`` (a ``Router.fleet_snapshot``-shaped dict) on
    the ``/fleet`` page under ``key`` until unregistered."""
    global _LIVE_SEQ
    with _LIVE_LOCK:
        prev = _FLEET_SOURCES.get(key)
        if prev is not None:
            _FLEET_SOURCES[key] = (prev[0], fn)
        else:
            _FLEET_SOURCES[key] = (_LIVE_SEQ, fn)
            _LIVE_SEQ += 1


def unregister_fleet_source(key: str) -> None:
    with _LIVE_LOCK:
        _FLEET_SOURCES.pop(key, None)


def fleet_snapshots() -> list[dict]:
    """One snapshot per registered fleet source, registration order; a
    raising source yields an error row instead of sinking the page."""
    with _LIVE_LOCK:
        items = [(key, fn) for key, (order, fn)
                 in sorted(_FLEET_SOURCES.items(),
                           key=lambda kv: kv[1][0])]
    out = []
    for key, fn in items:
        try:
            snap = dict(fn())
        except Exception as e:  # noqa: BLE001 - a poll must not 500
            snap = {"error": f"{type(e).__name__}: {e}"}
        snap.setdefault("router", key)
        out.append(snap)
    return out


def live_snapshots() -> list[dict]:
    """One snapshot dict per registered source, in registration order;
    a source that raises yields an ``{"error": ...}`` line instead of
    sinking the poll."""
    with _LIVE_LOCK:
        items = [(key, fn) for key, (order, fn)
                 in sorted(_LIVE_SOURCES.items(),
                           key=lambda kv: kv[1][0])]
    out = []
    for key, fn in items:
        try:
            snap = dict(fn())
        except Exception as e:  # noqa: BLE001 - a poll must not 500
            snap = {"error": f"{type(e).__name__}: {e}"}
        if snap.get("run") is None:  # unnamed run: label with the key
            snap["run"] = key
        out.append(snap)
    return out


def live_ndjson() -> str:
    """The ``/live`` payload: one JSON line per live run, or one
    ``{"live_runs": 0}`` line when nothing is registered."""
    snaps = live_snapshots()
    if not snaps:
        return json.dumps({"live_runs": 0}) + "\n"
    return "".join(json.dumps(s, sort_keys=True, default=str) + "\n"
                   for s in snaps)


def _valid_of(run_dir: Path) -> Any:
    f = run_dir / "results.edn"
    if not f.exists():
        return None
    try:
        from . import edn

        m = edn.read_string(f.read_text())
        v = m.get(edn.K("valid?"))
        if isinstance(v, edn.Keyword):
            return v.name
        return v
    except Exception:
        return "?"


_STYLE = """
body { font-family: sans-serif; margin: 2em; }
table { border-collapse: collapse; }
td, th { border: 1px solid #ccc; padding: 0.3em 0.8em; text-align: left; }
.valid-true { background: #c8f7c5; } .valid-false { background: #f7c5c5; }
.valid-unknown { background: #f7eec5; }
"""


# Per-run artifacts the index row links to directly (the telemetry +
# tracing + profiling sinks; everything else is reachable through the
# file listing).
_TELEMETRY_FILES = ("metrics.jsonl", "metrics.prom", "spans.jsonl",
                    "profile.json", "flightrecord.json", "online.json",
                    "offline.json")

# Jepsen-parity plot/timeline artifacts (checker/perf.py writes the
# pngs, checker/timeline.py the html) — they existed in the store but
# nothing linked them; the index row surfaces them when present.
_PARITY_FILES = ("latency-raw.png", "latency-quantiles.png", "rate.png",
                 "timeline.html")


def _index_page(root: Path) -> str:
    rows = []
    tests = store.tests(root=root)
    for name in sorted(tests):
        for start in sorted(tests[name], reverse=True):
            run = tests[name][start]
            v = _valid_of(run)
            cls = {True: "valid-true", False: "valid-false",
                   "unknown": "valid-unknown"}.get(v, "")
            vs = {True: "valid", False: "INVALID",
                  "unknown": "unknown"}.get(v, "—")
            tele = " ".join(
                f'<a href="/files/{name}/{start}/{fn}">{fn}</a>'
                for fn in _TELEMETRY_FILES + _PARITY_FILES
                if (run / fn).exists()
            ) or "—"
            rows.append(
                f'<tr class="{cls}"><td><a href="/files/{name}/{start}/">'
                f'{html.escape(name)}</a></td>'
                f"<td>{html.escape(start)}</td><td>{vs}</td>"
                f"<td>{tele}</td>"
                f'<td><a href="/zip/{name}/{start}">zip</a></td></tr>'
            )
    return (
        f"<html><head><title>Jepsen</title><style>{_STYLE}</style></head>"
        "<body><h1>Jepsen tests</h1>"
        '<p><a href="/metrics">metrics</a> · '
        '<a href="/profile">profile</a> · '
        '<a href="/utilization">utilization</a> · '
        '<a href="/runs">runs</a> · '
        '<a href="/online">online</a> · '
        '<a href="/verdicts">verdicts</a> · '
        '<a href="/live.html">live</a> · '
        '<a href="/fleet">fleet</a></p><table>'
        "<tr><th>Test</th><th>Started</th><th>Valid?</th>"
        "<th>Telemetry</th><th></th></tr>"
        + "".join(rows) + "</table></body></html>"
    )


def _metrics_summary(run_dir: Path, limit: int = 200) -> list[tuple]:
    """Parse a run's metrics.jsonl into display rows
    (metric, labels, value) — histograms fold to count/mean, events to a
    per-name count."""
    f = run_dir / "metrics.jsonl"
    if not f.exists():
        return []
    rows: list[tuple] = []
    event_counts: dict[str, int] = {}
    try:
        with open(f) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                s = json.loads(line)
                kind = s.get("type")
                if kind == "event":
                    n = s.get("name", "?")
                    event_counts[n] = event_counts.get(n, 0) + 1
                    continue
                labels = ",".join(
                    f"{k}={v}" for k, v in sorted(
                        (s.get("labels") or {}).items()))
                if kind == "histogram":
                    cnt = s.get("count") or 0
                    mean = (s.get("sum") or 0) / cnt if cnt else 0
                    val = f"n={cnt} mean={mean:.4g}s"
                    # Buckets/quantiles, not just counts: the stored
                    # sample carries per-bucket counts — render the
                    # interpolated p50/p99 next to the mean (the
                    # decision-latency family is useless without them).
                    b = s.get("buckets") or {}
                    # metrics.jsonl is written sort_keys=True, which
                    # orders bucket keys LEXICALLY ("+Inf" first,
                    # "10.0" before "2.5") — re-sort numerically with
                    # +Inf last or bounds/counts feed bucket_quantile
                    # misaligned.
                    pairs = sorted(
                        ((float("inf") if k == "+Inf" else float(k), c)
                         for k, c in b.items()))
                    bounds = [k for k, _c in pairs if k != float("inf")]
                    if bounds and cnt:
                        from .telemetry.registry import bucket_quantile

                        counts = [c for _k, c in pairs]
                        p50 = bucket_quantile(bounds, counts, 0.5)
                        p99 = bucket_quantile(bounds, counts, 0.99)
                        val += (f" p50={p50:.4g}s p99={p99:.4g}s"
                                if p50 is not None and p99 is not None
                                else "")
                else:
                    v = s.get("value")
                    val = str(int(v)) if isinstance(v, (int, float)) \
                        and float(v).is_integer() else f"{v:.6g}"
                rows.append((s.get("name", "?"), labels, val))
    except Exception:
        return [("(unparseable metrics.jsonl)", "", "")]
    for n, c in sorted(event_counts.items()):
        rows.append((n, "(events)", str(c)))
    return rows[:limit]


def _metrics_page(root: Path) -> str:
    sections = []
    tests = store.tests(root=root)
    for name in sorted(tests):
        for start in sorted(tests[name], reverse=True):
            run = tests[name][start]
            rows = _metrics_summary(run)
            if not rows:
                continue
            body = "".join(
                f"<tr><td>{html.escape(m)}</td><td>{html.escape(l)}</td>"
                f"<td>{html.escape(v)}</td></tr>"
                for m, l, v in rows
            )
            links = " · ".join(
                f'<a href="/files/{name}/{start}/{fn}">{fn}</a>'
                for fn in _TELEMETRY_FILES if (run / fn).exists()
            )
            sections.append(
                f'<h2><a href="/files/{name}/{start}/">'
                f"{html.escape(name)} / {html.escape(start)}</a></h2>"
                f"<p>{links}</p><table>"
                "<tr><th>Metric</th><th>Labels</th><th>Value</th></tr>"
                + body + "</table>"
            )
    if not sections:
        sections.append(
            "<p>No runs with telemetry yet — run a test with "
            "<code>--telemetry</code>.</p>")
    return (
        f"<html><head><title>Jepsen metrics</title>"
        f"<style>{_STYLE}</style></head>"
        '<body><h1>Run metrics</h1><p><a href="/">index</a></p>'
        + "".join(sections) + "</body></html>"
    )


def _profile_rows(run_dir: Path) -> Optional[dict]:
    f = run_dir / "profile.json"
    if not f.exists():
        return None
    try:
        return json.loads(f.read_text())
    except Exception:
        return {"error": "unparseable profile.json"}


def _profile_section(doc: dict) -> str:
    """Render one run's profile.json: the device attribution's rung
    table + summary, batch occupancy, sharded interconnect share, and
    memory watermarks."""
    if doc.get("error"):
        return f"<p>{html.escape(doc['error'])}</p>"
    attr = doc.get("attribution") or {}
    parts = []
    dev = attr.get("device")
    if dev:
        s = dev.get("summary") or {}
        head = " · ".join(
            f"{k}: {v}" for k, v in sorted(s.items())
            if not isinstance(v, dict))
        bw = s.get("bound_wall_s") or {}
        if bw:
            head += " · wall by bound: " + ", ".join(
                f"{k}={v}s" for k, v in sorted(bw.items()))
        rows = "".join(
            "<tr>" + "".join(
                f"<td>{html.escape(str(r.get(k, '—')))}</td>"
                for k in ("F", "chunks", "levels", "wall_s",
                          "occupancy_mean", "achieved_gbs", "bound"))
            + "</tr>"
            for r in dev.get("rungs") or [])
        parts.append(
            f"<h3>Device search (roofline)</h3><p>{html.escape(head)}</p>"
            "<table><tr><th>F</th><th>chunks</th><th>levels</th>"
            "<th>wall s</th><th>occupancy</th><th>GB/s</th>"
            "<th>bound</th></tr>" + rows + "</table>")
    batch = attr.get("batch")
    if batch:
        rows = "".join(
            "<tr>" + "".join(
                f"<td>{html.escape(str(r.get(k, '—')))}</td>"
                for k in ("F", "members", "calls", "wall_s", "decided",
                          "overflowed", "occupancy_mean",
                          "occupancy_final"))
            + "</tr>"
            for r in batch.get("rungs") or [])
        parts.append(
            "<h3>Batched escalation (why members escalated)</h3>"
            "<table><tr><th>F</th><th>members</th><th>calls</th>"
            "<th>wall s</th><th>decided</th><th>overflowed</th>"
            "<th>occ mean</th><th>occ final</th></tr>"
            + rows + "</table>")
    sharded = attr.get("sharded")
    if sharded:
        ic = sharded.get("interconnect") or {}
        mode = sharded.get("exchange")
        head = f" ({html.escape(str(mode))} exchange)" if mode else ""
        parts.append(
            f"<h3>Frontier-sharded interconnect{head}</h3><p>"
            + html.escape(" · ".join(
                f"{k}: {v}" for k, v in sorted(ic.items())))
            + "</p>")
    marks = doc.get("memory_watermarks") or []
    if marks:
        rows = "".join(
            f"<tr><td>{html.escape(str(m.get('device')))}</td>"
            f"<td>{m.get('bytes_in_use', '—')}</td>"
            f"<td>{m.get('peak_bytes_in_use', '—')}</td></tr>"
            for m in marks)
        parts.append(
            "<h3>Device memory watermarks</h3>"
            "<table><tr><th>device</th><th>bytes in use</th>"
            "<th>peak bytes</th></tr>" + rows + "</table>")
    return "".join(parts) or "<p>(empty profile)</p>"


def _profile_page(root: Path) -> str:
    sections = []
    tests = store.tests(root=root)
    for name in sorted(tests):
        for start in sorted(tests[name], reverse=True):
            run = tests[name][start]
            doc = _profile_rows(run)
            if doc is None:
                continue
            links = " · ".join(
                f'<a href="/files/{name}/{start}/{fn}">{fn}</a>'
                for fn in ("profile.json", "flightrecord.json",
                           "metrics.jsonl") if (run / fn).exists())
            sections.append(
                f'<h2><a href="/files/{name}/{start}/">'
                f"{html.escape(name)} / {html.escape(start)}</a></h2>"
                f"<p>{links}</p>" + _profile_section(doc))
    if not sections:
        sections.append(
            "<p>No runs with profiles yet — run a test with "
            "<code>--profile</code>.</p>")
    return (
        f"<html><head><title>Jepsen profiles</title>"
        f"<style>{_STYLE}</style></head>"
        '<body><h1>Performance attribution</h1>'
        '<p><a href="/">index</a> · <a href="/metrics">metrics</a></p>'
        + "".join(sections) + "</body></html>"
    )


def _utilization_section(util: dict) -> str:
    """One run's utilization block (profile.json): the SVG occupancy
    Gantt (telemetry.utilization.render_gantt — gap-class colored) plus
    the per-device summary table."""
    from .telemetry import utilization as _util

    s = util.get("summary") or {}
    head = (
        f"<p>devices: {s.get('n_devices')} · mean utilization "
        f"{s.get('mean_utilization_pct')}% · makespan "
        f"{s.get('makespan_s')}s · critical path "
        f"{s.get('critical_path_pct')}%</p>")
    shares = s.get("gap_attribution_share") or {}
    if shares:
        head += ("<p>idle attribution: " + html.escape(", ".join(
            f"{k}={round(v * 100, 1)}%"
            for k, v in sorted(shares.items()))) + "</p>")
    rows = "".join(
        f"<tr><td>{d.get('device')}</td><td>{d.get('chunks')}</td>"
        f"<td>{d.get('busy_s')}</td><td>{d.get('utilization_pct')}</td>"
        f"<td>{html.escape(', '.join(f'{k}={v}' for k, v in sorted((d.get('gap_s') or {}).items())) or '—')}</td></tr>"
        for d in util.get("devices") or [])
    table = (
        "<table><tr><th>device</th><th>chunks</th><th>busy s</th>"
        "<th>util %</th><th>idle s by class</th></tr>" + rows
        + "</table>")
    try:
        gantt = _util.render_gantt(util)
    except Exception:  # noqa: BLE001 - a malformed block still lists
        gantt = ""
    return head + gantt + table


def _utilization_page(root: Path) -> str:
    sections = []
    tests = store.tests(root=root)
    for name in sorted(tests):
        for start in sorted(tests[name], reverse=True):
            run = tests[name][start]
            doc = _profile_rows(run)
            if doc is None:
                continue
            util = (doc.get("attribution") or {}).get("utilization")
            if not util:
                continue
            sections.append(
                f'<h2><a href="/files/{name}/{start}/">'
                f"{html.escape(name)} / {html.escape(start)}</a></h2>"
                + _utilization_section(util))
    if not sections:
        sections.append(
            "<p>No runs with utilization timelines yet — run a test "
            "with <code>--profile</code> (utilization is reconstructed "
            "from the timed chunk events and stored in "
            "profile.json).</p>")
    return (
        f"<html><head><title>Jepsen utilization</title>"
        f"<style>{_STYLE}</style></head>"
        "<body><h1>Device saturation</h1>"
        '<p><a href="/">index</a> · <a href="/profile">profile</a> · '
        '<a href="/runs">runs</a></p>'
        + "".join(sections) + "</body></html>"
    )


def _runs_page(root: Path) -> str:
    """The cross-run perf ledger's trend (store/ledger.jsonl), grouped
    by comparable (kind, workload, engine) with the newest-vs-previous
    deltas — regressions highlighted."""
    from .telemetry import ledger as _ledger

    # default_path honors the JEPSEN_LEDGER_PATH override, matching
    # every writer — a CI pointing writers elsewhere must see the same
    # file rendered here.
    records = _ledger.load(_ledger.default_path(root))
    sections = []
    for block in _ledger.trend(records):
        k = block["key"]
        cols = block["columns"]
        names = [n for n, _k, _d in _ledger.LEDGER_METRICS
                 if any(n in c["metrics"] for c in cols)]
        head_cells = "".join(f"<th>{html.escape(c['label'])}</th>"
                             for c in cols)
        body = ""
        regressed = set(block.get("regressions") or ())
        for n in names:
            cells = "".join(
                f"<td>{c['metrics'].get(n, '—')}</td>" for c in cols)
            cls = ' class="valid-false"' if n in regressed else ""
            body += f"<tr{cls}><td>{html.escape(n)}</td>{cells}</tr>"
        verd = "".join(f"<td>{html.escape(v)}</td>"
                       for v in block["verdicts"])
        body += f"<tr><td>verdict</td>{verd}</tr>"
        sections.append(
            f"<h2>{html.escape(k['kind'])} · {html.escape(k['workload'])}"
            f" <small>[engine={html.escape(k['engine'])}, "
            f"{block['records']} records]</small></h2>"
            f"<table><tr><th>metric</th>{head_cells}</tr>{body}</table>"
            + (("<p class=\"valid-false\">regressions vs previous: "
                + html.escape(", ".join(sorted(regressed))) + "</p>")
               if regressed else ""))
    if not sections:
        sections.append(
            "<p>No ledger yet — every run and bench leg appends one "
            "record to <code>store/ledger.jsonl</code>; gate with "
            "<code>python -m jepsen_tpu_torch.ledger --check</code>.</p>")
    return (
        f"<html><head><title>Jepsen run ledger</title>"
        f"<style>{_STYLE}</style></head>"
        "<body><h1>Cross-run perf ledger</h1>"
        '<p><a href="/">index</a> · '
        '<a href="/utilization">utilization</a></p>'
        + "".join(sections) + "</body></html>"
    )


def _run_cause_counts(run_dir: Path) -> dict[str, dict[str, int]]:
    """Per-tenant ``{code: count}`` maps for one run, joined from the
    ``verdict_causes_total{code,tenant}`` samples in metrics.jsonl and
    the ``provenance`` block in online.json (tenant ``""`` = the run's
    own stream). Either source alone suffices — a run with only one of
    the two artifacts still renders."""
    out: dict[str, dict[str, int]] = {}
    f = run_dir / "metrics.jsonl"
    if f.exists():
        try:
            with open(f) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    s = json.loads(line)
                    if s.get("name") != "verdict_causes_total":
                        continue
                    labels = s.get("labels") or {}
                    code = labels.get("code")
                    if not code:  # the aggregate unlabeled total
                        continue
                    t = out.setdefault(labels.get("tenant") or "", {})
                    t[code] = t.get(code, 0) + int(s.get("value") or 0)
        except Exception:  # noqa: BLE001 - a bad artifact still lists
            pass
    f = run_dir / "online.json"
    if f.exists() and not out:
        try:
            doc = json.loads(f.read_text())
            causes = (doc.get("provenance") or {}).get("causes") or {}
            if causes:
                out[""] = {k: int(v) for k, v in causes.items()}
        except Exception:  # noqa: BLE001
            pass
    return out


def _verdicts_section(name: str, start: str,
                      tenants: dict[str, dict[str, int]]) -> str:
    """One run's cause Pareto: per-tenant tables with deep links into
    the trace chain (online.json segment table → spans.jsonl ids)."""
    from .checker import provenance as _prov

    parts = []
    links = " · ".join(
        [f'<a href="/files/{name}/{start}/online.json">online.json</a>',
         f'<a href="/files/{name}/{start}/metrics.jsonl">'
         "metrics.jsonl</a>",
         f'<a href="/files/{name}/{start}/spans.jsonl">spans.jsonl</a>',
         '<a href="/online">online</a>',
         '<a href="/utilization">utilization</a>',
         '<a href="/live.html">live</a>'])
    parts.append(f"<p>{links}</p>")
    for tenant in sorted(tenants):
        counts = tenants[tenant]
        label = (f"tenant <b>{html.escape(tenant)}</b>" if tenant
                 else "run stream")
        rows = "".join(
            f"<tr><td><code>{html.escape(r['code'])}</code></td>"
            f"<td>{html.escape(r['layer'])}</td>"
            f"<td>{r['count']}</td>"
            f"<td>{round(r['share'] * 100, 1)}%</td>"
            f"<td>{html.escape(r['description'])}</td></tr>"
            for r in _prov.pareto(counts))
        parts.append(
            f"<h3>{label} — {sum(counts.values())} attributed "
            "cause(s)</h3>"
            "<table><tr><th>cause</th><th>layer</th><th>count</th>"
            "<th>share</th><th>meaning</th></tr>" + rows + "</table>")
    return "".join(parts)


def _verdicts_page(root: Path) -> str:
    """The verdict-provenance browser: per-run / per-tenant cause
    Paretos (why did verdicts degrade to unknown), joined from the
    `verdict_causes_total` metric family and online.json provenance
    blocks, with the closed taxonomy reference at the bottom. See
    docs/verdicts.md."""
    from .checker import provenance as _prov

    sections = []
    tests = store.tests(root=root)
    for name in sorted(tests):
        for start in sorted(tests[name], reverse=True):
            run = tests[name][start]
            tenants = _run_cause_counts(run)
            if not tenants:
                continue
            sections.append(
                f'<h2><a href="/files/{name}/{start}/">'
                f"{html.escape(name)} / {html.escape(start)}</a></h2>"
                + _verdicts_section(name, start, tenants))
    if not sections:
        sections.append(
            "<p>No degraded verdicts recorded — every checked stream "
            "decided definitively (or no telemetry/online artifacts "
            "exist yet). Causes appear here the moment any verdict "
            "degrades to unknown.</p>")
    taxonomy = "".join(
        f"<tr><td><code>{html.escape(code)}</code></td>"
        f"<td>{html.escape(layer)}</td>"
        f"<td>{html.escape(desc)}</td></tr>"
        for code, (layer, desc) in sorted(_prov.TAXONOMY.items()))
    return (
        f"<html><head><title>Jepsen verdicts</title>"
        f"<style>{_STYLE}</style></head>"
        "<body><h1>Verdict provenance</h1>"
        '<p><a href="/">index</a> · <a href="/online">online</a> · '
        '<a href="/metrics">metrics</a> · '
        '<a href="/live.html">live</a> · advisor: '
        "<code>python -m jepsen_tpu_torch.advisor</code></p>"
        + "".join(sections)
        + "<h2>Cause taxonomy (closed)</h2>"
        "<table><tr><th>code</th><th>layer</th><th>meaning</th></tr>"
        + taxonomy + "</table></body></html>"
    )


def _online_section(doc: dict) -> str:
    """Render one run's online.json: live watermark + verdict headline,
    detection info when a violation aborted the run, and the decided
    segment table."""
    v = doc.get("valid")
    vs = {True: "valid", False: "INVALID",
          "unknown": "unknown"}.get(v, str(v))
    cls = {True: "valid-true", False: "valid-false",
           "unknown": "valid-unknown"}.get(v, "")
    head = (
        f'<p class="{cls}">online verdict: <b>{html.escape(vs)}</b> · '
        f"decided through index {doc.get('decided_through_index')} of "
        f"{doc.get('ops_observed')} ops · "
        f"{doc.get('segments_decided')} segments"
        + (" · <b>run aborted on violation</b>" if doc.get("aborted")
           else "") + "</p>")
    if doc.get("ops_to_detection") is not None:
        head += (
            f"<p>detection: {doc['ops_to_detection']} ops / "
            f"{doc.get('seconds_to_detection')} s to the first invalid "
            "segment</p>")
    rows = "".join(
        "<tr>" + "".join(
            f"<td>{html.escape(str(s.get(k, '—')))}</td>"
            for k in ("seq", "key", "ops", "start_index", "end_index",
                      "valid", "engine", "members", "wall_s",
                      "terminal"))
        + "</tr>"
        for s in (doc.get("segments") or [])[:200])
    table = (
        "<table><tr><th>seq</th><th>key</th><th>ops</th><th>start</th>"
        "<th>end</th><th>valid</th><th>engine</th><th>members</th>"
        "<th>wall s</th><th>terminal</th></tr>" + rows + "</table>"
        if rows else "<p>(no segments decided)</p>")
    return head + table


def _offline_section(doc: dict) -> str:
    """Render an offline (segment-planner) result — the JSON
    ``python -m jepsen_tpu_torch.offline -o .../offline.json`` writes (see
    docs/offline.md): verdict, plan shape, and per-stream decide
    attribution."""
    v = doc.get("valid")
    vs = {True: "valid", False: "INVALID",
          "unknown": "unknown"}.get(v, str(v))
    cls = {True: "valid-true", False: "valid-false",
           "unknown": "valid-unknown"}.get(v, "")
    plan = doc.get("plan") or {}
    util = (doc.get("utilization") or {}).get("mean_utilization_pct")
    busy = util if util is not None else doc.get("busy_pct")
    head = (
        f'<p class="{cls}">offline verdict: <b>{html.escape(vs)}</b> · '
        f"{doc.get('n_ops')} ops · engine {doc.get('engine')} · "
        f"{plan.get('n_items', '—')} items / "
        f"{plan.get('n_streams', '—')} streams · "
        f"plan {plan.get('plan_seconds', '—')} s · "
        f"wall {doc.get('wall_s', '—')} s"
        + (f" · busy {busy}%" if busy is not None else "") + "</p>")
    rows = "".join(
        "<tr>" + "".join(
            f"<td>{html.escape(str((row or {}).get(k, '—')))}</td>"
            for k in ("valid", "segments_decided", "decide_s"))
        + f"<td>{html.escape(name)}</td></tr>"
        for name, row in sorted((doc.get("streams") or {}).items()))
    table = (
        "<table><tr><th>valid</th><th>segments</th><th>decide s</th>"
        "<th>stream</th></tr>" + rows + "</table>" if rows else "")
    return head + table


def _online_page(root: Path) -> str:
    sections = []
    tests = store.tests(root=root)
    for name in sorted(tests):
        for start in sorted(tests[name], reverse=True):
            run = tests[name][start]
            f = run / "online.json"
            off = run / "offline.json"
            if not f.exists() and not off.exists():
                continue
            part = (
                f'<h2><a href="/files/{name}/{start}/">'
                f"{html.escape(name)} / {html.escape(start)}</a></h2>")
            if f.exists():
                try:
                    doc = json.loads(f.read_text())
                except Exception:
                    doc = None
                part += (
                    f'<p><a href="/files/{name}/{start}/online.json">'
                    "online.json</a></p>"
                    + (_online_section(doc) if doc is not None
                       else "<p>(unparseable online.json)</p>"))
            if off.exists():
                try:
                    odoc = json.loads(off.read_text())
                except Exception:
                    odoc = None
                part += (
                    f'<p><a href="/files/{name}/{start}/offline.json">'
                    "offline.json</a></p>"
                    + (_offline_section(odoc) if odoc is not None
                       else "<p>(unparseable offline.json)</p>"))
            sections.append(part)
    if not sections:
        sections.append(
            "<p>No runs with online monitoring yet — run a test with "
            "<code>--online</code>, or decide a recording with "
            "<code>python -m jepsen_tpu_torch.offline ... -o "
            "store/&lt;test&gt;/&lt;start&gt;/offline.json</code>.</p>")
    return (
        f"<html><head><title>Jepsen online monitor</title>"
        f"<style>{_STYLE}</style></head>"
        "<body><h1>Online linearizability monitor</h1>"
        '<p><a href="/">index</a> · <a href="/metrics">metrics</a> · '
        '<a href="/profile">profile</a></p>'
        + "".join(sections) + "</body></html>"
    )


_LIVE_HTML = """<html><head><title>Jepsen live</title>
<style>%s
#none { color: #888; } .stall { background: #f7c5c5; }
pre { background: #f6f6f6; padding: 0.6em; }</style></head>
<body><h1>Live runs</h1>
<p><a href="/">index</a> · <a href="/metrics">metrics</a> ·
<a href="/online">online</a> · <a href="/verdicts">verdicts</a> ·
<a href="/fleet">fleet</a> · <a href="/alerts">alerts</a> ·
raw feed: <a href="/live">/live</a>
(ndjson poll)</p>
<div id="runs"><p id="none">polling /live…</p></div>
<script>
async function tick() {
  try {
    const txt = await (await fetch('/live')).text();
    const runs = txt.trim().split('\\n').map(JSON.parse);
    const box = document.getElementById('runs');
    if (runs.length === 1 && runs[0].live_runs === 0) {
      box.innerHTML = '<p id="none">no live runs — start one with ' +
                      '--online --live-port</p>';
    } else {
      box.innerHTML = runs.map(r => {
        const lat = r.decision_latency || {};
        const stall = (r.watermark_stall_seconds || 0) > 0;
        let head;
        let tenantTable = '';
        if (r.tenants) {
          // A multi-tenant service line: per-tenant depth/watermark
          // rows instead of the single-run monitor fields. A ROUTER
          // line (r.router) is service-shaped but spans backends, so
          // it adds a backend-state strip and may have no aggregate
          // latency histogram of its own.
          const p50 = lat.p50_s === undefined ? '-' : lat.p50_s;
          const p99 = lat.p99_s === undefined ? '-' : lat.p99_s;
          head = '<p>' + (r.draining ? 'DRAINING · ' : '') +
            (r.router ? 'ROUTER · ' : '') +
            (r.router && r.epoch !== undefined
              ? 'epoch ' + r.epoch + ' · ' : '') +
            r.tenant_count + ' tenants' +
            ' · ' + r.ops_observed + ' ops observed' +
            ' · backlog ' + r.scheduler_backlog +
            ' · p50/p99 decide ' + p50 + '/' + p99 + 's' +
            // Firing alerts ride the service's own /live line (the
            // alerting plane's rule names), red-badged inline.
            ((r.alerts && r.alerts.length)
              ? ' · alerts: ' + r.alerts.map(a =>
                  '<span class="stall">' + a + '</span>').join(' ')
              : '') +
            '</p>';
          if (r.backends) {
            head += '<p>backends: ' +
              Object.entries(r.backends).map(([n, b]) => {
                b = b || {};
                // respawn_gave_up is the terminal supervision state
                // (the flap circuit tripped); a respawn count next to
                // a live backend means the supervisor healed it.
                const bad = b.down || b.state === 'lost' ||
                  b.state === 'open' || b.respawn_gave_up;
                // Each backend row links to ITS OWN /live view; the
                // scrape cell mirrors the missing-latency guard — a
                // federated backend with no successful scrape renders
                // a typed "no scrape" marker, never a blank that
                // reads as healthy.
                const label = b.url
                  ? '<a href="' + b.url + '/live">' + n + '</a>' : n;
                let scrape = '';
                if (b.scrapes !== undefined) {
                  scrape = (b.scrape_age_s === undefined ||
                            b.scrape_age_s === null)
                    ? ' · <span class="stall">no scrape</span>'
                    : ' · scraped ' + b.scrape_age_s + 's ago' +
                      (b.scrape_stale
                        ? ' <span class="stall">STALE</span>' : '');
                }
                return (bad ? '<span class="stall">' : '') + label +
                  ' [' + (b.state || '?') + ']' +
                  (b.respawns ? ' ⟳' + b.respawns : '') + scrape +
                  (bad ? '</span>' : '');
              }).join(' · ') + '</p>';
          }
          tenantTable = '<table><tr><th>tenant</th><th>verdict</th>' +
            '<th>watermark</th><th>ops</th><th>queue</th>' +
            '<th>backlog</th><th>undecided</th><th>p99 s</th>' +
            '<th></th></tr>' +
            Object.entries(r.tenants).map(([name, t]) => {
              t = t || {};
              const tl = t.decision_latency || {};
              // Red row: a refuted stream OR a degraded one (lost
              // segments / unknown folds / journal append failures —
              // definite-True coverage is already compromised).
              const cls = (t.verdict === 'False' || t.degraded)
                ? ' class="stall"' : '';
              const flags = [
                t.aborted ? 'ABORTED' : '',
                // Why-unknown at a glance: the dominant taxonomy code
                // rides next to the DEGRADED flag (docs/verdicts.md).
                t.degraded ? ('DEGRADED' +
                  (t.dominant_unknown_cause
                    ? ' [' + t.dominant_unknown_cause + ']' : '')) : '',
                t.resumed_from_journal ? 'resumed' : '',
              ].filter(Boolean).join(' ');
              return '<tr' + cls + '><td>' + name + '</td>' +
                '<td>' + t.verdict + '</td>' +
                '<td>' + t.watermark + '</td>' +
                '<td>' + t.ops_observed + '</td>' +
                '<td>' + t.queue_depth + '</td>' +
                '<td>' + t.backlog + '</td>' +
                '<td>' + t.undecided_ops + '</td>' +
                '<td>' + tl.p99_s + '</td>' +
                '<td>' + flags + '</td></tr>';
            }).join('') + '</table>';
        } else {
          head = '<p' + (stall ? ' class="stall"' : '') + '>' +
            'verdict ' + r.verdict +
            ' · watermark ' + r.decided_through_index +
            ' / ' + r.ops_observed + ' ops' +
            ' · backlog ' + r.scheduler_backlog +
            ' · open ' + r.open_segment_ops + ' ops' +
            (stall ? ' · STALLED ' + r.watermark_stall_seconds + 's'
                   : '') +
            ' · p50/p99 decide ' + lat.p50_s + '/' + lat.p99_s + 's' +
            '</p>';
        }
        return '<h2>' + (r.run || '?') + '</h2>' + head + tenantTable +
          '<pre>' + JSON.stringify(r, null, 1) + '</pre>';
      }).join('');
    }
  } catch (e) { /* server gone: keep polling */ }
  setTimeout(tick, 1000);
}
tick();
</script></body></html>
"""


def _live_page() -> str:
    return _LIVE_HTML % _STYLE


# ---------------------------------------------------------------------------
# The fleet page: every registered router's fleet_snapshot — backend
# states + scrape freshness, the router_state.jsonl timeline, SLO burn
# rates, and a fleet Gantt (one lane per backend) over the scraped
# busy-span reconstructions.


def _merge_intervals(ivals: list) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted((float(a), float(b)) for a, b in ivals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _fleet_gantt(backends: dict) -> str:
    """One Gantt lane per backend from its scraped utilization block
    (chunk busy-spans when the backend ran device kernels, backlog
    occupancy otherwise), re-offset onto ONE shared wall-clock window
    so cross-backend idle gaps line up; unattributed idle renders as
    ``no-work`` gaps."""
    lanes = []  # (name, pct, abs window t0/t1, merged rel intervals)
    for name in sorted(backends):
        u = (backends[name] or {}).get("utilization") or {}
        w = u.get("window") or {}
        if not isinstance(w.get("t0"), (int, float)) \
                or not isinstance(w.get("t1"), (int, float)):
            continue
        if u.get("source") == "chunks":
            ivals = [iv for dev in (u.get("devices") or [])
                     for iv in (dev.get("intervals") or [])]
        else:
            ivals = list(u.get("intervals") or [])
        lanes.append((name, u.get("utilization_pct"),
                      float(w["t0"]), float(w["t1"]),
                      _merge_intervals(ivals)))
    if not lanes:
        return ""
    w0 = min(ln[2] for ln in lanes)
    w1 = max(ln[3] for ln in lanes)
    if w1 <= w0:
        return ""
    devices = []
    pcts = [ln[1] for ln in lanes if isinstance(ln[1], (int, float))]
    for name, pct, t0, t1, ivals in lanes:
        rel = [[round(a + t0 - w0, 6), round(b + t0 - w0, 6)]
               for a, b in ivals]
        gaps = []
        cursor = round(t0 - w0, 6)
        for a, b in rel + [[round(t1 - w0, 6), round(t1 - w0, 6)]]:
            if a - cursor > 1e-6:
                gaps.append({"t0_s": cursor, "t1_s": a,
                             "wall_s": round(a - cursor, 4),
                             "class": "no-work"})
            cursor = max(cursor, b)
        devices.append({"device": name, "utilization_pct": pct,
                        "intervals": rel, "gaps": gaps})
    util = {
        "window": {"t0": round(w0, 6), "t1": round(w1, 6),
                   "makespan_s": round(w1 - w0, 6)},
        "summary": {"mean_utilization_pct":
                    (round(sum(pcts) / len(pcts), 2)
                     if pcts else None)},
        "devices": devices,
    }
    from .telemetry import utilization as _util

    return _util.render_gantt(util)


def _fleet_section(snap: dict) -> str:
    name = html.escape(str(snap.get("router") or "?"))
    if snap.get("error"):
        return (f"<h2>{name}</h2><p class=\"stall\">"
                f"{html.escape(str(snap['error']))}</p>")
    bits = [f"epoch {snap.get('epoch')}"]
    if snap.get("draining"):
        bits.append("DRAINING")
    bits.append(f"{len(snap.get('backends') or {})} backends")
    orphans = snap.get("orphaned") or []
    if orphans:
        bits.append('<span class="stall">'
                    f"{len(orphans)} orphaned</span>")
    lat = snap.get("decision_latency") or {}
    if isinstance(lat.get("p99_s"), (int, float)):
        bits.append(f"fleet p50/p99 decide {lat.get('p50_s')}/"
                    f"{lat.get('p99_s')}s")
    parts = [f"<h2>{name}</h2><p>{' · '.join(bits)}</p>"]
    slo = snap.get("slo") or {}
    windows = slo.get("windows") or {}
    if windows:
        rows = "".join(
            f"<tr><td>{html.escape(k)}</td>"
            f"<td>{w.get('window_s')}</td>"
            f"<td>{w.get('availability_burn_rate')}</td>"
            f"<td>{w.get('latency_burn_rate')}</td>"
            f"<td>{w.get('decided')}</td>"
            f"<td>{w.get('rejected')}</td></tr>"
            for k, w in sorted(windows.items()))
        parts.append(
            "<h3>SLO burn rates</h3>"
            f"<p>availability target {slo.get('availability_target')}"
            f" · latency target {slo.get('latency_target_s')}s @ "
            f"p{slo.get('latency_ratio')}</p>"
            "<table><tr><th>window</th><th>s</th>"
            "<th>availability burn</th><th>latency burn</th>"
            "<th>decided</th><th>rejected</th></tr>"
            + rows + "</table>")
    alerts = snap.get("alerts") or {}
    firing = sorted(alerts.get("firing") or [])
    if firing:
        parts.append(
            "<h3>Alerts firing</h3><p>"
            + " ".join(f'<span class="stall">{html.escape(r)}</span>'
                       for r in firing)
            + ' · <a href="/alerts">details</a></p>')
    backends = snap.get("backends") or {}
    stale = set(snap.get("stale_backends") or [])
    brows = []
    for n in sorted(backends):
        b = backends[n] or {}
        bad = (b.get("down") or b.get("state") in ("lost", "open")
               or b.get("respawn_gave_up"))
        age = b.get("scrape_age_s")
        # The missing-scrape guard (the missing-latency guard's shape):
        # a backend with no successful scrape renders a typed
        # placeholder, never a blank cell that reads as healthy.
        if age is None:
            scrape = '<span class="stall">no scrape</span>'
        else:
            scrape = f"{age}s ago"
            if b.get("scrape_stale") or n in stale:
                scrape += ' <span class="stall">STALE</span>'
        u = b.get("utilization") or {}
        pct = u.get("utilization_pct")
        util = "—" if pct is None else \
            f"{pct}% ({html.escape(str(u.get('source')))})"
        url = str(b.get("url") or "")
        link = (f'<a href="{html.escape(url)}/live">'
                f"{html.escape(n)}</a>" if url else html.escape(n))
        cls = ' class="stall"' if bad else ""
        brows.append(
            f"<tr{cls}><td>{link}</td>"
            f"<td>{html.escape(str(b.get('state') or '?'))}</td>"
            f"<td>{scrape}</td><td>{b.get('scrapes', 0)}</td>"
            f"<td>{util}</td>"
            f"<td>{len(b.get('tenants') or [])}</td></tr>")
    parts.append(
        "<h3>Backends</h3><table><tr><th>backend</th><th>state</th>"
        "<th>last scrape</th><th>scrapes</th><th>utilization</th>"
        "<th>tenants</th></tr>" + "".join(brows) + "</table>")
    gantt = _fleet_gantt(backends)
    if gantt:
        parts.append("<h3>Fleet timeline (busy spans)</h3>" + gantt)
    timeline = snap.get("timeline") or []
    if timeline:
        trows = []
        for rec in timeline[-40:]:
            detail = ", ".join(
                f"{k}={v}" for k, v in sorted(rec.items())
                if k not in ("kind", "t"))
            # Alert transitions ride the same timeline as placement /
            # respawn events so an operator can read them joined; a
            # firing row gets the stall tint.
            cls = ' class="stall"' if (rec.get("kind") == "alert"
                                       and rec.get("state") == "firing"
                                       ) else ""
            trows.append(
                f"<tr{cls}>"
                f"<td>{html.escape(str(rec.get('t', '—')))}</td>"
                f"<td>{html.escape(str(rec.get('kind')))}</td>"
                f"<td>{html.escape(detail)}</td></tr>")
        parts.append(
            "<h3>Router events &amp; alerts "
            "(router_state.jsonl + alerts.jsonl)</h3>"
            "<table><tr><th>t</th><th>kind</th><th>detail</th></tr>"
            + "".join(trows) + "</table>")
    return "".join(parts)


def _fleet_page() -> str:
    snaps = fleet_snapshots()
    if snaps:
        body = "".join(_fleet_section(s) for s in snaps)
    else:
        body = ("<p>No fleet sources — start a router with a metrics "
                "registry (<code>RouterConfig.federate</code>, the "
                "default) and <code>register_live=True</code>.</p>")
    return (
        "<html><head><title>Jepsen fleet</title>"
        '<meta http-equiv="refresh" content="2">'
        f"<style>{_STYLE}\n.stall {{ background: #f7c5c5; }}</style>"
        "</head><body><h1>Fleet</h1>"
        '<p><a href="/">index</a> · <a href="/live.html">live</a> · '
        '<a href="/metrics">metrics</a> · '
        'raw: <a href="/fleet.json">/fleet.json</a></p>'
        + body + "</body></html>")


def alert_snapshots() -> list[dict]:
    """One row per registered source that carries an alerting plane:
    routers contribute their fleet snapshot's ``alerts`` block (firing
    set + recent transitions), services contribute the firing-rule list
    their ``/live`` line carries. Sources without alerts are skipped —
    an empty store answers with an empty list, never an error."""
    out = []
    for snap in fleet_snapshots():
        al = snap.get("alerts")
        if isinstance(al, dict):
            out.append({
                "source": str(snap.get("router") or "?"),
                "kind": "router",
                "firing": sorted(al.get("firing") or []),
                "recent": list(al.get("recent") or []),
            })
    for line in live_snapshots():
        if line.get("router"):
            continue  # already covered via its fleet source
        al = line.get("alerts")
        if isinstance(al, list):
            out.append({
                "source": str(line.get("run") or "?"),
                "kind": "service",
                "firing": sorted(al),
                "recent": [],
            })
    return out


def _alerts_page() -> str:
    rows = alert_snapshots()
    parts = []
    for row in rows:
        name = html.escape(f"{row['source']} ({row['kind']})")
        firing = row["firing"]
        if firing:
            badge = " ".join(
                f'<span class="stall">{html.escape(r)}</span>'
                for r in firing)
            parts.append(f"<h2>{name}</h2><p>firing: {badge}</p>")
        else:
            parts.append(f"<h2>{name}</h2><p>no alerts firing</p>")
        recent = row["recent"]
        if recent:
            trows = []
            for rec in recent[-40:]:
                cls = ' class="stall"' \
                    if rec.get("state") == "firing" else ""
                trows.append(
                    f"<tr{cls}>"
                    f"<td>{html.escape(str(rec.get('t', '—')))}</td>"
                    f"<td>{html.escape(str(rec.get('rule')))}</td>"
                    f"<td>{html.escape(str(rec.get('state')))}</td>"
                    f"<td>{html.escape(str(rec.get('severity')))}</td>"
                    f"<td>{rec.get('generation')}</td></tr>")
            parts.append(
                "<table><tr><th>t</th><th>rule</th><th>state</th>"
                "<th>severity</th><th>gen</th></tr>"
                + "".join(trows) + "</table>")
    if not parts:
        parts.append(
            "<p>No alert sources — start a service or router with "
            "<code>--alerts</code> (or <code>alerts=True</code>) and "
            "<code>register_live=True</code>.</p>")
    return (
        "<html><head><title>Jepsen alerts</title>"
        '<meta http-equiv="refresh" content="2">'
        f"<style>{_STYLE}\n.stall {{ background: #f7c5c5; }}</style>"
        "</head><body><h1>Alerts</h1>"
        '<p><a href="/">index</a> · <a href="/fleet">fleet</a> · '
        '<a href="/live.html">live</a> · '
        'raw: <a href="/alerts.json">/alerts.json</a></p>'
        + "".join(parts) + "</body></html>")


def _listing_page(rel: str, d: Path) -> str:
    items = "".join(
        f'<li><a href="/files/{rel}{f.name}{"/" if f.is_dir() else ""}">'
        f"{html.escape(f.name)}</a></li>"
        for f in sorted(d.iterdir())
    )
    return (
        f"<html><head><style>{_STYLE}</style></head><body>"
        f"<h1>{html.escape(rel)}</h1><ul>{items}</ul></body></html>"
    )


def make_handler(root: Path):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            LOG.debug(fmt, *args)

        def _send(self, code: int, body: bytes,
                  ctype: str = "text/html; charset=utf-8"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = unquote(self.path)
            try:
                if path in ("/", "/index.html"):
                    self._send(200, _index_page(root).encode())
                    return
                if path in ("/metrics", "/metrics/"):
                    self._send(200, _metrics_page(root).encode())
                    return
                if path in ("/profile", "/profile/"):
                    self._send(200, _profile_page(root).encode())
                    return
                if path in ("/online", "/online/"):
                    self._send(200, _online_page(root).encode())
                    return
                if path in ("/verdicts", "/verdicts/"):
                    self._send(200, _verdicts_page(root).encode())
                    return
                if path in ("/utilization", "/utilization/"):
                    self._send(200, _utilization_page(root).encode())
                    return
                if path in ("/runs", "/runs/"):
                    self._send(200, _runs_page(root).encode())
                    return
                if path in ("/live", "/live/"):
                    self._send(200, live_ndjson().encode(),
                               "application/x-ndjson; charset=utf-8")
                    return
                if path == "/live.html":
                    self._send(200, _live_page().encode())
                    return
                if path in ("/fleet", "/fleet/"):
                    self._send(200, _fleet_page().encode())
                    return
                if path in ("/alerts", "/alerts/"):
                    self._send(200, _alerts_page().encode())
                    return
                if path == "/alerts.json":
                    self._send(
                        200,
                        json.dumps(alert_snapshots(), sort_keys=True,
                                   default=str).encode(),
                        "application/json")
                    return
                if path == "/fleet.json":
                    self._send(
                        200,
                        json.dumps(fleet_snapshots(), sort_keys=True,
                                   default=str).encode(),
                        "application/json")
                    return
                if path.startswith("/zip/"):
                    rel = path[len("/zip/"):].strip("/")
                    d = (root / rel).resolve()
                    if root.resolve() not in d.parents or not d.is_dir():
                        self._send(404, b"not found")
                        return
                    buf = io.BytesIO()
                    with zipfile.ZipFile(buf, "w") as z:
                        for f in d.rglob("*"):
                            if f.is_file():
                                z.write(f, f.relative_to(d.parent))
                    self._send(200, buf.getvalue(), "application/zip")
                    return
                if path.startswith("/files/"):
                    rel = path[len("/files/"):]
                    f = (root / rel.strip("/")).resolve()
                    if root.resolve() not in f.parents and f != root.resolve():
                        self._send(404, b"not found")
                        return
                    if f.is_dir():
                        self._send(
                            200,
                            _listing_page(
                                rel if rel.endswith("/") else rel + "/", f
                            ).encode(),
                        )
                        return
                    if f.is_file():
                        ctype = (
                            "text/html" if f.suffix == ".html"
                            else "image/png" if f.suffix == ".png"
                            else "image/svg+xml" if f.suffix == ".svg"
                            else "text/plain; charset=utf-8"
                        )
                        self._send(200, f.read_bytes(), ctype)
                        return
                self._send(404, b"not found")
            except Exception:
                LOG.warning("error serving %s", path, exc_info=True)
                self._send(500, b"internal error")

    return Handler


def server(root: Optional[Any] = None, port: int = 8080, host: str = ""
           ) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server on ``host:port``: every
    interface by default, as the reference binds; port 0 takes a free
    port (``server_address[1]`` names it)."""
    base = Path(root) if root else Path(store.BASE_DIR)
    return ThreadingHTTPServer((host, port), make_handler(base))


def serve(root: Optional[Any] = None, port: int = 8080) -> None:
    """Serve forever (cli.clj:323-340 seam)."""
    srv = server(root, port)
    LOG.info("Serving store on http://0.0.0.0:%d", port)
    print(f"Serving store on http://0.0.0.0:{port}")
    srv.serve_forever()
