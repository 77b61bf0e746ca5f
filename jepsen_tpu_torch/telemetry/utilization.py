"""Device saturation: per-device busy timelines, idle-gap attribution
and the occupancy Gantt, rebuilt on the host from a run's registry.

The port of the reference's ``jepsen_tpu/telemetry/utilization.py``, with
its semantics, result map and SVG unchanged. It reads the stamped events
the port's drivers already emit:

- ``wgl_chunk`` (the single driver), ``wgl_batch_chunk`` (the batched
  escalation, covering ``n_devices`` devices) and ``wgl_sharded_chunk``
  (the frontier-sharded search, covering ``n_shards`` devices), each with
  wall-clock ``t0``/``t1`` stamps and a ``stage``. The port's ``stage`` is
  ``compile`` for the first chunk after its kernel library was built or
  loaded, ``execute`` otherwise;
- ``wgl_host_stack`` events: the time the batch spends making a rung's
  tables ready for the card. The reference assembles the next bucket's
  tables on the host, sometimes while a chunk runs; the port makes a
  rung's tables once, on the card, while the card waits, and stamps that
  span with ``overlap=False`` (``parallel/batch.py``);
- the ``online_backlog`` timeline (the ``online_scheduler_backlog``
  gauge, stamped at each transition by the online scheduler).

:func:`reconstruct` merges each device's execute-stage chunk intervals
into busy spans, computes ``device_utilization_pct{device}`` (also set as
a labelled gauge on the registry), a makespan and critical-path summary,
and puts every idle gap into exactly one of four classes, in priority
order:

1. **compiling**: a compile-stage chunk on this device overlaps the gap;
2. **host-stacking**: a ``wgl_host_stack`` interval overlaps the gap;
3. **starved**: the scheduler backlog was above 0 during the gap, yet
   nothing ran on this device;
4. **no-work**: the backlog was empty, or no scheduler ran.

The ``/utilization`` page of :mod:`jepsen_tpu_torch.web` renders
:func:`render_gantt`'s SVG. The module is imported only behind a registry
that recorded chunk events (``profile._attribute_utilization`` checks
first), so a run without telemetry never imports it.
"""

from __future__ import annotations

import html as _html
from typing import Iterable, Optional

GAP_CLASSES = ("no-work", "starved", "host-stacking", "compiling")

# Chunk-event families and how many devices each one covers.
CHUNK_EVENTS = ("wgl_chunk", "wgl_batch_chunk", "wgl_sharded_chunk")

_EPS = 1e-9  # overlap/length tolerance for float stamps


def _devices_of(ev: dict) -> int:
    """How many mesh devices one chunk event kept busy: the sharded
    kernel runs on every shard, the batched kernel on the dp mesh, the
    single driver on one device. Events predating the field count 1."""
    name = ev.get("name")
    if name == "wgl_sharded_chunk":
        return max(int(ev.get("n_shards") or 1), 1)
    if name == "wgl_batch_chunk":
        return max(int(ev.get("n_devices") or 1), 1)
    return 1


def _stamped(ev: dict) -> Optional[tuple[float, float]]:
    """(t0, t1) wall-clock interval of a stamped event; None for
    recordings predating the stamps (duration-only events cannot be
    placed on a timeline)."""
    t0, t1 = ev.get("t0"), ev.get("t1")
    if t0 is None or t1 is None:
        return None
    t0, t1 = float(t0), float(t1)
    if t1 < t0:
        t0, t1 = t1, t0
    return (t0, t1)


def _merge(intervals: Iterable[tuple[float, float]]
           ) -> list[tuple[float, float]]:
    """Sorted union of intervals (touching/overlapping spans fuse)."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1] + _EPS:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlaps(intervals: list[tuple[float, float]],
              g0: float, g1: float) -> bool:
    return any(min(b, g1) - max(a, g0) > _EPS for a, b in intervals)


def _gaps(busy: list[tuple[float, float]], w0: float, w1: float
          ) -> list[tuple[float, float]]:
    """Complement of the busy union within the [w0, w1] window."""
    out = []
    cur = w0
    for a, b in busy:
        if a - cur > _EPS:
            out.append((cur, a))
        cur = max(cur, b)
    if w1 - cur > _EPS:
        out.append((cur, w1))
    return out


def _backlog_during(timeline: list[tuple[float, float]],
                    g0: float, g1: float) -> float:
    """Max scheduler backlog over [g0, g1]: the value holding at g0
    (last transition at or before it) plus any transition inside the
    gap. Empty timeline → 0 (no scheduler ran: no work was queued)."""
    if not timeline:
        return 0.0
    best = 0.0
    holding = None
    for t, v in timeline:  # sorted by t
        if t <= g0 + _EPS:
            holding = v
        elif t < g1 - _EPS:
            best = max(best, v)
        else:
            break
    if holding is not None:
        best = max(best, holding)
    return best


def _classify(g0: float, g1: float,
              compiling: list[tuple[float, float]],
              stacking: list[tuple[float, float]],
              backlog: list[tuple[float, float]]) -> str:
    """One class per gap, in priority order (see module docstring)."""
    if _overlaps(compiling, g0, g1):
        return "compiling"
    if _overlaps(stacking, g0, g1):
        return "host-stacking"
    if _backlog_during(backlog, g0, g1) > 0:
        return "starved"
    return "no-work"


def _bound(rows: list, cap: int, elide_key: str, out: dict) -> list:
    """Head+tail bound on a per-device list so profile.json stays
    small; the elided count is recorded, never silently dropped."""
    if len(rows) <= cap:
        return rows
    head = rows[: cap // 2]
    tail = rows[-(cap - len(head)):]
    out[elide_key] = len(rows) - len(head) - len(tail)
    return head + tail


def reconstruct(registry, max_intervals: int = 200,
                max_gaps: int = 200) -> Optional[dict]:
    """Rebuild per-device busy timelines + idle-gap attribution from a
    run's registry. Returns None when no stamped chunk events exist
    (telemetry-off runs never get here; pre-stamp recordings have no
    timeline to rebuild). Also sets the ``device_utilization_pct
    {device}`` gauge per device on the registry."""
    busy: dict[int, list[tuple[float, float]]] = {}
    compiling: dict[int, list[tuple[float, float]]] = {}
    chunks_per_dev: dict[int, int] = {}
    stacking: list[tuple[float, float]] = []
    backlog: list[tuple[float, float]] = []
    w0, w1 = None, None
    for ev in registry.events():
        name = ev.get("name")
        if name == "wgl_host_stack":
            iv = _stamped(ev)
            if iv is not None:
                stacking.append(iv)
            continue
        if name == "online_backlog":
            t = ev.get("t")
            if t is not None:
                backlog.append((float(t), float(ev.get("backlog") or 0)))
            continue
        if name not in CHUNK_EVENTS:
            continue
        iv = _stamped(ev)
        if iv is None:
            continue
        w0 = iv[0] if w0 is None else min(w0, iv[0])
        w1 = iv[1] if w1 is None else max(w1, iv[1])
        target = compiling if ev.get("stage") == "compile" else busy
        for d in range(_devices_of(ev)):
            target.setdefault(d, []).append(iv)
            if target is busy:
                chunks_per_dev[d] = chunks_per_dev.get(d, 0) + 1
    if w0 is None:
        return None
    backlog.sort()
    stacking = _merge(stacking)
    makespan = max(w1 - w0, _EPS)
    n_devices = max(len(busy) or 1, len(compiling) or 1)

    devices = []
    union_any: list[tuple[float, float]] = []
    per_dev_busy: dict[int, list[tuple[float, float]]] = {}
    gap_s: dict[str, float] = {c: 0.0 for c in GAP_CLASSES}
    util_by_dev: dict[str, float] = {}
    for d in range(n_devices):
        merged = _merge(busy.get(d, ()))
        per_dev_busy[d] = merged
        union_any.extend(merged)
        busy_s = sum(b - a for a, b in merged)
        util = round(busy_s / makespan * 100.0, 2)
        util_by_dev[str(d)] = util
        comp_d = _merge(compiling.get(d, ()))
        gaps = []
        dev_gap_s: dict[str, float] = {}
        for g0, g1 in _gaps(merged, w0, w1):
            cls = _classify(g0, g1, comp_d, stacking, backlog)
            gaps.append({"t0_s": round(g0 - w0, 6),
                         "t1_s": round(g1 - w0, 6),
                         "wall_s": round(g1 - g0, 6), "class": cls})
            dev_gap_s[cls] = dev_gap_s.get(cls, 0.0) + (g1 - g0)
            gap_s[cls] += g1 - g0
        row: dict = {
            "device": d,
            "chunks": chunks_per_dev.get(d, 0),
            "busy_s": round(busy_s, 6),
            "utilization_pct": util,
            "gap_s": {c: round(v, 6) for c, v in sorted(dev_gap_s.items())},
        }
        row["intervals"] = _bound(
            [[round(a - w0, 6), round(b - w0, 6)] for a, b in merged],
            max_intervals, "intervals_elided", row)
        row["gaps"] = _bound(gaps, max_gaps, "gaps_elided", row)
        devices.append(row)

    busy_any = _merge(union_any)
    busy_any_s = sum(b - a for a, b in busy_any)
    # busy_all: time EVERY device was busy (intersection) — with the
    # per-device unions in hand, sweep the union's spans against each.
    busy_all_s = 0.0
    for a, b in busy_any:
        seg = [(a, b)]
        for d in range(n_devices):
            nxt = []
            for s0, s1 in seg:
                for x0, x1 in per_dev_busy[d]:
                    lo, hi = max(s0, x0), min(s1, x1)
                    if hi - lo > _EPS:
                        nxt.append((lo, hi))
            seg = nxt
            if not seg:
                break
        busy_all_s += sum(s1 - s0 for s0, s1 in seg)

    idle_total = sum(gap_s.values())
    utils = list(util_by_dev.values())
    summary: dict = {
        "n_devices": n_devices,
        "makespan_s": round(makespan, 6),
        "device_utilization_pct": util_by_dev,
        "mean_utilization_pct": round(sum(utils) / len(utils), 2),
        "min_utilization_pct": min(utils),
        "max_utilization_pct": max(utils),
        "busy_any_s": round(busy_any_s, 6),
        "busy_all_s": round(busy_all_s, 6),
        # Critical path: the fraction of the makespan during which at
        # least one device was busy — the ceiling any scheduler
        # rebalancing could reach without shortening the serial chain.
        "critical_path_pct": round(busy_any_s / makespan * 100.0, 2),
        "idle_s_total": round(idle_total, 6),
        "gap_attribution_s": {c: round(v, 6)
                              for c, v in sorted(gap_s.items()) if v > 0},
    }
    if idle_total > _EPS:
        summary["gap_attribution_share"] = {
            c: round(v / idle_total, 4)
            for c, v in sorted(gap_s.items()) if v > 0}
    try:
        g = registry.gauge(
            "device_utilization_pct",
            "Per-device busy share of the run makespan, reconstructed "
            "from timed chunk events", labelnames=("device",))
        for d, pct in util_by_dev.items():
            g.labels(device=d).set(pct)
    except Exception:  # noqa: BLE001 - a read-only registry still reports
        pass
    return {
        "window": {"t0": round(w0, 6), "t1": round(w1, 6),
                   "makespan_s": round(makespan, 6)},
        "devices": devices,
        "summary": summary,
    }


# ---------------------------------------------------------------------------
# SVG occupancy Gantt (no plotting dependency — hand-rolled like
# checker/linear_viz.py)

_C_BUSY = "#78a878"
_C_GAP = {"no-work": "#d8d8d8", "starved": "#c24f4f",
          "host-stacking": "#d99a3d", "compiling": "#7d7dc2"}


def render_gantt(util: dict, width: int = 960) -> str:
    """One SVG lane per device: busy spans in green, idle gaps colored
    by class — the ``/utilization`` page's chart. ``util`` is
    :func:`reconstruct`'s output (or the block stored in
    profile.json)."""
    devices = util.get("devices") or []
    makespan = float((util.get("window") or {}).get("makespan_s")
                     or (util.get("summary") or {}).get("makespan_s")
                     or 1.0)
    x0, lane_h, pad = 70, 24, 14
    plot_w = max(width - x0 - 20, 10)
    scale = plot_w / max(makespan, _EPS)
    height = 40 + lane_h * max(len(devices), 1) + 46

    def x(t: float) -> float:
        return x0 + t * scale

    s = util.get("summary") or {}
    svg = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="11">',
        f'<text x="8" y="16" font-size="13">device occupancy — mean '
        f'{_html.escape(str(s.get("mean_utilization_pct", "?")))}% over '
        f'{_html.escape(str(round(makespan, 3)))}s makespan, critical '
        f'path {_html.escape(str(s.get("critical_path_pct", "?")))}%'
        f'</text>',
    ]
    for li, dev in enumerate(devices):
        y = 30 + li * lane_h
        svg.append(f'<text x="8" y="{y + 14}">dev '
                   f'{_html.escape(str(dev.get("device")))} '
                   f'{_html.escape(str(dev.get("utilization_pct")))}%'
                   f'</text>')
        for g in dev.get("gaps") or []:
            gx0, gx1 = x(g["t0_s"]), x(g["t1_s"])
            color = _C_GAP.get(g.get("class"), "#eee")
            svg.append(
                f'<rect x="{gx0:.1f}" y="{y + 2}" '
                f'width="{max(gx1 - gx0, 1):.1f}" height="{lane_h - 8}" '
                f'fill="{color}" fill-opacity="0.85">'
                f'<title>{_html.escape(str(g.get("class")))} '
                f'{g["wall_s"]}s</title></rect>')
        for a, b in dev.get("intervals") or []:
            bx0, bx1 = x(a), x(b)
            svg.append(
                f'<rect x="{bx0:.1f}" y="{y + 2}" '
                f'width="{max(bx1 - bx0, 1):.1f}" height="{lane_h - 8}" '
                f'rx="2" fill="{_C_BUSY}">'
                f'<title>busy {round(b - a, 4)}s</title></rect>')
    ly = 30 + lane_h * max(len(devices), 1) + 16
    lx = x0
    for color, name in [(_C_BUSY, "busy")] + [
            (_C_GAP[c], c) for c in GAP_CLASSES]:
        svg.append(f'<rect x="{lx}" y="{ly}" width="12" height="12" '
                   f'rx="2" fill="{color}"/>')
        svg.append(f'<text x="{lx + 16}" y="{ly + 10}">{name}</text>')
        lx += 30 + 8 * len(name)
    svg.append("</svg>")
    return "\n".join(svg)
