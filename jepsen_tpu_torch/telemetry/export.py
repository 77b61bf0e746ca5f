"""Metric sinks: JSON-lines and Prometheus text exposition, written into
the test's ``store/`` directory next to ``spans.jsonl``. The port of the
reference's ``jepsen_tpu/telemetry/export.py``; the files are the
reference's, line for line.

- ``metrics.jsonl`` — one JSON object per line: every metric sample
  (counters/gauges carry ``value``; histograms carry ``count``/``sum``/
  ``buckets``) followed by every event point (``"type": "event"`` — the
  per-chunk rows the search drivers record). This is the
  machine-readable sink bench rounds and tests consume.
- ``metrics.prom`` — Prometheus text exposition format 0.0.4 (HELP/TYPE
  headers, cumulative ``_bucket`` series with ``+Inf``, ``_sum``/
  ``_count``), scrape-able or just greppable.

Both writes are atomic (tmp + rename) so repeated exports of a growing
registry are deterministic full snapshots, mirroring
``trace.Collector.export_jsonl``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .registry import Registry


def _fmt(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _esc(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _label_str(labels: dict, extra: Optional[dict] = None) -> str:
    items = list(labels.items()) + list((extra or {}).items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_esc(v)}"' for k, v in items)
    return "{" + body + "}"


def prometheus_text(registry: Registry) -> str:
    """Render the registry in Prometheus text exposition format."""
    lines: list[str] = []
    seen: set[str] = set()
    by_name: dict[str, list[dict]] = {}
    meta: dict[str, tuple[str, str]] = {}
    for s in registry.collect():
        by_name.setdefault(s["name"], []).append(s)
        meta.setdefault(s["name"], (s["type"], ""))
    with registry._lock:
        helps = {n: m.help for n, m in registry._metrics.items()}
    for name in sorted(by_name):
        kind, _ = meta[name]
        if name not in seen:
            seen.add(name)
            if helps.get(name):
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} {kind}")
        for s in by_name[name]:
            labels = s.get("labels") or {}
            if kind == "histogram":
                cum = 0
                for le, c in s["buckets"].items():
                    cum += c
                    lines.append(
                        f"{name}_bucket{_label_str(labels, {'le': le})} "
                        f"{cum}")
                lines.append(f"{name}_sum{_label_str(labels)} "
                             f"{_fmt(s['sum'])}")
                lines.append(f"{name}_count{_label_str(labels)} "
                             f"{s['count']}")
            else:
                lines.append(f"{name}{_label_str(labels)} "
                             f"{_fmt(s['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def jsonl_lines(registry: Registry) -> list[str]:
    """All metric samples, then all events, one JSON object per line."""
    out = [json.dumps(s, sort_keys=True) for s in registry.collect()]
    out.extend(
        json.dumps({"type": "event", **e}, sort_keys=True)
        for e in registry.events()
    )
    return out


def _atomic_write(path, text: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def export_jsonl(registry: Registry, path) -> int:
    lines = jsonl_lines(registry)
    _atomic_write(path, "".join(line + "\n" for line in lines))
    return len(lines)


def export_prometheus(registry: Registry, path) -> None:
    _atomic_write(path, prometheus_text(registry))


def store_metrics(test: dict, registry: Optional[Registry] = None
                  ) -> Optional[list]:
    """Write metrics.jsonl + metrics.prom into the test's store directory
    (next to spans.jsonl); returns the paths or None when the test has no
    store or no registry."""
    reg = registry if registry is not None \
        else test.get("telemetry-registry")
    if reg is None:
        return None
    if not (test.get("name") and test.get("start-time")) or test.get(
            "no-store?"):
        return None
    from .. import store

    pj = store.path_mk(test, "metrics.jsonl")
    export_jsonl(reg, pj)
    pp = store.path_mk(test, "metrics.prom")
    export_prometheus(reg, pp)
    return [str(pj), str(pp)]
