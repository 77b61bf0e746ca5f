"""Cross-run ledger: every ``core.run`` appends one compact JSON line to
``<store root>/ledger.jsonl``.

The run-record half of the reference's ``jepsen_tpu/telemetry/ledger.py``:
:func:`default_path`, :func:`append`, :func:`load` and
:func:`record_of_run`. A record carries the run's identity (workload,
engine, exchange mode), its scale (ops), its verdict, the checker seconds
and the online monitor's p99 decision latency::

    {"ts": 1754300000.0, "kind": "run", "run": "cas-register/2026...",
     "workload": "cas-register", "engine": "device", "ops": 10000,
     "verdict": "True", "checker_seconds": 0.85,
     "p99_decision_latency_s": 0.18}

The reference's record also carries the device utilization and its gap
shares, which its profile module reconstructs from the chunk events; the
port has no such reader yet, so a port record leaves them out. The
trend, the regression gate and the ``python -m`` entry point read these
files and stay in the reference.

Appends are best-effort (a ledger write never sinks a run) and one line
each, so concurrent writers interleave whole records; unparseable lines
are skipped on load.
"""

from __future__ import annotations

import json
import os
import time as _time
from pathlib import Path
from typing import Any, Optional

LEDGER_BASENAME = "ledger.jsonl"


def default_path(root: Optional[Any] = None) -> Path:
    """``<store root>/ledger.jsonl``; ``JEPSEN_LEDGER_PATH`` overrides
    everything (CI can point every writer at one file)."""
    env = os.environ.get("JEPSEN_LEDGER_PATH")
    if env:
        return Path(env)
    if root is None:
        from .. import store

        root = store.BASE_DIR
    return Path(root) / LEDGER_BASENAME


def append(record: dict, path: Optional[Any] = None) -> Optional[str]:
    """Append one record (``ts`` stamped if absent). Never raises: the
    ledger is an observability artifact, not a run dependency."""
    try:
        p = Path(path) if path is not None else default_path()
        rec = dict(record)
        rec.setdefault("ts", round(_time.time(), 3))
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a") as f:
            f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
        return str(p)
    except Exception:  # noqa: BLE001
        return None


def load(path: Optional[Any] = None) -> list[dict]:
    """All parseable records, in file (= time) order."""
    p = Path(path) if path is not None else default_path()
    out: list[dict] = []
    try:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                if isinstance(d, dict):
                    out.append(d)
    except OSError:
        return []
    return out


def _walk_results(results: Any, found: dict) -> None:
    if not isinstance(results, dict):
        return
    for k, v in results.items():
        if k in ("backend", "exchange", "n_shards") and not isinstance(v, (dict, list)):
            found.setdefault(k, v)
        elif isinstance(v, dict):
            _walk_results(v, found)


def record_of_run(test: dict) -> dict:
    """One compact ledger record from a finished (or crashed) ``core.run``
    test map: identity, scale, verdict, checker seconds and the online
    p99 decision latency."""
    results = test.get("results") or {}
    found: dict = {}
    _walk_results(results, found)
    h = test.get("history")
    rec: dict = {
        "kind": "run",
        "run": f"{test.get('name')}/{test.get('start-time')}",
        "workload": test.get("name"),
        "engine": found.get("backend") or "host",
        "verdict": str(results.get("valid")),
    }
    if found.get("exchange"):
        rec["exchange"] = found["exchange"]
    if found.get("n_shards"):
        rec["n_shards"] = found["n_shards"]
    try:
        rec["ops"] = len(h) if h is not None else None
    except TypeError:
        rec["ops"] = None
    reg = test.get("telemetry-registry")
    if reg is not None:
        try:
            cs = []
            for k, v in reg.summary().items():
                if not k.startswith("checker_seconds"):
                    continue
                # checker_seconds is a histogram: summary() folds it to
                # {count, sum}, and the run's total is the sum.
                if isinstance(v, dict):
                    v = v.get("sum")
                if isinstance(v, (int, float)):
                    cs.append(float(v))
            if cs:
                rec["checker_seconds"] = round(sum(cs), 6)
        except Exception:  # noqa: BLE001 - record what we can
            pass
    onl = test.get("online-results") or {}
    lat = onl.get("decision_latency") or {}
    if lat.get("p99_s") is not None:
        rec["p99_decision_latency_s"] = lat["p99_s"]
    return rec
