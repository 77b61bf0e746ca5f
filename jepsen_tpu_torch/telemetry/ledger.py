"""Cross-run perf ledger: every ``core.run`` appends one compact JSON line
to ``<store root>/ledger.jsonl``, and ``python -m jepsen_tpu_torch.ledger``
renders the trend of like runs and gates on regressions between them.

The port of the reference's ``jepsen_tpu/telemetry/ledger.py``. A record
carries the run's identity (workload, engine, exchange mode), its scale
(ops), its verdict and the headline numbers of the observability stack:
the checker seconds, the online monitor's p99 decision latency, the mean
device utilization and the shares of the idle gaps by class
(:mod:`.utilization`)::

    {"ts": 1754300000.0, "kind": "run", "run": "cas-register/2026...",
     "workload": "cas-register", "engine": "device", "ops": 10000,
     "verdict": "True", "checker_seconds": 0.85,
     "p99_decision_latency_s": 0.18, "utilization_pct": 81.3,
     "gap_share": {"compiling": 0.7, "no-work": 0.3}}

The trend and the gate reuse :mod:`jepsen_tpu_torch.benchcmp`: records
group by ``(kind, workload, engine)`` (only like runs compare), the table
is ``benchcmp.render_table`` over :data:`LEDGER_METRICS` (the same
direction-aware arrows), and ``--check`` runs ``benchcmp.deltas`` on each
group's newest record against the one before it, exiting 1 past the
threshold.

``--alerts`` appends the flagged groups to the alerting plane's
``alerts.jsonl``; that plane comes with the multi-tenant service
(ROADMAP item A7), and until then the option is refused with exit 254.

Appends are best-effort (a ledger write never sinks a run) and one line
each, so concurrent writers interleave whole records; unparseable lines
are skipped on load.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time as _time
from pathlib import Path
from typing import Any, Optional

LEDGER_BASENAME = "ledger.jsonl"

# Metric catalogue: (name, key, direction) — flat keys into a ledger
# record; same direction semantics as benchcmp.METRICS ("lower" =
# seconds-like, "higher" = throughput/utilization-like, "info" = shown
# but never gated).
LEDGER_METRICS: list[tuple[str, str, str]] = [
    ("value_s", "value_s", "lower"),
    ("checker_seconds", "checker_seconds", "lower"),
    ("p99_decision_latency_s", "p99_decision_latency_s", "lower"),
    ("utilization_pct", "utilization_pct", "higher"),
    ("ops_per_s", "ops_per_s", "higher"),
    # Self-healing fleet: spawn → /healthz on the replacement child
    # after the router bench leg's injected kill-9.
    ("respawn_seconds", "respawn_seconds", "lower"),
    # Fleet federation: the bucket-merged cross-process p99 and the
    # coldest backend's busy share (telemetry/fleet.py).
    ("fleet_p99_decision_latency_s",
     "fleet_p99_decision_latency_s", "lower"),
    ("fleet_min_backend_utilization_pct",
     "fleet_min_backend_utilization_pct", "higher"),
    # Offline decrease-and-conquer: the segment planner's one-pass
    # cut cost over the recorded history (growing = planning stopped
    # being negligible next to deciding) and the end-to-end advantage
    # over the single-driver serial search ("info": the serial rate is
    # sample-measured and superlinear in history length, so the ratio
    # is a machine-dependent lower bound — gated in tests, not here).
    ("plan_seconds", "plan_seconds", "lower"),
    ("speedup_vs_serial", "speedup_vs_serial", "info"),
    # Alerting plane (telemetry/alerts.py): how long the armed
    # journal-fault took to flip `journal_errors` to firing, and what
    # rule evaluation cost against the service leg's wall clock —
    # both growing means the watchdog got slower or heavier.
    ("alert_detection_seconds", "alert_detection_seconds", "lower"),
    ("alert_eval_overhead_pct", "alert_eval_overhead_pct", "lower"),
    # Trace ingestion (ingest/): raw-recording parse+check
    # throughput of the adapter front door.
    ("ingest_ops_per_s", "ingest_ops_per_s", "higher"),
    ("ops", "ops", "info"),
]

DEFAULT_THRESHOLD = 0.10

# What --alerts answers until the alerting plane is ported, and its exit
# code (the CLI's code for invalid arguments).
ALERTS_SLICE = ("--alerts appends to the alerting plane's alerts.jsonl, which comes "
                "with the multi-tenant service (ROADMAP item A7: telemetry/alerts.py)")
EXIT_BAD_ARGS = 254


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
    """Append one record (``ts`` stamped if absent). Never raises —
    the ledger is an observability artifact, not a run dependency."""
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


# ---------------------------------------------------------------------------
# Records of runs and bench legs


def _walk_results(results: Any, found: dict) -> None:
    if not isinstance(results, dict):
        return
    for k, v in results.items():
        if k in ("backend", "exchange", "n_shards") and not isinstance(
                v, (dict, list)):
            found.setdefault(k, v)
        elif isinstance(v, dict):
            _walk_results(v, found)


def _stored_utilization_summary(test: dict) -> Optional[dict]:
    """A --profile run's core.run already reconstructed utilization
    into profile.json moments before the ledger append — read the
    summary back instead of re-running the full event-ring scan (and
    re-setting gauges after the metric sinks were exported)."""
    if not test.get("profile?"):
        return None
    if not (test.get("name") and test.get("start-time")) or test.get(
            "no-store?"):
        return None
    try:
        from .. import store

        doc = json.loads(store.path(test, "profile.json").read_text())
        return (doc.get("attribution") or {}).get(
            "utilization", {}).get("summary")
    except Exception:  # noqa: BLE001 - fall back to recomputing
        return None


def record_of_run(test: dict) -> dict:
    """One compact ledger record from a finished (or crashed)
    ``core.run`` test map: identity, scale, verdict, checker seconds,
    online p99 decision latency, and the utilization summary when the
    run's registry recorded stamped chunk events. The utilization
    module is only imported when those events exist."""
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
            s = reg.summary()
            cs = []
            for k, v in s.items():
                if not k.startswith("checker_seconds"):
                    continue
                # checker_seconds is a histogram: summary() folds it to
                # {count, sum} — the per-run total IS the sum.
                if isinstance(v, dict):
                    v = v.get("sum")
                if isinstance(v, (int, float)):
                    cs.append(float(v))
            if cs:
                rec["checker_seconds"] = round(sum(cs), 6)
        except Exception:  # noqa: BLE001 - record what we can
            pass
        try:
            u_summary = _stored_utilization_summary(test)
            if u_summary is None:
                from .profile import _attribute_utilization

                u = _attribute_utilization(reg)
                u_summary = u["summary"] if u is not None else None
            if u_summary is not None:
                rec["utilization_pct"] = \
                    u_summary["mean_utilization_pct"]
                if u_summary.get("gap_attribution_share"):
                    rec["gap_share"] = \
                        u_summary["gap_attribution_share"]
        except Exception:  # noqa: BLE001
            pass
    onl = test.get("online-results") or {}
    lat = onl.get("decision_latency") or {}
    if lat.get("p99_s") is not None:
        rec["p99_decision_latency_s"] = lat["p99_s"]
    return rec


# bench.py leg catalogue: (leg name, dotted path into the bench dict or
# None for top level, engine, {ledger key: source key}).
_BENCH_LEGS: list[tuple[str, Optional[str], str, dict]] = [
    ("headline", None, "native",
     {"value_s": "value", "ops_per_s": "ops_per_s"}),
    ("invalid_refutation", None, "native", {"value_s": "invalid_s"}),
    ("interpreter", None, "host",
     {"ops_per_s": "interpreter_ops_per_s"}),
    ("online_10k", "online_10k", "host",
     {"value_s": "online_s",
      "p99_decision_latency_s": "p99_decision_latency_s",
      "ops": "n_ops", "verdict": "valid"}),
    ("service_streams", "service_streams", "host",
     {"value_s": "wall_s", "ops_per_s": "sustained_ops_per_s",
      "p99_decision_latency_s": "p99_decision_latency_s",
      "ops": "n_ops_total", "verdict": "valid_all",
      # Alerting plane: detection latency of the armed journal fault
      # and the rule-evaluation overhead share of the leg's wall.
      "alert_detection_seconds": "alert_detection_seconds",
      "alert_eval_overhead_pct": "alert_eval_overhead_pct"}),
    ("service_router", "service_router", "host",
     {"value_s": "wall_s", "ops_per_s": "sustained_ops_per_s",
      "p99_decision_latency_s": "p99_decision_latency_s",
      "ops": "n_ops_total", "verdict": "valid_all",
      # Self-healing fleet: the repair half of the kill cycle.
      "respawn_seconds": "respawn_seconds",
      # Fleet federation: cross-process p99 + coldest backend busy
      # share from the router's federated scrape.
      "fleet_p99_decision_latency_s": "fleet_p99_decision_latency_s",
      "fleet_min_backend_utilization_pct":
          "fleet_min_backend_utilization_pct"}),
    ("batch_replay_100", "batch_replay_100", "device",
     {"value_s": "value_s"}),
    ("batch_replay_large", "batch_replay_large", "device",
     {"value_s": "value_s"}),
    ("smoke_8x10k", "batch_replay_large.smoke_8x10k", "device",
     {"value_s": "value_s", "utilization_pct": "utilization_pct"}),
    ("elle_txn", "elle_txn", "device",
     {"value_s": "value_s", "ops": "mops"}),
    # Batched Elle SCC/closure engine: N graphs across >=2 size
    # buckets through <= one vmapped dispatch per bucket.
    ("elle_scc_batched", "elle_scc_batched", "device",
     {"value_s": "value_s", "ops_per_s": "elle_txns_per_s",
      "ops": "n_txns", "speedup_vs_serial": "elle_batch_speedup_x"}),
    ("mutex_5k", "mutex_5k", "device", {"value_s": "value_s"}),
    ("device_kernel", None, "device",
     {"value_s": "device_kernel_s",
      "utilization_pct": "device_utilization_pct"}),
    ("max_verified_ops", "max_verified_ops", "native",
     {"ops": "ops", "value_s": "value_s", "ops_per_s": "ops_per_s"}),
    ("max_verified_ops_device", "max_verified_ops_device", "device",
     {"ops": "ops", "value_s": "value_s"}),
    ("max_verified_ops_device_sharded",
     "max_verified_ops_device_sharded", "sharded",
     {"ops": "ops", "value_s": "value_s"}),
    # Offline decrease-and-conquer: plan() → drive() over a recorded
    # ≥1M-op keyed history (segment × carried-state co-batching).
    ("offline_segmented", "offline_segmented", "auto",
     {"value_s": "decide_seconds", "ops_per_s": "ops_per_s",
      "plan_seconds": "plan_seconds",
      "speedup_vs_serial": "speedup_vs_serial",
      "utilization_pct": "utilization_pct",
      "ops": "n_ops", "verdict": "valid"}),
    # Trace ingestion: a 10k-op synthetic etcd recording through
    # adapter → pairing → classification → segmented WGL.
    ("ingest_etcd_10k", "ingest_etcd_10k", "host",
     {"value_s": "value_s", "ingest_ops_per_s": "ingest_ops_per_s",
      "ops": "ops", "verdict": "valid"}),
]


def _dig(d: Any, path: Optional[str]) -> Any:
    if path is None:
        return d
    cur = d
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def records_of_bench(out: dict) -> list[dict]:
    """One record per bench leg that actually produced a number —
    skipped/errored legs leave no record (their absence from the trend
    IS the signal; the bench JSON itself records the error)."""
    ts = round(_time.time(), 3)
    recs = []
    for leg, path, engine, fields in _BENCH_LEGS:
        data = _dig(out, path)
        if not isinstance(data, dict):
            continue
        rec: dict = {"ts": ts, "kind": "bench", "run": leg,
                     "workload": leg, "engine": engine}
        got_number = False
        for key, src in fields.items():
            v = data.get(src)
            if key == "verdict":
                if v is not None:
                    rec["verdict"] = str(v)
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                rec[key] = v
                got_number = True
        if got_number:
            recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# Trend + gate (reusing benchcmp's delta/threshold machinery)


def group_key(rec: dict) -> tuple:
    """Comparability key: only like runs trend against each other."""
    return (str(rec.get("kind")), str(rec.get("workload")),
            str(rec.get("engine")))


def grouped(records: list[dict]) -> dict[tuple, list[dict]]:
    out: dict[tuple, list[dict]] = {}
    for r in records:
        out.setdefault(group_key(r), []).append(r)
    return out


def _metrics_of(rec: dict) -> dict:
    return {name: float(rec[key]) for name, key, _d in LEDGER_METRICS
            if isinstance(rec.get(key), (int, float))
            and not isinstance(rec.get(key), bool)}


def _label(rec: dict, i: int) -> str:
    ts = rec.get("ts")
    try:
        return _time.strftime("%m-%d %H:%M", _time.localtime(float(ts)))
    except (TypeError, ValueError):
        return f"#{i}"


def trend(records: list[dict], threshold: float = DEFAULT_THRESHOLD,
          last: int = 8) -> list[dict]:
    """Per-group trend blocks: the newest ``last`` records as table
    columns plus the newest-vs-previous delta block (benchcmp.deltas
    over :data:`LEDGER_METRICS`)."""
    from .. import benchcmp

    out = []
    for key, recs in sorted(grouped(records).items()):
        recs = sorted(recs, key=lambda r: r.get("ts") or 0)
        window = recs[-last:]
        merged = [{"label": _label(r, i), "metrics": _metrics_of(r)}
                  for i, r in enumerate(window)]
        block: dict = {
            "key": {"kind": key[0], "workload": key[1],
                    "engine": key[2]},
            "records": len(recs),
            "columns": merged,
            "verdicts": [str(r.get("verdict")) for r in window],
        }
        if len(recs) >= 2:
            d = benchcmp.deltas(_metrics_of(recs[-2]),
                                _metrics_of(recs[-1]),
                                threshold=threshold,
                                metrics=LEDGER_METRICS)
            block["deltas"] = d
            block["regressions"] = benchcmp.regressions(d)
        out.append(block)
    return out


def check(records: list[dict],
          threshold: float = DEFAULT_THRESHOLD) -> list[dict]:
    """The ``--check`` gate: every group's newest record vs its
    previous comparable one; returns the flagged groups (empty =
    pass). Post-bench CI runs this right after the bench appended its
    leg records, so each leg gates against its own history."""
    return [b for b in trend(records, threshold=threshold)
            if b.get("regressions")]


def render(records: list[dict], threshold: float = DEFAULT_THRESHOLD,
           last: int = 8) -> str:
    from .. import benchcmp

    if not records:
        return ("ledger is empty — runs and bench legs append to "
                f"{default_path()}")
    lines = []
    for block in trend(records, threshold=threshold, last=last):
        k = block["key"]
        lines.append(f"== {k['kind']} {k['workload']} "
                     f"[engine={k['engine']}] "
                     f"({block['records']} records)")
        lines.append(benchcmp.render_table(block["columns"],
                                           metrics=LEDGER_METRICS))
        lines.append("verdicts: " + " ".join(block["verdicts"]))
        for name in sorted(block.get("deltas") or {}):
            d = block["deltas"][name]
            if "delta_pct" not in d:
                continue
            if d["regression"] or abs(d["delta_pct"]) >= 5:
                flag = " ** REGRESSION" if d["regression"] else ""
                lines.append(
                    f"  {name}: {benchcmp._fmt(d['prev'])} -> "
                    f"{benchcmp._fmt(d['cur'])} "
                    f"({d['delta_pct']:+.1f}%){flag}")
        lines.append("")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.ledger",
        description="Render the cross-run perf ledger's trend and gate "
                    "on regressions between comparable runs.")
    p.add_argument("path", nargs="?", default=None,
                   help=f"ledger file (default {default_path()})")
    p.add_argument("--check", action="store_true",
                   help="exit nonzero when any group's newest record "
                        "regresses past the threshold vs its previous "
                        "comparable run (same workload + engine)")
    p.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                   help="regression threshold as a fraction "
                        "(default 0.10 = 10%%)")
    p.add_argument("--workload", default=None,
                   help="only this workload/leg")
    p.add_argument("--last", type=int, default=8,
                   help="table columns per group (default 8)")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("--alerts", default=None, metavar="ALERTS_JSONL",
                   help="append each flagged group to an alerts.jsonl; "
                        "refused (exit 254) until the alerting plane "
                        "lands with the multi-tenant service")
    ns = p.parse_args(argv)

    if ns.alerts is not None:
        print(ALERTS_SLICE, file=sys.stderr)
        return EXIT_BAD_ARGS
    records = load(ns.path)
    if ns.workload:
        records = [r for r in records
                   if str(r.get("workload")) == ns.workload]
    flagged = check(records, threshold=ns.threshold) if records else []
    if ns.as_json:
        print(json.dumps({
            "groups": trend(records, threshold=ns.threshold,
                            last=ns.last),
            "threshold": ns.threshold,
            "flagged": [b["key"] for b in flagged],
        }, indent=1, sort_keys=True, default=str))
    else:
        print(render(records, threshold=ns.threshold, last=ns.last))
        if ns.check:
            if flagged:
                names = sorted(
                    f"{b['key']['workload']}[{b['key']['engine']}]"
                    f": {', '.join(b['regressions'])}"
                    for b in flagged)
                print(f"REGRESSIONS past {ns.threshold * 100:.0f}%:")
                print("\n".join("  " + n for n in names))
            else:
                print(f"no regressions past {ns.threshold * 100:.0f}% "
                      "(newest record per comparable group)")
    return 1 if (ns.check and flagged) else 0


if __name__ == "__main__":
    sys.exit(main())
