"""Bench-trajectory regression gate: read the committed ``BENCH_r*.json``
and ``MULTICHIP_r*.json`` round files into a metric-by-round table and
flag regressions.

The port of the reference's ``jepsen_tpu/benchcmp.py``, host-only and
unchanged in its semantics:

- ``python -m jepsen_tpu_torch.benchcmp BENCH_r0*.json`` renders the
  trajectory, compares the newest round with the one before it (every
  adjacent pair with ``--all``) and exits 1 when a tracked metric
  regresses past its threshold (10% by default, ``--threshold``);
- :func:`vs_previous` gives the delta block of a just-measured bench
  dict against the newest round file;
- :func:`deltas`, :func:`regressions`, :func:`render_table` and
  :func:`_fmt` are the machinery the cross-run ledger's trend and gate
  (:mod:`jepsen_tpu_torch.telemetry.ledger`) reuse with their own
  catalogue.

Round files come in three shapes: a wrapper ``{"cmd", "n",
"parsed", "rc", "tail"}`` (``parsed`` may be null, and a final line that
outgrew the tail capture survives only as a head-truncated fragment,
recovered by clipping to the first complete ``"key":`` boundary), a bare
bench JSON line, or a multichip wrapper ``{"n_devices", "ok", ...}``. A
metric missing from a round leaves a hole in the table and never crashes
the gate.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Any, Optional

# Metric catalogue: (name, dotted path into the bench JSON, direction).
# direction "lower" = seconds-like (regression when it grows), "higher"
# = throughput/scale-like (regression when it shrinks), "info" = shown
# in the table but never gated (budget wall, validity echoes).
METRICS: list[tuple[str, str, str]] = [
    ("value_s", "value", "lower"),
    ("invalid_s", "invalid_s", "lower"),
    ("fresh_history_s", "fresh_history_s", "lower"),
    ("headroom_10x_s", "headroom_10x.value_s", "lower"),
    ("interpreter_ops_per_s", "interpreter_ops_per_s", "higher"),
    ("interpreter_100w_ops_per_s", "interpreter_100w_ops_per_s",
     "higher"),
    ("batch_replay_100_s", "batch_replay_100.value_s", "lower"),
    ("batch_replay_large_s", "batch_replay_large.value_s", "lower"),
    ("smoke_8x10k_s", "batch_replay_large.smoke_8x10k.value_s", "lower"),
    ("elle_txn_s", "elle_txn.value_s", "lower"),
    ("big_scc_4096_s", "elle_txn.big_scc_4096.value_s", "lower"),
    # Batched Elle SCC/closure engine: co-batched
    # throughput across size buckets, and the speedup over the serial
    # per-graph engine baseline sampled in-leg (info: the pin lives in
    # the leg's own error field).
    ("elle_txns_per_s", "elle_scc_batched.elle_txns_per_s", "higher"),
    ("elle_batch_speedup_x", "elle_scc_batched.elle_batch_speedup_x",
     "info"),
    # Trace ingestion: raw etcd recording → adapter →
    # pairing → segmented WGL; the verdict/unmapped pins live in the
    # leg's own error field.
    ("ingest_ops_per_s", "ingest_etcd_10k.ingest_ops_per_s", "higher"),
    ("ingest_etcd_10k_s", "ingest_etcd_10k.value_s", "lower"),
    ("mutex_5k_s", "mutex_5k.value_s", "lower"),
    ("device_kernel_s", "device_kernel_s", "lower"),
    ("per_level_ms", "per_level_ms", "lower"),
    ("device_util", "device_util", "higher"),
    ("hbm_copy_gbs", "hbm_copy_gbs", "higher"),
    ("max_verified_ops", "max_verified_ops.ops", "higher"),
    ("max_verified_ops_per_s", "max_verified_ops.ops_per_s", "higher"),
    ("max_verified_ops_device", "max_verified_ops_device.ops", "higher"),
    ("max_verified_ops_device_sharded",
     "max_verified_ops_device_sharded.ops", "higher"),
    ("smoke_8x10k_decided",
     "batch_replay_large.smoke_8x10k.decided", "higher"),
    # Device-saturation observability: mean device
    # utilization of the smoke leg's escalation schedule, reconstructed
    # from stamped batch-chunk events (telemetry.utilization) — the
    # ROADMAP "first metric to watch" leg, now watched for EFFICIENCY
    # and not just decided>=1. Shrinking = the ladder idles the mesh.
    ("smoke_8x10k_utilization_pct",
     "batch_replay_large.smoke_8x10k.utilization_pct", "higher"),
    ("bench_wall_s", "bench_wall_s", "info"),
    ("multichip_ok", "multichip_ok", "higher"),
    # Owner-partitioned frontier exchange: the analytic
    # per-device per-level exchange bytes of the sharded search on the
    # multichip mesh — seconds-like direction (more interconnect bytes
    # per level is a regression); the drop factor vs the replicated
    # all_gather model is scale-like (it should ride mesh size).
    ("multichip_exchange_bytes_per_level",
     "exchange_bytes_per_level.alltoall", "lower"),
    ("multichip_exchange_drop_x", "exchange_drop_x", "higher"),
    # Online linearizability monitor: history ops observed
    # before the first invalid segment's verdict lands on the
    # seeded-invalid stream, and the end-to-end cost of deciding WHILE
    # streaming vs post-hoc — both regressions when they grow.
    ("online_ops_to_detection", "online_10k.ops_to_detection", "lower"),
    ("online_overhead_pct", "online_10k.online_overhead_pct", "lower"),
    # Decision-latency tracing: the p99 invoke→watermark-
    # covered lag of the online monitor's seeded-invalid 10k-op stream
    # — THE serving-stack signal ROADMAP item 3 benches against. Growth
    # = the scheduler/pipeline got slower at covering ops; lower only.
    ("online_p99_decision_latency_s",
     "online_10k.p99_decision_latency_s", "lower"),
    # Multi-tenant checking service: sustained throughput of
    # N concurrent tenant streams through the shared co-batching
    # scheduler, and the service-wide p99 invoke→watermark-covered lag
    # — the "heavy traffic from millions of users" serving numbers
    # ROADMAP item 3 benches. Throughput shrinking or tail latency
    # growing is a regression.
    ("service_sustained_ops_per_s",
     "service_streams.sustained_ops_per_s", "higher"),
    ("service_p99_decision_latency_s",
     "service_streams.p99_decision_latency_s", "lower"),
    # Fault-tolerant checking pipeline: the service leg now
    # ALWAYS runs with one injected transient device fault, so its
    # sustained ops/s is the RECOVERED throughput; `failovers` records
    # how many oracle rounds were demoted to host re-dispatch.
    # Direction "info": the count documents chaos coverage in the
    # trajectory — more or fewer failovers is a configuration fact,
    # not a regression.
    ("service_failovers_total", "service_streams.failovers", "info"),
    # Alerting plane: how long the armed journal fault
    # took to flip `journal_errors` to firing (growing = the watchdog
    # reacts slower), and what the rule catalogue's evaluation cost
    # against the service leg's wall clock (growing = the always-on
    # plane stopped being negligible; the bench gates it under 2%).
    ("alert_detection_seconds",
     "service_streams.alert_detection_seconds", "lower"),
    ("alert_eval_overhead_pct",
     "service_streams.alert_eval_overhead_pct", "lower"),
    # Horizontal service resilience: 2 backend processes ×
    # 4 tenants behind the tenant router with one injected kill-9
    # mid-run — the sustained throughput is the RECOVERED-after-
    # migration number (shrinking = the outage window or the proxy
    # overhead grew), and `router_migration_seconds` prices the
    # journal-backed migration itself (checkpoint handover + adopt
    # replay + placement flip; growing = recovery got slower).
    ("router_sustained_ops_per_s",
     "service_router.sustained_ops_per_s", "higher"),
    ("router_migration_seconds",
     "service_router.migration_seconds", "lower"),
    # Self-healing fleet: the leg's kill now runs a
    # FULL kill→respawn→re-adopt cycle; this prices the repair half
    # (spawn → /healthz on the replacement child; growing = recovery
    # to N capacity got slower).
    ("router_respawn_seconds",
     "service_router.respawn_seconds", "lower"),
    # Fleet observability: the REAL cross-process p99
    # from the router's bucket-merged federated histograms (growing =
    # the fleet's decision tail got slower — this is the quantile the
    # SLO monitor burns against, not a max of per-backend p99s), and
    # the coldest backend's busy share over the bench window
    # (shrinking = placement is leaving more paid-for capacity idle).
    ("fleet_p99_decision_latency_s",
     "service_router.fleet_p99_decision_latency_s", "lower"),
    ("fleet_min_backend_utilization_pct",
     "service_router.fleet_min_backend_utilization_pct", "higher"),
    # Offline decrease-and-conquer: end-to-end
    # plan+decide throughput over a recorded ≥1M-op keyed history
    # through the co-batching scheduler (shrinking = the planner or
    # the ready-take pipeline got slower). `speedup_vs_serial` is
    # "info": it divides by a sample-measured single-driver rate whose
    # superlinear cost makes the ratio a machine-dependent lower
    # bound — the scale pin asserts it in tests, the table shows it.
    ("offline_segmented_ops_per_s",
     "offline_segmented.ops_per_s", "higher"),
    ("offline_segmented_speedup_vs_serial",
     "offline_segmented.speedup_vs_serial", "info"),
]

DEFAULT_THRESHOLD = 0.10


def _dig(d: Any, path: str) -> Optional[float]:
    cur = d
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    if isinstance(cur, bool):
        return float(cur)
    if isinstance(cur, (int, float)):
        return float(cur)
    return None


def _parse_json_line(line: str) -> Optional[dict]:
    line = line.strip()
    if not line.startswith("{") or not line.endswith("}"):
        return None
    try:
        d = json.loads(line)
        return d if isinstance(d, dict) else None
    except ValueError:
        return None


def _recover_fragment(text: str) -> Optional[dict]:
    """Recover a dict from a HEAD-TRUNCATED JSON line (a tail capture
    that cut the front off): clip forward to the first complete
    ``, "key":`` boundary and re-open the object there. Loses the
    severed leading keys, keeps everything after — r5's final line
    yields 20+ of its metrics this way."""
    if not text.rstrip().endswith("}"):
        return None
    for m in re.finditer(r', "', text):
        candidate = '{"' + text[m.end():]
        try:
            d = json.loads(candidate)
            if isinstance(d, dict) and d:
                return d
        except ValueError:
            continue
    return None


def _last_bench_line(text: str) -> Optional[dict]:
    """The newest parseable bench JSON line in a blob of output (the
    documented last-parseable-line contract), falling back to fragment
    recovery on the final line."""
    best = None
    for line in text.splitlines():
        d = _parse_json_line(line)
        if d is not None and ("metric" in d or "bench_wall_s" in d):
            best = d
    if best is not None:
        return best
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if lines:
        rec = _recover_fragment(lines[-1])
        if rec is not None and ("bench_wall_s" in rec or "metric" in rec):
            rec["recovered_fragment"] = True
            return rec
    return None


def round_label(path: str) -> str:
    m = re.search(r"_r(\d+)", os.path.basename(path))
    if m:
        return f"r{int(m.group(1)):02d}"
    return os.path.splitext(os.path.basename(path))[0]


def round_sort_key(path: str) -> tuple:
    """NUMERIC ordering key for round artifacts — the label string is
    only 2-padded, so sorting by it (or by raw path) misplaces r100
    vs r99; every 'newest round' lookup must sort with this."""
    m = re.search(r"_r(\d+)", os.path.basename(path))
    return ((int(m.group(1)) if m else 10 ** 9),
            os.path.basename(path))


def load_round(path: str) -> dict:
    """One artifact -> {"label", "path", "data", "kind"}; ``data`` is
    the flat bench dict (possibly recovered), ``{}`` when nothing in the
    file parses (the gate shows the hole instead of crashing)."""
    with open(path) as f:
        raw = json.load(f)
    label = round_label(path)
    kind = "bench"
    data: dict = {}
    if isinstance(raw, dict) and "n_devices" in raw:
        kind = "multichip"
        data = {"multichip_ok": bool(raw.get("ok")),
                "n_devices": raw.get("n_devices")}
        inner = raw.get("parsed")
        if isinstance(inner, dict):
            data.update(inner)
        elif isinstance(raw.get("tail"), str):
            # dryrun_multichip prints one machine-readable JSON line
            # (exchange byte model, mode agreement) amid the backend's
            # log noise — the newest one wins.
            for line in raw["tail"].splitlines():
                d = _parse_json_line(line)
                if d is not None and ("multichip" in d
                                      or "exchange_bytes_per_level" in d):
                    data.update(d)
    elif isinstance(raw, dict) and ("parsed" in raw or "tail" in raw):
        inner = raw.get("parsed")
        if isinstance(inner, dict):
            data = dict(inner)
        elif isinstance(raw.get("tail"), str):
            data = _last_bench_line(raw["tail"]) or {}
        if raw.get("rc") not in (0, None):
            data.setdefault("driver_rc", raw["rc"])
    elif isinstance(raw, dict):
        data = raw
    return {"label": label, "path": path, "data": data, "kind": kind}


def extract(data: dict) -> dict:
    """Flatten one round's data into the metric catalogue's values."""
    return {name: _dig(data, path) for name, path, _dir in METRICS
            if _dig(data, path) is not None}


def _merge_rounds(rounds: list[dict]) -> list[dict]:
    """Merge same-label artifacts (BENCH + MULTICHIP of one round) into
    one column, in NUMERIC round order (the 2-padded label sorts r100
    before r99 lexically — the gate would compare the newest pair
    backwards)."""
    by_label: dict[str, dict] = {}
    for r in rounds:
        tgt = by_label.setdefault(
            r["label"], {"label": r["label"], "metrics": {},
                         "paths": []})
        tgt["paths"].append(r["path"])
        tgt["metrics"].update(extract(r["data"]))
    return sorted(by_label.values(),
                  key=lambda m: round_sort_key(m["paths"][0]))


def deltas(prev: dict, cur: dict,
           threshold: float = DEFAULT_THRESHOLD,
           metrics: Optional[list] = None) -> dict:
    """Metric-wise delta block between two rounds' extracted metrics:
    ``{metric: {prev, cur, delta_pct, regression}}``. ``delta_pct`` is
    signed (cur vs prev); regression is direction-aware and gated at
    ``threshold`` (fraction). ``metrics`` defaults to the bench
    catalogue; the cross-run ledger (``telemetry.ledger``)
    reuses this machinery with its own catalogue."""
    out: dict = {}
    for name, _path, direction in (metrics if metrics is not None
                                   else METRICS):
        p, c = prev.get(name), cur.get(name)
        if p is None or c is None:
            continue
        d: dict = {"prev": p, "cur": c}
        if p != 0:
            pct = (c - p) / abs(p) * 100.0
            d["delta_pct"] = round(pct, 1)
            if direction == "lower":
                d["regression"] = pct > threshold * 100.0
            elif direction == "higher":
                d["regression"] = pct < -threshold * 100.0
            else:
                d["regression"] = False
        else:
            d["regression"] = direction == "higher" and c < p
        out[name] = d
    return out


def regressions(delta_block: dict) -> list[str]:
    return sorted(k for k, v in delta_block.items()
                  if v.get("regression"))


def vs_previous(current: dict, artifact_glob: str = "BENCH_r*.json",
                root: Optional[str] = None,
                threshold: float = DEFAULT_THRESHOLD) -> Optional[dict]:
    """Delta block of a just-measured bench dict vs the NEWEST committed
    round artifact — what bench.py embeds as ``vs_previous`` so a
    regression is self-reported inside the new round's own JSON line.
    None when no prior artifact exists or none parses."""
    root = root or os.path.dirname(os.path.abspath(__file__)) + "/.."
    # Numeric round order — lexical path (or 2-padded label) order
    # misplaces r9 vs r10 (and r99 vs r100).
    paths = sorted(glob.glob(os.path.join(root, artifact_glob)),
                   key=round_sort_key)
    if not paths:
        return None
    prev = load_round(paths[-1])
    pm = extract(prev["data"])
    if not pm:
        return None
    block = deltas(pm, extract(current), threshold=threshold)
    if not block:
        return None
    return {
        "round": prev["label"],
        "path": os.path.basename(prev["path"]),
        "threshold_pct": round(threshold * 100.0, 1),
        "deltas": block,
        "regressions": regressions(block),
    }


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "—"
    if v == int(v) and abs(v) < 1e12:
        return str(int(v))
    return f"{v:.4g}"


def render_table(merged: list[dict],
                 metrics: Optional[list] = None) -> str:
    """Metric-by-round text table (metrics as rows, rounds as
    columns). ``metrics`` defaults to the bench catalogue (the ledger
    passes its own)."""
    labels = [m["label"] for m in merged]
    rows = []
    for name, _path, direction in (metrics if metrics is not None
                                   else METRICS):
        vals = [m["metrics"].get(name) for m in merged]
        if all(v is None for v in vals):
            continue
        arrow = {"lower": "↓", "higher": "↑", "info": " "}[direction]
        rows.append([f"{name} {arrow}"] + [_fmt(v) for v in vals])
    widths = [max(len(r[i]) for r in rows + [["metric"] + labels])
              for i in range(len(labels) + 1)]
    lines = ["  ".join(s.ljust(w) for s, w in
                       zip(["metric"] + labels, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for r in rows:
        lines.append("  ".join(s.ljust(w) for s, w in zip(r, widths)))
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.benchcmp",
        description="Render the bench-round trajectory and gate on "
                    "regressions.")
    p.add_argument("artifacts", nargs="*",
                   help="BENCH_r*.json / MULTICHIP_r*.json round files")
    p.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                   help="regression threshold as a fraction "
                        "(default 0.10 = 10%%)")
    p.add_argument("--all", action="store_true",
                   help="gate every adjacent round pair, not just the "
                        "newest")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the table + comparisons as JSON")
    ns = p.parse_args(argv)

    try:
        rounds = [load_round(a) for a in ns.artifacts]
    except (OSError, ValueError) as e:
        print(f"benchcmp: cannot read artifacts: {e}", file=sys.stderr)
        return 2
    merged = _merge_rounds(rounds)
    if len(merged) < 2:
        # A fresh repo (or a CI invocation before the second committed
        # round) has nothing to gate: that is a clean no-op, not a
        # failure — exit 0 so pipelines can call benchcmp
        # unconditionally.
        print(f"benchcmp: nothing to compare — {len(merged)} round(s) "
              "given, need at least 2 committed rounds")
        if merged:
            print(render_table(merged))
        return 0

    comparisons = []
    for prev, cur in zip(merged, merged[1:]):
        block = deltas(prev["metrics"], cur["metrics"],
                       threshold=ns.threshold)
        comparisons.append({
            "from": prev["label"], "to": cur["label"],
            "deltas": block, "regressions": regressions(block)})
    gated = comparisons if ns.all else comparisons[-1:]
    flagged = [c for c in gated if c["regressions"]]

    if ns.as_json:
        print(json.dumps({
            "rounds": [{"label": m["label"], "metrics": m["metrics"]}
                       for m in merged],
            "comparisons": comparisons,
            "threshold": ns.threshold,
            "flagged": [{k: c[k] for k in ("from", "to", "regressions")}
                        for c in flagged],
        }, indent=1, sort_keys=True))
    else:
        print(render_table(merged))
        for c in comparisons:
            marks = []
            for name in sorted(c["deltas"]):
                d = c["deltas"][name]
                if "delta_pct" not in d:
                    continue
                flag = " ** REGRESSION" if d["regression"] else ""
                if d["regression"] or abs(d["delta_pct"]) >= 5:
                    marks.append(
                        f"  {name}: {_fmt(d['prev'])} -> "
                        f"{_fmt(d['cur'])} ({d['delta_pct']:+.1f}%)"
                        f"{flag}")
            if marks:
                print(f"\n{c['from']} -> {c['to']}:")
                print("\n".join(marks))
        if flagged:
            names = {n for c in flagged for n in c["regressions"]}
            print(f"\nREGRESSIONS past {ns.threshold * 100:.0f}%: "
                  + ", ".join(sorted(names)))
        else:
            print(f"\nno regressions past {ns.threshold * 100:.0f}% "
                  f"({'all pairs' if ns.all else 'newest round'})")
    return 1 if flagged else 0


if __name__ == "__main__":
    sys.exit(main())
