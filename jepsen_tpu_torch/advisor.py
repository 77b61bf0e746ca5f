"""Config advisor: turn the observability stack's data into concrete
configuration recommendations. The port of the reference's
``jepsen_tpu/advisor.py``: the same rules, ids, severities, titles and
evidence; two rules' advice names the port's kernel library and the GPU
where the reference's names the XLA compile cache and TPU hardware, and
the cadence rule asks for a round with each change.

``python -m jepsen_tpu_torch.advisor [BENCH_r*.json ...]`` joins four data
sources the repo already produces —

- **verdict provenance** (``provenance`` blocks / cause Paretos — the
  why-unknown taxonomy of ``checker.provenance``),
- **roofline attribution** (``device_attribution`` — which chunks were
  latency- vs bandwidth-bound, ``telemetry.profile``),
- **utilization gap classes** (``gap_share`` — no-work / starved /
  host-stacking / compiling idle attribution),
- **trajectory trends** (the committed ``BENCH_r*.json`` rounds via
  ``jepsen_tpu_torch.benchcmp`` and ``store/ledger.jsonl`` via
  ``jepsen_tpu_torch.telemetry.ledger``)

— and emits recommendations like "83% of unknowns are
``overflow_top_rung`` → extend ``f_schedule``" or "idle gaps classify
as host-stacking → grow ``batch_f``". Every rule is a pure function
over those inputs, and the whole CLI is read-only: it never mutates a
store or a config.

Severity: ``high`` = verdicts are being lost to a tunable budget,
``medium`` = throughput/latency is being left on the table, ``info`` =
hygiene (baseline gaps, cadence).
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
from typing import Any, Callable, Optional

from .checker import provenance as _prov
# The alerting plane (telemetry/alerts.py) owns the operational
# predicates and their thresholds; the advisor's rules and the live
# alert rules MUST agree, so both import from the single source.
from .telemetry.alerts import (
    SLO_FAST_BURN_THRESHOLD,
    SLO_SLOW_BURN_THRESHOLD,
    TAIL_RATIO_THRESHOLD,
    journal_gap_count,
    respawn_capacity_deficit,
    slo_hot_windows,
    stale_backend_list,
    tail_is_pathological,
)

# Gap-attribution share past which an idle class is "dominating" a
# leg's device timeline and worth acting on.
GAP_SHARE_THRESHOLD = 0.25
# Provenance share past which one cause code dominates the unknowns.
CAUSE_SHARE_THRESHOLD = 0.5
# Elle engine degradations are rarer events than search unknowns; a
# persistent 20% share already means the bucket ceiling is mis-sized.
ELLE_FALLBACK_SHARE_THRESHOLD = 0.2
# Trace ingestion: any unmapped op folds its tenant unknown, so even a
# small persistent share means the adapter is leaking real traffic.
INGEST_UNMAPPED_SHARE_THRESHOLD = 0.05
# Per-backend load skew (router scale-out): the loaded backend must
# exceed BOTH an absolute floor and this ratio × the least-loaded one
# before a rebalance migration is worth its outage window — the same
# thresholds service/router.py's plan_rebalance defaults to.
REBALANCE_MIN_LOAD = 256.0
REBALANCE_SKEW_RATIO = 4.0
# A federated backend busy less than this share of the fleet window is
# underutilized — capacity the placement/rebalance policy is wasting.
UNDERUTILIZED_BACKEND_PCT = 40.0
# Offline plan skew: the largest (stream × key × segment) item's op
# count past this ratio × the mean per-worker share means one
# segment's serial decide is the wall-clock floor — more workers
# cannot help until the cut gets finer.
PLAN_SKEW_RATIO = 2.0


# ---------------------------------------------------------------------------
# Input gathering (pure walks over the bench/round dicts).


def collect_provenance(doc: Any) -> dict[str, int]:
    """Union every ``provenance`` block's cause counts found anywhere
    in a bench/result document."""
    counts: dict[str, int] = {}

    def walk(d: Any) -> None:
        if isinstance(d, dict):
            prov = d.get("provenance")
            if isinstance(prov, dict) and isinstance(
                    prov.get("causes"), dict):
                for code, n in prov["causes"].items():
                    if isinstance(n, (int, float)):
                        counts[code] = counts.get(code, 0) + int(n)
            for k, v in d.items():
                if k != "provenance":
                    walk(v)
        elif isinstance(d, list):
            for v in d:
                walk(v)

    walk(doc)
    return counts


def collect_gap_shares(doc: Any) -> dict[str, float]:
    """Max share per idle-gap class across every ``gap_share`` /
    ``gap_attribution_share`` block in the document (max, not mean: one
    leg's pathology should not be averaged away by quiet legs)."""
    shares: dict[str, float] = {}

    def walk(d: Any) -> None:
        if isinstance(d, dict):
            for key in ("gap_share", "device_gap_share",
                        "gap_attribution_share"):
                g = d.get(key)
                if isinstance(g, dict):
                    for cls, v in g.items():
                        if isinstance(v, (int, float)):
                            shares[cls] = max(shares.get(cls, 0.0),
                                              float(v))
            for v in d.values():
                walk(v)
        elif isinstance(d, list):
            for v in d:
                walk(v)

    walk(doc)
    return shares


def collect_skipped_legs(doc: Any) -> list[str]:
    """Leg names whose section reports ``{"skipped": ...}`` (budget,
    device_slow_guard, unreachable backend)."""
    out = []
    for name, v in (doc.items() if isinstance(doc, dict) else ()):
        if isinstance(v, dict) and v.get("skipped"):
            out.append(f"{name} ({v['skipped']})")
        elif isinstance(v, dict):
            out.extend(f"{name}.{s}" for s in collect_skipped_legs(v))
    return out


def collect_backend_loads(doc: Any) -> dict[str, float]:
    """Per-backend load from every ``backend_loads`` block in the
    document (the router bench leg / Router.stats() embed them):
    backend -> load in scheduler-backlog units (max across
    occurrences — one leg's skew must not be averaged away)."""
    loads: dict[str, float] = {}

    def _load_of(v: Any) -> Optional[float]:
        if isinstance(v, (int, float)):
            return float(v)
        if isinstance(v, dict):
            x = v.get("load")
            if isinstance(x, (int, float)):
                return float(x)
        return None

    def walk(d: Any) -> None:
        if isinstance(d, dict):
            bl = d.get("backend_loads")
            if isinstance(bl, dict):
                for name, v in bl.items():
                    x = _load_of(v)
                    if x is not None:
                        loads[name] = max(loads.get(name, 0.0), x)
            for k, v in d.items():
                if k != "backend_loads":
                    walk(v)
        elif isinstance(d, list):
            for v in d:
                walk(v)

    walk(doc)
    return loads


def collect_fleet(doc: Any) -> dict:
    """The worst fleet-capacity block (``fleet``) found anywhere in
    the document — the router bench leg / ``Router.stats()`` embed
    them: configured vs live backend counts plus the supervision
    state (respawn disabled / gave up). "Worst" = the largest
    capacity deficit; a healthy block must not average away a
    degraded one."""
    worst: dict = {}

    def _deficit(f: dict) -> int:
        c, l = f.get("configured_backends"), f.get("live_backends")
        if isinstance(c, int) and isinstance(l, int):
            return c - l
        return -1

    def walk(d: Any) -> None:
        nonlocal worst
        if isinstance(d, dict):
            f = d.get("fleet")
            if isinstance(f, dict) and _deficit(f) > _deficit(worst):
                worst = dict(f)
            for k, v in d.items():
                if k != "fleet":
                    walk(v)
        elif isinstance(d, list):
            for v in d:
                walk(v)

    walk(doc)
    return worst


def collect_plan_skew(doc: Any) -> dict:
    """The most skewed offline plan-stats block (``planner.Plan.
    stats()`` shape: ``largest_item_ops`` + ``mean_worker_share_ops``)
    found anywhere in the document — the offline bench leg and the
    CLI result both embed one. "Most skewed" = largest tail/share
    ratio; a balanced plan must not mask a skewed one."""
    worst: dict = {}

    def _ratio(d: dict) -> float:
        tail, share = d.get("largest_item_ops"), \
            d.get("mean_worker_share_ops")
        if isinstance(tail, (int, float)) and \
                isinstance(share, (int, float)) and share > 0:
            return float(tail) / float(share)
        return -1.0

    def walk(d: Any) -> None:
        nonlocal worst
        if isinstance(d, dict):
            if _ratio(d) > _ratio(worst):
                worst = dict(d)
            for v in d.values():
                walk(v)
        elif isinstance(d, list):
            for v in d:
                walk(v)

    walk(doc)
    return worst


def _latency_tails(doc: Any) -> list[tuple[str, float, float]]:
    """(leg, p50, p99) for every decision-latency summary present."""
    out = []
    for leg in ("online_10k", "service_streams"):
        d = doc.get(leg) if isinstance(doc, dict) else None
        if not isinstance(d, dict):
            continue
        p50 = d.get("p50_decision_latency_s")
        p99 = d.get("p99_decision_latency_s")
        if isinstance(p50, (int, float)) and isinstance(
                p99, (int, float)) and p50 > 0:
            out.append((leg, float(p50), float(p99)))
    return out


# ---------------------------------------------------------------------------
# Rules: each is (id, fn(ctx) -> Optional[recommendation dict]).
# ctx = {"bench": newest round dict, "rounds": benchcmp merged rounds,
#        "comparisons": newest adjacent benchcmp delta block or None,
#        "ledger": ledger records}.


def _share(counts: dict[str, int], *codes: str) -> float:
    total = sum(counts.values())
    return (sum(counts.get(c, 0) for c in codes) / total) if total else 0.0


def rule_extend_f_schedule(ctx: dict) -> Optional[dict]:
    counts = ctx["provenance"]
    share = _share(counts, "overflow_top_rung", "beam_loss",
                   "escalation_budget")
    if share < CAUSE_SHARE_THRESHOLD or not counts:
        return None
    return {
        "severity": "high",
        "title": "unknowns are capacity-bound — extend the frontier "
                 "schedule",
        "advice": "the dominant unknown causes are frontier-capacity "
                  "exhaustion (overflow_top_rung / beam_loss / "
                  "escalation_budget): extend `f_schedule` past its "
                  "top rung (or raise `f_total` / `max_escalations` "
                  "for the sharded driver) so the search can keep "
                  "escalating losslessly instead of giving up",
        "evidence": {"share_pct": round(share * 100, 1),
                     "causes": counts},
    }


def rule_raise_max_configs(ctx: dict) -> Optional[dict]:
    counts = ctx["provenance"]
    share = _share(counts, "max_configs", "carry_lost")
    if share < CAUSE_SHARE_THRESHOLD or not (
            counts.get("max_configs") or counts.get("carry_lost")):
        return None
    # carry_lost cascades from an initial enumeration-budget trip: the
    # root fix is the same knob.
    return {
        "severity": "high",
        "title": "unknowns are enumeration-budget-bound — raise "
                 "max_configs",
        "advice": "the dominant unknown causes are `max_configs` trips "
                  "and the `carry_lost` cascade they trigger (a key "
                  "whose carry is lost folds every later segment "
                  "unknown): raise `max_configs` on the "
                  "checker/monitor/service so enumeration completes "
                  "and carries survive",
        "evidence": {"share_pct": round(share * 100, 1),
                     "causes": counts},
    }


def rule_elle_device_fallbacks(ctx: dict) -> Optional[dict]:
    counts = ctx["provenance"]
    share = _share(counts, "elle_bucket_ceiling", "elle_device_oom")
    if share <= ELLE_FALLBACK_SHARE_THRESHOLD:
        return None
    return {
        "severity": "medium",
        "title": "elle cycle engine keeps falling back to the host "
                 "path — raise the bucket ceiling",
        "advice": "a persistent share of verdict causes is elle engine "
                  "degradations (`elle_bucket_ceiling` / "
                  "`elle_device_oom`): dependency graphs outgrow the "
                  "batched engine's largest size bucket or its "
                  "dispatches keep failing, so cycle checks pay the "
                  "host Tarjan/BFS price. Raise the bucket ceiling "
                  "(jepsen_tpu_torch/elle/ops.py BUCKETS) or provide a mesh "
                  "so big graphs take the block-row sharded closure "
                  "instead of degrading",
        "evidence": {"share_pct": round(share * 100, 1),
                     "causes": counts},
    }


def rule_grow_batch_f(ctx: dict) -> Optional[dict]:
    shares = ctx["gap_shares"]
    v = shares.get("host-stacking", 0.0)
    if v <= GAP_SHARE_THRESHOLD:
        return None
    return {
        "severity": "medium",
        "title": "idle gaps classify as host-stacking — grow batch_f",
        "advice": "devices idle while the host stacks the next "
                  "bucket's tables: grow `batch_f` (fewer, larger "
                  "rungs amortize the stacking) or widen the "
                  "double-buffered build window",
        "evidence": {"host_stacking_share": v, "gap_shares": shares},
    }


def rule_feed_starved(ctx: dict) -> Optional[dict]:
    shares = ctx["gap_shares"]
    v = shares.get("starved", 0.0)
    if v <= GAP_SHARE_THRESHOLD:
        return None
    return {
        "severity": "medium",
        "title": "devices starve with backlog present — feed wider "
                 "rounds",
        "advice": "devices sat idle while undecided segments were "
                  "backlogged: raise `max_inflight_segments` / "
                  "`max_ready_per_tenant` so dispatch rounds fill, or "
                  "add tenants/keys so the co-batching scheduler has "
                  "independent members to pack",
        "evidence": {"starved_share": v, "gap_shares": shares},
    }


def rule_prewarm_compiles(ctx: dict) -> Optional[dict]:
    shares = ctx["gap_shares"]
    v = shares.get("compiling", 0.0)
    if v <= GAP_SHARE_THRESHOLD:
        return None
    return {
        "severity": "medium",
        "title": "idle gaps classify as compiling — pre-warm the "
                 "kernel cache",
        "advice": "a large idle share is kernel builds: pre-warm the "
                  "capacity buckets the workload actually uses (run a "
                  "tiny history through each rung first) and keep the "
                  "kernel library's build directory "
                  "(jepsen_tpu_torch/_build/) across runs",
        "evidence": {"compiling_share": v, "gap_shares": shares},
    }


def rule_device_baseline_missing(ctx: dict) -> Optional[dict]:
    skipped = ctx["skipped_legs"]
    dev = [s for s in skipped if "device_slow_guard" in s
           or "budget" in s]
    if not dev:
        return None
    return {
        "severity": "info",
        "title": "device legs skipped — the round has no device "
                 "baseline",
        "advice": "this round's device legs were skipped (CPU-only box "
                  "behind `BENCH_DEVICE_SLOW_S`, or budget): run one "
                  "round on the GPU with the guard unset so "
                  "benchcmp and the ledger regain device/utilization "
                  "baselines",
        "evidence": {"skipped": dev},
    }


def rule_round_cadence(ctx: dict) -> Optional[dict]:
    rounds = ctx["rounds"]
    if len(rounds) < 2:
        return None
    import re

    nums = []
    for r in rounds:
        m = re.match(r"r(\d+)$", r.get("label") or "")
        if m:
            nums.append(int(m.group(1)))
    if len(nums) < 2 or nums[-1] - nums[-2] <= 1:
        return None
    return {
        "severity": "info",
        "title": "bench-round cadence gap — intermediate rounds were "
                 "never committed",
        "advice": f"the committed trajectory jumps r{nums[-2]:02d} → "
                  f"r{nums[-1]:02d}: commit a BENCH round with each "
                  "change so benchcmp and the ledger gate regressions "
                  "at change granularity instead of epoch granularity",
        "evidence": {"labels": [r["label"] for r in rounds]},
    }


def rule_trend_regressions(ctx: dict) -> Optional[dict]:
    cmpb = ctx["comparison"]
    if not cmpb or not cmpb.get("regressions"):
        return None
    return {
        "severity": "medium",
        "title": "trajectory regressions vs the previous committed "
                 "round",
        "advice": "metrics regressed past the gate threshold between "
                  f"{cmpb.get('from')} and {cmpb.get('to')}: "
                  + ", ".join(cmpb["regressions"])
                  + " — bisect with `python -m jepsen_tpu_torch.benchcmp` "
                    "and the per-leg ledger trend "
                    "(`python -m jepsen_tpu_torch.ledger`)",
        "evidence": {k: cmpb.get(k)
                     for k in ("from", "to", "regressions")},
    }


def rule_failover_review(ctx: dict) -> Optional[dict]:
    counts = ctx["provenance"]
    hit = {c: counts[c] for c in
           ("failover_exhausted", "worker_died", "round_failed")
           if counts.get(c)}
    if not hit:
        return None
    return {
        "severity": "high",
        "title": "verdicts lost to pipeline faults, not budgets",
        "advice": "unknowns were caused by failed rounds / exhausted "
                  "failover / a dead worker — these are infrastructure "
                  "faults, not tuning: check device health and the "
                  "circuit-breaker counters (`circuit_state`, "
                  "`wgl_retry_total`), and confirm "
                  "`JEPSEN_NO_FAILOVER` is unset",
        "evidence": {"causes": hit},
    }


def rule_journal_durability(ctx: dict) -> Optional[dict]:
    gaps = journal_gap_count(ctx["provenance"])
    if not gaps:
        return None
    return {
        "severity": "high",
        "title": "journal gaps detected — durability is losing "
                 "verdicts across restarts",
        "advice": "replay found swallowed journal appends "
                  "(journal_gap): the restored folds are pinned off "
                  "definite-True. Check disk space/health under "
                  "--journal-dir and consider --journal-fsync",
        "evidence": {"journal_gap": gaps},
    }


def rule_rebalance_tenants(ctx: dict) -> Optional[dict]:
    loads = ctx["backend_loads"]
    if len(loads) < 2:
        return None
    names = sorted(loads)
    src = max(names, key=lambda n: loads[n])
    dst = min(names, key=lambda n: loads[n])
    mx, mn = loads[src], loads[dst]
    if src == dst or mx < REBALANCE_MIN_LOAD \
            or mx < REBALANCE_SKEW_RATIO * (mn + 1.0):
        return None
    return {
        "severity": "medium",
        "title": "per-backend load skew — rebalance tenants across "
                 "backends",
        "advice": f"backend {src!r} carries {mx:.0f} load units "
                  f"(backlog + queued ops + weighted journal lag) vs "
                  f"{mn:.0f} on {dst!r}: enable the router's "
                  "load-adaptive rebalancing (RouterConfig.rebalance) "
                  "or migrate the heaviest tenant off the hot backend "
                  "(`POST /migrate/<tenant>?target=…`) — the verdict "
                  "journal makes the move lossless",
        "evidence": {"loads": loads, "src": src, "dst": dst,
                     "ratio": round(mx / (mn + 1.0), 1)},
    }


def rule_respawn_backend(ctx: dict) -> Optional[dict]:
    """Fleet running below its configured N with the self-healing
    layer out of play (respawn disabled, or the flap circuit gave up)
    — mirrored against the router's own supervision policy the way
    `rebalance_tenants` mirrors `plan_rebalance`: while the
    supervisor is still working on a respawn the advisor stays quiet
    (the fleet is healing itself), exactly as the router does."""
    deficit = respawn_capacity_deficit(ctx["fleet"])
    if deficit is None:
        return None  # the supervisor is on it; no operator action yet
    conf = deficit["configured_backends"]
    live = deficit["live_backends"]
    disabled = deficit["respawn_disabled"]
    gave_up = deficit["respawn_gave_up"]
    what = []
    if disabled:
        what.append("respawn is disabled (JEPSEN_NO_RESPAWN / "
                    "RouterConfig.respawn=False)")
    if gave_up:
        what.append("the flap-damping circuit gave up on "
                    + ", ".join(repr(n) for n in gave_up))
    return {
        "severity": "high",
        "title": "fleet below configured capacity — respawn is not "
                 "going to restore it",
        "advice": f"the fleet runs {live}/{conf} backends and "
                  + "; ".join(what)
                  + " — investigate why the backend keeps dying "
                    "(its journal dir is intact; a respawn re-binds "
                    "it), then re-enable respawn or restart the "
                    "router so the supervisor re-arms; until then "
                    "every verdict rides the survivors at reduced "
                    "capacity",
        "evidence": {"configured_backends": conf,
                     "live_backends": live,
                     "respawn_disabled": disabled,
                     "respawn_gave_up": gave_up},
    }


def rule_slo_burn(ctx: dict) -> Optional[dict]:
    """Fleet SLO error budget burning too hot (telemetry.fleet.
    SloMonitor's multiwindow gauges, embedded by the router bench leg
    under ``fleet.slo``): the fast window alerts on a spike, the slow
    window on a sustained leak — either past its threshold is worth an
    operator's attention NOW, before the budget is gone."""
    slo = (ctx["fleet"] or {}).get("slo")
    hot = slo_hot_windows(slo)
    if not hot:
        return None
    return {
        "severity": "high",
        "title": "fleet SLO error budget is burning past its "
                 "alert thresholds",
        "advice": "the federated SLO monitor reports burn rates past "
                  f"the fast ({SLO_FAST_BURN_THRESHOLD:g}x) / slow "
                  f"({SLO_SLOW_BURN_THRESHOLD:g}x) thresholds: check "
                  "which backends the rejects/slow decides concentrate "
                  "on (fleet /metrics per-backend children), then "
                  "raise the ingestion quota / queue_limit if the "
                  "availability budget is burning, or grow fleet "
                  "capacity (backends, max_ready_per_tenant) if the "
                  "latency budget is",
        "evidence": {"hot_windows": hot,
                     "availability_target":
                         (slo or {}).get("availability_target"),
                     "latency_target_s":
                         (slo or {}).get("latency_target_s")},
    }


def rule_backend_underutilized(ctx: dict) -> Optional[dict]:
    """A live backend busy under UNDERUTILIZED_BACKEND_PCT of the
    fleet window while some other backend runs hot: paid-for capacity
    the placement policy is not using. Quiet when every backend is
    cold (the fleet is simply idle — nothing to rebalance onto)."""
    util = (ctx["fleet"] or {}).get("utilization") or {}
    pcts = {n: u.get("utilization_pct") for n, u in util.items()
            if isinstance(u, dict)
            and isinstance(u.get("utilization_pct"), (int, float))}
    if len(pcts) < 2:
        return None
    cold = {n: p for n, p in pcts.items()
            if p < UNDERUTILIZED_BACKEND_PCT}
    hot_enough = max(pcts.values()) >= UNDERUTILIZED_BACKEND_PCT
    if not cold or not hot_enough or len(cold) == len(pcts):
        return None
    return {
        "severity": "medium",
        "title": "backend(s) underutilized while the fleet has work "
                 f"(busy < {UNDERUTILIZED_BACKEND_PCT:g}%)",
        "advice": "the fleet Gantt shows "
                  + ", ".join(f"{n!r} at {p}%"
                              for n, p in sorted(cold.items()))
                  + " while the busiest backend runs at "
                  f"{max(pcts.values())}% — lower "
                  "`rebalance_min_load`/`rebalance_ratio` so the "
                  "router spreads tenants sooner, or place fewer "
                  "tenants per backend; idle capacity costs the same "
                  "as busy capacity",
        "evidence": {"utilization_pct": dict(sorted(pcts.items())),
                     "threshold_pct": UNDERUTILIZED_BACKEND_PCT},
    }


def rule_scrape_stale(ctx: dict) -> Optional[dict]:
    """Stale federation scrapes: backends whose last /metrics.json
    snapshot is older than the staleness horizon. Their series are
    frozen in every fleet total — the fleet p99 / SLO burn rates are
    blind to whatever those backends are doing NOW."""
    fleet = ctx["fleet"] or {}
    stale = stale_backend_list(fleet)
    if not stale:
        return None
    fed = fleet.get("federation") or {}
    ages = {n: (fed.get(n) or {}).get("scrape_age_s") for n in stale}
    return {
        "severity": "medium",
        "title": "fleet metrics federation has stale backends — "
                 "fleet totals are partially frozen",
        "advice": "backends "
                  + ", ".join(repr(n) for n in sorted(stale))
                  + " have not answered a /metrics.json scrape within "
                  "the staleness horizon: their last-good series "
                  "still count in the fleet totals (frozen, never "
                  "double-counted) but the fleet p99 and SLO burn "
                  "rates no longer see them — check backend health / "
                  "respawn state, and treat fleet-level verdict "
                  "latency as a lower bound until the scrapes resume",
        "evidence": {"stale_backends": sorted(stale),
                     "scrape_age_s": ages},
    }


def rule_segment_plan_skew(ctx: dict) -> Optional[dict]:
    """One offline plan item dominating the wall: the largest
    (stream × key × segment) work item carries more than
    PLAN_SKEW_RATIO × the mean per-worker op share, so its SERIAL
    decide is a lower bound on the whole run's wall clock — adding
    workers/backends past that point only grows idle capacity. The
    fix is a finer cut first, wider fan-out second."""
    plan = ctx["plan_skew"]
    tail = plan.get("largest_item_ops")
    share = plan.get("mean_worker_share_ops")
    if not isinstance(tail, (int, float)) or \
            not isinstance(share, (int, float)) or share <= 0:
        return None
    ratio = float(tail) / float(share)
    if ratio <= PLAN_SKEW_RATIO:
        return None
    return {
        "severity": "medium",
        "title": "offline plan is skew-bound — one segment's serial "
                 "tail dominates the wall",
        "advice": f"the plan's largest segment carries {tail:.0f} ops "
                  f"vs a {share:.0f}-op mean per-worker share "
                  f"({ratio:.1f}x): that item decides serially and "
                  "floors the wall clock no matter how many workers "
                  "or backends fan out — record quiescent points more "
                  "often (shorter concurrent windows, or an explicit "
                  "barrier in the workload) so the Segmenter can cut "
                  "the hot key finer, and only then add streams/"
                  "backends to absorb the extra items",
        "evidence": {"largest_item_ops": tail,
                     "mean_worker_share_ops": share,
                     "ratio": round(ratio, 1),
                     "largest_item_key": plan.get("largest_item_key"),
                     "n_streams": plan.get("n_streams")},
    }


def rule_latency_tail(ctx: dict) -> Optional[dict]:
    tails = [(leg, p50, p99) for leg, p50, p99 in ctx["latency_tails"]
             if tail_is_pathological(p50, p99)]
    if not tails:
        return None
    return {
        "severity": "medium",
        "title": "decision-latency tail is pathological "
                 f"(p99/p50 > {TAIL_RATIO_THRESHOLD:g}x)",
        "advice": "a small fraction of ops waits orders of magnitude "
                  "longer for coverage: check the watermark-stall "
                  "detector and the starved/host-stacking gap shares, "
                  "and bound per-round work with "
                  "`max_ready_per_tenant` so one flood cannot hold "
                  "every tenant's tail hostage",
        "evidence": {leg: {"p50_s": p50, "p99_s": p99,
                           "ratio": round(p99 / p50, 1)}
                     for leg, p50, p99 in tails},
    }


def rule_ingest_unmapped(ctx: dict) -> Optional[dict]:
    counts = ctx["provenance"]
    share = _share(counts, "ingest_unmapped_op")
    if share <= INGEST_UNMAPPED_SHARE_THRESHOLD:
        return None
    return {
        "severity": "medium",
        "title": "ingested traces keep leaking unmapped ops — the "
                 "adapter is not covering the recording",
        "advice": "a persistent share of verdict causes is "
                  "`ingest_unmapped_op`: trace lines the adapter could "
                  "not parse (or orphan responses whose request never "
                  "appeared) fold every affected tenant to unknown. "
                  "Fix the column mapping / adapter rules — extend the "
                  "adapter's parse table for the unrecognised "
                  "commands, correct the `jsonl` column mapping, or "
                  "widen `reorder_window_ns` if requests and responses "
                  "are recorded out of order — so the recording maps "
                  "cleanly and verdicts become definite again",
        "evidence": {"share_pct": round(share * 100, 1),
                     "unmapped": counts.get("ingest_unmapped_op", 0),
                     "causes": counts},
    }


RULES: list[tuple[str, Callable[[dict], Optional[dict]]]] = [
    ("extend_f_schedule", rule_extend_f_schedule),
    ("raise_max_configs", rule_raise_max_configs),
    ("elle_device_fallbacks", rule_elle_device_fallbacks),
    ("ingest_unmapped", rule_ingest_unmapped),
    ("failover_review", rule_failover_review),
    ("journal_durability", rule_journal_durability),
    ("respawn_backend", rule_respawn_backend),
    ("slo_burn", rule_slo_burn),
    ("grow_batch_f", rule_grow_batch_f),
    ("feed_starved", rule_feed_starved),
    ("rebalance_tenants", rule_rebalance_tenants),
    ("segment_plan_skew", rule_segment_plan_skew),
    ("backend_underutilized", rule_backend_underutilized),
    ("scrape_stale", rule_scrape_stale),
    ("prewarm_compiles", rule_prewarm_compiles),
    ("trend_regressions", rule_trend_regressions),
    ("latency_tail", rule_latency_tail),
    ("device_baseline_missing", rule_device_baseline_missing),
    ("round_cadence", rule_round_cadence),
]

_SEV_ORDER = {"high": 0, "medium": 1, "info": 2}


def advise(bench: dict, rounds: Optional[list] = None,
           comparison: Optional[dict] = None,
           ledger_records: Optional[list] = None) -> list[dict]:
    """Run every rule over one bench/result document (+ optional
    trajectory context); returns recommendations sorted most severe
    first. Pure — safe to pin closed-form in tests."""
    ctx = {
        "bench": bench or {},
        "rounds": rounds or [],
        "comparison": comparison,
        "ledger": ledger_records or [],
        "provenance": collect_provenance(bench or {}),
        "gap_shares": collect_gap_shares(bench or {}),
        "skipped_legs": collect_skipped_legs(bench or {}),
        "latency_tails": _latency_tails(bench or {}),
        "backend_loads": collect_backend_loads(bench or {}),
        "fleet": collect_fleet(bench or {}),
        "plan_skew": collect_plan_skew(bench or {}),
    }
    out = []
    for rid, fn in RULES:
        rec = fn(ctx)
        if rec is not None:
            rec["id"] = rid
            out.append(rec)
    out.sort(key=lambda r: (_SEV_ORDER.get(r["severity"], 9), r["id"]))
    return out


def render(recs: list[dict]) -> str:
    if not recs:
        return ("no recommendations — no degraded verdicts, idle "
                "pathologies or trajectory regressions in the inputs")
    lines = []
    for i, r in enumerate(recs, 1):
        lines.append(f"{i}. [{r['severity']}] {r['title']}  "
                     f"(id: {r['id']})")
        lines.append(f"   {r['advice']}")
        ev = json.dumps(r.get("evidence") or {}, sort_keys=True,
                        default=str)
        if len(ev) > 300:
            ev = ev[:297] + "..."
        lines.append(f"   evidence: {ev}")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.advisor",
        description="Join verdict provenance, roofline attribution, "
                    "utilization gap classes and bench/ledger trends "
                    "into concrete config recommendations.")
    p.add_argument("artifacts", nargs="*",
                   help="BENCH_r*.json round files (default: the "
                        "repo's committed rounds; the newest round is "
                        "advised, the rest provide trend context)")
    p.add_argument("--ledger", default=None,
                   help="ledger.jsonl path (default: the store's)")
    p.add_argument("--json", action="store_true", dest="as_json")
    ns = p.parse_args(argv)

    from . import benchcmp as _bc

    paths = ns.artifacts or sorted(
        _glob.glob(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "..",
            "BENCH_r*.json")), key=_bc.round_sort_key)
    if not paths:
        print("advisor: no bench artifacts found — pass BENCH_r*.json "
              "paths (or run from the repo)", file=sys.stderr)
        return 2
    try:
        rounds = [_bc.load_round(a) for a in
                  sorted(paths, key=_bc.round_sort_key)]
    except (OSError, ValueError) as e:
        print(f"advisor: cannot read artifacts: {e}", file=sys.stderr)
        return 2
    merged = _bc._merge_rounds(rounds)
    # Advise over the newest BENCH artifact: a same-round MULTICHIP
    # wrapper sorts after it lexically but carries no provenance /
    # gap-share / leg data — advising over it would silently blank
    # every rule.
    newest = next((r for r in reversed(rounds) if r["kind"] == "bench"),
                  rounds[-1])
    comparison = None
    if len(merged) >= 2:
        block = _bc.deltas(merged[-2]["metrics"], merged[-1]["metrics"])
        comparison = {"from": merged[-2]["label"],
                      "to": merged[-1]["label"], "deltas": block,
                      "regressions": _bc.regressions(block)}
    try:
        from .telemetry import ledger as _ledger

        ledger_records = _ledger.load(ns.ledger) if ns.ledger \
            else _ledger.load()
    except Exception:  # noqa: BLE001 - the ledger is optional context
        ledger_records = []
    recs = advise(newest["data"], rounds=merged, comparison=comparison,
                  ledger_records=ledger_records)
    if ns.as_json:
        print(json.dumps({
            "round": newest["label"],
            "recommendations": recs,
            "provenance": collect_provenance(newest["data"]),
            "gap_shares": collect_gap_shares(newest["data"]),
        }, indent=1, sort_keys=True, default=str))
    else:
        print(f"== advisor over {newest['label']} "
              f"({os.path.basename(newest['path'])}; "
              f"{len(merged)} round(s) of context)")
        print(render(recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
