"""Verdict provenance: typed, machine-readable causes for degraded verdicts.

Every site that degrades a verdict to ``unknown`` attaches
``cause(code, **params)`` — a dict with ``code`` from the closed
:data:`TAXONOMY`, the owning ``layer`` and optional ``params`` — and the
scheduler's folds union the causes into per-segment, per-stream and
per-run *provenance* blocks (``{"causes": {code: count}, "dominant":
code, "total": n}``, :func:`block`). The codes and their layers are the
reference package's (including those of its service, journal and router,
which this package does not have yet; the trace ingestion's
``ingest_unmapped_op`` is set by :mod:`jepsen_tpu_torch.ingest`), so
results from either package fold the same way.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

# code -> (layer, description).
TAXONOMY: dict[str, tuple[str, str]] = {
    "overflow_top_rung": (
        "kernel",
        "frontier overflowed the capacity schedule's top rung (or "
        "escalation was disabled at the shared batch capacity)"),
    "escalation_budget": (
        "kernel",
        "lossless capacity escalations exhausted (sharded "
        "max_escalations spent without a verdict)"),
    "beam_loss": (
        "kernel",
        "lossy beam exhausted after truncation — configs were dropped, "
        "so exhaustion is not a refutation"),
    "level_budget": (
        "kernel",
        "level budget exhausted without a verdict"),
    "max_configs": (
        "host",
        "host/native enumeration config budget exhausted"),
    "oom": (
        "host",
        "native engine out of memory"),
    "encoding_unsupported": (
        "encode",
        "history/model does not fit the device encoding (plan "
        "rejected, unreadable archive, or model mismatch)"),
    "carry_lost": (
        "online",
        "carried initial-state set lost (budget-tripped enumeration, "
        "or an unknown upstream segment of the same key)"),
    "poisoned_key": (
        "online",
        "the stream's carries are poisoned (unaddressable journal key "
        "or replay poison): every later segment folds unknown"),
    "mixed_keys": (
        "online",
        "mixed keyed/keyless stream: the online split cannot match "
        "independent.subhistory, no definite verdict is safe"),
    "round_failed": (
        "scheduler",
        "a dispatch round raised; its segments fold unknown and their "
        "keys' carries are lost"),
    "worker_died": (
        "scheduler",
        "the scheduler worker died past its bounded restart; streams "
        "fold unknown"),
    "failover_exhausted": (
        "scheduler",
        "the failover host re-dispatch also failed for this member"),
    "lost_segments": (
        "service",
        "segments refused by a closed scheduler; a definite True can "
        "no longer cover the stream"),
    "undelivered_ops": (
        "service",
        "accepted ops never fed through the segmenter (drain deadline "
        "truncated the stream)"),
    "deadline": (
        "service",
        "a deadline truncated decision coverage (close/drain timed "
        "out with work in flight)"),
    "journal_gap": (
        "journal",
        "journal replay detected swallowed appends (seq gap); the "
        "restored fold is pinned off definite-True"),
    "backend_lost": (
        "router",
        "a backend service process was lost; the tenant restored from "
        "its journal checkpoint (anything undecided and unjournaled "
        "degrades to unknown — with no usable journal the whole "
        "stream does)"),
    "migration_interrupted": (
        "router",
        "a tenant migration failed partway (adopt refused, target "
        "unreachable, or JEPSEN_NO_MIGRATION); the tenant is orphaned "
        "and folds unknown until a later migration succeeds"),
    "elle_bucket_ceiling": (
        "elle",
        "a dependency graph outgrew the batched cycle engine's largest "
        "size bucket with no mesh available for the sharded closure; "
        "the verdict folded to the host Tarjan/BFS path"),
    "elle_device_oom": (
        "elle",
        "a batched/sharded closure dispatch kept failing past the "
        "chunk-halving escalation budget (an out-of-memory on CPU "
        "tensors, or an injected fault on any device; a real "
        "out-of-memory on a GPU raises instead); the verdict folded to "
        "the host Tarjan/BFS path"),
    "ingest_unmapped_op": (
        "ingest",
        "a recorded trace line (or parsed op) no adapter rule or "
        "workload model explains; the op was dropped from the checked "
        "history, so no definite verdict can cover the recording — the "
        "fold is one-sidedly unknown, never a flip"),
    "chaos": (
        "testing",
        "an injected chaos fault was the proximate cause"),
    "unattributed": (
        "unknown",
        "an unknown reached the fold with no structured cause"),
}


# Bounded per-row cause list (the per-stream counts stay exact).
MAX_CAUSES_PER_ROW = 8


def cause(code: str, **params: Any) -> dict:
    """One typed cause; ``code`` must be in the closed :data:`TAXONOMY`."""
    try:
        layer, _desc = TAXONOMY[code]
    except KeyError:
        raise ValueError(
            f"unknown provenance code {code!r}; the taxonomy is closed "
            f"(known: {sorted(TAXONOMY)})") from None
    c: dict = {"code": code, "layer": layer}
    if params:
        c["params"] = params
    return c


def attach(result: dict, code: str, **params: Any) -> dict:
    """Attach one cause to a result dict (under ``"causes"``) and return it."""
    result.setdefault("causes", []).append(cause(code, **params))
    return result


def of(result: Optional[dict]) -> list[dict]:
    """The causes attached to a result dict (never None)."""
    if not isinstance(result, dict):
        return []
    cs = result.get("causes")
    return list(cs) if isinstance(cs, list) else []


def ensure(causes: list[dict], **params: Any) -> list[dict]:
    """Backstop: an unknown with no structured cause gets ``unattributed``."""
    return causes if causes else [cause("unattributed", **params)]


def annotate(causes: Iterable[dict], **params: Any) -> list[dict]:
    """Copies of ``causes`` with ``params`` merged into each one's params
    (existing keys win); copies, because cause dicts are shared through
    member result maps."""
    out = []
    for c in causes:
        if not isinstance(c, dict):
            continue
        merged = dict(c.get("params") or {})
        for k, v in params.items():
            merged.setdefault(k, v)
        c2 = {k: v for k, v in c.items() if k != "params"}
        if merged:
            c2["params"] = merged
        out.append(c2)
    return out


def add_counts(counts: dict, causes: Iterable[Any]) -> dict:
    """Fold causes (dicts or bare codes) into a ``{code: n}`` map."""
    for c in causes:
        code = c.get("code") if isinstance(c, dict) else c
        if isinstance(code, str):
            counts[code] = counts.get(code, 0) + 1
    return counts


def merge_counts(*maps: Optional[dict]) -> dict:
    out: dict = {}
    for m in maps:
        for code, n in (m or {}).items():
            if isinstance(n, (int, float)):
                out[code] = out.get(code, 0) + int(n)
    return out


def dominant(counts: Optional[dict]) -> Optional[str]:
    """The most frequent code (ties break lexically), or None."""
    if not counts:
        return None
    return min(counts, key=lambda c: (-counts[c], c))


def block(counts: Optional[dict]) -> Optional[dict]:
    """The ``provenance`` block of a result, or None when nothing degraded."""
    if not counts:
        return None
    return {"causes": {c: int(n) for c, n in sorted(counts.items())},
            "dominant": dominant(counts), "total": int(sum(counts.values()))}


def pareto(counts: Optional[dict]) -> list[dict]:
    """Display rows, most frequent first: code, layer, count, share."""
    counts = counts or {}
    total = sum(counts.values()) or 1
    rows = []
    for code in sorted(counts, key=lambda c: (-counts[c], c)):
        layer, desc = TAXONOMY.get(code, ("?", "(unregistered code)"))
        rows.append({"code": code, "layer": layer, "count": counts[code],
                     "share": round(counts[code] / total, 4), "description": desc})
    return rows


_METRIC_HELP = ("Degraded-verdict causes by taxonomy code (see "
                "docs/verdicts.md); tenant=\"\" for non-service paths, "
                "unlabeled = all codes and tenants")


def count_metric(metrics, causes, tenant: str = "") -> None:
    """Increment ``verdict_causes_total{code,tenant}`` (and the aggregate
    unlabeled total) for each cause. No-op without a registry; never raises
    into a fold."""
    if metrics is None:
        return
    try:
        c = metrics.counter("verdict_causes_total", _METRIC_HELP,
                            labelnames=("code", "tenant"), aggregate=True)
        for item in causes:
            code = item.get("code") if isinstance(item, dict) else item
            if not isinstance(code, str):
                continue
            c.inc()  # the unlabeled total
            c.labels(code=code, tenant=str(tenant)).inc()
    except Exception:  # noqa: BLE001 - observability never sinks a fold
        pass
