"""Verdict provenance: typed, machine-readable causes for degraded verdicts.

Every site that degrades a verdict to ``unknown`` attaches
``cause(code, **params)`` — a dict with ``code`` from the closed
:data:`TAXONOMY`, the owning ``layer`` and optional ``params``. This copy
carries the codes the device searches (single and batched), the native C
search and the Elle cycle engine emit; the codes and their layers are the
reference package's, so results from either package fold the same way.
"""

from __future__ import annotations

from typing import Any, Optional

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
    "elle_bucket_ceiling": (
        "elle",
        "a dependency graph outgrew the batched cycle engine's largest "
        "size bucket with no mesh available for the sharded closure; "
        "the verdict folded to the host Tarjan/BFS path"),
    "elle_device_oom": (
        "elle",
        "a batched closure dispatch on CPU tensors kept running out of "
        "memory (torch.OutOfMemoryError) past the chunk-halving "
        "escalation budget; the verdict folded to the host Tarjan/BFS "
        "path (on a GPU the engine raises instead)"),
    "unattributed": (
        "unknown",
        "an unknown reached the fold with no structured cause"),
}


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
