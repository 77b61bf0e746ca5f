"""Human-readable anomaly files in the run directory.

The port of the reference's ``jepsen_tpu/elle/explain.py``. Jepsen passes
``:directory (store/path test "elle")`` into Elle's check, so a failed
analysis leaves explanation files beside the run's other files
(cycle/append.clj:19-21, Elle's ``<anomaly>.txt`` layout). On any
non-clean verdict this renders each anomaly's witnesses (cycle witnesses
as a walk T0..Tn with the dependency kind of every step, direct anomalies
as field dumps) into
``store/<name>/<time>/[subdir/]elle/<anomaly>.txt``.
"""

from __future__ import annotations

from typing import Any, Optional

from .. import store


def _render_cycle(i: int, w: dict) -> list[str]:
    lines = [f"Cycle {i}:"]
    cycle = w.get("cycle") or []
    txns = w.get("txns") or []
    kinds = w.get("kinds") or []
    # Witness cycles are closed (the first node repeated at the end,
    # elle/__init__.py _witness); render each transaction ONCE and let
    # the final edge wrap back to T0.
    if len(cycle) > 1 and cycle[0] == cycle[-1]:
        cycle = cycle[:-1]
    for j, node in enumerate(cycle):
        txn = txns[j] if j < len(txns) else f"txn #{node}"
        lines.append(f"  T{j} = {txn}")
    lines.append("")
    lines.append("  Then:")
    for j, ks in enumerate(kinds):
        a, b = j, (j + 1) % len(cycle) if cycle else 0
        kind = "+".join(ks) if ks else "?"
        reason = {
            "ww": "its write precedes the other's write of the same key",
            "wr": "the second txn read this txn's write",
            "rw": "it read a state the other txn overwrote",
            "realtime": "it completed before the other began (real time)",
            "process": "the same process ran it first",
        }
        why = " & ".join(reason.get(k, k) for k in ks) if ks else "edge"
        lines.append(f"    T{a} < T{b}\t[{kind}: {why}]")
    lines.append("  T0 is ordered before itself: these transactions "
                 "cannot be serialized.")
    return lines


def _render_direct(i: int, w: Any) -> list[str]:
    if isinstance(w, dict):
        body = [f"  {k}: {v}" for k, v in sorted(w.items(), key=str)]
    else:
        body = [f"  {w}"]
    return [f"Witness {i}:", *body]


def render_anomaly(name: str, witnesses: list) -> str:
    """One anomaly's explanation file content."""
    n = len(witnesses)
    out = [f"{name} ({n} witness{'es' if n != 1 else ''})", ""]
    for i, w in enumerate(witnesses):
        if isinstance(w, dict) and "cycle" in w:
            out.extend(_render_cycle(i, w))
        else:
            out.extend(_render_direct(i, w))
        out.append("")
    return "\n".join(out)


def write_anomalies(test: dict, res: dict,
                    subdirectory: Optional[Any] = None) -> Optional[list]:
    """Write ``elle/<anomaly>.txt`` explanation files for a non-clean
    elle result under the run's store directory (the reference's
    ``:directory`` behavior, cycle/append.clj:19-21).  No-op (returns
    None) for clean results or store-less runs; otherwise returns the
    written paths and records them in ``res["directory"]``."""
    anomalies = res.get("anomalies") or {}
    if res.get("valid") is True or not anomalies:
        return None
    if not store.wanted(test):
        return None
    # Diagnostics never mask the verdict: an unwritable store must not
    # turn a FOUND anomaly into {"valid": "unknown"} via check_safe
    # (the checker/__init__.py witness-file convention).
    try:
        parts = [str(subdirectory)] if subdirectory else []
        written = []
        for name, witnesses in sorted(anomalies.items()):
            path = store.path_mk(test, *parts, "elle", f"{name}.txt")
            path.write_text(render_anomaly(name, list(witnesses)))
            written.append(path)
        if written:
            res["directory"] = str(written[0].parent)
        return written
    except Exception as e:  # noqa: BLE001 - report, don't raise
        res["directory_error"] = f"{type(e).__name__}: {e}"
        return None
