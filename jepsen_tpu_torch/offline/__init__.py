"""Offline decrease-and-conquer checking of recorded histories. The port of
the reference's ``jepsen_tpu/offline``.

The online scheduler decides a history while it streams; this package
decides a fully *recorded* history by planning the same quiescent-cut /
per-key / carried-state decomposition up front (:func:`plan`) and fanning
the DAG through one multi-stream scheduler (:func:`drive`), whose rounds
co-batch many segments into one ``check_encoded_batch`` search on the
card.

Entry points: :func:`plan` + :func:`drive`, :func:`check_offline`,
``python -m jepsen_tpu_torch.offline HISTORY.ndjson`` and
``ops.wgl.check_history(..., parallel="segmented")``. The reference's
fan-out over backend service processes (``backends >= 1``,
``fanout_fleet``, ``fanout_services``) needs the checking service, which
comes with a later slice of the port: here it raises ``ValueError``.
"""

from __future__ import annotations

from typing import Any

from .driver import ENGINES, drive
from .planner import NonMonotoneHistoryError, Plan, PlanItem, plan

__all__ = ["plan", "drive", "check_offline", "fanout_services", "fanout_fleet",
           "Plan", "PlanItem", "ENGINES", "NonMonotoneHistoryError"]

_SERVICE_SLICE = ("fanning the plan over backend service processes (backends >= 1) "
                  "comes with a later slice of the port (the checking service); "
                  "use backends=0")


def fanout_fleet(*args, **kw) -> dict:
    """The reference's fan-out over N backend processes; raises
    ``ValueError`` (it needs the checking service)."""
    raise ValueError(_SERVICE_SLICE)


def fanout_services(*args, **kw) -> dict:
    """The reference's fan-out over in-process services; raises
    ``ValueError`` (it needs the checking service)."""
    raise ValueError(_SERVICE_SLICE)


def check_offline(model, history: Any, *, streams: int = 0, engine: str = "auto",
                  backends: int = 0, metrics=None, max_configs: int = 500_000,
                  **kw: Any) -> dict:
    """Plan and decide a recorded history in one call: the
    ``check_history(parallel="segmented")`` implementation.

    ``streams=0`` picks one stream per key, at most 8. Other keyword
    arguments go to :func:`drive` (``device``, ``batch_f``,
    ``max_ready_per_stream``, ``timeout``). ``backends >= 1`` raises
    ``ValueError``: the fan-out over service processes comes with a later
    slice."""
    if backends >= 1:
        raise ValueError(_SERVICE_SLICE)
    p = plan(history, streams=streams if streams >= 1 else 8)
    out = drive(p, model, engine=engine, metrics=metrics, max_configs=max_configs, **kw)
    out["parallel"] = "segmented"
    return out
