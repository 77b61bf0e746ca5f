"""Offline decrease-and-conquer checking of recorded histories. The port of
the reference's ``jepsen_tpu/offline``.

The online scheduler decides a history while it streams; this package
decides a fully *recorded* history by planning the same quiescent-cut /
per-key / carried-state decomposition up front (:func:`plan`) and fanning
the resulting DAG across three axes:

1. one multi-stream scheduler (:func:`drive`), whose rounds co-batch many
   segments into one ``check_encoded_batch`` search on the card,
2. the sharded mesh (``engine="sharded"``), and
3. the backend fleet: the plan's streams as synthetic tenants of N
   in-process services (:func:`fanout_services`) or of N backend service
   processes behind the tenant router (:func:`fanout_fleet`).

Entry points: :func:`plan` + :func:`drive`, :func:`check_offline`,
``python -m jepsen_tpu_torch.offline HISTORY.ndjson`` and
``ops.wgl.check_history(..., parallel="segmented")``. Every path decides
on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any

from .driver import ENGINES, drive
from .fanout import fanout_fleet, fanout_services
from .planner import NonMonotoneHistoryError, Plan, PlanItem, plan

__all__ = ["plan", "drive", "check_offline", "fanout_services", "fanout_fleet",
           "Plan", "PlanItem", "ENGINES", "NonMonotoneHistoryError"]


def check_offline(model, history: Any, *, streams: int = 0, engine: str = "auto",
                  backends: int = 0, metrics=None, max_configs: int = 500_000,
                  **kw: Any) -> dict:
    """Plan and decide a recorded history in one call: the
    ``check_history(parallel="segmented")`` implementation.

    ``streams=0`` picks one stream per key, at most 8. ``backends=0``
    decides in-process through the shared scheduler; other keyword
    arguments go to :func:`drive` (``device``, ``batch_f``,
    ``max_ready_per_stream``, ``timeout``). ``backends >= 1`` fans the
    streams across that many backend service processes through
    :func:`fanout_fleet`, which takes the other keyword arguments
    (``device``, ``chunk_ops``, ``drain_timeout``, ``env``,
    ``journal_root``)."""
    p = plan(history, streams=streams if streams >= 1 else 8)
    if backends >= 1:
        # Backend services speak auto/device/host; the mesh-sharded
        # oracle is a single-process engine, so it maps to device.
        svc_engine = "device" if engine == "sharded" else engine
        out = fanout_fleet(p, backends=backends, model=model.name, engine=svc_engine,
                           max_configs=max_configs, metrics=metrics, **kw)
    else:
        out = drive(p, model, engine=engine, metrics=metrics, max_configs=max_configs, **kw)
    out["parallel"] = "segmented"
    return out
