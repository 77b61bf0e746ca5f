"""The backend side of the fleet's metrics federation: one scrape of a
service's live registry, served as ``GET /metrics.json``.

The port of :func:`scrape_payload` from the reference's
``jepsen_tpu/telemetry/fleet.py``. The rest of that module (the router's
federation of many backends, scrape staleness and the SLO burn rates)
comes with the scale-out router (ROADMAP item A7).
"""

from __future__ import annotations

import time as _time
from typing import Optional

# Tail of the backend event ring shipped per scrape: bounds the payload
# while keeping the recent window the utilization Gantt renders.
MAX_SCRAPE_EVENTS = 20_000


def scrape_payload(registry, *, service: Optional[str] = None,
                   max_events: int = MAX_SCRAPE_EVENTS) -> dict:
    """The backend side of one federation scrape: every metric sample,
    the help strings (so the router's merged exposition keeps them) and
    the tail of the bounded event ring (the chunk/backlog events the
    fleet utilization view reconstructs from)."""
    with registry._lock:
        helps = {n: m.help for n, m in registry._metrics.items()
                 if m.help}
    events = registry.events()
    if max_events is not None and len(events) > max_events:
        events = events[-max_events:]
    return {
        "v": 1,
        "service": service,
        "t": round(_time.time(), 3),
        "samples": registry.collect(),
        "helps": helps,
        "events": events,
    }
