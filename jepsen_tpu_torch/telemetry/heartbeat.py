"""Progress heartbeat for long checks.

A copy of the reference's ``jepsen_tpu/telemetry/heartbeat.py``. Knossos
prints "checking... 43%" while its search grinds; the reference surfaces
nothing at all once the checker starts (failed analyses "can take hours",
checker.clj:210-213). The WGL device driver calls a
``chunk_callback(info)`` after every chunk with ``level`` /
``total_levels`` / ``F`` / ``frontier_max`` / ``count`` / ``wall_s``;
:class:`Heartbeat` is a rate-limited callback that turns those into a
periodic log line with percentage and ETA, and (optionally) mirrors them
into a telemetry registry so a live scrape sees the same numbers.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Optional

LOG = logging.getLogger("jepsen.telemetry")


class Heartbeat:
    """Rate-limited progress reporter usable as a WGL ``chunk_callback``.

    ``total``: fallback level count when the info dict carries none.
    ``interval_s``: minimum seconds between log lines (0 ⇒ every chunk).
    ``registry``: optional telemetry Registry to mirror progress gauges
    into (``wgl_progress_level``, ``wgl_progress_percent``,
    ``wgl_eta_seconds``).
    """

    def __init__(self, total: Optional[int] = None,
                 interval_s: float = 10.0, label: str = "linearizability",
                 log: Optional[logging.Logger] = None, registry=None):
        self.total = total
        self.interval_s = interval_s
        self.label = label
        self.log = log or LOG
        self.registry = registry
        self._t0 = _time.monotonic()
        self._last: Optional[float] = None
        self.beats = 0

    def __call__(self, info: dict) -> None:
        now = _time.monotonic()
        # The first chunk always beats; later ones are rate-limited.
        if self.interval_s and self._last is not None \
                and now - self._last < self.interval_s:
            return
        self._last = now
        self.beats += 1
        level = int(info.get("level") or 0)
        total = int(info.get("total_levels") or self.total or 0)
        wall = float(info.get("wall_s") or (now - self._t0))
        parts = [f"level {level}"]
        pct = None
        eta = None
        if total > 0:
            pct = min(100.0, 100.0 * level / total)
            parts[0] = f"level {level}/{total}"
        if level > 0 and total > level:
            eta = wall / level * (total - level)
            parts.append(f"ETA {eta:.0f}s")
        if info.get("count") is not None:
            parts.append(f"frontier {int(info['count'])}")
        if info.get("F") is not None:
            parts.append(f"F={int(info['F'])}")
        pct_s = f" {pct:.0f}%" if pct is not None else ""
        self.log.info("checking %s...%s (%s, %.1fs elapsed)",
                      self.label, pct_s, ", ".join(parts), wall)
        if self.registry is not None:
            g = self.registry.gauge
            g("wgl_progress_level",
              "Current BFS level of the running check").set(level)
            if pct is not None:
                g("wgl_progress_percent",
                  "Progress of the running check").set(round(pct, 2))
            if eta is not None:
                g("wgl_eta_seconds",
                  "Estimated seconds to verdict at current rate").set(
                      round(eta, 1))
