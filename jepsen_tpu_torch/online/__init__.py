"""Online linearizability checking: decide a history segment by segment.

The port of the reference's ``jepsen_tpu/online`` core:

- :mod:`segmenter`: the incremental stream consumer (quiescent cuts, the
  per-key split through ``independent``, the exact carried end-state
  sets);
- :mod:`scheduler`: the background dispatcher that co-batches ready
  segments of many keys and streams into one batched device search
  (``parallel.batch``), folds the verdicts and keeps each stream's
  monotone ``decided_through_index``, with the resilience layer's retries,
  breaker demotion and host failover.

The offline planner (``jepsen_tpu_torch.offline``) drives the scheduler
over a recorded history. A definite segmented verdict always equals the
single search's; the segmented fold may answer ``unknown`` where the
single search decides, with a typed cause (a mixed keyed/keyless stream,
a lost carry), never the opposite verdict.

The reference's :class:`OnlineMonitor` (the live monitor wired into a test
run), ``of_test`` and ``store_online`` need the test runner and the test
store, which come with later slices of the port: here they raise
``ValueError``.
"""

from __future__ import annotations

from .scheduler import DEFAULT_STREAM, SegmentScheduler  # noqa: F401
from .segmenter import (  # noqa: F401
    SINGLE_KEY,
    KeySegment,
    NonMonotoneHistoryError,
    Segmenter,
    encode_segment,
    segment_states,
)

_MONITOR_SLICE = ("the online monitor of a running test comes with a later slice of "
                  "the port (the test runner and the test store)")


class OnlineMonitor:
    """The reference's live monitor of a running test; raises ``ValueError``
    (it needs the test runner, which comes with a later slice)."""

    def __init__(self, *args, **kw):
        raise ValueError(_MONITOR_SLICE)


def of_test(test, *args, **kw):
    """The reference's monitor of a test map; raises ``ValueError``."""
    raise ValueError(_MONITOR_SLICE)


def store_online(test, *args, **kw):
    """The reference's ``online.json`` store write; raises ``ValueError``."""
    raise ValueError(_MONITOR_SLICE)


__all__ = [
    "DEFAULT_STREAM",
    "KeySegment",
    "NonMonotoneHistoryError",
    "OnlineMonitor",
    "SINGLE_KEY",
    "SegmentScheduler",
    "Segmenter",
    "encode_segment",
    "of_test",
    "segment_states",
    "store_online",
]
