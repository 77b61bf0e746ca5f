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
- :mod:`monitor`: the live monitor of a running test
  (:class:`OnlineMonitor`), which ``core.run`` tees the interpreter's ops
  into (``of_test``) and whose result it writes as ``online.json``
  (``store_online``).

The offline planner (``jepsen_tpu_torch.offline``) drives the scheduler
over a recorded history. A definite segmented verdict always equals the
single search's; the segmented fold may answer ``unknown`` where the
single search decides, with a typed cause (a mixed keyed/keyless stream,
a lost carry), never the opposite verdict.
"""

from __future__ import annotations

from .monitor import OnlineMonitor, of_test, store_online  # noqa: F401
from .scheduler import DEFAULT_STREAM, SegmentScheduler  # noqa: F401
from .segmenter import (  # noqa: F401
    SINGLE_KEY,
    KeySegment,
    NonMonotoneHistoryError,
    Segmenter,
    encode_segment,
    segment_states,
)

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
