"""One-pass segment planner for fully recorded histories. The port of the
reference's ``jepsen_tpu/offline/planner.py``.

The online scheduler finds segments as a stream arrives; offline the WHOLE
history is at hand, so the same cut rules (quiescent cuts, per-key splits,
exact carried end-state sets) run as one planning pass that emits a static
DAG of (stream x key x segment) work items:

- **across keys**: the keys' chains never depend on each other, so the
  planner spreads the keys over N *streams* (greedy largest-first bin
  packing on op counts), and each stream decides independently;
- **across segments of one key**: segment k+1 needs segment k's carried
  end states, so a key's chain is sequential, but many keys' ready
  segments co-batch into one device search (``offline.driver``);
- **across carried states**: each item fans into one batch member per
  carried initial state at encode time.

Planning runs the online :class:`~jepsen_tpu_torch.online.segmenter.Segmenter`
in strict mode (a non-monotone indexed input raises
:class:`~jepsen_tpu_torch.online.segmenter.NonMonotoneHistoryError`), so
the offline cuts are the ones the online scheduler would make.

The scheduler's per-stream watermark walks seq numbers from 0 without
gaps, but a stream that owns some keys sees only the cuts its keys appear
in, so the planner renumbers each stream's cuts into a dense stream-local
``seq`` (``PlanItem.global_seq`` keeps the original ordinal).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Optional

from .. import independent as ind
from ..history import History, Op
from ..online.segmenter import (SINGLE_KEY, KeySegment,
                                NonMonotoneHistoryError, Segmenter)

__all__ = ["Plan", "PlanItem", "plan", "NonMonotoneHistoryError"]


@dataclass(frozen=True)
class PlanItem:
    """One (stream × key × segment) node of the static decision DAG."""

    stream: str
    key: Any
    seq: int  # stream-local segment ordinal (dense from 0 per stream)
    global_seq: int  # the segmenter's cut ordinal over the whole history
    segment: KeySegment  # .seq already renumbered to the stream-local seq
    # Stream-local seq of this key's previous segment (the carry edge),
    # None for the key's first segment (carry = the model's init state).
    depends_on: Optional[int] = None

    @property
    def n_ops(self) -> int:
        return self.segment.n_ops


@dataclass
class Plan:
    """The planner's output: per-stream item chains plus the fan-out
    bookkeeping the driver and the fleet fan-out (``offline.fanout``)
    read."""

    items: list[PlanItem] = field(default_factory=list)
    # stream name -> its items in stream-local seq order.
    streams: dict = field(default_factory=dict)
    # stream name -> the ORIGINAL client ops of its keys, index order,
    # [k v] values intact — what fanout feeds the fleet as synthetic
    # tenants (the backends re-run these exact cut rules server-side).
    stream_ops: dict = field(default_factory=dict)
    key_to_stream: dict = field(default_factory=dict)
    n_ops: int = 0  # client ops planned
    n_cuts: int = 0  # global quiescent segments
    n_keys: int = 0
    plan_seconds: float = 0.0
    mixed: bool = False  # keyed/keyless mix: no sound per-key split
    poisoned: bool = False  # an :info ended quiescence mid-history
    dropped_nemesis: int = 0  # non-client ops (no invoke/ok discipline)
    largest_item_ops: int = 0
    largest_item_key: Any = None

    @property
    def n_items(self) -> int:
        return len(self.items)

    @property
    def n_streams(self) -> int:
        return len(self.streams)

    def stats(self) -> dict:
        """The plan summary a run's result embeds (the reference's advisor
        reads it for its ``segment_plan_skew`` rule)."""
        per_stream = {s: sum(it.n_ops for it in items)
                      for s, items in self.streams.items()}
        mean_share = (self.n_ops / max(1, self.n_streams)
                      if self.n_ops else 0.0)
        return {
            "n_ops": self.n_ops,
            "n_cuts": self.n_cuts,
            "n_keys": self.n_keys,
            "n_items": self.n_items,
            "n_streams": self.n_streams,
            "plan_seconds": round(self.plan_seconds, 4),
            "mixed": self.mixed,
            "poisoned": self.poisoned,
            "dropped_nemesis": self.dropped_nemesis,
            "largest_item_ops": self.largest_item_ops,
            "largest_item_key": (repr(self.largest_item_key)
                                 if self.largest_item_key is not None
                                 else None),
            "mean_worker_share_ops": round(mean_share, 1),
            "stream_ops": {str(s): n for s, n in per_stream.items()},
        }


def _key_of(op: Op) -> Any:
    return op.value.key if ind.is_tuple(op.value) else SINGLE_KEY


def _as_ops(history: Any) -> Iterable:
    if isinstance(history, History):
        return list(history)
    return list(history)


def plan(history: Any, streams: int = 1) -> Plan:
    """Plan a fully recorded history into a static decision DAG.

    ``history`` is a :class:`~jepsen_tpu.history.History`, a list of
    :class:`~jepsen_tpu.history.Op`, or a list of plain scheduler op
    dicts (ndjson rows). Missing ``index`` fields are stamped
    monotonically; non-monotone pre-indexed input raises
    :class:`NonMonotoneHistoryError` (a recorded history promises every
    op exactly once, in order — see the exception's docstring).

    ``streams`` is the requested fan-out width; the effective width is
    clamped to the number of keys (an unkeyed history has exactly one
    carry chain, so it plans as one stream regardless).
    """
    if streams < 1:
        raise ValueError("streams must be >= 1")
    t0 = _time.perf_counter()
    seg = Segmenter(strict=True)
    raw_segments: list[KeySegment] = []
    kept_ops: list[Op] = []  # client ops, as (re)indexed by the segmenter
    dropped_nemesis = 0
    for op in _as_ops(history):
        raw_segments.extend(seg.offer(op))
        last = seg.last_op
        if last is None:
            continue
        if last.is_client:
            kept_ops.append(last)
        else:
            dropped_nemesis += 1
    raw_segments.extend(seg.finish())

    p = Plan(mixed=seg.mixed_keys, poisoned=seg.poisoned,
             dropped_nemesis=dropped_nemesis, n_ops=len(kept_ops),
             n_cuts=seg.segments_emitted)

    # Key universe + per-key op weights (the bin-packing load measure).
    key_ops: dict = {}
    for s in raw_segments:
        key_ops[s.key] = key_ops.get(s.key, 0) + s.n_ops
        if s.n_ops > p.largest_item_ops:
            p.largest_item_ops = s.n_ops
            p.largest_item_key = s.key
    p.n_keys = len(key_ops)

    # Greedy largest-first bin packing of keys onto streams. One carry
    # chain (unkeyed or mixed) cannot split.
    width = 1 if (p.mixed or p.n_keys <= 1) else min(streams, p.n_keys)
    names = [f"s{i}" for i in range(width)]
    loads = {n: 0 for n in names}
    for k, w in sorted(key_ops.items(), key=lambda kv: (-kv[1],
                                                        repr(kv[0]))):
        tgt = min(names, key=lambda n: (loads[n], n))
        p.key_to_stream[k] = tgt
        loads[tgt] += w
    p.streams = {n: [] for n in names}

    # Renumber each stream's cut ordinals densely (order-preserving):
    # the scheduler's per-stream watermark walks next_seq contiguously.
    next_seq = {n: 0 for n in names}
    seen_seq: dict = {}  # (stream, global_seq) -> stream-local seq
    last_seq_of_key: dict = {}
    for s in raw_segments:
        stream = p.key_to_stream[s.key]
        sk = (stream, s.seq)
        if sk not in seen_seq:
            seen_seq[sk] = next_seq[stream]
            next_seq[stream] += 1
        local = seen_seq[sk]
        item = PlanItem(stream=stream, key=s.key, seq=local,
                        global_seq=s.seq,
                        segment=replace(s, seq=local),
                        depends_on=last_seq_of_key.get((stream, s.key)))
        last_seq_of_key[(stream, s.key)] = local
        p.items.append(item)
        p.streams[stream].append(item)

    # Original-op retention for the fleet fanout: each stream's ops in
    # index order, [k v] intact — its keys' full subhistory.
    p.stream_ops = {n: [] for n in names}
    for op in kept_ops:
        stream = p.key_to_stream.get(_key_of(op))
        if stream is None:  # op of a key with no client completions
            stream = names[0]
        p.stream_ops[stream].append(op)

    p.plan_seconds = _time.perf_counter() - t0
    return p
