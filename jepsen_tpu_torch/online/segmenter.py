"""Streaming history segmenter: quiescent cuts, the per-key split, and the
state carry between segments. The port of the reference's
``jepsen_tpu/online/segmenter.py``.

A history need not be decided as one search. Whenever the stream reaches
a *quiescent* point (no invocation open), real time orders everything
before the cut before everything after it, so the history factors into
closed segments that can be decided one by one, each from the states the
previous segment could have ended in. Each closed segment then splits per
key (``independent.history_keys``/``subhistory``, the offline lifted
checker's helpers, so the two cannot drift).

Cut rules:

- an invocation opens its process's interval; an ``:ok``/``:fail``
  completion closes it; a cut is legal only where no interval is open;
- an ``:info`` completion stays open to the end of time, so the first
  ``:info`` *poisons* quiescence: the rest of the stream becomes one
  terminal segment.

State carry: :func:`segment_states` enumerates the EXACT set of end states
of a decided-valid segment (the host oracle's search run to exhaustion,
each accepting configuration's state decoded with ``Model.decode_state``
so that it survives the next segment's ``ValueTable``); carrying the whole
set, not one linearization's end state, is what makes the segmented
verdict equal the single search's.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, replace
from typing import Any, Iterable, Optional

import numpy as np

from .. import independent as ind
from ..history import History, Op
from ..models import Model
from ..ops.encode import EncodedHistory, encode_history

# Key used for unkeyed (non-[k v]) histories: one stream, one carry.
SINGLE_KEY = "__single__"


class NonMonotoneHistoryError(ValueError):
    """A strict-mode segmenter saw a pre-indexed op BELOW the stream's
    high-water mark.

    The live path silently drops such ops as covered duplicates — the
    resume protocol makes index < already-observed mean "resubmission",
    never new work. A fully *recorded* history makes the opposite
    promise: every op is new, in index order, exactly once — so an
    out-of-order index there is corrupt input (a mis-merged log, a
    shuffled ndjson), and dropping it would silently mis-cut the
    history. Offline ingestion (``offline.plan``) rejects it
    with this typed error instead.
    """

    def __init__(self, index: int, floor: int) -> None:
        self.index = index
        self.floor = floor
        super().__init__(
            f"non-monotone recorded history: op index {index} arrived "
            f"after index {floor - 1} was already observed (offline "
            "histories must be in index order; re-sort the recording "
            "or strip stale duplicates)")


@dataclass(frozen=True)
class KeySegment:
    """One key's slice of one closed segment of the stream.

    ``ops`` are the key's subhistory ops with ``[k v]`` tuples unwrapped
    (exactly what ``independent.subhistory`` hands the offline checker);
    ``seq`` is the global segment ordinal (all KeySegments of one cut
    share it); ``start_index``/``end_index`` bound the history indexes
    the global segment covers; ``terminal`` marks the stream-end segment
    (which may be non-quiescent: open/:info intervals are legal there).
    """

    key: Any
    seq: int
    ops: tuple
    start_index: int
    end_index: int
    terminal: bool = False
    # Monotonic ns when the cut closed (all KeySegments of one cut share
    # it) — the start of the segment's trace span, so queue-wait before
    # the scheduler picks it up is visible in the decision-latency chain.
    cut_ns: int = 0

    @property
    def n_ops(self) -> int:
        return len(self.ops)


class Segmenter:
    """Incremental stream consumer: feed ops with :meth:`offer`, collect
    closed :class:`KeySegment` lists; :meth:`finish` flushes the terminal
    segment. Tracks in-flight invocations per process and cuts at
    quiescent points only (see module docstring for the rules)."""

    def __init__(self, strict: bool = False) -> None:
        # Offline/recorded-history mode: a pre-indexed op below the
        # high-water mark raises NonMonotoneHistoryError instead of
        # being dropped as a resume-protocol duplicate (see the
        # exception's docstring for why the two paths must differ).
        self.strict = strict
        self._buffer: list[Op] = []
        self._open: set = set()  # processes with an open invocation
        self._poisoned = False  # an :info interval is open to end of time
        self._seq = 0
        self._next_index = 0  # assigned when ops arrive unindexed
        self.ops_seen = 0
        self._saw_keyed = False
        self._saw_keyless = False
        # The (index-assigned) Op the last offer() consumed — the
        # monitor reads its index/kind for decision-latency tracking
        # without re-parsing the raw dict. None before the first offer
        # (and after an offer that DROPPED a journal-covered
        # resubmission).
        self.last_op: Optional[Op] = None
        # Journal-restore floor (resume()): pre-indexed ops BELOW it
        # are already covered by the replayed watermark and are
        # dropped — re-checking them as fresh ops from the restored
        # post-state carries could wrongly REFUTE a valid history.
        self._floor = 0
        self.dropped_covered = 0

    def resume(self, next_index: int, next_seq: int) -> None:
        """Restart support (the service's verdict journal): continue
        index assignment and segment numbering where a journaled
        stream left off, so a reconnecting client's ops land AFTER the
        replayed watermark and new cuts extend the journaled seq
        chain. Pre-indexed ops BELOW ``next_index`` are dropped by
        :meth:`offer` from here on (counted in ``dropped_covered``): a
        client that resubmits its covered prefix anyway would
        otherwise have those ops re-checked from the restored
        POST-state carries, which can refute a valid history — the
        server enforces the resume protocol instead of trusting it.
        Must precede the first :meth:`offer`."""
        if self._buffer or self.ops_seen:
            raise RuntimeError("resume() must precede the first offer")
        self._next_index = max(0, int(next_index))
        self._seq = max(0, int(next_seq))
        self._floor = self._next_index

    @property
    def open_ops(self) -> int:
        """Ops buffered in the not-yet-closed segment (telemetry)."""
        return len(self._buffer)

    @property
    def open_invocations(self) -> int:
        return len(self._open)

    @property
    def poisoned(self) -> bool:
        return self._poisoned

    @property
    def segments_emitted(self) -> int:
        return self._seq

    @property
    def next_index(self) -> int:
        """The index the next unindexed op would be assigned (the
        journal-lag telemetry reads it)."""
        return self._next_index

    @property
    def mixed_keys(self) -> bool:
        """True when the stream mixes keyed (``[k v]``) and keyless
        client ops. Offline, ``independent.subhistory`` folds every
        keyless op into EVERY key's subhistory — including keys that
        first appear later in the stream — which a streaming split
        cannot reproduce, so the monitor degrades the fold to
        "unknown" rather than risk a verdict offline contradicts."""
        return self._saw_keyed and self._saw_keyless

    def _as_op(self, op) -> Op:
        if not isinstance(op, Op):
            op = Op.from_dict(op)
        if op.index < 0:
            op = op.with_(index=self._next_index)
        self._next_index = max(self._next_index, op.index + 1)
        return op

    def offer(self, op) -> list[KeySegment]:
        """Consume one history op (Op or plain scheduler dict); returns
        the KeySegments of a newly closed segment, usually ``[]``.
        A pre-indexed op BELOW the stream's high-water mark — the
        restored-journal floor after :meth:`resume`, or simply an
        index this segmenter has already observed — is a covered
        duplicate: DROPPED (never buffered — ``last_op`` reads None
        for it), not re-checked. The live-stream half matters as much
        as the restore half: a client whose POST was ingested but
        whose response was lost (or whose reconnect rewind overlaps
        the watermark) resubmits ops this stream already consumed, and
        re-checking them from the CURRENT carries could refute a valid
        history — a flip, not a degradation. Indexed streams are
        in-order by contract, so index < already-observed is always a
        duplicate, never new work."""
        if isinstance(op, Op):
            had_index = op.index >= 0
        else:
            # Explicit None check, not `or` — index 0 is falsy but
            # very much an index (the nemesis_interval lesson).
            _idx = op.get("index") if isinstance(op, dict) else None
            had_index = isinstance(_idx, int) and _idx >= 0
        seen_through = self._next_index  # BEFORE _as_op advances it
        op = self._as_op(op)
        if had_index and op.index < max(self._floor, seen_through):
            if self.strict:
                raise NonMonotoneHistoryError(
                    op.index, max(self._floor, seen_through))
            self.dropped_covered += 1
            self.last_op = None
            return []
        self.last_op = op
        self.ops_seen += 1
        if not op.is_client:
            return []  # nemesis ops have no invoke/complete discipline
        if ind.is_tuple(op.value):
            self._saw_keyed = True
        else:
            self._saw_keyless = True
        self._buffer.append(op)
        if op.is_invoke:
            self._open.add(op.process)
            return []
        self._open.discard(op.process)
        if op.is_info:
            # Indeterminate: the interval stays open forever; quiescence
            # is unreachable from here on (knossos OPEN-ret semantics).
            self._poisoned = True
        if self._open or self._poisoned or not self._buffer:
            return []
        return self._cut(terminal=False)

    def finish(self) -> list[KeySegment]:
        """Flush whatever remains as the terminal segment (legal even
        when non-quiescent: open intervals encode as OPEN there, exactly
        like the offline checker sees them)."""
        if not self._buffer:
            return []
        return self._cut(terminal=True)

    def _cut(self, terminal: bool) -> list[KeySegment]:
        ops, self._buffer = self._buffer, []
        seq = self._seq
        self._seq += 1
        start = ops[0].index
        end = ops[-1].index
        cut_ns = _time.monotonic_ns()
        keys = sorted(ind.history_keys(ops), key=repr)
        if not keys:
            return [KeySegment(SINGLE_KEY, seq, tuple(ops), start, end,
                               terminal, cut_ns)]
        out = []
        for k in keys:
            sub = ind.subhistory(k, History(ops, reindex=False))
            out.append(KeySegment(k, seq, tuple(sub), start, end, terminal,
                                  cut_ns))
        return out


# ---------------------------------------------------------------------------
# State carry: encoding a segment from carried states, and enumerating
# the feasible end states of a decided segment.


def encode_segment(model: Model, seg: KeySegment,
                   carried: Optional[Iterable[tuple]]) -> list[EncodedHistory]:
    """Encode ``seg`` once per carried initial state.

    ``carried`` is an iterable of *decoded* (semantic) states from the
    previous segment's :func:`segment_states`, or None for the stream's
    first segment (the model's own init). Each returned member shares
    the segment's op rows but starts from one candidate state — the
    batch members the scheduler hands to the batched search; the segment
    is valid iff ANY member is.
    """
    base = encode_history(model, History(list(seg.ops), reindex=False))
    if carried is None:
        return [base]
    out = []
    for st in carried:
        lanes = model.encode_state(st, base.table)
        out.append(replace(base, init_state=np.asarray(lanes,
                                                       dtype=np.int32)))
    return out


def segment_states(enc: EncodedHistory,
                   max_configs: int = 500_000) -> dict:
    """Exhaustively decide one encoded segment AND enumerate its feasible
    end states.

    Unlike the host oracle (ops/wgl_host.py), which stops at the first
    accepting configuration, this BFS runs the whole reachable config
    space so the returned ``end_states`` is the EXACT set of states some
    valid linearization ends in — the next segment's legal initial
    states. Returns ``{"valid": True|False|"unknown", "end_states":
    [decoded states] | None, "configs_explored": n}``; ``end_states`` is
    None on a budget trip (the caller then carries "unknown" forward).

    Closed segments contain no ``:info`` ops (an :info poisons
    quiescence, so only terminal segments can carry them); skippable
    rows are handled anyway for the terminal case.
    """
    model = enc.model
    n = enc.n
    init = tuple(int(x) for x in enc.init_state)
    if n == 0:
        return {"valid": True,
                "end_states": [model.decode_state(init, enc.table)],
                "configs_explored": 0}
    from ..ops import wgl_host

    required = frozenset(i for i in range(n) if not enc.skippable[i])
    ret_order = sorted(range(n), key=lambda i: int(enc.ret[i]))
    start = (frozenset(), init)
    frontier = {start}
    seen = {start}
    explored = 0
    accepting_states: set = set()

    def accepting(cfg) -> bool:
        return required <= cfg[0]

    if accepting(start):
        accepting_states.add(init)
    while frontier:
        nxt = set()
        for linearized, state in frontier:
            explored += 1
            if explored > max_configs:
                from ..checker import provenance as _prov

                return _prov.attach(
                    {"valid": "unknown", "end_states": None,
                     "configs_explored": explored,
                     "info": f"config budget {max_configs} exhausted"},
                    "max_configs", budget=max_configs,
                    engine="enumerator")
            # Successor rule shared with the first-accept oracle
            # (wgl_host.expand) — the differential contract depends on
            # the two searches agreeing.
            for j, state2 in wgl_host.expand(enc, linearized, state,
                                             ret_order):
                cfg2 = (linearized | {j}, state2)
                if cfg2 in seen:
                    continue
                seen.add(cfg2)
                if accepting(cfg2):
                    accepting_states.add(state2)
                nxt.add(cfg2)
        frontier = nxt
    if not accepting_states:
        return {"valid": False, "end_states": [],
                "configs_explored": explored}
    return {
        "valid": True,
        "end_states": sorted(
            (model.decode_state(s, enc.table) for s in accepting_states),
            key=repr),
        "configs_explored": explored,
    }
