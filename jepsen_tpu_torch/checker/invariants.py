"""O(n) invariant checkers (the cheap checker family,
jepsen/src/jepsen/checker.clj:163-792). The port of the reference's
``jepsen_tpu/checker/invariants.py``, its numpy arithmetic kept as it is
(quantiles, float cumsums), so the result maps come out equal.

They run on the host, vectorized with numpy where the access pattern pays
(counter bound tracking, set-full per-element timelines); the search
checkers (linearizable, txn cycles) run on the card.

History op shapes follow the reference workloads:

- set:         {:f :add :value v} / final {:f :read :value #{...}}
- set-full:    adds + many reads returning the full set
- queue:       {:f :enqueue|:dequeue :value v}, optional {:f :drain}
- unique-ids:  {:f :generate} -> ok :value id
- counter:     {:f :add :value n>=0} / {:f :read :value n}
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Optional

import numpy as np

from . import Checker, checker_fn, merge_valid
from ..history import History
from ..util import integer_interval_set_str


def _client_ops(history: History):
    return list(history.client_ops())


# ---------------------------------------------------------------------------
# queue (model-folding; checker.clj:215-235)


def queue(model=None) -> Checker:
    """Every dequeue must come from somewhere: assume every non-failing
    enqueue succeeded and only ok dequeues succeeded, fold through the queue
    model (default unordered). O(n)."""

    def chk(test, history, opts):
        from ..models import UnorderedQueue, ValueTable
        from ..models.queue import DEQUEUE, ENQUEUE

        m = model or UnorderedQueue()
        table = ValueTable()
        state = m.init_state(table)
        for op in _client_ops(history):
            if op.f == "enqueue" and op.is_invoke:
                ok, state = m.step_scalar(state, ENQUEUE, table.intern(op.value), 0)
            elif op.f == "dequeue" and op.is_ok:
                ok, state = m.step_scalar(state, DEQUEUE, table.intern(op.value), 0)
            else:
                continue
            if not ok:
                return {
                    "valid": False,
                    "error": f"can't dequeue {op.value!r}",
                }
        return {
            "valid": True,
            "final_queue": [table.lookup(i) for i in state],
        }

    return checker_fn(chk, "queue")


# ---------------------------------------------------------------------------
# set (checker.clj:237-288)


def set_checker() -> Checker:
    """Adds followed by a final read: every acknowledged add must be read;
    only attempted elements may appear."""

    def chk(test, history, opts):
        attempts, adds = set(), set()
        final_read = None
        for op in _client_ops(history):
            if op.f == "add" and op.is_invoke:
                attempts.add(op.value)
            elif op.f == "add" and op.is_ok:
                adds.add(op.value)
            elif op.f == "read" and op.is_ok:
                final_read = op.value
        if final_read is None:
            return {"valid": "unknown", "error": "set was never read"}
        final = set(final_read)
        ok = final & attempts
        unexpected = final - attempts
        lost = adds - final
        recovered = ok - adds
        return {
            "valid": not lost and not unexpected,
            "attempt_count": len(attempts),
            "acknowledged_count": len(adds),
            "ok_count": len(ok),
            "lost_count": len(lost),
            "recovered_count": len(recovered),
            "unexpected_count": len(unexpected),
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
        }

    return checker_fn(chk, "set")


# ---------------------------------------------------------------------------
# set-full (checker.clj:291-589) — vectorized per-element timelines


def _quantiles(points, xs) -> Optional[dict]:
    xs = sorted(xs)
    if not xs:
        return None
    n = len(xs)
    return {p: xs[min(n - 1, int(n * p))] for p in points}


def set_full(checker_opts: Optional[dict] = None, **kw) -> Checker:
    """Per-element stable/lost/never-read timeline analysis.

    For each added element, find the *known* time (add completion or first
    observing read, whichever completes first), the last read invocation
    that observed it and the last ok-read invocation that missed it; an
    element is *stable* when no miss follows the final observation, *lost*
    when a miss follows both the observation and the known point, and
    *never-read* otherwise. Latencies are known->stable / known->lost in
    ms, reported as quantile maps. ``linearizable=True`` additionally fails
    stale (nonzero-stable-latency) elements.

    One divergence from checker.clj:562-570 noted: duplicate detection
    there compares multiplicities `< 1` (unreachable); here a value
    appearing more than once in a single read is a duplicate, as the
    surrounding docs intend.
    """
    o = dict(checker_opts or {})
    o.update(kw)
    linearizable = bool(o.get("linearizable", False))

    def chk(test, history, opts):
        ops = _client_ops(history)
        # Element table (one row per attempted add).
        elem_ids: dict[Any, int] = {}
        add_ok_idx: list[float] = []
        add_ok_time: list[float] = []
        add_ok_op: list[Any] = []
        for op in ops:
            if op.f == "add" and op.is_invoke and op.value not in elem_ids:
                elem_ids[op.value] = len(elem_ids)
                add_ok_idx.append(np.inf)
                add_ok_time.append(np.inf)
                add_ok_op.append(None)
        for op in ops:
            if op.f == "add" and op.is_ok and op.value in elem_ids:
                e = elem_ids[op.value]
                if op.index < add_ok_idx[e]:
                    add_ok_idx[e] = op.index
                    add_ok_time[e] = op.time
                    add_ok_op[e] = op
        E = len(elem_ids)

        # Ok reads, paired with their invocations.
        pending: dict[Any, Any] = {}
        reads = []  # (inv_idx, inv_time, ret_idx, ret_time, member-ids, dups)
        dups: Counter = Counter()
        for op in ops:
            if op.f != "read":
                continue
            if op.is_invoke:
                pending[op.process] = op
            elif op.is_fail:
                pending.pop(op.process, None)
            elif op.is_ok:
                inv = pending.pop(op.process, None)
                vals = op.value or []
                freq = Counter(vals)
                for v, c in freq.items():
                    if c > 1:
                        dups[v] = max(dups[v], c)
                members = {elem_ids[v] for v in freq if v in elem_ids}
                reads.append(
                    (
                        op.index if inv is None else inv.index,
                        op.time if inv is None else inv.time,
                        op.index,
                        op.time,
                        members,
                        inv if inv is not None else op,
                        op,
                    )
                )
        R = len(reads)

        last_present_idx = np.full(E, -1.0)
        last_present_time = np.full(E, -1.0)
        last_absent_idx = np.full(E, -1.0)
        last_absent_time = np.full(E, -1.0)
        first_obs_idx = np.full(E, np.inf)
        first_obs_time = np.full(E, np.inf)
        if E and R:
            # Chunk over reads so memory stays O(chunk * E) rather than
            # O(R * E): running E-wide max/min reductions across chunks.
            inv_idx = np.array([r[0] for r in reads], float)
            inv_time = np.array([r[1] for r in reads], float)
            ret_idx = np.array([r[2] for r in reads], float)
            ret_time = np.array([r[3] for r in reads], float)
            chunk = max(1, min(R, (1 << 24) // max(E, 1)))
            for lo in range(0, R, chunk):
                hi = min(lo + chunk, R)
                member = np.zeros((hi - lo, E), dtype=bool)
                for r in range(lo, hi):
                    members = reads[r][4]
                    if members:
                        member[r - lo, list(members)] = True
                ci, ct = inv_idx[lo:hi], inv_time[lo:hi]
                cri, crt = ret_idx[lo:hi], ret_time[lo:hi]
                pres = np.where(member, ci[:, None], -1.0)
                rbest = pres.argmax(axis=0)
                cmax = pres.max(axis=0)
                upd = cmax > last_present_idx
                last_present_idx = np.where(upd, cmax, last_present_idx)
                last_present_time = np.where(upd, ct[rbest], last_present_time)
                absn = np.where(~member, ci[:, None], -1.0)
                rabs = absn.argmax(axis=0)
                amax = absn.max(axis=0)
                upd = amax > last_absent_idx
                last_absent_idx = np.where(upd, amax, last_absent_idx)
                last_absent_time = np.where(upd, ct[rabs], last_absent_time)
                obs = np.where(member, cri[:, None], np.inf)
                robs = obs.argmin(axis=0)
                omin = obs.min(axis=0)
                upd = omin < first_obs_idx
                first_obs_idx = np.where(upd, omin, first_obs_idx)
                first_obs_time = np.where(upd, crt[robs], first_obs_time)

        add_ok_idx_a = np.array(add_ok_idx, float) if E else np.zeros(0)
        add_ok_time_a = np.array(add_ok_time, float) if E else np.zeros(0)
        known_idx = np.minimum(add_ok_idx_a, first_obs_idx)
        known_time = np.where(
            add_ok_idx_a <= first_obs_idx, add_ok_time_a, first_obs_time
        )
        known = np.isfinite(known_idx)

        stable = (last_present_idx >= 0) & (last_absent_idx < last_present_idx)
        lost = (
            known
            & (last_absent_idx >= 0)
            & (last_present_idx < last_absent_idx)
            & (known_idx < last_absent_idx)
        )
        never_read = ~(stable | lost)

        stable_time = np.where(last_absent_idx >= 0, last_absent_time + 1, 0.0)
        lost_time = np.where(last_present_idx >= 0, last_present_time + 1, 0.0)
        to_ms = lambda ns: int(max(ns, 0) // 1_000_000)
        elems = list(elem_ids)
        stable_lat = {
            elems[e]: to_ms(stable_time[e] - known_time[e])
            for e in np.flatnonzero(stable & known)
        }
        lost_lat = {
            elems[e]: to_ms(lost_time[e] - known_time[e])
            for e in np.flatnonzero(lost)
        }
        stale = sorted(
            (e for e, l in stable_lat.items() if l > 0), key=lambda e: stable_lat[e]
        )

        def known_op(e):
            if add_ok_idx_a[e] <= first_obs_idx[e]:
                return add_ok_op[e]
            return reads[int(robs[e])][6] if R else None

        def last_absent_op(e):
            return reads[int(rabs[e])][5] if R and last_absent_idx[e] >= 0 else None

        worst_stale = [
            {
                "element": e,
                "known": known_op(elem_ids[e]),
                "last_absent": last_absent_op(elem_ids[e]),
                "outcome": "stable",
                "stable_latency": stable_lat[e],
                "lost_latency": None,
            }
            for e in sorted(stale, key=lambda e: -stable_lat[e])[:8]
        ]

        n_stable = int(stable.sum())
        n_lost = int(lost.sum())
        valid: Any = True
        if n_lost > 0:
            valid = False
        elif n_stable == 0:
            valid = "unknown"
        elif linearizable and stale:
            valid = False
        points = [0, 0.5, 0.95, 0.99, 1]
        out = {
            "valid": False if dups else valid,
            "attempt_count": E,
            "stable_count": n_stable,
            "lost_count": n_lost,
            "lost": sorted(elems[e] for e in np.flatnonzero(lost)),
            "never_read_count": int(never_read.sum()),
            "never_read": sorted(elems[e] for e in np.flatnonzero(never_read)),
            "stale_count": len(stale),
            "stale": sorted(stale),
            "worst_stale": worst_stale,
            "duplicated_count": len(dups),
            "duplicated": dict(dups),
        }
        if stable_lat:
            out["stable_latencies"] = _quantiles(points, stable_lat.values())
        if lost_lat:
            out["lost_latencies"] = _quantiles(points, lost_lat.values())
        return out

    return checker_fn(chk, "set-full")


# ---------------------------------------------------------------------------
# total-queue (checker.clj:590-684) — multiset accounting


def _expand_drains(ops):
    """Expand ok :drain ops (value = list of elements) into dequeue
    invoke/ok pairs (checker.clj:590-620)."""
    out = []
    for op in ops:
        if op.f != "drain":
            out.append(op)
        elif op.is_invoke or op.is_fail:
            continue
        elif op.is_ok:
            for element in op.value or []:
                out.append(op.with_(type="invoke", f="dequeue", value=None))
                out.append(op.with_(type="ok", f="dequeue", value=element))
        else:
            raise ValueError(f"can't handle a crashed drain operation: {op!r}")
    return out


def total_queue() -> Checker:
    """What goes in must come out (given a full drain): every successful
    enqueue has a successful dequeue; no dequeues from nowhere."""

    def chk(test, history, opts):
        ops = _expand_drains(_client_ops(history))
        attempts: Counter = Counter()
        enqueues: Counter = Counter()
        dequeues: Counter = Counter()
        for op in ops:
            if op.f == "enqueue" and op.is_invoke:
                attempts[op.value] += 1
            elif op.f == "enqueue" and op.is_ok:
                enqueues[op.value] += 1
            elif op.f == "dequeue" and op.is_ok:
                dequeues[op.value] += 1
        ok = dequeues & attempts
        unexpected = Counter(
            {v: c for v, c in dequeues.items() if v not in attempts}
        )
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues
        return {
            "valid": not lost and not unexpected,
            "attempt_count": sum(attempts.values()),
            "acknowledged_count": sum(enqueues.values()),
            "ok_count": sum(ok.values()),
            "unexpected_count": sum(unexpected.values()),
            "duplicated_count": sum(duplicated.values()),
            "lost_count": sum(lost.values()),
            "recovered_count": sum(recovered.values()),
            "lost": dict(lost),
            "unexpected": dict(unexpected),
            "duplicated": dict(duplicated),
            "recovered": dict(recovered),
        }

    return checker_fn(chk, "total-queue")


# ---------------------------------------------------------------------------
# unique-ids (checker.clj:686-731)


def unique_ids() -> Checker:
    """A unique-id generator must actually emit unique ids."""

    def chk(test, history, opts):
        attempted = 0
        acks = []
        for op in _client_ops(history):
            if op.f != "generate":
                continue
            if op.is_invoke:
                attempted += 1
            elif op.is_ok:
                acks.append(op.value)
        counts = Counter(acks)
        dups = {v: c for v, c in counts.items() if c > 1}
        rng = [min(acks), max(acks)] if acks else None
        return {
            "valid": not dups,
            "attempted_count": attempted,
            "acknowledged_count": len(acks),
            "duplicated_count": len(dups),
            "duplicated": dict(
                sorted(dups.items(), key=lambda kv: -kv[1])[:48]
            ),
            "range": rng,
        }

    return checker_fn(chk, "unique-ids")


# ---------------------------------------------------------------------------
# counter (checker.clj:734-792) — vectorized bound tracking


def counter() -> Checker:
    """A monotonically-increasing counter: each read must land within
    [sum of ok increments at its invocation, sum of attempted increments at
    its completion].

    Vectorized: two prefix sums over the completed history (attempted
    increments at add-invokes, acknowledged increments at add-oks), then a
    gather per read pair — no per-op Python loop."""

    def chk(test, history, opts):
        ops = [op for op in history.complete() if op.is_client]
        n = len(ops)
        d_upper = np.zeros(n)
        d_lower = np.zeros(n)
        read_pairs = []  # (inv_pos, ok_pos, value)
        pending_inv: dict[Any, int] = {}
        pending_read: dict[Any, int] = {}
        for i, op in enumerate(ops):
            if op.f == "add":
                if op.is_invoke:
                    if op.value < 0:
                        raise ValueError("counter: negative add")
                    pending_inv[op.process] = i
                    d_upper[i] = op.value
                elif op.is_ok:
                    d_lower[i] = op.value
                elif op.is_fail:
                    # Un-count the attempted increment of a failed add.
                    j = pending_inv.pop(op.process, None)
                    if j is not None:
                        d_upper[j] = 0
            elif op.f == "read":
                if op.is_invoke:
                    pending_read[op.process] = i
                elif op.is_ok:
                    j = pending_read.pop(op.process, None)
                    if j is not None:
                        read_pairs.append((j, i, op.value))
                else:
                    pending_read.pop(op.process, None)
        cum_upper = np.cumsum(d_upper)
        cum_lower = np.cumsum(d_lower)
        reads = [
            [float(cum_lower[j]), v, float(cum_upper[i])] for j, i, v in read_pairs
        ]
        errors = [r for r in reads if not (r[0] <= r[1] <= r[2])]
        return {"valid": not errors, "reads": reads, "errors": errors}

    return checker_fn(chk, "counter")
