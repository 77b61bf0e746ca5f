"""Seeded history generators for tests and the chip smoke run.

``random_register_history`` and ``perturb_history`` draw from a
``random.Random`` in the same order as the reference package's
generators, so one seed gives op-for-op the same history in either
package. ``lagged_append_history`` and ``lagged_wr_history`` simulate
transactional stores for the Elle checkers (the reference has no such
generator; tests hand the same history to both packages).
"""

from __future__ import annotations

import random
from typing import Optional

from .history import History, Op


def random_register_history(
    rng: random.Random,
    n_ops: int = 40,
    n_procs: int = 4,
    cas: bool = True,
    crash_p: float = 0.1,
    fail_p: float = 0.05,
    values: int = 5,
) -> History:
    """Simulate concurrent processes against an atomic (cas-)register.

    Each op atomically takes effect at a random point inside its interval,
    so the result is linearizable by construction. ``crash_p`` turns
    completions into :info (indeterminate, effect applied or not with 50/50
    odds); ``fail_p`` produces :fail ops whose effect definitely did not
    apply.
    """
    state = 0
    ops: list[Op] = []
    t = 0
    pending: dict[int, Optional[tuple]] = {p: None for p in range(n_procs)}

    def now() -> int:
        nonlocal t
        t += rng.randint(1, 5)
        return t

    emitted = 0
    while emitted < n_ops or any(v is not None for v in pending.values()):
        p = rng.randrange(n_procs)
        slot = pending[p]
        if slot is None:
            if emitted >= n_ops:
                continue
            kinds = ["read", "write"] + (["cas"] if cas else [])
            f = rng.choice(kinds)
            if f == "read":
                value = None
            elif f == "write":
                value = rng.randrange(values)
            else:
                value = [rng.randrange(values), rng.randrange(values)]
            ops.append(Op("invoke", p, f, value, time=now()))
            pending[p] = (f, value, len(ops) - 1)
            emitted += 1
        else:
            f, value, _inv_pos = slot
            pending[p] = None
            if rng.random() < fail_p:
                ops.append(Op("fail", p, f, value, time=now()))
                continue
            crashed = rng.random() < crash_p
            applies = not crashed or rng.random() < 0.5
            out_value = value
            okflag = True
            if applies:
                if f == "read":
                    out_value = state
                elif f == "write":
                    state = value
                else:
                    old, new = value
                    if state == old:
                        state = new
                    else:
                        okflag = False
            if crashed:
                ops.append(Op("info", p, f, value, time=now()))
            elif f == "read":
                ops.append(Op("ok", p, f, out_value, time=now()))
            elif okflag:
                ops.append(Op("ok", p, f, value, time=now()))
            else:
                ops.append(Op("fail", p, f, value, time=now()))
    return History(ops)


def perturb_history(rng: random.Random, history: History,
                    within: float = 1.0) -> History:
    """Mutate one completed read's value — usually breaking
    linearizability. ``within`` restricts the mutated read to the first
    fraction of the history. A ``[k v]``-tupled (independent) value
    mutates its inner value and keeps its key."""
    ops = list(history)
    bound = max(1, int(len(ops) * within))
    ok_reads = [i for i, op in enumerate(ops[:bound])
                if op.is_ok and op.f == "read"]
    if not ok_reads:
        return history
    i = rng.choice(ok_reads)
    op = ops[i]

    def mut(v):
        return (v if v is None else v + 17) or 23

    from .independent import KV

    v = op.value
    ops[i] = op.with_(value=KV(v.key, mut(v.value)) if isinstance(v, KV) else mut(v))
    return History(ops, reindex=False)


def _lagged_txns(seed: int, n_txns: int, lag: Optional[tuple], depth: int,
                 key_count: int, max_txn_length: int, n_procs: int, mop):
    """The store loop both simulators share. Txn ``i`` runs on a random
    process over distinct random keys; each key's micro-ops come from
    ``mop(rng, key, seen_len, ops_out)``, where ``seen_len`` is the number
    of committed versions of the key the txn may see: all of them, or,
    inside the lag window ``[lo, hi)`` of txn indices, those committed up
    to a random 1..``depth`` txns earlier (a replica behind a partition).
    Txns run one after another: an invoke, then its ok."""
    rng = random.Random(seed)
    lens = [0] * key_count  # committed versions per key
    past: list[list[int]] = [list(lens)]  # past[t]: lens after t txns
    ops: list[Op] = []
    for i in range(n_txns):
        p = rng.randrange(n_procs)
        keys = rng.sample(range(key_count), rng.randint(1, min(max_txn_length, key_count)))
        lagged = lag is not None and lag[0] <= i < lag[1]
        snap = past[max(0, i - rng.randint(1, depth))] if lagged else lens
        invoke, done = [], []
        for k in keys:
            lens[k] += mop(rng, k, snap[k], invoke, done)
        past.append(list(lens))
        ops.append(Op("invoke", p, "txn", invoke, time=2 * i))
        ops.append(Op("ok", p, "txn", done, time=2 * i + 1))
    return History(ops)


def lagged_append_history(seed: int, n_txns: int, lag: Optional[tuple] = None,
                          depth: int = 16, key_count: int = 8, max_txn_length: int = 5,
                          n_procs: int = 10) -> History:
    """A list-append history (``["append", k, v]`` / ``["r", k, list]``,
    values unique per key) from a serial store whose reads inside the lag
    window see stale prefixes (see :func:`_lagged_txns`). Serializable
    outside the window; a stale read closes rw cycles inside it."""
    lists: dict[int, list] = {}

    def mop(rng, k, seen, invoke, done) -> int:
        versions = lists.setdefault(k, [])
        if rng.random() < 0.5:
            v = len(versions) + 1
            versions.append(v)
            invoke.append(["append", k, v])
            done.append(["append", k, v])
            return 1
        invoke.append(["r", k, None])
        done.append(["r", k, versions[:seen]])
        return 0

    return _lagged_txns(seed, n_txns, lag, depth, key_count, max_txn_length, n_procs, mop)


def lagged_wr_history(seed: int, n_txns: int, lag: Optional[tuple] = None,
                      depth: int = 16, key_count: int = 8, max_txn_length: int = 5,
                      n_procs: int = 10) -> History:
    """A rw-register history (``["w", k, v]`` with globally unique ``v`` /
    ``["r", k, v]``) from the same store loop: per key a read, a write, or
    a read then a write (which fixes the version order under
    ``wfr_keys``)."""
    regs: dict[int, list] = {}
    counter = [0]

    def mop(rng, k, seen, invoke, done) -> int:
        versions = regs.setdefault(k, [])
        kind = rng.randrange(3)
        if kind != 1:  # read (alone, or before a write)
            invoke.append(["r", k, None])
            done.append(["r", k, versions[seen - 1] if seen else None])
        if kind == 0:
            return 0
        counter[0] += 1
        versions.append(counter[0])
        invoke.append(["w", k, counter[0]])
        done.append(["w", k, counter[0]])
        return 1

    return _lagged_txns(seed, n_txns, lag, depth, key_count, max_txn_length, n_procs, mop)
