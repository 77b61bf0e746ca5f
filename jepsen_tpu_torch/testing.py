"""Seeded history generators for tests and the chip smoke run.

Both functions draw from a ``random.Random`` in the same order as the
reference package's generators, so one seed gives op-for-op the same
history in either package.
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
