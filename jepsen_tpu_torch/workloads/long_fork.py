"""Long-fork anomaly workload (parallel snapshot isolation probe).

The port of the checker half of the reference's
``jepsen_tpu/workloads/long_fork.py``, which mirrors jepsen.tests.long-fork
(jepsen/src/jepsen/tests/long_fork.clj): single-key write txns (each key
written exactly once, value 1) and group-read txns; the checker looks for
mutually incomparable reads — one read observed x but not y, another y but
not x (long_fork.clj:1-88's contiguity argument). The pairwise comparison is vectorized: each
group's reads become a bitmask matrix and incomparability is a matrix
test (a ``A·~Bᵀ`` style AND-reduction over key columns) instead of
long_fork.clj's per-pair reduce.

``generator`` and ``workload`` run tests rather than check them; they
raise ``ValueError`` naming the slice that brings them (the test runner).
"""

from __future__ import annotations

import random

import numpy as np

from ..checker import Checker, checker_fn
from . import RUNNER_SLICE

ILLEGAL = "illegal-history"

# The key order of a group read: any order does, so the port draws it from
# a module generator of its own where the reference draws from its test
# runner's.
_RNG = random.Random()


def group_for(n: int, k: int) -> list[int]:
    """The key group containing k (long_fork.clj:97-104)."""
    lo = k - (k % n)
    return list(range(lo, lo + n))


def read_txn_for(n: int, k: int) -> list:
    """A read txn of k's whole group, its keys in a random order."""
    ks = group_for(n, k)
    shuffled = []
    pool = list(ks)
    while pool:
        shuffled.append(pool.pop(_RNG.randrange(len(pool))))
    return [["r", kk, None] for kk in shuffled]


def generator(n: int = 2):
    raise ValueError(RUNNER_SLICE)


def _is_read_txn(txn) -> bool:
    return all(m[0] == "r" for m in txn or [])


def _is_write_txn(txn) -> bool:
    return bool(txn) and len(txn) == 1 and txn[0][0] == "w"


def find_forks(ops: list) -> list:
    """Mutually incomparable read pairs within one key group, vectorized
    (long_fork.clj:156-226). Returns [[op_a, op_b], ...]."""
    if len(ops) < 2:
        return []
    maps = [dict((m[1], m[2]) for m in (op.value if hasattr(op, "value")
                                        else op["value"])) for op in ops]
    ks = sorted(maps[0])
    for m in maps:
        if sorted(m) != ks:
            raise ValueError(f"{ILLEGAL}: reads over different key sets")
    # Values must agree where present (each key written exactly once
    # with one value); distinct observed values make the history illegal
    # (long_fork.clj:188-196).
    for j, k in enumerate(ks):
        seen = {m[k] for m in maps if m[k] is not None}
        if len(seen) > 1:
            raise ValueError(
                f"{ILLEGAL}: reads contain distinct values {sorted(seen)!r} "
                f"for key {k!r}")
    vals = np.array(
        [[m[k] is not None for k in ks] for m in maps], dtype=bool)
    # a_dominates[i,j]: read i saw a key j missed; incomparable pairs have
    # both directions set.
    R = len(ops)
    a_over_b = np.zeros((R, R), dtype=bool)
    for j in range(len(ks)):
        col = vals[:, j]
        a_over_b |= col[:, None] & ~col[None, :]
    inc = a_over_b & a_over_b.T
    out = []
    seen = set()
    for i, j in zip(*np.nonzero(np.triu(inc, 1))):
        key = (int(i), int(j))
        if key not in seen:
            seen.add(key)
            out.append([ops[int(i)], ops[int(j)]])
    return out


def checker(n: int = 2) -> Checker:
    """long_fork.clj:304-318."""

    def chk(test, history, opts):
        reads = [op for op in history
                 if op.is_ok and _is_read_txn(op.value)]
        # Multiple writes to one key => unknown (long_fork.clj:268-284).
        written = set()
        for op in history:
            if op.is_invoke and _is_write_txn(op.value):
                k = op.value[0][1]
                if k in written:
                    return {"valid": "unknown",
                            "error": ["multiple-writes", k]}
                written.add(k)
        early = [op for op in reads
                 if all(m[2] is None for m in op.value)]
        late = [op for op in reads
                if all(m[2] is not None for m in op.value)]
        out = {
            "reads_count": len(reads),
            "early_read_count": len(early),
            "late_read_count": len(late),
        }
        groups: dict = {}
        for op in reads:
            key_set = frozenset(m[1] for m in op.value)
            if len(key_set) != n:
                return {**out, "valid": "unknown",
                        "error": [ILLEGAL,
                                  f"read observed {len(key_set)} keys, "
                                  f"expected {n}"]}
            groups.setdefault(key_set, []).append(op)
        forks = []
        try:
            for ops in groups.values():
                forks.extend(find_forks(ops))
        except ValueError as e:
            return {**out, "valid": "unknown", "error": str(e)}
        if forks:
            out["valid"] = False
            out["forks"] = [[repr(a), repr(b)] for a, b in forks]
        else:
            out["valid"] = True
        return out

    return checker_fn(chk, "long-fork")


def workload(n: int = 2) -> dict:
    raise ValueError(RUNNER_SLICE)
