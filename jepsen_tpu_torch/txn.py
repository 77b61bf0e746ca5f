"""Transaction micro-op helpers (the reference's jepsen.txn library).

The port of the helpers of ``jepsen_tpu/txn.py``: a transaction is an op
whose value is a sequence of micro-ops ("mops"), each ``[f k v]`` — e.g.
``["r", 3, None]``, ``["w", 3, 2]``, ``["append", 3, 2]``. Completions
carry the observed values. The txn generators, which run tests rather
than check them, come with a later slice of the port and raise
``ValueError``.
"""

from __future__ import annotations

from typing import Any, Callable

R, W, APPEND = "r", "w", "append"


def reduce_mops(f: Callable, init: Any, history) -> Any:
    """Fold ``f(state, op, mop)`` over every micro-op of every op
    (txn.clj:5-17)."""
    state = init
    for op in history:
        v = op.value if hasattr(op, "value") else op.get("value")
        for mop in v or []:
            state = f(state, op, mop)
    return state


def op_mops(history):
    """All (op, mop) pairs (txn.clj:19-22)."""
    for op in history:
        v = op.value if hasattr(op, "value") else op.get("value")
        for mop in v or []:
            yield op, mop


def ext_reads(txn) -> dict:
    """Keys -> values a txn observed and did not itself write first
    (txn.clj:24-39): only the FIRST access per key counts, and only if it
    was a read."""
    ext: dict = {}
    ignore: set = set()
    for f, k, v in txn:
        if f == R and k not in ignore:
            ext[k] = v
        ignore.add(k)
    return ext


def ext_writes(txn) -> dict:
    """Keys -> final values written by the txn (txn.clj:41-53)."""
    ext: dict = {}
    for f, k, v in txn:
        if f != R:
            ext[k] = v
    return ext


def int_write_mops(txn) -> dict:
    """Keys -> list of non-final write mops to that key (txn.clj:55-69)."""
    writes: dict = {}
    for mop in txn:
        f, k, v = mop
        if f != R:
            writes.setdefault(k, []).append(mop)
    return {k: ms[:-1] for k, ms in writes.items() if len(ms) > 1}


GENERATORS_SLICE = ("the txn generators run tests rather than check them; they come "
                    "with a later slice of the port (the test runner)")


def append_txns(*args, **kwargs):
    raise ValueError(GENERATORS_SLICE)


def wr_txns(*args, **kwargs):
    raise ValueError(GENERATORS_SLICE)
