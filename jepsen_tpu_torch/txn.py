"""Transaction micro-op helpers (the reference's jepsen.txn library).

The port of ``jepsen_tpu/txn.py``: a transaction is an op whose value is
a sequence of micro-ops ("mops"), each ``[f k v]`` — e.g.
``["r", 3, None]``, ``["w", 3, 2]``, ``["append", 3, 2]``. Completions
carry the observed values. Also the txn *generators* the reference gets
from elle (elle.list-append/gen, elle.rw-register/gen — consumed at
jepsen/src/jepsen/tests/cycle/append.clj:23-27, cycle/wr.clj:9-12):
random transactions over a rotating key pool with bounded writes per key,
drawn from the generator RNG.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from . import generator as gen

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


class _TxnStream(gen.Generator):
    """An immutable, probe-idempotent txn stream.

    The generator protocol probes ``op`` speculatively and may discard the
    result (e.g. soonest-op races, jepsen_tpu.independent's group polling),
    so the next element and successor state are computed ONCE on first
    probe and cached — repeated probes return the same element, and only
    dispatching advances the stream (via the returned successor). A
    rotating pool of ``key_count`` active keys; a key retires after
    ``max_writes_per_key`` writes and a fresh, monotonically-increasing
    key replaces it."""

    __slots__ = ("mop_fn", "key_count", "min_len", "max_len",
                 "max_writes", "state", "_cached")

    def __init__(self, mop_fn, key_count, min_len, max_len, max_writes,
                 state=None):
        self.mop_fn = mop_fn
        self.key_count = key_count
        self.min_len = min_len
        self.max_len = max_len
        self.max_writes = max_writes
        self.state = state if state is not None else {
            "next_key": key_count,
            "active": tuple(range(key_count)),
            "writes": tuple([0] * key_count),
            "extra": (),
        }
        self._cached = None

    def _next(self):
        if self._cached is not None:
            return self._cached
        st = {
            "next_key": self.state["next_key"],
            "active": list(self.state["active"]),
            "writes": dict(zip(self.state["active"], self.state["writes"])),
            "extra": self.state["extra"],
        }
        n = self.min_len + gen.rand_int(self.max_len - self.min_len + 1)
        txn = []
        for _ in range(n):
            k = st["active"][gen.rand_int(len(st["active"]))]
            mop, st["extra"] = self.mop_fn(k, st["extra"])
            if mop[0] != R:
                st["writes"][k] = st["writes"].get(k, 0) + 1
                if st["writes"][k] >= self.max_writes:
                    i = st["active"].index(k)
                    nk = st["next_key"]
                    st["next_key"] += 1
                    st["active"][i] = nk
                    st["writes"][nk] = 0
            txn.append(mop)
        nxt = _TxnStream(
            self.mop_fn, self.key_count, self.min_len, self.max_len,
            self.max_writes,
            {
                "next_key": st["next_key"],
                "active": tuple(st["active"]),
                "writes": tuple(st["writes"][k] for k in st["active"]),
                "extra": st["extra"],
            },
        )
        self._cached = ({"f": "txn", "value": txn}, nxt)
        return self._cached

    def op(self, test, ctx):
        o, nxt = self._next()
        filled = gen.fill_in_op(o, ctx)
        if filled is gen.PENDING:
            return (gen.PENDING, self)
        return (filled, nxt)


def _txn_generator(mop_fn: Callable, key_count: int, min_txn_length: int,
                   max_txn_length: int, max_writes_per_key: int):
    return _TxnStream(mop_fn, key_count, min_txn_length, max_txn_length,
                      max_writes_per_key)


def take(stream, n: int, test: Optional[dict] = None) -> list[dict]:
    """Draw n txn op maps from a stream via the generator protocol (for
    direct use outside an interpreter, e.g. simulations and tests)."""
    ctx = gen.context({"concurrency": 1})
    out = []
    for _ in range(n):
        res = gen.op(stream, test or {}, ctx)
        if res is None:
            break
        o, stream = res
        out.append({"f": o["f"], "value": o["value"]})
    return out


def append_txns(key_count: int = 3, min_txn_length: int = 1,
                max_txn_length: int = 4, max_writes_per_key: int = 32):
    """Append/read txn stream (elle.list-append/gen semantics: ops like
    ``[["r", 3, None], ["append", 3, 2]]``; append values per key are
    unique and increasing — cycle/append.clj:29-40 op shape). ``extra``
    carries per-key append counters immutably (as sorted item tuples)."""

    def mop(k, extra):
        if gen.rand_int(2):
            counters = dict(extra)
            counters[k] = counters.get(k, 0) + 1
            return [APPEND, k, counters[k]], tuple(sorted(counters.items()))
        return [R, k, None], extra

    return _txn_generator(mop, key_count, min_txn_length, max_txn_length,
                          max_writes_per_key)


def wr_txns(key_count: int = 2, min_txn_length: int = 1,
            max_txn_length: int = 2, max_writes_per_key: int = 32):
    """Write/read txn stream with globally unique writes
    (elle.rw-register/gen semantics; cycle/wr.clj:31-45 taxonomy).
    ``extra`` is the global write counter."""

    def mop(k, extra):
        counter = extra[0] if extra else 0
        if gen.rand_int(2):
            return [W, k, counter + 1], (counter + 1,)
        return [R, k, None], extra

    return _txn_generator(mop, key_count, min_txn_length, max_txn_length,
                          max_writes_per_key)
