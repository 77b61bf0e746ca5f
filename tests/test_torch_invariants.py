"""The port's invariant checkers and the rest of its checker front door
(``jepsen_tpu_torch.checker``: ``queue``, ``set_checker``, ``set_full``,
``total_queue``, ``unique_ids``, ``counter``, ``noop``,
``unbridled_optimism``, ``unhandled_exceptions``, ``concurrency_limit``)
against the reference's (``jepsen_tpu.checker``).

Each history is drawn from a numpy seed, once, as op maps; both packages
build their own ``History`` of the same ops, and the whole result maps must
be equal, the ops they carry compared as op maps."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from jepsen_tpu import checker as ref_checker
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.models import FIFOQueue as RefFIFO
from jepsen_tpu.models import UnorderedQueue as RefUnordered
from jepsen_tpu_torch import checker as jc
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import FIFOQueue, UnorderedQueue

SEEDS = (0, 1, 2)


def norm(x):
    """A result map with either package's ops as op maps."""
    if isinstance(x, (Op, RefOp)):
        return {"type": x.type, "process": x.process, "f": x.f, "value": norm(x.value),
                "time": x.time, "index": x.index, "error": x.error,
                "extra": norm(list(x.extra))}
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def histories(rows):
    """The reference's and the port's History of the same op maps."""
    return (RefHistory([RefOp.from_dict(r) for r in rows]),
            History([Op.from_dict(r) for r in rows]))


def same(ref_chk, port_chk, rows, test=None):
    rh, ph = histories(rows)
    ref = ref_chk.check(test or {}, rh, {})
    port = port_chk.check(test or {}, ph, {})
    assert norm(port) == norm(ref)
    return port


def simulate(rng, n_ops, n_procs, invoke, complete):
    """Op maps of ``n_ops`` client ops on ``n_procs`` processes, each with
    at most one op in flight: ``invoke(p) -> (f, value)`` and
    ``complete(f, value) -> (type, value)`` at the completion's turn."""
    rows, busy, t, started = [], {}, 0, 0
    while started < n_ops or busy:
        free = [p for p in range(n_procs) if p not in busy]
        t += int(rng.integers(1, 3_000_000))
        if started < n_ops and free and (not busy or rng.random() < 0.5):
            p = int(rng.choice(free))
            f, v = invoke(p)
            busy[p] = (f, v)
            started += 1
            rows.append({"type": "invoke", "process": p, "f": f, "value": v, "time": t})
        else:
            p = int(rng.choice(sorted(busy)))
            f, v = busy.pop(p)
            typ, out = complete(f, v)
            rows.append({"type": typ, "process": p, "f": f, "value": out, "time": t})
    return rows


def outcome(rng):
    x = rng.random()
    return "ok" if x < 0.8 else "fail" if x < 0.9 else "info"


# ---------------------------------------------------------------------------
# set and set-full


def set_rows(seed, broken=False, n_ops=120, reads=0.4):
    rng = np.random.default_rng(seed)
    state, nxt, lost = set(), [0], []

    def invoke(p):
        if rng.random() < reads:
            return "read", None
        nxt[0] += 1
        return "add", nxt[0]

    def complete(f, v):
        typ = outcome(rng)
        if f == "add":
            if typ == "ok" or (typ == "info" and rng.random() < 0.5):
                state.add(v)
            return typ, v
        if typ != "ok":
            return typ, None
        seen = sorted(state)
        if broken and len(seen) > 6:
            if not lost:
                lost.append(seen[len(seen) // 2])
            seen = [x for x in seen if x not in lost]
            if rng.random() < 0.2:
                seen.append(seen[0])  # a duplicate in one read
        return "ok", seen

    rows = simulate(rng, n_ops, 4, invoke, complete)
    final = sorted(state - set(lost)) + ([10_000] if broken else [])
    t = rows[-1]["time"]
    rows += [{"type": "invoke", "process": 9, "f": "read", "value": None, "time": t + 1},
             {"type": "ok", "process": 9, "f": "read", "value": final, "time": t + 2}]
    return rows


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("broken", [False, True])
def test_set_checker(seed, broken):
    res = same(ref_checker.set_checker(), jc.set_checker(), set_rows(seed, broken))
    assert res["valid"] is (not broken)


def test_set_checker_never_read():
    rows = [{"type": "invoke", "process": 0, "f": "add", "value": 1, "time": 1}]
    assert same(ref_checker.set_checker(), jc.set_checker(), rows)["valid"] == "unknown"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("broken", [False, True])
@pytest.mark.parametrize("linearizable", [False, True])
def test_set_full(seed, broken, linearizable):
    res = same(ref_checker.set_full(linearizable=linearizable),
               jc.set_full(linearizable=linearizable), set_rows(seed, broken, n_ops=200))
    if broken:
        assert res["valid"] is False
        assert res["lost_count"] >= 1 or res["duplicated_count"] >= 1
    else:
        assert res["lost_count"] == 0 and res["duplicated_count"] == 0
        assert res["stable_count"] > 0


def test_set_full_worst_stale_carries_ops():
    """A stale element's ``worst_stale`` row carries the known op and the
    last read that missed it: the same ops in both packages."""
    rows = [
        {"type": "invoke", "process": 0, "f": "add", "value": 1, "time": 0},
        {"type": "invoke", "process": 1, "f": "read", "value": None, "time": 1_000_000},
        {"type": "ok", "process": 0, "f": "add", "value": 1, "time": 2_000_000},
        {"type": "ok", "process": 1, "f": "read", "value": [], "time": 3_000_000},
        {"type": "invoke", "process": 1, "f": "read", "value": None, "time": 9_000_000},
        {"type": "ok", "process": 1, "f": "read", "value": [], "time": 10_000_000},
        {"type": "invoke", "process": 1, "f": "read", "value": None, "time": 20_000_000},
        {"type": "ok", "process": 1, "f": "read", "value": [1], "time": 21_000_000},
    ]
    res = same(ref_checker.set_full(linearizable=True), jc.set_full(linearizable=True), rows)
    assert res["valid"] is False and res["stale"] == [1]
    assert isinstance(res["worst_stale"][0]["known"], Op)


# ---------------------------------------------------------------------------
# queue and total-queue


def queue_rows(seed, broken=False, n_ops=120, drain=False):
    rng = np.random.default_rng(seed)
    state, nxt = [], [0]

    def invoke(p):
        if rng.random() < 0.5:
            nxt[0] += 1
            return "enqueue", nxt[0]
        return "dequeue", None

    def complete(f, v):
        typ = outcome(rng)
        if f == "enqueue":
            if typ == "ok" or (typ == "info" and rng.random() < 0.5):
                state.append(v)
            return typ, v
        if typ != "ok" or not state:
            return ("fail" if typ == "ok" else typ), None
        x = state.pop(0 if rng.random() < 0.7 else int(rng.integers(len(state))))
        if broken and rng.random() < 0.1:
            return "ok", x + 100_000  # dequeued from nowhere
        return "ok", x

    rows = simulate(rng, n_ops, 4, invoke, complete)
    if drain:
        t = rows[-1]["time"]
        rest = list(state)
        if broken and rest:
            rest = rest[1:] + [rest[-1]]  # one lost, one duplicated
        rows += [{"type": "invoke", "process": 9, "f": "drain", "value": None, "time": t + 1},
                 {"type": "ok", "process": 9, "f": "drain", "value": rest, "time": t + 2}]
    return rows


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("broken", [False, True])
@pytest.mark.parametrize("fifo", [False, True])
def test_queue(seed, broken, fifo):
    rows = queue_rows(seed, broken)
    ref_model, model = (RefFIFO(), FIFOQueue()) if fifo else (RefUnordered(), UnorderedQueue())
    res = same(ref_checker.queue(ref_model), jc.queue(model), rows)
    if broken:
        assert res["valid"] is False


def test_queue_default_model():
    rows = queue_rows(4)
    assert same(ref_checker.queue(), jc.queue(), rows)["valid"] is True


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("broken", [False, True])
def test_total_queue(seed, broken):
    res = same(ref_checker.total_queue(), jc.total_queue(),
               queue_rows(seed, broken, drain=True))
    assert res["valid"] is (not broken)


def test_total_queue_crashed_drain_raises_in_both():
    rows = [{"type": "invoke", "process": 0, "f": "drain", "value": None, "time": 1},
            {"type": "info", "process": 0, "f": "drain", "value": None, "time": 2}]
    rh, ph = histories(rows)
    with pytest.raises(ValueError, match="crashed drain"):
        ref_checker.total_queue().check({}, rh, {})
    with pytest.raises(ValueError, match="crashed drain"):
        jc.total_queue().check({}, ph, {})


# ---------------------------------------------------------------------------
# unique-ids and counter


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("broken", [False, True])
def test_unique_ids(seed, broken):
    rng = np.random.default_rng(seed)
    nxt = [0]

    def complete(f, v):
        typ = outcome(rng)
        nxt[0] += 1
        if broken and rng.random() < 0.2:
            return typ, max(1, nxt[0] - int(rng.integers(1, 4)))
        return typ, nxt[0]

    rows = simulate(rng, 100, 5, lambda p: ("generate", None), complete)
    res = same(ref_checker.unique_ids(), jc.unique_ids(), rows)
    assert res["valid"] is (not broken)


def test_unique_ids_empty():
    assert same(ref_checker.unique_ids(), jc.unique_ids(), [])["range"] is None


def counter_rows(seed, broken=False, n_ops=150):
    rng = np.random.default_rng(seed)
    state = [0]

    def invoke(p):
        if rng.random() < 0.4:
            return "read", None
        return "add", int(rng.integers(0, 5))

    def complete(f, v):
        typ = outcome(rng)
        if f == "add":
            if typ == "ok" or (typ == "info" and rng.random() < 0.5):
                state[0] += v
            return typ, v
        if typ != "ok":
            return typ, None
        return "ok", state[0] + (1000 if broken and rng.random() < 0.2 else 0)

    return simulate(rng, n_ops, 4, invoke, complete)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("broken", [False, True])
def test_counter(seed, broken):
    res = same(ref_checker.counter(), jc.counter(), counter_rows(seed, broken))
    assert res["valid"] is (not broken)
    assert all(isinstance(b, float) for r in res["reads"] for b in (r[0], r[2]))


def test_counter_negative_add_raises_in_both():
    rows = [{"type": "invoke", "process": 0, "f": "add", "value": -1, "time": 1}]
    rh, ph = histories(rows)
    with pytest.raises(ValueError, match="negative"):
        ref_checker.counter().check({}, rh, {})
    with pytest.raises(ValueError, match="negative"):
        jc.counter().check({}, ph, {})


def test_history_complete_matches_reference():
    rows = counter_rows(7)[:-5]
    rh, ph = histories(rows)
    assert norm(list(ph.complete())) == norm(list(rh.complete()))
    full = History([Op.from_dict(r) for r in counter_rows(7)])
    assert full.complete() is full


# ---------------------------------------------------------------------------
# noop, unbridled optimism, unhandled exceptions, concurrency limit


def test_noop_and_unbridled_optimism():
    rh, ph = histories(counter_rows(1))
    assert jc.noop().check({}, ph, {}) is None is ref_checker.noop().check({}, rh, {})
    assert (jc.unbridled_optimism().check({}, ph, {})
            == ref_checker.unbridled_optimism().check({}, rh, {}) == {"valid": True})


@pytest.mark.parametrize("seed", SEEDS)
def test_unhandled_exceptions(seed):
    rng = np.random.default_rng(seed)
    classes = ["TimeoutError", "ConnectionError", "IOError"]
    rows = []
    for i in range(60):
        p = int(rng.integers(4))
        rows.append({"type": "invoke", "process": p, "f": "write", "value": i, "time": 2 * i})
        row = {"type": "ok", "process": p, "f": "write", "value": i, "time": 2 * i + 1}
        if rng.random() < 0.3:
            exc = classes[int(rng.integers(3))]
            row = dict(row, type="info", exception={"type": exc, "message": f"m{i}"})
        rows.append(row)
    res = same(ref_checker.unhandled_exceptions(), jc.unhandled_exceptions(), rows)
    assert res["exceptions"] and isinstance(res["exceptions"][0]["example"], Op)
    assert same(ref_checker.unhandled_exceptions(), jc.unhandled_exceptions(),
                counter_rows(seed)) == {"valid": True}


def test_concurrency_limit_bounds_compose_threads():
    """Two entries of one ``compose`` share a checker limited to one
    execution: the compose runs them on two threads, one at a time."""
    active, peak, lock = [0], [0], threading.Lock()

    def slow(test, history, opts):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.05)
        with lock:
            active[0] -= 1
        return {"valid": True}

    limited = jc.concurrency_limit(1, jc.checker_fn(slow))
    unlimited = jc.checker_fn(slow)
    _, ph = histories(counter_rows(1))
    res = jc.compose({"a": limited, "b": limited, "c": jc.noop()}).check({}, ph, {})
    assert peak[0] == 1 and res == {"a": {"valid": True}, "b": {"valid": True},
                                    "c": None, "valid": True}
    peak[0] = 0
    jc.compose({"a": unlimited, "b": unlimited}).check({}, ph, {})
    assert peak[0] == 2


def test_compose_of_the_front_door_matches_reference():
    rows = set_rows(3, broken=True)
    ref = ref_checker.compose({"set": ref_checker.set_checker(),
                               "full": ref_checker.set_full(),
                               "stats": ref_checker.stats(),
                               "exceptions": ref_checker.unhandled_exceptions(),
                               "limited": ref_checker.concurrency_limit(
                                   1, ref_checker.unbridled_optimism())})
    port = jc.compose({"set": jc.set_checker(), "full": jc.set_full(), "stats": jc.stats(),
                       "exceptions": jc.unhandled_exceptions(),
                       "limited": jc.concurrency_limit(1, jc.unbridled_optimism())})
    res = same(ref, port, rows)
    assert res["valid"] is False


def test_checker_exports_match_reference():
    assert set(ref_checker.__all__) <= set(jc.__all__)
    for name in ("counter", "queue", "set_checker", "set_full", "total_queue", "unique_ids",
                 "noop", "unbridled_optimism", "unhandled_exceptions", "concurrency_limit"):
        assert callable(getattr(jc, name)), name
