"""Causal-consistency register workload + sequential (causal-reverse)
probe.

The port of the reference's ``jepsen_tpu/workloads/causal.py``, which
mirrors jepsen.tests.causal
(jepsen/src/jepsen/tests/causal.clj): a CausalRegister model with its own step protocol — ops carry ``link``
(the position this op causally follows) and ``position`` fields; a fixed
causal order ``[read-init, w1, read, w2, read]`` is issued per key and
must appear to execute in issue order (causal.clj:33-82,104-131).

And jepsen.tests.causal-reverse (causal_reverse.clj): a strict
serializability probe — if write w_i is visible, every write acknowledged
before w_i's invocation must be visible too (:1-113).
"""

from __future__ import annotations

import itertools
from typing import Optional

from .. import checker as jchecker
from .. import generator as gen
from .. import independent
from ..checker import Checker, checker_fn


class Inconsistent:
    """causal.clj:15-31."""

    def __init__(self, msg: str):
        self.msg = msg

    def __repr__(self):
        return f"<inconsistent {self.msg}>"


class CausalRegister:
    """causal.clj:33-82. value/counter/last_pos."""

    def __init__(self, value: int = 0, counter: int = 0, last_pos=None):
        self.value = value
        self.counter = counter
        self.last_pos = last_pos

    def step(self, op) -> "CausalRegister | Inconsistent":
        c = self.counter + 1
        v = op.value if hasattr(op, "value") else op.get("value")
        pos = _field(op, "position")
        link = _field(op, "link")
        if link not in ("init", self.last_pos):
            return Inconsistent(
                f"Cannot link {link!r} to last-seen position "
                f"{self.last_pos!r}")
        f = op.f if hasattr(op, "f") else op.get("f")
        if f == "write":
            if v == c:
                return CausalRegister(v, c, pos)
            return Inconsistent(
                f"expected value {c} attempting to write {v} instead")
        if f == "read-init":
            if self.counter == 0 and v not in (0, None):
                return Inconsistent(f"expected init value 0, read {v}")
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return Inconsistent(
                f"can't read {v} from register {self.value}")
        if f == "read":
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return Inconsistent(
                f"can't read {v} from register {self.value}")
        return Inconsistent(f"unknown f {f!r}")


def _field(op, name):
    if hasattr(op, "get"):
        got = op.get(name)
        if got is not None:
            return got
    return getattr(op, name, None)


def check(model: Optional[CausalRegister] = None) -> Checker:
    """Fold ok ops through the causal model (causal.clj:88-110)."""

    def chk(test, history, opts):
        s = model or CausalRegister()
        for op in history:
            if not getattr(op, "is_ok", False):
                continue
            s = s.step(op)
            if isinstance(s, Inconsistent):
                return {"valid": False, "error": s.msg}
        return {"valid": True, "model": repr(getattr(s, "value", None))}

    return checker_fn(chk, "causal")


def ri(test=None, ctx=None):
    return {"type": "invoke", "f": "read-init", "value": None,
            "link": "init"}


def r(test=None, ctx=None):
    return {"type": "invoke", "f": "read", "value": None}


def cw1(test=None, ctx=None):
    return {"type": "invoke", "f": "write", "value": 1}


def cw2(test=None, ctx=None):
    return {"type": "invoke", "f": "write", "value": 2}


def test(opts: Optional[dict] = None) -> dict:
    """causal.clj:113-131: one process per key issues the causal order
    [read-init w1 r w2 r]."""
    o = dict(opts or {})
    return {
        "checker": independent.checker(check()),
        "generator": gen.time_limit(
            o.get("time-limit", 60),
            gen.nemesis(
                gen.cycle_([gen.sleep(10),
                             {"type": "info", "f": "start"},
                             gen.sleep(10),
                             {"type": "info", "f": "stop"}]),
                gen.stagger(1, independent.concurrent_generator(
                    1, itertools.count(), lambda k: [ri, cw1, r, cw2, r])),
            ),
        ),
    }


# ---------------------------------------------------------------------------
# causal-reverse (strict serializability probe)


def precedence_graph(history) -> dict:
    """write value -> set of writes acknowledged before its invocation
    (causal_reverse.clj:21-49)."""
    completed: set = set()
    expected: dict = {}
    for op in history:
        f = op.f if hasattr(op, "f") else op.get("f")
        if f != "write":
            continue
        typ = op.type if hasattr(op, "type") else op.get("type")
        v = op.value if hasattr(op, "value") else op.get("value")
        if typ == "invoke":
            expected[v] = set(completed)
        elif typ == "ok":
            completed.add(v)
    return expected


def reverse_errors(history, expected: dict) -> list:
    """Reads showing w_i but missing some w_j acknowledged before w_i
    (causal_reverse.clj:50-73)."""
    errors = []
    for op in history:
        if not getattr(op, "is_ok", False) or op.f != "read":
            continue
        seen = set(op.value or [])
        ours: set = set()
        for v in seen:
            ours |= expected.get(v, set())
        missing = ours - seen
        if missing:
            errors.append({
                "op": repr(op),
                "missing": sorted(missing),
                "expected_count": len(ours),
            })
    return errors


def reverse_checker() -> Checker:
    """causal_reverse.clj:75-84."""

    def chk(test, history, opts):
        expected = precedence_graph(history)
        errors = reverse_errors(history, expected)
        return {"valid": not errors, "errors": errors}

    return checker_fn(chk, "causal-reverse")


def reverse_workload(opts: Optional[dict] = None) -> dict:
    """causal_reverse.clj:86-113."""
    o = dict(opts or {})
    n = len(o.get("nodes") or [1])
    per_key = o.get("per-key-limit", 500)
    counter = itertools.count()

    def writes(test=None, ctx=None):
        return {"type": "invoke", "f": "write", "value": next(counter)}

    def reads(test=None, ctx=None):
        return {"type": "invoke", "f": "read", "value": None}

    return {
        "checker": jchecker.compose({
            "sequential": independent.checker(reverse_checker()),
        }),
        "generator": independent.concurrent_generator(
            n, itertools.count(),
            lambda k: gen.limit(per_key, gen.stagger(
                0.01, gen.mix([reads, writes])))),
    }
