"""Workload library and the in-process fake cluster.

The port of the reference's ``jepsen_tpu/workloads/__init__.py``
(jepsen.tests, jepsen/src/jepsen/tests.clj): the ``noop-test`` base map
and an in-process fake cluster, an atom-backed DB and CAS-register
client, which run the whole framework end to end with no real nodes
(tests.clj:27-67; exercised by jepsen/test/jepsen/core_test.clj:61-120).
The submodules hold the workloads' generators and checkers: the
transactional ones (:mod:`.append`, :mod:`.wr`), the lock and semaphore
(:mod:`.lock`), the keyed register (:mod:`.linearizable_register`), and
the bank, causal, long-fork and Adya G2 workloads (:mod:`.bank`,
:mod:`.causal`, :mod:`.long_fork`, :mod:`.adya`).
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Optional

from .. import checker as jchecker
from .. import client as jclient
from .. import nemesis as jnemesis
from ..history import OK, FAIL


def noop_test() -> dict:
    """Boring test stub; basis for more complex tests (tests.clj:12-25).
    Net/OS/DB/remote entries are filled in by core defaults when
    the corresponding layers are configured."""
    return {
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "name": "noop",
        "client": jclient.noop(),
        "nemesis": jnemesis.noop(),
        "generator": None,
        "checker": jchecker.unbridled_optimism(),
    }


class AtomDB:
    """A "database" that is just a shared cell (tests.clj:27-32).
    setup! resets it to 0; teardown! marks it done."""

    def __init__(self, state: "AtomState"):
        self.state = state

    def setup(self, test, node):
        self.state.reset(0)

    def teardown(self, test, node):
        self.state.reset("done")


class AtomState:
    """The shared register: a lock-protected cell standing in for the
    reference's clojure atom."""

    def __init__(self, value: Any = 0):
        self._value = value
        self._lock = threading.Lock()

    def reset(self, v: Any) -> Any:
        with self._lock:
            self._value = v
        return v

    def get(self) -> Any:
        with self._lock:
            return self._value

    def cas(self, cur: Any, new: Any) -> bool:
        with self._lock:
            if self._value == cur:
                self._value = new
                return True
            return False


class AtomClient(jclient.Client):
    """CAS client over an AtomState (tests.clj:34-67). ``meta_log`` records
    lifecycle calls so integration tests can assert open/setup/close counts
    (core_test.clj:100-109)."""

    def __init__(self, state: AtomState, meta_log: Optional[list] = None,
                 latency: float = 0.001):
        self.state = state
        self.meta_log = meta_log if meta_log is not None else []
        self.latency = latency

    def open(self, test, node):
        self.meta_log.append("open")
        return self

    def setup(self, test):
        self.meta_log.append("setup")

    def teardown(self, test):
        self.meta_log.append("teardown")

    def close(self, test):
        self.meta_log.append("close")

    def invoke(self, test, op):
        # Sleep to make sure we actually get some concurrency
        # (tests.clj:50-51); latency=0 for scheduler throughput
        # benchmarks, where the default 1 ms IS the measured ceiling.
        if self.latency:
            _time.sleep(self.latency)
        f = op.get("f")
        if f == "write":
            self.state.reset(op.get("value"))
            return {**op, "type": OK}
        if f == "cas":
            cur, new = op.get("value")
            return {**op, "type": OK if self.state.cas(cur, new) else FAIL}
        if f == "read":
            return {**op, "type": OK, "value": self.state.get()}
        raise ValueError(f"unknown f: {f!r}")


def atom_client(state: Optional[AtomState] = None,
                meta_log: Optional[list] = None) -> AtomClient:
    return AtomClient(state if state is not None else AtomState(), meta_log)
