"""Distributed lock / semaphore workloads over the mutex model family.

The port of the reference's ``jepsen_tpu/workloads/lock.py``: the
hazelcast suite's CP-subsystem locks and semaphores
(hazelcast.clj:515-733), the acquire/release generators per client, and
the checkers, linearizability against one of the mutex-family models
(``models.mutex``) on the GPU search composed with the op statistics.
Clients record::

    {"f": "acquire", "value": None}   -> ok value = fence token (or None)
    {"f": "release", "value": None}

and a semaphore's ops carry their permit count as the value.
"""

from __future__ import annotations

from typing import Optional

from .. import checker as jchecker
from .. import generator as gen
from ..models import (FencedMutex, Mutex, OwnerAwareMutex, ReentrantFencedMutex,
                      ReentrantMutex, Semaphore)

MODELS = {
    "mutex": Mutex,
    "owner-aware-mutex": OwnerAwareMutex,
    "reentrant-mutex": ReentrantMutex,
    "fenced-mutex": FencedMutex,
    "reentrant-fenced-mutex": ReentrantFencedMutex,
}

# The semaphore's permit count: the checker's Semaphore(capacity) and the
# node side's CP-semaphore must agree.
DEFAULT_CAPACITY = 2


def acquire(test=None, ctx=None):
    return {"type": "invoke", "f": "acquire", "value": None}


def release(test=None, ctx=None):
    return {"type": "invoke", "f": "release", "value": None}


def _linearizable(model, o: dict) -> jchecker.Checker:
    """``{"linear": linearizable, "stats": stats}``. ``backend`` is any of
    ``checker.linearizable``'s (``"device"``, ``"auto"``, ``"native"``,
    ``"competition"``, ``"sharded"``, ``"host"``) and defaults to
    ``"device"``, where the reference's defaults to ``"auto"``: the port's
    entry points run the GPU unless asked otherwise. ``device`` is the
    torch device (the GPU by default)."""
    return jchecker.compose({
        "linear": jchecker.linearizable(model=model, backend=o.get("backend", "device"),
                                        device=o.get("device")),
        "stats": jchecker.stats(),
    })


def checker(opts: Optional[dict] = None) -> jchecker.Checker:
    """The lock workload's checker, against one of :data:`MODELS`
    (``model``, default ``"reentrant-mutex"``)."""
    o = dict(opts or {})
    return _linearizable(MODELS[o.get("model") or "reentrant-mutex"](), o)


def semaphore_checker(opts: Optional[dict] = None) -> jchecker.Checker:
    """The counting-semaphore workload's checker (AcquiredPermitsModel,
    hazelcast.clj:630-649), ``capacity`` permits (default
    :data:`DEFAULT_CAPACITY`)."""
    o = dict(opts or {})
    return _linearizable(Semaphore(int(o.get("capacity") or DEFAULT_CAPACITY)), o)


def lock_generator():
    """Each thread alternates acquire/release (the hazelcast workloads'
    per-client discipline, hazelcast.clj:652-733); threads may still race
    and double-release, which is what the model checks."""
    return gen.each_thread(gen.flip_flop(acquire, release))


def lock_test(opts: Optional[dict] = None) -> dict:
    """A lock workload checked against one of the mutex-family models.
    opts: ``model`` (a name from :data:`MODELS`), ``backend``, ``device``."""
    return {"checker": checker(opts), "generator": lock_generator()}


def semaphore_test(opts: Optional[dict] = None) -> dict:
    """Counting-semaphore workload (AcquiredPermitsModel,
    hazelcast.clj:630-649); op values carry permit counts."""

    def acq(test=None, ctx=None):
        return {"type": "invoke", "f": "acquire", "value": 1}

    def rel(test=None, ctx=None):
        return {"type": "invoke", "f": "release", "value": 1}

    return {"checker": semaphore_checker(opts),
            "generator": gen.each_thread(gen.flip_flop(acq, rel))}
