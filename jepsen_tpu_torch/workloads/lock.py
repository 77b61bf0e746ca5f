"""Distributed lock / semaphore workloads over the mutex model family.

The port of the checker halves of the reference's
``jepsen_tpu/workloads/lock.py``: the hazelcast suite's CP-subsystem locks
and semaphores (hazelcast.clj:515-733), checked for linearizability
against one of the mutex-family models (``models.mutex``) on the GPU
search, composed with the op statistics. Clients record::

    {"f": "acquire", "value": None}   -> ok value = fence token (or None)
    {"f": "release", "value": None}

and a semaphore's ops carry their permit count as the value.
"""

from __future__ import annotations

from typing import Optional

from .. import checker as jchecker
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

GENERATORS_SLICE = ("the lock generators run tests rather than check them; they come "
                    "with a later slice of the port (the test runner)")


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
    raise ValueError(GENERATORS_SLICE)


def lock_test(opts: Optional[dict] = None) -> dict:
    raise ValueError(GENERATORS_SLICE)


def semaphore_test(opts: Optional[dict] = None) -> dict:
    raise ValueError(GENERATORS_SLICE)
