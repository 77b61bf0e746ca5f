"""Keyed histories: split a history by key and check every key.

The port of the checking half of the reference's ``jepsen_tpu/
independent.py`` (``jepsen.independent``). A single-register workload is
lifted to many keys by wrapping op values in ``[k v]`` tuples (:class:`KV`);
the lifted checker splits the history into per-key subhistories and is
valid iff every key is. When the inner checker has ``batch_check`` (the
``linearizable`` checker does), every key is decided in one batched device
search (``parallel.check_batch``); otherwise, or when the batch refuses,
the keys are checked one after another.

On a test with a store, each key's subhistory and result go to
``independent/<k>/history.edn`` and ``results.edn`` in the run's
directory. The generators that run keyed tests (``tuple_gen``,
``sequential_generator``, ``concurrent_generator``) come with a later
slice.
"""

from __future__ import annotations

import logging
from typing import Any

from . import store
from .checker import Checker, check_safe, merge_valid
from .history import History, Op

LOG = logging.getLogger("jepsen.independent")

DIR = "independent"  # the per-key results' directory in the store


class KV(tuple):
    """A key/value tuple in an op's value (a ``[k v]`` vector in EDN)."""

    __slots__ = ()

    def __new__(cls, k, v):
        return super().__new__(cls, (k, v))

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        return self[1]

    def __repr__(self):
        return f"[{self[0]!r} {self[1]!r}]"


def tuple_(k, v) -> KV:
    return KV(k, v)


def is_tuple(value: Any) -> bool:
    return isinstance(value, KV)


def _value(op):
    return op.value if isinstance(op, Op) else op.get("value")


def history_keys(history) -> set:
    """Every key a ``[k v]`` value names in ``history`` (ops or op dicts)."""
    return {v.key for v in map(_value, history) if is_tuple(v)}


def subhistory(k, history):
    """The ops without a differing key, tuples unwrapped. A history of
    :class:`Op` comes back as a :class:`History` with its indexes kept;
    anything else as a list."""
    out = []
    for op in history:
        v = _value(op)
        if not is_tuple(v):
            out.append(op)
        elif v.key == k:
            out.append(op.with_(value=v.value) if isinstance(op, Op)
                       else {**op, "value": v.value})
    if all(isinstance(o, Op) for o in out):
        return History(out, reindex=False)
    return out


class _IndependentChecker(Checker):
    def __init__(self, checker: Checker):
        self.checker = checker

    def check(self, test, history, opts=None):
        opts = opts or {}
        ks = sorted(history_keys(history), key=repr)
        subs = {k: subhistory(k, history) for k in ks}
        batch = getattr(self.checker, "batch_check", None)
        results = None
        if batch is not None and len(ks) > 1:
            try:
                results = batch(test, subs, opts)
            except Exception:
                LOG.warning("batched independent check failed; falling back to "
                            "per-key checking", exc_info=True)
        if results is None:
            results = {k: check_safe(self.checker, test, subs[k], opts) for k in ks}
        self._store_subresults(test, subs, results, opts)
        failures = [k for k in ks if results[k].get("valid") is not True]
        return {
            "valid": merge_valid(r.get("valid") for r in results.values()),
            "results": results,
            "failures": failures,
        }

    def _store_subresults(self, test, subs, results, opts):
        """Each key's ``history.edn`` and ``results.edn`` under
        ``store/<name>/<time>/independent/<k>/`` (independent.clj:288-301),
        on a test with a store; a failed key is logged."""
        if not store.wanted(test):
            return
        from . import edn

        for k, res in results.items():
            sub = subs[k]
            d = store.path_mk(test, DIR, str(k), "x").parent
            d.mkdir(parents=True, exist_ok=True)
            try:
                h = sub if isinstance(sub, History) else History(
                    [Op.from_dict(o) if isinstance(o, dict) else o for o in sub],
                    reindex=False)
                h.save(d / "history.edn")
                with open(d / "results.edn", "w") as f:
                    f.write(edn.write_string(store.to_edn_value(res)))
                    f.write("\n")
            except Exception:
                LOG.warning("could not store independent results for %r", k, exc_info=True)


def checker(inner: Checker) -> Checker:
    """Lift ``inner`` over ``[k v]``-tuple histories: valid iff valid for
    every key's subhistory. When ``inner`` has ``batch_check`` (e.g. the
    ``linearizable`` checker), every key is decided in one batched device
    search."""
    return _IndependentChecker(inner)
