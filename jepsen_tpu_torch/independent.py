"""Keyed histories: lift a workload to many keys, split a history by key
and check every key.

The port of the reference's ``jepsen_tpu/independent.py``
(``jepsen.independent``). A single-register workload is lifted to many
keys by wrapping op values in ``[k v]`` tuples (:class:`KV`); the lifted
checker splits the history into per-key subhistories and is
valid iff every key is. When the inner checker has ``batch_check`` (the
``linearizable`` checker does), every key is decided in one batched device
search (``parallel.check_batch``); otherwise, or when the batch refuses,
the keys are checked one after another.

On a test with a store, each key's subhistory and result go to
``independent/<k>/history.edn`` and ``results.edn`` in the run's
directory. The generators that run keyed tests are the reference's:
``tuple_gen`` wraps a generator's values in ``[k v]``,
``sequential_generator`` runs one key after another, and
``concurrent_generator`` runs keys in parallel, n worker threads a key
(independent.clj:31-226).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterable

from . import generator as gen
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


def tuple_gen(k, g):
    """Wrap a generator so its ops carry [k v] values
    (independent.clj:96-101)."""
    return gen.map_(lambda op: {**op, "value": KV(k, op.get("value"))}, g)


def sequential_generator(keys: Iterable, fgen: Callable):
    """One key at a time: run fgen(k1) to exhaustion, then k2, …
    (independent.clj:31-47). fgen must be pure."""
    return [tuple_gen(k, fgen(k)) for k in keys]


def group_threads(n: int, ctx: gen.Context) -> list[list]:
    """Partition sorted worker threads into groups of n
    (independent.clj:49-76)."""
    threads = sorted(t for t in gen.all_threads(ctx) if isinstance(t, int))
    count = len(threads)
    groups = count // n
    assert n <= count, (
        f"With {count} worker threads, concurrent-generator cannot run a key "
        f"with {n} threads concurrently. Raise :concurrency to at least {n}."
    )
    assert count == n * groups, (
        f"concurrent-generator has {count} threads but can only use "
        f"{n * groups} of them for {groups} concurrent keys with {n} threads "
        f"apiece. Raise or lower :concurrency to a multiple of {n}."
    )
    return [threads[i * n:(i + 1) * n] for i in range(groups)]


class _KeySeq:
    """A lazily-memoized view over a (possibly infinite) key iterable:
    ``get(i)`` pulls and caches up to index i. Shared by all generator
    states, so probe-and-discard evaluation never consumes keys twice."""

    __slots__ = ("it", "cache")

    def __init__(self, keys):
        if isinstance(keys, _KeySeq):
            self.it = keys.it
            self.cache = keys.cache
        elif isinstance(keys, (list, tuple)):
            self.it = iter(())
            self.cache = list(keys)
        else:
            self.it = iter(keys)
            self.cache = []

    def get(self, i: int):
        """Key at index i, or None past the end."""
        while len(self.cache) <= i:
            try:
                self.cache.append(next(self.it))
            except StopIteration:
                return None
        return self.cache[i]


class ConcurrentGenerator(gen.Generator):
    """Groups of n threads each work a key; exhausted groups pull the next
    key (independent.clj:103-209). Nemesis excluded; updates route to the
    executing thread's group."""

    __slots__ = ("n", "fgen", "group_threads", "thread_group", "keys",
                 "next_key", "gens")

    def __init__(self, n, fgen, group_threads_=None, thread_group=None,
                 keys=None, gens=None, next_key=0):
        self.n = n
        self.fgen = fgen
        self.group_threads = group_threads_
        self.thread_group = thread_group
        self.keys = keys if isinstance(keys, _KeySeq) else _KeySeq(
            keys if keys is not None else [])
        self.next_key = next_key
        self.gens = gens

    def _init(self, ctx: gen.Context):
        gt = self.group_threads or [set(g) for g in group_threads(self.n, ctx)]
        tg = self.thread_group or {
            t: gi for gi, g in enumerate(gt) for t in g
        }
        if self.gens is None:
            groups = len(gt)
            gens = []
            nk = self.next_key
            for _ in range(groups):
                k = self.keys.get(nk)
                if k is None:
                    gens.append(None)
                else:
                    gens.append(tuple_gen(k, self.fgen(k)))
                    nk += 1
        else:
            gens, nk = self.gens, self.next_key
        return gt, tg, nk, gens

    def op(self, test, ctx):
        gt, tg, nk, gens = self._init(ctx)
        free_groups = {tg[t] for t in ctx.free_threads if t in tg}
        soonest = None
        gens = list(gens)
        for group in free_groups:
            while True:
                g = gens[group]
                if g is None:
                    break
                gctx = gen.on_threads_context(
                    gen._in_set_pred(frozenset(gt[group])), ctx
                )
                res = gen.op(g, test, gctx)
                if res is None:
                    k = self.keys.get(nk)
                    if k is not None:
                        nk += 1
                        gens[group] = tuple_gen(k, self.fgen(k))
                        continue
                    gens[group] = None
                    break
                o, g2 = res
                soonest = gen.soonest_op_map(
                    soonest,
                    {"op": o, "group": group, "gen'": g2,
                     "weight": len(gt[group])},
                )
                break
        if soonest is not None and soonest.get("op") is not None:
            o = soonest["op"]
            if o is gen.PENDING:
                return (gen.PENDING, ConcurrentGenerator(
                    self.n, self.fgen, gt, tg, self.keys, gens, nk))
            gens2 = list(gens)
            gens2[soonest["group"]] = soonest["gen'"]
            return (o, ConcurrentGenerator(
                self.n, self.fgen, gt, tg, self.keys, gens2, nk))
        if any(g is not None for g in gens):
            return (gen.PENDING, ConcurrentGenerator(
                self.n, self.fgen, gt, tg, self.keys, gens, nk))
        return None

    def update(self, test, ctx, event):
        if self.thread_group is None or self.gens is None:
            return self
        thread = gen.process_to_thread(ctx, event.get("process"))
        group = self.thread_group.get(thread)
        if group is None or self.gens[group] is None:
            return self
        gens = list(self.gens)
        gens[group] = gen.update(gens[group], test, ctx, event)
        return ConcurrentGenerator(
            self.n, self.fgen, self.group_threads, self.thread_group,
            self.keys, gens, self.next_key)


def concurrent_generator(n: int, keys: Iterable, fgen: Callable):
    """n threads per key, keys taken in order as groups free up
    (independent.clj:211-236). ``keys`` may be an infinite iterable — it
    is consumed lazily with memoization."""
    assert isinstance(n, int) and n > 0
    return gen.clients(ConcurrentGenerator(n, fgen, keys=_KeySeq(keys)))


# ---------------------------------------------------------------------------
# History sharding (independent.clj:238-261)


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
