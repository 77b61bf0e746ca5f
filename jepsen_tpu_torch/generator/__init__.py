"""Pure-functional operation-scheduling DSL.

The port of the reference's ``jepsen_tpu/generator/__init__.py``, with the
same combinators, module RNG and ``fixed_rand`` pin, so that a seeded
simulation gives the reference's ops. The reference's generator system (jepsen/src/jepsen/generator.clj) models a
schedule as an immutable value with two operations::

    op(gen, test, ctx)        -> None | PENDING | (op-map, gen')
    update(gen, test, ctx, e) -> gen'

``None`` means exhausted; ``PENDING`` means "nothing to do yet, ask again";
otherwise the generator returns the next operation plus its successor state.
``update`` folds scheduler events (invocations and completions) back into
the generator (generator.clj:381-386). The *context* carries the logical
clock, the set of free worker threads, and the thread→process map
(generator.clj:433-444).

Python value types are generators too (generator.clj:525-600 extends the
protocol over maps/seqs/fns/delays):

- ``None``      — the empty generator
- ``dict``      — yields itself once, with :process/:time/:type filled from
                  the context (``fill_in_op``, generator.clj:511-523)
- ``list``/``tuple`` — a sequence of generators, run till each is exhausted;
                  updates go to the head
- callables     — called with (test, ctx) (or no args) to produce a fresh
                  generator each time; an endless stream until it returns None

All the reference combinators are provided under their reference names
(trailing underscore where Python collides): validate, friendly_exceptions,
trace, map_/f_map, filter_, on_update, on_threads/on, any_, each_thread,
reserve, clients, nemesis, mix, limit, once, log_, repeat_, process_limit,
time_limit, stagger, delay, sleep, synchronize, phases, then, until_ok,
flip_flop, concat (generator.clj:652-1428).

Randomness goes through a module RNG so the deterministic simulator
(:mod:`.sim`) can pin it (the reference's
``with-fixed-rand-int``, generator/test.clj:30-47).
"""

from __future__ import annotations

import inspect
import logging
import functools
import random as _random
import threading
from typing import Any, Callable, Iterable, Optional

LOG = logging.getLogger("jepsen.generator")

from ..history import FAIL, INFO, INVOKE, NEMESIS, OK  # single source of truth

# Generator-only op types (interpreted by the scheduler, never in history).
SLEEP, LOG_TYPE = "sleep", "log"


class _Pending:
    __slots__ = ()

    def __repr__(self) -> str:
        return ":pending"


PENDING = _Pending()


# ---------------------------------------------------------------------------
# RNG indirection (pinnable for deterministic simulation)

_rng_local = threading.local()


def _rng() -> _random.Random:
    r = getattr(_rng_local, "rng", None)
    return r if r is not None else _random


class fixed_rand:
    """Context manager pinning this thread's generator RNG to a seed."""

    def __init__(self, seed: int):
        self.seed = seed

    def __enter__(self):
        self.prev = getattr(_rng_local, "rng", None)
        _rng_local.rng = _random.Random(self.seed)
        return self

    def __exit__(self, *exc):
        _rng_local.rng = self.prev
        return False


def rand_int(n: int) -> int:
    return _rng().randrange(n) if n > 0 else 0


def rand_float(x: float) -> float:
    return _rng().random() * x


def secs_to_nanos(s: float) -> int:
    return int(s * 1e9)


# ---------------------------------------------------------------------------
# Context


class Context:
    """Scheduler context: logical time (ns), free threads, thread→process.

    Threads are ints 0..concurrency-1 plus the string "nemesis"
    (generator.clj:433-444).
    """

    __slots__ = ("time", "free_threads", "workers", "_flist", "_restrict")

    def __init__(self, time: int, free_threads: frozenset, workers: dict):
        self.time = time
        self.free_threads = free_threads
        self.workers = workers
        # Lazy per-instance caches (sound: contexts are immutable).
        self._flist = None
        self._restrict = None

    def with_(self, time=None, free_threads=None, workers=None) -> "Context":
        return Context(
            self.time if time is None else time,
            self.free_threads if free_threads is None else frozenset(free_threads),
            self.workers if workers is None else workers,
        )

    def free_thread_list(self) -> tuple:
        # Deterministic order: numeric threads sorted, nemesis last.
        # Tuple, not list: the value is cached, so it must be immutable.
        # Split by type and sort without a key fn: a keyed sort over
        # ~concurrency threads ran every scheduler step and dominated
        # high-concurrency interpreter profiles.
        if self._flist is None:
            ints = []
            names = []
            for t in self.free_threads:
                (ints if type(t) is int else names).append(t)
            ints.sort()
            names.sort(key=str)
            self._flist = tuple(ints) + tuple(names)
        return self._flist

    def __repr__(self) -> str:
        return (
            f"<ctx t={self.time} free={sorted(map(str, self.free_threads))} "
            f"workers={self.workers}>"
        )


def context(test: dict) -> Context:
    """Build the initial context for a test map (generator.clj:433-444):
    threads = nemesis + concurrency ints; every thread starts free, process
    = thread."""
    threads = [NEMESIS] + list(range(test.get("concurrency", 0)))
    return Context(0, frozenset(threads), {t: t for t in threads})


def free_processes(ctx: Context) -> list:
    return [ctx.workers[t] for t in ctx.free_thread_list()]


def some_free_process(ctx: Context):
    free = ctx.free_thread_list()
    if not free:
        return None
    return ctx.workers[free[rand_int(len(free))]]


def all_processes(ctx: Context) -> list:
    return list(ctx.workers.values())


def all_threads(ctx: Context) -> list:
    return list(ctx.workers.keys())


def process_to_thread(ctx: Context, process):
    for t, p in ctx.workers.items():
        if p == process:
            return t
    return None


def thread_to_process(ctx: Context, thread):
    return ctx.workers.get(thread)


def next_process(ctx: Context, thread):
    """Process id for a thread whose process just crashed: old process +
    number of numeric processes (generator.clj:499-507). Use with the
    global context only."""
    if isinstance(thread, int):
        return ctx.workers[thread] + sum(
            1 for p in all_processes(ctx) if isinstance(p, int)
        )
    return thread


def fill_in_op(op: dict, ctx: Context):
    """Fill :time/:process/:type from context; PENDING if no process free
    (generator.clj:511-523)."""
    p = some_free_process(ctx)
    if p is None:
        return PENDING
    out = dict(op)
    # Like the reference's (nil? ...) checks: an explicit None means absent.
    if out.get("time") is None:
        out["time"] = ctx.time
    if out.get("process") is None:
        out["process"] = p
    if out.get("type") is None:
        out["type"] = INVOKE
    return out


# ---------------------------------------------------------------------------
# Protocol dispatch


class Generator:
    """Base class for combinator generators."""

    def op(self, test: dict, ctx: Context):
        raise NotImplementedError

    def update(self, test: dict, ctx: Context, event: dict):
        return self

    def __repr__(self) -> str:
        fields = ", ".join(
            f"{k}={getattr(self, k)!r}" for k in getattr(self, "__slots__", ())[:3]
        )
        return f"<{type(self).__name__} {fields}>"


def op(gen, test: dict, ctx: Context):
    """Protocol dispatch over generator-ish values (generator.clj:525-600)."""
    while True:
        if gen is None:
            return None
        if isinstance(gen, Generator):
            return gen.op(test, ctx)
        if isinstance(gen, dict):
            filled = fill_in_op(gen, ctx)
            if filled is PENDING:
                return (PENDING, gen)
            return (filled, None)
        if isinstance(gen, (list, tuple)):
            seq = list(gen)
            if not seq:
                return None
            res = op(seq[0], test, ctx)
            if res is None:
                gen = seq[1:]
                continue
            o, g1 = res
            rest = seq[1:]
            return (o, [g1] + rest if rest else g1)
        if callable(gen):
            x = _call_gen_fn(gen, test, ctx)
            if x is None:
                return None
            if type(x) is dict:
                # Fast path for the overwhelmingly common fn->op-map
                # case: skip the [x, gen] list round trip (the list
                # branch would return (filled, [None, gen]), which the
                # next call walks back to plain ``gen`` anyway).
                filled = fill_in_op(x, ctx)
                if filled is PENDING:
                    return (PENDING, [x, gen])
                return (filled, gen)
            return op([x, gen], test, ctx)
        raise TypeError(f"not a generator: {gen!r}")


def update(gen, test: dict, ctx: Context, event: dict):
    # Identity convention (throughput-critical): every combinator's
    # update returns ``self``/``gen`` UNCHANGED when the wrapped
    # generator came back identical, so a no-op update of a deep stack
    # allocates nothing. Two updates run per completed op; the wrapper
    # churn dominated interpreter throughput before this.
    if gen is None:
        return None
    if isinstance(gen, Generator):
        return gen.update(test, ctx, event)
    if isinstance(gen, dict):
        return gen
    if isinstance(gen, (list, tuple)):
        if not gen:
            return None
        g2 = update(gen[0], test, ctx, event)
        if g2 is gen[0]:
            return gen
        return [g2, *gen[1:]]
    if callable(gen):
        return gen
    raise TypeError(f"not a generator: {gen!r}")


# Keyed by __code__ so closure instances share one entry and the cache
# doesn't pin per-test closures (and their captured state) forever.
_ARITY_CACHE: dict = {}


def _arity(f) -> int:
    try:
        sig = inspect.signature(f)
        return len(
            [
                p
                for p in sig.parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty
            ]
        )
    except (ValueError, TypeError):
        return 0


def _call_gen_fn(f, test, ctx):
    code = getattr(f, "__code__", None)
    if code is not None:
        nargs = _ARITY_CACHE.get(code)
        if nargs is None:
            nargs = _ARITY_CACHE[code] = _arity(f)
    else:
        nargs = _arity(f)
    return f(test, ctx) if nargs >= 2 else f()


# ---------------------------------------------------------------------------
# Validation & error wrapping


class InvalidOp(Exception):
    pass


_VALID_TYPES = {INVOKE, INFO, SLEEP, LOG_TYPE}


class Validate(Generator):
    """Checks well-formedness of emitted ops (generator.clj:602-656)."""

    __slots__ = ("gen",)

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        if not (isinstance(res, tuple) and len(res) == 2):
            raise InvalidOp(f"generator should return an (op, gen') pair, got {res!r}")
        o, g = res
        if o is not PENDING:
            problems = []
            if not isinstance(o, dict):
                problems.append("op should be either PENDING or a dict")
            else:
                if o.get("type") not in _VALID_TYPES:
                    problems.append(
                        f":type should be one of {sorted(_VALID_TYPES)}, got {o.get('type')!r}"
                    )
                if not isinstance(o.get("time"), (int, float)):
                    problems.append(":time should be a number")
                if o.get("process") is None:
                    problems.append("no :process")
                elif o.get("process") not in free_processes(ctx):
                    problems.append(f"process {o.get('process')!r} is not free")
            if problems:
                raise InvalidOp(
                    "generator produced an invalid op: "
                    + f"{o!r}; problems: {problems}; context: {ctx!r}"
                )
        return (o, Validate(g))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else Validate(g2)


validate = Validate


class FriendlyExceptions(Generator):
    """Wraps errors from the underlying generator with the context that
    produced them (generator.clj:658-698)."""

    __slots__ = ("gen",)

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        try:
            res = op(self.gen, test, ctx)
        except Exception as e:
            raise RuntimeError(
                f"generator threw {type(e).__name__} when asked for an op in ctx {ctx!r}"
            ) from e
        if res is None:
            return None
        o, g = res
        return (o, FriendlyExceptions(g))

    def update(self, test, ctx, event):
        try:
            g2 = update(self.gen, test, ctx, event)
            return self if g2 is self.gen else FriendlyExceptions(g2)
        except Exception as e:
            raise RuntimeError(
                f"generator threw {type(e).__name__} when updated with {event!r}"
            ) from e


friendly_exceptions = FriendlyExceptions


class Trace(Generator):
    """Logs every op/update through this point (generator.clj:700-760)."""

    __slots__ = ("k", "gen")

    def __init__(self, k, gen):
        self.k = k
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        LOG.info("%s op -> %r", self.k, None if res is None else res[0])
        if res is None:
            return None
        return (res[0], Trace(self.k, res[1]))

    def update(self, test, ctx, event):
        LOG.info("%s update <- %r", self.k, event)
        return Trace(self.k, update(self.gen, test, ctx, event))


trace = Trace


# ---------------------------------------------------------------------------
# Transformations


class Map(Generator):
    __slots__ = ("f", "gen")

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g = res
        return (o if o is PENDING else self.f(o), Map(self.f, g))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else Map(self.f, g2)


def map_(f, gen):
    """Transform each emitted op with f (generator.clj:762-768)."""
    return Map(f, gen)


def f_map(fm: dict, gen):
    """Rename op :f fields through the map fm (generator.clj:770-776) —
    used when composing nemesis packages."""

    def transform(o):
        o = dict(o)
        o["f"] = fm.get(o.get("f"), o.get("f"))
        return o

    return Map(transform, gen)


class Filter(Generator):
    __slots__ = ("f", "gen")

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        gen = self.gen
        while True:
            res = op(gen, test, ctx)
            if res is None:
                return None
            o, g = res
            if o is PENDING or self.f(o):
                return (o, Filter(self.f, g))
            gen = g

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else Filter(self.f, g2)


def filter_(f, gen):
    """Pass only ops matching f; PENDING passes through
    (generator.clj:779-798)."""
    return Filter(f, gen)


class OnUpdate(Generator):
    """Custom update handler: f(this, test, ctx, event) -> gen'
    (generator.clj:808-823)."""

    __slots__ = ("f", "gen")

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        return (res[0], OnUpdate(self.f, res[1]))

    def update(self, test, ctx, event):
        return self.f(self, test, ctx, event)


on_update = OnUpdate


# ---------------------------------------------------------------------------
# Thread routing


# (pred, id(workers)) -> (workers ref, allowed thread set, restricted
# workers dict). Thread ids are fixed for a run and workers dicts are
# immutable (replaced wholesale on process bumps), so the Python-level
# pred sweep runs once per (pred, workers-generation) instead of per
# scheduler step; holding the dict ref keeps the id stable. Bounded by
# a clear-on-overflow (generations = info-op count, normally tiny).
_RESTRICT_MEMO: dict = {}
_RESTRICT_MEMO_MAX = 4096


def on_threads_context(pred: Callable[[Any], bool], ctx: Context) -> Context:
    """Restrict a context to threads satisfying pred (generator.clj:826-843).

    Memoized per (ctx, pred): a deep generator stack restricts the same
    immutable context several times per scheduler step, which dominated
    interpreter throughput before caching. The pred sweep itself is
    additionally memoized per workers-generation (see _RESTRICT_MEMO),
    so steady-state restriction is one C-level set intersection."""
    cache = ctx._restrict
    if cache is None:
        cache = ctx._restrict = {}
    try:
        hit = cache.get(pred)
    except TypeError:  # unhashable pred: build uncached
        hit = None
        cache = None
    if hit is None:
        ent = None
        key = (pred, id(ctx.workers)) if cache is not None else None
        if key is not None:
            ent = _RESTRICT_MEMO.get(key)
            if ent is not None and ent[0] is not ctx.workers:
                ent = None
        if ent is None:
            allowed = frozenset(t for t in ctx.workers if pred(t))
            rworkers = {t: p for t, p in ctx.workers.items()
                        if t in allowed}
            ent = (ctx.workers, allowed, rworkers)
            if key is not None:
                if len(_RESTRICT_MEMO) > _RESTRICT_MEMO_MAX:
                    _RESTRICT_MEMO.clear()
                _RESTRICT_MEMO[key] = ent
        _, allowed, rworkers = ent
        hit = ctx.with_(free_threads=ctx.free_threads & allowed,
                        workers=rworkers)
        if cache is not None:
            cache[pred] = hit
    return hit


class OnThreads(Generator):
    """Restrict the wrapped generator to threads satisfying pred
    (generator.clj:845-864)."""

    __slots__ = ("pred", "gen")

    def __init__(self, pred, gen):
        self.pred = pred
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, on_threads_context(self.pred, ctx))
        if res is None:
            return None
        return (res[0], OnThreads(self.pred, res[1]))

    def update(self, test, ctx, event):
        if self.pred(process_to_thread(ctx, event.get("process"))):
            g2 = update(self.gen, test,
                        on_threads_context(self.pred, ctx), event)
            return self if g2 is self.gen else OnThreads(self.pred, g2)
        return self


def rand_int_seq(seed: Optional[int] = None):
    """A reproducible infinite stream of random ints for a seed
    (generator.clj:445-452)."""
    rng = _random.Random(seed if seed is not None else rand_int(2**31))
    while True:
        yield rng.getrandbits(63)


def on_threads(pred, gen):
    return OnThreads(pred, gen)




# `on` is the reference's short alias for on-threads (generator.clj:856).
on = on_threads


def soonest_op_map(m1: Optional[dict], m2: Optional[dict]) -> Optional[dict]:
    """Pick whichever {op, ..., weight} map happens sooner; break time ties
    randomly, weighted (generator.clj:866-908)."""
    if m1 is None:
        return m2
    if m2 is None:
        return m1
    o1, o2 = m1["op"], m2["op"]
    if o1 is PENDING:
        return m2
    if o2 is PENDING:
        return m1
    t1, t2 = o1.get("time"), o2.get("time")
    if t1 == t2:
        w1 = m1.get("weight", 1)
        w2 = m2.get("weight", 1)
        out = dict(m1 if rand_int(w1 + w2) < w1 else m2)
        out["weight"] = w1 + w2
        return out
    return m1 if t1 < t2 else m2


class Any(Generator):
    """Ops from whichever sub-generator is soonest; updates to all
    (generator.clj:910-934)."""

    __slots__ = ("gens",)

    def __init__(self, gens):
        self.gens = list(gens)

    def op(self, test, ctx):
        soonest = None
        for i, g in enumerate(self.gens):
            res = op(g, test, ctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1], "i": i}
                )
        if soonest is None:
            return None
        gens = list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return (soonest["op"], Any(gens))

    def update(self, test, ctx, event):
        gens = [update(g, test, ctx, event) for g in self.gens]
        if all(g2 is g for g2, g in zip(gens, self.gens)):
            return self
        return Any(gens)


def any_(*gens):
    if not gens:
        return None
    if len(gens) == 1:
        return gens[0]
    return Any(gens)


class EachThread(Generator):
    """An independent copy of the generator per thread; each copy sees a
    single-thread context (generator.clj:936-988)."""

    __slots__ = ("fresh", "gens")

    def __init__(self, fresh, gens=None):
        self.fresh = fresh
        self.gens = gens or {}

    def _thread_ctx(self, ctx, thread):
        return ctx.with_(
            free_threads=frozenset([thread]),
            workers={thread: ctx.workers[thread]},
        )

    def op(self, test, ctx):
        soonest = None
        for thread in ctx.free_thread_list():
            g = self.gens.get(thread, self.fresh)
            res = op(g, test, self._thread_ctx(ctx, thread))
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1], "thread": thread}
                )
        if soonest is not None:
            gens = dict(self.gens)
            gens[soonest["thread"]] = soonest["gen"]
            return (soonest["op"], EachThread(self.fresh, gens))
        if len(ctx.free_threads) != len(ctx.workers):
            return (PENDING, self)  # busy thread may still want ops later
        return None  # every thread exhausted

    def update(self, test, ctx, event):
        thread = process_to_thread(ctx, event.get("process"))
        if thread is None:
            return self
        g = self.gens.get(thread, self.fresh)
        tctx = ctx.with_(
            free_threads=frozenset(t for t in ctx.free_threads if t == thread),
            workers={thread: event.get("process")},
        )
        g2 = update(g, test, tctx, event)
        if g2 is g and thread in self.gens:
            return self
        gens = dict(self.gens)
        gens[thread] = g2
        return EachThread(self.fresh, gens)


each_thread = EachThread


@functools.lru_cache(maxsize=None)
def _in_set_pred(s: frozenset):
    """A stable membership predicate per thread set, so
    on_threads_context's identity-keyed memo can hit (the sets are the
    handful of reserve/group ranges a test declares, so the cache stays
    tiny)."""
    return lambda t: t in s


@functools.lru_cache(maxsize=None)
def _not_in_set_pred(s: frozenset):
    return lambda t: t not in s


class Reserve(Generator):
    """Dedicated thread ranges per generator + a default
    (generator.clj:990-1070)."""

    __slots__ = ("ranges", "all_ranges", "gens")

    def __init__(self, ranges, all_ranges, gens):
        self.ranges = ranges  # list[frozenset[int]]
        self.all_ranges = all_ranges
        self.gens = gens  # len(ranges)+1, last = default

    def op(self, test, ctx):
        soonest = None
        for i, threads in enumerate(self.ranges):
            rctx = on_threads_context(_in_set_pred(threads), ctx)
            res = op(self.gens[i], test, rctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest,
                    {"op": res[0], "gen": res[1], "weight": len(threads), "i": i},
                )
        dctx = on_threads_context(_not_in_set_pred(self.all_ranges), ctx)
        res = op(self.gens[-1], test, dctx)
        if res is not None:
            soonest = soonest_op_map(
                soonest,
                {
                    "op": res[0],
                    "gen": res[1],
                    "weight": len(dctx.workers),
                    "i": len(self.ranges),
                },
            )
        if soonest is None:
            return None
        gens = list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return (soonest["op"], Reserve(self.ranges, self.all_ranges, gens))

    def update(self, test, ctx, event):
        thread = process_to_thread(ctx, event.get("process"))
        i = len(self.ranges)
        for j, r in enumerate(self.ranges):
            if thread in r:
                i = j
                break
        g2 = update(self.gens[i], test, ctx, event)
        if g2 is self.gens[i]:
            return self
        gens = list(self.gens)
        gens[i] = g2
        return Reserve(self.ranges, self.all_ranges, gens)


def reserve(*args):
    """reserve(5, write_gen, 10, cas_gen, read_gen): first 5 threads get
    write_gen, next 10 cas_gen, the rest the default
    (generator.clj:1036-1070)."""
    *pairs, default = args
    assert default is not None
    assert len(pairs) % 2 == 0
    ranges, gens = [], []
    n = 0
    for i in range(0, len(pairs), 2):
        cnt, g = pairs[i], pairs[i + 1]
        ranges.append(frozenset(range(n, n + cnt)))
        gens.append(g)
        n += cnt
    all_ranges = frozenset().union(*ranges) if ranges else frozenset()
    return Reserve(ranges, all_ranges, gens + [default])


def clients(client_gen, nemesis_gen=None):
    """Route clients to client_gen (and optionally nemesis to nemesis_gen)
    (generator.clj:1073-1083)."""
    if nemesis_gen is None:
        return on_threads(lambda t: t != NEMESIS, client_gen)
    return any_(clients(client_gen), nemesis(nemesis_gen))


def nemesis(nemesis_gen, client_gen=None):
    if client_gen is None:
        return on_threads(lambda t: t == NEMESIS, nemesis_gen)
    return any_(nemesis(nemesis_gen), clients(client_gen))


class Mix(Generator):
    """Uniform random mixture; ignores updates (generator.clj:1104-1131)."""

    __slots__ = ("i", "gens")

    def __init__(self, i, gens):
        self.i = i
        self.gens = list(gens)

    def op(self, test, ctx):
        if not self.gens:
            return None
        res = op(self.gens[self.i], test, ctx)
        if res is not None:
            gens = list(self.gens)
            gens[self.i] = res[1]
            return (res[0], Mix(rand_int(len(gens)), gens))
        gens = self.gens[: self.i] + self.gens[self.i + 1 :]
        if not gens:
            return None
        return Mix(rand_int(len(gens)), gens).op(test, ctx)

    def update(self, test, ctx, event):
        return self


def mix(gens):
    gens = list(gens)
    if not gens:
        return None
    return Mix(rand_int(len(gens)), gens)


# ---------------------------------------------------------------------------
# Bounds


class Limit(Generator):
    __slots__ = ("remaining", "gen")

    def __init__(self, remaining, gen):
        self.remaining = remaining
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining <= 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        return (res[0], Limit(self.remaining - 1, res[1]))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else Limit(self.remaining, g2)


def limit(n, gen):
    """At most n ops from gen (generator.clj:1133-1146)."""
    return Limit(n, gen)


def once(gen):
    return limit(1, gen)


def log_(msg):
    """One :log op that makes the interpreter log a message
    (generator.clj:1153-1157)."""
    return {"type": LOG_TYPE, "value": msg}


class Repeat(Generator):
    """Re-emit from the same underlying generator state forever / n times
    (generator.clj:1159-1186)."""

    __slots__ = ("remaining", "gen")

    def __init__(self, remaining, gen):
        self.remaining = remaining  # -1 = infinite
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining == 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        return (res[0], Repeat(self.remaining - 1, self.gen))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else Repeat(self.remaining, g2)


def repeat_(*args):
    if len(args) == 1:
        return Repeat(-1, args[0])
    n, gen = args
    assert n >= 0
    return Repeat(n, gen)


class ProcessLimit(Generator):
    """Emit ops for at most n distinct processes (generator.clj:1188-1213)."""

    __slots__ = ("n", "procs", "gen")

    def __init__(self, n, procs, gen):
        self.n = n
        self.procs = procs
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g = res
        if o is PENDING:
            return (o, ProcessLimit(self.n, self.procs, g))
        procs = self.procs | frozenset(all_processes(ctx))
        if len(procs) > self.n:
            return None
        return (o, ProcessLimit(self.n, procs, g))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else ProcessLimit(self.n, self.procs, g2)


def process_limit(n, gen):
    return ProcessLimit(n, frozenset(), gen)


class TimeLimit(Generator):
    """Emit ops for dt seconds after the first op (generator.clj:1215-1240)."""

    __slots__ = ("limit", "cutoff", "gen")

    def __init__(self, limit, cutoff, gen):
        self.limit = limit
        self.cutoff = cutoff
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g = res
        if o is PENDING:
            return (o, TimeLimit(self.limit, self.cutoff, g))
        cutoff = self.cutoff if self.cutoff is not None else o["time"] + self.limit
        if o["time"] >= cutoff:
            return None
        return (o, TimeLimit(self.limit, cutoff, g))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else TimeLimit(self.limit, self.cutoff, g2)


def time_limit(dt, gen):
    return TimeLimit(secs_to_nanos(dt), None, gen)


class Stagger(Generator):
    """Schedule ops at uniform random intervals in [0, 2*dt) — a *total*
    rate across all threads (generator.clj:1242-1281)."""

    __slots__ = ("dt", "next_time", "gen")

    def __init__(self, dt, next_time, gen):
        self.dt = dt
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g = res
        if o is PENDING:
            return (o, self)
        nt = self.next_time if self.next_time is not None else ctx.time
        nt2 = nt + int(rand_float(self.dt))
        if nt <= o["time"]:
            return (o, Stagger(self.dt, nt2, g))
        o = dict(o)
        o["time"] = nt
        return (o, Stagger(self.dt, nt2, g))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else Stagger(self.dt, self.next_time, g2)


def stagger(dt, gen):
    return Stagger(secs_to_nanos(2 * dt), None, gen)


class Delay(Generator):
    """Ops exactly dt apart (catching up when behind)
    (generator.clj:1318-1347)."""

    __slots__ = ("dt", "next_time", "gen")

    def __init__(self, dt, next_time, gen):
        self.dt = dt
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g = res
        if o is PENDING:
            return (o, Delay(self.dt, self.next_time, g))
        nt = self.next_time if self.next_time is not None else o["time"]
        o = dict(o)
        o["time"] = max(o["time"], nt)
        return (o, Delay(self.dt, nt + self.dt, g))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else Delay(self.dt, self.next_time, g2)


def delay(dt, gen):
    return Delay(secs_to_nanos(dt), None, gen)


def sleep(dt):
    """One :sleep op — the receiving worker idles dt seconds
    (generator.clj:1348-1352)."""
    return {"type": SLEEP, "value": dt}


class Cycle(Generator):
    """Cycle through a sequence of generators forever: run element i to
    exhaustion, then move to (i+1) mod n with a FRESH copy of the
    element (the reference writes this as Clojure's lazy ``(cycle
    [...])``; note ``repeat_`` is different — it re-emits from the same
    un-advanced generator, so ``repeat_([a b])`` yields only ``a``s)."""

    _FRESH = object()  # distinct from None (None = exhausted inner)

    __slots__ = ("elements", "i", "inner")

    def __init__(self, elements, i=0, inner=_FRESH):
        self.elements = tuple(elements)
        self.i = i
        self.inner = self.elements[i] if inner is Cycle._FRESH else inner

    def op(self, test, ctx):
        i, inner = self.i, self.inner
        for _ in range(len(self.elements) + 1):
            res = op(inner, test, ctx)
            if res is not None:
                o, g2 = res
                return (o, Cycle(self.elements, i, g2))
            i = (i + 1) % len(self.elements)
            inner = self.elements[i]
        return None  # every element is empty

    def update(self, test, ctx, event):
        g2 = update(self.inner, test, ctx, event)
        return self if g2 is self.inner else Cycle(self.elements, self.i, g2)


def cycle_(elements):
    """An endless loop over a sequence of generators."""
    elements = list(elements)
    if not elements:
        return None
    return Cycle(elements)


class Synchronize(Generator):
    """PENDING until every worker is free, then delegates
    (generator.clj:1354-1374)."""

    __slots__ = ("gen",)

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        if ctx.free_threads == frozenset(ctx.workers):
            return op(self.gen, test, ctx)
        return (PENDING, self)

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else Synchronize(g2)


synchronize = Synchronize


def phases(*gens):
    """Run each generator to completion, synchronizing between
    (generator.clj:1376-1381)."""
    return [Synchronize(g) for g in gens]


def then(a, b):
    """b, then (synchronized) a — argument order matches the reference's
    threading-macro convention (generator.clj:1383-1394)."""
    return [b, Synchronize(a)]


class UntilOk(Generator):
    """Yield ops until one completes :ok (generator.clj:1396-1414)."""

    __slots__ = ("gen", "done")

    def __init__(self, gen, done=False):
        self.gen = gen
        self.done = done

    def op(self, test, ctx):
        if self.done:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        return (res[0], UntilOk(res[1], self.done))

    def update(self, test, ctx, event):
        if event.get("type") == OK:
            return self if self.done else UntilOk(self.gen, True)
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else UntilOk(g2, self.done)


def until_ok(gen):
    return UntilOk(gen)


class FlipFlop(Generator):
    """Alternate between generators; stop when any is exhausted; ignore
    updates (generator.clj:1416-1428)."""

    __slots__ = ("gens", "i")

    def __init__(self, gens, i=0):
        self.gens = list(gens)
        self.i = i

    def op(self, test, ctx):
        res = op(self.gens[self.i], test, ctx)
        if res is None:
            return None
        gens = list(self.gens)
        gens[self.i] = res[1]
        return (res[0], FlipFlop(gens, (self.i + 1) % len(gens)))


def flip_flop(a, b):
    return FlipFlop([a, b])


def concat(*gens):
    """Concatenate arbitrary generators (generator.clj:755-761)."""
    return list(gens)
