"""Deterministic generator simulation — no threads, no wall clock.

The port of the reference's ``jepsen_tpu/generator/sim.py``, which mirrors jepsen/src/jepsen/generator/test.clj: plays a generator against a
synthetic completion function under a pinned RNG (seed 45100), maintaining a
sorted in-flight completion set. This is both the unit-test vehicle for the
combinators and their executable spec (SURVEY.md §4)."""

from __future__ import annotations

from typing import Callable, Optional

from . import (
    Context,
    INVOKE,
    NEMESIS,
    PENDING,
    Validate,
    context,
    fixed_rand,
    next_process,
    op as gen_op,
    process_to_thread,
    update as gen_update,
)

DEFAULT_TEST: dict = {}
RAND_SEED = 45100  # generator/test.clj:43-47
PERFECT_LATENCY = 10  # ns, generator/test.clj:124-126


def n_plus_nemesis_context(n: int) -> Context:
    return context({"concurrency": n})


def default_context() -> Context:
    return n_plus_nemesis_context(2)


def invocations(history: list[dict]) -> list[dict]:
    return [o for o in history if o.get("type") == INVOKE]


def simulate(gen, complete_fn: Callable, ctx: Optional[Context] = None,
             test: Optional[dict] = None) -> list[dict]:
    """Simulate a generator to exhaustion (generator/test.clj:49-106).

    ``complete_fn(ctx, invoke) -> completion-op`` decides each op's fate.
    Returns the full history (invocations + completions interleaved by
    time)."""
    if ctx is None:
        ctx = default_context()
    if test is None:
        test = DEFAULT_TEST
    with fixed_rand(RAND_SEED):
        ops: list[dict] = []
        in_flight: list[dict] = []  # sorted by time
        gen = Validate(gen)
        while True:
            res = gen_op(gen, test, ctx)
            if res is None:
                return ops + in_flight
            invoke, gen2 = res
            if invoke is not PENDING and (
                not in_flight or invoke["time"] <= in_flight[0]["time"]
            ):
                # Apply the invocation: advance clock, occupy the thread.
                thread = process_to_thread(ctx, invoke["process"])
                ctx = ctx.with_(
                    time=max(ctx.time, invoke["time"]),
                    free_threads=ctx.free_threads - {thread},
                )
                gen = gen_update(gen2, test, ctx, invoke)
                complete = complete_fn(ctx, invoke)
                in_flight = sorted(in_flight + [complete], key=lambda o: o["time"])
                ops.append(invoke)
            else:
                # Complete something before the next invocation can apply.
                assert in_flight, "generator pending and nothing in flight???"
                o = in_flight[0]
                thread = process_to_thread(ctx, o["process"])
                ctx = ctx.with_(
                    time=max(ctx.time, o["time"]),
                    free_threads=ctx.free_threads | {thread},
                )
                gen = gen_update(gen, test, ctx, o)
                if thread != NEMESIS and o.get("type") == "info":
                    workers = dict(ctx.workers)
                    workers[thread] = next_process(ctx, thread)
                    ctx = ctx.with_(workers=workers)
                ops.append(o)
                in_flight = in_flight[1:]


def with_nemesis(nemesis, complete_fn, test: Optional[dict] = None):
    """Wrap ``complete_fn`` so nemesis-track invocations route through a
    real :class:`..nemesis.Nemesis` instance (its completion
    keeps the op's time + PERFECT_LATENCY unless the nemesis set one) —
    lets the simulated generator drive stateful fault injectors like
    the reference's process-pause nemesis (its nemesis/pause.py)."""

    def complete(ctx, op):
        if op.get("process") == NEMESIS:
            res = dict(nemesis.invoke(test or DEFAULT_TEST, op))
            if res.get("time") == op.get("time"):
                res["time"] = op["time"] + PERFECT_LATENCY
            res.setdefault("type", "info")
            return res
        return complete_fn(ctx, op)

    return complete


def quick_ops(gen, ctx=None, test=None):
    """Every op succeeds instantly with zero latency."""
    return simulate(gen, lambda ctx, o: {**o, "type": "ok"}, ctx, test)


def quick(gen, ctx=None, test=None):
    return invocations(quick_ops(gen, ctx, test))


def perfect_star(gen, ctx=None):
    """Every op succeeds in 10 ns; full history."""
    return simulate(
        gen, lambda ctx, o: {**o, "type": "ok", "time": o["time"] + PERFECT_LATENCY}, ctx
    )


def perfect(gen, ctx=None):
    return invocations(perfect_star(gen, ctx))


def perfect_info(gen, ctx=None):
    """Every op crashes (:info) in 10 ns; invocations only."""
    return invocations(
        simulate(
            gen,
            lambda ctx, o: {**o, "type": "info", "time": o["time"] + PERFECT_LATENCY},
            ctx,
        )
    )


def imperfect(gen, ctx=None):
    """Threads rotate fail -> info -> ok; full history
    (generator/test.clj:163-180)."""
    state: dict = {}
    rot = {None: "fail", "fail": "info", "info": "ok", "ok": "fail"}

    def complete(ctx, o):
        t = process_to_thread(ctx, o["process"])
        state[t] = rot[state.get(t)]
        return {**o, "type": state[t], "time": o["time"] + PERFECT_LATENCY}

    return simulate(gen, complete, ctx)
