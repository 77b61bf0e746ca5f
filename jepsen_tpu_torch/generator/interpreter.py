"""The runtime that turns a generator into a real history.

The port of the reference's ``jepsen_tpu/generator/interpreter.py``, which
mirrors jepsen.generator.interpreter (jepsen/src/jepsen/generator/
interpreter.clj): a single scheduler loop plus one OS thread per worker,
coupled through size-1 queues. The scheduler:

1. polls completions FIRST (latency-sensitive: a stale completion makes
   the generator believe ops are concurrent when they're not —
   interpreter.clj:215-241);
2. otherwise evaluates the pure generator for the next op
   (interpreter.clj:244-248);
3. dispatches ops whose :time has arrived to their worker's in-queue,
   sleeps until pending ops mature, and exits when the generator is
   exhausted and all outstanding ops have completed
   (interpreter.clj:252-292).

Soundness rule: a worker that catches ANY exception from a client invoke
completes the op as ``:info`` (indeterminate — the fault may have taken
effect), and the scheduler hands that thread a fresh process id so the
next op can't be confused with the crashed one
(interpreter.clj:142-157,233-236). Nemesis crashes do NOT bump the
process (the nemesis is a singleton).

Worker kinds come from the thread id: integer threads are client workers,
the ``"nemesis"`` thread drives the test's nemesis
(interpreter.clj:33-97).
"""

from __future__ import annotations

import logging
import queue
import sys
import threading
import time as _time
from typing import Any, Optional

from .. import client as jclient
from .. import nemesis as jnemesis
from ..history import INFO, INVOKE, NEMESIS
from ..util import log_op, relative_time_nanos
from . import (
    PENDING,
    Context,
    FriendlyExceptions,
    Validate,
    context as make_context,
    next_process,
    op as gen_op,
    update as gen_update,
)

LOG = logging.getLogger("jepsen.interpreter")

# Don't sleep longer than this when the generator is :pending — it may
# become ready as completions arrive (interpreter.clj:166-170).
MAX_PENDING_INTERVAL_S = 0.001

# GIL switch interval while a run is live. The scheduler thread is the
# bottleneck and every dispatched op is tiny; the default 5 ms interval
# lets freshly-woken workers preempt the scheduler mid-step, thrashing
# the GIL at high concurrency (~+17% throughput at 100 workers with
# 20 ms measured). Process-global state: a depth counter makes
# overlapping runs save/restore it exactly once (outermost wins).
SWITCH_INTERVAL_S = 0.02
_SWITCH_LOCK = threading.Lock()
_SWITCH_DEPTH = 0
_SWITCH_SAVED = 0.0


def _switch_interval_enter() -> None:
    global _SWITCH_DEPTH, _SWITCH_SAVED
    with _SWITCH_LOCK:
        _SWITCH_DEPTH += 1
        if _SWITCH_DEPTH == 1:
            _SWITCH_SAVED = sys.getswitchinterval()
            sys.setswitchinterval(max(_SWITCH_SAVED, SWITCH_INTERVAL_S))


def _switch_interval_exit() -> None:
    global _SWITCH_DEPTH
    with _SWITCH_LOCK:
        _SWITCH_DEPTH -= 1
        if _SWITCH_DEPTH == 0:
            sys.setswitchinterval(_SWITCH_SAVED)


def goes_in_history(op: dict) -> bool:
    """:sleep and :log ops are scheduler directives, not history events
    (interpreter.clj:172-179)."""
    return op.get("type") not in ("sleep", "log")


class Worker:
    """One executor of ops (interpreter.clj:19-31)."""

    def open(self, test: dict, thread_id: Any) -> "Worker":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def close(self, test: dict) -> None:
        pass


class ClientWorker(Worker):
    """Wraps a Client; re-opens it when the worker's process changes and
    the client isn't Reusable (interpreter.clj:33-67)."""

    def __init__(self, node: Any, process: Any = None,
                 client: Optional[jclient.Client] = None):
        self.node = node
        self.process = process
        self.client = client

    def invoke(self, test, op):
        if self.process != op.get("process") and not (
            self.client is not None
            and jclient.is_reusable(self.client, test)
        ):
            # Process changed; tear down the old connection, open a fresh one.
            if self.client is not None:
                try:
                    self.client.close(test)
                except Exception:
                    LOG.warning("error closing client", exc_info=True)
                self.client = None
            try:
                self.client = jclient.validate(test["client"]).open(
                    test, self.node
                )
                self.process = op.get("process")
            except Exception:
                LOG.warning(
                    "error opening client for process %s on node %s",
                    op.get("process"), self.node, exc_info=True,
                )
                return {
                    **op,
                    "type": "fail",
                    "error": ["no-client", "cannot open client"],
                }
        return self.client.invoke(test, op)

    def close(self, test):
        if self.client is not None:
            self.client.close(test)
            self.client = None


class NemesisWorker(Worker):
    """Applies ops to the test's (already set-up) nemesis
    (interpreter.clj:69-76)."""

    def __init__(self, nemesis: jnemesis.Nemesis):
        self.nemesis = nemesis

    def invoke(self, test, op):
        return self.nemesis.invoke(test, op)


def client_nodes(test: dict) -> list:
    """Thread i's home node: round-robin over :nodes
    (interpreter.clj:83-97)."""
    nodes = test.get("nodes") or [None]
    conc = test.get("concurrency", len(nodes))
    return [nodes[i % len(nodes)] for i in range(conc)]


def make_worker(test: dict, thread_id: Any, nemesis: jnemesis.Nemesis) -> Worker:
    if thread_id == NEMESIS:
        return NemesisWorker(nemesis)
    node = client_nodes(test)[thread_id]
    return ClientWorker(node)


class _WorkerThread:
    """A worker plus its inbox and OS thread; completions land on the
    scheduler's ONE shared queue (the reference's single out
    ArrayBlockingQueue, interpreter.clj:99-164) so the scheduler blocks
    on arrivals instead of polling per-worker outboxes.

    Both queues are ``SimpleQueue`` (C-implemented — roughly half the
    per-op synchronization cost of ``queue.Queue``'s pure-Python
    lock/condition dance, measured ~1.5× interpreter throughput). The
    inbox is unbounded but holds at most one op by construction: the
    scheduler only dispatches to FREE threads."""

    def __init__(self, test: dict, thread_id: Any, worker: Worker,
                 done_q: "queue.SimpleQueue[tuple]"):
        self.thread_id = thread_id
        self.worker = worker
        self.inbox: "queue.SimpleQueue[dict]" = queue.SimpleQueue()
        self.done_q = done_q
        self.thread = threading.Thread(
            target=self._run, args=(test,),
            name=f"jepsen-worker-{thread_id}", daemon=True,
        )
        self.thread.start()

    def _run(self, test: dict) -> None:
        while True:
            op = self.inbox.get()
            typ = op.get("type")
            if typ == "exit":
                try:
                    self.worker.close(test)
                except Exception:
                    LOG.warning("error closing worker %s", self.thread_id,
                                exc_info=True)
                return
            if typ == "sleep":
                _time.sleep(op.get("value") or 0)
                self.done_q.put((self.thread_id, dict(op)))
                continue
            if typ == "log":
                LOG.info("%s", op.get("value"))
                self.done_q.put((self.thread_id, dict(op)))
                continue
            try:
                res = self.worker.invoke(test, op)
                log_op(res)
                self.done_q.put((self.thread_id, res))
            except Exception as e:  # noqa: BLE001 - soundness rule
                # Coarse-grained failure: we don't know whether the op took
                # effect. :info keeps its interval open to end-of-history
                # (interpreter.clj:142-157).
                LOG.warning("process %s %s indeterminate", op.get("process"),
                            op.get("f"), exc_info=True)
                self.done_q.put((self.thread_id, {
                    **op,
                    "type": INFO,
                    "error": f"indeterminate: {e}",
                    "exception": e,
                }))

    def send(self, op: dict) -> None:
        self.inbox.put(op)

    def join(self, timeout: Optional[float] = None) -> None:
        self.thread.join(timeout)


def run(test: dict) -> list[dict]:
    """Run the test's generator to completion against its client and
    nemesis; returns the history as a list of op dicts
    (interpreter.clj:181-310).

    Requires: test["client"] (a Client prototype), test["nemesis"] (already
    set up), test["generator"], test["concurrency"], test["nodes"].

    Optional live-run hooks (both resolved ONCE; absent keys cost one
    None check per op):

    - ``test["op-observer"]``: called with every history-bound op as it
      lands (invocations and completions) — the online monitor's tee.
      Exceptions are logged, never propagated into the run.
    - ``test["stop-event"]``: a ``threading.Event``; once set, the
      scheduler stops dispatching and returns the history accumulated so
      far (ops still in flight are abandoned to their daemon workers) —
      the online monitor's ``abort_on_violation`` seam."""
    from .. import telemetry as jtelemetry

    ctx = make_context(test)
    nemesis = test.get("nemesis") or jnemesis.noop()
    _reg = jtelemetry.of_test(test)
    _observer = test.get("op-observer")
    _stop = test.get("stop-event")
    # Op-latency histogram by (f, completion type). Metric object is
    # resolved ONCE here; the completion path below only guards on the
    # None, so a telemetry-off run allocates nothing per op.
    _lat = (_reg.histogram(
        "jepsen_op_latency_seconds",
        "Client op latency (invoke to completion) by f and type",
        labelnames=("f", "type")) if _reg is not None else None)
    threads = ctx.free_thread_list()
    done_q: "queue.SimpleQueue[tuple]" = queue.SimpleQueue()
    workers: dict[Any, _WorkerThread] = {
        t: _WorkerThread(test, t, make_worker(test, t, nemesis), done_q)
        for t in threads
    }
    gen = Validate(FriendlyExceptions(test.get("generator")))
    history: list[dict] = []
    # Ops in flight: thread id -> invoke op.
    outstanding: dict[Any, dict] = {}
    # process -> thread, maintained alongside ctx.workers: dispatch must
    # not scan every worker per op (O(concurrency) per op bites at 100+
    # workers).
    thread_of: dict[Any, Any] = {p: t for t, p in ctx.workers.items()}
    exc: Optional[BaseException] = None

    def _note(op: dict) -> None:
        history.append(op)
        if _observer is not None:
            try:
                _observer(op)
            except Exception:  # noqa: BLE001 - observers never sink runs
                LOG.warning("op-observer failed", exc_info=True)

    def take_completion(block: bool, timeout: Optional[float] = None):
        """Apply completions from the shared queue; returns whether any
        was handled (interpreter.clj:215-241). BATCH-DRAIN: after the
        first get (which may block), every already-arrived completion is
        drained non-blockingly before returning — at high concurrency
        (100 workers) completions arrive in bursts, and paying a
        generator evaluation + scheduler pass per completion was the
        gap between the 1-worker and 100-worker throughput numbers.
        Each completion still updates the generator individually (the
        generator must observe every op), in arrival order — only the
        interleaved scheduler passes are elided."""
        nonlocal ctx, gen
        handled = 0
        while True:
            try:
                if handled == 0:
                    thread, op2 = done_q.get(block=block, timeout=timeout)
                else:
                    thread, op2 = done_q.get_nowait()
            except queue.Empty:
                return handled > 0
            inv = outstanding.pop(thread, None)
            op2 = dict(op2)
            op2.pop("exception", None)
            op2["time"] = relative_time_nanos()
            if _lat is not None and inv is not None and thread != NEMESIS \
                    and goes_in_history(op2):
                _lat.labels(f=str(op2.get("f")),
                            type=str(op2.get("type"))).observe(
                                max(op2["time"] - inv.get("time",
                                                          op2["time"]),
                                    0) / 1e9)
            ctx = ctx.with_(
                time=max(ctx.time, op2["time"]),
                free_threads=ctx.free_threads | {thread},
            )
            gen = gen_update(gen, test, ctx, op2)
            # Client crash ⇒ fresh process id for this thread
            # (interpreter.clj:233-236).
            if thread != NEMESIS and op2.get("type") == INFO:
                new_workers = dict(ctx.workers)
                thread_of.pop(new_workers[thread], None)
                new_workers[thread] = next_process(ctx, thread)
                thread_of[new_workers[thread]] = thread
                ctx = ctx.with_(workers=new_workers)
            if goes_in_history(op2):
                _note(op2)
            handled += 1

    _switch_interval_enter()
    try:
        while True:
            # 0. External stop (online monitor abort): return the
            # history as recorded so far; in-flight ops are abandoned
            # to their daemon workers (the run is over).
            if _stop is not None and _stop.is_set():
                take_completion(block=False)
                break

            # 1. Completions first (drain whatever has arrived).
            if take_completion(block=False):
                continue

            # 2. Ask the generator (interpreter.clj:244-292).
            res = gen_op(gen, test, ctx)
            if res is None:
                # Exhausted: wait for stragglers, then shut workers down.
                if outstanding:
                    take_completion(block=True,
                                    timeout=MAX_PENDING_INTERVAL_S)
                    continue
                break
            op_, gen2 = res
            now = relative_time_nanos()
            if op_ is PENDING:
                # Wake on the next completion rather than spinning.
                take_completion(block=True, timeout=MAX_PENDING_INTERVAL_S)
                continue
            if op_["time"] > now:
                # Future op: sleep towards it, but wake early for
                # completions (interpreter.clj:268-275).
                take_completion(
                    block=True,
                    timeout=min((op_["time"] - now) / 1e9,
                                MAX_PENDING_INTERVAL_S),
                )
                continue
            # Dispatch. The op keeps its scheduled :time.
            op_ = dict(op_)
            op_["time"] = max(op_["time"], now) if op_["time"] >= 0 else now
            thread = thread_of.get(op_["process"])
            assert thread is not None, f"no thread for process {op_['process']}"
            workers[thread].send(dict(op_))
            outstanding[thread] = op_
            ctx = ctx.with_(
                time=max(ctx.time, op_["time"]),
                free_threads=ctx.free_threads - {thread},
            )
            gen = gen_update(gen2, test, ctx, op_)
            if goes_in_history(op_):
                _note(op_)
    except BaseException as e:  # noqa: BLE001 - propagate after cleanup
        exc = e
    finally:
        _switch_interval_exit()
        # Drain & stop workers (interpreter.clj:252-261,294-309). Workers
        # stuck in a client call are daemon threads; exit ops queue behind
        # whatever they're doing.
        for w in workers.values():
            w.inbox.put({"type": "exit"})
        for w in workers.values():
            w.join(timeout=5.0)
    if exc is not None:
        raise exc
    return history
