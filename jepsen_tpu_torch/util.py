"""Shared utilities: the port of the reference's ``jepsen_tpu/util.py``
(jepsen.util, util.clj).

The monotonic relative test clock (util.clj:291-309), the
crash-propagating parallel map (util.clj:60-73), timeouts, retries,
majority math, op logging, the integer-set rendering the checkers print,
op latencies and nemesis intervals."""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterable, Optional, Sequence

LOG = logging.getLogger("jepsen")

_relative_origin: Optional[int] = None
_origin_lock = threading.Lock()


def with_relative_time():
    """Context manager zeroing the relative test clock
    (util.clj:291-309)."""

    @contextmanager
    def ctx():
        global _relative_origin
        with _origin_lock:
            prev = _relative_origin
            _relative_origin = time.monotonic_ns()
        try:
            yield
        finally:
            with _origin_lock:
                _relative_origin = prev

    return ctx()


def relative_time_nanos() -> int:
    """Nanoseconds since the enclosing with_relative_time() began (process
    start when none is active)."""
    origin = _relative_origin
    if origin is None:
        origin = 0
    return time.monotonic_ns() - origin


def majority(n: int) -> int:
    """Smallest majority of n nodes (util.clj:79-83)."""
    return n // 2 + 1


def name_plus(x: Any) -> str:
    return x if isinstance(x, str) else str(x)


def log_op(op: dict) -> None:
    LOG.info(
        "%s\t%s\t%s\t%s%s",
        op.get("process"),
        op.get("type"),
        op.get("f"),
        op.get("value"),
        f"\t{op.get('error')}" if op.get("error") else "",
    )


def _daemon_call(f: Callable, args: tuple) -> tuple[threading.Thread, list]:
    """Run f(*args) on a daemon thread; returns (thread, cell) where cell
    fills with ("ok", result) or ("error", exc). Daemon threads can be
    abandoned on timeout without blocking interpreter exit (a non-daemon
    executor worker would be joined by concurrent.futures' atexit hook)."""
    cell: list = []

    def run():
        try:
            cell.append(("ok", f(*args)))
        except BaseException as e:  # noqa: BLE001 - propagated to caller
            cell.append(("error", e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, cell


def real_pmap(f: Callable, coll: Sequence) -> list:
    """Parallel map over real (daemon) threads; the first exception
    *thrown* is re-raised promptly, without waiting for slower tasks
    (util.clj:60-73 semantics)."""
    coll = list(coll)
    if not coll:
        return []
    done = threading.Semaphore(0)

    def wrap(x):
        def call():
            try:
                return f(x)
            finally:
                done.release()

        return call

    tasks = [_daemon_call(wrap(x), ()) for x in coll]
    for _ in coll:
        done.acquire()
        for _t, cell in tasks:
            if cell and cell[0][0] == "error":
                raise cell[0][1]
    out = []
    for t, cell in tasks:
        t.join()
        status, value = cell[0]
        if status == "error":
            raise value
        out.append(value)
    return out


class TimeoutError_(Exception):
    pass


def timeout(seconds: float, f: Callable, *args, default=TimeoutError_):
    """Run f with a timeout; returns default (or raises) *at* the deadline
    (util.clj:332 macro). The worker is a daemon thread left to finish in
    the background: Python threads can't be safely killed, and a
    non-daemon worker (a ``with`` block's, or ThreadPoolExecutor's atexit
    join) would block interpreter exit and defeat the timeout."""
    t, cell = _daemon_call(f, args)
    t.join(timeout=seconds)
    if cell:
        status, value = cell[0]
        if status == "error":
            raise value
        return value
    if default is TimeoutError_:
        raise TimeoutError_(f"timed out after {seconds}s") from None
    return default


def with_retry(tries: int, f: Callable, *args, delay_s: float = 0.0,
               exceptions=(Exception,)):
    """Retry f up to `tries` times (util.clj:360)."""
    for attempt in range(tries):
        try:
            return f(*args)
        except exceptions:
            if attempt == tries - 1:
                raise
            if delay_s:
                time.sleep(delay_s)


def nanos_to_secs(ns: float) -> float:
    return ns / 1e9


def secs_to_nanos(s: float) -> int:
    return int(s * 1e9)


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """Compact '#{1-3 5}' rendering of an integer set (util.clj:549)."""
    xs = sorted(set(xs))
    if not xs:
        return "#{}"
    parts = []
    lo = prev = xs[0]
    for x in xs[1:]:
        if x == prev + 1:
            prev = x
            continue
        parts.append(f"{lo}" if lo == prev else f"{lo}-{prev}")
        lo = prev = x
    parts.append(f"{lo}" if lo == prev else f"{lo}-{prev}")
    return "#{" + " ".join(parts) + "}"


def history_to_latencies(history) -> list[tuple]:
    """[(invoke-op, latency-nanos)] for completed client ops
    (util.clj:620)."""
    out = []
    pending: dict = {}
    for op in history:
        if not getattr(op, "is_client", False):
            continue
        if op.is_invoke:
            pending[op.process] = op
        else:
            inv = pending.pop(op.process, None)
            if inv is not None and inv.time >= 0 and op.time >= 0:
                out.append((inv, op.time - inv.time))
    return out


def nemesis_intervals(history, fs: Optional[dict] = None) -> list[tuple]:
    """Pair nemesis start/stop ops into [start, stop] op intervals
    (util.clj:656). ``fs`` maps start-f -> stop-f OR a set of stop-fs
    (any of which closes the interval); default pairs :start with
    :stop."""
    fs = fs or {"start": "stop"}
    norm = {
        k: frozenset(v) if isinstance(v, (set, frozenset, list, tuple))
        else frozenset([v])
        for k, v in fs.items()
    }
    out = []
    open_: list = []  # (start_op, stop-f set), in start order
    for op in history:
        if not getattr(op, "is_nemesis", False):
            continue
        f = op.f
        if f in norm:
            open_.append((op, norm[f]))
        else:
            for i, (start, stops) in enumerate(open_):
                if f in stops:
                    out.append((start, op))
                    del open_[i]
                    break
    for start, _stops in open_:
        out.append((start, None))
    return out
