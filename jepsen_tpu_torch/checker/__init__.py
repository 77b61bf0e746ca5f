"""Checker protocol layer of the port, and the ``linearizable`` checker.

The port of the reference's ``jepsen_tpu/checker/__init__.py``: the
``Checker.check(test, history, opts)`` seam, the valid-merge lattice
``True < "unknown" < False``, ``check_safe``, ``compose``,
``concurrency_limit``, ``noop``, ``unbridled_optimism``,
``unhandled_exceptions``, ``stats``, the invariant checkers of
:mod:`.invariants` (``queue``, ``set_checker``, ``set_full``,
``total_queue``, ``unique_ids``, ``counter``), and ``linearizable``, which
dispatches on the ``backend`` option (overridden by the test map's
``checker_backend``) onto the GPU search (``ops.wgl``), the native C search
(``ops.wgl_c``), the two raced, the frontier-sharded search
(``parallel.frontier``), the offline segmented checker
(``jepsen_tpu_torch.offline``) or the port's host oracle, and decides many keyed
subhistories at once through ``batch_check`` (``parallel.check_batch``).
On a test map with ``"telemetry?": True`` it records into the test's
registry (``telemetry.of_test``); a refutation of a stored test writes its
witness files into the store (``checker.linear_viz``).

Result maps use the key ``"valid"`` with values True / False / "unknown".
"""

from __future__ import annotations

import logging
import threading
import time as _time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

from .. import store, telemetry
from ..devices import resolve_device
from ..history import History

LOG = logging.getLogger("jepsen")

# Priority lattice: larger dominates when composing.
_VALID_PRIORITY = {True: 0, "unknown": 0.5, False: 1}

# Backend names the device search answers to; "tpu" is the reference's.
DEVICE_BACKENDS = ("device", "tpu", "gpu", "cuda")
# check_history's engines besides the device search (ops.wgl.check_history).
HISTORY_BACKENDS = ("auto", "native", "competition")
# Bounds of the checker_seconds histogram (the reference's).
_CHECKER_SECONDS_BUCKETS = (0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0, 600.0)


class Checker:
    """Base checker. Subclasses (or :func:`checker_fn` wrappers) implement
    :meth:`check`."""

    def check(self, test: dict, history: History, opts: Optional[dict] = None) -> dict:
        raise NotImplementedError

    def __call__(self, test, history, opts=None):
        return self.check(test, history, opts)


class _FnChecker(Checker):
    __slots__ = ("fn", "_name")

    def __init__(self, fn: Callable, name: str = "checker"):
        self.fn = fn
        self._name = name

    def check(self, test, history, opts=None):
        return self.fn(test, history, opts or {})

    def __repr__(self):
        return f"<checker {self._name}>"


def checker_fn(fn: Callable, name: Optional[str] = None) -> Checker:
    """Lift ``fn(test, history, opts) -> result-map`` into a Checker."""
    return _FnChecker(fn, name or getattr(fn, "__name__", "checker"))


def merge_valid(valids) -> Any:
    """Merge valid values; the highest priority (worst) wins."""
    out = True
    for v in valids:
        if v not in _VALID_PRIORITY:
            raise ValueError(f"{v!r} is not a known valid value")
        if _VALID_PRIORITY[v] > _VALID_PRIORITY[out]:
            out = v
    return out


def noop() -> Checker:
    """Returns None from check (checker.clj:65-69)."""
    return checker_fn(lambda test, history, opts: None, "noop")


def unbridled_optimism() -> Checker:
    """Everything is awesoooommmmme! (checker.clj:115-119)"""
    return checker_fn(lambda test, history, opts: {"valid": True}, "unbridled-optimism")


def check_safe(checker: Checker, test: dict, history: History,
               opts: Optional[dict] = None) -> dict:
    """Like check, but exceptions become ``{"valid": "unknown", "error":
    ...}``."""
    try:
        return checker.check(test, history, opts or {})
    except Exception:
        LOG.warning("Error while checking history:", exc_info=True)
        return {"valid": "unknown", "error": traceback.format_exc()}


class _Compose(Checker):
    def __init__(self, checker_map: dict):
        self.checker_map = dict(checker_map)

    def check(self, test, history, opts=None):
        items = list(self.checker_map.items())
        if not items:
            return {"valid": True}
        with ThreadPoolExecutor(len(items)) as pool:
            results = list(pool.map(
                lambda kv: (kv[0], check_safe(kv[1], test, history, opts)), items))
        out = dict(results)
        out["valid"] = merge_valid(r.get("valid") for _, r in results if r is not None)
        return out


def compose(checker_map: dict) -> Checker:
    """Map of names -> checkers; runs each (in threads) and merges their
    valid values. A composed checker has no ``batch_check``, so a keyed
    ``independent.checker`` over it checks key by key, as the reference's
    does."""
    return _Compose(checker_map)


class _ConcurrencyLimit(Checker):
    def __init__(self, limit: int, checker: Checker):
        self.sem = threading.Semaphore(limit)
        self.checker = checker

    def check(self, test, history, opts=None):
        with self.sem:
            return self.checker.check(test, history, opts)


def concurrency_limit(limit: int, checker: Checker) -> Checker:
    """Bound the concurrent executions of a memory-hungry checker
    (checker.clj:98-113): at most ``limit`` threads run it at once, among
    them the threads of :func:`compose`."""
    return _ConcurrencyLimit(limit, checker)


def unhandled_exceptions() -> Checker:
    """Surface client exceptions recorded on :info ops, grouped by class,
    most frequent first (checker.clj:120-147)."""

    def chk(test, history, opts):
        groups: dict[Any, list] = {}
        for op in history:
            exc = op.get("exception")
            if exc is None or not op.is_info:
                continue
            cls = exc.get("type") if isinstance(exc, dict) else type(exc).__name__
            groups.setdefault(cls, []).append(op)
        exes = [{"count": len(ops), "class": cls, "example": ops[0]}
                for cls, ops in sorted(groups.items(), key=lambda kv: len(kv[1]),
                                       reverse=True)]
        return {"valid": True, "exceptions": exes} if exes else {"valid": True}

    return checker_fn(chk, "unhandled-exceptions")


def _stats_counts(ops) -> dict:
    ok = sum(1 for op in ops if op.is_ok)
    fail = sum(1 for op in ops if op.is_fail)
    info = sum(1 for op in ops if op.is_info)
    return {
        # A group where nothing succeeded is indeterminate, not broken:
        # fail and info are legitimate outcomes, and correctness is the
        # model checkers' call.
        "valid": True if ok > 0 else "unknown",
        "count": ok + fail + info,
        "ok_count": ok,
        "fail_count": fail,
        "info_count": info,
    }


def stats() -> Checker:
    """Success/failure rates, overall and by ``f``; valid iff every ``f``
    has some ok ops, else "unknown" — never False."""

    def chk(test, history, opts):
        ops = [op for op in history if not op.is_invoke and op.is_client]
        by_f: dict[Any, list] = {}
        for op in ops:
            by_f.setdefault(op.f, []).append(op)
        groups = {f: _stats_counts(sub)
                  for f, sub in sorted(by_f.items(), key=lambda kv: str(kv[0]))}
        out = _stats_counts(ops)
        out["by_f"] = groups
        out["valid"] = merge_valid(g["valid"] for g in groups.values())
        return out

    return checker_fn(chk, "stats")


def resolve_backend(name: str) -> str:
    """``"device"``, ``"auto"``, ``"native"``, ``"competition"``,
    ``"sharded"``, ``"segmented"`` or ``"host"`` for a backend name."""
    if name in DEVICE_BACKENDS:
        return "device"
    if name in ("host", "sharded", "segmented") or name in HISTORY_BACKENDS:
        return name
    raise ValueError(f"unknown backend {name!r}")


def _write_witness(model, ops, res: dict, test: dict, opts) -> None:
    """The refutation's witness files in the test's store directory (under
    ``opts["subdirectory"]`` when given): ``linear.txt`` always,
    ``linear.svg`` when the result carries ``stuck_configs``; their names
    go to ``res["witness_files"]``. A failed write is recorded as
    ``res["witness_error"]``: diagnostics never mask the verdict."""
    try:
        from .linear_viz import failure_report, render_linear_svg

        sub = (opts or {}).get("subdirectory")
        parts = [str(sub)] if sub else []
        with open(store.path_mk(test, *parts, "linear.txt"), "w") as f:
            f.write(failure_report(model, ops, res))
        if res.get("stuck_configs"):
            render_linear_svg(model, ops, res, store.path_mk(test, *parts, "linear.svg"))
            res["witness_files"] = ["linear.txt", "linear.svg"]
        else:
            res["witness_files"] = ["linear.txt"]
    except Exception as e:
        res["witness_error"] = f"{type(e).__name__}: {e}"


def linearizable(options: Optional[dict] = None, **kw) -> Checker:
    """Validate linearizability on the GPU search.

    ``options`` / kwargs:

    - ``model``: a ``jepsen_tpu_torch.models.Model`` (required).
    - ``backend``: ``"device"`` (default; ``"tpu"``, ``"gpu"`` and
      ``"cuda"`` are aliases), ``"auto"``, ``"native"`` or
      ``"competition"`` (``ops.wgl.check_history``'s engines: the C search
      first, the C search alone, or the two raced), ``"sharded"`` (the
      frontier-sharded search over the test map's ``"mesh"``, else a mesh
      of one shard on ``device``), ``"segmented"`` (the offline planner and
      the multi-stream scheduler, ``offline.check_offline``, its oracle
      engine ``auto`` on ``device``) or ``"host"`` (the port's oracle),
      overridden by the test map's ``checker_backend``. The default stays
      ``"device"`` (the reference's is ``"auto"``): the port's entry points
      run the GPU unless asked otherwise, and ``"auto"`` is one keyword
      away.
    - ``device``: the torch device of the device backends (default the GPU;
      ``"cpu"`` runs the plain PyTorch version, as the tests do).

    The returned checker's ``batch_check(test, keyed_histories, opts)``
    decides many subhistories as one batched search and re-checks each
    key it leaves ``unknown`` on its own, through the resolved backend
    (under ``"auto"`` the C search first). With telemetry on, both record
    ``checker_seconds{checker,backend}``; a single check also records the
    ``checker_op_count`` gauge and passes the registry (``metrics``) and a
    :class:`~jepsen_tpu_torch.telemetry.Heartbeat` (``chunk_callback``) to
    the engines, the batch ``metrics`` and
    ``checker_batch_keys_total{result}``. A refutation of a test with a
    store (``name`` and ``start-time``, and not ``no-store?``) writes its
    witness into the store: ``linear.txt`` and, with ``stuck_configs``,
    ``linear.svg`` (``checker.linear_viz``; ``witness_files``, or
    ``witness_error`` when the write fails)."""
    o = dict(options or {})
    o.update(kw)
    model = o.get("model")
    if model is None:
        raise ValueError(f"the linearizable checker requires a model; received {model!r}")
    default_backend = resolve_backend(o.get("backend", "device"))
    device = o.get("device")
    if default_backend != "host":
        device = resolve_device(device)

    def _resolve(test):
        return resolve_backend((test or {}).get("checker_backend", default_backend))

    def _check_one(test, ops, backend, **kw):
        """The single-history dispatch, shared by ``chk`` and the keyed
        batch's recheck of unknown keys. ``kw`` carries the telemetry
        (``metrics``, a heartbeat ``chunk_callback``); the sharded search
        takes only ``metrics``, the host oracle neither."""
        from ..ops import wgl

        if backend == "host":
            return wgl.check_history(model, ops, backend="host")
        if backend == "sharded":
            from ..parallel.frontier import check_history_sharded

            return check_history_sharded(model, ops, mesh=(test or {}).get("mesh"),
                                         device=resolve_device(device),
                                         metrics=kw.get("metrics"))
        if backend == "segmented":
            from .. import offline

            return offline.check_offline(model, ops, metrics=kw.get("metrics"),
                                         device=device)
        # The device legs resolve the device; the C search never does.
        return wgl.check_history(model, ops, backend=backend, device=device, **kw)

    def _observe_seconds(reg, backend, t0):
        reg.histogram("checker_seconds", "Checker wall seconds by checker and engine",
                      labelnames=("checker", "backend"),
                      buckets=_CHECKER_SECONDS_BUCKETS).labels(
            checker="linearizable", backend=backend).observe(_time.perf_counter() - t0)

    def chk(test, history, opts):
        backend = _resolve(test)
        ops = history.client_ops()
        reg = telemetry.of_test(test)
        kw = {}
        if reg is not None:
            # The registry, and a heartbeat fed by the drivers' per-chunk
            # callback (progress gauges and a periodic log line).
            kw["metrics"] = reg
            kw["chunk_callback"] = telemetry.Heartbeat(total=len(ops), registry=reg)
        t0 = _time.perf_counter()
        res = _check_one(test, ops, backend, **kw)
        if reg is not None:
            _observe_seconds(reg, str(res.get("backend")
                                      or ("device" if res.get("device") else backend)), t0)
            reg.gauge("checker_op_count", "Ops seen by the linearizable checker").set(
                res.get("op_count") or len(ops))
        # Keep the search diagnostics bounded, as the reference does.
        if isinstance(res.get("attempts"), list):
            res["attempts"] = res["attempts"][:10]
        if res.get("valid") is False and store.wanted(test):
            _write_witness(model, ops, res, test, opts)
        return res

    out = checker_fn(chk, "linearizable")

    def batch_check(test, keyed_histories: dict, opts=None) -> dict:
        """Decide many subhistories as one batched device search. Returns
        ``{key: result-map}``. Raises when the device backend is not in
        use, so the caller can check key by key."""
        backend = _resolve(test)
        if backend == "host" or not model.device_capable:
            raise RuntimeError("batch check requires the device backend")
        from ..parallel import check_batch

        reg = telemetry.of_test(test)
        kw = {"metrics": reg} if reg is not None else {}
        t0 = _time.perf_counter()
        ks = list(keyed_histories)
        results = check_batch(model, [keyed_histories[k].client_ops() for k in ks],
                              device=resolve_device(device), **kw)
        out_map = dict(zip(ks, results))
        # Keys the shared batch could not decide get the single-history
        # path of the resolved backend (under auto, the C search first).
        for k, r in out_map.items():
            if r.get("valid") == "unknown":
                out_map[k] = _check_one(test, keyed_histories[k].client_ops(), backend, **kw)
        if reg is not None:
            _observe_seconds(reg, "batch", t0)
            kc = reg.counter("checker_batch_keys_total",
                             "Keys decided through the batched device check",
                             labelnames=("result",))
            for r in out_map.values():
                kc.labels(result=str(r.get("valid"))).inc()
        return out_map

    out.batch_check = batch_check
    return out


# The invariant checkers live in their own module; re-export them, as the
# reference does.
from .invariants import (  # noqa: E402
    counter,
    queue,
    set_checker,
    set_full,
    total_queue,
    unique_ids,
)

__all__ = ["Checker", "check_safe", "checker_fn", "compose", "concurrency_limit",
           "counter", "linearizable", "merge_valid", "noop", "queue", "resolve_backend",
           "set_checker", "set_full", "stats", "total_queue", "unbridled_optimism",
           "unhandled_exceptions", "unique_ids"]
