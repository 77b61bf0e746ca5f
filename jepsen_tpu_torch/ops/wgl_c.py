"""The native C host search in the checker stack.

The port of the reference's ``jepsen_tpu/ops/wgl_c.py``: it hands an
encoded history to :mod:`jepsen_tpu_torch.native`'s compiled search, in
the device search's encoding (determinate ops sorted by invocation, a
window bitset of at most 64 ops, an open set of up to ``wgl_max_open()``
ops, at most 8 state lanes). Verdicts are exact; the only limit is a
configuration budget. :func:`check_encoded_native` returns None when the
model family or the shape is not supported, or when there is no C
compiler: the callers then run the host oracle.
"""

from __future__ import annotations

import ctypes
import os
import time as _time
from typing import Optional

import numpy as np

from .encode import EncodedHistory, encode_history
from .. import native
from ..checker import provenance as _prov
from ..history import History
from ..models import (CasRegister, FencedMutex, Model, Mutex, OwnerAwareMutex,
                      ReentrantFencedMutex, ReentrantMutex, Register, Semaphore)

# (model class, the C engine's model id, its parameter). Matched by exact
# type: Register subclasses CasRegister.
_MODEL_IDS = [
    (CasRegister, 1, lambda m: 0),
    (Register, 1, lambda m: 0),
    (Mutex, 2, lambda m: 0),
    (OwnerAwareMutex, 3, lambda m: 0),
    (ReentrantMutex, 4, lambda m: m.max_depth),
    (FencedMutex, 5, lambda m: 0),
    (ReentrantFencedMutex, 6, lambda m: 0),
    (Semaphore, 7, lambda m: m.capacity),
]


def _model_id(model: Model):
    for cls, mid, param in _MODEL_IDS:
        if type(model) is cls:
            return mid, int(param(model))
    return None, None


def parallel_policy() -> tuple[str, int]:
    """``(strategy, n_threads)`` of a full-budget search on this host, the
    one place the policy lives. The shared-stack engine wins refutations
    even on one core: its batched-LIFO pops interleave sibling subtrees,
    an order under which the dominance memo prunes more than the strict
    depth-first descent does, and with more cores the coverage fans out."""
    return "dfs-par", max(2, min(8, os.cpu_count() or 1))


def check_encoded_native(enc: EncodedHistory, max_configs: int = 50_000_000,
                         strategy: str = "dfs", cancel: Optional[ctypes.c_int32] = None,
                         n_threads: Optional[int] = None, metrics=None) -> Optional[dict]:
    """Decide linearizability in the C engine; None when unsupported.

    ``strategy``: ``"dfs"`` (memoized depth-first, near-linear on valid
    histories), ``"dfs-par"`` (the same search over ``n_threads`` workers
    sharing a striped dominance memo) or ``"bfs"`` (level-synchronous, the
    device search's shape). ``cancel``: a ``ctypes.c_int32`` the DFS polls;
    setting it nonzero from another thread makes the search return
    ``unknown`` promptly. ``metrics``: a
    :class:`jepsen_tpu_torch.telemetry.Registry` that receives
    ``wgl_native_nodes_total`` and ``wgl_native_wall_seconds_total`` (by
    strategy) and ``wgl_native_searches_total`` (by verdict)."""
    lib = native.load()
    if lib is None:
        return None
    mid, param = _model_id(enc.model)
    if mid is None:
        return None
    S = len(enc.init_state)
    if S > 8:
        return None

    from .wgl import det_tables

    t = det_tables(enc)
    nD, nO, W = t["nD"], t["nO"], t["W"]
    if nO > lib.wgl_max_open() or W > 64:
        return None
    ca = lambda a: np.ascontiguousarray(a, dtype=np.int32)  # noqa: E731
    invD, retD = ca(t["invD"]), ca(t["retD"])
    opD, a1D, a2D = ca(t["opD"]), ca(t["a1D"]), ca(t["a2D"])
    invO, opO = ca(t["invO"]), ca(t["opO"])
    a1O, a2O = ca(t["a1O"]), ca(t["a2O"])
    sufret = ca(t["sufret"])
    init = ca(enc.init_state)

    p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    explored = ctypes.c_int64(0)
    fmax = ctypes.c_int32(0)
    maxlin = ctypes.c_int32(0)
    t0 = _time.perf_counter()
    common = (
        nD, nO, S, W,
        p(invD), p(retD), p(opD), p(a1D), p(a2D),
        p(sufret),
        p(invO), p(opO), p(a1O), p(a2O),
        p(init),
        mid, param, max_configs,
        ctypes.byref(explored), ctypes.byref(fmax), ctypes.byref(maxlin),
    )
    if strategy in ("dfs", "dfs-par"):
        # The deepest configurations reached: the refutation witness.
        stride = int(lib.wgl_witness_stride())
        wit_cap = 5
        wit_buf = np.zeros(wit_cap * stride, dtype=np.int32)
        wit_len = ctypes.c_int32(0)
        wit_args = (p(wit_buf), wit_cap, ctypes.byref(wit_len),
                    ctypes.byref(cancel) if cancel is not None else None)
        if strategy == "dfs-par":
            if n_threads is None:
                n_threads = min(8, os.cpu_count() or 1)
            verdict = lib.wgl_check_dfs_par(*common, *wit_args, int(n_threads))
        else:
            verdict = lib.wgl_check_dfs(*common, *wit_args)
    elif strategy == "bfs":
        wit_buf = None
        verdict = lib.wgl_check(*common)
    else:
        raise ValueError(f"unknown native strategy {strategy!r}")
    wall = _time.perf_counter() - t0
    base = {
        "op_count": enc.n,
        "native": True,
        "configs_explored": int(explored.value),
        "frontier_max": int(fmax.value),
        "wall_s": wall,
    }
    if metrics is not None:
        _note_native_metrics(metrics, strategy, int(explored.value), wall, verdict)

    if verdict == 1:
        return {"valid": True, **base}
    if verdict == 0:
        res = {"valid": False, "max_linearized": int(maxlin.value), **base}
        if wit_buf is not None and wit_len.value:
            res["stuck_configs"] = _decode_witness(enc, wit_buf, int(wit_len.value), stride, S)
        return res
    if verdict == -1:
        return _prov.attach(
            {"valid": "unknown", "info": f"config budget {max_configs} exhausted", **base},
            "max_configs", budget=max_configs, engine="native")
    if verdict == -3:
        return _prov.attach(
            {"valid": "unknown", "info": "native engine out of memory", **base},
            "oom", engine="native")
    return None  # unsupported shape


def _note_native_metrics(metrics, strategy: str, explored: int, wall: float,
                         verdict: int) -> None:
    """The C engine's returns as registry counters."""
    metrics.counter(
        "wgl_native_nodes_total", "Configurations explored by the native C search",
        labelnames=("strategy",)).labels(strategy=strategy).inc(explored)
    metrics.counter(
        "wgl_native_wall_seconds_total", "Native C search wall seconds",
        labelnames=("strategy",)).labels(strategy=strategy).inc(wall)
    metrics.counter(
        "wgl_native_searches_total", "Native C searches by verdict",
        labelnames=("verdict",)).labels(
            verdict={1: "valid", 0: "invalid"}.get(verdict, "unknown")).inc()


def _decode_witness(enc: EncodedHistory, buf: np.ndarray, n_entries: int, stride: int,
                    S: int) -> list:
    """The C engine's deepest configurations in the host oracle's
    ``stuck_configs`` shape: the linearized history rows, the model state,
    and the first pending ops with the reason each cannot go next."""
    from .wgl import NO_WORDS_OPEN, decode_stuck_config

    # The layout assumes the C library's NO_WORDS and S_MAX; its stride
    # pins them, so a change there fails here rather than decoding open
    # words as state.
    assert stride == 3 + 2 * NO_WORDS_OPEN + 8, (
        f"witness stride {stride} does not match the decoder")
    det_rows = np.flatnonzero(~enc.skippable)
    open_rows = np.flatnonzero(enc.skippable)
    out = []
    for e in range(min(n_entries, buf.size // stride)):
        ent = buf[e * stride:(e + 1) * stride]
        p = int(ent[0])
        win = (int(ent[1]) & 0xFFFFFFFF) | ((int(ent[2]) & 0xFFFFFFFF) << 32)
        open_words = [(int(ent[3 + 2 * w]) & 0xFFFFFFFF)
                      | ((int(ent[4 + 2 * w]) & 0xFFFFFFFF) << 32)
                      for w in range(NO_WORDS_OPEN)]
        st = tuple(int(x) for x in ent[3 + 2 * NO_WORDS_OPEN:3 + 2 * NO_WORDS_OPEN + S])
        out.append(decode_stuck_config(enc, det_rows, open_rows, p, win, open_words, st))
    return out


def check_history_native(model: Model, history: History, **kw) -> Optional[dict]:
    return check_encoded_native(encode_history(model, history), **kw)
