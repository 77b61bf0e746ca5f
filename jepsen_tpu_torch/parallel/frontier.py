"""Frontier-sharded linearizability search: one history's frontier split
over the D shards of a mesh, the port of the reference's
``jepsen_tpu/parallel/frontier.py``.

Each shard expands its ``F`` configurations and compacts its stage-1
survivors; one exchange a level then moves candidates between shards. In
the default owner-partitioned mode (``exchange="alltoall"``) each
candidate goes to the shard owning its group hash (``owner = FNV % D``) in
fixed per-destination buckets, and each shard deduplicates only the rows
it owns; in the replicated mode (``exchange="allgather"``, also
``JEPSEN_WGL_EXCHANGE=allgather``, the kill-switch) every shard receives
every candidate, runs the global dedup and keeps its slice of the global
order. Any verdict either mode gives is the single search's at capacity
``F * D``, at the same level; the partitioned mode may spend an
escalation on hash imbalance.

The shards of a :class:`~jepsen_tpu_torch.parallel.Mesh` sit on one
device, as the members of one batch of the level kernels
(``ops.wgl_level.run_chunk_sharded``); the collectives are kernels:
``wgl_route`` (the owner routing with the all_to_all folded in: one
scatter into the owners' receive rows), ``wgl_exchange`` (the
all_gather), and the reductions in the last block of ``wgl_prune`` and
``wgl_chunk_init``.
"""

from __future__ import annotations

import os as _os
import time as _time
from typing import Optional

import torch

from .. import _build
from .. import trace as _trace
from ..checker import provenance as _prov
from ..ops import wgl
from ..ops import wgl_level as _lv
from ..ops.encode import EncodedHistory, encode_history
from ..testing import chaos as _chaos
from . import make_mesh
from . import resilience as _resilience


def _resolve_exchange(exchange: Optional[str]) -> str:
    """``JEPSEN_WGL_EXCHANGE`` (the operational kill-switch, which wins
    over an explicit argument), else ``exchange``, else ``"alltoall"``."""
    mode = _os.environ.get("JEPSEN_WGL_EXCHANGE") or exchange or "alltoall"
    if mode not in _lv.EXCHANGES:
        raise ValueError(f"unknown WGL exchange mode {mode!r} "
                         "(expected 'alltoall' or 'allgather')")
    return mode


def check_encoded_sharded(enc: EncodedHistory, mesh=None, axis: str = "dp",
                          f_total: int = 1024, max_open: int = 128, window_cap: int = 1024,
                          levels_per_call: Optional[int] = None, max_escalations: int = 2,
                          checkpoint_path: Optional[str] = None, chunk_callback=None,
                          metrics=None, exchange: Optional[str] = None, device=None,
                          plain: bool = False) -> dict:
    """Decide linearizability of one encoded history with its frontier
    sharded over ``mesh``'s ``axis`` (default: a mesh of one shard on
    ``device``, the GPU unless ``device="cpu"``). The result map mirrors
    the reference's: ``valid``, ``op_count``, ``device``, ``sharded``,
    ``n_shards``, ``exchange``, ``levels``, ``frontier_total`` (the global
    capacity used), ``frontier_max``, ``window``, ``attempts``, ``wall_s``
    and, where they apply, ``max_linearized``, ``stuck_configs`` and
    ``resumed_from_level``.

    ``f_total`` is the global capacity, rounded up to ``D * max(ceil(f_total
    / D), 16)``; an overflow escalates x4 losslessly up to
    ``max_escalations`` times, after which the verdict is ``unknown``.
    ``plain``: the plain PyTorch version of every stage, even on the GPU.

    ``checkpoint_path``: save the resumable global frontier after every
    chunk, in the single driver's format (``ops.wgl``; phase
    ``"sharded"``, never truncated), and resume from it; deleted on a
    definite verdict. The file holds the global row order, so it is
    portable across exchange modes and mesh sizes: it resumes exactly
    under the other mode or on another D, the width re-rounded to the new
    mesh's multiple. ``chunk_callback(info)`` is called after every chunk
    with the reference's keys (``level``, ``F``, ``global_capacity``,
    ``n_shards``, ``frontier_max``, ``total_levels``, ``count``,
    ``wall_s``); its exceptions propagate. ``metrics``: a
    :class:`jepsen_tpu_torch.telemetry.Registry` that receives the
    reference's ``wgl_sharded_chunk`` events, ``wgl_sharded_chunks_total``,
    ``wgl_sharded_levels_total``, ``wgl_exchange_bytes_total{exchange}``
    (and ``wgl_allgather_bytes_total`` under allgather) from
    ``wgl.exchange_bytes_per_level``, the per-shard config gauges,
    ``wgl_shard_imbalance`` (alltoall) and the escalation counter.

    A transient failure of a chunk (``parallel.resilience``: a CUDA
    runtime error, an out-of-memory, an injected ``device.dispatch``
    fault) retries THAT chunk, as the reference does, through the shared
    ``"sharded"`` circuit breaker. A chunk rewrites the frontier in place,
    so while retries are armed (not under ``JEPSEN_NO_FAILOVER=1``) the
    chunk's starting frontier is copied on the device before it runs (one
    copy, of the current capacity rung only), and a retry restores it and
    a fresh workspace first: the retried search gives the rows and verdict
    of one without the fault."""
    t0 = _time.perf_counter()
    exchange = _resolve_exchange(exchange)
    if mesh is None:
        mesh = make_mesh(device=device)
    D = int(mesh.shape[axis])
    dev = mesh.device
    ops = _lv.PLAIN if plain else _lv.KERNELS
    plan = wgl.plan_device(enc, max_open=max_open, window_cap=window_cap, device=dev)
    n = enc.n
    head = {"sharded": True, "n_shards": D, "exchange": exchange}
    if plan.nD == 0:
        return {"valid": True, "op_count": n, "device": True, "levels": 0, **head}
    if not plan.ok:
        return _prov.attach(
            {"valid": "unknown", "op_count": n, "device": True, "info": plan.reason, **head},
            "encoding_unsupported", reason=plan.reason)
    W, KO, S, _ND, _NO = plan.dims
    total_levels = plan.total_levels
    # every shard reads the same tables
    tabs = {k: v[None].expand((D,) + tuple(v.shape)).contiguous()
            for k, v in plan.tabs.items()}
    fmax_all = 1
    workspaces: dict = {}

    def capacity(f_req: int) -> int:
        return max(-(-f_req // D), 16) * D

    def note_chunk(F, FT, lvl0, lvl, count, cmax, cmin, chunk_wall, stage) -> None:
        c = metrics.counter
        levels_run = max(int(lvl) - lvl0, 0)
        ex_bytes = wgl.exchange_bytes_per_level(plan, F, D, exchange) * levels_run
        c("wgl_sharded_chunks_total", "Frontier-sharded kernel chunk invocations").inc()
        c("wgl_sharded_levels_total", "BFS levels run by the sharded search").inc(levels_run)
        c("wgl_exchange_bytes_total",
          "Analytic bytes moved by the per-level candidate exchange, by mode",
          labelnames=("exchange",)).labels(exchange=exchange).inc(ex_bytes)
        if exchange == "allgather":
            c("wgl_allgather_bytes_total",
              "Analytic bytes moved by the per-level candidate all_gather (legacy "
              "replicated mode only)").inc(ex_bytes)
        g = metrics.gauge(
            "wgl_sharded_configs_per_device",
            "TRUE per-shard live configs after the last chunk (max/min across shards "
            "— not a count/D mean). In allgather mode the skew is the slice LAYOUT "
            "(contiguous global order), not hash imbalance",
            labelnames=("n_shards", "stat"))
        g.labels(n_shards=D, stat="max").set(cmax)
        g.labels(n_shards=D, stat="min").set(cmin)
        if exchange == "alltoall":
            metrics.gauge(
                "wgl_shard_imbalance",
                "Max-shard occupancy / ideal (global count / n_shards) after the last "
                "chunk; 1.0 = perfectly balanced (alltoall mode only)",
                labelnames=("n_shards",)).labels(n_shards=D).set(
                    round(cmax * D / max(int(count), 1), 4))
        ev_extra = {"allgather_bytes": ex_bytes} if exchange == "allgather" else {}
        t1s = round(_time.time(), 6)
        metrics.event(
            "wgl_sharded_chunk", level=int(lvl), F=F, n_shards=D, global_capacity=FT,
            count=int(count), count_max=cmax, count_min=cmin, frontier_max=fmax_all,
            wall_s=round(chunk_wall, 4), stage=stage, t0=round(t1s - chunk_wall, 6),
            t1=t1s, exchange=exchange, exchange_bytes=ex_bytes, **ev_extra,
            **_trace.event_tags())

    def run_capacity(FT: int, fr: tuple, attempt: dict) -> tuple:
        """Chunks at one global capacity: (result, frontier); a None result
        is a lossless overflow (escalate)."""
        nonlocal fmax_all
        F = FT // D
        g = wgl.sharded_geometry(plan, F, D, exchange)
        if F not in workspaces:
            workspaces[F] = _lv.BatchWorkspace(g, D, dev)
        lpc = levels_per_call or wgl._levels_per_call(F * (plan.B or (W + KO * 32)))
        start = None  # this rung's copy of a chunk's starting frontier
        while True:
            t_call = _time.perf_counter()
            lvl0 = int(fr[-1])
            budget = min(total_levels, lvl0 + lpc)
            was_loaded = _build.loaded()
            if not _resilience.failover_disabled():
                if start is None:
                    start = tuple(torch.empty_like(a) for a in fr[:5])
                for dst, src in zip(start, fr[:5]):
                    dst.copy_(src)
            tried = False

            def chunk():
                nonlocal tried
                if tried:
                    # a failed attempt may have rewritten the frontier and
                    # left scratch state behind: start again from the copy
                    for dst, src in zip(fr[:5], start):
                        dst.copy_(src)
                    workspaces[F] = _lv.BatchWorkspace(g, D, dev)
                tried = True
                _chaos.fire("device.dispatch")
                return _lv.run_chunk_sharded(ops, g, tabs, fr[:5], workspaces[F], lvl0,
                                             budget, False, plan.nD, plan.nO, enc.model)

            acc, ovf, nonempty, lvl, fmax, count, cmax, cmin = _resilience.call(
                chunk, reason="sharded", metrics=metrics,
                breaker=_resilience.breaker("sharded", metrics=metrics))
            fmax_all = max(fmax_all, fmax)
            fr = fr[:5] + (lvl,)
            if checkpoint_path:
                wgl._save_search_checkpoint(checkpoint_path, fingerprint, "sharded", False,
                                            wgl._checkpoint_arrays(fr, sharded=True))
            attempt["levels"] = int(lvl)
            attempt["calls"] += 1
            chunk_wall = _time.perf_counter() - t_call
            attempt["wall_s"] = round(attempt["wall_s"] + chunk_wall, 3)
            if metrics is not None:
                note_chunk(F, FT, lvl0, lvl, count, cmax, cmin, chunk_wall,
                           _build.chunk_stage(was_loaded))

            def result(valid, **extra):
                r = {"valid": valid, "op_count": n, "device": True, **head,
                     "levels": int(lvl), "frontier_total": FT, "frontier_max": fmax_all,
                     "window": W, "torch_device": str(dev),
                     "wall_s": _time.perf_counter() - t0}
                r.update(extra)
                return r

            if chunk_callback is not None:
                chunk_callback({"level": int(lvl), "F": F, "global_capacity": FT,
                                "n_shards": D, "frontier_max": fmax_all,
                                "total_levels": total_levels, "count": int(count),
                                "wall_s": _time.perf_counter() - t0})
            if acc:
                return result(True), fr
            if ovf:
                return None, fr
            if not nonempty:
                # The last non-empty frontier, kept on the dead end, is the
                # refutation witness (the global, shard-major order).
                flat = tuple(a.reshape((-1,) + tuple(a.shape[2:])) for a in fr[:5])
                return result(False, max_linearized=int(lvl),
                              stuck_configs=wgl._returned_stuck_configs(enc, flat + (lvl,))), fr
            if lvl >= total_levels:
                return _prov.attach(result("unknown", info="level budget exhausted"),
                                    "level_budget", levels=int(lvl), F=F), fr

    fingerprint = wgl._enc_fingerprint(enc, plan) if checkpoint_path else None
    disk = wgl._load_search_checkpoint(checkpoint_path, fingerprint) \
        if checkpoint_path else None
    resume_fr = None
    if disk is not None:
        # Only an exact (never truncated) frontier may seed this search: the
        # single driver's beam writes lossy ones; its lossless companion is
        # fine.
        if not disk["truncated"]:
            resume_fr = disk["fr"]
        elif disk.get("lossless_fr") is not None:
            resume_fr = disk["lossless_fr"]
    resumed_level = 0
    if resume_fr is not None:
        # the global order, padded at its end to this mesh's multiple
        FT = capacity(max(f_total, resume_fr[0].shape[0]))
        flat = wgl._pad_frontier(wgl.frontier_from_arrays(*resume_fr, device=dev), FT, dev,
                                 ops)
        resumed_level = int(resume_fr[-1])
    else:
        FT = capacity(f_total)
        flat = wgl.initial_frontier(FT, W, KO, S, plan.init_state, dev)
    fr = tuple(a.reshape((D, FT // D) + tuple(a.shape[1:])) for a in flat[:5]) + (flat[5],)
    attempts: list = []
    for _esc in range(max_escalations + 1):
        attempt = {"F": FT, "levels": 0, "calls": 0, "wall_s": 0.0}
        attempts.append(attempt)
        res, fr = run_capacity(FT, fr, attempt)
        if res is not None:
            res["attempts"] = attempts
            if resumed_level:
                res["resumed_from_level"] = resumed_level
            if checkpoint_path and res.get("valid") != "unknown":
                wgl._clear_search_checkpoint(checkpoint_path)
            return res
        attempt["overflowed"] = True
        if metrics is not None and _esc < max_escalations:
            metrics.counter("wgl_capacity_escalations_total",
                            "Lossless frontier-capacity escalations").inc()
        FT = capacity(FT * 4)
        fr = wgl.pad_sharded_frontier(fr, FT // D, ops)
    return _prov.attach(
        {"valid": "unknown", "op_count": n, "device": True, **head,
         "info": f"frontier capacity schedule exhausted at {FT // 4}",
         "attempts": attempts, "torch_device": str(dev),
         "wall_s": _time.perf_counter() - t0},
        "escalation_budget", F=FT // 4, max_escalations=max_escalations)


def check_history_sharded(model, history, **kw) -> dict:
    """Encode ``history`` under ``model`` and run :func:`check_encoded_sharded`."""
    return check_encoded_sharded(encode_history(model, history), **kw)
