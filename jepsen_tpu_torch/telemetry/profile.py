"""Performance attribution: a roofline profiler over the WGL telemetry,
the device trace and memory watermarks of ``--profile``, and
``profile.json``.

The port of the reference's ``jepsen_tpu/telemetry/profile.py``. The
attribution is a host fold of the registry, unchanged from the
reference; it reads what the port's drivers record when a registry is
injected:

- the stats rows of each level, ``wgl_level``
  (``[level, frontier, expanded, overflow]``, ``ops/wgl.py``);
- the ``wgl_chunk`` events (levels run, capacity ``F``, wall, ``stage``),
  ``wgl_batch_chunk``/``wgl_batch_rung``/``wgl_rebatch`` of the batch,
  and ``wgl_sharded_chunk`` of the frontier-sharded search;
- with ``plan=``, ``ops.wgl.level_byte_floor``, the reference's byte
  model of one level, a lower bound on its memory traffic.

At capacity ``F`` a level costs at least ``t_bw = byte_floor(F) /
copy_bw`` of streaming and at least ``t_lat`` of fixed overhead. Whichever
bound explains more of the measured wall of a level names the chunk
**bandwidth**- or **latency**-bound; compile-stage chunks are counted
apart. Without a measured copy bandwidth the classifier falls back to the
frontier's occupancy. The batch section gives the occupancy of each rung
(why members escalated), the sharded one the exchange's share of the
level's traffic, and the utilization section is
:func:`telemetry.utilization.reconstruct`.

Where the reference calls JAX's profiler and device API, the port calls
PyTorch's: :func:`trace_capture` is a ``torch.profiler`` trace exported as
a Chrome trace, and :func:`memory_watermarks` reads the CUDA caching
allocator. :func:`store_profile` writes ``profile.json`` into the run's
store directory; the ``/profile`` and ``/utilization`` pages of
:mod:`jepsen_tpu_torch.web` render it.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time as _time
from typing import Callable, Optional

from .registry import Registry

LOG = logging.getLogger("jepsen.telemetry.profile")

# Fixed per-level latency floor (seconds): dispatch + loop overhead at
# the 2x unroll — the constant term of wgl._levels_per_call's measured
# per-level cost model.
LATENCY_FLOOR_S = 2.0e-4

# Occupancy fallback threshold for the no-measured-bandwidth case: a
# chunk whose mean frontier fills less than this fraction of F is
# latency-bound (its levels are mostly fixed overhead).
OCCUPANCY_THRESHOLD = 0.25


def _byte_floor_fn(plan, byte_floor, **floor_kw) -> Optional[Callable]:
    """Resolve the bytes-per-level model: an explicit callable wins,
    else wrap ``wgl.level_byte_floor`` over the plan. Context kwargs
    (``sharded``, ``exchange``) are forwarded to explicit callables
    that accept them; older single-argument callables keep working."""
    if byte_floor is not None:
        if not floor_kw:
            return byte_floor
        # Decide by SIGNATURE, not by catching TypeError from the call
        # — a TypeError raised inside the callable must propagate, not
        # silently re-invoke it without the context kwargs.
        import inspect

        try:
            params = inspect.signature(byte_floor).parameters
            accepts_kw = any(
                p.kind == inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            ) or all(k in params for k in floor_kw)
        except (TypeError, ValueError):  # builtins/odd callables
            accepts_kw = False
        if accepts_kw:
            return lambda F: byte_floor(F, **floor_kw)
        return byte_floor
    if plan is None:
        return None
    from ..ops import wgl

    return lambda F: wgl.level_byte_floor(plan, F, **floor_kw)


def _classify(per_level_s: float, floor_bytes: Optional[int],
              copy_bw_gbs: Optional[float], occupancy: Optional[float],
              latency_floor_s: float) -> tuple[str, Optional[float], float]:
    """(bound, util, latency_share) for one executing chunk."""
    latency_share = min(1.0, latency_floor_s / per_level_s) \
        if per_level_s > 0 else 0.0
    util = None
    if floor_bytes and copy_bw_gbs:
        t_bw = floor_bytes / (copy_bw_gbs * 1e9)
        util = min(1.0, t_bw / per_level_s) if per_level_s > 0 else 0.0
        bound = "bandwidth" if util >= latency_share else "latency"
    elif occupancy is not None:
        bound = "bandwidth" if occupancy >= OCCUPANCY_THRESHOLD \
            else "latency"
    else:
        bound = "latency" if latency_share >= 0.5 else "indeterminate"
    return bound, util, latency_share


def attribute(registry: Registry, plan=None,
              byte_floor: Optional[Callable[[int], int]] = None,
              copy_bw_gbs: Optional[float] = None,
              latency_floor_s: float = LATENCY_FLOOR_S,
              max_chunks: int = 60) -> dict:
    """Fold a run's registry into a performance-attribution map.

    Returns ``{"device": ..., "batch": ..., "sharded": ...}`` — each
    section present only when its events exist. ``plan`` (a
    ``wgl.DevicePlan``) or ``byte_floor(F) -> bytes`` enables the byte
    model; ``copy_bw_gbs`` (a measured copy bandwidth of the device)
    enables achieved-GB/s and the measured-roofline classification.
    ``max_chunks`` bounds the per-chunk list in the output (head + tail
    kept, middle elided) so the stored JSON stays small.
    """
    out: dict = {}
    dev = _attribute_device(registry, plan, byte_floor, copy_bw_gbs,
                            latency_floor_s, max_chunks)
    if dev is not None:
        out["device"] = dev
    batch = _attribute_batch(registry)
    if batch is not None:
        out["batch"] = batch
    sharded = _attribute_sharded(registry, plan, byte_floor)
    if sharded is not None:
        out["sharded"] = sharded
    util = _attribute_utilization(registry)
    if util is not None:
        out["utilization"] = util
    return out


def _attribute_utilization(registry) -> Optional[dict]:
    """Per-device busy timelines + idle-gap attribution (see
    ``telemetry.utilization``). The import is gated on chunk events
    actually existing: with telemetry disabled (or nothing recorded)
    the utilization module is never imported."""
    if not any(registry.events(n) for n in
               ("wgl_chunk", "wgl_batch_chunk", "wgl_sharded_chunk")):
        return None
    from . import utilization

    return utilization.reconstruct(registry)


def _attribute_device(registry, plan, byte_floor, copy_bw_gbs,
                      latency_floor_s, max_chunks) -> Optional[dict]:
    chunks_ev = registry.events("wgl_chunk")
    if not chunks_ev:
        return None
    floor = _byte_floor_fn(plan, byte_floor)
    # Per-level rows grouped by capacity: escalation retries rewrite the
    # same level number at a larger F, so the (F, level-range) pair is
    # the only unambiguous join key for a chunk's levels.
    by_F: dict[int, list[dict]] = {}
    for e in registry.events("wgl_level"):
        by_F.setdefault(int(e["F"]), []).append(e)

    chunks = []
    for ev in chunks_ev:
        F = int(ev["F"])
        lvl0, lvl = int(ev["level0"]), int(ev["level"])
        wall = float(ev["wall_s"])
        levels = max(lvl - lvl0, 0)
        c: dict = {"F": F, "level0": lvl0, "level": lvl,
                   "levels": levels, "wall_s": round(wall, 4),
                   "stage": ev.get("stage", "execute")}
        rows = [e for e in by_F.get(F, ())
                if lvl0 < int(e["level"]) <= lvl]
        occ = None
        if rows:
            occ = sum(int(e["frontier"]) for e in rows) / (len(rows) * F)
            c["occupancy"] = round(occ, 4)
            c["frontier_mean"] = round(
                sum(int(e["frontier"]) for e in rows) / len(rows), 1)
            c["expanded_total"] = sum(int(e["expanded"]) for e in rows)
        if levels == 0:
            # An attempt that completed no level: an overflow awaiting
            # escalation (or an instant accept) — wall is real, but a
            # per-level rate is meaningless.
            c["bound"] = ("compile" if c["stage"] == "compile"
                          else "overflow")
            chunks.append(c)
            continue
        per_level = wall / levels
        c["per_level_ms"] = round(per_level * 1e3, 4)
        fb = int(floor(F)) if floor is not None else None
        if fb is not None:
            c["bytes_floor"] = fb * levels
            if wall > 0:
                c["achieved_gbs"] = round(fb * levels / wall / 1e9, 2)
        if c["stage"] == "compile":
            # First chunk after a fresh build: the wall is jit cost.
            c["bound"] = "compile"
        else:
            bound, util, lat = _classify(per_level, fb, copy_bw_gbs, occ,
                                         latency_floor_s)
            c["bound"] = bound
            c["latency_share"] = round(lat, 4)
            if util is not None:
                c["util"] = round(util, 4)
        chunks.append(c)

    # Rung (capacity) aggregation + run summary.
    rungs: dict[int, dict] = {}
    totals = {"wall_s": 0.0, "levels": 0, "bytes_floor": 0}
    # Executing chunks only (a compile chunk's wall conflates jit cost
    # with its levels' execution, so BOTH its wall and its bytes stay
    # out of the achieved-GB/s figure).
    exec_totals = {"wall_s": 0.0, "bytes_floor": 0}
    bound_wall: dict[str, float] = {}
    for c in chunks:
        r = rungs.setdefault(c["F"], {
            "F": c["F"], "chunks": 0, "levels": 0, "wall_s": 0.0,
            "bytes_floor": 0, "_occ": [], "_bw": {}})
        r["chunks"] += 1
        r["levels"] += c["levels"]
        r["wall_s"] += c["wall_s"]
        r["bytes_floor"] += c.get("bytes_floor") or 0
        if "occupancy" in c:
            r["_occ"].append(c["occupancy"])
        r["_bw"][c["bound"]] = r["_bw"].get(c["bound"], 0.0) + c["wall_s"]
        totals["wall_s"] += c["wall_s"]
        totals["levels"] += c["levels"]
        totals["bytes_floor"] += c.get("bytes_floor") or 0
        if c["bound"] != "compile":
            exec_totals["wall_s"] += c["wall_s"]
            exec_totals["bytes_floor"] += c.get("bytes_floor") or 0
        bound_wall[c["bound"]] = bound_wall.get(c["bound"], 0.0) \
            + c["wall_s"]
    rung_list = []
    for F in sorted(rungs):
        r = rungs[F]
        occ = r.pop("_occ")
        bw = r.pop("_bw")
        if occ:
            r["occupancy_mean"] = round(sum(occ) / len(occ), 4)
        r["wall_s"] = round(r["wall_s"], 4)
        if r["bytes_floor"] and r["wall_s"] > 0:
            r["achieved_gbs"] = round(
                r["bytes_floor"] / r["wall_s"] / 1e9, 2)
        r["bound"] = max(bw, key=bw.get)
        rung_list.append(r)

    summary: dict = {
        "levels": totals["levels"],
        "wall_s": round(totals["wall_s"], 4),
        "bound_wall_s": {b: round(w, 4)
                         for b, w in sorted(bound_wall.items())},
        "copy_bw_gbs": copy_bw_gbs,
    }
    hot = {b: w for b, w in bound_wall.items()
           if b in ("latency", "bandwidth")}
    if hot:
        summary["dominant_bound"] = max(hot, key=hot.get)
    if totals["bytes_floor"]:
        summary["bytes_floor_total"] = totals["bytes_floor"]
    if exec_totals["bytes_floor"] and exec_totals["wall_s"] > 0:
        summary["achieved_gbs"] = round(
            exec_totals["bytes_floor"] / exec_totals["wall_s"] / 1e9, 2)
        if copy_bw_gbs:
            summary["util"] = round(
                exec_totals["bytes_floor"] / exec_totals["wall_s"]
                / (copy_bw_gbs * 1e9), 4)

    if len(chunks) > max_chunks:
        head = chunks[: max_chunks // 2]
        tail = chunks[-(max_chunks - len(head)):]
        summary["chunks_elided"] = len(chunks) - len(head) - len(tail)
        chunks = head + tail
    return {"chunks": chunks, "rungs": rung_list, "summary": summary}


def _attribute_batch(registry) -> Optional[dict]:
    """Per-rung occupancy of the batched escalation pipeline: WHY a
    member escalated is visible as its rung's final occupancy (members
    still searching when the rung's ladder moved on) plus the rebatch
    events' member counts."""
    chunk_ev = registry.events("wgl_batch_chunk")
    rung_ev = registry.events("wgl_batch_rung")
    rebatch_ev = registry.events("wgl_rebatch")
    if not (chunk_ev or rung_ev):
        return None
    by_F: dict[int, list[dict]] = {}
    for e in chunk_ev:
        by_F.setdefault(int(e["F"]), []).append(e)
    rungs = []
    for e in rung_ev:
        F = int(e["F"])
        r = {k: e[k] for k in
             ("F", "members", "calls", "wall_s", "decided", "overflowed",
              "lossy") if k in e}
        evs = by_F.get(F, ())
        if evs:
            occs = [int(x["active"]) / max(int(x["batch"]), 1)
                    for x in evs]
            r["occupancy_mean"] = round(sum(occs) / len(occs), 4)
            r["occupancy_final"] = round(occs[-1], 4)
        rungs.append(r)
    if not rungs:  # chunk events only (older recordings)
        for F in sorted(by_F):
            evs = by_F[F]
            occs = [int(x["active"]) / max(int(x["batch"]), 1)
                    for x in evs]
            rungs.append({"F": F, "calls": len(evs),
                          "occupancy_mean": round(sum(occs) / len(occs), 4),
                          "occupancy_final": round(occs[-1], 4)})
    out: dict = {"rungs": rungs}
    if rebatch_ev:
        out["escalations"] = [
            {"from_F": e["from_F"], "to_F": e["to_F"],
             "members": e["members"]} for e in rebatch_ev]
    return out


def _attribute_sharded(registry, plan, byte_floor) -> Optional[dict]:
    """Interconnect share of the frontier-sharded search: the analytic
    exchange bytes (mode-aware — the hash-routed all_to_all or the
    legacy replicated all_gather) vs the per-shard compute byte floor —
    how much of the level's traffic is the exchange itself."""
    ev = registry.events("wgl_sharded_chunk")
    if not ev:
        return None
    # Exchange mode of the run (events predating the field are the
    # legacy all_gather recordings).
    mode = next((e["exchange"] for e in ev if "exchange" in e),
                "allgather")
    floor = _byte_floor_fn(plan, byte_floor, sharded=True, exchange=mode)
    ex_total = 0
    floor_total = 0
    prev_level = 0
    chunks = []
    for e in ev:
        lvl = int(e["level"])
        levels = max(lvl - prev_level, 0)
        prev_level = lvl
        c = {"level": lvl, "F": int(e["F"]),
             "n_shards": int(e["n_shards"]),
             "wall_s": e.get("wall_s")}
        # New field first; back-compat with recordings that only carry
        # the all_gather-named alias.
        ex = e.get("exchange_bytes", e.get("allgather_bytes"))
        if ex is not None:
            ex_total += int(ex)
            c["exchange_bytes"] = int(ex)
        for k in ("count_max", "count_min"):
            if k in e:
                c[k] = int(e[k])
        if floor is not None:
            fb = int(floor(int(e["F"]))) * levels
            floor_total += fb
            c["bytes_floor"] = fb
        chunks.append(c)
    if not ex_total:
        # Fall back to the run counters (older recordings carry only
        # the unlabeled all_gather total; newer ones label the
        # exchange counter by mode).
        s = registry.summary()
        ex_total = int(sum(
            v for k, v in s.items()
            if k.startswith("wgl_exchange_bytes_total"))) or \
            int(s.get("wgl_allgather_bytes_total", 0))
    out: dict = {"exchange": mode,
                 "chunks": chunks[-60:],
                 "interconnect": {"exchange_bytes_total": ex_total,
                                  # legacy alias, kept one layer deep so
                                  # pre-partitioning consumers keep
                                  # reading a number
                                  "allgather_bytes_total": ex_total}}
    if ex_total and floor_total:
        out["interconnect"]["share_of_traffic"] = round(
            ex_total / (ex_total + floor_total), 4)
        out["interconnect"]["compute_bytes_floor_total"] = floor_total
    return out


# ---------------------------------------------------------------------------
# Opt-in capture on the card (--profile): torch.profiler trace + memory marks

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_capture(outdir):
    """Profile the body with ``torch.profiler`` and export a Chrome trace
    to ``outdir/trace.json`` (open it in Perfetto or ``chrome://tracing``);
    yields the directory, or None when the profiler did not start.

    Activities: CPU, and CUDA where a card is visible. CUPTI records the
    kernels on the card and the runtime calls that launched them,
    whatever thread made the call: the port's kernels, launched through ``ctypes``
    (``_build``) with no torch op to correlate with, are there under
    their own names (``k_expand``, ``k_sort_cta``, ...), the online
    monitor's worker thread's as well as the analysis's. The CPU side
    records the torch ops of the thread that started the profiler only;
    a ``core.run``'s device work runs on other threads, so CPU activity
    adds almost nothing to the trace and is kept. The trace costs about
    1 KB a kernel launch (a kernel event, its runtime call and their flow
    pair): 33-39 MB for a 2,000-op run's 31,000-37,000 launches on an
    H100. CUPTI does not always record every kernel: on an H100 with
    torch 2.11, 7 of a profiled run's 3,000 level launches had no kernel
    record though their runtime calls did. Count launches from a trace
    with that in mind.

    Profiling never sinks the run: a profiler that fails to start (another
    trace already running, no profiler in this build) logs a warning with
    the exception, and the body runs unprofiled. Every other error,
    whether of the body or of stopping the profiler (which synchronises
    with the card) or of the export, propagates.
    """
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(str(outdir), exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
    except Exception as e:  # noqa: BLE001 - profiling never sinks the run
        LOG.warning("profiler did not start, running unprofiled: %r", e, exc_info=True)
        prof = None
    try:
        yield str(outdir) if prof is not None else None
    finally:
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(os.path.join(str(outdir), TRACE_FILE))


def memory_watermarks() -> list[dict]:
    """One entry per visible CUDA device, from its caching allocator:
    ``bytes_in_use`` (``allocated_bytes.all.current``),
    ``peak_bytes_in_use`` (``allocated_bytes.all.peak``, since the process
    started or its last ``torch.cuda.reset_peak_memory_stats``),
    ``peak_bytes_reserved`` (``reserved_bytes.all.peak``) and
    ``bytes_limit`` (the device's total memory, ``mem_get_info``). The
    port's kernels take every buffer they use from torch tensors, so the
    allocator sees all of the port's device memory. Empty without a
    CUDA device, as the reference's is on JAX's CPU."""
    import torch

    if not torch.cuda.is_available():
        return []
    out = []
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        _free, total = torch.cuda.mem_get_info(d)
        out.append({
            "device": f"cuda:{d}",
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        })
    return out


def store_profile(test: dict, registry: Optional[Registry] = None,
                  plan=None, copy_bw_gbs: Optional[float] = None,
                  extra: Optional[dict] = None) -> Optional[str]:
    """Write ``profile.json`` (attribution + memory watermarks) into the
    test's store directory next to metrics.jsonl, atomically; None when
    the test has no store or no registry."""
    reg = registry if registry is not None \
        else test.get("telemetry-registry")
    if reg is None:
        return None
    if not (test.get("name") and test.get("start-time")) or test.get(
            "no-store?"):
        return None
    from .. import store

    doc = {
        "generated_at": _time.time(),
        "attribution": attribute(reg, plan=plan, copy_bw_gbs=copy_bw_gbs),
        "memory_watermarks": memory_watermarks(),
    }
    if extra:
        doc.update(extra)
    path = store.path_mk(test, "profile.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True, default=str)
    os.replace(tmp, path)
    return str(path)
