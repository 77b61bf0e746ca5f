"""Batched linearizability checking: many histories, one device search.

The port of the reference's ``jepsen_tpu/parallel/batch.py``: the device
counterpart of ``jepsen.independent``'s per-key ``bounded-pmap`` and of
the BASELINE "batch replay of 100 archived histories" config. Every
history is planned and padded to common static dims, and the level
kernels run all members at once on a member axis (one launch per stage
per level for the whole batch, ``ops.wgl_level.run_chunk_batch``).

**The escalation ladder.** The batch starts at a shared capacity ``f``.
Members that overflow it are regrouped on the device (``wgl_regroup``)
into a smaller batch at the next rung of the schedule, each resuming from
its own kept frontier at its own level (the level program restores the
pre-overflow frontier, so escalation is lossless). The top rung runs as a
lossy beam per member, the single driver's rule at its schedule's top, so
accepts that are sound under truncation land in the batch too. The serial
single-history search is the last resort, for members the whole ladder
leaves undecided.

Each rung runs in chunks with per-member level budgets. The stacked
tables are made once, on the device, and each rung row-selects its
members from them (the reference instead stacks the next rung's tables
on the host while the device runs the current chunk).

**A mesh** (``mesh=``, a :class:`jepsen_tpu_torch.parallel.Mesh`) shards
the member axis over its ``batch_axis`` ("dp") shards as the reference
does. Its shards sit on one device, so on the card the mesh is the member
axis plus the reference's divisibility padding: the planned rows, and each
rung's live rows, pad to a multiple of ``dp`` with copies of their first
row, which run, are decided and are dropped; and a chunk's level budget
counts ``ceil(Bk/dp)`` members, as each of the reference's devices runs
that many.
"""

from __future__ import annotations

import math
import time as _time
from typing import Optional, Sequence

import numpy as np

from .. import _build
from .. import trace as _trace
from ..checker import provenance as _prov
from ..devices import mesh_device, resolve_device
from ..history import History
from ..models import Model
from ..ops import wgl
from ..ops import wgl_level as _lv
from ..ops.encode import EncodedHistory, encode_history

_RESILIENCE_SLICE = "retries= (the batch's retry and circuit breaker) comes with a " \
    "later slice of the port (the checking pipeline's resilience)"


def check_encoded_batch(
    encs: Sequence[EncodedHistory],
    f: int = 256,
    mesh=None,
    batch_axis: str = "dp",
    max_open: int = 128,
    window_cap: int = 1024,
    escalate=True,
    f_schedule: Optional[tuple] = None,
    levels_per_call: Optional[int] = None,
    metrics=None,
    chunk_callback=None,
    retries: int = 0,
    device=None,
    plain: bool = False,
) -> list[dict]:
    """Check a batch of encoded histories (one model family) together on
    ``device`` (the GPU unless ``device="cpu"``).

    Returns one result map per history, in order, in the shape of
    ``ops.wgl.check_encoded_device``'s: ``valid``, ``op_count``,
    ``device``, ``levels``, ``frontier_max``, ``batched`` and, where they
    apply, ``escalated``, ``decided_at_F``, ``rungs``, ``beam``,
    ``max_linearized``, ``stuck_configs``, ``info`` and ``causes``.

    ``escalate``: ``True`` (default) regroups members that overflow the
    shared capacity ``f`` up ``f_schedule`` (default ``wgl.F_SCHEDULE``);
    the serial driver sees only members the top rung leaves undecided.
    ``"serial"`` sends every overflowing member straight to the serial
    driver. ``False`` reports them unknown.

    ``mesh``: shard the member axis over the product of the mesh's axes
    named ``batch_axis`` (see the module docstring); the batch runs on the
    mesh's device, and a ``device`` that differs raises ``ValueError``.

    ``chunk_callback(info)`` is called after every device chunk with the
    reference's keys (``F``, ``rung``, ``chunk``, ``active``, ``batch``,
    ``level_max``, ``wall_s``); its exceptions propagate. ``metrics``: a
    :class:`jepsen_tpu_torch.telemetry.Registry` that receives the
    reference's ``wgl_host_stack``, ``wgl_rebatch``, ``wgl_batch_chunk``
    and ``wgl_batch_rung`` events and its counters and gauges (re-batches,
    chunks, occupancy by rung, frontier bytes, serial fallbacks, members by
    outcome); the serial last resort gets both. A chunk's ``stage`` is
    ``"compile"`` when it paid the process's first load of the kernel
    library (``_build.chunk_stage``).

    ``plain``: run the plain PyTorch version of every stage (a loop over
    members) even on the GPU. ``retries`` comes with a later slice and
    raises ``ValueError``."""
    dp = 1
    if mesh is not None:
        device = mesh_device(mesh, device)
        dp = math.prod(mesh.shape[a] for a in mesh.axis_names if a == batch_axis) or 1
    if retries:
        raise ValueError(_RESILIENCE_SLICE)
    if not encs:
        return []
    return _check_encoded_batch_once(
        encs, f=f, dp=dp, max_open=max_open, window_cap=window_cap, escalate=escalate,
        f_schedule=f_schedule, levels_per_call=levels_per_call,
        device=resolve_device(device), plain=plain, metrics=metrics,
        chunk_callback=chunk_callback)


def _note_host_stack(metrics, F, members: int, wall: float) -> None:
    """One ``wgl_host_stack`` event: a rung's tables made ready for the
    card while the device waits (``overlap=False``; the port stacks no
    tables while a chunk runs)."""
    t1 = round(_time.time(), 6)
    metrics.event("wgl_host_stack", F=int(F), members=int(members), wall_s=round(wall, 6),
                  overlap=False, t0=round(t1 - wall, 6), t1=t1)


def _check_encoded_batch_once(encs, f, dp, max_open, window_cap, escalate, f_schedule,
                              levels_per_call, device, plain, metrics=None,
                              chunk_callback=None) -> list[dict]:
    t0 = _time.perf_counter()
    mk = wgl._model_cache_key(encs[0].model)
    if any(wgl._model_cache_key(e.model) != mk for e in encs):
        raise ValueError(
            "check_encoded_batch requires one model family per batch; got "
            f"{sorted({e.model.name for e in encs})}")
    results: list[Optional[dict]] = [None] * len(encs)
    ops = _lv.PLAIN if plain else _lv.KERNELS
    model = encs[0].model

    # Plan each history on the host; find the common static dims.
    plans = [wgl.plan_device(e, max_open=max_open, window_cap=window_cap, device="cpu")
             for e in encs]
    idx = []
    for i, (e, p) in enumerate(zip(encs, plans)):
        if p.nD == 0:
            results[i] = {"valid": True, "op_count": e.n, "device": True, "levels": 0}
        elif not p.ok:
            results[i] = _prov.attach({
                "valid": "unknown", "op_count": e.n, "device": True, "info": p.reason,
            }, "encoding_unsupported", reason=p.reason)
        else:
            idx.append(i)
    if not idx:
        return results  # type: ignore[return-value]

    dims = np.array([plans[i].dims for i in idx])  # (W, KO, S, ND, NO)
    W, KO, ND, NO = (int(dims[:, k].max()) for k in (0, 1, 3, 4))
    padded = [wgl.plan_device(encs[i], max_open=max_open, window_cap=window_cap,
                              pad_to=(W, KO, ND, NO), device="cpu") for i in idx]
    # Row r <-> encs[orig[r]]; None marks a copy of row 0 that pads the
    # rows to a multiple of the mesh's dp shards.
    orig: list[Optional[int]] = list(idx)
    while len(padded) % dp:
        padded.append(padded[0])
        orig.append(None)
    t_hs = _time.perf_counter()
    stack = wgl.stack_plans(padded, device)
    CC = stack.B or (W + KO * 32)

    sched = sorted(set(f_schedule if f_schedule is not None else wgl.F_SCHEDULE))
    batched_esc = escalate is True or escalate == "batch"
    rungs = [f] + ([x for x in sched if x > f] if batched_esc else [])

    n_rows = len(padded)
    lvls = np.zeros(n_rows, np.int64)
    fmax_all = np.ones(n_rows, np.int64)
    totals_all = stack.totals.numpy().astype(np.int64)
    status = ["run"] * n_rows  # run | acc | stuck | exhausted | ovf
    rung_stats: list[dict] = []
    live = list(range(n_rows))
    prev_live: list = []
    fr5 = None  # stacked frontier of `live`, at the current capacity

    def pad_rows(rows):
        """Mesh divisibility: repeat the first row (its verdicts are dropped)."""
        return rows + rows[:1] * (-len(rows) % dp)

    for ri, F in enumerate(rungs):
        live = pad_rows(live)
        Bk = len(live)
        # The top rung runs as a per-member beam, as the single driver does
        # at its schedule's top capacity: on overflow it keeps the best F
        # configs and goes on. A single-rung ladder stays lossless (its
        # overflow verdicts belong to the fallback policy).
        lossy_rung = batched_esc and len(rungs) > 1 and F == rungs[-1]
        for r in set(live):
            status[r] = "run"
        if ri == 0:
            plan = stack
            fr5 = wgl.initial_frontier_batch(F, W, KO, plan.init_state)
            if metrics is not None:
                _note_host_stack(metrics, F, len(live), _time.perf_counter() - t_hs)
        else:
            # Re-batch: the overflowed members' tables row-selected and
            # their kept frontiers regrouped on the device at the new
            # capacity.
            t_hs = _time.perf_counter()
            plan = stack.select(live)
            rowsel = [prev_live.index(r) for r in live]
            fr5 = ops.regroup(fr5, rowsel, F)
            if metrics is not None:
                _note_host_stack(metrics, F, len(live), _time.perf_counter() - t_hs)
                metrics.counter("wgl_rebatch_total",
                                "Overflowed members regrouped into a higher-capacity "
                                "re-batch").inc()
                metrics.event("wgl_rebatch", from_F=rungs[ri - 1], to_F=F,
                              members=sum(1 for r in live if orig[r] is not None),
                              level_min=int(lvls[live].min()),
                              level_max=int(lvls[live].max()))
        g = wgl.level_geometry(plan, F)
        ws = _lv.BatchWorkspace(g, Bk, device)
        nD, nO = plan.nD.tolist(), plan.nO.tolist()
        # Each of the reference's dp devices runs ceil(Bk/dp) members in
        # turn; the chunk length follows, so levels and rungs match it.
        lpc = levels_per_call or wgl._levels_per_call(F * CC * max(1, -(-Bk // dp)))
        totals = totals_all[live]
        lsub = lvls[live].copy()
        fsub = fmax_all[live].copy()
        active = np.ones(Bk, bool)
        acc_s = np.zeros(Bk, bool)
        ovf_s = np.zeros(Bk, bool)  # lossy rung: "truncated at least once"
        stuck_s = np.zeros(Bk, bool)
        calls = 0
        t_rung = _time.perf_counter()
        t_last = t_rung  # the previous chunk's end
        prev_live = live
        next_F = rungs[ri + 1] if ri + 1 < len(rungs) else None
        while active.any():
            budgets = np.where(active, np.minimum(totals, lsub + lpc), lsub)
            was_loaded = _build.loaded()
            flags = np.asarray(_lv.run_chunk_batch(
                ops, g, plan.tabs, fr5, ws, lsub.tolist(), budgets.tolist(),
                [lossy_rung] * Bk, nD, nO, model, ladder=(totals.tolist(), lpc)),
                dtype=np.int64)
            calls += 1
            acc = flags[:, 0].astype(bool)
            ovf = flags[:, 1].astype(bool)
            nonempty = flags[:, 2].astype(bool)
            lsub = np.where(active, flags[:, 3], lsub)
            fsub = np.maximum(fsub, np.where(active, flags[:, 4], 1))
            acc_s |= active & acc
            # A lossy-rung member can truncate and accept in one chunk; the
            # beam marker must record it (no ~acc guard).
            ovf_s |= active & ovf
            stuck_s |= active & ~acc & ~nonempty & (lossy_rung | ~ovf)
            if lossy_rung:
                # The beam goes on past overflow: ovf only records truncation.
                active = active & ~acc & nonempty & (lsub < totals)
            else:
                active = active & ~acc & ~ovf & nonempty & (lsub < totals)
            if metrics is not None:
                metrics.counter(
                    "wgl_donated_frontier_bytes_total",
                    "Frontier bytes the chunk updated in place (no carry copy)").inc(
                        sum(int(a.nbytes) for a in fr5))
                metrics.counter("wgl_batch_chunks_total",
                                "Batched-escalation kernel chunk invocations").inc()
                metrics.gauge("wgl_batch_occupancy",
                              "Members still searching / batch rows, after the last chunk",
                              labelnames=("F",)).labels(F=F).set(float(active.sum()) / Bk)
                now_pc = _time.perf_counter()
                chunk_wall = now_pc - t_last
                t_last = now_pc
                t1e = round(_time.time(), 6)
                metrics.event(
                    "wgl_batch_chunk", F=F, chunk=calls, active=int(active.sum()), batch=Bk,
                    level_max=int(lsub.max()), wall_s=round(now_pc - t_rung, 4),
                    chunk_wall_s=round(chunk_wall, 6), n_devices=dp,
                    stage=_build.chunk_stage(was_loaded), t0=round(t1e - chunk_wall, 6),
                    t1=t1e, **_trace.event_tags())
            if chunk_callback is not None:
                chunk_callback({"F": F, "rung": ri, "chunk": calls,
                                "active": int(active.sum()), "batch": Bk,
                                "level_max": int(lsub.max()),
                                "wall_s": _time.perf_counter() - t0})
        lvls[live] = lsub
        fmax_all[live] = fsub
        rung_stats.append({"F": F, "members": sum(orig[r] is not None for r in live),
                           "calls": calls,
                           "wall_s": round(_time.perf_counter() - t_rung, 3)})
        if metrics is not None:
            metrics.event(
                "wgl_batch_rung", F=F, members=rung_stats[-1]["members"], calls=calls,
                wall_s=rung_stats[-1]["wall_s"], decided=int(np.sum(acc_s | stuck_s)),
                overflowed=int(np.sum(ovf_s & ~acc_s & ~stuck_s)) if not lossy_rung else 0,
                lossy=bool(lossy_rung), **_trace.event_tags())
        # Classify this rung's members; decided members get results now.
        overflowed = []
        fr_host = None
        for b, r in enumerate(live):
            i = orig[r]
            if status[r] != "run":
                continue  # a padding copy of a row decided at its first place
            truncated = lossy_rung and bool(ovf_s[b])
            if acc_s[b]:
                status[r] = "acc"
            elif stuck_s[b]:
                status[r] = "stuck"
            elif ovf_s[b] and not lossy_rung:
                status[r] = "ovf"
                overflowed.append(r)
                continue
            else:
                status[r] = "exhausted"
            if i is None:
                continue
            base = {"op_count": encs[i].n, "device": True, "levels": int(lvls[r]),
                    "frontier_max": int(fmax_all[r]), "batched": True}
            if ri > 0:
                base.update(escalated=True, decided_at_F=F, rungs=list(rung_stats))
            if truncated:
                base["beam"] = True
            if status[r] == "acc":
                # Sound even after a truncation: dropping configs only
                # removes accepting paths, never invents one.
                results[i] = {"valid": True, **base}
            elif status[r] == "stuck" and truncated:
                # Beam exhaustion is not a refutation (configs were
                # dropped); the serial last resort may still decide.
                status[r] = "ovf"
                overflowed.append(r)
                continue
            elif status[r] == "stuck":
                results[i] = {"valid": False, "max_linearized": int(lvls[r]), **base}
                # The level program keeps the last non-empty frontier on a
                # dead end: this member's row of the stack is its witness.
                # Diagnostics never mask the verdict.
                try:
                    if fr_host is None:
                        fr_host = wgl.frontier_stack_to_arrays(fr5)
                    results[i]["stuck_configs"] = wgl.member_stuck_configs(
                        encs[i], fr_host, b)
                except (ValueError, IndexError, KeyError, TypeError):
                    pass
            else:
                results[i] = _prov.attach(
                    {"valid": "unknown", "info": "level budget exhausted", **base},
                    "level_budget", levels=int(lvls[r]), F=int(F))
        if not overflowed:
            live = []
            break
        live = overflowed
        if next_F is None:
            break

    # Members still undecided past the top rung: the serial single-history
    # driver is the last resort (optimistic beam, exhaustive phase).
    for r in live:
        i = orig[r]
        if status[r] != "ovf" or i is None:
            continue
        if escalate is False:
            results[i] = _prov.attach({
                "valid": "unknown", "op_count": encs[i].n, "device": True,
                "info": f"frontier overflow at shared capacity {f}",
            }, "overflow_top_rung", F=int(f), escalate=False)
            continue
        if escalate == "serial":
            serial_sched = tuple(x for x in sched if x > f) or (f,)
        else:
            serial_sched = tuple(rungs)
        if metrics is not None:
            metrics.counter("wgl_batch_serial_fallback_total",
                            "Members handed to the serial single-history driver after the "
                            "batched rungs overflowed").inc()
        results[i] = wgl.check_encoded_device(
            encs[i], f_schedule=serial_sched, max_open=max_open, window_cap=window_cap,
            device=device, plain=plain, metrics=metrics, chunk_callback=chunk_callback)
        results[i]["escalated"] = "serial"
        if len(rungs) > 1:
            results[i]["rungs"] = rung_stats
    if metrics is not None:
        c = metrics.counter("wgl_batch_members_total",
                            "Members decided through the batched checker by outcome",
                            labelnames=("result",))
        for i in idx:
            c.labels(result=str(results[i].get("valid"))).inc()
    return results  # type: ignore[return-value]


def check_batch(model: Model, histories: Sequence[History], **kw) -> list[dict]:
    """:func:`check_encoded_batch` of ``histories`` encoded for ``model``."""
    return check_encoded_batch([encode_history(model, h) for h in histories], **kw)


check_histories = check_batch
