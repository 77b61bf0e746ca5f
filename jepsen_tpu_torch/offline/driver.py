"""Offline DAG executor: fan planned segments through the multi-stream
scheduler. The port of the reference's ``jepsen_tpu/offline/driver.py``.

The driver submits every stream's segment chain, in stream-local seq
order, to ONE shared :class:`~jepsen_tpu_torch.online.scheduler.
SegmentScheduler`, whose rounds co-batch ready (segment x carried state)
members of many streams into one ``check_encoded_batch`` search on the
card. Verdicts fold by the scheduler's contract (a segment is valid iff
any member linearizes, invalid iff all are refuted, and an unknown poisons
the key's later segments), and the stream folds merge through
``checker.merge_valid``: the segmented path can only degrade to unknown
against the single search's verdict, never flip it.

Engines: ``auto``, ``device`` and ``host`` are the scheduler's;
``sharded`` is the device oracle with the default
:func:`~jepsen_tpu_torch.parallel.make_mesh` attached, which in the port
is one shard on one card (the reference's default mesh spans its
devices). The reference's per-device ``utilization`` summary needs its
``telemetry.profile``, which the port does not have yet: the result has
the scheduler's own ``decide_s`` and ``busy_pct``.
"""

from __future__ import annotations

import time as _time
from typing import Any, Optional

from ..checker import provenance as _prov
from ..models import Model
from ..online.scheduler import SegmentScheduler
from .planner import Plan

__all__ = ["drive", "ENGINES"]

ENGINES = ("auto", "device", "host", "sharded")


def drive(p: Plan, model: Model, *, engine: str = "auto",
          metrics=None, max_configs: int = 500_000,
          batch_f: int = 256,
          max_ready_per_stream: Optional[int] = None,
          timeout: Optional[float] = 600.0, device=None) -> dict:
    """Decide a planned history; returns the offline result map::

        {"valid": True|False|"unknown", "n_ops": ..., "wall_s": ...,
         "engine": ..., "plan": p.stats(), "streams": {name: fold},
         "provenance": {...}?, "violation": {...}?, "failover": {...}?}

    ``failover`` (here and in a stream's fold) counts the oracle rounds
    that the host re-decided after the device engine failed past its
    retries or its breaker was open: ``rounds``, ``members``, ``engines``
    and ``causes`` (the failure's type, or ``circuit_open``). A
    deterministic device failure (a failed kernel build, a ``ValueError``
    or ``TypeError``) is not failed over: it is raised here.

    ``device``: the torch device of the device oracle (the card unless
    ``device="cpu"``); the host engine never reaches it.

    The verdict is the ``merge_valid`` fold of every stream's fold —
    identical in shape to what ``check_history`` returns for the same
    history on one driver, modulo one-sided unknown degradation with
    typed provenance causes.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown offline engine {engine!r}")
    t0 = _time.perf_counter()
    out: dict = {"n_ops": p.n_ops, "engine": engine, "plan": p.stats()}

    if p.mixed:
        # Same degradation (and same cause) as the monitor: a keyed/
        # keyless mix means independent.subhistory's keyless broadcast
        # cannot be reproduced by any split — planned or streamed.
        out["valid"] = "unknown"
        out["info"] = ("mixed keyed/keyless history: per-key split "
                       "cannot match independent.subhistory; verdict "
                       "degraded to unknown")
        out["provenance"] = _prov.block(
            _prov.add_counts({}, ["mixed_keys"]))
        out["wall_s"] = round(_time.perf_counter() - t0, 4)
        return out
    if not p.items:
        out["valid"] = True
        out["wall_s"] = round(_time.perf_counter() - t0, 4)
        return out

    mesh = None
    sched_engine = engine
    if engine == "sharded":
        from ..parallel import make_mesh

        mesh = make_mesh(device=device)
        sched_engine = "device"
    sched = SegmentScheduler(
        model, engine=sched_engine, metrics=metrics,
        max_configs=max_configs, batch_f=batch_f,
        max_ready_per_stream=max_ready_per_stream, mesh=mesh, device=device)
    try:
        for name in p.streams:
            sched.register_stream(name)
        # Breadth-first walk: submit every stream's chain in seq order;
        # the scheduler's ready-take interleaves across streams (the
        # fairness cap bounds any one stream's share of a round) and
        # carry edges hold back each key's next segment until its
        # predecessor decided.
        for name, items in p.streams.items():
            batch: list = []
            cur = None
            for it in items:
                if it.seq != cur and batch:
                    sched.submit(batch, stream=name)
                    batch = []
                cur = it.seq
                batch.append(it.segment)
            if batch:
                sched.submit(batch, stream=name)
    finally:
        sched.close(timeout)
    if sched.fatal_error is not None:
        # a broken device path (a failed kernel build, a refused plan) is
        # the caller's to see, never a verdict decided elsewhere
        raise sched.fatal_error
    res = sched.result()
    out["valid"] = res["valid"]
    out["wall_s"] = round(_time.perf_counter() - t0, 4)
    streams: dict = {}
    decide_s = 0.0
    for name in p.streams:
        sr = sched.stream_result(name)
        busy = sum((row.get("wall_s") or 0.0)
                   for row in sr.get("segments", ()))
        decide_s += busy
        row = {k: v for k, v in sr.items() if k != "segments"}
        row["decide_s"] = round(busy, 4)
        streams[str(name)] = row
    out["streams"] = streams
    # Scheduler-side busy attribution: total decide wall across every
    # segment vs the drive's wall clock — how much of the run the decide
    # pipeline was deciding rather than planning/submitting/waiting.
    out["decide_s"] = round(decide_s, 4)
    if out["wall_s"] > 0:
        out["busy_pct"] = round(
            min(100.0, 100.0 * decide_s / out["wall_s"]), 1)
    out["segments_decided"] = res.get("segments_decided")
    if res.get("provenance") is not None:
        out["provenance"] = res["provenance"]
    if res.get("violation") is not None:
        out["violation"] = res["violation"]
    if res.get("failover") is not None:
        out["failover"] = res["failover"]
    return out
