"""Fleet fan-out: submit a planned history to your own serving stack.
The port of the reference's ``jepsen_tpu/offline/fanout.py``.

The plan's streams partition the history's keys, so each stream's op
list is a self-contained sub-history — which makes it a perfectly
shaped *synthetic tenant* for the checking service and its router.
Fanning the streams across N backends turns the fleet into the third
offline parallelism axis (after the device batch and the sharded mesh):
every backend re-runs the SAME cut/carry rules server-side over its
tenants' ops, and the per-tenant verdicts fold through
``checker.merge_valid`` into the plan verdict, preserving the one-sided
unknown contract end to end — across process boundaries.

Two transports, same shape:

- :func:`fanout_services` — N in-process :class:`~jepsen_tpu_torch.
  service.Service` instances fed through ``InProcessServiceClient``
  (tests, ``--simulate``-style runs; shares the GIL, so it proves the
  protocol, not the speedup).
- :func:`fanout_fleet` — N REAL backend processes behind the tenant
  :class:`~jepsen_tpu_torch.service.router.Router`, fed as ndjson over
  HTTP through the resume-aware client. Separate processes mean the
  per-stream host work runs on separate cores, and the router's
  federated scrape attributes per-backend utilization.

The device: both decide on the card unless the caller passes
``device="cpu"`` — every in-process ``Service`` gets ``device=``, every
backend process ``--device`` (the reference pins its backend processes to
the CPU through ``JAX_PLATFORMS=cpu``). On the card the backend processes
of :func:`fanout_fleet` each hold a CUDA context, and their rounds
time-slice the one card.
"""

from __future__ import annotations

import tempfile
import threading
import time as _time
from typing import Optional

from ..checker import merge_valid
from ..checker import provenance as _prov
from .planner import Plan

__all__ = ["fanout_services", "fanout_fleet", "TENANT_PREFIX"]

TENANT_PREFIX = "offline-"


def _tenant_of(stream: str) -> str:
    return f"{TENANT_PREFIX}{stream}"


def _mixed_result(p: Plan) -> dict:
    return {
        "valid": "unknown", "n_ops": p.n_ops, "plan": p.stats(),
        "info": ("mixed keyed/keyless history: per-key split cannot "
                 "match independent.subhistory; verdict degraded to "
                 "unknown"),
        "provenance": _prov.block(_prov.add_counts({}, ["mixed_keys"])),
    }


def _fold_tenants(tenant_rows: dict, extra_causes=()) -> dict:
    """merge_valid over the synthetic tenants' verdicts + the union of
    their provenance causes (the one-sided degradation stays typed
    across the process boundary)."""
    valids = []
    counts: dict = {}
    for row in tenant_rows.values():
        v = (row or {}).get("valid")
        valids.append(v if v in (True, False, "unknown") else "unknown")
        causes = ((row or {}).get("provenance") or {}).get("causes")
        if causes:
            counts = _prov.merge_counts(counts, causes)
    counts = _prov.add_counts(counts, extra_causes)
    out: dict = {"valid": merge_valid(valids) if valids else True}
    prov = _prov.block(counts)
    if prov is not None:
        out["provenance"] = prov
    return out


def fanout_services(p: Plan, model, *, backends: int = 2,
                    engine: str = "auto", metrics=None,
                    max_configs: int = 500_000,
                    chunk_ops: int = 512,
                    drain_timeout: float = 300.0,
                    device=None) -> dict:
    """Decide a plan across N in-process Service backends (streams
    assigned round-robin as synthetic tenants), each deciding on
    ``device`` (the card unless ``device="cpu"``)."""
    from ..service import Service
    from ..service.client import InProcessServiceClient

    if backends < 1:
        raise ValueError("backends must be >= 1")
    t0 = _time.perf_counter()
    if p.mixed:
        return _mixed_result(p)
    services = [Service(model, engine=engine, metrics=metrics,
                        max_configs=max_configs, register_live=False,
                        ledger=False, name=f"offline-backend-{i}",
                        device=device)
                for i in range(backends)]
    try:
        assignment = {s: services[i % backends]
                      for i, s in enumerate(sorted(p.stream_ops))}
        reports: dict = {}

        def _feed(stream: str) -> None:
            client = InProcessServiceClient(
                assignment[stream], _tenant_of(stream),
                chunk_ops=chunk_ops)
            reports[stream] = client.feed(p.stream_ops[stream])

        feeders = [threading.Thread(target=_feed, args=(s,),
                                    daemon=True)
                   for s in p.stream_ops if p.stream_ops[s]]
        for th in feeders:
            th.start()
        for th in feeders:
            th.join()
        tenant_rows: dict = {}
        lost = []
        for svc in services:
            svc.flush(drain_timeout)
            fin = svc.drain(timeout=drain_timeout)
            tenant_rows.update(fin.get("tenants") or {})
        for s, rep in reports.items():
            if rep.get("error") or rep.get("sent") != rep.get("ops"):
                lost.append(s)
    finally:
        for svc in services:
            try:
                svc.drain(timeout=5)
            except Exception:  # noqa: BLE001 - already drained
                pass
    out = _fold_tenants(tenant_rows,
                        ["lost_segments"] if lost else [])
    if lost:
        # A feeder that could not deliver its whole stream leaves the
        # undelivered suffix undecided — unknown, never a silent True.
        out["valid"] = merge_valid([out["valid"], "unknown"])
        out["undelivered_streams"] = sorted(lost)
    out.update(n_ops=p.n_ops, backends=backends, plan=p.stats(),
               wall_s=round(_time.perf_counter() - t0, 4),
               feed_reports={s: r for s, r in reports.items()},
               tenants={t: {k: v for k, v in (row or {}).items()
                            if k != "segments"}
                        for t, row in tenant_rows.items()})
    return out


def fanout_fleet(p: Plan, *, backends: int = 2,
                 model: str = "cas-register", engine: str = "auto",
                 max_configs: int = 500_000, chunk_ops: int = 1024,
                 drain_timeout: float = 600.0, metrics=None,
                 env: Optional[dict] = None,
                 journal_root: Optional[str] = None,
                 device=None) -> dict:
    """Decide a plan across N REAL backend processes behind the tenant
    router ("submit the history to yourself"), each started with
    ``--device`` (the card unless ``device="cpu"``; without a card a
    backend exits 255 and this raises). Returns the folded verdict plus
    the router's fleet stats — including the federated per-backend
    utilization attribution."""
    from ..service import router as _router
    from ..service.client import HttpServiceClient
    from ..telemetry import Registry

    if backends < 1:
        raise ValueError("backends must be >= 1")
    t0 = _time.perf_counter()
    if p.mixed:
        return _mixed_result(p)
    reg = metrics if metrics is not None else Registry()
    tmpd = journal_root or tempfile.mkdtemp(prefix="jepsen-offline-")
    bks = _router.spawn_backends(
        backends, journal_root=tmpd, model=model, engine=engine,
        max_configs=max_configs, metrics=reg, env=env, device=device)
    router = _router.Router(bks, metrics=reg, name="offline-fanout",
                            register_live=False, rebalance=False)
    srv = _router.server(router, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        reports: dict = {}

        def _feed(stream: str) -> None:
            client = HttpServiceClient(url, _tenant_of(stream),
                                       chunk_ops=chunk_ops,
                                       max_retries=60,
                                       max_backoff_s=0.5)
            reports[stream] = client.feed(p.stream_ops[stream])

        feeders = [threading.Thread(target=_feed, args=(s,),
                                    daemon=True)
                   for s in p.stream_ops if p.stream_ops[s]]
        feed_t0 = _time.perf_counter()
        for th in feeders:
            th.start()
        for th in feeders:
            th.join()
        feed_s = _time.perf_counter() - feed_t0
        fin = router.drain(timeout=drain_timeout)
        stats = router.stats()
    finally:
        router.close()
        srv.shutdown()
        srv.server_close()
    lost = sorted(s for s, r in reports.items()
                  if r.get("error") or r.get("sent") != r.get("ops"))
    out = _fold_tenants(fin.get("tenants") or {},
                        ["lost_segments"] if lost else [])
    if lost:
        out["valid"] = merge_valid([out["valid"], "unknown"])
        out["undelivered_streams"] = lost
    out.update(
        n_ops=p.n_ops, backends=backends, plan=p.stats(),
        wall_s=round(_time.perf_counter() - t0, 4),
        feed_s=round(feed_s, 4),
        p99_decision_latency_s=fin.get("p99_decision_latency_s"),
        feed_reports=reports,
        tenants={t: {k: v for k, v in (row or {}).items()
                     if k != "segments"}
                 for t, row in (fin.get("tenants") or {}).items()},
        backend_loads=stats.get("backend_loads"),
        fleet=stats.get("fleet"))
    return out
