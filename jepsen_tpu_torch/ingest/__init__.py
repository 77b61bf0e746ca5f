"""Trace ingestion: recordings of real, unmodified systems → verdicts.
The port of the reference's ``jepsen_tpu/ingest``.

Everything upstream checks histories *we* generated; this package is
the front door for histories nobody instrumented for us — an etcd WAL
plus watch-stream dump, a redis ``MONITOR`` capture, a zookeeper
transaction log, a mongodb oplog, or any ndjson a pcap dissector
emits. Three stages:

1. **adapters** (:mod:`jepsen_tpu_torch.ingest.adapters`) parse raw trace
   lines into invoke/ok history ops: request/response correlation ids
   pair intervals, connection identity assigns process ids, committed
   single-point records become zero-width pairs, unpaired requests
   stay open as ``:info``, and a bounded reorder window repairs mildly
   shuffled recordings (beyond it, the offline planner's strict
   ``NonMonotoneHistoryError`` — corrupt input is an error, not a
   guess).
2. **mapper** (:mod:`jepsen_tpu_torch.ingest.mapper`) classifies the op
   shapes into a workload and dispatches: register/cas/counter/set/
   bank through the WGL segmented pipeline, whose device oracle runs on
   the card, txn shapes through the Elle graph checkers on the batched
   cycle engine on the card.
3. **the unmapped contract**: every line or op no rule explains is
   *counted* (``ingest_unmapped_total{adapter}``), attached as the
   typed ``ingest_unmapped_op`` cause, and folds the verdict
   one-sidedly to ``unknown`` — an incompletely explained recording
   can neither be certified nor refuted. Never a flip, never a guess,
   and never a free-text-only unknown.

Front door: ``python -m jepsen_tpu_torch.ingest TRACE --adapter etcd``
(exit codes 0 valid / 2 invalid / 1 unknown, matching
``jepsen_tpu_torch.offline``). The reference's second front door, ``POST
/submit/<tenant>?adapter=etcd`` on its checking service, comes with the
port of that service.
"""

from __future__ import annotations

from .adapters import (ADAPTERS, Adapter, DEFAULT_REORDER_WINDOW_NS,
                       by_name, events_to_ops, parse_trace,
                       repair_order)
from .mapper import WORKLOADS, check_ingested, classify

__all__ = ["ADAPTERS", "Adapter", "DEFAULT_REORDER_WINDOW_NS",
           "WORKLOADS", "by_name", "check_ingested", "classify",
           "events_to_ops", "ingest_check", "parse_trace",
           "repair_order"]


def ingest_check(lines, adapter: str = "jsonl", *, check: str = "auto",
                 reorder_window_ns: int = DEFAULT_REORDER_WINDOW_NS,
                 metrics=None, adapter_opts=None, **kw) -> dict:
    """Parse + classify + check in one call — the CLI's core.

    ``lines``: an iterable of raw trace lines. Returns the mapper's
    result dict (``valid`` / ``workload`` / ``unmapped`` /
    ``provenance`` / ``result``) with the adapter's parse stats
    attached under ``"stats"``. ``kw`` goes to
    :func:`~jepsen_tpu_torch.ingest.mapper.check_ingested` (``engine``,
    ``model_init``, ``device``: the card unless ``device="cpu"``)."""
    a = by_name(adapter, **(adapter_opts or {}))
    parsed = parse_trace(lines, a, reorder_window_ns=reorder_window_ns,
                         metrics=metrics)
    out = check_ingested(parsed, check=check, metrics=metrics, **kw)
    out["stats"] = parsed["stats"]
    return out
