"""Read/write-register txn interpretation (elle.rw-register equivalent).

The port of the reference's ``jepsen_tpu/elle/wr.py``.

Histories of transactions over registers with micro-ops ``["w", k, v]``
and ``["r", k, v]``; writes are globally unique (cycle/wr.clj:2-4), so a
read traces exactly to its writer (wr edges). Unlike list-append, the raw
history does NOT recover a version order, so ww/rw edges need an extra
assumption (cycle/wr.clj:20-30):

- ``linearizable_keys=True``: each key independently linearizable — the
  realtime order of ok writes per key is its version order.
- ``sequential_keys=True``: each key sequentially consistent — version
  order from per-process write order, merged by observation order.
  (Implemented as: realtime per-process chains; cross-process order only
  via reads — conservative.)
- ``wfr_keys=True``: writes follow reads within a txn — a txn that
  externally reads k=v1 and writes k=v2 fixes v1 < v2, recovering
  version orders with no realtime or session assumptions
  (cycle/wr.clj:28-30).
- default: only wr edges + the direct anomalies (G1a, G1b, internal) —
  what elle can infer with no assumptions.
"""

from __future__ import annotations

from typing import Iterable, Optional

from . import DEFAULT_ANOMALIES, DepGraph, _check_extra, \
    compose_additional_graphs, cycle_anomalies, expand_anomalies, \
    op_f as _f, op_proc as _proc, op_type as _type, op_value as _value, \
    paired_intervals, result_map, suffixed_requests
from .graphs import add_read_edges, add_write_chains
from ..history import FAIL, INFO, OK
from ..txn import ext_reads, ext_writes


def _ret_index(op):
    idx = op.index if hasattr(op, "index") else op.get("index", -1)
    return idx if idx is not None else -1


def check(history, anomalies: Iterable[str] = DEFAULT_ANOMALIES,
          linearizable_keys: bool = False, sequential_keys: bool = False,
          wfr_keys: bool = False, device: Optional[bool] = None,
          additional_graphs: Iterable[str] = (),
          metrics=None, report: Optional[dict] = None,
          mesh=None, torch_device=None) -> dict:
    """Check a read/write-register history.

    ``wfr_keys`` is the reference's :wfr-keys? (cycle/wr.clj:28-30):
    assume writes follow reads within a transaction, so a txn that
    externally reads k=v1 and writes k=v2 fixes v1 < v2 in k's version
    order — ww/rw edges recoverable with no realtime or session
    assumptions at all.

    ``additional_graphs`` composes extra precedence orders into the
    cycle search (cycle/wr.clj:17-19's :additional-graphs): "realtime"
    upgrades the verdict to strict serializability (needs a full paired
    history — bare completion lists set "realtime_unavailable"),
    "process" to strong session serializability. Violations visible
    only with the extra edges report as suffixed anomalies
    ("G-single-realtime", …).

    ``report``, ``mesh`` and ``torch_device`` as in
    :func:`jepsen_tpu_torch.elle.append.check`, and ``metrics`` too."""
    requested = expand_anomalies(anomalies)
    extra = _check_extra(additional_graphs)
    requested = suffixed_requests(requested, extra)
    oks = [op for op in history if _type(op) == OK and _f(op) == "txn"]
    fails = [op for op in history if _type(op) == FAIL and _f(op) == "txn"]
    problems: dict = {}

    # Authorship: (k, v) -> ok txn index (writes unique).
    author: dict = {}
    for i, op in enumerate(oks):
        for f, k, v in _value(op) or []:
            if f == "w":
                if (k, v) in author:
                    problems.setdefault("duplicate-writes", []).append(
                        {"key": k, "value": v})
                author[(k, v)] = i
    fail_writes = {
        (k, v) for op in fails for f, k, v in _value(op) or [] if f == "w"
    }

    # Internal: a txn's reads must agree with its own prior writes/reads.
    for op in oks:
        seen: dict = {}
        for f, k, v in _value(op) or []:
            if f == "w":
                seen[k] = v
            elif f == "r" and v is not None:
                if k in seen and seen[k] != v:
                    problems.setdefault("internal", []).append(
                        {"op": repr(op), "key": k, "expected": seen[k],
                         "read": v})
                seen[k] = v

    # G1a: observing a failed write. G1b: observing a non-final write.
    for op in oks:
        for k, v in ext_reads(_value(op) or []).items():
            if v is None:
                continue
            if (k, v) in fail_writes:
                problems.setdefault("G1a", []).append(
                    {"key": k, "value": v, "reader": repr(op)})
            w = author.get((k, v))
            if w is not None and ext_writes(_value(oks[w]) or []).get(k) != v:
                problems.setdefault("G1b", []).append(
                    {"key": k, "value": v, "reader": repr(op)})

    g = DepGraph(len(oks))
    # wr edges: writer -> reader (external reads only; the shared
    # builder, elle/graphs.py).
    for ri, op in enumerate(oks):
        for k, v in ext_reads(_value(op) or []).items():
            add_read_edges(g, ri, author.get((k, v)))

    intervals = (
        paired_intervals(history)
        if extra or linearizable_keys or sequential_keys else None
    )

    if linearizable_keys or sequential_keys or wfr_keys:
        # Version order per key. Ordering two writes by raw ok-completion
        # order is UNSOUND for concurrent txns (either order is legal), so
        # an edge w1 -> w2 is added only when the order is forced:
        # - same process: program order (the sequential_keys assumption);
        # - linearizable_keys: true realtime precedence — w1's completion
        #   strictly before w2's invocation, when invocation indexes are
        #   recoverable from a full (paired) history;
        # - wfr_keys: a txn's external read of k precedes its own write
        #   of k in the version order (cycle/wr.clj:28-30).
        writes_by_key: dict = {}
        for i, op in enumerate(oks):
            for k, v in ext_writes(_value(op) or []).items():
                writes_by_key.setdefault(k, []).append((i, v))
        for k, ws in writes_by_key.items():
            chains: list[tuple[int, int]] = []
            if linearizable_keys or sequential_keys:
                for a in range(len(ws)):
                    for b in range(a + 1, len(ws)):
                        i1, _v1 = ws[a]
                        i2, _v2 = ws[b]
                        if i1 == i2:
                            continue
                        if _proc(oks[i1]) == _proc(oks[i2]):
                            chains.append((i1, i2))
                        elif (
                            linearizable_keys
                            and intervals is not None
                            and _ret_index(oks[i1])
                            < intervals.get(id(oks[i2]), (-1, -1))[0]
                        ):
                            chains.append((i1, i2))
            if wfr_keys:
                for i2, _v2 in ws:
                    r = ext_reads(_value(oks[i2]) or []).get(k)
                    if r is None:
                        continue
                    i1 = author.get((k, r))
                    if i1 is not None and i1 != i2:
                        chains.append((i1, i2))
            # ww for the forced pairs, then rw edges: reader of
            # version v -> any write FORCED after v's writer
            # (conservative: only chain successors).
            succ = add_write_chains(g, chains)
            for ri, op in enumerate(oks):
                r = ext_reads(_value(op) or []).get(k)
                if r is None:
                    continue
                w = author.get((k, r))
                if w is None:
                    continue
                add_read_edges(g, ri, None, succ.get(w, ()))

    n_txns = len(oks)
    rt_unavailable = False
    if extra:
        rt_unavailable = compose_additional_graphs(
            g, extra, history,
            [(i, op, True) for i, op in enumerate(oks)], intervals)

    problems.update(cycle_anomalies(g, device=device, extra=extra, metrics=metrics,
                                    n_txns=n_txns, report=report,
                                    mesh=mesh, torch_device=torch_device))
    res = result_map(
        problems, requested | {"duplicate-writes"}, lambda i: repr(oks[i])
    )
    res["txn_count"] = n_txns
    if report is not None:
        res["engine"] = dict(report)
    if rt_unavailable:
        res["realtime_unavailable"] = True
    return res
