"""List-append txn interpretation (elle.list-append equivalent).

The port of the reference's ``jepsen_tpu/elle/append.py``.

Histories of transactions over named lists, micro-ops ``["append", k, v]``
and ``["r", k, observed-list]`` (op shape documented at
jepsen/src/jepsen/tests/cycle/append.clj:29-40). Append values are unique
per key, so observed lists *recover the version order*: the longest read
of a key is its version order prefix; every other read must be a prefix of
it (else ``incompatible-order``).

Dependency edges over committed txns (ok, plus info txns whose appends
were observed — their writes are visible, so they committed):

- ww: writer of version i → writer of version i+1 (adjacent appends)
- wr: writer of the last element of an observed list → the reader
- rw: reader → writer of the next version after what it observed
       (including reads of the empty list → writer of version 0)

Appends never observed in any read have unknown positions and contribute
no edges — sound (never invents a cycle), though a real elle can
sometimes order them via additional inference.

Direct (non-cycle) anomalies: G1a aborted read, G1b intermediate read,
``internal`` (txn disagrees with its own prior ops), dirty-update is
subsumed by G1a here.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

from . import DEFAULT_ANOMALIES, DepGraph, _check_extra, \
    compose_additional_graphs, cycle_anomalies, expand_anomalies, \
    op_f as _f, op_type as _type, op_value as _value, paired_intervals, \
    result_map, suffixed_requests
from .graphs import add_read_edges, add_version_chain
from ..history import FAIL, INFO, OK


def _mops(op):
    return _value(op) or []


def check(history, anomalies: Iterable[str] = DEFAULT_ANOMALIES,
          device: Optional[bool] = None,
          additional_graphs: Iterable[str] = (),
          metrics=None, report: Optional[dict] = None,
          mesh=None, torch_device=None) -> dict:
    """Check a list-append history. Mirrors elle.list-append/check's
    result shape: {"valid", "anomaly_types", "anomalies"}.

    ``additional_graphs`` composes extra precedence orders into the
    cycle search (append.clj:49-50's :additional-graphs): "realtime"
    upgrades the verdict to strict serializability (needs a full paired
    history — bare completion lists set "realtime_unavailable"),
    "process" to strong session serializability. Violations visible
    only with the extra edges report as suffixed anomalies
    ("G-single-realtime", …).

    ``report`` observes the batched device cycle engine (:mod:`.engine`):
    the engine/chunks/causes summary, also attached to the result as
    ``"engine"``. ``torch_device`` is the engine's torch device (the GPU
    by default; ``"cpu"`` runs the plain versions). ``mesh`` (a
    :class:`jepsen_tpu_torch.parallel.Mesh`) sends every closure to the
    block-row sharded closure on the mesh's device, with no bucket
    ceiling. ``metrics`` (a :class:`jepsen_tpu_torch.telemetry.Registry`)
    records the engine's ``elle_batch_chunk`` events and counters."""
    requested = expand_anomalies(anomalies)
    extra = _check_extra(additional_graphs)
    requested = suffixed_requests(requested, extra)
    # Pair completions with their invocations' txn shape: we only need
    # completions (observed values live there).
    oks = [op for op in history if _type(op) == OK and _f(op) == "txn"]
    infos = [op for op in history if _type(op) == INFO and _f(op) == "txn"]
    fails = [op for op in history if _type(op) == FAIL and _f(op) == "txn"]

    problems: dict = {}

    # --- authorship: (k, v) -> (txn kind, txn index in its list) ---------
    ok_author: dict = {}
    info_author: dict = {}
    fail_author: dict = {}
    for i, op in enumerate(oks):
        for f, k, v in _mops(op):
            if f == "append":
                if (k, v) in ok_author:
                    problems.setdefault("duplicate-appends", []).append(
                        {"key": k, "value": v})
                ok_author[(k, v)] = i
    for i, op in enumerate(infos):
        for f, k, v in _mops(op):
            if f == "append":
                info_author[(k, v)] = i
    for i, op in enumerate(fails):
        for f, k, v in _mops(op):
            if f == "append":
                fail_author[(k, v)] = i

    # --- internal consistency (within one txn) ---------------------------
    for op in oks:
        err = _internal_case(_mops(op))
        if err is not None:
            problems.setdefault("internal", []).append(
                {"op": repr(op), **err})

    # --- version orders from reads ---------------------------------------
    longest: dict = {}  # k -> longest observed list
    for op in oks:
        for f, k, v in _mops(op):
            if f == "r" and v is not None:
                if len(v or []) > len(longest.get(k, [])):
                    longest[k] = list(v)
    for op in oks:
        for f, k, v in _mops(op):
            if f == "r" and v is not None:
                lv = longest.get(k, [])
                if list(v) != lv[: len(v)]:
                    problems.setdefault("incompatible-order", []).append(
                        {"key": k, "read": list(v), "longest": lv})

    # --- G1a / G1b --------------------------------------------------------
    for ri, op in enumerate(oks):
        for f, k, v in _mops(op):
            if f != "r" or not v:
                continue
            for x in v:
                if (k, x) in fail_author:
                    problems.setdefault("G1a", []).append(
                        {"key": k, "value": x, "reader": repr(op)})
                elif (
                    (k, x) not in ok_author and (k, x) not in info_author
                ):
                    # Observed a value no txn (committed, indeterminate,
                    # or failed) ever appended: corruption.
                    problems.setdefault("unknown-value", []).append(
                        {"key": k, "value": x, "reader": repr(op)})
            # Intermediate read: the read ends inside ANOTHER txn's
            # multi-append batch for k (a txn reading its own
            # intermediate state is legal).
            last = v[-1]
            writer = ok_author.get((k, last))
            if writer is not None and writer != ri:
                wmops = [m for m in _mops(oks[writer])
                         if m[0] == "append" and m[1] == k]
                vals = [m[2] for m in wmops]
                if last in vals and vals.index(last) < len(vals) - 1:
                    problems.setdefault("G1b", []).append(
                        {"key": k, "value": last, "reader": repr(op)})

    # --- dependency graph -------------------------------------------------
    # Committed txns: all oks + infos with an observed append.
    observed_info = sorted({
        i for (k, v), i in info_author.items() if v in longest.get(k, [])
    })
    node_of_ok = {i: i for i in range(len(oks))}
    node_of_info = {i: len(oks) + j for j, i in enumerate(observed_info)}
    n = len(oks) + len(observed_info)
    g = DepGraph(n)

    def author_node(k, v):
        if (k, v) in ok_author:
            return node_of_ok[ok_author[(k, v)]]
        i = info_author.get((k, v))
        if i is not None:
            return node_of_info.get(i)
        return None

    # Appends absent from the longest read of k lie strictly AFTER it
    # (reads are prefixes of the true order), so they sit after every
    # observed version and after every read — orderable against the
    # observed world even though they're mutually unordered.
    keys = set(longest) | {k for (k, _v) in ok_author}
    unobserved: dict = {}
    for (k, v), i in ok_author.items():
        if v not in longest.get(k, []):
            unobserved.setdefault(k, []).append(node_of_ok[i])
    for k in keys:
        # ww: adjacent observed versions, then last observed -> each
        # unobserved appender (the shared builder, elle/graphs.py).
        add_version_chain(
            g, [author_node(k, v) for v in longest.get(k, [])],
            unobserved.get(k, []))
    for ri, op in enumerate(oks):
        for f, k, v in _mops(op):
            if f != "r" or v is None:
                continue
            order = longest.get(k, [])
            nxt_pos = len(v)
            if nxt_pos < len(order):
                nxt = [author_node(k, order[nxt_pos])]
            else:
                # Read saw the whole observed order; every unobserved
                # appender wrote a later version it missed.
                nxt = unobserved.get(k, [])
            add_read_edges(g, ri,
                           author_node(k, v[-1]) if v else None, nxt)

    rt_unavailable = False
    if extra:
        nodes = [(node_of_ok[i], oks[i], True) for i in range(len(oks))] \
            + [(node_of_info[i], infos[i], False) for i in observed_info]
        rt_unavailable = compose_additional_graphs(
            g, extra, history, nodes, paired_intervals(history))

    problems.update(cycle_anomalies(g, device=device, extra=extra, metrics=metrics,
                                    n_txns=n, report=report,
                                    mesh=mesh, torch_device=torch_device))

    def txn_of(i):
        if i < len(oks):
            return repr(oks[i])
        return repr(infos[observed_info[i - len(oks)]])

    res = result_map(problems, requested | {
        "duplicate-appends", "incompatible-order", "unknown-value"}, txn_of)
    res["txn_count"] = n
    if report is not None:
        res["engine"] = dict(report)
    if rt_unavailable:
        res["realtime_unavailable"] = True
    return res


def _internal_case(mops) -> Optional[dict]:
    """Within-txn consistency: reads must reflect the txn's own earlier
    appends and be extensions of its earlier reads of the same key."""
    seen_reads: dict = {}
    appended: dict = {}
    for f, k, v in mops:
        if f == "append":
            appended.setdefault(k, []).append(v)
        elif f == "r" and v is not None:
            v = list(v)
            if k in seen_reads:
                # A later read must EQUAL the previous read plus the
                # txn's own appends since — nothing else may appear
                # mid-transaction.
                prev, n_apps_then = seen_reads[k]
                expect = prev + appended.get(k, [])[n_apps_then:]
                if v != expect:
                    return {"key": k, "expected": expect, "read": v}
            elif appended.get(k):
                # First read of k after own appends: must end with them
                # (the prefix is external state).
                suffix = appended[k]
                if v[-len(suffix):] != suffix:
                    return {"key": k, "expected_suffix": list(suffix),
                            "read": v}
            seen_reads[k] = (v, len(appended.get(k, [])))
    return None
