"""Transactional-anomaly checker (Elle's cycle taxonomy).

The port of the reference's ``jepsen_tpu/elle/__init__.py``: the
interpretation layers (:mod:`.append` for list-append histories,
:mod:`.wr` for read/write registers) build a typed dependency graph, and
:func:`cycle_anomalies` classifies its cycles. Graphs of at least
:data:`DEVICE_MIN_TXNS` nodes (or any graph, with ``device=True``) get
every closure the taxonomy needs from the batched device engine
(:mod:`.engine`, CUDA kernels in ``csrc/elle_closure.cu``); the rest run
the host Tarjan/BFS path, which also extracts every witness.

Anomaly taxonomy:

- G0        cycle of ww edges only
- G1a       aborted read (observed a failed txn's write)
- G1b       intermediate read (observed a non-final write)
- G1c       cycle of ww+wr edges (with at least one wr)
- G-single  cycle with exactly one rw (anti-dependency) edge
- G2        cycle with two or more rw edges ("G2-item")
- internal  txn inconsistent with its own reads/writes
- incompatible-order  reads of one key disagree on version order

``G2 implies G-single and G1c; G1 implies G1a, G1b, G1c; G1c implies G0``.

The entry points take the torch device as ``torch_device`` (the GPU by
default; ``"cpu"`` runs the plain PyTorch versions), since ``device`` is
the engine flag: None = auto, True = force the engine, False = host only
(``JEPSEN_ELLE_DEVICE`` overrides all three).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from . import ops as _ops
from . import engine as _engine
from ..history import History
from .graph import (
    DepGraph,
    PROC,
    RT,
    RW,
    WR,
    WW,
    SccReach,
    find_cycle_lists,
    find_cycle_with_edge_lists,
    sccs_lists,
    succ_lists,
)

# Umbrella expansion (cycle/wr.clj:44-45).
_EXPANSION = {
    "G1": {"G1a", "G1b", "G1c", "G0"},  # G1c implies G0
    "G1c": {"G0", "G1c"},
    "G2": {"G2", "G-single", "G1c", "G0"},
    "G-single": {"G-single", "G1c", "G0"},
}

DEFAULT_ANOMALIES = ("G1", "G2", "internal")

# The cycle-class anomalies that acquire "-realtime"/"-process" suffixed
# variants when additional graphs are composed (append.clj:49-50).
CYCLE_CLASSES = frozenset({"G0", "G1c", "G-single", "G2"})

# Dependency-only edges; additional-graph bits are excluded from the
# pure (plain-serializability) passes.
DEP_MASK = WW | WR | RW

EXTRA_BITS = {"realtime": RT, "process": PROC}

# Device closures pay off once the matmul amortizes dispatch; below this
# SCC size the host BFS wins.
DEVICE_MIN_TXNS = 512


def expand_anomalies(anomalies: Iterable[str]) -> set:
    out: set = set()
    for a in anomalies:
        out |= _EXPANSION.get(a, {a})
    return out


def _live_passes(g: DepGraph, extra: Iterable[str]) -> list:
    """(bit, name) taxonomy passes this graph actually needs: the pure
    pass plus each requested extra graph with edges present."""
    passes = [(0, "")]
    for name in extra:
        bit = EXTRA_BITS[name]
        if any(k & bit for k in g.edges.values()):
            passes.append((bit, name))
    return passes


def _pass_masks(passes: Sequence[tuple]) -> list:
    """The closure masks the engine must materialize for ``passes``
    (WW / WW|WR / full per pass, de-duplicated in order)."""
    masks: list = []
    for bit, _name in passes:
        for m in (WW | bit, WW | WR | bit, DEP_MASK | bit):
            if m not in masks:
                masks.append(m)
    return masks


def cycle_anomalies(g: DepGraph, device: Optional[bool] = None,
                    extra: Iterable[str] = (),
                    n_txns: Optional[int] = None,
                    metrics=None, report: Optional[dict] = None,
                    mesh=None, min_bucket: Optional[int] = None,
                    torch_device=None) -> dict:
    """Classify cycles in a typed dependency graph. Returns
    {anomaly-type: [witness]} where a witness is {"cycle": [txn indices],
    "kinds": [edge kinds along it]}.

    Batched-engine design (:mod:`.engine`): when the device is engaged,
    ALL taxonomy masks of ALL passes land in one bit-packed batched
    closure through the shared power-of-two bucket table; SCC membership and every reachability predicate are then
    host-side bit tests, and host graph walks run only to extract
    witnesses. ``device``: None = auto (engine for graphs ≥
    DEVICE_MIN_TXNS), True = force the engine, False = host
    Tarjan/BFS only (``JEPSEN_ELLE_DEVICE`` overrides all three). The
    host path is the SCC-condensed flow — Tarjan per mask, BFS or
    per-component device closures (SccReach) inside big components —
    and remains the differential oracle plus the typed-cause fallback
    target: engine degradations (bucket ceiling, and on CPU tensors an
    out-of-memory past the escalation budget) fold one-sidedly to the
    host verdict; on the GPU that out-of-memory raises.

    ``report`` observes the engine (``engine``, ``chunks``, fallback
    ``causes``); ``min_bucket`` pins a floor bucket (bucket-padding
    equality tests). ``mesh`` (a :class:`jepsen_tpu_torch.parallel.Mesh`)
    sends every closure to the block-row sharded closure on the mesh's
    device, with no bucket ceiling. ``metrics`` (a
    :class:`jepsen_tpu_torch.telemetry.Registry`) records the engine's
    ``elle_batch_chunk`` events and counters (:mod:`.engine`).
    ``torch_device``: see the module docstring.

    ``extra`` composes additional precedence graphs already present as
    RT/PROC edges in ``g`` (append.clj:49-50): for each name in
    ("realtime", "process"), a second pass searches cycles over
    dependency∪extra edges and reports them as the suffixed anomaly
    ("G-single-realtime", …) — strict-serializability violations that
    plain serializability cannot see. A suffixed pass for a class runs
    only when the pure class was not found, which guarantees every
    suffixed witness genuinely uses an extra edge. ``n_txns`` marks the
    boundary between txn nodes and the realtime timeline's aux chain
    nodes; witnesses splice aux nodes back out."""
    n = g.n
    if n == 0 or not g.edges:
        return {}
    use_device, forced = _ops.resolve_device(device)
    nt = n_txns if n_txns is not None else n
    out: dict = {}
    passes = _live_passes(g, extra)
    views = None
    if use_device and (forced or n >= DEVICE_MIN_TXNS):
        views = _engine.graph_closures(
            g, _pass_masks(passes), metrics=metrics, report=report, mesh=mesh,
            min_bucket=min_bucket, torch_device=torch_device)
    if report is not None:
        report["engine"] = "device" if views is not None else "host"
    if views is not None:
        for bit, name in passes:
            _taxonomy_pass_closures(g, out, bit, name, nt, views)
    else:
        for bit, name in passes:
            _taxonomy_pass(g, out, bit, name, use_device, nt, torch_device)
    return out


def cycle_anomalies_batch(graphs: Sequence[DepGraph],
                          device: Optional[bool] = None,
                          extra: Iterable[str] = (),
                          metrics=None,
                          report: Optional[dict] = None,
                          min_bucket: Optional[int] = None,
                          torch_device=None) -> list:
    """Decide MANY dependency graphs in as few device dispatches as
    possible: every (graph, mask) closure of every engaged graph joins
    one co-batched engine plan (≤ one batched closure per populated
    size bucket), then
    anomalies classify per graph from the packed closures. Graphs the
    engine declines (kill-switch, too small in auto mode, bucket
    ceiling, a CPU-tensor out-of-memory past the escalation budget) fold
    to the host path one-sidedly — the returned anomaly dicts are identical
    to per-graph :func:`cycle_anomalies` either way."""
    use_device, forced = _ops.resolve_device(device)
    results: list = [None] * len(graphs)
    jobs = []
    jmeta = []  # (graph index, passes)
    for i, g in enumerate(graphs):
        if g.n == 0 or not g.edges:
            results[i] = {}
            continue
        if use_device and (forced or g.n >= DEVICE_MIN_TXNS):
            passes = _live_passes(g, extra)
            jobs.append((g, _pass_masks(passes)))
            jmeta.append((i, passes))
    if jobs:
        views_list = _engine.batch_closures(
            jobs, metrics=metrics, report=report, min_bucket=min_bucket,
            torch_device=torch_device)
        for (i, passes), views in zip(jmeta, views_list):
            if views is None:
                continue
            out: dict = {}
            for bit, name in passes:
                _taxonomy_pass_closures(graphs[i], out, bit, name,
                                        graphs[i].n, views)
            results[i] = out
    for i, g in enumerate(graphs):
        if results[i] is None:
            out = {}
            for bit, name in _live_passes(g, extra):
                _taxonomy_pass(g, out, bit, name, use_device, g.n,
                               torch_device)
            results[i] = out
    return results


def _taxonomy_pass(g: DepGraph, out: dict, bit: int, name: str,
                   use_device: bool, nt: int, torch_device=None) -> None:
    """One taxonomy pass over dependency∪``bit`` edges. ``bit=0`` /
    ``name=""`` is the pure (plain-serializability) pass; otherwise
    anomalies report suffixed ("<class>-<name>") and each class runs
    only when its pure counterpart is absent — then any qualifying
    cycle necessarily uses a ``bit`` edge (a bit-free cycle would have
    satisfied the pure pass), so the suffix is honest.

    G0 is the one structural divergence between the passes: pure G0 is
    any WW SCC; a suffixed G0 must pivot on a ``bit`` edge inside a
    WW|bit SCC, since the SCC-exists criterion alone cannot show the
    cycle uses an extra edge."""
    sfx = f"-{name}" if name else ""
    n, edges = g.n, g.edges

    succ_ww = succ_lists(edges, n, WW | bit)
    if not name:
        ww_sccs = sccs_lists(succ_ww)
        if ww_sccs:
            cyc = find_cycle_lists(succ_ww, ww_sccs[0])
            if cyc:
                out.setdefault("G0", []).append(_witness(g, cyc, nt))
    elif "G0" not in out:
        comp = _comp_index(sccs_lists(succ_ww))
        for (a, b), k in sorted(edges.items()):
            if k & bit and comp.get(a) is not None \
                    and comp.get(a) == comp.get(b):
                cyc = find_cycle_with_edge_lists(succ_ww, a, b)
                if cyc:
                    out.setdefault(f"G0{sfx}", []).append(
                        _witness(g, cyc, nt))
                    break

    # G1c: a wr edge (a,b) on a ww|wr(|bit) cycle <=> a,b in one SCC of
    # that mask (the edge itself closes the loop).
    succ_wwr = succ_lists(edges, n, WW | WR | bit)
    if not name or "G1c" not in out:
        comp = _comp_index(sccs_lists(succ_wwr))
        for (a, b), k in sorted(edges.items()):
            if k & WR and comp.get(a) is not None \
                    and comp.get(a) == comp.get(b):
                cyc = find_cycle_with_edge_lists(succ_wwr, a, b)
                if cyc:
                    out.setdefault(f"G1c{sfx}", []).append(
                        _witness(g, cyc, nt))
                    break

    # rw-closing cycles. An rw edge (a,b) is:
    # - G-single when b reaches a via ww|wr(|bit) edges (that path + the
    #   rw edge is a cycle, so it lies inside ONE full-graph SCC — the
    #   query runs within the component);
    # - G2 when b reaches a only with further rw edges (same full-SCC
    #   membership, not wwr-reachable).
    want_single = not name or "G-single" not in out
    want_g2 = not name or "G2" not in out
    if not (want_single or want_g2):
        return
    succ_full = succ_lists(edges, n, DEP_MASK | bit)
    reach = SccReach(succ_wwr, sccs_lists(succ_full), use_device,
                     device_min=DEVICE_MIN_TXNS, torch_device=torch_device)
    # Every rw edge's reachability source is known up front: batch the
    # device closure rows into one transfer instead of one device read
    # per query (SccReach.prefetch).
    reach.prefetch([
        (comp_id, b)
        for (a, b), kind in edges.items()  # order irrelevant here
        if kind & RW
        for same, comp_id in [reach.same_comp(a, b)] if same
    ])
    g_single = None
    g2 = None
    for (a, b), kind in sorted(edges.items()):
        if not kind & RW:
            continue
        same, comp_id = reach.same_comp(a, b)
        if not same:
            continue
        wwr_back = reach.query(comp_id, b, a)
        if want_single and g_single is None and wwr_back:
            cyc = find_cycle_with_edge_lists(succ_wwr, a, b)
            if cyc:
                g_single = _witness(g, cyc, nt)
        if want_g2 and g2 is None and not wwr_back:
            cyc = find_cycle_with_edge_lists(succ_full, a, b)
            if cyc:
                g2 = _witness(g, cyc, nt)
        if (g_single is not None or not want_single) \
                and (g2 is not None or not want_g2):
            break
    if g_single is not None:
        out.setdefault(f"G-single{sfx}", []).append(g_single)
    if g2 is not None:
        out.setdefault(f"G2{sfx}", []).append(g2)


def _taxonomy_pass_closures(g: DepGraph, out: dict, bit: int, name: str,
                            nt: int, views: dict) -> None:
    """:func:`_taxonomy_pass` with every SCC/reachability predicate
    answered by the engine's bit-packed closures instead of host
    Tarjan/BFS — same pass gating, same sorted-edge scan order, same
    break conditions, and witness extraction via the SAME host cycle
    walks, so the two paths return identical anomaly sets with
    identical witnesses.

    The predicate equivalences (each edge (a, b) has a != b — DepGraph
    drops self-loops): nontrivial same-SCC membership under a mask ⟺
    mutual closure reach; the host's component-restricted wwr
    back-query ⟺ the global wwr closure bit, because under the
    same-full-SCC precondition any global wwr path b→…→a closes a full
    cycle through the rw edge and so stays inside the component."""
    sfx = f"-{name}" if name else ""
    n, edges = g.n, g.edges
    cw = views[WW | bit]
    cwwr = views[WW | WR | bit]
    cfull = views[DEP_MASK | bit]
    succ_cache: dict = {}

    def succ(mask):  # witness-extraction walks only — lazy
        if mask not in succ_cache:
            succ_cache[mask] = succ_lists(edges, n, mask)
        return succ_cache[mask]

    if not name:
        if cw.diag_any():
            # Witness identity with the host path: first sorted WW SCC,
            # same cycle walk (Tarjan here runs only on witness
            # extraction, never to decide).
            succ_ww = succ(WW | bit)
            ww_sccs = sccs_lists(succ_ww)
            cyc = find_cycle_lists(succ_ww, ww_sccs[0])
            if cyc:
                out.setdefault("G0", []).append(_witness(g, cyc, nt))
    elif "G0" not in out:
        for (a, b), k in sorted(edges.items()):
            if k & bit and cw.same_scc(a, b):
                cyc = find_cycle_with_edge_lists(succ(WW | bit), a, b)
                if cyc:
                    out.setdefault(f"G0{sfx}", []).append(
                        _witness(g, cyc, nt))
                    break

    if not name or "G1c" not in out:
        for (a, b), k in sorted(edges.items()):
            if k & WR and cwwr.same_scc(a, b):
                cyc = find_cycle_with_edge_lists(
                    succ(WW | WR | bit), a, b)
                if cyc:
                    out.setdefault(f"G1c{sfx}", []).append(
                        _witness(g, cyc, nt))
                    break

    want_single = not name or "G-single" not in out
    want_g2 = not name or "G2" not in out
    if not (want_single or want_g2):
        return
    g_single = None
    g2 = None
    for (a, b), kind in sorted(edges.items()):
        if not kind & RW:
            continue
        if not cfull.same_scc(a, b):
            continue
        wwr_back = cwwr.reach(b, a)
        if want_single and g_single is None and wwr_back:
            cyc = find_cycle_with_edge_lists(succ(WW | WR | bit), a, b)
            if cyc:
                g_single = _witness(g, cyc, nt)
        if want_g2 and g2 is None and not wwr_back:
            cyc = find_cycle_with_edge_lists(succ(DEP_MASK | bit), a, b)
            if cyc:
                g2 = _witness(g, cyc, nt)
        if (g_single is not None or not want_single) \
                and (g2 is not None or not want_g2):
            break
    if g_single is not None:
        out.setdefault(f"G-single{sfx}", []).append(g_single)
    if g2 is not None:
        out.setdefault(f"G2{sfx}", []).append(g2)


def _comp_index(sccs: list[list[int]]) -> dict:
    comp: dict = {}
    for ci, c in enumerate(sccs):
        for v in c:
            comp[v] = ci
    return comp


def _check_extra(additional_graphs) -> tuple:
    """Validate an additional-graphs option up front — a typo'd name (or
    a bare string, which iterates as characters) must fail loudly at the
    check() front door, not as a KeyError deep in the cycle search."""
    extra = tuple(additional_graphs)
    for name in extra:
        if name not in EXTRA_BITS:
            raise ValueError(
                f"unknown additional graph {name!r}; expected a list of "
                f"{sorted(EXTRA_BITS)}")
    return extra


def _order_fn(history, intervals: Optional[dict]):
    """Per-process program-order key for process-graph edges: paired
    invoke indexes when available, else the op's position in the
    original history (one process's ops complete sequentially, so
    history position preserves its program order — node ids do NOT,
    since info nodes are renumbered after all ok nodes)."""
    if intervals is not None:
        def order_of(op, node):
            iv = intervals.get(id(op))
            return iv[0] if iv is not None else node
    else:
        pos = {id(op): i for i, op in enumerate(history)}

        def order_of(op, node):
            return pos.get(id(op), node)
    return order_of


def suffixed_requests(requested: set, extra) -> set:
    """Requested anomalies plus the suffixed variants each additional
    graph unlocks (G2 + realtime -> G2-realtime, ...)."""
    out = set(requested)
    for name in extra:
        out |= {f"{a}-{name}" for a in requested & CYCLE_CLASSES}
    return out


def compose_additional_graphs(g: DepGraph, extra, history, nodes,
                              intervals: Optional[dict]) -> bool:
    """Add the requested extra precedence edges to ``g``. ``nodes``:
    (node_id, completion_op, has_ret) per committed txn — has_ret False
    for :info txns, which may take effect arbitrarily late and so
    realtime-precede nothing. Returns True when realtime was requested
    but the history is a bare completion list (no invocation indexes)."""
    order_of = _order_fn(history, intervals)
    rt_unavailable = False
    if "process" in extra:
        add_process_edges(g, [
            (node, op_proc(op), order_of(op, node))
            for node, op, _has_ret in nodes
        ])
    if "realtime" in extra:
        if intervals is None:
            rt_unavailable = True
        else:
            add_realtime_edges(g, [
                (node, intervals[id(op)][0],
                 intervals[id(op)][1] if has_ret else None)
                for node, op, has_ret in nodes
                if id(op) in intervals
            ])
    return rt_unavailable


def paired_intervals(history) -> Optional[dict]:
    """Map id(completion) -> (invoke_index, completion_index) from a
    paired History; None for bare completion lists (realtime edges are
    then underivable — the reference's realtime-graph likewise needs
    full histories)."""
    try:
        if not isinstance(history, History):
            return None
        return {
            id(iv.completion): (iv.invoke.index, iv.completion.index)
            for iv in history.pairs()
            if iv.completion is not None
        }
    except Exception:
        return None


def add_realtime_edges(g: DepGraph, intervals) -> None:
    """Compose realtime precedence into ``g`` as RT edges.

    ``intervals``: (node, invoke_index, ret_index|None) per committed
    txn. ret None = indeterminate (:info): such a txn may take effect
    arbitrarily late, so it realtime-precedes nothing (but can still be
    preceded via its invocation).

    Timeline-chain construction, O(n) edges where the naive precedence
    relation is O(n²): walking events in index order, consecutive
    completions coalesce into one aux chain node c (txn→c), chain nodes
    link forward (c→c'), and each invocation hangs off the latest chain
    node (c→txn). A txn path a→…→b exists iff ret(a) < inv(b) — exactly
    the realtime order. Aux nodes live past the txn range; witnesses
    splice them out."""
    events = []
    for node, inv, ret in intervals:
        events.append((inv, 0, node))
        if ret is not None:
            events.append((ret, 1, node))
    events.sort()
    chain = None
    chain_open = False
    for _idx, is_ret, node in events:
        if is_ret:
            if not chain_open:
                new = g.n
                g.n += 1
                if chain is not None:
                    g.add(chain, new, RT)
                chain, chain_open = new, True
            g.add(node, chain, RT)
        else:
            if chain is not None:
                g.add(chain, node, RT)
            chain_open = False


def add_process_edges(g: DepGraph, items) -> None:
    """Compose per-process program order into ``g`` as PROC edges.
    ``items``: (node, process, order_index) per committed txn; each
    process's txns chain in order_index order."""
    by_proc: dict = {}
    for node, proc, idx in items:
        by_proc.setdefault(proc, []).append((idx, node))
    for seq in by_proc.values():
        seq.sort()
        for (_, a), (_, b) in zip(seq, seq[1:]):
            g.add(a, b, PROC)


KIND_LOOKUP = {WW: "ww", WR: "wr", RW: "rw", RT: "realtime",
               PROC: "process"}


def monotonic_key_check(history, realtime: bool = True) -> dict:
    """elle.core's monotonic-key analyzer composed with the realtime
    graph (Jepsen consumes it via jepsen.tests.cycle/checker +
    cycle/combine, e.g. tidb/monotonic.clj:104-110).

    Ok ops carry ``{key: observed-value}`` maps; for each key, an op
    observing value v precedes every op observing the next larger value
    — values must never decrease. A cycle in that order (composed with
    realtime precedence when the history is paired) is a monotonicity
    violation; the witness cycle is returned."""
    oks = [op for op in history
           if op_type(op) == "ok" and isinstance(op_value(op), dict)]
    n = len(oks)
    g = DepGraph(n)
    by_key: dict = {}
    for i, op in enumerate(oks):
        for k, v in (op_value(op) or {}).items():
            if v is not None:
                by_key.setdefault(k, {}).setdefault(v, []).append(i)
    for groups in by_key.values():
        vals = sorted(groups)
        for a, b in zip(vals, vals[1:]):
            for i in groups[a]:
                for j in groups[b]:
                    if i != j:
                        g.add(i, j, WW)
    rt_unavailable = False
    if realtime:
        intervals = paired_intervals(history)
        if intervals is None:
            rt_unavailable = True
        else:
            add_realtime_edges(g, [
                (i, intervals[id(op)][0], intervals[id(op)][1])
                for i, op in enumerate(oks) if id(op) in intervals
            ])
    succ = succ_lists(g.edges, g.n, 0xFF)
    sccs = sccs_lists(succ)
    cycles = []
    if sccs:
        cyc = find_cycle_lists(succ, sccs[0])
        if cyc:
            w = _witness(g, cyc, n)
            w["ops"] = [repr(oks[i]) for i in w["cycle"]]
            cycles.append(w)
    out = {"valid": not sccs, "cycles": cycles}
    if rt_unavailable:
        out["realtime_unavailable"] = True
    return out


# Shared op accessors: checker layers accept both Op records and plain
# completion dicts.
def op_value(op):
    return op.value if hasattr(op, "value") else op.get("value")


def op_type(op):
    return op.type if hasattr(op, "type") else op.get("type")


def op_f(op):
    return op.f if hasattr(op, "f") else op.get("f")


def op_proc(op):
    return op.process if hasattr(op, "process") else op.get("process")


def _witness(g: DepGraph, cycle: list[int],
             n_txns: Optional[int] = None) -> dict:
    if cycle[0] != cycle[-1]:
        cycle = cycle + [cycle[0]]
    limit = n_txns if n_txns is not None else g.n
    if any(v >= limit for v in cycle):
        # Splice the realtime timeline's aux chain nodes out: a run of
        # chain hops between two txns collapses to one "realtime" step.
        # Cycle searches start from a dependency-edge endpoint, so
        # cycle[0] is always a txn.
        out_nodes = [cycle[0]]
        kinds: list[list[str]] = []
        prev = cycle[0]
        through_aux = False
        for v in cycle[1:]:
            if v >= limit:
                through_aux = True
                continue
            if through_aux:
                kinds.append(["realtime"])
            else:
                k = g.edges.get((prev, v), 0)
                kinds.append([KIND_LOOKUP[b] for b in KIND_LOOKUP if k & b])
            out_nodes.append(v)
            prev = v
            through_aux = False
        return {"cycle": out_nodes, "kinds": kinds}
    kinds = []
    for i in range(len(cycle) - 1):
        k = g.edges.get((cycle[i], cycle[i + 1]), 0)
        kinds.append([KIND_LOOKUP[b] for b in KIND_LOOKUP if k & b])
    return {"cycle": cycle, "kinds": kinds}


def result_map(anomalies: dict, requested: set, txn_of=None) -> dict:
    """Shape the final checker result (elle-style): valid iff no requested
    anomaly was found."""
    found = {k: v for k, v in anomalies.items() if k in requested and v}
    if txn_of is not None:
        for ws in found.values():
            for w in ws:
                if "cycle" in w:
                    w["txns"] = [txn_of(i) for i in w["cycle"]]
    return {
        "valid": not found,
        "anomaly_types": sorted(found),
        "anomalies": found,
    }
