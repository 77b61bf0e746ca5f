"""Dependency-graph cycle machinery of the transactional checker.

The port of the reference's ``jepsen_tpu/elle/graph.py``: the typed
:class:`DepGraph` (edge kinds are bitmasks), the host Tarjan and the
witness-cycle walks (the oracle and the small-graph path), and the
device consumers: :class:`SccReach`, which closes one big component of
the full graph on the device through ``ops.closure_rows_packed``, and
:func:`closures_device`. The closures run on the CUDA kernels of
``csrc/elle_closure.cu`` (``torch_device`` picks the torch device, the
GPU by default).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from . import ops as _ops

WW = 1  # write -> write (version order)
WR = 2  # write -> read  (reader observed writer)
RW = 4  # read -> write  (anti-dependency: reader missed the next version)

# Additional precedence graphs (append.clj:49-50's :additional-graphs):
# composing these with the dependency edges upgrades the verdict from
# serializability to strict serializability (realtime) / strong session
# serializability (process).
RT = 8     # realtime: a's completion strictly before b's invocation
PROC = 16  # process: consecutive txns of one process, program order

KIND_NAMES = {WW: "ww", WR: "wr", RW: "rw", RT: "realtime", PROC: "process"}


class DepGraph:
    """Typed dependency graph over txn indices 0..n-1."""

    def __init__(self, n: int):
        self.n = n
        self.edges: dict[tuple[int, int], int] = {}

    def add(self, src: int, dst: int, kind: int) -> None:
        if src == dst:
            return  # self-deps are internal, not cycles
        self.edges[(src, dst)] = self.edges.get((src, dst), 0) | kind

    def adjacency(self) -> np.ndarray:
        a = np.zeros((self.n, self.n), dtype=np.uint8)
        for (s, d), kind in self.edges.items():
            a[s, d] = kind
        return a

    def edge_list(self):
        return [(s, d, k) for (s, d), k in sorted(self.edges.items())]


# ---------------------------------------------------------------------------
# Host oracle: Tarjan SCC + witness cycles


def succ_lists(edges: dict, n: int, mask: int) -> list[list[int]]:
    """Adjacency lists of the masked subgraph straight from the edge
    dict — O(V+E), no dense n x n materialization (the memory wall on
    long histories)."""
    succ: list[list[int]] = [[] for _ in range(n)]
    for (s, d), kind in edges.items():
        if kind & mask:
            succ[s].append(d)
    return succ


def sccs_lists(succ: list[list[int]]) -> list[list[int]]:
    """Nontrivial strongly connected components over adjacency lists —
    iterative Tarjan, O(V+E)."""
    return _tarjan(succ)


def sccs_host(adj: np.ndarray, mask: int = 0xFF) -> list[list[int]]:
    """Strongly connected components (size > 1, or self-loop) of the
    subgraph with edge kinds in ``mask``. Iterative Tarjan."""
    n = adj.shape[0]
    succ = [np.flatnonzero(adj[i] & mask).tolist() for i in range(n)]
    return _tarjan(succ)


def _tarjan(succ: list[list[int]]) -> list[list[int]]:
    n = len(succ)
    index = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: list[int] = []
    out: list[list[int]] = []
    counter = [0]
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            for j in range(pi, len(succ[v])):
                w = succ[v][j]
                if index[w] == -1:
                    work[-1] = (v, j + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    out.append(sorted(comp))
    return out


def _succ_from_dense(adj: np.ndarray, mask: int) -> list[list[int]]:
    return [np.flatnonzero(adj[i] & mask).tolist()
            for i in range(adj.shape[0])]


def find_cycle_host(adj: np.ndarray, mask: int, scc: Iterable[int]
                    ) -> Optional[list[int]]:
    """A concrete cycle within ``scc`` using only ``mask`` edges (BFS from
    each node back to itself); None if none exists. Returns node list
    ``[a, b, …, a]``. Dense-adjacency front end of
    :func:`find_cycle_lists`."""
    return find_cycle_lists(_succ_from_dense(adj, mask), scc)


def _normalize_cycle(path: list[int]) -> list[int]:
    if path[0] != path[-1]:
        path = path + [path[0]]
    return path


def find_cycle_with_edge_host(adj: np.ndarray, back_mask: int,
                              rw_src: int, rw_dst: int) -> Optional[list[int]]:
    """A cycle that takes the single edge rw_src→rw_dst then returns to
    rw_src via ``back_mask`` edges only (G-single witness). Dense front
    end of :func:`find_cycle_with_edge_lists`."""
    return find_cycle_with_edge_lists(
        _succ_from_dense(adj, back_mask), rw_src, rw_dst)


def find_cycle_lists(succ: list[list[int]], scc: Iterable[int]
                     ) -> Optional[list[int]]:
    """List-based twin of :func:`find_cycle_host` (BFS within scc)."""
    nodes = set(int(x) for x in scc)
    for start in sorted(nodes):
        prev = {start: None}
        frontier = [start]
        while frontier:
            nxt = []
            for v in frontier:
                for w in succ[v]:
                    if w == start:
                        path = []
                        node = v
                        while node is not None:
                            path.append(node)
                            node = prev[node]
                        path.reverse()
                        return _normalize_cycle(path)
                    if w in nodes and w not in prev:
                        prev[w] = v
                        nxt.append(w)
            frontier = nxt
    return None


def find_cycle_with_edge_lists(succ: list[list[int]], rw_src: int,
                               rw_dst: int) -> Optional[list[int]]:
    """List-based twin of :func:`find_cycle_with_edge_host`: a cycle
    taking rw_src→rw_dst once, returning via ``succ`` edges."""
    prev = {rw_dst: None}
    frontier = [rw_dst]
    while frontier:
        nxt = []
        for v in frontier:
            for w in succ[v]:
                if w == rw_src:
                    path = []
                    node = v
                    while node is not None:
                        path.append(node)
                        node = prev[node]
                    path.reverse()
                    return _normalize_cycle([rw_src, *path])
                if w not in prev:
                    prev[w] = v
                    nxt.append(w)
        frontier = nxt
    return None


class SccReach:
    """Reachability queries within the strongly connected components of
    the FULL graph, over a (sub-)mask's edges — the only closure
    consumers in the anomaly taxonomy are edge-endpoint queries, and any
    qualifying path lies inside one full-graph SCC (the closing edge
    makes it a cycle). Memory is bounded by the LARGEST SCC, never n².

    Small components — and the first few queries of any component —
    answer by cached host BFS (O(E) each); once a component of at least
    ``device_min`` nodes has absorbed several distinct-source queries,
    it computes ONE device closure of the induced subgraph through the
    shared bucket table (:func:`ops.closure_rows_packed`): the matrix is
    built on the device from the edge arrays and the closure comes back
    bit-packed in one transfer; every later query is a host bit test.
    ``torch_device`` is the torch device of that closure (the GPU by
    default)."""

    # Distinct BFS sources a big component absorbs before the closure
    # pays for itself (each BFS is O(E); the closure answers all later
    # queries in one scalar read).
    BFS_BEFORE_CLOSURE = 8

    def __init__(self, succ: list[list[int]], sccs: list[list[int]],
                 device: bool, device_min: int = 512, torch_device=None):
        self.succ = succ
        self.torch_device = torch_device
        self.sccs = sccs
        self.device = device
        self.device_min = device_min
        self.node_comp: dict = {}
        for ci, comp in enumerate(sccs):
            for v in comp:
                self.node_comp[v] = ci
        self._bfs_cache: dict = {}
        self._bfs_sources: dict = {}  # comp_id -> distinct-source count
        self._closures: dict = {}  # comp_id -> (packed closure, local)

    def same_comp(self, a: int, b: int):
        ca = self.node_comp.get(a)
        return ca is not None and ca == self.node_comp.get(b), ca

    def prefetch(self, pairs) -> None:
        """Materialize closures ahead of upcoming ``query(comp, src,
        *)`` calls: ONE device dispatch and ONE bit-packed host transfer
        per component. Only components already in closure mode — or big
        enough that this batch alone would push them there — are
        materialized; everything else keeps the cheap per-source BFS."""
        by_comp: dict = {}
        for comp_id, src in pairs:
            by_comp.setdefault(comp_id, set()).add(src)
        for comp_id, srcs in by_comp.items():
            comp = self.sccs[comp_id]
            if not (comp_id in self._closures
                    or (self.device and len(comp) >= self.device_min
                        and len(srcs) + self._bfs_sources.get(comp_id, 0)
                        >= self.BFS_BEFORE_CLOSURE)):
                continue
            self._closure(comp_id)

    def query(self, comp_id: int, src: int, dst: int) -> bool:
        """Is there a ``succ``-path src→dst inside component comp_id?"""
        comp = self.sccs[comp_id]
        if comp_id in self._closures or (
                self.device and len(comp) >= self.device_min
                and self._bfs_sources.get(comp_id, 0)
                >= self.BFS_BEFORE_CLOSURE):
            packed, local = self._closure(comp_id)
            return _ops.row_bit(packed[local[src]], local[dst])
        key = (comp_id, src)
        reach = self._bfs_cache.get(key)
        if reach is None:
            nodes = set(comp)
            reach = set()
            frontier = [src]
            while frontier:
                nxt = []
                for v in frontier:
                    for w in self.succ[v]:
                        if w in nodes and w not in reach:
                            reach.add(w)
                            nxt.append(w)
                frontier = nxt
            self._bfs_cache[key] = reach
            self._bfs_sources[comp_id] = \
                self._bfs_sources.get(comp_id, 0) + 1
        return dst in reach

    def _closure(self, comp_id: int):
        hit = self._closures.get(comp_id)
        if hit is not None:
            return hit
        comp = sorted(self.sccs[comp_id])
        local = {v: i for i, v in enumerate(comp)}
        srcs, dsts = [], []
        for i, v in enumerate(comp):
            for w in self.succ[v]:
                j = local.get(w)
                if j is not None:
                    srcs.append(i)
                    dsts.append(j)
        packed, _labels = _ops.closure_rows_packed(
            srcs, dsts, len(comp), self.torch_device)
        self._closures[comp_id] = (packed, local)
        return packed, local


def closure_host(adj: np.ndarray, mask: int) -> np.ndarray:
    """Boolean transitive closure of the masked subgraph (repeated
    squaring, numpy)."""
    a = (adj & mask) > 0
    n = a.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(n, 2)))))
    for _ in range(steps):
        a2 = a | (a @ a)
        if np.array_equal(a2, a):
            break
        a = a2
    return a


# ---------------------------------------------------------------------------
# Device path: batched closures (shared bucket table)


def closures_device(adj: np.ndarray, torch_device=None):
    """Compute (has_ww_cycle, has_wwr_cycle, has_full_cycle,
    closure(ww|wr), closure(full)) on the torch device — all three
    taxonomy masks as members of ONE batched closure
    (:func:`ops.batched_closure`); results transfer bit-packed and
    unpack on the host."""
    n = adj.shape[0]
    pad = _ops.bucket_for(n) or _ops.closure_pad(n)
    members = []
    for mask in (WW, WW | WR, 0xFF):
        s, d = np.nonzero(adj & mask)
        members.append((s, d))
    epad = _ops.edge_pad(max(len(s) for s, _d in members))
    padded = [_ops.pad_edges(s, d, pad, epad) for s, d in members]
    S = np.stack([p[0] for p in padded])
    D = np.stack([p[1] for p in padded])
    packed, _labels = _ops.batched_closure(S, D, pad, torch_device)
    packed = packed.cpu().numpy().view(np.uint32)
    cw, cwr, cf = (_ops.unpack_bits_host(packed[i], pad)[:n, :n]
                   for i in range(3))
    return (bool(cw.diagonal().any()), bool(cwr.diagonal().any()),
            bool(cf.diagonal().any()), cwr, cf)
