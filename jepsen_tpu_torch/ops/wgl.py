"""WGL linearizability search on the GPU: planning and host driver.

The search is the reference's level-synchronous frontier BFS
(``jepsen_tpu/ops/wgl.py``). A configuration is a fixed-width row
``[p | window mask (KD u32 words) | state | open mask (KO words)]``: ``p``
is a prefix pointer over determinate rows sorted by invocation (all rows
``< p`` linearized), the window mask covers rows ``p .. p+W-1``, and open
(:info) ops get global mask slots. One BFS level linearizes one more op in
every configuration; ``ops.wgl_level`` runs a level as CUDA kernels (or
their plain PyTorch versions for CPU tensors).

The host driver escalates the frontier capacity over ``F_SCHEDULE``
losslessly, de-escalates after spikes, runs the top rung as a greedy beam
(whose exhaustion reads ``unknown``, never ``False``), and on long
histories first tries an optimistic beam. Verdicts: ``accepted`` ⇒
linearizable (sound under truncation); frontier exhausted with no
truncation ⇒ not linearizable, with the last non-empty frontier decoded as
the refutation witness.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time as _time
from typing import Optional

import numpy as np
import torch

from . import wgl_level as _lv
from .encode import EncodedHistory, encode_history
from .. import _build
from .. import trace as _trace
from ..checker import provenance as _prov
from ..devices import resolve_device
from ..history import History
from ..models import Model

INT32_MAX = np.int32(2**31 - 1)

# Frontier-capacity escalation schedule (configs per BFS level).
F_SCHEDULE = (16, 128, 1024, 2048, 4096, 8192, 32768)
# Expansions larger than this take the two-stage compaction (stage-1
# stable compaction of the valid rows into P = STAGE1_P_MULT*F rows, more
# survivors read as a lossless overflow). Read at call time, so tests can
# patch it.
BIG_M_THRESHOLD = 1 << 15
STAGE1_P_MULT = 4
# Per-level stats ring: one [level, frontier, expanded, overflow] row per
# level; a chunk longer than this keeps its most recent rows.
LEVEL_STAT_ROWS = _lv.LEVEL_STAT_ROWS
# Histories with at least this many determinate ops first run an
# optimistic beam of width OPTIMISTIC_BEAM_F.
OPTIMISTIC_MIN_OPS = 1500
OPTIMISTIC_BEAM_F = 4096

# The backends of check_history.
BACKENDS = ("device", "host", "auto", "native", "competition")


def _next_pow2(x: int, lo: int = 32) -> int:
    return max(lo, 1 << (int(x) - 1).bit_length())


class DevicePlan:
    """Prepared tables + static dims for one encoded history.

    ``dims = (W, KO, S, ND, NO)``; ``tabs`` holds the device tensors the
    expand stage reads (``tabD`` widened to int32 ``[ND, 8]``,
    ``sufret [ND+1]``, ``invO/opO/a1O/a2O [NO]``); ``B`` is the
    per-config candidate cap (None: no row-wise selection). ``args`` keeps
    the reference's ``DevicePlan.args`` on the host, in its dtypes and
    order (``tabD`` int16 or int32): what a search checkpoint's
    fingerprint hashes."""

    __slots__ = ("dims", "tabs", "nD", "nO", "init_state", "reason", "tab16",
                 "B", "device", "args")

    def __init__(self, dims, tabs, nD, nO, init_state=None, reason=None,
                 tab16=False, B=None, device=None, args=None):
        self.dims = dims
        self.args = args
        self.tabs = tabs
        self.nD = nD
        self.nO = nO
        self.init_state = init_state
        self.reason = reason
        self.tab16 = tab16
        self.B = B
        self.device = device

    @property
    def ok(self) -> bool:
        return self.reason is None

    @property
    def total_levels(self) -> int:
        return self.nD + self.nO + 1


def det_tables(enc: EncodedHistory) -> dict:
    """Split an encoding into determinate/open tables and derive the window
    width and the suffix-min completion table."""
    det = ~enc.skippable
    nD = int(det.sum())
    nO = enc.n - nD
    invD = enc.inv[det].astype(np.int32)
    retD = enc.ret[det].astype(np.int32)
    if nD:
        cnt = np.searchsorted(invD, retD, side="left") - np.arange(nD)
        W = max(int(cnt.max()), 1)
    else:
        W = 1
    sufret = np.full(nD + 1, INT32_MAX, dtype=np.int32)
    if nD:
        sufret[:nD] = np.minimum.accumulate(retD[::-1])[::-1]
    return {
        "nD": nD, "nO": nO, "W": W, "sufret": sufret,
        "invD": invD, "retD": retD,
        "opD": enc.opcode[det].astype(np.int32),
        "a1D": enc.a1[det].astype(np.int32),
        "a2D": enc.a2[det].astype(np.int32),
        "invO": enc.inv[~det].astype(np.int32),
        "opO": enc.opcode[~det].astype(np.int32),
        "a1O": enc.a1[~det].astype(np.int32),
        "a2O": enc.a2[~det].astype(np.int32),
    }


def plan_from_arrays(dims, args, nD: int, nO: int, init_state, B,
                     device=None) -> DevicePlan:
    """Build a plan from the reference's ``DevicePlan`` fields as numpy
    arrays: ``args = (nD, nO, total_levels, tabD, sufret, invO, opO, a1O,
    a2O)``. The int16 or int32 ``tabD`` is widened to int32 once, here."""
    dev = resolve_device(device)
    W, KO, S, ND, NO = (int(x) for x in dims)
    tabD = np.asarray(args[3])

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev).contiguous()

    tabs = {"tabD": t(tabD), "sufret": t(args[4]), "invO": t(args[5]),
            "opO": t(args[6]), "a1O": t(args[7]), "a2O": t(args[8])}
    return DevicePlan((W, KO, S, ND, NO), tabs, int(nD), int(nO),
                      init_state=np.asarray(init_state, np.int32),
                      tab16=tabD.dtype == np.int16,
                      B=None if B is None else int(B), device=dev, args=tuple(args))


def plan_device(enc: EncodedHistory, max_open: int = 128, window_cap: int = 1024,
                pad_to: Optional[tuple] = None, device=None) -> DevicePlan:
    """Prepare the search tables. ``pad_to = (W, KO, ND, NO)`` forces the
    static dims; they must dominate this history's own requirements."""
    t = det_tables(enc)
    nD, nO, W = t["nD"], t["nO"], t["W"]
    if nO > max_open:
        return DevicePlan(None, None, nD, nO,
                          reason=f"{nO} open (:info) ops exceeds device cap {max_open}")
    invD, retD = t["invD"], t["retD"]
    if W > window_cap:
        return DevicePlan(None, None, nD, nO,
                          reason=f"window requirement {W} exceeds cap {window_cap}")
    W = ((W + 31) // 32) * 32
    KO = (nO + 31) // 32
    ND = _next_pow2(max(nD, 1))
    NO = _next_pow2(max(nO, 1))
    S = len(enc.init_state)
    if pad_to is not None:
        pW, pKO, pND, pNO = pad_to
        if pW % 32 or pW < W or pKO < KO or pND < nD or pNO < max(nO, 1):
            return DevicePlan(
                None, None, nD, nO,
                reason=f"pad_to {pad_to} below requirement {(W, KO, nD, nO)} or W not x32")
        W, KO, ND, NO = pW, pKO, pND, pNO

    padD = lambda a: np.pad(a, (0, ND - nD))
    padO = lambda a: np.pad(a, (0, NO - nO))
    sufret = np.full(ND + 1, INT32_MAX, dtype=np.int32)
    sufret[: nD + 1] = t["sufret"]
    cols = [padD(invD), padD(retD), padD(t["opD"]), padD(t["a1D"]), padD(t["a2D"])]
    tab16 = all(c.size == 0 or (c.min() >= -32768 and c.max() <= 32767) for c in cols)
    tabD = np.zeros((ND, 8), dtype=np.int16 if tab16 else np.int32)
    for i, col in enumerate(cols):
        tabD[:, i] = col
    # the reference's DevicePlan.args, its scalars int32
    args = (np.int32(nD), np.int32(nO), np.int32(nD + nO + 1), tabD, sufret, padO(t["invO"]),
            padO(t["opO"]), padO(t["a1O"]), padO(t["a2O"]))
    # Per-config candidate cap: determinate candidates form a clique of the
    # op-interval overlap graph, so their count is bounded by the max
    # point-overlap of determinate intervals; opens add at most nO.
    if nD:
        ends = np.sort(retD)
        active = np.arange(1, nD + 1) - np.searchsorted(ends, invD, side="left")
        Dmax = int(active.max())
    else:
        Dmax = 0
    B = ((Dmax + nO + 7) // 8) * 8
    C = W + KO * 32
    return plan_from_arrays((W, KO, S, ND, NO), args, nD, nO, enc.init_state,
                            B if B < C else None, device)


class BatchPlan:
    """The tables of ``nb`` members planned to common static dims ``(W, KO,
    S, ND, NO)`` and one shared candidate cap ``B``, stacked member-major
    on the device (``tabs``: ``tabD [nb, ND, 8]``, ``sufret [nb, ND+1]``,
    ``invO/opO/a1O/a2O [nb, NO]``). ``nD``, ``nO`` and ``totals`` (levels
    a member may run: ``nD + nO + 1``) are int32 ``[nb]`` tensors on the
    host, where the driver reads them; ``init_state`` is ``[nb, S]`` on
    the device."""

    __slots__ = ("dims", "tabs", "nD", "nO", "totals", "init_state", "B", "device")

    def __init__(self, dims, tabs, nD, nO, totals, init_state, B, device):
        self.dims = tuple(int(x) for x in dims)
        self.tabs = tabs
        self.nD = nD
        self.nO = nO
        self.totals = totals
        self.init_state = init_state
        self.B = B
        self.device = device

    @property
    def nb(self) -> int:
        return int(self.nD.shape[0])

    def select(self, rows) -> "BatchPlan":
        """The plan of members ``rows`` (a row-select on the device: the
        stack is made once, and each rung of the batch ladder selects its
        members from it)."""
        rows = [int(r) for r in rows]
        ix = torch.tensor(rows, dtype=torch.long, device=self.device)
        hx = torch.tensor(rows, dtype=torch.long)
        return BatchPlan(self.dims, {k: v.index_select(0, ix) for k, v in self.tabs.items()},
                         self.nD[hx], self.nO[hx], self.totals[hx],
                         self.init_state.index_select(0, ix), self.B, self.device)


def stack_from_arrays(args_stack, dims, init_state, B, device=None) -> BatchPlan:
    """A batch plan from the reference's stacked ``DevicePlan.args``
    columns as numpy arrays: ``(nD [nb], nO [nb], total_levels [nb], tabD
    [nb, ND, 8] (int16 or int32), sufret [nb, ND+1], invO, opO, a1O, a2O
    [nb, NO])``; ``init_state`` is ``[nb, S]`` and ``B`` the shared
    candidate cap (None: no row-wise selection)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev).contiguous()

    def host(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32).reshape(-1))

    names = ("tabD", "sufret", "invO", "opO", "a1O", "a2O")
    tabs = {k: t(a) for k, a in zip(names, args_stack[3:9])}
    return BatchPlan(dims, tabs, host(args_stack[0]), host(args_stack[1]),
                     host(args_stack[2]), t(np.asarray(init_state).reshape(len(tabs["tabD"]), -1)),
                     None if B is None else int(B), dev)


def stack_plans(plans: list, device=None) -> BatchPlan:
    """Stack plans made with one ``pad_to`` (so their dims agree) into a
    batch plan on ``device``. The shared candidate cap dominates every
    member's: the largest, or None when any member has none (reference
    ``parallel/batch.py:232-236``)."""
    dims = {p.dims for p in plans}
    if len(dims) != 1:
        raise ValueError(f"stack_plans: members planned to different dims {sorted(dims)}")
    names = ("tabD", "sufret", "invO", "opO", "a1O", "a2O")
    cols = [np.array([p.nD for p in plans]), np.array([p.nO for p in plans]),
            np.array([p.total_levels for p in plans])]
    cols += [np.stack([p.tabs[k].cpu().numpy() for p in plans]) for k in names]
    Bs = [p.B for p in plans]
    B = None if any(b is None for b in Bs) else max(Bs)
    return stack_from_arrays(cols, dims.pop(), np.stack([p.init_state for p in plans]),
                             B, device)


def level_geometry(plan: DevicePlan, F: int) -> _lv.Geometry:
    """Static shape of one level at capacity ``F`` (reads
    ``BIG_M_THRESHOLD`` now, so a patched threshold takes effect)."""
    W, KO, S, ND, NO = plan.dims
    C = W + KO * 32
    SEL = plan.B is not None and plan.B < C
    M, P, _NC = _stage1_shape(plan, F)
    two_stage = M > BIG_M_THRESHOLD
    PB = max(int(ND).bit_length(), 1)
    if PB + 7 > 32:
        raise ValueError("ND too large for the fused compaction key")
    return _lv.Geometry(F=F, W=W, KO=KO, S=S, ND=ND, NO=NO, B=M // F, SEL=SEL,
                        two_stage=two_stage, P=P if two_stage else M)


def sharded_geometry(plan: DevicePlan, F: int, D: int, exchange: str) -> _lv.Geometry:
    """Static shape of one frontier-sharded level: ``F`` rows per shard, D
    shards, the two-stage compaction at every M (reference
    ``ops/wgl.py:525``: its trigger is ``axis_name is not None or M >
    BIG_M_THRESHOLD``), and ``L`` the exchanged rows: ``D * ceil(P / D)``
    (alltoall) or ``D * P`` (allgather)."""
    if exchange not in _lv.EXCHANGES:
        raise ValueError(f"unknown WGL exchange mode {exchange!r} "
                         "(expected 'alltoall' or 'allgather')")
    if not 1 <= D <= _lv.MAX_SHARDS:
        raise ValueError(f"{D} shards; the sharded kernels take 1..{_lv.MAX_SHARDS}")
    _M, P, _NC = _stage1_shape(plan, F)
    return dataclasses.replace(level_geometry(plan, F), two_stage=True, P=P, D=D,
                               exchange=exchange)


def _stage1_shape(plan: DevicePlan, F: int) -> tuple:
    """(M, P, NC) of one level at capacity ``F``."""
    W, KO, S, _ND, _NO = plan.dims
    KD = W // 32
    C = W + KO * 32
    SEL = plan.B is not None and plan.B < C
    M = F * (plan.B if SEL else C)
    P = min(M, max(STAGE1_P_MULT * F, 64))
    NC = 1 + KD + S + max(KO, 1)
    return M, P, NC


def level_byte_floor(plan: DevicePlan, F: int, sharded: bool = False,
                     exchange: str = "allgather") -> int:
    """Single-pass device-memory byte floor of one BFS level at capacity
    ``F``: every major tensor stream counted once in and once out,
    enumerated from the static shapes (the reference's byte model). A
    lower bound on real traffic. ``sharded``: the per-shard floor of a
    frontier-sharded level (two-stage at every M; the exchange itself is
    :func:`exchange_bytes_per_level`); with ``exchange="alltoall"`` it adds
    the owner routing and the bucket assembly."""
    W, KO, S, ND, NO = plan.dims
    KD = W // 32
    KO1 = max(KO, 1)
    C = W + KO * 32
    SEL = plan.B is not None and plan.B < C
    M, P1, NC = _stage1_shape(plan, F)
    esz = 2 if plan.tab16 else 4
    two_stage = sharded or M > BIG_M_THRESHOLD
    P = P1 if two_stage else M
    total = 0
    total += 2 * F * W * 8 * esz            # window-table row gather
    if SEL:
        total += 2 * 5 * F * C * 4          # candidate pre-selection
    total += 2 * M * 4 * (3 + S + 1)        # model step over the expansion
    total += 2 * M * (KD + KO1) * 4         # new-mask build
    if two_stage:
        total += 2 * M * 4                  # stage-1 compaction
        total += 2 * M * NC * 4             # candidate rows in
        total += 2 * P * NC * 4             # ... and survivors out
    total += 2 * (1 + NC) * P * 4           # fused-key dedup sort
    total += 2 * 2 * P * 4                  # fused-key compaction sort
    total += 2 * F * NC * 4                 # top-F row gather
    if sharded and exchange == "alltoall":
        total += 2 * 2 * P * 4              # owner routing
        total += 2 * P * NC * 4             # bucket assembly
    return total


def exchange_bytes_per_level(plan: DevicePlan, F: int, n_shards: int,
                             exchange: str = "alltoall") -> int:
    """Bytes one shard sends in one sharded level's exchange, ``F`` per
    shard (reference ``ops/wgl.py:1345``): the packed ``[*, NC+1]`` rows,
    ``n_shards * P`` of them under allgather, ``n_shards`` buckets of
    ``ceil(P / n_shards)`` under alltoall."""
    _M, P, NC = _stage1_shape(plan, F)
    if exchange == "allgather":
        return n_shards * P * (NC + 1) * 4
    return n_shards * (-(-P // n_shards)) * (NC + 1) * 4


def _levels_per_call(M: int, target_s: float = 8.0) -> int:
    """Levels per chunk, from the reference's per-level cost model (kept
    so chunk boundaries — where de-escalation is decided — fall on the
    same levels as the reference's)."""
    est = 2.0e-4 + 9.0e-9 * M
    return max(8, min(16384, int(target_s / est)))


def initial_frontier(F: int, W: int, KO: int, S: int, init_state, device) -> tuple:
    """Frontier ``(p, maskD, maskO, state, valid, level)`` for a fresh
    search: one valid config, nothing linearized."""
    dev = torch.device(device)
    KD = W // 32
    st = torch.as_tensor(np.asarray(init_state, np.int32), device=dev)
    return (
        torch.zeros((F,), dtype=torch.int32, device=dev),
        torch.zeros((F, KD), dtype=torch.int32, device=dev),
        torch.zeros((F, max(KO, 1)), dtype=torch.int32, device=dev),
        st.reshape(1, S).repeat(F, 1).contiguous(),
        torch.arange(F, device=dev) == 0,
        0,
    )


def initial_frontier_batch(F: int, W: int, KO: int, init_state: torch.Tensor) -> tuple:
    """Stacked fresh frontiers ``(p, maskD, maskO, state, valid)``, each
    ``[nb, F, ...]``, on ``init_state``'s device: one valid config per
    member, its own initial state."""
    nb, S = init_state.shape
    dev = init_state.device
    KD = W // 32
    valid = torch.zeros((nb, F), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    return (
        torch.zeros((nb, F), dtype=torch.int32, device=dev),
        torch.zeros((nb, F, KD), dtype=torch.int32, device=dev),
        torch.zeros((nb, F, max(KO, 1)), dtype=torch.int32, device=dev),
        init_state.to(torch.int32)[:, None, :].repeat(1, F, 1).contiguous(),
        valid,
    )


def frontier_from_arrays(p, mD, mO, st, valid, lvl, device=None,
                         n_shards: Optional[int] = None) -> tuple:
    """The port's frontier from the reference's 6-tuple as numpy arrays
    (u32 masks become int32 bit patterns). ``n_shards``: the reference's
    global sharded frontier (``[D*F, ...]``, shard-major) becomes the
    port's ``[D, F, ...]``."""
    dev = resolve_device(device)

    def t(a, dt):
        a = np.ascontiguousarray(np.asarray(a))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        a = a.astype(dt)
        if n_shards:
            a = a.reshape((n_shards, -1) + a.shape[1:])
        return torch.as_tensor(a, device=dev).contiguous()

    return (t(p, np.int32), t(mD, np.int32), t(mO, np.int32), t(st, np.int32),
            t(valid, bool), int(lvl))


def frontier_to_arrays(fr: tuple, sharded: bool = False) -> tuple:
    """Host numpy copy of a frontier, masks as uint32 (the reference's
    layout). ``sharded``: a ``[D, F, ...]`` frontier as the reference's
    global ``[D*F, ...]`` arrays."""
    p, mD, mO, st, valid, lvl = fr
    flat = (lambda a: a.reshape((-1,) + a.shape[2:])) if sharded else (lambda a: a)
    return (flat(p.cpu().numpy()), flat(mD.cpu().numpy().view(np.uint32)),
            flat(mO.cpu().numpy().view(np.uint32)), flat(st.cpu().numpy()),
            flat(valid.cpu().numpy()), int(lvl))


def frontier_stack_from_arrays(p, mD, mO, st, valid, device=None) -> tuple:
    """The port's stacked frontier ``[nb, F, ...]`` from the reference's
    stacked frontier arrays (numpy; u32 masks become int32 bit
    patterns)."""
    return frontier_from_arrays(p, mD, mO, st, valid, 0, device)[:5]


def frontier_stack_to_arrays(fr: tuple) -> tuple:
    """Host numpy copy of a stacked frontier's five arrays, masks as
    uint32 (the reference's layout)."""
    return frontier_to_arrays(tuple(fr[:5]) + (0,))[:5]


def _pad_frontier(fr: tuple, F_new: int, device, ops) -> tuple:
    """Grow a frontier to a larger capacity (escalation resume): the
    regroup of one member, ``idx = [0]`` (reference ``_pad_program``)."""
    grown = ops.regroup(tuple(a.to(device)[None] for a in fr[:-1]), [0], F_new)
    return tuple(a[0] for a in grown) + (fr[-1],)


def pad_sharded_frontier(fr: tuple, F_new: int, ops) -> tuple:
    """Grow a sharded frontier ``[D, F, ...]`` to ``F_new`` rows a shard as
    the reference does (``parallel/frontier.py`` escalation): the global
    ``[D*F]`` frontier padded at its end and resharded, so the rows of old
    shards 0..3 land on new shard 0 after a x4 step. The pad is the
    regroup of one member over the flattened arrays."""
    D = fr[0].shape[0]
    flat = tuple(a.reshape((1, -1) + tuple(a.shape[2:])) for a in fr[:-1])
    grown = ops.regroup(flat, [0], D * F_new)
    return tuple(a.reshape((D, F_new) + tuple(a.shape[2:])) for a in grown) + (fr[-1],)


def _snapshot_frontier(fr: tuple) -> tuple:
    """Host copy of a frontier: the beam's last-lossless checkpoint must
    survive the in-place updates of the next chunk."""
    return tuple(a.to("cpu", copy=True) for a in fr[:-1]) + (fr[-1],)


class _Search:
    """Per-search state shared by the chunks: plan, workspaces per
    capacity, and the stage implementation."""

    def __init__(self, plan: DevicePlan, model: Model, plain: bool):
        self.plan = plan
        self.model = model
        self.ops = _lv.PLAIN if plain else _lv.KERNELS
        self._ws: dict = {}

    def chunk(self, fr: tuple, F: int, lvl0: int, max_levels: int,
              lossy: bool) -> tuple:
        g = level_geometry(self.plan, F)
        key = (F, g)
        ws = self._ws.get(key)
        if ws is None:
            ws = self._ws[key] = _lv.BatchWorkspace(g, 1, self.plan.device)
        plan = self.plan
        flags = _lv.run_chunk(self.ops, g, plan.tabs, fr[:5], ws, lvl0, max_levels,
                              lossy, plan.nD, plan.nO, self.model)
        return flags, ws.stats[0]


def _chunk_level_rows(stats: np.ndarray, lvl0: int, lvl: int) -> list:
    """The stats ring's rows for this chunk, by level: completed levels
    and the attempt that ended the chunk (the reference's
    ``_note_chunk_metrics`` filter)."""
    rows = stats[np.argsort(stats[:, 0], kind="stable")]
    return [[int(x) for x in r] for r in rows.tolist()
            if lvl0 < r[0] <= lvl + 1]


def _note_chunk_metrics(metrics, lvl_stats, lvl0: int, lvl: int, F: int,
                        chunk_wall: float, stage: str) -> None:
    """Fold one chunk's stats ring and wall time into a telemetry registry
    (reference ``ops/wgl.py:996-1040``): the chunk and level counters, the
    kernel seconds by stage, the capacity gauge, one ``wgl_chunk`` event
    (``t1`` now, ``t0`` from the chunk's wall) and a ``wgl_level`` event for
    each of the chunk's levels, with the frontier peak. Host side only;
    never called when telemetry is off."""
    c = metrics.counter
    c("wgl_chunks_total", "Device kernel chunk invocations").inc()
    c("wgl_levels_total", "Completed BFS levels").inc(max(lvl - lvl0, 0))
    c("wgl_kernel_seconds_total",
      "Chunk wall seconds by stage (the chunk that first loads the kernel "
      "library carries its build or load)",
      labelnames=("stage",)).labels(stage=stage).inc(chunk_wall)
    metrics.gauge("wgl_capacity", "Current frontier capacity F").set(F)
    t1 = round(_time.time(), 6)
    metrics.event("wgl_chunk", level0=int(lvl0), level=int(lvl), F=int(F),
                  wall_s=round(chunk_wall, 6), stage=stage,
                  t0=round(t1 - chunk_wall, 6), t1=t1, **_trace.event_tags())
    if lvl_stats is None:
        return
    rows = lvl_stats[np.argsort(lvl_stats[:, 0], kind="stable")]
    for level_n, frontier, expanded, ovf_f in rows.tolist():
        if level_n <= lvl0 or level_n > lvl + 1:
            continue  # stale ring slots (zeros or a resumed prefix)
        # level_n == lvl + 1: the attempt that ended the chunk
        metrics.event("wgl_level", level=int(level_n), frontier=int(frontier),
                      expanded=int(expanded), overflow=bool(ovf_f), F=int(F),
                      completed=bool(level_n <= lvl))
        metrics.gauge("wgl_frontier_max", "Peak post-dedup frontier size").max(int(frontier))


def _enc_fingerprint(enc: EncodedHistory, plan: DevicePlan) -> str:
    """Content hash tying a search checkpoint to one (history, model,
    shape plan), so a stale file never resumes the wrong search: the
    model's identity (its class included, so a file does not cross
    packages), the dims and the reference's plan arrays in its dtypes and
    order (``plan.args``), as the reference hashes them."""
    h = hashlib.sha256()
    h.update(repr(_model_cache_key(enc.model)).encode())
    h.update(repr(plan.dims).encode())
    for a in plan.args:
        h.update(np.asarray(a).tobytes())
    return h.hexdigest()[:32]


def _checkpoint_arrays(fr: tuple, sharded: bool = False) -> tuple:
    """A frontier as the checkpoint stores it: the reference's host arrays
    (masks uint32) and its level as int32; a sharded frontier as the
    global ``[D*F]`` order."""
    host = frontier_to_arrays(fr, sharded=sharded)
    return host[:5] + (np.int32(host[5]),)


def _save_search_checkpoint(path, fingerprint: str, phase: str, truncated: bool, fr: tuple,
                            lossless_fr: Optional[tuple] = None) -> None:
    """Atomic npz snapshot of a resumable frontier (tmp file, then
    ``os.replace``), in the reference's format. ``fr`` and ``lossless_fr``
    are :func:`_checkpoint_arrays`; ``lossless_fr`` also keeps the last
    lossless frontier of a truncating beam (``ll_*``), so an interrupted
    beam's exhaustive fallback still skips the exact prefix."""
    p, mD, mO, st, valid, lvl = fr
    extra = {}
    if lossless_fr is not None:
        lp, lmD, lmO, lst, lvalid, llvl = lossless_fr
        extra = {"ll_p": lp, "ll_mD": lmD, "ll_mO": lmO, "ll_st": lst, "ll_valid": lvalid,
                 "ll_lvl": np.asarray(llvl)}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, fingerprint=fingerprint, phase=phase, truncated=truncated,
                            p=p, mD=mD, mO=mO, st=st, valid=valid, lvl=np.asarray(lvl),
                            **extra)
    os.replace(tmp, path)


def _clear_search_checkpoint(path) -> None:
    """Remove a checkpoint once its search reached a definite verdict."""
    try:
        os.remove(path)
    except OSError:
        pass


def _load_search_checkpoint(path, fingerprint: str) -> Optional[dict]:
    """The checkpoint at ``path`` as host arrays (``fr``, and
    ``lossless_fr`` where it has one), its ``phase`` and ``truncated``
    flag; None when there is none, or when the file is corrupt or foreign
    or its fingerprint is another search's."""
    if not path or not os.path.exists(path):
        return None
    try:
        z = np.load(path, allow_pickle=False)
        if str(z["fingerprint"]) != fingerprint:
            return None
        out = {"phase": str(z["phase"]), "truncated": bool(z["truncated"]),
               "fr": (z["p"], z["mD"], z["mO"], z["st"], z["valid"], np.int32(z["lvl"]))}
        if "ll_p" in z:
            out["lossless_fr"] = (z["ll_p"], z["ll_mD"], z["ll_mO"], z["ll_st"],
                                  z["ll_valid"], np.int32(z["ll_lvl"]))
        return out
    except Exception:  # noqa: BLE001 - a corrupt or foreign file: search from scratch
        return None


def check_encoded_device(enc: EncodedHistory, f_schedule=F_SCHEDULE,
                         max_open: int = 128, window_cap: int = 1024,
                         levels_per_call: Optional[int] = None,
                         pad_to: Optional[tuple] = None,
                         optimistic: Optional[bool] = None,
                         checkpoint_path: Optional[str] = None,
                         chunk_callback=None, metrics=None,
                         collect_stats: bool = False, device=None,
                         plain: bool = False, plan: Optional[DevicePlan] = None) -> dict:
    """Decide linearizability of an encoded history on ``device`` (the GPU
    unless ``device="cpu"``). The result map mirrors the reference's:
    ``valid``, ``op_count``, ``device``, ``levels``, ``frontier_max``,
    ``window``, ``attempts``, ``wall_s`` and, where they apply, ``phase``,
    ``beam``, ``info``, ``causes``, ``max_linearized``,
    ``stuck_configs`` and ``resumed_from_level``.

    ``checkpoint_path``: save the resumable frontier after every chunk
    (an atomic npz in the reference's format, fingerprinted to this
    history, model and plan) and resume from it on the next call with the
    same history; the file is deleted on a definite verdict and kept on
    ``unknown``. ``chunk_callback(info)`` is called after every chunk with
    the reference's keys (``level``, ``F``, ``frontier_max``, ``wall_s``,
    ``total_levels``, ``count``); its exceptions propagate, which also
    makes an interruption testable. ``metrics``: a
    :class:`jepsen_tpu_torch.telemetry.Registry` that receives the
    reference's events and counters (``wgl_chunk`` and ``wgl_level``
    events, ``wgl_escalation``, ``wgl_chunks_total``, ``wgl_levels_total``,
    ``wgl_kernel_seconds_total{stage}``, ``wgl_capacity``,
    ``wgl_frontier_max``, ``wgl_window``, ``wgl_total_levels`` and the
    escalation and truncation counters; ``stage`` as
    ``_build.chunk_stage`` gives it): one read of the stats ring a chunk,
    none without it.

    ``collect_stats``: also return ``level_stats``, the per-level
    ``[level, frontier, expanded, overflow]`` rows of every chunk.
    ``plain``: run the plain PyTorch version of every stage even on the
    GPU (the reference the kernels are held against). ``plan``: a
    prepared plan (e.g. from :func:`plan_from_arrays`) instead of
    planning ``enc`` here."""
    t0 = _time.perf_counter()
    n = enc.n
    dev = resolve_device(device)
    if plan is None:
        plan = plan_device(enc, max_open=max_open, window_cap=window_cap,
                           pad_to=pad_to, device=dev)
    if plan.nD == 0:
        return {"valid": True, "op_count": n, "device": True, "levels": 0}
    if not plan.ok or not f_schedule:
        info = plan.reason or "empty frontier-capacity schedule"
        return _prov.attach(
            {"valid": "unknown", "op_count": n, "device": True, "info": info},
            "encoding_unsupported", reason=info)
    search = _Search(plan, enc.model, plain)
    stats_out: Optional[list] = [] if collect_stats else None
    schedule = sorted(set(f_schedule))
    if optimistic is None:
        optimistic = plan.nD >= OPTIMISTIC_MIN_OPS
    if schedule[-1] > OPTIMISTIC_BEAM_F:
        beam_cap = OPTIMISTIC_BEAM_F
    elif len(schedule) > 1:
        beam_cap = schedule[-2]
    else:
        beam_cap = None
    fingerprint = _enc_fingerprint(enc, plan) if checkpoint_path else None
    disk = _load_search_checkpoint(checkpoint_path, fingerprint) if checkpoint_path else None
    if disk is not None and disk["fr"][0].shape[0] > max(schedule):
        # wider than this run's top capacity: slicing would drop configs
        disk = None
    if (disk is not None and disk.get("lossless_fr") is not None
            and disk["lossless_fr"][0].shape[0] > max(schedule)):
        disk = {k: v for k, v in disk.items() if k != "lossless_fr"}
    if disk is not None:
        # the host arrays as the port's frontiers, on the search's device
        disk = dict(disk, fr=frontier_from_arrays(*disk["fr"], device=dev))
        if disk.get("lossless_fr") is not None:
            disk["lossless_fr"] = frontier_from_arrays(*disk["lossless_fr"], device=dev)
    common = dict(stats_out=stats_out, chunk_callback=chunk_callback, metrics=metrics)

    def dck(phase):
        return (checkpoint_path, fingerprint, phase) if checkpoint_path else None

    def finish(res):
        if checkpoint_path and res.get("valid") != "unknown":
            _clear_search_checkpoint(checkpoint_path)
        res["torch_device"] = str(dev)
        if stats_out is not None:
            res["level_stats"] = stats_out
        return res

    beam_sched = ([f for f in schedule if f <= beam_cap] or [beam_cap]) \
        if beam_cap is not None else []
    sharded_disk = (disk is not None and disk["phase"] == "sharded"
                    and not disk["truncated"])
    if disk is not None and (
            disk["phase"] == "full"
            or (sharded_disk and (not optimistic or beam_cap is None
                                  or disk["fr"][0].shape[0] > max(beam_sched)))):
        # A checkpointed exhaustive phase (or a lossless sharded frontier
        # the beam cannot take) resumes the exhaustive phase directly.
        res = _device_search(enc, search, schedule, levels_per_call, t0, resume_from=disk,
                             disk_checkpoint=dck("full"), **common)
        res["resumed_from_level"] = int(disk["fr"][-1])
        return finish(res)
    if optimistic and beam_cap is not None:
        checkpoint: dict = {}
        if disk is not None and disk.get("lossless_fr") is not None:
            # interrupted after the beam first truncated: its persisted
            # last lossless frontier still seeds the exhaustive fallback
            checkpoint["fr"] = disk["lossless_fr"]
        elif sharded_disk:
            checkpoint["fr"] = disk["fr"]
        beam_resume = (disk if disk and (disk["phase"] == "beam" or sharded_disk)
                       and disk["fr"][0].shape[0] <= max(beam_sched) else None)
        res = _device_search(enc, search, beam_sched, levels_per_call, t0,
                             checkpoint=checkpoint, resume_from=beam_resume,
                             disk_checkpoint=dck("beam"), **common)
        if res["valid"] is True:
            res["phase"] = "optimistic-beam"
            return finish(res)
        if res["valid"] is False and not res.get("beam"):
            return finish(res)  # refuted without ever truncating: sound
        # Beam exhausted under truncation: exhaustive phase, resumed from
        # the beam's last lossless frontier.
        full = _device_search(enc, search, schedule, levels_per_call,
                              _time.perf_counter(), resume_from=checkpoint or None,
                              disk_checkpoint=dck("full"), **common)
        full["wall_s"] = _time.perf_counter() - t0
        full["optimistic_attempts"] = res.get("attempts")
        return finish(full)
    # Not optimistic: a truncated beam checkpoint must not seed the
    # exhaustive search; its lossless companion can.
    resume = None
    if disk is not None:
        if not disk["truncated"]:
            resume = disk
        elif disk.get("lossless_fr") is not None:
            resume = {"fr": disk["lossless_fr"]}
    return finish(_device_search(enc, search, schedule, levels_per_call, t0,
                                 resume_from=resume, disk_checkpoint=dck("full"), **common))


def _device_search(enc: EncodedHistory, search: _Search, schedule: list,
                   levels_per_call: Optional[int], t0: float,
                   checkpoint: Optional[dict] = None,
                   resume_from: Optional[dict] = None,
                   stats_out: Optional[list] = None,
                   disk_checkpoint: Optional[tuple] = None,
                   chunk_callback=None, metrics=None) -> dict:
    """One escalating/de-escalating frontier search over ``schedule``;
    the top capacity continues past overflow as a greedy beam.

    ``checkpoint`` (out): receives {"fr"} — the entry frontier of the
    first chunk that truncated (the last lossless state).
    ``resume_from``: such a dict (``truncated`` too, for a disk
    checkpoint) to start from instead of level 0. ``disk_checkpoint``:
    ``(path, fingerprint, phase)``, save the resumable frontier after
    every chunk. ``chunk_callback`` and ``metrics``: see
    :func:`check_encoded_device`."""
    plan = search.plan
    dev = plan.device
    n = enc.n
    W, KO, S, ND, NO = plan.dims
    total_levels = plan.total_levels
    if metrics is not None:
        metrics.gauge("wgl_window", "Required real-time window width (slots)").set(W)
        metrics.gauge("wgl_total_levels",
                      "BFS levels required for acceptance").set(total_levels)
    attempts: list = []
    fmax_all = 1

    def result(valid, lvl, **extra):
        r = {
            "valid": valid,
            "op_count": n,
            "device": True,
            "levels": int(lvl),
            "frontier_max": fmax_all,
            "window": W,
            "attempts": attempts,
            "wall_s": _time.perf_counter() - t0,
        }
        r.update(extra)
        return r

    def pick_capacity(count: int) -> int:
        """Smallest scheduled capacity with ≥4x headroom over the current
        frontier."""
        for F in schedule:
            if F >= 4 * count:
                return F
        return schedule[-1]

    if resume_from:
        ck_fr = resume_from["fr"]
        F = next((f for f in schedule if f >= ck_fr[0].shape[0]), schedule[-1])
        fr = _pad_frontier(ck_fr, F, dev, search.ops)
    else:
        F = schedule[0]
        fr = initial_frontier(F, W, KO, S, plan.init_state, dev)
    truncated = bool(resume_from.get("truncated")) if resume_from else False
    rung_entry = int(fr[-1])
    deesc_from = None  # capacity last de-escalated FROM (known adequate)
    while True:
        if fr[0].shape[0] < F:
            fr = _pad_frontier(fr, F, dev, search.ops)
        attempt = {"F": F, "levels": 0, "calls": 0, "wall_s": 0.0}
        if attempts and attempts[-1]["F"] == F:
            attempt = attempts[-1]
        else:
            attempts.append(attempt)
        t_call = _time.perf_counter()
        lpc = levels_per_call or _levels_per_call(F * (plan.B or (W + KO * 32)))
        lvl0 = int(fr[-1])
        budget = min(total_levels, lvl0 + lpc)
        lossy = F == schedule[-1]
        entry_fr = None
        if lossy and not truncated and checkpoint is not None:
            entry_fr = _snapshot_frontier(fr)
        was_loaded = _build.loaded()
        flags, stats = search.chunk(fr, F, lvl0, budget, lossy)
        acc, ovf, nonempty, lvl, fmax, count = flags
        fr = fr[:5] + (lvl,)
        fmax_all = max(fmax_all, fmax)
        attempt["levels"] = lvl
        attempt["calls"] += 1
        chunk_wall = _time.perf_counter() - t_call
        attempt["wall_s"] = round(attempt["wall_s"] + chunk_wall, 3)
        ring = (stats.cpu().numpy() if stats_out is not None or metrics is not None
                else None)
        if stats_out is not None:
            stats_out.extend(_chunk_level_rows(ring, lvl0, lvl))
        if metrics is not None:
            metrics.counter(
                "wgl_donated_frontier_bytes_total",
                "Frontier bytes the chunk updated in place (no carry copy)").inc(
                    sum(int(a.nbytes) for a in fr[:5]))
            _note_chunk_metrics(metrics, ring, lvl0, lvl, F, chunk_wall,
                                _build.chunk_stage(was_loaded))
        if lossy and bool(ovf):
            if not truncated and checkpoint is not None and (
                    checkpoint.get("fr") is None
                    or int(entry_fr[-1]) > int(checkpoint["fr"][-1])):
                checkpoint["fr"] = entry_fr
            truncated = True
        if disk_checkpoint is not None:
            path, fingerprint, phase = disk_checkpoint
            lossless = checkpoint.get("fr") if checkpoint is not None else None
            _save_search_checkpoint(
                path, fingerprint, phase, truncated, _checkpoint_arrays(fr),
                lossless_fr=None if lossless is None else _checkpoint_arrays(lossless))
        if metrics is not None and lossy and bool(ovf):
            metrics.counter("wgl_beam_truncations_total",
                            "Chunks in which the lossy beam dropped configs").inc()
        if chunk_callback is not None:
            chunk_callback({"level": lvl, "F": F, "frontier_max": fmax_all,
                            "wall_s": _time.perf_counter() - t0,
                            "total_levels": total_levels, "count": count})
        if acc:
            # Sound even after truncation: dropping configs only removes
            # accepting paths, never invents one.
            return result(True, lvl, **({"beam": True} if truncated else {}))
        if not nonempty:
            if truncated:
                return _prov.attach(result(
                    "unknown", lvl,
                    info=f"beam (lossy frontier, capacity {F}) exhausted",
                    beam=True,
                ), "beam_loss", F=int(F))
            # Refutation witness: the last non-empty frontier, which the
            # level program keeps on a dead end.
            return result(False, lvl, max_linearized=lvl,
                          stuck_configs=_returned_stuck_configs(enc, fr))
        if lvl >= total_levels:
            return _prov.attach(result(
                "unknown", lvl, info="level budget exhausted without verdict"
            ), "level_budget", levels=int(lvl), F=int(F))
        if ovf and not lossy:
            # Escalate, resuming losslessly from the kept frontier; a rung
            # that overflowed almost at once skips a rung.
            idx = schedule.index(F)
            step = 2 if lvl - rung_entry < 64 else 1
            nxt = schedule[min(idx + step, len(schedule) - 1)]
            if deesc_from is not None and F < deesc_from:
                nxt = min(nxt, deesc_from)
                if nxt >= deesc_from:
                    deesc_from = None
            if metrics is not None:
                metrics.counter("wgl_capacity_escalations_total",
                                "Lossless frontier-capacity escalations").inc()
                metrics.event("wgl_escalation", level=lvl, from_F=F, to_F=nxt)
            F = nxt
            rung_entry = lvl
        else:
            # De-escalate when the frontier has shrunk (kept rows are
            # compacted to the front, so the slice is lossless), only with
            # a long horizon left.
            attempt.setdefault("counts", []).append(count)
            F2 = pick_capacity(count)
            if F2 < F and total_levels - lvl > 1000:
                deesc_from = F
                fr = tuple(a[:F2] for a in fr[:-1]) + (fr[-1],)
                F = F2
                rung_entry = lvl


# Open-set words of the native engine's witness encoding (wgl_native.c's
# NO_WORDS).
NO_WORDS_OPEN = 4


def decode_stuck_config(enc: EncodedHistory, det_rows, open_rows, p: int,
                        win: int, open_words: list, st: tuple) -> dict:
    """Decode one (p, window-bitset, open-set, state) search config into
    the host oracle's ``stuck_configs`` entry shape: original history row
    indices, model state, and the first pending ops annotated with why
    each cannot extend the linearization."""
    nD = len(det_rows)
    linearized = [int(det_rows[i]) for i in range(min(p, nD))]
    for b in range(int(win).bit_length()):
        if (win >> b) & 1 and p + b < nD:
            linearized.append(int(det_rows[p + b]))
    for w, word in enumerate(open_words):
        for b in range(64):
            if (word >> b) & 1 and 64 * w + b < len(open_rows):
                linearized.append(int(open_rows[64 * w + b]))
    lin_set = set(linearized)
    model = enc.model
    unlin = [int(r) for r in det_rows if int(r) not in lin_set]
    min_ret = min((int(enc.ret[r]) for r in unlin), default=None)
    pending = []
    for r in unlin[:10]:
        if min_ret is not None and int(enc.inv[r]) >= min_ret \
                and int(enc.ret[r]) != min_ret:
            why = ("real-time-blocked: an earlier op completed "
                   "before this one was invoked")
        else:
            ok, _st2 = model.step_scalar(
                tuple(st), int(enc.opcode[r]), int(enc.a1[r]), int(enc.a2[r]))
            why = ("every continuation already explored" if ok
                   else f"model rejects from state {tuple(st)}")
        pending.append({"row": r, "op": enc.describe(r), "why": why})
    return {"linearized": sorted(lin_set), "state": tuple(st), "pending": pending}


def _returned_stuck_configs(enc: EncodedHistory, fr: tuple) -> list:
    """Refutation witness decoded from the returned (last non-empty)
    frontier. Diagnostics never mask the verdict: a decoding failure
    returns an empty witness."""
    try:
        return _frontier_stuck_configs(enc, frontier_to_arrays(fr)[:5])
    except (ValueError, IndexError, KeyError, TypeError):
        return []


def _frontier_stuck_configs(enc: EncodedHistory, fr: tuple, limit: int = 5) -> list:
    """Decode the host copy of a frontier's valid rows into stuck-config
    entries."""
    p_, mD, mO, _st, valid = (np.asarray(a) for a in fr[:5])
    det_rows = np.flatnonzero(~enc.skippable)
    open_rows = np.flatnonzero(enc.skippable)
    out = []
    for i in np.flatnonzero(valid)[:limit]:
        win = 0
        for w in range(mD.shape[1]):
            win |= int(mD[i, w]) << (32 * w)
        open_words = []
        for w in range(0, max(mO.shape[1], 1), 2):
            lo = int(mO[i, w]) if w < mO.shape[1] else 0
            hi = int(mO[i, w + 1]) if w + 1 < mO.shape[1] else 0
            open_words.append(lo | (hi << 32))
        st = tuple(int(x) for x in _st[i])
        out.append(decode_stuck_config(enc, det_rows, open_rows, int(p_[i]),
                                       win, open_words, st))
    return out


def member_stuck_configs(enc: EncodedHistory, fr_host: tuple, b: int) -> list:
    """Refutation witness of member ``b`` decoded from its row of a host
    copy of a stacked frontier (:func:`frontier_stack_to_arrays`)."""
    return _frontier_stuck_configs(enc, tuple(a[b] for a in fr_host[:5]))


def _model_cache_key(model: Model) -> tuple:
    """The identity of a model's step: members of one batch share it."""
    return (type(model), model.cache_key(), model.cache_args())


def check_history_device(model: Model, history: History, **kw) -> dict:
    return check_encoded_device(encode_history(model, history), **kw)


def check_encoded_competition(enc: EncodedHistory, native_max_configs: Optional[int] = None,
                              **kw) -> dict:
    """Race the native C search against the device search; the first
    definite verdict wins (knossos's ``:competition`` strategy, the
    reference's ``check_encoded_competition``). The C search runs on a
    host thread and releases the GIL inside the library call, so both
    engines run at once. The loser is cancelled: the device search raises
    out of its next chunk callback, the C search polls a cancel flag.

    Sound by construction: each engine is sound on its own, and the race
    only picks which sound verdict comes back. ``native_max_configs``
    bounds the C side (default ``1_000_000 + 2000 * n``); the other
    keyword arguments go to :func:`check_encoded_device` (a caller's
    ``chunk_callback`` is still called after every chunk), and
    ``metrics`` to the C side too. The result carries ``backend =
    "competition"`` and the winning ``engine``; a device search that
    raised (other than by losing) leaves its error in ``device_error``, a
    C search that raised in ``native_error``. The C library is loaded
    before the race starts, so a failed build raises here."""
    import ctypes
    import threading

    from .. import native
    from . import wgl_c

    native.load()
    if native_max_configs is None:
        native_max_configs = 1_000_000 + 2_000 * enc.n
    done = threading.Event()
    native_res: dict = {}
    cancel = ctypes.c_int32(0)

    def native_side():
        try:
            strategy, n_thr = wgl_c.parallel_policy()
            nat = wgl_c.check_encoded_native(
                enc, max_configs=native_max_configs, cancel=cancel, strategy=strategy,
                n_threads=n_thr, metrics=kw.get("metrics"))
        except Exception as e:  # noqa: BLE001 - the race must survive a loser
            nat = None
            native_res["native_error"] = f"{type(e).__name__}: {e}"
        if nat is not None:
            native_res.update(nat)
        if nat is not None and nat["valid"] != "unknown":
            done.set()

    t = threading.Thread(target=native_side, daemon=True)
    t.start()

    class _Lost(Exception):
        pass

    outer_cb = kw.pop("chunk_callback", None)

    def cb(info):
        if done.is_set():
            raise _Lost()
        if outer_cb is not None:
            outer_cb(info)

    dev: Optional[dict] = None
    device_error = None
    try:
        dev = check_encoded_device(enc, chunk_callback=cb, **kw)
    except _Lost:
        pass
    except Exception as e:  # noqa: BLE001 - a device failure keeps a native verdict
        device_error = f"{type(e).__name__}: {e}"
    if dev is not None and dev["valid"] != "unknown":
        # The device won: cancel the C search, which would otherwise run
        # on to its whole budget.
        done.set()
        cancel.value = 1
        t.join(timeout=30)
        out = dev
        out["engine"] = "device"
    else:
        # The device lost, failed or ended unknown: take the native
        # verdict, waiting for it if it is still searching.
        t.join()
        if "valid" in native_res and native_res["valid"] != "unknown":
            out = native_res
            out["engine"] = "native"
        else:
            # Neither engine decided.
            out = dev or native_res or {}
            out.setdefault("valid", "unknown")
            out.setdefault("op_count", enc.n)
            out.setdefault("info", "neither engine reached a definite verdict")
            # Each engine's own causes ride along; a bare fallback gets the
            # backstop, so no unknown leaves here without a cause.
            out["causes"] = _prov.ensure(_prov.of(out), stage="competition")
    out["backend"] = "competition"
    if device_error is not None:
        out["device_error"] = device_error
    if "native_error" in native_res:
        out["native_error"] = native_res["native_error"]
    return out


def check_history(model: Model, history: History, backend: str = "device",
                  host_max_configs: int = 500_000, parallel: Optional[str] = None,
                  **kw) -> dict:
    """Unified entry over the three engines: the device search (this
    module), the native C search (``ops.wgl_c``) and the host oracle
    (``ops.wgl_host``).

    ``backend``:

    - ``"device"`` (the default): the frontier search on the GPU (or on
      ``device="cpu"``);
    - ``"auto"``: the C search first (a sequential probe of ``50_000 + 5
      n`` configurations, then the parallel search under
      :func:`wgl_c.parallel_policy` up to ``1_000_000 + 2000 n``), then,
      for a model or shape it does not take or leaves ``unknown``, the
      device search, and after a device ``unknown`` the host oracle (its
      result keeps the device's under ``device_attempt``);
    - ``"native"``: the C search as under ``auto``, and the host oracle
      where it does not take the model or shape;
    - ``"competition"``: the C search raced against the device search
      (:func:`check_encoded_competition`), the host oracle after a shared
      ``unknown`` (with ``competition_attempt``); ``auto`` for a model
      with no device step;
    - ``"host"``: the host oracle only.

    A model with no device step (``device_capable = False``: the queues)
    runs on the host oracle under ``device``, and its result's ``info``
    says so. The device legs take every other keyword argument
    (``device``, ``metrics``, ``chunk_callback``, ...); the C search takes
    only ``metrics``. ``parallel=`` (the offline segmented checker) comes
    with a later slice of the port and raises."""
    if parallel is not None:
        raise ValueError("parallel= (the offline segmented checker) comes "
                         "with a later slice of the port")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
    from . import wgl_c, wgl_host

    enc = encode_history(model, history)
    if backend == "competition" and model.device_capable:
        res = check_encoded_competition(enc, **kw)
        if res["valid"] != "unknown":
            return res
        host = wgl_host.check_encoded(enc, max_configs=host_max_configs)
        if host["valid"] != "unknown":
            host["backend"] = "host"
            host["competition_attempt"] = {k: res.get(k) for k in ("valid", "info")}
            return host
        return res
    if backend == "competition":
        backend = "auto"  # no device step: the same fallback chain
    if backend in ("auto", "native"):
        # Budgeted: the C memo costs about 57 B a slot at <= 75% load, plus
        # a transient doubling while it grows.
        budget = 1_000_000 + 2_000 * enc.n
        # Two phases: a valid history decides in about n configurations,
        # so a cheap sequential probe catches it at full speed; a probe
        # that trips its budget suggests a refutation, which must cover
        # the reachable space, so it reruns on the shared-stack engine.
        quick = min(budget, 50_000 + 5 * enc.n)
        nat = wgl_c.check_encoded_native(enc, max_configs=quick, metrics=kw.get("metrics"))
        if nat is not None and nat["valid"] == "unknown":
            strategy, n_thr = wgl_c.parallel_policy()
            nat = wgl_c.check_encoded_native(enc, max_configs=budget, strategy=strategy,
                                             n_threads=n_thr, metrics=kw.get("metrics"))
        if nat is not None and nat["valid"] != "unknown":
            nat["backend"] = "native"
            return nat
        if backend == "native":
            if nat is not None:
                nat["backend"] = "native"
                return nat
            res = wgl_host.check_encoded(enc, max_configs=host_max_configs)
            res["backend"] = "host"
            res["info"] = res.get("info") or "native engine unavailable; ran python oracle"
            return res
    if backend == "host" or not model.device_capable:
        res = wgl_host.check_encoded(enc, max_configs=host_max_configs)
        if backend == "device":
            # A device request this model cannot honour: say so, keeping
            # the oracle's own diagnostics.
            note = f"model {model.name} is not device-capable; ran on host oracle"
            res["info"] = f"{res['info']}; {note}" if res.get("info") else note
        res["backend"] = "host"
        return res
    res = check_encoded_device(enc, **kw)
    if backend == "auto" and res["valid"] == "unknown":
        host = wgl_host.check_encoded(enc, max_configs=host_max_configs)
        if host["valid"] != "unknown":
            host["device_attempt"] = res
            return host
    return res
