"""One BFS level of the WGL frontier search over a batch of members: CUDA
kernels and their plain PyTorch versions.

This is the port of the reference's level program (``jepsen_tpu/ops/
wgl.py`` ``_build_kernel`` → ``level``, lines 301-934) and of its vmapped
batch form (``_build_batch_kernel``, line 949). A level is a fixed
sequence of stages, each a hand-written kernel in ``csrc/wgl_level.cu``
launched once for the whole batch, with a plain PyTorch function here
that computes one member's stage:

======================  ====================================================
stage                   what it computes
======================  ====================================================
``expand``              window read, two-min real-time candidacy, row-wise
                        ≤B selection, model step (any device model, see
                        :func:`step_spec`), bit set + renormalise; packed
                        candidate rows ``[M, NC]``; a single-stage level's
                        (``M <= BIG_M_THRESHOLD``) fused keys with them
``stage1_hash``         stable compaction of valid rows into P rows (when
                        ``M > BIG_M_THRESHOLD``, and in a sharded level)
                        fused with the FNV group hash and fused key: one
                        single-pass launch with decoupled look-back (see
                        :func:`stage1_scratch`)
``take_col_sort``       the radix sort of ``(src[v, col], v)`` with ``v``
                        the identity or the values: the sort-key gather
                        folded into the sort's key load (one launch on
                        the one-block path)
``radix_sort_pairs``    stable LSD radix sort of (u32 key, u32 value) pairs:
                        one block per member up to 16384 pairs, Onesweep
                        above (see :func:`sort_scratch`)
``prune``               same-group / adjacent-subset / group-head dominance,
                        keep count, fused compaction priority: one
                        single-pass launch with decoupled look-back (see
                        :func:`prune_scratch`)
``gather_finalize``     top-F gather into the frontier (in place), the
                        lossless restore, flags, stats row, stop test: one
                        launch (see :func:`gather_scratch`)
``chunk_init``          the whole start of a chunk: each member's control
                        block from its initial values (in the launch's
                        parameters, or a ladder table on the card), its
                        stats ring zeroed, its frontier count and stop
                        test (sharded: and the cross-shard reduce, in its
                        last block); one launch (see :func:`chunk_rows`)
``regroup``             row-gather of members' frontiers, zero-padded to a
                        larger capacity
``route``               sharded level (alltoall): owner hash and one
                        scatter of each shard's stage-1 rows straight into
                        their owners' receive rows with their fused keys
                        (the all_to_all folded in; see
                        :func:`route_scratch`)
``exchange``            sharded level (allgather): the all_gather of the
                        stage-1 rows and their keys between the shards'
                        buffers
======================  ====================================================

A frontier-sharded search (the reference's ``parallel/frontier.py``) is a
batch whose members are the D shards of one search on one device: the
buffers are shard-major, every stage above runs unchanged at the
exchanged row count ``L``, the route or the exchange stands where the
reference's collectives and its hash of the received rows were (each
writes the received rows' keys), and its cross-shard reductions
(pmax / psum / pmin) run in the last block of the prune and of the chunk
start (see :func:`_sharded_level_stages`).

Every buffer is member-major: ``[nb, ...]``, one row per member, and the
single-history search is the batch of one. The wrappers take the batched
buffers; for tensors on the CPU they run the plain version once per
member on member views (what ``vmap`` means), and on a CUDA tensor they
launch the kernel once for all members (or raise). Each wrapper counts
its launches in :data:`LAUNCHES`.

u32 words (masks, hashes, keys) are stored as int32 bit patterns; the
plain versions widen them to int64 and mask with ``0xFFFFFFFF`` because
CPU torch has no uint32 ``>>``/``+``/``min``.

Control blocks ``ctl`` (int32 [nb, CTL_SIZE], on the frontier's device)
hold each member's loop carry of the reference's ``while_loop``, its true
op counts ``nD``/``nO`` (the tables are padded to the batch's common
``ND``/``NO``) and this level's counters; every stage returns at once for
a member whose ``ctl[CTL_GO] == 0``, so a host may enqueue more levels
than will run and each member still stops exactly where the reference's
loop does.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from .. import _build
from ..models import (Bank, CasRegister, Counter, FencedMutex, LwSet, Model, MultiRegister,
                      Mutex, OwnerAwareMutex, ReentrantFencedMutex, ReentrantMutex, Register,
                      Semaphore)

INT32_MAX = 2**31 - 1
M32 = 0xFFFFFFFF
# The sign bit of a fused key: the row is invalid (csrc ``KEY_INVALID``).
KEY_INVALID = 0x80000000
LEVEL_STAT_ROWS = 512

(CTL_LVL, CTL_ACC, CTL_OVF, CTL_FMAX, CTL_STUCK, CTL_MAXLVL, CTL_LOSSY,
 CTL_GO, CTL_FCOUNT, CTL_NEXP, CTL_ACCNOW, CTL_ROWOVF, CTL_COUNT, CTL_ND,
 CTL_NO) = range(15)
# Sharded levels only, written to every shard by the cross-shard reduce
# (the prune's, or the chunk start's): the level's global keep count and
# overflow, and the sum, max and min over shards of the frontier counts
# after the level (or at a chunk's start).
CTL_GCOUNT, CTL_GOVF, CTL_NSUM, CTL_NMAX, CTL_NMIN = range(15, 20)
CTL_SIZE = 20
# A member is a grid coordinate (blockIdx.y) of the batched launches.
MAX_MEMBERS = 65535
# Members whose initial control-block values ride in the chunk start's
# launch parameters (csrc ``CS_INLINE``); a larger batch of the ladder
# keeps them in a table on the card (:func:`ladder_table`), and one row
# serves any number of members that share it.
CS_INLINE = _build.CS_INLINE
# The ladder table: words a member and their meaning (csrc ``CS_*``).
CS_TW = 8
CS_ENTRY, CS_TOTAL, CS_LOSSY, CS_ND, CS_NO, CS_ACTIVE = range(6)
CS_FRESH = 2  # CS_ACTIVE before the rung's first chunk
# The widest window the expand kernel holds (the planner's window cap).
EXPAND_MAX_W = 1024
# Shards of one mesh.
MAX_SHARDS = 256
EXCHANGES = ("alltoall", "allgather")
_EX_MODE = {None: 0, "alltoall": 1, "allgather": 2}  # EX_* in the kernels

# Launch counts per wrapper (kernel launches only; the CPU path counts
# nothing). ``reset_launches`` zeroes them.
LAUNCHES = {name: 0 for name in (
    "wgl_chunk_init", "wgl_expand", "wgl_stage1_hash", "wgl_take_col_sort",
    "radix_sort_pairs", "wgl_prune", "wgl_gather_finalize", "wgl_regroup", "wgl_route",
    "wgl_exchange")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class Geometry:
    """Static shape of one level at capacity ``F``, shared by every member
    of a batch (see ``wgl.level_geometry``). A member's true op counts are
    in its control block."""

    F: int
    W: int
    KO: int
    S: int
    ND: int
    NO: int
    B: int  # expansion width per config (== C when selection is off)
    SEL: bool
    two_stage: bool
    P: int  # stage-1 survivor rows (== M when single-stage)
    D: int = 1  # shards of a frontier-sharded search (its members)
    exchange: Optional[str] = None  # "alltoall" | "allgather" when sharded

    @property
    def KD(self) -> int:
        return self.W // 32

    @property
    def KO1(self) -> int:
        return max(self.KO, 1)

    @property
    def C(self) -> int:
        return self.W + 32 * self.KO

    @property
    def M(self) -> int:
        return self.F * self.B

    @property
    def PBK(self) -> int:
        """Rows of one destination's bucket (alltoall)."""
        return -(-self.P // self.D)

    @property
    def L(self) -> int:
        """Rows the dedup sees: the exchanged rows of a sharded level."""
        if self.exchange == "alltoall":
            return self.D * self.PBK
        if self.exchange == "allgather":
            return self.D * self.P
        return self.P if self.two_stage else self.M

    @property
    def NC(self) -> int:
        return 1 + self.KD + self.S + self.KO1

    @property
    def NID(self) -> int:
        """Group-identity columns (p, window mask, state) — what the FNV
        hash and the same-group test read; never the open masks."""
        return 1 + self.KD + self.S

    @property
    def PB(self) -> int:
        return max(int(self.ND).bit_length(), 1)


def _nblk(n: int, per: int) -> int:
    return max(1, -(-n // per))


SORT_PATHS = ("cta", "onesweep")


def sort_scratch(n: int, device, nb: int = 1, path: Optional[str] = None) -> tuple:
    """Scratch of :func:`radix_sort_pairs` for ``nb`` rows of ``n`` pairs,
    which also picks the kernel's path. ``"cta"``, one block per member
    with everything in shared memory, is the default up to the most pairs
    a block holds (``_build.SORT_CTA_MAX``; the crossover sweep on the card
    is in ``PERF.md`` §6) and needs no scratch: ``(tmp [2, nb, 0], state
    [0])``. ``"onesweep"`` needs the ping-pong keys and values ``tmp [2,
    nb, n]`` and ``state``: each member's digit histograms, tile counters
    and look-back words, zeroed (each call leaves them zero)."""
    if path is None:
        path = "cta" if n <= _build.SORT_CTA_MAX else "onesweep"
    if path not in SORT_PATHS:
        raise ValueError(f"unknown sort path {path!r} (expected one of {SORT_PATHS})")
    if path == "cta":
        if n > _build.SORT_CTA_MAX:
            raise ValueError(f"sort of {n} pairs: one block holds {_build.SORT_CTA_MAX}")
        return (torch.empty((2, nb, 0), dtype=torch.int32, device=device),
                torch.empty((0,), dtype=torch.int32, device=device))
    return (torch.empty((2, nb, n), dtype=torch.int32, device=device),
            torch.zeros((_sort_state_words(n, nb),), dtype=torch.int32, device=device))


def _sort_state_words(n: int, nb: int) -> int:
    return nb * (_build.SORT_HDR + 2 * 256 * _nblk(n, _build.SORT_TILE))


# Rows of one stage-1 tile (``wgl_stage1_hash``'s tile argument): the
# kernel takes these sizes, all on one scratch from :func:`stage1_scratch`;
# :func:`stage1_tile` picks one per call.
STAGE1_TILES = (2048, 4096, 8192)
# Rows of a member the two-stage compaction takes (its look-back counts
# are 30 bits).
STAGE1_MAX_M = (1 << 30) - 1


# The stage-1 scratch's header (csrc/wgl_level.cu S1_HDR): the call epoch,
# the ticket counter, the done counter and a pad word.
STAGE1_HDR = 4


def stage1_scratch(M: int, nb: int, device) -> torch.Tensor:
    """Scratch of the two-stage :func:`stage1_hash` over ``nb`` members of
    ``M`` rows, for the smallest tile of :data:`STAGE1_TILES`: the header
    (the call epoch, the ticket and done counters), then a 64-bit look-back
    word for each tile of each member. Zeroed here; every call leaves both
    counters zero and the epoch one higher, so an earlier call's words read
    as unpublished, whatever the shape of the next call."""
    return torch.zeros((_stage1_words(M, nb, min(STAGE1_TILES)),), dtype=torch.int32,
                       device=device)


def _stage1_words(M: int, nb: int, tile: int) -> int:
    return STAGE1_HDR + 2 * nb * _nblk(M, tile)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stage1_tile(M: int, nb: int, device) -> int:
    """The stage-1 tile of a call over ``nb`` members of ``M`` rows: the
    smallest tile whose grid has at most two blocks an SM (the main path's
    single member takes 2048, the batch's 8 x 262144 rows 8192: the fastest
    of each in ``chip_smoke.py``'s ``stage1_sweep`` on the H100)."""
    blocks = 2 * _sm_count(torch.device(device))
    return next((t for t in STAGE1_TILES if nb * _nblk(M, t) <= blocks), STAGE1_TILES[-1])


# Rows of one prune tile (a block, one row a thread): :func:`prune_tile`
# picks one per call, all on one scratch from :func:`prune_scratch`.
PRUNE_TILES = (256, 512, 1024)
# Rows of a member the prune takes (its look-back values are 30 bits).
PRUNE_MAX_L = (1 << 30) - 2
# Shared memory a block may take (H100: 227 KB).
_MAX_SMEM = 232448


def prune_scratch(L: int, nb: int, device) -> torch.Tensor:
    """Scratch of :func:`prune` over ``nb`` members of ``L`` rows, for the
    smallest tile of :data:`PRUNE_TILES`: the stage-1 scratch's layout (a
    header with the call epoch and the ticket and done counters, then a
    64-bit look-back word for each tile of each member). Zeroed here; every
    call leaves both counters zero and the epoch one higher, so one scratch
    serves calls of any shape."""
    return torch.zeros((_prune_words(L, nb, min(PRUNE_TILES)),), dtype=torch.int32,
                       device=device)


def _prune_words(L: int, nb: int, tile: int) -> int:
    return STAGE1_HDR + 2 * nb * _nblk(L, tile)


# Rows before its tile a prune block reads (csrc ``PR_HALO``).
PRUNE_HALO = 32


def _prune_smem(tile: int, NC: int, KO1: int) -> int:
    """The prune's dynamic shared memory (csrc ``pr_smem``)."""
    rows = tile + PRUNE_HALO
    return 4 * (rows * NC + rows + KO1) + rows


def prune_tile(L: int, nb: int, NC: int, KO1: int, device) -> int:
    """The prune tile of a call over ``nb`` members of ``L`` rows of ``NC``
    words: the smallest of :data:`PRUNE_TILES` whose grid has at most two
    blocks an SM, or the largest; halved while its rows do not fit a
    block's shared memory, down to the smallest (the wrapper refuses rows
    too wide for that)."""
    blocks = 2 * _sm_count(torch.device(device))
    tile = next((t for t in PRUNE_TILES if nb * _nblk(L, t) <= blocks), PRUNE_TILES[-1])
    while tile > PRUNE_TILES[0] and _prune_smem(tile, NC, KO1) > _MAX_SMEM:
        tile //= 2
    return tile


def gather_scratch(nb: int, device) -> torch.Tensor:
    """Scratch of :func:`gather_finalize` for ``nb`` members: one ticket
    counter a member, zero (each call leaves it zero: the member's last
    block resets its counter when it runs the finalize). A sharded
    search's :func:`chunk_init` takes its ticket from the first word (and
    leaves it zero too)."""
    return torch.zeros(nb, dtype=torch.int32, device=device)


# Rows of one route tile (``RT_THREADS`` times 1, 2 or 4 rows a thread):
# :func:`route_tile` picks one per call, all on one scratch from
# :func:`route_scratch`.
ROUTE_TILES = (512, 1024, 2048)
# Bucket slots a fill block of the route zeroes (csrc ``RT_FILL``).
ROUTE_FILL = 2048


def route_scratch(g: Geometry, device) -> torch.Tensor:
    """Scratch of :func:`route` for a sharded geometry, for the smallest
    tile of :data:`ROUTE_TILES`: the stage-1 scratch's layout (a header
    with the call epoch and the ticket and done counters, then a 64-bit
    look-back word for each tile of each (source, destination) pair).
    Zeroed here; every call leaves both counters zero and the epoch one
    higher, so one scratch serves calls of any shape."""
    return torch.zeros((_route_words(g.P, g.D, min(ROUTE_TILES)),), dtype=torch.int32,
                       device=device)


def _route_words(P: int, D: int, tile: int) -> int:
    return STAGE1_HDR + 2 * D * D * _nblk(P, tile)


def route_tile(P: int, D: int, device) -> int:
    """The route tile of a call over D shards of ``P`` stage-1 rows: the
    smallest of :data:`ROUTE_TILES` whose D * D tiles of data blocks are at
    most one block an SM, or the largest (sharded_10k's 8 x 2048 rows take
    1024, f_total 262144's 8 x 131072 rows 2048: the fastest of each in
    ``chip_smoke.py``'s timings on the H100, PERF.md)."""
    blocks = _sm_count(torch.device(device))
    return next((t for t in ROUTE_TILES if D * D * _nblk(P, t) <= blocks), ROUTE_TILES[-1])


def sort_path(scratch: tuple) -> str:
    """The path a :func:`radix_sort_pairs` call with ``scratch`` takes."""
    return "cta" if scratch[0].shape[-1] == 0 else "onesweep"


class BatchWorkspace:
    """Per-capacity buffers of the level pipeline for ``nb`` members,
    scratch included, made once (per rung) so a level allocates nothing."""

    def __init__(self, g: Geometry, nb: int, device):
        i32, u8 = torch.int32, torch.uint8
        L = g.L
        self.nb = nb
        self.rows = torch.zeros((nb, g.M, g.NC), dtype=i32, device=device)
        self.nvalid = torch.zeros((nb, g.M), dtype=u8, device=device)
        if g.exchange:
            # stage-1 rows, the exchanged rows (drows), the route's
            # look-back state (zero between calls)
            self.crows = torch.zeros((nb, g.P, g.NC), dtype=i32, device=device)
            self.drows = torch.zeros((nb, L, g.NC), dtype=i32, device=device)
            self.rvalid = torch.zeros((nb, L), dtype=u8, device=device)
            self.rt = route_scratch(g, device) if g.exchange == "alltoall" else None
            # the allgather's stage-1 keys, which the exchange copies
            self.ckey = (torch.zeros((nb, g.P), dtype=i32, device=device)
                         if g.exchange == "allgather" else None)
        else:
            self.drows = (torch.zeros((nb, g.P, g.NC), dtype=i32, device=device)
                          if g.two_stage else self.rows)
        self.fkey = torch.zeros((nb, L), dtype=i32, device=device)
        self.keys = torch.zeros((nb, L), dtype=i32, device=device)
        self.perm = torch.zeros((nb, L), dtype=i32, device=device)
        self.fprio = torch.zeros((nb, L), dtype=i32, device=device)
        self.ctl = torch.zeros((nb, CTL_SIZE), dtype=i32, device=device)
        self.stats = torch.zeros((nb, LEVEL_STAT_ROWS, 4), dtype=i32, device=device)
        self.sort = sort_scratch(L, device, nb)
        # the two-stage compaction's look-back state (zero between calls)
        self.s1 = stage1_scratch(g.M, nb, device) if g.two_stage else None
        # the prune's look-back state (zero between calls)
        self.pr = prune_scratch(L, nb, device)
        # the gather-finalize's tickets (zero between calls)
        self.gf = gather_scratch(nb, device)
        # the ladder table of a batch above CS_INLINE members, made at the
        # workspace's first chunk (a workspace serves one rung)
        self.ladder: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# u32 helpers for the plain versions (int64 carriers)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier of a u32 value -> int32 bit pattern."""
    return (x & M32).to(torch.int32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _ctz32(y: torch.Tensor) -> torch.Tensor:
    """Count of trailing zeros of a u32 (32 for 0)."""
    low = y & (-y)
    lg = torch.log2(low.clamp(min=1).to(torch.float64)).round().to(torch.int64)
    return torch.where(y == 0, torch.full_like(y, 32), lg)


def _go(ctl: torch.Tensor) -> bool:
    return bool(int(ctl[CTL_GO]))


# ---------------------------------------------------------------------------
# Plain versions, one member each (a member's views of the batched buffers)


def chunk_init_reference(ctl: torch.Tensor, valid: torch.Tensor,
                         stats: Optional[torch.Tensor], row: tuple) -> None:
    """One member's chunk start: its control block from ``row = (lvl0,
    max_levels, lossy, nD, nO)`` (every other field zero), its stats ring
    zeroed, its frontier count and stop test (reference ``ops/wgl.py:830-
    843``; acc, ovf and stuck start clear)."""
    lvl0, maxlvl, lossy, nD, nO = (int(x) for x in row)
    c = [0] * CTL_SIZE
    c[CTL_LVL], c[CTL_FMAX], c[CTL_MAXLVL], c[CTL_LOSSY] = lvl0, 1, maxlvl, int(bool(lossy))
    c[CTL_ND], c[CTL_NO] = nD, nO
    fcount = int(valid.sum())
    go = (not c[CTL_ACC] and (c[CTL_LOSSY] or not c[CTL_OVF]) and not c[CTL_STUCK]
          and fcount > 0 and c[CTL_LVL] < c[CTL_MAXLVL])
    c[CTL_FCOUNT], c[CTL_GO] = fcount, int(go)
    ctl.copy_(torch.tensor(c, dtype=torch.int32))
    if stats is not None:
        stats.zero_()


def ladder_row(ctl: torch.Tensor, trow: torch.Tensor, lpc: int) -> tuple:
    """One member's ``(lvl0, max_levels, lossy, nD, nO)`` from its ladder
    table row ``trow`` (updating its active flag) and its control block as
    the previous chunk left it: the batch ladder's rule. Before the rung's
    first chunk the member starts at its entry level; after it, where its
    last chunk ended, with ``lpc`` more levels (at most its total) while it
    is active (not accepted, not overflowed unless the rung is lossy,
    nonempty, not stuck, below its total), else with none."""
    t = [int(x) for x in trow.tolist()]
    total, lossy = t[CS_TOTAL], t[CS_LOSSY]
    if t[CS_ACTIVE] == CS_FRESH:
        lvl0, act = t[CS_ENTRY], 1
    else:
        c = ctl.tolist()
        lvl0 = c[CTL_LVL]
        act = int(bool(t[CS_ACTIVE]) and not c[CTL_ACC] and (lossy or not c[CTL_OVF])
                  and c[CTL_FCOUNT] > 0 and not c[CTL_STUCK] and lvl0 < total)
    trow[CS_ACTIVE] = act
    return lvl0, min(total, lvl0 + lpc) if act else lvl0, lossy, t[CS_ND], t[CS_NO]


def chunk_rows(lvl0, max_levels, lossy, nD, nO) -> list:
    """The chunk start's initial values, one ``(lvl0, max_levels, lossy, nD,
    nO)`` row a member (integers), or a single row when every member's is
    the same (a sharded search's shards, a single search)."""
    rows = [(int(a), int(b), int(bool(c)), int(d), int(e))
            for a, b, c, d, e in zip(lvl0, max_levels, lossy, nD, nO)]
    return rows if len(set(rows)) > 1 else rows[:1]


def ladder_table(lvl0, totals, lossy, nD, nO, device) -> torch.Tensor:
    """The ladder table of a rung (int32 ``[nb, CS_TW]``): each member's
    entry level, total levels, beam flag and op counts, every member not
    yet started (:func:`ladder_row`)."""
    t = torch.zeros((len(totals), CS_TW), dtype=torch.int32)
    for k, col in ((CS_ENTRY, lvl0), (CS_TOTAL, totals), (CS_ND, nD), (CS_NO, nO)):
        t[:, k] = torch.as_tensor([int(x) for x in col], dtype=torch.int32)
    t[:, CS_LOSSY] = torch.as_tensor([int(bool(x)) for x in lossy], dtype=torch.int32)
    t[:, CS_ACTIVE] = CS_FRESH
    return t.to(device)


def expand_reference(g: Geometry, tabs: dict, fr: tuple, ctl: torch.Tensor,
                     rows: torch.Tensor, nvalid: torch.Tensor, model: Model,
                     fkey: Optional[torch.Tensor] = None) -> None:
    """Plain version of ``k_expand`` (reference ``ops/wgl.py:363-490``) for
    one member; the model step is ``model.step_torch``. With ``fkey`` (a
    single-stage level: no stage 1) each row's fused key too (``:628-645``):
    a valid row's FNV group hash shifted right by one, an invalid slot's
    :data:`KEY_INVALID` (the kernel does not write such a row, so its key
    does not hash it; no stage reads it)."""
    if not _go(ctl):
        return
    p, mD, mO, st, valid = fr
    dev = p.device
    F, W, KD, KO, C = g.F, g.W, g.KD, g.KO, g.C
    nD, nO = int(ctl[CTL_ND]), int(ctl[CTL_NO])
    OB = 32 * KO
    i64 = torch.int64
    tabD, sufret = tabs["tabD"], tabs["sufret"]
    slots = torch.arange(W, device=dev, dtype=i64)
    p64 = p.to(i64)
    rws = p64[:, None] + slots[None, :]
    in_rng = rws < nD
    win = tabD[rws.clamp(max=g.ND - 1)].to(i64)  # [F, W, 8]
    big = torch.full_like(rws, INT32_MAX)
    invw = torch.where(in_rng, win[..., 0], big)
    retw = torch.where(in_rng, win[..., 1], big)
    mDu = _u32(mD)
    bits = (mDu[:, slots // 32] >> (slots % 32)) & 1
    unlin = in_rng & (bits == 0)
    vals = torch.where(unlin, retw, big)
    m1 = vals.min(dim=1).values
    am = torch.where(vals == m1[:, None], slots[None, :],
                     torch.full_like(rws, W)).min(dim=1).values
    is_am = slots[None, :] == am[:, None]
    m2 = torch.where(is_am, big, vals).min(dim=1).values
    tail = sufret.to(i64)[(p64 + W).clamp(max=nD)]
    minret_all = torch.minimum(m1, tail)
    minret_excl = torch.minimum(torch.where(is_am, m2[:, None], m1[:, None]),
                                tail[:, None])
    cand_D = unlin & (invw < minret_excl)
    opw = torch.where(in_rng, win[..., 2], 0)
    a1w = torch.where(in_rng, win[..., 3], 0)
    a2w = torch.where(in_rng, win[..., 4], 0)
    if KO:
        oslots = torch.arange(OB, device=dev, dtype=i64)
        oc = oslots.clamp(max=g.NO - 1)
        o_in = (oslots < nO)[None, :]
        invo = torch.where(o_in, tabs["invO"].to(i64)[oc][None, :],
                           torch.full((1, OB), INT32_MAX, dtype=i64, device=dev))
        obits = (_u32(mO)[:, oslots // 32] >> (oslots % 32)) & 1
        cand_O = o_in & (obits == 0) & (invo < minret_all[:, None])
        rep = lambda t: t.to(i64)[oc][None, :].expand(F, OB)
        opc = torch.cat([opw, rep(tabs["opO"])], dim=1)
        a1c = torch.cat([a1w, rep(tabs["a1O"])], dim=1)
        a2c = torch.cat([a2w, rep(tabs["a2O"])], dim=1)
        candv = torch.cat([cand_D, cand_O], dim=1)
    else:
        opc, a1c, a2c, candv = opw, a1w, a2w, cand_D
    candv = candv & valid.bool()[:, None]
    CC = g.B
    allslots = torch.arange(C, device=dev, dtype=i64)[None, :].expand(F, C)
    row_ovf = False
    if g.SEL:
        row_ovf = bool((candv.sum(dim=1) > g.B).any())
        # candidates first, in slot order
        sel = torch.argsort((~candv).to(torch.int8), dim=1, stable=True)[:, :CC]
        cand = torch.gather(candv, 1, sel)
        slot = torch.gather(allslots, 1, sel)
        opc, a1c, a2c = (torch.gather(x, 1, sel) for x in (opc, a1c, a2c))
    else:
        cand, slot = candv, allslots
    M = F * CC
    words = []  # new window-mask words, [F, CC] each
    for w in range(KD):
        hit = (slot < W) & (slot // 32 == w)
        words.append(mDu[:, w:w + 1] | torch.where(hit, 1 << (slot % 32), 0))
    owords = [torch.zeros_like(slot)]  # KO == 0: one all-zero open column
    if KO:
        mOu, oslot = _u32(mO), slot - W
        owords = [mOu[:, w:w + 1] | torch.where(
            (oslot >= 0) & (oslot // 32 == w), 1 << (oslot % 32), 0)
            for w in range(KO)]
    st_rep = st[:, None, :].expand(F, CC, g.S).reshape(M, g.S)
    ok, st2 = model.step_torch(st_rep, opc.reshape(M).to(torch.int32),
                               a1c.reshape(M).to(torch.int32), a2c.reshape(M).to(torch.int32))
    cand = cand.reshape(M) & ok
    words = [w_.reshape(M) for w_ in words]
    owords = [w_.reshape(M) for w_ in owords]
    # trailing ones across the KD words, then the multi-word right shift
    s = torch.zeros(M, dtype=i64, device=dev)
    carry = torch.ones(M, dtype=torch.bool, device=dev)
    for w in range(KD):
        t1 = _ctz32((~words[w]) & M32)
        s = s + torch.where(carry, t1, 0)
        carry = carry & (t1 == 32)
    np_ = p64[:, None].expand(F, CC).reshape(M) + s
    sw, sb = s // 32, s % 32
    zero = torch.zeros(M, dtype=i64, device=dev)
    wstack = torch.stack(words + [zero], dim=1)  # [M, KD+1], last = 0

    def word_at(k):
        return torch.gather(wstack, 1, k.clamp(max=KD)[:, None])[:, 0]

    shifted = []
    for w in range(KD):
        lo = word_at(w + sw)
        hi = word_at(w + sw + 1)
        shifted.append((lo >> sb) | torch.where(sb == 0, 0, (hi << (32 - sb)) & M32))
    cols = [np_] + shifted + [st2[:, i].to(i64) for i in range(g.S)] + owords
    rows.copy_(_i32(torch.stack(cols, dim=1)))
    nvalid.copy_(cand.to(torch.uint8))
    if fkey is not None:
        fkey.copy_(_i32(torch.where(cand, _fnv(rows[:, :g.NID]) >> 1, KEY_INVALID)))
    n_exp = int(cand.sum())
    acc_now = bool((cand & (np_ >= nD)).any())
    ctl[CTL_NEXP] += n_exp
    ctl[CTL_ACCNOW] |= int(acc_now)
    ctl[CTL_ROWOVF] |= int(row_ovf)


def _fnv(idcols: torch.Tensor) -> torch.Tensor:
    """FNV-1a-style group hash of each row's identity columns (u32 in
    int64)."""
    gh = torch.full((idcols.shape[0],), 2166136261, dtype=torch.int64,
                    device=idcols.device)
    for c in range(idcols.shape[1]):
        gh = ((gh ^ _u32(idcols[:, c])) * 16777619) & M32
    return gh


def _fnv_fkey(idcols: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    gh = _fnv(idcols)
    return _i32(torch.where(valid, gh >> 1, (gh >> 1) | KEY_INVALID))


def zero_row_key(NID: int) -> int:
    """The fused key of an invalid row of ``NID`` zero words (int32 bit
    pattern): the key of a received buffer's empty slot."""
    gh = 2166136261
    for _ in range(NID):
        gh = (gh * 16777619) & M32
    return ((gh >> 1) | KEY_INVALID) - (1 << 32)


def stage1_hash_reference(g: Geometry, rows: torch.Tensor, nvalid: torch.Tensor,
                          ctl: torch.Tensor, drows: torch.Tensor,
                          fkey: torch.Tensor, scratch: Optional[torch.Tensor] = None) -> None:
    """Plain version of ``wgl_stage1_hash`` (reference ``ops/wgl.py:523-549``
    and ``:628-645``) for a two-stage level (a single-stage level's keys
    come from the expand). ``scratch`` is the kernel's, unused here. With
    ``fkey`` None (an alltoall level) only the compaction runs; in an
    allgather level only the survivors' keys are written (the exchange
    gives the other received rows the zero row's key). The rows after the
    valid ones get the invalid rows here and stay as they were in the
    kernel; only the valid prefix and the keys' sign bits are the contract
    there."""
    if not g.two_stage:
        raise ValueError("stage1_hash: a single-stage level has no stage 1 (the expand "
                         "writes its keys)")
    if not _go(ctl):
        return
    nv = nvalid.bool()
    idx = torch.argsort((~nv).to(torch.int8), stable=True)[:g.P]
    drows.copy_(rows[idx])
    n = min(int(ctl[CTL_NEXP]), g.P)
    valid = torch.arange(g.P, device=rows.device) < n
    if fkey is not None:
        keys = _fnv_fkey(drows[:, :g.NID], valid)
        if g.exchange:
            fkey[:n] = keys[:n]
        else:
            fkey.copy_(keys)


def hash_rows_reference(g: Geometry, drows: torch.Tensor, rvalid: torch.Tensor,
                        ctl: torch.Tensor, fkey: torch.Tensor) -> None:
    """Group hash and fused key of a level's rows in place, validity from
    ``rvalid`` (reference ``ops/wgl.py:612-645``): the keys the route and
    the exchange write with a sharded level's received rows, and the keys
    the expand writes with a single-stage level's valid rows. No stage runs
    it: the yardstick the tests hold those keys against."""
    if not _go(ctl):
        return
    fkey.copy_(_fnv_fkey(drows[:, :g.NID], rvalid.bool()))


def route_reference(g: Geometry, crows: torch.Tensor, ctl: torch.Tensor,
                    send: torch.Tensor, svalid: torch.Tensor, skey: torch.Tensor) -> None:
    """One shard's owner routing into send buckets, a restatement of the
    reference's (``ops/wgl.py:551-590``): owner = FNV of the identity
    columns mod D, a stable (owner, position) order, fixed buckets of
    ``PBK`` rows, the bucket overflow into the row-overflow flag. Empty
    slots are zeros. ``skey``: each slot's fused key, a routed row's owner
    hash shifted right by one, an empty slot's the zero row's key. The
    first half of :func:`route_plain`."""
    if not _go(ctl):
        return
    D, P, PBK = g.D, g.P, g.PBK
    dev = crows.device
    n = min(int(ctl[CTL_NEXP]), P)
    nv = torch.arange(P, device=dev) < n
    gh = _fnv(crows[:, :g.NID])
    owner = gh % D
    okey = torch.where(nv, owner, torch.full_like(owner, D))
    sidx = torch.argsort(okey, stable=True)
    cnt = torch.bincount(owner[nv], minlength=D)
    off = torch.cumsum(cnt, 0) - cnt
    if bool((cnt > PBK).any()):
        ctl[CTL_ROWOVF] = 1
    slot = torch.arange(D * PBK, device=dev)
    d_of, j_of = slot // PBK, slot % PBK
    bvalid = j_of < cnt[d_of]
    bsrc = sidx[(off[d_of] + j_of).clamp(max=P - 1)]
    send.copy_(crows[bsrc] * bvalid[:, None].to(torch.int32))
    svalid.copy_(bvalid)
    skey.copy_(torch.where(bvalid, _i32(gh[bsrc] >> 1), zero_row_key(g.NID)))


def collective_plain(g: Geometry, send: torch.Tensor, svalid: Optional[torch.Tensor],
                     ctl: torch.Tensor, recv: torch.Tensor, rvalid: torch.Tensor,
                     skey: torch.Tensor, fkey: torch.Tensor) -> None:
    """The reference's tiled collectives between the D shards' buffers
    (``ops/wgl.py:592-611``): alltoall (``svalid``: the send buckets'
    validity) ``recv[d][s*PBK + j] = send[s][d*PBK + j]``, allgather
    (``svalid`` None) ``recv[d][s*P + j] = send[s][j]`` (the stage-1 rows,
    valid below each source's ``min(n_cand, P)``). Invalid rows are zeros;
    a stopped destination is not written. The send side's keys ``skey`` go
    along into ``fkey``, an invalid row's the zero row's key. The second
    half of :func:`route_plain`, and :func:`exchange_plain`."""
    D = g.D
    a2a = g.exchange == "alltoall"
    Bk = g.PBK if a2a else g.P
    for d in range(D):
        if not _go(ctl[d]):
            continue
        lo = d * Bk if a2a else 0
        for s_ in range(D):
            if svalid is not None:
                v = svalid[s_, lo:lo + Bk].bool()
            else:
                n = min(int(ctl[s_, CTL_NEXP]), g.P)
                v = torch.arange(Bk, device=send.device) < n
            recv[d, s_ * Bk:(s_ + 1) * Bk] = send[s_, lo:lo + Bk] * v[:, None].to(torch.int32)
            rvalid[d, s_ * Bk:(s_ + 1) * Bk] = v
            fkey[d, s_ * Bk:(s_ + 1) * Bk] = torch.where(v, skey[s_, lo:lo + Bk],
                                                        zero_row_key(g.NID))


def _shard_kept(g: Geometry, count_local: int, count: int, s: int) -> int:
    if g.exchange == "alltoall":
        return min(count_local, g.F)
    return max(0, min(min(count, g.F * g.D) - s * g.F, g.F))


def shard_reduce_plain(g: Optional[Geometry], ctl: torch.Tensor, stage: int) -> None:
    """The cross-shard reductions over the D control blocks, written to
    every shard's block: the plain version of the reduce in the last block
    of the sharded :func:`chunk_init` (``stage`` 0, a chunk's start,
    reference ``ops/wgl.py:830-836``: the global nonempty and the stop
    test; ``g`` is not read) and of the sharded :func:`prune` (``stage``
    1: the pmax of acc_now (``:490``) and pre_ovf (``:612``), the keep
    count (psum under alltoall, ``:697``) and its overflow, and the
    frontier count each shard holds after the level (``:877-890``))."""
    c = ctl.tolist()
    c0 = c[0]
    if stage == 0:
        fc = [r[CTL_FCOUNT] for r in c]
        go = (not c0[CTL_ACC] and (c0[CTL_LOSSY] or not c0[CTL_OVF]) and not c0[CTL_STUCK]
              and sum(fc) > 0 and c0[CTL_LVL] < c0[CTL_MAXLVL])
        for r in c:
            r[CTL_NSUM], r[CTL_NMAX], r[CTL_NMIN], r[CTL_GO] = sum(fc), max(fc), min(fc), int(go)
    else:
        if not c0[CTL_GO]:
            return
        D, F = g.D, g.F
        acc = int(any(r[CTL_ACCNOW] for r in c))
        pre = any(r[CTL_ROWOVF] or r[CTL_NEXP] > g.P for r in c)
        if g.exchange == "alltoall":
            count = sum(r[CTL_COUNT] for r in c)
            ovf_now = pre or any(r[CTL_COUNT] > F for r in c)
        else:
            count = c0[CTL_COUNT]
            ovf_now = pre or count > F * D
        dead = (ovf_now and not c0[CTL_LOSSY]) or count == 0
        fc = [r[CTL_FCOUNT] if dead else _shard_kept(g, r[CTL_COUNT], count, s_)
              for s_, r in enumerate(c)]
        for r in c:
            r[CTL_ACCNOW], r[CTL_GCOUNT], r[CTL_GOVF] = acc, count, int(ovf_now)
            r[CTL_NSUM], r[CTL_NMAX], r[CTL_NMIN] = sum(fc), max(fc), min(fc)
    ctl.copy_(torch.tensor(c, dtype=torch.int32))


def take_col_reference(src: torch.Tensor, col: int, idx: torch.Tensor,
                       out: torch.Tensor, ctl: Optional[torch.Tensor] = None) -> None:
    if ctl is not None and not _go(ctl):
        return
    src2 = src if src.dim() == 2 else src[:, None]
    out.copy_(src2[idx.long(), col])


def take_col_sort_reference(src: torch.Tensor, col: int, keys: torch.Tensor,
                            vals: torch.Tensor, ctl: Optional[torch.Tensor] = None,
                            ident: bool = False) -> None:
    """Plain version of ``wgl_take_col_sort`` for one member: ``vals``
    becomes the identity when ``ident``, then the take of the key column
    through it and the stable sort of ``(keys, vals)``."""
    if ctl is not None and not _go(ctl):
        return
    if ident:
        vals.copy_(torch.arange(vals.shape[0], dtype=vals.dtype, device=vals.device))
    take_col_reference(src, col, vals, keys)
    radix_sort_pairs_reference(keys, vals)


def radix_sort_pairs_reference(keys: torch.Tensor, vals: torch.Tensor,
                               scratch: Optional[tuple] = None,
                               ctl: Optional[torch.Tensor] = None) -> None:
    """Stable ascending sort of (u32 key, u32 value) pairs, in place.
    ``scratch`` is the kernel's (see :func:`sort_scratch`), unused here."""
    if ctl is not None and not _go(ctl):
        return
    order = torch.argsort(_u32(keys), stable=True)
    keys.copy_(keys[order])
    vals.copy_(vals[order])


def prune_reference(g: Geometry, drows: torch.Tensor, skey: torch.Tensor,
                    perm: torch.Tensor, ctl: torch.Tensor, fprio: torch.Tensor,
                    scratch: Optional[torch.Tensor] = None) -> None:
    """Plain version of ``wgl_prune`` (reference ``ops/wgl.py:657-736``).
    ``scratch`` is the kernel's (see :func:`prune_scratch`), unused here."""
    if not _go(ctl):
        return
    dev = drows.device
    L = skey.shape[0]
    cols = _u32(drows[perm.long()])  # [L, NC] in sorted order
    idc = cols[:, :g.NID]
    oc = cols[:, g.NID:]
    svalid = (_u32(skey) >> 31) == 0
    prev_valid = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), svalid[:-1]])
    same = svalid & prev_valid
    same[1:] &= (idc[1:] == idc[:-1]).all(dim=1)
    prev_sub = same.clone()
    prev_sub[1:] &= ((oc[:-1] & ~oc[1:] & M32) == 0).all(dim=1)
    is_start = svalid & ~same
    iota = torch.arange(L, device=dev)
    seg = torch.cummax(torch.where(is_start, iota, torch.full_like(iota, -1)), dim=0).values
    head = oc[seg.clamp(min=0)]
    head_sub = svalid & ~is_start & ((head & ~oc & M32) == 0).all(dim=1)
    keep = svalid & ~(same & prev_sub) & ~head_sub
    opc_used = _popcount(oc).sum(dim=1)
    PB = g.PB
    maxp = (1 << PB) - 1
    fp = ((~keep).to(torch.int64) << (PB + 6)) \
        | ((((maxp - cols[:, 0]) & M32) << 6) & M32) \
        | opc_used.clamp(max=63)
    fprio.copy_(_i32(fp))
    ctl[CTL_COUNT] += int(keep.sum())


def _level_outcome(g: Geometry, c: list) -> tuple:
    """(ovf_now, dead, stuck_now, kept) from a level's counters — the
    reference's ``ops/wgl.py:711-712`` and ``:791-797``."""
    count = c[CTL_COUNT]
    pre_ovf = bool(c[CTL_ROWOVF]) or (g.two_stage and c[CTL_NEXP] > g.P)
    ovf_now = pre_ovf or count > g.F
    lossy = c[CTL_LOSSY] != 0
    stuck_now = count == 0 and not (ovf_now and not lossy)
    dead = (ovf_now and not lossy) or count == 0
    return ovf_now, dead, stuck_now, min(count, g.F)


def _sharded_outcome(g: Geometry, c: list, s: int) -> tuple:
    """(ovf_now, dead, stuck_now, kept, offset) of shard ``s`` from the
    replicated fields the prune's reduce wrote (reference
    ``ops/wgl.py:697-711``, ``:743-757``, ``:791-797``)."""
    count, ovf_now = c[CTL_GCOUNT], bool(c[CTL_GOVF])
    lossy = c[CTL_LOSSY] != 0
    stuck_now = count == 0 and not (ovf_now and not lossy)
    dead = (ovf_now and not lossy) or count == 0
    off = s * g.F if g.exchange == "allgather" else 0
    return ovf_now, dead, stuck_now, _shard_kept(g, c[CTL_COUNT], count, s), off


def gather_finalize_reference(g: Geometry, drows: torch.Tensor, perm: torch.Tensor,
                              ctl: torch.Tensor, stats: torch.Tensor, fr: tuple,
                              shard: int = 0) -> None:
    """Plain version of ``wgl_gather_finalize`` (reference
    ``ops/wgl.py:741-843``) for one member: top-F gather into the frontier
    unless the level is dead, then the loop carry, stats row and stop test.
    ``perm`` holds the rows in compaction order (the compaction sort
    carries the dedup order as its values). In a sharded level ``shard``
    is the member's index, the outcome is the replicated one and no stats
    row is written."""
    if not _go(ctl):
        return
    c = ctl.tolist()
    if g.exchange:
        ovf_now, dead, stuck_now, kept, off = _sharded_outcome(g, c, shard)
    else:
        ovf_now, dead, stuck_now, kept = _level_outcome(g, c)
        off = 0
    if not dead:
        p, mD, mO, st, valid = fr
        kvalid = torch.arange(g.F, device=drows.device) < kept
        src = perm.long()[off:off + g.F]
        rows = drows[src] * kvalid[:, None].to(torch.int32)
        KD, S = g.KD, g.S
        p.copy_(rows[:, 0])
        mD.copy_(rows[:, 1:1 + KD])
        st.copy_(rows[:, 1 + KD:1 + KD + S])
        mO.copy_(rows[:, 1 + KD + S:])
        valid.copy_(kvalid)
    lvl = c[CTL_LVL]
    fcount = c[CTL_FCOUNT] if dead else kept
    if g.exchange:
        fm, nonempty = min(c[CTL_GCOUNT], g.F * g.D), c[CTL_NSUM] > 0
    else:
        fm, nonempty = kept, fcount > 0
        stats[(lvl + 1) % LEVEL_STAT_ROWS] = torch.tensor(
            [lvl + 1, kept, c[CTL_NEXP], int(ovf_now)], dtype=torch.int32)
    acc = c[CTL_ACC] | c[CTL_ACCNOW]
    ovf = c[CTL_OVF] | int(ovf_now)
    stuck = c[CTL_STUCK] | int(stuck_now)
    lvl2 = lvl if dead else lvl + 1
    go = (not acc and (c[CTL_LOSSY] or not ovf) and not stuck and nonempty
          and lvl2 < c[CTL_MAXLVL])
    c[CTL_LVL], c[CTL_ACC], c[CTL_OVF] = lvl2, acc, ovf
    c[CTL_FMAX] = max(c[CTL_FMAX], fm)
    c[CTL_STUCK], c[CTL_FCOUNT], c[CTL_GO] = stuck, fcount, int(go)
    c[CTL_NEXP] = c[CTL_ACCNOW] = c[CTL_ROWOVF] = c[CTL_COUNT] = 0
    ctl.copy_(torch.tensor(c, dtype=torch.int32))


def regroup_reference(fr: tuple, idx, F_new: int) -> tuple:
    """Plain version of ``wgl_regroup`` (reference ``parallel/batch.py:95``
    ``_regroup_program``): the members ``idx`` of the stacked frontier
    ``fr`` (five ``[nb, F_old, ...]`` arrays), zero-padded on the capacity
    axis to ``F_new``. An index may repeat."""
    ix = torch.as_tensor(list(idx), dtype=torch.long, device=fr[0].device)
    out = []
    for a in fr:
        o = torch.zeros((len(ix), F_new) + tuple(a.shape[2:]), dtype=a.dtype,
                        device=a.device)
        o[:, : a.shape[1]] = a[ix]
        out.append(o)
    return tuple(out)


# ---------------------------------------------------------------------------
# Plain batched stages: one member's plain stage, run once per member


def _member(a, b: int):
    if isinstance(a, torch.Tensor):
        return a[b]
    if isinstance(a, dict):
        return {k: v[b] for k, v in a.items()}
    if isinstance(a, tuple):
        return tuple(_member(x, b) for x in a)
    return a


def _members(args) -> int:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.shape[0]
        if isinstance(a, (dict, tuple)):
            vals = a.values() if isinstance(a, dict) else a
            n = _members(vals)
            if n is not None:
                return n
    return None


def vmap_members(ref):
    """The batched plain version of a one-member plain stage: ``ref`` run
    once per member on member views of every batched argument (tensors,
    and dicts or tuples of them; anything else is passed as it is). This
    is what the reference's ``vmap`` means; the CPU path and ``plain=True``
    use it."""

    def run(*args):
        for b in range(_members(args)):
            ref(*(_member(a, b) for a in args))

    run.__name__ = ref.__name__.replace("_reference", "_plain")
    run.__doc__ = f"Per-member loop of :func:`{ref.__name__}`."
    return run


def chunk_init_plain(ctl: torch.Tensor, valid: torch.Tensor, stats: Optional[torch.Tensor],
                     rows: Optional[list], ticket: Optional[torch.Tensor] = None,
                     table: Optional[torch.Tensor] = None, lpc: int = 0) -> None:
    """Per-member loop of :func:`chunk_init_reference`: member ``b`` takes
    ``rows[b]`` (``rows[0]`` when there is one row), or with ``rows=None``
    its :func:`ladder_row` from ``table`` and ``lpc``. With ``ticket`` (a
    sharded search, its members the shards; the kernel's ticket word, not
    used here) then the chunk-start reduce (:func:`shard_reduce_plain`,
    stage 0)."""
    nb = ctl.shape[0]
    if rows is None:
        rows = [ladder_row(ctl[b], table[b], lpc) for b in range(nb)]
    for b in range(nb):
        chunk_init_reference(ctl[b], valid[b], None if stats is None else stats[b],
                             rows[0 if len(rows) == 1 else b])
    if ticket is not None:
        shard_reduce_plain(None, ctl, 0)


expand_plain = vmap_members(expand_reference)
stage1_hash_plain = vmap_members(stage1_hash_reference)
take_col_plain = vmap_members(take_col_reference)


def take_col_sort_plain(src: torch.Tensor, col: int, keys: torch.Tensor, vals: torch.Tensor,
                        scratch: Optional[tuple] = None, ctl: Optional[torch.Tensor] = None,
                        ident: bool = False) -> None:
    """Per-member loop of :func:`take_col_sort_reference`: ``take_col_plain``
    then ``radix_sort_pairs_plain`` (the kernel's scratch is not
    member-major and is not used)."""
    vmap_members(take_col_sort_reference)(src, col, keys, vals, ctl, ident)


def prune_plain(g: Geometry, drows, skey, perm, ctl, fprio, scratch=None) -> None:
    """Per-member loop of :func:`prune_reference` (the kernel's scratch is
    not member-major and is not used); in a sharded level then the
    cross-shard reduce (:func:`shard_reduce_plain`, stage 1)."""
    vmap_members(prune_reference)(g, drows, skey, perm, ctl, fprio, None)
    if g.exchange:
        shard_reduce_plain(g, ctl, 1)


def route_plain(g: Geometry, crows, ctl, drows, rvalid, scratch, fkey) -> None:
    """Plain version of ``wgl_route`` over all D shards: each shard's
    :func:`route_reference` into send buckets of its own (zeros, and the
    zero row's keys), then the tiled all_to_all of the buckets and their
    keys into the receive rows and ``fkey`` (:func:`collective_plain`).
    The kernel's scratch is not used."""
    sr = g.D * g.PBK
    send = torch.zeros((g.D, sr, g.NC), dtype=torch.int32, device=crows.device)
    svalid = torch.zeros((g.D, sr), dtype=torch.uint8, device=crows.device)
    skey = torch.full((g.D, sr), zero_row_key(g.NID), dtype=torch.int32, device=crows.device)
    vmap_members(route_reference)(g, crows, ctl, send, svalid, skey)
    collective_plain(g, send, svalid, ctl, drows, rvalid, skey, fkey)


def exchange_plain(g: Geometry, crows, ctl, recv, rvalid, skey, fkey) -> None:
    """Plain version of ``wgl_exchange``: the tiled all_gather of the
    stage-1 rows and of their keys ``skey`` (stage 1's) into ``fkey``
    (:func:`collective_plain`)."""
    collective_plain(g, crows, None, ctl, recv, rvalid, skey, fkey)


def gather_finalize_plain(g: Geometry, drows, perm, ctl, stats, fr, scratch=None) -> None:
    """Per-member loop of :func:`gather_finalize_reference` (each shard's
    index passed along in a sharded level; the kernel's scratch is not
    used)."""
    for b in range(ctl.shape[0]):
        gather_finalize_reference(g, *(_member(a, b) for a in (drows, perm, ctl, stats, fr)),
                                  shard=b)


def radix_sort_pairs_plain(keys: torch.Tensor, vals: torch.Tensor,
                           scratch: Optional[tuple] = None,
                           ctl: Optional[torch.Tensor] = None) -> None:
    """Per-member loop of :func:`radix_sort_pairs_reference` (the kernel's
    scratch is not member-major and is not used)."""
    vmap_members(radix_sort_pairs_reference)(keys, vals, None, ctl)


# ---------------------------------------------------------------------------
# Kernel wrappers: one launch per stage for the whole batch


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check_cuda(*ts: Optional[torch.Tensor]) -> None:
    dev = None
    for t in ts:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"kernel argument on {t.device}, expected cuda")
        if not t.is_contiguous():
            raise ValueError("kernel argument must be contiguous")
        if t.dtype not in (torch.int32, torch.uint8, torch.bool):
            raise ValueError(f"kernel argument dtype {t.dtype} not supported")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError("kernel arguments on different devices")


def _check_shapes(name: str, *pairs) -> None:
    """Each ``(tensor, shape)`` pair must match exactly."""
    for t, shape in pairs:
        if t.shape != shape:
            raise ValueError(f"{name}: buffer of shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")


def _check_members(nb: int) -> None:
    if not 1 <= nb <= MAX_MEMBERS:
        raise ValueError(f"batch of {nb} members; the kernels take 1..{MAX_MEMBERS}")


def _launch(name: str, *args) -> None:
    fn = getattr(_build.load(), name)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({_build.error_string(rc)})")
    LAUNCHES[name] += 1


def chunk_init(ctl: torch.Tensor, valid: torch.Tensor, stats: Optional[torch.Tensor],
               rows: Optional[list], ticket: Optional[torch.Tensor] = None,
               table: Optional[torch.Tensor] = None, lpc: int = 0) -> None:
    """The whole start of a chunk, one launch (``ctl [nb, CTL_SIZE]``,
    ``valid [nb, F]``, ``stats [nb, ...]`` each member's stats ring): each
    member's control block from ``rows`` (:func:`chunk_rows`: one row for
    every member, or a row a member up to :data:`CS_INLINE`; they ride in
    the launch's parameters, so nothing is copied to the card), or with
    ``rows=None`` from the ladder ``table`` (:func:`ladder_table`, on the
    card) and ``lpc``; its stats ring zeroed; its frontier count and stop
    test. With ``ticket`` (a sharded search: its members are the shards;
    ``BatchWorkspace.gf``, whose first word must be zero and is left zero)
    the same launch's last block also runs the chunk-start reduce over the
    shards."""
    if ctl.device.type == "cpu":
        return chunk_init_plain(ctl, valid, stats, rows, ticket, table, lpc)
    _launch("wgl_chunk_init", *_chunk_init_args(ctl, valid, stats, rows, ticket, table, lpc))


def _chunk_init_args(ctl, valid, stats, rows, ticket=None, table=None, lpc=0) -> tuple:
    nb, F = valid.shape
    if rows is not None and (len(rows) not in (1, nb) or len(rows) > CS_INLINE):
        raise ValueError(f"chunk_init: {len(rows)} rows for {nb} members; the launch "
                         f"takes one row or a row a member up to {CS_INLINE} (a larger "
                         "batch of the ladder reads its ladder table)")
    _check_cuda(ctl, valid, stats, ticket, table)
    _check_members(nb)
    _check_shapes("chunk_init", (ctl, (nb, CTL_SIZE)),
                  *(((table, (nb, CS_TW)),) if table is not None else ()))
    if stats is not None and (stats.dtype != torch.int32 or stats.shape[0] != nb):
        raise ValueError("chunk_init: the stats rings are int32 [nb, ...]")
    stat_words = 0 if stats is None else stats.numel() // nb
    if ticket is not None and (ticket.dtype != torch.int32 or ticket.numel() < 1):
        raise ValueError("chunk_init: the ticket is one int32 word (see gather_scratch)")
    if rows is None:
        if table is None:
            raise ValueError("chunk_init: no rows and no ladder table")
        host = (ctypes.c_int * 1)()
    else:
        flat = [v for r in rows for v in r]
        host = (ctypes.c_int * len(flat))(*flat)
    ci = ctypes.c_int
    # the host array is an argument itself, so it lives through the call
    return (_ptr(ctl), _ptr(valid), _ptr(stats), _ptr(ticket), _ptr(table), host,
            ci(0 if rows is None else len(rows)), ci(lpc), ci(stat_words), ci(F), ci(nb),
            _stream())


# The model steps ``k_expand`` inlines, by class: (step id, the attribute
# holding the step's one behaviour parameter). A class that is not here —
# a subclass included, since it may change the step — has no kernel step.
_KERNEL_STEPS = {
    CasRegister: (0, None), Register: (0, None), MultiRegister: (1, None),
    Counter: (2, None), LwSet: (3, None), Bank: (4, None), Mutex: (5, None),
    OwnerAwareMutex: (6, None), ReentrantMutex: (7, "max_depth"),
    FencedMutex: (8, None), ReentrantFencedMutex: (9, "LOCK_LIMIT"),
    Semaphore: (10, "capacity"),
}


def step_spec(model: Model) -> tuple:
    """``(step id, parameter)`` of ``model``'s step in ``k_expand``: the
    ``STEP_*`` id of ``csrc/wgl_level.cu`` and the one int parameter the
    step reads (0 where it reads none). Raises ``ValueError`` for a model
    the kernel does not implement."""
    spec = _KERNEL_STEPS.get(type(model))
    if spec is None:
        raise ValueError(f"the CUDA expand kernel has no step for model "
                         f"{type(model).__name__} ({getattr(model, 'name', '?')!r})")
    sid, attr = spec
    prm = 0 if attr is None else int(getattr(model, attr))
    if not -2**31 <= prm < 2**31:
        raise ValueError(f"{type(model).__name__}.{attr} = {prm} does not fit in int32")
    return sid, prm


def expand(g: Geometry, tabs: dict, fr: tuple, ctl: torch.Tensor,
           rows: torch.Tensor, nvalid: torch.Tensor, model: Model,
           fkey: Optional[torch.Tensor] = None) -> None:
    """Stage K1 (see module docstring). The kernel inlines ``model``'s
    step (:func:`step_spec`). ``fkey [nb, M]``: a single-stage level's
    keys, written with the rows (see :func:`expand_reference`)."""
    if ctl.device.type == "cpu":
        return expand_plain(g, tabs, fr, ctl, rows, nvalid, model, fkey)
    _launch("wgl_expand", *_expand_args(g, tabs, fr, ctl, rows, nvalid, model, fkey))


def _expand_args(g, tabs, fr, ctl, rows, nvalid, model, fkey=None) -> tuple:
    sid, prm = step_spec(model)
    if g.S != model.state_width:
        raise ValueError(f"expand: state width {g.S}, but model {model.name!r} has "
                         f"{model.state_width} lanes")
    p, mD, mO, st, valid = fr
    t = tabs
    _check_cuda(t["tabD"], t["sufret"], t["invO"], t["opO"], t["a1O"], t["a2O"],
                p, mD, mO, st, valid, ctl, rows, nvalid, fkey)
    if g.W % 32 or not 32 <= g.W <= EXPAND_MAX_W or t["tabD"].data_ptr() % 16:
        raise ValueError(f"expand: W {g.W} must be a multiple of 32 up to {EXPAND_MAX_W}, "
                         "tabD 16-byte aligned")
    nb = ctl.shape[0]
    _check_members(nb)
    F = g.F
    _check_shapes("expand", (ctl, (nb, CTL_SIZE)), (t["tabD"], (nb, g.ND, 8)),
                  (t["sufret"], (nb, g.ND + 1)), (t["invO"], (nb, g.NO)),
                  (t["opO"], (nb, g.NO)), (t["a1O"], (nb, g.NO)), (t["a2O"], (nb, g.NO)),
                  (p, (nb, F)), (mD, (nb, F, g.KD)), (mO, (nb, F, g.KO1)),
                  (st, (nb, F, g.S)), (valid, (nb, F)), (rows, (nb, g.M, g.NC)),
                  (nvalid, (nb, g.M)))
    if fkey is not None:
        if g.two_stage:
            raise ValueError("expand: a two-stage level's keys come from stage 1")
        _check_shapes("expand", (fkey, (nb, g.M)))
    ci = ctypes.c_int
    return (_ptr(t["tabD"]), _ptr(t["sufret"]), _ptr(t["invO"]),
            _ptr(t["opO"]), _ptr(t["a1O"]), _ptr(t["a2O"]),
            _ptr(p), _ptr(mD), _ptr(mO), _ptr(st), _ptr(valid),
            _ptr(ctl), _ptr(rows), _ptr(nvalid), _ptr(fkey),
            ci(F), ci(g.W), ci(g.KO), ci(g.ND), ci(g.NO), ci(g.B if g.SEL else 0),
            ci(g.S), ci(sid), ci(prm), ci(nb), _stream())


def stage1_hash(g: Geometry, rows: torch.Tensor, nvalid: torch.Tensor,
                ctl: torch.Tensor, drows: torch.Tensor, fkey: Optional[torch.Tensor],
                scratch: Optional[torch.Tensor]) -> None:
    """Stage K2 (see module docstring) of a two-stage level. ``scratch``:
    ``BatchWorkspace.s1`` (:func:`stage1_scratch`), the compaction's
    look-back state. ``fkey`` None: the compaction alone (an alltoall
    level: the route writes the received rows' keys); in an allgather level
    the survivors' keys only. A member's ``ctl[CTL_NEXP]`` must be its count
    of valid rows, as the expand leaves it."""
    if ctl.device.type == "cpu":
        return stage1_hash_plain(g, rows, nvalid, ctl, drows, fkey, scratch)
    _launch("wgl_stage1_hash", *_stage1_hash_args(g, rows, nvalid, ctl, drows, fkey, scratch))


def _stage1_hash_args(g, rows, nvalid, ctl, drows, fkey, scratch) -> tuple:
    _check_cuda(rows, nvalid, ctl, drows, fkey, scratch)
    nb = ctl.shape[0]
    _check_members(nb)
    _check_shapes("stage1_hash", (ctl, (nb, CTL_SIZE)), (rows, (nb, g.M, g.NC)),
                  (nvalid, (nb, g.M)), (drows, (nb, g.P, g.NC)))
    if g.M > STAGE1_MAX_M:
        raise ValueError(f"stage1_hash: {g.M} rows a member; the kernel takes at most "
                         f"{STAGE1_MAX_M}")
    if not g.two_stage:
        raise ValueError("stage1_hash: a single-stage level has no stage 1 (the expand "
                         "writes its keys)")
    if fkey is not None:
        _check_shapes("stage1_hash", (fkey, (nb, g.P)))
    tile = stage1_tile(g.M, nb, rows.device)
    if tile not in STAGE1_TILES:
        raise ValueError(f"stage1_hash: tile {tile}; the kernel takes {STAGE1_TILES}")
    if (scratch is None or scratch.dtype != torch.int32
            or scratch.numel() < _stage1_words(g.M, nb, tile)):
        raise ValueError("stage1_hash: look-back scratch too small (see stage1_scratch)")
    ci = ctypes.c_int
    return (_ptr(rows), _ptr(nvalid), _ptr(ctl), _ptr(drows), _ptr(fkey), _ptr(scratch),
            ci(g.M), ci(g.NC), ci(g.NID), ci(g.P), ci(int(not g.exchange)), ci(nb), ci(tile),
            _stream())


def radix_sort_pairs(keys: torch.Tensor, vals: torch.Tensor, scratch: tuple,
                     ctl: Optional[torch.Tensor] = None) -> None:
    """Stage K3: stable ascending sort of each member's row of (u32 key,
    u32 value) pairs (``[nb, n]``), in place. ``scratch`` is ``(tmp,
    state)`` from :func:`sort_scratch` (a :class:`BatchWorkspace` holds
    one); it chooses the kernel's path: one launch, or at most five."""
    if keys.device.type == "cpu":
        return radix_sort_pairs_plain(keys, vals, scratch, ctl)
    _launch("radix_sort_pairs", *_radix_sort_pairs_args(keys, vals, scratch, ctl))


def _radix_sort_pairs_args(keys, vals, scratch, ctl) -> tuple:
    tmp, state = scratch
    _check_cuda(keys, vals, tmp, state, ctl)
    if keys.dim() != 2:
        raise ValueError("radix_sort_pairs: keys must be [nb, n]")
    nb, n = keys.shape
    _check_members(nb)
    if vals.shape != keys.shape:
        raise ValueError("radix_sort_pairs: keys and values differ in shape")
    if n >= 2**30:
        raise ValueError(f"radix_sort_pairs: {n} pairs a row; the kernel takes fewer than 2**30")
    one_block = sort_path(scratch) == "cta"
    if one_block:
        fits = tmp.shape == (2, nb, 0) and n <= _build.SORT_CTA_MAX
    else:
        fits = tmp.shape == (2, nb, n) and state.numel() >= _sort_state_words(n, nb)
    if not fits:
        raise ValueError("radix_sort_pairs: scratch does not fit (see sort_scratch)")
    if ctl is not None:
        _check_shapes("radix_sort_pairs", (ctl, (nb, CTL_SIZE)))
    none = ctypes.c_void_p(0)
    if one_block:
        return (_ptr(keys), _ptr(vals), none, none, none, ctypes.c_int(n), ctypes.c_int(nb),
                _ptr(ctl), _stream())
    return (_ptr(keys), _ptr(vals), _ptr(tmp[0]), _ptr(tmp[1]), _ptr(state),
            ctypes.c_int(n), ctypes.c_int(nb), _ptr(ctl), _stream())


def take_col_sort(src: torch.Tensor, col: int, keys: torch.Tensor, vals: torch.Tensor,
                  scratch: tuple, ctl: Optional[torch.Tensor] = None,
                  ident: bool = False) -> None:
    """:func:`radix_sort_pairs` of ``(src[b, v, col], v)`` in place in
    ``(keys, vals)`` (``src [nb, L, NC]``, or ``[nb, L]`` with ``col=0``,
    ``L`` at least the pairs a member): ``v`` is the position ``i`` when
    ``ident``, else ``vals[b, i]``. One kernel gathers the keys where the
    sort loads them (one launch on the one-block path)."""
    if keys.device.type == "cpu":
        return take_col_sort_plain(src, col, keys, vals, scratch, ctl, ident)
    _launch("wgl_take_col_sort", *_take_col_sort_args(src, col, keys, vals, scratch, ctl, ident))


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def _take_col_sort_args(src, col, keys, vals, scratch, ctl, ident) -> tuple:
    sort = _radix_sort_pairs_args(keys, vals, scratch, ctl)
    _check_cuda(src, keys)
    nb, n = keys.shape
    stride = src.shape[2] if src.dim() == 3 else 1
    if src.dim() not in (2, 3) or src.shape[0] != nb or not 0 <= col < stride \
            or src.shape[1] < n:
        raise ValueError("take_col_sort: bad column or shapes")
    if _overlap(src, keys) or _overlap(src, vals):
        raise ValueError("take_col_sort: src overlaps keys or vals")
    ci = ctypes.c_int
    return (_ptr(src), ctypes.c_long(src.stride(0)), ci(stride), ci(col), ci(int(ident))) + sort


def prune(g: Geometry, drows: torch.Tensor, skey: torch.Tensor,
          perm: torch.Tensor, ctl: torch.Tensor, fprio: torch.Tensor,
          scratch: torch.Tensor) -> None:
    """Stage K4 (see module docstring): one launch. ``scratch``:
    ``BatchWorkspace.pr`` (:func:`prune_scratch`), the look-back state. In
    a sharded level (``g.exchange``; the members are its D shards) the
    launch's last block also runs the cross-shard reduce."""
    if ctl.device.type == "cpu":
        return prune_plain(g, drows, skey, perm, ctl, fprio, scratch)
    _launch("wgl_prune", *_prune_args(g, drows, skey, perm, ctl, fprio, scratch))


def _prune_args(g, drows, skey, perm, ctl, fprio, scratch) -> tuple:
    _check_cuda(drows, skey, perm, ctl, fprio, scratch)
    nb, L = skey.shape
    _check_members(nb)
    _check_shapes("prune", (ctl, (nb, CTL_SIZE)), (perm, (nb, L)), (fprio, (nb, L)),
                  (drows, (nb, L, g.NC)))
    if L > PRUNE_MAX_L:
        raise ValueError(f"prune: {L} rows a member; the kernel takes at most {PRUNE_MAX_L}")
    tile = prune_tile(L, nb, g.NC, g.KO1, drows.device)
    if tile < 32 or tile > max(PRUNE_TILES) or tile % 32 or \
            _prune_smem(tile, g.NC, g.KO1) > _MAX_SMEM:
        raise ValueError(f"prune: tile {tile} for rows of {g.NC} words does not fit a block")
    if (scratch is None or scratch.dtype != torch.int32
            or scratch.numel() < _prune_words(L, nb, tile)):
        raise ValueError("prune: look-back scratch too small (see prune_scratch)")
    if g.exchange:
        _check_sharded("prune", g, nb)
    ci = ctypes.c_int
    return (_ptr(drows), _ptr(skey), _ptr(perm), _ptr(ctl), _ptr(fprio), _ptr(scratch),
            ci(L), ci(g.NC), ci(g.NID), ci(g.KO1), ci(g.PB), ci(g.F), ci(g.P),
            ci(_EX_MODE[g.exchange]), ci(nb), ci(tile), _stream())


def gather_finalize(g: Geometry, drows: torch.Tensor, perm: torch.Tensor,
                    ctl: torch.Tensor, stats: torch.Tensor, fr: tuple,
                    scratch: Optional[torch.Tensor] = None) -> None:
    """Stage K5 (see module docstring): one launch. Writes each member's
    frontier in place from ``perm``, the rows in compaction order.
    ``scratch``: ``BatchWorkspace.gf`` (:func:`gather_scratch`), the
    tickets."""
    if ctl.device.type == "cpu":
        return gather_finalize_plain(g, drows, perm, ctl, stats, fr, scratch)
    _launch("wgl_gather_finalize", *_gather_finalize_args(g, drows, perm, ctl, stats, fr, scratch))


def _gather_finalize_args(g, drows, perm, ctl, stats, fr, scratch) -> tuple:
    p, mD, mO, st, valid = fr
    _check_cuda(drows, perm, ctl, stats, p, mD, mO, st, valid, scratch)
    nb = ctl.shape[0]
    _check_members(nb)
    F, L = g.F, g.L
    _check_shapes("gather_finalize", (ctl, (nb, CTL_SIZE)), (drows, (nb, L, g.NC)),
                  (perm, (nb, L)), (p, (nb, F)), (mD, (nb, F, g.KD)),
                  (mO, (nb, F, g.KO1)), (st, (nb, F, g.S)), (valid, (nb, F)),
                  (stats, (nb, LEVEL_STAT_ROWS, 4)))
    if scratch is None or scratch.dtype != torch.int32 or scratch.numel() < nb:
        raise ValueError("gather_finalize: ticket scratch too small (see gather_scratch)")
    if 4 * _build.GF_ROWS * (g.NC + 1) > _MAX_SMEM:
        raise ValueError(f"gather_finalize: rows of {g.NC} words do not fit a block")
    ci = ctypes.c_int
    _check_sharded("gather_finalize", g, nb)
    return (_ptr(drows), _ptr(perm), _ptr(ctl), _ptr(stats), _ptr(p), _ptr(mD), _ptr(mO),
            _ptr(st), _ptr(valid), _ptr(scratch), ci(F), ci(L), ci(g.NC), ci(g.KD), ci(g.S),
            ci(g.KO1), ci(g.P if g.two_stage else 0), ci(LEVEL_STAT_ROWS),
            ci(_EX_MODE[g.exchange]), ci(nb), _stream())


def _check_sharded(name: str, g: Geometry, nb: int) -> None:
    """A sharded level's members are exactly its D shards."""
    if g.exchange is not None and nb != g.D:
        raise ValueError(f"{name}: {nb} members for a mesh of {g.D} shards")
    if not 1 <= g.D <= MAX_SHARDS:
        raise ValueError(f"{name}: {g.D} shards; the kernels take 1..{MAX_SHARDS}")


def route(g: Geometry, crows: torch.Tensor, ctl: torch.Tensor, drows: torch.Tensor,
          rvalid: torch.Tensor, scratch: Optional[torch.Tensor], fkey: torch.Tensor) -> None:
    """Sharded stage (alltoall): each shard's stage-1 rows ``crows [D, P,
    NC]`` routed to their owners and written straight into the owners'
    receive rows ``drows [D, D*PBK, NC]`` (source s's bucket at rows
    ``[s*PBK, (s+1)*PBK)``), validity ``rvalid [D, D*PBK]`` and fused keys
    ``fkey [D, D*PBK]`` (an empty slot's the zero row's);
    a bucket overflow sets the source's row-overflow flag. One launch.
    ``scratch``: ``BatchWorkspace.rt`` (:func:`route_scratch`), the
    look-back state."""
    if ctl.device.type == "cpu":
        return route_plain(g, crows, ctl, drows, rvalid, scratch, fkey)
    _launch("wgl_route", *_route_args(g, crows, ctl, drows, rvalid, scratch, fkey))


def _route_args(g, crows, ctl, drows, rvalid, scratch, fkey) -> tuple:
    _check_cuda(crows, ctl, drows, rvalid, scratch, fkey)
    D = g.D
    _check_sharded("route", g, ctl.shape[0])
    if g.exchange != "alltoall":
        raise ValueError("route: only the alltoall exchange routes rows")
    _check_shapes("route", (ctl, (D, CTL_SIZE)), (crows, (D, g.P, g.NC)),
                  (drows, (D, g.L, g.NC)), (rvalid, (D, g.L)), (fkey, (D, g.L)))
    if g.P > STAGE1_MAX_M:
        raise ValueError(f"route: {g.P} rows a shard; the kernel takes at most {STAGE1_MAX_M}")
    tile = route_tile(g.P, D, crows.device)
    if tile not in ROUTE_TILES:
        raise ValueError(f"route: tile {tile}; the kernel takes {ROUTE_TILES}")
    if (scratch is None or scratch.dtype != torch.int32
            or scratch.numel() < _route_words(g.P, D, tile)):
        raise ValueError("route: look-back scratch too small (see route_scratch)")
    ci = ctypes.c_int
    return (_ptr(crows), _ptr(ctl), _ptr(drows), _ptr(rvalid), _ptr(fkey), _ptr(scratch),
            ci(g.P), ci(g.NC), ci(g.NID), ci(D), ci(g.PBK), ci(tile), _stream())


def exchange(g: Geometry, crows: torch.Tensor, ctl: torch.Tensor, recv: torch.Tensor,
             rvalid: torch.Tensor, skey: torch.Tensor, fkey: torch.Tensor) -> None:
    """Sharded stage (allgather): the all_gather of the stage-1 rows
    ``crows [D, P, NC]`` between the D shards' buffers on one device, into
    ``recv [D, D*P, NC]`` and ``rvalid [D, D*P]``, and of stage 1's keys
    ``skey [D, P]`` of the rows into ``fkey [D, D*P]`` (an invalid row's
    the zero row's key). (The alltoall's exchange is part of
    :func:`route`.)"""
    if g.exchange != "allgather":
        raise ValueError("exchange: the allgather's stage (the alltoall's is route)")
    if ctl.device.type == "cpu":
        return exchange_plain(g, crows, ctl, recv, rvalid, skey, fkey)
    _launch("wgl_exchange", *_exchange_args(g, crows, ctl, recv, rvalid, skey, fkey))


def _exchange_args(g, crows, ctl, recv, rvalid, skey, fkey) -> tuple:
    _check_cuda(crows, ctl, recv, rvalid, skey, fkey)
    D = g.D
    _check_sharded("exchange", g, ctl.shape[0])
    if g.exchange != "allgather":
        raise ValueError("exchange: the allgather's stage (the alltoall's is route)")
    _check_shapes("exchange", (ctl, (D, CTL_SIZE)), (crows, (D, g.P, g.NC)),
                  (recv, (D, g.L, g.NC)), (rvalid, (D, g.L)), (skey, (D, g.P)),
                  (fkey, (D, g.L)))
    ci = ctypes.c_int
    return (_ptr(crows), _ptr(ctl), _ptr(recv), _ptr(rvalid), _ptr(skey), _ptr(fkey), ci(g.P),
            ci(g.NC), ci(g.NID), ci(D), _stream())


def regroup(fr: tuple, idx, F_new: int) -> tuple:
    """The members ``idx`` (host integers; an index may repeat) of the
    stacked frontier ``fr`` (``p [nb, F]``, ``mD [nb, F, KD]``, ``mO [nb,
    F, KO1]``, ``st [nb, F, S]``, ``valid [nb, F]``), zero-padded on the
    capacity axis to ``F_new``: new buffers ``[len(idx), F_new, ...]``."""
    idx = [int(i) for i in idx]
    p, mD, mO, st, valid = fr
    nb, F_old = p.shape
    if F_new < F_old:
        raise ValueError(f"regroup: F_new {F_new} below the current capacity {F_old}")
    if any(not 0 <= i < nb for i in idx):
        raise ValueError(f"regroup: member index out of range 0..{nb - 1}")
    if p.device.type == "cpu":
        return regroup_reference(fr, idx, F_new)
    out = tuple(torch.empty((len(idx), F_new) + tuple(a.shape[2:]), dtype=a.dtype,
                            device=a.device) for a in fr)
    if not idx:
        return out
    ix = None
    if len(idx) > _build.RG_INLINE:
        # A copy from pinned memory does not wait for the stream's queued work.
        ix = torch.tensor(idx, dtype=torch.int32).pin_memory().to(p.device, non_blocking=True)
    _launch("wgl_regroup", *_regroup_args(fr, out, idx, ix))
    return out


def _regroup_args(fr: tuple, out: tuple, idx: list, ix: Optional[torch.Tensor] = None) -> tuple:
    """The one launch of :func:`regroup`: ``out`` the new buffers ``[n_new,
    F_new, ...]``, ``idx`` the member indices (host integers, passed in
    the launch's parameters up to ``_build.RG_INLINE``), ``ix`` the same
    indices on the device (int32), needed only above that."""
    p, mD, mO, st, valid = fr
    nb, F_old = p.shape
    n_new, F_new = out[0].shape
    if len(idx) != n_new or (n_new > _build.RG_INLINE and ix is None):
        raise ValueError("regroup: the indices do not match the new buffers")
    _check_cuda(*fr, *out, ix)
    _check_shapes("regroup", (mD, (nb, F_old, mD.shape[2])), (mO, (nb, F_old, mO.shape[2])),
                  (st, (nb, F_old, st.shape[2])), (valid, (nb, F_old)),
                  *((o, (n_new, F_new) + tuple(a.shape[2:])) for a, o in zip(fr, out)),
                  *(((ix, (n_new,)),) if ix is not None else ()))
    ci = ctypes.c_int
    # the host array is an argument itself, so it lives through the call
    host = (ctypes.c_int * n_new)(*idx)
    return (*(_ptr(a) for a in fr), *(_ptr(a) for a in out), _ptr(ix), host, ci(n_new),
            ci(F_old), ci(F_new), ci(mD.shape[2]), ci(mO.shape[2]), ci(st.shape[2]), _stream())


class _Stages:
    """One implementation of every stage, for :func:`run_level_batch`."""

    def __init__(self, **fns):
        self.__dict__.update(fns)


KERNELS = _Stages(chunk_init=chunk_init, expand=expand, stage1_hash=stage1_hash,
                  take_col_sort=take_col_sort, radix_sort_pairs=radix_sort_pairs,
                  prune=prune, gather_finalize=gather_finalize, regroup=regroup,
                  route=route, exchange=exchange)
PLAIN = _Stages(chunk_init=chunk_init_plain, expand=expand_plain,
                stage1_hash=stage1_hash_plain, take_col_sort=take_col_sort_plain,
                radix_sort_pairs=radix_sort_pairs_plain, prune=prune_plain,
                gather_finalize=gather_finalize_plain, regroup=regroup_reference,
                route=route_plain, exchange=exchange_plain)


def _level_stages(g: Geometry, tabs: dict, fr: tuple, ws: BatchWorkspace,
                  model: Model) -> list:
    """One BFS level for every member, in order, as ``(stage, arguments)``
    pairs: one call per stage for the whole batch (each stage returns at
    once for a member whose control block says stop). A single-stage
    level's expand writes the keys; a two-stage level's stage 1 does."""
    if g.exchange:
        return _sharded_level_stages(g, tabs, fr, ws, model)
    ctl = ws.ctl
    if not g.two_stage:
        out = [("expand", (g, tabs, fr, ctl, ws.rows, ws.nvalid, model, ws.fkey))]
    else:
        out = [("expand", (g, tabs, fr, ctl, ws.rows, ws.nvalid, model, None)),
               ("stage1_hash", (g, ws.rows, ws.nvalid, ctl, ws.drows, ws.fkey, ws.s1))]
    return out + _dedup_stages(g, fr, ws)


def _dedup_stages(g: Geometry, fr: tuple, ws: BatchWorkspace) -> list:
    """The stages from the dedup sort on: over ``ws.drows``' ``L`` rows
    keyed by ``ws.fkey``."""
    ctl = ws.ctl
    out = []
    # Dedup order: lexicographic over (fkey, open-mask words), built as
    # stable sorts from the last key to the first, each gathering its key
    # column through the order so far (the first from the identity). With
    # no open ops the single open column is all zeros and sorts as the
    # identity.
    cols = [(ws.drows, g.NID + w) for w in reversed(range(g.KO1))] if g.KO else []
    for j, (src, col) in enumerate(cols + [(ws.fkey, 0)]):
        out.append(("take_col_sort", (src, col, ws.keys, ws.perm, ws.sort, ctl, j == 0)))
    out += [("prune", (g, ws.drows, ws.keys, ws.perm, ctl, ws.fprio, ws.pr)),
            # Compaction order: (priority, position) — stability is the
            # tiebreak. The values are the dedup order's rows, so they come
            # out as the rows in compaction order.
            ("radix_sort_pairs", (ws.fprio, ws.perm, ws.sort, ctl)),
            ("gather_finalize", (g, ws.drows, ws.perm, ctl, ws.stats, fr, ws.gf))]
    return out


def _sharded_level_stages(g: Geometry, tabs: dict, fr: tuple, ws: BatchWorkspace,
                          model: Model) -> list:
    """One level of a frontier-sharded search, its D shards the members
    (the reference's ``_build_kernel(axis_name=...)``): each shard expands
    and compacts its stage-1 rows (two-stage at every M, reference
    ``ops/wgl.py:525``); the alltoall's route writes them and their keys
    (the owner test's hash) straight into their owners' receive rows, the
    allgather's exchange copies them and stage 1's keys to every shard; the
    received rows are deduplicated as in a single level at ``L`` rows, the
    prune's last block replicates the cross-shard values, and the finalize
    keeps each shard's rows (``ops/wgl.py:743-757``)."""
    ctl = ws.ctl
    out = [("expand", (g, tabs, fr, ctl, ws.rows, ws.nvalid, model, None)),
           ("stage1_hash", (g, ws.rows, ws.nvalid, ctl, ws.crows, ws.ckey, ws.s1))]
    if g.exchange == "alltoall":
        out.append(("route", (g, ws.crows, ctl, ws.drows, ws.rvalid, ws.rt, ws.fkey)))
    else:
        out.append(("exchange", (g, ws.crows, ctl, ws.drows, ws.rvalid, ws.ckey, ws.fkey)))
    return out + _dedup_stages(g, fr, ws)


def run_level_batch(ops: _Stages, g: Geometry, tabs: dict, fr: tuple,
                    ws: BatchWorkspace, model: Model) -> None:
    """Enqueue one BFS level for every member through ``ops``."""
    for stage, args in _level_stages(g, tabs, fr, ws, model):
        getattr(ops, stage)(*args)


# stage -> (kernel entry point, its argument check and packing)
_PACKERS = {"expand": ("wgl_expand", _expand_args),
            "stage1_hash": ("wgl_stage1_hash", _stage1_hash_args),
            "take_col_sort": ("wgl_take_col_sort", _take_col_sort_args),
            "radix_sort_pairs": ("radix_sort_pairs", _radix_sort_pairs_args),
            "prune": ("wgl_prune", _prune_args),
            "gather_finalize": ("wgl_gather_finalize", _gather_finalize_args),
            "route": ("wgl_route", _route_args),
            "exchange": ("wgl_exchange", _exchange_args)}


class _LevelProgram:
    """:func:`run_level_batch` on the kernels with every launch's arguments
    checked and packed once (per chunk: the buffers do not change between
    its levels), so enqueueing a level costs only its ctypes calls."""

    def __init__(self, g: Geometry, tabs: dict, fr: tuple, ws: BatchWorkspace, model: Model):
        lib = _build.load()
        self.steps = []
        for stage, args in _level_stages(g, tabs, fr, ws, model):
            name, pack = _PACKERS[stage]
            self.steps.append((name, getattr(lib, name), pack(*args)))

    def __call__(self) -> None:
        for name, fn, args in self.steps:
            rc = fn(*args)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc} ({_build.error_string(rc)})")
            LAUNCHES[name] += 1


def _run_levels(ops: _Stages, g: Geometry, tabs: dict, fr: tuple, ws: BatchWorkspace,
                lvl0, max_levels, lossy, nD, nO, model: Model,
                ladder: Optional[tuple] = None) -> torch.Tensor:
    """Run every member's levels from its ``lvl0`` until its stop condition
    or its ``max_levels``; returns the host copy of the control blocks.

    The chunk starts with one :func:`chunk_init` (no copy to the card, no
    memset): the initial values ride in its parameters, or, for a batch
    above :data:`CS_INLINE` members, in the workspace's ladder table, made
    from ``ladder = (totals, lpc)`` at its first chunk. On the GPU the host
    then enqueues levels for the whole batch in growing runs without
    reading the control blocks first (levels enqueued past a member's stop
    return at once, so a chunk that starts stopped costs the first run's
    launches), and reads the ``[nb, CTL_SIZE]`` control blocks once per
    run, going on while any member may go on. The buffers are checked once
    per chunk (:class:`_LevelProgram`), not once per level."""
    ctl = ws.ctl
    rows = chunk_rows(lvl0, max_levels, lossy, nD, nO)
    table, lpc = None, 0
    if ws.nb > CS_INLINE and ladder is not None:
        totals, lpc = ladder
        if ws.ladder is None:
            ws.ladder = ladder_table(lvl0, totals, lossy, nD, nO, ctl.device)
        table, rows = ws.ladder, None
    ops.chunk_init(ctl, fr[4], ws.stats, rows, ws.gf if g.exchange else None, table, lpc)
    remaining = max(0, max(int(m) - int(a) for m, a in zip(max_levels, lvl0)))
    pipelined = ops is KERNELS and ctl.device.type == "cuda"
    batch = 4 if pipelined else 1
    if pipelined:
        level = _LevelProgram(g, tabs, fr, ws, model)
    else:
        def level():
            run_level_batch(ops, g, tabs, fr, ws, model)
    c = None if pipelined else ctl.cpu()
    while remaining > 0 and (c is None or bool(c[:, CTL_GO].any())):
        n = min(batch, remaining)
        for _ in range(n):
            level()
        remaining -= n
        if pipelined:
            batch = min(2 * batch, 256)
        c = ctl.cpu()
    if c is None:
        c = ctl.cpu()
    if c[:, CTL_MAXLVL].tolist() != [int(m) for m in max_levels]:
        raise RuntimeError("chunk start: the control blocks' level budgets "
                           f"{c[:, CTL_MAXLVL].tolist()} are not the host's {list(max_levels)}")
    return c


def run_chunk_batch(ops: _Stages, g: Geometry, tabs: dict, fr: tuple,
                    ws: BatchWorkspace, lvl0, max_levels, lossy, nD, nO,
                    model: Model, ladder: Optional[tuple] = None) -> list:
    """Run every member's levels from its ``lvl0`` until its stop
    condition or its ``max_levels`` (the reference's vmapped
    ``while_loop``). ``lvl0``, ``max_levels``, ``lossy``, ``nD`` and
    ``nO`` hold one integer per member; every member steps ``model``.
    ``ladder = (totals, lpc)``: the batch ladder's rule (each member's
    total levels and the rung's levels a chunk), which a batch above
    :data:`CS_INLINE` members needs for its chunk start (``ws`` then
    serves one rung). Returns each member's packed flags ``[acc, ovf,
    nonempty, lvl, fmax, count]`` (the reference's ``[nb, 6]``); the
    frontier ``fr`` is updated in place and ``ws.stats`` holds each
    member's per-level ring. See :func:`_run_levels` for how the GPU path
    enqueues levels."""
    c = _run_levels(ops, g, tabs, fr, ws, lvl0, max_levels, lossy, nD, nO, model, ladder)
    out = []
    for r in c.tolist():
        nonempty = int(r[CTL_FCOUNT] > 0 and not r[CTL_STUCK])
        out.append([r[CTL_ACC], r[CTL_OVF], nonempty, r[CTL_LVL], r[CTL_FMAX],
                    r[CTL_FCOUNT]])
    return out


def run_chunk_sharded(ops: _Stages, g: Geometry, tabs: dict, fr: tuple,
                      ws: BatchWorkspace, lvl0: int, max_levels: int, lossy: bool,
                      nD: int, nO: int, model: Model) -> list:
    """One chunk of a frontier-sharded search (the reference's
    ``parallel/frontier.py`` ``_sharded_kernel``): ``fr`` holds the D
    shards' frontiers ``[D, F, ...]`` (updated in place), ``tabs`` the
    tables repeated for each shard, ``g`` a sharded geometry
    (``wgl.sharded_geometry``). Returns the reference's 8 packed flags
    ``[acc, ovf, nonempty, lvl, fmax, count, cnt_max, cnt_min]``: the
    global values, and the largest and smallest shard's frontier."""
    if not g.exchange:
        raise ValueError("run_chunk_sharded: the geometry is not sharded")
    D = g.D
    c = _run_levels(ops, g, tabs, fr, ws, [lvl0] * D, [max_levels] * D, [lossy] * D,
                    [nD] * D, [nO] * D, model)
    rep_cols = [CTL_LVL, CTL_ACC, CTL_OVF, CTL_FMAX, CTL_STUCK, CTL_GO, CTL_NSUM, CTL_NMAX,
                CTL_NMIN]
    if not bool((c[:, rep_cols] == c[0, rep_cols]).all()):
        raise RuntimeError(f"shards disagree on replicated control fields: {c.tolist()}")
    if int(c[:, CTL_FCOUNT].sum()) != int(c[0, CTL_NSUM]):
        raise RuntimeError("shards' frontier counts do not add up to the reduced sum")
    r = c[0].tolist()
    nonempty = int(r[CTL_NSUM] > 0 and not r[CTL_STUCK])
    return [r[CTL_ACC], r[CTL_OVF], nonempty, r[CTL_LVL], r[CTL_FMAX], r[CTL_NSUM],
            r[CTL_NMAX], r[CTL_NMIN]]


def run_chunk(ops: _Stages, g: Geometry, tabs: dict, fr: tuple, ws: BatchWorkspace,
              lvl0: int, max_levels: int, lossy: bool, nD: int, nO: int,
              model: Model) -> list:
    """:func:`run_chunk_batch` for one search: ``tabs`` and ``fr`` are one
    member's (``fr[0]`` is ``[F]``), ``ws`` a workspace of one member.
    Returns the packed flags."""
    return run_chunk_batch(ops, g, {k: t[None] for k, t in tabs.items()},
                           tuple(a[None] for a in fr), ws, [lvl0], [max_levels],
                           [lossy], [nD], [nO], model)[0]
