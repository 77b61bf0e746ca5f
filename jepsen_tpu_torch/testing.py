"""Seeded history generators for tests and the chip smoke run.

``random_register_history``, ``perturb_history`` and
``random_lock_history`` draw from a ``random.Random`` in the same order as
the reference package's generators, so one seed gives op-for-op the same
history in either package. ``random_model_history`` simulates an atomic
service of any device model, and ``lagged_append_history`` and
``lagged_wr_history`` simulate transactional stores for the Elle checkers
(the reference has no such generators; tests hand the same op rows to
both packages). ``sort_keys`` draws the radix sort's test keys,
``stage1_case`` the stage-1 compaction's inputs; ``device_work`` counts the
device launches of one call on the card.
"""

from __future__ import annotations

import random
from typing import Any, NamedTuple, Optional

from .history import History, Op
from .models import Model, ValueTable, model_by_name


def random_register_history(
    rng: random.Random,
    n_ops: int = 40,
    n_procs: int = 4,
    cas: bool = True,
    crash_p: float = 0.1,
    fail_p: float = 0.05,
    values: int = 5,
) -> History:
    """Simulate concurrent processes against an atomic (cas-)register.

    Each op atomically takes effect at a random point inside its interval,
    so the result is linearizable by construction. ``crash_p`` turns
    completions into :info (indeterminate, effect applied or not with 50/50
    odds); ``fail_p`` produces :fail ops whose effect definitely did not
    apply.
    """
    state = 0
    ops: list[Op] = []
    t = 0
    pending: dict[int, Optional[tuple]] = {p: None for p in range(n_procs)}

    def now() -> int:
        nonlocal t
        t += rng.randint(1, 5)
        return t

    emitted = 0
    while emitted < n_ops or any(v is not None for v in pending.values()):
        p = rng.randrange(n_procs)
        slot = pending[p]
        if slot is None:
            if emitted >= n_ops:
                continue
            kinds = ["read", "write"] + (["cas"] if cas else [])
            f = rng.choice(kinds)
            if f == "read":
                value = None
            elif f == "write":
                value = rng.randrange(values)
            else:
                value = [rng.randrange(values), rng.randrange(values)]
            ops.append(Op("invoke", p, f, value, time=now()))
            pending[p] = (f, value, len(ops) - 1)
            emitted += 1
        else:
            f, value, _inv_pos = slot
            pending[p] = None
            if rng.random() < fail_p:
                ops.append(Op("fail", p, f, value, time=now()))
                continue
            crashed = rng.random() < crash_p
            applies = not crashed or rng.random() < 0.5
            out_value = value
            okflag = True
            if applies:
                if f == "read":
                    out_value = state
                elif f == "write":
                    state = value
                else:
                    old, new = value
                    if state == old:
                        state = new
                    else:
                        okflag = False
            if crashed:
                ops.append(Op("info", p, f, value, time=now()))
            elif f == "read":
                ops.append(Op("ok", p, f, out_value, time=now()))
            elif okflag:
                ops.append(Op("ok", p, f, value, time=now()))
            else:
                ops.append(Op("fail", p, f, value, time=now()))
    return History(ops)


def perturb_history(rng: random.Random, history: History,
                    within: float = 1.0) -> History:
    """Mutate one completed read's value — usually breaking
    linearizability. ``within`` restricts the mutated read to the first
    fraction of the history. A ``[k v]``-tupled (independent) value
    mutates its inner value and keeps its key."""
    ops = list(history)
    bound = max(1, int(len(ops) * within))
    ok_reads = [i for i, op in enumerate(ops[:bound])
                if op.is_ok and op.f == "read"]
    if not ok_reads:
        return history
    i = rng.choice(ok_reads)
    op = ops[i]

    def mut(v):
        return (v if v is None else v + 17) or 23

    from .independent import KV

    v = op.value
    ops[i] = op.with_(value=KV(v.key, mut(v.value)) if isinstance(v, KV) else mut(v))
    return History(ops, reindex=False)


def random_lock_history(
    rng: random.Random,
    n_ops: int = 200,
    n_procs: int = 4,
) -> History:
    """Simulate concurrent processes against an atomic lock service
    (owner-aware mutex semantics: acquire fails when held, release fails
    unless you hold it). Linearizable by construction: each op takes
    effect atomically inside its interval."""
    owner: Optional[int] = None
    ops: list[Op] = []
    t = 0
    pending: dict[int, Optional[tuple]] = {p: None for p in range(n_procs)}

    def now() -> int:
        nonlocal t
        t += rng.randint(1, 5)
        return t

    emitted = 0
    while emitted < n_ops or any(v is not None for v in pending.values()):
        p = rng.randrange(n_procs)
        slot = pending[p]
        if slot is None:
            if emitted >= n_ops:
                continue
            f = rng.choice(["acquire", "release"])
            ops.append(Op("invoke", p, f, None, time=now()))
            pending[p] = (f,)
            emitted += 1
        else:
            (f,) = slot
            pending[p] = None
            if f == "acquire":
                if owner is None:
                    owner = p
                    ops.append(Op("ok", p, f, None, time=now()))
                else:
                    ops.append(Op("fail", p, f, None, time=now()))
            else:
                if owner == p:
                    owner = None
                    ops.append(Op("ok", p, f, None, time=now()))
                else:
                    ops.append(Op("fail", p, f, None, time=now()))
    return History(ops, reindex=True)


# The model each name's histories are drawn for: 3 registers (yugabyte's
# multi-key register set), 8 accounts holding 100 in all (the bank
# workload's defaults), a semaphore of 2 permits (the lock workload's).
_HISTORY_MODELS = {
    "multi-register": lambda: model_by_name("multi-register", {0: None, 1: None, 2: None}),
    "counter": lambda: model_by_name("counter", 0),
    "set": lambda: model_by_name("set"),
    "bank": lambda: model_by_name("bank", {a: 12 + (4 if a == 0 else 0) for a in range(8)}),
    "mutex": lambda: model_by_name("mutex"),
    "owner-aware-mutex": lambda: model_by_name("owner-aware-mutex"),
    "reentrant-mutex": lambda: model_by_name("reentrant-mutex", 2),
    "fenced-mutex": lambda: model_by_name("fenced-mutex"),
    "reentrant-fenced-mutex": lambda: model_by_name("reentrant-fenced-mutex"),
    "semaphore": lambda: model_by_name("semaphore", 2),
}
HISTORY_MODELS = tuple(_HISTORY_MODELS)
SET_ELEMENTS = 8
MAX_TRANSFER = 5
FAIL_P = 0.02


def history_model(name: str) -> Model:
    """The model :func:`random_model_history` draws ``name``'s histories
    for."""
    return _HISTORY_MODELS[name]()


class _Effect(NamedTuple):
    """The fields of a paired op that ``Model.encode_op`` reads."""

    f: str
    type: str
    value_in: Any
    value_out: Any
    process: int


def _draw_op(name: str, model: Model, rng: random.Random) -> tuple:
    """(f, invoke value) of a random op of model ``name``'s op shapes."""
    if name == "multi-register":
        reg = rng.choice(model.regs)
        if rng.random() < 0.5:
            return "read", {reg: None}
        return "write", {reg: rng.randrange(5)}
    if name == "counter":
        return ("read", None) if rng.random() < 0.4 else ("add", rng.randint(-3, 5))
    if name == "set":
        f = rng.choice(["add", "add", "remove", "read"])
        return f, None if f == "read" else rng.randrange(SET_ELEMENTS)
    if name == "bank":
        if rng.random() < 0.4:
            return "read", {rng.choice(model.accounts): None}
        src, dst = rng.sample(model.accounts, 2)
        return "transfer", {"from": src, "to": dst, "amount": rng.randint(1, MAX_TRANSFER)}
    f = rng.choice(["acquire", "release"])
    if name == "semaphore":
        return f, rng.choice([1, 1, 2])
    return f, None


def _observed(name: str, model: Model, state: tuple, table: ValueTable, f: str,
              value_in, p: int, fences: dict):
    """The value an ok completion of (f, value_in) by process ``p``
    observes in ``state``: a read's value, a fence token, else the invoke
    value."""
    if name == "multi-register" and f == "read":
        (reg,) = value_in
        return {reg: model.decode_state(state, table)[model.reg_ids[reg]]}
    if name == "counter" and f == "read":
        return state[0]
    if name == "set" and f == "read":
        return sorted(model.decode_state(state, table)[0])
    if name == "bank" and f == "read":
        (acct,) = value_in
        return {acct: state[model.acct_ids[acct]]}
    if name in ("fenced-mutex", "reentrant-fenced-mutex") and f == "acquire":
        # A reacquire by the holder gets the hold's token, a fresh one the
        # next token of the service's strictly increasing counter.
        if fences["holder"] == p:
            return fences["token"]
        return fences["next"]
    return value_in


def random_model_history(
    rng: random.Random,
    model_name: str,
    n_ops: int = 40,
    n_procs: int = 4,
    crash_p: float = 0.05,
    perturb: bool = False,
    within: float = 1.0,
) -> History:
    """Simulate concurrent processes against an atomic service of the
    device model ``model_name`` (one of :data:`HISTORY_MODELS`; the model
    is :func:`history_model`'s).

    Each op takes effect at its completion, an instant inside its
    interval, by the model's own ``step_scalar``: an op the step refuses
    completes as ``fail`` (an acquire of a held lock, an overdraft, a
    remove of an absent element), so the history is linearizable by
    construction. ``crash_p`` turns completions into ``info``
    (indeterminate; the effect applied or not with 50/50 odds, and nothing
    observed); a share :data:`FAIL_P` of completions are ``fail`` ops
    whose effect did not apply. Op values follow each model's op shapes:
    one register or one account per read, at most :data:`SET_ELEMENTS`
    set elements, transfers of 1 to :data:`MAX_TRANSFER`, permit counts
    of 1 or 2, fence tokens from a strictly increasing counter.

    ``perturb`` breaks one observed outcome of the finished history: a
    read's value, a fence token, or (for the models that observe none) an
    acknowledged acquire reported as failed, which leaves a later release
    nothing to release; ``within`` restricts it to the first fraction of
    the history."""
    model = history_model(model_name)
    table = ValueTable()
    state = tuple(model.init_state(table))
    fences = {"next": 1, "holder": None, "token": None}
    ops: list[Op] = []
    t = 0
    pending: dict[int, Optional[tuple]] = {p: None for p in range(n_procs)}

    def now() -> int:
        nonlocal t
        t += rng.randint(1, 5)
        return t

    emitted = 0
    while emitted < n_ops or any(v is not None for v in pending.values()):
        p = rng.randrange(n_procs)
        slot = pending[p]
        if slot is None:
            if emitted >= n_ops:
                continue
            f, value = _draw_op(model_name, model, rng)
            ops.append(Op("invoke", p, f, value, time=now()))
            pending[p] = (f, value)
            emitted += 1
            continue
        f, value = slot
        pending[p] = None
        if rng.random() < FAIL_P:
            ops.append(Op("fail", p, f, value, time=now()))
            continue
        crashed = rng.random() < crash_p
        applies = not crashed or rng.random() < 0.5
        out = _observed(model_name, model, state, table, f, value, p, fences)
        enc = model.encode_op(_Effect(f, "info" if crashed else "ok", value, out, p), table)
        ok = False
        if applies and enc is not None:
            ok, state2 = model.step_scalar(state, *enc)
            if ok:
                state = state2
                if out is not None and f == "acquire" and out == fences["next"]:
                    fences.update(next=out + rng.randint(1, 3), holder=p, token=out)
        if model_name in ("fenced-mutex", "reentrant-fenced-mutex") and ok and \
                f == "release" and state[0] == 0:
            fences.update(holder=None, token=None)
        if crashed:
            ops.append(Op("info", p, f, value, time=now()))
        elif ok:
            ops.append(Op("ok", p, f, out, time=now()))
        else:
            ops.append(Op("fail", p, f, value, time=now()))
    h = History(ops)
    return _perturb_observed(rng, model_name, h, within) if perturb else h


def _perturb_observed(rng: random.Random, model_name: str, history: History,
                      within: float) -> History:
    """One observed outcome among the first ``within`` of ``history``
    changed (see :func:`random_model_history`); the history as it is when
    there is none."""
    ops = list(history)
    bound = max(1, int(len(ops) * within))
    if model_name in ("multi-register", "counter", "set", "bank"):
        cands = [i for i, op in enumerate(ops[:bound]) if op.is_ok and op.f == "read"]
    elif model_name in ("fenced-mutex", "reentrant-fenced-mutex"):
        cands = [i for i, op in enumerate(ops[:bound])
                 if op.is_ok and op.f == "acquire" and op.value is not None]
    else:
        cands = [i for i, op in enumerate(ops[:bound]) if op.is_ok and op.f == "acquire"]
    if not cands:
        return history
    i = rng.choice(cands)
    op = ops[i]
    v = op.value
    if model_name in ("mutex", "owner-aware-mutex", "reentrant-mutex", "semaphore"):
        ops[i] = op.with_(type="fail")
    elif model_name == "set":
        e = rng.randrange(SET_ELEMENTS)
        ops[i] = op.with_(value=sorted(set(v) ^ {e}))
    elif isinstance(v, dict):
        ((k, x),) = v.items()
        ops[i] = op.with_(value={k: (x if x is None else x + 17) or 23})
    elif model_name == "counter":
        ops[i] = op.with_(value=v + 17)
    else:
        # A fence token repeated: the first ok acquire's (or one below it).
        first = next(o.value for o in ops if o.is_ok and o.f == "acquire"
                     and o.value is not None)
        ops[i] = op.with_(value=first if first != v else max(v - 1, 0))
    return History(ops, reindex=False)


def _lagged_txns(seed: int, n_txns: int, lag: Optional[tuple], depth: int,
                 key_count: int, max_txn_length: int, n_procs: int, mop):
    """The store loop both simulators share. Txn ``i`` runs on a random
    process over distinct random keys; each key's micro-ops come from
    ``mop(rng, key, seen_len, ops_out)``, where ``seen_len`` is the number
    of committed versions of the key the txn may see: all of them, or,
    inside the lag window ``[lo, hi)`` of txn indices, those committed up
    to a random 1..``depth`` txns earlier (a replica behind a partition).
    Txns run one after another: an invoke, then its ok."""
    rng = random.Random(seed)
    lens = [0] * key_count  # committed versions per key
    past: list[list[int]] = [list(lens)]  # past[t]: lens after t txns
    ops: list[Op] = []
    for i in range(n_txns):
        p = rng.randrange(n_procs)
        keys = rng.sample(range(key_count), rng.randint(1, min(max_txn_length, key_count)))
        lagged = lag is not None and lag[0] <= i < lag[1]
        snap = past[max(0, i - rng.randint(1, depth))] if lagged else lens
        invoke, done = [], []
        for k in keys:
            lens[k] += mop(rng, k, snap[k], invoke, done)
        past.append(list(lens))
        ops.append(Op("invoke", p, "txn", invoke, time=2 * i))
        ops.append(Op("ok", p, "txn", done, time=2 * i + 1))
    return History(ops)


def lagged_append_history(seed: int, n_txns: int, lag: Optional[tuple] = None,
                          depth: int = 16, key_count: int = 8, max_txn_length: int = 5,
                          n_procs: int = 10) -> History:
    """A list-append history (``["append", k, v]`` / ``["r", k, list]``,
    values unique per key) from a serial store whose reads inside the lag
    window see stale prefixes (see :func:`_lagged_txns`). Serializable
    outside the window; a stale read closes rw cycles inside it."""
    lists: dict[int, list] = {}

    def mop(rng, k, seen, invoke, done) -> int:
        versions = lists.setdefault(k, [])
        if rng.random() < 0.5:
            v = len(versions) + 1
            versions.append(v)
            invoke.append(["append", k, v])
            done.append(["append", k, v])
            return 1
        invoke.append(["r", k, None])
        done.append(["r", k, versions[:seen]])
        return 0

    return _lagged_txns(seed, n_txns, lag, depth, key_count, max_txn_length, n_procs, mop)


def lagged_wr_history(seed: int, n_txns: int, lag: Optional[tuple] = None,
                      depth: int = 16, key_count: int = 8, max_txn_length: int = 5,
                      n_procs: int = 10) -> History:
    """A rw-register history (``["w", k, v]`` with globally unique ``v`` /
    ``["r", k, v]``) from the same store loop: per key a read, a write, or
    a read then a write (which fixes the version order under
    ``wfr_keys``)."""
    regs: dict[int, list] = {}
    counter = [0]

    def mop(rng, k, seen, invoke, done) -> int:
        versions = regs.setdefault(k, [])
        kind = rng.randrange(3)
        if kind != 1:  # read (alone, or before a write)
            invoke.append(["r", k, None])
            done.append(["r", k, versions[seen - 1] if seen else None])
        if kind == 0:
            return 0
        counter[0] += 1
        versions.append(counter[0])
        invoke.append(["w", k, counter[0]])
        done.append(["w", k, counter[0]])
        return 1

    return _lagged_txns(seed, n_txns, lag, depth, key_count, max_txn_length, n_procs, mop)


# Key families of the radix sort's tests: stability (equal and two distinct
# keys), pass skipping (a zero top byte, as the compaction key fprio has at
# PB = 14: PB + 7 bits), presorted and reversed rows, and random keys.
SORT_KEY_FAMILIES = ("equal", "two", "top_byte", "sorted", "reversed", "random")


def sort_keys(family: str, nb: int, n: int, seed: int = 0):
    """``[nb, n]`` int32 keys (u32 bit patterns) of one family, drawn with
    numpy from ``seed``; each member's row on its own."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, size=(nb, n), dtype=np.uint64).astype(np.uint32)
    if family == "equal":
        u[:] = u[:, :1]
    elif family == "two":
        pair = rng.integers(0, 2**32, size=(nb, 2), dtype=np.uint64).astype(np.uint32)
        u = np.where(rng.random((nb, n)) < 0.5, pair[:, :1], pair[:, 1:])
    elif family == "top_byte":
        u = u >> np.uint32(32 - (14 + 7))
    elif family == "sorted":
        u = np.sort(u, axis=1)
    elif family == "reversed":
        u = np.sort(u, axis=1)[:, ::-1]
    elif family != "random":
        raise ValueError(f"unknown key family {family!r} (expected one of {SORT_KEY_FAMILIES})")
    return np.array(u, dtype=np.uint32, order="C").view(np.int32)  # a copy, strides >= 0


# Validity patterns of one member's stage-1 rows (``stage1_case``): none,
# one row, every row, exactly P, P + 1, and random 5% / 50% of the rows.
STAGE1_DENSITIES = ("none", "one", "all", "exactly_P", "P_plus_1", "p05", "p50")


def stage1_case(seed: int, nb: int, M: int, P: int, NC: int, density: str) -> tuple:
    """Seeded numpy inputs of one two-stage ``wgl_level.stage1_hash`` call
    on ``nb`` members: ``(rows [nb, M, NC] int32, nvalid [nb, M] uint8 with
    random nonzero bytes where valid, ctl [nb, CTL_SIZE] int32 (go, and
    n_cand the count of valid rows, as the expand leaves it), drows [nb,
    P, NC] and fkey [nb, P] int32: what the outputs held before)``."""
    import numpy as np

    from .ops import wgl_level as lv

    if density not in STAGE1_DENSITIES:
        raise ValueError(f"unknown density {density!r} (expected one of {STAGE1_DENSITIES})")
    rng = np.random.default_rng(seed)
    word = lambda *shape: rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)  # noqa: E731
    rows = word(nb, M, NC)
    want = {"none": 0, "one": 1, "all": M, "exactly_P": P, "P_plus_1": P + 1,
            "p05": int(0.05 * M), "p50": int(0.5 * M)}[density]
    nvalid = np.zeros((nb, M), dtype=np.uint8)
    for b in range(nb):
        idx = rng.choice(M, size=min(want, M), replace=False)
        nvalid[b, idx] = rng.integers(1, 256, len(idx), dtype=np.int64).astype(np.uint8)
    ctl = np.zeros((nb, lv.CTL_SIZE), dtype=np.int32)
    ctl[:, lv.CTL_GO] = 1
    ctl[:, lv.CTL_NEXP] = (nvalid != 0).sum(axis=1)
    return rows, nvalid, ctl, word(nb, P, NC), word(nb, P)


# Group families of the prune's tests (``prune_case``): every row its own
# group; one group over all rows; groups that begin 16 rows past a
# multiple of 32 and run 32, 64, 160 or 1280 rows, so that every tile and
# halo boundary falls inside a group and some outlast the largest tile; and
# short groups with half the rows invalid, anywhere in the order.
PRUNE_FAMILIES = ("distinct", "one_group", "straddle", "half_invalid")


def prune_case(seed: int, nb: int, L: int, NC: int, NID: int, family: str) -> tuple:
    """Seeded numpy inputs of one ``wgl_level.prune`` call on ``nb`` members
    of ``L`` rows of ``NC`` words (``NID`` identity words, then the open
    words): ``(drows [nb, L, NC], skey [nb, L], perm [nb, L], ctl [nb,
    CTL_SIZE] (go), fprio [nb, L])``, int32 bit patterns. Row ``i`` of the
    sorted order is ``drows[b, perm[b, i]]``; rows of one group share their
    identity words and draw their open words from six bits, so that the
    subset rules fire; a key's sign bit marks an invalid row."""
    import numpy as np

    from .ops import wgl_level as lv

    if family not in PRUNE_FAMILIES:
        raise ValueError(f"unknown family {family!r} (expected one of {PRUNE_FAMILIES})")
    rng = np.random.default_rng(seed)
    drows = np.zeros((nb, L, NC), dtype=np.uint32)
    skey = np.zeros((nb, L), dtype=np.uint32)
    perm = np.zeros((nb, L), dtype=np.int32)
    idx = np.arange(L)
    for b in range(nb):
        valid = np.ones(L, dtype=bool)
        if family == "distinct":
            gid = idx.copy()
        elif family == "one_group":
            gid = np.zeros(L, dtype=np.int64)
        elif family == "straddle":
            starts, pos = [0], 16
            while pos < L:
                starts.append(pos)
                pos += 32 * int(rng.choice([1, 2, 5, 40]))
            gid = np.searchsorted(np.asarray(starts), idx, side="right") - 1
        else:
            gid = np.cumsum(rng.random(L) < 0.3)
            valid = rng.random(L) < 0.5
        gid = gid.astype(np.uint64) + np.uint64(1000 * b)
        ident = [gid & np.uint64(0x3F)] + [
            (gid * np.uint64(2654435761) + np.uint64(k)) & np.uint64(0xFFFFFFFF)
            for k in range(1, NID)]
        rows = np.stack(ident + [rng.integers(0, 64, L).astype(np.uint64)
                                 for _ in range(NC - NID)], axis=1).astype(np.uint32)
        hsh = ((gid * np.uint64(2246822519)) >> np.uint64(1)) & np.uint64(0x7FFFFFFF)
        skey[b] = (hsh | np.where(valid, 0, 0x80000000).astype(np.uint64)).astype(np.uint32)
        perm[b] = rng.permutation(L).astype(np.int32)
        drows[b, perm[b]] = rows
    ctl = np.zeros((nb, lv.CTL_SIZE), dtype=np.int32)
    ctl[:, lv.CTL_GO] = 1
    fprio = rng.integers(-2**31, 2**31, (nb, L), dtype=np.int64).astype(np.int32)
    return drows.view(np.int32), skey.view(np.int32), perm, ctl, fprio


# Key columns of the take-col sort's tests (``take_sort_case``): random
# keys, an all-zero column (an open-mask word with no open op: every digit
# uniform, so a sort alone would write nothing) and all-equal keys.
TAKE_SORT_FAMILIES = ("random", "zero", "equal")


def take_sort_case(seed: int, nb: int, n: int, stride: int, col: int, family: str) -> tuple:
    """Seeded numpy inputs of one ``wgl_level.take_col_sort`` call on ``nb``
    members of ``n`` pairs: ``(src [nb, n, stride] ([nb, n] when stride is
    1) whose column ``col`` holds keys of the family, keys [nb, n] (stale
    values), vals [nb, n]: each member a permutation of its rows)``,
    int32 bit patterns."""
    import numpy as np

    if family not in TAKE_SORT_FAMILIES:
        raise ValueError(f"unknown family {family!r} (expected one of {TAKE_SORT_FAMILIES})")
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2**31, 2**31, (nb, n, stride), dtype=np.int64).astype(np.int32)
    rows[:, :, col] = 0 if family == "zero" else sort_keys(family, nb, n, seed)
    src = rows if stride > 1 else np.ascontiguousarray(rows[:, :, 0])
    keys = rng.integers(-9, 9, (nb, n)).astype(np.int32)
    vals = np.stack([rng.permutation(n) for _ in range(nb)]).astype(np.int32)
    return src, keys, vals


# A level's end for ``gather_case``: members that fit, overflow (lossy or
# not) or run dry, the dead arms alone, and both sharded arms.
GATHER_CASES = ("single", "single_dead", "single_stuck", "alltoall", "allgather")


def gather_case(seed: int, case: str, nb: int, F: int, P: int) -> tuple:
    """Seeded inputs of one level's compaction sort and gather-finalize on
    ``nb`` members (the shards of one mesh in a sharded case) at capacity
    ``F`` and ``P`` stage-1 rows: ``(geometry, drows [nb, L, NC], perm [nb,
    L]: the dedup order, fprio [nb, L]: priorities with ties, ctl [nb,
    CTL_SIZE])``, numpy int32 but for the geometry. ``single``: counts
    around F (member 0's F // 2, the rest up to F + 9), half the members
    lossy; ``single_dead``: every member's rows overflowed, lossless;
    ``single_stuck``: every count zero; the sharded cases hold the reduced
    fields the prune's cross-shard reduce would have written."""
    import numpy as np

    from .ops import wgl_level as lv

    if case not in GATHER_CASES:
        raise ValueError(f"unknown case {case!r} (expected one of {GATHER_CASES})")
    rng = np.random.default_rng(seed)
    mode = case if case in lv.EXCHANGES else None
    g = lv.Geometry(F=F, W=32, KO=1, S=2, ND=64, NO=32, B=8, SEL=True, two_stage=True, P=P,
                    D=nb if mode else 1, exchange=mode)
    L = g.L
    drows = rng.integers(-2**31, 2**31, (nb, L, g.NC), dtype=np.int64).astype(np.int32)
    perm = np.stack([rng.permutation(L) for _ in range(nb)]).astype(np.int32)
    fprio = rng.integers(0, 7, (nb, L)).astype(np.int32) << 6
    ctl = np.zeros((nb, lv.CTL_SIZE), dtype=np.int32)
    ctl[:, lv.CTL_GO] = 1
    ctl[:, lv.CTL_LVL], ctl[:, lv.CTL_MAXLVL], ctl[:, lv.CTL_FMAX] = 7, 50, 3
    ctl[:, lv.CTL_FCOUNT] = rng.integers(1, F, nb)
    ctl[:, lv.CTL_NEXP] = rng.integers(0, P, nb)
    ctl[:, lv.CTL_COUNT] = rng.integers(0, F + 10, nb)
    if case == "single":
        ctl[:, lv.CTL_COUNT] = rng.integers(1, F + 10, nb)
        ctl[0, lv.CTL_COUNT] = F // 2
        ctl[:, lv.CTL_LOSSY] = rng.random(nb) < 0.5
    elif case == "single_dead":
        ctl[:, lv.CTL_ROWOVF] = 1
    elif case == "single_stuck":
        ctl[:, lv.CTL_COUNT] = 0
    else:
        ctl[:, lv.CTL_GCOUNT] = int(ctl[:, lv.CTL_COUNT].sum()) if mode == "alltoall" \
            else int(rng.integers(F, F * nb + 5))
        ctl[:, lv.CTL_NSUM] = int(ctl[:, lv.CTL_FCOUNT].sum())
    return g, drows, perm, fprio, ctl


# CUgraphNodeType values (cuda.h).
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def device_work(call) -> dict:
    """The device work one ``call()`` issues on the card, counted exactly:
    the call runs under CUDA stream capture (relaxed mode, on a side stream
    made current), so nothing executes and nothing is sampled, and the
    nodes of the captured graph are counted by kind: ``{"kernel": n,
    "memcpy": n, "memset": n, "other": n}``. ``call`` must issue all its
    work on the current stream and must not synchronize; call it once
    before, so that first-use set-up (kernel attributes, module loading)
    is out of the count."""
    import ctypes

    import torch

    drv = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"device_work: {what} failed with CUresult {rc}")

    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    handle, graph = ctypes.c_void_p(stream.cuda_stream), ctypes.c_void_p()
    with torch.cuda.stream(stream):
        ok(drv.cuStreamBeginCapture_v2(handle, ctypes.c_int(2)), "cuStreamBeginCapture")
        try:
            call()
        finally:
            rc = drv.cuStreamEndCapture(handle, ctypes.byref(graph))
    try:
        ok(rc, "cuStreamEndCapture")
        n = ctypes.c_size_t(0)
        ok(drv.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * max(n.value, 1))()
        ok(drv.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        out = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}
        for node in nodes[:n.value]:
            kind = ctypes.c_int(-1)
            ok(drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
            out[_NODE_KINDS.get(kind.value, "other")] += 1
        return out
    finally:
        if graph.value:
            drv.cuGraphDestroy(graph)
