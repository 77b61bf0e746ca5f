"""The chunk start as one launch (``ops.wgl_level.chunk_init``), on the
CPU: its plain version against the sequence it replaced (the control
blocks built on the host and copied in, the stats rings zeroed, then each
member's frontier count and the reference's stop test, ``ops/wgl.py:
830-843``; sharded, then the chunk-start reduce), for one member, three and
100 (each its own row in the launch's parameters, or one shared row),
sharded D 1, 2 and 8, stopped members (no budget left, an empty frontier;
in the ladder table, accepted, overflowed and stuck members of the
previous chunk), stale control blocks and rings; the ladder table's rule
against the batch driver's own; and the batch driver through the table
(a batch above ``CS_INLINE`` members) against the reference."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.parallel.batch import check_encoded_batch as ref_check_encoded_batch
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.ops.encode import encode_history
from jepsen_tpu_torch.parallel import check_encoded_batch
from jepsen_tpu_torch.testing import perturb_history, random_register_history


def old_sequence(ctl, valid, stats, lists, sharded=False):
    """The parent's chunk start: the control blocks built on the host from
    ``lists = (lvl0, max_levels, lossy, nD, nO)`` and copied in, the stats
    rings zeroed, then each member's count and stop test from its control
    block (the reference's loop condition), and the reduce when sharded."""
    nb = ctl.shape[0]
    init = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32)
    lvl0, max_levels, lossy, nD, nO = lists
    init[:, lv.CTL_LVL] = torch.as_tensor(list(lvl0), dtype=torch.int32)
    init[:, lv.CTL_FMAX] = 1
    init[:, lv.CTL_MAXLVL] = torch.as_tensor(list(max_levels), dtype=torch.int32)
    init[:, lv.CTL_LOSSY] = torch.as_tensor([int(x) for x in lossy], dtype=torch.int32)
    init[:, lv.CTL_ND] = torch.as_tensor(list(nD), dtype=torch.int32)
    init[:, lv.CTL_NO] = torch.as_tensor(list(nO), dtype=torch.int32)
    ctl.copy_(init)
    if stats is not None:
        stats.zero_()
    for b in range(nb):
        c = ctl[b].tolist()
        fcount = int(valid[b].sum())
        go = (not c[lv.CTL_ACC] and (c[lv.CTL_LOSSY] or not c[lv.CTL_OVF])
              and not c[lv.CTL_STUCK] and fcount > 0 and c[lv.CTL_LVL] < c[lv.CTL_MAXLVL])
        ctl[b, lv.CTL_FCOUNT] = fcount
        ctl[b, lv.CTL_GO] = int(go)
    if sharded:
        lv.shard_reduce_plain(None, ctl, 0)


def _case(rng, nb, F, shared=False, stopped=True):
    valid = torch.from_numpy((rng.random((nb, F)) < rng.random((nb, 1))).astype(np.uint8))
    n = 1 if shared else nb
    lvl0 = rng.integers(0, 9000, n)
    budget = lvl0 + rng.integers(1, 200, n)
    if stopped and n > 2:
        budget[::4] = lvl0[::4]              # no budget left
        budget[1::5] = lvl0[1::5] - 3        # a resumed level past its budget
    if stopped and nb > 2:
        valid[2::3] = 0                       # an empty frontier
    lists = tuple(x.tolist() * (nb // n) for x in (
        lvl0, budget, rng.integers(0, 2, n), rng.integers(1, 10001, n), rng.integers(0, 9, n)))
    return valid, lists


def _stale(rng, nb):
    return (torch.from_numpy(rng.integers(-9, 9, (nb, lv.CTL_SIZE)).astype(np.int32)),
            torch.from_numpy(rng.integers(-9, 9, (nb, lv.LEVEL_STAT_ROWS, 4)).astype(np.int32)))


@pytest.mark.parametrize("nb", [1, 3, 100])
@pytest.mark.parametrize("shared", [False, True])
def test_chunk_start_matches_the_old_sequence(nb, shared):
    """Control blocks and stats rings equal to the parent's sequence, from
    stale buffers, rows in the parameters (a row a member, or one shared
    row), stopped members among them."""
    rng = np.random.default_rng(nb + 10 * shared)
    for _trial in range(3):
        valid, lists = _case(rng, nb, 64, shared)
        rows = lv.chunk_rows(*lists)
        assert len(rows) == (1 if shared or nb == 1 else nb)
        ctl, stats = _stale(rng, nb)
        want, want_stats = ctl.clone(), stats.clone()
        lv.chunk_init(ctl, valid, stats, rows)
        old_sequence(want, valid, want_stats, lists)
        assert torch.equal(ctl, want) and torch.equal(stats, want_stats)
        go = ctl[:, lv.CTL_GO]
        if nb > 10:
            assert 0 < int(go.sum()) < nb  # some members stopped, some not


@pytest.mark.parametrize("D", [1, 2, 8])
def test_sharded_chunk_start_matches_the_old_sequence(D):
    """The sharded start (one shared row, the ticket): each shard's count,
    the reduce's sum, max and min and the global stop test, as the
    parent's sequence and its reduce gave; the ticket is left zero."""
    rng = np.random.default_rng(70 + D)
    for trial in range(4):
        valid, lists = _case(rng, D, 32, shared=True, stopped=False)
        if trial == 1:
            valid.zero_()
        if trial == 2:
            lists = (lists[0], lists[0]) + lists[2:]  # no budget left
        ticket = lv.gather_scratch(D, "cpu")
        ctl, stats = _stale(rng, D)
        want, want_stats = ctl.clone(), stats.clone()
        lv.chunk_init(ctl, valid, stats, lv.chunk_rows(*lists), ticket)
        old_sequence(want, valid, want_stats, lists, sharded=True)
        assert torch.equal(ctl, want) and torch.equal(stats, want_stats)
        assert int(ticket.abs().sum()) == 0
        assert (ctl[:, lv.CTL_NSUM] == int(valid.sum())).all()


def _batch_rule(ctl_rows, lsub, active, totals, lossy, lpc):
    """The batch driver's rule (``parallel/batch.py``) from one chunk's
    flags: the next chunk's ``lvl0``, budgets and active members."""
    acc = np.array([r[lv.CTL_ACC] for r in ctl_rows], bool)
    ovf = np.array([r[lv.CTL_OVF] for r in ctl_rows], bool)
    nonempty = np.array([r[lv.CTL_FCOUNT] > 0 and not r[lv.CTL_STUCK] for r in ctl_rows], bool)
    lsub = np.where(active, [r[lv.CTL_LVL] for r in ctl_rows], lsub)
    keep = ~acc & nonempty & (lsub < totals)
    active = active & (keep if lossy else keep & ~ovf)
    return lsub, np.where(active, np.minimum(totals, lsub + lpc), lsub), active


@pytest.mark.parametrize("lossy", [False, True])
def test_ladder_table_follows_the_batch_rule(lossy):
    """The ladder table's chunks (the rung's first, then from what the
    previous chunk's levels left: accepted, overflowed, stuck, emptied,
    at the total) give the control blocks the batch driver's own rule
    gives through the parent's sequence; the table's active flags are the
    driver's active members."""
    rng = np.random.default_rng(5 + lossy)
    nb, F, lpc = 9, 16, 5
    totals = rng.integers(1, 30, nb)
    lsub = np.minimum(rng.integers(0, 20, nb), totals)
    nD, nO = rng.integers(1, 99, nb), rng.integers(0, 9, nb)
    table = lv.ladder_table(lsub, totals, [lossy] * nb, nD, nO, "cpu")
    ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32)
    active = np.ones(nb, bool)
    budgets = np.minimum(totals, lsub + lpc)
    for _chunk in range(4):
        valid = torch.from_numpy((rng.random((nb, F)) < 0.6).astype(np.uint8))
        want = ctl.clone()
        old_sequence(want, valid, None, (lsub, budgets, [lossy] * nb, nD, nO))
        lv.chunk_init(ctl, valid, None, None, table=table, lpc=lpc)
        assert torch.equal(ctl, want)
        assert table[:, lv.CS_ACTIVE].tolist() == active.astype(int).tolist()
        # what the chunk's levels leave
        step = rng.integers(0, lpc + 1, nb)
        ctl[:, lv.CTL_LVL] = torch.from_numpy(
            np.minimum(ctl[:, lv.CTL_LVL].numpy() + step, ctl[:, lv.CTL_MAXLVL].numpy()))
        for col in (lv.CTL_ACC, lv.CTL_OVF, lv.CTL_STUCK):
            ctl[:, col] = torch.from_numpy((rng.random(nb) < 0.15).astype(np.int32))
        lsub, budgets, active = _batch_rule(ctl.tolist(), lsub, active, totals, lossy, lpc)


def test_rows_above_the_inline_capacity_need_the_table():
    """A row a member above CS_INLINE members is refused (the launch's
    parameters hold CS_INLINE rows); one shared row serves any batch."""
    nb = lv.CS_INLINE + 1
    valid = torch.ones((nb, 4), dtype=torch.uint8)
    ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32)
    rows = [(0, 5 + b, 0, 3, 0) for b in range(nb)]
    with pytest.raises(ValueError, match="ladder table"):
        lv._chunk_init_args(ctl, valid, None, rows)
    lv.chunk_init(ctl, valid, None, rows[:1])
    assert (ctl[:, lv.CTL_GO] == 1).all() and (ctl[:, lv.CTL_MAXLVL] == 5).all()


def _hists(n):
    h1, h2 = [], []
    for i in range(n):
        r1, r2 = random.Random(300 + i), random.Random(300 + i)
        kw = dict(n_ops=16 + 2 * (i % 5), n_procs=4, cas=True, crash_p=0.1)
        a, b = ref_random(r1, **kw), random_register_history(r2, **kw)
        if i % 3 == 1:
            a, b = ref_perturb(r1, a), perturb_history(r2, b)
        h1.append(a)
        h2.append(b)
    return h1, h2


@pytest.mark.parametrize("kw", [dict(f=2, f_schedule=(4, 8), levels_per_call=3),
                                dict(f=4, f_schedule=(4, 16), levels_per_call=4)],
                         ids=["serial", "ladder"])
def test_batch_through_the_ladder_table_matches_reference(monkeypatch, kw):
    """With CS_INLINE below the batch, every chunk start of every rung reads
    the ladder table: the results equal the reference's and the run's with
    the rows in the parameters (the driver's budgets are checked against
    the control blocks after every chunk)."""
    h1, h2 = _hists(7)
    encs = [encode_history(CasRegister(init=0), h) for h in h2]
    inline = check_encoded_batch(encs, device="cpu", **kw)
    starts = []
    real = lv.chunk_init_plain

    def spy(ctl, valid, stats, rows, ticket=None, table=None, lpc=0):
        starts.append(rows is None)
        return real(ctl, valid, stats, rows, ticket, table, lpc)

    monkeypatch.setattr(lv, "CS_INLINE", 2)
    monkeypatch.setattr(lv, "chunk_init_plain", spy)
    table = check_encoded_batch(encs, device="cpu", **kw)
    ref = ref_check_encoded_batch([ref_encode(RefCas(init=0), h) for h in h1], mesh=None, **kw)
    keys = ("valid", "levels", "frontier_max", "escalated", "decided_at_F", "beam")
    for a, b, r in zip(table, inline, ref):
        assert all(a.get(k) == b.get(k) == r.get(k) for k in keys)
        assert a.get("rungs") == b.get("rungs") or \
            [x["calls"] for x in a["rungs"]] == [x["calls"] for x in b["rungs"]]
    assert any(starts) and len(starts) > 3


def test_chunk_whose_budget_disagrees_raises(monkeypatch):
    """The driver holds every chunk's control blocks to its own budgets: a
    chunk start that set another budget fails the chunk."""
    h = random_register_history(random.Random(3), n_ops=20, n_procs=4, cas=True)
    real = lv.chunk_init_plain

    def off_by_one(ctl, valid, stats, rows, ticket=None, table=None, lpc=0):
        rows = [(a, b + 1, c, d, e) for a, b, c, d, e in rows]
        return real(ctl, valid, stats, rows, ticket, table, lpc)

    monkeypatch.setattr(lv, "chunk_init_plain", off_by_one)
    with pytest.raises(RuntimeError, match="level budgets"):
        wgl.check_encoded_device(encode_history(CasRegister(init=0), h), levels_per_call=4,
                                 device="cpu")
