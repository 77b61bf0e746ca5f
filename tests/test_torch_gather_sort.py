"""The two stages that fold the level's index work into their neighbours,
on the CPU: the take-col sort (the sort-key gather done where the sort
loads its keys) and the one-launch gather-finalize (which reads the rows
in compaction order straight from the compaction sort's values).

``take_col_sort_plain`` (what ``wgl_take_col_sort`` is held to on the
card) against the two-stage ``take_col_plain`` + ``radix_sort_pairs_plain``
sequence it replaces and against numpy; the level's dedup and compaction
orders built from it against the JAX reference's lexicographic
``lax.sort``; ``gather_finalize_reference`` on the carried ``perm``
against the parent's ``perm[order]`` form, written out in numpy here;
and the argument checks of both wrappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.testing import (GATHER_CASES, TAKE_SORT_FAMILIES, gather_case, sort_keys,
                                      take_sort_case)

NC = 5  # the north star's row: p, two window words, state, open word


def _two_stage(src, col, keys, vals, ctl, ident):
    """The parent's sequence: the identity reset (first key only), the
    take_col launch, then the sort."""
    if ident:
        go = range(vals.shape[0]) if ctl is None else \
            [b for b in range(vals.shape[0]) if int(ctl[b, lv.CTL_GO])]
        for b in go:
            vals[b] = torch.arange(vals.shape[1], dtype=torch.int32)
    lv.take_col_plain(src, col, vals, keys, ctl)
    lv.radix_sort_pairs_plain(keys, vals, None, ctl)


@pytest.mark.parametrize("family", TAKE_SORT_FAMILIES)
@pytest.mark.parametrize("stride", [1, NC])
@pytest.mark.parametrize("ident", [True, False])
def test_take_col_sort_is_take_col_then_sort(ident, stride, family):
    nb, n = 3, 700
    col = 3 if stride > 1 else 0
    src, keys0, vals0 = map(torch.from_numpy,
                            take_sort_case(stride * 10 + ident, nb, n, stride, col, family))
    k, v = keys0.clone(), vals0.clone()
    lv.take_col_sort(src, col, k, v, lv.sort_scratch(n, "cpu", nb), None, ident)
    kw, vw = keys0.clone(), vals0.clone()
    _two_stage(src, col, kw, vw, None, ident)
    assert torch.equal(k, kw) and torch.equal(v, vw)
    # and numpy: the stable order of the column read through the values
    s = src.numpy() if stride > 1 else src.numpy()[:, :, None]
    idx = np.broadcast_to(np.arange(n), (nb, n)) if ident else vals0.numpy()
    column = np.take_along_axis(s[:, :, col], idx, 1)
    order = np.argsort(column.view(np.uint32), axis=1, kind="stable")
    np.testing.assert_array_equal(k.numpy(), np.take_along_axis(column, order, 1))
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(idx, order, 1))


@pytest.mark.parametrize("ident", [True, False])
def test_take_col_sort_leaves_a_stopped_member_untouched(ident):
    nb, n = 3, 300
    src, keys0, vals0 = map(torch.from_numpy, take_sort_case(9, nb, n, NC, 4, "random"))
    ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32)
    ctl[:, lv.CTL_GO] = 1
    ctl[1, lv.CTL_GO] = 0
    k, v = keys0.clone(), vals0.clone()
    lv.take_col_sort_plain(src, 4, k, v, None, ctl, ident)
    assert torch.equal(k[1], keys0[1]) and torch.equal(v[1], vals0[1])
    kw, vw = keys0.clone(), vals0.clone()
    _two_stage(src, 4, kw, vw, ctl, ident)
    assert torch.equal(k, kw) and torch.equal(v, vw)


@pytest.mark.parametrize("seed", range(3))
def test_take_col_sorts_compose_to_the_reference_orders(seed):
    """The level's dedup order (``_dedup_stages``: the open column from the
    identity, then the fused key through the order so far) is the
    reference's lexicographic ``lax.sort(..., num_keys=2)`` with the row
    index as the payload; the compaction sort of (fprio, perm) leaves in
    perm the dedup order's rows in the reference's compaction order."""
    rng = np.random.default_rng(seed)
    n = 3000
    fkey = (rng.integers(0, 40, size=n).astype(np.uint32) << np.uint32(25)).view(np.int32)
    drows = rng.integers(-2**31, 2**31, (1, n, NC), dtype=np.int64).astype(np.int32)
    drows[0, :, 4] = rng.integers(0, 4, size=n)
    ocol = drows[0, :, 4].view(np.uint32)
    keys, perm = torch.zeros((1, n), dtype=torch.int32), torch.full((1, n), -1, dtype=torch.int32)
    scratch = lv.sort_scratch(n, "cpu")
    lv.take_col_sort(torch.from_numpy(drows), 4, keys, perm, scratch, None, True)
    lv.take_col_sort(torch.from_numpy(fkey[None].copy()), 0, keys, perm, scratch, None, False)
    iota = jnp.arange(n, dtype=jnp.uint32)
    dedup = jax.lax.sort((jnp.asarray(fkey.view(np.uint32)), jnp.asarray(ocol), iota),
                         num_keys=2)[2]
    np.testing.assert_array_equal(perm[0].numpy(), np.asarray(dedup).astype(np.int32))
    np.testing.assert_array_equal(keys[0].numpy(), fkey[np.asarray(dedup)])
    fprio = sort_keys("top_byte", 1, n, seed=seed)
    lv.radix_sort_pairs(torch.from_numpy(fprio.copy()), perm, scratch)
    order = jax.lax.sort((jnp.asarray(fprio[0].view(np.uint32)), iota), num_keys=2)[1]
    np.testing.assert_array_equal(perm[0].numpy(), np.asarray(dedup)[np.asarray(order)])


# -- gather-finalize ---------------------------------------------------------

def _parent_gather_finalize(g, drows, perm, order, c, s):
    """The parent's form of one member's gather and carry update, in
    numpy: frontier slot k holds row perm[order[off + k]]. Returns the
    frontier's five arrays (None when the level is dead), the control
    block after it and the stats row (None when sharded)."""
    c = list(c)
    lossy = c[lv.CTL_LOSSY] != 0
    if g.exchange:
        count, ovf_now = c[lv.CTL_GCOUNT], bool(c[lv.CTL_GOVF])
        kept = min(c[lv.CTL_COUNT], g.F) if g.exchange == "alltoall" else \
            max(0, min(min(count, g.F * g.D) - s * g.F, g.F))
        off = s * g.F if g.exchange == "allgather" else 0
    else:
        count = c[lv.CTL_COUNT]
        ovf_now = bool(c[lv.CTL_ROWOVF]) or (g.two_stage and c[lv.CTL_NEXP] > g.P) \
            or count > g.F
        kept, off = min(count, g.F), 0
    stuck_now = count == 0 and not (ovf_now and not lossy)
    dead = (ovf_now and not lossy) or count == 0
    fr = None
    if not dead:
        k = np.arange(g.F)
        rows = drows[perm[order[off:off + g.F]]] * (k < kept)[:, None]
        KD, S = g.KD, g.S
        fr = (rows[:, 0], rows[:, 1:1 + KD], rows[:, 1 + KD + S:], rows[:, 1 + KD:1 + KD + S],
              (k < kept).astype(np.uint8))
    lvl = c[lv.CTL_LVL]
    fcount = c[lv.CTL_FCOUNT] if dead else kept
    row = None
    if g.exchange:
        fm, nonempty = min(c[lv.CTL_GCOUNT], g.F * g.D), c[lv.CTL_NSUM] > 0
    else:
        fm, nonempty = kept, fcount > 0
        row = [lvl + 1, kept, c[lv.CTL_NEXP], int(ovf_now)]
    acc = c[lv.CTL_ACC] | c[lv.CTL_ACCNOW]
    ovf = c[lv.CTL_OVF] | int(ovf_now)
    stuck = c[lv.CTL_STUCK] | int(stuck_now)
    lvl2 = lvl if dead else lvl + 1
    go = not acc and (lossy or not ovf) and not stuck and nonempty and lvl2 < c[lv.CTL_MAXLVL]
    c[lv.CTL_LVL], c[lv.CTL_ACC], c[lv.CTL_OVF] = lvl2, acc, ovf
    c[lv.CTL_FMAX] = max(c[lv.CTL_FMAX], fm)
    c[lv.CTL_STUCK], c[lv.CTL_FCOUNT], c[lv.CTL_GO] = stuck, fcount, int(go)
    c[lv.CTL_NEXP] = c[lv.CTL_ACCNOW] = c[lv.CTL_ROWOVF] = c[lv.CTL_COUNT] = 0
    return fr, c, row


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_finalize_on_the_carried_perm_is_the_parent_form(case):
    D = 3 if case in lv.EXCHANGES else 2
    g, drows, perm, fprio, ctl = gather_case(21, case, D, 40, 90)
    # the parent: the compaction sort of (fprio, iota), the gather through
    # perm[order]
    order = np.argsort(fprio.view(np.uint32), axis=1, kind="stable")
    want = [_parent_gather_finalize(g, drows[s], perm[s], order[s], ctl[s], s) for s in range(D)]
    # the level now: the compaction sort carries perm, the gather reads it
    fr0 = tuple(torch.from_numpy(a) for a in (
        np.full((D, g.F), 5, np.int32), np.full((D, g.F, g.KD), 6, np.int32),
        np.full((D, g.F, g.KO1), 7, np.int32), np.full((D, g.F, g.S), 8, np.int32),
        np.ones((D, g.F), np.uint8)))
    fr = tuple(t.clone() for t in fr0)
    c, pm = torch.from_numpy(ctl.copy()), torch.from_numpy(perm.copy())
    stats = torch.zeros((D, lv.LEVEL_STAT_ROWS, 4), dtype=torch.int32)
    lv.radix_sort_pairs(torch.from_numpy(fprio.copy()), pm, lv.sort_scratch(g.L, "cpu", D), c)
    np.testing.assert_array_equal(pm.numpy(), np.take_along_axis(perm, order, 1))
    lv.gather_finalize(g, torch.from_numpy(drows), pm, c, stats, fr, lv.gather_scratch(D, "cpu"))
    for s, (wfr, wc, wrow) in enumerate(want):
        got = [a[s].numpy() for a in fr]
        for a, b in zip(got, wfr if wfr is not None else [a[s].numpy() for a in fr0]):
            np.testing.assert_array_equal(a, b)
        assert c[s].tolist() == wc
        ring = torch.zeros_like(stats[s])
        if wrow is not None:  # the level's row (lvl + 1), none when sharded
            ring[8] = torch.tensor(wrow, dtype=torch.int32)
        assert torch.equal(stats[s], ring)
    dead = [w[0] is None for w in want]
    assert dead == {"single_dead": [True, True], "single_stuck": [True, True]}.get(case, dead)
    assert case != "single" or not dead[0]


# -- the wrappers' argument checks ---------------------------------------------

@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """The wrappers' argument packing with the device checks stubbed out,
    so their shape and scratch checks run on CPU tensors."""
    monkeypatch.setattr(lv, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(lv, "_stream", lambda: 0)


@pytest.mark.parametrize("path", lv.SORT_PATHS)
def test_take_col_sort_args_are_the_gather_then_the_sort(as_if_on_the_card, path):
    """The entry point takes the gather (source, its member stride, row
    stride, column, identity flag) followed by ``radix_sort_pairs``' own
    arguments."""
    nb, n = 2, 300
    src = torch.zeros((nb, n, NC), dtype=torch.int32)
    keys, vals = torch.zeros((nb, n), dtype=torch.int32), torch.zeros((nb, n), dtype=torch.int32)
    scratch = lv.sort_scratch(n, "cpu", nb, path=path)
    args = lv._take_col_sort_args(src, 3, keys, vals, scratch, None, True)
    sort = lv._radix_sort_pairs_args(keys, vals, scratch, None)
    val = lambda a: getattr(a, "value", a)  # noqa: E731
    assert [val(a) for a in args[:5]] == [src.data_ptr(), n * NC, NC, 3, 1]
    assert [val(a) for a in args[5:]] == [val(a) for a in sort]
    args = lv._take_col_sort_args(src[:, :, 0].contiguous(), 0, keys, vals, scratch, None, False)
    assert [val(a) for a in args[1:5]] == [n, 1, 0, 0]


@pytest.mark.parametrize("case", ["col", "members", "rank", "short_ident", "short", "overlap_keys",
                                  "overlap_vals", "scratch"])
def test_take_col_sort_args_refuse(as_if_on_the_card, case):
    nb, n = 2, 300
    src = torch.zeros((nb, n, NC), dtype=torch.int32)
    keys, vals = torch.zeros((nb, n), dtype=torch.int32), torch.zeros((nb, n), dtype=torch.int32)
    scratch, col, ident = lv.sort_scratch(n, "cpu", nb), 2, False
    if case == "col":
        col = NC
    elif case == "members":
        src = torch.zeros((nb + 1, n, NC), dtype=torch.int32)
    elif case == "rank":
        src = torch.zeros((nb * n * NC,), dtype=torch.int32)
    elif case in ("short_ident", "short"):  # rows [0, n) of src must exist
        src, ident = torch.zeros((nb, n - 1, NC), dtype=torch.int32), case == "short_ident"
    elif case == "overlap_keys":
        src, col = keys, 0
    elif case == "overlap_vals":
        both = torch.zeros((nb + 1, n), dtype=torch.int32)
        src, vals, col = both[:nb], both[1:], 0
    else:
        scratch = lv.sort_scratch(n - 1, "cpu", nb, path="onesweep")
    with pytest.raises(ValueError, match="take_col_sort|radix_sort_pairs"):
        lv._take_col_sort_args(src, col, keys, vals, scratch, None, ident)


def test_gather_finalize_args_need_the_ticket_scratch(as_if_on_the_card):
    """The entry point takes perm (the rows in compaction order, no separate
    order) and one ticket word a member."""
    nb = 2
    g = lv.Geometry(F=16, W=32, KO=1, S=1, ND=64, NO=32, B=4, SEL=True, two_stage=False, P=64)
    ws = lv.BatchWorkspace(g, nb, "cpu")
    fr = tuple(torch.zeros((nb, g.F) + tuple(s), dtype=d) for s, d in (
        ((), torch.int32), ((g.KD,), torch.int32), ((g.KO1,), torch.int32), ((g.S,), torch.int32),
        ((), torch.uint8)))
    args = lv._gather_finalize_args(g, ws.drows, ws.perm, ws.ctl, ws.stats, fr, ws.gf)
    assert len(args) == len(lv._build.SIGNATURES["wgl_gather_finalize"])
    assert args[1].value == ws.perm.data_ptr() and args[9].value == ws.gf.data_ptr()
    assert tuple(ws.gf.shape) == (nb,) and int(ws.gf.abs().sum()) == 0
    with pytest.raises(ValueError, match="ticket scratch"):
        lv._gather_finalize_args(g, ws.drows, ws.perm, ws.ctl, ws.stats, fr, None)
    with pytest.raises(ValueError, match="ticket scratch"):
        lv._gather_finalize_args(g, ws.drows, ws.perm, ws.ctl, ws.stats, fr, ws.gf[:1])
