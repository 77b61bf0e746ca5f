"""The prune stage on the CPU: the port's plain version against the JAX
reference's own prune, on the seeded group families the card tests feed
the kernel (``testing.prune_case``), and the wrapper's tile and scratch.

The reference's prune (``jepsen_tpu/ops/wgl.py:657-736``) is inline in its
level program, so it is driven there: ``_build_kernel`` at a two-stage
geometry of L = 4F rows, with a spy on ``lax.sort`` that hands the dedup
sort a family's sorted rows instead of its own (through a host callback, so
one trace serves every case) and captures the compaction sort's priority
operand, ``fprio``. ``prune_plain`` must give the same priority for every
row and the keep count its dropped bit implies. The families' duplicate
groups straddle every tile and halo boundary of the kernel and run longer
than its largest tile (1024 rows), so the rows that take the kernel's
look-back on the card are held against the reference here. The kernel
itself is held to ``prune_plain`` on the card (``tests/test_torch_cuda.py``)."""

import random

import jax
import numpy as np
import pytest
import torch
from jax import lax

from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.testing import PRUNE_FAMILIES, prune_case

# (id, pad_to (W, KO, ND, NO), F): L = 4F rows of 1 + KD + 1 + max(KO, 1)
# words; F = 1024 puts 4096 rows, four of the largest tile, in a member.
GEOMETRIES = [("kd1-ko1-L2048", (32, 1, 64, 32), 512),
              ("kd2-ko2-L4096", (64, 2, 64, 64), 1024)]


def _sorted_columns(case, b, NID):
    """Member ``b`` of a prune case as the reference's dedup sort returns
    it: the fused key, the open words, then p, the window words and the
    state (the identity words)."""
    drows, skey, perm = case[0][b].view(np.uint32), case[1][b].view(np.uint32), case[2][b]
    rows = drows[perm]
    return [skey] + [rows[:, c] for c in range(NID, rows.shape[1])] + \
        [rows[:, c] for c in range(NID)]


@pytest.fixture(scope="module", params=GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def reference_prune(request):
    """``(geometry, run)``: ``run(cols)`` runs one level of the reference's
    level program with its dedup sort's output replaced by ``cols`` and
    returns the priority the compaction sort was given."""
    _, pad_to, F = request.param
    h = ref_random(random.Random(7), n_ops=40, n_procs=5, crash_p=0.2)
    enc = ref_encode(RefCas(init=0), h)
    plan = ref_wgl.plan_device(enc, pad_to=pad_to)
    assert plan.ok, plan.reason
    W, KO, S, ND, NO = plan.dims
    g = lv.Geometry(F=F, W=W, KO=KO, S=S, ND=ND, NO=NO, B=1, SEL=False, two_stage=True,
                    P=4 * F)
    current, seen = {}, []
    real_sort = lax.sort

    def sort(operand, dimension=-1, is_stable=True, num_keys=1):
        ops = tuple(operand) if isinstance(operand, (tuple, list)) else (operand,)
        if dimension == 0 and len(ops) == g.NC + 1:  # the dedup sort
            shapes = tuple(jax.ShapeDtypeStruct(o.shape, o.dtype) for o in ops)
            return jax.pure_callback(
                lambda *_: tuple(np.asarray(c, dtype=s.dtype)
                                 for c, s in zip(current["cols"], shapes)), shapes, *ops)
        if dimension == 0 and len(ops) == 2 and num_keys == 2:  # the compaction sort
            jax.debug.callback(lambda x: seen.append(np.asarray(x)), ops[0])
        return real_sort(operand, dimension=dimension, is_stable=is_stable, num_keys=num_keys)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_wgl, "BIG_M_THRESHOLD", 64)
        ref_wgl._build_kernel.cache_clear()
        mp.setattr(lax, "sort", sort)
        _, kern = ref_wgl._build_kernel(ref_wgl._model_cache_key(enc.model), F, W, KO, S, ND,
                                        NO, B=plan.B)
        fr = ref_wgl.initial_frontier(F, W, KO, S, plan.init_state)[:5]

        def run(cols):
            current["cols"] = cols
            seen.clear()
            kern(*plan.args[:2], np.int32(1), *plan.args[3:], *fr, np.int32(0), np.int32(1))
            jax.effects_barrier()
            # One level; its program may hand the priority to the
            # compaction sort more than once, always the same.
            assert seen and all(np.array_equal(x, seen[0]) for x in seen)
            return seen[0]

        # The level really has L = 4F rows (the traced program is kept).
        assert run(_sorted_columns(prune_case(0, 1, g.L, g.NC, g.NID, "distinct"), 0,
                                   g.NID)).shape == (g.L,)
        yield g, run
    ref_wgl._build_kernel.cache_clear()


@pytest.mark.parametrize("family", PRUNE_FAMILIES)
def test_prune_plain_matches_the_reference_level_program(reference_prune, family):
    g, run = reference_prune
    nb = 2
    case = prune_case(g.L + len(family), nb, g.L, g.NC, g.NID, family)
    t = [torch.from_numpy(a.copy()) for a in case]
    lv.prune_plain(g, t[0], t[1], t[2], t[3], t[4])
    for b in range(nb):
        want = run(_sorted_columns(case, b, g.NID))
        np.testing.assert_array_equal(t[4][b].numpy().view(np.uint32), want)
        kept = int(((want >> np.uint32(g.PB + 6)) & 1 == 0).sum())
        assert int(t[3][b, lv.CTL_COUNT]) == kept


def test_prune_families_reach_the_look_back():
    """Each family holds what its name says at the card tests' sizes: the
    straddling groups cover every multiple of 32 and outlast the largest
    tile; one group spans the member; half the rows are invalid."""
    L, NC, NID = 4096, 4, 3
    for family in PRUNE_FAMILIES:
        drows, skey, perm, _, _ = prune_case(1, 1, L, NC, NID, family)
        ident = drows[0][perm[0]][:, :NID]
        start = np.ones(L, dtype=bool)
        start[1:] = (ident[1:] != ident[:-1]).any(axis=1)
        invalid = (skey[0] < 0).mean()
        if family == "distinct":
            assert start.all()
        elif family == "one_group":
            assert start.sum() == 1
        elif family == "straddle":
            assert not start[np.arange(32, L, 32)].any()
            runs = np.diff(np.flatnonzero(np.r_[start, True]))
            assert runs.max() > max(lv.PRUNE_TILES)
        else:
            assert 0.4 < invalid < 0.6
        if family != "half_invalid":
            assert invalid == 0


def _fake_cuda(monkeypatch):
    monkeypatch.setattr(lv, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(lv, "_stream", lambda: 0)
    monkeypatch.setattr(lv, "_sm_count", lambda device: 132)


@pytest.mark.parametrize("L,nb,tile", [(16384, 1, 256), (32768, 8, 1024), (1 << 20, 8, 1024),
                                       (64, 100, 256), (2048, 3, 256)])
def test_prune_tile_and_scratch(L, nb, tile, monkeypatch):
    """The tile rule (the smallest with at most two blocks an SM) and the
    scratch it needs: one 64-bit word a tile of each member after a 4-word
    header, zeroed."""
    _fake_cuda(monkeypatch)
    assert lv.prune_tile(L, nb, 5, 1, "cpu") == tile
    scratch = lv.prune_scratch(L, nb, "cpu")
    assert scratch.numel() >= lv._prune_words(L, nb, tile) == 4 + 2 * nb * -(-L // tile)
    assert not scratch.any()


def test_prune_tile_shrinks_for_wide_rows(monkeypatch):
    """Wide rows take a smaller tile, down to the smallest the scratch is
    sized for; rows too wide even for that are refused."""
    _fake_cuda(monkeypatch)
    tile = lv.prune_tile(1 << 20, 8, 200, 4, "cpu")
    assert tile < 1024 and lv._prune_smem(tile, 200, 4) <= lv._MAX_SMEM
    assert lv._prune_smem(2 * tile, 200, 4) > lv._MAX_SMEM
    assert lv.prune_tile(1 << 20, 8, 400, 4, "cpu") == min(lv.PRUNE_TILES)
    g = lv.Geometry(F=64, W=32, KO=1, S=397, ND=64, NO=32, B=1, SEL=False, two_stage=True,
                    P=4096)
    assert g.NC == 400
    nb, L = 1, g.L
    t = lambda *shape: torch.zeros(shape, dtype=torch.int32)  # noqa: E731
    with pytest.raises(ValueError, match="does not fit a block"):
        lv._prune_args(g, t(nb, L, g.NC), t(nb, L), t(nb, L), t(nb, lv.CTL_SIZE), t(nb, L),
                       lv.prune_scratch(L, nb, "cpu"))


def test_prune_wrapper_refuses_a_short_scratch(monkeypatch):
    _fake_cuda(monkeypatch)
    g = lv.Geometry(F=512, W=32, KO=1, S=1, ND=64, NO=32, B=1, SEL=False, two_stage=True,
                    P=2048)
    nb, L = 3, g.L
    drows = torch.zeros((nb, L, g.NC), dtype=torch.int32)
    keys, perm, fprio = (torch.zeros((nb, L), dtype=torch.int32) for _ in range(3))
    ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32)
    good = lv.prune_scratch(L, nb, "cpu")
    args = lv._prune_args(g, drows, keys, perm, ctl, fprio, good)
    assert args[-2].value == lv.prune_tile(L, nb, g.NC, g.KO1, "cpu")
    with pytest.raises(ValueError, match="scratch too small"):
        lv._prune_args(g, drows, keys, perm, ctl, fprio, good[:-1])
    with pytest.raises(ValueError, match="scratch too small"):
        lv._prune_args(g, drows, keys, perm, ctl, fprio, None)
    with pytest.raises(ValueError, match="shape"):
        lv._prune_args(g, drows[:, :-1], keys, perm, ctl, fprio, good)


def test_expand_wrapper_refuses_a_window_it_cannot_hold(monkeypatch):
    from jepsen_tpu_torch.models import CasRegister

    _fake_cuda(monkeypatch)
    model = CasRegister(init=0)
    for W, ok in ((32, True), (1024, True), (1056, False)):
        g = lv.Geometry(F=4, W=W, KO=1, S=1, ND=64, NO=32, B=8, SEL=True, two_stage=False, P=32)
        nb = 1
        tabs = {"tabD": torch.zeros((nb, g.ND, 8), dtype=torch.int32),
                "sufret": torch.zeros((nb, g.ND + 1), dtype=torch.int32),
                **{k: torch.zeros((nb, g.NO), dtype=torch.int32)
                   for k in ("invO", "opO", "a1O", "a2O")}}
        fr = (torch.zeros((nb, g.F), dtype=torch.int32),
              torch.zeros((nb, g.F, g.KD), dtype=torch.int32),
              torch.zeros((nb, g.F, g.KO1), dtype=torch.int32),
              torch.zeros((nb, g.F, g.S), dtype=torch.int32),
              torch.zeros((nb, g.F), dtype=torch.uint8))
        ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32)
        rows = torch.zeros((nb, g.M, g.NC), dtype=torch.int32)
        nvalid = torch.zeros((nb, g.M), dtype=torch.uint8)
        if ok:
            lv._expand_args(g, tabs, fr, ctl, rows, nvalid, model)
        else:
            with pytest.raises(ValueError, match="multiple of 32 up to 1024"):
                lv._expand_args(g, tabs, fr, ctl, rows, nvalid, model)
