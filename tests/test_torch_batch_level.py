"""One batched chunk of the port against the JAX reference's vmapped level
program (``_build_batch_kernel``), from the same stacked tables and
frontiers: exact equality of the ``[nb, 6]`` flags and of all five
returned frontier arrays. Also the regroup against ``_regroup_program``,
``_pad_program`` and the sharded escalation's grow, and the launches a
level program packs.

Members differ in length, in their true op counts ``nD``/``nO`` (the
tables are padded to common dims) and in their starting levels; some are
perturbed. The port runs on the CPU (the plain stages, once per member);
tables and frontiers are carried across with ``stack_from_arrays`` and
``frontier_stack_from_arrays``."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.parallel import batch as ref_batch
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops import wgl_level as lv

# (id, members as (seed, n_ops, crash_p, perturb), F, two_stage)
CASES = [
    ("nb1-single-stage", [(100, 24, 0.1, False)], 16, False),
    ("nb3-two-stage", [(101, 20, 0.1, False), (102, 30, 0.25, True),
                       (103, 26, 0.0, False)], 16, True),
    ("nb5-single-stage", [(104, 18, 0.2, True), (105, 34, 0.1, False),
                          (106, 22, 0.3, False), (107, 28, 0.0, True),
                          (108, 16, 0.15, False)], 16, False),
]


def _encs(members):
    out = []
    for seed, n_ops, crash_p, perturb in members:
        rng = random.Random(seed)
        h = ref_random(rng, n_ops=n_ops, n_procs=5, crash_p=crash_p)
        if perturb:
            h = ref_perturb(rng, h)
        out.append(ref_encode(RefCas(init=0), h))
    return out


@pytest.fixture
def two_stage_threshold(monkeypatch):
    """Lower the two-stage threshold in both packages, with the
    reference's compiled programs dropped before and after."""
    def set_(on):
        if on:
            monkeypatch.setattr(ref_wgl, "BIG_M_THRESHOLD", 64)
            monkeypatch.setattr(wgl, "BIG_M_THRESHOLD", 64)
        ref_wgl._build_kernel.cache_clear()
        ref_wgl._build_batch_kernel.cache_clear()
    yield set_
    ref_wgl._build_kernel.cache_clear()
    ref_wgl._build_batch_kernel.cache_clear()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_batched_chunk_matches_reference(case, two_stage_threshold):
    _id, members, F, two_stage = case
    two_stage_threshold(two_stage)
    encs = _encs(members)
    nb = len(encs)
    plans = [ref_wgl.plan_device(e) for e in encs]
    dims = np.array([p.dims for p in plans])
    W, KO, ND, NO = (int(dims[:, k].max()) for k in (0, 1, 3, 4))
    S = int(dims[0, 2])
    padded = [ref_wgl.plan_device(e, pad_to=(W, KO, ND, NO)) for e in encs]
    Bs = [p.B for p in padded]
    B = None if any(b is None for b in Bs) else max(Bs)
    cols = [np.stack(c) for c in zip(*[p.args for p in padded])]
    assert nb == 1 or len(set(cols[0].tolist())) > 1, "members should differ in nD"
    kern = ref_wgl._build_batch_kernel(ref_wgl._model_cache_key(encs[0].model),
                                       F, W, KO, S, ND, NO, B=B)

    def ref_chunk(fr5, lvl0, budgets, lossy):
        out = kern(cols[0], cols[1], np.asarray(budgets, np.int32), *cols[3:9], *fr5,
                   np.asarray(lvl0, np.int32), np.asarray(lossy, np.int32))
        return np.asarray(out[0]), [np.asarray(a) for a in out[1:]]

    # Warm each member's frontier as a beam to its own level.
    fr0 = [np.stack(c) for c in zip(*[ref_wgl.initial_frontier(F, W, KO, S, p.init_state)[:5]
                                      for p in padded])]
    warm = [3 + 2 * b for b in range(nb)]
    wflags, wfr = ref_chunk(fr0, [0] * nb, warm, [1] * nb)
    lvl0 = wflags[:, 3].tolist()

    port_plan = wgl.stack_from_arrays(cols, (W, KO, S, ND, NO),
                                      np.stack([p.init_state for p in padded]), B,
                                      device="cpu")
    g = wgl.level_geometry(port_plan, F)
    assert g.two_stage == two_stage and g.SEL == (B is not None and B < g.C)
    for lossy in (0, 1):
        budgets = [lv0 + 6 for lv0 in lvl0]
        ref_flags, ref_fr = ref_chunk(wfr, lvl0, budgets, [lossy] * nb)
        port_fr = wgl.frontier_stack_from_arrays(*wfr, device="cpu")
        ws = lv.BatchWorkspace(g, nb, "cpu")
        flags = lv.run_chunk_batch(lv.KERNELS, g, port_plan.tabs, port_fr, ws, lvl0,
                                   budgets, [lossy] * nb, port_plan.nD.tolist(),
                                   port_plan.nO.tolist(), CasRegister(init=0))
        assert flags == ref_flags.tolist(), f"lossy={lossy}"
        for name, a, b in zip(("p", "mD", "mO", "st", "valid"),
                              wgl.frontier_stack_to_arrays(port_fr), ref_fr):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} lossy={lossy}")


def test_batched_cases_reach_overflow_and_dead_ends(two_stage_threshold):
    """The members above overflow, get stuck and keep going: checked on the
    port alone from fresh frontiers (cheap)."""
    two_stage_threshold(False)
    seen = set()
    for _id, members, F, _two in CASES:
        encs = _encs(members)
        plans = [ref_wgl.plan_device(e) for e in encs]
        dims = np.array([p.dims for p in plans])
        W, KO, ND, NO = (int(dims[:, k].max()) for k in (0, 1, 3, 4))
        padded = [ref_wgl.plan_device(e, pad_to=(W, KO, ND, NO)) for e in encs]
        cols = [np.stack(c) for c in zip(*[p.args for p in padded])]
        plan = wgl.stack_from_arrays(cols, padded[0].dims,
                                     np.stack([p.init_state for p in padded]),
                                     max(p.B for p in padded), device="cpu")
        g = wgl.level_geometry(plan, F)
        fr = wgl.initial_frontier_batch(F, W, KO, plan.init_state)
        ws = lv.BatchWorkspace(g, len(encs), "cpu")
        flags = lv.run_chunk_batch(lv.KERNELS, g, plan.tabs, fr, ws, [0] * len(encs),
                                   plan.totals.tolist(), [0] * len(encs),
                                   plan.nD.tolist(), plan.nO.tolist(), CasRegister(init=0))
        for acc, ovf, nonempty, *_ in flags:
            seen.add("acc" if acc else "ovf" if ovf else "stuck" if not nonempty else "go")
    assert {"acc", "ovf", "stuck"} <= seen


def _frontier_arrays(rng, nb, F, KD=2, KO1=1, S=1):
    """Seeded stacked frontier arrays in the reference's layout."""
    return [rng.integers(-2**31, 2**31 - 1, size=(nb, F), dtype=np.int64).astype(np.int32),
            rng.integers(0, 2**32, size=(nb, F, KD), dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 2**32, size=(nb, F, KO1), dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 9, size=(nb, F, S), dtype=np.int64).astype(np.int32),
            rng.random((nb, F)) < 0.5]


# (idx, F_old, F_new): repeated indices, no member, the same capacity, and
# capacities whose byte runs are not multiples of 16 (the kernel's copy
# groups): each against the reference's re-batch program.
@pytest.mark.parametrize("idx,F,F_new", [
    pytest.param([0, 2, 2, 1], 8, 32, id="idx0"), pytest.param([1], 8, 32, id="idx1"),
    pytest.param([2, 0], 8, 32, id="idx2"), pytest.param([], 8, 32, id="no_member"),
    pytest.param([1, 1, 0], 24, 24, id="same_capacity"),
    pytest.param([2, 0, 2], 13, 40, id="F_old_13"),
    pytest.param([0], 5, 7, id="F_old_5")])
def test_regroup_matches_reference(idx, F, F_new):
    rng = np.random.default_rng(9)
    nb = 3
    fr5 = _frontier_arrays(rng, nb, F)
    port = wgl.frontier_stack_from_arrays(*fr5, device="cpu")
    got = wgl.frontier_stack_to_arrays(lv.regroup(port, idx, F_new))
    ref_got = wgl.frontier_stack_to_arrays(lv.regroup_reference(port, idx, F_new))
    if idx:
        want = ref_batch._regroup_program(F_new)(np.asarray(idx, np.int32), *fr5)
    else:  # the reference's program takes no empty index: nothing of nothing
        want = [np.zeros((0, F_new) + a.shape[2:], a.dtype) for a in fr5]
    for a, b, c in zip(got, ref_got, want):
        assert a.shape == b.shape == np.asarray(c).shape
        np.testing.assert_array_equal(a, np.asarray(c))
        np.testing.assert_array_equal(b, np.asarray(c))


@pytest.mark.parametrize("F,F_new", [(16, 64), (13, 40), (32, 32)])
def test_regroup_of_one_member_is_the_pad_program(F, F_new):
    """The single search's grow (``wgl._pad_frontier``: the regroup of one
    member) against the reference's ``_pad_program``."""
    fr5 = [a[0] for a in _frontier_arrays(np.random.default_rng(F), 1, F, KD=3, KO1=2, S=2)]
    port = wgl.frontier_from_arrays(*fr5, 7, device="cpu")
    got = wgl.frontier_to_arrays(wgl._pad_frontier(port, F_new, "cpu", lv.KERNELS))
    want = ref_wgl._pad_frontier(tuple(fr5) + (7,), F_new)
    assert got[-1] == int(want[-1]) == 7
    for a, c in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a, np.asarray(c))


@pytest.mark.parametrize("D,F,F_new", [(8, 16, 64), (3, 5, 20), (2, 24, 24)])
def test_regroup_of_the_sharded_frontier_is_the_global_pad(D, F, F_new):
    """The sharded escalation's grow (``wgl.pad_sharded_frontier``: the
    regroup of one member over the flattened ``[D*F]`` arrays) against the
    reference's (``parallel/frontier.py:375``, ``:401``: ``_pad_frontier``
    of the global frontier, resharded at the new capacity)."""
    glob = [a[0] for a in _frontier_arrays(np.random.default_rng(D * F), 1, D * F)]
    port = wgl.frontier_from_arrays(*glob, 3, device="cpu", n_shards=D)
    grown = wgl.pad_sharded_frontier(port, F_new, lv.KERNELS)
    assert grown[0].shape == (D, F_new)
    got = wgl.frontier_to_arrays(grown, sharded=True)
    want = ref_wgl._pad_frontier(tuple(glob) + (3,), D * F_new)
    for a, c in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a, np.asarray(c))


def test_regroup_packs_its_indices_in_the_launch(monkeypatch):
    """The one regroup launch carries up to RG_INLINE member indices
    in its parameters (a host array, no device copy); above that it needs
    them on the device, and the indices must match the new buffers."""
    monkeypatch.setattr(lv, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(lv, "_stream", lambda: 0)
    fr = wgl.initial_frontier_batch(8, 32, 1, torch.zeros((3, 1), dtype=torch.int32))

    def out(n):
        return tuple(torch.zeros((n, 16) + tuple(a.shape[2:]), dtype=a.dtype) for a in fr)

    args = lv._regroup_args(fr, out(3), [2, 0, 2])
    assert args[10].value is None and list(args[11]) == [2, 0, 2]
    assert [a.value for a in args[12:18]] == [3, 8, 16, 1, 1, 1]
    big = [1, 0] * (lv._build.RG_INLINE // 2) + [2]
    with pytest.raises(ValueError, match="indices"):
        lv._regroup_args(fr, out(len(big)), big)
    with pytest.raises(ValueError, match="indices"):
        lv._regroup_args(fr, out(3), [0, 1])
    ix = torch.tensor(big, dtype=torch.int32)
    args = lv._regroup_args(fr, out(len(big)), big, ix)
    assert args[10].value == ix.data_ptr() and args[12].value == lv._build.RG_INLINE + 1


def test_regroup_refuses_shrink_and_bad_index():
    fr = wgl.initial_frontier_batch(8, 32, 1, torch.zeros((2, 1)))
    with pytest.raises(ValueError):
        lv.regroup(fr, [0], 4)
    with pytest.raises(ValueError):
        lv.regroup(fr, [2], 16)


class _FakeLib:
    """Stands in for the kernel library: records each entry point's call
    and returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, [getattr(a, "value", a) for a in args]))
            return self.rc
        return fn


@pytest.mark.parametrize("KO", [0, 2, 1])
def test_level_program_packs_each_launch_once(KO, monkeypatch):
    """The kernel path's level program checks and packs its launches once
    per chunk: a level is the wrappers' launches in ``run_level_batch``'s
    order with the wrappers' own arguments (no copies: the first dedup
    sort makes the identity order itself, the compaction sort carries the
    dedup order; a single-stage level has no stage 1, its expand writes the
    keys), and one count per launch: ``KO1 + 5`` launches a level with open
    words (6 at KO = 1), 5 without."""
    lib = _FakeLib()
    monkeypatch.setattr(lv._build, "load", lambda: lib)
    monkeypatch.setattr(lv, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(lv, "_stream", lambda: 0)
    monkeypatch.setattr(lv, "_sm_count", lambda device: 132)  # the prune's tile
    nb, F, W = 2, 8, 32
    g = lv.Geometry(F=F, W=W, KO=KO, S=1, ND=40, NO=4, B=W + 32 * KO, SEL=False,
                    two_stage=False, P=F * (W + 32 * KO))
    tabs = {"tabD": torch.zeros((nb, g.ND, 8), dtype=torch.int32),
            "sufret": torch.zeros((nb, g.ND + 1), dtype=torch.int32),
            **{k: torch.zeros((nb, g.NO), dtype=torch.int32)
               for k in ("invO", "opO", "a1O", "a2O")}}
    fr = wgl.initial_frontier_batch(F, W, KO, torch.zeros((nb, 1), dtype=torch.int32))
    ws = lv.BatchWorkspace(g, nb, "cpu")
    prog = lv._LevelProgram(g, tabs, fr, ws, CasRegister(init=0))
    lv.reset_launches()
    prog()
    prog()
    keys = [(ws.drows, g.NID + w) for w in reversed(range(g.KO1))] if KO else []
    keys.append((ws.fkey, 0))
    want = [("wgl_expand", lv._expand_args(g, tabs, fr, ws.ctl, ws.rows, ws.nvalid,
                                           CasRegister(init=0), ws.fkey))]
    want += [("wgl_take_col_sort", lv._take_col_sort_args(src, col, ws.keys, ws.perm, ws.sort,
                                                           ws.ctl, j == 0))
             for j, (src, col) in enumerate(keys)]
    want += [("wgl_prune", lv._prune_args(g, ws.drows, ws.keys, ws.perm, ws.ctl, ws.fprio,
                                          ws.pr)),
             ("radix_sort_pairs", lv._radix_sort_pairs_args(ws.fprio, ws.perm, ws.sort,
                                                            ws.ctl)),
             ("wgl_gather_finalize", lv._gather_finalize_args(g, ws.drows, ws.perm, ws.ctl,
                                                              ws.stats, fr, ws.gf))]
    want = [(n, [getattr(a, "value", a) for a in args]) for n, args in want]
    assert lib.calls == want + want
    assert len(want) == (g.KO1 + 5 if KO else 5)
    assert want[0][1][14] == ws.fkey.data_ptr()  # the expand writes the keys
    assert [a[4] for n, a in want if n == "wgl_take_col_sort"] == [1] + [0] * (len(keys) - 1)
    assert not hasattr(ws, "order") and not hasattr(ws, "iota")
    assert lv.LAUNCHES == {"wgl_chunk_init": 0, "wgl_expand": 2, "wgl_stage1_hash": 0,
                           "wgl_take_col_sort": 2 * len(keys),
                           "radix_sort_pairs": 2, "wgl_prune": 2,
                           "wgl_gather_finalize": 2, "wgl_regroup": 0, "wgl_route": 0,
                           "wgl_exchange": 0}
    lib.rc = 700
    monkeypatch.setattr(lv._build, "error_string", lambda rc: "an illegal memory access")
    with pytest.raises(RuntimeError, match="wgl_expand: CUDA error 700"):
        prog()


@pytest.mark.parametrize("KO", [0, 1])
def test_two_stage_level_program_keeps_stage1(KO, monkeypatch):
    """A two-stage level (``M > BIG_M_THRESHOLD``): the expand writes no
    keys, stage 1 compacts the rows and writes them (hashing the invalid
    tail too): ``KO1 + 6`` launches with open words (7 at KO = 1), 6
    without, as before the keys moved into the single-stage expand."""
    lib = _FakeLib()
    monkeypatch.setattr(lv._build, "load", lambda: lib)
    monkeypatch.setattr(lv, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(lv, "_stream", lambda: 0)
    monkeypatch.setattr(lv, "_sm_count", lambda device: 132)
    nb, F, W = 2, 8, 32
    g = lv.Geometry(F=F, W=W, KO=KO, S=1, ND=40, NO=4, B=W + 32 * KO, SEL=False,
                    two_stage=True, P=64)
    tabs = {"tabD": torch.zeros((nb, g.ND, 8), dtype=torch.int32),
            "sufret": torch.zeros((nb, g.ND + 1), dtype=torch.int32),
            **{k: torch.zeros((nb, g.NO), dtype=torch.int32)
               for k in ("invO", "opO", "a1O", "a2O")}}
    fr = wgl.initial_frontier_batch(F, W, KO, torch.zeros((nb, 1), dtype=torch.int32))
    ws = lv.BatchWorkspace(g, nb, "cpu")
    prog = lv._LevelProgram(g, tabs, fr, ws, CasRegister(init=0))
    lv.reset_launches()
    prog()
    names = [n for n, _a in lib.calls]
    assert names == (["wgl_expand", "wgl_stage1_hash"] + ["wgl_take_col_sort"] * (KO + 1)
                     + ["wgl_prune", "radix_sort_pairs", "wgl_gather_finalize"])
    assert len(names) == (g.KO1 + 6 if KO else 6)
    expand_args, s1_args = lib.calls[0][1], lib.calls[1][1]
    assert expand_args[14] is None or expand_args[14] == 0  # no keys from the expand
    assert s1_args[4] == ws.fkey.data_ptr() and s1_args[10] == 1  # stage 1's, and the tail
    assert lv.LAUNCHES["wgl_stage1_hash"] == 1
