"""One batched chunk of the port against the JAX reference's vmapped level
program (``_build_batch_kernel``), from the same stacked tables and
frontiers: exact equality of the ``[nb, 6]`` flags and of all five
returned frontier arrays. Also the regroup against ``_regroup_program``.

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


@pytest.mark.parametrize("idx", [[0, 2, 2, 1], [1], [2, 0]])
def test_regroup_matches_reference(idx):
    rng = np.random.default_rng(9)
    nb, F, KD, KO1, S, F_new = 3, 8, 2, 1, 1, 32
    fr5 = [rng.integers(-2**31, 2**31 - 1, size=(nb, F), dtype=np.int64).astype(np.int32),
           rng.integers(0, 2**32, size=(nb, F, KD), dtype=np.uint64).astype(np.uint32),
           rng.integers(0, 2**32, size=(nb, F, KO1), dtype=np.uint64).astype(np.uint32),
           rng.integers(0, 9, size=(nb, F, S), dtype=np.int64).astype(np.int32),
           rng.random((nb, F)) < 0.5]
    want = ref_batch._regroup_program(F_new)(np.asarray(idx, np.int32), *fr5)
    port = wgl.frontier_stack_from_arrays(*fr5, device="cpu")
    got = wgl.frontier_stack_to_arrays(lv.regroup(port, idx, F_new))
    ref_got = wgl.frontier_stack_to_arrays(lv.regroup_reference(port, idx, F_new))
    for a, b, c in zip(got, ref_got, want):
        np.testing.assert_array_equal(a, np.asarray(c))
        np.testing.assert_array_equal(b, np.asarray(c))


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


@pytest.mark.parametrize("KO", [0, 2])
def test_level_program_packs_each_launch_once(KO, monkeypatch):
    """The kernel path's level program checks and packs its launches once
    per chunk: a level is the wrappers' launches in ``run_level_batch``'s
    order with the wrappers' own arguments (no copies: the first dedup
    sort makes the identity order itself, the compaction sort carries the
    dedup order), and one count per launch: ``KO1 + 6`` launches a level
    with open words, 6 without."""
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
                                           CasRegister(init=0))),
            ("wgl_stage1_hash", lv._stage1_hash_args(g, ws.rows, ws.nvalid, ws.ctl, ws.drows,
                                                     ws.fkey, ws.s1))]
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
    assert len(want) == (g.KO1 + 6 if KO else 6)
    assert [a[4] for n, a in want if n == "wgl_take_col_sort"] == [1] + [0] * (len(keys) - 1)
    assert not hasattr(ws, "order") and not hasattr(ws, "iota")
    assert lv.LAUNCHES == {"wgl_chunk_init": 0, "wgl_expand": 2, "wgl_stage1_hash": 2,
                           "wgl_take_col_sort": 2 * len(keys),
                           "radix_sort_pairs": 2, "wgl_prune": 2,
                           "wgl_gather_finalize": 2, "wgl_regroup": 0, "wgl_route": 0,
                           "wgl_exchange": 0}
    lib.rc = 700
    monkeypatch.setattr(lv._build, "error_string", lambda rc: "an illegal memory access")
    with pytest.raises(RuntimeError, match="wgl_expand: CUDA error 700"):
        prog()
