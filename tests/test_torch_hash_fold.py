"""The fused keys written where a level's rows are written, against the
JAX package.

A single-stage level (``M <= BIG_M_THRESHOLD``) has no stage 1: its expand
writes each row's fused key. A sharded level's received rows get their keys
from the stage that writes them: the alltoall's route (the owner test's
hash), the allgather's exchange (stage 1's keys of the source's rows). No
level hashes its rows in a launch of its own. Here the plain versions'
keys are held bit for bit against ``hash_rows_reference`` (the plain hash
of the rows in place, the yardstick) and against the reference's fused key
(``ops/wgl.py:628-645``) computed with ``jax.numpy``; and whole chunks of
the port, on the CPU, against the reference's ``_build_kernel`` (a
single-stage level) and its sharded program (both exchanges) on the
conftest's 8-device CPU mesh: verdict, final level, every stats row and
the frontier. Inputs are made from numpy seeds.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.parallel import make_mesh as ref_make_mesh
from jepsen_tpu.parallel.frontier import _sharded_kernel
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.testing import stage1_case

MODES = ("alltoall", "allgather")
KEY_INVALID_I32 = lv.KEY_INVALID - 2**32  # the sign bit alone, as an int32 bit pattern


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain stages run many small ops: one intra-op thread each keeps
    a worker from oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_fkey(rows, valid, NID):
    """The reference's fused key of int32 rows (``ops/wgl.py:628-645``), as
    an int32 bit pattern: FNV over the identity columns, shifted right by
    one, the sign bit where the row is invalid."""
    mat = jnp.asarray(np.ascontiguousarray(rows).view(np.uint32))
    u32 = jnp.uint32
    gh = jnp.full((mat.shape[0],), u32(2166136261))
    for c in range(NID):
        gh = (gh ^ mat[:, c]) * u32(16777619)
    key = jnp.where(jnp.asarray(valid), gh >> 1, (gh >> 1) | u32(0x80000000))
    return np.asarray(key).view(np.int32)


def _yardstick(g, drows, rvalid, ctl, fkey):
    """``hash_rows_reference`` of each member's rows (a fresh key buffer)."""
    want = fkey.clone()
    lv.vmap_members(lv.hash_rows_reference)(g, drows, rvalid, ctl, want)
    return want


def _assert_keys_of_rows(g, ctl, drows, rvalid, fkey, before):
    """Every going member's keys equal the yardstick and the reference's
    fused key of its rows, slot by slot; an empty slot's is the zero row's
    key; a stopped member's keys are what they were."""
    want = _yardstick(g, drows, rvalid, ctl, fkey)
    for d in range(ctl.shape[0]):
        if not int(ctl[d, lv.CTL_GO]):
            assert torch.equal(fkey[d], before[d])
            continue
        assert torch.equal(fkey[d], want[d])
        np.testing.assert_array_equal(
            fkey[d].numpy(), ref_fkey(drows[d, :, :g.NID].numpy(), rvalid[d].numpy() != 0,
                                      g.NID))
        empty = rvalid[d] == 0
        assert (fkey[d][empty] == lv.zero_row_key(g.NID)).all()


def _route_inputs(D, S, variant, P=61):
    """An alltoall geometry of D shards (state width S) and seeded stage-1
    rows: n_cand below P, above P and 0 across the shards; ``overflow``
    puts every second row of a shard in one group (its owner's bucket
    overflows at D > 1); ``stopped`` stops the last shard."""
    g = lv.Geometry(F=8, W=32, KO=1, S=S, ND=64, NO=32, B=8, SEL=False, two_stage=True, P=P,
                    D=D, exchange="alltoall")
    rng = np.random.default_rng(1000 * D + 10 * S + len(variant))
    crows = rng.integers(-2**31, 2**31, (D, P, g.NC), dtype=np.int64).astype(np.int32)
    if variant == "overflow":
        crows[:, ::2, :g.NID] = crows[:, :1, :g.NID]
    ctl = torch.zeros((D, lv.CTL_SIZE), dtype=torch.int32)
    ctl[:, lv.CTL_GO] = 1
    ctl[:, lv.CTL_NEXP] = torch.tensor([(P - 5, P + 3, 0, P // 2)[s % 4] for s in range(D)])
    if variant == "stopped":
        ctl[D - 1, lv.CTL_GO] = 0
    return g, torch.from_numpy(crows), ctl


@pytest.mark.parametrize("variant", ["plain", "stopped", "overflow"])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_route_plain_keys_are_the_hash_of_the_received_rows(D, S, variant):
    """route_plain's keys (the owner test's hash, shifted right by one,
    beside each routed row; the zero row's key in an empty slot) equal
    ``hash_rows_reference`` and the reference's fused key over its
    received rows on every slot; a stopped shard's are not written; a
    bucket overflow sets the source's flag, its routed rows keyed as
    ever."""
    g, crows, ctl = _route_inputs(D, S, variant)
    drows = torch.full((D, g.L, g.NC), 0x5A5A5A5A, dtype=torch.int32)
    rvalid = torch.full((D, g.L), 7, dtype=torch.uint8)
    fkey = torch.full((D, g.L), 13, dtype=torch.int32)
    before = fkey.clone()
    lv.route_plain(g, crows, ctl, drows, rvalid, None, fkey)
    _assert_keys_of_rows(g, ctl, drows, rvalid, fkey, before)
    assert int((rvalid == 1).sum()) > 0 or variant == "stopped" and D == 1
    if variant == "overflow" and D > 1:
        assert int(ctl[:, lv.CTL_ROWOVF].max()) == 1


@pytest.mark.parametrize("density", ["none", "p05", "p50", "P_plus_1"])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_allgather_stage1_and_exchange_keys(D, S, density):
    """The allgather level's stage 1 writes its survivors' keys (the
    reference's, bit for bit) and no others; the exchange copies them
    beside the rows and gives every row past a source's n_cand the zero
    row's key: the received keys equal ``hash_rows_reference`` over the
    received rows on every slot."""
    NC, M, P = 3 + S, 300, 40
    g = lv.Geometry(F=10, W=32, KO=1, S=S, ND=64, NO=32, B=30, SEL=False, two_stage=True, P=P,
                    D=D, exchange="allgather")
    assert g.NC == NC and g.M == M
    rows, nvalid, ctl, crows, ckey = (torch.from_numpy(a) for a in
                                      stage1_case(D * 7 + S, D, M, P, NC, density))
    ckey0 = ckey.clone()
    if D == 3:  # a stopped shard's stage 1 writes nothing
        c1, k1 = ctl.clone(), ckey.clone()
        c1[1, lv.CTL_GO] = 0
        lv.stage1_hash_plain(g, rows, nvalid, c1, crows.clone(), k1, None)
        assert torch.equal(k1[1], ckey0[1])
    lv.stage1_hash_plain(g, rows, nvalid, ctl, crows, ckey, None)
    for b in range(D):
        n = min(int(ctl[b, lv.CTL_NEXP]), P)
        np.testing.assert_array_equal(ckey[b, :n].numpy(),
                                      ref_fkey(crows[b, :n, :g.NID].numpy(),
                                               np.ones(n, bool), g.NID))
        assert torch.equal(ckey[b, n:], ckey0[b, n:])  # the exchange keys the rest
    if D == 3:  # a stopped destination is not written (the shards stop together)
        ctl[1, lv.CTL_GO] = 0
    recv = torch.full((D, g.L, NC), 0x5A5A5A5A, dtype=torch.int32)
    rvalid = torch.full((D, g.L), 7, dtype=torch.uint8)
    fkey = torch.full((D, g.L), 13, dtype=torch.int32)
    before = fkey.clone()
    lv.exchange_plain(g, crows, ctl, recv, rvalid, ckey, fkey)
    _assert_keys_of_rows(g, ctl, recv, rvalid, fkey, before)


def _single_stage_level(crash_p, sel, seed=5, F=32, warm=4):
    """A single-stage level of a seeded register history (the reference's
    plan carried across): the geometry, tables and a frontier warmed
    ``warm`` plain beam levels, with its control block at the next
    level's start."""
    h = ref_random(random.Random(seed), n_ops=60, n_procs=6, crash_p=crash_p)
    plan = ref_wgl.plan_device(ref_encode(RefCas(init=0), h))
    assert plan.ok, plan.reason
    B = plan.B if sel else None
    port = wgl.stack_plans([wgl.plan_from_arrays(plan.dims, plan.args, plan.nD, plan.nO,
                                                 plan.init_state, B, device="cpu")], "cpu")
    g = wgl.level_geometry(port, F)
    assert not g.two_stage and g.SEL == bool(sel and B)
    fr = wgl.initial_frontier_batch(F, g.W, g.KO, port.init_state)
    ws = lv.BatchWorkspace(g, 1, "cpu")
    flags = lv.run_chunk_batch(lv.PLAIN, g, port.tabs, fr, ws, [0], [warm], [1],
                               port.nD.tolist(), port.nO.tolist(), CasRegister(init=0))
    ctl = torch.zeros((1, lv.CTL_SIZE), dtype=torch.int32)
    lv.chunk_init_plain(ctl, fr[4], None, [(flags[0][3], flags[0][3] + 1, 1, int(port.nD[0]),
                                            int(port.nO[0]))])
    assert int(ctl[0, lv.CTL_GO]) == 1
    return g, port, fr, ctl


@pytest.mark.parametrize("sel", [True, False])
@pytest.mark.parametrize("crash_p", [0.0, 0.2])
def test_single_stage_expand_keys(crash_p, sel):
    """A single-stage expand's keys: on every valid slot the key the
    removed single-stage hash wrote (``hash_rows_reference`` of the rows in
    place) and the reference's fused key; on every other slot the sign bit
    alone. The rows and validity are the expand's without keys."""
    g, port, fr, ctl = _single_stage_level(crash_p, sel)
    outs = []
    for keyed in (True, False):
        c = ctl.clone()
        rows = torch.zeros((1, g.M, g.NC), dtype=torch.int32)
        nval = torch.zeros((1, g.M), dtype=torch.uint8)
        fkey = torch.full((1, g.M), 13, dtype=torch.int32) if keyed else None
        lv.expand(g, port.tabs, fr, c, rows, nval, CasRegister(init=0), fkey)
        outs.append((c, rows, nval, fkey))
    (c, rows, nval, fkey), (c2, rows2, nval2, _) = outs
    assert torch.equal(c, c2) and torch.equal(rows, rows2) and torch.equal(nval, nval2)
    vm = nval[0].bool()
    assert 0 < int(vm.sum()) < g.M
    today = _yardstick(g, rows, nval, c, torch.zeros_like(fkey))
    assert torch.equal(fkey[0][vm], today[0][vm])
    np.testing.assert_array_equal(
        fkey[0][vm].numpy(), ref_fkey(rows[0, vm, :g.NID].numpy(), np.ones(int(vm.sum()), bool),
                                      g.NID))
    assert (fkey[0][~vm] == KEY_INVALID_I32).all()
    assert (fkey[0] < 0).tolist() == (~vm).tolist()


def test_single_stage_level_reads_no_invalid_row():
    """Nothing after a single-stage expand reads an invalid slot's row (the
    kernel does not write it; its key is the sign bit alone): the level
    with every invalid row overwritten by seeded garbage ends with the same
    frontier, control block and stats ring."""
    g, port, fr, ctl = _single_stage_level(0.2, True, seed=9)
    results = []
    for poison in (False, True):
        f = tuple(a.clone() for a in fr)
        ws = lv.BatchWorkspace(g, 1, "cpu")
        ws.ctl.copy_(ctl)
        stages = lv._level_stages(g, port.tabs, f, ws, CasRegister(init=0))
        assert [s for s, _a in stages][:2] == ["expand", "take_col_sort"]
        for i, (stage, args) in enumerate(stages):
            getattr(lv.KERNELS, stage)(*args)
            if i == 0 and poison:
                bad = ~ws.nvalid.bool()
                garbage = np.random.default_rng(3).integers(-2**31, 2**31, ws.rows.shape,
                                                            dtype=np.int64).astype(np.int32)
                ws.rows[bad] = torch.from_numpy(garbage)[bad]
        results.append((f, ws.ctl.clone(), ws.stats.clone()))
    (f0, c0, s0), (f1, c1, s1) = results
    assert all(torch.equal(a, b) for a, b in zip(f0, f1))
    assert torch.equal(c0, c1) and torch.equal(s0, s1)
    assert int(c0[0, lv.CTL_FCOUNT]) > 0


# (seed, n_ops, crash_p, perturb, F)
SINGLE = [(21, 50, 0.1, False, 32), (22, 60, 0.2, True, 16), (23, 40, 0.0, False, 64)]


@pytest.mark.parametrize("case", SINGLE, ids=[f"s{c[0]}" for c in SINGLE])
def test_single_stage_chunk_matches_reference(case):
    """A whole single-stage chunk (no stage 1: the expand writes the keys)
    against the reference's ``_build_kernel`` on the CPU: the flags
    (verdict, final level), every stats row and the frontier."""
    seed, n_ops, crash_p, perturb, F = case
    rng = random.Random(seed)
    h = ref_random(rng, n_ops=n_ops, n_procs=5, crash_p=crash_p)
    if perturb:
        h = ref_perturb(rng, h)
    enc = ref_encode(RefCas(init=0), h)
    plan = ref_wgl.plan_device(enc)
    assert plan.ok, plan.reason
    W, KO, S, ND, NO = plan.dims
    _, kern = ref_wgl._build_kernel(ref_wgl._model_cache_key(enc.model), F, W, KO, S, ND, NO,
                                    B=plan.B, collect_stats=True)
    total = int(plan.args[2])
    fr = ref_wgl.initial_frontier(F, W, KO, S, plan.init_state)
    out = kern(*plan.args[:2], np.int32(total), *plan.args[3:], *fr[:5], np.int32(fr[5]),
               np.int32(0))
    ref_flags = [int(x) for x in np.asarray(out[0])]
    ref_stats, ref_front = np.asarray(out[1]), [np.asarray(a) for a in out[-5:]]
    port = wgl.plan_from_arrays(plan.dims, plan.args, plan.nD, plan.nO, plan.init_state,
                                plan.B, device="cpu")
    g = wgl.level_geometry(port, F)
    assert not g.two_stage
    pfr = wgl.frontier_from_arrays(*fr, device="cpu")
    ws = lv.BatchWorkspace(g, 1, "cpu")
    assert "stage1_hash" not in [s for s, _a in lv._level_stages(
        g, {k: t[None] for k, t in port.tabs.items()}, tuple(a[None] for a in pfr[:5]), ws,
        CasRegister(init=0))]
    flags = lv.run_chunk(lv.KERNELS, g, port.tabs, pfr[:5], ws, int(fr[5]), total, False,
                         port.nD, port.nO, CasRegister(init=0))
    assert flags == ref_flags
    levels = flags[3]
    rows = [(lv_ + 1) % lv.LEVEL_STAT_ROWS for lv_ in range(int(fr[5]), levels)]
    assert ws.stats[0, rows].tolist() == ref_stats[rows].tolist()
    for name, a, b in zip(("p", "mD", "mO", "st", "valid"),
                          wgl.frontier_to_arrays(pfr[:5] + (levels,))[:5], ref_front):
        np.testing.assert_array_equal(a, b, err_msg=name)


_MESHES = {}


@pytest.mark.parametrize("D", [2, 8])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_chunk_with_folded_keys_matches_reference(mode, D):
    """A whole sharded chunk, its received keys written by the route or
    the exchange (no hash stage), against the reference's sharded program
    on the CPU mesh: the 8 flags (verdict, final level) and the global
    frontier."""
    F = 16
    rng = random.Random(40 + D)
    enc = ref_encode(RefCas(init=0), ref_random(rng, n_ops=70, n_procs=4, crash_p=0.05,
                                                cas=True))
    plan = ref_wgl.plan_device(enc, pad_to=(64, 1, 128, 32))
    assert plan.ok, plan.reason
    W, KO, S, ND, NO = plan.dims
    if D not in _MESHES:
        _MESHES[D] = ref_make_mesh(D, shape=(D, 1))
    kern = _sharded_kernel(ref_wgl._model_cache_key(enc.model), F, W, KO, S, ND, NO, "dp",
                           _MESHES[D], B=None, exchange=mode)
    total = int(plan.args[2])
    fr = ref_wgl.initial_frontier(F * D, W, KO, S, plan.init_state)
    out = kern(plan.args[0], plan.args[1], np.int32(total), *plan.args[3:], *fr[:5],
               np.int32(fr[5]), np.int32(0))
    ref_flags = [int(x) for x in np.asarray(out[0])]
    port = wgl.plan_from_arrays(plan.dims, plan.args, plan.nD, plan.nO, plan.init_state, None,
                                device="cpu")
    g = wgl.sharded_geometry(port, F, D, mode)
    tabs = {k: v[None].expand((D,) + tuple(v.shape)).contiguous() for k, v in port.tabs.items()}
    pfr = wgl.frontier_from_arrays(*fr, device="cpu", n_shards=D)
    ws = lv.BatchWorkspace(g, D, "cpu")
    stages = [s for s, _a in lv._sharded_level_stages(g, tabs, pfr[:5], ws, CasRegister(init=0))]
    assert stages[:3] == ["expand", "stage1_hash", "route" if mode == "alltoall" else "exchange"]
    assert stages[3] == "take_col_sort" and len(stages) == 7 + g.KO1
    flags = lv.run_chunk_sharded(lv.KERNELS, g, tabs, pfr[:5], ws, int(fr[5]), total, False,
                                 port.nD, port.nO, CasRegister(init=0))
    assert flags == ref_flags
    got = wgl.frontier_to_arrays(pfr[:5] + (flags[3],), sharded=True)
    for name, a, b in zip(("p", "mD", "mO", "st", "valid"), got, out[1:6]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name} {mode} D={D}")
