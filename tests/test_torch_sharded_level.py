"""One frontier-sharded chunk of the port against the JAX reference's
sharded program (``parallel/frontier.py`` ``_sharded_kernel``) on the
conftest's 8-virtual-device CPU mesh, from the same plan tables and the
same global frontier: exact equality of the 8 packed flags and of the
five global frontier arrays, at one level, two levels and a whole chunk,
for D in {1, 2, 8} shards under both exchanges. Also the sharded plain
stages (the route with the all_to_all folded in, the all_gather, the
cross-shard reduces in the prune and the chunk start, the sharded
finalize) against NumPy restatements of the reference's lines.

The port runs on the CPU (the plain stages; its D shards are the members
of one batch). Tables cross with ``plan_from_arrays``, frontiers with
``frontier_from_arrays(..., n_shards=D)``."""

import random

import numpy as np
import pytest
import torch

import jepsen_tpu.models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.parallel import make_mesh as ref_make_mesh
from jepsen_tpu.parallel.frontier import _sharded_kernel
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_lock_history as ref_random_lock
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch.models import CasRegister, model_class
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.testing import (PRUNE_FAMILIES, history_model, prune_case,
                                      random_model_history)

MODES = ("alltoall", "allgather")
F = 16  # per shard: the same compiled shapes on every mesh
PAD_TO = (64, 1, 128, 32)  # (W, KO, ND, NO) of every register case
_MESHES = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain stages run many small ops: one intra-op thread each keeps
    a worker from oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_mesh(D):
    if D not in _MESHES:
        _MESHES[D] = ref_make_mesh(D, shape=(D, 1))
    return _MESHES[D]


def register_enc(seed, n_ops=70, n_procs=4, crash_p=0.05, perturb=False):
    rng = random.Random(seed)
    h = ref_random(rng, n_ops=n_ops, n_procs=n_procs, crash_p=crash_p, cas=True)
    if perturb:
        h = ref_perturb(rng, h)
    return ref_encode(ref_models.CasRegister(init=0), h)


class Pair:
    """One encoded history planned in both packages at ``F`` per shard on
    ``D`` shards under ``mode``."""

    def __init__(self, enc, D, mode, pad_to=PAD_TO, B="plan"):
        self.enc, self.D, self.mode = enc, D, mode
        self.plan = plan = ref_wgl.plan_device(enc, pad_to=pad_to)
        assert plan.ok, plan.reason
        self.B = plan.B if B == "plan" else B
        W, KO, S, ND, NO = plan.dims
        self.kern = _sharded_kernel(ref_wgl._model_cache_key(enc.model), F, W, KO, S, ND, NO,
                                    "dp", ref_mesh(D), B=self.B, exchange=mode)
        self.port_plan = wgl.plan_from_arrays(plan.dims, plan.args, plan.nD, plan.nO,
                                              plan.init_state, self.B, device="cpu")
        self.g = wgl.sharded_geometry(self.port_plan, F, D, mode)
        self.tabs = {k: v[None].expand((D,) + tuple(v.shape)).contiguous()
                     for k, v in self.port_plan.tabs.items()}
        self.model = model_class(enc.model.name)._from_cache_key(enc.model.cache_args()) \
            if enc.model.name != "cas-register" else CasRegister(init=0)
        self.total = int(plan.args[2])

    def initial(self):
        W, KO, S, _ND, _NO = self.plan.dims
        return ref_wgl.initial_frontier(F * self.D, W, KO, S, self.plan.init_state)

    def ref_chunk(self, fr, budget):
        args = self.plan.args
        out = self.kern(args[0], args[1], np.int32(budget), *args[3:], *fr[:5],
                        np.int32(fr[5]), np.int32(0))
        flags = [int(x) for x in np.asarray(out[0])]
        return flags, tuple(np.asarray(a) for a in out[1:]) + (np.int32(flags[3]),)

    def port_chunk(self, fr, budget, ws=None):
        pfr = wgl.frontier_from_arrays(*fr, device="cpu", n_shards=self.D)
        ws = ws or lv.BatchWorkspace(self.g, self.D, "cpu")
        flags = lv.run_chunk_sharded(lv.KERNELS, self.g, self.tabs, pfr[:5], ws, int(fr[5]),
                                     budget, False, self.plan.nD, self.plan.nO, self.model)
        return flags, wgl.frontier_to_arrays(pfr[:5] + (flags[3],), sharded=True)

    def check(self, fr, budget):
        """One chunk from ``fr`` in both packages; returns the reference's
        (flags, frontier) after asserting the port's equal."""
        rf, rfr = self.ref_chunk(fr, budget)
        pf, pfr = self.port_chunk(fr, budget)
        assert pf == rf, (self.D, self.mode, budget, pf, rf)
        for name, a, b in zip(("p", "mD", "mO", "st", "valid"), pfr, rfr):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} D={self.D} {self.mode}")
        return rf, rfr


# (id, seed, n_ops, n_procs, crash_p, perturb)
REGISTER = [("r31", 31, 60, 4, 0.05, False), ("r77", 77, 80, 6, 0.1, False),
            ("r63-bad", 63, 70, 4, 0.05, True)]


@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", REGISTER, ids=[c[0] for c in REGISTER])
def test_sharded_chunk_matches_reference(case, mode, D):
    _id, seed, n_ops, n_procs, crash_p, perturb = case
    pair = Pair(register_enc(seed, n_ops, n_procs, crash_p, perturb), D, mode, B=None)
    fr0 = pair.initial()
    _flags, warm = pair.check(fr0, 6)  # a chunk from level 0
    lvl = int(warm[5])
    for lpc in (1, 2):
        pair.check(warm, min(pair.total, lvl + lpc))
    pair.check(warm, pair.total)  # the whole search in one chunk


@pytest.mark.parametrize("mode", MODES)
def test_sharded_chunk_with_candidate_selection(mode):
    """The plan's candidate cap B (row-wise selection before the step)."""
    pair = Pair(register_enc(31, 60, 4, 0.05), 8, mode)
    assert pair.g.SEL
    _f, warm = pair.check(pair.initial(), 8)
    pair.check(warm, pair.total)


def to_ref_history(h):
    return RefHistory([RefOp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                       for o in h], reindex=False)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_chunk_owner_aware_mutex(mode):
    h = ref_random_lock(random.Random(5), n_ops=80, n_procs=4)
    enc = ref_encode(ref_models.OwnerAwareMutex(), h)
    pair = Pair(enc, 8, mode, pad_to=None)
    fr, total = pair.initial(), pair.total
    pair.check(fr, total)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_chunk_multi_register(mode):
    """S = 3 state lanes."""
    port_model = history_model("multi-register")
    h = random_model_history(random.Random(12), "multi-register", 40, 4, 0.05)
    ref_model = ref_models._REGISTRY["multi-register"]._from_cache_key(
        port_model.cache_args())
    pair = Pair(ref_encode(ref_model, to_ref_history(h)), 2, mode, pad_to=None)
    assert pair.plan.dims[2] == 3
    pair.model = port_model
    _f, warm = pair.check(pair.initial(), 5)
    pair.check(warm, pair.total)


def _partial_level(pair, fr, upto):
    """Run one port level's stages up to (and including) ``upto`` from the
    reference frontier ``fr``; returns the workspace."""
    ws = lv.BatchWorkspace(pair.g, pair.D, "cpu")
    pfr = wgl.frontier_from_arrays(*fr, device="cpu", n_shards=pair.D)[:5]
    lv.chunk_init_plain(ws.ctl, pfr[4], ws.stats,
                        [(int(fr[5]), pair.total, 0, pair.plan.nD, pair.plan.nO)])
    lv.shard_reduce_plain(pair.g, ws.ctl, 0)
    for stage, args in lv._sharded_level_stages(pair.g, pair.tabs, pfr, ws, pair.model):
        getattr(lv.PLAIN, stage)(*args)
        if stage == upto:
            return ws
    raise AssertionError(upto)


def test_bucket_overflow_escalates_losslessly():
    """f_total 16 on 8 shards: F = 16 a shard, P = 64, buckets of PBK = 8
    rows. Some level routes more than 8 rows of one shard to one owner;
    the overflow is lossless (the frontier is restored) in both packages."""
    pair = Pair(register_enc(77, 80, 6, 0.1), 8, "alltoall", B=None)
    flags, fr = pair.check(pair.initial(), pair.total)
    assert flags[1] == 1 and flags[0] == 0  # overflowed, not accepted
    ws = _partial_level(pair, fr, "route")
    assert int(ws.ctl[:, lv.CTL_ROWOVF].max()) == 1  # a bucket overflowed (no B cap)
    counts = [int(ws.ctl[s, lv.CTL_NEXP]) for s in range(8)]
    assert max(counts) <= pair.g.P  # not the stage-1 overflow
    # the frontier came back as it entered the overflowing level
    _f, again = pair.check(fr, pair.total)
    for a, b in zip(again[:5], fr[:5]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_refutation_returns_the_witness_frontier(mode):
    pair = Pair(register_enc(63, 70, 4, 0.05, perturb=True), 8, mode, B=None)
    flags, fr = pair.check(pair.initial(), pair.total)
    acc, ovf, nonempty = flags[:3]
    assert (acc, ovf, nonempty) == (0, 0, 0)  # refuted
    assert fr[4].any()  # the last non-empty frontier is kept


# ---------------------------------------------------------------------------
# The new plain stages against NumPy restatements of the reference's lines


def _np_fnv(rows):
    gh = np.full(rows.shape[0], 2166136261, dtype=np.uint64)
    for c in range(rows.shape[1]):
        gh = ((gh ^ rows[:, c].astype(np.uint32).astype(np.uint64)) * 16777619) & 0xFFFFFFFF
    return gh.astype(np.uint32)


def _np_route(pmat, n_cand, D, NID):
    """``ops/wgl.py:551-590`` in NumPy: owner, (owner, iota) order,
    counts, offsets, bucket slots."""
    P = pmat.shape[0]
    nvalid = np.arange(P) < min(n_cand, P)
    owner = _np_fnv(pmat[:, :NID]) % np.uint32(D)
    okey = np.where(nvalid, owner, np.uint32(D))
    sidx = np.lexsort((np.arange(P), okey))
    cnt = np.array([np.sum(nvalid & (owner == d)) for d in range(D)])
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    PBK = -(-P // D)
    slot = np.arange(D * PBK)
    d_of, j_of = slot // PBK, slot % PBK
    bvalid = j_of < cnt[d_of]
    bsrc = sidx[np.minimum(off[d_of] + j_of, P - 1)]
    return owner, bvalid, np.where(bvalid[:, None], pmat[bsrc], 0), bool((cnt > PBK).any())


def _geometry(D, mode, P=48, F=16, S=1):
    return lv.Geometry(F=F, W=32, KO=1, S=S, ND=64, NO=32, B=P // F, SEL=False,
                       two_stage=True, P=P, D=D, exchange=mode)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_route_plain_matches_numpy(D, S):
    """The route (the owner routing and the tiled all_to_all in one stage)
    against ``ops/wgl.py:551-611`` in NumPy: source s's bucket for owner d
    at drows[d][s*PBK, (s+1)*PBK), a bucket overflow (one owner
    over-full), and at D = 3 a stopped shard (it sends nothing and its
    receive rows are not written)."""
    rng = np.random.default_rng(D + 10 * S)
    g = _geometry(D, "alltoall", S=S)
    PBK = g.PBK
    crows = rng.integers(-2**31, 2**31 - 1, size=(D, g.P, g.NC)).astype(np.int32)
    crows[:, ::3, :g.NID] = crows[:, :1, :g.NID]  # one owner over-full
    n_cand = [g.P - 5 * s for s in range(D)]
    go = [int(not (D == 3 and s == 1)) for s in range(D)]
    ctl = torch.zeros((D, lv.CTL_SIZE), dtype=torch.int32)
    ctl[:, lv.CTL_GO] = torch.tensor(go)
    ctl[:, lv.CTL_NEXP] = torch.tensor(n_cand)
    drows = torch.full((D, g.L, g.NC), 0x5A5A5A5A, dtype=torch.int32)
    rvalid = torch.full((D, g.L), 7, dtype=torch.uint8)
    lv.route(g, torch.from_numpy(crows), ctl, drows, rvalid, None,
             torch.zeros((D, g.L), dtype=torch.int32))
    routed = [_np_route(crows[s], n_cand[s] if go[s] else 0, D, g.NID) for s in range(D)]
    for s, (_owner, _bvalid, _bmat, over) in enumerate(routed):
        assert int(ctl[s, lv.CTL_ROWOVF]) == int(over)
    for d in range(D):
        if not go[d]:
            assert (drows[d] == 0x5A5A5A5A).all() and (rvalid[d] == 7).all()
            continue
        for s, (_owner, bvalid, bmat, _over) in enumerate(routed):
            rows = slice(s * PBK, (s + 1) * PBK)
            bucket = slice(d * PBK, (d + 1) * PBK)
            np.testing.assert_array_equal(rvalid[d, rows].numpy().astype(bool), bvalid[bucket])
            np.testing.assert_array_equal(drows[d, rows].numpy(), bmat[bucket])
        # every received row is owned by its shard
        got = drows[d].numpy()[rvalid[d].numpy().astype(bool)]
        assert (_np_fnv(got[:, :g.NID]) % D == d).all()
    assert D == 1 or int(ctl[:, lv.CTL_ROWOVF].max()) == 1


@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("mode", MODES)
def test_exchange_plain_matches_numpy(D, mode):
    """Tiled all_to_all: recv[d][s*PBK + j] = send[s][d*PBK + j]; tiled
    all_gather: recv[d][s*P + j] = send[s][j] (``ops/wgl.py:592-611``).
    The all_to_all is the second half of the route's plain version; the
    all_gather is the exchange stage, which an alltoall geometry refuses."""
    rng = np.random.default_rng(10 + D)
    g = _geometry(D, mode)
    a2a = mode == "alltoall"
    SR = D * g.PBK if a2a else g.P
    send = rng.integers(-2**31, 2**31 - 1, size=(D, SR, g.NC)).astype(np.int32)
    sval = rng.random((D, SR)) < 0.7
    ctl = torch.zeros((D, lv.CTL_SIZE), dtype=torch.int32)
    ctl[:, lv.CTL_GO] = 1
    n_cand = rng.integers(0, g.P + 10, size=D)
    ctl[:, lv.CTL_NEXP] = torch.from_numpy(n_cand.astype(np.int32))
    recv = torch.zeros((D, g.L, g.NC), dtype=torch.int32)
    rvalid = torch.zeros((D, g.L), dtype=torch.uint8)
    skey = torch.zeros((D, SR), dtype=torch.int32)
    fkey = torch.zeros((D, g.L), dtype=torch.int32)
    if a2a:
        lv.collective_plain(g, torch.from_numpy(send), torch.from_numpy(sval.astype(np.uint8)),
                            ctl, recv, rvalid, skey, fkey)
        with pytest.raises(ValueError, match="allgather"):
            lv.exchange(g, torch.from_numpy(send), ctl, recv, rvalid, skey, fkey)
    else:
        lv.exchange(g, torch.from_numpy(send), ctl, recv, rvalid, skey, fkey)
    if a2a:
        mat = np.concatenate([(~sval).astype(np.uint32)[..., None],
                              send.view(np.uint32)], axis=2)
        # all_to_all(split_axis=0, concat_axis=0, tiled): chunk d of s to d
        want = np.stack([np.concatenate([mat[s, d * g.PBK:(d + 1) * g.PBK] for s in range(D)])
                         for d in range(D)])
    else:
        v = np.arange(g.P)[None, :] < np.minimum(n_cand, g.P)[:, None]
        mat = np.concatenate([(~v).astype(np.uint32)[..., None], send.view(np.uint32)], axis=2)
        want = np.stack([mat.reshape(D * g.P, -1)] * D)
    valid = want[..., 0] == 0
    np.testing.assert_array_equal(rvalid.numpy().astype(bool), valid)
    np.testing.assert_array_equal(recv.numpy().view(np.uint32),
                                  np.where(valid[..., None], want[..., 1:], 0))


def _np_level_reduce(g, c0, c):
    """The level's cross-shard values (``ops/wgl.py:490``, ``:612``,
    ``:697-711``, ``:877-890``) in NumPy from the control blocks ``c0``
    before the reduce (lossless), asserted on ``c`` after it; returns
    (count, ovf_now, dead, kept, the shards' frontier counts)."""
    D, F = g.D, g.F
    counts = c0[:, lv.CTL_COUNT]
    pre = bool(np.any(c0[:, lv.CTL_ROWOVF] | (c0[:, lv.CTL_NEXP] > g.P)))
    if g.exchange == "alltoall":
        count = int(counts.sum())
        ovf_now = pre or bool(np.any(counts > F))
        kept = np.minimum(counts, F)
    else:
        count = int(counts[0])  # every shard counts the same global rows
        ovf_now = pre or count > F * D
        kept = np.clip(min(count, F * D) - np.arange(D) * F, 0, F)
    dead = ovf_now or count == 0
    fc = c0[:, lv.CTL_FCOUNT] if dead else kept
    assert (c[:, lv.CTL_GCOUNT] == count).all() and (c[:, lv.CTL_GOVF] == ovf_now).all()
    assert (c[:, lv.CTL_ACCNOW] == c0[:, lv.CTL_ACCNOW].max()).all()
    assert (c[:, lv.CTL_NSUM] == fc.sum()).all() and (c[:, lv.CTL_NMAX] == fc.max()).all()
    assert (c[:, lv.CTL_NMIN] == fc.min()).all()
    return count, ovf_now, dead, kept, fc


def _random_level_ctl(rng, g, F=16):
    """Control blocks of D shards at a level's prune: going, lossless,
    random frontier counts, acc_now, row-overflow flags and candidate
    counts (some above P)."""
    D = g.D
    ctl = torch.zeros((D, lv.CTL_SIZE), dtype=torch.int32)
    ctl[:, lv.CTL_GO] = 1
    ctl[:, lv.CTL_MAXLVL] = 100
    ctl[:, lv.CTL_LVL] = 7
    ctl[:, lv.CTL_FMAX] = 3
    ctl[:, lv.CTL_FCOUNT] = torch.from_numpy(rng.integers(0, F + 1, D).astype(np.int32))
    ctl[:, lv.CTL_ACCNOW] = torch.from_numpy((rng.random(D) < 0.1).astype(np.int32))
    ctl[:, lv.CTL_ROWOVF] = torch.from_numpy((rng.random(D) < 0.1).astype(np.int32))
    ctl[:, lv.CTL_NEXP] = torch.from_numpy(rng.integers(0, g.P + 3, D).astype(np.int32))
    return ctl


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_prune_plain_runs_the_reduce(mode, D, S):
    """A sharded level's prune is the prune of every shard and then the
    cross-shard reduce (the kernel runs it in its last block): the
    priorities and keep counts of a per-shard ``prune_reference``, and the
    replicated values of the NumPy restatement from those counts."""
    rng = np.random.default_rng(30 + D + 10 * S)
    g = _geometry(D, mode, S=S)
    for trial, family in enumerate(PRUNE_FAMILIES):
        drows, skey, perm, _go, _fprio = (torch.from_numpy(a) for a in prune_case(
            40 + trial, D, g.L, g.NC, g.NID, family))
        ctl = _random_level_ctl(rng, g)
        want_ctl, want_fprio = ctl.clone(), torch.zeros((D, g.L), dtype=torch.int32)
        for b in range(D):
            lv.prune_reference(g, drows[b], skey[b], perm[b], want_ctl[b], want_fprio[b])
        fprio = torch.zeros((D, g.L), dtype=torch.int32)
        lv.prune(g, drows, skey, perm, ctl, fprio, None)
        assert torch.equal(fprio, want_fprio)
        assert torch.equal(ctl[:, lv.CTL_COUNT], want_ctl[:, lv.CTL_COUNT])
        _np_level_reduce(g, want_ctl.numpy(), ctl.numpy())
        # a stopped level is left as it was
        ctl[:, lv.CTL_GO] = 0
        before = ctl.clone()
        lv.prune(g, drows, skey, perm, ctl, fprio, None)
        assert torch.equal(ctl, before)


@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_sharded_chunk_init_plain_runs_the_reduce(D):
    """A sharded chunk start (a ticket given) is each shard's control block
    from the shared initial values, its frontier count and then the
    chunk-start reduce (``ops/wgl.py:830-836``): the sum, max and min of
    the counts and one global stop test on every shard; without the ticket
    each shard's own. A stale control block and stats ring are
    overwritten."""
    rng = np.random.default_rng(50 + D)
    F = 16
    for trial in range(6):
        valid = torch.from_numpy((rng.random((D, F)) < rng.random((D, 1))).astype(np.uint8))
        if trial == 1:
            valid.zero_()  # an empty frontier stops the search
        lvl0 = int(rng.integers(0, 10))
        row = (lvl0, 9 if trial != 4 else lvl0, trial % 2, 7, 2)  # trial 4: no budget
        stale = torch.from_numpy(rng.integers(-5, 5, (D, lv.CTL_SIZE)).astype(np.int32))
        ctl, alone = stale.clone(), stale.clone()
        stats = torch.ones((D, lv.LEVEL_STAT_ROWS, 4), dtype=torch.int32)
        lv.chunk_init(ctl, valid, stats, [row], lv.gather_scratch(D, "cpu"))
        lv.chunk_init(alone, valid, None, [row])
        fc = valid.sum(dim=1).numpy()
        go = fc.sum() > 0 and row[0] < row[1]
        c = ctl.numpy()
        assert (c[:, lv.CTL_FCOUNT] == fc).all() and (c[:, lv.CTL_GO] == int(go)).all()
        assert (c[:, lv.CTL_NSUM] == fc.sum()).all() and (c[:, lv.CTL_NMAX] == fc.max()).all()
        assert (c[:, lv.CTL_NMIN] == fc.min()).all() and not stats.any()
        for k, v in zip((lv.CTL_LVL, lv.CTL_MAXLVL, lv.CTL_LOSSY, lv.CTL_ND, lv.CTL_NO,
                         lv.CTL_FMAX, lv.CTL_ACC, lv.CTL_OVF, lv.CTL_STUCK),
                        row + (1, 0, 0, 0)):
            assert (c[:, k] == v).all() and (alone.numpy()[:, k] == v).all()
        a = alone.numpy()
        assert (a[:, lv.CTL_FCOUNT] == fc).all() and not a[:, lv.CTL_NSUM:].any()
        assert (a[:, lv.CTL_GO] == [int(row[0] < row[1] and f > 0) for f in fc]).all()


@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("mode", MODES)
def test_shard_reduce_and_finalize_plain_match_numpy(D, mode):
    """The cross-shard values (``ops/wgl.py:490``, ``:612``, ``:697-711``)
    and each shard's kept rows (``:743-757``): alltoall the first
    min(count_local, F) of its own order, allgather its slice of the
    global order valid below min(count, F*D)."""
    rng = np.random.default_rng(20 + D)
    F = 16
    g = _geometry(D, mode, F=F)
    for trial in range(6):
        ctl = _random_level_ctl(rng, g, F)
        local = rng.integers(0, F + 3, D) if trial != 2 else np.zeros(D, int)
        same = int(rng.integers(0, F * D + 4))
        counts = local if mode == "alltoall" else np.full(D, same)
        ctl[:, lv.CTL_COUNT] = torch.from_numpy(counts.astype(np.int32))
        c0 = ctl.numpy().copy()
        lv.shard_reduce_plain(g, ctl, 1)
        count, ovf_now, dead, kept, fc = _np_level_reduce(g, c0, ctl.numpy())
        # the sharded finalize: each shard's rows and the replicated carry
        L = g.L
        drows = torch.from_numpy(rng.integers(0, 2**20, size=(D, L, g.NC)).astype(np.int32))
        # the rows in compaction order (the compaction sort's values)
        perm = torch.stack([torch.randperm(L) for _ in range(D)]).to(torch.int32)
        fr = tuple(t.clone() for t in wgl.initial_frontier_batch(
            F, 32, 1, torch.zeros((D, 1), dtype=torch.int32)))
        fr0 = tuple(t.clone() for t in fr)
        stats = torch.zeros((D, lv.LEVEL_STAT_ROWS, 4), dtype=torch.int32)
        lv.gather_finalize(g, drows, perm, ctl, stats, fr, lv.gather_scratch(D, "cpu"))
        for s in range(D):
            if dead:
                np.testing.assert_array_equal(fr[0][s].numpy(), fr0[0][s].numpy())
                continue
            off = s * F if mode == "allgather" else 0
            src = perm[s].numpy()[off:off + F]
            want = np.where((np.arange(F) < kept[s])[:, None], drows[s].numpy()[src], 0)
            np.testing.assert_array_equal(fr[0][s].numpy(), want[:, 0])
            np.testing.assert_array_equal(fr[4][s].numpy(), np.arange(F) < kept[s])
        c = ctl.numpy()
        stuck = count == 0 and not ovf_now
        assert (c[:, lv.CTL_LVL] == (7 if dead else 8)).all()
        assert (c[:, lv.CTL_FMAX] == max(3, min(count, F * D))).all()
        assert (c[:, lv.CTL_STUCK] == int(stuck)).all() and (c[:, lv.CTL_OVF] == ovf_now).all()
        assert (c[:, lv.CTL_FCOUNT] == fc).all()
        go = not c0[:, lv.CTL_ACCNOW].any() and not ovf_now and not stuck and fc.sum() > 0
        assert (c[:, lv.CTL_GO] == int(go)).all()
        assert not stats.any()  # no stats ring when sharded


class _FakeLib:
    """Stands in for the kernel library: records each entry point's call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append(name)
            return 0
        return fn


@pytest.mark.parametrize("mode", MODES)
def test_sharded_level_program_launches(mode, monkeypatch):
    """The kernel path packs a sharded level once per chunk: the stages in
    order (the route under alltoall, the exchange under allgather, each
    writing the received rows' keys: no stage hashes them again; one
    take-col sort a dedup key, the prune with the cross-shard reduce in its
    launch), one count per launch: 8 launches a level at KO = 1 in both
    modes, and one launch at a chunk's start (the chunk init with its
    ticket)."""
    lib = _FakeLib()
    monkeypatch.setattr(lv._build, "load", lambda: lib)
    monkeypatch.setattr(lv, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(lv, "_stream", lambda: 0)
    monkeypatch.setattr(lv, "_sm_count", lambda device: 132)  # the stage-1 tile's choice
    pair = Pair(register_enc(31, 60, 4, 0.05), 3, mode, B=None)
    fr = wgl.frontier_from_arrays(*pair.initial(), device="cpu", n_shards=3)[:5]
    ws = lv.BatchWorkspace(pair.g, 3, "cpu")
    prog = lv._LevelProgram(pair.g, pair.tabs, fr, ws, pair.model)
    lv.reset_launches()
    prog()
    a2a = mode == "alltoall"
    sorts = ["wgl_take_col_sort"] * (pair.g.KO1 + 1)
    want = (["wgl_expand", "wgl_stage1_hash", "wgl_route" if a2a else "wgl_exchange"] + sorts
            + ["wgl_prune", "radix_sort_pairs", "wgl_gather_finalize"])
    assert lib.calls == want and (pair.g.KO1 > 1 or len(want) == 8)
    assert lv.LAUNCHES["wgl_route"] == a2a and lv.LAUNCHES["wgl_exchange"] == (not a2a)
    assert lv.LAUNCHES["wgl_stage1_hash"] == 1 and "wgl_shard_reduce" not in lv.LAUNCHES
    # the route or the exchange writes the received rows' keys
    keyed = lv._route_args(pair.g, ws.crows, ws.ctl, ws.drows, ws.rvalid, ws.rt, ws.fkey) \
        if a2a else lv._exchange_args(pair.g, ws.crows, ws.ctl, ws.drows, ws.rvalid, ws.ckey,
                                      ws.fkey)
    assert keyed[4 if a2a else 5].value == ws.fkey.data_ptr()
    # the prune is told it runs the shards' reduce; the chunk start its ticket
    prune = lv._prune_args(pair.g, ws.drows, ws.keys, ws.perm, ws.ctl, ws.fprio, ws.pr)
    assert prune[13].value == lv._EX_MODE[mode] and prune[11].value == pair.g.F
    init = lv._chunk_init_args(ws.ctl, fr[4], ws.stats, [(0, 9, 0, 1, 0)], ws.gf)
    assert init[3].value == ws.gf.data_ptr() and init[2].value == ws.stats.data_ptr()
    bad = torch.zeros((2, lv.CTL_SIZE), dtype=torch.int32)
    with pytest.raises(ValueError, match="members"):
        lv._prune_args(pair.g, ws.drows[:2], ws.keys[:2], ws.perm[:2], bad, ws.fprio[:2], ws.pr)
    with pytest.raises(ValueError, match="members"):
        if a2a:
            lv._route_args(pair.g, ws.crows[:2], bad, ws.drows[:2], ws.rvalid[:2], ws.rt,
                           ws.fkey[:2])
        else:
            lv._exchange_args(pair.g, ws.crows[:2], bad, ws.drows[:2], ws.rvalid[:2],
                              ws.ckey[:2], ws.fkey[:2])
