"""Card-only tests of the port's CUDA kernels: each kernel path is held
against the plain PyTorch version on the GPU, bit for bit.

Marked ``cuda``; they skip where no GPU is present (decided inside the
fixture, never at import). Run them on a machine with the card with
``python -m pytest tests/test_torch_cuda.py``.
"""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.ops.encode import encode_history
from jepsen_tpu_torch.parallel import Mesh
from jepsen_tpu_torch.testing import (GATHER_CASES, PRUNE_FAMILIES, SORT_KEY_FAMILIES,
                                      STAGE1_DENSITIES, TAKE_SORT_FAMILIES, device_work,
                                      gather_case, perturb_history, prune_case,
                                      random_register_history, sort_keys, stage1_case,
                                      take_sort_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _both(enc, **kw):
    k = wgl.check_encoded_device(enc, device="cuda", collect_stats=True, **kw)
    p = wgl.check_encoded_device(enc, device="cuda", collect_stats=True,
                                 plain=True, **kw)
    return k, p


def _same(k, p):
    assert k["valid"] == p["valid"]
    assert k["levels"] == p["levels"]
    assert k["level_stats"] == p["level_stats"]
    assert k.get("stuck_configs") == p.get("stuck_configs")
    assert [(a["F"], a["levels"]) for a in k["attempts"]] == \
        [(a["F"], a["levels"]) for a in p["attempts"]]


@pytest.mark.parametrize("seed", range(6))
def test_search_kernels_match_plain(cuda, seed):
    rng = random.Random(100 + seed)
    h = random_register_history(rng, n_ops=40, n_procs=5, crash_p=0.2)
    if seed % 2:
        h = perturb_history(rng, h)
    _same(*_both(encode_history(CasRegister(init=0), h), f_schedule=(16, 128)))


@pytest.mark.parametrize("seed", range(4))
def test_two_stage_kernels_match_plain(cuda, seed, monkeypatch):
    monkeypatch.setattr(wgl, "BIG_M_THRESHOLD", 256)
    rng = random.Random(200 + seed)
    h = random_register_history(rng, n_ops=40, n_procs=5, crash_p=0.2)
    if seed % 2:
        h = perturb_history(rng, h)
    _same(*_both(encode_history(CasRegister(init=0), h), f_schedule=(16, 64)))


@pytest.mark.parametrize("seed", range(3))
def test_wide_masks_kernels_match_plain(cuda, seed):
    """KD = 2 window words and KO = 2 open words (padded)."""
    rng = random.Random(300 + seed)
    h = random_register_history(rng, n_ops=80, n_procs=40, crash_p=0.05)
    enc = encode_history(CasRegister(init=0), h)
    _same(*_both(enc, f_schedule=(16, 256), pad_to=(64, 2, 128, 64)))


def test_radix_sort_matches_stable_sort(cuda):
    g = torch.Generator().manual_seed(5)
    for n in (1, 31, 1000, 4097, 70000):
        keys = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, dtype=torch.int64)
        keys[: n // 3] = keys[n // 2] if n > 2 else keys[: n // 3]
        k32 = keys.to(torch.int32)[None]
        vals = torch.arange(n, dtype=torch.int32)[None]
        kd, vd = k32.to(cuda), vals.to(cuda)
        lv.radix_sort_pairs(kd, vd, lv.sort_scratch(n, cuda))
        kr, vr = k32.clone(), vals.clone()
        lv.radix_sort_pairs_plain(kr, vr)
        assert torch.equal(kd.cpu(), kr) and torch.equal(vd.cpu(), vr)


def test_radix_sort_refuses_short_scratch(cuda):
    keys = torch.zeros((1, 5000), dtype=torch.int32, device=cuda)
    vals = torch.zeros((1, 5000), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        lv.radix_sort_pairs(keys, vals, lv.sort_scratch(4096, cuda, path="onesweep"))
    big = torch.zeros((1, lv._build.SORT_CTA_MAX + 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # one block holds no more than SORT_CTA_MAX pairs
        lv.radix_sort_pairs(big, big.clone(), lv.sort_scratch(16, cuda))


SORT_SIZES = (1, 31, 2048, 16384, 16385, 32768, 32769, 131072, 1048576)


def _sort_both(keys, vals, scratch, ctl=None):
    """The kernel and the plain version on copies of the same pairs, bit
    for bit; returns the kernel's."""
    kk, vk, kp, vp = keys.clone(), vals.clone(), keys.clone(), vals.clone()
    lv.radix_sort_pairs(kk, vk, scratch, ctl)
    lv.radix_sort_pairs_plain(kp, vp, None, ctl)
    torch.cuda.synchronize()
    assert torch.equal(kk, kp) and torch.equal(vk, vp)
    return kk, vk


def _iota(nb, n, cuda):
    return torch.arange(n, dtype=torch.int32, device=cuda).repeat(nb, 1)


@pytest.mark.parametrize("family", SORT_KEY_FAMILIES)
@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("n", SORT_SIZES)
def test_radix_sort_sweep_matches_plain(cuda, n, nb, family):
    """Both paths on both sides of the crossover, each key family (stability,
    skipped passes, presorted rows), bit for bit against the plain sort."""
    keys = torch.from_numpy(sort_keys(family, nb, n, seed=n + nb)).to(cuda)
    _sort_both(keys, _iota(nb, n, cuda), lv.sort_scratch(n, cuda, nb))


@pytest.mark.parametrize("family", ["equal", "two", "top_byte", "random"])
@pytest.mark.parametrize("n", [1, 31, 2048, 4096, 16384])
def test_radix_sort_onesweep_below_the_crossover(cuda, n, family):
    keys = torch.from_numpy(sort_keys(family, 3, n, seed=7)).to(cuda)
    _sort_both(keys, _iota(3, n, cuda), lv.sort_scratch(n, cuda, 3, path="onesweep"))


def test_radix_sort_scratch_is_reusable(cuda):
    """One Onesweep scratch through every family and two sizes in turn:
    each call leaves the digit histograms and diff words zero."""
    nb = 3
    scratch = lv.sort_scratch(50000, cuda, nb)
    hdr = lambda: scratch[1][:nb * lv._build.SORT_HDR].view(nb, -1)[:, :1025]  # noqa: E731
    for rep, family in enumerate(SORT_KEY_FAMILIES * 2):
        n = 50000 if rep % 2 else 40000
        keys = torch.from_numpy(sort_keys(family, nb, n, seed=rep)).to(cuda)
        small = (scratch[0][:, :, :n].contiguous(), scratch[1])
        _sort_both(keys, _iota(nb, n, cuda), scratch if n == 50000 else small)
        assert int(hdr().abs().sum()) == 0


@pytest.mark.parametrize("path", lv.SORT_PATHS)
def test_radix_sort_leaves_a_stopped_member_untouched(cuda, path):
    nb, n = 3, 16384 if path == "cta" else 20000
    keys = torch.from_numpy(sort_keys("random", nb, n, seed=3)).to(cuda)
    vals = _iota(nb, n, cuda)
    ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32, device=cuda)
    ctl[:, lv.CTL_GO] = 1
    ctl[1, lv.CTL_GO] = 0
    scratch = lv.sort_scratch(n, cuda, nb, path=path)
    kk, vk = _sort_both(keys, vals, scratch, ctl)
    assert torch.equal(kk[1], keys[1]) and torch.equal(vk[1], vals[1])
    assert not torch.equal(kk[0], keys[0])
    if path == "onesweep":  # nor its state header
        hdr = scratch[1][:nb * lv._build.SORT_HDR].view(nb, -1)
        assert int(hdr[1].abs().sum()) == 0


def _launches_only(kernels):
    """A call's device work of ``kernels`` launches and nothing else."""
    return {"kernel": kernels, "memcpy": 0, "memset": 0, "other": 0}


@pytest.mark.parametrize("n,launches", [(16384, 1), (16385, 5), (1048576, 5)])
def test_radix_sort_device_launches(cuda, n, launches):
    """One block's launch at the main path's size, five above the crossover
    (an upsweep and four passes, whatever the digits)."""
    keys = torch.from_numpy(sort_keys("top_byte", 1, n, seed=1)).to(cuda)
    vals = _iota(1, n, cuda)
    scratch = lv.sort_scratch(n, cuda)
    lv.radix_sort_pairs(keys.clone(), vals.clone(), scratch)
    work = device_work(lambda: lv.radix_sort_pairs(keys, vals, scratch))
    assert work == _launches_only(launches), work


def test_wrappers_refuse_cpu_cuda_mix(cuda):
    keys = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        lv.radix_sort_pairs(keys, torch.zeros((1, 4), dtype=torch.int32),
                            lv.sort_scratch(4, cuda))
    assert np.all(keys.cpu().numpy() == 0)


# -- the stage-1 compaction and hash --------------------------------------------


def _stage1_header(scratch):
    """(call epoch, ticket counter, done counter, pad) of a stage-1 scratch."""
    return scratch[:lv.STAGE1_HDR].tolist()


def _stage1_geometry(M, P, NC):
    return lv.Geometry(F=M, W=32, KO=0, S=NC - 3, ND=64, NO=4, B=1, SEL=False,
                       two_stage=True, P=P)


def _stage1_both(cuda, g, case, scratch, with_key=True):
    """The kernel and the plain version on the same inputs, each held to the
    contract: the valid prefix of drows and fkey and the sign bit of every
    key equal; the kernel leaves drows' tail as it was and keys it as
    invalid from what it holds. Returns the kernel's (drows, fkey)."""
    rows, nvalid, ctl, drows0, fkey0 = (torch.from_numpy(a).to(cuda) for a in case)
    kd, kf, pd, pf = drows0.clone(), fkey0.clone(), drows0.clone(), fkey0.clone()
    lv.stage1_hash(g, rows, nvalid, ctl, kd, kf if with_key else None, scratch)
    lv.stage1_hash_plain(g, rows, nvalid, ctl, pd, pf if with_key else None, None)
    torch.cuda.synchronize()
    for b in range(ctl.shape[0]):
        if not int(ctl[b, lv.CTL_GO]):
            assert torch.equal(kd[b], drows0[b]) and torch.equal(kf[b], fkey0[b])
            continue
        n = min(int(ctl[b, lv.CTL_NEXP]), g.P)
        assert torch.equal(kd[b, :n], pd[b, :n])
        assert torch.equal(kd[b, n:], drows0[b, n:])
        if with_key:
            assert torch.equal(kf[b, :n], pf[b, :n])
            assert torch.equal(kf[b] < 0, pf[b] < 0)
            tail = lv._fnv_fkey(drows0[b, n:, :g.NID], torch.zeros(g.P - n, dtype=torch.bool,
                                                                     device=cuda))
            assert torch.equal(kf[b, n:], tail)
        else:
            assert torch.equal(kf[b], fkey0[b])
    return kd, kf


_T = min(lv.STAGE1_TILES)


@pytest.mark.parametrize("density", STAGE1_DENSITIES)
@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("M", [1, 31, _T - 1, _T, _T + 1, 131072, 262144])
def test_stage1_matches_plain(cuda, M, nb, density):
    """Both arms (with the key, and the compaction alone) at one member and
    batches of 3 and 8, at sizes around the tile and the main path's."""
    P = max(1, min(M, M // 8 + 3))
    g = _stage1_geometry(M, P, 5)
    case = stage1_case(M + nb, nb, M, P, 5, density)
    scratch = lv.stage1_scratch(M, nb, cuda)
    _stage1_both(cuda, g, case, scratch)
    _stage1_both(cuda, g, case, scratch, with_key=False)
    assert _stage1_header(scratch) == [2, 0, 0, 0]


@pytest.mark.parametrize("NC", range(3, 10))
@pytest.mark.parametrize("M", [_T + 1, 131072])
def test_stage1_matches_plain_at_every_row_width(cuda, M, NC):
    P = M // 8
    g = _stage1_geometry(M, P, NC)
    for density in ("p05", "p50", "P_plus_1"):
        case = stage1_case(NC + M, 3, M, P, NC, density)
        scratch = lv.stage1_scratch(M, 3, cuda)
        _stage1_both(cuda, g, case, scratch)
        _stage1_both(cuda, g, case, scratch, with_key=False)


@pytest.mark.parametrize("tile", lv.STAGE1_TILES)
@pytest.mark.parametrize("M", [2047, 4097, 8193, 131072])
def test_stage1_matches_plain_at_every_tile(cuda, M, tile, monkeypatch):
    monkeypatch.setattr(lv, "stage1_tile", lambda *a: tile)
    P = M // 4
    g = _stage1_geometry(M, P, 7)
    scratch = lv.stage1_scratch(M, 3, cuda)
    for density in ("p05", "exactly_P", "all"):
        _stage1_both(cuda, g, stage1_case(tile + M, 3, M, P, 7, density), scratch)


def test_stage1_leaves_a_stopped_member_untouched(cuda):
    M, P, nb = 131072, 16384, 3
    g = _stage1_geometry(M, P, 5)
    case = stage1_case(3, nb, M, P, 5, "p50")
    case[2][1, lv.CTL_GO] = 0
    scratch = lv.stage1_scratch(M, nb, cuda)
    kd, _ = _stage1_both(cuda, g, case, scratch)
    assert not torch.equal(kd[0].cpu(), torch.from_numpy(case[3][0]))
    assert _stage1_header(scratch) == [1, 0, 0, 0]


@pytest.mark.parametrize("tile", [None, 2048, 8192])
def test_stage1_scratch_cleans_itself(cuda, tile, monkeypatch):
    """Calls in a row on one scratch, at two sizes, two member counts and
    both arms (and a stopped member): each leaves the ticket and done
    counters zero and the epoch one higher, so the words of the call before
    (at other offsets when the shape changes) are never read as this
    call's."""
    if tile is not None:
        monkeypatch.setattr(lv, "stage1_tile", lambda *a: tile)
    scratch = lv.stage1_scratch(262144, 8, cuda)
    for rep in range(8):
        nb, M = (8, 262144) if rep % 2 else (3, 100000)
        P = M // 8
        g = _stage1_geometry(M, P, 5)
        case = stage1_case(rep, nb, M, P, 5, STAGE1_DENSITIES[rep % len(STAGE1_DENSITIES)])
        if rep == 4:
            case[2][1, lv.CTL_GO] = 0
        _stage1_both(cuda, g, case, scratch, with_key=rep % 3 != 2)
        assert _stage1_header(scratch) == [rep + 1, 0, 0, 0]


@pytest.mark.parametrize("with_key", [True, False])
def test_stage1_device_launches(cuda, with_key):
    """One device launch a call on the two-stage arm, with or without the
    key: no other kernel, copy or memset."""
    M, P, nb = 131072, 16384, 1
    g = _stage1_geometry(M, P, 5)
    rows, nvalid, ctl, drows, fkey = (torch.from_numpy(a).to(cuda)
                                      for a in stage1_case(1, nb, M, P, 5, "p05"))
    scratch = lv.stage1_scratch(M, nb, cuda)
    key = fkey if with_key else None
    lv.stage1_hash(g, rows, nvalid, ctl, drows, key, scratch)
    work = device_work(lambda: lv.stage1_hash(g, rows, nvalid, ctl, drows, key, scratch))
    assert work == _launches_only(1), work


def test_stage1_refuses_short_scratch_and_cpu_mix(cuda):
    M, P, nb = 4097, 512, 3
    g = _stage1_geometry(M, P, 5)
    rows, nvalid, ctl, drows, fkey = (torch.from_numpy(a).to(cuda)
                                      for a in stage1_case(2, nb, M, P, 5, "p50"))
    with pytest.raises(ValueError, match="scratch"):
        lv.stage1_hash(g, rows, nvalid, ctl, drows, fkey,
                       lv.stage1_scratch(M, nb, cuda)[:nb])
    with pytest.raises(ValueError):
        lv.stage1_hash(g, rows, nvalid, ctl, drows, fkey, lv.stage1_scratch(M, nb, "cpu"))
    with pytest.raises(ValueError):
        lv.stage1_hash(g, rows.cpu(), nvalid, ctl, drows, fkey, lv.stage1_scratch(M, nb, cuda))


# -- the prune -------------------------------------------------------------------


def _prune_geometry(L, NC=5, KO=1, ND=64):
    """A two-stage geometry of L = P rows of NC words: p, one window word,
    NC - 2 - max(KO, 1) state words and max(KO, 1) open words."""
    KO1 = max(KO, 1)
    return lv.Geometry(F=L, W=32, KO=KO, S=NC - 2 - KO1, ND=ND, NO=32, B=1, SEL=False,
                       two_stage=True, P=L)


def _prune_both(cuda, g, case, scratch):
    """The kernel and the plain prune on the same inputs: fprio and every
    control block equal (a stopped member's untouched). Returns the
    kernel's (ctl, fprio)."""
    drows, skey, perm, ctl, fprio = (torch.from_numpy(a).to(cuda) for a in case)
    kc, kf, pc, pf = ctl.clone(), fprio.clone(), ctl.clone(), fprio.clone()
    lv.prune(g, drows, skey, perm, kc, kf, scratch)
    lv.prune_plain(g, drows, skey, perm, pc, pf)
    torch.cuda.synchronize()
    assert torch.equal(kf, pf) and torch.equal(kc, pc)
    for b in range(ctl.shape[0]):
        if not int(ctl[b, lv.CTL_GO]):
            assert torch.equal(kf[b], fprio[b]) and torch.equal(kc[b], ctl[b])
    return kc, kf


def _prune_scratch_for(L, nb, tile, cuda):
    """A prune scratch for a forced tile (``prune_scratch`` sizes it for the
    smallest tile the wrapper picks)."""
    return torch.zeros((lv._prune_words(L, nb, tile),), dtype=torch.int32, device=cuda)


def _prune_header(scratch):
    """(call epoch, ticket counter, done counter, pad) of a prune scratch."""
    return scratch[:lv.STAGE1_HDR].tolist()


@pytest.mark.parametrize("family", PRUNE_FAMILIES)
@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("L", [1, 33, 256, 2047, 16384, 32768, 131072])
def test_prune_matches_plain(cuda, L, nb, family):
    """One member and batches of 3 and 8, from one row to the batch's L, on
    each group family: distinct rows, one group over the member, groups
    straddling every tile and halo boundary (some longer than the largest
    tile), half the rows invalid."""
    g = _prune_geometry(L)
    scratch = lv.prune_scratch(L, nb, cuda)
    _prune_both(cuda, g, prune_case(L + nb, nb, L, g.NC, g.NID, family), scratch)
    assert _prune_header(scratch) == [1, 0, 0, 0]


@pytest.mark.parametrize("tile", [32, 64, 256, 512, 1024])
@pytest.mark.parametrize("family", ["one_group", "straddle"])
def test_prune_matches_plain_at_every_tile(cuda, family, tile, monkeypatch):
    """Every tile the kernel takes, where groups outlast the halo and the
    tile: the look-back carries their starts."""
    monkeypatch.setattr(lv, "prune_tile", lambda *a: tile)
    L, nb = 20000, 3
    g = _prune_geometry(L, NC=7, KO=2)
    scratch = _prune_scratch_for(L, nb, tile, cuda)
    _prune_both(cuda, g, prune_case(tile, nb, L, g.NC, g.NID, family), scratch)


@pytest.mark.parametrize("NC,KO", [(4, 0), (5, 1), (6, 2), (12, 4), (40, 4)])
def test_prune_matches_plain_at_every_row_width(cuda, NC, KO):
    L, nb = 16384, 3
    g = _prune_geometry(L, NC=NC, KO=KO)
    scratch = lv.prune_scratch(L, nb, cuda)
    for family in PRUNE_FAMILIES:
        _prune_both(cuda, g, prune_case(NC + L, nb, L, g.NC, g.NID, family), scratch)


def test_prune_leaves_a_stopped_member_untouched(cuda):
    L, nb = 32768, 3
    g = _prune_geometry(L)
    case = prune_case(5, nb, L, g.NC, g.NID, "straddle")
    case[3][1, lv.CTL_GO] = 0
    scratch = lv.prune_scratch(L, nb, cuda)
    kc, kf = _prune_both(cuda, g, case, scratch)
    assert not torch.equal(kf[0].cpu(), torch.from_numpy(case[4][0]))
    assert int(kc[0, lv.CTL_COUNT]) > 0 and int(kc[1, lv.CTL_COUNT]) == 0
    assert _prune_header(scratch) == [1, 0, 0, 0]


@pytest.mark.parametrize("mode", ["alltoall", "allgather"])
def test_prune_at_the_sharded_geometries(cuda, mode):
    """The prune at both sharded arms' shapes: the D shards of a mesh as its
    members, L = D * ceil(P / D) (alltoall) or D * P (allgather) rows, at
    f_total 4096 and 262144 on 8 shards; a shard whose count is its local
    one (what the cross-shard reduce in the sharded prune's last block
    reads)."""
    model, enc = _sharded_history(1)
    D = 8
    for f_total in (4096, 262144):
        plan = wgl.plan_device(enc, device="cuda")
        g = wgl.sharded_geometry(plan, f_total // D, D, mode)
        assert g.L == (D * g.PBK if mode == "alltoall" else D * g.P)
        scratch = lv.prune_scratch(g.L, D, cuda)
        for family in ("straddle", "half_invalid"):
            case = prune_case(f_total + D, D, g.L, g.NC, g.NID, family)
            kc, _ = _prune_both(cuda, g, case, scratch)
            assert len(set(kc[:, lv.CTL_COUNT].tolist())) > 1  # local counts


@pytest.mark.parametrize("tile", [None, 32, 1024])
def test_prune_scratch_cleans_itself(cuda, tile, monkeypatch):
    """Calls in a row on one scratch at two sizes and member counts (and a
    stopped member): each leaves the counters zero and the epoch one
    higher, so the words of the call before are never read as this
    call's."""
    if tile is not None:
        monkeypatch.setattr(lv, "prune_tile", lambda *a: tile)
    scratch = _prune_scratch_for(32768, 8, tile or min(lv.PRUNE_TILES), cuda)
    for rep in range(8):
        nb, L = (8, 32768) if rep % 2 else (3, 20000)
        g = _prune_geometry(L)
        case = prune_case(rep, nb, L, g.NC, g.NID, PRUNE_FAMILIES[rep % len(PRUNE_FAMILIES)])
        if rep == 4:
            case[3][1, lv.CTL_GO] = 0
        _prune_both(cuda, g, case, scratch)
        assert _prune_header(scratch) == [rep + 1, 0, 0, 0]


@pytest.mark.parametrize("L,nb", [(16384, 1), (32768, 8), (2048, 8), (1 << 20, 1)])
def test_prune_device_launches(cuda, L, nb):
    """One device launch a call: the main path's, the batch's and a sharded
    arm's shapes and a member of 2**20 rows; no other kernel, copy or
    memset."""
    g = _prune_geometry(L)
    drows, skey, perm, ctl, fprio = (torch.from_numpy(a).to(cuda)
                                     for a in prune_case(1, nb, L, g.NC, g.NID, "straddle"))
    scratch = lv.prune_scratch(L, nb, cuda)
    lv.prune(g, drows, skey, perm, ctl, fprio, scratch)
    work = device_work(lambda: lv.prune(g, drows, skey, perm, ctl, fprio, scratch))
    assert work == _launches_only(1), work


def test_prune_refuses_short_scratch_and_cpu_mix(cuda):
    L, nb = 4097, 3
    g = _prune_geometry(L)
    drows, skey, perm, ctl, fprio = (torch.from_numpy(a).to(cuda)
                                     for a in prune_case(2, nb, L, g.NC, g.NID, "straddle"))
    with pytest.raises(ValueError, match="scratch"):
        lv.prune(g, drows, skey, perm, ctl, fprio, lv.prune_scratch(L, nb, cuda)[:nb])
    with pytest.raises(ValueError):
        lv.prune(g, drows, skey, perm, ctl, fprio, lv.prune_scratch(L, nb, "cpu"))
    with pytest.raises(ValueError):
        lv.prune(g, drows.cpu(), skey, perm, ctl, fprio, lv.prune_scratch(L, nb, cuda))


# -- the take-col sort and the one-launch gather-finalize -------------------------


def _take_sort_both(cuda, case, col, scratch, ctl=None, ident=False):
    """The kernel and the plain version (take_col, then the sort) on copies
    of the same inputs, bit for bit; returns the kernel's pairs."""
    src, keys, vals = (torch.from_numpy(a).to(cuda) for a in case)
    kk, vk, kp, vp = keys.clone(), vals.clone(), keys.clone(), vals.clone()
    lv.take_col_sort(src, col, kk, vk, scratch, ctl, ident)
    lv.take_col_sort_plain(src, col, kp, vp, None, ctl, ident)
    torch.cuda.synchronize()
    assert torch.equal(kk, kp) and torch.equal(vk, vp)
    return kk, vk


@pytest.mark.parametrize("family", TAKE_SORT_FAMILIES)
@pytest.mark.parametrize("ident", [True, False])
@pytest.mark.parametrize("nb", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 31, 2048, 16384, 16385, 32768, 131072])
def test_take_col_sort_matches_plain(cuda, n, nb, ident, family):
    """Both paths (one block to 16384 pairs, Onesweep above), the identity
    and read values, and the keys whose digits are all uniform (an
    all-zero column, all-equal keys): the gathered pairs are stored even
    where the sort has nothing to do."""
    case = take_sort_case(n + nb, nb, n, 5, 3, family)
    _kk, vk = _take_sort_both(cuda, case, 3, lv.sort_scratch(n, cuda, nb), ident=ident)
    if family != "random" and n > 1:  # nothing to sort: the gathered pairs in row order
        idx = np.arange(n) if ident else case[2]
        np.testing.assert_array_equal(vk.cpu().numpy(), np.broadcast_to(idx, (nb, n)))


@pytest.mark.parametrize("path", lv.SORT_PATHS)
@pytest.mark.parametrize("stride", [1, 5])
def test_take_col_sort_on_either_path_at_every_stride(cuda, path, stride):
    n, nb = 12000, 3
    col = stride - 1
    for family in TAKE_SORT_FAMILIES:
        for ident in (True, False):
            _take_sort_both(cuda, take_sort_case(7, nb, n, stride, col, family), col,
                            lv.sort_scratch(n, cuda, nb, path=path), ident=ident)


@pytest.mark.parametrize("path", lv.SORT_PATHS)
@pytest.mark.parametrize("ident", [True, False])
def test_take_col_sort_leaves_a_stopped_member_untouched(cuda, path, ident):
    nb, n = 3, 16384 if path == "cta" else 20000
    case = take_sort_case(4, nb, n, 5, 3, "random")
    ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32, device=cuda)
    ctl[:, lv.CTL_GO] = 1
    ctl[1, lv.CTL_GO] = 0
    scratch = lv.sort_scratch(n, cuda, nb, path=path)
    kk, vk = _take_sort_both(cuda, case, 3, scratch, ctl, ident)
    assert np.array_equal(kk[1].cpu().numpy(), case[1][1])
    assert np.array_equal(vk[1].cpu().numpy(), case[2][1])
    if path == "onesweep":  # nor its state header
        hdr = scratch[1][:nb * lv._build.SORT_HDR].view(nb, -1)
        assert int(hdr[1].abs().sum()) == 0


@pytest.mark.parametrize("n,launches", [(16384, 1), (16385, 5), (1048576, 5)])
def test_take_col_sort_device_launches(cuda, n, launches):
    """No gather launch: one block's launch at the main path's size, the
    sort's five above it."""
    src, keys, vals = (torch.from_numpy(a).to(cuda) for a in take_sort_case(1, 1, n, 5, 3, "zero"))
    scratch = lv.sort_scratch(n, cuda)
    for ident in (True, False):
        lv.take_col_sort(src, 3, keys.clone(), vals.clone(), scratch, None, ident)
        work = device_work(lambda: lv.take_col_sort(src, 3, keys, vals, scratch, None, ident))
        assert work == _launches_only(launches), work


def test_take_col_sort_refuses_overlap_and_cpu_mix(cuda):
    keys = torch.zeros((1, 64), dtype=torch.int32, device=cuda)
    vals = torch.zeros((1, 64), dtype=torch.int32, device=cuda)
    scratch = lv.sort_scratch(64, cuda)
    with pytest.raises(ValueError, match="overlaps"):
        lv.take_col_sort(keys, 0, keys, vals, scratch)
    with pytest.raises(ValueError):
        lv.take_col_sort(torch.zeros((1, 64), dtype=torch.int32), 0, keys, vals, scratch)


def _gather_both(cuda, g, case, scratch, stop=None):
    """The level's compaction sort (plain) of the case, then the one-launch
    gather-finalize and its plain version on copies of the same frontier,
    control blocks and stats ring, bit for bit; returns the kernel's."""
    _g, drows, perm, fprio, ctl = (torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray)
                                   else a for a in case)
    if stop is not None:
        ctl[stop, lv.CTL_GO] = 0
    lv.radix_sort_pairs_plain(fprio, perm, None, ctl)
    nb = ctl.shape[0]
    gen = torch.Generator().manual_seed(g.F)
    fr0 = [torch.randint(-9, 9, (nb, g.F) + s, generator=gen, dtype=torch.int32)
           for s in ((), (g.KD,), (g.KO1,), (g.S,))]
    fr0 = tuple(t.to(cuda) for t in fr0) + (torch.ones((nb, g.F), dtype=torch.bool,
                                                          device=cuda),)
    stats = torch.randint(-9, 9, (nb, lv.LEVEL_STAT_ROWS, 4), generator=gen,
                          dtype=torch.int32).to(cuda)
    k = (ctl.clone(), stats.clone(), tuple(t.clone() for t in fr0))
    p = (ctl.clone(), stats.clone(), tuple(t.clone() for t in fr0))
    lv.gather_finalize(g, drows, perm, k[0], k[1], k[2], scratch)
    lv.gather_finalize_plain(g, drows, perm, p[0], p[1], p[2])
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    for a, b in zip(k[2], p[2]):
        assert torch.equal(a, b)
    assert int(scratch.abs().sum()) == 0  # the tickets clean themselves
    return k, fr0


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("F", [40, 100, 4096])
def test_gather_finalize_matches_plain(cuda, case, F):
    """Capacities below, not a multiple of and many times the block's 64
    slots; members that fit, overflow lossy, die (the frontier kept) or
    run dry; both sharded arms on 8 shards."""
    nb = 8 if case in lv.EXCHANGES else 3
    c = gather_case(F, case, nb, F, 2 * F + 10)
    k, fr0 = _gather_both(cuda, c[0], c, lv.gather_scratch(nb, cuda))
    if case in ("single_dead", "single_stuck"):  # the frontier kept
        for a, b in zip(k[2], fr0):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["single", "alltoall", "allgather"])
def test_gather_finalize_leaves_a_stopped_member_untouched(cuda, case):
    nb = 4
    c = gather_case(3, case, nb, 100, 210)
    k, fr0 = _gather_both(cuda, c[0], c, lv.gather_scratch(nb, cuda), stop=1)
    assert int(k[0][1, lv.CTL_GO]) == 0 and int(k[0][1, lv.CTL_LVL]) == 7
    for a, b in zip(k[2], fr0):
        assert torch.equal(a[1], b[1])


def test_gather_finalize_scratch_cleans_itself(cuda):
    """Calls in a row on one ticket scratch, at other capacities, member
    counts and cases (a stopped member, a dead level): each call's last
    block of each member resets its counter, so every call finalizes."""
    scratch = lv.gather_scratch(8, cuda)
    for rep in range(8):
        case = GATHER_CASES[rep % len(GATHER_CASES)]
        nb = 8 if case in lv.EXCHANGES or rep % 2 else 3
        F = (64, 130, 4096)[rep % 3]
        c = gather_case(rep, case, nb, F, 2 * F)
        _gather_both(cuda, c[0], c, scratch[:nb], stop=1 if rep == 4 else None)


@pytest.mark.parametrize("F,nb", [(4096, 1), (8192, 8), (40, 3)])
def test_gather_finalize_device_launches(cuda, F, nb):
    """One device launch a call: no finalize launch, copy or memset."""
    g, drows, perm, _fprio, ctl = (torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray)
                                   else a for a in gather_case(1, "single", nb, F, 2 * F))
    fr = wgl.initial_frontier_batch(F, g.W, g.KO, torch.zeros((nb, g.S), dtype=torch.int32,
                                                              device=cuda))
    stats = torch.zeros((nb, lv.LEVEL_STAT_ROWS, 4), dtype=torch.int32, device=cuda)
    scratch = lv.gather_scratch(nb, cuda)
    lv.gather_finalize(g, drows, perm, ctl.clone(), stats, fr, scratch)
    work = device_work(lambda: lv.gather_finalize(g, drows, perm, ctl, stats, fr, scratch))
    assert work == _launches_only(1), work


def test_gather_finalize_refuses_short_scratch_and_cpu_mix(cuda):
    nb = 3
    g, drows, perm, _fprio, ctl = (torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray)
                                   else a for a in gather_case(2, "single", nb, 40, 90))
    fr = wgl.initial_frontier_batch(40, g.W, g.KO, torch.zeros((nb, g.S), dtype=torch.int32,
                                                               device=cuda))
    stats = torch.zeros((nb, lv.LEVEL_STAT_ROWS, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="ticket scratch"):
        lv.gather_finalize(g, drows, perm, ctl, stats, fr, lv.gather_scratch(nb - 1, cuda))
    with pytest.raises(ValueError):
        lv.gather_finalize(g, drows, perm, ctl, stats, fr, lv.gather_scratch(nb, "cpu"))


# -- the expand ------------------------------------------------------------------


def _expand_case(cuda, name, nb, F=64, crash_p=0.1, B=None, sel=True, seed=3, levels=6):
    """``nb`` histories of one model family planned together, their frontier
    warmed ``levels`` beam levels on the kernels at capacity F, and a
    level's control blocks: (geometry, tables, frontier, ctl, model). ``B``
    overrides the selected layout's candidate cap; ``sel=False`` takes the
    unselected layout."""
    import chip_smoke
    from jepsen_tpu_torch.testing import history_model, random_model_history

    model = history_model(name) if name != "cas-register" else CasRegister(init=0)
    hists = [random_model_history(random.Random(seed + b), name, n_ops=80, n_procs=6,
                                  crash_p=crash_p) if name != "cas-register" else
             random_register_history(random.Random(seed + b), n_ops=80, n_procs=6,
                                     crash_p=crash_p) for b in range(nb)]
    plan = chip_smoke.batch_plan([encode_history(model, h) for h in hists], wgl)
    plan.B = None if not sel else (B or plan.B or 8)
    g = wgl.level_geometry(plan, F)
    assert g.SEL == sel
    fr, _ws, lvls = chip_smoke.warm_frontier(plan, F, lv, wgl, model, levels)
    ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32, device=cuda)
    lv.chunk_init_plain(ctl, fr[4], None, lv.chunk_rows(
        lvls, [x + 1 for x in lvls], [1] * nb, plan.nD.tolist(), plan.nO.tolist()))
    return g, plan.tabs, fr, ctl, model


def _expand_batch_both(g, tabs, fr, ctl, model):
    """wgl_expand and the plain expand on the same batch: control blocks,
    nvalid and the valid rows equal; ctl[CTL_NEXP] each member's count of
    valid rows; a stopped member's buffers untouched. A single-stage
    level's keys too, bit for bit on every slot: a valid row's equal to
    ``hash_rows_reference`` of the row, an invalid slot's the sign bit
    alone. Returns (ctl, nvalid)."""
    out = []
    nb = ctl.shape[0]
    keyed = not g.two_stage
    for fn in (lv.expand, lv.expand_plain):
        c = ctl.clone()
        rows = torch.full((nb, g.M, g.NC), -7, dtype=torch.int32, device=ctl.device)
        nval = torch.full((nb, g.M), 9, dtype=torch.uint8, device=ctl.device)
        key = torch.full((nb, g.M), 5, dtype=torch.int32, device=ctl.device) if keyed else None
        fn(g, tabs, tuple(a.clone() for a in fr), c, rows, nval, model, key)
        torch.cuda.synchronize()
        out.append((c, nval, rows, key))
    (kc, kn, kr, kk), (pc, pn, pr, pk) = out
    assert torch.equal(kc, pc) and torch.equal(kn, pn)
    assert torch.equal(kr[kn.bool()], pr[pn.bool()])
    if keyed:
        assert torch.equal(kk, pk)
        want = kk.clone()
        lv.vmap_members(lv.hash_rows_reference)(g, kr, kn, kc, want)
        vm = kn.bool()
        go = kc[:, lv.CTL_GO].bool()[:, None].expand_as(vm)
        assert torch.equal(kk[vm], want[vm])
        assert (kk[~vm & go] == lv.KEY_INVALID - 2**32).all()
    for b in range(nb):
        if int(ctl[b, lv.CTL_GO]):
            assert int(kc[b, lv.CTL_NEXP]) == int((kn[b] != 0).sum())
        else:
            assert (kn[b] == 9).all() and (kr[b] == -7).all()
            assert not keyed or (kk[b] == 5).all()
    return kc, kn


@pytest.mark.parametrize("sel", [True, False])
@pytest.mark.parametrize("crash_p", [0.0, 0.1])
@pytest.mark.parametrize("name", ["cas-register", "multi-register", "bank"])
def test_expand_matches_plain(cuda, name, crash_p, sel):
    """The selected and the unselected layout, with no open op (KO = 0) and
    with some, at a fixed-width state (S = 1) and the runtime-width ones
    (multi-register's three lanes, bank's accounts); a batch of three."""
    g, tabs, fr, ctl, model = _expand_case(cuda, name, 3, crash_p=crash_p, sel=sel)
    assert (g.KO == 0) == (crash_p == 0.0)
    _kc, kn = _expand_batch_both(g, tabs, fr, ctl, model)
    assert int(kn.sum()) > 0


def test_expand_flags_a_row_with_more_than_b_candidates(cuda):
    """A candidate cap below the rows' candidate counts: the row overflow
    flag, and the first B candidates of each row, as the plain version."""
    g, tabs, fr, ctl, model = _expand_case(cuda, "cas-register", 2, B=2, crash_p=0.2)
    kc, _kn = _expand_batch_both(g, tabs, fr, ctl, model)
    assert kc[:, lv.CTL_ROWOVF].any()


def test_expand_leaves_a_stopped_member_untouched(cuda):
    g, tabs, fr, ctl, model = _expand_case(cuda, "cas-register", 3)
    ctl[1, lv.CTL_GO] = 0
    kc, _kn = _expand_batch_both(g, tabs, fr, ctl, model)
    assert int(kc[1, lv.CTL_NEXP]) == 0 and int(kc[0, lv.CTL_NEXP]) > 0


@pytest.mark.parametrize("W", [64, 96, 288, 1024])
def test_expand_at_every_window_width(cuda, W):
    """Window widths on each side of the kernel's register templates (2, 8
    and 32 words), padded onto a history's own tables."""
    import chip_smoke

    model = CasRegister(init=0)
    h = random_register_history(random.Random(W), n_ops=120, n_procs=8, crash_p=0.05)
    enc = encode_history(model, h)
    own = wgl.plan_device(enc, device="cpu")
    plan = wgl.stack_plans([wgl.plan_device(enc, pad_to=(W, own.dims[1], own.dims[3],
                                                         own.dims[4]), device="cpu")], "cuda")
    g = wgl.level_geometry(plan, 64)
    assert g.W == W
    fr, _ws, lvls = chip_smoke.warm_frontier(plan, 64, lv, wgl, model, 8)
    ctl = torch.zeros((1, lv.CTL_SIZE), dtype=torch.int32, device=cuda)
    lv.chunk_init_plain(ctl, fr[4], None, [(lvls[0], lvls[0] + 1, 1, int(plan.nD[0]),
                                            int(plan.nO[0]))])
    _kc, kn = _expand_batch_both(g, plan.tabs, fr, ctl, model)
    assert int(kn.sum()) > 0


def test_prune_is_one_launch_on_every_path(cuda):
    """The prune as each level program packs it is one device launch
    (counted from a stream capture of the call): the single search, a
    batch, and both sharded arms."""
    import chip_smoke

    model, enc = _sharded_history(1)
    levels = []
    for plan in (wgl.stack_plans([wgl.plan_device(enc, device="cpu")], "cuda"),
                 chip_smoke.batch_plan([enc, enc, enc], wgl)):
        g = wgl.level_geometry(plan, 64)
        fr = wgl.initial_frontier_batch(64, g.W, g.KO, plan.init_state)
        levels.append((g, plan.tabs, fr, lv.BatchWorkspace(g, plan.nb, cuda)))
    for mode in ("alltoall", "allgather"):
        plan, g, tabs = chip_smoke.sharded_setup(lv, wgl, enc, 64 * 8, 8, mode, model)
        fr0 = wgl.initial_frontier(64 * 8, g.W, g.KO, g.S, plan.init_state, "cuda")
        fr = tuple(a.reshape((8, 64) + tuple(a.shape[1:])).contiguous() for a in fr0[:5])
        levels.append((g, tabs, fr, lv.BatchWorkspace(g, 8, cuda)))
    for g, tabs, fr, ws in levels:
        ws.ctl[:, lv.CTL_GO] = 1
        (args,) = [a for s, a in lv._level_stages(g, tabs, fr, ws, model) if s == "prune"]
        lv.prune(*args)
        assert device_work(lambda: lv.prune(*args)) == _launches_only(1)


# -- the member axis ---------------------------------------------------------


def _batch_plan(seeds, cuda, n_ops=40):
    encs = []
    for s in seeds:
        rng = random.Random(s)
        h = random_register_history(rng, n_ops=n_ops + 7 * (s % 4), n_procs=5,
                                    crash_p=0.05 * (s % 5))
        if s % 3 == 0:
            h = perturb_history(rng, h)
        encs.append(encode_history(CasRegister(init=0), h))
    plans = [wgl.plan_device(e, device="cpu") for e in encs]
    dims = np.array([p.dims for p in plans])
    pad = tuple(int(dims[:, k].max()) for k in (0, 1, 3, 4))
    padded = [wgl.plan_device(e, pad_to=pad, device="cpu") for e in encs]
    return encs, wgl.stack_plans(padded, cuda)


@pytest.mark.parametrize("F,threshold", [(64, None), (64, 512)])
def test_batched_chunks_match_plain(cuda, F, threshold, monkeypatch):
    """Every batched stage at nb = 3 through whole chunks: the kernels and
    the per-member plain loop give the same flags, frontiers and stats."""
    if threshold:
        monkeypatch.setattr(wgl, "BIG_M_THRESHOLD", threshold)
    _, plan = _batch_plan((11, 12, 13), cuda)
    g = wgl.level_geometry(plan, F)
    assert g.two_stage == bool(threshold)
    nb = plan.nb
    runs = []
    for ops in (lv.KERNELS, lv.PLAIN):
        fr = wgl.initial_frontier_batch(F, g.W, g.KO, plan.init_state)
        ws = lv.BatchWorkspace(g, nb, cuda)
        out = []
        for lossy, levels in ((1, 9), (0, 40)):
            lvl0 = [0] * nb if not out else [f[3] for f in out[-1][0]]
            flags = lv.run_chunk_batch(ops, g, plan.tabs, fr, ws, lvl0,
                                       [lvl + levels for lvl in lvl0], [lossy] * nb,
                                       plan.nD.tolist(), plan.nO.tolist(),
                                       CasRegister(init=0))
            torch.cuda.synchronize()
            out.append((flags, [a.cpu().clone() for a in fr], ws.stats.cpu().clone()))
        runs.append(out)
    for (kf, kfr, ks), (pf, pfr, ps) in zip(*runs):
        assert kf == pf
        assert all(torch.equal(a, b) for a, b in zip(kfr, pfr))
        assert torch.equal(ks, ps)


def test_regroup_matches_plain_with_repeated_index(cuda):
    _, plan = _batch_plan((21, 22, 23), cuda)
    fr = wgl.initial_frontier_batch(16, plan.dims[0], plan.dims[1], plan.init_state)
    g = wgl.level_geometry(plan, 16)
    lv.run_chunk_batch(lv.KERNELS, g, plan.tabs, fr, lv.BatchWorkspace(g, 3, cuda),
                       [0] * 3, [6] * 3, [1] * 3, plan.nD.tolist(), plan.nO.tolist(),
                       CasRegister(init=0))
    before = lv.LAUNCHES["wgl_regroup"]
    k = lv.regroup(fr, [2, 0, 2], 64)
    p = lv.regroup_reference(fr, [2, 0, 2], 64)
    torch.cuda.synchronize()
    assert lv.LAUNCHES["wgl_regroup"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    # the indices travel in the launch's parameters: no copy
    work = device_work(lambda: lv._launch("wgl_regroup", *lv._regroup_args(fr, k, [2, 0, 2])))
    assert work == _launches_only(1), work


@pytest.mark.parametrize("idx,F,F_new,widths", [
    ([1, 1, 0], 13, 40, (3, 2, 5)), ([0], 5, 7, (1, 1, 1)), ([2, 1], 24, 24, (2, 1, 3)),
    ([], 16, 64, (2, 1, 1)), ([0, 0], 4096, 8192, (2, 1, 1)), ([1], 1000, 4093, (7, 3, 9)),
    ([2, 0, 1] * 100, 13, 17, (2, 1, 1))])
def test_regroup_at_unaligned_widths(cuda, idx, F, F_new, widths):
    """The one-launch regroup bit for bit against regroup_reference where
    no run starts on 16 bytes (F 13, 5, 1000: valid's runs and the one-word
    arrays' at odd offsets), with a repeated index, no member, the same
    capacity, and 300 members (above RG_INLINE: the indices go to the
    card first); one device launch."""
    KD, KO1, S = widths
    gen = torch.Generator(device=cuda).manual_seed(F * 31 + F_new)
    r = lambda *shape: torch.randint(-2**31, 2**31 - 1, shape, generator=gen,  # noqa: E731
                                     device=cuda, dtype=torch.int64).to(torch.int32)
    fr = (r(3, F), r(3, F, KD), r(3, F, KO1), r(3, F, S),
          torch.randint(0, 2, (3, F), generator=gen, device=cuda).bool())
    k = lv.regroup(fr, idx, F_new)
    p = lv.regroup_reference(fr, idx, F_new)
    torch.cuda.synchronize()
    assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(k, p))
    if idx:
        ix = torch.tensor(idx, dtype=torch.int32, device=cuda)
        ix = ix if len(idx) > lv._build.RG_INLINE else None
        work = device_work(lambda: lv._launch("wgl_regroup", *lv._regroup_args(fr, k, idx, ix)))
        assert work == _launches_only(1), work


def test_batch_verdicts_match_single_searches(cuda):
    from jepsen_tpu_torch.parallel import check_encoded_batch

    encs, _ = _batch_plan(range(30, 36), cuda)
    got = check_encoded_batch(encs, f=16, f_schedule=(16, 128))
    plain = check_encoded_batch(encs, f=16, f_schedule=(16, 128), plain=True)
    for g, p, e in zip(got, plain, encs):
        single = wgl.check_encoded_device(e, f_schedule=(16, 128))
        assert g["valid"] == p["valid"] == single["valid"]
        assert g["levels"] == p["levels"]
        assert g.get("stuck_configs") == p.get("stuck_configs")


# -- every device model's step in the expand kernel ---------------------------


def _expand_both(g, tabs, fr, ctl, model):
    """wgl_expand and its plain version on copies of the same inputs:
    (control blocks, nvalid, valid rows) of each."""
    out = []
    for fn in (lv.expand, lv.expand_plain):
        c = ctl.clone()
        rows = torch.zeros((1, g.M, g.NC), dtype=torch.int32, device=ctl.device)
        nval = torch.zeros((1, g.M), dtype=torch.uint8, device=ctl.device)
        fn(g, tabs, tuple(a.clone() for a in fr), c, rows, nval, model)
        torch.cuda.synchronize()
        out.append((c.cpu(), nval.cpu(), rows[nval.bool()].cpu()))
    return out


@pytest.mark.parametrize("name", ["multi-register", "counter", "set", "bank", "mutex",
                                  "owner-aware-mutex", "reentrant-mutex", "fenced-mutex",
                                  "reentrant-fenced-mutex", "semaphore"])
def test_model_step_kernels_match_plain(cuda, name, monkeypatch):
    """Each model family through wgl_expand against the plain expand (its
    step_torch) from a warmed frontier, at the selected and the unselected
    layout, then whole searches (kernels against plain) of a valid and a
    perturbed history."""
    from jepsen_tpu_torch.testing import history_model, random_model_history

    model = history_model(name)
    for perturb in (True, False):
        h = random_model_history(random.Random(5), name, n_ops=60, n_procs=6, crash_p=0.1,
                                 perturb=perturb)
        enc = encode_history(model, h)
        _same(*_both(enc, f_schedule=(16, 128)))
    for sel in (False, True):  # from the valid history's frontier
        plan = wgl.plan_device(enc, device="cuda")
        # The unselected layout steps every slot; the selected one at most B.
        plan.B = (plan.B or 8) if sel else None
        F = 64
        g = wgl.level_geometry(plan, F)
        assert g.S == model.state_width and g.SEL == sel
        fr = wgl.initial_frontier(F, g.W, g.KO, g.S, plan.init_state, "cuda")[:5]
        ws = lv.BatchWorkspace(g, 1, cuda)
        flags = lv.run_chunk(lv.KERNELS, g, plan.tabs, fr, ws, 0, min(8, plan.nD // 2), True,
                             plan.nD, plan.nO, model)
        lvl = flags[3]
        ctl = torch.zeros((1, lv.CTL_SIZE), dtype=torch.int32, device=cuda)
        fr1 = tuple(a[None] for a in fr)
        lv.chunk_init(ctl, fr1[4], None, [(lvl, lvl + 1, 1, plan.nD, plan.nO)])
        tabs = {k: t[None] for k, t in plan.tabs.items()}
        before = lv.LAUNCHES["wgl_expand"]
        (kc, kn, kr), (pc, pn, pr) = _expand_both(g, tabs, fr1, ctl, model)
        assert lv.LAUNCHES["wgl_expand"] == before + 1
        assert torch.equal(kc, pc) and torch.equal(kn, pn) and torch.equal(kr, pr)
        assert int(kn.sum()) > 0


def test_expand_refuses_a_model_it_has_no_step_for(cuda):
    from jepsen_tpu_torch.models import CasRegister as Cas

    class Sub(Cas):
        pass

    h = random_register_history(random.Random(1), n_ops=20, n_procs=3)
    with pytest.raises(ValueError, match="no step"):
        wgl.check_encoded_device(encode_history(Sub(init=0), h), device="cuda")


# -- Elle's closure kernels ----------------------------------------------------


def _elle_edges(pad, nb, seed):
    from jepsen_tpu_torch.elle import ops as eo

    rng = np.random.default_rng(seed)
    members = []
    for b in range(nb):
        n = int(rng.integers(pad // 2, pad + 1))
        ne = int(rng.integers(0, 3 * n))
        members.append((rng.integers(0, n, ne), rng.integers(0, n, ne)))
    epad = eo.edge_pad(max(len(s) for s, _ in members))
    padded = [eo.pad_edges(s, d, pad, epad) for s, d in members]
    return (torch.from_numpy(np.stack([p[0] for p in padded])),
            torch.from_numpy(np.stack([p[1] for p in padded])))


@pytest.mark.parametrize("seed", range(3))
def test_elle_kernels_match_plain(cuda, seed):
    """elle_adjacency, elle_square and elle_labels_pack at pad 256, nb = 3,
    each against its plain version on the same inputs, bit for bit."""
    from jepsen_tpu_torch.elle import ops as eo

    pad = 256
    S, D = (t.to(cuda) for t in _elle_edges(pad, 3, seed))
    before = dict(eo.LAUNCHES)
    a = eo.adjacency(S, D, pad)
    ap = eo.adjacency_plain(S, D, pad)
    assert a.dtype == torch.bfloat16 and torch.equal(a.float(), ap)
    for _ in range(eo.closure_steps(pad)):
        nxt = eo.square(a)
        assert torch.equal(nxt.float(), eo.square_plain(a.float()))
        a = nxt
    pk, lb = eo.labels_pack(a)
    ppk, plb = eo.labels_pack_plain(a.float())
    torch.cuda.synchronize()
    assert torch.equal(pk, ppk) and torch.equal(lb, plb)
    assert {k: eo.LAUNCHES[k] - before[k] for k in before} == {
        "elle_adjacency": 1, "elle_square": eo.closure_steps(pad), "elle_labels_pack": 1,
        "elle_unpack": 0, "elle_pack_rows": 0, "elle_gather": 0, "elle_block_square": 0}
    got = eo.batched_closure(S, D, pad)
    want = eo.batched_closure(S.cpu(), D.cpu(), pad, torch_device="cpu")
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))


def test_elle_append_check_on_the_card_matches_the_cpu(cuda):
    from jepsen_tpu_torch.elle import append as ea
    from jepsen_tpu_torch.elle import ops as eo
    from jepsen_tpu_torch.testing import lagged_append_history

    h = lagged_append_history(3, 600, (100, 400), depth=8)
    before = eo.LAUNCHES["elle_square"]
    rep = {}
    got = ea.check(h, device=True, additional_graphs=("process",), report=rep)
    assert eo.LAUNCHES["elle_square"] > before and rep["engine"] == "device"
    want = ea.check(h, device=True, additional_graphs=("process",), report={},
                    torch_device="cpu")
    assert got == want and got["valid"] is False


def _random_01(shape, density, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape) < density).to(device=device, dtype=torch.bfloat16)


def _square_cases():
    from jepsen_tpu_torch.elle import ops as eo

    return [(pad, nb) for pad in eo.BUCKETS for nb in (1, 3)] + [(8192, 6)]


@pytest.mark.parametrize("pad,nb", _square_cases())
def test_square_matches_plain_at_every_bucket(cuda, pad, nb):
    """One elle_square step bit for bit against square_plain on random masks
    (sparse, as a dependency graph's adjacency, and a half-closed density),
    one launch a step."""
    from jepsen_tpu_torch.elle import ops as eo

    for density in (2.0 / pad, 0.02):
        a = _random_01((nb, pad, pad), density, pad * 10 + nb, cuda)
        before = eo.LAUNCHES["elle_square"]
        got = eo.square(a)
        torch.cuda.synchronize()
        assert eo.LAUNCHES["elle_square"] == before + 1
        assert torch.equal(got.float(), eo.square_plain(a.float()))


@pytest.mark.parametrize("fill", [1.0, 0.0])
def test_square_of_all_ones_and_empty_members(cuda, fill):
    """Every path count reaches pad in an all-ones member at 8192 (exact in
    fp32), and an empty member stays empty."""
    from jepsen_tpu_torch.elle import ops as eo

    a = torch.full((1, 8192, 8192), fill, dtype=torch.bfloat16, device=cuda)
    got = eo.square(a)
    assert torch.equal(got.float(), eo.square_plain(a.float()))
    assert bool((got == fill).all())


@pytest.mark.parametrize("pad", [256, 1024])
def test_block_square_matches_plain(cuda, pad):
    """elle_block_square with B apart from A, at pad 256 with D = 8 (P = 32
    rows a shard, so a 128-row tile spans four shards) and at 1024."""
    from jepsen_tpu_torch.elle import ops as eo

    b = _random_01((pad, pad), 3.0 / pad, pad, cuda)
    full = _random_01((pad, pad), 3.0 / pad, pad + 1, cuda)
    full[: pad // 8] = b[: pad // 8]  # shard 0's rows, as a gather leaves them
    got = eo.block_square(b, full)
    assert torch.equal(got.float(), eo.block_square_plain(b.float(), full.float()))
    ones = torch.ones_like(b)
    assert bool((eo.block_square(ones, ones) == 1).all())


def test_square_with_tiles_not_a_multiple_of_the_sms(cuda):
    """The persistent grid: 640 tiles of 128 x 256 at pad 2048 with 5
    members, not a multiple of the SM count, so the blocks take unequal
    shares."""
    from jepsen_tpu_torch.elle import ops as eo

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pad, nb = 2048, 5
    tiles = (pad // 128) * (pad // 256) * nb
    assert tiles > sms and tiles % sms
    a = _random_01((nb, pad, pad), 2.0 / pad, 77, cuda)
    assert torch.equal(eo.square(a).float(), eo.square_plain(a.float()))


def test_square_wrappers_refuse_a_misaligned_view(cuda):
    from jepsen_tpu_torch.elle import ops as eo

    flat = torch.zeros(256 * 256 + 8, dtype=torch.bfloat16, device=cuda)
    view = flat[1:1 + 256 * 256].view(1, 256, 256)
    with pytest.raises(ValueError, match="16-byte"):
        eo.square(view)
    with pytest.raises(ValueError, match="16-byte"):
        eo.block_square(view[0], torch.zeros_like(view[0]))


# -- the mesh-sharded Elle closure ---------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 8])
@pytest.mark.parametrize("pad", [256, 1024])
def test_sharded_closure_kernels_match_plain(cuda, pad, d):
    """elle_unpack, elle_pack_rows, elle_gather and elle_block_square, each
    against its plain version on the same inputs at every step of both
    modes, then the whole sharded closure against the plain chain and the
    bucketed kernels, bit for bit."""
    from jepsen_tpu_torch.elle import ops as eo

    rng = np.random.default_rng(pad + d)
    n = pad - 7
    srcs, dsts = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
    assert eo.sharded_pad(n, d) == pad
    words = torch.from_numpy(eo.edge_words(srcs, dsts, pad).view(np.int32)).to(cuda)
    before = dict(eo.LAUNCHES)
    b = eo.unpack(words, pad)
    assert b.dtype == torch.bfloat16 and torch.equal(b.float(), eo.unpack_plain(words, pad))
    cut = eo.unpack(words[:5], pad - 13)  # m cutting inside a word
    assert torch.equal(cut.float(), eo.unpack_plain(words[:5], pad - 13))
    for _ in range(eo.closure_steps(pad)):
        pk = eo.pack_rows(b)
        assert torch.equal(pk, eo.pack_rows_plain(b.float()))
        full = eo.unpack(pk, pad)
        gathered = eo.gather(b, d)
        assert torch.equal(gathered, eo.gather_plain(b, d)) and torch.equal(gathered, full)
        nxt = eo.block_square(b, full)
        assert torch.equal(nxt.float(), eo.block_square_plain(b.float(), full.float()))
        b = nxt
    torch.cuda.synchronize()
    steps = eo.closure_steps(pad)
    assert {k: eo.LAUNCHES[k] - before[k] for k in ("elle_unpack", "elle_pack_rows",
                                                     "elle_gather", "elle_block_square")} \
        == {"elle_unpack": 2 + steps, "elle_pack_rows": steps, "elle_gather": steps,
            "elle_block_square": steps}
    s, t = eo.pad_edges(srcs, dsts, pad, eo.edge_pad(len(srcs)))
    bucketed = eo.batched_closure(s[None], t[None], pad)[0][0]
    for mode in eo.EXCHANGES:
        got = eo.sharded_closure_words(words, d, mode)
        want = eo.sharded_closure_words(words, d, mode, plain=True)
        assert torch.equal(got, want) and torch.equal(got, bucketed)
    mesh = Mesh((d, 1), ("dp", "mp"), cuda)
    assert np.array_equal(eo.sharded_closure(srcs, dsts, n, mesh),
                          bucketed.cpu().numpy().view(np.uint32))


def test_sharded_closure_wrappers_refuse_bad_buffers(cuda):
    from jepsen_tpu_torch.elle import ops as eo

    b = torch.zeros((256, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        eo.block_square(b, b, b)
    with pytest.raises(ValueError):
        eo.gather(b, 3)
    with pytest.raises(ValueError):
        eo.gather(b, 2, b)
    with pytest.raises(ValueError):
        eo.pack_rows(b[:, :40].contiguous())
    with pytest.raises(ValueError):
        eo.unpack(torch.zeros((4, 2), dtype=torch.int32, device=cuda), 65)
    with pytest.raises(ValueError):
        eo.block_square(b.float(), b)


def _random_bf16(shape, seed, device):
    """bf16 tensors of random bit patterns (NaNs included: compare as int16)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(-2**15, 2**15, shape, generator=gen, device=device, dtype=torch.int32)
    return bits.to(torch.int16).view(torch.bfloat16)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("pad", [128, 256, 8192, 32768])
def test_gather_matches_plain(cuda, pad, d):
    from jepsen_tpu_torch.elle import ops as eo

    b = _random_bf16((pad, pad), pad + d, cuda)
    before = eo.LAUNCHES["elle_gather"]
    got = eo.gather(b, d)
    out = torch.empty_like(b)
    assert eo.gather(b, d, out) is out
    want = eo.gather_plain(b, d)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    assert eo.LAUNCHES["elle_gather"] - before == 2


@pytest.mark.parametrize("rows,cols,d", [(64, 4, 2), (16, 12, 2), (24, 12, 3), (16, 4, 8),
                                         (40, 20, 5)])
def test_gather_of_rows_shorter_than_16_bytes(cuda, rows, cols, d):
    """Rows that are not whole 16-byte pieces, in blocks that are."""
    from jepsen_tpu_torch.elle import ops as eo

    assert (cols * 2) % 16 and (rows // d * cols * 2) % 16 == 0
    b = _random_bf16((rows, cols), rows * cols, cuda)
    got = eo.gather(b, d)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), eo.gather_plain(b, d).view(torch.int16))


def test_gather_refusals(cuda):
    from jepsen_tpu_torch.elle import ops as eo

    b = torch.zeros((256, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        eo.gather(b, 3)  # rows % shards
    with pytest.raises(ValueError):
        eo.gather(torch.zeros((3, 4), dtype=torch.bfloat16, device=cuda), 3)  # 8-byte blocks
    with pytest.raises(ValueError):
        eo.gather(b, 2, b)  # out aliases blocks
    with pytest.raises(ValueError):
        eo.gather(b, 2, torch.zeros((256, 128), dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError):
        eo.gather(b.float(), 2)
    flat = torch.zeros(256 * 256 + 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        eo.gather(flat[1:1 + 256 * 256].view(256, 256), 2)
    with pytest.raises(ValueError, match="16-byte"):
        eo.gather(b, 2, flat[1:1 + 256 * 256].view(256, 256))
    with pytest.raises(ValueError):
        eo.gather(b, 2, torch.zeros((256, 256), dtype=torch.bfloat16))


# -- the frontier-sharded level ------------------------------------------------


def _sharded_history(S, seed=7):
    from jepsen_tpu_torch.testing import history_model, random_model_history

    if S == 1:
        model = CasRegister(init=0)
        h = random_register_history(random.Random(seed), n_ops=80, n_procs=6, crash_p=0.05)
    else:
        model = history_model("multi-register")
        h = random_model_history(random.Random(seed), "multi-register", n_ops=80, n_procs=6,
                                 crash_p=0.05)
    assert model.state_width == S
    return model, encode_history(model, h)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("mode", ["alltoall", "allgather"])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_sharded_stages_match_plain(cuda, D, mode, S):
    """One sharded level from a warmed frontier, stage by stage: each kernel
    (wgl_route with the all_to_all folded in, or wgl_exchange; the prune
    with the cross-shard reduce in its last block; the sharded finalize
    and every existing stage at the exchanged row count) against its plain
    version on identical inputs, bit for bit, on the same grid. No reduce
    launch exists."""
    import chip_smoke

    model, enc = _sharded_history(S)
    F = 32
    plan, g, tabs = chip_smoke.sharded_setup(lv, wgl, enc, F * D, D, mode, model)
    fr0 = wgl.initial_frontier(F * D, g.W, g.KO, g.S, plan.init_state, "cuda")
    fr = tuple(a.reshape((D, F) + tuple(a.shape[1:])).contiguous() for a in fr0[:5])
    flags = lv.run_chunk_sharded(lv.PLAIN, g, tabs, fr, lv.BatchWorkspace(g, D, cuda), 0, 12,
                                 True, plan.nD, plan.nO, model)
    assert flags[2] == 1 and flags[5] > 1
    before = dict(lv.LAUNCHES)
    for lossy in (True, False):
        ctl = chip_smoke.sharded_ctl(lv, g, plan, fr, flags[3], lossy)
        errs, _wp = chip_smoke.sharded_lockstep(lv, g, tabs, model, fr, ctl)
        assert errs and not any(errs.values()), errs
    ran = {k for k in before if lv.LAUNCHES[k] > before[k]}
    assert {"wgl_prune", "wgl_gather_finalize"} <= ran
    assert ("wgl_route" in ran) == (mode == "alltoall")
    assert ("wgl_exchange" in ran) == (mode == "allgather")
    assert "wgl_shard_reduce" not in lv.LAUNCHES


@pytest.mark.parametrize("mode", ["alltoall", "allgather"])
def test_sharded_search_matches_plain(cuda, mode):
    """A whole sharded search with an escalation, kernels against plain:
    the same result map and the same frontier arrays."""
    from jepsen_tpu_torch.parallel import frontier, make_mesh

    model, enc = _sharded_history(1, seed=11)
    kw = dict(mesh=make_mesh(3), f_total=16, exchange=mode, max_escalations=3)
    k = frontier.check_encoded_sharded(enc, **kw)
    p = frontier.check_encoded_sharded(enc, plain=True, **kw)
    assert len(k["attempts"]) > 1
    for key in ("valid", "levels", "frontier_total", "frontier_max", "max_linearized",
                "stuck_configs"):
        assert k.get(key) == p.get(key), key
    assert [(a["F"], a["levels"], a["calls"]) for a in k["attempts"]] == \
        [(a["F"], a["levels"], a["calls"]) for a in p["attempts"]]
    single = wgl.check_encoded_device(enc)
    assert k["valid"] == single["valid"]


def _exchange_case(D, NC, P, cuda):
    """An allgather geometry of D shards with NC words a row and random
    stage-1 rows, each source's n_cand 0, below P or above P, one
    destination stopped at D = 3, and receive buffers prefilled with a
    pattern."""
    F = 13
    g = lv.Geometry(F=F, W=32, KO=1, S=NC - 3, ND=64, NO=32, B=-(-P // F), SEL=False,
                    two_stage=True, P=P, D=D, exchange="allgather")
    assert g.NC == NC
    rng = np.random.default_rng(D * 100 + NC)
    send = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(D, P, NC),
                                         dtype=np.int64).astype(np.int32)).to(cuda)
    ctl = torch.zeros((D, lv.CTL_SIZE), dtype=torch.int32, device=cuda)
    ctl[:, lv.CTL_GO] = 1
    if D == 3:
        ctl[2, lv.CTL_GO] = 0
    ctl[:, lv.CTL_NEXP] = torch.tensor([(0, P // 2, P + 7)[s % 3] for s in range(D)])
    recv = torch.full((D, g.L, NC), 0x5A5A5A5A, dtype=torch.int32, device=cuda)
    rvalid = torch.full((D, g.L), 7, dtype=torch.uint8, device=cuda)
    return g, send, ctl, recv, rvalid


@pytest.mark.parametrize("P", [52, 4108])
@pytest.mark.parametrize("NC", range(3, 9))
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_exchange_matches_plain(cuda, D, NC, P):
    """The block-copy all_gather bit for bit against exchange_plain: runs
    that start off 16 bytes (P * NC odd), several blocks a run at P = 4108,
    sources with n_cand 0, below P and above P, invalid rows zeroed and a
    stopped destination left as it was; with stage 1's keys (the hash of
    each source's rows below its n_cand): the received keys equal
    exchange_plain's and the plain hash of the received rows on every slot
    of every going shard. (The all_to_all is wgl_route's.)"""
    g, send, ctl, recv, rvalid = _exchange_case(D, NC, P, cuda)
    skey = torch.full((D, P), 3, dtype=torch.int32, device=cuda)
    below = torch.arange(P, device=cuda)[None] < ctl[:, lv.CTL_NEXP, None]
    going = ctl.clone()  # every source's stage 1 ran (the shards stop together)
    going[:, lv.CTL_GO] = 1
    lv.vmap_members(lv.hash_rows_reference)(g, send, below, going, skey)
    fkey = torch.full((D, g.L), 11, dtype=torch.int32, device=cuda)
    rk, vk, rp, vp = recv.clone(), rvalid.clone(), recv.clone(), rvalid.clone()
    kk, pk = fkey.clone(), fkey.clone()
    lv.exchange(g, send, ctl, rk, vk, skey, kk)
    lv.exchange_plain(g, send, ctl, rp, vp, skey, pk)
    torch.cuda.synchronize()
    assert torch.equal(rk, rp) and torch.equal(vk, vp) and torch.equal(kk, pk)
    if D == 3:
        assert torch.equal(rk[2], recv[2]) and torch.equal(kk[2], fkey[2])
    _assert_received_keys(g, ctl, rk, vk, kk)


def _route_case(D, NC, P, cuda, seed=0):
    """An alltoall geometry of D shards with NC words a row: random stage-1
    rows, every third row of a shard of one group (an over-full owner: a
    bucket overflow at every D > 1), each source's n_cand below P, half of
    it, above P or 0, one shard stopped at D = 3 (it sends nothing and is
    not written), and receive rows prefilled with a pattern."""
    F = 13
    g = lv.Geometry(F=F, W=32, KO=1, S=NC - 3, ND=64, NO=32, B=-(-P // F), SEL=False,
                    two_stage=True, P=P, D=D, exchange="alltoall")
    assert g.NC == NC
    rng = np.random.default_rng(seed + D * 100 + NC + P)
    crows = rng.integers(-2**31, 2**31 - 1, size=(D, P, NC), dtype=np.int64).astype(np.int32)
    crows[:, ::3, :g.NID] = crows[:, :1, :g.NID]
    ctl = torch.zeros((D, lv.CTL_SIZE), dtype=torch.int32)
    ctl[:, lv.CTL_GO] = 1
    if D == 3:
        ctl[2, lv.CTL_GO] = 0
    ctl[:, lv.CTL_NEXP] = torch.tensor([(P - 3, P // 2, P + 7, 0)[s % 4] for s in range(D)])
    drows = torch.full((D, g.L, NC), 0x5A5A5A5A, dtype=torch.int32)
    rvalid = torch.full((D, g.L), 7, dtype=torch.uint8)
    return g, *(t.to(cuda) for t in (torch.from_numpy(crows), ctl, drows, rvalid))


def _assert_received_keys(g, ctl, drows, rvalid, fkey):
    """The received keys are the plain hash of the received rows
    (``hash_rows_reference``: a valid row's FNV hash shifted right by one,
    an empty slot's the zero row's key) on every slot of every going
    shard, bit for bit."""
    want = fkey.clone()
    lv.vmap_members(lv.hash_rows_reference)(g, drows, rvalid, ctl, want)
    assert torch.equal(fkey, want)
    empty = (rvalid == 0) & ctl[:, lv.CTL_GO].bool()[:, None]
    assert (fkey[empty] == lv.zero_row_key(g.NID)).all()


def _route_both(g, crows, ctl, drows, rvalid, scratch):
    """The route kernel and its plain version on the same inputs: the
    received rows, their validity, their keys (also against the plain hash
    of the received rows) and every control block equal; a stopped
    destination's buffers untouched. Returns the kernel's (ctl, drows,
    rvalid)."""
    fkey = torch.full(rvalid.shape, 11, dtype=torch.int32, device=rvalid.device)
    kc, kd, kv, kk = ctl.clone(), drows.clone(), rvalid.clone(), fkey.clone()
    pc, pd, pv, pk = ctl.clone(), drows.clone(), rvalid.clone(), fkey.clone()
    lv.route(g, crows, kc, kd, kv, scratch, kk)
    lv.route_plain(g, crows, pc, pd, pv, None, pk)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(kv, pv) and torch.equal(kc, pc)
    assert torch.equal(kk, pk)
    _assert_received_keys(g, ctl, kd, kv, kk)
    for d in range(g.D):
        if not int(ctl[d, lv.CTL_GO]):
            assert torch.equal(kd[d], drows[d]) and torch.equal(kv[d], rvalid[d])
            assert torch.equal(kk[d], fkey[d])
    return kc, kd, kv


@pytest.mark.parametrize("tile", [None, 512, 2048])
@pytest.mark.parametrize("P", [52, 4108, 20000])
@pytest.mark.parametrize("NC", [3, 4, 5, 6, 7, 8, 9, 13])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_route_matches_plain(cuda, D, NC, P, tile, monkeypatch):
    """The one-launch route (owner routing and all_to_all) bit for bit
    against its plain version (route_reference into send buckets, then the
    tiled all_to_all): one tile a shard or many (the look-back carries a
    bucket's offset), buckets past RT_FILL slots (fill blocks zero them:
    PBK 4108 and 20000 at D = 1, 10000 at D = 2), bucket overflows, n_cand
    0 and above P, a stopped shard, and rows kept in registers (NC up to 8)
    or copied through the listed positions (9 and 13). Replaces the
    alltoall cases of test_exchange_matches_plain."""
    if tile is not None:
        monkeypatch.setattr(lv, "route_tile", lambda *a: tile)
    g, crows, ctl, drows, rvalid = _route_case(D, NC, P, cuda)
    scratch = lv.route_scratch(g, cuda)
    kc, _kd, kv = _route_both(g, crows, ctl, drows, rvalid, scratch)
    assert scratch[:lv.STAGE1_HDR].tolist() == [1, 0, 0, 0]
    assert D == 1 or int(kc[:, lv.CTL_ROWOVF].max()) == 1
    assert int((kv == 1).sum()) > 0


def test_route_matches_plain_at_the_largest_rung(cuda):
    """The route at exchange_scale's shape (f_total 262144 on 8 shards:
    131072 stage-1 rows a shard, buckets of 16384 rows, seven fill blocks
    a bucket) on the north star's row width."""
    model, enc = _sharded_history(1)
    plan = wgl.plan_device(enc, device="cuda")
    g = wgl.sharded_geometry(plan, 262144 // 8, 8, "alltoall")
    rng = np.random.default_rng(262144)
    crows = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(8, g.P, g.NC),
                                          dtype=np.int64).astype(np.int32)).to(cuda)
    ctl = torch.zeros((8, lv.CTL_SIZE), dtype=torch.int32, device=cuda)
    ctl[:, lv.CTL_GO] = 1
    ctl[:, lv.CTL_NEXP] = torch.from_numpy(rng.integers(g.P // 2, g.P + g.P // 8, 8)
                                           .astype(np.int32))
    drows = torch.zeros((8, g.L, g.NC), dtype=torch.int32, device=cuda)
    rvalid = torch.zeros((8, g.L), dtype=torch.uint8, device=cuda)
    scratch = lv.route_scratch(g, cuda)
    for _ in range(2):  # the scratch cleans itself
        _route_both(g, crows, ctl, drows, rvalid, scratch)
    assert scratch[:lv.STAGE1_HDR].tolist() == [2, 0, 0, 0]


def test_route_scratch_cleans_itself(cuda, monkeypatch):
    """Calls in a row on one scratch at other shard counts, row counts and
    tiles: each leaves the counters zero and the epoch one higher."""
    scratch = None
    shapes = [(8, 4108, 512), (3, 52, 1024), (2, 20000, 2048), (8, 2048, 512), (1, 9, 512)]
    for rep, (D, P, tile) in enumerate(shapes * 2):
        monkeypatch.setattr(lv, "route_tile", lambda *a, t=tile: t)
        g, crows, ctl, drows, rvalid = _route_case(D, 5, P, cuda, seed=rep)
        if scratch is None:
            scratch = torch.zeros(max(lv._route_words(p, d, 512) for d, p, _t in shapes),
                                  dtype=torch.int32, device=cuda)
        _route_both(g, crows, ctl, drows, rvalid, scratch)
        assert scratch[:lv.STAGE1_HDR].tolist() == [rep + 1, 0, 0, 0]


@pytest.mark.parametrize("D", [1, 3, 8])
def test_route_is_one_device_launch(cuda, D):
    g, crows, ctl, drows, rvalid = _route_case(D, 5, 20000, cuda)
    scratch = lv.route_scratch(g, cuda)
    fkey = torch.zeros(rvalid.shape, dtype=torch.int32, device=cuda)
    lv.route(g, crows, ctl, drows, rvalid, scratch, fkey)
    work = device_work(lambda: lv.route(g, crows, ctl, drows, rvalid, scratch, fkey))
    assert work == _launches_only(1), work


def _sharded_prune_case(D, mode, L_of, seed, family):
    """A sharded geometry of D shards and a prune case over its L rows,
    with the control blocks' other fields (frontier counts, acc_now,
    row-overflow flags, candidate counts, lossy) random."""
    g = lv.Geometry(F=16, W=32, KO=1, S=2, ND=64, NO=32, B=3, SEL=False, two_stage=True,
                    P=L_of, D=D, exchange=mode)
    case = list(prune_case(seed, D, g.L, g.NC, g.NID, family))
    rng = np.random.default_rng(seed)
    ctl = case[3]
    ctl[:, lv.CTL_FCOUNT] = rng.integers(0, g.F + 1, D)
    ctl[:, lv.CTL_ACCNOW] = rng.random(D) < 0.05
    ctl[:, lv.CTL_ROWOVF] = rng.random(D) < 0.05
    ctl[:, lv.CTL_NEXP] = rng.integers(0, g.P + 2, D)
    ctl[:, lv.CTL_LOSSY] = seed % 2
    return g, tuple(case)


@pytest.mark.parametrize("family", PRUNE_FAMILIES)
@pytest.mark.parametrize("mode", ["alltoall", "allgather"])
@pytest.mark.parametrize("D", [1, 2, 3, 8, 40])
def test_sharded_prune_matches_plain(cuda, D, mode, family):
    """The sharded prune (the reduce in its last block) bit for bit against
    prune_plain (the prune of every shard, then shard_reduce_plain): every
    control block, the replicated fields included; D above a warp (the
    reduce's lanes loop)."""
    for seed in range(3):
        g, case = _sharded_prune_case(D, mode, 300, 10 * D + seed, family)
        scratch = lv.prune_scratch(g.L, D, cuda)
        kc, _kf = _prune_both(cuda, g, case, scratch)
        assert _prune_header(scratch) == [1, 0, 0, 0]
        assert (kc[:, lv.CTL_GCOUNT] == kc[0, lv.CTL_GCOUNT]).all()


def test_single_level_prune_runs_no_reduce(cuda):
    """The single level's prune is the unsharded instantiation: the fields
    only a sharded level's reduce writes keep what they held, the call is
    one device launch, and a single-stage level is 6 launches at KO = 1
    (its expand writes the keys: no stage 1)."""
    L, nb = 16384, 3
    g = _prune_geometry(L)
    case = prune_case(9, nb, L, g.NC, g.NID, "straddle")
    case[3][:, lv.CTL_GCOUNT:] = -7
    scratch = lv.prune_scratch(L, nb, cuda)
    kc, _kf = _prune_both(cuda, g, case, scratch)
    assert (kc[:, lv.CTL_GCOUNT:] == -7).all()
    assert _prune_header(scratch) == [1, 0, 0, 0]
    drows, skey, perm, ctl, fprio = (torch.from_numpy(a).to(cuda) for a in case)
    work = device_work(lambda: lv.prune(g, drows, skey, perm, ctl, fprio, scratch))
    assert work == _launches_only(1), work
    model, enc = _sharded_history(1)
    plan = wgl.stack_plans([wgl.plan_device(enc, device="cpu")], "cuda")
    gl = wgl.level_geometry(plan, 64)
    ws = lv.BatchWorkspace(gl, 1, cuda)
    fr = wgl.initial_frontier_batch(64, gl.W, gl.KO, plan.init_state)
    lv._LevelProgram(gl, plan.tabs, fr, ws, model)()
    # packed inside the capture, so that the launches go to its stream
    work = device_work(lambda: lv._LevelProgram(gl, plan.tabs, fr, ws, model)())
    assert not gl.two_stage and gl.KO1 == 1
    assert work == _launches_only(5 + gl.KO1), work


@pytest.mark.parametrize("D", [1, 2, 3, 8, 40, 256])
def test_sharded_chunk_init_matches_plain(cuda, D):
    """The sharded chunk start (one launch: the control blocks from the
    shared initial values, the stats rings zeroed, the counts, the reduce
    in its last block) bit for bit against chunk_init_plain with the
    ticket: random frontiers, some empty, a start with no budget, stale
    control blocks and rings; the ticket is left zero; one device launch
    (no copy, no memset)."""
    rng = np.random.default_rng(D)
    ticket = lv.gather_scratch(D, cuda)
    for trial in range(6):
        valid = torch.from_numpy((rng.random((D, 100)) < rng.random((D, 1)))
                                 .astype(np.uint8)).to(cuda)
        if trial == 1:
            valid.zero_()
        lvl0 = int(rng.integers(0, 10))
        row = (lvl0, 9 if trial != 4 else lvl0, trial % 2, 7, 2)
        stale = torch.from_numpy(rng.integers(-5, 5, (D, lv.CTL_SIZE)).astype(np.int32))
        kc, pc = stale.to(cuda), stale.to(cuda)
        ks = torch.ones((D, lv.LEVEL_STAT_ROWS, 4), dtype=torch.int32, device=cuda)
        ps = ks.clone()
        lv.chunk_init(kc, valid, ks, [row], ticket)
        lv.chunk_init_plain(pc, valid, ps, [row], ticket)
        torch.cuda.synchronize()
        assert torch.equal(kc, pc) and torch.equal(ks, ps) and int(ticket.abs().sum()) == 0
    assert device_work(lambda: lv.chunk_init(kc, valid, ks, [row], ticket)) == _launches_only(1)


@pytest.mark.parametrize("nb", [1, 3, 100, 128])
def test_chunk_init_rows_match_plain(cuda, nb):
    """The chunk start with a row a member in its parameters (up to
    CS_INLINE) and with one shared row, bit for bit against the plain
    version: control blocks, stats rings; one device launch."""
    rng = np.random.default_rng(nb)
    F = 64
    for shared in (False, True):
        valid = torch.from_numpy((rng.random((nb, F)) < 0.3).astype(np.uint8)).to(cuda)
        lvl0 = rng.integers(0, 50, nb)
        rows = lv.chunk_rows(lvl0, lvl0 + rng.integers(0, 3, nb), rng.integers(0, 2, nb),
                             rng.integers(1, 99, nb), rng.integers(0, 9, nb))
        if shared:
            rows = rows[:1]
        kc = torch.full((nb, lv.CTL_SIZE), 3, dtype=torch.int32, device=cuda)
        pc = kc.clone()
        ks = torch.ones((nb, lv.LEVEL_STAT_ROWS, 4), dtype=torch.int32, device=cuda)
        ps = ks.clone()
        lv.chunk_init(kc, valid, ks, rows)
        lv.chunk_init_plain(pc, valid, ps, rows)
        torch.cuda.synchronize()
        assert torch.equal(kc, pc) and torch.equal(ks, ps)
    assert device_work(lambda: lv.chunk_init(kc, valid, ks, rows)) == _launches_only(1)


def test_chunk_init_ladder_table_matches_plain(cuda):
    """A batch above CS_INLINE members reads the ladder table on the card:
    three chunks of the ladder's rule (fresh, then the control blocks the
    previous chunk left: accepted, overflowed, emptied, stuck, at its
    total), bit for bit against the plain version, table included."""
    nb, F, lpc = 200, 32, 7
    rng = np.random.default_rng(7)
    totals = rng.integers(1, 40, nb)
    lossy = rng.integers(0, 2, nb)
    lvl0 = np.minimum(rng.integers(0, 30, nb), totals)
    kt = lv.ladder_table(lvl0, totals, lossy, rng.integers(1, 99, nb), rng.integers(0, 9, nb),
                         cuda)
    pt = kt.clone()
    kc = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32, device=cuda)
    pc = kc.clone()
    for chunk in range(3):
        valid = torch.from_numpy((rng.random((nb, F)) < 0.5).astype(np.uint8)).to(cuda)
        lv.chunk_init(kc, valid, None, None, table=kt, lpc=lpc)
        lv.chunk_init_plain(pc, valid, None, None, table=pt, lpc=lpc)
        torch.cuda.synchronize()
        assert torch.equal(kc, pc) and torch.equal(kt, pt), chunk
        # what a chunk's levels leave: some members on, some stopped
        step = torch.from_numpy(rng.integers(0, lpc + 1, nb).astype(np.int32)).to(cuda)
        kc[:, lv.CTL_LVL] = torch.minimum(kc[:, lv.CTL_LVL] + step, kc[:, lv.CTL_MAXLVL])
        for col in (lv.CTL_ACC, lv.CTL_OVF, lv.CTL_STUCK):
            kc[:, col] = torch.from_numpy((rng.random(nb) < 0.1).astype(np.int32)).to(cuda)
        pc.copy_(kc)
    assert device_work(lambda: lv.chunk_init(kc, valid, None, None, table=kt, lpc=lpc)) \
        == _launches_only(1)


@pytest.mark.parametrize("mode", ["alltoall", "allgather"])
def test_sharded_level_device_launches(cuda, mode):
    """A sharded level at KO = 1 is 8 device launches in both modes (the
    expand, stage 1, the route or the exchange with the received rows'
    keys, two take-col sorts, the prune with the reduce, the compaction
    sort and the gather-finalize), counted from a stream capture; no
    reduce launch and no hash launch."""
    import chip_smoke

    model, enc = _sharded_history(1)
    plan, g, tabs = chip_smoke.sharded_setup(lv, wgl, enc, 64 * 8, 8, mode, model)
    assert g.KO1 == 1
    fr0 = wgl.initial_frontier(64 * 8, g.W, g.KO, g.S, plan.init_state, "cuda")
    fr = tuple(a.reshape((8, 64) + tuple(a.shape[1:])).contiguous() for a in fr0[:5])
    ws = lv.BatchWorkspace(g, 8, cuda)
    ws.ctl[:, lv.CTL_GO] = 1
    prog = lv._LevelProgram(g, tabs, fr, ws, model)
    prog()
    # packed inside the capture, so that the launches go to its stream
    work = device_work(lambda: lv._LevelProgram(g, tabs, fr, ws, model)())
    assert work == _launches_only(8), work
    names = [name for name, _fn, _a in prog.steps]
    assert names.count("wgl_route") == (mode == "alltoall") and names.count("wgl_stage1_hash") == 1


def test_sharded_wrappers_refuse_bad_meshes(cuda):
    model, enc = _sharded_history(1)
    plan = wgl.plan_device(enc, device="cuda")
    g = wgl.sharded_geometry(plan, 16, 2, "alltoall")
    ctl = torch.zeros((3, lv.CTL_SIZE), dtype=torch.int32, device=cuda)
    crows = torch.zeros((3, g.P, g.NC), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="members"):
        lv.route(g, crows, ctl, torch.zeros((3, g.L, g.NC), dtype=torch.int32, device=cuda),
                 torch.zeros((3, g.L), dtype=torch.uint8, device=cuda), lv.route_scratch(g, cuda),
                 torch.zeros((3, g.L), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="allgather"):
        lv.exchange(g, crows, ctl, crows, crows, crows, crows)
    with pytest.raises(ValueError):
        wgl.sharded_geometry(plan, 16, lv.MAX_SHARDS + 1, "alltoall")


# ---------------------------------------------------------------------------
# The resilience layer and the segmented checker on the card


def _resilience_clean(monkeypatch):
    from jepsen_tpu_torch.parallel import resilience
    from jepsen_tpu_torch.testing import chaos

    monkeypatch.delenv("JEPSEN_NO_FAILOVER", raising=False)
    resilience.reset_breakers()
    chaos.reset()


def _batch_rows(results):
    return [(r["valid"], r.get("levels"), r.get("frontier_max"), r.get("stuck_configs"))
            for r in results]


@pytest.mark.parametrize("point,on_call", [("device.dispatch", 1), ("device.dispatch", 2),
                                           ("host.stack", 1)])
def test_batch_retry_on_the_card(cuda, monkeypatch, point, on_call):
    """An injected fault in a batch on the card: the batch runs again and
    every member's result is the plain path's."""
    from jepsen_tpu_torch.parallel import check_batch
    from jepsen_tpu_torch.telemetry import Registry
    from jepsen_tpu_torch.testing import chaos

    _resilience_clean(monkeypatch)
    rng = random.Random(5)
    hs = [random_register_history(rng, n_ops=60, n_procs=4) for _ in range(6)]
    plain = check_batch(CasRegister(init=0), hs, f=16, device="cuda", plain=True)
    reg = Registry()
    with chaos.inject(point, on_call=on_call):
        got = check_batch(CasRegister(init=0), hs, f=16, device="cuda", metrics=reg)
    assert _batch_rows(got) == _batch_rows(plain)
    assert reg.counter("wgl_retry_total", labelnames=("reason",)).labels(
        reason="batch").value == 1


@pytest.mark.parametrize("mode", ["alltoall", "allgather"])
def test_sharded_chunk_retry_on_the_card(cuda, monkeypatch, mode):
    """``device.dispatch`` at the third chunk, and a fault after a chunk's
    levels ran: the retried search gives the plain search's verdict and
    per-chunk rows."""
    from jepsen_tpu_torch.parallel import frontier, make_mesh
    from jepsen_tpu_torch.testing import chaos

    _resilience_clean(monkeypatch)
    monkeypatch.delenv("JEPSEN_WGL_EXCHANGE", raising=False)
    enc = encode_history(CasRegister(init=0),
                         random_register_history(random.Random(91), n_ops=80, n_procs=4,
                                                 crash_p=0.0))

    def run(**kw):
        rows = []
        res = frontier.check_encoded_sharded(enc, mesh=make_mesh(4), f_total=64,
                                             levels_per_call=4, exchange=mode,
                                             chunk_callback=lambda i: rows.append(
                                                 (i["level"], i["count"])), **kw)
        return (res["valid"], res.get("levels"), res.get("stuck_configs")), rows

    plain = run(plain=True)
    assert len(plain[1]) >= 3
    with chaos.inject("device.dispatch", on_call=3):
        assert run() == plain
    real = lv.run_chunk_sharded
    n = {"calls": 0}

    def run_then_fail(*a, **kw):
        out = real(*a, **kw)
        n["calls"] += 1
        if n["calls"] == 2:
            raise torch.OutOfMemoryError("CUDA out of memory (after the chunk's levels)")
        return out

    monkeypatch.setattr(lv, "run_chunk_sharded", run_then_fail)
    assert run() == plain


@pytest.mark.parametrize("invalid", [False, True])
def test_segmented_device_engine_on_the_card(cuda, monkeypatch, invalid):
    """The offline checker's device engine on the card: the result map is
    the plain path's (the same engine on CPU tensors) and the host
    engine's (the engine name aside), and a round reached the batched
    search with more than one member."""
    from jepsen_tpu_torch import independent as ind
    from jepsen_tpu_torch import offline
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.telemetry import Registry
    from jepsen_tpu_torch.testing import concurrent_register_history

    _resilience_clean(monkeypatch)
    ops = []
    for i in range(4):
        rng = random.Random(30 + i)
        hk = concurrent_register_history(rng, n_ops=240, n_writers=4)
        if invalid and i == 0:
            hk = perturb_history(rng, hk)
        ops.extend(op.with_(process=op.process + 1000 * i, value=ind.KV(f"k{i}", op.value),
                            index=-1) for op in hk)
    ops.sort(key=lambda o: o.time)
    h = History(ops[:-9], reindex=True)
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k not in ("wall_s", "decide_s", "busy_pct", "plan", "engine")}
        return [strip(v) for v in x] if isinstance(x, (list, tuple)) else x

    reg = Registry()
    dev = offline.check_offline(CasRegister(init=0), h, engine="device", streams=2,
                                metrics=reg)
    plain = offline.check_offline(CasRegister(init=0), h, engine="device", streams=2,
                                  device="cpu")
    host = offline.check_offline(CasRegister(init=0), h, engine="host", streams=2)
    assert strip(dev) == strip(plain) == strip(host) and dev["valid"] is (not invalid)
    rounds = [e for e in reg.events() if e["name"] == "online_round"]
    assert any(e["engine"] == "device" and e["oracle_members"] > 1 for e in rounds)
    assert not any(e["failover"] for e in rounds) and "failover" not in dev


def test_segmented_rescue_on_the_card(cuda, monkeypatch):
    """The scheduler's budget-tripped rescue on the card: at a stage-1
    budget that trips every key's first segment, those non-terminal members
    of every stream go to the batched search, and the result map is the
    plain path's and the host engine's at the same budget."""
    from jepsen_tpu_torch import independent as ind
    from jepsen_tpu_torch import offline
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.telemetry import Registry
    from jepsen_tpu_torch.testing import concurrent_register_history

    _resilience_clean(monkeypatch)
    keys = 64
    ops = []
    for i in range(keys):
        hk = concurrent_register_history(random.Random(300 + i), n_ops=40, n_writers=5)
        ops.extend(op.with_(process=op.process + 1000 * i, value=ind.KV(f"k{i}", op.value),
                            index=-1) for op in hk)
    ops.sort(key=lambda o: o.time)
    h = History(ops, reindex=True)

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k not in ("wall_s", "decide_s", "busy_pct", "plan", "engine")}
        return [strip(v) for v in x] if isinstance(x, (list, tuple)) else x

    reg = Registry()
    kw = dict(streams=4, max_configs=64)
    dev = offline.check_offline(CasRegister(init=0), h, engine="device", metrics=reg, **kw)
    plain = offline.check_offline(CasRegister(init=0), h, engine="device", device="cpu", **kw)
    host = offline.check_offline(CasRegister(init=0), h, engine="host", **kw)
    assert strip(dev) == strip(plain) == strip(host)
    rounds = [e for e in reg.events() if e["name"] == "online_round"]
    members = [e["oracle_members"] for e in rounds if e["engine"] == "device"]
    assert sum(members) >= keys and not any(e["failover"] for e in rounds)


def test_replay_store_on_the_card(cuda, tmp_path):
    """A stored run replayed on the card writes the ``rechecked.edn`` that
    the same replay writes on the CPU, but for the wall times, and the
    command's exit code says invalid for a perturbed run."""
    import re
    import shutil

    from jepsen_tpu_torch import cli, store
    from jepsen_tpu_torch.parallel import replay

    rng = random.Random(41)
    hists = [random_register_history(rng, n_ops=40, n_procs=4, crash_p=0.05)
             for _ in range(5)]
    hists[2] = perturb_history(rng, hists[2])
    for i, h in enumerate(hists):
        store.save_1({"name": "card", "start-time": store.time_str(1785456000 + i),
                      "store-root": str(tmp_path / "gpu"), "history": h})
    shutil.copytree(tmp_path / "gpu", tmp_path / "cpu", symlinks=True)
    code = cli.run(cli.replay_cmd(model_args={"init": 0}),
                   ["replay", "--store-root", str(tmp_path / "gpu")])
    summary = replay.replay_store(root=tmp_path / "cpu", model_args={"init": 0},
                                  device="cpu")
    assert code == cli.EXIT_INVALID and summary["invalid"] == 1
    no_walls = lambda p: re.sub(r":wall_s [0-9.e+-]+", "", p.read_text())  # noqa: E731
    files = sorted((tmp_path / "gpu").rglob("rechecked.edn"))
    assert len(files) == 5
    for f in files:
        assert no_walls(f) == no_walls(tmp_path / "cpu" / f.relative_to(tmp_path / "gpu"))


def test_edn_fast_builds_on_the_cards_machine(cuda):
    """The C EDN reader builds where the card is (a machine without
    ``Python.h`` reads with Python alone and says so)."""
    from jepsen_tpu_torch import edn, native

    fast = native.load_edn_fast()
    if fast is None:
        pytest.skip(f"edn_fast not built: {native.edn_fast_missing}")
    assert fast.parse_all("{:f :cas, :value [1 2]}") == [
        {edn.K("f"): edn.K("cas"), edn.K("value"): [1, 2]}]


def _runner_test(tmp_path, n_ops=300, lose_at=None, **extra):
    """A short cas-register run through ``core.run`` on the card: the atom
    register (1 ms a call) over 4 workers, the linearizable checker on the
    card; ``lose_at`` loses that call's reply (the op stays ``:info``), so
    the rest of the run is an open tail for the monitor's device oracle."""
    import threading

    from jepsen_tpu_torch import checker as jchecker
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.workloads import AtomClient, AtomDB, AtomState, noop_test

    calls, lock = [0], threading.Lock()

    class Client(AtomClient):
        def invoke(self, test, op):
            res = super().invoke(test, op)
            with lock:
                calls[0] += 1
                lost = calls[0] == lose_at
            if lost:
                raise TimeoutError("reply lost")
            return res

    state = AtomState()
    test = dict(noop_test())
    test.update(
        name="runner", db=AtomDB(state), client=Client(state), model=CasRegister(init=0),
        concurrency=4, checker=jchecker.linearizable(model=CasRegister(init=0)),
        generator=gen.clients(gen.limit(n_ops, gen.mix([
            lambda: {"f": "write", "value": gen.rand_int(5)},
            lambda: {"f": "cas", "value": [gen.rand_int(5), gen.rand_int(5)]},
            lambda: {"f": "read"}]))),
        **{"store-root": str(tmp_path)})
    test.update(extra)
    return test


def test_runner_analysis_and_monitor_launch_the_level_kernels(cuda, tmp_path):
    """``core.run`` with the online monitor's device oracle: the monitor's
    rounds and then the analysis each launch every level kernel, and both
    verdicts are the C engine's on the stored history."""
    from jepsen_tpu_torch import core, store
    from jepsen_tpu_torch.checker import checker_fn

    test = _runner_test(tmp_path, lose_at=10, **{"online?": True, "online-engine": "device",
                                                 "telemetry?": True})
    inner, counted = test["checker"], {}

    def analysis(t, h, o):
        counted["online"] = dict(lv.LAUNCHES)
        lv.reset_launches()
        res = inner.check(t, h, o)
        counted["analyze"] = dict(lv.LAUNCHES)
        return res

    test["checker"] = checker_fn(analysis)
    lv.reset_launches()
    res = core.run(test)
    level = ("wgl_chunk_init", "wgl_expand", "wgl_take_col_sort", "radix_sort_pairs",
             "wgl_prune", "wgl_gather_finalize")
    for path in ("online", "analyze"):
        assert all(counted[path][k] > 0 for k in level), (path, counted[path])
    assert res["results"]["valid"] is res["online-results"]["valid"] is True
    assert res["results"]["torch_device"] == "cuda"
    stored = store.load_history("runner", res["start-time"], root=tmp_path)
    native = wgl.check_history(CasRegister(init=0), stored, backend="native")
    assert native["valid"] is True
    rounds = [e for e in res["telemetry-registry"].events("online_round")
              if e.get("engine") == "device" and e.get("oracle_members")]
    assert rounds


def test_runner_device_error_in_the_monitor_is_raised(cuda, tmp_path, monkeypatch):
    """A deterministic device error of the monitor's oracle is raised out of
    the run, not answered by the host; online.json keeps the partial fold."""
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch.online import scheduler as sched_mod

    def broken(self, encs):
        raise ValueError("plan refused on the card")

    monkeypatch.setattr(sched_mod.SegmentScheduler, "_decide_device", broken)
    test = _runner_test(tmp_path, n_ops=60, lose_at=5,
                        **{"online?": True, "online-engine": "device"})
    with pytest.raises(ValueError, match="plan refused on the card"):
        core.run(test)
    assert list(tmp_path.rglob("online.json"))


def test_runner_cli_defaults_to_the_card(cuda, tmp_path):
    """``python -m jepsen_tpu_torch test`` with no ``--device`` decides on
    the card, and ``analyze`` re-checks the stored run there."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root),
                                                        os.environ.get("PYTHONPATH", "")]))
    common = ["--workload", "cas-register", "--store-root", str(tmp_path)]
    a = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch", "test", *common,
                        "--time-limit", "2", "--rate", "200", "--no-ssh"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert a.returncode == 0, a.stderr[-2000:]
    b = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch", "analyze", *common],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert b.returncode == 0, b.stderr[-2000:]
    assert ':torch_device "cuda"' in next(tmp_path.rglob("results.edn")).read_text()
