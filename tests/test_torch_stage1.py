"""The stage-1 compaction and hash and the dense Elle gather, on the CPU:
the port's plain versions against the JAX reference's own operations, and
the wrappers' scratch and refusals.

``stage1_hash_plain`` is held against the reference's two-stage
compaction and group hash (``jepsen_tpu/ops/wgl.py:523-549`` and
``:628-645``) in two ways, on the JAX CPU: inside the reference's own level
program (``_build_kernel`` at a two-stage geometry), whose stage-1 inputs
and outputs of every level are handed to the host by spies on ``lax.sort``
and ``jnp.stack``; and restated with the same ``jax.lax`` operations on one
member at the seeded densities of ``testing.stage1_case``. Every row and
key must agree, the rows past the valid ones included. ``gather_plain`` is
held against the dense exchange of the reference's sharded closure program
(``jepsen_tpu/elle/ops.py:324``, spied the same way) and against a
restated ``lax.all_gather(..., tiled=True)`` under ``shard_map``, on the
conftest's virtual CPU devices. The CUDA kernels themselves are held to
these plain versions on the card (``tests/test_torch_cuda.py``)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec

from jepsen_tpu.elle import ops as ref_elle_ops
from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.parallel import make_mesh as ref_make_mesh
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch.elle import ops as eo
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.testing import STAGE1_DENSITIES, stage1_case


def _geometry(M, P, NC, two_stage=True):
    """A level geometry of ``M`` candidate rows of ``NC`` words (one window
    word, one open word, ``NC - 3`` state words), ``P`` survivors."""
    return lv.Geometry(F=M, W=32, KO=0, S=NC - 3, ND=64, NO=4, B=1, SEL=False,
                       two_stage=two_stage, P=P if two_stage else M)


def ref_stage1(rows, nvalid, P, NID):
    """One member through the reference's stage-1 compaction
    (``ops/wgl.py:525-549``: the fused validity/iota key, one sort, the
    top-P row gather, the survivors' validity) and its group hash and
    fused key (``:628-645``), as uint32 numpy arrays."""
    u32 = jnp.uint32
    M = rows.shape[0]
    nv = jnp.asarray(nvalid != 0)
    n_cand = jnp.sum(nv.astype(jnp.int32))
    fused = jnp.where(nv, lax.iota(u32, M), lax.iota(u32, M) | u32(0x80000000))
    (s3,) = lax.sort((fused,), dimension=0, num_keys=1)
    vidx = (s3[:P] & u32(0x7FFFFFFF)).astype(jnp.int32)
    pmat = jnp.asarray(rows.view(np.uint32))[vidx]
    valid = lax.iota(jnp.int32, P) < jnp.minimum(n_cand, P)
    return np.asarray(pmat), ref_fkey(pmat, valid, NID)


def ref_fkey(mat, valid, NID):
    u32 = jnp.uint32
    gh = jnp.full((mat.shape[0],), u32(2166136261))
    for c in range(NID):
        gh = (gh ^ mat[:, c]) * u32(16777619)
    return np.asarray(jnp.where(valid, gh >> 1, (gh >> 1) | u32(0x80000000)))


def _port(g, rows, nvalid, ctl, drows, fkey, with_key=True):
    t = [torch.from_numpy(a.copy()) for a in (rows, nvalid, ctl, drows, fkey)]
    d = t[0] if not g.two_stage else t[3]
    lv.stage1_hash_plain(g, t[0], t[1], t[2], d, t[4] if with_key else None, None)
    return d.numpy().view(np.uint32), t[4].numpy().view(np.uint32)


# Histories the reference's level program runs at a two-stage geometry
# (id, seed, n_ops, n_procs, crash_p, perturb, F): levels with no valid
# candidate (the perturbed ones get stuck), with fewer than P and with
# more than P (P = max(4F, 64) = 64 here, so the F = 16 one overflows).
REF_LEVEL_HISTORIES = [("p5-F16", 102, 30, 5, 0.25, True, 16),
                       ("p8-F16", 202, 60, 8, 0.4, False, 16),
                       ("p8-F8-stuck", 203, 40, 8, 0.5, True, 8)]


def _spy_reference_stage1(mp, seen):
    """Spies on ``lax.sort`` and ``jnp.stack`` (the reference level program
    imports them in ``_build_kernel``) that find stage 1 in its trace: the
    one-operand sort of the fused validity/iota key, then the ``[M, NC]``
    stack of the candidate rows, then the dedup sort, whose operands are
    stage 1's output (the fused key, then the open, p, window and state
    columns of the P compacted rows). Each level appends ``(num_keys,
    [fused, rows, *dedup operands])`` to ``seen`` through a debug
    callback."""
    real_sort, real_stack = lax.sort, jnp.stack
    trace = {}

    def sort(operand, dimension=-1, is_stable=True, num_keys=1):
        ops = tuple(operand) if isinstance(operand, (tuple, list)) else (operand,)
        if isinstance(operand, (tuple, list)) and len(ops) == 1 and dimension == 0:
            trace.clear()
            trace["fused"] = ops[0]
        elif "rows" in trace and dimension == 0 and len(ops) > 2:
            jax.debug.callback(
                lambda *xs, nk=num_keys: seen.append((nk, [np.asarray(x) for x in xs])),
                trace.pop("fused"), trace.pop("rows"), *ops)
        return real_sort(operand, dimension=dimension, is_stable=is_stable, num_keys=num_keys)

    def stack(arrays, axis=0, *a, **kw):
        out = real_stack(arrays, axis, *a, **kw)
        if "fused" in trace and "rows" not in trace and axis == 1:
            trace["rows"] = out
        return out

    mp.setattr(lax, "sort", sort)
    mp.setattr(jnp, "stack", stack)


@pytest.fixture(scope="module")
def reference_levels():
    """{history id: the stage-1 captures of every level} of the reference's
    level program (beam mode, from a fresh frontier to the end)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_wgl, "BIG_M_THRESHOLD", 64)
        ref_wgl._build_kernel.cache_clear()
        try:
            for hid, seed, n_ops, n_procs, crash_p, perturb, F in REF_LEVEL_HISTORIES:
                rng = random.Random(seed)
                h = ref_random(rng, n_ops=n_ops, n_procs=n_procs, crash_p=crash_p)
                if perturb:
                    h = ref_perturb(rng, h)
                enc = ref_encode(RefCas(init=0), h)
                plan = ref_wgl.plan_device(enc)
                W, KO, S, ND, NO = plan.dims
                seen = []
                with pytest.MonkeyPatch.context() as spy:
                    _spy_reference_stage1(spy, seen)
                    _, kern = ref_wgl._build_kernel(ref_wgl._model_cache_key(enc.model), F,
                                                    W, KO, S, ND, NO, B=plan.B)
                    fr = ref_wgl.initial_frontier(F, W, KO, S, plan.init_state)[:5]
                    kern(*plan.args[:2], np.int32(10**6), *plan.args[3:], *fr, np.int32(0),
                         np.int32(1))
                    jax.effects_barrier()
                out[hid] = seen
        finally:
            ref_wgl._build_kernel.cache_clear()
    return out


def _n_cand(capture):
    return int(((capture[1][0] >> 31) == 0).sum())


@pytest.mark.parametrize("hid", [h[0] for h in REF_LEVEL_HISTORIES])
def test_stage1_plain_matches_the_reference_level_program(reference_levels, hid):
    """Every level's stage 1 of the reference's own program: its candidate
    rows and validity through ``stage1_hash_plain`` give its compacted rows
    and fused keys, all P of each."""
    levels = reference_levels[hid]
    assert len(levels) >= 10
    for num_keys, (fused, rows, fkey, *cols) in levels:
        n_open = num_keys - 1
        assert n_open == 1  # one open word: the geometry below has NID = NC - 1
        M, NC = rows.shape
        P = fkey.shape[0]
        want = np.stack([cols[n_open]] + cols[n_open + 1:] + cols[:n_open], axis=1)
        g = _geometry(M, P, NC)
        nvalid = ((fused >> 31) == 0).astype(np.uint8)[None]
        ctl = np.zeros((1, lv.CTL_SIZE), dtype=np.int32)
        ctl[:, lv.CTL_GO], ctl[:, lv.CTL_NEXP] = 1, int(nvalid.sum())
        drows, key = _port(g, rows.view(np.int32)[None], nvalid, ctl,
                           np.zeros((1, P, NC), np.int32), np.zeros((1, P), np.int32))
        np.testing.assert_array_equal(drows[0], want)
        np.testing.assert_array_equal(key[0], fkey)


def test_reference_levels_cover_every_count(reference_levels):
    """The captured levels hold no valid candidate, fewer than P, and more
    than P (the survivors cut at P)."""
    seen = set()
    for levels in reference_levels.values():
        for cap in levels:
            n, P = _n_cand(cap), cap[1][2].shape[0]
            seen.add("none" if n == 0 else "over" if n > P else "within")
    assert seen == {"none", "within", "over"}


@pytest.mark.parametrize("density", STAGE1_DENSITIES)
@pytest.mark.parametrize("M,P", [(1, 1), (31, 8), (2047, 512), (2048, 512), (2049, 512),
                                 (4097, 1024)])
def test_stage1_plain_matches_the_reference(M, P, density):
    NC = 5
    g = _geometry(M, P, NC)
    case = stage1_case(M + P, 3, M, P, NC, density)
    rows, nvalid = case[0], case[1]
    drows, fkey = _port(g, *case)
    for b in range(3):
        want_rows, want_key = ref_stage1(rows[b], nvalid[b], P, g.NID)
        np.testing.assert_array_equal(drows[b], want_rows)
        np.testing.assert_array_equal(fkey[b], want_key)


@pytest.mark.parametrize("NC", range(3, 10))
def test_stage1_plain_matches_the_reference_at_every_row_width(NC):
    M, P = 3000, 700
    g = _geometry(M, P, NC)
    case = stage1_case(NC, 2, M, P, NC, "p50")
    drows, fkey = _port(g, *case)
    for b in range(2):
        want_rows, want_key = ref_stage1(case[0][b], case[1][b], P, g.NID)
        np.testing.assert_array_equal(drows[b], want_rows)
        np.testing.assert_array_equal(fkey[b], want_key)


@pytest.mark.parametrize("density", ["none", "p05", "P_plus_1"])
def test_stage1_compaction_only_leaves_the_keys(density):
    """With no ``fkey`` (a sharded level's stage 1) the rows are compacted
    as the reference compacts them and no key is written."""
    M, P, NC = 2049, 512, 6
    g = _geometry(M, P, NC)
    case = stage1_case(5, 2, M, P, NC, density)
    drows, fkey = _port(g, *case, with_key=False)
    np.testing.assert_array_equal(fkey, case[4].view(np.uint32))
    for b in range(2):
        np.testing.assert_array_equal(drows[b], ref_stage1(case[0][b], case[1][b], P, 0)[0])


def test_stage1_single_stage_hashes_every_row():
    """A single-stage level (no compaction) has no stage 1: its expand
    writes the keys, held against ``hash_rows_reference``, the hash of
    every row in place with validity from nvalid (``ops/wgl.py:628-645``
    at ``L = M``), which is checked here against the reference's."""
    M, NC = 300, 5
    g = _geometry(M, M, NC, two_stage=False)
    case = stage1_case(9, 2, M, M, NC, "p50")
    t = [torch.from_numpy(a.copy()) for a in case]
    with pytest.raises(ValueError, match="no stage 1"):
        lv.stage1_hash_plain(g, t[0], t[1], t[2], t[0], t[4], None)
    lv.vmap_members(lv.hash_rows_reference)(g, t[0], t[1], t[2], t[4])
    np.testing.assert_array_equal(t[0].numpy(), case[0])
    for b in range(2):
        want = ref_fkey(jnp.asarray(case[0][b].view(np.uint32)), jnp.asarray(case[1][b] != 0),
                        g.NID)
        np.testing.assert_array_equal(t[4][b].numpy().view(np.uint32), want)


def test_stage1_plain_leaves_a_stopped_member_untouched():
    M, P, NC = 2049, 512, 5
    g = _geometry(M, P, NC)
    case = stage1_case(4, 3, M, P, NC, "p50")
    case[2][1, lv.CTL_GO] = 0
    drows, fkey = _port(g, *case)
    np.testing.assert_array_equal(drows[1], case[3][1].view(np.uint32))
    np.testing.assert_array_equal(fkey[1], case[4][1].view(np.uint32))
    assert not np.array_equal(drows[0], case[3][0].view(np.uint32))


# -- the workspace and the wrapper's refusals ----------------------------------


@pytest.mark.parametrize("M,nb", [(1, 1), (2048, 3), (2049, 3), (131072, 8)])
def test_workspace_allocates_the_stage1_scratch_zeroed_per_member(M, nb):
    g = _geometry(M, max(1, M // 4), 5)
    ws = lv.BatchWorkspace(g, nb, "cpu")
    tiles = -(-M // min(lv.STAGE1_TILES))
    assert ws.s1.dtype == torch.int32 and ws.s1.shape == (4 + 2 * nb * tiles,)
    assert int(ws.s1.abs().sum()) == 0
    for tile in lv.STAGE1_TILES:  # every tile size fits the one scratch
        assert ws.s1.numel() >= lv._stage1_words(M, nb, tile)
    assert lv.BatchWorkspace(_geometry(M, M, 5, two_stage=False), nb, "cpu").s1 is None


def test_sharded_workspace_allocates_the_stage1_scratch():
    g = lv.Geometry(F=64, W=32, KO=1, S=1, ND=64, NO=4, B=32, SEL=True, two_stage=True,
                    P=256, D=3, exchange="alltoall")
    ws = lv.BatchWorkspace(g, 3, "cpu")
    assert ws.s1.shape == (4 + 2 * 3 * (-(-g.M // 2048)),) and int(ws.s1.abs().sum()) == 0


def _args(g, nb, scratch, device="cpu"):
    z = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    return (g, z(nb, g.M, g.NC), z(nb, g.M, dt=torch.uint8), z(nb, lv.CTL_SIZE),
            z(nb, g.P, g.NC), z(nb, g.P), scratch)


def test_stage1_wrapper_refuses_short_scratch(monkeypatch):
    monkeypatch.setattr(lv, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(lv, "_stream", lambda: 0)
    nb, g = 3, _geometry(4097, 1024, 5)
    ok = lv.stage1_scratch(g.M, nb, "cpu")
    for tile in lv.STAGE1_TILES:
        monkeypatch.setattr(lv, "stage1_tile", lambda *a, tile=tile: tile)
        lv._stage1_hash_args(*_args(g, nb, ok))
        short = ok[:lv._stage1_words(g.M, nb, tile) - 1]
        assert short.numel() >= 4 + 2 * nb * (-(-g.M // tile)) - 1
        with pytest.raises(ValueError, match="scratch"):
            lv._stage1_hash_args(*_args(g, nb, short))
    with pytest.raises(ValueError, match="scratch"):
        lv._stage1_hash_args(*_args(g, nb, None))
    with pytest.raises(ValueError, match="scratch"):
        lv._stage1_hash_args(*_args(g, nb, ok.to(torch.int64)))
    monkeypatch.setattr(lv, "stage1_tile", lambda *a: 1024)
    with pytest.raises(ValueError, match="tile"):
        lv._stage1_hash_args(*_args(g, nb, ok))


def test_stage1_wrapper_refuses_a_member_of_2_30_rows(monkeypatch):
    monkeypatch.setattr(lv, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(lv, "stage1_tile", lambda *a: 2048)
    g = _geometry(1 << 30, 1024, 3)
    with pytest.raises(ValueError, match="rows a member"):
        lv._stage1_hash_args(*_args(g, 1, torch.zeros(8, dtype=torch.int32), device="meta"))


def test_stage1_wrapper_refuses_cpu_tensors():
    """The kernel's argument check: a CPU tensor never reaches a launch
    (the CPU path is chosen by the control block's device alone)."""
    nb, g = 1, _geometry(2049, 512, 5)
    with pytest.raises(ValueError, match="expected cuda"):
        lv._stage1_hash_args(*_args(g, nb, lv.stage1_scratch(g.M, nb, "cpu")))


@pytest.mark.parametrize("M,nb,sms,tile", [(131072, 1, 132, 2048), (262144, 8, 132, 8192),
                                           (131072, 8, 132, 4096), (1 << 22, 8, 132, 8192),
                                           (2049, 3, 1, 8192)])
def test_stage1_tile_keeps_the_grid_near_two_blocks_an_sm(M, nb, sms, tile, monkeypatch):
    monkeypatch.setattr(lv, "_sm_count", lambda device: sms)
    assert lv.stage1_tile(M, nb, "cuda") == tile


# -- the dense gather ----------------------------------------------------------


def _ref_gather(x, d):
    """Each of ``d`` reference devices' ``all_gather`` of its row block of
    ``x``, stacked ``[d, rows, cols]``."""
    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map
    mesh = ref_make_mesh(d, shape=(d, 1))
    axis = mesh.axis_names[0]
    spec = PartitionSpec(axis, None)

    def raw(b):
        return lax.all_gather(b, axis, axis=0, tiled=True)

    try:
        f = shard_map(raw, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    except TypeError:  # pragma: no cover - older jax
        f = shard_map(raw, mesh=mesh, in_specs=spec, out_specs=spec, check_rep=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x))).reshape(d, *x.shape)


@pytest.mark.parametrize("cols", [64, 12])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_gather_plain_matches_the_reference_all_gather(d, cols):
    rng = np.random.default_rng(d + cols)
    x = rng.standard_normal((64, cols)).astype(np.float32)
    got = eo.gather_plain(torch.from_numpy(x), d).numpy()
    np.testing.assert_array_equal(got, x)
    for copy in _ref_gather(x, d):
        np.testing.assert_array_equal(got, copy)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_gather_plain_matches_the_reference_dense_exchange(d, monkeypatch):
    """The reference's sharded closure in its ``dense`` mode (one tiled
    ``lax.all_gather`` of each step's bf16 row blocks,
    ``jepsen_tpu/elle/ops.py:324``), with a spy on ``lax.all_gather`` that
    hands each device's block and gathered matrix to the host: at every
    step the device blocks, stacked, through ``gather_plain`` give every
    device's gathered matrix. (At 8 devices the host callbacks inside the
    collective stall the CPU backend's rendezvous until it aborts; the
    restated ``all_gather`` above covers 8.)"""
    seen = []
    real = lax.all_gather

    def all_gather(x, axis_name, *a, **kw):
        out = real(x, axis_name, *a, **kw)
        jax.debug.callback(lambda i, b, f: seen.append((int(i), np.asarray(b), np.asarray(f))),
                           lax.axis_index(axis_name), x, out)
        return out

    monkeypatch.setattr(lax, "all_gather", all_gather)
    ref_elle_ops._sharded_closure_kernel.cache_clear()
    try:
        rng = np.random.default_rng(d)
        n = 40 * d
        srcs, dsts = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
        ref_elle_ops.sharded_closure(srcs, dsts, n, ref_make_mesh(d, shape=(d, 1)),
                                     exchange="dense")
        jax.effects_barrier()
    finally:
        ref_elle_ops._sharded_closure_kernel.cache_clear()
    steps = {}  # a step's gathered matrix -> {device: its block}
    for i, block, full in seen:
        steps.setdefault(full.tobytes(), (full, {}))[1][i] = block
    assert len(seen) >= 2 * d and len(steps) >= 2
    for full, blocks in steps.values():
        assert sorted(blocks) == list(range(d))
        stacked = torch.from_numpy(np.concatenate([blocks[i] for i in range(d)]).view(np.int16))
        got = eo.gather_plain(stacked.view(torch.bfloat16), d)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), full.view(np.int16))
