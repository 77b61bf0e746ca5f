"""The port's batch on a mesh (``parallel.check_batch(mesh=)``) against
the JAX reference's on the conftest's 8 virtual CPU devices: whole result
maps, member by member, with the reference's divisibility padding (copies
of the first row that run and are dropped) and its chunk length of
``ceil(Bk/dp)`` members. Only the wall times and the port's own
``torch_device`` are left out; every other field, the rungs' ``calls``
included, must be equal. The port's mesh is D shards on the CPU
device."""

import random

import pytest
import torch

from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.parallel import check_batch as ref_check_batch
from jepsen_tpu.parallel import make_mesh as ref_make_mesh
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.parallel import Mesh, check_batch, make_mesh
from jepsen_tpu_torch.testing import perturb_history, random_register_history


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain stages run many small ops: one intra-op thread each keeps
    a worker from oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(seed, n):
    """tests/test_parallel.py's ``_mixed_histories``, in both packages."""
    out = []
    for draw, perturb in ((ref_random, ref_perturb),
                          (random_register_history, perturb_history)):
        rng = random.Random(seed)
        hs = []
        for i in range(n):
            h = draw(rng, n_ops=16, n_procs=3, crash_p=0.1)
            if i % 3 == 2:
                h = perturb(rng, h)
            hs.append(h)
        out.append(hs)
    return out


def _small13():
    """tests/test_parallel.py:176-181's 13 histories."""
    return [[draw(rng, n_ops=10, n_procs=2, crash_p=0.0) for _ in range(13)]
            for draw, rng in ((ref_random, random.Random(1)),
                              (random_register_history, random.Random(1)))]


def _seed77():
    """tests/test_torch_batch.py's seed-77 batch: valid, refuted and
    unknown-via-serial members at a tiny schedule."""
    r1, r2 = random.Random(77), random.Random(77)
    h1, h2 = [], []
    for i in range(5):
        a = ref_random(r1, n_ops=18, n_procs=4, cas=True, crash_p=0.2)
        b = random_register_history(r2, n_ops=18, n_procs=4, cas=True, crash_p=0.2)
        if i % 2:
            a, b = ref_perturb(r1, a), perturb_history(r2, b)
        h1.append(a)
        h2.append(b)
    return h1, h2


def _timeless(res):
    """A result map without its wall times (the map's, its rungs' and its
    attempts') and the port's own ``torch_device``."""
    out = {k: v for k, v in res.items() if k not in ("wall_s", "torch_device")}
    for key in ("rungs", "attempts", "optimistic_attempts"):
        if out.get(key):
            out[key] = [{k: v for k, v in r.items() if k != "wall_s"} for r in out[key]]
    return out


def _compare(hists, d, **kw):
    h1, h2 = hists
    ref = ref_check_batch(RefCas(init=0), h1, mesh=ref_make_mesh(d, shape=(d, 1)), **kw)
    port = check_batch(CasRegister(init=0), h2, mesh=make_mesh(d, device="cpu"), **kw)
    assert len(port) == len(ref) == len(h2)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert _timeless(p) == _timeless(r), i
    return port


@pytest.mark.parametrize("d", [8, 3])
def test_mixed_batch_on_a_mesh_matches_reference(d):
    """tests/test_parallel.py:30-39: 11 histories, f = 64, not divisible
    by 8 (5 padding copies) nor by 3 (1)."""
    port = _compare(_mixed(22, 11), d, f=64)
    plain = check_batch(CasRegister(init=0), _mixed(22, 11)[1], f=64, device="cpu")
    assert [_timeless(r) for r in port] == [_timeless(r) for r in plain]


def test_rung_members_count_a_live_members_padding_copies_as_reference():
    """At f = 8 two members of the mixed batch escalate; on 8 shards the
    rung pads them with six copies of the first, and the reference counts
    those copies in the rung's ``members`` (they are rows of a real
    member), so the port does too: 8 where the batch without a mesh says 2."""
    port = _compare(_mixed(22, 11), 8, f=8)
    alone = check_batch(CasRegister(init=0), _mixed(22, 11)[1], f=8, device="cpu")
    rungs = lambda res: next(r["rungs"] for r in res if r.get("rungs"))  # noqa: E731
    assert [(x["F"], x["members"]) for x in rungs(port)] == [(8, 11), (16, 8)]
    assert [(x["F"], x["members"]) for x in rungs(alone)] == [(8, 11), (16, 2)]
    assert [r["valid"] for r in port] == [r["valid"] for r in alone]


def test_thirteen_histories_on_eight_shards_match_reference():
    port = _compare(_small13(), 8, f=16)
    assert all(r["valid"] is True for r in port)


@pytest.mark.parametrize("d", [8, 3])
def test_escalating_batch_on_a_mesh_matches_reference(d):
    """The ladder pads each rung's live rows too: the seed-77 batch at
    f = 2 -> 4 -> 8 escalates and falls back to the serial driver."""
    port = _compare(_seed77(), d, f=2, f_schedule=(4, 8))
    assert {str(r["valid"]) for r in port} == {"True", "False", "unknown"}
    assert any(r.get("escalated") is True for r in port)
    # No padding copy shows: each rung counts the real members only.
    for r in port:
        for rung in r.get("rungs") or []:
            assert rung["members"] <= 5


@pytest.mark.parametrize("d", [8, 3])
def test_chunk_length_counts_one_shards_members(d, monkeypatch):
    """A chunk's level budget follows ``F * CC * ceil(Bk/dp)``: under a
    cost rule that cuts chunks to 2 levels above 100 candidate slots, the
    8-shard batch (one member a shard) runs each rung in one call, the
    3-shard one in several, both as the reference does."""
    rule = lambda M, target_s=8.0: 2 if M > 100 else 16  # noqa: E731
    monkeypatch.setattr(ref_wgl, "_levels_per_call", rule)
    monkeypatch.setattr(wgl, "_levels_per_call", rule)
    port = _compare(_seed77(), d, f=2, f_schedule=(4, 8))
    calls = [x["calls"] for r in port for x in r.get("rungs") or []]
    assert calls and (max(calls) == 1) == (d == 8)


def test_a_conflicting_device_raises():
    _, h2 = _seed77()
    with pytest.raises(ValueError, match="not the mesh's device"):
        check_batch(CasRegister(init=0), h2[:2], mesh=make_mesh(2, device="cpu"),
                    device="cuda")
    with pytest.raises(ValueError, match="not the mesh's device"):
        check_batch(CasRegister(init=0), h2[:2], mesh=Mesh((2, 1), ("dp", "mp"), "cuda"),
                    device="cpu")
    got = check_batch(CasRegister(init=0), h2[:2], mesh=make_mesh(2, device="cpu"),
                      device="cpu", f=16)
    assert [r["valid"] for r in got] == [r["valid"] for r in check_batch(
        CasRegister(init=0), h2[:2], device="cpu", f=16)]


def test_batch_axis_names_the_sharded_axes():
    """Only the axes named ``batch_axis`` pad the rows: on a (2, 4) mesh
    sharded over "mp" the batch pads to 4."""
    h1, h2 = _seed77()
    mesh = make_mesh(8, shape=(2, 4), device="cpu")
    ref = ref_check_batch(RefCas(init=0), h1, f=2, f_schedule=(4, 8),
                          mesh=ref_make_mesh(8, shape=(2, 4)), batch_axis="mp")
    port = check_batch(CasRegister(init=0), h2, f=2, f_schedule=(4, 8), mesh=mesh,
                       batch_axis="mp")
    assert [_timeless(r) for r in port] == [_timeless(r) for r in ref]
