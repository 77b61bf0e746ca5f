"""The port's batched check (``parallel.check_encoded_batch``) against the
JAX reference's, per member: verdict, levels, frontier peak, escalation,
the rung it was decided at, the rungs run, beam, refutation level and
witness, and the causes of an unknown. The port runs on the CPU; the
reference runs unsharded (``mesh=None``).

The seed-77 batch is the reference's own escalation differential
(``tests/test_parallel.py``): valid, refuted and unknown-via-serial
members at a tiny schedule."""

import random

import pytest

from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.parallel.batch import check_encoded_batch as ref_check_encoded_batch
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl_host
from jepsen_tpu_torch.ops.encode import encode_history
from jepsen_tpu_torch.parallel import Mesh, check_batch, check_encoded_batch, check_histories
from jepsen_tpu_torch.testing import perturb_history, random_register_history

KEYS = ("valid", "levels", "frontier_max", "escalated", "decided_at_F", "beam",
        "max_linearized", "stuck_configs", "batched", "op_count")


def _seed77():
    """The reference's seed-77 batch, in both packages."""
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


def _mix():
    """Members of different lengths and crash rates, every third perturbed."""
    h1, h2 = [], []
    for i in range(7):
        kw = dict(n_ops=16 + 4 * i, n_procs=4 + i % 3, crash_p=0.05 * (i % 4))
        a = ref_random(random.Random(500 + i), **kw)
        b = random_register_history(random.Random(500 + i), **kw)
        if i % 3 == 0:
            a = ref_perturb(random.Random(600 + i), a)
            b = perturb_history(random.Random(600 + i), b)
        h1.append(a)
        h2.append(b)
    return h1, h2


def _rungs(res):
    return [(r["F"], r["members"], r["calls"]) for r in res.get("rungs") or []]


def _compare(hists, **kw):
    h1, h2 = hists
    ref = ref_check_encoded_batch([ref_encode(RefCas(init=0), h) for h in h1], mesh=None, **kw)
    port = check_encoded_batch([encode_history(CasRegister(init=0), h) for h in h2],
                               device="cpu", **kw)
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        for k in KEYS:
            assert p.get(k) == r.get(k), (i, k, p.get(k), r.get(k))
        assert _rungs(p) == _rungs(r), i
        assert [c["code"] for c in p.get("causes", [])] == \
            [c["code"] for c in r.get("causes", [])], i
    return port


def test_seed77_escalation_matches_reference():
    port = _compare(_seed77(), f=2, f_schedule=(4, 8))
    assert {str(r["valid"]) for r in port} == {"True", "False", "unknown"}
    assert any(r.get("escalated") is True for r in port)
    assert all(r.get("escalated") == "serial" for r in port if r["valid"] == "unknown")
    assert any(r.get("stuck_configs") for r in port if r["valid"] is False)


@pytest.mark.parametrize("escalate", [False, "serial"])
def test_seed77_other_escalations_match_reference(escalate):
    port = _compare(_seed77(), f=2, f_schedule=(4, 8), escalate=escalate)
    if escalate is False:
        assert any(r["valid"] == "unknown" and r["causes"][0]["code"] == "overflow_top_rung"
                   for r in port)
    else:
        assert any(r.get("escalated") == "serial" for r in port)


def test_seeded_mix_matches_reference():
    port = _compare(_mix(), f=16)
    # Every refutation agrees with the port's host oracle.
    _, h2 = _mix()
    for r, h in zip(port, h2):
        if r["valid"] is False:
            assert wgl_host.check_history_host(CasRegister(init=0), h)["valid"] is False


def test_batch_agrees_with_single_searches_and_host_oracle():
    """Port alone: the batch and the single search with the same schedule
    reach the same verdicts, and definite ones agree with the host."""
    from jepsen_tpu_torch.ops import wgl

    _, h2 = _mix()
    encs = [encode_history(CasRegister(init=0), h) for h in h2]
    got = check_encoded_batch(encs, f=16, f_schedule=(16, 64, 256), device="cpu")
    for g, e, h in zip(got, encs, h2):
        single = wgl.check_encoded_device(e, f_schedule=(16, 64, 256), device="cpu")
        assert g["valid"] == single["valid"]
        if g["valid"] is not True or not g.get("batched"):
            continue
        assert g["levels"] == single["levels"]
    host = [wgl_host.check_history_host(CasRegister(init=0), h)["valid"] for h in h2]
    assert [g["valid"] for g in got] == host


def test_beam_outcome_follows_the_batch_padding_as_in_reference():
    """A member's lossy-beam outcome depends on the dims the batch pads it
    to (the dedup hash covers the padded window words, and the beam keeps
    ties in hash order): seed 33 is unknown alone and True beside a
    wider member, in both packages alike."""
    kw, wide = dict(n_ops=60, n_procs=5, crash_p=0.1), dict(n_ops=60, n_procs=40, crash_p=0.05)
    a = (ref_random(random.Random(33), **kw), random_register_history(random.Random(33), **kw))
    b = (ref_random(random.Random(1033), **wide),
         random_register_history(random.Random(1033), **wide))
    alone = _compare(([a[0]], [a[1]]), f=4, f_schedule=(4, 8))
    pair = _compare(([a[0], b[0]], [a[1], b[1]]), f=4, f_schedule=(4, 8))
    assert alone[0]["valid"] == "unknown" and pair[0]["valid"] is True


def test_north_star_shape_ladder_leaves_valid_members_unknown_as_in_reference():
    """Eight members shaped as the 8x10k batch (seeds 17 + i, ten
    processes, the north star's crash and fail rates), cut to 250 ops and a
    ladder of 4 -> 8 -> 16: the top rung's beam accepts some valid members
    and strands others, which the serial last resort with the same
    schedule leaves unknown, member for member as in the reference. The
    default single search decides the first of them."""
    from jepsen_tpu_torch.ops import wgl

    kw = dict(n_ops=250, n_procs=10, cas=True, crash_p=0.002, fail_p=0.02)
    hists = ([ref_random(random.Random(17 + i), **kw) for i in range(8)],
             [random_register_history(random.Random(17 + i), **kw) for i in range(8)])
    port = _compare(hists, f=4, f_schedule=(4, 8, 16), escalate=True)
    verdicts = [r["valid"] for r in port]
    assert False not in verdicts and True in verdicts and "unknown" in verdicts
    assert all(r.get("decided_at_F") == 16 and r.get("beam") for r in port
               if r["valid"] is True)
    assert all(r.get("escalated") == "serial" for r in port if r["valid"] == "unknown")
    stranded = [h for h, v in zip(hists[1], verdicts) if v == "unknown"]
    assert all(wgl.check_history(CasRegister(init=0), h, device="cpu")["valid"] is True
               for h in stranded[:1])


def test_entry_points_and_empty_batch():
    _, h2 = _seed77()
    a = check_batch(CasRegister(init=0), h2[:2], f=16, device="cpu")
    b = check_histories(CasRegister(init=0), h2[:2], f=16, device="cpu")
    assert [r["valid"] for r in a] == [r["valid"] for r in b]
    assert all(r["batched"] for r in a)
    assert check_encoded_batch([], device="cpu") == []


def test_mixed_model_families_refused():
    from jepsen_tpu_torch.models import Register

    _, h2 = _seed77()
    encs = [encode_history(CasRegister(init=0), h2[0]),
            encode_history(Register(init=0), random_register_history(
                random.Random(1), n_ops=8, cas=False))]
    with pytest.raises(ValueError, match="one model family"):
        check_encoded_batch(encs, device="cpu")


@pytest.mark.parametrize("kw", [dict(mesh=Mesh((2, 1), ("dp", "mp"), "cuda")),
                                dict(retries=2)])
def test_later_slice_options_raise(kw):
    """``retries`` (the batch's resilience) comes with a later slice and
    raises; a mesh is ported, and one on another device than ``device=``
    raises."""
    _, h2 = _seed77()
    match = "not the mesh's device" if "mesh" in kw else "later slice"
    with pytest.raises(ValueError, match=match):
        check_batch(CasRegister(init=0), h2[:1], device="cpu", **kw)
