"""The port's frontier-sharded driver (``parallel.frontier``) against the
JAX reference's (``jepsen_tpu.parallel.frontier``) on the conftest's
8-virtual-device CPU mesh: result maps compared key by key (verdict,
levels, attempts with F, levels and calls per rung, frontier_total,
frontier_max, n_shards, exchange, max_linearized, stuck_configs,
provenance causes), mirroring the reference's own cases
(``tests/test_frontier_sharded.py``). The port's mesh is D shards on the
CPU device; both packages draw the same histories from one seed."""

import random

import numpy as np
import pytest
import torch

from jepsen_tpu import checker as ref_checker
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.models import OwnerAwareMutex as RefMutex
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops import wgl_host as ref_host
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.parallel import frontier as ref_frontier
from jepsen_tpu.parallel import make_mesh as ref_make_mesh
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_lock_history as ref_random_lock
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch import checker as jc
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import CasRegister, OwnerAwareMutex
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.ops.encode import encode_history
from jepsen_tpu_torch.parallel import make_mesh
from jepsen_tpu_torch.parallel import frontier
from jepsen_tpu_torch.testing import perturb_history, random_lock_history, random_register_history

KEYS = ("valid", "levels", "frontier_total", "frontier_max", "n_shards", "exchange",
        "sharded", "max_linearized", "stuck_configs", "window", "op_count", "info")
_REF_MESHES = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain stages run many small ops: one intra-op thread each keeps
    a worker from oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_ambient_kill_switch(monkeypatch):
    """The kill-switch overrides ``exchange=``; an ambient one would make
    every mode here the same mode."""
    monkeypatch.delenv("JEPSEN_WGL_EXCHANGE", raising=False)


def ref_mesh(D):
    if D not in _REF_MESHES:
        _REF_MESHES[D] = ref_make_mesh(D, shape=(D, 1))
    return _REF_MESHES[D]


def _attempts(res):
    return [(a["F"], a["levels"], a["calls"], a.get("overflowed", False))
            for a in res.get("attempts") or []]


def _causes(res):
    return [(c["code"], c.get("params")) for c in res.get("causes") or []]


def compare(ref_model, port_model, h1, h2, D=8, **kw):
    """Both drivers on one history (``h1`` the reference's, ``h2`` the
    port's), compared; returns the port's result."""
    ref = ref_frontier.check_history_sharded(ref_model, h1, mesh=ref_mesh(D), **kw)
    port = frontier.check_history_sharded(port_model, h2, mesh=make_mesh(D, device="cpu"),
                                          **kw)
    for k in KEYS:
        assert port.get(k) == ref.get(k), (k, port.get(k), ref.get(k))
    assert _attempts(port) == _attempts(ref)
    assert _causes(port) == _causes(ref)
    return port


def registers(seed, n, n_ops=60, n_procs=4, crash_p=0.05, perturb_every=3):
    """``n`` register histories drawn in both packages from one seed, the
    ``perturb_every``-th ones perturbed (as the reference's tests draw)."""
    r1, r2 = random.Random(seed), random.Random(seed)
    out = []
    for i in range(n):
        a = ref_random(r1, n_ops=n_ops, n_procs=n_procs, crash_p=crash_p, cas=True)
        b = random_register_history(r2, n_ops=n_ops, n_procs=n_procs, crash_p=crash_p,
                                    cas=True)
        if perturb_every and i % perturb_every == perturb_every - 1:
            a, b = ref_perturb(r1, a), perturb_history(r2, b)
        out.append((a, b))
    return out


@pytest.mark.parametrize("mode", ["alltoall", "allgather"])
def test_register_histories_match_reference(mode):
    """The reference's register differential (seed 31, ten histories, every
    third perturbed) in both modes, each against the host oracle too."""
    seen = set()
    for a, b in registers(31, 10):
        port = compare(RefCas(init=0), CasRegister(init=0), a, b, f_total=128,
                       exchange=mode)
        assert port["valid"] == ref_host.check_history_host(RefCas(init=0), a)["valid"]
        seen.add(port["valid"])
    assert seen == {True, False}


def test_mutex_history_matches_reference():
    a = ref_random_lock(random.Random(5), n_ops=80, n_procs=4)
    b = random_lock_history(random.Random(5), n_ops=80, n_procs=4)
    port = compare(RefMutex(), OwnerAwareMutex(), a, b, f_total=128)
    assert port["valid"] == ref_host.check_history_host(RefMutex(), a)["valid"]


@pytest.mark.parametrize("mode,D", [("alltoall", 8), ("allgather", 2)])
def test_escalation_resumes_losslessly(mode, D):
    """f_total 16: overflow, x4 escalations, the same rungs as the
    reference. On 8 shards (F = 16 each) the global count fits, so only the
    alltoall's per-shard overflow escalates: the reference's imbalance
    case; the allgather runs on 2 shards, where the global count does not."""
    ((a, b),) = registers(77, 1, n_ops=80, n_procs=6, crash_p=0.1, perturb_every=0)
    port = compare(RefCas(init=0), CasRegister(init=0), a, b, D=D, f_total=16,
                   max_escalations=4, exchange=mode)
    assert len(port["attempts"]) > 1
    assert all(x["overflowed"] is True for x in port["attempts"][:-1])


def test_escalation_budget_cause_matches_reference():
    ((a, b),) = registers(77, 1, n_ops=80, n_procs=6, crash_p=0.1, perturb_every=0)
    port = compare(RefCas(init=0), CasRegister(init=0), a, b, f_total=16,
                   max_escalations=0)
    assert port["valid"] == "unknown"
    assert _causes(port)[0][0] == "escalation_budget"


def test_empty_history():
    ref = ref_frontier.check_encoded_sharded(ref_encode(RefCas(init=0), RefHistory([])),
                                             mesh=ref_mesh(8))
    port = frontier.check_encoded_sharded(encode_history(CasRegister(init=0), History([])),
                                          mesh=make_mesh(8, device="cpu"))
    assert port == {k: v for k, v in ref.items()}


def test_cross_mesh_differential():
    """Verdict and level equal for D in {1, 2, 8} in both modes, each equal
    to the reference's result map at that D and mode."""
    for i, (a, b) in enumerate(registers(63, 3, perturb_every=2)):
        levels = set()
        for D in (1, 2, 8):
            for mode in ("alltoall", "allgather"):
                port = compare(RefCas(init=0), CasRegister(init=0), a, b, D=D, f_total=128,
                               exchange=mode)
                assert port["n_shards"] == D and port["exchange"] == mode
                levels.add((port["valid"], port["levels"]))
        assert len(levels) == 1, (i, levels)


def test_env_kill_switch_selects_allgather(monkeypatch):
    ((_a, b),) = registers(31, 1, perturb_every=0)
    mesh = make_mesh(8, device="cpu")
    monkeypatch.setenv("JEPSEN_WGL_EXCHANGE", "allgather")
    m = CasRegister(init=0)
    assert frontier.check_history_sharded(m, b, mesh=mesh, f_total=128)["exchange"] == \
        "allgather"
    assert frontier.check_history_sharded(m, b, mesh=mesh, f_total=128,
                                          exchange="alltoall")["exchange"] == "allgather"
    monkeypatch.setenv("JEPSEN_WGL_EXCHANGE", "bogus")
    with pytest.raises(ValueError, match="exchange mode"):
        frontier.check_history_sharded(m, b, mesh=mesh, f_total=128)


def test_refutation_stuck_configs_match_reference():
    """The reference's stuck-config case (seed 8): refutations carry the
    same witness, per-op reasons included."""
    r1, r2 = random.Random(8), random.Random(8)
    seen = 0
    for _ in range(20):
        a = ref_perturb(r1, ref_random(r1, n_ops=40, n_procs=4, cas=True, crash_p=0.08))
        b = perturb_history(r2, random_register_history(r2, n_ops=40, n_procs=4, cas=True,
                                                        crash_p=0.08))
        port = compare(RefCas(init=0), CasRegister(init=0), a, b, f_total=256)
        if port["valid"] is False:
            seen += 1
            assert port["stuck_configs"] and all(
                cfg["pending"] and all(p.get("why") for p in cfg["pending"])
                for cfg in port["stuck_configs"])
            if seen >= 2:
                break
    assert seen >= 1


def test_frontier_after_escalation_is_the_global_pad():
    """After a x4 escalation the reference pads the GLOBAL frontier at its
    end and reshards it; the port's pad gives the same arrays."""
    ((a, _b),) = registers(77, 1, n_ops=80, n_procs=6, crash_p=0.1, perturb_every=0)
    enc = ref_encode(RefCas(init=0), a)
    plan = ref_wgl.plan_device(enc)
    W, KO, S, _ND, _NO = plan.dims
    D, F = 8, 16
    rng = np.random.default_rng(3)
    fr = list(ref_wgl.initial_frontier(D * F, W, KO, S, plan.init_state))
    fr[0] = rng.integers(0, 50, D * F).astype(np.int32)
    fr[1] = rng.integers(0, 2**32, (D * F, W // 32), dtype=np.uint64).astype(np.uint32)
    fr[4] = rng.random(D * F) < 0.6
    fr[5] = np.int32(9)
    want = ref_wgl._pad_frontier(tuple(fr), 4 * D * F)
    port = wgl.frontier_from_arrays(*fr, device="cpu", n_shards=D)
    grown = wgl.pad_sharded_frontier(port, 4 * F, lv.KERNELS)
    assert grown[0].shape == (D, 4 * F)
    assert grown[4][0, :4 * F].sum() == int(np.asarray(fr[4])[:4 * F].sum())  # old 0..3
    got = wgl.frontier_to_arrays(grown, sharded=True)
    for x, y in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert got[5] == 9


def _checker_history(cls):
    return cls([Op(type="invoke", f="write", value=3, process=0, time=0),
                Op(type="ok", f="write", value=3, process=0, time=1),
                Op(type="invoke", f="read", value=None, process=1, time=2),
                Op(type="ok", f="read", value=3, process=1, time=3)])


def test_sharded_backend_via_checker():
    ref_h = RefHistory([RefOp(type=o.type, f=o.f, value=o.value, process=o.process,
                              time=o.time) for o in _checker_history(History)])
    ref = ref_checker.linearizable(model=RefCas(init=0), backend="sharded").check(
        {"mesh": ref_mesh(8)}, ref_h, {})
    chk = jc.linearizable(model=CasRegister(init=0), backend="sharded", device="cpu")
    port = chk.check({"mesh": make_mesh(8, device="cpu")}, _checker_history(History), {})
    for k in KEYS:
        assert port.get(k) == ref.get(k), k
    assert port["valid"] is True and port["sharded"] is True and port["n_shards"] == 8
    # the test map's checker_backend selects it too; no mesh: one shard
    dev = jc.linearizable(model=CasRegister(init=0), device="cpu")
    res = dev.check({"checker_backend": "sharded"}, _checker_history(History), {})
    assert res["sharded"] is True and res["n_shards"] == 1


def test_multi_device_mesh_raises():
    with pytest.raises(ValueError, match="later slice"):
        make_mesh(2, devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="later slice"):
        make_mesh(devices=["cpu", "cuda:0"])
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 4, "mp": 1} and mesh.device.type == "cpu"
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh(4, shape=(2, 1), device="cpu")
