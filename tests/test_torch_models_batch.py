"""The batch path and the checkers at state widths above one, against the
JAX reference: one batched chunk of multi-register members (``S = 3``)
against ``_build_batch_kernel``; the keyed ``independent.checker(
linearizable(MultiRegister(...)))`` against the reference's (every key's
result map, timings aside); the lock and semaphore workloads' checkers
against the reference's ``lock_test``/``semaphore_test`` checkers on the
device backend; and a host-only model's note. All comparisons are exact.
The port runs on the CPU."""

import random

import numpy as np
import pytest

import jepsen_tpu.models as ref_models
from jepsen_tpu import checker as ref_checker
from jepsen_tpu import independent as ref_ind
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.workloads import lock as ref_lock
from jepsen_tpu_torch import checker as jc
from jepsen_tpu_torch import independent as ind
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import FIFOQueue, MultiRegister
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.testing import history_model, random_model_history
from jepsen_tpu_torch.workloads import lock

REGS = {0: None, 1: None, 2: None}
# Result-map keys that hold host timings or the torch device.
TIMING = ("wall_s", "torch_device")


def to_ref_history(h):
    return RefHistory([RefOp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                       for o in h], reindex=False)


def _untimed(res):
    """A result map without host timings (nested attempts included)."""
    out = {k: v for k, v in res.items() if k not in TIMING}
    for k in ("attempts", "optimistic_attempts", "rungs"):
        if isinstance(out.get(k), list):
            out[k] = [{a: b for a, b in x.items() if a != "wall_s"} for x in out[k]]
    return out


def test_batched_chunk_at_state_width_3_matches_reference():
    """Members of different lengths, one perturbed, warmed to their own
    levels, then one chunk of 6 levels each, lossless and lossy: the same
    ``[nb, 6]`` flags and frontier arrays, all three state lanes."""
    hists = [random_model_history(random.Random(70 + i), "multi-register", n_ops=24 + 6 * i,
                                  n_procs=5, crash_p=0.1, perturb=i == 1) for i in range(3)]
    model = MultiRegister(REGS)
    encs = [ref_encode(ref_models.MultiRegister(REGS), to_ref_history(h)) for h in hists]
    nb, F = len(encs), 16
    plans = [ref_wgl.plan_device(e) for e in encs]
    dims = np.array([p.dims for p in plans])
    W, KO, ND, NO = (int(dims[:, k].max()) for k in (0, 1, 3, 4))
    S = int(dims[0, 2])
    assert S == 3
    padded = [ref_wgl.plan_device(e, pad_to=(W, KO, ND, NO)) for e in encs]
    Bs = [p.B for p in padded]
    B = None if any(b is None for b in Bs) else max(Bs)
    cols = [np.stack(c) for c in zip(*[p.args for p in padded])]
    kern = ref_wgl._build_batch_kernel(ref_wgl._model_cache_key(encs[0].model),
                                       F, W, KO, S, ND, NO, B=B)

    def ref_chunk(fr5, lvl0, budgets, lossy):
        out = kern(cols[0], cols[1], np.asarray(budgets, np.int32), *cols[3:9], *fr5,
                   np.asarray(lvl0, np.int32), np.asarray(lossy, np.int32))
        return np.asarray(out[0]), [np.asarray(a) for a in out[1:]]

    fr0 = [np.stack(c) for c in zip(*[ref_wgl.initial_frontier(F, W, KO, S, p.init_state)[:5]
                                      for p in padded])]
    wflags, wfr = ref_chunk(fr0, [0] * nb, [4 + 2 * b for b in range(nb)], [1] * nb)
    lvl0 = wflags[:, 3].tolist()
    port_plan = wgl.stack_from_arrays(cols, (W, KO, S, ND, NO),
                                      np.stack([p.init_state for p in padded]), B,
                                      device="cpu")
    g = wgl.level_geometry(port_plan, F)
    for lossy in (0, 1):
        budgets = [lv0 + 6 for lv0 in lvl0]
        ref_flags, ref_fr = ref_chunk(wfr, lvl0, budgets, [lossy] * nb)
        port_fr = wgl.frontier_stack_from_arrays(*wfr, device="cpu")
        ws = lv.BatchWorkspace(g, nb, "cpu")
        flags = lv.run_chunk_batch(lv.KERNELS, g, port_plan.tabs, port_fr, ws, lvl0,
                                   budgets, [lossy] * nb, port_plan.nD.tolist(),
                                   port_plan.nO.tolist(), model)
        assert flags == ref_flags.tolist(), f"lossy={lossy}"
        for name, a, b in zip(("p", "mD", "mO", "st", "valid"),
                              wgl.frontier_stack_to_arrays(port_fr), ref_fr):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} lossy={lossy}")


def _keyed_multi_register(n_keys=8, n_ops=24):
    """A keyed history of single-register reads and writes over registers
    (0, 1, 2): key k's ops from ``random_model_history``, every third key
    perturbed. (reference History, port History)."""
    o1, o2 = [], []
    for k in range(n_keys):
        h = random_model_history(random.Random(90 + k), "multi-register", n_ops=n_ops,
                                 n_procs=3, crash_p=0.05, perturb=k % 3 == 1)
        for o in h:
            o1.append(RefOp(o.type, o.process, o.f, ref_ind.KV(k, o.value), time=len(o1),
                            index=len(o1)))
            o2.append(o.with_(value=ind.KV(k, o.value), time=len(o2), index=len(o2)))
    return RefHistory(o1, reindex=False), History(o2, reindex=False)


def test_keyed_multi_register_matches_reference():
    h1, h2 = _keyed_multi_register()
    ref = ref_ind.checker(ref_checker.linearizable(
        model=ref_models.MultiRegister(REGS), backend="device")).check(
        {"no-store?": True}, h1, {})
    port = ind.checker(jc.linearizable(model=MultiRegister(REGS), device="cpu")).check(
        {"no-store?": True}, h2, {})
    assert port["valid"] == ref["valid"] is False
    assert port["failures"] == ref["failures"]
    assert set(port["results"]) == set(ref["results"]) == set(range(8))
    for k in range(8):
        assert _untimed(port["results"][k]) == _untimed(ref["results"][k]), k
    assert all(r.get("batched") for r in port["results"].values())


def test_keyed_compose_checks_key_by_key():
    """Yugabyte's wiring wraps ``linearizable`` in ``compose``, which has
    no batch check: both packages decide each key on its own, with the
    batch's verdicts."""
    h1, h2 = _keyed_multi_register(n_keys=4)
    wrap = lambda c, lin: c.compose({"linear": lin, "stats": c.stats()})  # noqa: E731
    ref = ref_ind.checker(wrap(ref_checker, ref_checker.linearizable(
        model=ref_models.MultiRegister(REGS), backend="device"))).check(
        {"no-store?": True}, h1, {})
    comp = wrap(jc, jc.linearizable(model=MultiRegister(REGS), device="cpu"))
    assert not hasattr(comp, "batch_check")
    port = ind.checker(comp).check({"no-store?": True}, h2, {})
    batched = ind.checker(jc.linearizable(model=MultiRegister(REGS), device="cpu")).check(
        {"no-store?": True}, h2, {})
    assert port["valid"] == ref["valid"] == batched["valid"]
    assert port["failures"] == ref["failures"] == batched["failures"]
    for k in range(4):
        p, r = port["results"][k], ref["results"][k]
        assert p["stats"] == r["stats"]
        assert _untimed(p["linear"]) == _untimed(r["linear"])
        assert "batched" not in p["linear"]
        assert p["linear"]["valid"] == batched["results"][k]["valid"]


LOCK_MODELS = sorted(lock.MODELS)


@pytest.mark.parametrize("perturb", [False, True], ids=["ok", "bad"])
@pytest.mark.parametrize("name", LOCK_MODELS)
def test_lock_checker_matches_reference(name, perturb):
    h = random_model_history(random.Random(LOCK_MODELS.index(name)), name, n_ops=36,
                             n_procs=4, crash_p=0.05, perturb=perturb)
    ref = ref_lock.lock_test({"model": name, "backend": "device"})["checker"].check(
        {}, to_ref_history(h), {})
    port = lock.checker({"model": name, "device": "cpu"}).check({}, h, {})
    assert set(port) == set(ref) == {"linear", "stats", "valid"}
    assert port["valid"] == ref["valid"]
    assert port["stats"] == ref["stats"]
    assert _untimed(port["linear"]) == _untimed(ref["linear"])
    if not perturb:
        assert port["valid"] is True


@pytest.mark.parametrize("perturb", [False, True], ids=["ok", "bad"])
def test_semaphore_checker_matches_reference(perturb):
    h = random_model_history(random.Random(7), "semaphore", n_ops=36, n_procs=4,
                             crash_p=0.05, perturb=perturb)
    assert history_model("semaphore").capacity == lock.DEFAULT_CAPACITY \
        == ref_lock.DEFAULT_CAPACITY
    ref = ref_lock.semaphore_test()["checker"].check({"checker_backend": "device"},
                                                    to_ref_history(h), {})
    port = lock.semaphore_checker({"device": "cpu"}).check({}, h, {})
    assert port["valid"] == ref["valid"]
    assert port["stats"] == ref["stats"]
    assert _untimed(port["linear"]) == _untimed(ref["linear"])


def test_lock_workload_parts_of_later_slices_raise():
    """The lock workload's generators and test maps simulate as the
    reference's (the simulator's pinned RNG, exact ops)."""
    import jepsen_tpu.generator as r_gen
    import jepsen_tpu_torch.generator as p_gen
    from jepsen_tpu.generator import sim as r_sim
    from jepsen_tpu_torch.generator import sim as p_sim

    pairs = ((lock.lock_generator(), ref_lock.lock_generator()),
             (lock.lock_test({"device": "cpu"})["generator"],
              ref_lock.lock_test()["generator"]),
             (lock.semaphore_test({"device": "cpu"})["generator"],
              ref_lock.semaphore_test()["generator"]))
    for p, r in pairs:
        got = p_sim.imperfect(p_gen.limit(30, p), p_sim.n_plus_nemesis_context(3))
        want = r_sim.imperfect(r_gen.limit(30, r), r_sim.n_plus_nemesis_context(3))
        assert got == want and len(got) == 60
    assert lock.MODELS.keys() == ref_lock.MODELS.keys()
    assert all(lock.MODELS[k].__name__ == ref_lock.MODELS[k].__name__ for k in lock.MODELS)


def test_stats_and_compose_match_reference():
    rng = random.Random(3)
    rows = []
    for i in range(40):
        f = rng.choice(["acquire", "release", "read"])
        rows.append(("invoke", i % 4, f, None))
        rows.append((rng.choice(["ok", "fail", "info"]) if f != "read" else "fail",
                     i % 4, f, None))
    rows.append(("info", "nemesis", "start", None))
    h1 = RefHistory([RefOp(t, p, f, v, time=i) for i, (t, p, f, v) in enumerate(rows)])
    h2 = History([Op(t, p, f, v, time=i) for i, (t, p, f, v) in enumerate(rows)])
    assert jc.stats().check({}, h2, {}) == ref_checker.stats().check({}, h1, {})
    assert jc.stats().check({}, h2, {})["valid"] == "unknown"
    bad = lambda test, history, opts: {"valid": False}  # noqa: E731
    boom = lambda test, history, opts: 1 / 0  # noqa: E731
    got = jc.compose({"a": jc.stats(), "b": jc.checker_fn(bad), "c": jc.checker_fn(boom)}
                     ).check({}, h2, {})
    want = ref_checker.compose({"a": ref_checker.stats(), "b": ref_checker.checker_fn(bad),
                                "c": ref_checker.checker_fn(boom)}).check({}, h1, {})
    assert got["valid"] is False and want["valid"] is False
    assert got["a"] == want["a"] and got["b"] == want["b"]
    assert got["c"]["valid"] == want["c"]["valid"] == "unknown"
    assert jc.compose({}).check({}, h2, {}) == ref_checker.compose({}).check({}, h1, {})


@pytest.mark.parametrize("backend", ["device", "host"])
def test_host_only_model_note_matches_reference(backend):
    rng = random.Random(5)
    rows, queue, n = [], [], 0
    for i in range(30):
        if queue and rng.random() < 0.5:
            rows += [("invoke", 0, "dequeue", None), ("ok", 0, "dequeue", queue.pop(0))]
        else:
            n += 1
            queue.append(n)
            rows += [("invoke", 1, "enqueue", n), ("ok", 1, "enqueue", n)]
    h1 = RefHistory([RefOp(t, p, f, v, time=i) for i, (t, p, f, v) in enumerate(rows)])
    h2 = History([Op(t, p, f, v, time=i) for i, (t, p, f, v) in enumerate(rows)])
    ref = ref_wgl.check_history(ref_models.FIFOQueue(), h1, backend=backend)
    port = wgl.check_history(FIFOQueue(), h2, backend=backend, device="cpu")
    assert port["valid"] is True
    assert port["backend"] == ref["backend"] == "host"
    assert port.get("info") == ref.get("info")
    assert {k: v for k, v in port.items() if k != "wall_s"} == \
        {k: v for k, v in ref.items() if k != "wall_s"}
