"""The port's checker surface against the JAX reference's: the keyed
``independent.checker(linearizable(...))`` on a 100-key history (per-key
verdicts, failures, merged verdict), ``history_keys``/``subhistory``, the
backend names, and the options left for later slices."""

import random

import pytest
import torch

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import independent as ref_ind
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch import checker as jc
from jepsen_tpu_torch import independent as ind
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.testing import perturb_history, random_register_history


def _keyed(n_keys=100, seed=11):
    """The 100-key history of the reference's keyed batch test, built in
    both packages from one seed; every ninth key perturbed."""
    r1, r2 = random.Random(seed), random.Random(seed)
    o1, o2 = [], []
    for k in range(n_keys):
        a = ref_random(r1, n_ops=10, n_procs=2, crash_p=0.0)
        b = random_register_history(r2, n_ops=10, n_procs=2, crash_p=0.0)
        if k % 9 == 0:
            a, b = ref_perturb(r1, a), perturb_history(r2, b)
        for o in a:
            o1.append(o.with_(value=ref_ind.KV(k, o.value), index=len(o1)))
        for o in b:
            o2.append(o.with_(value=ind.KV(k, o.value), index=len(o2)))
    return RefHistory(o1, reindex=False), History(o2, reindex=False)


def test_keyed_linearizable_matches_reference():
    h1, h2 = _keyed()
    ref = ref_ind.checker(ref_checker.linearizable(model=RefCas(init=0))).check(
        {"no-store?": True}, h1, {})
    port = ind.checker(jc.linearizable(model=CasRegister(init=0), device="cpu")).check(
        {"no-store?": True}, h2, {})
    assert port["valid"] == ref["valid"] is False
    assert port["failures"] == ref["failures"]
    assert set(port["results"]) == set(ref["results"]) == set(range(100))
    for k in range(100):
        assert port["results"][k]["valid"] == ref["results"][k]["valid"], k
    assert all(r.get("batched") for r in port["results"].values())


def test_keyed_host_backend_checks_key_by_key():
    """The host backend refuses the batch; the lifted checker then checks
    each key on its own, with the same verdicts."""
    _, h2 = _keyed(12)
    lin = jc.linearizable(model=CasRegister(init=0), backend="host")
    with pytest.raises(RuntimeError, match="device backend"):
        lin.batch_check({}, {0: ind.subhistory(0, h2)})
    host = ind.checker(lin).check({}, h2, {})
    dev = ind.checker(jc.linearizable(model=CasRegister(init=0), device="cpu")).check(
        {}, h2, {})
    assert {k: r["valid"] for k, r in host["results"].items()} == \
        {k: r["valid"] for k, r in dev["results"].items()}
    assert all(r.get("backend") == "host" for r in host["results"].values())


def _op_cases(KV, OpCls, HistoryCls):
    """The reference's history_keys/subhistory cases, for either package."""
    dicts = [
        {"type": "invoke", "process": 0, "f": "w", "value": KV(1, "a")},
        {"type": "ok", "process": 0, "f": "w", "value": KV(1, "a")},
        {"type": "info", "process": "nemesis", "f": "start", "value": None},
        {"type": "invoke", "process": 1, "f": "w", "value": KV(2, "b")},
        {"type": "invoke", "process": 0, "f": "cas", "value": (1, 2)},
        {"type": "info", "process": 0, "f": "w", "value": None},
        {"type": "invoke", "process": 2, "f": "w", "value": KV(("shard", 0), KV("b", 1))},
        {"type": "ok", "process": 2, "f": "w", "value": KV(("shard", 0), [1, 2])},
    ]
    ops = HistoryCls([OpCls(type=d["type"], process=d["process"], f=d["f"],
                            value=d["value"], time=i, index=i)
                      for i, d in enumerate(dicts)], reindex=False)
    return dicts, ops


def _norm(v):
    """A value with either package's KV as a plain nested tuple."""
    if isinstance(v, (ref_ind.KV, ind.KV)):
        return ("KV", _norm(v[0]), _norm(v[1]))
    if isinstance(v, list):
        return [_norm(x) for x in v]
    return v


def _shape(sub):
    return (type(sub).__name__,
            [(o["type"], o["process"], _norm(o["value"])) if isinstance(o, dict)
             else (o.type, o.process, _norm(o.value), o.index) for o in sub])


def test_history_keys_and_subhistory_match_reference():
    ref_dicts, ref_ops = _op_cases(ref_ind.KV, RefOp, RefHistory)
    dicts, ops = _op_cases(ind.KV, Op, History)
    for r_in, p_in in ((ref_dicts, dicts), (ref_ops, ops), (ref_dicts[:2], dicts[:2]),
                       ([], []), (list(ref_ops)[:1] + ref_dicts[1:3], list(ops)[:1] + dicts[1:3])):
        rk, pk = ref_ind.history_keys(r_in), ind.history_keys(p_in)
        assert {_norm(k) for k in pk} == {_norm(k) for k in rk}
        for k in sorted(pk, key=repr) + ["missing"]:
            assert _shape(ind.subhistory(k, p_in)) == _shape(ref_ind.subhistory(k, r_in))
    assert ind.is_tuple(ind.tuple_(1, 2)) and not ind.is_tuple((1, 2))
    assert ind.KV("k", 3).key == "k" and ind.KV("k", 3).value == 3


def test_independent_checker_merges_like_reference():
    even = lambda test, history, opts: {"valid": len(history) % 2 == 0}  # noqa: E731
    h1, h2 = [], []
    for k in (1, 2, 3):
        for i in range(k):
            h1.append(RefOp("invoke", 0, "x", ref_ind.KV(k, i), time=i, index=len(h1)))
            h2.append(Op("invoke", 0, "x", ind.KV(k, i), time=i, index=len(h2)))
    ref = ref_ind.checker(ref_checker.checker_fn(even)).check(
        {"no-store?": True}, RefHistory(h1, reindex=False), {})
    port = ind.checker(jc.checker_fn(even)).check({}, History(h2, reindex=False), {})
    assert port == ref
    assert jc.merge_valid([True, "unknown"]) == "unknown"
    assert jc.merge_valid([True, "unknown", False]) is False


@pytest.mark.parametrize("name", ["device", "tpu", "gpu", "cuda"])
def test_device_backend_aliases(name):
    h = random_register_history(random.Random(5), n_ops=20, n_procs=3)
    by_option = jc.linearizable(model=CasRegister(init=0), backend=name, device="cpu")
    res = by_option.check({}, h, {})
    assert res["valid"] is True and res["device"] is True
    # The test map's checker_backend overrides the option.
    host_first = jc.linearizable(model=CasRegister(init=0), backend="host", device="cpu")
    assert host_first.check({"checker_backend": name}, h, {})["device"] is True
    assert by_option.check({"checker_backend": "host"}, h, {})["backend"] == "host"


@pytest.mark.parametrize("name", ["auto", "native", "competition", "segmented"])
def test_later_slice_backends_raise(name):
    """``auto``, ``native``, ``competition`` and ``segmented`` run, as an
    option and as the test map's override, with the reference checker's
    verdict and backend (``segmented``: the verdict and the offline
    result's ``parallel`` and ``segments_decided``)."""
    r1, r2 = random.Random(5), random.Random(5)
    good = (ref_random(r1, n_ops=6), random_register_history(r2, n_ops=6))
    bad = (ref_perturb(r1, ref_random(r1, n_ops=30, n_procs=3, crash_p=0.0)),
           perturb_history(r2, random_register_history(r2, n_ops=30, n_procs=3, crash_p=0.0)))
    by_option = jc.linearizable(model=CasRegister(init=0), backend=name, device="cpu")
    by_map = jc.linearizable(model=CasRegister(init=0), device="cpu")
    ref = ref_checker.linearizable(model=RefCas(init=0), backend=name)
    for ref_h, h in (good, bad):
        want = ref.check({"no-store?": True}, ref_h, {})
        for port in (by_option.check({}, h, {}), by_map.check({"checker_backend": name}, h, {})):
            assert port["valid"] == want["valid"]
            if name == "segmented":
                assert port["parallel"] == want["parallel"] == "segmented"
                assert port["segments_decided"] == want["segments_decided"]
            else:
                assert port["backend"] == want["backend"]
    assert want["valid"] is False


def test_stored_witness_files_raise(tmp_path):
    """A stored test map no longer raises: a refutation writes the
    reference's witness files (``linear.txt``, ``linear.svg``) into the
    store, byte for byte, and a valid history or ``no-store?`` writes
    none."""
    lin = jc.linearizable(model=CasRegister(init=0), device="cpu")
    h = random_register_history(random.Random(5), n_ops=6)
    stored = {"name": "t", "start-time": "1", "store-root": str(tmp_path / "port")}
    assert lin.check(dict(stored), h, {})["valid"] is True
    assert lin.check(dict(stored, **{"no-store?": True}), h, {})["valid"] is True
    assert not (tmp_path / "port").exists()
    r1, r2 = random.Random(5), random.Random(5)
    bad_r = ref_perturb(r1, ref_random(r1, n_ops=30, n_procs=3, crash_p=0.0))
    bad_p = perturb_history(r2, random_register_history(r2, n_ops=30, n_procs=3, crash_p=0.0))
    want = ref_checker.linearizable(model=RefCas(init=0), backend="device").check(
        {"name": "t", "start-time": "1", "store-root": str(tmp_path / "ref")}, bad_r, {})
    got = lin.check(dict(stored), bad_p, {})
    assert got["valid"] is want["valid"] is False
    assert got["witness_files"] == want["witness_files"] == ["linear.txt", "linear.svg"]
    for f in got["witness_files"]:
        assert (tmp_path / "port" / "t" / "1" / f).read_bytes() == \
            (tmp_path / "ref" / "t" / "1" / f).read_bytes()


def test_linearizable_requires_model_and_a_gpu_by_default():
    with pytest.raises(ValueError, match="requires a model"):
        jc.linearizable(device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jc.linearizable(model=CasRegister(init=0))
    from jepsen_tpu_torch.parallel import check_batch

    with pytest.raises(RuntimeError, match="device='cpu'"):
        check_batch(CasRegister(init=0), [random_register_history(random.Random(1), n_ops=4)])


def test_check_safe_turns_errors_into_unknown():
    def boom(test, history, opts):
        raise RuntimeError("boom")

    res = jc.check_safe(jc.checker_fn(boom), {}, History([]))
    assert res["valid"] == "unknown" and "boom" in res["error"]


@pytest.mark.parametrize("backend", ["auto", "native", "competition"])
def test_lock_checker_takes_the_new_backends(backend):
    """The lock workload's checker with each new backend, against the
    reference's (``lock_test(...)["checker"]``) on the same lock history:
    the same composed verdict and the same ``linear`` backend."""
    from jepsen_tpu.workloads import lock as ref_lock
    from jepsen_tpu_torch.testing import random_lock_history
    from jepsen_tpu_torch.workloads import lock

    h = random_lock_history(random.Random(17), n_ops=60, n_procs=4)
    ref_h = RefHistory([RefOp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                        for o in h], reindex=False)
    opts = {"model": "owner-aware-mutex", "backend": backend}
    ref = ref_lock.lock_test(opts)["checker"].check({"no-store?": True}, ref_h, {})
    port = lock.checker(dict(opts, device="cpu")).check({}, h, {})
    assert port["valid"] == ref["valid"] is True
    assert port["linear"]["valid"] == ref["linear"]["valid"]
    assert port["linear"]["backend"] == ref["linear"]["backend"]
