"""The port's chaos seams (``jepsen_tpu_torch.testing.chaos``) and what
they pin: the harness itself against the reference's, a retried batch and
a retried sharded chunk giving the rows of a search without the fault,
and the Elle engine's fold of an injected dispatch fault."""

from __future__ import annotations

import random

import pytest
import torch

from jepsen_tpu.elle import append as r_append
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.history import Op as ROp
from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.parallel import batch as ref_batch
from jepsen_tpu.parallel import resilience as ref_resilience
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.testing import chaos as ref_chaos
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch.elle import append as p_append
from jepsen_tpu_torch.elle import engine as p_engine
from jepsen_tpu_torch.elle import ops as p_ops
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.ops.encode import encode_history
from jepsen_tpu_torch.parallel import batch, frontier, make_mesh, resilience
from jepsen_tpu_torch.telemetry import Registry
from jepsen_tpu_torch.testing import chaos, lagged_append_history, random_register_history

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("JEPSEN_NO_FAILOVER", raising=False)
    monkeypatch.delenv("JEPSEN_WGL_EXCHANGE", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for m in (resilience, ref_resilience):
        m.reset_breakers()
    chaos.reset()
    ref_chaos.reset()
    yield
    torch.set_num_threads(n)
    for m in (resilience, ref_resilience):
        m.reset_breakers()
    chaos.reset()
    ref_chaos.reset()


def test_points_modes_and_causes_are_the_references():
    assert chaos.POINTS == ref_chaos.POINTS and chaos.MODES == ref_chaos.MODES
    assert chaos.EXPECTED_UNKNOWN_CAUSES == ref_chaos.EXPECTED_UNKNOWN_CAUSES
    from jepsen_tpu_torch.checker.provenance import TAXONOMY

    for codes in chaos.EXPECTED_UNKNOWN_CAUSES.values():
        assert codes <= set(TAXONOMY) and "unattributed" not in codes


def _crossings(mod, on_call, times, n=6):
    out = []
    with mod.inject("host.stack", on_call=on_call, times=times):
        for _ in range(n):
            try:
                mod.fire("host.stack")
                out.append("pass")
            except mod.ChaosError as e:
                out.append(str(e))
        counts = (mod.calls("host.stack"), mod.fired("host.stack"))
    return out, counts, (mod.calls("host.stack"), mod.fired("host.stack"))


@pytest.mark.parametrize("on_call,times", [(1, 1), (2, 3), (5, 1), (7, 1)])
def test_inject_counts_like_the_reference(on_call, times):
    assert _crossings(chaos, on_call, times) == _crossings(ref_chaos, on_call, times)


def test_inject_refuses_bad_arguments_and_double_arming():
    for kw in (dict(point="nope"), dict(point="host.stack", mode="explode"),
               dict(point="host.stack", on_call=0)):
        with pytest.raises(ValueError):
            with chaos.inject(**kw):
                pass
    with chaos.inject("host.stack"):
        with pytest.raises(RuntimeError, match="already armed"):
            with chaos.inject("host.stack"):
                pass
    with chaos.inject("device.dispatch", mode="delay", delay_s=0.001):
        chaos.fire("device.dispatch")
    assert chaos.fired("device.dispatch") == 1
    chaos.fire("device.dispatch")  # disarmed: nothing happens


# ---------------------------------------------------------------------------
# The batch's retry: the whole batch again, with the same results


def _histories(seed=77, n=6, n_ops=40):
    r1, r2 = random.Random(seed), random.Random(seed)
    return ([ref_random(r1, n_ops=n_ops, n_procs=3) for _ in range(n)],
            [random_register_history(r2, n_ops=n_ops, n_procs=3) for _ in range(n)])


def _strip(results):
    out = []
    for r in results:
        r = {k: v for k, v in r.items() if k not in ("wall_s", "torch_device")}
        if "rungs" in r:
            r["rungs"] = [{k: v for k, v in g.items() if k != "wall_s"} for g in r["rungs"]]
        out.append(r)
    return out


@pytest.mark.parametrize("point,on_call", [("device.dispatch", 1), ("device.dispatch", 2),
                                           ("host.stack", 1)])
def test_batch_retry_gives_the_results_without_the_fault(point, on_call):
    """One injected fault anywhere in a batch: the batch runs again and
    every member's result is the one without the fault (and the
    reference's), with ``wgl_retry_total{reason="batch"}`` 1."""
    ref_h, hs = _histories()
    encs = [encode_history(CasRegister(init=0), h) for h in hs]
    clean = batch.check_encoded_batch(encs, f=16, device="cpu")
    reg = Registry()
    with chaos.inject(point, on_call=on_call):
        got = batch.check_encoded_batch(encs, f=16, device="cpu", metrics=reg)
        assert chaos.fired(point) == 1
    assert _strip(got) == _strip(clean)
    assert reg.counter("wgl_retry_total", labelnames=("reason",)).labels(
        reason="batch").value == 1
    assert resilience.breaker("batch").state == "closed"
    with ref_chaos.inject(point, on_call=on_call):
        want = ref_batch.check_encoded_batch(
            [ref_encode(RefCas(init=0), h) for h in ref_h], f=16)
    assert [(r["valid"], r.get("levels")) for r in got] == \
        [(r["valid"], r.get("levels")) for r in want]


def test_host_stack_is_crossed_once_an_attempt():
    """The port stacks the members' tables once, before the first rung (the
    later rungs row-select them on the device), so it crosses ``host.stack``
    once a batch attempt. The reference crosses it again at the first chunk
    of each rung below the top (it stacks the next rung's tables on the
    host then): the same fault's ``on_call`` 2 fires there and not here."""
    ref_h, hs = _histories()
    encs = [encode_history(CasRegister(init=0), h) for h in hs]
    clean = batch.check_encoded_batch(encs, f=16, device="cpu")
    reg = Registry()
    with chaos.inject("host.stack", on_call=2):
        got = batch.check_encoded_batch(encs, f=16, device="cpu", metrics=reg)
        assert (chaos.calls("host.stack"), chaos.fired("host.stack")) == (1, 0)
    assert _strip(got) == _strip(clean)
    assert reg.counter("wgl_retry_total", labelnames=("reason",)).labels(
        reason="batch").value == 0
    assert len({r["rungs"][-1]["F"] for r in got if r.get("rungs")} | {16}) > 1
    with ref_chaos.inject("host.stack", on_call=2):
        want = ref_batch.check_encoded_batch(
            [ref_encode(RefCas(init=0), h) for h in ref_h], f=16)
        assert ref_chaos.fired("host.stack") == 1
    assert [(r["valid"], r.get("levels")) for r in got] == \
        [(r["valid"], r.get("levels")) for r in want]


def test_batch_fault_past_the_retries_opens_the_breaker():
    _ref_h, hs = _histories(n=3)
    encs = [encode_history(CasRegister(init=0), h) for h in hs]
    reg = Registry()
    with chaos.inject("device.dispatch", times=3):
        with pytest.raises(chaos.ChaosError):
            batch.check_encoded_batch(encs, f=16, device="cpu", metrics=reg)
    assert resilience.breaker("batch").state == "open"
    assert reg.gauge("circuit_state", labelnames=("device",)).labels(device="batch").value == 2
    assert reg.counter("wgl_retry_total", labelnames=("reason",)).labels(
        reason="batch").value == 2
    with pytest.raises(resilience.CircuitOpenError):
        batch.check_encoded_batch(encs, f=16, device="cpu")


def test_batch_kill_switch_propagates(monkeypatch):
    monkeypatch.setenv("JEPSEN_NO_FAILOVER", "1")
    _ref_h, hs = _histories(n=2)
    encs = [encode_history(CasRegister(init=0), h) for h in hs]
    with chaos.inject("device.dispatch"):
        with pytest.raises(chaos.ChaosError):
            batch.check_encoded_batch(encs, f=16, device="cpu")


# ---------------------------------------------------------------------------
# The sharded chunk retry: the chunk again, from its starting frontier


def _sharded(enc, **kw):
    infos, reg = [], Registry()
    res = frontier.check_encoded_sharded(enc, mesh=make_mesh(4, device="cpu"), f_total=64,
                                         levels_per_call=4, chunk_callback=infos.append,
                                         metrics=reg, **kw)
    rows = [(i["level"], i["F"], i["count"]) for i in infos]
    res = {k: v for k, v in res.items() if k not in ("wall_s", "attempts")}
    return res, rows, reg


def _sharded_history(perturbed):
    h = random_register_history(random.Random(91), n_ops=60, n_procs=4, crash_p=0.0)
    if perturbed:
        from jepsen_tpu_torch.testing import perturb_history

        h = perturb_history(random.Random(92), h)
    return encode_history(CasRegister(init=0), h)


@pytest.mark.parametrize("perturbed", [False, True])
@pytest.mark.parametrize("exchange", ["alltoall", "allgather"])
def test_sharded_chunk_retry_before_the_launches(perturbed, exchange):
    """``device.dispatch`` armed at the third chunk: the chunk is retried
    and the search gives the verdict and per-chunk rows of the search
    without the fault."""
    enc = _sharded_history(perturbed)
    clean, clean_rows, _ = _sharded(enc, exchange=exchange)
    assert len(clean_rows) >= 3
    with chaos.inject("device.dispatch", on_call=3):
        got, rows, reg = _sharded(enc, exchange=exchange)
        assert chaos.fired("device.dispatch") == 1
    assert got == clean and rows == clean_rows
    assert reg.counter("wgl_retry_total", labelnames=("reason",)).labels(
        reason="sharded").value == 1


@pytest.mark.parametrize("perturbed", [False, True])
def test_sharded_chunk_retry_after_the_chunk_rewrote_the_frontier(monkeypatch, perturbed):
    """A fault that strikes after a chunk has run its levels (the frontier
    is rewritten in place): the retry starts again from the chunk's copied
    starting frontier and a fresh workspace, and gives the rows of the
    search without the fault."""
    enc = _sharded_history(perturbed)
    clean, clean_rows, _ = _sharded(enc)
    real = lv.run_chunk_sharded
    n = {"calls": 0}

    def run_then_fail(*a, **kw):
        out = real(*a, **kw)
        n["calls"] += 1
        if n["calls"] == 2:
            raise torch.OutOfMemoryError("CUDA out of memory (after the chunk's levels)")
        return out

    monkeypatch.setattr(lv, "run_chunk_sharded", run_then_fail)
    got, rows, reg = _sharded(enc)
    assert n["calls"] == len(clean_rows) + 1
    assert got == clean and rows == clean_rows
    assert reg.counter("wgl_retry_total", labelnames=("reason",)).labels(
        reason="sharded").value == 1


def test_sharded_kill_switch_propagates(monkeypatch):
    monkeypatch.setenv("JEPSEN_NO_FAILOVER", "1")
    enc = _sharded_history(False)
    with chaos.inject("device.dispatch", on_call=2):
        with pytest.raises(chaos.ChaosError):
            _sharded(enc)


# ---------------------------------------------------------------------------
# Elle: an injected dispatch fault folds as the reference's does


def _to_ref(h):
    return RHistory([ROp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                     for o in h], reindex=False)


def _verdict(res):
    """The result map without the engine's report."""
    return {k: v for k, v in res.items() if k != "engine"}


@pytest.mark.parametrize("times", [1, 100])
def test_elle_dispatch_fault_folds_like_the_reference(times):
    """Once: the chunk halves and the verdict stands. Every time: past the
    halvings the graph folds to the host path, typed ``elle_device_oom``.
    Result maps and reports equal the reference's."""
    h = lagged_append_history(5, 300, lag=(100, 160), depth=4)
    p_rep, r_rep = {}, {}
    with chaos.inject("device.dispatch", times=times):
        got = p_append.check(h, device=True, torch_device="cpu", report=p_rep)
        fired = chaos.fired("device.dispatch")
    with ref_chaos.inject("device.dispatch", times=times):
        want = r_append.check(_to_ref(h), device=True, report=r_rep)
        ref_fired = ref_chaos.fired("device.dispatch")
    assert got == want and p_rep == r_rep and fired == ref_fired >= 1
    assert _verdict(got) == _verdict(p_append.check(h, device=False))
    codes = {c["code"] for c in p_rep.get("causes") or []}
    assert codes == (set() if times == 1 else {"elle_device_oom"})


def test_elle_injected_fault_folds_on_a_gpu_and_a_real_oom_raises(monkeypatch):
    """On a CUDA torch device an injected fault folds (it says nothing
    about the card's size), while a real out-of-memory past the halvings
    raises (divergence 1)."""
    h = lagged_append_history(6, 200, lag=(60, 120), depth=4)
    monkeypatch.setattr(p_engine, "_torch_device", lambda _d: torch.device("cuda"))
    rep = {}
    with chaos.inject("device.dispatch", times=100):
        got = p_append.check(h, device=True, report=rep)
    assert _verdict(got) == _verdict(p_append.check(h, device=False))
    assert {c["code"] for c in rep["causes"]} == {"elle_device_oom"}

    def oom(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(p_ops, "batched_closure", oom)
    with pytest.raises(torch.OutOfMemoryError, match="elle closure at bucket"):
        p_append.check(h, device=True)
