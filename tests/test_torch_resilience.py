"""The port's resilience layer (``jepsen_tpu_torch.parallel.resilience``)
against the reference's: transient classification on the reference's
inputs, the card's errors, the retry loop and its counters, and the
circuit breaker's state sequences under the same failure scripts."""

from __future__ import annotations

import time

import pytest
import torch

from jepsen_tpu.parallel import resilience as ref
from jepsen_tpu.telemetry import Registry as RefRegistry
from jepsen_tpu.testing.chaos import ChaosError as RefChaosError
from jepsen_tpu_torch import _build, native
from jepsen_tpu_torch.parallel import resilience
from jepsen_tpu_torch.telemetry import Registry
from jepsen_tpu_torch.testing.chaos import ChaosError

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv("JEPSEN_NO_FAILOVER", raising=False)
    resilience.reset_breakers()
    ref.reset_breakers()
    yield
    resilience.reset_breakers()
    ref.reset_breakers()


XlaRuntimeError = type("XlaRuntimeError", (RuntimeError,), {})

# The reference's classification inputs (its tests/test_resilience.py and
# the markers of its module), each as both packages see it.
REFERENCE_INPUTS = {
    "chaos": (RefChaosError("injected"), ChaosError("injected")),
    "xla_name": (XlaRuntimeError("boom"),) * 2,
    "resource_exhausted": (RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),) * 2,
    "unavailable": (RuntimeError("UNAVAILABLE: relay dropped"),) * 2,
    "deadline": (RuntimeError("DEADLINE_EXCEEDED: slow"),) * 2,
    "aborted": (RuntimeError("ABORTED: preempted"),) * 2,
    "internal": (RuntimeError("INTERNAL: device lost"),) * 2,
    "oom_text": (MemoryError("out of memory"),) * 2,
    "oom_text_cap": (RuntimeError("Out of memory while allocating"),) * 2,
    "plain_runtime": (RuntimeError("boom"),) * 2,
    "value": (ValueError("bad model mix"),) * 2,
    "type": (TypeError("nope"),) * 2,
    "assertion": (AssertionError("x"),) * 2,
    "key": (KeyError("k"),) * 2,
}


@pytest.mark.parametrize("name", sorted(REFERENCE_INPUTS))
def test_transient_classification_matches_the_reference(name):
    r, p = REFERENCE_INPUTS[name]
    assert resilience.is_transient(p) == ref.is_transient(r)


@pytest.mark.parametrize("exc", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("wgl_expand: CUDA error 700 (an illegal memory access was encountered)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    type("AcceleratorError", (RuntimeError,), {})("an illegal memory access"),
])
def test_the_cards_runtime_errors_are_transient(exc):
    assert resilience.is_transient(exc)


@pytest.mark.parametrize("exc", [
    _build.BuildError("nvcc failed:\nINTERNAL compiler error: out of memory"),
    native.NativeBuildError("cc failed: out of memory"),
    ValueError("RESOURCE_EXHAUSTED in a plan"),
    TypeError("CUDA error in an argument"),
])
def test_deterministic_errors_are_never_transient(exc):
    """A build failure, a plan's ValueError and a TypeError are never
    retried, whatever their text (the reference classifies a ValueError
    with a transient marker in its text as transient)."""
    assert not resilience.is_transient(exc)


def _script(mod, steps, threshold=2, cooldown=0.02):
    """Run one failure script on a breaker; returns (action, result, state)
    after each step."""
    b = mod.CircuitBreaker("t", failure_threshold=threshold, cooldown_s=cooldown)
    out = []
    for step in steps:
        if step == "fail":
            res = b.record_failure()
        elif step == "ok":
            res = b.record_success()
        elif step == "allow":
            res = b.allow()
        elif step == "engaged":
            res = b.engaged()
        else:
            time.sleep(cooldown * 1.5)
            res = None
        out.append((step, res, b.state, b.snapshot()["consecutive_failures"]))
    return out


SCRIPTS = {
    "opens_at_threshold": ["fail", "allow", "fail", "allow", "engaged"],
    "probe_closes": ["fail", "fail", "allow", "wait", "engaged", "allow", "allow", "ok",
                     "allow"],
    "probe_fails": ["fail", "fail", "wait", "allow", "fail", "allow", "engaged", "wait",
                    "engaged", "allow", "ok"],
    "success_resets": ["fail", "ok", "fail", "allow", "fail", "allow"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_breaker_state_sequences_match_the_reference(name):
    assert _script(resilience, SCRIPTS[name]) == _script(ref, SCRIPTS[name])


def _flaky(fail_times, exc):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fail_times:
            raise exc
        return "ok"

    return fn, calls


@pytest.mark.parametrize("fail_times,retries", [(0, 2), (1, 2), (2, 2), (3, 2), (2, 0)])
def test_call_retries_like_the_reference(fail_times, retries):
    """The same flaky thunk under both packages' ``call``: the same
    attempts, outcome, retry count and breaker state."""
    def run(mod, reg, exc):
        fn, calls = _flaky(fail_times, exc)
        b = mod.breaker("batch", metrics=reg)
        try:
            out = mod.call(fn, retries=retries, base_delay_s=0.001, metrics=reg,
                           reason="batch", breaker=b)
        except Exception as e:  # noqa: BLE001 - compared below
            out = type(e).__name__
        n = reg.counter("wgl_retry_total", labelnames=("reason",)).labels(
            reason="batch").value
        return out, len(calls), n, b.state

    got = run(resilience, Registry(), ChaosError("transient"))
    want = run(ref, RefRegistry(), RefChaosError("transient"))
    assert got == want


def test_breaker_opens_and_refuses_without_an_attempt():
    reg = Registry()
    b = resilience.breaker("batch", metrics=reg)
    fn, calls = _flaky(99, ChaosError("dead"))
    with pytest.raises(ChaosError):
        resilience.call(fn, retries=2, base_delay_s=0.001, breaker=b, metrics=reg)
    assert len(calls) == 3 and b.state == "open"
    assert reg.gauge("circuit_state", labelnames=("device",)).labels(device="batch").value == 2
    assert reg.counter("circuit_transitions_total", labelnames=("device", "state")).labels(
        device="batch", state="open").value == 1
    with pytest.raises(resilience.CircuitOpenError):
        resilience.call(fn, breaker=b)
    assert len(calls) == 3


def test_nontransient_failures_are_not_retried():
    for exc in (ValueError("plan"), _build.BuildError("nvcc failed")):
        fn, calls = _flaky(5, exc)
        with pytest.raises(type(exc)):
            resilience.call(fn, retries=5, base_delay_s=0.001)
        assert len(calls) == 1


def test_kill_switch(monkeypatch):
    monkeypatch.setenv("JEPSEN_NO_FAILOVER", "1")
    b = resilience.CircuitBreaker("t", failure_threshold=1, cooldown_s=60)
    b.record_failure()
    assert b.allow() and not b.engaged() and resilience.failover_disabled()
    fn, calls = _flaky(1, ChaosError("x"))
    with pytest.raises(ChaosError):
        resilience.call(fn, retries=5, base_delay_s=0.001, breaker=b)
    assert len(calls) == 1


def test_breakers_are_shared_by_key():
    a = resilience.breaker("batch")
    assert resilience.breaker("batch") is a and resilience.breaker("sharded") is not a
    reg = Registry()
    assert a.metrics is None and resilience.breaker("batch", metrics=reg).metrics is reg
