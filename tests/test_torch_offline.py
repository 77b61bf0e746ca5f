"""The port's offline segmented checker (``jepsen_tpu_torch.offline``)
against the reference's (``jepsen_tpu.offline``).

The same recorded histories, drawn from one seed by both packages'
generators, go through both planners and drivers; the result maps (the
verdict, ``segments_decided``, the per-stream folds, the provenance
counts, the plan's statistics and the violation) must be equal, under the
``host``, ``auto`` and ``device`` engines (the port's device oracle is its
plain PyTorch search on the CPU; the reference's runs on JAX's CPU). The
chaos pins hold the fold under an injected fault to the reference's: the
single search's verdict or a typed ``unknown`` whose causes lie in
``chaos.EXPECTED_UNKNOWN_CAUSES``, never ``unattributed``.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu import independent as ref_ind
from jepsen_tpu import offline as ref_offline
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.parallel import resilience as ref_resilience
from jepsen_tpu.testing import chaos as ref_chaos
from jepsen_tpu.testing import concurrent_register_history as ref_concurrent
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu_torch import checker as jc
from jepsen_tpu_torch import independent as ind
from jepsen_tpu_torch import offline
from jepsen_tpu_torch.checker import merge_valid
from jepsen_tpu_torch.checker.provenance import TAXONOMY
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.online.segmenter import NonMonotoneHistoryError
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.parallel import resilience
from jepsen_tpu_torch.telemetry import Registry
from jepsen_tpu_torch.testing import (chaos, chunked_register_history,
                                      concurrent_register_history, perturb_history)

pytestmark = pytest.mark.offline

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread_and_clean_state():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    resilience.reset_breakers()
    ref_resilience.reset_breakers()
    chaos.reset()
    ref_chaos.reset()
    yield
    torch.set_num_threads(n)
    resilience.reset_breakers()
    ref_resilience.reset_breakers()
    chaos.reset()
    ref_chaos.reset()


def keyed_history(seed, n_ops=360, n_keys=3, n_writers=4, invalid=False) -> History:
    """``n_keys`` concurrent-register histories as [k v] values merged by
    time (the reference's ``tests/test_offline.py`` vehicle);
    ``invalid=True`` perturbs one read of key 0."""
    ops = []
    per_key = max(n_writers * 2, n_ops // n_keys)
    for i in range(n_keys):
        h = concurrent_register_history(random.Random(seed + i), n_ops=per_key,
                                        n_writers=n_writers)
        if invalid and i == 0:
            h = perturb_history(random.Random(seed + 100), h, within=0.5)
        for op in h:
            ops.append(op.with_(process=op.process + 1000 * i,
                                value=ind.KV(f"k{i}", op.value), index=-1))
    ops.sort(key=lambda o: o.time)
    return History(ops, reindex=True)


def poisoned_tail(h) -> History:
    """The last ok write flipped to :info, so the tail is a terminal segment
    (the one kind the oracle, and its chaos seam, always sees)."""
    ops = list(h)
    k = max(j for j in range(len(ops)) if ops[j].is_ok and ops[j].f == "write")
    ops[k] = ops[k].with_(type="info")
    return History(ops, reindex=True)


def open_tail(h, drop=3) -> History:
    """The history without its last ``drop`` ops: open invocations make the
    tail a terminal segment for every key in it."""
    return History(list(h)[:-drop], reindex=False)


def to_ref(h):
    """The same ops as the reference's History (its own KV type)."""
    out = []
    for op in h:
        v = op.value
        if isinstance(v, ind.KV):
            v = ref_ind.KV(v.key, v.value)
        out.append(RefOp(op.type, op.process, op.f, v, time=op.time, index=op.index,
                         error=op.error))
    return RefHistory(out, reindex=False)


_WALLS = {"wall_s", "decide_s", "busy_pct", "plan_seconds", "utilization"}


def norm(x):
    """A result map without its wall times, with the reference's KV keys as
    plain tuples, for comparison."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items() if k not in _WALLS}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def both(h, engine="host", **kw):
    port = offline.check_offline(CasRegister(init=0), h, engine=engine, device="cpu", **kw)
    ref = ref_offline.check_offline(RefCas(init=0), to_ref(h), engine=engine, **kw)
    return port, ref


def single_search_verdict(h, max_configs=500_000):
    keys = sorted({op.value.key for op in h if ind.is_tuple(op.value)})
    if not keys:
        return wgl.check_history(CasRegister(init=0), h, backend="host",
                                 host_max_configs=max_configs)["valid"]
    return merge_valid(wgl.check_history(CasRegister(init=0), ind.subhistory(k, h),
                                         backend="host", host_max_configs=max_configs)["valid"]
                       for k in keys)


def without_failover(res):
    """The port's result map without its ``failover`` summaries (global
    and per stream; the reference records a failover only in its metrics),
    and the global summary."""
    res = dict(res)
    fo = res.pop("failover", None)
    if "streams" in res:
        res["streams"] = {k: {kk: vv for kk, vv in row.items() if kk != "failover"}
                          for k, row in res["streams"].items()}
    return res, fo


def assert_typed_provenance(res, allowed=None):
    prov = res.get("provenance")
    if res.get("valid") == "unknown":
        assert prov, f"unknown verdict without provenance: {res}"
    if prov is not None:
        causes = prov.get("causes") or {}
        assert causes and set(causes) <= set(TAXONOMY), prov
        assert "unattributed" not in causes
        if allowed is not None:
            assert set(causes) <= set(allowed), (causes, allowed)


def test_generators_draw_the_references_histories():
    a = concurrent_register_history(random.Random(5), n_ops=200, n_writers=4)
    b = ref_concurrent(random.Random(5), n_ops=200, n_writers=4)
    assert [(o.type, o.process, o.f, o.value, o.time, o.index) for o in a] == \
        [(o.type, o.process, o.f, o.value, o.time, o.index) for o in b]
    from jepsen_tpu.testing import chunked_register_history as ref_chunked

    a = chunked_register_history(random.Random(6), n_ops=300, chunk_ops=40)
    b = ref_chunked(random.Random(6), n_ops=300, chunk_ops=40)
    assert [(o.type, o.process, o.f, o.value, o.time, o.index) for o in a] == \
        [(o.type, o.process, o.f, o.value, o.time, o.index) for o in b]
    h = perturb_history(random.Random(7), keyed_history(3, n_ops=120))
    r = ref_perturb(random.Random(7), to_ref(keyed_history(3, n_ops=120)))
    assert [repr(o.value) for o in h] == [repr(o.value) for o in r]


MATRIX = {
    "valid_unkeyed": lambda: concurrent_register_history(random.Random(21), n_ops=200,
                                                         n_writers=4),
    "invalid_unkeyed": lambda: perturb_history(
        random.Random(22), concurrent_register_history(random.Random(21), n_ops=200,
                                                       n_writers=4), within=0.5),
    "valid_keyed": lambda: keyed_history(23, n_ops=360, n_keys=3),
    "invalid_keyed": lambda: keyed_history(24, n_ops=360, n_keys=3, invalid=True),
    "no_quiescence": lambda: concurrent_register_history(random.Random(25), n_ops=20,
                                                         n_writers=10, read_every=0),
    "open_tail_keyed": lambda: open_tail(keyed_history(26, n_ops=360, n_keys=3), 9),
}


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_matrix_host_engine(name):
    """The reference's differential matrix: both packages' result maps are
    equal, and the verdict is the single search's."""
    h = MATRIX[name]()
    port, ref = both(h, engine="host", streams=4)
    assert norm(port) == norm(ref)
    assert port["valid"] == single_search_verdict(h) and port["valid"] in (True, False)
    assert port["parallel"] == "segmented" and port["segments_decided"] >= 1
    assert_typed_provenance(port)


@pytest.mark.parametrize("name", ["valid_keyed", "invalid_keyed", "open_tail_keyed"])
@pytest.mark.parametrize("engine", ["auto", "device"])
def test_matrix_device_engines(name, engine):
    """Under ``auto`` and ``device`` the oracle rounds run the batched
    search (the port's on the CPU); the result maps equal the reference's
    and the host engine's (the engine name aside)."""
    h = MATRIX[name]()
    port, ref = both(h, engine=engine, streams=4)
    host = offline.check_offline(CasRegister(init=0), h, engine="host", device="cpu",
                                 streams=4)
    assert norm(port) == norm(ref)
    assert {**norm(port), "engine": "host"} == norm(host)
    assert_typed_provenance(port)


def test_device_engine_reaches_the_batched_search():
    """A run with no fault reaches the device oracle with more than one
    member in a round and fails nothing over."""
    h = MATRIX["open_tail_keyed"]()
    reg = Registry()
    res = offline.check_offline(CasRegister(init=0), h, engine="device", device="cpu",
                                streams=4, metrics=reg)
    rounds = [e for e in reg.events() if e["name"] == "online_round"]
    assert res["valid"] is True
    assert any(e["engine"] == "device" and e["oracle_members"] > 1 for e in rounds)
    assert not any(e["failover"] for e in rounds)
    assert reg.counter("wgl_batch_members_total", labelnames=("result",)).labels(
        result="True").value >= 2


def test_overflow_degrades_one_sided_and_typed():
    """``max_configs=1`` starves the enumerator: the verdict folds unknown
    (one-sidedly, typed) in both packages, with equal result maps."""
    h = MATRIX["valid_keyed"]()
    port, ref = both(h, engine="host", streams=4, max_configs=1)
    assert norm(port) == norm(ref)
    assert port["valid"] == "unknown"
    assert_typed_provenance(port)


def test_check_history_parallel_segmented_surface():
    h = keyed_history(29, n_ops=240, n_keys=2, n_writers=3)
    res = wgl.check_history(CasRegister(init=0), h, parallel="segmented", backend="host",
                            streams=2)
    from jepsen_tpu.ops import wgl as ref_wgl

    ref = ref_wgl.check_history(RefCas(init=0), to_ref(h), parallel="segmented",
                                backend="host", streams=2)
    assert norm(res) == norm(ref)
    assert res["parallel"] == "segmented" and res["valid"] is True
    dev = wgl.check_history(CasRegister(init=0), h, parallel="segmented", backend="device",
                            device="cpu", streams=2)
    assert dev["valid"] is True and dev["engine"] == "device"
    with pytest.raises(ValueError, match="unknown parallel mode"):
        wgl.check_history(CasRegister(init=0), h, parallel="bisect")


def test_linearizable_checker_segmented_backend():
    from jepsen_tpu import checker as ref_checker

    for invalid in (False, True):
        h = keyed_history(31, n_ops=240, n_keys=2, n_writers=3, invalid=invalid)
        res = jc.linearizable(model=CasRegister(init=0), backend="segmented",
                              device="cpu").check({}, h, {})
        ref = ref_checker.linearizable(model=RefCas(init=0), backend="segmented").check(
            {}, to_ref(h), {})
        assert norm(res) == norm(ref)
        assert res["valid"] is (not invalid) and res["parallel"] == "segmented"


def test_mixed_keyed_keyless_degrades_typed():
    ops = list(keyed_history(13, n_ops=120, n_keys=2, n_writers=3))
    t = max(op.time for op in ops)
    ops.append(Op("invoke", 99, "write", 999, time=t + 1))
    ops.append(Op("ok", 99, "write", 999, time=t + 2))
    h = History(ops, reindex=True)
    port, ref = both(h, engine="host", streams=2)
    assert norm(port) == norm(ref)
    assert port["valid"] == "unknown"
    assert "mixed_keys" in port["provenance"]["causes"]


def test_plan_matches_the_reference():
    h = keyed_history(7, n_ops=480, n_keys=4, n_writers=3)
    p = offline.plan(h, streams=2)
    r = ref_offline.plan(to_ref(h), streams=2)
    assert norm(p.stats()) == norm(r.stats())
    assert [(it.stream, it.key, it.seq, it.global_seq, it.depends_on, it.n_ops,
             it.segment.start_index, it.segment.end_index, it.segment.terminal)
            for it in p.items] == \
        [(it.stream, it.key, it.seq, it.global_seq, it.depends_on, it.n_ops,
          it.segment.start_index, it.segment.end_index, it.segment.terminal)
         for it in r.items]
    assert p.key_to_stream == r.key_to_stream


def test_plan_rejects_shuffled_recordings_and_stamps_rows():
    ops = list(concurrent_register_history(random.Random(3), n_ops=60, n_writers=3))
    ops[5], ops[20] = ops[20], ops[5]
    with pytest.raises(NonMonotoneHistoryError):
        offline.plan(ops)
    rows, t = [], 0
    for i in range(12):
        t += 1
        rows.append({"type": "invoke", "process": 0, "f": "write", "value": i, "time": t})
        t += 1
        rows.append({"type": "ok", "process": 0, "f": "write", "value": i, "time": t})
    p = offline.plan(rows, streams=2)
    assert p.n_ops == len(rows)
    assert offline.drive(p, CasRegister(init=0), engine="host")["valid"] is True


def test_backends_and_unknown_engine_refused(tmp_path, monkeypatch):
    """``check_offline(backends=2, device="cpu")`` fans the plan over two
    backend processes and folds the reference's verdict and causes; an
    unknown engine is refused."""
    monkeypatch.setenv("JEPSEN_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    h = keyed_history(19, n_ops=120, n_keys=2, n_writers=3)
    port = offline.check_offline(CasRegister(init=0), h, backends=2, engine="host",
                                 device="cpu", journal_root=str(tmp_path / "port"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    ref = ref_offline.check_offline(RefCas(init=0), to_ref(h), backends=2, engine="host",
                                    env=env, journal_root=str(tmp_path / "ref"))
    assert port["valid"] is ref["valid"] is True
    assert port.get("provenance") == ref.get("provenance")
    assert sorted(port["tenants"]) == sorted(ref["tenants"])
    with pytest.raises(ValueError, match="backends must be >= 1"):
        offline.fanout_fleet(offline.plan(h), backends=0)
    with pytest.raises(ValueError, match="unknown offline engine"):
        offline.drive(offline.plan(h), CasRegister(init=0), engine="fleet")


def test_device_engine_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    h = keyed_history(19, n_ops=120, n_keys=2, n_writers=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        offline.check_offline(CasRegister(init=0), h, engine="device")
    # the host engine never needs the card
    assert offline.check_offline(CasRegister(init=0), h, engine="host")["valid"] is True


def test_sharded_engine_is_one_shard_on_the_device():
    h = MATRIX["open_tail_keyed"]()
    port = offline.check_offline(CasRegister(init=0), h, engine="sharded", device="cpu",
                                 streams=4)
    host = offline.check_offline(CasRegister(init=0), h, engine="host", device="cpu",
                                 streams=4)
    assert {**norm(port), "engine": "host"} == norm(host)


@pytest.mark.parametrize("keyed", [True, False])
def test_cli_matches_the_library(tmp_path, keyed):
    h = (open_tail(keyed_history(41, n_ops=240, n_keys=2, n_writers=3), 5) if keyed
         else perturb_history(random.Random(42), concurrent_register_history(
             random.Random(41), n_ops=120, n_writers=3)))
    path = tmp_path / "h.ndjson"
    with open(path, "w") as f:
        for op in h:
            v = list(op.value) if isinstance(op.value, ind.KV) else op.value
            f.write(json.dumps({"type": op.type, "process": op.process, "f": op.f,
                                "value": v, "time": op.time, "index": op.index}) + "\n")
    out = tmp_path / "out.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                      os.environ.get("PYTHONPATH", "")]))
    args = [sys.executable, "-m", "jepsen_tpu_torch.offline", str(path), "--engine", "auto",
            "--device", "cpu", "--streams", "2", "-o", str(out)] + (["--keyed"] if keyed else [])
    run = subprocess.run(args, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    lib = offline.check_offline(CasRegister(init=0), h, engine="auto", device="cpu", streams=2)
    assert run.returncode == (0 if lib["valid"] is True else 2), run.stderr
    doc = json.loads(out.read_text())
    assert doc["valid"] == lib["valid"] and doc["parallel"] == "segmented"
    assert doc["segments_decided"] == lib["segments_decided"]


# ---------------------------------------------------------------------------
# Chaos pins: the fold under an injected fault is the reference's


def chaos_both(point, h, engine, streams=3, **inj):
    with chaos.inject(point, **inj):
        port = offline.check_offline(CasRegister(init=0), h, streams=streams, engine=engine,
                                     device="cpu")
        fired = chaos.fired(point)
    with ref_chaos.inject(point, **inj):
        ref = ref_offline.check_offline(RefCas(init=0), to_ref(h), streams=streams,
                                        engine=engine)
        ref_fired = ref_chaos.fired(point)
    return port, ref, fired, ref_fired


@pytest.mark.chaos
@pytest.mark.parametrize("invalid,on_call", [(False, 1), (True, 2)])
def test_dispatch_fault_never_flips_the_verdict(invalid, on_call):
    h = poisoned_tail(keyed_history(17 + int(invalid), n_ops=360, n_keys=3, invalid=invalid))
    base = single_search_verdict(h)
    assert base is (not invalid)
    port, ref, fired, ref_fired = chaos_both("device.dispatch", h, "host", on_call=on_call)
    assert fired == ref_fired
    port, fo = without_failover(port)
    # a failed host round was re-decided member by member, and says so
    if fired:
        assert fo == {**fo, "rounds": fired, "engines": ["host"],
                      "causes": {"ChaosError": fired}}
    else:
        assert fo is None
    assert norm(port) == norm(ref)
    assert port["valid"] in (base, "unknown")
    assert_typed_provenance(port, chaos.EXPECTED_UNKNOWN_CAUSES["device.dispatch"])


@pytest.mark.chaos
@pytest.mark.parametrize("point,on_call,times,failover,retried", [
    ("device.dispatch", 1, 1, True, 0),
    ("device.dispatch", 2, 1, False, 1),
    ("device.dispatch", 2, 3, True, 2),
    ("host.stack", 1, 1, False, 1),
    ("host.stack", 1, 3, True, 2)])
def test_device_oracle_fault_retries_or_fails_over(point, on_call, times, failover, retried):
    """A fault in the device oracle. The scheduler's own ``device.dispatch``
    seam (its first crossing, outside the batch's retry) fails the round
    over to the host oracle at once; a fault inside the batch (its chunk
    seam, the second crossing, or ``host.stack``) is retried, and only
    three in a row spend the retries and fail the round over
    (``failover`` in its ``online_round``, ``service_failovers_total``).
    The verdict stays the host's, and the port's fold, events and retry
    count equal the reference's under the same ``on_call``."""
    from jepsen_tpu.telemetry import Registry as RefRegistry

    h = MATRIX["open_tail_keyed"]()
    host = offline.check_offline(CasRegister(init=0), h, engine="host", device="cpu",
                                 streams=4)
    reg, ref_reg = Registry(), RefRegistry()
    with chaos.inject(point, on_call=on_call, times=times):
        port = offline.check_offline(CasRegister(init=0), h, engine="device", device="cpu",
                                     streams=4, metrics=reg)
    with ref_chaos.inject(point, on_call=on_call, times=times):
        ref = ref_offline.check_offline(RefCas(init=0), to_ref(h), engine="device",
                                        streams=4, metrics=ref_reg)
    port, fo = without_failover(port)
    assert norm(port) == norm(ref)
    assert port["valid"] == host["valid"] is True
    n_rounds = sum(e["failover"] for e in reg.events() if e["name"] == "online_round")
    if failover:
        assert fo["rounds"] == n_rounds >= 1 and fo["causes"] == {"ChaosError": n_rounds}
    else:
        assert fo is None

    def seen(r):
        # how the terminal segments group into rounds depends on thread
        # timing, so the rounds are compared by what happened in them
        rounds = [e["failover"] for e in r.events() if e["name"] == "online_round"]
        n_retry = r.counter("wgl_retry_total", labelnames=("reason",)).labels(
            reason="batch").value
        n_fail = r.counter("service_failovers_total", labelnames=("engine",),
                           aggregate=True).value
        return any(rounds), n_retry, n_fail >= 1, n_fail == sum(rounds)

    assert seen(reg) == seen(ref_reg) == (failover, retried, failover, True)


@pytest.mark.chaos
@pytest.mark.parametrize("error", ["build", "value", "type"])
def test_deterministic_device_failure_raises(monkeypatch, error):
    """A failed kernel build, a ``ValueError`` or a ``TypeError`` from the
    device oracle is not failed over to the host: ``check_offline`` raises
    it, and no round is demoted or retried."""
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.online.scheduler import SegmentScheduler

    exc = {"build": _build.BuildError("nvcc failed"), "value": ValueError("bad plan"),
           "type": TypeError("bad argument")}[error]
    calls = []

    def broken(self, encs):
        calls.append(len(encs))
        raise exc

    monkeypatch.setattr(SegmentScheduler, "_decide_device", broken)
    reg = Registry()
    with pytest.raises(type(exc)) as got:
        offline.check_offline(CasRegister(init=0), MATRIX["open_tail_keyed"](),
                              engine="device", device="cpu", streams=4, metrics=reg)
    assert got.value is exc
    assert len(calls) == 1  # later device rounds fail at once, no rebuild
    assert reg.counter("service_failovers_total", labelnames=("engine",),
                       aggregate=True).value == 0
    assert not any(e["failover"] for e in reg.events() if e["name"] == "online_round")


@pytest.mark.chaos
def test_transient_device_failure_fails_over_in_the_result(monkeypatch):
    """A transient device failure (an out-of-memory) past the oracle's
    retries: every entry's result carries the ``failover`` summary, and the
    verdict is the host engine's."""
    from jepsen_tpu_torch.online.scheduler import SegmentScheduler

    def oom(self, encs):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(SegmentScheduler, "_decide_device", oom)
    h = MATRIX["open_tail_keyed"]()
    host = offline.check_offline(CasRegister(init=0), h, engine="host", device="cpu",
                                 streams=4)
    reg = Registry()
    res = offline.check_offline(CasRegister(init=0), h, engine="device", device="cpu",
                                streams=4, metrics=reg)
    n = sum(e["failover"] for e in reg.events() if e["name"] == "online_round")
    assert n >= 1
    assert res["failover"]["rounds"] == n and res["failover"]["engines"] == ["device"]
    assert res["failover"]["causes"] == {"OutOfMemoryError": n}
    assert sum((row.get("failover") or {}).get("members", 0)
               for row in res["streams"].values()) >= res["failover"]["members"]
    rest, _fo = without_failover(res)
    assert {**norm(rest), "engine": "host"} == norm(host)
    doc = wgl.check_history(CasRegister(init=0), h, parallel="segmented", backend="device",
                            device="cpu", streams=4)
    assert doc["failover"]["causes"].keys() == {"OutOfMemoryError"}
    assert doc["valid"] == host["valid"]


@pytest.mark.chaos
def test_worker_crash_folds_like_the_reference():
    h = keyed_history(33, n_ops=240, n_keys=2, n_writers=3)
    port, ref, fired, ref_fired = chaos_both("scheduler.worker", h, "host", streams=2,
                                             on_call=1)
    assert fired == ref_fired == 1
    assert port["valid"] == ref["valid"]
    assert port["valid"] in (True, "unknown")
    assert_typed_provenance(port, chaos.EXPECTED_UNKNOWN_CAUSES["scheduler.worker"])


@pytest.mark.chaos
def test_kill_switch_propagates_the_injected_error(monkeypatch):
    """``JEPSEN_NO_FAILOVER=1``: no retry, no failover; the round fails
    and folds ``round_failed``, as in the reference."""
    monkeypatch.setenv("JEPSEN_NO_FAILOVER", "1")
    h = MATRIX["open_tail_keyed"]()
    port, ref, _f, _rf = chaos_both("device.dispatch", h, "device", streams=4, on_call=1)
    # which terminal segments share the failed round depends on thread
    # timing; the verdict and the causes do not
    assert port["valid"] == ref["valid"] == "unknown"
    assert set(port["provenance"]["causes"]) == set(ref["provenance"]["causes"]) \
        == {"round_failed"}
