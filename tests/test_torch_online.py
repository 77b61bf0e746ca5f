"""The port's segmenter and segment scheduler (``jepsen_tpu_torch.online``)
against the reference's (``jepsen_tpu.online``).

The same seeded histories go through both: the segment lists and the
exhaustive end-state enumeration (``segment_states``) must be equal, and
the scheduler's per-stream folds, cause codes and ``online_round`` events
must be equal under the ``host``, ``auto`` and ``device`` engines (the
port's device oracle is its plain PyTorch search on the CPU)."""

from __future__ import annotations

import random
import sys
import threading
import types

import pytest
import torch

from jepsen_tpu import independent as ref_ind
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.models import Mutex as RefMutex
from jepsen_tpu.online import scheduler as ref_sched_mod
from jepsen_tpu.online import segmenter as ref_seg
from jepsen_tpu.parallel import resilience as ref_resilience
from jepsen_tpu.telemetry import Registry as RefRegistry
from jepsen_tpu.testing import chaos as ref_chaos
from jepsen_tpu_torch import independent as ind
from jepsen_tpu_torch import online
from jepsen_tpu_torch import trace
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.models import CasRegister, Mutex
from jepsen_tpu_torch.online import scheduler as sched_mod
from jepsen_tpu_torch.online import segmenter as seg
from jepsen_tpu_torch.parallel import resilience
from jepsen_tpu_torch.telemetry import Registry, flight
from jepsen_tpu_torch.testing import (chaos, chunked_register_history,
                                      concurrent_register_history, perturb_history,
                                      random_lock_history, random_register_history)

pytestmark = pytest.mark.online


@pytest.fixture(autouse=True)
def _one_thread_and_clean_state():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (resilience, ref_resilience):
        mod.reset_breakers()
    chaos.reset()
    ref_chaos.reset()
    yield
    torch.set_num_threads(n)
    for mod in (resilience, ref_resilience):
        mod.reset_breakers()
    chaos.reset()
    ref_chaos.reset()


def keyed_history(seed, n_ops=240, n_keys=3, n_writers=3, invalid=False) -> History:
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


def to_ref(h):
    out = []
    for op in h:
        v = op.value
        if isinstance(v, ind.KV):
            v = ref_ind.KV(v.key, v.value)
        out.append(RefOp(op.type, op.process, op.f, v, time=op.time, index=op.index,
                         error=op.error))
    return RefHistory(out, reindex=False)


def op_row(o):
    return (o.type, o.process, o.f, repr(o.value), o.time, o.index)


def seg_row(s):
    return (repr(s.key), s.seq, [op_row(o) for o in s.ops], s.start_index, s.end_index,
            s.terminal)


HISTORIES = {
    "keyed": lambda: keyed_history(3),
    "keyed_open_tail": lambda: History(list(keyed_history(4))[:-4], reindex=False),
    "unkeyed_chunked": lambda: chunked_register_history(random.Random(5), n_ops=200,
                                                        chunk_ops=30),
    "unkeyed_crashes": lambda: random_register_history(random.Random(6), n_ops=60,
                                                       crash_p=0.05),
    "no_quiescence": lambda: concurrent_register_history(random.Random(7), n_ops=16,
                                                         n_writers=8, read_every=0),
}


def segments_of(mod, ops, strict=False):
    s = mod.Segmenter(strict=strict)
    out = []
    for op in ops:
        out.extend(s.offer(op))
    out.extend(s.finish())
    return s, out


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_segment_lists_equal(name):
    h = HISTORIES[name]()
    s, port = segments_of(seg, h)
    r, ref = segments_of(ref_seg, to_ref(h))
    assert [seg_row(x) for x in port] == [seg_row(x) for x in ref]
    assert (s.poisoned, s.mixed_keys, s.segments_emitted, s.ops_seen) == \
        (r.poisoned, r.mixed_keys, r.segments_emitted, r.ops_seen)


def test_dict_rows_strict_and_covered_duplicates():
    rows = [{"type": "invoke", "process": 0, "f": "write", "value": 1, "index": 0},
            {"type": "ok", "process": 0, "f": "write", "value": 1, "index": 1},
            {"type": "invoke", "process": 0, "f": "read", "value": None, "index": 1}]
    s = seg.Segmenter()
    out = [x for row in rows for x in s.offer(row)]
    assert len(out) == 1 and s.dropped_covered == 1 and s.last_op is None
    with pytest.raises(seg.NonMonotoneHistoryError):
        strict = seg.Segmenter(strict=True)
        for row in rows:
            strict.offer(row)
    mixed = seg.Segmenter()
    mixed.offer(Op("invoke", 0, "write", ind.KV("a", 1)))
    mixed.offer(Op("invoke", 1, "write", 2))
    assert mixed.mixed_keys


def _carried_states(mod, model, segs):
    """segment_states over a key's chain, carrying the enumerated states."""
    out, carry = [], {}
    for s in segs:
        encs = mod.encode_segment(model, s, carry.get(s.key))
        rs = [mod.segment_states(e) for e in encs]
        out.append([(r["valid"], r.get("end_states"), r["configs_explored"]) for r in rs])
        ends = [st for r in rs if r["valid"] is True for st in (r["end_states"] or [])]
        carry[s.key] = sorted(set(ends), key=repr)
    return out


@pytest.mark.parametrize("name", ["keyed", "unkeyed_chunked"])
def test_segment_states_equal(name):
    h = HISTORIES[name]()
    _s, port = segments_of(seg, h)
    _r, ref = segments_of(ref_seg, to_ref(h))
    assert _carried_states(seg, CasRegister(init=0), port) == \
        _carried_states(ref_seg, RefCas(init=0), ref)


def test_segment_states_mutex_and_budget():
    h = random_lock_history(random.Random(8), n_ops=40, n_procs=3)
    _s, port = segments_of(seg, h)
    _r, ref = segments_of(ref_seg, to_ref(h))
    assert _carried_states(seg, Mutex(), port) == _carried_states(ref_seg, RefMutex(), ref)
    h = HISTORIES["keyed"]()
    (_s, port), (_r, ref) = segments_of(seg, h), segments_of(ref_seg, to_ref(h))
    enc = seg.encode_segment(CasRegister(init=0), port[0], None)[0]
    ref_enc = ref_seg.encode_segment(RefCas(init=0), ref[0], None)[0]
    a, b = seg.segment_states(enc, max_configs=1), ref_seg.segment_states(ref_enc,
                                                                          max_configs=1)
    assert a == b and a["valid"] == "unknown" and a["causes"][0]["code"] == "max_configs"


# ---------------------------------------------------------------------------
# The scheduler


class _DeferredThread(threading.Thread):
    """A thread whose ``start`` waits for the test's signal."""

    held: list = []

    def start(self):
        self.held.append(super().start)


def run_scheduler(mod, model, streams, engine, metrics, **kw):
    """Submit every stream's cuts, then close; returns the global result and
    each stream's. The worker thread starts only once every batch is
    queued (its ``threading.Thread`` deferred), so the rounds and a crash's
    place in them do not depend on thread timing."""
    extra = {"device": "cpu"} if mod is sched_mod else {}
    segmenter = seg if mod is sched_mod else ref_seg
    _DeferredThread.held = []
    real = mod.threading
    mod.threading = types.SimpleNamespace(Thread=_DeferredThread, Lock=threading.Lock,
                                          Event=threading.Event)
    try:
        sch = mod.SegmentScheduler(model, engine=engine, metrics=metrics, **kw, **extra)
    finally:
        mod.threading = real
    for name, h in streams.items():
        sch.register_stream(name)
        s = segmenter.Segmenter()
        for op in h:
            cut = s.offer(op)
            if cut:
                sch.submit(cut, stream=name)
        tail = s.finish()
        if tail:
            sch.submit(tail, stream=name)
    (start,) = _DeferredThread.held
    start()
    assert sch.wait_idle(120)
    sch.close(60)
    return sch.result(), {n: sch.stream_result(n) for n in streams}


_WALLS = {"wall_s", "t", "decide_s"}


def norm(x):
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items() if k not in _WALLS}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def rounds(reg):
    return [norm(e) for e in reg.events() if e["name"] == "online_round"]


def _streams(invalid=False):
    return {"a": History(list(keyed_history(11, invalid=invalid))[:-3], reindex=False),
            "b": History(list(keyed_history(12, n_keys=2))[:-2], reindex=False)}


@pytest.mark.parametrize("engine", ["host", "auto", "device"])
@pytest.mark.parametrize("invalid", [False, True])
def test_scheduler_folds_equal(engine, invalid):
    """Two streams co-batched through one scheduler: the global and
    per-stream folds, the causes and every ``online_round`` event equal the
    reference's."""
    streams = _streams(invalid)
    reg, ref_reg = Registry(), RefRegistry()
    port = run_scheduler(sched_mod, CasRegister(init=0), streams, engine, reg)
    ref = run_scheduler(ref_sched_mod, RefCas(init=0),
                        {n: to_ref(h) for n, h in streams.items()}, engine, ref_reg)
    assert norm(port) == norm(ref)
    assert port[0]["valid"] is (not invalid)
    assert rounds(reg) == rounds(ref_reg)
    oracle = [e for e in rounds(reg) if e["oracle_members"]]
    if engine != "host":
        assert any(e["engine"] == "device" and e["oracle_members"] > 1 for e in oracle)


def test_scheduler_rounds_and_spans():
    """The round events, and the trace collector's oracle, segment and
    member spans, line up with the fold; the flight recorder logs the
    round phases."""
    streams = _streams()
    reg, col, rec = Registry(), trace.Collector(), flight.FlightRecorder()
    res, per = run_scheduler(sched_mod, CasRegister(init=0), streams, "device", reg,
                             collector=col, flight=rec)
    ev = rounds(reg)
    assert sum(e["segments"] for e in ev) == res["segments_decided"]
    stages = {}
    for sp in col.spans:
        stages.setdefault(sp["stage"], []).append(sp)
    assert len(stages["segment"]) == res["segments_decided"]
    assert stages["oracle"] and all(sp["attrs"]["engine"] == "device"
                                    for sp in stages["oracle"])
    oracle_ids = {sp["span_id"] for sp in stages["oracle"]}
    linked = [sp for sp in stages["member"] if sp["attrs"].get("oracle_span")]
    assert linked and {sp["attrs"]["oracle_span"] for sp in linked} <= oracle_ids
    phases = {p["phase"] for p in rec.snapshot()["phases"]}
    assert {"online.drain", "online.dispatch", "online.fold"} <= phases
    assert reg.counter("online_segments_total", labelnames=("verdict",)).labels(
        verdict="True").value == res["segments_decided"]


@pytest.mark.chaos
@pytest.mark.parametrize("on_call,times", [(1, 1), (1, 2)])
def test_worker_crash_restart_folds_like_the_reference(on_call, times):
    """The ``scheduler.worker`` seam: one crash is survived by the bounded
    restart; two are terminal (``worker_died``). The folds equal the
    reference's, and no verdict flips."""
    streams = _streams()
    with chaos.inject("scheduler.worker", on_call=on_call, times=times):
        port = run_scheduler(sched_mod, CasRegister(init=0), streams, "host", Registry())
    with ref_chaos.inject("scheduler.worker", on_call=on_call, times=times):
        ref = run_scheduler(ref_sched_mod, RefCas(init=0),
                            {n: to_ref(h) for n, h in streams.items()}, "host",
                            RefRegistry())
    assert norm(port) == norm(ref)
    assert port[0]["valid"] in (True, "unknown")
    causes = set((port[0].get("provenance") or {}).get("causes") or {})
    assert causes <= chaos.EXPECTED_UNKNOWN_CAUSES["scheduler.worker"]


@pytest.mark.chaos
def test_open_breaker_demotes_the_round_to_the_host():
    """With the ``"batch"`` breaker open, a device round is demoted up
    front (``failover`` true, ``service_failovers_total{engine=device}``),
    and the verdict is the host's."""
    reg = Registry()
    b = resilience.breaker("batch", metrics=reg)
    for _ in range(b.failure_threshold):
        b.record_failure()
    assert b.state == "open"
    assert reg.gauge("circuit_state", labelnames=("device",)).labels(device="batch").value == 2
    res, _per = run_scheduler(sched_mod, CasRegister(init=0), _streams(), "device", reg)
    host, _ = run_scheduler(sched_mod, CasRegister(init=0), _streams(), "host", Registry())
    assert res["valid"] == host["valid"] is True
    demoted = [e for e in rounds(reg) if e["oracle_members"]]
    assert demoted and all(e["failover"] and e["engine"] == "host" for e in demoted)
    c = reg.counter("service_failovers_total", labelnames=("engine",), aggregate=True)
    assert c.labels(engine="device").value == len(demoted)
    # the result maps say so too, globally and for each stream in a round
    assert res["failover"] == {
        "rounds": len(demoted), "members": sum(e["oracle_members"] for e in demoted),
        "engines": ["device"], "causes": {"circuit_open": len(demoted)}}
    for name, row in _per.items():
        n = sum(1 for e in demoted if name in e["oracle_streams"])
        assert (row.get("failover") or {}).get("rounds", 0) == n
    assert "failover" not in host


def test_scheduler_device_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        online.SegmentScheduler(CasRegister(init=0), engine="device")
    sch = online.SegmentScheduler(CasRegister(init=0), engine="host")
    sch.close(5)


def test_monitor_entry_points_raise():
    """The monitor's entry points: no monitor off the online path, a
    refused armed abort without a model, no online.json without a store,
    and a monitor that needs a card (or ``"cpu"``) for its device
    oracle."""
    assert online.of_test({}) is None
    assert online.of_test({"online?": True}) is None
    with pytest.raises(ValueError, match="online-abort"):
        online.of_test({"online?": True, "online-abort?": True})
    assert online.store_online({"no-store?": True}, {"valid": True}) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            online.OnlineMonitor(CasRegister(init=0), engine="device")
    mon = online.OnlineMonitor(CasRegister(init=0), engine="device", device="cpu")
    assert mon.finish()["valid"] is True


def test_device_oracle_from_the_worker_and_the_caller_at_once():
    """The device oracle runs on the worker thread while the caller's
    thread runs its own device searches: both give the verdicts they give
    alone."""
    from jepsen_tpu_torch.ops import wgl

    streams = _streams()
    alone = run_scheduler(sched_mod, CasRegister(init=0), streams, "device", Registry())
    hs = [random_register_history(random.Random(s), n_ops=30, n_procs=3) for s in range(4)]
    want = [wgl.check_history(CasRegister(init=0), h, device="cpu")["valid"] for h in hs]
    got, errors = [], []

    def caller():
        try:
            for h in hs:
                got.append(wgl.check_history(CasRegister(init=0), h, device="cpu")["valid"])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=caller)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t.start()
        both = run_scheduler(sched_mod, CasRegister(init=0), streams, "device", Registry())
        t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive() and not errors
    assert got == want
    assert norm(both) == norm(alone)
