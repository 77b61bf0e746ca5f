"""The port's live online monitor (``online.OnlineMonitor``, ``of_test``,
``store_online``) and its wiring into ``core.run``, against the
reference's.

The same seeded histories stream through both packages' monitors; the
folded verdicts, watermarks, segment rows (wall times aside), abort and
detection fields must agree, and each must agree with the offline search.
The port's device engine runs on the CPU (``device="cpu"``); the
reference's runs its host engine, which the port's device oracle must
match. Then the live cases: the lying client that the monitor aborts
before the generator drains, the online and offline verdicts of a
``core.run``, ``online.json`` in the store, the off path that builds
nothing, ``live_snapshot``'s shape and the watermark-stall gauge."""

from __future__ import annotations

import json
import random
import threading
import time

import pytest

from jepsen_tpu import checker as r_checker
from jepsen_tpu import core as r_core
from jepsen_tpu import generator as r_gen
from jepsen_tpu import independent as r_ind
from jepsen_tpu import online as r_online
from jepsen_tpu import testing as r_testing
from jepsen_tpu import trace as r_trace
from jepsen_tpu import workloads as r_wl
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.history import Op as ROp
from jepsen_tpu.models import CasRegister as RCas
from jepsen_tpu.ops import wgl as r_wgl
from jepsen_tpu.telemetry import Registry as RRegistry
from jepsen_tpu_torch import checker as p_checker
from jepsen_tpu_torch import core as p_core
from jepsen_tpu_torch import generator as p_gen
from jepsen_tpu_torch import independent as p_ind
from jepsen_tpu_torch import online as p_online
from jepsen_tpu_torch import testing as p_testing
from jepsen_tpu_torch import trace as p_trace
from jepsen_tpu_torch import workloads as p_wl
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import Op as POp
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.ops import wgl as p_wgl
from jepsen_tpu_torch.telemetry import FlightRecorder
from jepsen_tpu_torch.telemetry import Registry as PRegistry

REF = dict(online=r_online, testing=r_testing, trace=r_trace, Registry=RRegistry, Cas=RCas,
           History=RHistory, Op=ROp, ind=r_ind, wgl=r_wgl, checker=r_checker, core=r_core,
           gen=r_gen, wl=r_wl)
PORT = dict(online=p_online, testing=p_testing, trace=p_trace, Registry=PRegistry, Cas=PCas,
            History=PHistory, Op=POp, ind=p_ind, wgl=p_wgl, checker=p_checker, core=p_core,
            gen=p_gen, wl=p_wl)
TIMING = ("wall_s", "decision_latency", "seconds_to_detection", "ops_to_detection")


def stream(mon, history, paced=False):
    """Feed ``history`` until the monitor aborts. ``paced`` waits for the
    scheduler to decide each op's segments before the next op, so the op
    an abort lands on does not depend on the decider thread's speed."""
    for op in history:
        mon.observe(op)
        if paced:
            assert mon.scheduler.wait_idle(60)
        if mon.aborted:
            break
    return mon.finish()


def _monitor(pkg, engine="host", **kw):
    if pkg is PORT and engine != "host":
        kw.setdefault("device", "cpu")
    return pkg["online"].OnlineMonitor(pkg["Cas"](init=0), engine=engine, **kw)


def _scrub(x):
    """Without wall times and span ids (a thread id and a counter)."""
    if isinstance(x, dict):
        return {k: _scrub(v) for k, v in x.items() if k not in ("wall_s", "trace_span")}
    if isinstance(x, list):
        return [_scrub(v) for v in x]
    return x


def _untimed(fin):
    return _scrub({k: v for k, v in fin.items() if k not in TIMING})


def _hist(pkg, kind, seed):
    T = pkg["testing"]
    if kind == "valid":
        return T.chunked_register_history(random.Random(seed), n_ops=300, n_procs=4,
                                          chunk_ops=60)
    if kind == "invalid":
        return T.perturb_history(random.Random(4), T.chunked_register_history(
            random.Random(seed), n_ops=300, n_procs=4, chunk_ops=60))
    if kind == "overflow":
        return T.random_register_history(random.Random(seed), n_ops=120, n_procs=10,
                                         crash_p=0.2)
    if kind == "no_quiescence":
        return T.random_register_history(random.Random(seed), n_ops=150, n_procs=4,
                                         crash_p=0.04)
    if kind == "keyed":
        rng = random.Random(seed)
        ops = []
        for i, k in enumerate(("a", "b", "c")):
            for op in T.chunked_register_history(rng, n_ops=80, n_procs=2, chunk_ops=40):
                ops.append(op.with_(value=pkg["ind"].KV(k, op.value),
                                    process=op.process + 10 * i))
        ops.sort(key=lambda o: o.time)
        return T.perturb_history(random.Random(5), pkg["History"](ops, reindex=True))
    if kind == "open_tail":
        # terminal segments per key: the device oracle's members
        rng = random.Random(seed)
        ops = []
        for i, k in enumerate(("a", "b")):
            for op in T.chunked_register_history(rng, n_ops=60, n_procs=2, chunk_ops=30):
                ops.append(op.with_(value=pkg["ind"].KV(k, op.value),
                                    process=op.process + 10 * i))
        ops.sort(key=lambda o: o.time)
        t_end = ops[-1].time + 1
        ops.append(pkg["Op"]("invoke", 0, "write", pkg["ind"].KV("a", 3), time=t_end))
        ops.append(pkg["Op"]("invoke", 10, "write", pkg["ind"].KV("b", 3), time=t_end + 1))
        return pkg["History"](ops, reindex=True)
    raise ValueError(kind)


CASES = {"valid": (10, {}), "invalid": (11, {}), "overflow": (12, {"max_configs": 50}),
         "no_quiescence": (13, {}), "keyed": (14, {}), "open_tail": (15, {})}


@pytest.mark.parametrize("abort", [False, True])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_monitor_matches_reference(kind, abort):
    seed, kw = CASES[kind]
    out = []
    for pkg in (REF, PORT):
        mon = _monitor(pkg, abort_on_violation=abort, metrics=pkg["Registry"](),
                       collector=pkg["trace"].Collector(), **kw)
        out.append(stream(mon, _hist(pkg, kind, seed), paced=abort))
    ref, port = out
    assert _untimed(port) == _untimed(ref)
    assert port["decision_latency"]["count"] == ref["decision_latency"]["count"]
    if kind == "invalid":
        assert port["valid"] is False and port["aborted"] == abort
    if kind == "overflow":
        assert port["valid"] == "unknown" and not port["aborted"]


@pytest.mark.parametrize("kind", ["valid", "invalid", "open_tail", "no_quiescence"])
def test_device_engine_agrees_with_reference_host(kind):
    """The port's device oracle (batched search on the CPU) folds the
    reference host engine's verdicts, segment for segment."""
    seed, kw = CASES[kind]
    ref = stream(_monitor(REF, "host", **kw), _hist(REF, kind, seed))
    port = stream(_monitor(PORT, "device", batch_f=64, **kw), _hist(PORT, kind, seed))
    assert port["valid"] == ref["valid"]
    assert port["decided_through_index"] == ref["decided_through_index"]
    assert [(s["key"], s["seq"], s["valid"]) for s in port["segments"]] == \
        [(s["key"], s["seq"], s["valid"]) for s in ref["segments"]]
    terminal = [s for s in port["segments"] if s["terminal"]]
    if kind == "open_tail":
        assert terminal and all(s["engine"] == "device" for s in terminal)


def test_mixed_keyed_keyless_stream_degrades_to_unknown():
    out = []
    for pkg in (REF, PORT):
        KV = pkg["ind"].KV
        h = pkg["History"]([pkg["Op"](t, p, f, v, time=i) for i, (t, p, f, v) in enumerate([
            ("invoke", 0, "write", KV("a", 1)), ("ok", 0, "write", KV("a", 1)),
            ("invoke", 0, "write", 9), ("ok", 0, "write", 9),
            ("invoke", 0, "read", KV("a", None)), ("ok", 0, "read", KV("a", 9))])])
        mon = _monitor(pkg, abort_on_violation=True)
        fin = stream(mon, h)
        assert mon.segmenter.mixed_keys
        out.append(fin)
    assert _untimed(out[1]) == _untimed(out[0])
    assert out[1]["valid"] == "unknown" and not out[1]["aborted"] and "info" in out[1]


# ---------------------------------------------------------------------------
# decision latency, spans, the stall detector, live_snapshot


def test_latency_histogram_and_span_chain_match_reference():
    res = []
    for pkg in (REF, PORT):
        h = pkg["testing"].chunked_register_history(random.Random(22), n_ops=120, n_procs=4,
                                                    chunk_ops=40)
        reg, col = pkg["Registry"](), pkg["trace"].Collector()
        fin = stream(_monitor(pkg, metrics=reg, collector=col), h)
        by: dict = {}
        for s in col.spans:
            by.setdefault(s.get("stage"), []).append(s)
        samples = [s for s in reg.collect() if s["name"] == "decision_latency_seconds"]
        res.append((fin["valid"], fin["decision_latency"]["count"],
                    fin["decision_latency"]["undecided_ops"],
                    {k: len(v) for k, v in by.items()},
                    sorted(s["attrs"]["index"] for s in by["op"]),
                    list(samples[0]["buckets"])))
    assert res[1] == res[0]
    assert "300.0" in res[1][5]


def _gauge(reg):
    for s in reg.collect():
        if s["name"] == "online_watermark_stall_seconds":
            return s["value"]
    return None


def test_stall_gauge_fires_and_clears():
    reg, rec = PRegistry(), FlightRecorder()
    mon = _monitor(PORT, metrics=reg, flight=rec, stall_after_s=0.05)
    mon.observe(POp("invoke", 0, "write", 1, time=0))
    t, deadline = 1, time.monotonic() + 5.0
    while _gauge(reg) == 0.0 and time.monotonic() < deadline:
        mon.observe(POp("invoke", 1, "write", t, time=10 * t))
        mon.observe(POp("ok", 1, "write", t, time=10 * t + 1))
        t += 1
        time.sleep(0.02)
    assert _gauge(reg) > 0.0
    phases = [p for p in rec.snapshot()["phases"] if p["phase"] == "online.watermark_stall"]
    assert len(phases) == 1 and "end_s" not in phases[0]
    assert rec.offending_phase() == "online.watermark_stall"
    mon.observe(POp("ok", 0, "write", 1, time=10 * t))
    assert mon.scheduler.wait_idle(10.0)
    assert mon.finish()["valid"] is True
    assert _gauge(reg) == 0.0
    phases = [p for p in rec.snapshot()["phases"] if p["phase"] == "online.watermark_stall"]
    assert len(phases) == 1 and "end_s" in phases[0]


def test_quiet_gap_does_not_fire_stall():
    reg = PRegistry()
    mon = _monitor(PORT, metrics=reg, stall_after_s=0.05)
    mon.observe(POp("invoke", 0, "write", 1, time=0))
    mon.observe(POp("ok", 0, "write", 1, time=1))
    assert mon.scheduler.wait_idle(10.0)
    time.sleep(0.15)
    mon.observe(POp("invoke", 0, "write", 2, time=2))
    assert _gauge(reg) == 0.0
    mon.observe(POp("ok", 0, "write", 2, time=3))
    assert mon.finish()["valid"] is True


@pytest.mark.parametrize("engine", ["host", "device"])
def test_live_snapshot_has_the_references_shape(engine):
    snaps = []
    for pkg in (REF, PORT):
        h = pkg["testing"].chunked_register_history(random.Random(25), n_ops=80, n_procs=2,
                                                    chunk_ops=40)
        mon = _monitor(pkg, "host" if pkg is REF else engine, metrics=pkg["Registry"](),
                       name="live-test")
        for op in h:
            mon.observe(op)
        assert mon.scheduler.wait_idle(10.0)
        snap = mon.live_snapshot()
        json.dumps(snap)
        mon.finish()
        snaps.append(snap)
    ref, port = snaps
    assert set(port) == set(ref)
    for k in ("run", "ops_observed", "decided_through_index", "verdict", "aborted",
              "segments_decided", "segments_unknown", "scheduler_backlog",
              "watermark_stall_seconds", "undecided_ops"):
        assert port[k] == ref[k], k
    assert set(port["decision_latency"]) == set(ref["decision_latency"])


def test_registry_metrics_after_violation():
    names = []
    for pkg in (REF, PORT):
        T = pkg["testing"]
        h = T.perturb_history(random.Random(8), T.chunked_register_history(
            random.Random(18), n_ops=200, n_procs=4, chunk_ops=50))
        reg = pkg["Registry"]()
        fin = stream(_monitor(pkg, metrics=reg), h)
        assert fin["valid"] is False
        samples = reg.collect()
        names.append((sorted({s["name"] for s in samples}),
                      sorted({s["labels"]["verdict"] for s in samples
                              if s["name"] == "online_segments_total" and s.get("labels")})))
    assert names[1] == names[0]
    assert "online_detection_seconds" in names[1][0] and "False" in names[1][1]


def test_monitor_of_test_reads_the_test_map():
    assert p_online.of_test({}) is None
    assert p_online.of_test({"online?": True}) is None
    with pytest.raises(ValueError):
        p_online.of_test({"online?": True, "online-abort?": True})
    mon = p_online.of_test({"online?": True, "model": PCas(init=0), "online-engine": "device",
                            "online-abort?": True, "device": "cpu", "name": "t"})
    assert mon.abort_on_violation and mon.scheduler.engine == "device"
    assert str(mon.scheduler.device) == "cpu" and mon.name == "t"
    mon.finish()


# ---------------------------------------------------------------------------
# live runs through core.run


def _cas_test(pkg, **extra):
    G = pkg["gen"]
    state = pkg["wl"].AtomState()
    kw = {"device": "cpu"} if pkg is PORT else {"backend": "native"}
    test = dict(pkg["wl"].noop_test())
    test.update(
        name="online-e2e", db=pkg["wl"].AtomDB(state), client=pkg["wl"].AtomClient(state),
        model=pkg["Cas"](init=0), concurrency=4,
        checker=pkg["checker"].linearizable(model=pkg["Cas"](init=0), **kw),
        generator=G.clients(G.limit(120, G.mix([
            lambda: {"f": "read"},
            lambda: {"f": "write", "value": G.rand_int(5)},
            lambda: {"f": "cas", "value": [G.rand_int(5), G.rand_int(5)]}]))))
    test.update(extra)
    return test


@pytest.mark.parametrize("engine", ["host", "device"])
def test_online_run_agrees_with_offline_checker(tmp_path, engine):
    res = p_core.run(_cas_test(PORT, **{"online?": True, "online-engine": engine,
                                        "device": "cpu", "telemetry?": True,
                                        "store-root": str(tmp_path)}))
    fin = res["online-results"]
    assert fin["valid"] is res["results"]["valid"] is True
    assert not fin["aborted"] and fin["segments_decided"] >= 1
    (online_json,) = tmp_path.rglob("online.json")
    stored = json.loads(online_json.read_text())
    assert stored["valid"] is True and stored["segments_decided"] == fin["segments_decided"]
    names = {s["name"] for s in res["telemetry-registry"].collect()}
    assert {"online_segments_total", "online_decided_watermark",
            "online_open_segment_ops", "decision_latency_seconds"} <= names
    phases = {s["labels"]["phase"] for s in res["telemetry-registry"].collect()
              if s["name"] == "run_phase_seconds"}
    assert "online.finish" in phases
    # the reference's checker reads the port's run alike
    h = RHistory([ROp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                  for o in res["history"]], reindex=False)
    assert r_checker.linearizable(model=RCas(init=0), backend="native").check(
        {}, h, {})["valid"] is True
    assert not any(t.name == "jepsen-online-scheduler" for t in threading.enumerate())


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_lying_client_aborts_before_the_generator_drains(pkg):
    G = pkg["gen"]
    state = pkg["wl"].AtomState()
    counter = {"n": 0}

    class LyingClient(pkg["wl"].AtomClient):
        def invoke(self, test, op):
            res = super().invoke(test, op)
            counter["n"] += 1
            if op.get("f") == "read" and counter["n"] >= 40 and res.get("value") != 93:
                return {**res, "value": 93}
            return res

    n_gen = 1500
    test = _cas_test(pkg, **{"no-store?": True, "online?": True, "online-abort?": True,
                             "online-engine": "host" if pkg is REF else "device",
                             "device": "cpu"})
    test.update(client=LyingClient(state, latency=0.001), concurrency=2, db=pkg["wl"].AtomDB(state),
                generator=G.clients(G.stagger(0.008, G.limit(n_gen, G.mix([
                    lambda: {"f": "read"},
                    lambda: {"f": "write", "value": G.rand_int(5)}])))))
    res = pkg["core"].run(test)
    fin = res["online-results"]
    assert fin["aborted"] is True and fin["valid"] is False
    assert fin["ops_to_detection"] > 0
    assert len(res["history"]) < n_gen
    assert res["results"]["valid"] is False


def test_off_path_allocates_nothing(monkeypatch):
    def _boom(*a, **kw):
        raise AssertionError("online subsystem touched on off path")

    monkeypatch.setattr(p_online.OnlineMonitor, "__init__", _boom)
    monkeypatch.setattr(p_online.SegmentScheduler, "__init__", _boom)
    res = p_core.run(_cas_test(PORT, **{"no-store?": True, "telemetry?": True}))
    assert res["results"]["valid"] is True
    assert "online-monitor" not in res and "online-results" not in res
    names = {s["name"] for s in res["telemetry-registry"].collect()}
    assert not any(n.startswith("online_") for n in names)
    assert not any(t.name == "jepsen-online-scheduler" for t in threading.enumerate())


def test_off_path_allocates_no_span_objects(monkeypatch):
    def _boom(*a, **kw):
        raise AssertionError("span object allocated on off path")

    monkeypatch.setattr(p_trace.Collector, "__init__", _boom)
    monkeypatch.setattr(p_trace.Collector, "record", _boom)
    res = p_core.run(_cas_test(PORT, **{"no-store?": True}))
    assert res["results"]["valid"] is True and "trace-collector" not in res
    assert p_trace.event_tags() is p_trace.event_tags() == {}


def test_store_online_writes_the_references_file(tmp_path):
    fin = {"valid": True, "segments": [], "decided_through_index": 3}
    paths = []
    for name, mod in (("ref", r_online), ("port", p_online)):
        t = {"name": "o", "start-time": "20260801T000000.000Z",
             "store-root": str(tmp_path / name)}
        paths.append(mod.store_online(t, fin))
    assert open(paths[1]).read() == open(paths[0]).read()
