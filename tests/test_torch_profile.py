"""The port's ``telemetry.profile`` against the reference's: the roofline
attribution over hand-built registries whose arithmetic is known (the
bandwidth and latency classes, compile chunks, the occupancy fallback,
overflow chunks, eliding, the batch's rungs and escalations, the sharded
interconnect share with legacy and partitioned recordings, byte-floor
callables with and without keywords); ``profile.json`` as
``store_profile`` writes it; the ``torch.profiler`` capture of
``trace_capture`` (a Chrome trace on the CPU, a profiler that cannot
start, an error of the body); ``memory_watermarks`` (empty without a
card); and a ``core.run`` with ``profile?``, ``live-port`` and the online
monitor, whose ``profile.json`` equals the reference's attribution of the
run's registry and whose ledger record carries the utilization."""

from __future__ import annotations

import json
import logging
import random
import threading
import time
import urllib.request

import pytest
import torch

from jepsen_tpu.telemetry import Registry as RRegistry
from jepsen_tpu.telemetry import profile as r_profile
from jepsen_tpu_torch import checker as p_checker
from jepsen_tpu_torch import core as p_core
from jepsen_tpu_torch import generator as p_gen
from jepsen_tpu_torch import store as p_store
from jepsen_tpu_torch import telemetry as p_telemetry
from jepsen_tpu_torch import web as p_web
from jepsen_tpu_torch import workloads as p_wl
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.telemetry import Registry as PRegistry
from jepsen_tpu_torch.telemetry import ledger as p_ledger
from jepsen_tpu_torch.telemetry import profile as p_profile


def _canon(doc):
    return json.loads(json.dumps(doc, sort_keys=True, default=str))


def _chunk(reg, level0, level, F, wall_s, stage="execute"):
    reg.event("wgl_chunk", level0=level0, level=level, F=F, wall_s=wall_s, stage=stage)


def _levels(reg, levels, F, frontier):
    for lv in levels:
        reg.event("wgl_level", level=lv, frontier=frontier, expanded=frontier * 2,
                  overflow=False, F=F, completed=True)


def _bandwidth(reg):
    _chunk(reg, 0, 10, 1024, 2.0)
    _levels(reg, range(1, 11), 1024, frontier=512)
    return {"byte_floor": lambda F: 10 ** 9, "copy_bw_gbs": 10.0}


def _latency(reg):
    _chunk(reg, 0, 100, 8192, 0.05)
    _levels(reg, range(1, 101), 8192, frontier=4)
    return {"byte_floor": lambda F: 10 ** 4, "copy_bw_gbs": 100.0}


def _compile(reg):
    _chunk(reg, 0, 5, 16, 30.0, stage="compile")
    _chunk(reg, 5, 10, 16, 0.01)
    _levels(reg, range(1, 11), 16, frontier=8)
    return {"byte_floor": lambda F: 10 ** 6, "copy_bw_gbs": 100.0}


def _occupancy(reg):
    _chunk(reg, 0, 10, 64, 0.1)
    _levels(reg, range(1, 11), 64, frontier=32)
    _chunk(reg, 10, 20, 64, 0.1)
    _levels(reg, range(11, 21), 64, frontier=2)
    _chunk(reg, 20, 25, 64, 0.0)
    return {"byte_floor": lambda F: 10 ** 6}


def _indeterminate(reg):
    _chunk(reg, 0, 10, 64, 10.0)
    _chunk(reg, 10, 20, 64, 0.001)
    return {}


def _overflow(reg):
    _chunk(reg, 0, 0, 16, 0.2)
    _chunk(reg, 0, 0, 64, 0.3, stage="compile")
    return {"byte_floor": lambda F: 10 ** 6}


def _eliding(reg):
    rng = random.Random(4)
    lvl = 0
    for i in range(90):
        F = rng.choice([16, 64, 256])
        n = rng.randint(0, 6)
        _chunk(reg, lvl, lvl + n, F, rng.random() / 10, "compile" if i % 17 == 0 else "execute")
        _levels(reg, range(lvl + 1, lvl + n + 1), F, frontier=rng.randint(1, F))
        lvl += n
    return {"byte_floor": lambda F: 4096 * F, "copy_bw_gbs": 3000.0, "max_chunks": 10}


def _batch(reg):
    for F, active in ((256, 6), (256, 3), (1024, 3), (1024, 1)):
        reg.event("wgl_batch_chunk", F=F, active=active, batch=8, wall_s=0.1,
                  stage="execute", n_devices=2)
    reg.event("wgl_batch_rung", F=256, members=8, calls=2, wall_s=0.2, decided=5,
              overflowed=3, lossy=False)
    reg.event("wgl_batch_rung", F=1024, members=3, calls=2, wall_s=0.2, decided=3,
              overflowed=0, lossy=True)
    reg.event("wgl_rebatch", from_F=256, to_F=1024, members=3)
    return {}


def _batch_chunks_only(reg):
    for F, active in ((16, 4), (16, 2), (64, 2)):
        reg.event("wgl_batch_chunk", F=F, active=active, batch=4, wall_s=0.1)
    return {}


def _sharded_legacy(reg):
    for level in (10, 20):
        reg.event("wgl_sharded_chunk", level=level, F=128, n_shards=8, global_capacity=1024,
                  count=500, frontier_max=600, wall_s=0.5, allgather_bytes=4_000_000)
    return {"byte_floor": lambda F, **kw: 600_000}


def _sharded_counter_fallback(reg):
    reg.event("wgl_sharded_chunk", level=10, F=128, n_shards=8, wall_s=0.5)
    reg.counter("wgl_allgather_bytes_total", "bytes").inc(123_456)
    return {"byte_floor": lambda F: 1000}


def _sharded_partitioned(reg):
    for level, cmax in ((10, 90), (20, 70)):
        reg.event("wgl_sharded_chunk", level=level, F=128, n_shards=8, global_capacity=1024,
                  count=500, count_max=cmax, count_min=30, frontier_max=600, wall_s=0.5,
                  exchange="alltoall", exchange_bytes=500_000)

    def floor(F, sharded=False, exchange="allgather"):
        return 600_000 + (100_000 if exchange == "alltoall" else 0) + (7 if sharded else 0)

    return {"byte_floor": floor}


def _single_arg_floor(reg):
    reg.event("wgl_sharded_chunk", level=4, F=32, n_shards=2, wall_s=0.1,
              exchange="allgather", exchange_bytes=10)
    return {"byte_floor": lambda F: 11 * F}


def _empty(reg):
    return {}


CASES = {f.__name__.strip("_"): f for f in (
    _bandwidth, _latency, _compile, _occupancy, _indeterminate, _overflow, _eliding, _batch,
    _batch_chunks_only, _sharded_legacy, _sharded_counter_fallback, _sharded_partitioned,
    _single_arg_floor, _empty)}


@pytest.mark.parametrize("case", list(CASES))
def test_attribute_matches_reference(case):
    """The same events in each package's registry: equal attribution maps."""
    preg, rreg = PRegistry(), RRegistry()
    kw = CASES[case](preg)
    CASES[case](rreg)
    got, want = p_profile.attribute(preg, **kw), r_profile.attribute(rreg, **kw)
    assert _canon(got) == _canon(want)
    if case == "empty":
        assert got == {}
    if case == "bandwidth":
        (c,) = got["device"]["chunks"]
        assert (c["bound"], c["util"], c["achieved_gbs"]) == ("bandwidth", 0.5, 5.0)
    if case == "eliding":
        assert got["device"]["summary"]["chunks_elided"] == 80


def test_a_byte_floor_that_raises_propagates():
    """A ``TypeError`` inside the byte-floor callable is the callable's
    own, not a signature mismatch: it propagates in both packages."""
    for reg_cls, prof in ((PRegistry, p_profile), (RRegistry, r_profile)):
        reg = reg_cls()
        reg.event("wgl_sharded_chunk", level=4, F=32, n_shards=2, wall_s=0.1,
                  exchange="alltoall", exchange_bytes=10)

        def floor(F, **kw):
            raise TypeError("inside the model")

        with pytest.raises(TypeError, match="inside the model"):
            prof.attribute(reg, byte_floor=floor)


# ---------------------------------------------------------------------------
# trace_capture, memory_watermarks, store_profile


def test_trace_capture_writes_a_chrome_trace(tmp_path):
    with p_profile.trace_capture(tmp_path / "trace") as d:
        assert d == str(tmp_path / "trace")
        x = torch.arange(64, dtype=torch.float32)
        for _ in range(3):
            x = x * 2 + 1
    doc = json.loads((tmp_path / "trace" / p_profile.TRACE_FILE).read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"aten::mul", "aten::add"} <= names


def test_trace_capture_that_cannot_start_runs_the_body_unprofiled(tmp_path, monkeypatch,
                                                                  caplog):
    import torch.profiler

    def refuse(*a, **kw):
        raise RuntimeError("profiler already running")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    ran = []
    with caplog.at_level(logging.WARNING, logger="jepsen.telemetry.profile"):
        with p_profile.trace_capture(tmp_path / "t") as d:
            ran.append(d)
    assert ran == [None]
    assert "profiler already running" in caplog.text
    assert not (tmp_path / "t" / p_profile.TRACE_FILE).exists()


def test_trace_capture_lets_the_body_error_through(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with p_profile.trace_capture(tmp_path / "t"):
            torch.ones(4).sum()
            1 / 0
    # the profiler still stopped and exported what it saw
    assert (tmp_path / "t" / p_profile.TRACE_FILE).exists()
    with p_profile.trace_capture(tmp_path / "again") as d:
        assert d is not None


def test_memory_watermarks_one_entry_per_card():
    marks = p_profile.memory_watermarks()
    if not torch.cuda.is_available():
        assert marks == []
        return
    assert [m["device"] for m in marks] == [f"cuda:{d}"
                                            for d in range(torch.cuda.device_count())]
    for m in marks:
        assert 0 <= m["bytes_in_use"] <= m["peak_bytes_in_use"] <= m["bytes_limit"]


def _stored_test(root, reg):
    return {"name": "prof", "start-time": "20260101T000000.000Z", "store-root": str(root),
            "telemetry-registry": reg}


def test_store_profile_writes_what_the_reference_writes(tmp_path):
    from jepsen_tpu.telemetry import profile as rp

    preg, rreg = PRegistry(), RRegistry()
    for reg in (preg, rreg):
        _eliding(reg)
        _batch(reg)
    path = p_profile.store_profile(_stored_test(tmp_path / "p", preg), copy_bw_gbs=3000.0,
                                   extra={"note": 1})
    rpath = rp.store_profile(_stored_test(tmp_path / "r", rreg), copy_bw_gbs=3000.0,
                             extra={"note": 1})
    got, want = json.loads(open(path).read()), json.loads(open(rpath).read())
    assert path.endswith("prof/20260101T000000.000Z/profile.json")
    assert set(got) == set(want) == {"generated_at", "attribution", "memory_watermarks", "note"}
    assert got["attribution"] == want["attribution"]
    if not torch.cuda.is_available():
        assert got["memory_watermarks"] == []
    assert not [p for p in (tmp_path / "p").rglob("*.tmp")]
    # no store, or no registry: nothing written, in both packages
    for prof, reg in ((p_profile, PRegistry()), (rp, RRegistry())):
        assert prof.store_profile({"name": "x"}, registry=reg) is None
        assert prof.store_profile({"name": "x", "start-time": "t", "no-store?": True},
                                  registry=reg) is None
        assert prof.store_profile({"name": "x", "start-time": "t"}) is None


def test_telemetry_exports_the_profile_layer():
    for name in ("attribute", "memory_watermarks", "store_profile", "trace_capture",
                 "profile"):
        assert name in p_telemetry.__all__ and hasattr(p_telemetry, name)


# ---------------------------------------------------------------------------
# core.run with profile?, live-port and the online monitor


def _run_test(root, n_ops=120, **extra):
    state = p_wl.AtomState()
    test = dict(p_wl.noop_test())
    g = p_gen
    test.update(
        name="profiled", nodes=["n1", "n2"], concurrency=4, db=p_wl.AtomDB(state),
        client=p_wl.AtomClient(state, latency=0.001), model=PCas(init=0),
        # no stats checker: a short run may see no cas succeed, which stats
        # calls unknown
        checker=p_checker.compose({"linear": p_checker.linearizable(model=PCas(init=0),
                                                                    device="cpu")}),
        generator=g.clients(g.limit(n_ops, g.mix([
            lambda: {"f": "write", "value": g.rand_int(5)},
            lambda: {"f": "cas", "value": [g.rand_int(5), g.rand_int(5)]},
            lambda: {"f": "read"}]))),
        **{"store-root": str(root), "device": "cpu", "online?": True,
           "online-engine": "device", "telemetry?": True})
    test.update(extra)
    return test


class _CrashOnce(p_wl.AtomClient):
    """The atom register's client, one reply of which is lost: the op stays
    ``:info``, so the stream never quiesces after it and the monitor's
    device oracle decides the tail."""

    def __init__(self, state, calls):
        super().__init__(state, latency=0.001)
        self.calls = calls

    def invoke(self, test, op):
        res = super().invoke(test, op)
        with self.calls["lock"]:
            self.calls["n"] += 1
            lost = self.calls["n"] == 10
        if lost:
            raise TimeoutError("reply lost")
        return res


def test_profiled_run_with_a_live_server(tmp_path, monkeypatch):
    """``profile?``, ``live-port: 0`` and ``online?``: the monitor's line is
    on ``/live`` while the run executes; ``profile.json`` holds the
    reference's attribution of the run's registry and no watermarks (no
    card); the trace is in ``profile_trace/``; the ledger record carries
    the utilization; the server and the live source are gone after."""
    monkeypatch.delenv("JEPSEN_LEDGER_PATH", raising=False)
    servers = []
    orig = p_web.server

    def local_server(root=None, port=8080, host=""):
        srv = orig(root, port, host="127.0.0.1")
        servers.append(srv)
        return srv

    monkeypatch.setattr(p_web, "server", local_server)
    lines, stop = [], threading.Event()

    def poll():
        deadline = time.monotonic() + 120
        while not stop.is_set() and time.monotonic() < deadline:
            if servers:
                url = f"http://127.0.0.1:{servers[0].server_address[1]}/live"
                try:
                    with urllib.request.urlopen(url, timeout=5) as r:
                        line = json.loads(r.read().decode().splitlines()[0])
                    if "ops_observed" in line:
                        lines.append(line)
                        return
                except OSError:
                    pass
            time.sleep(0.01)

    state = p_wl.AtomState()
    test = _run_test(tmp_path, n_ops=200, **{"profile?": True, "live-port": 0})
    test["client"] = _CrashOnce(state, {"n": 0, "lock": threading.Lock()})
    test["db"] = p_wl.AtomDB(state)
    poller = threading.Thread(target=poll)
    poller.start()
    try:
        res = p_core.run(test)
    finally:
        stop.set()
        poller.join(timeout=30)
    assert not poller.is_alive()
    assert res["results"]["valid"] is True and res["online-results"]["valid"] is True
    assert lines and lines[0]["run"] == "profiled"
    assert p_web.live_snapshots() == []
    assert servers[0].socket.fileno() == -1  # shut down and closed

    run_dir = p_store.path(res)
    doc = json.loads((run_dir / "profile.json").read_text())
    reg = res["telemetry-registry"]
    assert doc["attribution"] == _canon(r_profile.attribute(reg))
    assert doc["attribution"]["batch"]["rungs"]
    assert doc["attribution"]["device"]["chunks"]
    util = doc["attribution"]["utilization"]["summary"]
    assert 0 < util["mean_utilization_pct"] <= 100
    assert doc["memory_watermarks"] == ([] if not torch.cuda.is_available() else
                                        doc["memory_watermarks"])
    assert (run_dir / "profile_trace" / p_profile.TRACE_FILE).exists()
    (rec,) = p_ledger.load(tmp_path / "ledger.jsonl")
    assert rec["utilization_pct"] == util["mean_utilization_pct"]
    assert rec["verdict"] == "True" and rec["ops"] == 400


def test_analyze_alone_writes_the_profile(tmp_path):
    """``core.analyze`` of a stored run with ``profile?`` (the CLI's
    ``analyze --profile``) writes ``profile.json`` beside the results."""
    res = p_core.run(_run_test(tmp_path, n_ops=40, **{"online?": False}))
    run_dir = p_store.path(res)
    assert not (run_dir / "profile.json").exists()
    stored = p_store.load_test(res["name"], res["start-time"], root=tmp_path)
    stored.update(checker=res["checker"], **{"profile?": True, "telemetry?": True,
                                             "store-root": str(tmp_path)})
    stored.pop("telemetry-registry", None)
    out = p_core.analyze(stored)
    assert out["results"]["valid"] is True
    doc = json.loads((run_dir / "profile.json").read_text())
    assert doc["attribution"] == _canon(r_profile.attribute(out["telemetry-registry"]))
    assert doc["attribution"]["device"]["chunks"]
