"""The port's multi-tenant checking service (``jepsen_tpu_torch.service``)
against the reference's (``jepsen_tpu.service``).

The same seeded tenant streams, drawn by both packages' generators, go
through both services; per tenant the verdict, watermark, fold counters,
abort and detection fields and the violation must agree, and the drain
documents must carry the same keys. Streams whose abort point is
compared are paced (each op is decided before the next is sent), so the
op an abort lands on does not depend on the decider thread's speed. The
admission, backpressure, drain and ledger cases run in both packages with
the same inputs and must end the same way. The co-batching case runs the
port's device engine on the CPU (``device="cpu"``, the plain versions of
the kernels): one device round holds members of two tenants, and one
batched chunk carries both. Without a card, a service whose engine can
reach the device oracle does not start unless it is given the CPU, and a
deterministic device error of a round is raised out of ``flush`` and
``drain`` (and the CLI exits 255)."""

from __future__ import annotations

import json
import random
import threading
import time

import pytest
import torch

from jepsen_tpu import service as r_service
from jepsen_tpu import testing as r_testing
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.history import Op as ROp
from jepsen_tpu.models import CasRegister as RCas
from jepsen_tpu.ops import wgl as r_wgl
from jepsen_tpu.telemetry import Registry as RRegistry
from jepsen_tpu.telemetry import ledger as r_ledger
from jepsen_tpu_torch import service as p_service
from jepsen_tpu_torch import testing as p_testing
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import Op as POp
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.online.scheduler import SegmentScheduler
from jepsen_tpu_torch.parallel import resilience
from jepsen_tpu_torch.service import __main__ as p_main
from jepsen_tpu_torch.telemetry import Registry as PRegistry
from jepsen_tpu_torch.telemetry import ledger as p_ledger

REF = dict(service=r_service, testing=r_testing, History=RHistory, Op=ROp, Cas=RCas,
           Registry=RRegistry, ledger=r_ledger)
PORT = dict(service=p_service, testing=p_testing, History=PHistory, Op=POp, Cas=PCas,
            Registry=PRegistry, ledger=p_ledger)
PKGS = {"ref": REF, "port": PORT}

MC = 2000  # the shared budget under which the mix lands valid/invalid/unknown


@pytest.fixture(autouse=True)
def _one_thread(tmp_path, monkeypatch):
    """One torch thread, and the CLI's ledger records in the test's own
    directory."""
    monkeypatch.setenv("JEPSEN_LEDGER_PATH", str(tmp_path / "cli-ledger.jsonl"))
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    resilience.reset_breakers()
    yield
    torch.set_num_threads(n)
    resilience.reset_breakers()


def mk(pkg, **kw):
    """A service without the process-wide side effects (the live source,
    the store's ledger); the port's on the CPU."""
    kw.setdefault("engine", "host")
    kw.setdefault("register_live", False)
    kw.setdefault("ledger", False)
    if pkg is PORT:
        kw.setdefault("device", "cpu")
    return pkg["service"].Service(pkg["Cas"](init=0), **kw)


def valid_history(pkg, seed, n_ops=200, n_procs=2, chunk_ops=30):
    return pkg["testing"].chunked_register_history(random.Random(seed), n_ops=n_ops,
                                                   n_procs=n_procs, chunk_ops=chunk_ops)


def mixed(pkg):
    T = pkg["testing"]
    return {
        "valid-a": valid_history(pkg, 21),
        "valid-b": valid_history(pkg, 22),
        "invalid": T.perturb_history(random.Random(7), valid_history(pkg, 23)),
        # wide concurrency and open intervals: the enumerator trips MC
        "overflow": T.random_register_history(random.Random(24), n_ops=120, n_procs=10,
                                              crash_p=0.2),
    }


def paced_feed(svc, tenant, history, aborted_error):
    """Submit op by op, each decided before the next is sent; stop at the
    tenant's abort."""
    for op in history:
        try:
            svc.submit(tenant, op)
        except aborted_error:
            return
        deadline = time.monotonic() + 30
        while True:
            snap = svc.tenant_snapshot(tenant)
            if (snap["ops_observed"] == snap["ops_ingested"]
                    and svc.scheduler.stream_backlog(tenant) == 0):
                break
            assert time.monotonic() < deadline, "op not decided in 30 s"
            time.sleep(0.0005)


def _scrub(x):
    if isinstance(x, dict):
        return {k: _scrub(v) for k, v in x.items()
                if k not in ("wall_s", "trace_span", "seconds_to_detection", "t")}
    if isinstance(x, list):
        return [_scrub(v) for v in x]
    return x


def run_mixed(pkg):
    hs = mixed(pkg)
    reg = pkg["Registry"]()
    svc = mk(pkg, metrics=reg, max_configs=MC, abort_on_violation=True)
    err = pkg["service"].TenantAbortedError
    threads = [threading.Thread(target=paced_feed, args=(svc, n, h, err))
               for n, h in hs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert svc.flush(60.0)
    stats = {n: svc.scheduler.stream_stats(n) for n in hs}
    fin = svc.drain(timeout=60)
    return hs, reg, stats, fin


def test_four_tenant_mixed_differential():
    """Four concurrent tenants (two valid, one seeded invalid that aborts,
    one over the budget): the port's per-tenant folds equal the
    reference's, and each equals the single search on that history."""
    out = {name: run_mixed(pkg) for name, pkg in PKGS.items()}
    hs, _reg, rstats, rfin = out["ref"]
    _hs, preg, pstats, pfin = out["port"]
    want = {n: r_wgl.check_history(RCas(init=0), h, backend="host",
                                   host_max_configs=MC)["valid"] for n, h in hs.items()}
    assert want == {"valid-a": True, "valid-b": True, "invalid": False,
                    "overflow": "unknown"}
    assert {n: pfin["tenants"][n]["valid"] for n in hs} == want
    assert pfin["valid"] is rfin["valid"] is False
    keys = ("valid", "decided_through_index", "segments_decided", "aborted",
            "ops_observed", "ops_ingested", "ops_to_detection", "rejected", "provenance")
    for n in hs:
        r, p = rfin["tenants"][n], pfin["tenants"][n]
        assert {k: p.get(k) for k in keys} == {k: r.get(k) for k in keys}, n
        assert _scrub(p.get("violation")) == _scrub(r.get("violation")), n
        assert _scrub(p["segments"]) == _scrub(r["segments"]), n
        assert set(p) == set(r), n
        assert set(p["decision_latency"]) == set(r["decision_latency"])
        for k in ("segments_decided", "segments_invalid", "segments_unknown",
                  "decided_through_index", "backlog"):
            assert pstats[n][k] == rstats[n][k], (n, k)
    assert set(pfin) == set(rfin)
    assert pfin["tenants"]["invalid"]["aborted"] is True
    assert pfin["tenants"]["invalid"]["violation"]["segment"]["start_index"] == \
        rfin["tenants"]["invalid"]["violation"]["segment"]["start_index"]
    for n in ("valid-a", "valid-b"):
        assert pfin["tenants"][n]["decided_through_index"] == hs[n][-1].index
        assert pfin["tenants"][n]["decision_latency"]["count"] > 0
    assert preg.events("online_round")


def poisoned(pkg, seed, n_ops=100):
    """A valid stream whose quiescence is poisoned halfway (an ok write
    turned :info): the rest is one terminal segment, the kind the device
    oracle decides."""
    base = list(valid_history(pkg, seed, n_ops=n_ops))
    k = next(j for j in range(len(base) // 2, len(base))
             if base[j].is_ok and base[j].f == "write")
    base[k] = base[k].with_(type="info")
    return pkg["History"](base, reindex=True)


def test_device_batch_carries_members_of_both_tenants():
    """The device engine on the CPU: the closing round batches both
    tenants' terminal members into one batched search, and the verdicts
    are the reference's single search's."""
    reg = PRegistry()
    svc = mk(PORT, engine="device", batch_f=64, metrics=reg)
    hs = {name: poisoned(PORT, 71 + i) for i, name in enumerate(("dev-a", "dev-b"))}
    for name, h in hs.items():
        for op in h:
            svc.submit(name, op)
    assert svc.flush(120.0)
    fin = svc.drain(timeout=120)
    for i, name in enumerate(("dev-a", "dev-b")):
        want = r_wgl.check_history(RCas(init=0), poisoned(REF, 71 + i), backend="host")
        assert fin["tenants"][name]["valid"] is want["valid"] is True
        assert fin["tenants"][name]["decided_through_index"] == hs[name][-1].index
        assert "failover" not in fin["tenants"][name]
    rounds = [ev for ev in reg.events("online_round") if ev["engine"] == "device"]
    assert rounds, "no device round dispatched"
    assert any(len(ev["oracle_streams"]) >= 2 for ev in rounds)
    chunks = reg.events("wgl_batch_chunk")
    assert chunks and any(ev["batch"] >= 2 for ev in chunks)


# ---------------------------------------------------------------------------
# Admission, backpressure, drain: the same inputs end the same way.


def _outcome(fn, pkg):
    try:
        return ("ok", fn())
    except pkg["service"].ServiceError as e:
        return (type(e).__name__, e.http_status, e.code)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_max_tenants_typed_reject(pkg):
    P = PKGS[pkg]
    svc = mk(P, max_tenants=2)
    try:
        svc.submit("a", {"type": "invoke", "process": 0, "f": "read", "value": None,
                         "time": 0})
        svc.register("b")
        with pytest.raises(P["service"].TenantLimitError) as e:
            svc.submit("c", {"type": "invoke", "process": 0, "f": "read", "value": None,
                             "time": 1})
        assert isinstance(e.value, P["service"].AdmissionError)
        assert e.value.http_status == 429
        assert svc.tenants() == ["a", "b"]
    finally:
        svc.drain(timeout=10)


def test_quota_reject_and_refill_match_reference():
    got = {}
    for name, P in PKGS.items():
        svc = mk(P, quota_ops_per_s=50.0, quota_burst=5.0)
        ops = list(valid_history(P, 1, n_ops=20))
        seq = [_outcome(lambda op=op: svc.submit("t", op), P) for op in ops[:6]]
        time.sleep(0.12)
        seq.append(_outcome(lambda: svc.submit("t", ops[5]), P))
        snap = svc.tenant_snapshot("t")
        svc.drain(timeout=10)
        got[name] = (seq, snap["rejected"], snap["ops_ingested"])
    assert got["port"] == got["ref"]
    assert got["port"][0][5] == ("QuotaExceededError", 429, "quota_exceeded")
    assert got["port"][2] == 6


def test_draining_service_rejects_with_typed_error():
    got = {}
    for name, P in PKGS.items():
        svc = mk(P)
        svc.submit("t", {"type": "invoke", "process": 0, "f": "write", "value": 1, "time": 0})
        svc.drain(timeout=10)
        got[name] = _outcome(lambda: svc.submit("t", {"type": "ok", "process": 0, "f": "write",
                                                      "value": 1, "time": 1}), P)
    assert got["port"] == got["ref"] == ("ServiceClosedError", 503, "draining")


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_stalled_consumer_bounds_queue(pkg, monkeypatch):
    """A stalled pump: the bounded queue fills to queue_limit, the next
    submit is a typed 429, and drain still feeds every accepted op."""
    P = PKGS[pkg]
    monkeypatch.setattr(P["service"].Service, "_pump_once", lambda self: False)
    svc = mk(P, queue_limit=10)
    h = list(valid_history(P, 2, n_ops=40))
    for op in h[:10]:
        svc.submit("t", op)
    with pytest.raises(P["service"].IngestQueueFullError) as e:
        svc.submit("t", h[10])
    assert e.value.http_status == 429 and e.value.retry_after_s == 1.0
    snap = svc.tenant_snapshot("t")
    assert snap["queue_depth"] == 10 and snap["rejected"]["queue"] >= 1
    fin = svc.drain(timeout=20)
    assert fin["tenants"]["t"]["ops_observed"] == 10
    assert "undelivered_ops" not in fin["tenants"]["t"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_stalled_consumer_block_mode_times_out(pkg, monkeypatch):
    P = PKGS[pkg]
    monkeypatch.setattr(P["service"].Service, "_pump_once", lambda self: False)
    svc = mk(P, queue_limit=2, backpressure="block", block_timeout_s=0.1)
    h = list(valid_history(P, 3, n_ops=20))
    svc.submit("t", h[0])
    svc.submit("t", h[1])
    t0 = time.monotonic()
    with pytest.raises(P["service"].IngestQueueFullError):
        svc.submit("t", h[2])
    assert time.monotonic() - t0 >= 0.09
    svc.drain(timeout=20)


def test_drain_partial_terminal_and_idempotent():
    """A stream cut mid-flight and one ending in an open invocation: the
    terminal segments fold to the reference's rows."""
    got = {}
    for name, P in PKGS.items():
        svc = mk(P)
        h = list(valid_history(P, 51, n_ops=60))
        for op in h[:len(h) - 3]:
            svc.submit("cut", op)
        base = list(valid_history(P, 52, n_ops=40))
        base.append(P["Op"]("invoke", 0, "write", 3, time=base[-1].time + 1))
        for op in P["History"](base, reindex=True):
            svc.submit("open", op)
        fin = svc.drain(timeout=30)
        assert svc.drain(timeout=1) is fin
        got[name] = {t: (r["valid"], r["decided_through_index"], _scrub(r["segments"]))
                     for t, r in fin["tenants"].items()}
    assert got["port"] == got["ref"]
    assert got["port"]["cut"][0] is True and got["port"]["open"][0] is True
    assert any(r["terminal"] for r in got["port"]["open"][2])


def test_per_tenant_metric_families_match_reference():
    names = {}
    for name, P in PKGS.items():
        reg = P["Registry"]()
        svc = mk(P, metrics=reg)
        for t, seed in (("t-a", 31), ("t-b", 32)):
            for op in valid_history(P, seed, n_ops=60):
                svc.submit(t, op)
        assert svc.flush(30.0)
        fin = svc.drain(timeout=30)
        assert fin["valid"] is True
        names[name] = {(s["name"], tuple(sorted(s["labels"].items())))
                       for s in reg.collect()
                       if s["name"].startswith(("service_", "online_decided", "online_scheduler",
                                                "decision_latency"))}
        for s in reg.collect():
            if s["name"] == "online_scheduler_backlog":
                assert s["value"] == 0
    assert names["port"] == names["ref"]
    assert ("decision_latency_seconds", (("tenant", "t-a"),)) in names["port"]


def test_snapshots_have_the_references_shape():
    shapes = {}
    for name, P in PKGS.items():
        svc = mk(P)
        for t, seed in (("zeta", 81), ("alpha", 82)):
            for op in valid_history(P, seed, n_ops=40):
                svc.submit(t, op)
        assert svc.flush(30.0)
        live, health = svc.live_snapshot(), svc.health_snapshot()
        svc.drain(timeout=30)
        shapes[name] = (sorted(live), list(live["tenants"]),
                        sorted(live["tenants"]["zeta"]), live["tenants"]["zeta"]["verdict"],
                        live["tenants"]["zeta"]["watermark"], sorted(health),
                        health["tenants"])
    assert shapes["port"] == shapes["ref"]
    assert shapes["port"][1] == ["zeta", "alpha"]


def test_ledger_records_match_reference(tmp_path, monkeypatch):
    recs = {}
    for name, P in PKGS.items():
        path = tmp_path / name / "ledger.jsonl"
        monkeypatch.setenv("JEPSEN_LEDGER_PATH", str(path))
        svc = mk(P, ledger=True)
        for t, seed in (("la", 83), ("lb", 84)):
            for op in valid_history(P, seed, n_ops=40):
                svc.submit(t, op)
        assert svc.drain(timeout=30)["valid"] is True
        recs[name] = [{k: v for k, v in r.items()
                       if k not in ("ts", "ops_per_s", "p99_decision_latency_s")}
                      for r in P["ledger"].load(path)]
    assert recs["port"] == recs["ref"]
    assert {r["run"] for r in recs["port"]} == {"service/la", "service/lb"}


def test_live_source_renders_on_the_ports_live_feed():
    """The service registers its ``live_snapshot`` with the port's web
    ``/live`` feed while it runs, and unregisters on drain."""
    from jepsen_tpu_torch import web

    svc = mk(PORT, register_live=True, name="svc-live-test", alerts=True)
    try:
        for op in valid_history(PORT, 85, n_ops=40):
            svc.submit("t", op)
        assert svc.flush(30.0)
        rows = [r for r in web.live_snapshots() if r.get("run") == "svc-live-test"]
        assert len(rows) == 1 and rows[0]["service"] is True
        assert rows[0]["tenants"]["t"]["verdict"] == "True"
        assert rows[0]["alerts"] == []
    finally:
        svc.drain(timeout=30)
    assert not [r for r in web.live_snapshots() if r.get("run") == "svc-live-test"]


# ---------------------------------------------------------------------------
# The device: no silent fallback.


def test_service_without_a_card_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_service.Service(PCas(init=0), register_live=False, ledger=False)
    with pytest.raises(RuntimeError):
        p_service.Service(PCas(init=0), p_service.ServiceConfig(engine="device"),
                          register_live=False, ledger=False)
    svc = mk(PORT, engine="device")
    assert str(svc.device) == "cpu"
    svc.drain(timeout=10)
    assert p_main.main(["--simulate", "1", "--sim-ops", "20"]) == 255


def test_deterministic_device_error_is_raised(monkeypatch, capsys):
    """A failed kernel build or a refused plan in a device round is raised
    out of flush and drain (every call) and the CLI exits 255; no host
    verdict stands in for it."""
    def boom(self, encs):
        raise ValueError("refused plan")

    monkeypatch.setattr(SegmentScheduler, "_decide_device", boom)
    svc = mk(PORT, engine="device")
    for op in poisoned(PORT, 72, n_ops=60):
        svc.submit("t", op)
    with pytest.raises(ValueError, match="refused plan"):
        svc.drain(timeout=30)
    with pytest.raises(ValueError):
        svc.drain(timeout=1)
    assert svc.finished["tenants"]["t"]["valid"] == "unknown"
    capsys.readouterr()
    # a budget of 5 configurations sends every segment to the oracle
    code = p_main.main(["--simulate", "2", "--sim-ops", "60", "--engine", "device",
                        "--max-configs", "5", "--device", "cpu"])
    assert code == 255
    assert "refused plan" in capsys.readouterr().err


def test_open_breaker_failover_shows_in_the_tenants_results():
    """With the ``batch`` breaker open, the device rounds are demoted to the
    host: the verdicts stand, and each tenant whose members were demoted
    says so in its drained row (``failover``); the reference has no such
    key."""
    b = resilience.breaker("batch")
    for _ in range(b.failure_threshold):
        b.record_failure()
    reg = PRegistry()
    svc = mk(PORT, engine="device", metrics=reg)
    for i, name in enumerate(("fo-a", "fo-b")):
        for op in poisoned(PORT, 73 + i, n_ops=60):
            svc.submit(name, op)
    fin = svc.drain(timeout=60)
    demoted = [e for e in reg.events("online_round") if e["oracle_members"]]
    assert demoted and all(e["failover"] and e["engine"] == "host" for e in demoted)
    for name in ("fo-a", "fo-b"):
        row = fin["tenants"][name]
        assert row["valid"] is True
        n = sum(1 for e in demoted if name in e["oracle_streams"])
        assert row["failover"]["rounds"] == n >= 1
        assert row["failover"]["causes"] == {"circuit_open": n}


def test_cli_simulate_exit_codes_match_reference(capsys):
    """``--simulate 3 --sim-invalid 1 --abort-on-violation``: exit 1 in
    both packages with the same per-tenant verdicts and watermarks;
    ``--roll`` to a router that does not answer exits 2 in both."""
    from jepsen_tpu.service import __main__ as r_main

    argv = ["--simulate", "3", "--sim-ops", "200", "--sim-invalid", "1",
            "--abort-on-violation", "--engine", "host"]
    docs = {}
    for name, main, extra in (("ref", r_main.main, []), ("port", p_main.main, ["--device", "cpu"])):
        assert main(argv + extra) == 1
        doc = json.loads(capsys.readouterr().out)
        docs[name] = {t: (r["valid"], r["aborted"]) for t, r in doc["tenants"].items()}
    assert docs["port"] == docs["ref"]
    assert docs["port"]["tenant-0"] == (False, True)
    for main in (r_main.main, p_main.main):
        assert main(["--roll", "http://127.0.0.1:1"]) == 2
        assert "roll failed" in capsys.readouterr().err
    assert p_main.main(["--no-such-flag"]) == 254
