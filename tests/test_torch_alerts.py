"""The port's alerting plane (``jepsen_tpu_torch.telemetry.alerts``, the
``alerts`` CLI shim and ``ledger --alerts``) against the reference's.

Every predicate of the catalogue over the reference's synthetic contexts
(and over the empty one) gives the reference's evidence; the catalogues,
thresholds and the chaos matrix (``EXPECTED_ALERTS``, keyed by the port's
chaos seams) are the reference's; one sequence of evaluations drives both
engines through the same lifecycle records; each package replays the
other's ``alerts.jsonl`` (with a torn tail) to the same firing set; the
CUSUM sentinel raises the same findings on the same series; the sinks
write and retry the same way; the CLI prints the same lines; a service
under the ``journal.fsync`` fault fires the reference's alerts, a clean
one none; and ``ledger --check --alerts`` appends the reference's
records."""

from __future__ import annotations

import json
import math
import random
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from jepsen_tpu.telemetry import Registry as RRegistry
from jepsen_tpu.telemetry import alerts as r_alerts
from jepsen_tpu.telemetry import ledger as r_ledger
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.service import Service
from jepsen_tpu_torch.service.client import InProcessServiceClient
from jepsen_tpu_torch.telemetry import Registry as PRegistry
from jepsen_tpu_torch.telemetry import alerts as p_alerts
from jepsen_tpu_torch.telemetry import ledger as p_ledger
from jepsen_tpu_torch.testing import chaos, chunked_register_history

ROOT = Path(__file__).resolve().parent.parent


def _hist_samples(reg_cls, fast, slow):
    reg = reg_cls()
    h = reg.histogram("decision_latency_seconds", buckets=(0.001, 0.01, 0.1, 1.0))
    for _ in range(fast):
        h.observe(0.0005)
    for _ in range(slow):
        h.observe(0.5)
    return reg.collect()


def contexts():
    """The reference's synthetic contexts, and a few at each threshold."""
    slo_hot = {"windows": {"fast": {"availability_burn_rate": 20.0, "latency_burn_rate": 1.0},
                           "slow": {"availability_burn_rate": 2.0, "latency_burn_rate": 7.0}}}
    at = r_alerts
    return {
        "empty": {},
        "slo_hot": {"slo": slo_hot},
        "slo_edge": {"slo": {"windows": {"fast": {"availability_burn_rate":
                                                  at.SLO_FAST_BURN_THRESHOLD},
                                         "slow": {"latency_burn_rate": "x"}}}},
        "stale": {"fleet": {"stale_backends": ["b1", "b0"],
                            "federation": {"b0": {"scrape_age_s": 9.0}}}},
        "respawn_gave_up": {"fleet": {"configured_backends": 3, "live_backends": 1,
                                      "respawn_disabled": False, "respawn_gave_up": ["b2"]}},
        "respawn_healing": {"fleet": {"configured_backends": 3, "live_backends": 1,
                                      "respawn_disabled": False, "respawn_gave_up": []}},
        "respawn_disabled": {"fleet": {"configured_backends": 2, "live_backends": 1,
                                       "respawn_disabled": True}},
        "journal": {"health": {"tenants": {
            "t0": {"journal_append_failures": 3},
            "t1": {"journal_lag_ops": at.JOURNAL_LAG_ALERT_OPS + 1},
            "ok": {"journal_lag_ops": 5}, "junk": 7}},
            "samples": [{"name": "journal_lag_ops", "type": "gauge",
                         "labels": {"tenant": "t2"}, "value": at.JOURNAL_LAG_ALERT_OPS * 2}]},
        "stall": {"samples": [{"name": "online_watermark_stall_seconds", "type": "gauge",
                               "labels": {}, "value": at.WATERMARK_STALL_ALERT_S + 5},
                              {"name": "online_watermark_stall_seconds", "type": "gauge",
                               "labels": {"tenant": "a"}, "value": 1.0}]},
        "circuit": {"samples": [{"name": "circuit_state", "type": "gauge",
                                 "labels": {"device": "d0"}, "value": 2},
                                {"name": "circuit_state", "type": "gauge",
                                 "labels": {"device": "d1"}, "value": 0}]},
        "canary": {"samples": [{"name": "verdict_causes_total",
                                "labels": {"code": "unattributed", "tenant": "t0"}, "value": 2}],
                   "health": {"provenance": {"unattributed": 1}}},
        "tail": {"samples": _hist_samples(RRegistry, 98, 2)},
        "tail_port_registry": {"samples": _hist_samples(PRegistry, 98, 2)},
        "tail_healthy": {"samples": _hist_samples(PRegistry, 50, 50)},
        "sentinel": {"sentinel": [{"series": "s", "shift": "down", "value": 1.0,
                                   "baseline": 10.0, "regression": True, "t": 1.0}, "junk"]},
    }


@pytest.mark.parametrize("ctx_name", sorted(contexts()))
def test_every_predicate_matches_reference(ctx_name):
    ctx = contexts()[ctx_name]
    rr, pr = r_alerts.catalogue(), p_alerts.catalogue()
    assert [r.describe() for r in pr] == [r.describe() for r in rr]
    for r, p in zip(rr, pr):
        assert p.predicate(ctx) == r.predicate(ctx), r.name
    assert p_alerts.decision_tail(ctx.get("samples")) == \
        r_alerts.decision_tail(ctx.get("samples"))


def test_shared_predicates_thresholds_and_matrix():
    for name in ("SEVERITIES", "STATES", "SLO_FAST_BURN_THRESHOLD", "SLO_SLOW_BURN_THRESHOLD",
                 "TAIL_RATIO_THRESHOLD", "JOURNAL_LAG_ALERT_OPS", "WATERMARK_STALL_ALERT_S",
                 "ALERT_EVAL_INTERVAL_S", "REGRESSION_ACTIVE_S", "EXPECTED_ALERTS"):
        assert getattr(p_alerts, name) == getattr(r_alerts, name), name
    assert set(p_alerts.EXPECTED_ALERTS) == set(chaos.POINTS)
    names = {r.name for r in p_alerts.catalogue()}
    for point, allowed in p_alerts.EXPECTED_ALERTS.items():
        assert allowed <= names and "unattributed_causes" not in allowed, point
    for fn, args in ((p_alerts.slo_hot_windows, (None,)),
                     (p_alerts.stale_backend_list, ("x",)),
                     (p_alerts.journal_gap_count, ({"journal_gap": 4},)),
                     (p_alerts.journal_gap_count, ({"other": 1},)),
                     (p_alerts.tail_is_pathological, (0.001, 0.5)),
                     (p_alerts.tail_is_pathological, (0.1, 0.5)),
                     (p_alerts.tail_is_pathological, (0.0, 0.5))):
        assert fn(*args) == getattr(r_alerts, fn.__name__)(*args)
    for bad in ({"severity": "loud"}, {"for_s": -1.0}):
        for mod in (r_alerts, p_alerts):
            kw = dict({"severity": "medium"}, **bad)
            with pytest.raises(ValueError):
                mod.AlertRule("r", predicate=lambda c: None, **kw)


def _rules(mod, **kw):
    return [mod.AlertRule(n, "medium", (lambda ctx, n=n: ctx.get(n)), **kw)
            for n in ("a", "b")]


SCRIPT = [({"a": {"x": 1}}, 1.0), ({"a": {"x": 2}, "b": {"y": 1}}, 2.0), ({"b": {"y": 2}}, 3.0),
          ({}, 4.0), ({"a": {"x": 3}}, 5.0), ({"a": {"x": 3}}, 9.0), ({}, 10.0), ({}, 20.0)]


@pytest.mark.parametrize("hold", [{}, {"for_s": 2.0}, {"resolve_for_s": 3.0},
                                  {"for_s": 1.0, "resolve_for_s": 1.0}])
def test_lifecycle_records_match_reference(hold, tmp_path):
    outs = {}
    for name, mod, reg in (("ref", r_alerts, RRegistry()), ("port", p_alerts, PRegistry())):
        path = tmp_path / f"{name}.jsonl"
        eng = mod.AlertEngine(_rules(mod, **hold), metrics=reg, path=str(path), source="s")
        trans = [eng.evaluate(ctx, now=now) for ctx, now in SCRIPT]
        snap = eng.snapshot()
        outs[name] = (trans, eng.firing(), sorted(eng.fired_rules()), eng.history(),
                      {k: v for k, v in snap.items() if k not in ("eval_seconds", "path")},
                      sorted((s["name"], tuple(sorted(s["labels"].items())), s.get("value"))
                             for s in reg.collect() if s["name"].startswith("alert")))
        eng.close()
        outs[name] += (path.read_text(),)
    assert outs["port"] == outs["ref"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_replays_the_others_alerts_file(writer, tmp_path):
    """Two restarts over one alerts.jsonl, each after a torn final line:
    the firing set and the generations are the writer's in both readers."""
    W = r_alerts if writer == "ref" else p_alerts
    path = tmp_path / "alerts.jsonl"
    eng = W.AlertEngine(_rules(W), path=str(path))
    for ctx, now in SCRIPT[:5]:
        eng.evaluate(ctx, now=now)
    eng.close()
    with open(path, "a") as f:
        f.write('{"rule": "a", "sta')
    got = {}
    for name, mod in (("ref", r_alerts), ("port", p_alerts)):
        folded = mod.replay(str(path))
        got[name] = folded
        e2 = mod.AlertEngine(_rules(mod), path=str(tmp_path / f"copy-{name}.jsonl"))
        e2.close()
    assert got["port"] == got["ref"]
    assert got["port"]["torn"] is True and sorted(got["port"]["firing"]) == ["a"]
    # reopen the torn file with each package's engine (it trims the tail)
    for mod in (p_alerts, r_alerts):
        e = mod.AlertEngine(_rules(mod), path=str(path))
        assert sorted(e.firing()) == ["a"] and e.replayed >= 1
        assert e.firing()["a"]["generation"] == 2
        e.close()
    e = p_alerts.AlertEngine(_rules(p_alerts), path=str(path))
    assert e.evaluate({}, now=30.0)[0]["state"] == "resolved"
    e.close()
    assert r_alerts.replay(str(path)) == p_alerts.replay(str(path))
    assert r_alerts.replay(str(path))["firing"] == {}


def _series(kind, n=60, seed=3):
    rng = random.Random(seed)
    if kind == "step_up":
        return [rng.gauss(10, 1) for _ in range(30)] + [rng.gauss(14, 1) for _ in range(n)]
    if kind == "step_down":
        return [rng.gauss(10, 1) for _ in range(30)] + [rng.gauss(6, 1) for _ in range(n)]
    if kind == "drift":
        return [10 + i * 0.08 + rng.gauss(0, 0.5) for i in range(2 * n)]
    if kind == "flat":
        return [5.0] * 20 + [5.0001] * 10 + [6.0] * 5
    if kind == "nonfinite":
        return [1.0] * 15 + [math.nan, math.inf, "x", None] + [1.0] * 5
    return [rng.gauss(10, 1) for _ in range(2 * n)]


@pytest.mark.parametrize("kind", ["step_up", "step_down", "drift", "noise", "flat", "nonfinite"])
def test_cusum_and_sentinel_match_reference(kind):
    xs = _series(kind)
    outs = {}
    for name, mod in (("ref", r_alerts), ("port", p_alerts)):
        c = mod.Cusum()
        shifts = []
        for x in xs:
            if isinstance(x, (int, float)):
                shifts.append(c.update(x))
        s = mod.RegressionSentinel()
        finds = [s.observe("thr", x, lower_is_better=False, t=float(i))
                 for i, x in enumerate(xs)]
        finds += [s.observe("lat", x, lower_is_better=True, t=float(i))
                  for i, x in enumerate(xs)]
        outs[name] = (shifts, finds, s.active(now=float(len(xs))), s.active(now=1e9))
    assert outs["port"] == outs["ref"]


def test_sentinel_observe_ledger_matches_reference():
    rng = random.Random(9)
    recs = []
    for i in range(40):
        recs.append({"kind": "bench", "workload": "w", "engine": "device", "ts": i,
                     "ops_per_s": 1000.0 + rng.gauss(0, 5) - (300 if i > 25 else 0),
                     "p99_decision_latency_s": 0.1 + rng.gauss(0, 0.001)})
    got = [mod.RegressionSentinel().observe_ledger(recs, now=100.0)
           for mod in (r_alerts, p_alerts)]
    assert got[0] == got[1] and got[1]


def test_sinks_match_reference(tmp_path):
    hits = []

    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            hits.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(503 if len(hits) % 2 == 1 else 200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    got = {}
    try:
        for name, mod in (("ref", r_alerts), ("port", p_alerts)):
            target = tmp_path / name / "alerts.ndjson"
            sink = mod.AlertSink(str(target))
            rows = [sink.emit({"rule": "r", "state": s}) for s in ("firing", "resolved")]
            slept = []
            http = mod.AlertSink(f"http://127.0.0.1:{srv.server_address[1]}/hook",
                                 base_backoff_s=0.01, sleep=slept.append)
            down = mod.AlertSink("http://127.0.0.1:1/hook", max_retries=3,
                                 base_backoff_s=0.01, sleep=slept.append)
            got[name] = (rows, target.read_text(), sink.emitted, sink.failures,
                         http.emit({"rule": "r", "state": "firing"}),
                         {k: v for k, v in down.emit({"rule": "r"}).items() if k != "error"},
                         slept, down.failures)
    finally:
        srv.shutdown()
        srv.server_close()
    assert got["port"] == got["ref"]
    assert got["port"][4] == {"ok": True, "status": 200, "attempts": 2}


def _write_alerts(mod, path):
    eng = mod.AlertEngine(_rules(mod), path=str(path))
    eng.evaluate({"a": {"on": 1}, "b": {"on": 1}}, now=1.0)
    eng.evaluate({"a": {"on": 1}}, now=2.0)
    eng.close()


@pytest.mark.parametrize("args", [[], ["--firing"], ["--json"], ["--json", "--firing"],
                                  ["MISSING"]])
def test_cli_matches_reference(tmp_path, capsys, args):
    path = tmp_path / "alerts.jsonl"
    _write_alerts(r_alerts, path)
    argv = [str(tmp_path / "no.jsonl") if a == "MISSING" else a for a in args]
    if "MISSING" not in args:
        argv = [str(path)] + argv
    outs = []
    for mod in (r_alerts, p_alerts):
        code = mod.main(list(argv))
        cap = capsys.readouterr()
        outs.append((code, cap.out, cap.err.replace("jepsen_tpu_torch", "jepsen_tpu")))
    assert outs[1] == outs[0]


def test_python_m_alerts(tmp_path):
    path = tmp_path / "alerts.jsonl"
    _write_alerts(p_alerts, path)
    env_path = str(ROOT)
    r = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.alerts", str(path), "--firing"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120,
                       env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"})
    assert r.returncode == 1, r.stderr
    assert "FIRING" in r.stdout and "jax" not in r.stderr


def _service_run(tmp_path, inject):
    reg = PRegistry()
    svc = Service(CasRegister(), engine="host", device="cpu", metrics=reg,
                  register_live=False, ledger=False, journal_dir=str(tmp_path / "j"),
                  alerts=True, alerts_path=str(tmp_path / "alerts.jsonl"))
    h = History(list(chunked_register_history(random.Random(71), n_ops=240, n_procs=4,
                                              chunk_ops=60)), reindex=True)
    try:
        if inject:
            with chaos.inject("journal.fsync", mode="raise", on_call=2, times=1_000_000):
                InProcessServiceClient(svc, "t0").feed(h)
                svc.flush(60.0)
        else:
            InProcessServiceClient(svc, "t0").feed(h)
            svc.flush(60.0)
        fin = svc.drain(timeout=60)
    finally:
        chaos.reset()
    return svc, fin


def test_service_journal_fault_fires_only_expected_alerts(tmp_path):
    svc, fin = _service_run(tmp_path, True)
    fired = svc.alert_engine.fired_rules()
    assert "journal_errors" in fired
    assert fired <= p_alerts.EXPECTED_ALERTS["journal.fsync"]
    assert fin["tenants"]["t0"]["valid"] is True
    assert "journal_errors" in p_alerts.replay(str(tmp_path / "alerts.jsonl"))["firing"]
    assert "journal_errors" in r_alerts.replay(str(tmp_path / "alerts.jsonl"))["firing"]
    snap = svc.alerts_snapshot()
    assert snap["service"] == "service" and "journal_errors" in snap["firing"]


def test_service_clean_run_fires_nothing(tmp_path):
    svc, fin = _service_run(tmp_path, False)
    assert svc.alert_engine.fired_rules() == set()
    assert svc.alert_engine.evaluations >= 1
    assert fin["tenants"]["t0"]["valid"] is True
    assert p_alerts.replay(str(tmp_path / "alerts.jsonl"))["firing"] == {}
    off = Service(CasRegister(), engine="host", device="cpu", register_live=False,
                  ledger=False)
    assert off.alert_engine is None
    assert off.alerts_snapshot() == {"enabled": False, "service": "service"}
    off.drain(timeout=10)


def test_ledger_alerts_appends_the_references_records(tmp_path, capsys):
    """``ledger --check --alerts FILE``: the port appends the reference's
    ``perf_regression`` records (wall stamps aside), continuing the file's
    generations; without ``--check`` nothing is written."""
    recs = [{"kind": "run", "workload": w, "engine": "device", "ts": t, "value_s": v}
            for w in ("w1", "w2") for t, v in ((1, 1.0), (2, 2.0), (3, 4.0))]
    path = tmp_path / "ledger.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    outs = {}
    for name, mod in (("ref", r_ledger), ("port", p_ledger)):
        alerts = tmp_path / f"{name}-alerts.jsonl"
        codes = [mod.main(["--alerts", str(alerts), str(path)]),
                 mod.main(["--check", "--alerts", str(alerts), str(path)]),
                 mod.main(["--check", "--alerts", str(alerts), "--threshold", "0.5", str(path)])]
        out = capsys.readouterr().out.replace("jepsen_tpu_torch", "jepsen_tpu")
        lines = [{k: v for k, v in json.loads(x).items() if k != "t"}
                 for x in alerts.read_text().splitlines()]
        outs[name] = (codes, out, lines)
    assert outs["port"] == outs["ref"]
    assert outs["port"][0] == [0, 1, 1]
    assert [r["generation"] for r in outs["port"][2]] == [1, 2, 3, 4]
    assert {r["rule"] for r in outs["port"][2]} == {"perf_regression"}


def test_append_finding_continues_generations(tmp_path):
    path = tmp_path / "a.jsonl"
    _write_alerts(r_alerts, path)
    rec = p_alerts.append_finding(str(path), {"k": 1}, rule="a", now=5.0)
    assert rec["generation"] == 2 and rec["state"] == "firing"
    assert r_alerts.replay(str(path)) == p_alerts.replay(str(path))
    (tmp_path / "dir").mkdir()
    assert p_alerts.append_finding(str(tmp_path / "dir"), {}) is None  # never raises
