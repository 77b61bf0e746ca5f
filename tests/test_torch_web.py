"""The port's results browser (``web``) against the reference's, over real
in-process HTTP servers bound to ``127.0.0.1`` on free ports: every page
over the same store tree under ``tmp_path`` (a profiled, monitored port
run with its telemetry, trace and ledger record, a run left invalid, one
left unknown, an offline result, degraded-verdict causes, plots and an
unparseable profile), ``/live`` with a registered monitor, the fleet and
alerts pages empty and with a registered source, and the status codes of
``/zip/``, ``/files/`` and unknown paths. Bodies must be equal, with only
the package's name in command hints normalised. Every request has a
timeout and every server is shut down in a ``finally``."""

from __future__ import annotations

import html
import json
import random
import threading
import urllib.error
import urllib.request
from contextlib import contextmanager

import pytest

from jepsen_tpu import web as r_web
from jepsen_tpu.checker import provenance as r_prov
from jepsen_tpu_torch import checker as p_checker
from jepsen_tpu_torch import core as p_core
from jepsen_tpu_torch import generator as p_gen
from jepsen_tpu_torch import store as p_store
from jepsen_tpu_torch import web as p_web
from jepsen_tpu_torch import workloads as p_wl
from jepsen_tpu_torch.checker import provenance as p_prov
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.online import OnlineMonitor
from jepsen_tpu_torch.testing import random_register_history

TAXONOMY_WORDED_OTHERWISE = ("elle_device_oom", "unattributed")
PAGES = ("/", "/index.html", "/metrics", "/profile", "/online", "/utilization", "/runs",
         "/verdicts", "/live.html", "/fleet", "/alerts", "/alerts.json", "/fleet.json",
         "/live", "/metrics/", "/runs/")


@contextmanager
def _serving(web, root):
    srv = web.server(root=root, port=0, host="127.0.0.1") if web is p_web else \
        _ref_server(root)
    t = threading.Thread(target=lambda: srv.serve_forever(poll_interval=0.05), daemon=True)
    t.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def _ref_server(root):
    from http.server import ThreadingHTTPServer
    from pathlib import Path

    return ThreadingHTTPServer(("127.0.0.1", 0), r_web.make_handler(Path(root)))


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=20) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _norm(body: bytes, port: bool = False) -> bytes:
    """The package's name in command hints, and in the port's body the two
    cause descriptions it words otherwise (its Elle closure raises a real
    out-of-memory on the card: divergence 1)."""
    body = body.replace(b"jepsen_tpu_torch", b"jepsen_tpu")
    for code in TAXONOMY_WORDED_OTHERWISE if port else ():
        body = body.replace(html.escape(p_prov.TAXONOMY[code][1]).encode(),
                            html.escape(r_prov.TAXONOMY[code][1]).encode())
    return body


def _both(root, paths):
    out = {}
    with _serving(r_web, root) as rport, _serving(p_web, root) as pport:
        for path in paths:
            out[path] = (_get(rport, path), _get(pport, path))
    return out


def _same(root, paths):
    got = _both(root, paths)
    for path, (ref, port) in got.items():
        assert port[:2] == ref[:2], path
        assert _norm(port[2], port=True) == _norm(ref[2]), path
    return {path: port for path, (_ref, port) in got.items()}


class _LostReply(p_wl.AtomClient):
    def __init__(self, state, calls):
        super().__init__(state, latency=0.0005)
        self.calls = calls

    def invoke(self, test, op):
        res = super().invoke(test, op)
        with self.calls["lock"]:
            self.calls["n"] += 1
            lost = self.calls["n"] == 8
        if lost:
            raise TimeoutError("reply lost")
        return res


def _run(root, name, checker, n_ops=60, **extra):
    state = p_wl.AtomState()
    test = dict(p_wl.noop_test())
    g = p_gen
    test.update(
        name=name, nodes=["n1"], concurrency=3, db=p_wl.AtomDB(state),
        client=_LostReply(state, {"n": 0, "lock": threading.Lock()}), model=PCas(init=0),
        checker=checker,
        generator=g.clients(g.limit(n_ops, g.mix([
            lambda: {"f": "write", "value": g.rand_int(5)}, lambda: {"f": "read"}]))),
        **{"store-root": str(root), "device": "cpu"})
    test.update(extra)
    return p_core.run(test)


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """One store tree every page reads."""
    root = tmp_path_factory.mktemp("store")
    linear = p_checker.compose({"linear": p_checker.linearizable(model=PCas(init=0),
                                                                 device="cpu"),
                                "stats": p_checker.stats()})
    res = _run(root, "cas-register", linear, n_ops=120,
               **{"online?": True, "online-engine": "device", "telemetry?": True,
                  "profile?": True})
    assert res["results"]["valid"] is True
    # a second run of the same test: the ledger's trend has two columns
    _run(root, "cas-register", linear, **{"telemetry?": True, "profile?": True})
    _run(root, "invalid-one", p_checker.checker_fn(lambda t, h, o: {"valid": False}))
    bad = _run(root, "unknown-one", p_checker.checker_fn(lambda t, h, o: {"valid": "unknown"}),
               **{"telemetry?": True})
    d = p_store.path(bad)
    (d / "offline.json").write_text(json.dumps({
        "valid": "unknown", "n_ops": 1000, "engine": "device", "wall_s": 1.5,
        "plan": {"n_items": 12, "n_streams": 3, "plan_seconds": 0.01},
        "utilization": {"mean_utilization_pct": 40.5},
        "streams": {"k1": {"valid": True, "segments_decided": 4, "decide_s": 0.2},
                    "k2": {"valid": "unknown", "segments_decided": 1, "decide_s": 0.9}}}))
    (d / "online.json").write_text(json.dumps({
        "valid": "unknown", "decided_through_index": 10, "ops_observed": 40,
        "segments_decided": 2, "aborted": False,
        "provenance": {"causes": {"overflow_top_rung": 2, "engine_error": 1}},
        "segments": [{"seq": 0, "key": None, "ops": 10, "valid": True, "engine": "host"}]}))
    with open(d / "metrics.jsonl", "a") as f:
        for code, tenant, v in (("overflow_top_rung", "t1", 3), ("escalation_budget", "", 2)):
            f.write(json.dumps({"type": "counter", "name": "verdict_causes_total",
                                "labels": {"code": code, "tenant": tenant},
                                "value": v}) + "\n")
    for fn in ("latency-raw.png", "rate.png", "timeline.html"):
        (d / fn).write_bytes(b"\x89PNG fake" if fn.endswith(".png") else b"<html></html>")
    (p_store.path(_run(root, "broken-profile", linear)) / "profile.json").write_text("{oops")
    return root


def test_the_taxonomy_differs_only_in_wording():
    assert set(p_prov.TAXONOMY) == set(r_prov.TAXONOMY)
    assert {c for c in p_prov.TAXONOMY if p_prov.TAXONOMY[c] != r_prov.TAXONOMY[c]} == \
        set(TAXONOMY_WORDED_OTHERWISE)
    assert all(p_prov.TAXONOMY[c][0] == r_prov.TAXONOMY[c][0] for c in p_prov.TAXONOMY)


def test_every_page_matches_reference(store_root, monkeypatch):
    monkeypatch.delenv("JEPSEN_LEDGER_PATH", raising=False)
    got = _same(store_root, PAGES)
    for path in PAGES:
        assert got[path][0] == 200, path
    assert b"Device search (roofline)" in got["/profile"][2]
    assert b"<svg" in got["/utilization"][2]
    assert b"cas-register" in got["/runs"][2]
    assert b"overflow_top_rung" in got["/verdicts"][2]
    assert b"offline verdict" in got["/online"][2]
    assert b"INVALID" in got["/"][2] and b"profile.json" in got["/"][2]
    assert json.loads(got["/live"][2]) == {"live_runs": 0}
    assert json.loads(got["/fleet.json"][2]) == [] == json.loads(got["/alerts.json"][2])


def test_pages_of_an_empty_store_match_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("JEPSEN_LEDGER_PATH", raising=False)
    got = _same(tmp_path, PAGES)
    assert b"--profile" in got["/profile"][2] and b"--profile" in got["/utilization"][2]
    assert b"python -m jepsen_tpu_torch.ledger --check" in got["/runs"][2]


def test_file_zip_and_unknown_paths_match_reference(store_root):
    run = sorted(p for p in (store_root / "cas-register").iterdir() if not p.is_symlink())[0]
    rel = f"cas-register/{run.name}"
    paths = [f"/files/{rel}/", f"/files/{rel}", f"/files/{rel}/history.edn",
             f"/files/{rel}/results.edn", f"/files/{rel}/profile.json",
             f"/files/{rel}/profile_trace/", "/files/", "/files/nope/", "/files/../../etc/passwd",
             "/zip/../..", "/zip/nope/x", "/no-such-page", "/live.htm", "/files/%2e%2e/x"]
    got = _both(store_root, paths + [f"/zip/{rel}"])
    for path in paths:
        ref, port = got[path]
        assert port == ref, path
    ref, port = got[f"/zip/{rel}"]
    assert port[:2] == ref[:2] == (200, "application/zip")
    import io
    import zipfile

    names = [sorted(zipfile.ZipFile(io.BytesIO(b[2])).namelist()) for b in (ref, port)]
    assert names[0] == names[1] and f"{run.name}/history.edn" in names[1]
    assert got["/no-such-page"][1][0] == 404 and got["/files/../../etc/passwd"][1][0] == 404


def test_live_with_a_registered_monitor(tmp_path):
    """``/live`` streams a registered monitor's snapshot, one line a run
    in registration order; a raising source is an error line; both
    packages render the same lines."""
    mon = OnlineMonitor(PCas(init=0), engine="device", device="cpu", name="live-run")
    try:
        for op in random_register_history(random.Random(2), n_ops=60, n_procs=3,
                                          crash_p=0.05):
            mon.observe(op)
        snap = mon.live_snapshot()

        def boom():
            raise RuntimeError("source gone")

        for web in (p_web, r_web):
            web.register_live_source("b/2", lambda: dict(snap))
            web.register_live_source("a/1", lambda: {"run": None, "verdict": "unknown"})
            web.register_live_source("c/3", boom)
            web.register_live_source("b/2", lambda: dict(snap))  # keeps its slot
        try:
            got = _same(tmp_path, ["/live", "/live.html", "/alerts.json"])
            lines = [json.loads(x) for x in got["/live"][2].decode().splitlines()]
            assert [x["run"] for x in lines] == ["live-run", "a/1", "c/3"]
            assert lines[0]["ops_observed"] == 120
            assert lines[2]["error"] == "RuntimeError: source gone"
            p_web.register_live_source("m", mon.live_snapshot)
            with _serving(p_web, tmp_path) as port:
                status, ctype, body = _get(port, "/live")
            assert status == 200 and ctype.startswith("application/x-ndjson")
            assert json.loads(body.decode().splitlines()[-1])["run"] == "live-run"
        finally:
            for web in (p_web, r_web):
                for key in ("a/1", "b/2", "c/3", "m"):
                    web.unregister_live_source(key)
    finally:
        mon.finish()
    assert p_web.live_ndjson() == '{"live_runs": 0}\n'


def test_fleet_and_alerts_pages_with_a_source(tmp_path):
    """The service registers fleet sources; until the port has one, the
    pages render whatever a source gives exactly as the reference does."""
    snap = {
        "epoch": 3, "draining": True, "orphaned": ["t9"],
        "decision_latency": {"p50_s": 0.1, "p99_s": 0.4},
        "slo": {"availability_target": 0.999, "latency_target_s": 1.0, "latency_ratio": 0.99,
                "windows": {"fast": {"window_s": 60, "availability_burn_rate": 0.5,
                                     "latency_burn_rate": 2.0, "decided": 10, "rejected": 1}}},
        "alerts": {"firing": ["slo_burn"], "recent": [
            {"t": 10.0, "rule": "slo_burn", "state": "firing", "severity": "high",
             "generation": 2}]},
        "stale_backends": ["b1"],
        "backends": {
            "b0": {"state": "ok", "url": "http://127.0.0.1:1", "scrapes": 3, "scrape_age_s": 0.5,
                   "tenants": ["t1"],
                   "utilization": {"source": "chunks", "utilization_pct": 50.0,
                                   "window": {"t0": 100.0, "t1": 104.0},
                                   "devices": [{"intervals": [[0.0, 1.0], [2.0, 3.0]]}]}},
            "b1": {"state": "lost", "down": True, "scrapes": 0, "scrape_age_s": None,
                   "utilization": {"source": "backlog", "utilization_pct": 25.0,
                                   "window": {"t0": 101.0, "t1": 103.0},
                                   "intervals": [[0.5, 1.0]]}}},
        "timeline": [{"t": 1.0, "kind": "place", "tenant": "t1"},
                     {"t": 2.0, "kind": "alert", "state": "firing", "rule": "slo_burn"}]}
    for web in (p_web, r_web):
        web.register_fleet_source("r0", lambda: dict(snap))
        web.register_fleet_source("r1", lambda: 1 / 0)
        web.register_live_source("svc", lambda: {"run": "svc", "alerts": ["journal_errors"],
                                                 "tenants": {}})
    try:
        got = _same(tmp_path, ["/fleet", "/fleet.json", "/alerts", "/alerts.json",
                               "/live.html"])
        assert b"slo_burn" in got["/alerts"][2] and b"journal_errors" in got["/alerts"][2]
        assert b"<svg" in got["/fleet"][2]
        assert p_web.alert_snapshots() == r_web.alert_snapshots()
        assert p_web.fleet_snapshots() == r_web.fleet_snapshots()
    finally:
        for web in (p_web, r_web):
            web.unregister_fleet_source("r0")
            web.unregister_fleet_source("r1")
            web.unregister_live_source("svc")
    assert p_web.fleet_snapshots() == [] and p_web.alert_snapshots() == []


def test_server_binds_the_given_host_and_a_free_port(tmp_path):
    srv = p_web.server(root=tmp_path, port=0, host="127.0.0.1")
    try:
        host, port = srv.server_address[:2]
        assert host == "127.0.0.1" and port > 0
    finally:
        srv.server_close()
