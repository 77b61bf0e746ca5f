"""The port's ndjson-over-HTTP front door of the checking service
(``jepsen_tpu_torch.service.http``) and its client against the
reference's.

One script of requests goes to a port server and a reference server, each
over its own service on ``127.0.0.1``: every answer (status, body with
wall times aside, ``Retry-After``) must be equal. The script reaches every
typed status: 200, 400 (bad json, bad epoch, bad cause, no journal,
unknown adapter, bad reorder window, non-monotone trace), 404, 409
(aborted tenant, stale epoch, double adopt, journal of another model),
410 (released tenant), 413, 429 (quota and a full queue) and 503
(draining). Then the client's resume after a 429, and ``?adapter=etcd``
on the golden etcd recording, whose drained verdict must be the port's
``ingest_check`` verdict."""

from __future__ import annotations

import json
import random
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from jepsen_tpu import service as r_service
from jepsen_tpu import testing as r_testing
from jepsen_tpu.models import CasRegister as RCas
from jepsen_tpu.models import Mutex as RMutex
from jepsen_tpu.service import client as r_client
from jepsen_tpu.service import http as r_http
from jepsen_tpu.telemetry import Registry as RRegistry
from jepsen_tpu_torch import service as p_service
from jepsen_tpu_torch import testing as p_testing
from jepsen_tpu_torch import trace as p_trace
from jepsen_tpu_torch.ingest import ingest_check
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.models import Mutex as PMutex
from jepsen_tpu_torch.service import client as p_client
from jepsen_tpu_torch.service import http as p_http
from jepsen_tpu_torch.telemetry import Registry as PRegistry

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "traces"

REF = dict(service=r_service, http=r_http, client=r_client, testing=r_testing, Cas=RCas,
           Mutex=RMutex, Registry=RRegistry)
PORT = dict(service=p_service, http=p_http, client=p_client, testing=p_testing, Cas=PCas,
            Mutex=PMutex, Registry=PRegistry)
PKGS = {"ref": REF, "port": PORT}
TIMING = {"wall_s", "t", "decision_latency", "seconds_to_detection", "trace_span"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Served:
    """A service behind its package's handler on 127.0.0.1."""

    def __init__(self, pkg, model=None, max_body=None, **kw):
        kw.setdefault("engine", "host")
        kw.setdefault("register_live", False)
        kw.setdefault("ledger", False)
        if pkg is PORT:
            kw.setdefault("device", "cpu")
        self.svc = pkg["service"].Service(model or pkg["Cas"](init=0), **kw)
        handler = (pkg["http"].make_handler(self.svc, max_body=max_body) if max_body
                   else pkg["http"].make_handler(self.svc))
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=lambda: self.srv.serve_forever(poll_interval=0.02),
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def call(self, method, path, body=None):
        req = urllib.request.Request(self.url + path, data=body, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.headers.get("Retry-After"), r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Retry-After"), e.read()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.svc.drain(timeout=30)


def _scrub(x):
    if isinstance(x, dict):
        return {k: _scrub(v) for k, v in x.items() if k not in TIMING}
    if isinstance(x, list):
        return [_scrub(v) for v in x]
    return x


def _answer(status, retry_after, raw, shape_only=False):
    try:
        doc = json.loads(raw)
    except ValueError:
        return status, retry_after, "text", raw.decode()[:40]
    if shape_only:
        return status, retry_after, sorted(doc)
    return status, retry_after, _scrub(doc)


def ndjson(history, skip=0):
    return "".join(json.dumps({"type": op.type, "process": op.process, "f": op.f,
                               "value": op.value, "time": op.time}) + "\n"
                   for op in list(history)[skip:]).encode()


def script(pkg, tmp_path):
    """Every typed answer of the front door, in order."""
    T = pkg["testing"]
    h = T.chunked_register_history(random.Random(61), n_ops=60, n_procs=2, chunk_ops=30)
    bad = T.perturb_history(random.Random(7), T.chunked_register_history(
        random.Random(23), n_ops=200, n_procs=2, chunk_ops=30))
    out = []
    # the plain service: ingest, bad json, 404s, abort, no journal, adapters
    s = Served(pkg, abort_on_violation=True)
    try:
        out.append(_answer(*s.call("POST", "/submit/alpha", ndjson(h))))
        out.append(_answer(*s.call("POST", "/submit/bad", ndjson(h)[:80] + b"\n{not json\n")))
        out.append(_answer(*s.call("GET", "/nope")))
        out.append(_answer(*s.call("POST", "/nope")))
        # the abort may land before the whole body is in (409) or after it
        out.append(s.call("POST", "/submit/inv", ndjson(bad))[0] in (200, 409))
        assert s.svc.flush(30.0)
        out.append(_answer(*s.call("POST", "/submit/inv", ndjson(bad)[-200:].split(b"\n", 1)[1])))
        st, ra, raw = s.call("GET", "/healthz")
        doc = json.loads(raw)
        doc["tenants"]["inv"].pop("watermark")  # where the abort landed
        out.append((st, ra, doc))
        out.append(_answer(*s.call("GET", "/tenants"), shape_only=True))
        out.append(_answer(*s.call("GET", "/alerts")))
        out.append(_answer(*s.call("GET", "/trace")))
        out.append(_answer(*s.call("GET", "/metrics")))
        out.append(_answer(*s.call("POST", "/release/ghost")))
        out.append(_answer(*s.call("POST", "/release/alpha")))
        out.append(_answer(*s.call("POST", "/adopt/alpha", b"{}\n")))
        out.append(_answer(*s.call("POST", "/fence")))
        out.append(_answer(*s.call("POST", "/fence?epoch=x")))
        out.append(_answer(*s.call("POST", "/fence?epoch=5")))
        out.append(_answer(*s.call("POST", "/release/alpha?epoch=3")))
        out.append(_answer(*s.call("POST", "/submit/x?adapter=oracle", b"{}")))
        out.append(_answer(*s.call("POST", "/submit/x?adapter=etcd&reorder_window_ns=x",
                                   b"{}")))
        lines = [json.dumps({"time": 5_000_000, "f": "write", "key": "k", "value": 1}),
                 json.dumps({"time": 100, "f": "write", "key": "k", "value": 2})]
        out.append(_answer(*s.call("POST", "/submit/x?adapter=jsonl",
                                   "\n".join(lines).encode())))
        st, ra, raw = s.call("POST", "/drain")
        doc = json.loads(raw)
        out.append((st, ra, sorted(doc), {t: (r["valid"], r["aborted"], sorted(r),
                                              t == "inv" or r["decided_through_index"])
                                          for t, r in doc["tenants"].items()}))
        out.append(_answer(*s.call("POST", "/submit/alpha", ndjson(h)[:100])))
    finally:
        s.close()
    # quota and a full queue: 429 with the resume point
    s = Served(pkg, quota_ops_per_s=1.0, quota_burst=10.0)
    try:
        st, ra, raw = s.call("POST", "/submit/q", ndjson(h))
        doc = json.loads(raw)
        out.append((st, ra, doc["error"], doc["accepted"], doc["retryable"],
                    doc["retry_after_s"] > 0))
    finally:
        s.close()
    s = Served(pkg, queue_limit=5)
    s.svc._pump_once = lambda: False  # a stalled pump: the queue fills
    try:
        out.append(_answer(*s.call("POST", "/submit/full", ndjson(h))))
    finally:
        s.close()
    s = Served(pkg, max_body=100)
    try:
        out.append(_answer(*s.call("POST", "/submit/big", ndjson(h))))
    finally:
        s.close()
    # the journaled service: release, 410, adopt, double adopt, bad cause,
    # a journal of another model family
    s = Served(pkg, journal_dir=str(tmp_path / "j"))
    try:
        assert s.call("POST", "/submit/m", ndjson(h))[0] == 200
        assert s.svc.flush(30.0)
        st, ra, raw = s.call("POST", "/release/m")
        rel = json.loads(raw)
        out.append((st, sorted(rel), rel["watermark"], rel["quiesced"]))
        out.append(_answer(*s.call("POST", "/submit/m", ndjson(h)[:100])))
        st, ra, raw = s.call("POST", "/adopt/m2", rel["journal"].encode())
        out.append((st, ra, _scrub(json.loads(raw))))
        out.append(_answer(*s.call("POST", "/adopt/m2", rel["journal"].encode())))
        out.append(_answer(*s.call("POST", "/adopt/m3?cause=bogus", rel["journal"].encode())))
        other = json.dumps({"kind": "header", "v": 1, "tenant": "m4", "model": {
            "name": "mutex", "key": ["mutex", 1, 2], "args": []}}) + "\n"
        out.append(_answer(*s.call("POST", "/adopt/m4", other.encode())))
    finally:
        s.close()
    return out


def _unpathed(answer, root):
    """An answer without its run's own directory, and without the wording
    of an unknown cause's message (the port's provenance words it
    otherwise; the code and status are the reference's)."""
    if not isinstance(answer, tuple):
        return answer
    status, ra, *rest = answer
    doc = rest[-1]
    if isinstance(doc, dict) and isinstance(doc.get("detail"), str):
        doc = dict(doc, detail=doc["detail"].replace(str(root), "ROOT"))
        if doc.get("error") == "bad_cause":
            doc["detail"] = doc["detail"].split(";")[0]
    return (status, ra, *rest[:-1], doc)


def test_every_status_code_matches_reference(tmp_path):
    got = {name: [_unpathed(a, tmp_path / name) for a in script(P, tmp_path / name)]
           for name, P in PKGS.items()}
    assert len(got["port"]) == len(got["ref"])
    for i, (p, r) in enumerate(zip(got["port"], got["ref"])):
        assert p == r, i
    codes = {a[0] for a in got["port"] if isinstance(a, tuple)}
    assert {200, 400, 404, 409, 410, 413, 429, 503} <= codes


def test_metrics_json_and_trace_routes():
    """``/metrics.json`` is the port's ``scrape_payload`` (``v`` 1, the
    samples and the helps); ``/trace`` serves a collector's spans, with
    the client's trace id on its ``service.ingest`` span."""
    s = Served(PORT, metrics=PRegistry(), collector=p_trace.Collector())
    try:
        h = p_testing.chunked_register_history(random.Random(3), n_ops=40, n_procs=2,
                                               chunk_ops=20)
        c = p_client.HttpServiceClient(s.url, "t", trace_id="trace-1")
        assert c.feed(h)["sent"] == len(h)
        st, _ra, raw = s.call("GET", "/metrics.json")
        doc = json.loads(raw)
        assert st == 200 and doc["v"] == 1 and doc["service"] == "service"
        assert {"samples", "helps", "events", "t"} <= set(doc)
        assert any(x["name"] == "service_tenants" for x in doc["samples"])
        st, _ra, raw = s.call("GET", "/trace")
        spans = json.loads(raw)["spans"]
        assert any(sp["name"] == "service.ingest" and sp["trace_id"] == "trace-1"
                   for sp in spans)
        st, _ra, raw = s.call("GET", "/metrics")
        assert st == 200 and b"service_tenants" in raw
    finally:
        s.close()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_client_resumes_after_429(pkg):
    """A quota of 200 ops/s with a burst of 20: the client is turned back
    with 429s, sleeps the server's own estimate and resumes at the
    ``accepted`` cursor until every op is in."""
    P = PKGS[pkg]
    s = Served(P, quota_ops_per_s=200.0, quota_burst=20.0)
    try:
        h = P["testing"].chunked_register_history(random.Random(4), n_ops=120, n_procs=2,
                                                  chunk_ops=30)
        rep = P["client"].HttpServiceClient(s.url, "t", chunk_ops=50).feed(h)
        assert rep["error"] is None and rep["sent"] == len(h) and rep["retries"] >= 1
        fin = s.svc.drain(timeout=30)
        assert fin["tenants"]["t"]["valid"] is True
        assert fin["tenants"]["t"]["ops_observed"] == len(h)
    finally:
        s.close()


def test_client_rewinds_to_the_watermark_in_process():
    """The in-process client on a 503 re-reads the watermark and resends
    from the watermark op: the covered op is dropped by the server."""
    svc = p_service.Service(PCas(init=0), engine="host", device="cpu",
                            register_live=False, ledger=False)
    h = list(p_testing.chunked_register_history(random.Random(5), n_ops=90, n_procs=2,
                                                chunk_ops=30))
    calls = {"n": 0}
    c = p_client.InProcessServiceClient(svc, "t", chunk_ops=30, sleep=lambda s: None)
    real = c._post

    def flaky(rows):
        calls["n"] += 1
        if calls["n"] == 3:  # the third chunk: a migration 503
            assert svc.flush(30.0)
            return {"status": 503, "accepted": 0, "error": "migrating", "retryable": True}
        return real(rows)

    c._post = flaky
    rep = c.feed(h)
    fin = svc.drain(timeout=30)
    assert rep["rewinds"] == 1 and rep["resubmitted_ops"] >= 1 and rep["sent"] == len(h)
    assert fin["tenants"]["t"]["valid"] is True
    assert fin["tenants"]["t"]["resubmitted_ops_dropped"] >= 1


@pytest.mark.parametrize("garbage", [False, True])
def test_adapter_etcd_matches_ingest_check(garbage):
    """``POST /submit/<tenant>?adapter=etcd`` on the golden etcd recording:
    the drained verdict is ``ingest_check``'s, in both packages; an
    unexplained line taints the tenant to unknown."""
    lines = (GOLDEN / "etcd.ndjson").read_text().splitlines()
    if garbage:
        lines = lines + ["garbage"]
    want = ingest_check(lines, "etcd", device="cpu")
    body = ("\n".join(lines) + "\n").encode()
    got = {}
    for name, P in PKGS.items():
        s = Served(P)
        try:
            st, _ra, raw = s.call("POST", "/submit/acme?adapter=etcd", body)
            doc = json.loads(raw)
            assert st == 200 and doc["adapter"] == "etcd"
            fin = s.svc.drain(timeout=30)
            row = fin["tenants"]["acme"]
            got[name] = (doc["accepted"], doc["unmapped"], doc["hint"], row["valid"],
                         sorted((row.get("provenance") or {}).get("causes") or {}))
        finally:
            s.close()
    assert got["port"] == got["ref"]
    assert got["port"][3] == want["valid"]
    assert got["port"][3] == ("unknown" if garbage else True)
    if garbage:
        assert "ingest_unmapped_op" in got["port"][4]
