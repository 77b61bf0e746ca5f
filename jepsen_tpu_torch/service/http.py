"""ndjson-over-HTTP ingestion for the multi-tenant checking service.
The port of the reference's ``jepsen_tpu/service/http.py``.

Reuses the ``web.py`` server machinery (``ThreadingHTTPServer`` + a
handler factory closed over the state it serves) for the WRITE side the
results browser never needed:

- ``POST /submit/<tenant>`` — body is ndjson, one history op per line
  (the interpreter's scheduler-dict shape: ``{"type": "invoke",
  "process": 0, "f": "write", "value": 1, "time": ...}``). Ops are fed
  in order through ``Service.submit``; the response reports how many
  lines were accepted. A typed rejection maps to its HTTP status
  (quota/queue-full → 429, draining → 503, aborted tenant → 409) with
  ``{"error": <code>, "accepted": <n>}`` so the client knows exactly
  where to resume.
- ``GET /`` / ``GET /tenants`` — the service's live snapshot (per-tenant
  watermark, backlog, verdict, decision-latency quantiles) as JSON.
- ``GET /healthz`` — liveness.
- ``POST /drain`` — graceful shutdown: folds every tenant's partial
  verdict and returns the per-tenant results document.

The service also registers itself on the results browser's ``/live``
feed (``ServiceConfig.register_live``), so the ingestion port carries
only the ingest API while dashboards keep polling the web server.
"""

from __future__ import annotations

import json
import logging
import math
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlsplit

from .journal import JournalError, JournalModelMismatchError
from .service import Service, ServiceError

LOG = logging.getLogger("jepsen.service")

# Largest POST body accepted (bytes). The per-tenant queue bounds are
# useless if one request can buffer an arbitrary body in RAM first —
# a bigger stream is just more requests (the response's `accepted`
# count is the client's resume cursor anyway).
MAX_BODY_BYTES = 8 << 20
# Adopt bodies are WHOLE journals and have no chunked resume protocol
# (the replay needs the complete file) — a long-lived tenant's journal
# easily exceeds the submit cap, and refusing it would permanently
# orphan exactly the tenants with the most decided state to protect.
# Still bounded: one adopt buffers at most this much.
MAX_ADOPT_BODY_BYTES = 256 << 20


def make_handler(service: Service, max_body: int = MAX_BODY_BYTES):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            LOG.debug(fmt, *args)

        def _json(self, code: int, doc: dict,
                  retry_after_s=None) -> None:
            body = json.dumps(doc, sort_keys=True,
                              default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after_s is not None:
                # The standard backoff hint, integral seconds, never
                # zero (clients treat 0 as "immediately", defeating
                # the point): quota refill estimate on 429s, the fixed
                # drain hint on 503s.
                self.send_header("Retry-After",
                                 str(max(1, math.ceil(retry_after_s))))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = unquote(self.path)
            try:
                if path in ("/", "/tenants", "/tenants/",
                            "/live", "/live/"):
                    # /live is the alias the fleet page's per-backend
                    # links target — same row the web dashboard polls.
                    self._json(200, service.live_snapshot())
                elif path == "/healthz":
                    # Liveness PLUS the per-tenant overload signals
                    # (backlog, journal_lag_ops, degraded) the router /
                    # an external LB makes placement decisions from —
                    # no /metrics scrape needed.
                    self._json(200, service.health_snapshot())
                elif path in ("/metrics", "/metrics/"):
                    # The LIVE registry as Prometheus text (before,
                    # prom export only landed in store files at drain —
                    # nothing was scrape-able mid-run).
                    self._metrics_text()
                elif path in ("/metrics.json", "/metrics.json/"):
                    # The federation scrape the router consumes:
                    # samples + helps + the event-ring tail (see
                    # telemetry.fleet.scrape_payload).
                    self._metrics_json()
                elif path in ("/trace", "/trace/"):
                    # The service's span sink (when tracing is on) —
                    # how a cross-process trace is observed without a
                    # span-shipping sidecar: the test/operator scrapes
                    # each backend's spans and joins on trace id.
                    col = getattr(service, "collector", None)
                    if col is None:
                        self._json(404, {"error": "no_collector"})
                    else:
                        with col._lock:
                            spans = list(col.spans)
                        self._json(200, {"service": service.name,
                                         "spans": spans})
                elif path in ("/alerts", "/alerts/"):
                    # The alert plane's lifecycle view: firing set,
                    # rule catalogue, recent transitions
                    # ({"enabled": false} without an alert config).
                    self._json(200, service.alerts_snapshot())
                else:
                    self._json(404, {"error": "not_found"})
            except Exception as e:  # noqa: BLE001 - never 500 silently
                LOG.warning("error serving %s", path, exc_info=True)
                self._json(500, {"error": "internal",
                                 "detail": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            parts = urlsplit(self.path)
            path = unquote(parts.path)
            query = parse_qs(parts.query)
            try:
                if path.startswith("/submit/"):
                    tenant = path[len("/submit/"):].strip("/")
                    self._submit(tenant, query)
                elif path.startswith("/adopt/"):
                    self._adopt(path[len("/adopt/"):].strip("/"),
                                query)
                elif path.startswith("/release/"):
                    self._release(path[len("/release/"):].strip("/"),
                                  query)
                elif path in ("/fence", "/fence/"):
                    self._fence(query)
                elif path in ("/drain", "/drain/"):
                    self._json(200, service.drain())
                else:
                    self._json(404, {"error": "not_found"})
            except Exception as e:  # noqa: BLE001
                LOG.warning("error serving %s", path, exc_info=True)
                self._json(500, {"error": "internal",
                                 "detail": f"{type(e).__name__}: {e}"})

        def _metrics_text(self) -> None:
            reg = service.metrics
            if reg is None:
                self._json(404, {"error": "no_registry"})
                return
            from ..telemetry import export as _export

            body = _export.prometheus_text(reg).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _metrics_json(self) -> None:
            reg = service.metrics
            if reg is None:
                self._json(404, {"error": "no_registry"})
                return
            from ..telemetry import fleet as _fleet

            self._json(200, _fleet.scrape_payload(
                reg, service=service.name))

        def _trace_ctx(self):
            """The propagated cross-process trace context of this
            request, or None (see trace.TRACE_HEADER)."""
            from .. import trace as _trace

            tid = self.headers.get(_trace.TRACE_HEADER)
            if not tid:
                return None
            return (tid, self.headers.get(_trace.PARENT_HEADER))

        def _read_body(self, tenant: str, limit: Optional[int] = None):
            """Bounded body read shared by submit and adopt; None when
            the 413 was already sent."""
            cap = limit if limit is not None else max_body
            length = int(self.headers.get("Content-Length") or 0)
            if length > cap:
                self._json(413, {
                    "error": "body_too_large", "tenant": tenant,
                    "accepted": 0, "max_bytes": cap,
                    "detail": "split the stream into smaller POSTs; "
                              "`accepted` is the resume cursor"})
                return None
            return self.rfile.read(length)

        def _epoch_of(self, query: dict):
            """Parse the optional fencing epoch; returns (ok, epoch)
            — a non-integer epoch is a 400, not a silent unfenced
            call (the fence would never learn the caller's
            generation)."""
            raw = (query.get("epoch") or [None])[0]
            if raw is None:
                return True, None
            try:
                return True, int(raw)
            except ValueError:
                self._json(400, {"error": "bad_epoch",
                                 "detail": f"epoch {raw!r} is not an "
                                           "integer"})
                return False, None

        def _fence(self, query: dict) -> None:
            ok, epoch = self._epoch_of(query)
            if not ok:
                return
            if epoch is None:
                self._json(400, {"error": "bad_epoch",
                                 "detail": "POST /fence?epoch=N"})
                return
            try:
                self._json(200, service.fence(epoch))
            except ServiceError as e:
                self._json(e.http_status,
                           {"error": e.code, "detail": str(e)})

        def _adopt(self, tenant: str, query: dict) -> None:
            # The migration seam: body = the tenant's journal (the
            # router's handover), ?cause= the typed migration reason
            # (backend_lost), ?epoch= the caller's placement epoch
            # (a stale ex-router is refused 409 `stale_epoch`). Typed
            # refusals map like /submit's; a journal written for
            # another model family is the 409 the journal replay
            # types. The cap is the ADOPT cap — journals have no
            # chunked resume protocol, and the submit-sized bound
            # would orphan big tenants forever.
            ok, epoch = self._epoch_of(query)
            if not ok:
                return
            body = self._read_body(tenant, limit=MAX_ADOPT_BODY_BYTES)
            if body is None:
                return
            cause = (query.get("cause") or [None])[0]
            try:
                doc = service.adopt(tenant, body, cause=cause,
                                    epoch=epoch,
                                    trace=self._trace_ctx())
            except ServiceError as e:
                self._json(e.http_status,
                           {"error": e.code, "tenant": tenant,
                            "detail": str(e)},
                           retry_after_s=(e.retry_after_s
                                          if e.http_status in (429, 503)
                                          else None))
                return
            except JournalModelMismatchError as e:
                self._json(409, {"error": "journal_model_mismatch",
                                 "tenant": tenant, "detail": str(e)})
                return
            except JournalError as e:
                self._json(409, {"error": "journal_error",
                                 "tenant": tenant, "detail": str(e)})
                return
            except ValueError as e:  # unknown provenance cause code
                self._json(400, {"error": "bad_cause",
                                 "tenant": tenant, "detail": str(e)})
                return
            self._json(200, doc)

        def _release(self, tenant: str, query: dict) -> None:
            ok, epoch = self._epoch_of(query)
            if not ok:
                return
            try:
                doc = service.release(tenant, epoch=epoch)
            except ServiceError as e:
                self._json(e.http_status,
                           {"error": e.code, "tenant": tenant,
                            "detail": str(e)},
                           retry_after_s=(e.retry_after_s
                                          if e.http_status in (429, 503)
                                          else None))
                return
            self._json(200, doc)

        def _submit(self, tenant: str, query: Optional[dict] = None
                    ) -> None:
            body = self._read_body(tenant)
            if body is None:
                return
            trace = self._trace_ctx()
            adapter = ((query or {}).get("adapter") or [None])[0]
            if adapter is not None:
                # Content negotiation: the body is a RAW TRACE in the
                # named adapter's dialect, not ndjson ops — the ingest
                # front door (``ingest``).
                self._submit_trace(tenant, adapter, body, query or {},
                                   trace)
                return
            accepted = 0
            for line in body.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    op = json.loads(line)
                except ValueError:
                    self._json(400, {
                        "error": "bad_json", "tenant": tenant,
                        "accepted": accepted,
                        "detail": "unparseable ndjson line"})
                    return
                try:
                    service.submit(tenant, op, trace=trace)
                except ServiceError as e:
                    # Typed rejection: the client resumes after
                    # `accepted` lines (quota/backpressure are
                    # retryable 429s; aborted/draining are not). 429s
                    # and 503s additionally carry Retry-After — the
                    # token bucket's refill estimate / the drain hint
                    # — so a well-behaved client backs off by exactly
                    # the server's own estimate.
                    doc = {
                        "error": e.code, "tenant": tenant,
                        "accepted": accepted, "detail": str(e),
                        # Migration 503s override the status-derived
                        # default: the tenant comes back (elsewhere),
                        # so the client retries through the router.
                        "retryable": (e.retryable
                                      if e.retryable is not None
                                      else e.http_status == 429)}
                    ra = (e.retry_after_s
                          if e.http_status in (429, 503) else None)
                    if ra is not None:
                        doc["retry_after_s"] = ra
                    self._json(e.http_status, doc, retry_after_s=ra)
                    return
                accepted += 1
            self._json(200, {"tenant": tenant, "accepted": accepted})

        def _submit_trace(self, tenant: str, adapter: str,
                          body: bytes, query: dict, trace) -> None:
            """``POST /submit/<tenant>?adapter=<name>``: parse a raw
            recording through the named ingest adapter, submit the
            recovered history ops, and TAINT the tenant for every
            line no rule explained — its drain verdict folds
            one-sidedly to unknown (``ingest_unmapped_op``)."""
            from .. import ingest as _ingest
            from ..online.segmenter import NonMonotoneHistoryError

            try:
                a = _ingest.by_name(adapter)
            except KeyError:
                self._json(400, {
                    "error": "unknown_adapter", "tenant": tenant,
                    "accepted": 0, "adapter": adapter,
                    "known": sorted(_ingest.ADAPTERS)})
                return
            window = (query.get("reorder_window_ns") or [None])[0]
            try:
                window = (int(window) if window is not None
                          else _ingest.DEFAULT_REORDER_WINDOW_NS)
            except ValueError:
                self._json(400, {"error": "bad_reorder_window",
                                 "tenant": tenant, "accepted": 0})
                return
            try:
                parsed = _ingest.parse_trace(
                    body.decode("utf-8", errors="replace").splitlines(),
                    a, reorder_window_ns=window,
                    metrics=service.metrics)
            except NonMonotoneHistoryError as e:
                # Corrupt recording (out of order beyond the repair
                # window): typed refusal, nothing submitted.
                self._json(400, {"error": "non_monotone_trace",
                                 "tenant": tenant, "accepted": 0,
                                 "detail": str(e)})
                return
            # Taint FIRST: the degradation must be durable even if a
            # rejection truncates the submit loop below.
            if parsed["unmapped"]:
                service.taint(tenant, "ingest_unmapped_op",
                              parsed["unmapped"])
            accepted = 0
            for op in parsed["ops"]:
                # The service stamps its own indexes (the tenant may
                # already hold ops from earlier POSTs).
                op = {k: v for k, v in op.items() if k != "index"}
                try:
                    service.submit(tenant, op, trace=trace)
                except ServiceError as e:
                    doc = {
                        "error": e.code, "tenant": tenant,
                        "accepted": accepted, "detail": str(e),
                        "adapter": adapter,
                        "unmapped": parsed["unmapped"],
                        "retryable": (e.retryable
                                      if e.retryable is not None
                                      else e.http_status == 429)}
                    ra = (e.retry_after_s
                          if e.http_status in (429, 503) else None)
                    if ra is not None:
                        doc["retry_after_s"] = ra
                    self._json(e.http_status, doc, retry_after_s=ra)
                    return
                accepted += 1
            self._json(200, {
                "tenant": tenant, "accepted": accepted,
                "adapter": adapter, "unmapped": parsed["unmapped"],
                "hint": parsed["hint"], "stats": parsed["stats"]})

    return Handler


def server(service: Service, port: int = 0) -> ThreadingHTTPServer:
    """Build (without starting) the ingestion server — tests drive
    this; port 0 binds an ephemeral port."""
    return ThreadingHTTPServer(("", port), make_handler(service))


def serve(service: Service, port: int = 8089,
          port_file: Optional[str] = None) -> None:
    """Serve forever (the ``jepsen_tpu_torch.service`` CLI's daemon mode).
    ``port_file`` is the spawned-backend readiness protocol: the
    BOUND port (``--port 0`` = ephemeral) is written atomically after
    bind, so a supervisor never has to probe-then-bind a port it
    could lose to another process (the TOCTOU the old
    ``_free_port`` dance had)."""
    srv = server(service, port)
    if port_file:
        tmp = f"{port_file}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(str(srv.server_address[1]))
        os.replace(tmp, port_file)
    LOG.info("Service %s ingesting on http://0.0.0.0:%d",
             service.name, srv.server_address[1])
    print(f"Service {service.name} ingesting on "
          f"http://0.0.0.0:{srv.server_address[1]} "
          "(POST /submit/<tenant>, POST /drain, GET /tenants)")
    srv.serve_forever()
