"""Resume-aware ndjson client for the checking service. The port of the
reference's ``jepsen_tpu/service/client.py``.

The client half of the ingestion contract the HTTP layer speaks:

- **Typed rejections carry a resume point** (``accepted``): the client
  advances its cursor by exactly what the server took and retries the
  rest — no op is ever skipped or double-counted by the transport.
- **Backoff honors the server's own estimate**: 429/503 responses
  carry ``Retry-After`` (the token bucket's refill estimate, the
  router's migration hint); the client sleeps that, falling back to
  bounded exponential backoff, and gives up after ``max_retries``
  consecutive zero-progress attempts.
- **Reconnects re-anchor on the journaled watermark** (the resume
  contract): after an unreachable backend or a migration 503,
  the acks the client holds may have come from a process that died
  with unjournaled state — so the client re-reads the tenant's
  watermark (``GET /tenants``) and rewinds to the watermark op
  *inclusive*. The one-op overlap is deliberate: the boundary op's
  delivery is ambiguous, and the server's drop floor
  (``Segmenter.resume``) makes overlap free — the tenant row's
  ``resubmitted_ops_dropped`` counter is the proof the floor engaged.

Two transports share one feed loop: :class:`HttpServiceClient` (real
deployments) and :class:`InProcessServiceClient` (``--simulate``,
in-process drivers, tests) — the latter submits
through ``Service.submit`` directly so value tuples never round-trip
through JSON.
"""

from __future__ import annotations

import json
import logging
import time as _time
from typing import Any, Callable, Iterable, Optional
from urllib import error as _uerror
from urllib import request as _urequest
from urllib.parse import quote

from ..history import Op

LOG = logging.getLogger("jepsen.service")


def op_json(op: Any) -> dict:
    """One history op as the plain scheduler-dict shape the ingestion
    endpoint parses — INCLUDING the index when assigned (the resume
    protocol's drop floor is index-based; an unindexed resubmission
    cannot be deduplicated server-side). ``independent`` [k v] values
    are serialized as ``{"kv": [k, v]}`` — a plain JSON list would be
    indistinguishable from a vector value, and the server needs the
    key axis intact to run its P-compositional split (the ingestion
    seam rehydrates the marker; see ``service._decode_kv``)."""
    if isinstance(op, Op):
        from .. import independent as ind

        value = ({"kv": [op.value.key, op.value.value]}
                 if ind.is_tuple(op.value) else op.value)
        m: dict = {"type": op.type, "process": op.process, "f": op.f,
                   "value": value, "time": op.time}
        if op.index >= 0:
            m["index"] = op.index
        if op.error is not None:
            m["error"] = op.error
        return m
    return dict(op)


class ServiceClient:
    """Shared resume-aware feed loop; subclasses provide the transport
    (`_post(rows) -> response dict`) and the watermark lookup."""

    def __init__(self, tenant: str, *, chunk_ops: int = 256,
                 max_retries: int = 8, base_backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0,
                 sleep: Callable[[float], None] = _time.sleep,
                 trace_id: Optional[str] = None,
                 trace_span: Optional[str] = None) -> None:
        if chunk_ops < 1:
            raise ValueError("chunk_ops must be >= 1")
        self.tenant = tenant
        self.chunk_ops = chunk_ops
        self.max_retries = max_retries
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self._sleep = sleep
        # Cross-process trace context: when set, every submit carries
        # the propagation headers (trace.TRACE_HEADER /
        # trace.PARENT_HEADER), so the router and every backend this
        # tenant touches — including post-migration — record their
        # spans under ONE trace id.
        self.trace_id = trace_id
        self.trace_span = trace_span

    # -- transport seam ------------------------------------------------------

    def _post(self, rows: list[dict]) -> dict:
        """Submit ``rows`` in order; NEVER raises. Returns a dict with
        ``status`` (int; 0 = transport unreachable), ``accepted``
        (resume point within this chunk), and optionally ``error`` /
        ``retryable`` / ``retry_after_s``."""
        raise NotImplementedError

    def _resume_watermark(self) -> Optional[int]:
        """The tenant's current journaled/decided watermark as the
        server reports it, or None when unavailable (mid-migration,
        transport down)."""
        return None

    # -- the feed loop -------------------------------------------------------

    def feed(self, ops: Iterable[Any]) -> dict:
        """Feed ``ops`` in order with retries, backoff and watermark
        re-anchoring. Returns a report::

            {"ops": N, "sent": n_accepted, "retries": r,
             "rewinds": w, "resubmitted_ops": k,
             "error": code | None, "gave_up": bool}

        ``error`` is set when a non-retryable rejection (tenant
        aborted, draining) stopped the feed or retries were exhausted;
        ``sent`` is then the exact resume cursor.
        """
        rows = [op_json(op) for op in ops]
        idx = [r["index"] if isinstance(r.get("index"), int) else -1
               for r in rows]
        report = {"ops": len(rows), "sent": 0, "retries": 0,
                  "rewinds": 0, "resubmitted_ops": 0, "error": None,
                  "gave_up": False}
        cursor = 0
        consec = 0  # consecutive zero-progress attempts
        while cursor < len(rows):
            chunk = rows[cursor:cursor + self.chunk_ops]
            r = self._post(chunk)
            accepted = r.get("accepted")
            accepted = accepted if isinstance(accepted, int) else 0
            accepted = max(0, min(accepted, len(chunk)))
            cursor += accepted
            if accepted == len(chunk):
                consec = 0
                continue
            if accepted > 0:
                consec = 0  # partial progress still resets the clock
            status = r.get("status")
            status = status if isinstance(status, int) else 0
            retryable = bool(r.get("retryable")) or status == 0
            if not retryable:
                report["error"] = r.get("error") or f"http_{status}"
                break
            consec += 1
            report["retries"] += 1
            if consec > self.max_retries:
                report["error"] = r.get("error") or "unreachable"
                report["gave_up"] = True
                break
            delay = r.get("retry_after_s")
            if isinstance(delay, (int, float)) and delay > 0:
                delay = min(float(delay), self.max_backoff_s)
            else:
                delay = min(self.base_backoff_s * (2 ** (consec - 1)),
                            self.max_backoff_s)
            self._sleep(delay)
            if status in (0, 503):
                # Reconnect episode (dead backend / migration in
                # flight): re-anchor on the server's watermark, from
                # the watermark op INCLUSIVE (see module docstring).
                wm = self._resume_watermark()
                if wm is not None and wm >= 0:
                    back = next((k for k, i in enumerate(idx)
                                 if i >= wm), None)
                    if back is not None and back < cursor:
                        report["resubmitted_ops"] += cursor - back
                        report["rewinds"] += 1
                        cursor = back
        report["sent"] = cursor
        return report


class HttpServiceClient(ServiceClient):
    """ndjson-over-HTTP transport — point ``base_url`` at a backend's
    or the router's ingestion port."""

    def __init__(self, base_url: str, tenant: str, *,
                 timeout_s: float = 10.0, resume: bool = True,
                 **kw: Any) -> None:
        super().__init__(tenant, **kw)
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.resume = resume

    def _post(self, rows: list[dict]) -> dict:
        body = ("\n".join(json.dumps(r, sort_keys=True, default=str)
                          for r in rows) + "\n").encode()
        url = (f"{self.base_url}/submit/"
               f"{quote(self.tenant, safe='')}")
        from .. import trace as _trace

        req = _urequest.Request(
            url, data=body, method="POST",
            headers=_trace.trace_headers(self.trace_id,
                                         self.trace_span))
        try:
            with _urequest.urlopen(req, timeout=self.timeout_s) as resp:
                doc = json.loads(resp.read().decode() or "{}")
                if not isinstance(doc, dict):
                    doc = {}
                doc.setdefault("status", resp.status)
                return doc
        except _uerror.HTTPError as e:
            try:
                doc = json.loads(e.read().decode() or "{}")
            except ValueError:
                doc = {}
            if not isinstance(doc, dict):
                doc = {}
            doc.setdefault("accepted", 0)
            doc["status"] = e.code
            ra = e.headers.get("Retry-After") if e.headers else None
            if ra and "retry_after_s" not in doc:
                try:
                    doc["retry_after_s"] = float(ra)
                except ValueError:
                    pass
            return doc
        except Exception as e:  # noqa: BLE001 - transport down
            return {"status": 0, "accepted": 0, "error": "unreachable",
                    "retryable": True, "detail": str(e)}

    def _resume_watermark(self) -> Optional[int]:
        if not self.resume:
            return None
        try:
            with _urequest.urlopen(f"{self.base_url}/tenants",
                                   timeout=self.timeout_s) as resp:
                doc = json.loads(resp.read().decode() or "{}")
            row = (doc.get("tenants") or {}).get(self.tenant) or {}
            wm = row.get("watermark")
            return wm if isinstance(wm, int) else None
        except Exception:  # noqa: BLE001 - resume point unavailable
            return None


class InProcessServiceClient(ServiceClient):
    """In-process transport over ``Service.submit`` — the seam
    ``--simulate``, bench's in-process legs and tests drive. Ops are
    handed to the service as-is (no JSON round-trip, so tuple values
    survive)."""

    def __init__(self, service, tenant: str, **kw: Any) -> None:
        super().__init__(tenant, **kw)
        self.service = service

    def _post(self, rows: list[dict]) -> dict:
        from .service import ServiceError

        trace = ((self.trace_id, self.trace_span)
                 if self.trace_id else None)
        accepted = 0
        for row in rows:
            try:
                self.service.submit(self.tenant, row, trace=trace)
            except ServiceError as e:
                return {"status": e.http_status, "accepted": accepted,
                        "error": e.code,
                        # Mirror the HTTP layer: an explicit
                        # e.retryable (the migration 503) overrides
                        # the status-derived default.
                        "retryable": (e.retryable
                                      if e.retryable is not None
                                      else e.http_status == 429),
                        "retry_after_s": e.retry_after_s}
            accepted += 1
        return {"status": 200, "accepted": accepted}

    def _resume_watermark(self) -> Optional[int]:
        try:
            snap = self.service.tenant_snapshot(self.tenant) or {}
            wm = snap.get("watermark")
            return wm if isinstance(wm, int) else None
        except Exception:  # noqa: BLE001
            return None
