"""Spans and trace-context tags.

The port of the reference's ``jepsen_tpu/trace.py``: the cross-process
propagation headers the service's client stamps and its HTTP layer
reads (:data:`TRACE_HEADER`, :data:`PARENT_HEADER`,
:func:`trace_headers`), the thread-safe span :class:`Collector`
(``mint_id``, ``record``, ``span``, ``export_jsonl``) with its
process-wide :func:`default_collector`, the thread-local tags a caller
pushes around a check (``span_tags``) that every chunk event carries
(``event_tags``), and the client wrapper (:func:`tracing`) whose spans
``core.run`` writes into the store as ``spans.jsonl``
(:func:`store_spans`). The online scheduler's ``collector=`` records its
``online.oracle``, ``online.segment`` and ``online.member`` spans in a
collector, and pushes the oracle span's id as the ``trace_span`` tag of
the chunk events its device calls emit."""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

from . import client as jclient

# Cross-process trace propagation: the service client stamps these
# headers on every POST, and the service's HTTP layer threads them into
# ``Service.submit``, so one tenant's life across a restart and a resume
# is one trace id.
TRACE_HEADER = "X-Trace-Id"
PARENT_HEADER = "X-Parent-Span"


def trace_headers(trace_id: Optional[str],
                  parent_id: Optional[str] = None) -> dict:
    """Propagation headers for one outbound request ({} when no trace
    context is active — callers can always ``update`` with this)."""
    if not trace_id:
        return {}
    out = {TRACE_HEADER: str(trace_id)}
    if parent_id:
        out[PARENT_HEADER] = str(parent_id)
    return out


class Collector:
    """Thread-safe span sink."""

    def __init__(self):
        self.spans: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        # next() on itertools.count is atomic under the GIL: concurrent
        # spans never mint the same id.
        self._ids = itertools.count()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def mint_id(self) -> str:
        """A fresh span id, which a caller may hand to children before the
        parent span is recorded."""
        return f"{threading.get_ident():x}-{next(self._ids)}"

    def record(self, name: str, *, start_ns: int, end_ns: int,
               span_id: Optional[str] = None, trace_id: Optional[str] = None,
               parent_id: Optional[str] = None, stage: Optional[str] = None,
               **attrs: Any) -> dict:
        """Log an already-timed span with explicit linkage (the cross-thread
        seam of the online scheduler's segment -> member -> oracle chain)."""
        rec: dict = {
            "name": name,
            "span_id": span_id or self.mint_id(),
            "parent_id": parent_id,
            "thread": threading.current_thread().name,
            "start_ns": int(start_ns),
            "end_ns": int(end_ns),
            "duration_us": (int(end_ns) - int(start_ns)) // 1000,
        }
        if trace_id is not None:
            rec["trace_id"] = trace_id
        if stage is not None:
            rec["stage"] = stage
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            self.spans.append(rec)
        return rec

    @contextmanager
    def span(self, name: str, **attrs: Any):
        """Record a span around the body; spans nest per thread."""
        stack = self._stack()
        sid = self.mint_id()
        parent = stack[-1] if stack else None
        rec = {
            "name": name,
            "span_id": sid,
            "parent_id": parent,
            "thread": threading.current_thread().name,
            "start_ns": time.monotonic_ns(),
            **({"attrs": attrs} if attrs else {}),
        }
        stack.append(sid)
        try:
            yield rec
        except Exception as e:
            rec["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            stack.pop()
            rec["end_ns"] = time.monotonic_ns()
            rec["duration_us"] = (rec["end_ns"] - rec["start_ns"]) // 1000
            with self._lock:
                self.spans.append(rec)

    def export_jsonl(self, path) -> int:
        """Write every span as one JSON line: a full snapshot into a tmp
        file and an atomic rename, so an export is complete or absent."""
        with self._lock:
            spans = list(self.spans)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            for s in spans:
                f.write(json.dumps(s) + "\n")
        os.replace(tmp, path)
        return len(spans)


_default = Collector()


def default_collector() -> Collector:
    return _default


def span(name: str, **attrs):
    return _default.span(name, **attrs)


_tags_local = threading.local()
_EMPTY_TAGS: dict = {}


@contextmanager
def span_tags(**tags: Any):
    """Attach trace-context tags to telemetry events emitted inside the
    body (nests: inner tags shadow outer keys, the outer dict is restored
    on exit)."""
    prev = getattr(_tags_local, "d", None)
    _tags_local.d = {**prev, **tags} if prev else dict(tags)
    try:
        yield
    finally:
        _tags_local.d = prev


def event_tags() -> dict:
    """The current thread's trace-context tags: ``{}`` (one shared
    instance) when none are pushed."""
    return getattr(_tags_local, "d", None) or _EMPTY_TAGS


class TracingClient(jclient.Client):
    """Wraps a client so every lifecycle call records a span (the dgraph
    suite's with-trace around client bodies, trace.clj:32-74)."""

    def __init__(self, client: jclient.Client, collector: Optional[Collector] = None):
        self.client = client
        self.collector = collector or _default

    def open(self, test, node):
        with self.collector.span("client.open", node=str(node)):
            return TracingClient(self.client.open(test, node), self.collector)

    def setup(self, test):
        with self.collector.span("client.setup"):
            self.client.setup(test)

    def invoke(self, test, op):
        with self.collector.span("client.invoke", f=str(op.get("f")),
                                 process=str(op.get("process"))) as rec:
            res = self.client.invoke(test, op)
            rec["type"] = res.get("type")
            return res

    def teardown(self, test):
        with self.collector.span("client.teardown"):
            self.client.teardown(test)

    def close(self, test):
        with self.collector.span("client.close"):
            self.client.close(test)


def tracing(client: jclient.Client, collector: Optional[Collector] = None) -> jclient.Client:
    """The client wrapped in a :class:`TracingClient` (reusable when the
    client is)."""
    out = TracingClient(client, collector)
    if isinstance(client, jclient.Reusable):
        class _R(TracingClient, jclient.Reusable):
            pass

        return _R(client, collector or _default)
    return out


def store_spans(test: dict, collector: Optional[Collector] = None) -> Optional[str]:
    """Write spans.jsonl into the test's store directory."""
    if not (test.get("name") and test.get("start-time")) or test.get("no-store?"):
        return None
    from . import store

    path = store.path_mk(test, "spans.jsonl")
    (collector or _default).export_jsonl(path)
    return str(path)
