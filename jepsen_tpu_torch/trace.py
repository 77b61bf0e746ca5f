"""Trace-context tags that the drivers' telemetry events carry.

A trimmed copy of the reference's ``jepsen_tpu/trace.py``: only the
thread-local tags a caller pushes around a check (``span_tags``) and that
every chunk event carries (``event_tags``); the span collector and the
client wrapper stay in the reference."""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any

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
