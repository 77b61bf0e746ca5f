"""Client protocol: how workers talk to the database under test.

The port of the reference's ``jepsen_tpu/client.py``, which mirrors
jepsen.client (jepsen/src/jepsen/client.clj):

- :class:`Client` — five lifecycle methods (client.clj:9-27). ``open``
  returns a *connected copy* of the client bound to one node; ``invoke``
  applies one operation and returns its completion; ``setup``/``teardown``
  run once-per-client database preparation; ``close`` severs the
  connection.
- :class:`Reusable` — marker mixin: a client that may keep serving after
  its process crashes (client.clj:29-40). Non-reusable clients are
  re-opened by the interpreter when their worker's process changes.
- :func:`validate` — wrapper enforcing completion well-formedness
  (client.clj:60-106): type ∈ {ok, fail, info}, process and f unchanged.
- :func:`noop` — a client that trivially "succeeds" every op
  (client.clj:42-49).

Clients here are ordinary mutable Python objects (connections are
stateful); the *generator* side of the system stays pure.
"""

from __future__ import annotations

from typing import Any, Optional

from .history import FAIL, INFO, OK


class Client:
    """One logical client connection (client.clj:9-27). Subclasses override
    whichever methods matter; defaults are no-ops so trivial clients stay
    trivial."""

    def open(self, test: dict, node: Any) -> "Client":
        """Return a client connected to ``node``. Must be safe to call on a
        fresh (never-opened) instance; the returned object is the one that
        receives invoke/close."""
        return self

    def setup(self, test: dict) -> None:
        """One-time database preparation (create tables, etc.)."""

    def invoke(self, test: dict, op: dict) -> dict:
        """Apply ``op`` (an :invoke map) and return its completion — the
        same op with type ok/fail/info and any result value."""
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        """Undo setup."""

    def close(self, test: dict) -> None:
        """Sever this connection."""


class Reusable:
    """Marker: client survives process crashes (client.clj:29-40)."""


def is_reusable(client: Any, test: dict) -> bool:
    if isinstance(client, _Validate):
        return is_reusable(client.client, test)
    return isinstance(client, Reusable)


class _Noop(Client, Reusable):
    """Does nothing; every op "succeeds" (client.clj:42-49)."""

    def invoke(self, test, op):
        return {**op, "type": OK}

    def __repr__(self):
        return "<client.noop>"


def noop() -> Client:
    return _Noop()


class ValidationError(Exception):
    pass


_COMPLETION_TYPES = (OK, FAIL, INFO)


class _Validate(Client):
    """Checks completions line up with their invocations
    (client.clj:60-106)."""

    def __init__(self, client: Client):
        self.client = client

    def open(self, test, node):
        opened = self.client.open(test, node)
        return _Validate(opened)

    def setup(self, test):
        self.client.setup(test)

    def invoke(self, test, op):
        res = self.client.invoke(test, op)
        if res is None:
            raise ValidationError(
                f"Expected client {self.client!r} to return a completion for "
                f"op {op!r} but got None"
            )
        if res.get("type") not in _COMPLETION_TYPES:
            raise ValidationError(
                f"Expected client {self.client!r} to return a completion with "
                f"type ok/fail/info for op {op!r} but got {res!r}"
            )
        for field in ("process", "f"):
            if res.get(field) != op.get(field):
                raise ValidationError(
                    f"Expected client {self.client!r} to return a completion "
                    f"with the same {field} as op {op!r} but got {res!r}"
                )
        return res

    def teardown(self, test):
        self.client.teardown(test)

    def close(self, test):
        self.client.close(test)

    def __repr__(self):
        return f"<client.validate {self.client!r}>"


def validate(client: Client) -> Client:
    """Wrap ``client`` so malformed completions raise instead of corrupting
    the history (client.clj:60-106). Reusability of the inner client is
    preserved (is_reusable unwraps the wrapper)."""
    if isinstance(client, _Validate):
        return client
    return _Validate(client)
