"""Database automation protocols.

The port of the reference's ``jepsen_tpu/db.py``, which mirrors jepsen.db (jepsen/src/jepsen/db.clj):

- :class:`DB` — setup/teardown per node (db.clj:11-13).
- :class:`Process` — start/kill the DB process (db.clj:18-24); used by the
  kill/restart nemesis package.
- :class:`Pause` — SIGSTOP/SIGCONT style pause/resume (db.clj:26-29).
- :class:`Primary` — primary discovery + promotion (db.clj:31-38).
- :class:`LogFiles` — log paths to snarf after a run (db.clj:40-41).
- :func:`cycle` — teardown-then-setup across all nodes with bounded retries
  on :setup-failed (db.clj:121-158).

Node-side effects go through the test's control session (``control``)
so the same DB code runs over SSH or the in-process dummy remote.
:func:`tcpdump` starts its daemon through the node-side helpers of the
reference's ``control/util.py`` and ``control/net.py``, which the port does
not hold yet: constructing it raises ``ValueError``.
"""

from __future__ import annotations

import logging
from typing import Any, Iterable, Optional

from . import control as c
from .util import real_pmap


def _on_nodes(test: dict, f, nodes) -> None:
    """Run f(test, node) per node with its control session bound; the
    in-process fake-cluster path (no sessions) calls f directly."""
    nodes = list(nodes)
    if test.get("sessions"):
        c.on_nodes(test, f, nodes)
    else:
        real_pmap(lambda n: f(test, n), nodes)

LOG = logging.getLogger("jepsen.db")


class DB:
    """Set up and tear down a database on one node (db.clj:11-13)."""

    def setup(self, test: dict, node: Any) -> None:
        pass

    def teardown(self, test: dict, node: Any) -> None:
        pass


class Process:
    """Starting and killing the DB's process(es) (db.clj:18-24)."""

    def start(self, test: dict, node: Any) -> None:
        raise NotImplementedError

    def kill(self, test: dict, node: Any) -> None:
        raise NotImplementedError


class Pause:
    """Pausing/resuming the DB's process(es) (db.clj:26-29)."""

    def pause(self, test: dict, node: Any) -> None:
        raise NotImplementedError

    def resume(self, test: dict, node: Any) -> None:
        raise NotImplementedError


class Primary:
    """Primary discovery and promotion (db.clj:31-38)."""

    def primaries(self, test: dict) -> list:
        raise NotImplementedError

    def setup_primary(self, test: dict, node: Any) -> None:
        pass


class LogFiles:
    """Paths of log files to download after a run (db.clj:40-41)."""

    def log_files(self, test: dict, node: Any) -> Iterable[str]:
        return []


class _Noop(DB):
    def __repr__(self):
        return "<db.noop>"


def noop() -> DB:
    return _Noop()


class SetupFailed(Exception):
    """Raised by DB.setup to request a teardown+retry (db.clj:117-125)."""


def cycle(test: dict, retries: int = 3) -> None:
    """Teardown then setup the DB on every node in parallel; on
    :class:`SetupFailed`, tear down and retry up to ``retries`` times
    (db.clj:121-158). Afterwards runs Primary.setup_primary on the first
    node if the DB supports it."""
    db: DB = test.get("db") or noop()
    nodes = test.get("nodes") or []
    attempt = 0
    while True:
        attempt += 1
        try:
            _on_nodes(test, db.teardown, nodes)
            _on_nodes(test, db.setup, nodes)
            break
        except SetupFailed:
            if attempt > retries:
                raise
            LOG.warning("DB setup failed; retrying (%d/%d)", attempt, retries)
    if isinstance(db, Primary) and nodes:
        _on_nodes(test, db.setup_primary, [nodes[0]])


def teardown_all(test: dict) -> None:
    db: DB = test.get("db") or noop()
    _on_nodes(test, db.teardown, test.get("nodes") or [])


# What the tcpdump DB raises: it needs the node-side daemon helpers.
CONTROL_UTIL_SLICE = ("tcpdump starts its capture daemon through control/util.py and "
                      "control/net.py, which the port does not hold yet (ROADMAP item "
                      "A17's remainder)")


def tcpdump(opts: Optional[dict] = None) -> DB:
    """Packet capture from setup to teardown (db.clj:49-115). Raises
    ``ValueError``: its daemon helpers are not in the port yet."""
    raise ValueError(CONTROL_UTIL_SLICE)
