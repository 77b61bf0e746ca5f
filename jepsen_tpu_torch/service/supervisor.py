"""The fleet supervision layer: backend respawn and crash-safe router
state. The port of the reference's ``jepsen_tpu/service/supervisor.py``;
``router_state.jsonl``'s records are the reference's byte for byte, so
either package's router replays the other's file.

The router *survives* losing a backend (journal-backed migration onto
the survivors), but without this module it would never *repair* the
loss: the dead process would stay dead and the fleet run at N-1 forever,
and the router's own placement map would be single-process state — a
router crash would lose every placement, tombstone and orphan record at
once. This module closes both halves of that repair loop:

- :class:`BackendSupervisor` — when a spawned backend child dies, the
  supervisor respawns it with **bounded exponential backoff** and a
  **flap-damping circuit** (``max_failures_in_window`` child deaths /
  failed respawns inside ``window_s`` ⇒ give up and stay on the
  survivors; a crash-looping binary must not eat the fleet's CPU
  forever). The replacement child re-binds the SAME ``--journal-dir``
  — the journals of any tenant the router could not migrate away are
  still there, so the respawned process restores them by ordinary
  journal replay — and, once it passes ``/healthz``, the router
  re-adopts tenants toward it via the live ``/migrate`` machinery so
  capacity returns to N. ``JEPSEN_NO_RESPAWN=1`` is the operational
  kill-switch (checked per attempt, like every other kill-switch).
- :class:`ProcessRespawner` — the (re)spawn recipe for one real
  backend process. The child binds **port 0** and reports the bound
  port through an atomically-written ``--port-file``: probing a free
  port and then binding it has a TOCTOU hole (another process could
  take the probed port between probe and bind) that would crash-loop a
  respawn on ``EADDRINUSE``.
- :class:`RouterState` / :func:`replay_state` — an append-only
  ``router_state.jsonl`` persisting the placement map, orphan
  records, backend lost/respawned events and a **monotone placement
  epoch**, under the same torn-final-line / replay discipline as the
  tenant journal (binary read, stop at the first unparseable line,
  truncate the torn fragment on reopen). A restarted router replays it
  and then *reconciles* against live ``/healthz`` + journal-dir reality
  — a record is a hint, reality wins. The epoch (bumped past the
  replayed maximum on every router start) rides every
  ``/release``/``/adopt`` and fences a stale ex-router's in-flight
  migration with a typed 409 ``stale_epoch`` — the multi-router-HA
  primitive.

Telemetry: ``router_respawns_total{backend,outcome}`` (outcome ``ok``
/ ``failed`` / ``gave_up`` / ``disabled``), ``router_respawn_seconds``
(spawn → healthy), and the router's ``router_epoch`` gauge. A
backend whose supervisor gave up reports the typed
``respawn_gave_up`` health state on its fleet-table row (the
advisor's ``respawn_backend`` rule keys off it).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import threading
import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional
from urllib import request as _urequest

LOG = logging.getLogger("jepsen.router")

STATE_FORMAT_VERSION = 1

RESPAWN_SECONDS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                           30.0, 60.0, 120.0)


def respawn_disabled() -> bool:
    """``JEPSEN_NO_RESPAWN=1`` — checked per attempt, so flipping the
    env in a live router takes effect (the kill-switch contract)."""
    return os.environ.get("JEPSEN_NO_RESPAWN", "") == "1"


# ---------------------------------------------------------------------------
# Respawning a real backend process (the --port-file protocol).


class ProcessRespawner:
    """(Re)spawn one backend service process: the same command line,
    the same ``--journal-dir``, a FRESH child that binds port 0 and
    reports its bound port through ``port_file`` (written atomically
    by the child after bind — no probe-then-bind TOCTOU, so a respawn
    can never crash-loop on ``EADDRINUSE``). Calling the instance
    replaces ``backend.proc``/``backend.url`` in place; it raises when
    the child exits before becoming healthy or the deadline passes."""

    def __init__(self, cmd: list, *, port_file: str,
                 env: Optional[dict] = None,
                 wait_ready_s: float = 120.0) -> None:
        self.cmd = list(cmd)
        self.port_file = port_file
        self.env = env
        self.wait_ready_s = wait_ready_s

    def spawn(self, backend) -> None:
        """Start the child (any previous incarnation is killed first —
        two children must never share a journal dir)."""
        p = backend.proc
        if p is not None and p.poll() is None:
            try:
                p.kill()
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001 - already gone
                pass
        try:
            os.remove(self.port_file)  # a stale port is a wrong port
        except OSError:
            pass
        backend.proc = subprocess.Popen(
            self.cmd, env=self.env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)

    def await_ready(self, backend,
                    deadline: Optional[float] = None) -> None:
        """Wait for the bound-port report, then for ``/healthz``."""
        if deadline is None:
            deadline = _time.monotonic() + self.wait_ready_s
        port = None
        while port is None:
            try:
                with open(self.port_file, encoding="utf-8") as f:
                    txt = f.read().strip()
                if txt:
                    port = int(txt)
                    break
            except (OSError, ValueError):
                pass
            if backend.proc.poll() is not None:
                raise RuntimeError(
                    f"backend {backend.name} exited "
                    f"rc={backend.proc.poll()} before reporting its "
                    "bound port")
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"backend {backend.name} did not report a bound "
                    f"port within {self.wait_ready_s}s")
            _time.sleep(0.05)
        url = f"http://127.0.0.1:{port}"
        while True:
            try:
                with _urequest.urlopen(url + "/healthz",
                                       timeout=2) as r:
                    if r.status == 200:
                        break
            except Exception:  # noqa: BLE001 - not up yet
                pass
            if backend.proc.poll() is not None:
                raise RuntimeError(
                    f"backend {backend.name} exited "
                    f"rc={backend.proc.poll()} before becoming "
                    "healthy")
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"backend {backend.name} not healthy after "
                    f"{self.wait_ready_s}s")
            _time.sleep(0.05)
        backend.url = url

    def __call__(self, backend) -> None:
        self.spawn(backend)
        self.await_ready(backend)


# ---------------------------------------------------------------------------
# The per-backend respawn supervisor.


@dataclass(frozen=True)
class RespawnPolicy:
    """Backoff + flap-damping knobs for one backend's supervisor."""

    base_backoff_s: float = 0.25
    max_backoff_s: float = 15.0
    # The flap circuit: this many failures (child deaths + failed
    # respawn attempts) inside the sliding window give up for good.
    window_s: float = 60.0
    max_failures_in_window: int = 5


class BackendSupervisor:
    """Respawn lifecycle for ONE backend: the router's supervision
    tick calls :meth:`note_exit` + :meth:`kick` when it detects the
    child's death; a worker thread then backs off, respawns through
    the injected ``respawner`` and hands the healthy backend to
    ``on_ready`` (the router marks it up and re-adopts tenants).
    Failures accumulate in the flap window; crossing
    ``max_failures_in_window`` flips the terminal ``gave_up`` state —
    the fleet stays on the survivors and the backend row reports
    ``respawn_gave_up`` until an operator intervenes (or the router
    restarts)."""

    def __init__(self, backend, respawner: Callable, policy:
                 Optional[RespawnPolicy] = None, *, metrics=None,
                 on_ready: Optional[Callable] = None,
                 on_give_up: Optional[Callable] = None) -> None:
        self.backend = backend
        self.respawner = respawner
        self.policy = policy or RespawnPolicy()
        self.metrics = metrics
        self.on_ready = on_ready
        self.on_give_up = on_give_up
        self.respawns = 0          # successful respawns, lifetime
        self.last_respawn_s: Optional[float] = None
        self.gave_up = False
        self._attempt = 0          # consecutive failed respawns
        self._failures: "deque[float]" = deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- observation ---------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            self._trim_locked()
            return {
                "respawns": self.respawns,
                "gave_up": self.gave_up,
                "window_failures": len(self._failures),
                "last_respawn_s": self.last_respawn_s,
            }

    # -- the protocol --------------------------------------------------------

    def note_exit(self) -> None:
        """Record one observed child death (a flap-window failure)."""
        with self._lock:
            self._failures.append(_time.monotonic())
            self._trim_locked()

    def kick(self) -> None:
        """Start the respawn worker unless one is already running, the
        circuit gave up, or the supervisor was closed."""
        with self._lock:
            if self.gave_up or self._stop.is_set():
                return
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"jepsen-respawn-{self.backend.name}")
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)

    # -- the worker ----------------------------------------------------------

    def _trim_locked(self) -> None:
        now = _time.monotonic()
        while self._failures and \
                now - self._failures[0] > self.policy.window_s:
            self._failures.popleft()

    def _run(self) -> None:
        b = self.backend
        pol = self.policy
        disabled_seen = False
        while not self._stop.is_set():
            if respawn_disabled():
                # "Checked per attempt" means un-setting the env must
                # take effect on a backend that is ALREADY dead (no
                # further death will ever re-kick it): keep the worker
                # parked on a slow poll instead of exiting, and resume
                # the normal backoff/flap protocol the moment the
                # switch clears. Counted/logged once per kick.
                if not disabled_seen:
                    disabled_seen = True
                    self._count("disabled")
                    LOG.warning("backend %s dead and "
                                "JEPSEN_NO_RESPAWN=1; respawn parked "
                                "until the switch clears", b.name)
                if self._stop.wait(max(pol.max_backoff_s, 1.0)):
                    return
                continue
            with self._lock:
                self._trim_locked()
                if len(self._failures) >= pol.max_failures_in_window:
                    self.gave_up = True
            if self.gave_up:
                self._count("gave_up")
                LOG.error(
                    "backend %s FLAPPING (%d failures within %.0fs); "
                    "giving up on respawn — fleet stays on the "
                    "survivors (respawn_gave_up)", b.name,
                    pol.max_failures_in_window, pol.window_s)
                if self.on_give_up is not None:
                    try:
                        self.on_give_up(b)
                    except Exception:  # noqa: BLE001
                        LOG.warning("on_give_up hook failed",
                                    exc_info=True)
                return
            delay = min(pol.base_backoff_s * (2 ** self._attempt),
                        pol.max_backoff_s)
            if self._stop.wait(delay):
                return
            t0 = _time.monotonic()
            try:
                self.respawner(b)
            except Exception as e:  # noqa: BLE001 - a failed respawn
                self._attempt += 1
                with self._lock:
                    self._failures.append(_time.monotonic())
                self._count("failed")
                LOG.warning("respawn of backend %s failed (%s: %s); "
                            "attempt %d", b.name, type(e).__name__, e,
                            self._attempt)
                continue
            if self._stop.is_set():
                # Closed mid-respawn (drain / teardown): don't
                # resurrect a child nobody will supervise or reap.
                p = getattr(b, "proc", None)
                if p is not None and p.poll() is None:
                    try:
                        p.kill()
                        p.wait(timeout=5)
                    except Exception:  # noqa: BLE001
                        pass
                return
            seconds = _time.monotonic() - t0
            ready = True
            if self.on_ready is not None:
                # The bring-up hook may REFUSE the healthy child (the
                # router could not apply its epoch fence): that is a
                # failed attempt — count it in the flap window, back
                # off, respawn fresh (the next spawn reaps this one).
                try:
                    ready = self.on_ready(b) is not False
                except Exception:  # noqa: BLE001
                    ready = False
                    LOG.warning("on_ready hook for backend %s raised",
                                b.name, exc_info=True)
            if not ready:
                self._attempt += 1
                with self._lock:
                    self._failures.append(_time.monotonic())
                self._count("failed")
                LOG.warning("backend %s respawned but was refused at "
                            "bring-up; retrying", b.name)
                continue
            with self._lock:
                self._attempt = 0
                self.respawns += 1
                self.last_respawn_s = round(seconds, 4)
            self._count("ok")
            self._observe(seconds)
            LOG.info("backend %s respawned in %.2fs (%s)", b.name,
                     seconds, b.url)
            return

    # -- metrics -------------------------------------------------------------

    def _count(self, outcome: str) -> None:
        if self.metrics is not None:
            try:
                self.metrics.counter(
                    "router_respawns_total",
                    "Backend respawn attempts by the supervision "
                    "layer, by backend and outcome (ok / failed / "
                    "gave_up / disabled)",
                    labelnames=("backend", "outcome")).labels(
                        backend=self.backend.name,
                        outcome=outcome).inc()
            except Exception:  # noqa: BLE001 - observability only
                pass

    def _observe(self, seconds: float) -> None:
        if self.metrics is not None:
            try:
                self.metrics.histogram(
                    "router_respawn_seconds",
                    "Wall seconds from respawn start to the "
                    "replacement child passing /healthz",
                    buckets=RESPAWN_SECONDS_BUCKETS).observe(seconds)
            except Exception:  # noqa: BLE001
                pass


# ---------------------------------------------------------------------------
# Crash-safe router state: append-only router_state.jsonl.
#
# Record kinds:
#   header       {"kind": "header", "v": 1, "epoch": N}   (per open)
#   place        {"kind": "place", "tenant", "backend", ["from"]}
#   orphan       {"kind": "orphan", "tenant", "from", "causes"}
#   orphan_clear {"kind": "orphan_clear", "tenant"}
#   lost         {"kind": "lost", "backend"}               (audit)
#   respawned    {"kind": "respawned", "backend", "url"}   (audit)
#
# The "from" field on a place record is the durable tombstone of the
# previous placement (on the backend side the renamed `.migrated`
# journal is the enforcing tombstone; this record lets a restarted
# router know the move happened even when that backend is dead).


def replay_state(path: str) -> dict:
    """Reconstruct the router's durable state from its journal: the
    newest placement per tenant, the open orphan records, and the
    highest epoch any header recorded. The torn-final-line discipline
    is the tenant journal's own reader (``journal.ConsistentLines`` —
    ONE copy of the rule; a missing trailing newline would otherwise
    let the reopen garble the next header, regressing the epoch and
    unfencing a stale router). Every record is a HINT: the restarted
    router reconciles the replayed state against live ``/healthz`` +
    journal-dir reality before serving."""
    from . import journal as _journal

    out: dict = {"epoch": 0, "placement": {}, "orphans": {},
                 "records": 0, "torn_tail": False,
                 "consistent_bytes": 0}
    lines = _journal.ConsistentLines(path)
    try:
        for rec in lines:
            out["records"] += 1
            kind = rec.get("kind")
            if kind == "header":
                ep = rec.get("epoch")
                if isinstance(ep, int):
                    out["epoch"] = max(out["epoch"], ep)
            elif kind == "place":
                t, b = rec.get("tenant"), rec.get("backend")
                if isinstance(t, str) and isinstance(b, str):
                    out["placement"][t] = b
                    # A completed migration supersedes the orphan
                    # record ("orphaned until a later migration
                    # succeeds").
                    out["orphans"].pop(t, None)
            elif kind == "orphan":
                t = rec.get("tenant")
                if isinstance(t, str):
                    out["orphans"][t] = {
                        "from": rec.get("from"),
                        "causes": dict(rec.get("causes") or {}),
                        **({"note": rec["note"]} if rec.get("note")
                           else {}),
                    }
            elif kind == "orphan_clear":
                out["orphans"].pop(rec.get("tenant"), None)
            # "lost"/"respawned" are audit-only: liveness is decided
            # by reconciliation against reality, never by a record.
    except FileNotFoundError:
        return out
    out["torn_tail"] = lines.torn
    out["consistent_bytes"] = lines.consistent_bytes
    return out


class RouterState:
    """The append side of ``router_state.jsonl``: one line-buffered
    writer, append never raises into routing (failures are counted —
    losing durability must not lose a migration)."""

    def __init__(self, path: str, epoch: int,
                 truncate_to: Optional[int] = None) -> None:
        self.path = path
        self.append_failures = 0
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if truncate_to is not None:
            # A torn final line has no trailing newline: appending
            # straight after it would garble the next record (the
            # tenant journal's rule); cut back to the consistent prefix first.
            try:
                with open(path, "r+b") as tf:
                    tf.truncate(truncate_to)
            except FileNotFoundError:
                pass
        self._f = open(path, "a", buffering=1, encoding="utf-8")
        self.append({"kind": "header", "v": STATE_FORMAT_VERSION,
                     "epoch": int(epoch)})

    def append(self, rec: dict) -> bool:
        # Every record carries its wall-clock write time: the /fleet
        # timeline joins these events with per-backend busy spans, and
        # replay tolerates (ignores) unknown keys by construction.
        rec = {**rec, "t": round(_time.time(), 3)}
        try:
            with self._lock:
                self._f.write(json.dumps(rec, sort_keys=True) + "\n")
            return True
        except Exception:  # noqa: BLE001 - durability only
            self.append_failures += 1
            LOG.warning("router state append failed (%d so far)",
                        self.append_failures, exc_info=True)
            return False

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:  # noqa: BLE001
            pass
