"""Control plane: run commands on cluster nodes.

The port of the reference's ``jepsen_tpu/control/__init__.py``, which
mirrors jepsen.control (jepsen/src/jepsen/control.clj):

- :class:`Remote` protocol — connect/disconnect/execute/upload/download
  (control.clj:18-35).
- Ambient per-thread session state (host, dir, sudo, trace — the
  reference's dynamic vars, control.clj:37-49) so node-side code reads as
  ``c.exec("iptables", "-F")`` inside an :func:`on_nodes` callback.
- Shell escaping rules ported from control.clj:77-120 (:func:`escape`,
  :class:`Lit` literals, ``|`` pipes, ``>``/``>>``/``<`` redirections).
- Backends: :class:`SshRemote` (OpenSSH client subprocess — the JSch
  analogue), :class:`ShellRemote` (localhost subprocess), and
  :class:`DummyRemote` (records commands, returns canned results — the
  ``:dummy?`` mode, control.clj:38,317-331, which unlocks cluster-free
  integration tests). The docker/k8s exec variants and the node-side
  helpers (the reference's ``control/docker.py``, ``util.py`` and
  ``net.py``) are not in the port yet.

Sessions auto-reconnect with bounded retries (reconnect.clj:92-129
semantics folded into :class:`Session`).
"""

from __future__ import annotations

import logging
import re
import shutil
import subprocess
import threading
import time
from typing import Any, Callable, Iterable, Optional

from ..util import real_pmap

LOG = logging.getLogger("jepsen.control")


class Lit:
    """A literal string passed unescaped to the shell (control.clj:66-75)."""

    __slots__ = ("string",)

    def __init__(self, s: str):
        self.string = s

    def __repr__(self):
        return f"(lit {self.string!r})"


PIPE = Lit("|")
AMP = Lit("&&")

_NEEDS_QUOTES = re.compile(r"[\\\$`\"\s\(\)\{\}\[\]\*\?<>&;|~#!]")
_ESCAPE_CHARS = re.compile(r"([\\\$`\"])")


def escape(x: Any) -> str:
    """Escape a thing for the shell (control.clj:77-120): None -> "",
    literals pass through, ">", ">>", "<" are redirections, sequences are
    escaped element-wise and space-joined."""
    if x is None:
        return ""
    if isinstance(x, Lit):
        return x.string
    if isinstance(x, (list, tuple, set, frozenset)):
        return " ".join(escape(e) for e in x)
    s = str(x)
    if s in (">", ">>", "<"):
        return s
    if s == "":
        return '""'
    if _NEEDS_QUOTES.search(s):
        return '"' + _ESCAPE_CHARS.sub(r"\\\1", s) + '"'
    return s


# ---------------------------------------------------------------------------
# Ambient state (the reference's dynamic vars, control.clj:37-49)


class _Env(threading.local):
    def __init__(self):
        self.host = None
        self.session = None
        self.dir = "/"
        self.sudo = None
        self.trace = False
        self.ssh = {}


_env = _Env()


class _Binding:
    def __init__(self, **kw):
        self.kw = kw
        self.prev = {}

    def __enter__(self):
        for k, v in self.kw.items():
            self.prev[k] = getattr(_env, k)
            setattr(_env, k, v)
        return self

    def __exit__(self, *exc):
        for k, v in self.prev.items():
            setattr(_env, k, v)
        return False


def su():
    """Run body as root (control.clj:280-290)."""
    return _Binding(sudo="root")


def sudo(user: str):
    return _Binding(sudo=user)


def cd(dir: str):
    return _Binding(dir=dir)


def trace():
    return _Binding(trace=True)


def with_ssh(conf: dict):
    """Bind SSH config for the body (control.clj:383-401)."""
    return _Binding(ssh=dict(conf or {}))


def with_session(host: Any, session: "Session"):
    return _Binding(host=host, session=session)


def current_host():
    return _env.host


# ---------------------------------------------------------------------------
# Remote protocol + backends


class RemoteError(Exception):
    def __init__(self, result: dict):
        self.result = result
        super().__init__(
            f"Command exited with non-zero status {result.get('exit')} on "
            f"node {result.get('host')}:\n{result.get('cmd')}\n\n"
            f"STDOUT:\n{result.get('out')}\n\nSTDERR:\n{result.get('err')}"
        )


class Remote:
    """control.clj:18-35."""

    def connect(self, host: Any) -> "Remote":
        return self

    def disconnect(self) -> None:
        pass

    def execute(self, action: dict) -> dict:
        """action = {"cmd": str, "in": optional stdin}; returns
        {"out", "err", "exit"}."""
        raise NotImplementedError

    def upload(self, local_paths, remote_path) -> None:
        raise NotImplementedError

    def download(self, remote_paths, local_path) -> None:
        raise NotImplementedError


class DummyRemote(Remote):
    """No-op remote recording every action (the :dummy? mode). A shared
    ``log`` lists (host, cmd) tuples; ``responses`` maps regexes to canned
    stdout."""

    def __init__(self, log: Optional[list] = None,
                 responses: Optional[dict] = None, host: Any = None):
        self.log = log if log is not None else []
        self.responses = responses or {}
        self.host = host

    def connect(self, host):
        return DummyRemote(self.log, self.responses, host)

    def execute(self, action):
        self.log.append((self.host, action["cmd"]))
        out = ""
        for pat, resp in self.responses.items():
            if re.search(pat, action["cmd"]):
                out = resp(self.host, action) if callable(resp) else resp
                break
        return {"out": out, "err": "", "exit": 0}

    def upload(self, local_paths, remote_path):
        self.log.append((self.host, f"<upload {local_paths} -> {remote_path}>"))

    def download(self, remote_paths, local_path):
        self.log.append((self.host, f"<download {remote_paths} -> {local_path}>"))


class ShellRemote(Remote):
    """Executes on the local machine via bash — the no-cluster way to run
    node-side code for real (every "node" is localhost)."""

    def __init__(self, host: Any = None):
        self.host = host

    def connect(self, host):
        return ShellRemote(host)

    def execute(self, action):
        p = subprocess.run(
            ["bash", "-c", action["cmd"]],
            input=(action.get("in") or "").encode() or None,
            capture_output=True,
        )
        return {"out": p.stdout.decode(errors="replace"),
                "err": p.stderr.decode(errors="replace"),
                "exit": p.returncode}

    def upload(self, local_paths, remote_path):
        paths = local_paths if isinstance(local_paths, (list, tuple)) else [
            local_paths]
        for p in paths:
            shutil.copy(str(p), str(remote_path))

    def download(self, remote_paths, local_path):
        paths = remote_paths if isinstance(remote_paths, (list, tuple)) else [
            remote_paths]
        for p in paths:
            shutil.copy(str(p), str(local_path))


class SshRemote(Remote):
    """OpenSSH client subprocess (the clj-ssh/JSch analogue,
    control.clj:298-341). Honors the test's ssh map: username, password
    (via sshpass when present), port, private-key-path,
    strict-host-key-checking."""

    def __init__(self, conf: Optional[dict] = None, host: Any = None):
        self.conf = dict(conf or {})
        self.host = host

    def connect(self, host):
        conf = {**self.conf, **(_env.ssh or {})}
        return SshRemote(conf, host)

    def _base(self, prog: str) -> list:
        conf = self.conf
        cmd = [prog]
        if not conf.get("strict-host-key-checking"):
            cmd += ["-o", "StrictHostKeyChecking=no",
                    "-o", "UserKnownHostsFile=/dev/null"]
        if conf.get("private-key-path"):
            cmd += ["-i", str(conf["private-key-path"])]
        if conf.get("port") and prog == "ssh":
            cmd += ["-p", str(conf["port"])]
        if conf.get("port") and prog == "scp":
            cmd += ["-P", str(conf["port"])]
        return cmd

    def _dest(self) -> str:
        user = self.conf.get("username", "root")
        return f"{user}@{self.host}"

    def execute(self, action):
        argv = self._base("ssh") + [self._dest(), action["cmd"]]
        p = subprocess.run(
            argv,
            input=(action.get("in") or "").encode() or None,
            capture_output=True,
        )
        return {"out": p.stdout.decode(errors="replace"),
                "err": p.stderr.decode(errors="replace"),
                "exit": p.returncode}

    def upload(self, local_paths, remote_path):
        paths = local_paths if isinstance(local_paths, (list, tuple)) else [
            local_paths]
        argv = self._base("scp") + [str(p) for p in paths] + [
            f"{self._dest()}:{remote_path}"]
        p = subprocess.run(argv, capture_output=True)
        if p.returncode:
            raise RemoteError({"cmd": " ".join(argv), "host": self.host,
                               "exit": p.returncode,
                               "err": p.stderr.decode(errors="replace"),
                               "out": ""})

    def download(self, remote_paths, local_path):
        paths = remote_paths if isinstance(remote_paths, (list, tuple)) else [
            remote_paths]
        argv = self._base("scp") + [
            f"{self._dest()}:{p}" for p in paths] + [str(local_path)]
        p = subprocess.run(argv, capture_output=True)
        if p.returncode:
            raise RemoteError({"cmd": " ".join(argv), "host": self.host,
                               "exit": p.returncode,
                               "err": p.stderr.decode(errors="replace"),
                               "out": ""})


def ssh() -> SshRemote:
    return SshRemote()


def dummy(log: Optional[list] = None, responses: Optional[dict] = None
          ) -> DummyRemote:
    return DummyRemote(log, responses)


def shell() -> ShellRemote:
    return ShellRemote()


# ---------------------------------------------------------------------------
# Sessions (auto-reconnecting wrapper; reconnect.clj:16-129 semantics)


class Session:
    """A connection to one node, reopened on failure with bounded retries
    (control.clj:168-189 retry loop + reconnect.clj wrapper)."""

    def __init__(self, remote: Remote, host: Any, retries: int = 5):
        self.remote_proto = remote
        self.host = host
        self.retries = retries
        self.lock = threading.Lock()
        self.conn: Optional[Remote] = None

    def _ensure(self) -> Remote:
        if self.conn is None:
            self.conn = self.remote_proto.connect(self.host)
        return self.conn

    def _with_retry(self, f: Callable) -> Any:
        last = None
        for attempt in range(self.retries):
            try:
                with self.lock:
                    return f(self._ensure())
            except RemoteError:
                raise  # command-level failure; connection is fine
            except Exception as e:  # connection-level: reopen + retry
                last = e
                LOG.warning("session to %s failed (attempt %d); reopening",
                            self.host, attempt + 1)
                with self.lock:
                    try:
                        if self.conn is not None:
                            self.conn.disconnect()
                    except Exception:
                        pass
                    self.conn = None
                time.sleep(min(1.0 + attempt, 3.0))
        raise last

    def execute(self, action: dict) -> dict:
        return self._with_retry(lambda c: c.execute(action))

    def upload(self, local_paths, remote_path):
        return self._with_retry(lambda c: c.upload(local_paths, remote_path))

    def download(self, remote_paths, local_path):
        return self._with_retry(lambda c: c.download(remote_paths, local_path))

    def close(self):
        with self.lock:
            if self.conn is not None:
                try:
                    self.conn.disconnect()
                finally:
                    self.conn = None


# ---------------------------------------------------------------------------
# The ambient command API (exec/su/cd/upload/download)


def _wrap_cd(cmd: str) -> str:
    if _env.dir:
        return f"cd {escape(_env.dir)}; {cmd}"
    return cmd


def _wrap_sudo(action: dict) -> dict:
    if _env.sudo:
        cmd = escape(action["cmd"])
        user = _env.sudo
        # Skip sudo when we're already the target user (e.g. root inside a
        # container without sudo installed).
        return {
            "cmd": (
                f'if [ "$(id -un)" = {user} ]; then bash -c {cmd}; '
                f"else sudo -S -u {user} bash -c {cmd}; fi"
            ),
            "in": action.get("in"),
        }
    return action


def exec_star(*commands: str) -> str:
    """exec without escaping (control.clj:193-203)."""
    cmd = " ".join(str(c) for c in commands)
    action = _wrap_sudo({"cmd": _wrap_cd(cmd)})
    if _env.trace:
        LOG.info("Host: %s cmd: %s", _env.host, action["cmd"])
    session = _env.session
    if session is None:
        raise RuntimeError(
            "Unable to perform a control action: no session bound for this "
            "thread (use on_nodes / with_session)."
        )
    result = session.execute(action)
    result["cmd"] = cmd
    result["host"] = _env.host
    if result.get("exit", 0) != 0:
        raise RemoteError(result)
    return result.get("out", "").rstrip("\n")


def exec(*commands: Any) -> str:
    """Run an escaped shell command on the bound node, returning stdout
    (control.clj:204-210)."""
    return exec_star(*(escape(c) for c in commands))


def upload(local_paths, remote_path):
    _env.session.upload(local_paths, remote_path)
    return remote_path


def download(remote_paths, local_path):
    _env.session.download(remote_paths, local_path)


# ---------------------------------------------------------------------------
# Cluster session management (core.clj:330-338 / control.clj:415-439)


def setup_sessions(test: dict, remote: Optional[Remote] = None) -> dict:
    """Open a Session per node; stores and returns {node: Session} (also
    placed at test["sessions"])."""
    remote = remote or test.get("remote") or ssh()
    if isinstance(remote, Remote):
        proto = remote
    else:
        raise TypeError(f"not a Remote: {remote!r}")
    ssh_conf = test.get("ssh") or {}
    if ssh_conf.get("dummy?") and isinstance(proto, SshRemote):
        proto = DummyRemote(log=test.setdefault("dummy-log", []))
    sessions = {}
    with with_ssh(ssh_conf):
        for node in test.get("nodes") or []:
            sessions[node] = Session(proto, node)
    test["sessions"] = sessions
    return sessions


def close_sessions(sessions: dict) -> None:
    for s in (sessions or {}).values():
        try:
            s.close()
        except Exception:
            LOG.warning("error closing session", exc_info=True)


def on_nodes(test: dict, f: Callable, nodes: Optional[Iterable] = None
             ) -> dict:
    """Run ``f(test, node)`` in parallel on each node with that node's
    session bound (control.clj:415-431). Returns {node: result}."""
    sessions = test.get("sessions") or {}
    target = list(nodes if nodes is not None else (test.get("nodes") or []))

    def run(node):
        session = sessions.get(node)
        if session is None:
            raise RuntimeError(f"No session for node {node!r}")
        with with_session(node, session):
            return (node, f(test, node))

    return dict(real_pmap(run, target))


def with_test_nodes(test: dict, body: Callable) -> dict:
    """Evaluate ``body(node)`` on every node (control.clj:433-439)."""
    return on_nodes(test, lambda t, n: body(n))
