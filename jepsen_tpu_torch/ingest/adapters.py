"""Per-system trace adapters: raw recordings → checkable history ops.
The port of the reference's ``jepsen_tpu/ingest/adapters.py``; the same
lines give the same op stream, op for op.

Each adapter understands one system's recording format and yields
*events* — the neutral intermediate between a trace line and a history
op:

``{"phase", "corr", "conn", "f", "value", "time", "ok", "hint"}``

- ``phase``: ``"request"`` (an operation began), ``"response"`` (its
  outcome arrived), or ``"apply"`` (a committed single-point record —
  a txn-log / oplog entry is invoke+ok at one instant).
- ``corr``: the request/response correlation id (etcd request ids,
  redis connection order, zookeeper ``(session, cxid)``). ``apply``
  events need none.
- ``conn``: connection identity; process ids are assigned from it
  (first-seen order). A connection that *pipelines* — a second request
  while one is open — gets a fresh process id for the overlap, because
  a Jepsen process has at most one op in flight.
- ``time``: nanoseconds. Recordings are repaired within a bounded
  reorder window (:func:`repair_order`); an event older than the
  high-water mark minus the window is corrupt input and raises the
  strict-mode :class:`NonMonotoneHistoryError` rather than silently
  mis-cutting the history.
- ``hint``: the workload the event suggests (``register`` / ``counter``
  / ``set`` / ``append`` / ``wr``), majority-voted by the mapper.

The pairing pass (:func:`events_to_ops`) reconstructs invoke/ok
intervals from correlation ids, stamps monotone indexes, and turns
every unpaired request into a trailing ``:info`` — the open-interval
semantics the Segmenter already honors. Lines (or events) no rule
explains are **counted, never guessed**: they surface as
``ingest_unmapped_op`` provenance and fold the verdict one-sidedly to
unknown (:mod:`jepsen_tpu_torch.ingest.mapper`).

Write-only server-side logs (redis MONITOR, zookeeper txn logs,
mongodb oplogs) carry no read observations by themselves; adapters
accept the recorder-side annotations documented per adapter (redis
``# ->`` reply lines, mongodb ``"op": "q"`` read records) — without
them the check still validates write plumbing (zookeeper's setData
version chain is checked as a per-path CAS ladder) but cannot refute
read anomalies. The reference's ``docs/ingest.md`` has the adapter
table.
"""

from __future__ import annotations

import json
import re
import shlex
from bisect import insort
from typing import Any, Iterable, Optional

from ..independent import KV
from ..online.segmenter import NonMonotoneHistoryError
from ..testing import chaos

# Bounded reorder-window repair: events may arrive up to this far
# behind the newest timestamp already seen (multi-shard log merges,
# NIC timestamping jitter, mild clock skew) and are re-sorted in
# place; anything older is a corrupt recording and raises.
DEFAULT_REORDER_WINDOW_NS = 1_000_000


class Adapter:
    """One system's trace dialect. Instantiate per parse — adapters
    may keep per-connection state (redis reply attribution)."""

    name = "adapter"
    hint: Optional[str] = None  # default workload hint

    def parse_line(self, line: str) -> Optional[list]:
        """Events for one raw line: a list (possibly empty — a mapped
        line that contributes no ops, e.g. an oplog noop), or ``None``
        for a line no rule explains (counted unmapped)."""
        raise NotImplementedError

    def event(self, *, phase: str = "apply", corr: Any = None,
              conn: Any = "0", f: Any = None, value: Any = None,
              time: int = 0, ok: Optional[bool] = None,
              hint: Optional[str] = None) -> dict:
        return {"phase": phase, "corr": corr, "conn": conn, "f": f,
                "value": value, "time": int(time), "ok": ok,
                "hint": hint or self.hint}


# ---------------------------------------------------------------------------
# etcd: WAL / watch-stream ndjson with request/response phases.


class EtcdAdapter(Adapter):
    """etcd client-proxy recording, ndjson. Request lines::

        {"ts": <ns>, "conn": "c1", "id": 7, "phase": "request",
         "op": "put"|"range"|"txn_cas", "key": "r0", "value": 5,
         "cmp": 4}

    and response lines ``{"ts", "conn", "id", "phase": "response",
    "ok": true, "value": <observed>, "succeeded": <cas outcome>}``.
    put→write, range/get→read, txn_cas→cas ``[cmp, value]``; values
    are keyed ``[key v]`` so multi-key recordings split per key."""

    name = "etcd"
    hint = "register"

    _OPS = {"put": "write", "range": "read", "get": "read",
            "txn_cas": "cas"}

    def __init__(self) -> None:
        # corr -> (f, key) of the open request, for response mapping.
        self._open: dict = {}

    def parse_line(self, line):
        try:
            rec = json.loads(line)
        except ValueError:
            return None
        if not isinstance(rec, dict) or "ts" not in rec:
            return None
        conn = rec.get("conn", "0")
        corr = (conn, rec.get("id"))
        phase = rec.get("phase", "request")
        if phase == "request":
            f = self._OPS.get(rec.get("op"))
            key = rec.get("key")
            if f is None or key is None:
                return None
            if f == "write":
                value = KV(key, rec.get("value"))
            elif f == "cas":
                value = KV(key, [rec.get("cmp"), rec.get("value")])
            else:
                value = KV(key, None)
            self._open[corr] = (f, key)
            return [self.event(phase="request", corr=corr, conn=conn,
                               f=f, value=value, time=rec["ts"])]
        if phase == "response":
            f, key = self._open.pop(corr, (None, None))
            ok = rec.get("ok", True)
            if ok and f == "cas" and rec.get("succeeded") is False:
                ok = False  # definite cas miss: a clean :fail
            value = (KV(key, rec.get("value"))
                     if f == "read" and ok else None)
            return [self.event(phase="response", corr=corr, conn=conn,
                               value=value, time=rec["ts"], ok=ok)]
        return None


# ---------------------------------------------------------------------------
# redis: MONITOR lines (plus recorder-side `# ->` reply annotations).


_REDIS_LINE = re.compile(
    r"^(?P<ts>\d+\.\d+)\s+\[(?P<db>\d+)\s+(?P<conn>\S+)\]\s+"
    r"(?P<rest>.*)$")


class RedisAdapter(Adapter):
    """``redis-cli MONITOR`` output::

        1699999999.123456 [0 127.0.0.1:53222] "SET" "r0" "5"

    MONITOR logs a command when it *executes*, so write-like commands
    (SET / INCR / INCRBY / DECR / SADD / SREM) are committed
    single-point applies. Reads (GET / SMEMBERS) carry no result in
    MONITOR — alone they become indeterminate ``:info`` observations;
    a recorder that also captures replies interleaves annotation
    lines::

        1699999999.123500 [0 127.0.0.1:53222] # -> "5"

    which attach to the connection's most recent unanswered read.
    INCR-family traces hint ``counter``, SADD/SREM/SMEMBERS hint
    ``set``, SET/GET hint ``register``."""

    name = "redis"

    _WRITES = {"SET": ("write", "register"),
               "INCR": ("add", "counter"),
               "INCRBY": ("add", "counter"),
               "DECR": ("add", "counter"),
               "DECRBY": ("add", "counter"),
               "SADD": ("add", "set"),
               "SREM": ("remove", "set")}
    _READS = {"GET": ("read", "register"),
              "SMEMBERS": ("read", "set")}

    def __init__(self) -> None:
        self._seq = 0
        self._open_read: dict = {}  # conn -> (corr, f, key, hint)

    @staticmethod
    def _num(s: str):
        try:
            return int(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                return s

    def parse_line(self, line):
        m = _REDIS_LINE.match(line.strip())
        if not m:
            return None
        t = int(float(m.group("ts")) * 1_000_000_000)
        conn = m.group("conn")
        rest = m.group("rest")
        if rest.startswith("# ->"):
            open_read = self._open_read.pop(conn, None)
            if open_read is None:
                return None  # orphan reply annotation
            corr, f, key, hint = open_read
            raw = shlex.split(rest[len("# ->"):].strip())
            if hint == "set":
                value = KV(key, [self._num(v) for v in raw])
            else:
                value = KV(key, self._num(raw[0]) if raw else None)
            return [self.event(phase="response", corr=corr, conn=conn,
                               value=value, time=t, ok=True,
                               hint=hint)]
        try:
            args = shlex.split(rest)
        except ValueError:
            return None
        if not args:
            return None
        cmd = args[0].upper()
        if cmd in self._WRITES:
            f, hint = self._WRITES[cmd]
            if len(args) < 2:
                return None
            key = args[1]
            if f == "add" and hint == "counter":
                delta = (self._num(args[2]) if len(args) > 2
                         else (1 if cmd.startswith("INCR") else -1))
                if cmd.startswith("DECR") and isinstance(delta, int) \
                        and len(args) > 2:
                    delta = -delta
                value = KV(key, delta)
            elif hint == "set":
                value = KV(key, self._num(args[2]) if len(args) > 2
                           else None)
            else:
                value = KV(key, self._num(args[2]) if len(args) > 2
                           else None)
            return [self.event(conn=conn, f=f, value=value, time=t,
                               hint=hint)]
        if cmd in self._READS:
            f, hint = self._READS[cmd]
            if len(args) < 2:
                return None
            key = args[1]
            self._seq += 1
            corr = ("r", conn, self._seq)
            self._open_read[conn] = (corr, f, key, hint)
            return [self.event(phase="request", corr=corr, conn=conn,
                               f=f, value=KV(key, None), time=t,
                               hint=hint)]
        return None


# ---------------------------------------------------------------------------
# zookeeper: transaction log (committed writes; version-chain CAS).


_ZK_LINE = re.compile(
    r"^(?P<ts>\d+)\s+session:(?P<session>\S+)\s+cxid:(?P<cxid>\d+)\s+"
    r"(?P<type>create|setData|delete)\s+(?P<path>\S+)"
    r"(?:\s+(?P<data>\S+))?(?:\s+version:(?P<version>-?\d+))?\s*$")

# The tombstone "version" a delete writes; create restarts the chain
# at 0, mirroring zookeeper's per-znode version reset.
ZK_DELETED = -1


class ZookeeperAdapter(Adapter):
    """ZooKeeper transaction-log lines (as dumped by ``LogFormatter``,
    normalized to one line per committed txn)::

        <ts-ns> session:0x16b cxid:12 create /r0 <data>
        <ts-ns> session:0x16b cxid:13 setData /r0 <data> version:1
        <ts-ns> session:0x16b cxid:14 delete /r0

    The txn log holds only committed writes, so the checkable
    invariant is the per-path *version chain*: ``create`` writes
    version 0, ``setData version:n`` is a CAS ``[n-1, n]``, ``delete``
    writes the tombstone. A log with a skipped or repeated version is
    refutable with no read observations at all; data payloads are not
    modeled."""

    name = "zookeeper"
    hint = "register"

    def parse_line(self, line):
        m = _ZK_LINE.match(line.strip())
        if not m:
            return None
        t = int(m.group("ts"))
        conn = m.group("session")
        typ = m.group("type")
        path = m.group("path")
        if typ == "create":
            f, value = "write", KV(path, 0)
        elif typ == "delete":
            f, value = "write", KV(path, ZK_DELETED)
        else:  # setData
            v = m.group("version")
            if v is None:
                return None  # a setData txn always records a version
            v = int(v)
            f, value = "cas", KV(path, [v - 1, v])
        return [self.event(conn=conn, f=f, value=value, time=t)]


# ---------------------------------------------------------------------------
# mongodb: oplog ndjson (committed writes; optional recorded reads).


class MongoAdapter(Adapter):
    """MongoDB oplog entries, ndjson (``mongodump``/change-stream
    style)::

        {"ts": {"t": 12, "i": 3}, "op": "i", "ns": "db.c",
         "o": {"_id": "r0", "value": 5}}
        {"ts": ..., "op": "u", "ns": "db.c", "o2": {"_id": "r0"},
         "o": {"$set": {"value": 6}}}
        {"ts": ..., "op": "d", "ns": "db.c", "o": {"_id": "r0"}}

    ``i``/``u``/``d`` are committed single-point writes keyed by
    ``_id`` (delete writes ``None``); ``"op": "n"`` noops are mapped
    but contribute nothing. A recorder that mirrors client reads
    appends ``{"op": "q", "o2": {"_id": k}, "value": v}`` records —
    the oplog alone carries no read observations. Time is
    ``ts.t * 1e9 + ts.i`` (the oplog's total order)."""

    name = "mongodb"
    hint = "register"

    def parse_line(self, line):
        try:
            rec = json.loads(line)
        except ValueError:
            return None
        if not isinstance(rec, dict) or "op" not in rec:
            return None
        ts = rec.get("ts") or {}
        t = int(ts.get("t", 0)) * 1_000_000_000 + int(ts.get("i", 0))
        conn = rec.get("conn", rec.get("ns", "oplog"))
        op = rec["op"]
        if op == "n":
            return []
        if op == "i":
            o = rec.get("o") or {}
            if "_id" not in o:
                return None
            return [self.event(conn=conn, f="write",
                               value=KV(o["_id"], o.get("value")),
                               time=t)]
        if op == "u":
            o2 = rec.get("o2") or {}
            sets = (rec.get("o") or {}).get("$set") or {}
            if "_id" not in o2 or "value" not in sets:
                return None
            return [self.event(conn=conn, f="write",
                               value=KV(o2["_id"], sets["value"]),
                               time=t)]
        if op == "d":
            o = rec.get("o") or {}
            if "_id" not in o:
                return None
            return [self.event(conn=conn, f="write",
                               value=KV(o["_id"], None), time=t)]
        if op == "q":
            o2 = rec.get("o2") or {}
            if "_id" not in o2:
                return None
            return [self.event(conn=conn, f="read",
                               value=KV(o2["_id"], rec.get("value")),
                               time=t)]
        return None


# ---------------------------------------------------------------------------
# jsonl: generic column-mapping adapter (pcap-style observations).


class JsonlAdapter(Adapter):
    """Generic ndjson adapter driven by a column mapping — the escape
    hatch for pcap dissectors and custom recorders. ``columns`` maps
    event fields to the recording's column names (defaults in
    :data:`DEFAULT_COLUMNS`); ``time_scale`` multiplies the recorded
    time into nanoseconds (``1e9`` for float seconds)."""

    name = "jsonl"

    DEFAULT_COLUMNS = {"time": "time", "phase": "phase", "corr": "corr",
                       "conn": "conn", "f": "f", "key": "key",
                       "value": "value", "ok": "ok"}

    def __init__(self, columns: Optional[dict] = None,
                 time_scale: float = 1, hint: Optional[str] = None):
        self.columns = dict(self.DEFAULT_COLUMNS)
        self.columns.update(columns or {})
        self.time_scale = time_scale
        self.hint = hint

    def parse_line(self, line):
        try:
            rec = json.loads(line)
        except ValueError:
            return None
        if not isinstance(rec, dict):
            return None
        col = self.columns
        if col["time"] not in rec or col["f"] not in rec:
            return None
        t = int(rec[col["time"]] * self.time_scale)
        value = rec.get(col["value"])
        key = rec.get(col["key"])
        if key is not None:
            value = KV(key, value)
        return [self.event(
            phase=rec.get(col["phase"], "apply"),
            corr=rec.get(col["corr"]),
            conn=rec.get(col["conn"], "0"),
            f=rec[col["f"]], value=value, time=t,
            ok=rec.get(col["ok"]))]


ADAPTERS: dict = {
    "etcd": EtcdAdapter,
    "redis": RedisAdapter,
    "zookeeper": ZookeeperAdapter,
    "mongodb": MongoAdapter,
    "jsonl": JsonlAdapter,
}


def by_name(name: str, **opts: Any) -> Adapter:
    try:
        cls = ADAPTERS[name]
    except KeyError:
        raise KeyError(f"unknown adapter {name!r}; known: "
                       f"{sorted(ADAPTERS)}") from None
    return cls(**opts)


# ---------------------------------------------------------------------------
# Reorder repair + pairing: events → history ops.


def repair_order(events: list, window_ns: int) -> list:
    """Stable re-sort of mildly out-of-order events within a bounded
    window. An event older than ``high-water − window`` is a corrupt
    recording (a mis-merged log, a shuffled ndjson) and raises the
    strict-mode :class:`NonMonotoneHistoryError` instead of being
    silently re-slotted: the offline planner's contract for fully
    recorded input."""
    out: list = []
    hi: Optional[int] = None
    for i, e in enumerate(events):
        t = e["time"]
        if hi is None or t >= hi:
            out.append(e)
            hi = t
            continue
        if t < hi - window_ns:
            raise NonMonotoneHistoryError(i, hi - window_ns)
        # In-window straggler: stable insert (after equal times).
        insort(out, e, key=lambda x: x["time"])
    return out


def events_to_ops(events: Iterable[dict], *,
                  reorder_window_ns: int = DEFAULT_REORDER_WINDOW_NS
                  ) -> tuple[list[dict], dict]:
    """Pair repaired events into scheduler-shaped history ops.

    Returns ``(ops, stats)``: ops carry monotone ``index`` stamps (the
    strict Segmenter's precondition) and every unpaired request closes
    as a trailing ``:info`` — its interval stays open, exactly what
    the Segmenter's quiescence rule expects of an indeterminate op.
    Orphan responses (a reply whose request never appeared — or
    arrived beyond the reorder window) are counted ``unmapped`` in
    the stats, never guessed into an interval."""
    events = repair_order(list(events), reorder_window_ns)
    ops: list[dict] = []
    conn_proc: dict = {}      # conn -> current process id
    busy: dict = {}           # conn -> open corr on its current process
    proc_of_corr: dict = {}   # corr -> (process, invoke op)
    hints: dict = {}
    n_procs = 0
    unmapped = 0
    for e in events:
        if e.get("hint"):
            hints[e["hint"]] = hints.get(e["hint"], 0) + 1
        conn = e["conn"]
        phase = e["phase"]
        if phase == "response":
            got = proc_of_corr.pop(e["corr"], None)
            if got is None:
                unmapped += 1  # orphan response
                continue
            proc, invoke = got
            ok = e.get("ok")
            typ = "ok" if ok in (True, None) else "fail"
            ops.append({"type": typ, "process": proc,
                        "f": invoke["f"],
                        "value": (e["value"] if e["value"] is not None
                                  else invoke["value"]),
                        "time": e["time"]})
            if busy.get(conn) == e["corr"]:
                del busy[conn]
            continue
        # request | apply: allocate/rotate the connection's process.
        proc = conn_proc.get(conn)
        if proc is None or conn in busy:
            # First op on the conn, or a pipelined request while one
            # is open: a Jepsen process has one op in flight, so the
            # overlap gets a fresh process id.
            proc = n_procs
            n_procs += 1
            conn_proc[conn] = proc
        invoke = {"type": "invoke", "process": proc, "f": e["f"],
                  "value": e["value"], "time": e["time"]}
        ops.append(invoke)
        if phase == "apply":
            ops.append({"type": "ok", "process": proc, "f": e["f"],
                        "value": e["value"], "time": e["time"]})
        else:
            busy[conn] = e["corr"]
            proc_of_corr[e["corr"]] = (proc, invoke)
    # Unpaired requests: open intervals — a trailing :info each.
    t_end = (ops[-1]["time"] + 1) if ops else 0
    for corr in sorted(proc_of_corr, key=repr):
        proc, invoke = proc_of_corr[corr]
        ops.append({"type": "info", "process": proc, "f": invoke["f"],
                    "value": invoke["value"], "time": t_end})
    for i, op in enumerate(ops):
        op["index"] = i  # monotone by construction; strict-mode safe
    stats = {"events": len(events), "processes": n_procs,
             "open_intervals": len(proc_of_corr),
             "orphan_responses": unmapped, "hints": hints}
    return ops, stats


def parse_trace(lines: Iterable[str], adapter: Adapter, *,
                reorder_window_ns: int = DEFAULT_REORDER_WINDOW_NS,
                metrics=None) -> dict:
    """Parse raw trace ``lines`` through ``adapter`` into history ops.

    Returns ``{"ops", "unmapped", "stats", "hint"}``. Unexplained or
    fault-hit lines are counted (``ingest_unmapped_total{adapter}``),
    never guessed — the mapper folds any non-zero count one-sidedly to
    unknown. The per-line ``ingest.parse`` chaos seam models a parser
    fault (truncated read, codec bug): an injected raise costs exactly
    that line, and the degradation rides the same unmapped path."""
    events: list = []
    unmapped = 0
    n_lines = 0
    for line in lines:
        if not line.strip():
            continue
        n_lines += 1
        try:
            chaos.fire("ingest.parse")
            evs = adapter.parse_line(line)
        except NonMonotoneHistoryError:
            raise
        except Exception:  # noqa: BLE001 - one bad line, one count
            evs = None
        if evs is None:
            unmapped += 1
            continue
        events.extend(evs)
    ops, stats = events_to_ops(events,
                               reorder_window_ns=reorder_window_ns)
    unmapped += stats.pop("orphan_responses")
    stats["lines"] = n_lines
    hints = stats.pop("hints")
    hint = (max(sorted(hints), key=lambda h: hints[h])
            if hints else adapter.hint)
    _count(metrics, adapter.name, len(ops), unmapped)
    return {"ops": ops, "unmapped": unmapped, "stats": stats,
            "hint": hint, "adapter": adapter.name}


def _count(metrics, adapter: str, n_ops: int, n_unmapped: int) -> None:
    """``ingest_ops_total{adapter}`` / ``ingest_unmapped_total
    {adapter}`` on the port's :class:`~jepsen_tpu_torch.telemetry.Registry`.
    Never raises into a parse."""
    if metrics is None:
        return
    try:
        c = metrics.counter(
            "ingest_ops_total",
            "History ops produced from ingested raw trace lines",
            labelnames=("adapter",))
        c.labels(adapter=adapter).inc(n_ops)
        u = metrics.counter(
            "ingest_unmapped_total",
            "Raw trace lines (or events) no adapter rule explained; "
            "each folds the verdict one-sidedly to unknown",
            labelnames=("adapter",))
        u.labels(adapter=adapter).inc(n_unmapped)
    except Exception:  # noqa: BLE001 - observability never sinks a parse
        pass
