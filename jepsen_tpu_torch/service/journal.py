"""Crash-safe per-tenant verdict journal. The port of the reference's
``jepsen_tpu/service/journal.py``: its files are the reference's, byte for
byte but for wall-clock fields, so either package replays the other's.

A service crash used to lose every per-tenant verdict: reconnecting
clients had to resubmit their whole history. The journal is the
durability layer underneath the fold — one append-only JSONL file per
tenant under ``journal_dir``, one record per decided segment, written
from the scheduler's ``on_segment`` hook *inside the fold lock* (so a
journaled watermark can never run ahead of the in-memory fold state).
On restart, :func:`replay` reconstructs each tenant's watermark,
verdict counters, violation witness and per-key carried end-state
sets; the service seeds its segmenter and the scheduler's stream state
from them (``SegmentScheduler.restore_stream``), and a reconnecting
client reads its watermark from ``GET /tenants``
(``resumed_from_journal``) and resumes submitting from there instead
of resubmitting history.

File format (``<journal_dir>/<quoted tenant>.jsonl``):

- line 1 — ``{"kind": "header", "v": 1, "tenant": …, "model": {…}}``.
  The model identity is the kernel-cache identity
  (``Model.cache_key()`` + ``cache_args()``); replaying a journal
  against a different model family raises the TYPED
  :class:`JournalModelMismatchError` — a cas-register journal must
  never silently seed a queue fold.
- one ``{"kind": "segment", …}`` line per decided segment: the
  display row (seq, key repr, verdict, index range, terminal) plus
  the stream watermark AFTER this segment and the key's new carry —
  the decoded (table-independent) end-state set, ``"unknown"`` where
  the carry was lost, or absent for terminal segments. Keys and
  states are JSON-round-tripped (tuples survive via a freeze/thaw
  codec); a key or state the codec cannot round-trip journals
  ``carry_ok: false`` and replays as a LOST carry — the one-sided
  degradation again, never a wrong state.

Torn final lines — the signature of a kill-9 mid-append — are
expected: replay stops at the first unparseable line and keeps the
prefix (every complete record was written under the fold lock, so any
prefix is a consistent fold state). Append failures (disk full, the
``journal.fsync`` chaos seam) are counted and swallowed: the journal
loses durability, never a verdict.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Optional
from urllib.parse import quote, unquote

from ..checker import provenance as _prov
from ..models import Model
from ..online.segmenter import SINGLE_KEY
from ..testing import chaos as _chaos

LOG = logging.getLogger("jepsen.service")

FORMAT_VERSION = 1

# Display rows kept by replay (the fold counters stay exact): matches
# SegmentScheduler.max_segment_rows' default bounded table.
MAX_REPLAY_ROWS = 2000


class JournalError(RuntimeError):
    """Base class of journal read/replay failures."""


class JournalModelMismatchError(JournalError):
    """The journal was written for a different model family — its
    carried states are meaningless under this fold's model."""


# ---------------------------------------------------------------------------
# JSON round-trip codec: the decoded (semantic) states and keys are
# tuples-of-hashables; JSON has no tuples, so freeze→lists on write and
# thaw→tuples on read. Anything the codec can't round-trip EXACTLY
# (sets, exotic objects) degrades to a lost carry, never a wrong one.


def _jsonable(v: Any) -> Any:
    """Tuples→lists, recursively; raises TypeError on the
    un-round-trippable (actual lists would thaw into tuples and change
    identity, so they are refused too — decoded states never contain
    them)."""
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"not journal-round-trippable: {type(v).__name__}")


def _thaw(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_thaw(x) for x in v)
    return v


def model_identity(model: Model) -> dict:
    """The journal header's model identity — the same identity the
    device kernel cache keys on, so "same family" here means "same
    fold behavior"."""
    return {
        "name": model.name,
        "key": _jsonable(tuple(model.cache_key())),
        "args": _jsonable(tuple(model.cache_args())),
    }


def tenant_path(journal_dir: str, tenant: str) -> str:
    """Filesystem-safe per-tenant journal path (tenant names are an
    external input; percent-quote everything non-alphanumeric)."""
    return os.path.join(journal_dir, quote(tenant, safe="") + ".jsonl")


def scan(journal_dir: str) -> dict[str, str]:
    """tenant -> journal path, for every journal file present."""
    out: dict[str, str] = {}
    try:
        names = sorted(os.listdir(journal_dir))
    except FileNotFoundError:
        return out
    for name in names:
        if name.endswith(".jsonl"):
            out[unquote(name[:-len(".jsonl")])] = os.path.join(
                journal_dir, name)
    return out


class ConsistentLines:
    """The ONE torn-final-line reader every append-only jsonl replay
    in the service shares (the tenant journal here, the router's
    ``router_state.jsonl`` in service/supervisor.py — a rule patched
    in one copy must not silently leave the other wrong). Iterates
    the parseable JSON-dict records of the file's consistent prefix;
    after iteration ``.torn`` says whether a torn tail was dropped
    and ``.consistent_bytes`` is the exact byte length of that prefix
    (the reopening writer's truncation offset).

    Torn = the kill-9 signature: a final line missing its newline
    (even when its bytes happen to parse — appending after it would
    garble the next record, and the garbled line would make the NEXT
    replay silently drop every later record), an undecodable or
    unparseable line, or a non-dict record. Replay stops there; an
    append-only writer cannot have put reachable records after it."""

    def __init__(self, path: str):
        self.path = path
        self.torn = False
        self.consistent_bytes = 0

    def __iter__(self):
        with open(self.path, "rb") as f:
            for raw in f:
                if not raw.endswith(b"\n"):
                    self.torn = True
                    LOG.warning("%s: final line lacks its newline; "
                                "dropping the torn tail", self.path)
                    return
                try:
                    line = raw.decode("utf-8").strip()
                except UnicodeDecodeError:
                    self.torn = True
                    return
                if not line:
                    self.consistent_bytes += len(raw)
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    self.torn = True
                    LOG.warning("%s: torn line; replaying the "
                                "consistent prefix", self.path)
                    return
                if not isinstance(rec, dict):
                    self.torn = True
                    return
                self.consistent_bytes += len(raw)
                yield rec


class TenantJournal:
    """The append side: one open file, one record per decided segment.
    ``append_segment`` is called from the scheduler worker under the
    fold lock; it must be cheap (one line-buffered write) and must
    NEVER raise into the fold (failures are counted on the instance
    and logged)."""

    def __init__(self, path: str, tenant: str, model: Model,
                 fsync: bool = False, fresh_header: bool = True,
                 truncate: bool = False,
                 truncate_to: Optional[int] = None):
        self.path = path
        self.tenant = tenant
        self.fsync = fsync
        self.append_failures = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # A torn FINAL line has no trailing newline: appending straight
        # after it would garble the next record onto the fragment, and
        # the garbled line would stop the NEXT replay early (silently
        # dropping every later record). ``truncate_to`` cuts the file
        # back to replay's consistent prefix first; ``truncate``
        # discards it entirely (reopening over a torn-HEADER file
        # replay deemed empty).
        if truncate_to is not None and not truncate:
            try:
                with open(path, "r+b") as tf:
                    tf.truncate(truncate_to)
            except FileNotFoundError:
                pass
        # Line-buffered append: a complete record is flushed to the OS
        # per call (fsync additionally forces it to disk); a kill-9
        # mid-write leaves at most one torn FINAL line, which replay
        # tolerates (and the next reopen trims).
        self._f = open(path, "w" if truncate else "a", buffering=1,
                       encoding="utf-8")
        if fresh_header:
            self._write({"kind": "header", "v": FORMAT_VERSION,
                         "tenant": tenant,
                         "model": model_identity(model)})

    def _write(self, rec: dict) -> None:
        _chaos.fire("journal.fsync")
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        if self.fsync:
            os.fsync(self._f.fileno())

    def append_segment(self, row: dict, key: Any, carry: Any,
                       watermark: int) -> bool:
        """One decided-segment record; returns False on a swallowed
        append failure (durability lost, verdict unaffected)."""
        rec = {
            "kind": "segment",
            "seq": row.get("seq"),
            "key": row.get("key"),  # repr'd display key
            "ops": row.get("ops"),
            "start_index": row.get("start_index"),
            "end_index": row.get("end_index"),
            "terminal": bool(row.get("terminal")),
            "valid": row.get("valid"),
            "watermark": int(watermark),
        }
        if row.get("info"):
            rec["info"] = row["info"]
        if row.get("causes"):
            # The structured why-unknown provenance rides the journal,
            # so a restart restores the cause Pareto (cause params are
            # JSON scalars by construction). `cause_counts` carries
            # the EXACT counts when the display list was truncated.
            rec["causes"] = row["causes"]
            if row.get("cause_counts"):
                rec["cause_counts"] = row["cause_counts"]
        if self.append_failures:
            # A prior append was swallowed: every later record admits
            # it, so replay can tell a mid-stream GAP (stale carries,
            # possibly a lost invalid verdict) from a clean journal —
            # a gap must degrade the restored fold, never restore a
            # definite True over records that never landed.
            rec["after_append_failure"] = True
        # Every record carries its exact key (terminal ones too: a
        # replayed terminal segment must INVALIDATE the key's earlier
        # carry — its effects are not enumerable, so ops submitted
        # after a post-drain restart would otherwise be checked from a
        # state missing them). An un-round-trippable KEY journals a
        # repr only (replay cannot address it and poisons the stream's
        # carries).
        try:
            key_enc = ({"single": True} if key == SINGLE_KEY
                       else {"k": _jsonable(key)})
        except TypeError:
            key_enc = {"repr": str(row.get("key"))}
        rec["key_enc"] = key_enc
        if not row.get("terminal"):
            # The key's carry AFTER this segment, round-tripped for
            # replay; un-round-trippable STATES under a good key lose
            # only THAT key's carry ("unknown").
            rec["carry_ok"] = "repr" not in key_enc
            if rec["carry_ok"]:
                try:
                    rec["carry"] = (
                        "unknown" if carry == "unknown"
                        else None if carry is None
                        else [_jsonable(s) for s in carry])
                except TypeError:
                    rec["carry"] = "unknown"
        try:
            self._write(rec)
            return True
        except Exception:  # noqa: BLE001 - durability only, never fold
            self.append_failures += 1
            LOG.warning("journal append failed for tenant %s (%d so "
                        "far); verdicts unaffected", self.tenant,
                        self.append_failures, exc_info=True)
            return False

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:  # noqa: BLE001
            pass


def replay(path: str, model: Model) -> dict:
    """Reconstruct one tenant's fold state from its journal.

    Returns the kwargs shape ``SegmentScheduler.restore_stream``
    takes, plus ``tenant``/``records``/``torn_tail``/``degraded``/
    ``consistent_bytes``/``fresh``. Raises
    :class:`JournalModelMismatchError` when the header names a
    different model family, :class:`JournalError` when the file has no
    parseable header at all (a parseable non-header first record — a
    foreign file).

    Soundness of the restore:

    - Only records COVERED by the final journaled watermark (their
      ``end_index`` <= it) restore carries, seq numbering and fold
      counters: a record beyond the watermark belongs to a cut that
      was still partially decided at the crash — restoring its carry
      would hand the resubmitted ops their OWN post-states to check
      from (a verdict flip), and counting its valid verdict would let
      the fold claim definite True over the undecided sibling
      segments. Uncovered valid/unknown records are dropped (their
      ops sit above the watermark, so the resume protocol re-checks
      them from the committed carries); an uncovered INVALID record
      keeps its verdict and witness — refutation evidence is real
      regardless of coverage.
    - ``degraded`` (swallowed append failures admitted by later
      records, or a committed-seq gap) poisons carries and pins the
      restored fold off definite-True with one phantom unknown.
    - A torn FINAL line (kill-9 mid-append) is tolerated — replay
      keeps the consistent prefix, reports ``torn_tail: True`` and
      ``consistent_bytes`` (the byte length of that prefix) so the
      reopening writer can TRUNCATE the torn fragment instead of
      concatenating the next record onto it.
    """
    want = model_identity(model)
    header: Optional[dict] = None
    n_records = 0
    torn = False
    consistent_bytes = 0
    watermark = -1
    next_seq = 0
    carry: dict[Any, Any] = {}
    carry_poisoned = False
    cause_counts: dict[str, int] = {}
    degraded = False  # swallowed append failures / seq gaps
    seen_seqs: set = set()
    n_decided = n_invalid = n_unknown = 0
    violation: Optional[dict] = None
    segments: list[dict] = []
    # Records parsed but not yet covered by the watermark (segments of
    # cuts that were still in flight); folded in file order the moment
    # a later record's watermark covers them, dropped at EOF if never.
    pending: list[dict] = []

    def _fold(rec: dict) -> None:
        nonlocal next_seq, carry_poisoned, violation
        nonlocal n_decided, n_invalid, n_unknown
        n_decided += 1
        v = rec.get("valid")
        if v is False:
            n_invalid += 1
        elif v is not True:
            n_unknown += 1
        seq = rec.get("seq")
        if isinstance(seq, int):
            seen_seqs.add(seq)
            next_seq = max(next_seq, seq + 1)
        row = {k: rec.get(k) for k in
               ("seq", "key", "ops", "start_index", "end_index",
                "terminal", "valid")}
        row.update(engine="journal", members=0, wall_s=0.0,
                   info="replayed from journal")
        if rec.get("causes"):
            row["causes"] = rec["causes"]
            if rec.get("cause_counts"):
                # Exact counts outrank the bounded display list (a
                # many-member segment journals both).
                for code, cnt in rec["cause_counts"].items():
                    if isinstance(cnt, (int, float)):
                        cause_counts[code] = (cause_counts.get(code, 0)
                                              + int(cnt))
            else:
                _prov.add_counts(cause_counts, rec["causes"])
        elif v is not True and v is not False:
            # A pre-provenance journal (or a record written by a
            # taxonomy hole): the restored Pareto still accounts for
            # the unknown.
            _prov.add_counts(cause_counts, ["unattributed"])
        if len(segments) < MAX_REPLAY_ROWS:
            segments.append(row)
        if v is False and violation is None:
            violation = {"segment": dict(row), "refutation": None,
                         "replayed": True}
        ke = rec.get("key_enc") or {}
        if ke.get("single"):
            k = SINGLE_KEY
        elif "k" in ke:
            k = _thaw(ke["k"])
        else:
            k = None  # un-round-trippable (or pre-key_enc) key
        if rec.get("terminal"):
            # The terminal segment consumed ops whose effects no carry
            # enumerates: a later restart continuing this stream must
            # NOT check from the key's pre-terminal carry (stale — a
            # wrong-state refutation). Invalidate it; an unaddressable
            # key poisons the stream's carries wholesale.
            if k is None:
                carry_poisoned = True
            else:
                carry[k] = "unknown"
        else:
            c = rec.get("carry")
            if k is None or not rec.get("carry_ok"):
                # The key is known only by repr — it cannot be
                # addressed in the restored carry map, and a future
                # segment of it would otherwise check from the
                # model's INIT state, which could wrongly REFUTE.
                # Poison the whole restored stream's carries instead
                # (every future segment folds unknown): strictly
                # one-sided.
                carry_poisoned = True
            elif c == "unknown" or c is None:
                # Lost carry, or a segment journaled with no carry
                # recorded: unknown forward.
                carry[k] = "unknown"
            else:
                carry[k] = [_thaw(s) for s in c]

    # One streaming pass, bounded memory (the pending buffer holds at
    # most the in-flight cuts at the crash): the restore keeps the
    # fold COUNTERS exact for the committed prefix but only the first
    # MAX_REPLAY_ROWS display rows (mirroring the scheduler's own
    # bounded segment table). The shared torn-final-line reader
    # (ConsistentLines) decides what counts as the consistent prefix
    # — a dropped torn record's ops sit above the reported watermark,
    # so the resume protocol re-checks them: one-sided, never a flip.
    lines = ConsistentLines(path)
    for rec in lines:
        if header is None:
            if rec.get("kind") != "header":
                # A parseable first record that is NOT a header
                # means this is some other file (e.g.
                # --journal-dir pointed at a directory holding
                # ledger.jsonl): a misconfiguration the operator
                # must see, not silently replay.
                raise JournalError(
                    f"journal {path}: missing header record")
            if rec.get("v") != FORMAT_VERSION:
                raise JournalError(
                    f"journal {path}: unsupported format version "
                    f"{rec.get('v')!r}")
            if rec.get("model") != want:
                raise JournalModelMismatchError(
                    f"journal {path} was written for model "
                    f"{(rec.get('model') or {}).get('name')!r} "
                    f"{rec.get('model')!r}; this service folds "
                    f"{want!r} — refusing to seed carried states "
                    "across model families")
            header = rec
            continue
        n_records += 1
        if rec.get("kind") != "segment":
            continue
        if rec.get("after_append_failure"):
            degraded = True
        pending.append(rec)
        new_wm = int(rec.get("watermark", -1))
        if new_wm > watermark:
            watermark = new_wm
            still = []
            cover: dict = {}  # (seq, key) -> newest covered record
            for p in pending:  # file order preserved
                if int(p.get("end_index", -1)) <= watermark:
                    # Last-wins per (seq, key): after a crash, a
                    # resubmission re-decides an UNCOVERED cut
                    # under the same seq, and the next restart
                    # sees both the stale record and the fresh
                    # one — only the newest may fold (the stale
                    # one would double-count and, folded last,
                    # resurrect a stale carry).
                    cover[(p.get("seq"), p.get("key"))] = p
                else:
                    still.append(p)
            pending = still
            for p in cover.values():
                _fold(p)
    torn = lines.torn
    consistent_bytes = lines.consistent_bytes
    if header is None:
        # Empty file, or the HEADER line itself was torn (the process
        # died inside the very first write — an append-only writer
        # cannot have put records after it). This journal holds
        # nothing: replay as a FRESH tenant instead of bricking every
        # restart behind a file an operator must hand-delete.
        LOG.warning("journal %s: no usable records (empty or torn "
                    "header); treating as fresh", path)
        return {
            "tenant": "", "watermark": -1, "next_seq": 0, "carry": {},
            "carry_poisoned": False, "n_decided": 0, "n_invalid": 0,
            "n_unknown": 0, "violation": None, "segments": [],
            "cause_counts": {},
            "records": 0, "torn_tail": torn, "degraded": False,
            "consistent_bytes": 0, "fresh": True,
        }
    # Records never covered by the watermark: cuts in flight at the
    # crash. Their ops sit ABOVE the watermark, so the resume protocol
    # re-checks them from the committed carries — dropping the
    # valid/unknown ones loses nothing and keeps the restored fold
    # honest (a kept valid verdict would claim definite True over the
    # undecided sibling segments of the same cut). An INVALID one
    # keeps its verdict and witness: refutation evidence is real
    # whether or not the cut completed.
    for p in pending:
        if p.get("valid") is False:
            # Verdict + witness only: its seq must NOT extend the
            # restored numbering (the cut never completed — counting
            # it would fake a committed-prefix gap), and its carry is
            # irrelevant to an invalid stream.
            n_decided += 1
            n_invalid += 1
            row = {k: p.get(k) for k in
                   ("seq", "key", "ops", "start_index", "end_index",
                    "terminal", "valid")}
            row.update(engine="journal", members=0, wall_s=0.0,
                       info="replayed from journal (uncovered cut)")
            if len(segments) < MAX_REPLAY_ROWS:
                segments.append(row)
            if violation is None:
                violation = {"segment": dict(row), "refutation": None,
                             "replayed": True}
        else:
            LOG.info("journal %s: dropping uncovered record "
                     "(seq %s, key %s) — its cut was still in flight",
                     path, p.get("seq"), p.get("key"))
    if seen_seqs and seen_seqs != set(range(next_seq)):
        # A mid-stream seq GAP in the COMMITTED prefix can only come
        # from a swallowed append failure (the file is append-only; a
        # kill-9 truncates the tail, it cannot punch holes). The
        # missing cut may have moved a carry — or held the stream's
        # only invalid verdict.
        degraded = True
    if degraded:
        # One-sided restore: carries may be stale (poison them all)
        # and a lost record could have been invalid, so the restored
        # fold must never report a definite True — one phantom
        # unknown pins it (provenance: journal_gap). Journaled invalid
        # verdicts still stand (their refutation evidence is real
        # regardless).
        carry_poisoned = True
        n_unknown += 1
        n_decided += 1
        _prov.add_counts(cause_counts, [_prov.cause("journal_gap")])
        LOG.warning("journal %s: append-failure gap detected; "
                    "restoring with poisoned carries and an unknown "
                    "fold", path)
    return {
        "tenant": header.get("tenant") or "",
        "watermark": watermark,
        "next_seq": next_seq,
        "carry": carry,
        "carry_poisoned": carry_poisoned,
        "n_decided": n_decided,
        "n_invalid": n_invalid,
        "n_unknown": n_unknown,
        "violation": violation,
        "segments": segments,
        "cause_counts": cause_counts,
        "records": n_records,
        "torn_tail": torn,
        "degraded": degraded,
        "consistent_bytes": consistent_bytes,
    }
