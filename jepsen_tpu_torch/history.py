"""Operation & history data model (``Op``, ``Interval``, ``History``).

Histories are sequences of op maps ``{:type :invoke|:ok|:fail|:info,
:process p, :f f, :value v, :time t, :index i}``; invocations are paired
with completions by process. Process ids: clients are ints; anything else
(the nemesis) is not a client. ``History.load``/``save`` read and write
the store's ``history.edn`` (one op map a line), as the reference's
``jepsen_tpu/history.py`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Iterator, Optional

from . import edn
from .edn import K, Keyword

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

NEMESIS = "nemesis"

_TYPE_KWS = {INVOKE: K(INVOKE), OK: K(OK), FAIL: K(FAIL), INFO: K(INFO)}
_STD_KEYS = frozenset(
    (K("type"), K("f"), K("process"), K("value"), K("time"), K("index"), K("error")))


@dataclass(frozen=True)
class Op:
    """One history event.

    ``f`` and ``value`` are domain-defined (e.g. f="cas", value=(1, 2)).
    ``time`` is nanoseconds on the test's monotonic clock. ``index`` is the
    op's position in the indexed history, -1 if unassigned.
    """

    type: str
    process: Any  # int client process | "nemesis"
    f: Any
    value: Any = None
    time: int = -1
    index: int = -1
    error: Any = None
    extra: tuple = field(default_factory=tuple)  # sorted (key, value) pairs
    f_is_kw: bool = True  # whether :f serializes as a keyword (vs raw value)

    @property
    def is_invoke(self) -> bool:
        return self.type == INVOKE

    @property
    def is_ok(self) -> bool:
        return self.type == OK

    @property
    def is_fail(self) -> bool:
        return self.type == FAIL

    @property
    def is_info(self) -> bool:
        return self.type == INFO

    @property
    def is_client(self) -> bool:
        return isinstance(self.process, int)

    @property
    def is_nemesis(self) -> bool:
        return self.process == NEMESIS

    def with_(self, **kw: Any) -> "Op":
        return replace(self, **kw)

    @classmethod
    def from_dict(cls, m: dict) -> "Op":
        """An Op from a plain scheduler op map (string keys); keys other
        than the standard fields go to ``extra``, sorted."""
        std = {"type", "process", "f", "value", "time", "index", "error"}
        extra = tuple(sorted(((k, v) for k, v in m.items() if k not in std), key=repr))
        return cls(type=m.get("type"), process=m.get("process"), f=m.get("f"),
                   value=m.get("value"), time=m.get("time", -1), index=m.get("index", -1),
                   error=m.get("error"), extra=extra)

    def get(self, key: Any, default: Any = None) -> Any:
        """Look up an extra field; a string key also matches the keyword
        with that name."""
        for k, v in self.extra:
            if k == key or (isinstance(k, Keyword) and k.name == key):
                return v
        return default

    @classmethod
    def from_edn(cls, m: dict) -> "Op":
        """An Op from a parsed EDN op map: keyword ``type`` and ``f`` become
        strings (``f_is_kw`` remembers a keyword ``f``), the ``:nemesis``
        process becomes ``"nemesis"`` (other keyword processes stay
        Keywords), and keys other than the standard fields go to
        ``extra``, sorted."""
        typ = m.get(K("type"))
        f = m.get(K("f"))
        proc = m.get(K("process"))
        if proc is K(NEMESIS):
            proc = NEMESIS
        extra = tuple(sorted(((k, v) for k, v in m.items() if k not in _STD_KEYS), key=repr))
        return cls(type=typ.name if isinstance(typ, Keyword) else typ, process=proc,
                   f=f.name if isinstance(f, Keyword) else f, value=m.get(K("value")),
                   time=m.get(K("time"), -1), index=m.get(K("index"), -1),
                   error=m.get(K("error")), extra=extra,
                   f_is_kw=isinstance(f, Keyword) or not isinstance(f, str))

    def to_edn(self) -> dict:
        """The op as an EDN map, keys in the reference's order."""
        m: dict = {
            K("type"): _TYPE_KWS.get(self.type, K(str(self.type))),
            K("f"): K(self.f) if isinstance(self.f, str) and self.f_is_kw else self.f,
            K("value"): self.value,
            K("time"): self.time,
            K("process"): K(self.process) if self.process == NEMESIS else self.process,
        }
        if self.index >= 0:
            m[K("index")] = self.index
        if self.error is not None:
            m[K("error")] = self.error
        for k, v in self.extra:
            m[k] = v
        return m

    def __repr__(self) -> str:
        e = f" :error {self.error!r}" if self.error is not None else ""
        return f"<{self.index} {self.process} {self.type} :{self.f} {self.value!r}{e}>"


def invoke_op(process: Any, f: Any, value: Any = None, time: int = -1, **extra: Any) -> Op:
    return Op(INVOKE, process, f, value, time=time, extra=tuple(sorted(extra.items())))


@dataclass(frozen=True)
class Interval:
    """A paired operation: invocation + (possibly missing) completion.

    ``completion is None`` means the invoke never completed inside the
    history (treated like :info — open to the end of time).
    """

    invoke: Op
    completion: Optional[Op]

    @property
    def process(self) -> Any:
        return self.invoke.process

    @property
    def f(self) -> Any:
        return self.invoke.f

    @property
    def type(self) -> str:
        """Final type: ok / fail / info."""
        return self.completion.type if self.completion is not None else INFO

    @property
    def value_in(self) -> Any:
        return self.invoke.value

    @property
    def value_out(self) -> Any:
        return self.completion.value if self.completion is not None else None

    @property
    def inv_time(self) -> int:
        return self.invoke.time

    @property
    def ret_time(self) -> float:
        if self.completion is None or self.completion.type == INFO:
            return math.inf
        return self.completion.time

    @property
    def inv_index(self) -> int:
        return self.invoke.index

    @property
    def ret_index(self) -> float:
        if self.completion is None or self.completion.type == INFO:
            return math.inf
        return self.completion.index


class History:
    """An ordered, optionally indexed, sequence of :class:`Op`.

    Construction from a raw iterable assigns indexes (0..n-1 in order) unless
    ``reindex=False`` and ops already carry them.
    """

    __slots__ = ("ops",)

    def __init__(self, ops: Iterable[Op], reindex: bool = True):
        ops = list(ops)
        if reindex:
            ops = [op.with_(index=i) if op.index != i else op for i, op in enumerate(ops)]
        self.ops = ops

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self) -> Iterator[Op]:
        return iter(self.ops)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return History(self.ops[i], reindex=False)
        return self.ops[i]

    def __eq__(self, other: object) -> bool:
        return isinstance(other, History) and self.ops == other.ops

    def __repr__(self) -> str:
        return f"<History n={len(self.ops)}>"

    def filter(self, pred: Callable[[Op], bool]) -> "History":
        return History([op for op in self.ops if pred(op)], reindex=False)

    def client_ops(self) -> "History":
        return self.filter(lambda op: op.is_client)

    def nemesis_ops(self) -> "History":
        return self.filter(lambda op: op.is_nemesis)

    def oks(self) -> "History":
        return self.filter(lambda op: op.is_ok)

    def invokes(self) -> "History":
        return self.filter(lambda op: op.is_invoke)

    def processes(self) -> set:
        return {op.process for op in self.ops}

    def reindex(self) -> "History":
        return History(self.ops, reindex=True)

    def pairs(self) -> list[Interval]:
        """Pair each client invocation with its completion, preserving
        invocation order. Completions without a pending invoke for their
        process are ignored. Nemesis ops are excluded."""
        pending: dict[Any, int] = {}  # process -> position in `out`
        out: list[Interval] = []
        for op in self.ops:
            if not op.is_client:
                continue
            if op.is_invoke:
                pending[op.process] = len(out)
                out.append(Interval(op, None))
            else:
                pos = pending.pop(op.process, None)
                if pos is not None:
                    out[pos] = Interval(out[pos].invoke, op)
        return out

    def complete(self) -> "History":
        """Knossos ``history/complete``: any invoke with no completion gets a
        synthetic trailing :info op, so every interval is closed-or-info."""
        pending: dict[Any, Op] = {}
        for op in self.ops:
            if not op.is_client:
                continue
            if op.is_invoke:
                pending[op.process] = op
            else:
                pending.pop(op.process, None)
        if not pending:
            return self
        tail = [inv.with_(type=INFO, index=len(self.ops) + i,
                          error="indeterminate: no completion in history")
                for i, inv in enumerate(pending.values())]
        return History(self.ops + tail, reindex=False)

    @classmethod
    def from_edn_string(cls, s: str, reindex: bool = False) -> "History":
        """The ops of an EDN text (one op map a form); indexes are assigned
        when ``reindex`` is set or any op lacks one."""
        ops = [Op.from_edn(m) for m in edn.read_all(s)]
        return cls(ops, reindex=reindex or any(op.index < 0 for op in ops))

    def to_edn_string(self) -> str:
        return "\n".join(edn.write_string(op.to_edn()) for op in self.ops) + "\n"

    @classmethod
    def load(cls, path) -> "History":
        with open(path, "r") as fh:
            return cls.from_edn_string(fh.read())

    def save(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_edn_string())
