"""Operation & history data model (``Op``, ``Interval``, ``History``).

Histories are sequences of op maps ``{:type :invoke|:ok|:fail|:info,
:process p, :f f, :value v, :time t, :index i}``; invocations are paired
with completions by process. Process ids: clients are ints; anything else
(the nemesis) is not a client.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Iterator, Optional

from .edn import Keyword

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

NEMESIS = "nemesis"


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

    def __repr__(self) -> str:
        e = f" :error {self.error!r}" if self.error is not None else ""
        return f"<{self.index} {self.process} {self.type} :{self.f} {self.value!r}{e}>"


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
