"""EDN reader and writer: the codec of the store's ``history.edn`` and
``results.edn``.

The port of the reference's ``jepsen_tpu/edn.py``. Jepsen persists
histories and results as EDN, and its op maps use keywords (``:type
:invoke``, ``:f :read``, ...); archived histories of either package load
back through this codec. It needs nothing outside the standard library.

Mapping EDN -> Python:

==============  ==========================================
EDN             Python
==============  ==========================================
nil             None
true/false      True/False
integers        int        (incl. N-suffixed bigints)
floats          float      (incl. M-suffixed decimals)
strings         str
characters      Char
keywords        Keyword    (interned; ``K("f")`` helper)
symbols         Symbol
list ()         tuple  (tagged as List via subclass EdnList)
vector []       list
map {}          dict   (keys must be hashable; list keys -> tuple)
set #{}         frozenset
#tag value      Tagged(tag, value)   (#inst/#uuid included)
==============  ==========================================

:func:`read_string` and :func:`read_all` run on the C reader
(``native/edn_fast.c``, :func:`jepsen_tpu_torch.native.load_edn_fast`)
where it accepts the text and on the Python reader otherwise.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Iterator


class Keyword:
    """An interned EDN keyword (``:foo`` or ``:ns/name``).

    Interning makes ``Keyword("f") is Keyword("f")`` true, so keyword-keyed
    dicts behave like Clojure maps with keyword keys; the history model
    depends on it.
    """

    __slots__ = ("name",)
    _interned: dict[str, "Keyword"] = {}
    _lock = threading.Lock()

    def __new__(cls, name: str) -> "Keyword":
        kw = cls._interned.get(name)
        if kw is None:
            with cls._lock:
                kw = cls._interned.get(name)
                if kw is None:
                    kw = object.__new__(cls)
                    kw.name = name
                    cls._interned[name] = kw
        return kw

    def __repr__(self) -> str:
        return ":" + self.name

    def __hash__(self) -> int:
        return hash((Keyword, self.name))

    def __eq__(self, other: object) -> bool:
        return self is other

    def __lt__(self, other: "Keyword") -> bool:
        return self.name < other.name

    def __reduce__(self):  # pickle support (Keyword is interned)
        return (Keyword, (self.name,))


def K(name: str) -> Keyword:
    """Shorthand constructor: ``K("invoke")`` == ``Keyword("invoke")``."""
    return Keyword(name)


class Symbol:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return self.name

    def __hash__(self) -> int:
        return hash((Symbol, self.name))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Symbol) and other.name == self.name


class Char:
    __slots__ = ("c",)

    def __init__(self, c: str):
        self.c = c

    def __repr__(self) -> str:
        return "\\" + self.c

    def __hash__(self) -> int:
        return hash((Char, self.c))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Char) and other.c == self.c


class EdnList(tuple):
    """An EDN list ``(...)`` — distinct from a vector, printed with parens."""


class FrozenMap(tuple):
    """An immutable map usable as a dict key / set member: a tuple of sorted
    (key, value) pairs that prints back as an EDN map, keeping map-keyed
    maps and sets-of-maps round-trippable."""

    def to_dict(self) -> dict:
        return {k: v for k, v in self}


@dataclass(frozen=True)
class Tagged:
    tag: str
    value: Any


_CHAR_NAMES = {
    "newline": "\n",
    "return": "\r",
    "space": " ",
    "tab": "\t",
    "backspace": "\b",
    "formfeed": "\f",
}
_CHAR_NAMES_INV = {v: k for k, v in _CHAR_NAMES.items()}

_DELIMS = set('()[]{}"; ')
_WS = set(" \t\n\r,")


class _Reader:
    __slots__ = ("s", "i", "n")

    def __init__(self, s: str):
        self.s = s
        self.i = 0
        self.n = len(s)

    def error(self, msg: str) -> Exception:
        line = self.s.count("\n", 0, self.i) + 1
        return ValueError(f"EDN parse error at pos {self.i} (line {line}): {msg}")

    def skip_ws(self) -> None:
        s, n = self.s, self.n
        i = self.i
        while i < n:
            c = s[i]
            if c in _WS:
                i += 1
            elif c == ";":  # comment to end of line
                j = s.find("\n", i)
                i = n if j < 0 else j + 1
            elif c == "#" and s.startswith("#_", i):  # discard next form
                self.i = i + 2
                self.skip_ws()
                self.read()  # read and drop
                i = self.i
            else:
                break
        self.i = i

    def read(self) -> Any:
        self.skip_ws()
        if self.i >= self.n:
            raise self.error("unexpected EOF")
        c = self.s[self.i]
        if c == "(":
            self.i += 1
            return EdnList(self._read_seq(")"))
        if c == "[":
            self.i += 1
            return self._read_seq("]")
        if c == "{":
            self.i += 1
            return self._read_map()
        if c == '"':
            return self._read_string()
        if c == "\\":
            return self._read_char()
        if c == "#":
            return self._read_dispatch()
        if c == ":":
            self.i += 1
            return Keyword(self._read_token())
        if c.isdigit() or (c in "+-" and self.i + 1 < self.n and self.s[self.i + 1].isdigit()):
            return self._read_number()
        tok = self._read_token()
        if not tok:
            raise self.error(f"unexpected {c!r}")
        if tok == "nil":
            return None
        if tok == "true":
            return True
        if tok == "false":
            return False
        return Symbol(tok)

    def _read_seq(self, close: str) -> list:
        out = []
        while True:
            self.skip_ws()
            if self.i >= self.n:
                raise self.error(f"unterminated sequence, expected {close!r}")
            if self.s[self.i] == close:
                self.i += 1
                return out
            out.append(self.read())

    def _read_map(self) -> dict:
        items = self._read_seq("}")
        if len(items) % 2:
            raise self.error("map literal with odd number of forms")
        out = {}
        for k, v in zip(items[::2], items[1::2]):
            out[_hashable(k)] = v
        return out

    def _read_string(self) -> str:
        s = self.s
        i = self.i + 1
        buf: list[str] = []
        while i < self.n:
            c = s[i]
            if c == '"':
                self.i = i + 1
                return "".join(buf)
            if c == "\\":
                i += 1
                if i >= self.n:
                    break
                e = s[i]
                if e == "n":
                    buf.append("\n")
                elif e == "t":
                    buf.append("\t")
                elif e == "r":
                    buf.append("\r")
                elif e == "b":
                    buf.append("\b")
                elif e == "f":
                    buf.append("\f")
                elif e == "u":
                    buf.append(chr(int(s[i + 1 : i + 5], 16)))
                    i += 4
                else:
                    buf.append(e)  # \" \\ \/ and anything else literal
                i += 1
            else:
                buf.append(c)
                i += 1
        raise self.error("unterminated string")

    def _read_char(self) -> Char:
        self.i += 1  # skip backslash
        if self.i >= self.n:
            raise self.error("EOF after \\")
        start = self.i
        if not self.s[start].isalnum():
            # single non-alphanumeric char, incl. delimiters: \( \" \, ...
            self.i += 1
            return Char(self.s[start])
        while self.i < self.n and self.s[self.i] not in _WS and self.s[self.i] not in _DELIMS:
            self.i += 1
        tok = self.s[start : self.i]
        if len(tok) == 1:
            return Char(tok)
        if tok in _CHAR_NAMES:
            return Char(_CHAR_NAMES[tok])
        if tok.startswith("u") and len(tok) == 5:
            return Char(chr(int(tok[1:], 16)))
        raise self.error(f"unknown character literal \\{tok}")

    def _read_dispatch(self) -> Any:
        s = self.s
        if s.startswith("#{", self.i):
            self.i += 2
            return frozenset(_hashable(x) for x in self._read_seq("}"))
        if s.startswith("##", self.i):
            self.i += 2
            tok = self._read_token()
            m = {"Inf": float("inf"), "-Inf": float("-inf"), "NaN": float("nan")}
            if tok in m:
                return m[tok]
            raise self.error(f"unknown ## literal {tok}")
        # tagged literal: #tag value
        self.i += 1
        tag = self._read_token()
        if not tag:
            raise self.error("bad dispatch")
        value = self.read()
        return Tagged(tag, value)

    def _read_token(self) -> str:
        start = self.i
        s, n = self.s, self.n
        i = self.i
        while i < n and s[i] not in _WS and s[i] not in _DELIMS:
            i += 1
        self.i = i
        return s[start:i]

    def _read_number(self) -> Any:
        start = self.i
        s, n = self.s, self.n
        i = self.i
        if s[i] in "+-":
            i += 1
        is_float = False
        while i < n and s[i] not in _WS and s[i] not in _DELIMS:
            if s[i] in ".eE" and not (s[i] in "eE" and s[i - 1] in "+-"):
                is_float = True
            i += 1
        tok = s[start:i]
        self.i = i
        if tok.endswith("N"):
            return int(tok[:-1])
        if tok.endswith("M"):
            return float(tok[:-1])
        if tok.lstrip("+-").lower().startswith("0x"):
            return int(tok, 16)
        if is_float or ("e" in tok or "E" in tok) or "." in tok:
            return float(tok)
        try:
            return int(tok)
        except ValueError:
            return float(tok)


def _hashable(x: Any) -> Any:
    """Coerce a parsed form into something usable as a dict key / set member."""
    if isinstance(x, EdnList):
        return EdnList(_hashable(e) for e in x)
    if isinstance(x, (list, tuple)):
        return tuple(_hashable(e) for e in x)
    if isinstance(x, dict):
        return FrozenMap(sorted(((k, _hashable(v)) for k, v in x.items()), key=repr))
    if isinstance(x, Tagged):
        return Tagged(x.tag, _hashable(x.value))
    return x


def _fast_reader():
    """The native (C extension) reader, or None. Accelerator only: it
    raises FastParseError on any grammar it does not cover (tagged
    literals, chars, ratios, bignums) and the callers below fall back to
    the full Python reader, so the behaviour is always the Python
    reader's."""
    from . import native

    return native.load_edn_fast()


def read_string(s: str) -> Any:
    """Parse a single EDN form from ``s``; trailing non-whitespace is an error."""
    fast = _fast_reader()
    if fast is not None:
        try:
            forms = fast.parse_all(s)
        except fast.FastParseError:
            pass
        else:
            if len(forms) != 1:
                raise ValueError(
                    "trailing content after form" if forms
                    else "unexpected end of input")
            return forms[0]
    r = _Reader(s)
    v = r.read()
    r.skip_ws()
    if r.i < r.n:
        raise r.error("trailing content after form")
    return v


def read_all(s: str) -> Iterator[Any]:
    """Parse every top-level form in ``s`` (e.g. a history.edn file, one
    op map per line — store.clj:351-362 writes one form per line). Runs
    on the native reader when the grammar allows, the python reader
    otherwise.

    Laziness: the native fast path materializes EVERY form before the
    first is yielded (one C call parses the whole buffer); only the
    python fallback streams form-by-form. Batch consumers (the history
    loader, replay) read everything anyway, so peak memory is the same
    — but callers that want to stop early on multi-GB files should chunk
    the input per line themselves before calling."""
    fast = _fast_reader()
    if fast is not None:
        try:
            return iter(fast.parse_all(s))
        except fast.FastParseError:
            pass
    def gen():
        r = _Reader(s)
        while True:
            r.skip_ws()
            if r.i >= r.n:
                return
            yield r.read()

    return gen()


# ---------------------------------------------------------------------------
# Printer


def _needs_quotes_str(s: str) -> str:
    out = ['"']
    for c in s:
        if c == '"':
            out.append('\\"')
        elif c == "\\":
            out.append("\\\\")
        elif c == "\n":
            out.append("\\n")
        elif c == "\t":
            out.append("\\t")
        elif c == "\r":
            out.append("\\r")
        else:
            out.append(c)
    out.append('"')
    return "".join(out)


def write_string(x: Any) -> str:
    """Print ``x`` as EDN, round-trippable through :func:`read_string`."""
    buf: list[str] = []
    _write(x, buf)
    return "".join(buf)


def _write(x: Any, buf: list[str]) -> None:
    if x is None:
        buf.append("nil")
    elif x is True:
        buf.append("true")
    elif x is False:
        buf.append("false")
    elif isinstance(x, Keyword):
        buf.append(":" + x.name)
    elif isinstance(x, Symbol):
        buf.append(x.name)
    elif isinstance(x, Char):
        buf.append("\\" + _CHAR_NAMES_INV.get(x.c, x.c))
    elif isinstance(x, str):
        buf.append(_needs_quotes_str(x))
    elif isinstance(x, bool):  # pragma: no cover - caught above
        buf.append("true" if x else "false")
    elif isinstance(x, int):
        buf.append(str(x))
    elif isinstance(x, float):
        if x != x:
            buf.append("##NaN")
        elif x == float("inf"):
            buf.append("##Inf")
        elif x == float("-inf"):
            buf.append("##-Inf")
        else:
            buf.append(repr(x))
    elif isinstance(x, Tagged):
        buf.append("#" + x.tag + " ")
        _write(x.value, buf)
    elif isinstance(x, EdnList):
        buf.append("(")
        for j, e in enumerate(x):
            if j:
                buf.append(" ")
            _write(e, buf)
        buf.append(")")
    elif isinstance(x, FrozenMap):
        buf.append("{")
        for j, (k, v) in enumerate(x):
            if j:
                buf.append(", ")
            _write(k, buf)
            buf.append(" ")
            _write(v, buf)
        buf.append("}")
    elif isinstance(x, dict):
        buf.append("{")
        for j, (k, v) in enumerate(x.items()):
            if j:
                buf.append(", ")
            _write(k, buf)
            buf.append(" ")
            _write(v, buf)
        buf.append("}")
    elif isinstance(x, (frozenset, set)):
        buf.append("#{")
        for j, e in enumerate(sorted(x, key=repr)):
            if j:
                buf.append(" ")
            _write(e, buf)
        buf.append("}")
    elif isinstance(x, (list, tuple)):
        buf.append("[")
        for j, e in enumerate(x):
            if j:
                buf.append(" ")
            _write(e, buf)
        buf.append("]")
    else:
        # numpy scalars and other numerics degrade gracefully
        try:
            buf.append(str(int(x)) if float(x).is_integer() else repr(float(x)))
        except (TypeError, ValueError):
            buf.append(_needs_quotes_str(str(x)))
