"""The port's EDN codec (``jepsen_tpu_torch.edn``) against the JAX
reference's: both readers give the same object graph (compared by type
name and value, the classes being each package's own), both printers the
same text, on the reference's own corpus (``tests/test_edn.py``) and on
forms that hypothesis builds from a fixed seed; and the port's C reader
(``native/edn_fast.c``) agrees with its Python reader on everything it
accepts and refuses tagged literals, chars, ratios and bignums, which the
public entry points then read with the Python reader."""

import math

import pytest
from hypothesis import HealthCheck, given, seed, settings
from hypothesis import strategies as st

from jepsen_tpu import edn as R
from jepsen_tpu_torch import edn as P
from jepsen_tpu_torch import native

# The reference's corpus: tests/test_edn.py's inputs, its fast-reader
# cases, and op maps in the store's format.
CORPUS = [
    "nil", "true", "false", "42", "-7", "+4", "0", "-17", "3.5", "3.25", "1e3", "-1e3",
    "12N", "1.5M", "0x1F", "2e-3", "1E+5", '"hi\\nthere"', '"hello"',
    '"esc \\"q\\" \\n\\t\\u0041"', '"slash \\/ and \\b\\f\\r"', "##Inf", "##-Inf", "##NaN",
    ":foo", ":ns/name", ":kw", "sym", "my.ns/sym", "foo/bar", "[1 2 3]", "(1 2)", "(1 2 3)",
    "[]", "()", "{}", "#{}", "{:a 1, :b [2 3]}", "#{1 2 3}", "{[1 2] 3}", "{(1 2) :v}",
    "{:type :invoke, :f :cas, :value [0 3], :process 2, :time 12345, :index 7}",
    "[{:a 1} {:b #{:x}} (1 [2 {:c 3}])]", "; hello\n[1 #_2 3]", "; comment\n42",
    "#_ {:skipped 1} 7", '#inst "2020-01-01T00:00:00Z"', '#uuid "abc"',
    "#jepsen/tag {:a 1}", "[[:r 3 nil] [:append 3 2]]", "#{(1 [2])}", "{(1 [2]) 5}",
    "{{:a 1} 2}", "\\a", "\\newline", "[\\( \\) \\space \\u0041 \\,]",
    str(2 ** 70), str(-2 ** 63), str(2 ** 63), "{:type :info, :f :start, :value nil, "
    ":process :nemesis, :time 12, :index 1}",
]
BAD = ["[1)", "1 2", "{:a}", '"unterminated', "[1 2", "#", "\\", "1/2"]


def graph(x):
    """A package-neutral picture of a parsed or built value: type names
    and values, container order kept where it is significant."""
    name = type(x).__name__
    if x is None or isinstance(x, bool):
        return (name, x)
    if isinstance(x, float):
        return (name, "nan" if math.isnan(x) else x)
    if name == "Keyword" or name == "Symbol":
        return (name, x.name)
    if name == "Char":
        return (name, x.c)
    if name == "Tagged":
        return (name, x.tag, graph(x.value))
    if isinstance(x, dict):
        return (name, [(graph(k), graph(v)) for k, v in x.items()])
    if isinstance(x, (frozenset, set)):
        return (name, sorted((graph(e) for e in x), key=repr))
    if isinstance(x, (list, tuple)):  # list, tuple, EdnList, FrozenMap
        return (name, [graph(e) for e in x])
    return (name, x)


@pytest.mark.parametrize("text", CORPUS)
def test_readers_agree_on_the_corpus(text):
    want, got = R.read_string(text), P.read_string(text)
    assert graph(got) == graph(want)
    assert P.write_string(got) == R.write_string(want)
    assert [graph(f) for f in P.read_all(text + "\n" + text)] == \
        [graph(f) for f in R.read_all(text + "\n" + text)]


@pytest.mark.parametrize("text", BAD)
def test_both_refuse_malformed_text(text):
    with pytest.raises(ValueError):
        R.read_string(text)
    with pytest.raises(ValueError):
        P.read_string(text)


def test_keywords_stay_interned():
    assert P.read_string(":foo") is P.K("foo") is P.Keyword("foo")
    op = P.read_string("{:type :invoke, :f :cas}")
    assert op[P.K("type")] is P.K("invoke")


# -- hypothesis-built forms ---------------------------------------------------

_name = st.from_regex(r"\A[a-z][a-z0-9.*!?-]{0,6}(/[a-z][a-z0-9]{0,4})?\Z").filter(
    lambda s: s not in ("nil", "true", "false"))
_text = st.text(st.characters(blacklist_categories=("Cs",)), max_size=12)
_scalar = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 70, 2 ** 70),
    st.floats(allow_nan=True, allow_infinity=True), _text,
    _name.map(lambda n: ("kw", n)), _name.map(lambda n: ("sym", n)))
_char = st.sampled_from(list("ab1()[]{}\";,\\#") + ["\n", " ", "\t"]).map(lambda c: ("char", c))
_key = st.one_of(st.integers(-50, 50), _text, _name.map(lambda n: ("kw", n)))


def _containers(inner):
    return st.one_of(
        st.lists(inner, max_size=4).map(lambda xs: ("vec", xs)),
        st.lists(inner, max_size=4).map(lambda xs: ("list", xs)),
        st.lists(st.tuples(_key, inner), max_size=4).map(lambda kv: ("map", kv)),
        st.lists(_key, max_size=4).map(lambda xs: ("set", xs)),
        st.tuples(st.sampled_from(["inst", "uuid", "my/tag"]), inner).map(
            lambda tv: ("tag",) + tv))


FORMS = st.recursive(st.one_of(_scalar, _char), _containers, max_leaves=12)


def build(mod, t):
    """The value an abstract form stands for, built from ``mod``'s classes."""
    if not isinstance(t, tuple):
        return t
    kind = t[0]
    if kind == "kw":
        return mod.Keyword(t[1])
    if kind == "sym":
        return mod.Symbol(t[1])
    if kind == "char":
        return mod.Char(t[1])
    if kind == "tag":
        return mod.Tagged(t[1], build(mod, t[2]))
    if kind == "vec":
        return [build(mod, x) for x in t[1]]
    if kind == "list":
        return mod.EdnList(build(mod, x) for x in t[1])
    if kind == "map":
        return {build(mod, k): build(mod, v) for k, v in t[1]}
    return frozenset(build(mod, x) for x in t[1])


@seed(2026)
@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(FORMS)
def test_built_forms_print_and_read_alike(form):
    ref, port = build(R, form), build(P, form)
    text = R.write_string(ref)
    assert P.write_string(port) == text
    assert graph(P.read_string(text)) == graph(R.read_string(text))
    lines = text + "\n" + text + "\n"
    assert [graph(f) for f in P.read_all(lines)] == [graph(f) for f in R.read_all(lines)]


# -- the C reader -------------------------------------------------------------


def _fast():
    fast = native.load_edn_fast()
    if fast is None:
        pytest.skip(f"edn_fast not built: {native.edn_fast_missing}")
    return fast


def _python(text):
    r = P._Reader(text)
    out = []
    while True:
        r.skip_ws()
        if r.i >= r.n:
            return out
        out.append(r.read())


@pytest.mark.parametrize("text", CORPUS)
def test_fast_reader_agrees_or_falls_back(text):
    fast = _fast()
    try:
        got = fast.parse_all(text)
    except fast.FastParseError:
        rich = ("#inst", "#uuid", "#jepsen", "\\", "N", "M", "0x", "##")
        assert any(r in text for r in rich) or not -2 ** 63 <= P.read_string(text) < 2 ** 63, \
            text
        return
    assert [graph(f) for f in got] == [graph(f) for f in _python(text)]


@pytest.mark.parametrize("text", ['#inst "2024-01-01T00:00:00Z"', "\\a", "1/2", "12N",
                                  str(2 ** 70), "[\\( 1]"])
def test_fast_reader_refuses_rich_grammar(text):
    """Refused by the C reader; the entry points then give the Python
    reader's answer (a ratio is an error in both packages)."""
    fast = _fast()
    with pytest.raises(fast.FastParseError):
        fast.parse_all(text)

    def outcome(mod):
        try:
            return graph(mod.read_string(text))
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(P) == outcome(R)


@seed(2027)
@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(FORMS)
def test_fast_reader_agrees_on_built_forms(form):
    fast = _fast()
    text = P.write_string(build(P, form)) + "\n"
    try:
        got = fast.parse_all(text)
    except fast.FastParseError:
        return
    assert [graph(f) for f in got] == [graph(f) for f in _python(text)]


def test_fast_reader_binds_the_ports_classes():
    fast = _fast()
    (op,) = fast.parse_all("{:f :cas, :value (1 [2]), :s sym, {:a 1} #{[1]}}")
    assert op[P.K("f")] is P.K("f").__class__("cas")
    assert type(op[P.K("value")]) is P.EdnList and type(op[P.K("s")]) is P.Symbol
    (k,) = [k for k in op if isinstance(k, P.FrozenMap)]
    assert op[k] == frozenset({(1,)})
