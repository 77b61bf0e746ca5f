"""Nemesis protocol: fault injection as a special singleton client.

Mirrors jepsen.nemesis (jepsen/src/jepsen/nemesis.clj):

- :class:`Nemesis` — setup/invoke/teardown (nemesis.clj:10-15). A nemesis
  receives :info ops from the generator's nemesis track and performs
  faults against the cluster.
- :class:`Reflection` — optional ``fs()`` enumerating the op :f's a
  nemesis handles, used by compose for routing (nemesis.clj:17-20).
- :func:`validate` — wraps a nemesis so a nil completion raises
  (nemesis.clj:29-70).
- :func:`noop` — accepts every op unchanged (nemesis.clj:72-79).

The port of the reference's ``jepsen_tpu/nemesis/__init__.py``: the
protocol, ``compose``, the grudge algebra, ``node_start_stopper``,
``hammer_time`` and ``truncate_file``. The partitioners cut links with
iptables through ``net.py``, which the port does not hold yet (ROADMAP
A17's remainder): constructing one raises ``ValueError``. The nemesis
packages of the reference's submodules (combined, partition, pause,
reorder, time) wait with it.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional


class Nemesis:
    """Fault injector (nemesis.clj:10-15). ``setup`` returns the nemesis to
    use (may be self); ``invoke`` applies a fault op and returns its
    completion."""

    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass


class Reflection:
    """Optional: enumerate handled op fs (nemesis.clj:17-20)."""

    def fs(self) -> Iterable[Any]:
        raise NotImplementedError


class _Noop(Nemesis, Reflection):
    """Does nothing (nemesis.clj:72-79)."""

    def invoke(self, test, op):
        return dict(op)

    def fs(self):
        return []

    def __repr__(self):
        return "<nemesis.noop>"


def noop() -> Nemesis:
    return _Noop()


class ValidationError(Exception):
    pass


class _Validate(Nemesis):
    """Nil completions raise instead of vanishing (nemesis.clj:29-70)."""

    def __init__(self, nemesis: Nemesis):
        self.nemesis = nemesis

    def setup(self, test):
        inner = self.nemesis.setup(test)
        if inner is None:
            raise ValidationError(
                f"nemesis setup returned None (from {self.nemesis!r})"
            )
        return _Validate(inner)

    def invoke(self, test, op):
        res = self.nemesis.invoke(test, op)
        if res is None:
            raise ValidationError(
                f"nemesis {self.nemesis!r} returned None for op {op!r}"
            )
        return res

    def teardown(self, test):
        self.nemesis.teardown(test)

    def __repr__(self):
        return f"<nemesis.validate {self.nemesis!r}>"


def validate(nemesis: Nemesis) -> Nemesis:
    if isinstance(nemesis, _Validate):
        return nemesis
    return _Validate(nemesis)


# ---------------------------------------------------------------------------
# Grudge algebra (nemesis.clj:88-193). A grudge maps each node to the set
# of nodes whose traffic it drops.


def bisect(coll: list) -> list:
    """Cut a sequence in half, smaller half first (nemesis.clj:88-91)."""
    n = len(coll) // 2
    return [list(coll[:n]), list(coll[n:])]


def split_one(coll: list, loner: Any = None) -> list:
    """Split one node off from the rest (nemesis.clj:93-98)."""
    from ..generator import rand_int

    if loner is None:
        loner = coll[rand_int(len(coll))]
    return [[loner], [x for x in coll if x != loner]]


def complete_grudge(components: Iterable[Iterable]) -> dict:
    """No node can talk to any node outside its component
    (nemesis.clj:100-112)."""
    comps = [set(c) for c in components]
    universe = set().union(*comps) if comps else set()
    grudge = {}
    for comp in comps:
        for node in comp:
            grudge[node] = universe - comp
    return grudge


def bridge(nodes: list) -> dict:
    """Cut the network in half but keep one bridge node connected to both
    sides (nemesis.clj:114-125)."""
    components = bisect(list(nodes))
    b = components[1][0]
    grudge = complete_grudge(components)
    grudge.pop(b, None)
    return {node: others - {b} for node, others in grudge.items()}


def _shuffled(coll: list) -> list:
    """Shuffle via the pinnable generator RNG."""
    from ..generator import rand_int

    pool = list(coll)
    out = []
    while pool:
        out.append(pool.pop(rand_int(len(pool))))
    return out


def majorities_ring(nodes: list) -> dict:
    """Every node sees a majority, but no two nodes see the same majority
    (nemesis.clj:172-187)."""
    from ..util import majority

    shuffled = _shuffled(list(nodes))
    n = len(shuffled)
    m = majority(n)
    U = set(shuffled)
    grudge = {}
    for i in range(n):
        maj = [shuffled[(i + j) % n] for j in range(m)]
        holder = maj[len(maj) // 2]
        grudge[holder] = U - set(maj)
    return grudge


# ---------------------------------------------------------------------------
# Partitioners (nemesis.clj:127-193)


# What a partitioner raises: it cuts links with iptables through the
# reference's net.py, which the port does not hold yet.
NET_SLICE = ("partitioners cut links with iptables through net.py, which the port "
             "does not hold yet (ROADMAP item A17's remainder)")


class Partitioner(Nemesis, Reflection):
    """:start cuts links per (grudge_fn nodes) and :stop heals
    (nemesis.clj:127-153). Raises ``ValueError`` at construction: the
    port has no ``net.py`` to cut links with."""

    def __init__(self, grudge_fn: Optional[Any] = None):
        raise ValueError(NET_SLICE)

    def fs(self):
        return ["start", "stop"]


def partitioner(grudge_fn=None) -> Nemesis:
    return Partitioner(grudge_fn)


def partition_halves() -> Nemesis:
    """First-half/second-half split (nemesis.clj:155-160)."""
    return partitioner(lambda nodes: complete_grudge(bisect(list(nodes))))


def partition_random_halves() -> Nemesis:
    """Randomly chosen halves (nemesis.clj:162-165)."""
    return partitioner(
        lambda nodes: complete_grudge(bisect(_shuffled(nodes))))


def partition_random_node() -> Nemesis:
    """Isolate one random node (nemesis.clj:167-170)."""
    return partitioner(lambda nodes: complete_grudge(split_one(list(nodes))))


def partition_majorities_ring() -> Nemesis:
    """nemesis.clj:189-193."""
    return partitioner(majorities_ring)


# ---------------------------------------------------------------------------
# Composition (nemesis.clj:195-278)


def _f_router(fs_spec) -> "callable":
    """fs_spec is a set (pass-through) or map (rename) of op fs."""
    if isinstance(fs_spec, dict):
        return lambda f: fs_spec.get(f)
    members = set(fs_spec)
    return lambda f: f if f in members else None


def compose(nemeses) -> Nemesis:
    """Combine nemeses. Either a mapping of f-specs (frozensets pass
    through, tuple-of-pairs rename) to nemeses, or a collection of
    Reflection nemeses whose fs() are disjoint (nemesis.clj:195-278)."""
    if isinstance(nemeses, dict):
        routes = [(_f_router(spec), spec, nem) for spec, nem in
                  _iter_spec_map(nemeses)]
    else:
        # Collection: route by Reflection fs, preserving every nemesis
        # (including ones with empty fs — their setup/teardown still run).
        specs = []
        seen: dict = {}
        for nem in nemeses:
            if not isinstance(nem, Reflection):
                raise TypeError(
                    f"compose of a collection needs Reflection nemeses; "
                    f"{nem!r} has no fs()")
            fs = list(nem.fs())
            for f in fs:
                if f in seen:
                    raise ValueError(
                        f"nemeses {nem!r} and {seen[f]!r} both use f {f!r}")
                seen[f] = nem
            specs.append((frozenset(fs), nem))
        routes = [(_f_router(spec), spec, nem) for spec, nem in specs]

    class _Composed(Nemesis, Reflection):
        def setup(self, test):
            for i, (router, spec, nem) in enumerate(routes):
                routes[i] = (router, spec, nem.setup(test))
            return self

        def invoke(self, test, op):
            f = op.get("f")
            for router, _spec, nem in routes:
                f2 = router(f)
                if f2 is not None:
                    res = nem.invoke(test, {**op, "f": f2})
                    return {**res, "f": f}
            raise ValueError(f"no nemesis can handle {f!r}")

        def teardown(self, test):
            for _router, _spec, nem in routes:
                nem.teardown(test)

        def fs(self):
            out = []
            for _router, spec, _nem in routes:
                out.extend(spec.keys() if isinstance(spec, dict)
                           else list(spec))
            return out

    return _Composed()


def _iter_spec_map(m: dict):
    # dict keys may be frozensets, tuples, or dicts-as-tuples; normalize.
    for spec, nem in m.items():
        if isinstance(spec, tuple) and spec and isinstance(spec[0], tuple):
            yield dict(spec), nem
        else:
            yield spec, nem


# ---------------------------------------------------------------------------
# Node process manipulation (nemesis.clj:302-389)


class NodeStartStopper(Nemesis):
    """:start runs start_fn on targeted nodes; :stop undoes it
    (nemesis.clj:302-345). Functions run with the node's control session
    bound: (test, node) -> value."""

    def __init__(self, targeter, start_fn, stop_fn):
        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self._nodes: Optional[list] = None
        import threading

        self._lock = threading.Lock()

    def invoke(self, test, op):
        import inspect

        from .. import control as c

        with self._lock:
            f = op.get("f")
            if f == "start":
                try:
                    two_arg = len(
                        inspect.signature(self.targeter).parameters) >= 2
                except (TypeError, ValueError):
                    two_arg = False
                ns = (self.targeter(test, test["nodes"]) if two_arg
                      else self.targeter(test["nodes"]))
                if ns is None:
                    value = "no-target"
                elif self._nodes is not None:
                    value = f"nemesis already disrupting {self._nodes!r}"
                else:
                    ns = ns if isinstance(ns, (list, tuple, set)) else [ns]
                    self._nodes = list(ns)
                    value = c.on_nodes(
                        test, lambda t, n: self.start_fn(t, n), self._nodes)
            elif f == "stop":
                if self._nodes is None:
                    value = "not-started"
                else:
                    value = c.on_nodes(
                        test, lambda t, n: self.stop_fn(t, n), self._nodes)
                    self._nodes = None
            else:
                raise ValueError(f"unknown f {f!r}")
            return {**op, "type": "info", "value": value}


def node_start_stopper(targeter, start_fn, stop_fn) -> Nemesis:
    return NodeStartStopper(targeter, start_fn, stop_fn)


def _rand_nth_targeter(nodes):
    from ..generator import rand_int

    return nodes[rand_int(len(nodes))]


def hammer_time(process: str, targeter=None) -> Nemesis:
    """SIGSTOP/SIGCONT a process on targeted nodes (nemesis.clj:347-361)."""
    from .. import control as c

    def start(test, node):
        with c.su():
            c.exec("killall", "-s", "STOP", process)
        return ["paused", process]

    def stop(test, node):
        with c.su():
            c.exec("killall", "-s", "CONT", process)
        return ["resumed", process]

    return node_start_stopper(targeter or _rand_nth_targeter, start, stop)


class TruncateFile(Nemesis):
    """{"f": "truncate", "value": {node: {"file": path, "drop": bytes}}}
    drops the last bytes from files (nemesis.clj:363-389)."""

    def invoke(self, test, op):
        from .. import control as c

        assert op.get("f") == "truncate"
        plan = op.get("value") or {}

        def f(t, node):
            spec = plan[node]
            with c.su():
                c.exec("truncate", "-c", "-s", f"-{int(spec['drop'])}",
                       spec["file"])

        c.on_nodes(test, f, list(plan.keys()))
        return dict(op)


def truncate_file() -> Nemesis:
    return TruncateFile()
