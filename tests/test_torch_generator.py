"""The port's generator, simulator and small runner helpers against the
reference's, exactly.

Every combinator is built twice, once from each package's ``generator``
module, and played through each package's deterministic simulator
(``generator.sim``, the RNG pinned to seed 45100): the ops, processes and
times must be the same. Also the context helpers, ``util``, the client and
nemesis protocols (``validate``, ``compose``, the grudge algebra under the
pinned RNG) and the control plane's dummy remote."""

from __future__ import annotations

import pytest

import jepsen_tpu.generator as RG
import jepsen_tpu_torch.generator as PG
from jepsen_tpu import client as ref_client
from jepsen_tpu import control as ref_control
from jepsen_tpu import nemesis as ref_nemesis
from jepsen_tpu import util as ref_util
from jepsen_tpu.generator import sim as ref_sim
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu_torch import client as port_client
from jepsen_tpu_torch import control as port_control
from jepsen_tpu_torch import nemesis as port_nemesis
from jepsen_tpu_torch import util as port_util
from jepsen_tpu_torch.generator import sim as port_sim
from jepsen_tpu_torch.history import History, Op

PAIRS = ((RG, ref_sim), (PG, port_sim))


def norm(x):
    """Plain data of an op or a value: lists for sequences, ``("KV", k, v)``
    for either package's key/value tuple, sorted reprs for a set."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if type(x).__name__ == "KV":
        return ("KV", norm(x.key), norm(x.value))
    if isinstance(x, (frozenset, set)):
        return sorted(map(repr, x))
    return x


def _ints(G, n=40, **kv):
    return [{"value": i, **kv} for i in range(n)]


def _on_update_case(G):
    box = {"delivered": None}

    def handler(this, test, ctx, event):
        if event.get("type") == "ok" and event.get("f") == "write":
            box["delivered"] = {"f": "confirm", "value": event.get("value")}
        return this

    return G.clients(G.any_(
        G.OnUpdate(handler, G.limit(2, G.repeat_({"f": "write", "value": 7}))),
        G.limit(1, lambda test, ctx: box["delivered"])))


# name -> builder(G) -> generator
CASES = {
    "nil": lambda G: None,
    "map_once": lambda G: {"f": "write"},
    "seq": lambda G: [{"f": "a"}, {"f": "b"}, {"f": "c"}, {"f": "d"}],
    "repeat_limit": lambda G: G.limit(7, G.repeat_({"f": "write", "value": 1})),
    "repeat_n": lambda G: G.repeat_(3, _ints(G)),
    "fn_rand": lambda G: G.limit(20, lambda: {"f": "w", "value": G.rand_int(100)}),
    "fn_test_ctx": lambda G: G.limit(12, lambda test, ctx: {"f": "w", "value": ctx.time}),
    "fn_rand_float": lambda G: G.limit(8, lambda: {"f": "w", "value": G.rand_float(3.0)}),
    "mix": lambda G: G.limit(40, G.mix([lambda: {"f": "read"},
                                        lambda: {"f": "write", "value": G.rand_int(5)},
                                        lambda: {"f": "cas",
                                                 "value": [G.rand_int(5), G.rand_int(5)]}])),
    "map_": lambda G: G.map_(lambda op: {**op, "value": 2 * op["value"]}, _ints(G, 12)),
    "f_map": lambda G: G.f_map({"a": "b"}, G.limit(6, G.repeat_({"f": "a"}))),
    "filter_": lambda G: G.filter_(lambda op: op["value"] % 3 == 0, _ints(G, 30)),
    "on_update": _on_update_case,
    "clients": lambda G: G.clients(G.limit(10, G.repeat_({"f": "r"}))),
    "clients_and_nemesis": lambda G: G.clients(G.limit(6, G.repeat_({"f": "r"})),
                                               G.limit(2, G.repeat_({"f": "kill"}))),
    "nemesis": lambda G: G.nemesis([{"type": "info", "f": "start"},
                                    {"type": "info", "f": "stop"}],
                                   G.limit(6, G.repeat_({"f": "r"}))),
    "reserve": lambda G: G.limit(30, G.reserve(1, G.repeat_({"f": "r"}),
                                               G.repeat_({"f": "w"}))),
    "reserve_mix": lambda G: G.limit(40, G.reserve(
        2, G.repeat_({"f": "read"}),
        G.mix([lambda: {"f": "write", "value": G.rand_int(5)},
               lambda: {"f": "cas", "value": [G.rand_int(5), G.rand_int(5)]}]))),
    "each_thread": lambda G: G.each_thread(G.limit(3, G.repeat_({"f": "w"}))),
    "each_thread_flip_flop": lambda G: G.limit(14, G.each_thread(
        G.flip_flop(lambda test=None, ctx=None: {"type": "invoke", "f": "acquire"},
                    lambda test=None, ctx=None: {"type": "invoke", "f": "release"}))),
    "flip_flop": lambda G: G.limit(10, G.flip_flop(G.repeat_({"f": "a"}),
                                                   G.repeat_({"f": "b"}))),
    "any_": lambda G: G.any_(G.limit(3, G.repeat_({"f": "a"})),
                             G.limit(5, G.repeat_({"f": "b"}))),
    "on_threads": lambda G: G.on_threads(lambda t: t == 0, G.limit(5, G.repeat_({"f": "a"}))),
    "process_limit": lambda G: G.process_limit(3, G.repeat_({"f": "w"})),
    "time_limit": lambda G: G.time_limit(50e-9, G.repeat_({"f": "w"})),
    "stagger": lambda G: G.limit(20, G.stagger(1e-8, G.repeat_({"f": "w"}))),
    "delay": lambda G: G.limit(5, G.delay(3e-9, G.repeat_({"f": "w"}))),
    "sleep": lambda G: G.clients([{"f": "a"}, G.sleep(1e-8), {"f": "b"}]),
    "cycle_": lambda G: G.limit(7, G.cycle_([{"f": "a"}, {"f": "b"}, {"f": "c"}])),
    "cycle_nemesis": lambda G: G.limit(6, G.cycle_([G.sleep(0), {"type": "info", "f": "start"},
                                                    G.sleep(0), {"type": "info", "f": "stop"}])),
    "phases": lambda G: G.clients(G.phases([{"f": "a"}] * 2, [{"f": "b"}], [{"f": "c"}] * 3)),
    "then": lambda G: G.clients(G.then(G.once({"f": "read"}),
                                       G.limit(3, lambda: {"f": "write", "value": 2}))),
    "synchronize": lambda G: G.clients([G.limit(3, G.repeat_({"f": "a"})),
                                        G.synchronize(G.limit(2, G.repeat_({"f": "b"})))]),
    "until_ok": lambda G: G.until_ok(G.repeat_({"f": "w"})),
    "concat": lambda G: G.concat([{"value": "a"}, {"value": "b"}], G.limit(1, {"value": "c"}),
                                 {"value": "d"}),
    "once": lambda G: G.once(lambda: {"f": "w", "value": G.rand_int(9)}),
    "log_": lambda G: [G.log_("hello"), {"f": "w"}, G.log_("bye")],
    "trace": lambda G: G.Trace("t", G.limit(2, G.repeat_({"f": "read"}))),
    "demo_cas": lambda G: G.clients(G.time_limit(2e-7, G.stagger(1e-8, G.mix([
        lambda: {"f": "write", "value": G.rand_int(5)},
        lambda: {"f": "cas", "value": [G.rand_int(5), G.rand_int(5)]},
        lambda: {"f": "read"}])))),
    "basic_cas": lambda G: G.phases(G.clients({"f": "read"}), G.clients(G.limit(
        30, G.reserve(5, G.repeat_({"f": "read"}), G.mix([
            lambda: {"f": "write", "value": G.rand_int(5)},
            lambda: {"f": "cas", "value": [G.rand_int(5), G.rand_int(5)]}]))))),
}

SIMS = ("perfect_star", "imperfect", "quick_ops", "perfect_info")


def simulate(which, sim_name, case, n=None):
    G, S = PAIRS[which]
    # Some combinators draw at construction (mix picks its first
    # generator): build under the same pin as the simulation.
    with G.fixed_rand(S.RAND_SEED):
        # The bound keeps every case finite under every simulator (a time
        # limit under zero latency, until_ok when every op crashes).
        g = G.limit(80, CASES[case](G))
    ctx = S.n_plus_nemesis_context(n) if n else None
    if sim_name == "perfect_info":
        return S.simulate(g, lambda c, o: {**o, "type": "info", "time": o["time"] + 10}, ctx)
    fn = getattr(S, sim_name)
    return fn(g, ctx) if ctx is not None or sim_name != "imperfect" else fn(g)


@pytest.mark.parametrize("sim_name", SIMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_combinator_simulates_as_the_reference(case, sim_name):
    ref = simulate(0, sim_name, case)
    port = simulate(1, sim_name, case)
    assert norm(port) == norm(ref)


@pytest.mark.parametrize("case", ["mix", "reserve_mix", "each_thread", "until_ok",
                                  "basic_cas", "stagger", "nemesis", "on_threads"])
def test_combinator_on_five_workers(case):
    ref = simulate(0, "imperfect", case, n=5)
    port = simulate(1, "imperfect", case, n=5)
    assert norm(port) == norm(ref) and port


def test_simulator_constants_and_rng_pin():
    assert port_sim.RAND_SEED == ref_sim.RAND_SEED == 45100
    assert port_sim.PERFECT_LATENCY == ref_sim.PERFECT_LATENCY
    with PG.fixed_rand(7):
        a = [PG.rand_int(1000) for _ in range(20)] + [PG.rand_float(1.0)]
    with RG.fixed_rand(7):
        b = [RG.rand_int(1000) for _ in range(20)] + [RG.rand_float(1.0)]
    assert a == b


def test_context_helpers():
    for G in (RG, PG):
        assert G.secs_to_nanos(1.5) == 1_500_000_000
    rc, pc = RG.context({"concurrency": 4}), PG.context({"concurrency": 4})
    assert RG.all_processes(rc) == PG.all_processes(pc)
    assert RG.all_threads(rc) == PG.all_threads(pc)
    assert sorted(map(repr, RG.free_processes(rc))) == sorted(map(repr, PG.free_processes(pc)))
    for t in (0, 3, "nemesis"):
        assert RG.thread_to_process(rc, t) == PG.thread_to_process(pc, t)
        assert RG.next_process(rc, t) == PG.next_process(pc, t)
    with RG.fixed_rand(3):
        r = RG.fill_in_op({"f": "w"}, rc)
    with PG.fixed_rand(3):
        p = PG.fill_in_op({"f": "w"}, pc)
    assert r == p


def test_friendly_exceptions_and_validate():
    def boom(test, ctx):
        raise ValueError("bad gen")

    msgs = []
    for G, S in PAIRS:
        with pytest.raises(Exception) as ei:
            S.perfect(G.friendly_exceptions(boom))
        msgs.append((type(ei.value).__name__, str(ei.value).split("\n")[0]))
    assert msgs[0] == msgs[1]

    class Bad:
        def op(self, test, ctx):
            return ({"type": "wat", "process": 0, "time": 0, "f": "x"}, None)

        def update(self, test, ctx, event):
            return self

    errs = []
    for G, S in PAIRS:
        bad = type("Bad", (G.Generator,), dict(Bad.__dict__))()
        with pytest.raises(Exception) as ei:
            S.perfect(bad)
        errs.append(type(ei.value).__name__)
    assert errs[0] == errs[1]


def test_with_nemesis_routes_the_nemesis_track():
    class Echo:
        def invoke(self, test, op):
            return {**op, "value": "done"}

    out = []
    for G, S in PAIRS:
        g = G.nemesis([{"type": "info", "f": "start"}], G.limit(3, G.repeat_({"f": "r"})))
        out.append(norm(S.simulate(g, S.with_nemesis(
            Echo(), lambda c, o: {**o, "type": "ok", "time": o["time"] + 10}))))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# util


def _latency_history(HistoryCls, OpCls):
    return HistoryCls([
        OpCls("invoke", 0, "w", 1, time=0), OpCls("invoke", "nemesis", "start", None, time=1),
        OpCls("ok", 0, "w", 1, time=5), OpCls("info", "nemesis", "start", None, time=6),
        OpCls("invoke", 1, "r", None, time=7), OpCls("invoke", "nemesis", "stop", None, time=8),
        OpCls("info", "nemesis", "stop", None, time=9), OpCls("ok", 1, "r", 1, time=12),
        OpCls("invoke", "nemesis", "start", None, time=13)])


def test_util_matches_reference():
    for n in range(0, 9):
        assert port_util.majority(n) == ref_util.majority(n)
    assert port_util.name_plus(3) == ref_util.name_plus(3) == "3"
    assert port_util.nanos_to_secs(1500) == ref_util.nanos_to_secs(1500)
    assert port_util.secs_to_nanos(0.25) == ref_util.secs_to_nanos(0.25)
    for xs in ([], [1, 2, 3, 5, 7, 8], [4]):
        assert port_util.integer_interval_set_str(xs) == ref_util.integer_interval_set_str(xs)
    rh, ph = _latency_history(RefHistory, RefOp), _latency_history(History, Op)
    assert [(repr(o), d) for o, d in port_util.history_to_latencies(ph)] == \
        [(repr(o), d) for o, d in ref_util.history_to_latencies(rh)]
    for fs in (None, {"start": "stop"}, {"start": {"stop", "heal"}}):
        got = [(repr(a), repr(b)) for a, b in port_util.nemesis_intervals(ph, fs)]
        want = [(repr(a), repr(b)) for a, b in ref_util.nemesis_intervals(rh, fs)]
        assert got == want


def test_util_parallel_timeout_retry():
    assert port_util.real_pmap(lambda x: x * x, range(6)) == [0, 1, 4, 9, 16, 25]
    with pytest.raises(KeyError):
        port_util.real_pmap(lambda x: {}[x], [1, 2])
    assert port_util.timeout(5, lambda: 4) == 4
    assert port_util.timeout(0.01, __import__("time").sleep, 1, default="late") == "late"
    with pytest.raises(port_util.TimeoutError_):
        port_util.timeout(0.01, __import__("time").sleep, 1)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("no")
        return "yes"

    assert port_util.with_retry(3, flaky) == "yes" and len(calls) == 3
    with port_util.with_relative_time():
        t0 = port_util.relative_time_nanos()
        assert 0 <= t0 < 1_000_000_000


# ---------------------------------------------------------------------------
# client, nemesis, control


@pytest.mark.parametrize("completion,ok", [({"type": "ok"}, True), ({"type": "wat"}, False),
                                           ({"type": "ok", "process": 9}, False),
                                           ({"type": "fail", "f": "other"}, False), (None, False)])
def test_client_validate_matches_reference(completion, ok):
    def run(mod):
        class C(mod.Client):
            def invoke(self, test, op):
                return None if completion is None else {**op, **completion}

        c = mod.validate(C())
        op = {"type": "invoke", "process": 0, "f": "w", "value": 1, "time": 0}
        try:
            return ("ok", c.invoke({}, op))
        except Exception as e:  # noqa: BLE001
            return ("err", type(e).__name__)

    ref, port = run(ref_client), run(port_client)
    assert port == ref
    assert (port[0] == "ok") is ok
    assert port_client.noop().invoke({}, {"f": "x"}) == ref_client.noop().invoke({}, {"f": "x"})
    assert isinstance(port_client.noop(), port_client.Reusable) == \
        isinstance(ref_client.noop(), ref_client.Reusable)


def test_grudges_match_reference():
    nodes = ["n1", "n2", "n3", "n4", "n5"]
    assert port_nemesis.bisect(nodes) == ref_nemesis.bisect(nodes)
    assert port_nemesis.split_one(nodes, "n2") == ref_nemesis.split_one(nodes, "n2")
    assert port_nemesis.complete_grudge([["n1"], ["n2", "n3"]]) == \
        ref_nemesis.complete_grudge([["n1"], ["n2", "n3"]])
    assert port_nemesis.bridge(nodes) == ref_nemesis.bridge(nodes)
    for seed in range(4):
        with PG.fixed_rand(seed):
            p = (port_nemesis.majorities_ring(nodes), port_nemesis.split_one(nodes))
        with RG.fixed_rand(seed):
            r = (ref_nemesis.majorities_ring(nodes), ref_nemesis.split_one(nodes))
        assert p == r


def test_partitioners_raise_naming_what_they_wait_for():
    for fn in (port_nemesis.partition_halves, port_nemesis.partition_random_halves,
               port_nemesis.partition_random_node, port_nemesis.partition_majorities_ring,
               port_nemesis.partitioner):
        with pytest.raises(ValueError, match="net.py"):
            fn()
    from jepsen_tpu_torch import db as port_db

    with pytest.raises(ValueError, match="control/util.py"):
        port_db.tcpdump()


def test_nemesis_compose_and_validate_match_reference():
    def run(mod):
        log = []

        class A(mod.Nemesis, mod.Reflection):
            def invoke(self, test, op):
                log.append(("A", op["f"]))
                return {**op, "value": "a"}

            def fs(self):
                return ["start", "stop"]

        class B(mod.Nemesis, mod.Reflection):
            def invoke(self, test, op):
                log.append(("B", op["f"]))
                return {**op, "value": "b"}

            def fs(self):
                return ["kill"]

        n = mod.validate(mod.compose([A(), B()])).setup({})
        out = [n.invoke({}, {"type": "info", "f": f}) for f in ("start", "kill", "stop")]
        renamed = mod.compose({(("boom", "start"),): A()}).setup({})
        out.append(renamed.invoke({}, {"type": "info", "f": "boom"}))
        with pytest.raises(ValueError):
            n.invoke({}, {"type": "info", "f": "nope"})

        class Nil(mod.Nemesis):
            def invoke(self, test, op):
                return None

        with pytest.raises(mod.ValidationError):
            mod.validate(Nil()).setup({}).invoke({}, {"f": "x"})
        return out, log, sorted(mod.compose([A(), B()]).fs())

    assert run(port_nemesis) == run(ref_nemesis)


def test_node_start_stopper_on_the_dummy_remote():
    def run(mod, cmod):
        log = []
        remote = cmod.dummy(log)
        test = {"nodes": ["n1", "n2", "n3"], "remote": remote}
        test["sessions"] = cmod.setup_sessions(test, remote)
        nem = mod.hammer_time("etcd", targeter=lambda nodes: nodes[:2])
        out = [nem.invoke(test, {"type": "info", "f": f}) for f in ("start", "start", "stop")]
        mod.truncate_file().invoke(test, {"f": "truncate",
                                          "value": {"n3": {"file": "/x", "drop": 5}}})
        cmod.close_sessions(test["sessions"])
        return norm(out), sorted(norm(log), key=repr)

    assert run(port_nemesis, port_control) == run(ref_nemesis, ref_control)


def test_control_escape_and_dummy_exec_match_reference():
    for x in ("a b", "it's", 3, "plain", "$HOME"):
        assert port_control.escape(x) == ref_control.escape(x)
    assert port_control.escape(port_control.Lit("a|b")) == ref_control.escape(ref_control.Lit("a|b"))

    def run(cmod):
        log = []
        remote = cmod.dummy(log, responses={"hostname": "node-x"})
        test = {"nodes": ["n1", "n2"], "remote": remote}
        sessions = cmod.setup_sessions(test, remote)
        test["sessions"] = sessions

        def body(t, node):
            with cmod.su():
                with cmod.cd("/opt"):
                    cmod.exec("echo", "hi there", cmod.Lit(">"), "/tmp/f")
            return cmod.exec("hostname")

        out = cmod.on_nodes(test, body)
        cmod.close_sessions(sessions)
        return norm(out), sorted(norm(log), key=repr)

    assert run(port_control) == run(ref_control)
