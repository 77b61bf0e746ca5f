"""The port's workload generators against the reference's, exactly.

Each generator is built in both packages under the generator RNG pinned to
the simulator's seed (45100), played through each package's simulator, and
the ops, processes and times compared: the txn streams (``txn.append_txns``,
``wr_txns``, ``take``), the append and wr workloads, the lock and semaphore
workloads, the keyed register of ``workloads.linearizable_register``,
``independent``'s keyed generators, the bank, causal, long-fork and G2
workloads, and the demo suite's ``cas-register`` and ``noop`` tests."""

from __future__ import annotations

import importlib
import itertools

import pytest

import jepsen_tpu.__main__ as ref_main
import jepsen_tpu_torch.__main__ as port_main

PKGS = ("jepsen_tpu", "jepsen_tpu_torch")


def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if type(x).__name__ == "KV":
        return ("KV", plain(x.key), plain(x.value))
    return x


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# name -> (builder(pkg) -> (generator, test map), number of worker threads)
def _wl(name, fn, *args, **kw):
    def build(pkg):
        return getattr(mod(pkg, f"workloads.{name}"), fn)(*args, **kw), {}

    return build


def _test_map(name, fn, opts=None, extra=None):
    def build(pkg):
        t = getattr(mod(pkg, f"workloads.{name}"), fn)(
            dict(opts or {}, device="cpu", torch_device="cpu"))
        test = {k: v for k, v in t.items() if k not in ("checker", "generator")}
        return t["generator"], {**test, **(extra or {})}

    return build


def _txn(fn, **kw):
    def build(pkg):
        return getattr(mod(pkg, "txn"), fn)(**kw), {}

    return build


def _ind(kind):
    def build(pkg):
        G = mod(pkg, "generator")
        ind = mod(pkg, "independent")

        def fgen(k):
            return G.limit(4, G.mix([lambda: {"f": "write", "value": G.rand_int(5)},
                                     lambda: {"f": "read"}]))

        if kind == "tuple":
            return ind.tuple_gen("k", G.limit(5, G.repeat_({"f": "read"}))), {}
        if kind == "sequential":
            return ind.sequential_generator([1, 2, 3], fgen), {}
        if kind == "concurrent":
            return ind.concurrent_generator(2, itertools.count(), fgen), {}
        return ind.concurrent_generator(2, [10, 11, 12], fgen), {}

    return build


def _demo(name):
    def build(pkg):
        main = ref_main if pkg == "jepsen_tpu" else port_main
        t = main.WORKLOADS[name]({"time_limit": 1, "rate": 1e9, "device": "cpu"})
        return t["generator"], {}

    return build


CASES = {
    "append_txns": (_txn("append_txns"), 2),
    "append_txns_wide": (_txn("append_txns", key_count=5, max_txn_length=8,
                              max_writes_per_key=3), 2),
    "wr_txns": (_txn("wr_txns"), 2),
    "wr_txns_wide": (_txn("wr_txns", key_count=4, min_txn_length=2, max_txn_length=5,
                          max_writes_per_key=2), 2),
    "append_gen": (_wl("append", "gen", {"key_count": 4}), 3),
    "append_test": (_test_map("append", "test"), 3),
    "wr_gen": (_wl("wr", "gen"), 3),
    "wr_test": (_test_map("wr", "test"), 3),
    "lock_generator": (_wl("lock", "lock_generator"), 3),
    "lock_test": (_test_map("lock", "lock_test", {"model": "fenced-mutex"}), 3),
    "semaphore_test": (_test_map("lock", "semaphore_test"), 3),
    "linearizable_register": (_test_map("linearizable_register", "test",
                                        {"nodes": ["n1", "n2"], "per-key-limit": 6}), 4),
    "tuple_gen": (_ind("tuple"), 2),
    "sequential_generator": (_ind("sequential"), 2),
    "concurrent_generator": (_ind("concurrent"), 4),
    "concurrent_generator_finite": (_ind("finite"), 4),
    "bank_test": (_test_map("bank", "test"), 3),
    "causal_test": (_test_map("causal", "test", {"time-limit": 30}), 3),
    "causal_reverse": (_test_map("causal", "reverse_workload",
                                 {"nodes": ["n1", "n2"], "per-key-limit": 4}), 4),
    "long_fork": (_wl("long_fork", "generator", 3), 3),
    "long_fork_workload": (_wl("long_fork", "workload"), 2),
    "adya_g2": (_wl("adya", "g2_gen"), 4),
    "demo_cas_register": (_demo("cas-register"), 3),
    "demo_noop": (_demo("noop"), 3),
}


def simulate(pkg, case, sim_name):
    G = mod(pkg, "generator")
    S = mod(pkg, "generator.sim")
    build, n = CASES[case]
    with G.fixed_rand(S.RAND_SEED):
        g, test = build(pkg)
        if isinstance(g, dict) and "checker" in g:  # a workload map
            test = {k: v for k, v in g.items() if k not in ("checker", "generator")}
            g = g["generator"]
        g = G.limit(40, g)
    ctx = S.n_plus_nemesis_context(n)
    if sim_name == "imperfect":
        return S.imperfect(g, ctx) if not test else S.simulate(g, _rotating(S), ctx, test)
    return S.simulate(g, lambda c, o: {**o, "type": "ok", "time": o["time"] + 10}, ctx,
                      test or None)


def _rotating(S):
    """``sim.imperfect``'s fail -> info -> ok rotation, for a call that also
    passes a test map."""
    state: dict = {}
    rot = {None: "fail", "fail": "info", "info": "ok", "ok": "fail"}

    def complete(ctx, o):
        t = S.process_to_thread(ctx, o["process"])
        state[t] = rot[state.get(t)]
        return {**o, "type": state[t], "time": o["time"] + S.PERFECT_LATENCY}

    return complete


@pytest.mark.parametrize("sim_name", ["perfect", "imperfect"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_workload_generator_simulates_as_the_reference(case, sim_name):
    want = simulate("jepsen_tpu", case, sim_name)
    got = simulate("jepsen_tpu_torch", case, sim_name)
    assert plain(got) == plain(want)
    assert got, case


@pytest.mark.parametrize("fn,kw", [("append_txns", {}), ("wr_txns", {"key_count": 3})])
def test_txn_take_matches_reference(fn, kw):
    out = []
    for pkg in PKGS:
        G = mod(pkg, "generator")
        with G.fixed_rand(11):
            out.append(mod(pkg, "txn").take(getattr(mod(pkg, "txn"), fn)(**kw), 200))
    assert out[0] == out[1] and len(out[1]) == 200


def test_long_fork_read_txn_draws_from_the_generator_rng():
    out = []
    for pkg in PKGS:
        G = mod(pkg, "generator")
        lf = mod(pkg, "workloads.long_fork")
        with G.fixed_rand(4):
            out.append([lf.read_txn_for(5, k) for k in range(12)])
    assert out[0] == out[1]


def test_group_threads_matches_reference():
    for n, conc in ((1, 3), (2, 4), (3, 6)):
        got = [mod(pkg, "independent").group_threads(
            n, mod(pkg, "generator").context({"concurrency": conc})) for pkg in PKGS]
        assert got[0] == got[1]
    for pkg in PKGS:
        with pytest.raises(AssertionError):
            mod(pkg, "independent").group_threads(
                2, mod(pkg, "generator").context({"concurrency": 3}))


def test_workload_maps_carry_the_references_keys():
    """The test maps have the reference's keys, and their checkers check
    on the CPU when asked."""
    for name, fn, opts in (("bank", "test", {}), ("causal", "test", {}),
                           ("causal", "reverse_workload", {}), ("long_fork", "workload", None),
                           ("adya", "g2", {}), ("append", "test", {}), ("wr", "test", {}),
                           ("lock", "lock_test", {}), ("lock", "semaphore_test", {}),
                           ("linearizable_register", "test", {})):
        maps = []
        for pkg in PKGS:
            f = getattr(mod(pkg, f"workloads.{name}"), fn)
            maps.append(f() if opts is None else f(dict(opts, device="cpu",
                                                         torch_device="cpu")))
        assert set(maps[0]) == set(maps[1]), (name, fn)
        assert {k: v for k, v in maps[0].items() if k not in ("checker", "generator")} == \
            {k: v for k, v in maps[1].items() if k not in ("checker", "generator")}
