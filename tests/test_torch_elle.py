"""The port's Elle checker against the JAX reference on the CPU.

Each case builds the same history (or graph) in both packages and checks
that the result maps are equal — ``valid``, ``anomaly_types`` and every
witness cycle and kind list — and so is the engine ``report``
(``engine``/``chunks``/``causes``). The reference runs as its own tests run
it (JAX on the CPU); the port runs with ``torch_device="cpu"``, where every
closure takes the plain PyTorch versions.
"""

import random

import pytest
import torch

import jepsen_tpu.elle as R
import jepsen_tpu_torch.elle as P
from jepsen_tpu.elle import append as r_append
from jepsen_tpu.elle import graph as r_graph
from jepsen_tpu.elle import wr as r_wr
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.history import Op as ROp
from jepsen_tpu_torch import txn as p_txn
from jepsen_tpu_torch.checker import provenance
from jepsen_tpu_torch.elle import append as p_append
from jepsen_tpu_torch.elle import engine as p_engine
from jepsen_tpu_torch.elle import graph as p_graph
from jepsen_tpu_torch.elle import ops as p_ops
from jepsen_tpu_torch.elle import wr as p_wr
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import Op as POp
from jepsen_tpu_torch.testing import lagged_append_history, lagged_wr_history
from jepsen_tpu_torch.workloads import append as p_wl_append
from jepsen_tpu_torch.workloads import wr as p_wl_wr

CPU = {"torch_device": "cpu"}


def T(value, type="ok", process=0):
    return {"type": type, "f": "txn", "value": value, "process": process}


def rows_history(rows):
    """(reference History, port History) of (type, process, mops) rows."""
    mk = lambda H, O: H([O(t, p, "txn", v, time=i * 1_000_000)
                         for i, (t, p, v) in enumerate(rows)])
    return mk(RHistory, ROp), mk(PHistory, POp)


def to_ref_history(h):
    return RHistory([ROp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                     for o in h], reindex=False)


def port_graph(g):
    """The port's DepGraph with the reference graph's nodes and edges,
    added in the reference's insertion order (the witness walks follow
    adjacency-list order, so a sorted ``edge_list()`` would be another
    graph to them)."""
    out = P.DepGraph(g.n)
    for (s, d), k in g.edges.items():
        out.add(s, d, k)
    assert out.edge_list() == g.edge_list()
    return out


def both_checks(kind, ref_hist, port_hist, **kw):
    """(reference result, port result), each with its own report."""
    r_rep, p_rep = {}, {}
    r_fn, p_fn = (r_append.check, p_append.check) if kind == "append" else \
        (r_wr.check, p_wr.check)
    got_r = r_fn(ref_hist, report=r_rep, **kw)
    got_p = p_fn(port_hist, report=p_rep, torch_device="cpu", **kw)
    assert r_rep == p_rep
    return got_r, got_p


STALE_APPEND = [("invoke", 0, [["append", "x", 1]]), ("ok", 0, [["append", "x", 1]]),
                ("invoke", 1, [["r", "x", None]]), ("ok", 1, [["r", "x", []]])]

# (kind, history: list of dict completions or rows for a History, check options)
CASES = {
    "append_clean_serial": ("append", [T([["append", "x", 1]]),
                                       T([["r", "x", [1]], ["append", "x", 2]]),
                                       T([["r", "x", [1, 2]]])], {}),
    "append_g1a": ("append", [T([["append", "x", 1]], type="fail"), T([["r", "x", [1]]])], {}),
    "append_g1b": ("append", [T([["append", "x", 1], ["append", "x", 2]]),
                              T([["r", "x", [1]]]), T([["r", "x", [1, 2]]])], {}),
    "append_incompatible_order": ("append", [T([["r", "x", [1, 2]]]),
                                             T([["r", "x", [1, 3]]])], {}),
    "append_internal": ("append", [T([["append", "x", 9], ["r", "x", [1]]])], {}),
    "append_g1c": ("append", [T([["append", "x", 1], ["r", "y", [1]]]),
                              T([["append", "y", 1], ["r", "x", [1]]])], {}),
    "append_g_single": ("append", [T([["r", "x", []], ["r", "y", [9]]]),
                                   T([["append", "x", 1], ["append", "y", 9]]),
                                   T([["r", "y", [9]]])], {}),
    "append_g2_write_skew": ("append", [T([["r", "x", []], ["append", "y", 1]]),
                                        T([["r", "y", []], ["append", "x", 1]])], {}),
    "append_g0": ("append", [T([["append", "x", 1], ["append", "y", 2]]),
                             T([["append", "x", 2], ["append", "y", 1]]),
                             T([["r", "x", [1, 2]], ["r", "y", [1, 2]]])],
                  {"anomalies": ["G0"]}),
    "append_unrequested": ("append", [T([["r", "x", []], ["append", "y", 1]]),
                                      T([["r", "y", []], ["append", "x", 1]])],
                           {"anomalies": ["G1"]}),
    "append_chain_and_cycle": ("append", [T([["append", "k", i + 1],
                                             ["r", "k", list(range(1, i + 2))]])
                                          for i in range(30)]
                               + [T([["append", "x", 1], ["r", "y", [1]]]),
                                  T([["append", "y", 1], ["r", "x", [1]]])], {}),
    "wr_clean": ("wr", [T([["w", "x", 1]]), T([["r", "x", 1]])], {}),
    "wr_g1a": ("wr", [T([["w", "x", 1]], type="fail"), T([["r", "x", 1]])], {}),
    "wr_g1b": ("wr", [T([["w", "x", 1], ["w", "x", 2]]), T([["r", "x", 1]])], {}),
    "wr_internal": ("wr", [T([["w", "x", 1], ["r", "x", 2], ["w", "x", 3]])], {}),
    "wr_g1c": ("wr", [T([["w", "x", 1], ["r", "y", 2]]), T([["w", "y", 2], ["r", "x", 1]])],
               {}),
    "wr_write_skew_wfr": ("wr", [T([["w", "x", 1], ["w", "y", 1]]),
                                 T([["r", "x", 1], ["w", "x", 2], ["r", "y", 1]]),
                                 T([["r", "y", 1], ["w", "y", 2], ["r", "x", 1]])],
                          {"wfr_keys": True}),
    "wr_write_skew_no_assumption": ("wr", [T([["w", "x", 1], ["w", "y", 1]]),
                                           T([["r", "x", 1], ["w", "x", 2], ["r", "y", 1]]),
                                           T([["r", "y", 1], ["w", "y", 2], ["r", "x", 1]])],
                                    {}),
    "wr_write_skew_linearizable": ("wr", [T([["w", "x", 1], ["w", "y", 2]]),
                                          T([["r", "x", 1], ["w", "y", 3]]),
                                          T([["r", "y", 2], ["w", "x", 4]])],
                                   {"linearizable_keys": True}),
    "append_stale_read_realtime": ("append", STALE_APPEND,
                                   {"additional_graphs": ["realtime"]}),
    "append_stale_read_no_graphs": ("append", STALE_APPEND, {}),
    "append_stale_read_process": ("append", [(t, 0, v) for t, _p, v in STALE_APPEND],
                                  {"additional_graphs": ["process"]}),
    "append_fresh_read_realtime": ("append", [
        ("invoke", 0, [["append", "x", 1]]), ("ok", 0, [["append", "x", 1]]),
        ("invoke", 1, [["r", "x", None]]), ("ok", 1, [["r", "x", [1]]])],
        {"additional_graphs": ["realtime", "process"]}),
    "append_concurrent_stale_read": ("append", [
        ("invoke", 0, [["append", "x", 1]]), ("invoke", 1, [["r", "x", None]]),
        ("ok", 0, [["append", "x", 1]]), ("ok", 1, [["r", "x", []]])],
        {"additional_graphs": ["realtime"]}),
    "append_bare_realtime_unavailable": ("append", [T([["append", "x", 1]]),
                                                    T([["r", "x", []]])],
                                         {"additional_graphs": ["realtime"]}),
    "append_pure_not_double_reported": ("append", [
        ("invoke", 0, [["append", "x", 1], ["r", "y", None]]),
        ("ok", 0, [["append", "x", 1], ["r", "y", [1]]]),
        ("invoke", 1, [["append", "y", 1], ["r", "x", None]]),
        ("ok", 1, [["append", "y", 1], ["r", "x", [1]]])],
        {"additional_graphs": ["realtime", "process"]}),
    "append_bare_observed_info": ("append", [T([["append", "x", 1]], type="info", process=0),
                                             T([["r", "x", [1]]], process=0)],
                                  {"additional_graphs": ["process"]}),
    "wr_stale_read_realtime": ("wr", [
        ("invoke", 0, [["w", "x", 1]]), ("ok", 0, [["w", "x", 1]]),
        ("invoke", 1, [["w", "x", 2]]), ("ok", 1, [["w", "x", 2]]),
        ("invoke", 2, [["r", "x", None]]), ("ok", 2, [["r", "x", 1]])],
        {"linearizable_keys": True, "additional_graphs": ["realtime"]}),
}


@pytest.mark.parametrize("device", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_anomaly_cases_match_reference(name, device):
    kind, hist, kw = CASES[name]
    if isinstance(hist[0], dict):
        ref_hist = port_hist = hist
    else:
        ref_hist, port_hist = rows_history(hist)
    got_r, got_p = both_checks(kind, ref_hist, port_hist, device=device, **kw)
    assert got_p == got_r


def test_unknown_graph_name_rejected():
    h = [T([["append", "x", 1]])]
    with pytest.raises(ValueError, match="additional graph"):
        p_append.check(h, additional_graphs=["real-time"], **CPU)
    with pytest.raises(ValueError, match="additional graph"):
        p_wr.check(h, additional_graphs="realtime", **CPU)


def _random_typed_graph(rng, n, extra_edges=False):
    g = R.DepGraph(n)
    kinds = [R.WW, R.WW, R.WR, R.RW] + ([R.RT, R.PROC] if extra_edges else [])
    for _ in range(3 * n):
        g.add(rng.randrange(n), rng.randrange(n), rng.choice(kinds))
    return g


def both_cycles(g, **kw):
    r_rep, p_rep = {}, {}
    got_r = R.cycle_anomalies(g, report=r_rep, **kw)
    got_p = P.cycle_anomalies(port_graph(g), report=p_rep, torch_device="cpu", **kw)
    return got_r, got_p, r_rep, p_rep


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("device", [True, False])
def test_cycle_anomalies_random_graphs(seed, device):
    rng = random.Random(seed)
    g = _random_typed_graph(rng, rng.randrange(20, 160))
    got_r, got_p, r_rep, p_rep = both_cycles(g, device=device)
    assert got_p == got_r and p_rep == r_rep


@pytest.mark.parametrize("seed", range(4))
def test_cycle_anomalies_suffixed_passes(seed):
    rng = random.Random(1000 + seed)
    g = _random_typed_graph(rng, rng.randrange(20, 120), extra_edges=True)
    for device in (True, False):
        got_r, got_p, r_rep, p_rep = both_cycles(g, device=device,
                                                 extra=("realtime", "process"))
        assert got_p == got_r and p_rep == r_rep


def test_bucket_padding_equality():
    g = _random_typed_graph(random.Random(9), 100)
    got_r, got_p, r_rep, p_rep = both_cycles(g, device=True, min_bucket=256)
    assert got_p == got_r and p_rep == r_rep
    assert P.cycle_anomalies(port_graph(g), device=True, **CPU) == got_p


def test_env_override_and_auto_mode(monkeypatch):
    g = _random_typed_graph(random.Random(11), 30)
    for env, device, engine in (("0", True, "host"), ("1", False, "device"), (None, None, "host")):
        if env is None:
            monkeypatch.delenv("JEPSEN_ELLE_DEVICE", raising=False)
        else:
            monkeypatch.setenv("JEPSEN_ELLE_DEVICE", env)
        got_r, got_p, r_rep, p_rep = both_cycles(g, device=device)
        assert got_p == got_r and p_rep == r_rep and p_rep["engine"] == engine


def test_oom_past_the_rung_budget_degrades_to_host(monkeypatch):
    """Every dispatch out of memory on CPU tensors: the port halves its
    chunk down to one member, then folds to the host with elle_device_oom
    causes, as the reference does for a failing dispatch."""
    from jepsen_tpu.elle import ops as r_ops

    g = _random_typed_graph(random.Random(13), 60)
    calls = []

    def boom_ref(pad, epad):
        raise RuntimeError("RESOURCE_EXHAUSTED: injected")

    def boom_port(S, D, pad, torch_device=None):
        assert torch.device(torch_device).type == "cpu"
        calls.append(len(S))
        raise torch.OutOfMemoryError("CUDA out of memory: injected")

    monkeypatch.setattr(r_ops, "batched_closure_kernel", boom_ref)
    monkeypatch.setattr(p_ops, "batched_closure", boom_port)
    got_r, got_p, r_rep, p_rep = both_cycles(g, device=True)
    assert got_p == got_r == R.cycle_anomalies(g, device=False)
    codes = [c["code"] for c in p_rep["causes"]]
    assert codes and set(codes) == {"elle_device_oom"} and p_rep["engine"] == "host"
    assert [c["code"] for c in r_rep["causes"]] == codes
    assert calls == [3, 1]  # three masks in one chunk, halved to one member, then the fold


def test_oom_past_the_rung_budget_raises_on_the_gpu(monkeypatch):
    """On a CUDA torch device the spent rung budget raises, naming the
    bucket and the members, instead of folding the card's work to the
    host."""
    calls = []

    def boom(S, D, pad, torch_device=None):
        calls.append(len(S))
        raise torch.OutOfMemoryError("CUDA out of memory: injected")

    monkeypatch.setattr(p_engine, "_torch_device", lambda _d: torch.device("cuda"))
    monkeypatch.setattr(p_ops, "batched_closure", boom)
    g = port_graph(_random_typed_graph(random.Random(13), 60))
    rep = {}
    with pytest.raises(torch.OutOfMemoryError, match=r"bucket 128: a chunk of 1 of 3"):
        P.cycle_anomalies(g, device=True, report=rep)
    assert calls == [3, 1] and not rep.get("causes")


def test_transient_oom_costs_a_rung_not_the_verdict(monkeypatch):
    g = _random_typed_graph(random.Random(14), 60)
    real = p_ops.batched_closure
    fired = []

    def once(*a, **kw):
        if not fired:
            fired.append(1)
            raise torch.OutOfMemoryError("injected")
        return real(*a, **kw)

    monkeypatch.setattr(p_ops, "batched_closure", once)
    rep = {}
    got = P.cycle_anomalies(port_graph(g), device=True, report=rep, **CPU)
    assert fired and got == R.cycle_anomalies(g, device=False)
    # The chunk of three masks halved to one member: three chunks.
    assert rep["engine"] == "device" and not rep.get("causes") and rep["chunks"] == 3


def test_other_kernel_faults_propagate(monkeypatch):
    """Only torch.OutOfMemoryError enters the halving rung: a launch error
    must not become a quiet host fallback."""
    def fault(*a, **kw):
        raise RuntimeError("elle_square: CUDA error 700 (an illegal memory access)")

    monkeypatch.setattr(p_ops, "batched_closure", fault)
    g = port_graph(_random_typed_graph(random.Random(15), 40))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        P.cycle_anomalies(g, device=True, **CPU)


def test_bucket_ceiling_degrades_with_typed_cause():
    g = R.DepGraph(p_ops.CEILING + 1)
    for a, b in [(0, 1), (1, 2), (2, 0), (5, 6)]:
        g.add(a, b, R.WW)
    got_r, got_p, r_rep, p_rep = both_cycles(g, device=True)
    assert got_p == got_r and p_rep == r_rep
    assert p_rep["engine"] == "host"
    assert {c["code"] for c in p_rep["causes"]} == {"elle_bucket_ceiling"}
    assert all(c["layer"] == "elle" for c in p_rep["causes"])


def test_batch_matches_reference_and_chunk_contract():
    rng = random.Random(15)
    graphs = [R.DepGraph(0), R.DepGraph(5)]
    graphs += [_random_typed_graph(rng, rng.randrange(10, 200)) for _ in range(12)]
    r_rep, p_rep = {}, {}
    got_r = R.cycle_anomalies_batch(graphs, device=True, report=r_rep)
    got_p = P.cycle_anomalies_batch([port_graph(g) for g in graphs], device=True,
                                    report=p_rep, **CPU)
    assert got_p == got_r and p_rep == r_rep
    buckets = {p_ops.bucket_for(g.n) for g in graphs if g.edges}
    assert len(buckets) == 2 and p_rep["chunks"] == 2
    assert got_p == [P.cycle_anomalies(port_graph(g), device=False) for g in graphs]


def test_scc_reach_closes_a_big_component_like_the_reference():
    n = R.DEVICE_MIN_TXNS + 16
    succ = [[(i + 1) % n] + ([(i + 7) % n] if i % 5 == 0 else []) for i in range(n)]
    sccs = [list(range(n))]
    r = r_graph.SccReach(succ, sccs, device=True, device_min=R.DEVICE_MIN_TXNS)
    p = p_graph.SccReach(succ, sccs, device=True, device_min=P.DEVICE_MIN_TXNS, **CPU)
    host = p_graph.SccReach(succ, sccs, device=False)
    queries = [(i * 37 % n, (i * 61 + 5) % n) for i in range(24)]
    for s, d in queries:
        assert p.query(0, s, d) == r.query(0, s, d) == host.query(0, s, d), (s, d)
    assert p._closures and r._closures
    assert (p._closures[0][0] == r._closures[0][0]).all()  # the packed closure, bit for bit
    assert p._closures[0][0].shape == (1024, 32)


def test_big_scc_device_closure():
    n = R.DEVICE_MIN_TXNS + 40
    g = R.DepGraph(n)
    for i in range(n - 1):
        g.add(i, i + 1, R.WW)
    g.add(n - 1, 0, R.RW)
    for device in (True, False):
        got_r, got_p, r_rep, p_rep = both_cycles(g, device=device)
        assert got_p == got_r and set(got_p) == {"G-single"} and p_rep == r_rep


def test_realtime_pass_through_a_device_sized_component():
    n = R.DEVICE_MIN_TXNS + 90
    out = {}
    for device in (False, True):
        gr, gp = R.DepGraph(n), P.DepGraph(n)
        R.add_realtime_edges(gr, [(i, 2 * i, 2 * i + 1) for i in range(n)])
        P.add_realtime_edges(gp, [(i, 2 * i, 2 * i + 1) for i in range(n)])
        for j in range(10):
            gr.add(n - 1 - j, j, R.RW)
            gp.add(n - 1 - j, j, P.RW)
        assert gp.edge_list() == gr.edge_list() and gp.n == gr.n
        want = R.cycle_anomalies(gr, device=device, extra=("realtime",), n_txns=n)
        got = P.cycle_anomalies(gp, device=device, extra=("realtime",), n_txns=n, **CPU)
        assert got == want
        out[device] = set(got)
    assert out[False] == out[True] == {"G-single-realtime"}


@pytest.mark.parametrize("n_txns,lag,extra", [(300, (60, 240), ("process", "realtime")),
                                             (600, (100, 400), ("process",))])
def test_lagged_append_history_on_the_device_engine(n_txns, lag, extra):
    h = lagged_append_history(3, n_txns, lag, depth=8)
    got_r, got_p = both_checks("append", to_ref_history(h), h, device=True,
                               additional_graphs=extra)
    assert got_p == got_r and got_p["valid"] is False
    assert got_p["engine"]["engine"] == "device" and got_p["engine"]["chunks"] == 1
    host = p_append.check(h, device=False, additional_graphs=extra, **CPU)
    assert {k: v for k, v in got_p.items() if k != "engine"} == host


def test_lagged_wr_history_on_the_device_engine():
    h = lagged_wr_history(4, 400, (80, 300), depth=8)
    got_r, got_p = both_checks("wr", to_ref_history(h), h, device=True, wfr_keys=True)
    assert got_p == got_r and got_p["engine"]["engine"] == "device"


def test_lagged_history_is_serializable_outside_the_window():
    h = lagged_append_history(3, 300, None)
    assert p_append.check(h, device=True, **CPU)["valid"] is True
    assert p_wr.check(lagged_wr_history(3, 300, None), device=True, wfr_keys=True,
                      **CPU)["valid"] is True


def test_workload_checkers_match_reference():
    from jepsen_tpu.workloads import append as r_wl_append
    from jepsen_tpu.workloads import wr as r_wl_wr

    h = [T([["r", "x", []], ["r", "y", [9]]]), T([["append", "x", 1], ["append", "y", 9]])]
    test = {"no-store?": True, "name": "x", "start-time": "t"}
    got = p_wl_append.checker({"torch_device": "cpu"}).check(test, h, {})
    assert got == r_wl_append.checker().check(test, h, {})
    assert got["valid"] is False and "directory" not in got
    hw = [T([["w", "x", 1]], type="fail"), T([["r", "x", 1]])]
    got = p_wl_wr.checker({"anomalies": ["G1"], "torch_device": "cpu"}).check({}, hw, {})
    assert got == r_wl_wr.checker({"anomalies": ["G1"]}).check({}, hw, {})


def test_what_later_slices_bring_raises():
    """The txn generators draw the reference's txns under the pinned
    generator RNG, as do the append and wr workloads' ``gen``, and their
    ``test`` maps hold a generator and a checker; ``monotonic_key_check``
    gives the reference's result."""
    import jepsen_tpu.generator as r_gen
    import jepsen_tpu_torch.generator as p_gen
    from jepsen_tpu import txn as r_txn
    from jepsen_tpu.workloads import append as r_wl_append
    from jepsen_tpu.workloads import wr as r_wl_wr

    h = [T([["append", "x", 1]])]
    assert P.monotonic_key_check(h) == R.monotonic_key_check(h)
    for name, p_mk, r_mk in (("append_txns", p_txn.append_txns, r_txn.append_txns),
                             ("wr_txns", p_txn.wr_txns, r_txn.wr_txns),
                             ("append.gen", p_wl_append.gen, r_wl_append.gen),
                             ("wr.gen", p_wl_wr.gen, r_wl_wr.gen)):
        with p_gen.fixed_rand(5):
            got = p_txn.take(p_mk(), 60)
        with r_gen.fixed_rand(5):
            want = r_txn.take(r_mk(), 60)
        assert got == want and len(got) == 60, name
    t = p_wl_wr.test({"torch_device": "cpu"})
    assert set(t) == {"generator", "checker"}


def test_engine_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    g = port_graph(_random_typed_graph(random.Random(2), 30))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.cycle_anomalies(g, device=True)
    assert P.cycle_anomalies(g, device=False) == R.cycle_anomalies(
        _random_typed_graph(random.Random(2), 30), device=False)


def test_txn_helpers_and_provenance_match_reference():
    from jepsen_tpu import txn as r_txn
    from jepsen_tpu.checker import provenance as r_prov

    t = [["r", "x", 1], ["w", "y", 2], ["r", "y", 3], ["w", "x", 4], ["w", "x", 5]]
    for fn in ("ext_reads", "ext_writes", "int_write_mops"):
        assert getattr(p_txn, fn)(t) == getattr(r_txn, fn)(t)
    h = [T(t), T([["r", "z", None]])]
    assert list(p_txn.op_mops(h)) == list(r_txn.op_mops(h))
    f = lambda acc, op, mop: acc + [mop[1]]
    assert p_txn.reduce_mops(f, [], h) == r_txn.reduce_mops(f, [], h)
    # elle_device_oom keeps the reference's code and layer; its text says
    # that only CPU tensors fold to the host in the port.
    assert provenance.TAXONOMY["elle_bucket_ceiling"] == r_prov.TAXONOMY["elle_bucket_ceiling"]
    for code in ("elle_bucket_ceiling", "elle_device_oom"):
        assert provenance.TAXONOMY[code][0] == r_prov.TAXONOMY[code][0]
        assert provenance.cause(code, n=1) == r_prov.cause(code, n=1)
    assert p_engine.MAX_ESCALATIONS == 4 and p_engine.MEMBER_BYTE_BUDGET == 1 << 31


def test_graph_closures_views_match_reference():
    """engine.graph_closures: every mask's ClosureView (packed rows, labels,
    SCCs and the taxonomy's bit tests) equal to the reference's."""
    from jepsen_tpu.elle import engine as r_engine

    g = _random_typed_graph(random.Random(21), 90)
    masks = [R.WW, R.WW | R.WR, R.WW | R.WR | R.RW, R.RT]
    want = r_engine.graph_closures(g, masks)
    got = p_engine.graph_closures(port_graph(g), masks, **CPU)
    assert list(got) == list(want) and got[R.RT] is p_engine.EMPTY_VIEW
    for m in masks[:3]:
        assert (got[m].packed == want[m].packed).all() and got[m].packed.dtype == "uint32"
        assert (got[m].labels == want[m].labels).all()
        assert got[m].sccs() == want[m].sccs() and got[m].diag_any() == want[m].diag_any()
        assert [got[m].same_scc(a, b) for a in range(0, 90, 7) for b in range(0, 90, 11)] == \
            [want[m].same_scc(a, b) for a in range(0, 90, 7) for b in range(0, 90, 11)]


def test_host_oracle_and_closures_device_match_reference():
    """closures_device (three masks in one batched closure), closure_host,
    sccs_host and the dense witness walks against the reference's."""
    for n in (8, 40, 130):
        g = _random_typed_graph(random.Random(n), n)
        adj = g.adjacency()
        assert (port_graph(g).adjacency() == adj).all()
        want = r_graph.closures_device(adj)
        got = p_graph.closures_device(adj, **CPU)
        assert got[:3] == want[:3]
        assert (got[3] == want[3]).all() and (got[4] == want[4]).all()
        for mask in (R.WW, R.WW | R.WR, 0xFF):
            assert (p_graph.closure_host(adj, mask) == r_graph.closure_host(adj, mask)).all()
            sccs = p_graph.sccs_host(adj, mask)
            assert sccs == r_graph.sccs_host(adj, mask)
            if sccs:
                assert p_graph.find_cycle_host(adj, mask, sccs[0]) == \
                    r_graph.find_cycle_host(adj, mask, sccs[0])
        rw = [(a, b) for (a, b), k in g.edges.items() if k & R.RW][:3]
        for a, b in rw:
            assert p_graph.find_cycle_with_edge_host(adj, R.WW | R.WR, a, b) == \
                r_graph.find_cycle_with_edge_host(adj, R.WW | R.WR, a, b)
