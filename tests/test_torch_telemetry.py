"""The port's driver telemetry and chunk callbacks against the JAX
reference's, on the CPU with the same seeded histories: the single
driver's ``wgl_chunk``/``wgl_level``/``wgl_escalation`` events, the
batch's ``wgl_batch_chunk``/``wgl_batch_rung``/``wgl_rebatch`` events, the
sharded driver's ``wgl_sharded_chunk`` events in both exchange modes, the
Elle engine's ``elle_batch_chunk`` events, every counter and gauge, and the
callback dicts. Walls, ``t0``/``t1`` and ``stage`` are excluded (the port's
``stage`` follows the load of its kernel library, the reference's its JIT
builds); so are the reference's build-cache counter
(``wgl_kernel_cache_total``: the port builds no program per bucket) and the
wall-valued ``wgl_kernel_seconds_total``. Both packages cut chunks at the
same levels: ``levels_per_call`` is given. The reference's readers
(``telemetry.utilization``, ``telemetry.profile``) read the port's
registry."""

import random

import pytest
import torch

import jepsen_tpu.elle as R
import jepsen_tpu_torch.elle as P
from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.parallel import frontier as ref_frontier
from jepsen_tpu.parallel import make_mesh as ref_make_mesh
from jepsen_tpu.parallel.batch import check_encoded_batch as ref_check_encoded_batch
from jepsen_tpu.telemetry import Registry as RefRegistry
from jepsen_tpu.telemetry import profile as ref_profile
from jepsen_tpu.telemetry import utilization as ref_utilization
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch import telemetry, trace
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops.encode import encode_history
from jepsen_tpu_torch.parallel import check_encoded_batch, frontier, make_mesh
from jepsen_tpu_torch.testing import perturb_history, random_register_history

# Fields no comparison reads: walls, stamps, the build stage.
WALL = {"wall_s", "chunk_wall_s", "t0", "t1", "stage"}
# Metrics the port does not record (no per-bucket program builds) or that
# hold walls.
SKIP_METRICS = {"wgl_kernel_cache_total", "wgl_kernel_seconds_total"}
_REF_MESHES = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain stages run many small ops: one intra-op thread each keeps
    a worker from oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_ambient_kill_switch(monkeypatch):
    monkeypatch.delenv("JEPSEN_WGL_EXCHANGE", raising=False)


def _histories(seed, n_ops, n_procs, crash_p, perturb):
    r1, r2 = random.Random(seed), random.Random(seed)
    kw = dict(n_ops=n_ops, n_procs=n_procs, crash_p=crash_p)
    h1, h2 = ref_random(r1, **kw), random_register_history(r2, **kw)
    if perturb:
        h1, h2 = ref_perturb(r1, h1), perturb_history(r2, h2)
    return h1, h2


def _events(reg, name, drop=WALL):
    return [{k: v for k, v in e.items() if k not in drop} for e in reg.events(name)]


def _samples(reg):
    return sorted((s["name"], tuple(sorted(s["labels"].items())), s["value"])
                  for s in reg.collect() if s["name"] not in SKIP_METRICS)


def _callbacks(infos):
    return [{k: v for k, v in i.items() if k != "wall_s"} for i in infos]


def _same_metrics(port_reg, ref_reg, names):
    for name in names:
        assert _events(port_reg, name) == _events(ref_reg, name), name
    assert _samples(port_reg) == _samples(ref_reg)


# (seed, n_ops, n_procs, crash_p, perturb, f_schedule, pad_to, optimistic, levels_per_call)
SINGLE = [
    (0, 30, 4, 0.15, False, (16, 64), (32, 1, 64, 32), None, 8),
    (1, 30, 4, 0.15, True, (16, 64), (32, 1, 64, 32), None, 8),
    (40, 30, 6, 0.3, False, (2, 4096), (32, 1, 64, 32), None, 8),   # escalations
    (60, 40, 5, 0.1, False, (16, 32, 64), (32, 1, 64, 32), True, 8),  # optimistic beam
    (61, 40, 5, 0.1, True, (16, 32, 64), (32, 1, 64, 32), True, 16),
    (22, 40, 6, 0.3, False, (16, 128), (32, 1, 64, 32), None, 12),
]


def _single_both(case, **kw):
    seed, n_ops, n_procs, crash_p, perturb, sched, pad_to, optimistic, lpc = case
    h1, h2 = _histories(seed, n_ops, n_procs, crash_p, perturb)
    opts = dict(f_schedule=sched, pad_to=pad_to, optimistic=optimistic, levels_per_call=lpc)
    ref_reg, port_reg = RefRegistry(), telemetry.Registry()
    ref_cb, port_cb = [], []
    ref = ref_wgl.check_encoded_device(ref_encode(RefCas(init=0), h1), metrics=ref_reg,
                                       chunk_callback=ref_cb.append, **opts, **kw)
    port = wgl.check_encoded_device(encode_history(CasRegister(init=0), h2), metrics=port_reg,
                                    chunk_callback=port_cb.append, device="cpu", **opts, **kw)
    return ref, port, ref_reg, port_reg, ref_cb, port_cb


@pytest.mark.parametrize("case", SINGLE, ids=lambda c: f"seed{c[0]}")
def test_single_driver_metrics_match_reference(case):
    """Every ``wgl_level`` event field for field, the ``wgl_chunk`` events'
    ``level0``, ``level`` and ``F``, the escalation events, every counter
    and gauge, and the callback dicts."""
    ref, port, ref_reg, port_reg, ref_cb, port_cb = _single_both(case)
    assert (port["valid"], port["levels"]) == (ref["valid"], ref["levels"])
    _same_metrics(port_reg, ref_reg, ("wgl_level", "wgl_escalation"))
    def chunk(reg):
        return [(e["level0"], e["level"], e["F"]) for e in reg.events("wgl_chunk")]

    assert chunk(port_reg) == chunk(ref_reg) and chunk(port_reg)
    assert {e["stage"] for e in port_reg.events("wgl_chunk")} == {"execute"}
    assert all(e["t0"] <= e["t1"] for e in port_reg.events("wgl_chunk"))
    assert _callbacks(port_cb) == _callbacks(ref_cb)
    assert len(port_cb) == len(port_reg.events("wgl_chunk"))


def test_callback_exceptions_propagate():
    """A callback that raises stops the search with its exception (how a
    caller enforces a deadline), in both packages at the same chunk."""
    def stop_after(n, seen):
        def cb(info):
            seen.append(info["level"])
            if len(seen) == n:
                raise TimeoutError("deadline")
        return cb

    h1, h2 = _histories(0, 30, 4, 0.15, False)
    seen_r, seen_p = [], []
    with pytest.raises(TimeoutError):
        ref_wgl.check_encoded_device(ref_encode(RefCas(init=0), h1), levels_per_call=8,
                                     pad_to=(32, 1, 64, 32), chunk_callback=stop_after(2, seen_r))
    with pytest.raises(TimeoutError):
        wgl.check_encoded_device(encode_history(CasRegister(init=0), h2), levels_per_call=8,
                                 pad_to=(32, 1, 64, 32), chunk_callback=stop_after(2, seen_p),
                                 device="cpu")
    assert seen_p == seen_r and len(seen_p) == 2


def test_metrics_off_reads_no_stats_ring(monkeypatch):
    """With ``metrics=None`` (and no ``collect_stats``) the chunk loop reads
    nothing but the flags: the stats ring is never copied to the host."""
    real = wgl._Search.chunk

    class Untouchable:
        def cpu(self):
            raise AssertionError("the stats ring was read")

    def chunk(self, *a):
        flags, _stats = real(self, *a)
        return flags, Untouchable()

    monkeypatch.setattr(wgl._Search, "chunk", chunk)
    _h1, h2 = _histories(1, 30, 4, 0.15, True)
    res = wgl.check_encoded_device(encode_history(CasRegister(init=0), h2), levels_per_call=8,
                                   device="cpu")
    assert res["valid"] in (True, False)
    with pytest.raises(AssertionError, match="stats ring"):
        wgl.check_encoded_device(encode_history(CasRegister(init=0), h2), levels_per_call=8,
                                 device="cpu", metrics=telemetry.Registry())


def test_events_carry_trace_tags():
    """Chunk events carry the trace-context tags pushed around the check."""
    _h1, h2 = _histories(0, 30, 4, 0.15, False)
    reg = telemetry.Registry()
    with trace.span_tags(trace_span="s1"):
        wgl.check_encoded_device(encode_history(CasRegister(init=0), h2), levels_per_call=8,
                                 device="cpu", metrics=reg)
    assert reg.events("wgl_chunk") and all(e["trace_span"] == "s1"
                                           for e in reg.events("wgl_chunk"))
    assert trace.event_tags() == {}


def test_registry_matches_reference_shapes():
    """Register-or-get, labels, the aggregate child, ``collect`` and
    ``summary`` in the reference's shapes."""
    for reg in (telemetry.Registry(), RefRegistry()):
        c = reg.counter("a_total", "help", labelnames=("k",), aggregate=True)
        c.inc(2)
        c.labels(k="x").inc()
        reg.gauge("g").max(3)
        reg.gauge("g").max(1)
        reg.event("e", x=1)
        assert reg.counter("a_total", labelnames=("k",)) is c
        with pytest.raises(ValueError):
            reg.gauge("a_total")
        with pytest.raises(ValueError):
            c.inc(-1)
    a, b = telemetry.Registry(), RefRegistry()
    for reg in (a, b):
        reg.counter("a_total", labelnames=("k",), aggregate=True).labels(k="x").inc()
        reg.gauge("g").set(2.5)
        reg.event("e", x=1)
    assert a.collect() == b.collect() and a.summary() == b.summary()
    assert a.last_event("e") == b.last_event("e") == {"name": "e", "x": 1}


def _batch_hists():
    h1, h2 = [], []
    for i in range(5):
        r1, r2 = random.Random(77 + i), random.Random(77 + i)
        kw = dict(n_ops=18, n_procs=4, cas=True, crash_p=0.2)
        a, b = ref_random(r1, **kw), random_register_history(r2, **kw)
        if i % 2:
            a, b = ref_perturb(r1, a), perturb_history(r2, b)
        h1.append(a)
        h2.append(b)
    return h1, h2


@pytest.mark.parametrize("kw", [dict(f=2, f_schedule=(4, 8), levels_per_call=8),
                                dict(f=4, f_schedule=(4, 16, 64), levels_per_call=5),
                                dict(f=64, escalate=False, levels_per_call=6)],
                         ids=["serial", "ladder", "flat"])
def test_batch_metrics_match_reference(kw):
    """The batch's ``wgl_batch_chunk``, ``wgl_batch_rung`` and
    ``wgl_rebatch`` events (and the serial last resort's single-driver
    events), its counters and gauges, and the callback dicts."""
    h1, h2 = _batch_hists()
    ref_reg, port_reg = RefRegistry(), telemetry.Registry()
    ref_cb, port_cb = [], []
    ref = ref_check_encoded_batch([ref_encode(RefCas(init=0), h) for h in h1], mesh=None,
                                  metrics=ref_reg, chunk_callback=ref_cb.append, **kw)
    port = check_encoded_batch([encode_history(CasRegister(init=0), h) for h in h2],
                               device="cpu", metrics=port_reg, chunk_callback=port_cb.append,
                               **kw)
    assert [r["valid"] for r in port] == [r["valid"] for r in ref]
    _same_metrics(port_reg, ref_reg, ("wgl_batch_chunk", "wgl_batch_rung", "wgl_rebatch",
                                      "wgl_level", "wgl_escalation"))
    assert port_reg.events("wgl_batch_chunk")
    stacks = [(e["F"], e["members"]) for e in port_reg.events("wgl_host_stack")]
    assert stacks == [(e["F"], e["members"]) for e in ref_reg.events("wgl_host_stack")
                      if not e["overlap"]]
    assert _callbacks(port_cb) == _callbacks(ref_cb) and port_cb


def _sharded_hist(seed=77):
    h1, h2 = _histories(seed, 80, 6, 0.1, False)
    return h1, h2


def _ref_mesh(D):
    if D not in _REF_MESHES:
        _REF_MESHES[D] = ref_make_mesh(D, shape=(D, 1))
    return _REF_MESHES[D]


@pytest.mark.parametrize("mode,D,f_total", [("alltoall", 8, 16), ("allgather", 2, 16),
                                            ("alltoall", 2, 128), ("allgather", 8, 128)])
def test_sharded_metrics_match_reference(mode, D, f_total):
    """The sharded driver's ``wgl_sharded_chunk`` events (counts, per-shard
    max and min, capacities, the exchange's bytes), its counters and
    gauges (``wgl_shard_imbalance`` under alltoall), escalations included,
    and the callback dicts, in both exchange modes."""
    h1, h2 = _sharded_hist()
    opts = dict(f_total=f_total, max_escalations=4, exchange=mode, levels_per_call=10)
    ref_reg, port_reg = RefRegistry(), telemetry.Registry()
    ref_cb, port_cb = [], []
    ref = ref_frontier.check_history_sharded(RefCas(init=0), h1, mesh=_ref_mesh(D),
                                             metrics=ref_reg, chunk_callback=ref_cb.append,
                                             **opts)
    port = frontier.check_history_sharded(CasRegister(init=0), h2,
                                          mesh=make_mesh(D, device="cpu"), metrics=port_reg,
                                          chunk_callback=port_cb.append, **opts)
    assert (port["valid"], port["levels"]) == (ref["valid"], ref["levels"])
    _same_metrics(port_reg, ref_reg, ("wgl_sharded_chunk",))
    assert len(port_reg.events("wgl_sharded_chunk")) > 1
    assert _callbacks(port_cb) == _callbacks(ref_cb)
    imbalance = any(k.startswith("wgl_shard_imbalance") for k in port_reg.summary())
    assert imbalance == (mode == "alltoall")


def _elle_graphs():
    rng = random.Random(15)
    graphs = []
    for _ in range(6):
        n = rng.randrange(10, 200)
        g = R.DepGraph(n)
        kinds = [R.WW, R.WW, R.WR, R.RW]
        for _ in range(3 * n):
            g.add(rng.randrange(n), rng.randrange(n), rng.choice(kinds))
        graphs.append(g)
    return graphs


def _port_graph(g):
    out = P.DepGraph(g.n)
    for (s, d), k in g.edges.items():
        out.add(s, d, k)
    return out


def test_elle_metrics_match_reference():
    """The Elle engine's ``elle_batch_chunk`` events, its occupancy gauge
    by bucket and closure-bytes counter, through ``cycle_anomalies_batch``
    and ``cycle_anomalies``."""
    graphs = _elle_graphs()
    ref_reg, port_reg = RefRegistry(), telemetry.Registry()
    got_r = R.cycle_anomalies_batch(graphs, device=True, metrics=ref_reg)
    got_p = P.cycle_anomalies_batch([_port_graph(g) for g in graphs], device=True,
                                    metrics=port_reg, torch_device="cpu")
    assert got_p == got_r
    R.cycle_anomalies(graphs[0], device=True, metrics=ref_reg)
    P.cycle_anomalies(_port_graph(graphs[0]), device=True, metrics=port_reg, torch_device="cpu")
    _same_metrics(port_reg, ref_reg, ("elle_batch_chunk",))
    assert len(port_reg.events("elle_batch_chunk")) == 3


def test_elle_fallback_counters_match_reference():
    """A graph above the bucket ceiling folds to the host in both packages:
    ``elle_device_fallback_total{cause}`` and ``verdict_causes_total``."""
    from jepsen_tpu_torch.elle import ops as p_ops

    g = R.DepGraph(p_ops.CEILING + 1)
    for a, b in [(0, 1), (1, 2), (2, 0), (5, 6)]:
        g.add(a, b, R.WW)
    ref_reg, port_reg = RefRegistry(), telemetry.Registry()
    assert P.cycle_anomalies(_port_graph(g), device=True, metrics=port_reg,
                             torch_device="cpu") == R.cycle_anomalies(g, device=True,
                                                                      metrics=ref_reg)
    assert _samples(port_reg) == _samples(ref_reg)
    assert port_reg.summary()["elle_device_fallback_total{cause=elle_bucket_ceiling}"] == 3


def test_elle_append_check_passes_metrics():
    """``elle.append.check`` and ``elle.wr.check`` take ``metrics=`` through
    to the engine."""
    from jepsen_tpu.elle import append as r_append
    from jepsen_tpu.history import History as RHistory
    from jepsen_tpu.history import Op as ROp
    from jepsen_tpu_torch.elle import append as p_append
    from jepsen_tpu_torch.elle import wr as p_wr
    from jepsen_tpu_torch.testing import lagged_append_history, lagged_wr_history

    h = lagged_append_history(3, 300, (60, 240), depth=8)
    ref_h = RHistory([ROp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                      for o in h], reindex=False)
    ref_reg, port_reg = RefRegistry(), telemetry.Registry()
    got_p = p_append.check(h, device=True, metrics=port_reg, torch_device="cpu")
    got_r = r_append.check(ref_h, device=True, metrics=ref_reg)
    assert got_p == got_r
    _same_metrics(port_reg, ref_reg, ("elle_batch_chunk",))
    reg = telemetry.Registry()
    p_wr.check(lagged_wr_history(4, 300, (60, 200), depth=8), device=True, wfr_keys=True,
               metrics=reg, torch_device="cpu")
    assert reg.events("elle_batch_chunk")


@pytest.mark.parametrize("driver", ["single", "sharded", "batch"])
def test_reference_readers_take_port_registry(driver):
    """The reference's ``telemetry.utilization.reconstruct`` and
    ``telemetry.profile.attribute`` read a port run's registry without
    error and count the same chunks as on the reference's registry."""
    if driver == "single":
        _ref, _port, ref_reg, port_reg, _c1, _c2 = _single_both(SINGLE[2])
    elif driver == "sharded":
        h1, h2 = _sharded_hist()
        ref_reg, port_reg = RefRegistry(), telemetry.Registry()
        opts = dict(f_total=16, max_escalations=4, exchange="alltoall", levels_per_call=10)
        ref_frontier.check_history_sharded(RefCas(init=0), h1, mesh=_ref_mesh(8),
                                           metrics=ref_reg, **opts)
        frontier.check_history_sharded(CasRegister(init=0), h2, metrics=port_reg,
                                       mesh=make_mesh(8, device="cpu"), **opts)
    else:
        h1, h2 = _batch_hists()
        ref_reg, port_reg = RefRegistry(), telemetry.Registry()
        kw = dict(f=4, f_schedule=(4, 16, 64), levels_per_call=5)
        ref_check_encoded_batch([ref_encode(RefCas(init=0), h) for h in h1], mesh=None,
                                metrics=ref_reg, **kw)
        check_encoded_batch([encode_history(CasRegister(init=0), h) for h in h2],
                            device="cpu", metrics=port_reg, **kw)
    port_util = ref_utilization.reconstruct(port_reg)
    ref_util = ref_utilization.reconstruct(ref_reg)
    busy = lambda u: sum(d["chunks"] for d in u["devices"])  # noqa: E731
    # the reference's compile-stage chunks count as compiling, not busy
    compiled = sum(ref_utilization._devices_of(e) for e in ref_reg.events()
                   if e["name"] in ref_utilization.CHUNK_EVENTS and e["stage"] == "compile")
    assert busy(port_util) == busy(ref_util) + compiled > 0
    port_prof = ref_profile.attribute(port_reg)
    ref_prof = ref_profile.attribute(ref_reg)
    assert set(port_prof) == set(ref_prof)
    if driver == "single":
        assert [c["levels"] for c in port_prof["device"]["chunks"]] == \
            [c["levels"] for c in ref_prof["device"]["chunks"]]


def test_histogram_matches_reference():
    """The port's ``Histogram`` against the reference's: the same bucket
    counts, sums, samples, summary and quantiles for the same
    observations, labelled and unlabelled, default and given buckets."""
    import jepsen_tpu.telemetry as ref_telemetry

    rng = random.Random(5)
    values = [rng.expovariate(3.0) for _ in range(200)] + [0.0005, 10.0, 99.0]
    regs = (telemetry.Registry(), ref_telemetry.Registry())
    for reg in regs:
        plain = reg.histogram("h_plain", "default buckets")
        lab = reg.histogram("h_lab", "given buckets", labelnames=("k",),
                            buckets=(0.01, 0.05, 0.25, 1.0, 5.0, 30.0))
        agg = reg.histogram("h_agg", "aggregate", labelnames=("k",), aggregate=True)
        for i, v in enumerate(values):
            plain.observe(v)
            lab.labels(k=str(i % 3)).observe(v)
            agg.observe(v)
            agg.labels(k="x").observe(v)
        assert reg.histogram("h_lab", labelnames=("k",),
                             buckets=(0.01, 0.05, 0.25, 1.0, 5.0, 30.0)) is lab
        with pytest.raises(ValueError, match="buckets"):
            reg.histogram("h_lab", labelnames=("k",), buckets=(1.0,))
    port, ref = regs
    assert port.collect() == ref.collect()
    assert port.summary() == ref.summary()
    for name in ("h_plain", "h_agg"):
        p, r = port.histogram(name, labelnames=() if name == "h_plain" else ("k",)), \
            ref.histogram(name, labelnames=() if name == "h_plain" else ("k",))
        assert [p.quantile(q) for q in (0.1, 0.5, 0.99, 1.0)] == \
            [r.quantile(q) for q in (0.1, 0.5, 0.99, 1.0)]
        assert p.stats() == r.stats()
    assert telemetry.DEFAULT_BUCKETS == ref_telemetry.DEFAULT_BUCKETS
    assert telemetry.bucket_quantile((1.0, 2.0), [0, 0], 0.5) is None


def test_of_test_gates_on_the_test_map():
    assert telemetry.of_test({}) is None and telemetry.of_test(None) is None
    assert not telemetry.enabled({"telemetry?": False})
    test = {"telemetry?": True}
    reg = telemetry.of_test(test)
    assert isinstance(reg, telemetry.Registry) and telemetry.of_test(test) is reg
    assert test["telemetry-registry"] is reg


def test_heartbeat_matches_reference():
    """The port's Heartbeat is the reference's: the same gauges from the
    same callback dicts, and the same rate limit."""
    import jepsen_tpu.telemetry as ref_telemetry

    infos = [{"level": 10, "total_levels": 40, "wall_s": 2.0, "count": 7, "F": 16},
             {"level": 20, "total_levels": 40, "wall_s": 4.0, "count": 9, "F": 64},
             {"level": 0}]
    out = []
    for mod in (telemetry, ref_telemetry):
        reg = mod.Registry()
        hb = mod.Heartbeat(total=40, interval_s=0, registry=reg)
        limited = mod.Heartbeat(total=40, interval_s=3600)
        for info in infos:
            hb(info)
            limited(info)
        out.append((reg.collect(), hb.beats, limited.beats))
    assert out[0] == out[1]
    assert out[0][1] == 3 and out[0][2] == 1


# Checker metrics the comparisons read (the engines' own are compared
# elsewhere); walls are compared by count, not value.
CHECKER_METRICS = ("checker_seconds", "checker_op_count", "checker_batch_keys_total",
                   "wgl_progress_level", "wgl_progress_percent")


def _checker_samples(reg, drop_labels=()):
    out = []
    for s in reg.collect():
        if s["name"] not in CHECKER_METRICS:
            continue
        labels = tuple(sorted((k, v) for k, v in s["labels"].items() if k not in drop_labels))
        value = s["count"] if s["type"] == "histogram" else s["value"]
        out.append((s["name"], labels, value))
    return sorted(out)


@pytest.mark.parametrize("backend", ["device", "auto", "native", "competition", "host"])
def test_checker_telemetry_matches_reference(backend):
    """``linearizable`` on a test map with ``"telemetry?": True``: the
    ``checker_seconds`` histogram by backend, ``checker_op_count`` and the
    heartbeat's progress gauges, against the reference checker's, with the
    same verdict and backend. The raced backend's winner may differ, so
    there the heartbeat and the label are not compared."""
    from jepsen_tpu import checker as ref_checker

    from jepsen_tpu_torch import checker as jc

    h1, h2 = _histories(41, 60, 4, 0.0, False)
    ref_test, test = {"telemetry?": True}, {"telemetry?": True}
    ref = ref_checker.linearizable(model=RefCas(init=0), backend=backend).check(
        ref_test, h1, {})
    port = jc.linearizable(model=CasRegister(init=0), backend=backend, device="cpu").check(
        test, h2, {})
    assert port["valid"] == ref["valid"] is True
    assert port.get("backend") == ref.get("backend")
    reg, ref_reg = test["telemetry-registry"], ref_test["telemetry-registry"]
    assert isinstance(reg, telemetry.Registry)
    if backend == "competition":
        keep = lambda s: [x for x in s if not x[0].startswith("wgl_progress")]  # noqa: E731
        assert keep(_checker_samples(reg, ("backend",))) == \
            keep(_checker_samples(ref_reg, ("backend",)))
    else:
        assert _checker_samples(reg) == _checker_samples(ref_reg)
    label = "device" if backend == "device" else port["backend"]
    assert [s["labels"] for s in reg.collect() if s["name"] == "checker_seconds"] == \
        [{"checker": "linearizable", "backend": label}]
    if backend in ("auto", "native"):
        assert reg.counter("wgl_native_searches_total",
                           labelnames=("verdict",)).labels(verdict="valid").value >= 1


def test_batch_check_telemetry_matches_reference():
    """The keyed batch: ``checker_seconds{backend="batch"}`` and
    ``checker_batch_keys_total{result}``, against the reference's."""
    from jepsen_tpu import checker as ref_checker
    from jepsen_tpu import independent as ref_ind

    from jepsen_tpu_torch import checker as jc
    from jepsen_tpu_torch import independent as ind

    o1, o2 = [], []
    for k in range(6):
        h1, h2 = _histories(60 + k, 10, 2, 0.0, k % 3 == 0)
        for o in h1:
            o1.append(o.with_(value=ref_ind.KV(k, o.value), index=len(o1)))
        for o in h2:
            o2.append(o.with_(value=ind.KV(k, o.value), index=len(o2)))
    from jepsen_tpu.history import History as RefHistory

    from jepsen_tpu_torch.history import History

    ref_test, test = {"telemetry?": True}, {"telemetry?": True}
    ref = ref_ind.checker(ref_checker.linearizable(model=RefCas(init=0))).check(
        ref_test, RefHistory(o1, reindex=False), {})
    port = ind.checker(jc.linearizable(model=CasRegister(init=0), device="cpu")).check(
        test, History(o2, reindex=False), {})
    assert port["valid"] == ref["valid"] is False
    reg, ref_reg = test["telemetry-registry"], ref_test["telemetry-registry"]
    assert _checker_samples(reg) == _checker_samples(ref_reg)
    assert ("checker_seconds", (("backend", "batch"), ("checker", "linearizable")), 1) in \
        _checker_samples(reg)
    assert sum(v for n, _l, v in _checker_samples(reg) if n == "checker_batch_keys_total") == 6
    assert reg.events("wgl_batch_chunk")
