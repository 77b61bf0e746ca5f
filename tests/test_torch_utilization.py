"""The port's ``telemetry.utilization`` and ``telemetry.profile.attribute``
against the reference's, on the same registries: hand-built stamped
events whose arithmetic is known (every gap class), seeded random event
streams of every chunk family, and the registries of real port runs on
the CPU (the single driver, the batch, the frontier-sharded search in both
exchange modes, the online monitor's device oracle) and of the
reference's own drivers. For each: equal ``reconstruct`` maps, equal
gauges, equal Gantt SVG, and equal attribution with and without
``plan=`` (each package's plan of the same history, so each package's
``level_byte_floor``)."""

from __future__ import annotations

import json
import random

import pytest
import torch

from jepsen_tpu.models import CasRegister as RCas
from jepsen_tpu.ops import wgl as r_wgl
from jepsen_tpu.ops.encode import encode_history as r_encode
from jepsen_tpu.telemetry import Registry as RRegistry
from jepsen_tpu.telemetry import profile as r_profile
from jepsen_tpu.telemetry import utilization as r_util
from jepsen_tpu.testing import perturb_history as r_perturb
from jepsen_tpu.testing import random_register_history as r_random
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.ops import wgl as p_wgl
from jepsen_tpu_torch.ops.encode import encode_history as p_encode
from jepsen_tpu_torch.parallel import check_encoded_batch, frontier, make_mesh
from jepsen_tpu_torch.telemetry import Registry as PRegistry
from jepsen_tpu_torch.telemetry import profile as p_profile
from jepsen_tpu_torch.telemetry import utilization as p_util
from jepsen_tpu_torch.testing import perturb_history as p_perturb
from jepsen_tpu_torch.testing import random_register_history as p_random

B = 1_754_000_000.0  # wall-clock anchor of the hand-built stamps
PAD = (32, 1, 64, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk(reg, t0, t1, stage="execute", name="wgl_chunk", **extra):
    reg.event(name, level0=0, level=1, F=16, wall_s=t1 - t0, stage=stage,
              t0=B + t0, t1=B + t1, **extra)


def _one_of_each(reg):
    """One gap of each class on one device, in priority order."""
    _chunk(reg, 0, 2)
    _chunk(reg, 2, 3, stage="compile")
    _chunk(reg, 3, 5)
    reg.event("wgl_host_stack", F=256, members=2, wall_s=1.0, overlap=False,
              t0=B + 5, t1=B + 6)
    _chunk(reg, 6, 7)
    reg.event("online_backlog", t=B + 6.5, backlog=3)
    _chunk(reg, 8, 9)
    reg.event("online_backlog", t=B + 8.5, backlog=0)
    _chunk(reg, 10, 11)
    return reg


def _random_events(reg, seed):
    """A seeded stream of every event family the readers take, with
    overlapping, touching, reversed and unstamped intervals."""
    rng = random.Random(seed)
    t = 0.0
    for _ in range(rng.randint(20, 60)):
        kind = rng.choice(["wgl_chunk", "wgl_batch_chunk", "wgl_sharded_chunk",
                           "wgl_host_stack", "online_backlog", "unstamped"])
        a = t + rng.choice([0.0, rng.random()])
        b = a + rng.random() * 2
        if rng.random() < 0.1:
            a, b = b, a
        if kind == "online_backlog":
            reg.event(kind, t=B + a, backlog=rng.choice([0, 0, 1, 4]))
        elif kind == "wgl_host_stack":
            reg.event(kind, F=64, members=3, wall_s=b - a, overlap=False, t0=B + a, t1=B + b)
        elif kind == "unstamped":
            reg.event("wgl_chunk", level0=0, level=2, F=16, wall_s=0.1, stage="execute")
        else:
            extra = {"wgl_batch_chunk": {"n_devices": rng.choice([1, 2, 4]), "active": 2,
                                         "batch": 4},
                     "wgl_sharded_chunk": {"n_shards": rng.choice([1, 2, 8]),
                                           "exchange_bytes": rng.randint(0, 4096),
                                           "count_max": 9, "count_min": 1},
                     "wgl_chunk": {}}[kind]
            lvl0 = rng.randint(0, 50)
            reg.event(kind, level0=lvl0, level=lvl0 + rng.randint(0, 5),
                      F=rng.choice([16, 64]), wall_s=abs(b - a),
                      stage=rng.choice(["execute", "execute", "compile"]),
                      t0=B + a, t1=B + b, **extra)
        t = max(t, a, b) * rng.choice([1.0, 1.0, 1.0001])
    return reg


def _histories(seed, n_ops, n_procs, crash_p, perturb=False):
    r1, r2 = random.Random(seed), random.Random(seed)
    kw = dict(n_ops=n_ops, n_procs=n_procs, crash_p=crash_p)
    h1, h2 = r_random(r1, **kw), p_random(r2, **kw)
    if perturb:
        h1, h2 = r_perturb(r1, h1), p_perturb(r2, h2)
    return h1, h2


def _plans(h_ref, h_port):
    return (r_wgl.plan_device(r_encode(RCas(init=0), h_ref), pad_to=PAD),
            p_wgl.plan_device(p_encode(PCas(init=0), h_port), pad_to=PAD, device="cpu"))


def _single(seed, sched, lpc, perturb=False, ref=False):
    h1, h2 = _histories(seed, 30, 6, 0.3, perturb)
    opts = dict(f_schedule=sched, pad_to=PAD, levels_per_call=lpc)
    if ref:
        reg = RRegistry()
        r_wgl.check_encoded_device(r_encode(RCas(init=0), h1), metrics=reg, **opts)
    else:
        reg = PRegistry()
        p_wgl.check_encoded_device(p_encode(PCas(init=0), h2), metrics=reg, device="cpu",
                                   **opts)
    return reg, _plans(h1, h2)


def _batch():
    reg = PRegistry()
    encs = []
    for i in range(4):
        r = random.Random(77 + i)
        h = p_random(r, n_ops=18, n_procs=4, cas=True, crash_p=0.2)
        encs.append(p_encode(PCas(init=0), p_perturb(r, h) if i % 2 else h))
    check_encoded_batch(encs, device="cpu", metrics=reg, f=4, f_schedule=(4, 16, 64),
                        levels_per_call=5)
    return reg, None


def _sharded(mode, D):
    h1, h2 = _histories(77, 80, 6, 0.1)
    reg = PRegistry()
    frontier.check_history_sharded(PCas(init=0), h2, metrics=reg,
                                   mesh=make_mesh(D, device="cpu"), f_total=16,
                                   max_escalations=4, exchange=mode, levels_per_call=10)
    return reg, _plans(h1, h2)


def _online():
    from jepsen_tpu_torch.online import OnlineMonitor

    reg = PRegistry()
    mon = OnlineMonitor(PCas(init=0), engine="device", metrics=reg, device="cpu")
    # crashed ops keep the stream from quiescing: the device oracle decides
    for op in p_random(random.Random(3), n_ops=200, n_procs=4, crash_p=0.05):
        mon.observe(op)
    assert mon.finish()["valid"] is True
    return reg, None


def _synthetic(build):
    def make():
        return build(PRegistry()), None
    return make


REGISTRIES = {
    "one_of_each": _synthetic(_one_of_each),
    **{f"random{s}": _synthetic(lambda reg, s=s: _random_events(reg, s)) for s in range(6)},
    "port_single": lambda: _single(0, (16, 64), 8),
    "port_single_escalating": lambda: _single(40, (2, 4096), 8),
    "port_single_perturbed": lambda: _single(1, (16, 64), 5, perturb=True),
    "port_batch": _batch,
    "port_sharded_alltoall": lambda: _sharded("alltoall", 8),
    "port_sharded_allgather": lambda: _sharded("allgather", 2),
    "port_online": _online,
    "ref_single": lambda: _single(40, (2, 4096), 8, ref=True),
    "ref_single_perturbed": lambda: _single(1, (16, 64), 5, perturb=True, ref=True),
}


@pytest.fixture(scope="module")
def registries():
    return {}


def _get(registries, name):
    if name not in registries:
        registries[name] = REGISTRIES[name]()
    return registries[name]


def _gauges(reg):
    return sorted((s["name"], tuple(sorted(s["labels"].items())), s["value"])
                  for s in reg.collect() if s["name"] == "device_utilization_pct")


@pytest.mark.parametrize("name", list(REGISTRIES))
def test_reconstruct_matches_reference(registries, name):
    reg, _plans_ = _get(registries, name)
    got = p_util.reconstruct(reg)
    port_gauges = _gauges(reg)
    want = r_util.reconstruct(reg)
    assert got == want
    assert _gauges(reg) == port_gauges
    if got is not None:
        assert got["summary"]["n_devices"] >= 1
        for d in got["devices"]:
            assert all(g["class"] in p_util.GAP_CLASSES for g in d["gaps"])
    for kw in ({}, {"max_intervals": 3, "max_gaps": 2}):
        assert p_util.reconstruct(reg, **kw) == r_util.reconstruct(reg, **kw)


@pytest.mark.parametrize("name", list(REGISTRIES))
def test_render_gantt_matches_reference(registries, name):
    reg, _plans_ = _get(registries, name)
    util = r_util.reconstruct(reg)
    if util is None:
        util = {"window": {}, "summary": {}, "devices": []}
    for width in (960, 320):
        assert p_util.render_gantt(util, width=width) == r_util.render_gantt(util, width=width)
    # the block as profile.json stores it (a JSON round trip) renders alike
    stored = json.loads(json.dumps(util))
    assert p_util.render_gantt(stored) == r_util.render_gantt(stored)


def _canon(doc):
    return json.loads(json.dumps(doc, sort_keys=True, default=str))


@pytest.mark.parametrize("with_plan", [False, True], ids=["no_plan", "plan"])
@pytest.mark.parametrize("name", list(REGISTRIES))
def test_attribute_matches_reference(registries, name, with_plan):
    reg, plans = _get(registries, name)
    if with_plan and plans is None:
        # no history behind these events: the byte model is a callable
        kw_p = kw_r = {"byte_floor": lambda F: 1000 * F, "copy_bw_gbs": 2000.0}
    elif with_plan:
        kw_r, kw_p = {"plan": plans[0]}, {"plan": plans[1]}
    else:
        kw_p = kw_r = {}
    got = p_profile.attribute(reg, **kw_p)
    want = r_profile.attribute(reg, **kw_r)
    assert _canon(got) == _canon(want)
    if name.startswith("port_single") or name.startswith("ref_single"):
        assert got["device"]["chunks"] and "utilization" in got
        if with_plan:
            assert got["device"]["summary"]["bytes_floor_total"] > 0
    if name.startswith("port_sharded") and with_plan:
        assert got["sharded"]["interconnect"]["share_of_traffic"] > 0
    if name in ("port_batch", "port_online"):
        assert got["batch"]["rungs"]


@pytest.mark.parametrize("case", ["sharded_alltoall", "sharded_allgather", "single"])
def test_level_byte_floor_matches_reference(case):
    """``plan=`` prices a level with each package's ``level_byte_floor``:
    the port's is the reference's byte model, level for level."""
    h1, h2 = _histories(77, 80, 6, 0.1)
    r_plan, p_plan = _plans(h1, h2)
    kw = {"single": {}, "sharded_alltoall": {"sharded": True, "exchange": "alltoall"},
          "sharded_allgather": {"sharded": True, "exchange": "allgather"}}[case]
    for F in (2, 16, 64, 1024, 65536):
        assert p_wgl.level_byte_floor(p_plan, F, **kw) == r_wgl.level_byte_floor(r_plan, F, **kw)


def test_reconstruct_of_no_stamped_events_is_none():
    for reg in (PRegistry(), RRegistry()):
        reg.event("wgl_chunk", level0=0, level=1, F=16, wall_s=0.1, stage="execute")
        reg.event("online_backlog", t=B, backlog=1)
        assert p_util.reconstruct(reg) is None is r_util.reconstruct(reg)
        assert p_profile._attribute_utilization(PRegistry()) is None


def test_port_host_stack_spans_are_stamped_and_not_overlapped(registries):
    """The port's batch stamps the span in which it makes a rung's tables
    ready for the card, while the card waits (``overlap=False``); the
    readers class an idle gap under it as host-stacking, as the
    reference's do."""
    for name in ("port_batch", "port_online"):
        reg, _ = _get(registries, name)
        spans = reg.events("wgl_host_stack")
        assert spans and all(e["overlap"] is False and e["t0"] <= e["t1"] for e in spans)
        assert p_util.reconstruct(reg) == r_util.reconstruct(reg)
