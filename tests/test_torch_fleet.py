"""The port's fleet federation (``jepsen_tpu_torch.telemetry.fleet``)
against the reference's (``jepsen_tpu.telemetry.fleet``).

The same seeded metrics go into a port registry and a reference registry;
both are scraped (``scrape_payload``) and the scrapes fed to both
packages' pure functions: the merged samples, the Prometheus text, the
histogram summaries and the backlog occupancy must be equal, whichever
package's registry a backend ran. ``FleetFederation`` and ``SloMonitor``
replay one script of scrapes, failures and clock readings in both
packages: ages, staleness, decommissioning, a respawned generation
replacing (never double-counting) the dead one, the merged view, the
metadata and the gauges they export must agree. The in-process cluster
(two port services behind the port's router) checks the federation of a
real fleet: every total is the sum of its children, ``/metrics`` and
``/fleet`` serve it, a stopped backend reads stale, and the results
browser's ``/fleet`` renders the router's snapshot.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.request

import pytest

from jepsen_tpu.telemetry import Registry as RRegistry
from jepsen_tpu.telemetry import fleet as r_fleet
from jepsen_tpu_torch import trace as p_trace
from jepsen_tpu_torch import web as p_web
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.service import Service
from jepsen_tpu_torch.service import http as p_http
from jepsen_tpu_torch.service import router as p_router
from jepsen_tpu_torch.service.client import HttpServiceClient
from jepsen_tpu_torch.telemetry import Registry as PRegistry
from jepsen_tpu_torch.telemetry import fleet as p_fleet
from jepsen_tpu_torch.testing import chunked_register_history

pytestmark = [pytest.mark.fleet, pytest.mark.service]

FLEETS = {"ref": r_fleet, "port": p_fleet}
REGISTRIES = {"ref": RRegistry, "port": PRegistry}
BUCKETS = (0.05, 0.25, 1.0, 4.0, 30.0)


def fill(reg, seed, buckets=BUCKETS):
    """Seeded counters, labeled counters, gauges and a histogram (the
    families a backend service exports), plus a backlog event ring."""
    rng = random.Random(seed)
    reg.counter("service_ops_total", "ops ingested").inc(rng.randint(0, 500))
    rej = reg.counter("service_rejects_total", "rejected submits", labelnames=("reason",))
    for reason in ("quota", "queue"):
        rej.labels(reason=reason).inc(rng.randint(0, 9))
    reg.gauge("service_tenants", "tenants held").set(rng.randint(0, 6))
    h = reg.histogram("decision_latency_seconds", "op decision latency", buckets=buckets)
    for _ in range(rng.randint(1, 40)):
        h.observe(rng.expovariate(1.5))
    t = 1000.0 + seed
    for _ in range(rng.randint(2, 12)):
        t += rng.uniform(0.1, 3.0)
        reg.event("online_backlog", t=round(t, 3), backlog=rng.choice((0, 0, 1, 3)))


def scrapes(kinds, seed, buckets=BUCKETS):
    """``{backend: scrape_payload}``: backend ``bI`` runs the package
    ``kinds[I]``'s registry."""
    out = {}
    for i, kind in enumerate(kinds):
        reg = REGISTRIES[kind]()
        fill(reg, seed + i, buckets)
        out[f"b{i}"] = FLEETS[kind].scrape_payload(reg, service=f"b{i}")
    return out


def norm(x):
    return json.loads(json.dumps(x, sort_keys=True))


FLEET_MIXES = [("port", "port"), ("ref", "ref"), ("port", "ref"), ("port", "ref", "port")]


@pytest.mark.parametrize("kinds", FLEET_MIXES, ids="-".join)
@pytest.mark.parametrize("seed", [1, 2])
def test_merge_and_exposition_match_reference(kinds, seed):
    """Scrapes of real port and reference registries merge, render and
    summarise the same in both packages."""
    per = {b: s["samples"] for b, s in scrapes(kinds, seed).items()}
    helps = {}
    for s in scrapes(kinds, seed).values():
        helps.update(s["helps"])
    got = {k: f.merge_samples(per) for k, f in FLEETS.items()}
    assert norm(got["port"]) == norm(got["ref"])
    assert p_fleet.prometheus_text_for(got["port"], helps) == \
        r_fleet.prometheus_text_for(got["ref"], helps)
    hists = [s for s in got["port"] if s["type"] == "histogram"]
    assert hists
    for s in hists:
        for q in ((0.5, 0.9, 0.99), (0.25, 0.999)):
            assert p_fleet.stats_from_sample(s, q) == r_fleet.stats_from_sample(s, q)
    total = next(s for s in hists if "backend" not in s["labels"])
    assert total["count"] == sum(s["count"] for s in hists if "backend" in s["labels"])


def test_mismatched_buckets_keep_children_and_drop_the_total():
    per = {}
    for i, (kind, buckets) in enumerate((("port", (1.0, 2.0)), ("ref", (1.0, 4.0)))):
        reg = REGISTRIES[kind]()
        reg.histogram("lat_seconds", "l", buckets=buckets).observe(0.5 + 2 * i)
        per[f"b{i}"] = FLEETS[kind].scrape_payload(reg)["samples"]
    got = {k: norm(f.merge_samples(per)) for k, f in FLEETS.items()}
    assert got["port"] == got["ref"]
    assert sorted(s["labels"].get("backend") for s in got["port"]) == ["b0", "b1"]


@pytest.mark.parametrize("kind", ["port", "ref"])
def test_scrape_payload_matches_reference(kind):
    """Both packages' payloads of one registry carry the same samples,
    helps and event tail."""
    reg = REGISTRIES[kind]()
    fill(reg, 5)
    for i in range(50):
        reg.event("online_backlog", t=float(i), backlog=i % 3)
    docs = {k: f.scrape_payload(reg, service="svc", max_events=10) for k, f in FLEETS.items()}
    for d in docs.values():
        d.pop("t")
    assert norm(docs["port"]) == norm(docs["ref"])
    assert len(docs["port"]["events"]) == 10 and docs["port"]["events"][-1]["t"] == 49.0


@pytest.mark.parametrize("seed", range(6))
def test_backlog_occupancy_matches_reference(seed):
    rng = random.Random(seed)
    evs, t = [], 100.0
    for _ in range(rng.randint(0, 14)):
        t += rng.uniform(0.0, 4.0)
        evs.append({"name": rng.choice(("online_backlog", "online_backlog", "other")),
                    "t": round(t, 3), "backlog": rng.choice((0, 1, 2))})
    for until in (None, t + rng.uniform(0, 5)):
        assert p_fleet.backlog_occupancy(evs, until=until) == \
            r_fleet.backlog_occupancy(evs, until=until)


def counter_payload(kind, value, service=None):
    reg = REGISTRIES[kind]()
    reg.counter("ops_total", "ops").inc(value)
    return FLEETS[kind].scrape_payload(reg, service=service)


def federation_script(kind):
    """One script of scrapes, failures and clock readings through a
    federation of package ``kind``: what each step answers, and the
    gauges and counters it exports."""
    met = REGISTRIES[kind]()
    fed = FLEETS[kind].FleetFederation(met, stale_after_s=5.0)
    f = FLEETS[kind]
    out = []
    fed.record_scrape("b0", counter_payload(kind, 100, "b0"), now=100.0)
    fed.record_scrape("b1", counter_payload(kind, 10), now=100.0)
    fed.record_scrape("b9", counter_payload(kind, 50), now=100.0)
    out.append(("merged", fed.merged()))
    out.append(("ages", fed.ages(now=103.0)))
    out.append(("stale", fed.stale_backends(now=103.0)))
    out.append(("stale_expected", fed.stale_backends(expected=["b0", "b1", "b2"], now=102.0)))
    out.append(("meta", fed.meta(now=102.0, expected=["b0", "b1"])))
    # b0 dies and respawns: the fresh generation replaces the dead one's
    fed.record_failure("b0")
    fed.record_failure("b0")
    out.append(("meta_failures", fed.meta(now=104.0)))
    fed.record_scrape("b0", counter_payload(kind, 5, "b0"), now=105.0)
    out.append(("merged_respawned", fed.merged()))
    # b9 is decommissioned: past the horizon it expires from the totals
    out.append(("stale_decommissioned", fed.stale_backends(expected=["b0", "b1"], now=106.0)))
    out.append(("backends", fed.backends()))
    out.append(("merged_after_expiry", fed.merged()))
    out.append(("stale_late", fed.stale_backends(expected=["b0", "b1"], now=112.0)))
    out.append(("helps", fed.helps()))
    out.append(("text", fed.prometheus_text()))
    fed.forget("b1")
    out.append(("after_forget", (fed.backends(), fed.merged(), fed.meta(now=112.0))))
    # the fleet histogram, and the backlog-occupancy utilization
    for b, v in (("h0", 0.5), ("h1", 3.0)):
        reg = REGISTRIES[kind]()
        reg.histogram("decision_latency_seconds", "d", buckets=(1.0, 4.0)).observe(v)
        reg.event("online_backlog", t=100.0, backlog=1)
        reg.event("online_backlog", t=105.0, backlog=0)
        reg.event("online_backlog", t=110.0, backlog=0)
        fed.record_scrape(b, f.scrape_payload(reg), now=110.0)
    out.append(("histogram_stats", fed.histogram_stats("decision_latency_seconds")))
    out.append(("no_family", fed.histogram_stats("no_such_family")))
    out.append(("fleet_histogram", fed.fleet_histogram("decision_latency_seconds")))
    out.append(("utilization", (fed.utilization("h0"), fed.utilization("nope"))))
    out.append(("events", fed.events("h1")))
    out.append(("exported", met.collect()))
    return norm(out)


def test_federation_script_matches_reference():
    port, ref = federation_script("port"), federation_script("ref")
    assert [k for k, _ in port] == [k for k, _ in ref]
    for (k, a), (_, b) in zip(port, ref):
        assert a == b, k
    got = dict(port)
    # the respawned generation replaced the dead one: 5 + 10, not 115
    assert [s["value"] for s in got["merged_respawned"]
            if s["name"] == "ops_total" and "backend" not in s["labels"]] == [65.0]
    assert [s["value"] for s in got["merged_after_expiry"]
            if s["name"] == "ops_total" and "backend" not in s["labels"]] == [15.0]
    assert got["stale_expected"] == ["b2"] and got["stale_late"] == ["b0", "b1"]
    assert got["utilization"][0]["source"] == "backlog"


def slo_merged(decided, slow, rejects):
    within = decided - slow
    return [
        {"name": "decision_latency_seconds", "type": "histogram", "labels": {},
         "count": decided, "sum": float(decided),
         "buckets": {"10.0": within, "100.0": slow, "+Inf": 0}},
        {"name": "service_rejects_total", "type": "counter",
         "labels": {"reason": "quota"}, "value": float(rejects)},
        {"name": "service_rejects_total", "type": "counter",
         "labels": {"reason": "quota", "backend": "b0"}, "value": float(rejects)},
    ]


@pytest.mark.parametrize("seed", range(4))
def test_slo_monitor_matches_reference(seed):
    """``SloMonitor.observe`` over one seeded series of fleet totals (with
    generation resets that lower them) answers the same windows and sets
    the same gauges in both packages."""
    rng = random.Random(seed)
    series, decided, slow, rej, now = [], 0, 0, 0, 1000.0
    for _ in range(12):
        if rng.random() < 0.15:
            decided, slow, rej = decided // 3, slow // 3, rej // 3  # a respawn
        add = rng.randint(0, 200)
        decided += add
        slow += rng.randint(0, add // 4)
        rej += rng.randint(0, 20)
        now += rng.uniform(1.0, 90.0)
        series.append((slo_merged(decided, slow, rej), now))
    out = {}
    for kind, f in FLEETS.items():
        met = REGISTRIES[kind]()
        mon = f.SloMonitor(met, fast_window_s=60.0, slow_window_s=600.0)
        docs = [mon.observe(m, now=t) for m, t in series]
        out[kind] = norm([docs, met.collect()])
    assert out["port"] == out["ref"]
    for kind, f in FLEETS.items():
        with pytest.raises(ValueError):
            f.SloMonitor(availability_target=1.5)
        with pytest.raises(ValueError):
            f.SloMonitor(latency_ratio=0.0)


# ---------------------------------------------------------------------------
# The federation of a real fleet: two port services behind the port's router.


def get_json(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read().decode())


class _Node:
    def __init__(self, name, journal_dir):
        self.metrics = PRegistry()
        self.svc = Service(CasRegister(init=0), journal_dir=str(journal_dir), name=name,
                           engine="host", device="cpu", register_live=False, ledger=False,
                           metrics=self.metrics, collector=p_trace.Collector())
        self.srv = p_http.server(self.svc, port=0)
        threading.Thread(target=lambda: self.srv.serve_forever(poll_interval=0.02),
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.backend = p_router.Backend(name, self.url, journal_dir=str(journal_dir),
                                        failure_threshold=2, cooldown_s=60.0)
        self.stopped = False

    def stop(self):
        if not self.stopped:
            self.stopped = True
            self.srv.shutdown()
            self.srv.server_close()
            self.svc._pump_stop.set()
            self.svc.scheduler.close(timeout=10)


def wait(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_router_federates_a_real_fleet(tmp_path):
    nodes = [_Node(f"fb{i}", tmp_path / f"fb{i}") for i in range(2)]
    rmet = PRegistry()
    router = p_router.Router(
        [nd.backend for nd in nodes], metrics=rmet, collector=p_trace.Collector(),
        name="fleet-test-router", probe_interval_s=0.05, probe_timeout_s=1.0,
        failure_threshold=2, migrate_retry_after_s=0.05, rebalance=False, respawn=False,
        state_path=str(tmp_path / "router_state.jsonl"))
    rsrv = p_router.server(router, port=0)
    threading.Thread(target=lambda: rsrv.serve_forever(poll_interval=0.02), daemon=True).start()
    url = f"http://127.0.0.1:{rsrv.server_address[1]}"
    try:
        fed = router.federation
        wait(lambda: set(fed.backends()) == {"fb0", "fb1"}, "both backends scraped")
        h = chunked_register_history(random.Random(7), n_ops=120, n_procs=2, chunk_ops=30)
        rep = HttpServiceClient(url, "t0", chunk_ops=30, max_retries=100,
                                max_backoff_s=0.2).feed(h)
        assert rep["error"] is None
        wait(lambda: (fed.fleet_histogram("decision_latency_seconds") or {}).get("count", 0) > 0,
             "fleet decision-latency total")
        merged = fed.merged()
        groups = {}
        for s in merged:
            labels = dict(s["labels"])
            b = labels.pop("backend", None)
            g = groups.setdefault((s["name"], tuple(sorted(labels.items()))), [None, []])
            if b is None:
                g[0] = s
            else:
                g[1].append(s)
        checked = 0
        for name, (tot, kids) in groups.items():
            if tot is None or not kids:
                continue
            if tot["type"] == "histogram":
                assert tot["count"] == sum(k["count"] for k in kids), name
            else:
                assert tot["value"] == pytest.approx(sum(k["value"] for k in kids)), name
            checked += 1
        assert checked > 0
        assert [s["value"] for s in merged
                if s["name"] == "service_tenants" and not s["labels"]] == [1.0]
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "fleet_scrapes_total" in text and 'backend="fb0"' in text
        assert "router_epoch" in text
        doc = get_json(url + "/fleet")
        assert set(doc["backends"]) == {"fb0", "fb1"} and doc["stale_backends"] == []
        assert doc["decision_latency"]["count"] > 0
        assert any(r.get("kind") == "place" for r in doc["timeline"])
        # the results browser renders the router's registered snapshot
        snaps = p_web.fleet_snapshots()
        assert [s["router"] for s in snaps] == ["fleet-test-router"]
        page = p_web._fleet_section(snaps[0])
        assert "fb0" in page and "router_state.jsonl" in page
        slo = router.stats()["fleet"]["slo"]
        assert slo["windows"]["fast"]["availability_burn_rate"] < 1.0
        # a stopped backend reads stale; its last snapshot is kept
        fed.stale_after_s = 0.3
        nodes[1].stop()
        wait(lambda: "fb1" in (router.stats()["fleet"].get("stale_backends") or []),
             "fb1 scrape staleness")
        assert fed.meta()["fb1"]["stale"] is True and fed.meta()["fb1"]["scrapes"] >= 1
        assert router.tenants_snapshot()["backends"]["fb1"]["scrape_stale"] is True
    finally:
        router.close()
        rsrv.shutdown()
        rsrv.server_close()
        for nd in nodes:
            nd.stop()
    assert p_web.fleet_snapshots() == []
