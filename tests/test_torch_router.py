"""The port's tenant router and its supervision layer
(``jepsen_tpu_torch.service.router``, ``service.supervisor``) against the
reference's (``jepsen_tpu.service.router``, ``service.supervisor``).

- The pure planners (``plan_rebalance``, ``plan_readopt``,
  ``backend_load``, ``tenant_load``) answer the reference's on the same
  inputs.
- ``router_state.jsonl``: each package's writer produces the reference's
  bytes, and each package replays the other's file, torn final line
  included.
- The router matrix runs the port's router in front of in-process port
  backends (real HTTP servers on ephemeral ports, each a ``Service`` on
  the CPU with its own journal directory): 2 backends x 4 tenants (valid /
  valid / seeded-invalid / overflow-unknown) with one backend killed
  mid-stream. Every verdict equals the reference's ``check_history``
  verdict or is ``unknown`` with only the causes
  ``chaos.EXPECTED_UNKNOWN_CAUSES["backend.process"]`` allows, and the
  resumed clients' covered ops are dropped server-side. Then a manual
  migration over ``/release``, the ``JEPSEN_NO_MIGRATION`` orphan, a
  false-positive probe, respawn and re-adoption, flap damping, a rolling
  restart with zero unknown verdicts, and ``router.crash`` mid-migration
  followed by a restart that recovers and fences.
- Protocol parity: the port's router in front of the reference's backends
  and the reference's router in front of the port's give the same
  per-tenant verdicts, a live migration included.
- As processes: without a card a backend exits 255 and ``spawn_backends``
  raises; ``python -m jepsen_tpu_torch.service --router`` with
  ``--device cpu`` serves a tenant, ``--roll`` rolls every backend with
  zero unknown verdicts and an interrupt drains (exit 0). The real kill -9
  of spawned children is marked ``slow``, as the reference marks its own.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import pytest
import torch

from jepsen_tpu import service as r_service
from jepsen_tpu import testing as r_testing
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.models import CasRegister as RCas
from jepsen_tpu.ops import wgl as r_wgl
from jepsen_tpu.service import client as r_client
from jepsen_tpu.service import http as r_http
from jepsen_tpu.service import router as r_router
from jepsen_tpu.service import supervisor as r_sup
from jepsen_tpu.testing import chaos as r_chaos
from jepsen_tpu_torch import advisor as p_advisor
from jepsen_tpu_torch import service as p_service
from jepsen_tpu_torch import testing as p_testing
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.parallel import resilience
from jepsen_tpu_torch.service import __main__ as p_main
from jepsen_tpu_torch.service import client as p_client
from jepsen_tpu_torch.service import http as p_http
from jepsen_tpu_torch.service import journal as p_journal
from jepsen_tpu_torch.service import router as p_router
from jepsen_tpu_torch.service import supervisor as p_sup
from jepsen_tpu_torch.telemetry import Registry as PRegistry
from jepsen_tpu_torch.testing import chaos as p_chaos

pytestmark = [pytest.mark.router, pytest.mark.service]

ROOT = Path(__file__).resolve().parent.parent

PORT = dict(service=p_service, http=p_http, router=p_router, client=p_client,
            testing=p_testing, Cas=PCas, svc_kw={"device": "cpu"})
REF = dict(service=r_service, http=r_http, router=r_router, client=r_client,
           testing=r_testing, Cas=RCas, svc_kw={})
PKGS = {"port": PORT, "ref": REF}

# The causes an unknown verdict may carry under a backend loss: the
# chaos harness's own per-seam declaration, one set for the three fleet
# seams.
ALLOWED = set(p_chaos.EXPECTED_UNKNOWN_CAUSES["backend.process"])
assert ALLOWED == set(p_chaos.EXPECTED_UNKNOWN_CAUSES["router.crash"]) \
    == set(p_chaos.EXPECTED_UNKNOWN_CAUSES["router.probe"]) \
    == set(r_chaos.EXPECTED_UNKNOWN_CAUSES["backend.process"])

MC = 2000  # the shared budget under which the mix lands valid/invalid/unknown


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    """One torch thread, fresh breakers and seams, and any CLI ledger in
    the test's own directory."""
    monkeypatch.setenv("JEPSEN_LEDGER_PATH", str(tmp_path / "cli-ledger.jsonl"))
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    resilience.reset_breakers()
    p_chaos.reset()
    r_chaos.reset()
    yield
    torch.set_num_threads(n)
    resilience.reset_breakers()
    p_chaos.reset()
    r_chaos.reset()


def valid_history(pkg, seed, n_ops=200):
    return list(pkg["testing"].chunked_register_history(random.Random(seed), n_ops=n_ops,
                                                        n_procs=2, chunk_ops=30))


def mixed(pkg):
    T = pkg["testing"]
    return {
        "valid-a": valid_history(pkg, 21),
        "valid-b": valid_history(pkg, 22),
        "invalid": list(T.perturb_history(random.Random(7), valid_history(pkg, 23))),
        "overflow": list(T.random_register_history(random.Random(24), n_ops=120, n_procs=10,
                                                   crash_p=0.2)),
    }


def offline(history, **kw):
    """The reference's single search on the reference's own draw."""
    return r_wgl.check_history(RCas(init=0), RHistory(list(history)), backend="host",
                               **kw)["valid"]


def causes_of(row):
    return set(((row or {}).get("provenance") or {}).get("causes") or {})


class _InProcBackend:
    """One backend in process: a ``Service`` of package ``pkg`` with its
    own journal directory behind a real HTTP server on an ephemeral port,
    seen by a router of package ``rpkg``. ``respawn="ok"`` arms an
    in-process respawner (a fresh Service over the same journal
    directory, as ``ProcessRespawner`` does with a real child);
    ``respawn="fail"`` one that always raises."""

    def __init__(self, pkg, rpkg, name, journal_dir, svc_kw=None, failure_threshold=2,
                 respawn=None):
        self.pkg = pkg
        self.name = name
        self.journal_dir = str(journal_dir)
        self.svc_kw = dict(engine="host", register_live=False, ledger=False,
                           **pkg["svc_kw"], **(svc_kw or {}))
        self.generation = 0
        self._boot()
        respawner = {"ok": self._respawn, "fail": self._broken, None: None}[respawn]
        self.backend = rpkg["router"].Backend(
            name, self.url, journal_dir=self.journal_dir, failure_threshold=failure_threshold,
            cooldown_s=60.0, respawner=respawner)

    def _boot(self):
        self.svc = self.pkg["service"].Service(self.pkg["Cas"](init=0),
                                               journal_dir=self.journal_dir, name=self.name,
                                               **self.svc_kw)
        self.srv = self.pkg["http"].server(self.svc, port=0)
        threading.Thread(target=lambda: self.srv.serve_forever(poll_interval=0.02),
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.killed = False

    def _respawn(self, backend):
        if not self.killed:
            self.kill()
        self.generation += 1
        self._boot()
        backend.url = self.url

    def _broken(self, backend):
        raise RuntimeError("injected respawn failure")

    def kill(self):
        """The kill -9 stand-in: stop serving, the pump and the scheduler;
        no drain, no journal close."""
        self.killed = True
        self.srv.shutdown()
        self.srv.server_close()
        self.svc._pump_stop.set()
        self.svc.scheduler.close(timeout=10)

    def stop(self):
        if not self.killed:
            self.kill()


class _Cluster:
    """N in-process backends of package ``backends`` behind a router of
    package ``router`` with its own HTTP front door, fast probe cadence."""

    def __init__(self, tmp_path, n=2, router_kw=None, svc_kw=None, respawn=None,
                 router="port", backends="port"):
        self.rpkg = PKGS[router]
        kw = dict(register_live=False, probe_interval_s=0.05, probe_timeout_s=1.0,
                  failure_threshold=2, migrate_retry_after_s=0.05, rebalance=False)
        if respawn is not None:
            kw.update(respawn_base_backoff_s=0.01, respawn_max_backoff_s=0.05)
        kw.update(router_kw or {})
        self.nodes = [_InProcBackend(PKGS[backends], self.rpkg, f"b{i}", tmp_path / f"b{i}",
                                     svc_kw=svc_kw, failure_threshold=kw["failure_threshold"],
                                     respawn=respawn)
                      for i in range(n)]
        self.router = self.rpkg["router"].Router([nd.backend for nd in self.nodes], **kw)
        self.serve()

    def serve(self):
        self.rsrv = self.rpkg["router"].server(self.router, port=0)
        threading.Thread(target=lambda: self.rsrv.serve_forever(poll_interval=0.02),
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.rsrv.server_address[1]}"

    def node(self, name):
        return next(nd for nd in self.nodes if nd.backend.name == name)

    def client(self, tenant, **kw):
        kw.setdefault("chunk_ops", 25)
        kw.setdefault("max_retries", 100)
        kw.setdefault("max_backoff_s", 0.2)
        return self.rpkg["client"].HttpServiceClient(self.url, tenant, **kw)

    def feed_from_watermark(self, name, rows, end=None):
        """Resume one tenant from the server's watermark INCLUSIVE (the
        resume contract) up to ``end`` ops."""
        wm = (self.router.tenants_snapshot()["tenants"].get(name) or {}).get("watermark")
        start = (next((k for k, op in enumerate(rows) if op.index >= wm), 0)
                 if isinstance(wm, int) and wm >= 0 else 0)
        rep = self.client(name).feed(rows[start:end])
        assert rep["error"] is None, (name, rep)
        return rep

    def all_watermarks(self, names):
        rows = self.router.tenants_snapshot()["tenants"]
        return all(isinstance((rows.get(n) or {}).get("watermark"), int)
                   and rows[n]["watermark"] >= 0 for n in names)

    def stop(self):
        try:
            self.router.close()
        finally:
            self.rsrv.shutdown()
            self.rsrv.server_close()
            for nd in self.nodes:
                nd.stop()


def wait(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def assert_one_sided(fin, want):
    """Every tenant's verdict is the reference's offline one or an unknown
    with only the fleet seams' causes."""
    for n, row in fin["tenants"].items():
        if n in want:
            assert row["valid"] in (want[n], "unknown"), (n, row["valid"], want[n])
        if row["valid"] not in (True, False):
            assert causes_of(row) and causes_of(row) <= ALLOWED, (n, row)
    assert "unattributed" not in json.dumps(fin)


# ---------------------------------------------------------------------------
# The pure planners.


def _health(rng, tenants, backlog_scale):
    rows = {t: {"backlog": rng.randint(0, backlog_scale), "queue_depth": rng.randint(0, 90),
                **({"journal_lag_ops": rng.randint(0, 40_000)} if rng.random() < 0.5 else {})}
            for t in tenants}
    return {"ok": True, "scheduler_backlog": rng.randint(0, backlog_scale), "tenants": rows}


def _plan_case(seed):
    rng = random.Random(seed)
    names = [f"b{i}" for i in range(rng.randint(1, 4))]
    tenants = [f"t{i}" for i in range(rng.randint(0, 7))]
    placement = {t: rng.choice(names) for t in tenants if rng.random() < 0.9}
    health = {}
    for n in names:
        if rng.random() < 0.85:
            mine = [t for t, b in placement.items() if b == n and rng.random() < 0.9]
            health[n] = _health(rng, mine, rng.choice((5, 100, 2000)))
    return health, placement, set(names), rng


HAND_CASES = [
    ({"b0": {"scheduler_backlog": 600, "tenants": {"t-big": {"backlog": 500, "queue_depth": 80},
                                                   "t-small": {"backlog": 10}}},
      "b1": {"scheduler_backlog": 5, "tenants": {"t-idle": {"backlog": 5}}}},
     {"t-big": "b0", "t-small": "b0", "t-idle": "b1"}),
    ({"b0": {"scheduler_backlog": 100, "tenants": {"t": {"backlog": 100}}},
      "b1": {"scheduler_backlog": 1}}, {"t": "b0"}),
    ({"b0": {"scheduler_backlog": 600, "tenants": {"t": {"backlog": 600}}},
      "b1": {"scheduler_backlog": 400, "tenants": {"u": {"backlog": 400}}}},
     {"t": "b0", "u": "b1"}),
    ({"b0": {"scheduler_backlog": 0, "tenants": {"t": {"journal_lag_ops": 40_000}}},
      "b1": {"scheduler_backlog": 0}}, {"t": "b0"}),
    ({"b0": {"scheduler_backlog": 9000}, "b1": {"scheduler_backlog": 0}}, {"t": "b0"}),
    ({}, {"t": "b0"}),
    ({"b0": {"scheduler_backlog": 10_000, "tenants": {"t": {"backlog": 10_000}}}}, {"t": "b0"}),
]


@pytest.mark.parametrize("seed", range(40))
def test_planners_match_reference(seed):
    health, placement, live, rng = _plan_case(seed)
    for kw in ({}, dict(min_load=rng.choice((0.0, 50.0, 256.0)),
                        ratio=rng.choice((1.0, 2.0, 4.0)), lag_weight=rng.choice((0.0, 0.01)))):
        assert p_router.plan_rebalance(health, placement, **kw) == \
            r_router.plan_rebalance(health, placement, **kw)
    for h in list(health.values()) + [None, {}]:
        for lw in (0.01, 0.5):
            assert p_router.backend_load(h, lw) == r_router.backend_load(h, lw)
        for row in ((h or {}).get("tenants") or {None: None}).values():
            assert p_router.tenant_load(row, 0.01) == r_router.tenant_load(row, 0.01)
    for target in sorted(live) + ["gone"]:
        for alive in (live, live - {sorted(live)[0]}):
            assert p_router.plan_readopt(placement, target, alive) == \
                r_router.plan_readopt(placement, target, alive)


@pytest.mark.parametrize("case", range(len(HAND_CASES)))
def test_rebalance_edge_cases_match_reference(case):
    health, placement = HAND_CASES[case]
    for ratio in (1.0, 4.0):
        got = p_router.plan_rebalance(health, placement, min_load=256.0, ratio=ratio)
        assert got == r_router.plan_rebalance(health, placement, min_load=256.0, ratio=ratio)
    if case == 0:
        assert got == ("t-big", "b0", "b1")


def test_readopt_walks_to_balance_like_the_reference():
    for mod in (p_router, r_router):
        placement = {f"t{i}": "b1" for i in range(4)}
        moves = []
        while (plan := mod.plan_readopt(placement, "b0", {"b0", "b1"})) is not None:
            moves.append(plan)
            placement[plan[0]] = "b0"
        assert moves == [("t0", "b1"), ("t1", "b1")]


# ---------------------------------------------------------------------------
# router_state.jsonl across the packages.

SUPS = {"port": p_sup, "ref": r_sup}


def _write_state(sup, path, epoch=3, truncate_to=None, extra=()):
    st = sup.RouterState(path, epoch=epoch, truncate_to=truncate_to)
    for rec in ({"kind": "place", "tenant": "a", "backend": "b0"},
                {"kind": "place", "tenant": "a", "backend": "b1", "from": "b0"},
                {"kind": "orphan", "tenant": "o", "from": "b0", "causes": {"backend_lost": 1}},
                {"kind": "orphan_clear", "tenant": "o"},
                {"kind": "lost", "backend": "b0", "why": "process exited rc=-9"},
                {"kind": "orphan", "tenant": "p", "from": "b1",
                 "causes": {"backend_lost": 2, "migration_interrupted": 1}, "note": "no target"},
                {"kind": "respawned", "backend": "b0", "url": "http://127.0.0.1:1", "why": "respawn"},
                *extra):
        st.append(rec)
    st.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("tail", [b"", b'{"kind": "place", "ten',
                                  b'{"kind": "place", "tenant": "z", "backend": "b1"}'])
def test_state_file_is_the_reference_and_replays_across(writer, tail, tmp_path, monkeypatch):
    """Both writers give the same bytes (the clock fixed); either package
    replays either file the same way, a torn final line (or one without its
    newline) dropped, and a reopen after the tear keeps the epoch chain."""
    clock = types.SimpleNamespace(time=lambda: 1_790_000_000.25, monotonic=time.monotonic)
    for sup in SUPS.values():
        monkeypatch.setattr(sup, "_time", clock)
    files = {}
    for kind, sup in SUPS.items():
        path = str(tmp_path / f"{kind}.jsonl")
        _write_state(sup, path)
        files[kind] = Path(path).read_bytes()
    assert files["port"] == files["ref"]
    path = str(tmp_path / f"{writer}.jsonl")
    with open(path, "ab") as f:
        f.write(tail)
    reps = {k: sup.replay_state(path) for k, sup in SUPS.items()}
    assert reps["port"] == reps["ref"]
    rep = reps["port"]
    assert rep["torn_tail"] is bool(tail) and rep["epoch"] == 3
    assert rep["placement"] == {"a": "b1"} and set(rep["orphans"]) == {"p"}
    # the other package reopens it (truncating the tear) one epoch later
    other = SUPS["ref" if writer == "port" else "port"]
    _write_state(other, path, epoch=rep["epoch"] + 1,
                 truncate_to=rep["consistent_bytes"] if rep["torn_tail"] else None,
                 extra=({"kind": "place", "tenant": "c", "backend": "b0"},))
    again = {k: sup.replay_state(path) for k, sup in SUPS.items()}
    assert again["port"] == again["ref"]
    assert again["port"]["torn_tail"] is False and again["port"]["epoch"] == 4
    assert again["port"]["placement"] == {"a": "b1", "c": "b0"}
    assert SUPS["port"].replay_state(str(tmp_path / "missing.jsonl")) == \
        SUPS["ref"].replay_state(str(tmp_path / "missing.jsonl"))


# ---------------------------------------------------------------------------
# Placement and the kill matrix.


def test_placement_sticky_and_spread_like_the_reference(tmp_path):
    got = {}
    for kind in ("port", "ref"):
        c = _Cluster(tmp_path / kind, router=kind, backends=kind)
        try:
            h = valid_history(PKGS[kind], 7, n_ops=40)
            for t in ("t0", "t1", "t2", "t3"):
                assert c.client(t).feed(h)["error"] is None
            pl = c.router.placement()
            c.client("t0").feed(valid_history(PKGS[kind], 8, n_ops=20))
            assert c.router.placement()["t0"] == pl["t0"]
            got[kind] = pl
        finally:
            c.stop()
    assert got["port"] == got["ref"]
    assert sorted(got["port"].values()) == ["b0", "b0", "b1", "b1"]


@pytest.mark.chaos
def test_backend_kill_never_flips_a_verdict(tmp_path):
    """2 backends x 4 tenants, one backend killed after 60% of every
    stream: each verdict is the reference's or a typed unknown; the
    migrated clients resume from the journaled watermark and their covered
    ops are dropped server-side."""
    hs = mixed(PORT)
    want = {n: offline(h, host_max_configs=MC) for n, h in mixed(REF).items()}
    assert want == {"valid-a": True, "valid-b": True, "invalid": False, "overflow": "unknown"}
    reg = PRegistry()
    c = _Cluster(tmp_path, svc_kw={"max_configs": MC}, router_kw={"metrics": reg})
    try:
        cut = {n: int(len(r) * 0.6) for n, r in hs.items()}
        for n in hs:
            assert c.client(n).feed(hs[n][:cut[n]])["sent"] == cut[n]
        wait(lambda: c.all_watermarks([n for n in hs if n != "overflow"]), "watermarks", 60)
        victim = c.router.placement()["valid-a"]
        victims = sorted(t for t, b in c.router.placement().items() if b == victim)
        wm_before = {n: (c.router.tenants_snapshot()["tenants"].get(n) or {}).get("watermark")
                     for n in hs}
        c.node(victim).kill()
        wait(lambda: all(c.router.placement().get(t) != victim for t in victims),
             f"migration of {victims}")
        for n in hs:
            if n in victims:
                c.feed_from_watermark(n, hs[n])
            else:
                assert c.client(n).feed(hs[n][cut[n]:])["error"] is None
        fin = c.router.drain(timeout=120)
        assert_one_sided(fin, want)
        got = {n: fin["tenants"][n]["valid"] for n in hs}
        assert got["invalid"] is False and (got["valid-a"] is True or got["valid-b"] is True)
        dropped = 0
        for n in victims:
            row = fin["tenants"][n]
            assert row.get("resumed_from_journal"), (n, row)
            if isinstance(wm_before[n], int) and wm_before[n] >= 0:
                assert row.get("resubmitted_ops_dropped", 0) > 0, (n, row)
            dropped += row.get("resubmitted_ops_dropped") or 0
        assert dropped > 0
        mig = [m for m in c.router.stats()["migrations"] if m.get("ok")]
        assert sorted(m["tenant"] for m in mig) == victims
        assert {m["reason"] for m in mig} == {"backend_lost"}
        names = {s["name"] for s in reg.collect()}
        assert {"router_migrations_total", "router_failed_probes_total",
                "router_migration_seconds"} <= names
    finally:
        c.stop()


def test_manual_migration_over_release(tmp_path):
    """The source alive: quiesce and ``/release`` hand the journal over,
    the source tombstones the tenant (a typed 410 to a stray direct
    submit, also after a restart of the source), the target adopts and the
    stream ends with the reference's verdict."""
    h = valid_history(PORT, 31, n_ops=240)
    c = _Cluster(tmp_path)
    try:
        cut = len(h) // 2
        assert c.client("liv").feed(h[:cut])["error"] is None
        src = c.router.placement()["liv"]
        with pytest.raises(KeyError):
            c.router.migrate("liv", target="no-such-backend")
        assert c.router.migrate("liv", reason="rebalance") is True
        dst = c.router.placement()["liv"]
        src_dir = c.node(src).backend.journal_dir
        assert dst != src and not os.path.exists(p_journal.tenant_path(src_dir, "liv"))
        assert os.path.exists(p_journal.tenant_path(src_dir, "liv") + ".migrated")
        with pytest.raises(p_service.TenantMigratedError) as e:
            c.node(src).svc.submit("liv", {"type": "invoke", "process": 0, "f": "read",
                                           "value": None, "time": 0})
        assert e.value.http_status == 410
        rep = c.client("liv").feed(h[cut:])
        assert rep["error"] is None and rep["retries"] == 0
        fin = c.router.drain(timeout=60)
        assert fin["tenants"]["liv"]["valid"] is offline(valid_history(REF, 31, n_ops=240)) \
            is True
        assert fin["tenants"]["liv"]["backend"] == dst
        assert [m["reason"] for m in c.router.stats()["migrations"]] == ["rebalance"]
    finally:
        c.stop()
    svc2 = p_service.Service(PCas(init=0), engine="host", device="cpu", register_live=False,
                             ledger=False, journal_dir=src_dir)
    try:
        with pytest.raises(p_service.TenantMigratedError):
            svc2.submit("liv", {"type": "invoke", "process": 0, "f": "read", "value": None,
                                "time": 0})
    finally:
        svc2.drain(timeout=10)


def test_kill_switch_orphans_one_sidedly_and_a_later_migration_recovers(tmp_path,
                                                                        monkeypatch):
    monkeypatch.setenv("JEPSEN_NO_MIGRATION", "1")
    h = valid_history(PORT, 43, n_ops=160)
    c = _Cluster(tmp_path)
    try:
        assert c.client("keep").feed(h[:40])["error"] is None
        assert c.router.migrate("keep", reason="manual") is False  # refused, not orphaned
        assert "keep" not in c.router.stats()["orphaned"]
        assert c.client("t").feed(h[:len(h) // 2])["error"] is None
        victim = c.router.placement()["t"]
        c.node(victim).kill()
        wait(lambda: "t" in c.router.stats()["orphaned"], "orphaning under the kill-switch")
        status, doc = c.router.submit("t", b'{"type": "invoke", "process": 0, "f": "read", '
                                           b'"value": null, "time": 0}\n')
        assert status == 503 and doc["error"] == "orphaned" and doc["retryable"] is False
        assert c.router.stats()["orphaned"]["t"]["causes"] == \
            {"backend_lost": 1, "migration_interrupted": 1}
        assert c.router.tenants_snapshot()["tenants"]["t"]["verdict"] == "unknown"
        monkeypatch.delenv("JEPSEN_NO_MIGRATION")
        # the operator's recovery: the journal still sits in the dead dir
        assert c.router.migrate("t", reason="manual") is True
        assert "t" not in c.router.stats()["orphaned"]
        c.feed_from_watermark("t", h)
        fin = c.router.drain(timeout=60)
        assert fin["tenants"]["t"]["valid"] is True
    finally:
        c.stop()


def test_kill_switch_drain_folds_unknown_with_typed_causes(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_NO_MIGRATION", "1")
    h = valid_history(PORT, 41, n_ops=120)
    c = _Cluster(tmp_path)
    try:
        assert c.client("t").feed(h[:len(h) // 2])["error"] is None
        c.node(c.router.placement()["t"]).kill()
        wait(lambda: "t" in c.router.stats()["orphaned"], "orphaning")
        fin = c.router.drain(timeout=30)
        row = fin["tenants"]["t"]
        assert row["valid"] == "unknown" and fin["valid"] == "unknown"
        assert causes_of(row) == {"backend_lost", "migration_interrupted"}
        assert not any(m["ok"] for m in c.router.stats()["migrations"])
    finally:
        c.stop()


@pytest.mark.chaos
def test_false_positive_probe_migrates_via_release(tmp_path):
    h = valid_history(PORT, 51, n_ops=200)
    c = _Cluster(tmp_path, router_kw={"failure_threshold": 1, "probe_interval_s": 10.0})
    try:
        assert c.client("fp").feed(h[:len(h) // 2])["error"] is None
        src = c.router.placement()["fp"]
        with p_chaos.inject("router.probe", on_call=1, times=1):
            c.router._tick()
        assert p_chaos.fired("router.probe") == 1
        wait(lambda: c.router.placement()["fp"] != src, "false-positive migration", 10)
        assert c.client("fp").feed(h[len(h) // 2:])["error"] is None
        fin = c.router.drain(timeout=60)
        assert fin["tenants"]["fp"]["valid"] is True
        assert [m["reason"] for m in c.router.stats()["migrations"]] == ["backend_lost"]
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# Supervision: respawn and re-adoption, flap damping, the rolling restart.


def test_kill_same_backend_twice_respawn_and_readopt(tmp_path):
    reg = PRegistry()
    c = _Cluster(tmp_path, respawn="ok", router_kw={"metrics": reg})
    try:
        hs = {f"t{i}": valid_history(PORT, 70 + i) for i in range(4)}
        want = {f"t{i}": offline(valid_history(REF, 70 + i)) for i in range(4)}
        for n, r in hs.items():
            assert c.client(n).feed(r[:int(len(r) * 0.4)])["error"] is None
        wait(lambda: c.all_watermarks(hs), "journaled watermarks", 60)
        victim = c.router.placement()["t0"]
        vb, sup = c.router._backends[victim], c.router._supervisors[victim]
        for kills, frac in ((1, 0.7), (2, 1.0)):
            c.node(victim).kill()
            wait(lambda: sup.respawns >= kills and not vb.down
                 and victim in c.router.placement().values(),
                 f"kill #{kills}: respawn and re-adopt", 60)
            for n, r in hs.items():
                c.feed_from_watermark(n, r, int(len(r) * frac))
        fin = c.router.drain(timeout=120)
        assert_one_sided(fin, want)
        assert any(fin["tenants"][n]["valid"] is True for n in hs)
        st = c.router.stats()
        assert st["fleet"]["live_backends"] == st["fleet"]["configured_backends"] == 2
        assert st["fleet"]["respawns"] == 2 and st["fleet"]["respawn_gave_up"] == []
        assert c.node(victim).generation == 2
        reasons = {m["reason"] for m in st["migrations"] if m.get("ok")}
        assert {"backend_lost", "readopt"} <= reasons
        assert sum(fin["tenants"][n].get("resubmitted_ops_dropped") or 0 for n in hs) > 0
        names = {s["name"] for s in reg.collect()}
        assert {"router_respawns_total", "router_respawn_seconds"} <= names
    finally:
        c.stop()


def test_flap_damping_gives_up_one_sidedly(tmp_path):
    reg = PRegistry()
    c = _Cluster(tmp_path, respawn="fail",
                 router_kw={"metrics": reg, "respawn_max_failures": 3, "respawn_window_s": 60.0})
    try:
        hs = {f"t{i}": valid_history(PORT, 90 + i, n_ops=120) for i in range(2)}
        for n, r in hs.items():
            assert c.client(n).feed(r[:len(r) // 2])["error"] is None
        victim = c.router.placement()["t0"]
        sup = c.router._supervisors[victim]
        c.node(victim).kill()
        wait(lambda: sup.gave_up, "flap circuit giving up")
        assert c.client("fresh").feed(valid_history(PORT, 99, n_ops=60))["error"] is None
        row = c.router.health_snapshot()["backends"][victim]
        assert row["state"] == "respawn_gave_up" and row["respawn_gave_up"] is True
        fleet = c.router.stats()["fleet"]
        assert fleet["live_backends"] == 1 and fleet["respawn_gave_up"] == [victim]
        recs = p_advisor.advise({"service_router": {"fleet": fleet}})
        assert "respawn_backend" in [r["id"] for r in recs]
        outcomes = {s["labels"].get("outcome") for s in reg.collect()
                    if s["name"] == "router_respawns_total"}
        assert {"failed", "gave_up"} <= outcomes
        fin = c.router.drain(timeout=60)
        for n in list(hs) + ["fresh"]:
            assert fin["tenants"][n]["valid"] in (True, "unknown")
        assert "unattributed" not in json.dumps(fin)
    finally:
        c.stop()


def test_rolling_restart_zero_unknown(tmp_path):
    c = _Cluster(tmp_path, respawn="ok")
    try:
        hs = {f"t{i}": valid_history(PORT, 110 + i, n_ops=160) for i in range(4)}
        cut = {n: len(r) // 2 for n, r in hs.items()}
        for n, r in hs.items():
            assert c.client(n).feed(r[:cut[n]])["error"] is None
        wait(lambda: c.all_watermarks(hs), "journaled watermarks", 60)
        gens = {nd.name: nd.generation for nd in c.nodes}
        req = urllib.request.Request(c.url + "/roll", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            doc = json.loads(r.read().decode())
        assert doc["ok"] is True, doc
        entries = {e["backend"]: e for e in doc["backends"]}
        for nd in c.nodes:
            assert nd.generation == gens[nd.name] + 1
            assert "seconds" in entries[nd.name] and "error" not in entries[nd.name]
        assert not any(b.down for b in c.router._backends.values())
        for n, r in hs.items():
            assert c.client(n).feed(r[cut[n]:])["error"] is None
        fin = c.router.drain(timeout=120)
        assert {n: fin["tenants"][n]["valid"] for n in hs} == {n: True for n in hs}
        assert "roll" in {m["reason"] for m in c.router.stats()["migrations"] if m.get("ok")}
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# router.crash.


@pytest.mark.chaos
def test_raising_migration_orphans_one_tenant_and_moves_its_sibling(tmp_path):
    c = _Cluster(tmp_path)
    try:
        hs = {f"t{i}": valid_history(PORT, 130 + i, n_ops=120) for i in range(4)}
        for n, r in hs.items():
            assert c.client(n).feed(r[:len(r) // 2])["error"] is None
        wait(lambda: c.all_watermarks(hs), "journaled watermarks", 60)
        victim = c.router.placement()["t0"]
        victims = sorted(t for t, b in c.router.placement().items() if b == victim)
        assert len(victims) == 2
        with p_chaos.inject("router.crash", on_call=1, times=1):
            c.node(victim).kill()
            wait(lambda: p_chaos.fired("router.crash") >= 1, "chaos mid-migration")
            wait(lambda: not c.router._migrating, "migrations settling")
        st = c.router.stats()
        assert len(st["orphaned"]) == 1
        orphan = next(iter(st["orphaned"]))
        sibling = next(t for t in victims if t != orphan)
        assert st["placement"][sibling] != victim
        assert set(st["orphaned"][orphan]["causes"]) == {"backend_lost", "migration_interrupted"}
        c.feed_from_watermark(sibling, hs[sibling])
        fin = c.router.drain(timeout=60)
        assert fin["tenants"][sibling]["valid"] in (True, "unknown")
        assert fin["tenants"][orphan]["valid"] == "unknown"
        assert_one_sided(fin, {})
    finally:
        c.stop()


@pytest.mark.chaos
def test_crash_midmigration_restart_recovers_and_fences(tmp_path):
    """The router dies with the checkpoint in hand and the adopt not
    issued; a router restarted on its state file bumps the epoch,
    re-migrates the released tenant off its ``.migrated`` checkpoint and
    fences every backend against the dead generation."""
    state = str(tmp_path / "router_state.jsonl")
    c = _Cluster(tmp_path, router_kw={"state_path": state})
    router2 = rsrv2 = None
    try:
        rows = valid_history(PORT, 121, n_ops=200)
        half = len(rows) // 2
        assert c.client("mig").feed(rows[:half])["error"] is None
        assert c.client("stay").feed(valid_history(PORT, 122, n_ops=60))["error"] is None
        wait(lambda: c.all_watermarks(["mig"]), "journaled watermark", 60)
        src, stay_home = c.router.placement()["mig"], c.router.placement()["stay"]
        epoch1 = c.router._epoch
        with p_chaos.inject("router.crash", on_call=1):
            with pytest.raises(p_chaos.ChaosError):
                c.router.migrate("mig", reason="manual")
        c.router.close()
        c.rsrv.shutdown()
        c.rsrv.server_close()
        # the reference replays the dead port router's state file the same way
        assert r_sup.replay_state(state) == p_sup.replay_state(state)
        router2 = p_router.Router([nd.backend for nd in c.nodes], register_live=False,
                                  probe_interval_s=0.05, probe_timeout_s=1.0,
                                  failure_threshold=2, migrate_retry_after_s=0.05,
                                  rebalance=False, state_path=state)
        assert router2._epoch > epoch1
        pl = router2.placement()
        assert pl["stay"] == stay_home and pl["mig"] != src
        assert "mig" not in router2.stats()["orphaned"]
        row = router2.tenants_snapshot()["tenants"]["mig"]
        assert row.get("resumed_from_journal"), row
        mig = [m for m in router2.stats()["migrations"] if m.get("ok")]
        assert [(m["tenant"], m["reason"]) for m in mig] == [("mig", "router_restart")]
        for nd in c.nodes:
            with pytest.raises(p_service.StaleEpochError) as ei:
                nd.svc.adopt("ghost", "x", epoch=epoch1)
            assert ei.value.http_status == 409 and ei.value.code == "stale_epoch"
        rsrv2 = p_router.server(router2, port=0)
        threading.Thread(target=lambda: rsrv2.serve_forever(poll_interval=0.02),
                         daemon=True).start()
        url2 = f"http://127.0.0.1:{rsrv2.server_address[1]}"
        wm = row["watermark"]
        start = next(k for k, op in enumerate(rows) if op.index >= wm) \
            if isinstance(wm, int) and wm >= 0 else 0
        rep = p_client.HttpServiceClient(url2, "mig", chunk_ops=25, max_retries=100,
                                         max_backoff_s=0.2).feed(rows[start:])
        assert rep["error"] is None, rep
        fin = router2.drain(timeout=120)
        assert fin["tenants"]["mig"]["valid"] is True and fin["tenants"]["stay"]["valid"] is True
    finally:
        if router2 is not None:
            router2.close()
        if rsrv2 is not None:
            rsrv2.shutdown()
            rsrv2.server_close()
        c.stop()


# ---------------------------------------------------------------------------
# Protocol parity across the packages.


@pytest.mark.parametrize("router,backends", [("port", "ref"), ("ref", "port")])
def test_router_fronts_the_other_packages_backends(router, backends, tmp_path):
    """Placement, a live migration (``/release`` then ``/adopt`` with the
    epoch) and the drain between one package's router and the other's
    backends give the reference's per-tenant verdicts."""
    rp = PKGS[router]
    hs = mixed(rp)
    want = {n: offline(h, host_max_configs=MC) for n, h in mixed(REF).items()}
    c = _Cluster(tmp_path, router=router, backends=backends, svc_kw={"max_configs": MC})
    try:
        cut = {n: len(r) // 2 for n, r in hs.items()}
        for n in hs:
            assert c.client(n).feed(hs[n][:cut[n]])["sent"] == cut[n]
        src = c.router.placement()["valid-a"]
        assert c.router.migrate("valid-a", reason="manual") is True
        assert c.router.placement()["valid-a"] != src
        for n in hs:
            assert c.client(n).feed(hs[n][cut[n]:])["error"] is None
        fin = c.router.drain(timeout=120)
        assert {n: fin["tenants"][n]["valid"] for n in hs} == want
        assert fin["tenants"]["valid-a"]["resumed_from_journal"]
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# Processes.


def test_spawned_backend_without_a_card_exits_255(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: a backend without --device cpu comes up on it")
    with pytest.raises(RuntimeError, match="rc=255"):
        p_router.spawn_backends(1, journal_root=str(tmp_path / "j"), engine="device")
    assert p_main.main(["--router", "--router-backends", "1", "--engine", "device",
                        "--journal-dir", str(tmp_path / "k"), "--port", "0"]) == 255
    assert p_main.main(["--router", "--port", "0"]) == 254  # no --journal-dir


def _wait_port(proc, path, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stderr.read()
        try:
            return int(Path(path).read_text())
        except (OSError, ValueError):
            time.sleep(0.05)
    raise AssertionError("the router wrote no port")


def test_router_cli_serves_rolls_and_drains(tmp_path, capsys):
    """``--router`` as a process over two ``--device cpu`` backends: a
    tenant fed over HTTP, ``--roll`` rolls both backends (exit 0) with the
    tenant's verdict still the reference's, and an interrupt drains and
    prints the merged results (exit 0)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    pf = tmp_path / "router.port"
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.service", "--router", "--router-backends", "2",
         "--journal-dir", str(tmp_path / "fleet"), "--port", "0", "--port-file", str(pf),
         "--engine", "host", "--device", "cpu", "--probe-interval", "0.1"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        url = f"http://127.0.0.1:{_wait_port(proc, pf)}"
        h = valid_history(PORT, 140, n_ops=240)
        half = len(h) // 2
        rep = p_client.HttpServiceClient(url, "cli", chunk_ops=40, max_retries=100,
                                         max_backoff_s=0.2).feed(h[:half])
        assert rep["error"] is None
        assert p_main.main(["--roll", url]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["ok"] is True and len(doc["backends"]) == 2
        assert all("seconds" in e and "error" not in e for e in doc["backends"])
        rep = p_client.HttpServiceClient(url, "cli", chunk_ops=40, max_retries=100,
                                         max_backoff_s=0.2).feed(h[half:])
        assert rep["error"] is None
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    assert proc.returncode == 0, err[-3000:]
    fin = json.loads(out[out.index("\n{") + 1:])
    assert fin["valid"] is True and fin["tenants"]["cli"]["valid"] is \
        offline(valid_history(REF, 140, n_ops=240))


# ---------------------------------------------------------------------------
# The real kill -9 of spawned children (slow, as in the reference).


@pytest.mark.slow
@pytest.mark.chaos
def test_kill9_same_backend_twice_respawn_and_readopt(tmp_path):
    backends = p_router.spawn_backends(2, journal_root=str(tmp_path), engine="host",
                                       device="cpu", failure_threshold=2, cooldown_s=60.0)
    router = p_router.Router(backends, register_live=False, probe_interval_s=0.1,
                             failure_threshold=2, migrate_retry_after_s=0.1, rebalance=False,
                             respawn_base_backoff_s=0.1, respawn_max_backoff_s=0.5)
    rsrv = p_router.server(router, port=0)
    threading.Thread(target=lambda: rsrv.serve_forever(poll_interval=0.02), daemon=True).start()
    url = f"http://127.0.0.1:{rsrv.server_address[1]}"
    try:
        hs = {f"t{i}": valid_history(PORT, 60 + i) for i in range(4)}
        want = {f"t{i}": offline(valid_history(REF, 60 + i)) for i in range(4)}

        def feed_all(frac):
            snap = router.tenants_snapshot()["tenants"]
            for n, r in hs.items():
                w = (snap.get(n) or {}).get("watermark")
                start = (next((k for k, op in enumerate(r) if op.index >= w), 0)
                         if isinstance(w, int) and w >= 0 else 0)
                rep = p_client.HttpServiceClient(url, n, chunk_ops=25, max_retries=100,
                                                 max_backoff_s=0.2).feed(
                    r[start:int(len(r) * frac)])
                assert rep["error"] is None, (n, rep)

        feed_all(0.4)
        wait(lambda: all(isinstance((router.tenants_snapshot()["tenants"].get(n) or {})
                                    .get("watermark"), int) for n in hs), "watermarks", 60)
        with p_chaos.inject("backend.process", on_call=1):
            wait(lambda: p_chaos.fired("backend.process") == 1, "the kill order")
        wait(lambda: any(b.down or b.proc.poll() is not None for b in backends), "the death")
        vb = next(b for b in backends if b.down or b.proc.poll() is not None)
        pid1 = vb.proc.pid

        def healed(k):
            st = router.stats()
            return (st["fleet"]["respawns"] >= k and not vb.down
                    and vb.name in st["placement"].values())

        wait(lambda: healed(1), "respawn #1", 120)
        assert vb.proc.pid != pid1
        feed_all(0.7)
        vb.proc.kill()
        wait(lambda: healed(2), "respawn #2", 120)
        feed_all(1.0)
        fin = router.drain(timeout=120)
        assert_one_sided(fin, want)
        st = router.stats()
        assert st["fleet"]["live_backends"] == 2 and st["fleet"]["respawns"] == 2
        assert {"backend_lost", "readopt"} <= {m["reason"] for m in st["migrations"]
                                               if m.get("ok")}
        assert sum(fin["tenants"][n].get("resubmitted_ops_dropped") or 0 for n in hs) > 0
    finally:
        router.close()
        rsrv.shutdown()
        rsrv.server_close()
