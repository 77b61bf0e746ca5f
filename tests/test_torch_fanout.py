"""The port's fleet fan-out (``jepsen_tpu_torch.offline.fanout``) against
the reference's (``jepsen_tpu.offline.fanout``).

One keyed history, drawn from a seed by the port's generator and handed
to the reference as its own ``History``, is planned by both packages and
fanned out as synthetic tenants: over in-process services
(``fanout_services``, the host engine and the device engine, the port's
plain search on the CPU against the reference's on JAX's CPU), and over
real backend processes behind each package's router
(``check_offline(backends=1|2)``, the port's children started with
``--device cpu``). The folded verdict, the provenance, the undelivered
streams and every tenant's row (its walls and latencies left out) must
be the reference's; a mixed keyed/keyless history and a stream whose feed
stops half way fold the same way; ``python -m jepsen_tpu_torch.offline
--backends 2`` decides like ``backends=0``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu import offline as ref_offline
from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.parallel import resilience as ref_resilience
from jepsen_tpu.service import client as ref_client
from jepsen_tpu_torch import offline
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.parallel import resilience
from jepsen_tpu_torch.service import client as p_client
from jepsen_tpu_torch.telemetry import Registry

from test_torch_offline import keyed_history, poisoned_tail, to_ref

pytestmark = [pytest.mark.offline, pytest.mark.service]

ROOT = Path(__file__).resolve().parent.parent

# Per-tenant fields that time the run rather than decide it (how many ops
# were observed when a violation was detected depends on the decider's
# speed against the feeder's).
_TIMING = {"wall_s", "decide_s", "busy_pct", "plan_seconds", "utilization", "t",
           "decision_latency", "p50_decision_latency_s", "p99_decision_latency_s",
           "seconds_to_detection", "ops_to_detection", "trace_span", "backend"}


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    resilience.reset_breakers()
    ref_resilience.reset_breakers()
    yield
    torch.set_num_threads(n)
    resilience.reset_breakers()
    ref_resilience.reset_breakers()


def scrub(x):
    if isinstance(x, dict):
        return {k: scrub(v) for k, v in x.items() if k not in _TIMING}
    if isinstance(x, (list, tuple)):
        return [scrub(v) for v in x]
    return x


def folded(out) -> dict:
    """What a fan-out decides: the verdict, its causes, the undelivered
    streams, the plan's counts and every tenant's row."""
    return json.loads(json.dumps(scrub({
        k: out.get(k) for k in ("valid", "provenance", "undelivered_streams", "n_ops",
                                "backends", "tenants", "parallel")}), sort_keys=True,
        default=str))


def plans(h, streams=2):
    return offline.plan(h, streams=streams), ref_offline.plan(to_ref(h), streams=streams)


CASES = {"valid": dict(seed=19, n_ops=320, n_keys=4, n_writers=3),
         "invalid": dict(seed=20, n_ops=320, n_keys=4, n_writers=3, invalid=True)}


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fanout_services_matches_reference(case, engine):
    kw = dict(CASES[case])
    h = keyed_history(kw.pop("seed"), **kw)
    if engine == "device":
        h = poisoned_tail(h)  # a terminal segment: the oracle's member
    pp, rp = plans(h)
    reg = Registry()
    port = offline.fanout_services(pp, CasRegister(init=0), backends=2, engine=engine,
                                   device="cpu", metrics=reg)
    ref = ref_offline.fanout_services(rp, RefCas(init=0), backends=2, engine=engine)
    assert folded(port) == folded(ref)
    assert port["valid"] is (case == "valid")
    if engine == "device":
        assert any(e["engine"] == "device" and e["oracle_members"]
                   for e in reg.events("online_round"))
    assert set(port["tenants"]) == {f"offline-{s}" for s in pp.stream_ops if pp.stream_ops[s]}
    assert scrub(port["plan"]) == scrub(ref["plan"])


def test_mixed_keys_fold_unknown_like_the_reference():
    h = keyed_history(21, n_ops=120, n_keys=2, n_writers=3)
    ops = list(h) + [h[-1].with_(value=3, index=-1, process=99)]
    h = History(ops, reindex=True)
    pp, rp = plans(h)
    assert pp.mixed and rp.mixed
    for backends in (1, 2):
        port = offline.fanout_services(pp, CasRegister(init=0), backends=backends, device="cpu")
        ref = ref_offline.fanout_services(rp, RefCas(init=0), backends=backends)
        assert folded(port) == folded(ref)
        assert port["valid"] == "unknown" and "mixed_keys" in port["provenance"]["causes"]
        # the fleet returns before it spawns anything
        assert folded(offline.fanout_fleet(pp, backends=backends, device="cpu")) == \
            folded(ref_offline.fanout_fleet(rp, backends=backends))


def test_an_undelivered_stream_folds_unknown_like_the_reference(monkeypatch):
    """A feeder that stops half way leaves its suffix undecided: the fold
    is ``unknown`` with ``lost_segments`` and the stream named, in both
    packages."""
    h = keyed_history(22, n_ops=320, n_keys=4, n_writers=3)
    pp, rp = plans(h)
    victim = f"offline-{sorted(s for s in pp.stream_ops if pp.stream_ops[s])[0]}"
    for mod in (p_client, ref_client):
        real = mod.InProcessServiceClient.feed

        def half_feed(self, ops, _real=real):
            ops = list(ops)
            if self.tenant != victim:
                return _real(self, ops)
            rep = _real(self, ops[:len(ops) // 2])
            rep["ops"] = len(ops)
            return rep

        monkeypatch.setattr(mod.InProcessServiceClient, "feed", half_feed)
    port = offline.fanout_services(pp, CasRegister(init=0), backends=2, engine="host",
                                   device="cpu")
    ref = ref_offline.fanout_services(rp, RefCas(init=0), backends=2, engine="host")
    assert folded(port) == folded(ref)
    assert port["valid"] == "unknown" and port["undelivered_streams"] == [victim[8:]]
    assert "lost_segments" in port["provenance"]["causes"]


@pytest.mark.parametrize("backends", [1, 2])
def test_check_offline_over_backend_processes_matches_reference(backends, tmp_path):
    """``check_offline(backends=N)``: N backend processes behind each
    package's router decide the same tenants the same way, and the port's
    verdict is its ``backends=0`` one."""
    h = keyed_history(23, n_ops=360, n_keys=4, n_writers=3)
    port = offline.check_offline(CasRegister(init=0), h, streams=2, engine="host",
                                 backends=backends, device="cpu",
                                 journal_root=str(tmp_path / "port"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    ref = ref_offline.check_offline(RefCas(init=0), to_ref(h), streams=2, engine="host",
                                    backends=backends, env=env,
                                    journal_root=str(tmp_path / "ref"))
    assert folded(port) == folded(ref)
    inproc = offline.check_offline(CasRegister(init=0), h, streams=2, engine="host",
                                   device="cpu")
    assert port["valid"] is inproc["valid"] is True and port["parallel"] == "segmented"
    assert port["backend_loads"] and port["fleet"]["configured_backends"] == backends
    assert port["fleet"]["live_backends"] == backends


def test_offline_cli_fans_out_over_backends(tmp_path):
    h = keyed_history(24, n_ops=240, n_keys=3, n_writers=3)
    src = tmp_path / "history.ndjson"
    with open(src, "w") as f:
        for op in h:
            v = [op.value.key, op.value.value]
            f.write(json.dumps({"type": op.type, "process": op.process, "f": op.f, "value": v,
                                "time": op.time, "index": op.index}) + "\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    out = {}
    for backends in ("0", "2"):
        dst = tmp_path / f"out{backends}.json"
        run = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.offline", str(src),
                              "--keyed", "--engine", "host", "--device", "cpu", "--backends",
                              backends, "-o", str(dst)], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        out[backends] = json.loads(dst.read_text())
    assert out["0"]["valid"] is out["2"]["valid"] is True
    assert out["2"]["backends"] == 2 and len(out["2"]["tenants"]) == out["0"]["plan"]["n_streams"]
