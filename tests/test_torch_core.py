"""The port's test runner (``core``, the interpreter, the fake cluster)
against the reference's.

- ``core.analyze`` of one fixed stored history gives the reference's
  results map, wall times aside, under the C engine, the host oracle and
  the device search (the port's on the CPU), and the same store files.
- A deterministic run (one worker, a fixed op sequence) stores the same
  file set in both packages, with equal ``results.edn`` but for wall times
  and equal ledger records but for their stamps.
- Threaded runs are not deterministic, so they are held by cross-checking:
  each package's checker reads the other package's history and gives the
  same verdict (the reference's basic CAS test at N = 300, and the
  interpreter's crash, exception, nemesis and sleep/log cases).
- What the port refuses rather than hides: no card without
  ``device="cpu"``, the options whose machinery it lacks, a deterministic
  device error of the monitor or the analysis."""

from __future__ import annotations

import random
import re
import threading
from pathlib import Path

import pytest
import torch

from jepsen_tpu import checker as r_checker
from jepsen_tpu import client as r_client
from jepsen_tpu import core as r_core
from jepsen_tpu import generator as r_gen
from jepsen_tpu import nemesis as r_nemesis
from jepsen_tpu import store as r_store
from jepsen_tpu import workloads as r_wl
from jepsen_tpu.generator import interpreter as r_interp
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.history import Op as ROp
from jepsen_tpu.models import CasRegister as RCas
from jepsen_tpu.testing import random_register_history as r_random
from jepsen_tpu_torch import checker as p_checker
from jepsen_tpu_torch import client as p_client
from jepsen_tpu_torch import core as p_core
from jepsen_tpu_torch import db as p_db
from jepsen_tpu_torch import generator as p_gen
from jepsen_tpu_torch import nemesis as p_nemesis
from jepsen_tpu_torch import store as p_store
from jepsen_tpu_torch import workloads as p_wl
from jepsen_tpu_torch.generator import interpreter as p_interp
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import Op as POp
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.telemetry import ledger as p_ledger
from jepsen_tpu_torch.testing import perturb_history as p_perturb
from jepsen_tpu_torch.testing import random_register_history as p_random

START = "20260801T000000.000Z"
# Result-map keys that hold host timings or the torch device.
TIMING = ("wall_s", "torch_device", "checker_seconds")

REF = dict(checker=r_checker, gen=r_gen, core=r_core, wl=r_wl, client=r_client,
           nemesis=r_nemesis, interp=r_interp, Cas=RCas, History=RHistory, Op=ROp)
PORT = dict(checker=p_checker, gen=p_gen, core=p_core, wl=p_wl, client=p_client,
            nemesis=p_nemesis, interp=p_interp, Cas=PCas, History=PHistory, Op=POp)


def untimed(x):
    """A result map without host timings, nested maps and lists included."""
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if k not in TIMING}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


_WALL = re.compile(rb"(:wall_s|:checker_seconds) [0-9.e-]+")


def _linear(pkg, backend):
    kw = {} if pkg is REF else {"device": "cpu"}
    return pkg["checker"].linearizable(model=pkg["Cas"](init=0), backend=backend, **kw)


def _fixed(seed, refuted):
    """One history in both packages, from one seed (a refuted one perturbed)."""
    r1, r2 = random.Random(seed), random.Random(seed)
    rh = r_random(r1, n_ops=40, n_procs=3, crash_p=0.05)
    ph = p_random(r2, n_ops=40, n_procs=3, crash_p=0.05)
    if refuted:
        from jepsen_tpu.testing import perturb_history as r_perturb

        rh, ph = r_perturb(r1, rh), p_perturb(r2, ph)
    return rh, ph


@pytest.mark.parametrize("backend", ["native", "host", "device"])
@pytest.mark.parametrize("refuted", [False, True])
def test_analyze_of_a_stored_history_matches_reference(tmp_path, backend, refuted):
    rh, ph = _fixed(21, refuted)
    out = {}
    for name, pkg, store, h in (("ref", REF, r_store, rh), ("port", PORT, p_store, ph)):
        t = {"name": "fixed", "start-time": START, "store-root": str(tmp_path / name),
             "history": h}
        store.save_1(t)
        t["checker"] = pkg["checker"].compose({"linear": _linear(pkg, backend),
                                               "stats": pkg["checker"].stats()})
        out[name] = pkg["core"].analyze(t)
    want, got = out["ref"]["results"], out["port"]["results"]
    assert got["valid"] == want["valid"] == (False if refuted else True)
    if backend == "device":
        keys = ("valid", "levels", "frontier_max", "max_linearized", "op_count")
        assert {k: got["linear"].get(k) for k in keys} == \
            {k: want["linear"].get(k) for k in keys}
        assert got["stats"] == want["stats"]
        return
    assert untimed(got) == untimed(want)
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port) == sorted(ref)
    for f in ref:
        if f.endswith("results.edn"):
            assert _WALL.sub(b"T", port[f]) == _WALL.sub(b"T", ref[f]), f
        elif not f.endswith(".svg"):
            # test.edn names each package's own store root
            assert port[f].replace(str(tmp_path / "port").encode(), b"R") == \
                ref[f].replace(str(tmp_path / "ref").encode(), b"R"), f


# ---------------------------------------------------------------------------
# a deterministic run through core.run: the store and the ledger


def _sequential_test(pkg, root, **extra):
    state = pkg["wl"].AtomState()
    ops = [{"f": "write", "value": 1}, {"f": "read"}, {"f": "cas", "value": [1, 2]},
           {"f": "read"}, {"f": "cas", "value": [1, 3]}, {"f": "write", "value": 4},
           {"f": "read"}]
    test = dict(pkg["wl"].noop_test())
    test.update(
        name="sequential", nodes=["n1"], concurrency=1, db=pkg["wl"].AtomDB(state),
        client=pkg["wl"].AtomClient(state, latency=0), model=pkg["Cas"](init=0),
        checker=pkg["checker"].compose({"linear": _linear(pkg, "native"),
                                        "stats": pkg["checker"].stats()}),
        generator=pkg["gen"].clients(ops), **{"store-root": str(root)})
    test.update(extra)
    return test


@pytest.mark.parametrize("telemetry", [False, True])
def test_sequential_run_stores_what_the_reference_stores(tmp_path, telemetry):
    extra = {"telemetry?": True} if telemetry else {}
    ref = r_core.run(_sequential_test(REF, tmp_path / "ref", **extra))
    port = p_core.run(_sequential_test(PORT, tmp_path / "port", **extra))
    assert untimed(port["results"]) == untimed(ref["results"])
    assert port["results"]["valid"] is True
    assert [(o.type, o.process, o.f, o.value) for o in port["history"]] == \
        [(o.type, o.process, o.f, o.value) for o in ref["history"]]
    rfiles = {re.sub(r"\d{8}T\d{6}\.\d{3}Z", "T", f) for f in _files(tmp_path / "ref")}
    pfiles = {re.sub(r"\d{8}T\d{6}\.\d{3}Z", "T", f) for f in _files(tmp_path / "port")}
    assert pfiles == rfiles
    for pkg_res, root in ((ref, tmp_path / "ref"), (port, tmp_path / "port")):
        assert (root / "ledger.jsonl").exists()
    rr = p_ledger.load(tmp_path / "ref" / "ledger.jsonl")
    pr = p_ledger.load(tmp_path / "port" / "ledger.jsonl")
    drop = ("ts", "run", "checker_seconds", "utilization_pct", "gap_share")
    assert [{k: v for k, v in r.items() if k not in drop} for r in pr] == \
        [{k: v for k, v in r.items() if k not in drop} for r in rr]
    rres = next((tmp_path / "ref").rglob("results.edn")).read_bytes()
    pres = next((tmp_path / "port").rglob("results.edn")).read_bytes()
    assert _WALL.sub(b"T", pres) == _WALL.sub(b"T", rres)
    if telemetry:
        names = {s["name"] for s in port["telemetry-registry"].collect()}
        assert {"run_phase_seconds", "jepsen_op_latency_seconds"} <= names
        phases = {s["labels"]["phase"] for s in port["telemetry-registry"].collect()
                  if s["name"] == "run_phase_seconds"}
        assert phases == {"db.cycle", "run_case", "analyze"}


# ---------------------------------------------------------------------------
# threaded runs, cross-checked


class CrashyClient:
    """Every k-th invoke raises (interpreter_test.clj crash-recovery)."""

    @staticmethod
    def make(pkg, k=5):
        counter = [0]

        class C(pkg["client"].Client):
            def invoke(self, test, op):
                counter[0] += 1
                if counter[0] % k == 0:
                    raise RuntimeError("crunch")
                return {**op, "type": "ok"}

        return C()


def _basic_cas(pkg, n=300):
    G = pkg["gen"]
    state = pkg["wl"].AtomState()
    meta: list = []
    test = dict(pkg["wl"].noop_test())
    test.update(
        name="basic cas", concurrency=10, db=pkg["wl"].AtomDB(state),
        client=pkg["wl"].AtomClient(state, meta),
        checker=pkg["checker"].compose({"linear": _linear(pkg, "native" if pkg is REF
                                                          else "device"),
                                        "stats": pkg["checker"].stats()}),
        generator=G.phases(G.clients({"f": "read"}), G.clients(G.limit(n, G.reserve(
            5, G.repeat_({"f": "read"}),
            G.mix([lambda: {"f": "write", "value": G.rand_int(5)},
                   lambda: {"f": "cas", "value": [G.rand_int(5), G.rand_int(5)]}]))))),
        **{"no-store?": True})
    return pkg["core"].run(test), state, meta


def _convert(h, pkg):
    return pkg["History"]([pkg["Op"](o.type, o.process, o.f, o.value, time=o.time,
                                     index=o.index) for o in h], reindex=False)


@pytest.fixture(scope="module")
def basic_runs():
    return {"ref": _basic_cas(REF), "port": _basic_cas(PORT)}


@pytest.mark.parametrize("runner", ["ref", "port"])
def test_basic_cas_run_cross_checks(basic_runs, runner):
    """Each package's checker reads the other's history with the same
    verdict; the port's run has the reference's shape and lifecycle."""
    res, state, meta = basic_runs[runner]
    h = res["history"]
    assert len(h) == 2 * 301 and [o.index for o in h] == list(range(len(h)))
    assert state.get() == "done"
    counts = {k: meta.count(k) for k in set(meta)}
    assert counts == {"open": 15, "close": 15, "setup": 5, "teardown": 5}
    rh, ph = _convert(h, REF), _convert(h, PORT)
    want = _linear(REF, "native").check({}, rh, {})
    got = _linear(PORT, "device").check({}, ph, {})
    assert got["valid"] == want["valid"] is True
    assert res["results"]["linear"]["valid"] is True
    assert PORT["checker"].stats().check({}, ph, {}) == REF["checker"].stats().check({}, rh, {})
    assert [o.value for o in h if o.f == "read" and o.is_ok][0] == 0


def _interp(pkg, test):
    t = dict(pkg["wl"].noop_test())
    t.update(test)
    t.setdefault("concurrency", 4)
    return pkg["interp"].run(t)


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_interpreter_crash_becomes_info_and_process_bumps(pkg):
    h = _interp(pkg, {"client": CrashyClient.make(pkg),
                      "generator": pkg["gen"].clients(
                          pkg["gen"].limit(40, pkg["gen"].repeat_({"f": "read"})))})
    infos = [o for o in h if o["type"] == "info"]
    assert len(infos) == 8 and all("indeterminate" in str(o["error"]) for o in infos)
    done = set()
    for o in h:
        if o["type"] == "invoke":
            assert o["process"] not in done
        elif o["type"] == "info":
            done.add(o["process"])
    assert len(h) == 80 and [o["time"] for o in h] == sorted(o["time"] for o in h)
    # both packages' stats checkers read the crashed run alike
    rh = _convert(PHistory([POp.from_dict(o) for o in h]), REF)
    ph = _convert(PHistory([POp.from_dict(o) for o in h]), PORT)
    assert PORT["checker"].stats().check({}, ph, {}) == REF["checker"].stats().check({}, rh, {})


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_interpreter_sleep_log_and_exception(pkg):
    G = pkg["gen"]
    h = _interp(pkg, {"generator": G.phases(
        G.clients(G.limit(4, G.repeat_({"f": "read"}))), G.log_("hello"), G.sleep(0.01),
        G.clients(G.limit(4, G.repeat_({"f": "read"}))))})
    assert len(h) == 16 and all(o["type"] not in ("sleep", "log") for o in h)

    def boom(test, ctx):
        raise ValueError("bad gen")

    with pytest.raises(Exception, match="generator threw ValueError") as ei:
        _interp(pkg, {"generator": boom})
    assert "bad gen" in str(ei.value.__cause__)


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_interpreter_nemesis_ops_flow(pkg):
    class Recording(pkg["nemesis"].Nemesis):
        def __init__(self):
            self.ops = []

        def invoke(self, test, op):
            self.ops.append(op["f"])
            return {**op, "type": "info"}

    nem = Recording()
    G = pkg["gen"]
    h = _interp(pkg, {"nemesis": nem, "generator": G.nemesis(
        [{"type": "info", "f": "start"}, {"type": "info", "f": "stop"}],
        G.limit(6, G.repeat_({"f": "read"})))})
    assert nem.ops == ["start", "stop"]
    assert len([o for o in h if o["process"] == "nemesis"]) == 4
    assert len(h) == 16


def test_db_exception_propagates_as_itself():
    class BoomDB(p_db.DB):
        def setup(self, test, node):
            if node == test["nodes"][2]:
                raise RuntimeError("hi")

    test = dict(p_wl.noop_test())
    test.update(name="interesting exception", db=BoomDB(), **{"no-store?": True})
    with pytest.raises(RuntimeError, match="^hi$"):
        p_core.run(test)


def test_tracing_client_spans_land_in_the_store(tmp_path):
    t = _sequential_test(PORT, tmp_path, **{"telemetry?": True})
    res = p_core.run(t)
    spans = next(tmp_path.rglob("spans.jsonl")).read_text().splitlines()
    names = [__import__("json").loads(s)["name"] for s in spans]
    assert names.count("client.invoke") == 7
    assert {"client.open", "client.setup", "client.teardown", "client.close"} <= set(names)
    assert res["results"]["valid"] is True
    assert (next(tmp_path.rglob("metrics.jsonl")).read_text()
            and next(tmp_path.rglob("metrics.prom")).read_text())


# ---------------------------------------------------------------------------
# the options the port refused while it lacked web.py and the profile layer


@pytest.mark.parametrize("opt,artifact", [({"live-port": 0}, None),
                                          ({"profile?": True}, "profile.json")])
def test_unported_options_raise_before_the_run(tmp_path, opt, artifact):
    """``live-port`` and ``profile?`` were refused with ``ValueError``
    before the run started; both now run, in ``core.run`` and in a
    standalone ``core.analyze``, and leave what the reference leaves."""
    t = _sequential_test(PORT, tmp_path, **{"telemetry?": True, **opt})
    res = p_core.run(t)
    assert res["results"]["valid"] is True
    run_dir = p_store.path(res)
    if artifact is not None:
        assert (run_dir / artifact).exists()
        assert (run_dir / "profile_trace" / "trace.json").exists()
        (run_dir / artifact).unlink()
    out = p_core.analyze({**t, "history": res["history"], "start-time": res["start-time"]})
    assert out["results"]["valid"] is True
    assert (run_dir / "profile.json").exists() is (artifact is not None)


def test_no_card_without_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_checker.linearizable(model=PCas(init=0))
    t = _sequential_test(PORT, "unused", **{"no-store?": True, "online?": True,
                                            "online-engine": "device"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_core.run(t)
    assert not any(th.name == "jepsen-online-scheduler" for th in threading.enumerate())


def test_device_error_in_the_analysis_is_no_host_verdict(monkeypatch, tmp_path):
    from jepsen_tpu_torch.ops import wgl

    def broken(*a, **k):
        raise ValueError("plan refused")

    monkeypatch.setattr(wgl, "check_encoded_device", broken)
    t = _sequential_test(PORT, tmp_path)
    t["checker"] = p_checker.compose({"linear": _linear(PORT, "device")})
    res = p_core.run(t)
    assert res["results"]["valid"] == "unknown"
    assert "plan refused" in res["results"]["linear"]["error"]


def test_device_error_in_the_monitor_raises(monkeypatch, tmp_path):
    from jepsen_tpu_torch.online import scheduler as sched_mod

    def broken(self, encs):
        raise ValueError("plan refused")

    monkeypatch.setattr(sched_mod.SegmentScheduler, "_decide_device", broken)
    # an open tail: the last write never completes, so the terminal
    # segment goes to the device oracle
    t = _sequential_test(PORT, tmp_path, **{"online?": True, "online-engine": "device",
                                            "device": "cpu"})

    class Hangs(p_client.Client):
        def __init__(self, inner):
            self.inner = inner

        def invoke(self, test, op):
            if op["f"] == "write" and op["value"] == 4:
                raise RuntimeError("lost")
            return self.inner.invoke(test, op)

    t["client"] = Hangs(t["client"])
    with pytest.raises(ValueError, match="plan refused"):
        p_core.run(t)
    online = next(tmp_path.rglob("online.json")).read_text()
    assert '"valid": "unknown"' in online
    assert not any(th.name == "jepsen-online-scheduler" for th in threading.enumerate())
