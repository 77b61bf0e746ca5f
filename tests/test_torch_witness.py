"""The files the port's checkers write into a test's store, against the
JAX reference's: the ``linearizable`` checker's ``linear.txt`` and
``linear.svg`` (a history refuted by the host oracle and one refuted by
the device search, with and without a ``subdirectory``), the append and
wr workload checkers' ``elle/<anomaly>.txt`` explanation files, the keyed
checker's ``independent/<k>/`` trees, ``timeline.html``, and what an
unwritable store leaves in the result (``witness_error``,
``directory_error``, the verdict unchanged). The port runs with
``device="cpu"``; the reference's keyed batch runs on one device."""

import random
import re
from pathlib import Path

import jax
import pytest

from jepsen_tpu import checker as r_checker
from jepsen_tpu import independent as r_ind
from jepsen_tpu.checker import timeline as r_timeline
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.history import Op as ROp
from jepsen_tpu.models import CasRegister as RCas
from jepsen_tpu.testing import perturb_history as r_perturb
from jepsen_tpu.testing import random_register_history as r_random
from jepsen_tpu.workloads import append as r_wl_append
from jepsen_tpu.workloads import wr as r_wl_wr
from jepsen_tpu_torch import checker as p_checker
from jepsen_tpu_torch import independent as p_ind
from jepsen_tpu_torch.checker import timeline as p_timeline
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import Op as POp
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.testing import lagged_append_history, lagged_wr_history
from jepsen_tpu_torch.testing import perturb_history as p_perturb
from jepsen_tpu_torch.testing import random_register_history as p_random
from jepsen_tpu_torch.workloads import append as p_wl_append
from jepsen_tpu_torch.workloads import wr as p_wl_wr

START = "20260731T000000.000Z"


@pytest.fixture
def one_device(monkeypatch):
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])


def _tests(tmp_path, name="witness"):
    """The same stored test map for each package, each with its own root."""
    return ({"name": name, "start-time": START, "store-root": str(tmp_path / "ref")},
            {"name": name, "start-time": START, "store-root": str(tmp_path / "port")})


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _refuted(seed=5, n_ops=30):
    r1, r2 = random.Random(seed), random.Random(seed)
    ref = r_perturb(r1, r_random(r1, n_ops=n_ops, n_procs=3, crash_p=0.0))
    port = p_perturb(r2, p_random(r2, n_ops=n_ops, n_procs=3, crash_p=0.0))
    return ref, port


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("sub", [None, "linear"])
def test_linear_witness_files_match(tmp_path, backend, sub):
    rh, ph = _refuted()
    rt, pt = _tests(tmp_path)
    opts = {"subdirectory": sub} if sub else {}
    want = r_checker.linearizable(model=RCas(init=0), backend=backend).check(rt, rh, opts)
    got = p_checker.linearizable(model=PCas(init=0), backend=backend, device="cpu").check(
        pt, ph, opts)
    assert got["valid"] is want["valid"] is False
    assert got["witness_files"] == want["witness_files"]
    assert "witness_error" not in got and "witness_error" not in want
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert port == ref
    run = f"witness/{START}/" + (f"{sub}/" if sub else "")
    assert sorted(port) == sorted(run + f for f in got["witness_files"])
    assert port[run + "linear.txt"].startswith(b"Linearizability refuted.")


@pytest.mark.parametrize("seed", [5, 9, 11])
def test_device_and_host_witnesses_name_the_same_configuration(tmp_path, seed):
    """The device search's ``linear.txt`` and the host oracle's name the
    same deepest configuration (state, ops linearized) and the same
    pending ops; only the device search says why each is stuck."""
    _, ph = _refuted(seed=seed)
    texts = {}
    for backend in ("device", "host"):
        t = {"name": "w", "start-time": START, "store-root": str(tmp_path / backend)}
        res = p_checker.linearizable(model=PCas(init=0), backend=backend,
                                     device="cpu").check(t, ph, {})
        assert res["valid"] is False and res["witness_files"][0] == "linear.txt"
        texts[backend] = (tmp_path / backend / "w" / START / "linear.txt").read_text()
    configs = {b: [ln for ln in t.splitlines() if ln.startswith("config")]
               for b, t in texts.items()}
    assert configs["device"] == configs["host"] and configs["host"]
    pending = {b: re.findall(r"(?:cannot linearize|pending:) (.*)", t) for b, t in texts.items()}
    assert pending["device"] == pending["host"] and pending["host"]
    assert "because: model rejects" in texts["device"]


def test_valid_history_writes_no_witness(tmp_path):
    h = p_random(random.Random(3), n_ops=20, n_procs=3, crash_p=0.0)
    _, pt = _tests(tmp_path)
    res = p_checker.linearizable(model=PCas(init=0), device="cpu").check(pt, h, {})
    assert res["valid"] is True and "witness_files" not in res
    assert not (tmp_path / "port").exists()


def _to_ref(h):
    return RHistory([ROp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                     for o in h], reindex=False)


@pytest.mark.parametrize("workload,opts,sub", [
    ("append", {}, None),
    ("append", {}, "elle-sub"),
    ("wr", {"wfr_keys": True}, None),
])
def test_elle_explanation_files_match(tmp_path, workload, opts, sub):
    make = lagged_append_history if workload == "append" else lagged_wr_history
    h = make(3, 120, (10, 60), depth=8)
    r_wl, p_wl = (r_wl_append, p_wl_append) if workload == "append" else (r_wl_wr, p_wl_wr)
    rt, pt = _tests(tmp_path, workload)
    copts = {"subdirectory": sub} if sub else {}
    want = r_wl.checker(dict(opts)).check(rt, _to_ref(h), copts)
    got = p_wl.checker(dict(opts, torch_device="cpu")).check(pt, h, copts)
    assert got["valid"] is want["valid"] is False
    rel = lambda d, root: str(Path(d).relative_to(root))  # noqa: E731
    assert rel(got["directory"], tmp_path / "port") == rel(want["directory"], tmp_path / "ref")
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert port == ref
    names = sorted(Path(p).name for p in port)
    assert names == sorted(f"{a}.txt" for a in got["anomalies"])
    assert {k: v for k, v in got.items() if k != "directory"} == \
        {k: v for k, v in want.items() if k != "directory"}


def test_clean_elle_result_writes_nothing(tmp_path):
    h = lagged_append_history(3, 120, None)
    _, pt = _tests(tmp_path)
    res = p_wl_append.checker({"torch_device": "cpu"}).check(pt, h, {})
    assert res["valid"] is True and "directory" not in res
    assert not (tmp_path / "port").exists()


def _keyed(n_keys=3, seed=21):
    r1, r2 = random.Random(seed), random.Random(seed)
    o1, o2 = [], []
    for k in range(n_keys):
        a = r_random(r1, n_ops=12, n_procs=2, crash_p=0.0)
        b = p_random(r2, n_ops=12, n_procs=2, crash_p=0.0)
        if k == 1:
            a, b = r_perturb(r1, a), p_perturb(r2, b)
        o1 += [o.with_(value=r_ind.KV(k, o.value), index=len(o1) + i) for i, o in enumerate(a)]
        o2 += [o.with_(value=p_ind.KV(k, o.value), index=len(o2) + i) for i, o in enumerate(b)]
    return RHistory(o1, reindex=False), PHistory(o2, reindex=False)


def _no_walls(b: bytes) -> bytes:
    return re.sub(rb":wall_s -?[0-9.e+-]+", b":wall_s W", b)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_independent_store_trees_match(tmp_path, one_device, backend):
    rh, ph = _keyed()
    rt, pt = _tests(tmp_path, "keyed")
    want = r_ind.checker(r_checker.linearizable(model=RCas(init=0), backend=backend)).check(
        rt, rh, {})
    got = p_ind.checker(p_checker.linearizable(model=PCas(init=0), backend=backend,
                                               device="cpu")).check(pt, ph, {})
    assert got["valid"] is want["valid"] is False and got["failures"] == want["failures"] == [1]
    ref, port = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(port) == sorted(ref)
    per_key = sorted(p for p in port if "/independent/" in p)
    assert [p.split("/independent/")[1] for p in per_key] == \
        [f"{k}/{f}" for k in range(3) for f in ("history.edn", "results.edn")]
    for p in port:
        assert _no_walls(port[p]) == _no_walls(ref[p]), p


def _timed_history(History, Op):
    ops = [Op("invoke", 0, "write", 1, time=1_000), Op("invoke", 1, "read", None, time=2_000),
           Op("ok", 0, "write", 1, time=5_000_000), Op("info", "nemesis", "start", None,
                                                          time=6_000_000),
           Op("ok", 1, "read", 1, time=9_000_000), Op("invoke", 2, "cas", [1, 2], time=9_500_000),
           Op("info", 2, "cas", [1, 2], time=20_000_000),
           Op("invoke", 0, "read", None, time=21_000_000),
           Op("fail", 0, "read", None, time=22_000_000)]
    return History(ops)


@pytest.mark.parametrize("sub", [None, "tl"])
def test_timeline_html_matches(tmp_path, sub):
    rt, pt = _tests(tmp_path, "timeline")
    opts = {"subdirectory": sub} if sub else {}
    want = r_timeline.html().check(rt, _timed_history(RHistory, ROp), opts)
    got = p_timeline.html().check(pt, _timed_history(PHistory, POp), opts)
    assert got["valid"] is want["valid"] is True
    assert Path(got["file"]).relative_to(tmp_path / "port") == \
        Path(want["file"]).relative_to(tmp_path / "ref")
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert p_timeline.render(_timed_history(PHistory, POp)) == \
        r_timeline.render(_timed_history(RHistory, ROp))
    assert p_timeline.html().check({"no-store?": True}, _timed_history(PHistory, POp),
                                   {}) == {"valid": True}


def test_unwritable_store_keeps_the_verdict(tmp_path):
    """A store root that is a file: the witness and explanation writes fail,
    the failure is recorded, and the verdict stands, in both packages."""
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    test = {"name": "x", "start-time": START, "store-root": str(blocker)}
    rh, ph = _refuted()
    want = r_checker.linearizable(model=RCas(init=0), backend="host").check(dict(test), rh, {})
    got = p_checker.linearizable(model=PCas(init=0), backend="host").check(dict(test), ph, {})
    assert got["valid"] is want["valid"] is False
    assert got["witness_error"].split(":")[0] == want["witness_error"].split(":")[0]
    assert "witness_files" not in got
    h = lagged_append_history(3, 120, (10, 60), depth=8)
    want = r_wl_append.checker().check(dict(test), _to_ref(h), {})
    got = p_wl_append.checker({"torch_device": "cpu"}).check(dict(test), h, {})
    assert got["valid"] is want["valid"] is False
    assert got["directory_error"].split(":")[0] == want["directory_error"].split(":")[0]
    assert "directory" not in got and blocker.read_text() == "not a directory"
