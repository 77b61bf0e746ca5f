"""The port's crash-safe verdict journal (``jepsen_tpu_torch.service.
journal``) against the reference's.

Both packages' services journal the same paced tenant streams: the files
must be equal byte for byte (the journal holds no wall-clock field). A
journal written by either package replays in the other to the same
watermark, fold counters, violation witness and carries, a service
restarted on the other package's journal directory resumes from the same
watermark and ends with the same verdict, and a release by one package is
adopted by the other. Torn final lines, a foreign file and a journal of
another model family are typed the same way by both."""

from __future__ import annotations

import random
import time

import pytest
import torch

from jepsen_tpu import independent as r_ind
from jepsen_tpu import service as r_service
from jepsen_tpu import testing as r_testing
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.models import CasRegister as RCas
from jepsen_tpu.models import Mutex as RMutex
from jepsen_tpu.ops import wgl as r_wgl
from jepsen_tpu.service import journal as r_journal
from jepsen_tpu_torch import independent as p_ind
from jepsen_tpu_torch import service as p_service
from jepsen_tpu_torch import testing as p_testing
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.models import Mutex as PMutex
from jepsen_tpu_torch.service import journal as p_journal

REF = dict(service=r_service, journal=r_journal, testing=r_testing, Cas=RCas, Mutex=RMutex,
           History=RHistory, ind=r_ind)
PORT = dict(service=p_service, journal=p_journal, testing=p_testing, Cas=PCas, Mutex=PMutex,
            History=PHistory, ind=p_ind)
PKGS = {"ref": REF, "port": PORT}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk(pkg, journal_dir, **kw):
    kw.setdefault("engine", "host")
    kw.setdefault("register_live", False)
    kw.setdefault("ledger", False)
    if pkg is PORT:
        kw.setdefault("device", "cpu")
    return pkg["service"].Service(pkg["Cas"](init=0), journal_dir=str(journal_dir), **kw)


def crash(svc):
    """Abandon a service as a crash would: no drain, no terminal fold."""
    svc._pump_stop.set()
    svc.scheduler.close(timeout=10)


def history(pkg, kind, seed):
    T = pkg["testing"]
    h = T.chunked_register_history(random.Random(seed), n_ops=300, n_procs=2, chunk_ops=30)
    if kind == "invalid":
        return T.perturb_history(random.Random(5), h, within=0.5)
    if kind == "keyed":
        rng = random.Random(seed)
        ops = []
        for i, k in enumerate(("a", "b")):
            for op in T.chunked_register_history(rng, n_ops=80, n_procs=2, chunk_ops=40):
                ops.append(op.with_(value=pkg["ind"].KV(k, op.value),
                                    process=op.process + 10 * i))
        ops.sort(key=lambda o: o.time)
        return pkg["History"](ops, reindex=True)
    return h


def paced(svc, tenant, ops, aborted_error):
    """Submit op by op, each decided before the next: the journal's record
    order is then the segment order, in either package."""
    for op in ops:
        try:
            svc.submit(tenant, op)
        except aborted_error:
            return
        deadline = time.monotonic() + 30
        while True:
            snap = svc.tenant_snapshot(tenant)
            if (snap["ops_observed"] == snap["ops_ingested"]
                    and svc.scheduler.stream_backlog(tenant) == 0):
                break
            assert time.monotonic() < deadline
            time.sleep(0.0005)


def journal_of(pkg, tmp_path, kind, seed, n_feed=None, drain=False):
    d = tmp_path / f"{kind}-{'ref' if pkg is REF else 'port'}"
    svc = mk(pkg, d, abort_on_violation=True)
    ops = list(history(pkg, kind, seed))
    paced(svc, "t/1", ops[:n_feed], pkg["service"].TenantAbortedError)
    assert svc.flush(30.0)
    snap = svc.tenant_snapshot("t/1")
    if drain:
        svc.drain(timeout=30)
    else:
        crash(svc)
    return d, pkg["journal"].tenant_path(str(d), "t/1"), snap, ops


def _comparable(rep):
    """A replay dict without the package's own objects: carries as
    key -> sorted state lists."""
    out = dict(rep)
    out["carry"] = {str(k): (v if isinstance(v, str) else sorted(map(list, v)))
                    for k, v in (rep.get("carry") or {}).items()}
    return out


@pytest.mark.parametrize("drain", [False, True])
@pytest.mark.parametrize("kind", ["valid", "invalid", "keyed"])
def test_journal_bytes_and_replays_match_reference(tmp_path, kind, drain):
    files, reps = {}, {}
    for name, P in PKGS.items():
        _d, path, _snap, _ops = journal_of(P, tmp_path, kind, 12, drain=drain)
        files[name] = open(path, "rb").read()
    assert files["port"] == files["ref"]
    for src in PKGS:  # each package's file through each package's replay
        path = tmp_path / f"{src}.jsonl"
        path.write_bytes(files[src])
        for name, P in PKGS.items():
            reps[(src, name)] = _comparable(P["journal"].replay(str(path), P["Cas"](init=0)))
    first = reps[("ref", "ref")]
    assert all(r == first for r in reps.values())
    assert first["records"] > 0 and first["watermark"] >= 0
    if kind == "invalid":
        assert first["violation"] is not None and first["n_invalid"] >= 1
    if kind == "keyed":
        assert set(first["carry"]) >= {"a", "b"} or drain


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_restart_on_the_other_packages_journal(tmp_path, writer, reader):
    """Crash one package's service half way; the other package restarts on
    its journal directory, resumes from the journaled watermark and ends
    with the single search's verdict (the covered boundary op resent and
    dropped)."""
    W, R = PKGS[writer], PKGS[reader]
    d, _path, before, ops = journal_of(W, tmp_path, "valid", 21, n_feed=150)
    svc = mk(R, d)
    snap = svc.tenant_snapshot("t/1")
    assert snap["resumed_from_journal"]["watermark"] == before["watermark"] >= 0
    assert snap["watermark"] == before["watermark"]
    assert snap["verdict"] == "True"
    rops = list(history(R, "valid", 21))
    start = next(k for k, op in enumerate(rops) if op.index >= snap["watermark"])
    for op in rops[start:]:
        svc.submit("t/1", op)
    fin = svc.drain(timeout=60)
    row = fin["tenants"]["t/1"]
    want = r_wgl.check_history(RCas(init=0), history(REF, "valid", 21), backend="host")
    assert row["valid"] is want["valid"] is True
    assert row["decided_through_index"] == ops[-1].index
    assert row["resubmitted_ops_dropped"] >= 1
    assert row["resumed_from_journal"]["records"] > 0


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_invalid_and_abort_survive_a_cross_package_restart(tmp_path, writer, reader):
    W, R = PKGS[writer], PKGS[reader]
    d, _path, before, _ops = journal_of(W, tmp_path, "invalid", 12)
    assert before["aborted"] is True
    svc = mk(R, d, abort_on_violation=True)
    snap = svc.tenant_snapshot("t/1")
    assert snap["verdict"] == "False" and snap["aborted"] is True
    with pytest.raises(R["service"].TenantAbortedError):
        svc.submit("t/1", {"type": "invoke", "process": 0, "f": "read", "value": None,
                           "time": 10 ** 12})
    fin = svc.drain(timeout=30)
    assert fin["tenants"]["t/1"]["valid"] is False
    assert fin["tenants"]["t/1"]["violation"]["segment"]["start_index"] == \
        before.get("violation", fin["tenants"]["t/1"]["violation"])["segment"]["start_index"]


@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref")])
def test_release_adopt_across_packages(tmp_path, src, dst):
    """One package releases a tenant (its journal is the checkpoint), the
    other adopts it: the watermark is kept and the verdict completes."""
    S, D = PKGS[src], PKGS[dst]
    a = mk(S, tmp_path / "a")
    ops = list(history(S, "valid", 31))
    for op in ops[:150]:
        a.submit("t", op)
    assert a.flush(30.0)
    doc = a.release("t", timeout=30)
    b = mk(D, tmp_path / "b")
    adopted = b.adopt("t", doc["journal"])
    assert adopted["watermark"] == doc["watermark"] >= 0 and adopted["fresh"] is False
    with pytest.raises(S["service"].TenantMigratedError):
        a.submit("t", ops[150])
    a.drain(timeout=10)
    dops = list(history(D, "valid", 31))
    start = next(k for k, op in enumerate(dops) if op.index >= doc["watermark"])
    for op in dops[start:]:
        b.submit("t", op)
    fin = b.drain(timeout=60)
    assert fin["tenants"]["t"]["valid"] is True
    assert fin["tenants"]["t"]["decided_through_index"] == ops[-1].index


@pytest.mark.parametrize("cut", ["half_line", "no_newline", "garbage"])
def test_torn_tails_replay_as_the_reference(tmp_path, cut):
    _d, path, _snap, _ops = journal_of(REF, tmp_path, "valid", 41, n_feed=200)
    data = open(path, "rb").read()
    lines = data.splitlines(keepends=True)
    if cut == "half_line":
        torn = b"".join(lines[:-1]) + lines[-1][:len(lines[-1]) // 2]
    elif cut == "no_newline":
        torn = data[:-1]  # parseable, but the newline never landed
    else:
        torn = data + b"\xff\xfe{not json\n"
    p = tmp_path / "torn.jsonl"
    p.write_bytes(torn)
    reps = [_comparable(P["journal"].replay(str(p), P["Cas"](init=0))) for P in (REF, PORT)]
    assert reps[0] == reps[1]
    assert reps[1]["torn_tail"] is True
    assert reps[1]["consistent_bytes"] < len(torn)
    # A service reopening the torn file trims it to the consistent prefix.
    svc = mk(PORT, tmp_path / "reopen")
    svc.drain(timeout=10)
    (tmp_path / "re").mkdir()
    (tmp_path / "re" / "t%2F1.jsonl").write_bytes(torn)
    svc = mk(PORT, tmp_path / "re")
    assert svc.tenant_snapshot("t/1")["resumed_from_journal"]["torn_tail"] is True
    crash(svc)
    assert (tmp_path / "re" / "t%2F1.jsonl").stat().st_size == reps[1]["consistent_bytes"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_other_model_family_is_refused_typed(tmp_path, writer):
    _d, path, _snap, _ops = journal_of(PKGS[writer], tmp_path, "valid", 51, n_feed=60)
    for P in (REF, PORT):
        with pytest.raises(P["journal"].JournalModelMismatchError):
            P["journal"].replay(path, P["Mutex"]())
    d = tmp_path / "mutex"
    d.mkdir()
    (d / "t.jsonl").write_bytes(open(path, "rb").read())
    with pytest.raises(p_journal.JournalModelMismatchError):
        p_service.Service(PMutex(), journal_dir=str(d), engine="host", device="cpu",
                          register_live=False, ledger=False)


def test_foreign_file_and_empty_header(tmp_path):
    p = tmp_path / "x.jsonl"
    p.write_text('{"kind": "segment", "seq": 0}\n')
    for P in (REF, PORT):
        with pytest.raises(P["journal"].JournalError):
            P["journal"].replay(str(p), P["Cas"](init=0))
    p.write_text('{"kind": "head')
    reps = [P["journal"].replay(str(p), P["Cas"](init=0)) for P in (REF, PORT)]
    assert reps[0] == reps[1] and reps[1]["fresh"] is True


def test_model_identity_and_codec_match_reference():
    for m in ((RCas(init=0), PCas(init=0)), (RMutex(), PMutex())):
        assert p_journal.model_identity(m[1]) == r_journal.model_identity(m[0])
    for v in [(1, (2, 3)), ((), None), ("a", 1.5, True)]:
        assert p_journal._thaw(p_journal._jsonable(v)) == v
        assert p_journal._jsonable(v) == r_journal._jsonable(v)
    for bad in ([1], {1}, object()):
        with pytest.raises(TypeError):
            p_journal._jsonable(bad)
    for t in ("t/1", "a b", "ü"):
        assert p_journal.tenant_path("/j", t) == r_journal.tenant_path("/j", t)
