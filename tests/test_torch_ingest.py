"""The port's trace ingestion (``jepsen_tpu_torch.ingest``) against the
reference's (``jepsen_tpu.ingest``).

The same raw trace lines go through both packages: the golden recordings
of ``tests/golden/traces`` (etcd, redis, zookeeper, mongodb, generic
jsonl) as they are, seeded invalid and truncated (as the reference's
``tests/test_ingest.py`` builds them), and nemesis-matrix cells whose
traces the reference's ``generator.sim`` and ``nemesis`` modules draw.
Both must give the same op stream, op for op, and the same whole result
map (verdict, workload, ``unmapped``, causes, provenance and the checker's
own map, without its wall times); the port's segmented oracle and Elle
engine run their plain PyTorch versions on the CPU (``device="cpu"``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu import generator as gen
from jepsen_tpu import independent as ref_ind
from jepsen_tpu import ingest as ref_ingest
from jepsen_tpu import nemesis as nem
from jepsen_tpu.generator import sim
from jepsen_tpu.ingest import adapters as ref_ad
from jepsen_tpu.ingest import mapper as ref_mapper
from jepsen_tpu.nemesis.partition import SimNet, partitioned_completions
from jepsen_tpu.nemesis.reorder import DeliveryReorder, reordered_completions
from jepsen_tpu.nemesis.time import SimClockSkew, skewed_completions
from jepsen_tpu.online.segmenter import NonMonotoneHistoryError as RefNonMonotone
from jepsen_tpu.parallel import resilience as ref_resilience
from jepsen_tpu.telemetry import Registry as RefRegistry
from jepsen_tpu.testing import chaos as ref_chaos
from jepsen_tpu_torch import independent as ind
from jepsen_tpu_torch import ingest
from jepsen_tpu_torch.checker import provenance as prov
from jepsen_tpu_torch.ingest import adapters as ad
from jepsen_tpu_torch.ingest import mapper
from jepsen_tpu_torch.ingest.__main__ import EXIT_ERROR, main
from jepsen_tpu_torch.online.segmenter import NonMonotoneHistoryError
from jepsen_tpu_torch.parallel import resilience
from jepsen_tpu_torch.telemetry import Registry
from jepsen_tpu_torch.testing import chaos

pytestmark = pytest.mark.ingest

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "traces"
FIXTURES = {"etcd": "etcd.ndjson", "redis": "redis.txt", "zookeeper": "zookeeper.txt",
            "mongodb": "mongodb.ndjson", "jsonl": "generic.jsonl"}
_WALLS = {"wall_s", "decide_s", "busy_pct", "plan_seconds", "utilization"}


@pytest.fixture(autouse=True)
def _one_thread_and_clean_state():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (resilience, ref_resilience):
        mod.reset_breakers()
    for mod in (chaos, ref_chaos):
        mod.reset()
    yield
    torch.set_num_threads(n)
    for mod in (chaos, ref_chaos):
        mod.reset()


def golden(adapter):
    return (GOLDEN / FIXTURES[adapter]).read_text().splitlines()


def norm(x):
    """A result map without its wall times, either package's ``[k v]`` as a
    tagged tuple."""
    if isinstance(x, (ind.KV, ref_ind.KV)):
        return ("KV", norm(x[0]), norm(x[1]))
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items() if k not in _WALLS}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def both(lines, adapter, **kw):
    """The same lines through both packages' ``ingest_check``."""
    ref = ref_ingest.ingest_check(list(lines), adapter, **kw)
    port = ingest.ingest_check(list(lines), adapter, device="cpu", **kw)
    assert norm(port) == norm(ref)
    return port


def causes_of(result):
    return {c["code"] for c in result.get("causes", [])}


def assert_typed(result):
    codes = causes_of(result)
    assert codes <= set(prov.TAXONOMY) and "unattributed" not in codes


# The reference test's seeded-invalid and truncated variants.
def seed_invalid(adapter, lines):
    if adapter == "etcd":
        lines[-1] = lines[-1].replace('"value": 7', '"value": 999')
    elif adapter == "redis":
        lines[-1] = lines[-1].replace('"1"', '"7"')
    elif adapter == "zookeeper":
        lines[-1] = lines[-1].replace("version:1", "version:5")
    elif adapter == "mongodb":
        lines[3] = lines[3].replace('"value": 6', '"value": 999')
    else:
        lines[:] = [json.dumps({"time": 1000, "f": "txn",
                                "value": [["append", "x", 1], ["r", "y", [1]]]}),
                    json.dumps({"time": 2000, "f": "txn",
                                "value": [["append", "y", 1], ["r", "x", [1]]]})]
    return lines


def truncate(adapter, lines):
    if adapter == "etcd":
        del lines[14]
    elif adapter == "redis":
        del lines[8]
    else:
        lines[-1] = lines[-1][:len(lines[-1]) // 2]
    return lines


VARIANTS = {"valid": lambda a, ls: ls, "invalid": seed_invalid, "truncated": truncate}
EXPECT = {"valid": True, "invalid": False, "truncated": "unknown"}


# ---------------------------------------------------------------------------
# Golden recordings: the same ops, the same result maps


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("adapter", sorted(FIXTURES))
def test_golden_ops_match_reference(adapter, variant):
    lines = VARIANTS[variant](adapter, golden(adapter))
    ref = ref_ad.parse_trace(lines, ref_ad.by_name(adapter))
    port = ad.parse_trace(lines, ad.by_name(adapter))
    assert norm(port) == norm(ref)
    assert [o["index"] for o in port["ops"]] == list(range(len(port["ops"])))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("adapter", sorted(FIXTURES))
def test_golden_verdicts_match_reference(adapter, variant):
    res = both(VARIANTS[variant](adapter, golden(adapter)), adapter)
    assert res["valid"] == EXPECT[variant]
    assert_typed(res)
    if variant == "truncated":
        assert res["unmapped"] >= 1 and causes_of(res) == {"ingest_unmapped_op"}
        assert res["provenance"]["causes"]["ingest_unmapped_op"] == res["unmapped"]
    else:
        assert res["unmapped"] == 0


@pytest.mark.parametrize("check", ["segmented", "elle"])
def test_forced_checks_match_reference(check):
    """A register recording forced through either path (the Elle lift
    drops the cas ops, counted unmapped)."""
    res = both(golden("etcd"), "etcd", check=check)
    assert res["check"] == check
    if check == "elle":
        assert res["workload"] == "wr" and res["valid"] == "unknown"


def test_unmapped_never_flips_an_invalid():
    lines = seed_invalid("etcd", golden("etcd")) + ["%%% torn %%%"]
    res = both(lines, "etcd")
    assert res["valid"] == "unknown" and "ingest_unmapped_op" in causes_of(res)


def test_adapter_units_match_reference():
    cases = [
        ("etcd", [json.dumps({"ts": 1, "conn": "c1", "id": 1, "phase": "request",
                              "op": "put", "key": "k", "value": 1}),
                  json.dumps({"ts": 2, "conn": "c1", "id": 2, "phase": "request",
                              "op": "put", "key": "k", "value": 2}),
                  json.dumps({"ts": 3, "conn": "c1", "id": 1, "phase": "response",
                              "ok": True}),
                  json.dumps({"ts": 4, "conn": "c1", "id": 2, "phase": "response",
                              "ok": True})], {}),
        ("jsonl", [json.dumps({"t": 5, "verb": "write", "k": "a", "v": 3})],
         {"columns": {"time": "t", "f": "verb", "key": "k", "value": "v"}}),
        ("etcd", golden("etcd")[:-1], {}),
        ("etcd", golden("etcd") + ["%%% not a trace line %%%"], {}),
    ]
    for adapter, lines, opts in cases:
        ref = ref_ad.parse_trace(lines, ref_ad.by_name(adapter, **opts))
        port = ad.parse_trace(lines, ad.by_name(adapter, **opts))
        assert norm(port) == norm(ref)
    with pytest.raises(KeyError, match="unknown adapter"):
        ad.by_name("oracle-v7")
    assert sorted(ad.ADAPTERS) == sorted(ref_ad.ADAPTERS)
    assert ad.ZK_DELETED == ref_ad.ZK_DELETED
    assert ad.DEFAULT_REORDER_WINDOW_NS == ref_ad.DEFAULT_REORDER_WINDOW_NS


# ---------------------------------------------------------------------------
# Classification and the reorder window


def test_classify_matches_reference():
    cases = [([{"f": "txn", "value": [["append", 0, 1]]}], None),
             ([{"f": "txn", "value": [["w", 0, 1]]}], None),
             ([{"f": "transfer"}], None), ([{"f": "add"}, {"f": "remove"}], None),
             ([{"f": "add"}, {"f": "read"}], None), ([{"f": "write"}, {"f": "read"}], None),
             ([{"f": "read"}], "set"), ([{"f": "write"}], "counter"), ([], "bank"),
             ([{"f": "cas"}, {"f": None}], "register")]
    for ops, hint in cases:
        assert mapper.classify(ops, hint) == ref_mapper.classify(ops, hint)
    assert {k: (v[0], v[2]) for k, v in mapper.WORKLOADS.items()} == \
        {k: (v[0], v[2]) for k, v in ref_mapper.WORKLOADS.items()}


@pytest.mark.parametrize("ingested, match", [
    ({"ops": [{"type": "invoke", "f": "transfer", "process": 0, "value": None, "time": 0,
               "index": 0}], "unmapped": 0, "adapter": "jsonl"}, "model_init"),
    ({"ops": [{"f": "txn", "value": [["append", 0, 1]], "type": "ok", "process": 0,
               "time": 0, "index": 0}], "unmapped": 0, "adapter": "jsonl"}, "elle"),
])
def test_refusals_match_reference(ingested, match):
    with pytest.raises(ValueError, match=match):
        ref_mapper.check_ingested(ingested, check="segmented")
    with pytest.raises(ValueError, match=match):
        mapper.check_ingested(ingested, check="segmented", device="cpu")
    with pytest.raises(ValueError, match="unknown check"):
        mapper.check_ingested(ingested, check="bogus", device="cpu")


def bank_lines(reads):
    lines = [json.dumps({"time": 1, "phase": "request", "corr": 1, "conn": "a",
                         "f": "transfer", "value": {"from": "x", "to": "y", "amount": 2}}),
             json.dumps({"time": 2, "phase": "response", "corr": 1, "conn": "a",
                         "f": "transfer", "ok": True})]
    for i, read in enumerate(reads):
        lines += [json.dumps({"time": 3 + 2 * i, "phase": "request", "corr": 2 + i,
                              "conn": "b", "f": "read"}),
                  json.dumps({"time": 4 + 2 * i, "phase": "response", "corr": 2 + i,
                              "conn": "b", "f": "read", "ok": True, "value": read})]
    return lines


@pytest.mark.parametrize("reads, valid", [([{"x": 8}, {"y": 12}], True),
                                          ([{"x": 8}, {"y": 11}], False),
                                          ([{"x": 8, "y": 12}], "unknown")])
def test_bank_recording_with_model_init(reads, valid):
    """A bank recording needs the account map; the bank model's encoding
    takes single-account reads, and a snapshot read fails its round in
    both packages (typed ``round_failed``)."""
    res = both(bank_lines(reads), "jsonl", model_init={"x": 10, "y": 10})
    assert res["workload"] == "bank" and res["valid"] == valid
    assert_typed(res)


def events(ts):
    return [{"phase": "apply", "corr": None, "conn": "0", "f": "write", "value": i,
             "time": t, "ok": None, "hint": None} for i, t in enumerate(ts)]


def test_reorder_window_repairs_and_raises_as_the_reference():
    assert ad.repair_order(events([100, 300, 200]), 500) == \
        ref_ad.repair_order(events([100, 300, 200]), 500)
    with pytest.raises(RefNonMonotone):
        ref_ad.repair_order(events([100, 5000, 200]), 500)
    with pytest.raises(NonMonotoneHistoryError) as got:
        ad.repair_order(events([100, 5000, 200]), 500)
    assert (got.value.index, got.value.floor) == (2, 4500)
    lines = [json.dumps({"time": 5000, "f": "write", "key": "k", "value": 1}),
             json.dumps({"time": 100, "f": "write", "key": "k", "value": 2})]
    with pytest.raises(NonMonotoneHistoryError):
        ingest.ingest_check(lines, "jsonl", reorder_window_ns=500, device="cpu")
    res = both(lines, "jsonl", reorder_window_ns=10_000)
    assert res["valid"] is True
    ops, stats = ad.events_to_ops(events([100, 300, 200]), reorder_window_ns=500)
    rops, rstats = ref_ad.events_to_ops(events([100, 300, 200]), reorder_window_ns=500)
    assert (ops, stats) == (rops, rstats)


# ---------------------------------------------------------------------------
# The chaos seam and the metrics


def test_parse_seam_degrades_as_the_reference():
    with ref_chaos.inject("ingest.parse", "raise", on_call=3):
        ref = ref_ingest.ingest_check(golden("etcd"), "etcd")
    with chaos.inject("ingest.parse", "raise", on_call=3):
        port = ingest.ingest_check(golden("etcd"), "etcd", device="cpu")
    assert chaos.fired("ingest.parse") == 1
    assert norm(port) == norm(ref)
    assert port["unmapped"] == 2 and port["valid"] == "unknown"
    assert causes_of(port) <= chaos.EXPECTED_UNKNOWN_CAUSES["ingest.parse"]
    assert_typed(port)
    with chaos.inject("ingest.parse", "delay", delay_s=0.001, times=3):
        res = ingest.ingest_check(golden("etcd"), "etcd", device="cpu")
    assert res["valid"] is True and res["unmapped"] == 0


def _ingest_counts(reg, adapter):
    ops = reg.counter("ingest_ops_total", labelnames=("adapter",))
    unmapped = reg.counter("ingest_unmapped_total", labelnames=("adapter",))
    return ops.labels(adapter=adapter).value, unmapped.labels(adapter=adapter).value


@pytest.mark.parametrize("adapter", sorted(FIXTURES))
def test_metric_families_per_adapter(adapter):
    lines = golden(adapter) + ["garbage"]
    ref_reg, reg = RefRegistry(), Registry()
    ref_ingest.ingest_check(lines, adapter, metrics=ref_reg)
    ingest.ingest_check(lines, adapter, metrics=reg, device="cpu")
    assert _ingest_counts(reg, adapter) == _ingest_counts(ref_reg, adapter)
    assert _ingest_counts(reg, adapter)[1] == 1


# ---------------------------------------------------------------------------
# The CLI


def run_cli(trace, *argv):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                      os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.ingest", str(trace),
                           "--device", "cpu", *argv],
                          capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)


@pytest.mark.parametrize("variant, rc", [("valid", 0), ("invalid", 2), ("truncated", 1)])
def test_cli_exit_codes(tmp_path, variant, rc):
    lines = VARIANTS[variant]("etcd", golden("etcd"))
    trace = tmp_path / "trace.ndjson"
    trace.write_text("\n".join(lines) + "\n")
    out = tmp_path / "out.json"
    p = run_cli(trace, "--adapter", "etcd", "--check", "segmented", "-o", str(out))
    assert p.returncode == rc, p.stderr
    doc = json.loads(out.read_text())
    ref = ref_ingest.ingest_check(lines, "etcd", check="segmented")
    assert doc["valid"] == ref["valid"] == EXPECT[variant]
    assert (doc["workload"], doc["unmapped"]) == (ref["workload"], ref["unmapped"])


def test_cli_elle_in_process(tmp_path, capsys):
    assert main([str(GOLDEN / "generic.jsonl"), "--check", "elle", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["workload"] == "append" and doc["check"] == "elle"
    lines = seed_invalid("jsonl", golden("jsonl"))
    trace = tmp_path / "g1c.jsonl"
    trace.write_text("\n".join(lines) + "\n")
    assert main([str(trace), "--device", "cpu", "-o", str(tmp_path / "o.json")]) == 2
    assert json.loads((tmp_path / "o.json").read_text())["result"]["anomaly_types"]


@pytest.mark.parametrize("error", ["value", "build"])
def test_cli_deterministic_device_failure_is_no_verdict(tmp_path, monkeypatch, capsys, error):
    """A deterministic failure of the device oracle (a ``ValueError``, a
    kernel that fails to build) is raised by ``offline.drive``, and the
    CLI exits 255: not 0, 2 or 1, and never an ``unknown`` verdict."""
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.online.scheduler import SegmentScheduler

    exc = {"value": ValueError("bad plan"), "build": _build.BuildError("nvcc failed")}[error]
    calls = []

    def broken(self, encs):
        calls.append(len(encs))
        raise exc

    monkeypatch.setattr(SegmentScheduler, "_decide_device", broken)
    trace = tmp_path / "open.ndjson"
    trace.write_text("\n".join(golden("etcd")[:-1]) + "\n")  # an open tail
    out = tmp_path / "out.json"
    rc = main([str(trace), "--adapter", "etcd", "--engine", "device", "--device", "cpu",
               "-o", str(out)])
    assert rc == EXIT_ERROR == 255 and calls
    assert not out.exists()
    assert type(exc).__name__ in capsys.readouterr().err


def test_cli_refuses_columns_outside_jsonl(capsys):
    with pytest.raises(SystemExit):
        main([str(GOLDEN / "etcd.ndjson"), "--adapter", "etcd", "--columns", "{}"])


# ---------------------------------------------------------------------------
# Nemesis-matrix cells: traces drawn by the reference's simulator


def to_jsonl(history):
    """A simulated history as a generic jsonl recording: invokes become
    requests, ok/fail responses pair by corr, info completions are never
    answered (open intervals), reads without an observation stay open."""
    lines, seq, open_corr = [], 0, {}
    for op in history:
        if op.get("process") == gen.NEMESIS:
            continue
        v = op.get("value")
        key, val = (v.key, v.value) if ref_ind.is_tuple(v) else (None, v)
        rec = {"time": int(op["time"]), "conn": op["process"], "f": op["f"]}
        if key is not None:
            rec["key"] = key
        typ = op["type"]
        if typ == "invoke":
            seq += 1
            open_corr[op["process"]] = seq
            rec.update(phase="request", corr=seq, value=val)
        elif typ in ("ok", "fail"):
            if op["f"] == "read" and val is None:
                continue
            rec.update(phase="response", corr=open_corr.get(op["process"]),
                       ok=(typ == "ok"), value=val)
        else:
            continue
        lines.append(json.dumps(rec))
    return lines


KV = ref_ind.KV
CLIENTS = {
    "register": lambda: [{"f": "read", "value": KV("r%d" % (v % 2), None)} if v % 4 == 0
                         else {"f": "write", "value": KV("r%d" % (v % 2), v)}
                         for v in range(1, 17)],
    "counter": lambda: [{"f": "read", "value": KV("c0", None)} if v % 5 == 0
                        else {"f": "add", "value": KV("c0", 1 if v % 2 else -1)}
                        for v in range(1, 17)],
    "set": lambda: ([{"f": "add", "value": KV("s0", v)} for v in range(10)]
                    + [{"f": "remove", "value": KV("s0", v)} for v in range(6)]),
}


def nemesis_history(kind, workload):
    client = CLIENTS[workload]()
    if kind == "partition":
        net = SimNet()
        complete = sim.with_nemesis(
            nem.partitioner(), partitioned_completions(net, node_of=lambda p: "n%d" % (p % 2)),
            {"net": net, "nodes": ["n0", "n1"]})
        track = [{"type": "info", "f": "start", "value": {"n0": ["n1"]}},
                 {"type": "info", "f": "stop"}]
    elif kind == "reorder":
        reorder = DeliveryReorder(window_ns=300)
        complete = sim.with_nemesis(reorder, reordered_completions(reorder))
        track = [{"type": "info", "f": "start", "value": 300}, {"type": "info", "f": "stop"}]
    else:
        skew = SimClockSkew()
        complete = sim.with_nemesis(skew, skewed_completions(skew))
        track = [{"type": "info", "f": "bump", "value": {1: 400}},
                 {"type": "info", "f": "reset", "value": None}]
    return sim.simulate(gen.nemesis(track, gen.clients(client)), complete,
                        sim.n_plus_nemesis_context(2))


@pytest.mark.parametrize("kind, workload, check", [
    ("partition", "register", "segmented"), ("partition", "set", "elle"),
    ("reorder", "counter", "segmented"), ("reorder", "register", "elle"),
    ("skew", "set", "segmented"), ("skew", "counter", "elle"),
])
def test_nemesis_cells_match_reference(kind, workload, check):
    lines = to_jsonl(nemesis_history(kind, workload))
    ref_ops = ref_ad.parse_trace(lines, ref_ad.by_name("jsonl"))["ops"]
    assert norm(ad.parse_trace(lines, ad.by_name("jsonl"))["ops"]) == norm(ref_ops)
    res = both(lines, "jsonl", check=check)
    assert res["valid"] in (True, "unknown")
    assert_typed(res)
    if check == "elle" and workload in ("counter", "set"):
        assert res["valid"] == "unknown" and "ingest_unmapped_op" in causes_of(res)


def test_skew_beyond_window_raises_in_both():
    skew = SimClockSkew()
    complete = sim.with_nemesis(skew, skewed_completions(skew))
    track = [{"type": "info", "f": "bump", "value": {1: -5_000_000}}]
    history = sim.simulate(gen.nemesis(track, gen.clients(CLIENTS["register"]())), complete,
                           sim.n_plus_nemesis_context(2))
    lines = to_jsonl(history)
    with pytest.raises(RefNonMonotone):
        ref_ingest.ingest_check(lines, "jsonl", reorder_window_ns=1000)
    with pytest.raises(NonMonotoneHistoryError):
        ingest.ingest_check(lines, "jsonl", reorder_window_ns=1000, device="cpu")


def test_ingestion_needs_a_gpu_unless_asked_for_the_cpu():
    """The device oracle of a recording with an open tail runs on the card
    by default: without a GPU the drive raises, it never moves to the CPU
    unasked."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ingest.ingest_check(golden("etcd")[:-1], "etcd", engine="device")
