"""The reader half of the port's cross-run ledger against the reference's:
``trend``, ``check``, ``render``, ``records_of_bench``, ``record_of_run``
(with the utilization and gap shares, read back from ``profile.json`` or
reconstructed from the registry) and ``main``, over synthetic ledgers and
bench lines written under ``tmp_path``; equal output, with only the
package's name normalised. ``--alerts`` appends the reference's
``perf_regression`` records under ``--check`` (and nothing without it),
and ``python -m jepsen_tpu_torch.ledger`` gates as a process."""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from jepsen_tpu.telemetry import ledger as r_ledger
from jepsen_tpu_torch.telemetry import Registry as PRegistry
from jepsen_tpu_torch.telemetry import ledger as p_ledger

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _no_ledger_override(monkeypatch):
    monkeypatch.delenv("JEPSEN_LEDGER_PATH", raising=False)


def _records(seed, n=40):
    """Runs and bench legs of a few comparable groups, out of order in
    time, some without a stamp, some with booleans and strings where a
    number would be."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        kind = rng.choice(["run", "bench"])
        rec = {"kind": kind, "workload": rng.choice(["cas-register", "mutex_5k", "elle_txn"]),
               "engine": rng.choice(["device", "native", "host"]),
               "run": f"r{i}", "verdict": rng.choice(["True", "False", "unknown", None])}
        if rng.random() < 0.9:
            rec["ts"] = 1_754_000_000 + rng.randint(0, 10 ** 6)
        for name, key, _d in r_ledger.LEDGER_METRICS:
            if rng.random() < 0.4:
                rec[key] = rng.choice([round(rng.uniform(0.01, 100), 4), rng.randint(0, 9),
                                       True, "n/a", 0])
        out.append(rec)
    return out


def _write(path, records, junk=True):
    lines = [json.dumps(r) for r in records]
    if junk:
        lines[3:3] = ["{not json", "", "[1, 2]"]
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("seed", range(5))
def test_trend_check_render_match_reference(tmp_path, seed):
    path = _write(tmp_path / "ledger.jsonl", _records(seed))
    recs = p_ledger.load(path)
    assert recs == r_ledger.load(path)
    for threshold, last in ((0.1, 8), (0.0, 3), (0.5, 1), (2.0, 20)):
        assert p_ledger.trend(recs, threshold=threshold, last=last) == \
            r_ledger.trend(recs, threshold=threshold, last=last)
        assert p_ledger.check(recs, threshold=threshold) == \
            r_ledger.check(recs, threshold=threshold)
        assert p_ledger.render(recs, threshold=threshold, last=last) == \
            r_ledger.render(recs, threshold=threshold, last=last)
    assert p_ledger.grouped(recs) == r_ledger.grouped(recs)
    for r in recs:
        assert p_ledger.group_key(r) == r_ledger.group_key(r)
    assert p_ledger.render([]) == r_ledger.render([])


def _bench_line(rng):
    line: dict = {"value": rng.random(), "ops_per_s": rng.randint(1, 10 ** 5),
                  "invalid_s": rng.random(), "device_kernel_s": rng.random(),
                  "device_utilization_pct": rng.uniform(0, 100)}
    for leg, path, _engine, fields in r_ledger._BENCH_LEGS:
        if path is None or rng.random() < 0.3:
            continue
        cur = line
        for part in path.split("."):
            cur = cur.setdefault(part, {})
        for src in fields.values():
            if rng.random() < 0.7:
                cur[src] = rng.choice([rng.random(), rng.randint(0, 100), True, "x"])
    line["batch_replay_100"] = "skipped"  # a leg that errored leaves no record
    return line


@pytest.mark.parametrize("seed", range(4))
def test_records_of_bench_match_reference(seed):
    line = _bench_line(random.Random(seed))
    got, want = p_ledger.records_of_bench(line), r_ledger.records_of_bench(line)
    assert [r.pop("ts") > 0 for r in got] == [r.pop("ts") > 0 for r in want]
    assert got == want and got
    assert p_ledger._BENCH_LEGS == r_ledger._BENCH_LEGS


def _run_map(tmp_path, reg, profile=None, **extra):
    test = {"name": "cas-register", "start-time": "20260101T000000.000Z",
            "store-root": str(tmp_path), "history": list(range(12)),
            "results": {"valid": True, "linear": {"backend": "device", "valid": True,
                                                  "exchange": "alltoall", "n_shards": 2}},
            "online-results": {"decision_latency": {"p99_s": 0.25}},
            "telemetry-registry": reg}
    if profile is not None:
        test["profile?"] = True
        d = tmp_path / "cas-register" / "20260101T000000.000Z"
        d.mkdir(parents=True, exist_ok=True)
        (d / "profile.json").write_text(json.dumps(profile))
    test.update(extra)
    return test


def test_record_of_run_matches_reference(tmp_path):
    reg = PRegistry()
    reg.histogram("checker_seconds", "s", labelnames=("checker",)).labels(
        checker="linear").observe(0.75)
    base = 1_754_000_000.0
    for i, (a, b) in enumerate(((0, 1), (1.5, 2), (2.5, 4))):
        reg.event("wgl_chunk", level0=i, level=i + 1, F=16, wall_s=b - a,
                  stage="compile" if i == 1 else "execute", t0=base + a, t1=base + b)
    reg.event("online_backlog", t=base + 2.1, backlog=2)
    cases = [
        _run_map(tmp_path / "a", reg),
        _run_map(tmp_path / "b", reg, profile={"attribution": {"utilization": {"summary": {
            "mean_utilization_pct": 42.5, "gap_attribution_share": {"starved": 1.0}}}}}),
        _run_map(tmp_path / "c", reg, profile={"attribution": {}}),
        _run_map(tmp_path / "d", PRegistry()),
        _run_map(tmp_path / "e", None, results=None, history=None),
        _run_map(tmp_path / "f", reg, **{"no-store?": True, "profile?": True}),
    ]
    for test in cases:
        got, want = p_ledger.record_of_run(test), r_ledger.record_of_run(test)
        assert got == want
    first = p_ledger.record_of_run(cases[0])
    # busy [0, 1] and [2.5, 4] of 4 s; the one gap holds a compile chunk
    assert first["utilization_pct"] == 62.5 and first["gap_share"] == {"compiling": 1.0}
    assert p_ledger.record_of_run(cases[1])["utilization_pct"] == 42.5


@pytest.mark.parametrize("args", [
    [], ["--check"], ["--json"], ["--check", "--threshold", "0.5"], ["--last", "2"],
    ["--workload", "mutex_5k", "--check"], ["--json", "--check", "--threshold", "0"],
    ["--check", "EMPTY"], ["MISSING"]])
def test_main_matches_reference(tmp_path, capsys, args):
    path = _write(tmp_path / "ledger.jsonl", _records(11))
    (tmp_path / "empty.jsonl").write_text("")
    subst = {"EMPTY": str(tmp_path / "empty.jsonl"), "MISSING": str(tmp_path / "no.jsonl")}
    argv = [subst.get(a, a) for a in args]
    if not any(a in subst for a in args):
        argv.append(str(path))
    outs = []
    for ledger in (r_ledger, p_ledger):
        code = ledger.main(list(argv))
        cap = capsys.readouterr()
        outs.append((code, cap.out.replace("jepsen_tpu_torch", "jepsen_tpu"), cap.err))
    assert outs[1] == outs[0]


def test_alerts_is_refused(tmp_path, capsys):
    """``--alerts`` without ``--check`` writes nothing; with it, each
    flagged group is appended as the reference's ``perf_regression``
    record (the wall stamp aside), with the reference's exit code and
    output."""
    path = _write(tmp_path / "ledger.jsonl", _records(3))
    outs = []
    for ledger in (r_ledger, p_ledger):
        alerts = tmp_path / f"{ledger.__name__}.alerts.jsonl"
        codes = [ledger.main(["--alerts", str(alerts), str(path)])]
        assert not alerts.exists()
        codes.append(ledger.main(["--check", "--alerts", str(alerts), str(path)]))
        cap = capsys.readouterr()
        lines = [{k: v for k, v in json.loads(x).items() if k != "t"}
                 for x in alerts.read_text().splitlines()] if alerts.exists() else []
        outs.append((codes, cap.out.replace("jepsen_tpu_torch", "jepsen_tpu"), lines))
    assert outs[1] == outs[0]
    assert outs[1][0] == [0, 1] and len(outs[1][2]) == 2
    assert all(r["rule"] == "perf_regression" and r["source"] == "ledger"
               for r in outs[1][2])


def test_python_m_ledger_gates(tmp_path):
    """``python -m jepsen_tpu_torch.ledger --check``: 1 past the threshold,
    0 within it."""
    path = tmp_path / "ledger.jsonl"
    recs = [{"kind": "run", "workload": "w", "engine": "device", "ts": 1, "value_s": 1.0},
            {"kind": "run", "workload": "w", "engine": "device", "ts": 2, "value_s": 2.0}]
    _write(path, recs, junk=False)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    env.pop("JEPSEN_LEDGER_PATH", None)
    cmd = [sys.executable, "-m", "jepsen_tpu_torch.ledger", "--check", str(path)]
    p = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 1, p.stderr
    assert "REGRESSIONS past 10%" in p.stdout and "w[device]: value_s" in p.stdout
    p = subprocess.run(cmd[:-1] + ["--threshold", "2", str(path)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
