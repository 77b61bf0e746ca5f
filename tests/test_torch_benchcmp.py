"""The port's ``benchcmp`` against the reference's, over synthetic round
files written under ``tmp_path`` in every shape the reader takes (the
run wrapper with ``parsed`` set, null with a JSON line in its tail, or
a head-truncated fragment; a bare bench line; the multichip wrapper; an
unreadable file): equal loaded rounds, metrics, merged columns in numeric
round order, delta blocks, regressions, tables, ``vs_previous`` and
``main``'s output and exit code, with only the package's name
normalised."""

from __future__ import annotations

import json
import random

import pytest

from jepsen_tpu import benchcmp as r_bc
from jepsen_tpu.telemetry import ledger as r_ledger
from jepsen_tpu_torch import benchcmp as p_bc
from jepsen_tpu_torch.telemetry import ledger as p_ledger


def _bench(rng, scale=1.0):
    """A bench line with a random subset of the catalogue's metrics."""
    out: dict = {}
    for _name, path, _d in r_bc.METRICS:
        if rng.random() < 0.6:
            cur = out
            parts = path.split(".")
            for part in parts[:-1]:
                cur = cur.setdefault(part, {})
            cur[parts[-1]] = rng.choice([0, 1, 7, round(rng.random() * 100 * scale, 4),
                                         rng.randint(1, 10 ** 6)])
    out["multichip_ok"] = rng.random() < 0.5
    # last, so that a head-truncated line still names itself a bench line
    out.update(metric="check_seconds", bench_wall_s=600 * scale)
    return out


def _write_rounds(root, seed):
    rng = random.Random(seed)
    files = []

    def put(name, doc):
        p = root / name
        p.write_text(json.dumps(doc) if not isinstance(doc, str) else doc)
        files.append(str(p))

    put("BENCH_r01.json", {"cmd": "python bench.py", "n": 1, "parsed": None, "rc": 1,
                           "tail": "noise\n" + json.dumps(_bench(rng)) + "\nmore noise"})
    put("BENCH_r02.json", _bench(rng, 1.3))
    line = json.dumps(_bench(rng, 0.7))
    put("BENCH_r03.json", {"cmd": "c", "n": 3, "parsed": None, "rc": 0,
                           "tail": "log\n" + line[len(line) // 3:]})
    put("BENCH_r04.json", {"cmd": "c", "n": 4, "parsed": _bench(rng, 1.1), "rc": 2})
    put("MULTICHIP_r04.json", {"n_devices": 8, "ok": True, "parsed": None,
                               "tail": "x\n" + json.dumps(
                                   {"multichip": True,
                                    "exchange_bytes_per_level": {"alltoall": 4096},
                                    "exchange_drop_x": 7.5})})
    put("BENCH_r10.json", _bench(rng, 0.9))
    put("BENCH_r100.json", _bench(rng, 1.5))
    put("BENCH_r99.json", {"cmd": "c", "n": 99, "parsed": None, "rc": 0, "tail": "nothing"})
    return files


def _norm(s):
    return s.replace("jepsen_tpu_torch", "jepsen_tpu")


@pytest.mark.parametrize("seed", range(4))
def test_load_extract_merge_match_reference(tmp_path, seed):
    files = _write_rounds(tmp_path, seed)
    p_rounds = [p_bc.load_round(f) for f in files]
    r_rounds = [r_bc.load_round(f) for f in files]
    assert p_rounds == r_rounds
    assert any(r["data"].get("recovered_fragment") for r in p_rounds)
    for r in p_rounds:
        assert p_bc.extract(r["data"]) == r_bc.extract(r["data"])
        assert p_bc.round_label(r["path"]) == r_bc.round_label(r["path"])
        assert p_bc.round_sort_key(r["path"]) == r_bc.round_sort_key(r["path"])
    merged = p_bc._merge_rounds(p_rounds)
    assert merged == r_bc._merge_rounds(r_rounds)
    assert [m["label"] for m in merged][-3:] == ["r10", "r99", "r100"]
    assert p_bc.render_table(merged) == r_bc.render_table(merged)


@pytest.mark.parametrize("threshold", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("seed", range(3))
def test_deltas_and_regressions_match_reference(seed, threshold):
    rng = random.Random(100 + seed)
    prev, cur = r_bc.extract(_bench(rng)), r_bc.extract(_bench(rng, 1.2))
    prev["value_s"], cur["value_s"] = 0.0, 0.5  # a zero baseline
    for metrics in (None, r_bc.METRICS, r_ledger.LEDGER_METRICS):
        got = p_bc.deltas(prev, cur, threshold=threshold, metrics=metrics)
        want = r_bc.deltas(prev, cur, threshold=threshold, metrics=metrics)
        assert got == want
        assert p_bc.regressions(got) == r_bc.regressions(want)
    assert p_bc.METRICS == r_bc.METRICS
    assert p_bc.DEFAULT_THRESHOLD == r_bc.DEFAULT_THRESHOLD
    assert p_ledger.LEDGER_METRICS == r_ledger.LEDGER_METRICS


def test_fmt_and_table_match_reference():
    for v in (None, 0, 3.0, -2, 1e13, 0.000123456, 12345.678):
        assert p_bc._fmt(v) == r_bc._fmt(v)
    for bc in (p_bc, r_bc):  # neither formats an infinite value
        with pytest.raises(OverflowError):
            bc._fmt(float("inf"))
    cols = [{"label": "a", "metrics": {"value_s": 1.5, "ops": 10}},
            {"label": "bb", "metrics": {"utilization_pct": 80.25}}]
    for metrics in (None, r_ledger.LEDGER_METRICS):
        assert p_bc.render_table(cols, metrics=metrics) == \
            r_bc.render_table(cols, metrics=metrics)


def test_vs_previous_matches_reference(tmp_path):
    current = _bench(random.Random(9), 1.25)
    assert p_bc.vs_previous(current, root=str(tmp_path)) is None
    assert r_bc.vs_previous(current, root=str(tmp_path)) is None
    _write_rounds(tmp_path, 2)
    for glob in ("BENCH_r*.json", "MULTICHIP_r*.json", "BENCH_r0*.json"):
        got = p_bc.vs_previous(current, artifact_glob=glob, root=str(tmp_path))
        want = r_bc.vs_previous(current, artifact_glob=glob, root=str(tmp_path))
        assert got == want


@pytest.mark.parametrize("args", [
    [], ["r02"], ["r01", "r02", "r03", "r04", "m04", "r10", "r99", "r100"],
    ["--all", "r01", "r02", "r03", "r04", "r10"], ["--json", "r02", "r04", "m04"],
    ["--threshold", "0.5", "r03", "r10", "r100"], ["--json", "--all", "r10", "r02"],
    ["r02", "nojson"], ["r02", "missing"]])
def test_main_matches_reference(tmp_path, capsys, args):
    files = dict(zip(["r01", "r02", "r03", "r04", "m04", "r10", "r100", "r99"],
                     _write_rounds(tmp_path, 5)))
    (tmp_path / "bad.json").write_text("{not json")
    files["nojson"] = str(tmp_path / "bad.json")
    files["missing"] = str(tmp_path / "nope.json")
    argv = [files.get(a, a) for a in args]
    outs = []
    for bc in (r_bc, p_bc):
        code = bc.main(list(argv))
        cap = capsys.readouterr()
        outs.append((code, _norm(cap.out), _norm(cap.err)))
    assert outs[1] == outs[0]
    if args[-1:] in (["nojson"], ["missing"]):
        assert outs[1][0] == 2


def test_python_m_benchcmp_help(capsys):
    with pytest.raises(SystemExit) as e:
        p_bc.main(["--help"])
    assert e.value.code == 0
    assert "python -m jepsen_tpu_torch.benchcmp" in capsys.readouterr().out
