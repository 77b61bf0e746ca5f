"""The port's batch replay of a store (``parallel.replay``, the ``replay``
command of ``cli`` and ``python -m jepsen_tpu_torch``) against the JAX
reference's: one store tree of 16 runs under two test names (valid and
perturbed runs, one that escalates past the shared capacity, an
unreadable ``history.edn``, a history of another model, one whose ops the
model drops entirely, and a reference-style text) copied to two roots;
the summaries are equal, each pair of ``rechecked.edn`` files is
byte-identical but for the ``wall_s`` wall times, and the CLI gives the
reference's exit codes. The port runs with ``device="cpu"``; the
reference runs on one device (its ``replay_store`` shards the batch over
every local device when it sees more than one, the port's takes one card:
``ROADMAP.md``'s divergence 3), so ``jax.devices`` is cut to one here."""

import os
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from jepsen_tpu import cli as r_cli
from jepsen_tpu.parallel import replay as RR
from jepsen_tpu_torch import cli as p_cli
from jepsen_tpu_torch import native, store, trace
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.parallel import replay as PR
from jepsen_tpu_torch.testing import perturb_history, random_register_history

from test_torch_store import REFERENCE_STYLE

ROOT = Path(__file__).resolve().parent.parent
T0 = 1785456000
REFUTED = """\
{:type :invoke, :f :write, :value 3, :process 0, :time 10, :index 0}
{:type :ok, :f :write, :value 3, :process 0, :time 20, :index 1}
{:type :invoke, :f :read, :value nil, :process 1, :time 30, :index 2}
{:type :ok, :f :read, :value 9, :process 1, :time 40, :index 3}
"""


def _runs():
    """The 16 runs: (test name, history text)."""
    out = []
    for i in range(8):
        h = random_register_history(random.Random(100 + i), n_ops=30, n_procs=4, cas=True,
                                    crash_p=0.05)
        out.append(("reg-a", h.to_edn_string()))
    for i in range(3):
        rng = random.Random(200 + i)
        h = perturb_history(rng, random_register_history(rng, n_ops=30, n_procs=4, cas=True,
                                                         crash_p=0.0))
        out.append(("reg-b", h.to_edn_string()))
    # Its frontier outgrows the default capacity of 256: it escalates.
    h = random_register_history(random.Random(1), n_ops=40, n_procs=12, cas=True, crash_p=0.3)
    out.append(("reg-b", h.to_edn_string()))
    out.append(("reg-a", "{:type :invoke, :f :write, :value"))  # unreadable
    mutex = History([Op("invoke", 0, "acquire", None), Op("ok", 0, "acquire", None),
                     Op("invoke", 0, "release", None), Op("ok", 0, "release", None)])
    out.append(("reg-b", mutex.to_edn_string()))  # another model's
    dropped = History([Op("invoke", 0, "write", 1), Op("fail", 0, "write", 1),
                       Op("invoke", 1, "read", None), Op("fail", 1, "read", None)])
    out.append(("reg-a", dropped.to_edn_string()))  # every op dropped
    out.append(("reg-b", REFERENCE_STYLE))
    return out


def _store(root: Path, runs) -> None:
    for i, (name, text) in enumerate(runs):
        d = root / name / store.time_str(T0 + i + 0.25 * (i % 3))
        d.mkdir(parents=True)
        (d / "history.edn").write_text(text)


@pytest.fixture
def one_device(monkeypatch):
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The 16-run tree, replayed by both packages into two copies."""
    base = tmp_path_factory.mktemp("replay")
    _store(base / "src", _runs())
    r1, r2 = base / "ref", base / "port"
    shutil.copytree(base / "src", r1)
    shutil.copytree(base / "src", r2)
    devices = jax.devices
    jax.devices = lambda *a, **k: devices(*a, **k)[:1]
    try:
        ref = RR.replay_store(root=str(r1), model_args={"init": 0})
    finally:
        jax.devices = devices
    port = PR.replay_store(root=str(r2), model_args={"init": 0}, device="cpu")
    return r1, r2, ref, port


def _relative(summary, root):
    return {k: ({str(Path(p).relative_to(root)): v for p, v in val.items()}
                if k == "runs" else val) for k, val in summary.items()}


def _no_walls(text):
    return re.sub(r":wall_s -?[0-9.e+-]+", ":wall_s W", text)


def test_summaries_are_equal(roots):
    r1, r2, ref, port = roots
    assert _relative(port, r2) == _relative(ref, r1)
    assert port["count"] == 16 and port["escalated"] == 1
    assert (port["valid"], port["invalid"], port["unknown"]) == (10, 3, 3)


def test_rechecked_files_are_identical_but_for_walls(roots):
    r1, r2, _, _ = roots
    files = sorted(p.relative_to(r2) for p in r2.rglob("rechecked.edn"))
    assert len(files) == 16
    assert files == sorted(p.relative_to(r1) for p in r1.rglob("rechecked.edn"))
    for rel in files:
        a, b = (r1 / rel).read_text(), (r2 / rel).read_text()
        assert _no_walls(b) == _no_walls(a), rel
    texts = [(r2 / rel).read_text() for rel in files]
    assert sum(':code "encoding_unsupported"' in t for t in texts) == 3
    assert any(":escalated true" in t for t in texts)


def test_find_histories_newest_first(roots):
    _, r2, _, _ = roots
    for kw in ({}, {"name": "reg-a"}, {"limit": 5}, {"name": "reg-b", "limit": 2}):
        got = [p.relative_to(r2) for p in PR.find_histories(root=r2, **kw)]
        want = [p.relative_to(r2) for p in RR.find_histories(root=r2, **kw)]
        assert got == want, kw
        stamps = [p.parent.name for p in got]
        assert stamps == sorted(stamps, reverse=True)


def test_replay_results_in_memory_match(roots):
    """``replay`` on paths returns the maps that ``rechecked.edn`` holds."""
    _, r2, _, _ = roots
    from jepsen_tpu_torch.models import CasRegister

    paths = PR.find_histories(root=r2, limit=4)
    spans = trace.default_collector().spans
    before = len(spans)
    res = PR.replay(CasRegister(init=0), paths, write_results=False, device="cpu")
    for p, r in zip(paths, res):
        text = (p.parent / "rechecked.edn").read_text()
        assert _no_walls(store.edn.write_string(store.to_edn_value(r)) + "\n") == \
            _no_walls(text)
    # Each step is a span; with write_results=False nothing is written.
    assert [s["name"] for s in spans[before:]] == \
        ["replay.load", "replay.encode", "replay.decide"]
    assert spans[before]["attrs"] == {"histories": 4}


def _cli_pair(tmp_path, runs, extra=()):
    """Exit codes of both packages' ``replay`` command on copies of one
    store."""
    _store(tmp_path / "src", runs)
    codes = []
    for pkg, cli, dev in (("ref", r_cli, ()), ("port", p_cli, ("--device", "cpu"))):
        root = tmp_path / pkg
        shutil.copytree(tmp_path / "src", root)
        codes.append(cli.run(cli.replay_cmd(model_args={"init": 0}),
                             ["replay", "--store-root", str(root), *dev, *extra]))
    return codes


_VALID = [("reg", random_register_history(random.Random(300 + i), n_ops=20, n_procs=3,
                                          crash_p=0.0).to_edn_string()) for i in range(3)]


@pytest.mark.parametrize("case,runs,extra,code", [
    ("all_valid", _VALID, (), p_cli.EXIT_OK),
    ("mixed", _VALID + [("bad", REFUTED)], (), p_cli.EXIT_INVALID),
    ("unknown_only", [("junk", "{:type")], (), p_cli.EXIT_UNKNOWN),
    ("test_name", _VALID + [("bad", REFUTED)], ("--test-name", "reg"), p_cli.EXIT_OK),
    ("limit", [("bad", REFUTED)] + _VALID, ("--limit", "3"), p_cli.EXIT_OK),
    ("limit_all", [("bad", REFUTED)] + _VALID, ("--limit", "4"), p_cli.EXIT_INVALID),
    ("bad_limit", _VALID, ("--limit", "0"), p_cli.EXIT_BAD_ARGS),
])
def test_cli_exit_codes_match(tmp_path, one_device, case, runs, extra, code):
    assert _cli_pair(tmp_path, runs, extra) == [code, code], case


def test_reference_format_replay_through_the_ports_cli(tmp_path):
    """The reference's own reference-format case (``tests/test_cli.py``):
    the valid history replays True, and a refuted one beside it makes the
    command exit invalid."""
    d = tmp_path / "consul-register" / "20180501T120000.000Z"
    d.mkdir(parents=True)
    (d / "history.edn").write_text(REFERENCE_STYLE)
    argv = ["replay", "--store-root", str(tmp_path), "--device", "cpu"]
    assert p_cli.run(p_cli.replay_cmd(), argv) == p_cli.EXIT_OK
    assert ":valid? true" in (d / "rechecked.edn").read_text()
    d2 = tmp_path / "consul-register" / "20180501T120001.000Z"
    d2.mkdir(parents=True)
    (d2 / "history.edn").write_text(REFUTED)
    assert p_cli.run(p_cli.replay_cmd(), argv) == p_cli.EXIT_INVALID
    assert ":valid? false" in (d2 / "rechecked.edn").read_text()


def test_module_entry_point_in_a_subprocess(tmp_path):
    _store(tmp_path, _VALID + [("bad", REFUTED)])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch", "replay", "--device", "cpu",
                          "--store-root", str(tmp_path)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == p_cli.EXIT_INVALID, out.stderr
    assert "replay summary" in out.stderr
    assert len(list(tmp_path.rglob("rechecked.edn"))) == 4


def test_replay_without_a_gpu_raises_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _store(tmp_path, _VALID)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.replay_store(root=tmp_path)
    cmd = p_cli.replay_cmd(model_args={"init": 0})
    assert p_cli.run(cmd, ["replay", "--store-root", str(tmp_path)]) == p_cli.EXIT_ERROR
    assert not list(tmp_path.rglob("rechecked.edn"))
    assert p_cli.run(cmd, ["replay", "--store-root", str(tmp_path), "--device", "cpu"]) == \
        p_cli.EXIT_OK


def test_a_failed_reader_build_raises_once(tmp_path, monkeypatch):
    """A C reader that does not build is the machine's fault, not the
    runs': ``replay_store`` raises it (the CLI exits 255) instead of
    marking every history unreadable, and the compiler runs once."""
    builds = []

    def broken(*a, **k):
        builds.append(a)
        raise native.NativeBuildError("cc failed to build edn_fast.c (exit 1)")

    monkeypatch.setattr(native, "_edn_mod", None)
    monkeypatch.setattr(native, "_edn_error", None)
    monkeypatch.setattr(native, "edn_fast_missing", None)
    monkeypatch.setattr(native, "_edn_missing", lambda: None)
    monkeypatch.setattr(native, "compile_library", broken)
    _store(tmp_path, _VALID)
    with pytest.raises(native.NativeBuildError):
        PR.replay_store(root=tmp_path, device="cpu")
    cmd = p_cli.replay_cmd(model_args={"init": 0})
    assert p_cli.run(cmd, ["replay", "--store-root", str(tmp_path), "--device", "cpu"]) == \
        p_cli.EXIT_ERROR
    assert len(builds) == 1
    assert not list(tmp_path.rglob("rechecked.edn"))


@pytest.mark.parametrize("flag", [["--checker-backend", "host"], ["--telemetry"],
                                  ["--nodes", "n1,n2"], ["--time-limit", "5"]])
def test_replay_refuses_the_test_runners_flags(tmp_path, flag):
    """``replay`` takes only the options it reads: the test runner's flags
    are refused as bad arguments rather than quietly ignored."""
    _store(tmp_path, _VALID)
    cmd = p_cli.replay_cmd(model_args={"init": 0})
    argv = ["replay", "--store-root", str(tmp_path), "--device", "cpu", *flag]
    assert p_cli.run(cmd, argv) == p_cli.EXIT_BAD_ARGS
    assert not list(tmp_path.rglob("rechecked.edn"))
