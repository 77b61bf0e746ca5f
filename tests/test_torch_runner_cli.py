"""The port's test-running CLI against the reference's: option parsing
(cli.clj:55-102,141-193), the ``test``, ``analyze`` and ``test-all``
commands and their exit codes (0, 1, 2, 254, 255; cli.clj:120-130), the
analysis of a stored history with no cluster, and ``python -m
jepsen_tpu_torch`` as a process. Every port command runs with ``--device
cpu``; the reference's checkers run on its C engine."""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu import checker as r_checker
from jepsen_tpu import cli as r_cli
from jepsen_tpu import client as r_client
from jepsen_tpu import generator as r_gen
from jepsen_tpu import workloads as r_wl
from jepsen_tpu.models import CasRegister as RCas
from jepsen_tpu_torch import checker as p_checker
from jepsen_tpu_torch import cli as p_cli
from jepsen_tpu_torch import client as p_client
from jepsen_tpu_torch import generator as p_gen
from jepsen_tpu_torch import workloads as p_wl
from jepsen_tpu_torch.models import CasRegister as PCas

ROOT = Path(__file__).resolve().parent.parent
REF = dict(cli=r_cli, checker=r_checker, client=r_client, gen=r_gen, wl=r_wl, Cas=RCas)
PORT = dict(cli=p_cli, checker=p_checker, client=p_client, gen=p_gen, wl=p_wl, Cas=PCas)
PKGS = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


def _argv(pkg, *args):
    """The port's commands run on the CPU; the reference's have no flag."""
    return [*args, "--device", "cpu"] if pkg is PORT else list(args)


# ---------------------------------------------------------------------------
# option parsing


def test_parse_concurrency_matches_reference():
    for spec, n in (("10", 5), ("3n", 5), ("1n", 3), ("0", 2)):
        assert p_cli.parse_concurrency(spec, n) == r_cli.parse_concurrency(spec, n)
    for cli in (p_cli, r_cli):
        with pytest.raises(ValueError):
            cli.parse_concurrency("n3", 5)


@pytest.mark.parametrize("args", [["--nodes", "a, b,c"], ["-n", "x", "-n", "y"], [],
                                  ["--nodes", "a,b", "--concurrency", "2n", "--no-ssh"],
                                  ["--concurrency", "7", "--time-limit", "3",
                                   "--leave-db-running", "--telemetry"]])
def test_options_map_matches_reference(args, tmp_path):
    out = []
    for cli in (r_cli, p_cli):
        p = argparse.ArgumentParser()
        cli.add_test_opts(p)
        opts = cli.options_map(p.parse_args(args))
        opts.pop("device", None)
        out.append(opts)
    assert out[1] == out[0]
    f = tmp_path / "nodes.txt"
    f.write_text("h1\nh2\n")
    p = argparse.ArgumentParser()
    p_cli.add_test_opts(p)
    assert p_cli.parse_nodes(p.parse_args(["--nodes-file", str(f)])) == ["h1", "h2"]
    assert p_cli.DEFAULT_NODES == r_cli.DEFAULT_NODES


@pytest.mark.parametrize("extra", [
    {}, {"online": True, "online_abort": True, "online_engine": "host"},
    {"online_abort": True}, {"online_engine": "device"}, {"online_engine": "auto"},
    {"live_port": 8080}, {"profile": True}, {"telemetry": True, "leave_db_running": True},
    {"checker_backend": "native", "store_root": "s"}, {"logging_json": True}])
def test_apply_std_opts_matches_reference(extra):
    base = {"nodes": ["n1"], "concurrency": 1, "time_limit": 1, "ssh": {"dummy?": True}}
    want = r_cli._apply_std_opts({}, {**base, **extra})
    got = p_cli._apply_std_opts({}, {**base, **extra})
    assert got == want
    assert p_cli._apply_std_opts({}, {**base, "device": "cpu"})["device"] == "cpu"


# ---------------------------------------------------------------------------
# commands and exit codes


def _stale(pkg):
    class StaleClient(pkg["client"].Client, pkg["client"].Reusable):
        """Reads from a snapshot that never sees writes."""

        def __init__(self, state):
            self.state = state

        def invoke(self, test, op):
            if op["f"] == "read":
                return {**op, "type": "ok", "value": 0}
            if op["f"] == "write":
                self.state.reset(op["value"])
                return {**op, "type": "ok"}
            cur, new = op["value"]
            return {**op, "type": "ok" if self.state.cas(cur, new) else "fail"}

    return StaleClient


def _suite(pkg, client="atom", name="cli-suite"):
    G = pkg["gen"]

    def test_fn(opts):
        state = pkg["wl"].AtomState()
        cls = {"atom": pkg["wl"].AtomClient, "stale": _stale(pkg)}[client]
        kw = {"device": opts.get("device")} if pkg is PORT else {"backend": "native"}
        test = dict(pkg["wl"].noop_test())
        test.update(
            name=name, db=pkg["wl"].AtomDB(state), client=cls(state),
            checker=pkg["checker"].linearizable(model=pkg["Cas"](init=0), **kw),
            generator=G.clients(G.limit(30, G.mix([
                lambda: {"f": "write", "value": 1 + G.rand_int(4)},
                lambda: {"f": "read"}]))))
        return test

    return test_fn


def _broken_checker_suite(pkg):
    def test_fn(opts):
        t = _suite(pkg)(opts)
        t["checker"] = pkg["checker"].checker_fn(
            lambda test, h, o: (_ for _ in ()).throw(RuntimeError("checker crashed")))
        return t

    return test_fn


@PKGS
def test_valid_run_exits_0(pkg, tmp_path):
    cmds = pkg["cli"].single_test_cmd(_suite(pkg))
    assert pkg["cli"].run(cmds, _argv(pkg, "test", "--store-root", str(tmp_path),
                                      "--concurrency", "4", "--nodes", "n1,n2")) == 0


@PKGS
def test_invalid_run_exits_1(pkg, tmp_path):
    cmds = pkg["cli"].single_test_cmd(_suite(pkg, "stale"))
    assert pkg["cli"].run(cmds, _argv(pkg, "test", "--store-root", str(tmp_path),
                                      "--concurrency", "4", "--nodes", "n1,n2")) == 1


@PKGS
def test_unknown_run_exits_2(pkg, tmp_path):
    cmds = pkg["cli"].single_test_cmd(_broken_checker_suite(pkg))
    assert pkg["cli"].run(cmds, _argv(pkg, "test", "--store-root", str(tmp_path),
                                      "--nodes", "n1")) == 2


@PKGS
def test_bad_args_exit_254(pkg):
    cmds = pkg["cli"].single_test_cmd(_suite(pkg))
    assert pkg["cli"].run(cmds, ["bogus-command"]) == 254
    assert pkg["cli"].run(cmds, _argv(pkg, "test", "--concurrency", "n3")) == 254
    assert pkg["cli"].run(cmds, []) == 254


@PKGS
def test_analyze_reuses_the_stored_history(pkg, tmp_path):
    cmds = pkg["cli"].single_test_cmd(_suite(pkg))
    assert pkg["cli"].run(cmds, _argv(pkg, "test", "--store-root", str(tmp_path),
                                      "--concurrency", "4", "--nodes", "n1,n2")) == 0
    assert pkg["cli"].run(cmds, _argv(pkg, "analyze", "--store-root", str(tmp_path),
                                      "--nodes", "n1,n2")) == 0
    bad = pkg["cli"].single_test_cmd(_suite(pkg, "stale"))
    assert pkg["cli"].run(bad, _argv(pkg, "test", "--store-root", str(tmp_path / "b"),
                                     "--nodes", "n1,n2")) == 1
    # re-analysis keeps the refuted verdict
    assert pkg["cli"].run(bad, _argv(pkg, "analyze", "--store-root", str(tmp_path / "b"),
                                     "--nodes", "n1,n2")) == 1


@PKGS
def test_analyze_name_mismatch_and_empty_store_exit_255(pkg, tmp_path):
    cmds = pkg["cli"].single_test_cmd(_suite(pkg))
    assert pkg["cli"].run(cmds, _argv(pkg, "analyze", "--store-root",
                                      str(tmp_path / "none"))) == 255
    assert pkg["cli"].run(cmds, _argv(pkg, "test", "--store-root", str(tmp_path),
                                      "--nodes", "n1")) == 0
    other = pkg["cli"].single_test_cmd(_suite(pkg, name="other-name"))
    assert pkg["cli"].run(other, _argv(pkg, "analyze", "--store-root", str(tmp_path))) == 255


@PKGS
def test_test_all_exits_with_the_worst(pkg, tmp_path):
    cmds = pkg["cli"].test_all_cmd({"good": _suite(pkg), "bad": _suite(pkg, "stale")})
    assert pkg["cli"].run(cmds, _argv(pkg, "test-all", "--store-root", str(tmp_path),
                                      "--concurrency", "4", "--nodes", "n1,n2")) == 1
    only_good = pkg["cli"].test_all_cmd({"good": _suite(pkg)})
    assert pkg["cli"].run(only_good, _argv(pkg, "test-all", "--store-root",
                                           str(tmp_path / "g"))) == 0


def test_no_card_without_cpu_exits_255(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cmds = p_cli.single_test_cmd(_suite(PORT))
    assert p_cli.run(cmds, ["test", "--store-root", str(tmp_path), "--nodes", "n1"]) == 255
    assert not list(tmp_path.rglob("history.edn"))
    # test-all counts a test that cannot reach the card as unknown
    assert p_cli.run(p_cli.test_all_cmd({"good": _suite(PORT)}),
                     ["test-all", "--store-root", str(tmp_path)]) == 2


@pytest.mark.parametrize("flag", [["--profile"], ["--live-port", "0"]])
def test_unported_flags_are_refused(flag, tmp_path):
    """``--profile`` and ``--live-port`` exited 254 while the port lacked
    their machinery; both now run the test to its verdict (exit 0), and
    ``--profile`` leaves ``profile.json`` and the trace."""
    cmds = p_cli.single_test_cmd(_suite(PORT))
    assert p_cli.run(cmds, ["test", "--store-root", str(tmp_path), "--device", "cpu",
                            *flag]) == 0
    (results,) = tmp_path.rglob("results.edn")
    profiled = flag == ["--profile"]
    assert (results.parent / "profile.json").exists() is profiled
    assert (results.parent / "profile_trace" / "trace.json").exists() is profiled


def test_serve_command_serves_the_store_root(tmp_path, monkeypatch):
    """``serve`` hands its ``--store-root`` and ``--port`` to ``web.serve``,
    as the reference's command does; it takes no test options."""
    from jepsen_tpu_torch import __main__ as demo
    from jepsen_tpu_torch import web

    calls = []
    monkeypatch.setattr(web, "serve", lambda root=None, port=8080: calls.append((root, port)))
    assert "serve" in demo.COMMANDS
    assert p_cli.run(demo.COMMANDS, ["serve", "--store-root", str(tmp_path),
                                     "--port", "8123"]) == 0
    assert p_cli.run(p_cli.serve_cmd(), ["serve"]) == 0
    assert calls == [(str(tmp_path), 8123), (None, 8080)]
    assert p_cli.run(p_cli.serve_cmd(), ["serve", "--nodes", "n1"]) == 254


def test_replay_still_refuses_test_flags(tmp_path):
    cmds = p_cli.replay_cmd(model_args={"init": 0})
    assert p_cli.run(cmds, ["replay", "--store-root", str(tmp_path), "--device", "cpu",
                            "--nodes", "n1"]) == 254


# ---------------------------------------------------------------------------
# python -m jepsen_tpu_torch


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    return env


def test_demo_suite_test_then_analyze_as_processes(tmp_path):
    """``test`` with the online monitor and telemetry, then ``analyze`` of
    the stored run: both exit 0 with the same ``results.edn`` verdict."""
    run = [sys.executable, "-m", "jepsen_tpu_torch"]
    common = ["--workload", "cas-register", "--store-root", str(tmp_path), "--device", "cpu"]
    a = subprocess.run([*run, "test", *common, "--time-limit", "1", "--rate", "100",
                        "--no-ssh", "--online", "--online-engine", "device", "--telemetry"],
                       cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert a.returncode == 0, a.stderr[-3000:]
    (results,) = tmp_path.rglob("results.edn")
    first = results.read_text()
    run_dir = results.parent
    assert {p.name for p in run_dir.iterdir()} >= {
        "history.edn", "results.edn", "online.json", "metrics.jsonl", "spans.jsonl"}
    assert (tmp_path / "ledger.jsonl").exists()
    b = subprocess.run([*run, "analyze", *common], cwd=tmp_path, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert b.returncode == 0, b.stderr[-3000:]
    from jepsen_tpu_torch.edn import K, read_string

    first_v = read_string(first)[K("valid?")]
    second_v = read_string(results.read_text())[K("valid?")]
    assert first_v is second_v is True
