"""CLI framework: build ``test`` / ``analyze`` / ``test-all`` / ``replay``
runners.

The port of the reference's ``jepsen_tpu/cli.py`` (jepsen.cli,
jepsen/src/jepsen/cli.clj): a suite supplies a ``test_fn(options) ->
test-map``, hands :func:`run` a map of commands and gets the reference's
exit codes (cli.clj:120-130)::

    0    all tests passed
    1    some test failed (results invalid)
    2    some test had unknown validity
    254  invalid arguments
    255  internal error

The commands that run or analyze tests (:func:`single_test_cmd`,
:func:`test_all_cmd`) take the reference's standard test options
(test-opt-spec, cli.clj:55-102: --node/--nodes/--nodes-file, --username,
--password, --no-ssh, --concurrency with its ``n`` suffix, --time-limit,
--checker-backend, --telemetry, the online monitor's flags, ...) and
``--device``, the torch device of the run's checkers and online monitor
(the card by default; ``cpu`` runs the plain PyTorch version). Where the
reference adds the test options to every command, the port adds them to
these: ``replay`` takes only the options it reads. ``--profile`` and
``--live-port`` are accepted and refused by ``core`` (ROADMAP items A8
and A16), and ``serve`` waits for the web pages.
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import sys
from typing import Callable, Optional

from . import core, store

LOG = logging.getLogger("jepsen.cli")

DEFAULT_NODES = ["n1", "n2", "n3", "n4", "n5"]

EXIT_OK = 0
EXIT_INVALID = 1
EXIT_UNKNOWN = 2
EXIT_BAD_ARGS = 254
EXIT_ERROR = 255


def add_test_opts(p: argparse.ArgumentParser) -> None:
    """test-opt-spec (cli.clj:55-102)."""
    p.add_argument("-n", "--node", action="append", dest="node",
                   help="node to run on; repeatable")
    p.add_argument("--nodes", help="comma-separated node hostnames")
    p.add_argument("--nodes-file", help="file of node hostnames, one/line")
    p.add_argument("--username", default="root")
    p.add_argument("--password", default="root")
    p.add_argument("--strict-host-key-checking", action="store_true")
    p.add_argument("--ssh-private-key")
    p.add_argument("--no-ssh", action="store_true",
                   help="don't establish SSH connections (dummy remote)")
    p.add_argument("--concurrency", default="1n",
                   help="worker count; integer with optional n suffix "
                        "(3n = 3 x node count)")
    p.add_argument("--leave-db-running", action="store_true")
    p.add_argument("--logging-json", action="store_true")
    p.add_argument("--test-count", type=int, default=1)
    p.add_argument("--time-limit", type=int, default=60,
                   help="test duration in seconds, excl. setup/teardown")
    p.add_argument("--checker-backend",
                   choices=["auto", "device", "tpu", "host", "native",
                            "sharded", "competition"],
                   default="auto",
                   help="override the linearizable checkers' engine "
                        "(checker.linearizable's backends); auto keeps "
                        "each checker's own")
    p.add_argument("--telemetry", action="store_true",
                   help="collect framework metrics (checker/kernel "
                        "counters, op-latency histograms, phase "
                        "timings) + client spans into the run's store "
                        "directory (metrics.jsonl/.prom, spans.jsonl)")
    p.add_argument("--profile", action="store_true",
                   help="performance attribution (implies --telemetry); "
                        "the port refuses it until its profile module "
                        "lands")
    p.add_argument("--online", action="store_true",
                   help="decide linearizability WHILE the run executes: "
                        "stream ops through the online monitor "
                        "(online.OnlineMonitor), deciding closed "
                        "segments on the batched device search "
                        "concurrently with the workload; writes "
                        "online.json next to the results")
    p.add_argument("--online-abort", action="store_true",
                   help="stop the run at the first invalid segment "
                        "(records ops_to_detection / "
                        "seconds_to_detection); implies --online")
    p.add_argument("--online-engine",
                   choices=["auto", "device", "host"], default="auto",
                   help="segment-deciding engine for --online: the "
                        "batched device pipeline, the host enumerator, "
                        "or auto (device when the model supports it "
                        "and a round batches >1 member); a non-auto "
                        "choice implies --online")
    p.add_argument("--live-port", type=int, default=None,
                   help="serve the results browser in-process for the "
                        "run's duration; the port refuses it until its "
                        "web pages land")
    p.add_argument("--store-root", default=None,
                   help="directory for the store/ tree")
    p.add_argument("--device", default=None,
                   help="torch device of the checkers and the online "
                        "monitor (default: the GPU; 'cpu' runs the "
                        "plain PyTorch version)")


def parse_concurrency(spec: str, n_nodes: int) -> int:
    """'3n' -> 3 * node count (cli.clj:141-156)."""
    m = re.fullmatch(r"(\d+)(n?)", spec)
    if not m:
        raise ValueError(
            f"--concurrency {spec} should be an integer optionally "
            "followed by n")
    return int(m.group(1)) * (n_nodes if m.group(2) else 1)


def parse_nodes(ns: argparse.Namespace) -> list[str]:
    """Merge --node/--nodes/--nodes-file (cli.clj:158-193)."""
    if ns.nodes_file:
        with open(ns.nodes_file) as f:
            return [line.strip() for line in f if line.strip()]
    if ns.nodes:
        return [s.strip() for s in ns.nodes.split(",")]
    if ns.node:
        return list(ns.node)
    return list(DEFAULT_NODES)


def options_map(ns: argparse.Namespace) -> dict:
    """Parsed argparse namespace -> options dict for test_fn."""
    nodes = parse_nodes(ns)
    opts = dict(vars(ns))
    opts["nodes"] = nodes
    opts["concurrency"] = parse_concurrency(ns.concurrency, len(nodes))
    opts["ssh"] = {
        "username": ns.username,
        "password": ns.password,
        "strict-host-key-checking": ns.strict_host_key_checking,
        "private-key-path": ns.ssh_private_key,
        "dummy?": bool(ns.no_ssh),
    }
    return opts


def _apply_std_opts(test: dict, opts: dict) -> dict:
    test = dict(test)
    test.setdefault("nodes", opts["nodes"])
    test.setdefault("concurrency", opts["concurrency"])
    test.setdefault("time-limit", opts["time_limit"])
    if opts.get("leave_db_running"):
        test["leave-db-running?"] = True
    if opts.get("logging_json"):
        test["logging-json"] = True
    if opts.get("telemetry"):
        test["telemetry?"] = True
    if opts.get("profile"):
        # Profiling rides the telemetry registry; the flag implies it.
        test["telemetry?"] = True
        test["profile?"] = True
    # --online-abort / an explicit --online-engine imply --online (the
    # --profile/--telemetry precedent) — silently ignoring them would
    # leave a user believing violation-abort protection is armed.
    if (opts.get("online") or opts.get("online_abort")
            or (opts.get("online_engine") or "auto") != "auto"):
        test["online?"] = True
        if opts.get("online_abort"):
            test["online-abort?"] = True
        if opts.get("online_engine") and opts["online_engine"] != "auto":
            test["online-engine"] = opts["online_engine"]
    if opts.get("live_port") is not None:  # 0 = ephemeral port
        test["live-port"] = int(opts["live_port"])
    if opts.get("store_root"):
        test["store-root"] = opts["store_root"]
    if opts.get("device"):
        test["device"] = opts["device"]
    if opts.get("checker_backend") and opts["checker_backend"] != "auto":
        test["checker_backend"] = opts["checker_backend"]
    test.setdefault("ssh", opts["ssh"])
    return test


def single_test_cmd(test_fn: Callable[[dict], dict],
                    add_opts: Optional[Callable] = None) -> dict:
    """Commands `test` (run + analyze, repeat --test-count times) and
    `analyze` (re-check the latest stored history against a fresh test
    map) — cli.clj:342-418."""

    def run_test(opts) -> int:
        worst = EXIT_OK
        for _ in range(opts["test_count"]):
            test = _apply_std_opts(test_fn(opts), opts)
            result = core.run(test)
            valid = (result.get("results") or {}).get("valid")
            if valid is False:
                return EXIT_INVALID
            if valid == "unknown":
                worst = max(worst, EXIT_UNKNOWN)
        return worst

    def run_analyze(opts) -> int:
        cli_test = _apply_std_opts(test_fn(opts), opts)
        stored = store.latest(root=opts.get("store_root"))
        if stored is None:
            LOG.error("Not sure what the last test was")
            return EXIT_ERROR
        if stored.get("name") != cli_test.get("name"):
            LOG.error(
                "Stored test (%s) and CLI test (%s) have different names; "
                "aborting", stored.get("name"), cli_test.get("name"))
            return EXIT_ERROR
        test = dict(stored)
        test.pop("results", None)
        history = stored.get("history")
        test.update(cli_test)
        test["history"] = history
        test["name"] = stored["name"]
        test["start-time"] = stored["start-time"]
        analyzed = core.analyze(test)
        core.log_results(analyzed)
        valid = (analyzed.get("results") or {}).get("valid")
        if valid is False:
            return EXIT_INVALID
        if valid == "unknown":
            return EXIT_UNKNOWN
        return EXIT_OK

    return {
        "test": {"run": run_test, "add_opts": add_opts, "test_opts": True,
                 "help": "Run the test and analyze the history."},
        "analyze": {"run": run_analyze, "add_opts": add_opts,
                    "test_opts": True,
                    "help": "Re-check the most recent stored history "
                            "(no cluster needed)."},
    }


def test_all_cmd(test_fns: dict,
                 add_opts: Optional[Callable] = None) -> dict:
    """Command `test-all`: sweep a map of name -> test_fn
    (cli.clj:420-502); exit code is the worst across the sweep.
    ``add_opts`` installs the same suite flags the single `test`
    command takes (so a soak can raise --ops etc.)."""

    def run_all(opts) -> int:
        worst = EXIT_OK
        for name, fn in test_fns.items():
            LOG.info("Running test %s", name)
            try:
                test = _apply_std_opts(fn(opts), opts)
                result = core.run(test)
                valid = (result.get("results") or {}).get("valid")
            except Exception:
                LOG.error("Test %s crashed", name, exc_info=True)
                valid = "unknown"
            if valid is False:
                worst = max(worst, EXIT_INVALID)
            elif valid == "unknown":
                worst = max(worst, EXIT_UNKNOWN)
        return worst

    return {"test-all": {"run": run_all, "add_opts": add_opts,
                         "test_opts": True,
                         "help": "Run every test in the suite."}}


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError("must be a positive integer")
    return v


def replay_cmd(model_args: Optional[dict] = None) -> dict:
    """Command ``replay``: re-check every archived history in the store as
    one batched search on the card (BASELINE's batch-replay config; the
    scale version of ``analyze``), through ``parallel.replay.replay_store``.

    ``model_args`` sets the suite's default model kwargs (e.g. a register
    whose DB starts at 0 rather than nil); ``--model-args`` on the command
    line overrides it. ``--device`` picks the torch device (the card by
    default; ``cpu`` runs the plain PyTorch version)."""

    def run_replay(opts) -> int:
        from .parallel.replay import replay_store

        margs = opts.get("model_args")
        summary = replay_store(
            model_name=opts.get("model") or "cas-register",
            root=opts.get("store_root"),
            name=opts.get("test_name") or None,
            limit=opts.get("limit"),
            model_args=json.loads(margs) if margs else None,
            device=opts.get("device"),
        )
        LOG.info("replay summary: %s", json.dumps(
            {k: v for k, v in summary.items() if k != "runs"}))
        for run, valid in (summary.get("runs") or {}).items():
            LOG.info("  %s -> %s", run, valid)
        if summary.get("invalid"):
            return EXIT_INVALID
        if summary.get("unknown"):
            return EXIT_UNKNOWN
        return EXIT_OK

    def add_opts(p):
        p.add_argument("--model", default="cas-register")
        p.add_argument(
            "--model-args",
            default=json.dumps(model_args) if model_args else None,
            help="JSON kwargs for the model, e.g. '{\"init\": 0}' for "
                 "a register whose DB starts at 0 rather than nil")
        p.add_argument("--test-name", default=None,
                       help="only replay runs of this test")
        p.add_argument("--limit", type=_positive_int, default=None,
                       help="replay at most N newest runs")
        p.add_argument("--device", default=None,
                       help="torch device of the batch (default: the GPU; "
                            "'cpu' runs the plain PyTorch version)")
        p.add_argument("--store-root", default=None,
                       help="directory for the store/ tree")

    return {"replay": {"run": run_replay, "add_opts": add_opts,
                       "help": "Batch-recheck every stored history on "
                               "the device."}}


def run(commands: dict, argv: Optional[list] = None) -> int:
    """Dispatch argv against a command map; returns the command's code.
    Merge several command maps with dict-union."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="jepsen-tpu-torch")
    sub = parser.add_subparsers(dest="command")
    for name, spec in commands.items():
        p = sub.add_parser(name, help=spec.get("help"))
        if spec.get("test_opts"):
            add_test_opts(p)
        if spec.get("add_opts"):
            spec["add_opts"](p)
    try:
        ns = parser.parse_args(argv)
    except SystemExit as e:
        return EXIT_BAD_ARGS if e.code not in (0, None) else 0
    if not ns.command:
        parser.print_help()
        return EXIT_BAD_ARGS
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s{%(threadName)s} %(levelname)s %(name)s - "
               "%(message)s")
    spec = commands[ns.command]
    try:
        opts = options_map(ns) if spec.get("test_opts") else dict(vars(ns))
        code = spec["run"](opts)
        return EXIT_OK if code is None else code
    except ValueError as e:
        LOG.error("%s", e)
        return EXIT_BAD_ARGS
    except Exception:
        LOG.error("internal error", exc_info=True)
        return EXIT_ERROR


def main_exit(commands: dict, argv: Optional[list] = None) -> None:
    sys.exit(run(commands, argv))
