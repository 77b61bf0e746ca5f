"""CLI framework: the command runner and the ``replay`` command.

The port of the reference's ``jepsen_tpu/cli.py`` (jepsen.cli,
jepsen/src/jepsen/cli.clj), trimmed to what runs without a test runner: a
suite hands :func:`run` a map of commands and gets the reference's exit
codes (cli.clj:120-130)::

    0    all tests passed
    1    some test failed (results invalid)
    2    some test had unknown validity
    254  invalid arguments
    255  internal error

A command takes only the options it reads. The reference's standard test
options (test-opt-spec, cli.clj:55-102: nodes, SSH, concurrency, time
limit, checker backend, telemetry, online monitoring) come with the
commands that run tests (``test``, ``analyze``, ``test-all``) and the
results server (``serve``), which need the test runner and the web pages
the port does not hold yet; :func:`replay_cmd` is the one command here.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional

LOG = logging.getLogger("jepsen.cli")

EXIT_OK = 0
EXIT_INVALID = 1
EXIT_UNKNOWN = 2
EXIT_BAD_ARGS = 254
EXIT_ERROR = 255


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
        code = spec["run"](dict(vars(ns)))
        return EXIT_OK if code is None else code
    except ValueError as e:
        LOG.error("%s", e)
        return EXIT_BAD_ARGS
    except Exception:
        LOG.error("internal error", exc_info=True)
        return EXIT_ERROR


def main_exit(commands: dict, argv: Optional[list] = None) -> None:
    sys.exit(run(commands, argv))
