"""CLI: check a raw trace recording of an unmodified system.

::

    python -m jepsen_tpu_torch.ingest TRACE --adapter etcd \
        --check auto|segmented|elle [--engine auto|device|host|sharded] \
        [--reorder-window-ns N] [--columns '{"time": "ts"}'] \
        [--model-init '{"a": 10}'] [--device cpu] [-o OUT.json]

Each input line is one raw trace record in the adapter's native
dialect (etcd proxy ndjson, redis MONITOR text, zookeeper txn-log
lines, mongodb oplog ndjson, or generic column-mapped jsonl; the
reference's ``docs/ingest.md`` has the table). The segmented pipeline's
device oracle and the Elle engine run on the card unless ``--device
cpu``. Exit codes match ``jepsen_tpu_torch.offline``: 0 valid, 2 invalid,
1 unknown (including any trace with unmapped lines — the one-sided fold).
An error that leaves no verdict (a corrupt recording, a kernel that
fails to build, a ``ValueError`` from the device oracle) prints its
traceback and exits 255, never 1: it is not an unknown verdict.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

from ..cli import EXIT_ERROR
from ..telemetry import Registry
from . import ADAPTERS, DEFAULT_REORDER_WINDOW_NS, ingest_check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.ingest",
        description="Parse a recording of a real, unmodified system "
                    "and check the recovered history.")
    ap.add_argument("trace", help="raw trace file, or - for stdin")
    ap.add_argument("--adapter", default="jsonl",
                    choices=sorted(ADAPTERS))
    ap.add_argument("--check", default="auto",
                    choices=["auto", "segmented", "elle"])
    ap.add_argument("--engine", default="auto",
                    help="WGL engine for --check segmented")
    ap.add_argument("--reorder-window-ns", type=int,
                    default=DEFAULT_REORDER_WINDOW_NS,
                    help="bounded repair window for out-of-order "
                         "recordings; older stragglers raise")
    ap.add_argument("--columns", default=None,
                    help="JSON column mapping for --adapter jsonl")
    ap.add_argument("--model-init", default=None,
                    help="JSON model constructor data (e.g. the "
                         "bank's account map)")
    ap.add_argument("--device", default=None,
                    help="torch device of the device oracle and the Elle "
                         "engine (default: the GPU)")
    ap.add_argument("-o", "--out", default=None,
                    help="write the result JSON here (default stdout)")
    args = ap.parse_args(argv)

    adapter_opts = {}
    if args.columns:
        if args.adapter != "jsonl":
            ap.error("--columns only applies to --adapter jsonl")
        adapter_opts["columns"] = json.loads(args.columns)
    model_init = json.loads(args.model_init) if args.model_init else None

    f = sys.stdin if args.trace == "-" else open(args.trace)
    try:
        res = ingest_check(
            f, args.adapter, check=args.check, engine=args.engine,
            reorder_window_ns=args.reorder_window_ns,
            model_init=model_init, metrics=Registry(),
            adapter_opts=adapter_opts, device=args.device)
    except Exception:
        traceback.print_exc()
        return EXIT_ERROR
    finally:
        if args.trace != "-":
            f.close()

    doc = json.dumps(res, indent=2, sort_keys=True, default=str)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(doc + "\n")
    else:
        print(doc)
    v = res.get("valid")
    return 0 if v is True else 2 if v is False else 1


if __name__ == "__main__":
    sys.exit(main())
