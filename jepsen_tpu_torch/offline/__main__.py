"""CLI: decide a recorded ndjson history offline.

::

    python -m jepsen_tpu_torch.offline HISTORY.ndjson --model cas-register \
        --engine auto --streams 8 --backends 0 [--keyed] [--device cpu] \
        [-o OUT.json]

Each input line is one op map (``type``, ``process``, ``f``, ``value``,
``time``, ``index``). ``--keyed`` reads two-element list values as
``independent`` [k v] pairs (JSON cannot tell a vector value from a
key/value pair). The device engines run on the card unless ``--device
cpu``, in this process and in every backend process. ``--backends N``
spawns N backend service processes behind the tenant router and fans the
plan's streams across them; ``--backends 0`` (the default) decides
in-process through the shared multi-stream scheduler. The exit code is 0
for a valid history, 2 for an invalid one and 1 for unknown.
"""

from __future__ import annotations

import argparse
import json
import sys

from .. import independent as ind
from ..models import known_models, model_by_name
from ..telemetry import Registry
from . import ENGINES, check_offline


def _load_ndjson(path: str, keyed: bool) -> list:
    ops = []
    f = sys.stdin if path == "-" else open(path)
    try:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if keyed and isinstance(row.get("value"), list) and len(row["value"]) == 2:
                row = dict(row, value=ind.KV(*row["value"]))
            ops.append(row)
    finally:
        if path != "-":
            f.close()
    return ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.offline",
        description="Decide a recorded ndjson history with the decrease-and-conquer "
                    "segment planner.")
    ap.add_argument("history", help="ndjson history file, or - for stdin")
    ap.add_argument("--model", default="cas-register", choices=sorted(known_models()))
    ap.add_argument("--engine", default="auto", choices=list(ENGINES))
    ap.add_argument("--streams", type=int, default=0,
                    help="fan-out width (0 = one per key, at most 8)")
    ap.add_argument("--backends", type=int, default=0,
                    help="spawn N router backend processes and fan the streams "
                         "across them (0 = in-process)")
    ap.add_argument("--keyed", action="store_true",
                    help="treat 2-element list values as [k v] pairs")
    ap.add_argument("--max-configs", type=int, default=500_000)
    ap.add_argument("--device", default=None,
                    help="torch device of the device engines (default: the GPU)")
    ap.add_argument("-o", "--out", default=None,
                    help="write the result JSON here (default stdout)")
    args = ap.parse_args(argv)

    model = model_by_name(args.model)
    ops = _load_ndjson(args.history, args.keyed)
    streams = args.streams if args.streams >= 1 else \
        max(args.backends, 8) if args.backends else 8
    res = check_offline(model, ops, streams=streams, engine=args.engine,
                        backends=args.backends, metrics=Registry(),
                        max_configs=args.max_configs, device=args.device)
    doc = json.dumps(res, indent=2, sort_keys=True, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    else:
        print(doc)
    v = res.get("valid")
    return 0 if v is True else 2 if v is False else 1


if __name__ == "__main__":
    sys.exit(main())
