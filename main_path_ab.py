#!/usr/bin/env python3
"""Wall time of the port's main path in two checkouts, alternated on one GPU.

    python3 main_path_ab.py OLD_ROOT NEW_ROOT [--pairs 3] [--repeat 2]

Each root is the top of a checkout holding ``jepsen_tpu_torch``. The
script runs one process per turn, in the order old, new, new, old, repeated
``--pairs`` times; each process builds its checkout's kernels, warms up on
a short history, then decides the north-star history (10,000 cas-register
ops, ``random.Random(2026)``) through ``check_history(..., backend="device")``
``--repeat`` times and prints one JSON line of walls. The last line is a
summary per root: every wall, the median, and the levels. It fails if a
verdict is not ``True`` or the two roots disagree on the levels.
"""

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time

NORTH_STAR = dict(n_ops=10000, n_procs=10, cas=True, crash_p=0.002, fail_p=0.02)
NORTH_STAR_SEED = 2026


def one(root: str, repeat: int) -> dict:
    """Time the main path of the checkout at ``root`` in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.models import CasRegister
    from jepsen_tpu_torch.ops import wgl
    from jepsen_tpu_torch.testing import random_register_history

    if not torch.cuda.is_available():
        raise SystemExit("main_path_ab: CUDA is not available")
    _build.load()
    model = CasRegister(init=0)
    warm = random_register_history(random.Random(0), n_ops=500, n_procs=10, cas=True)
    wgl.check_history(model, warm, backend="device")
    hist = random_register_history(random.Random(NORTH_STAR_SEED), **NORTH_STAR)
    walls, levels = [], None
    for _ in range(repeat):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = wgl.check_history(model, hist, backend="device")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if res["valid"] is not True:
            raise AssertionError(f"north-star history not accepted: {res['valid']}")
        levels = res["levels"]
    return {"root": root, "walls_s": walls, "levels": levels,
            "ms_per_level": [1e3 * w / levels for w in walls]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(one(a.one, a.repeat)), flush=True)
        return 0
    if len(a.roots) != 2:
        ap.error("give two checkout roots: OLD_ROOT NEW_ROOT")
    old, new = a.roots
    runs = {old: [], new: []}
    for _ in range(a.pairs):
        for root in (old, new, new, old):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root,
                                  "--repeat", str(a.repeat)], capture_output=True, text=True,
                                 timeout=600)
            if out.returncode != 0:
                sys.stderr.write(out.stderr)
                raise SystemExit(f"main_path_ab: the run of {root} failed")
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs[root].append(line)
    levels = {r: {x["levels"] for x in v} for r, v in runs.items()}
    if levels[old] != levels[new] or len(levels[old]) != 1:
        raise AssertionError(f"levels differ: {levels}")
    summary = {}
    for r, v in runs.items():
        walls = [w for x in v for w in x["walls_s"]]
        summary[r] = {"walls_s": walls, "median_s": statistics.median(walls),
                      "levels": v[0]["levels"]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
