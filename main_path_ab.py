#!/usr/bin/env python3
"""Wall time of one of the port's paths in two checkouts, alternated on one GPU.

    python3 main_path_ab.py OLD_ROOT NEW_ROOT [--path north_star] [--pairs 3] [--repeat 2]

Each root is the top of a checkout holding ``jepsen_tpu_torch``. The
script runs one process per turn, in the order old, new, new, old, repeated
``--pairs`` times; each process builds its checkout's kernels, warms up on
a short history, then runs the path ``--repeat`` times and prints one JSON
line of walls. The paths:

- ``north_star`` (the default): the north-star history (10,000
  cas-register ops, ``random.Random(2026)``) through
  ``check_history(..., backend="device")``; its result is the levels, and
  the verdict must be ``True``;
- ``elle_append_8k``: ``chip_smoke.py``'s 8000-txn list-append history
  through ``elle.append.check`` with the process graph (six masks at
  bucket 8192 on the closure kernels);
- ``elle_sharded_20k``: its 20,000-txn history through
  ``elle.append.check(..., mesh=make_mesh(8))`` (three closures at pad
  32768 on the sharded-closure kernels);
- ``level_kernels``: every stage of one level alone, each through its
  checkout's own wrapper and arguments (its level program's,
  ``_level_stages``; a stage that runs more than once a level is summed,
  and a parent's index-reset copies are timed as ``reset``), at
  ``chip_smoke.py``'s frontiers: the north star's at F 4096 (800 beam
  levels) and at F 1024 (a single-stage level: M = 32768), the eight
  10k-op members' at F 8192, each other device model family's at F 4096
  (200 levels) and the mutex_5k history's at F 16 (its capacity, 200
  levels, single-stage). Device ms a call as
  ``chip_smoke.py`` times them (``batch_ms``, from the checkout's own
  script), with the sums over the dedup stages (``dedup_ms``: from stage
  1 to the prune), over the stages after the prune
  (``compaction_gather_ms``) and over the level (``level_ms``); the
  result is each case's checksums (per member the expand's NEXP and
  valid rows, the prune's keep count and the sum of its valid rows'
  priorities, and
  after the gather-finalize the control block's level, frontier count,
  go flag and frontier peak and the sums of the new frontier's p and
  valid), which must agree between the two checkouts; then the sharded
  level of ``chip_smoke.py``'s ``sharded_kernels`` in each mode (the north
  star's frontier at F 4096 laid on 8 shards of 512 rows, lossy), every
  stage of its own level program timed and summed the same way;
- ``sharded_10k``: ``chip_smoke.py``'s ``SHARD_10K`` history (10,000
  cas-register ops, ``random.Random(2032)``: the reference bench leg's)
  through ``parallel.frontier.check_encoded_sharded`` on 8 shards at a
  global capacity of 4096, in both exchange modes: each mode's walls,
  levels enqueued and ms per enqueued level, then one run under
  ``torch.profiler`` for the device's busy time (the sum of the kernels'
  device time) and its idle share (1 - busy / the median wall); the
  result is each mode's verdict and levels.

The Elle paths' result is the verdict and the anomaly types, and each line
also gives the closures' share of the wall (``closure_s``: the time inside
the closure entry point, ending in a synchronize). The last line is a
summary per root: every wall, the median, and the result. It fails if the
two roots disagree on the result.
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
# chip_smoke.py's Elle histories (APPEND_8K, APPEND_20K there).
APPEND_8K = dict(seed=11, n_txns=8000, lag=(0, 8000), depth=16)
APPEND_20K = dict(seed=11, n_txns=20000, lag=(8000, 11000), depth=16)
ELLE_WARM = dict(seed=5, n_txns=2000, lag=(600, 1100), depth=8)
# chip_smoke.py's SHARD_10K (its seed apart), on SHARD_D shards at SHARD_F_TOTAL.
SHARD_10K = dict(n_ops=10000, n_procs=10, cas=True, crash_p=20 / 10000, fail_p=0.02)
SHARD_10K_SEED = 2032
SHARD_D, SHARD_F_TOTAL = 8, 4096
PATHS = ("north_star", "elle_append_8k", "elle_sharded_20k", "level_kernels", "sharded_10k")


def one(root: str, repeat: int, path: str = "north_star") -> dict:
    """Time ``path`` in the checkout at ``root`` in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from jepsen_tpu_torch import _build

    if not torch.cuda.is_available():
        raise SystemExit("main_path_ab: CUDA is not available")
    _build.load()
    if path == "level_kernels":
        return level_kernels(root)
    if path == "sharded_10k":
        return sharded_10k(root, repeat)
    if path != "north_star":
        return elle(root, repeat, path)
    from jepsen_tpu_torch.models import CasRegister
    from jepsen_tpu_torch.ops import wgl
    from jepsen_tpu_torch.testing import random_register_history

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
    return {"root": root, "walls_s": walls, "result": levels,
            "ms_per_level": [1e3 * w / levels for w in walls]}


def elle(root: str, repeat: int, path: str) -> dict:
    """An Elle path: walls, the time inside the closure entry point, and
    the verdict with the anomaly types."""
    import torch

    from jepsen_tpu_torch.elle import append
    from jepsen_tpu_torch.elle import ops as eo
    from jepsen_tpu_torch.parallel import make_mesh
    from jepsen_tpu_torch.testing import lagged_append_history

    name = "sharded_closure" if path == "elle_sharded_20k" else "batched_closure"
    inner = getattr(eo, name)
    closure_s = [0.0]

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        closure_s[0] += time.perf_counter() - t
        return out

    setattr(eo, name, timed)
    if path == "elle_sharded_20k":
        run = lambda h: append.check(h, mesh=make_mesh(8))  # noqa: E731
        hist = lagged_append_history(**APPEND_20K)
    else:
        run = lambda h: append.check(h, device=None, additional_graphs=("process",))  # noqa: E731
        hist = lagged_append_history(**APPEND_8K)
    run(lagged_append_history(**ELLE_WARM))
    walls, closures, result = [], [], None
    for _ in range(repeat):
        closure_s[0] = 0.0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run(hist)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        closures.append(closure_s[0])
        result = [res["valid"], sorted(res["anomaly_types"])]
    return {"root": root, "walls_s": walls, "closure_s": closures, "result": result}


def sharded_10k(root: str, repeat: int) -> dict:
    """The sharded_10k path: each mode's walls, levels enqueued, ms per
    level, device busy time and idle share; the result is each mode's
    verdict and levels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jepsen_tpu_torch.models import CasRegister
    from jepsen_tpu_torch.ops import wgl_level as lv
    from jepsen_tpu_torch.ops.encode import encode_history
    from jepsen_tpu_torch.parallel import frontier, make_mesh
    from jepsen_tpu_torch.testing import random_register_history

    model = CasRegister(init=0)
    enc = encode_history(model, random_register_history(random.Random(SHARD_10K_SEED),
                                                        **SHARD_10K))
    warm = encode_history(model, random_register_history(random.Random(0), n_ops=500,
                                                         n_procs=10, cas=True))
    out = {"root": root, "walls_s": [], "modes": {}, "result": {}}
    for mode in ("alltoall", "allgather"):
        def run(e, mode=mode):
            res = frontier.check_encoded_sharded(e, mesh=make_mesh(SHARD_D),
                                                 f_total=SHARD_F_TOTAL, exchange=mode)
            torch.cuda.synchronize()
            return res

        run(warm)
        walls = []
        for _ in range(repeat):
            lv.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run(enc)
            walls.append(time.perf_counter() - t)
        levels = lv.LAUNCHES["wgl_expand"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(enc)
        busy = sum((getattr(e, "self_device_time_total", 0) or 0) / 1e3
                   for e in prof.key_averages()
                   if "cuda" in str(getattr(e, "device_type", "")).lower())
        wall_ms = 1e3 * statistics.median(walls)
        out["modes"][mode] = {"walls_s": walls, "levels_enqueued": levels,
                              "ms_per_level": [1e3 * w / levels for w in walls],
                              "busy_ms": busy, "busy_ms_per_level": busy / levels,
                              "idle_share": 1 - busy / wall_ms if busy else None}
        out["result"][mode] = [res["valid"], res.get("levels")]
        out["walls_s"] += walls
    return out


def _level_cases(cs, lv, wgl):
    """level_kernels' cases: (label, geometry, tables, frontier, workspace
    with its control blocks at the level's start, model)."""
    import torch

    from jepsen_tpu_torch.models import CasRegister
    from jepsen_tpu_torch.ops.encode import encode_history
    from jepsen_tpu_torch.testing import (history_model, random_lock_history,
                                          random_register_history)

    cas = CasRegister(init=0)
    hist = random_register_history(random.Random(NORTH_STAR_SEED), **NORTH_STAR)
    north = encode_history(cas, hist)
    mutex = history_model("owner-aware-mutex")
    lock = random_lock_history(random.Random(cs.MUTEX_5K["seed"]), n_ops=cs.MUTEX_5K["n_ops"],
                               n_procs=cs.MUTEX_5K["n_procs"])
    cases = [("north_star", cas, [north], 4096, cs.WARM_LEVELS),
             ("north_star_F1024", cas, [north], 1024, cs.WARM_LEVELS),
             ("batch_8x8192", cas, [encode_history(cas, h)
                                    for h in cs.big_histories(random_register_history)],
              8192, cs.WARM_LEVELS)]
    for name, (good, _bad) in cs.model_histories().items():
        model = history_model(name)
        cases.append((name, model, [encode_history(model, good)], 4096, cs.MODEL_WARM_LEVELS))
    cases.append(("mutex_5k", mutex, [encode_history(mutex, lock)], 16, cs.MODEL_WARM_LEVELS))
    for label, model, encs, F, warm in cases:
        plan = cs.batch_plan(encs, wgl)
        g = wgl.level_geometry(plan, F)
        fr, ws, lvls = cs.warm_frontier(plan, F, lv, wgl, model, warm)
        nb = plan.nb
        ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32, device="cuda")
        cs.start_ctl(lv, ctl, fr, lvls, plan)
        ws.ctl.copy_(ctl)
        yield label, g, plan.tabs, fr, ws, model
    # the sharded level of chip_smoke's sharded_kernels, each mode
    single = wgl.stack_plans([wgl.plan_device(north, device="cpu")], "cuda")
    fr1, _ws, (lvl,) = cs.warm_frontier(single, SHARD_F_TOTAL, lv, wgl, cas)
    for mode in ("alltoall", "allgather"):
        fr = cs.shard_frontier(fr1, SHARD_D)
        plan, g, tabs = cs.sharded_setup(lv, wgl, north, SHARD_F_TOTAL, SHARD_D, mode, cas)
        ws = lv.BatchWorkspace(g, SHARD_D, "cuda")
        ws.ctl.copy_(cs.sharded_ctl(lv, g, plan, fr, lvl, lossy=True))
        yield f"sharded_{mode}", g, tabs, fr, ws, cas


def level_kernels(root: str) -> dict:
    """The level_kernels path: {case: {stage: ms}} of every stage of one
    level, and each case's checksums as the result."""
    import torch

    import chip_smoke as cs
    from jepsen_tpu_torch.ops import wgl
    from jepsen_tpu_torch.ops import wgl_level as lv

    times, result = {}, {}
    for label, g, tabs, fr, ws, model in _level_cases(cs, lv, wgl):
        sums, row = [], {}
        # the buffers a stage may both read and write: each timed call
        # gets its own copies of those it takes
        mutable = [ws.ctl, ws.keys, ws.perm, ws.fprio, ws.stats, *fr]
        mutable += [ws.order] if hasattr(ws, "order") else []  # a parent's
        part = "dedup"
        for stage, args in lv._level_stages(g, tabs, fr, ws, model):
            ins = tuple(t for t in _tensors(args) if any(t is m for m in mutable))
            call = lambda t, s=stage, a=args, i=ins: _run_stage(  # noqa: E731
                lv, s, _subst(a, {id(x): y for x, y in zip(i, t)}))
            ms = cs.batch_ms(call, ins)[0]
            for key in (f"{stage}_ms", "level_ms") + (() if stage == "expand" else (
                    "compaction_gather_ms" if part == "tail" else "dedup_ms",)):
                row[key] = row.get(key, 0.0) + ms
            _run_stage(lv, stage, args)
            if stage == "expand":
                sums.append(ws.ctl[:, lv.CTL_NEXP].tolist())
                sums.append((ws.nvalid != 0).sum(dim=1).tolist())
            if stage == "prune":
                sums.append(ws.ctl[:, lv.CTL_COUNT].tolist())
                # the valid rows' priorities (sorted keys without the sign
                # bit): an invalid slot's row is not written by the expand
                # and its priority is read by no stage
                sums.append((ws.fprio.to(torch.int64) * (ws.keys >= 0)).sum(dim=1).tolist())
                part = "tail"
            if stage == "gather_finalize":
                sums.append(ws.ctl[:, [lv.CTL_LVL, lv.CTL_FCOUNT, lv.CTL_GO, lv.CTL_FMAX]]
                            .tolist())
                sums.append([fr[0].to(torch.int64).sum(dim=1).tolist(),
                             fr[4].to(torch.int64).sum(dim=1).tolist()])
        torch.cuda.synchronize()
        row["valid_configs"] = int(fr[4].sum())
        times[label], result[label] = row, sums
    return {"root": root, "walls_s": [], "kernels": times, "result": result}


def _tensors(args):
    """The tensors among a stage's arguments, tuples (the frontier) opened."""
    import torch

    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, tuple):
            yield from _tensors(a)


def _subst(args, swap: dict):
    """A stage's arguments with each tensor whose id is in ``swap`` replaced."""
    if isinstance(args, tuple):
        return tuple(_subst(a, swap) for a in args)
    return swap.get(id(args), args)


def _run_stage(lv, stage, args) -> None:
    """One stage of a checkout's level program on the kernels (a parent's
    ``reset`` copies its second argument into its first)."""
    if stage == "reset":
        args[0].copy_(args[1])
    else:
        getattr(lv.KERNELS, stage)(*args)


def _median_or_none(xs):
    """The median of the values that are not None (the profiler may see
    no device time), or None."""
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--path", choices=PATHS, default="north_star")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(one(a.one, a.repeat, a.path)), flush=True)
        return 0
    if len(a.roots) != 2:
        ap.error("give two checkout roots: OLD_ROOT NEW_ROOT")
    old, new = a.roots
    runs = {old: [], new: []}
    for _ in range(a.pairs):
        for root in (old, new, new, old):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root,
                                  "--repeat", str(a.repeat), "--path", a.path],
                                 capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                sys.stderr.write(out.stderr)
                raise SystemExit(f"main_path_ab: the run of {root} failed")
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs[root].append(line)
    results = {r: {json.dumps(x["result"]) for x in v} for r, v in runs.items()}
    if results[old] != results[new] or len(results[old]) != 1:
        raise AssertionError(f"results differ: {results}")
    summary = {}
    for r, v in runs.items():
        if "modes" in v[0]:  # sharded_10k: the medians of each mode
            summary[r] = {m: {"walls_s": [w for x in v for w in x["modes"][m]["walls_s"]],
                              **{k: _median_or_none([x["modes"][m][k] for x in v])
                                 for k in ("busy_ms_per_level", "idle_share")},
                              "levels_enqueued": v[0]["modes"][m]["levels_enqueued"]}
                          for m in v[0]["modes"]}
            for m, row in summary[r].items():
                row["median_s"] = statistics.median(row["walls_s"])
                row["median_ms_per_level"] = 1e3 * row["median_s"] / row["levels_enqueued"]
            summary[r]["result"] = v[0]["result"]
            continue
        if "kernels" in v[0]:  # level_kernels: the median of each case's ms
            summary[r] = {c: {k: statistics.median(x["kernels"][c][k] for x in v)
                              for k in v[0]["kernels"][c]} for c in v[0]["kernels"]}
            continue
        walls = [w for x in v for w in x["walls_s"]]
        summary[r] = {"walls_s": walls, "median_s": statistics.median(walls),
                      "result": v[0]["result"]}
        if "closure_s" in v[0]:
            closures = [c for x in v for c in x["closure_s"]]
            summary[r].update(closure_s=closures, closure_median_s=statistics.median(closures))
    print(json.dumps({"summary": summary, "path": a.path}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
