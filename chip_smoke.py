#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``jepsen_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``jepsen_tpu_torch/csrc`` with ``nvcc``
and then runs these phases, each printing JSON lines:

- ``kernels``: every stage of one level, kernel against its plain PyTorch
  version bit for bit, at several capacities of the north-star history
  (a 10,000-op cas-register history), plus the radix sort on random keys;
  the level's stages are the expand, stage 1 (a two-stage level's: a
  single-stage level's expand writes the fused keys, checked against the
  plain hash of its rows and timed beside the parent's hash launch, the
  yardstick ``k_hash``), one take-col sort a dedup key (the first from the
  identity order), the prune, the compaction sort (which carries the dedup
  order as its values) and the one-launch gather-finalize; the regroup
  (one launch) beside its parent's five launches;
- ``radix_sort_sweep``: the radix sort at 1 to 1,048,576 pairs, 1, 3 and
  8 members, on each key family of ``testing.SORT_KEY_FAMILIES``, bit for
  bit against the plain sort, with its ms beside ``torch.sort``'s, its
  bound and the path it takes; both paths at the sizes one block holds,
  and the device launches of one call at each size;
- ``stage1_sweep``: the stage-1 compaction and hash alone at 1 to 262,144
  rows (around the smallest tile, the main path's 131,072 and the batch's
  262,144), 1, 3 and 8 members and each validity density of
  ``testing.STAGE1_DENSITIES``, both arms (with the key, and the
  compaction alone), bit for bit under its contract against the plain
  version, with ms, bound and share of the bound; the device launches of
  one call of each arm (counted from a stream capture: one); every tile
  size at the main path's and the batch's shapes;
- ``prune_sweep``: ``wgl_prune`` alone at 64 to 1,048,576 rows a member
  (the main path's 16384, the batch's 32768, the allgather arm's
  1,048,576), 1, 3 and 8 members and each group family of
  ``testing.PRUNE_FAMILIES``, bit for bit against the plain prune, with
  its ms, bound and share of the bound, the device launches of one call
  (counted from a stream capture: one), and every tile at the main path's
  and the batch's shapes;
- ``steady_state``: device busy time, idle share and device launches per
  level (the launches counted from a stream capture of one level, plus the
  window's control-block reads);
- ``main_path``: the north-star history decided through
  ``check_history(..., backend="device")`` with every kernel's launch
  count checked, then the same search through the plain versions on the
  card (same verdict, levels, rungs and per-level rows);
- ``telemetry``: the drivers' telemetry, chunk callbacks and checkpoints:
  the north star with a ``Registry``, a callback and a checkpoint,
  interrupted by the callback after its first chunk at the beam's top
  capacity and resumed (``True`` at the main path's level, its per-level
  rows, the file deleted); sharded_10k's first chunk saved under
  alltoall and resumed under allgather (the uninterrupted allgather
  search's verdict, rungs and cause, the saved level's levels not run
  again); the north star's wall with and without ``metrics``, in turns;
- ``refutation`` and ``driver_paths``: a perturbed history refuted in
  agreement with the host oracle, and a small search that takes every
  driver path, each against the plain path;
- ``kernels_batch``: every stage on the member axis and the regroup,
  kernel against plain, at nb = 8, F = 8192 and nb = 3, F = 64;
- ``gather_sort_scale``: the two kernels that fold the level's index
  work into their neighbours, at the north star's (F 4096) and the
  batch's (8 x 8192) level inputs from ``kernels``/``kernels_batch``:
  ``wgl_take_col_sort`` (identity and read values) beside the parent
  design it replaces (a ``take_col`` launch, then ``radix_sort_pairs``;
  the parent's kernels are built from ``yardsticks/wgl_parent.cu``, which
  only this script compiles, into a library apart from the port's),
  ``radix_sort_pairs`` alone on the same keys and ``index_select`` +
  ``torch.sort``; the one-launch ``wgl_gather_finalize`` beside the
  parent's gather and finalize launches (the yardstick) and
  ``index_select`` of the F kept rows;
  both bit for bit against their plain versions (the yardsticks too),
  with the device launches of one call; and the take-col sort alone at
  1 to 1,048,576 pairs (1 and 8 members, both ``ident`` settings, random
  and all-equal keys), with the same yardsticks;
- ``chunk_start``: the chunk start (``wgl_chunk_init``, one launch: the
  control blocks from values in its parameters, the stats rings zeroed,
  the count, the stop test, the sharded reduce) at the north star's F
  1024 and 4096, the batch's 8 x 8192, batch_replay_100's 100 x 64 and
  the sharded start (8 x 512), each with stopped members, bit for bit
  against its plain version and beside the parent's whole start (the
  control blocks built on the host and copied in, a memset, the count
  launch from the yardsticks and the host's read of the control blocks
  before the first level), which must agree: the kernel's device ms
  beside the parent's count launch alone, both starts' spans as the
  device sees them, both host walls to the first level's enqueue, the
  device operations of a start by stream capture; a 200-member batch's
  ladder table over three chunks; and what a chunk that starts stopped
  costs;
- ``batch_replay_100``: 100 histories decided by ``check_batch``, by the
  keyed ``independent.checker(linearizable(...))``, by the plain path and
  by the host oracle, in agreement; every keyed result comes from the
  batch, with the same launch counts as ``check_batch``'s and fewer
  levels enqueued than the members' summed levels;
- ``batch_mesh``: the same 100 histories through ``check_batch`` on a
  mesh of 8 shards and of 3 (4 and 2 padding copies), each result equal
  to the batch's without a mesh but for the rungs' calls and members;
- ``batch_8x10k``: eight north-star-shaped histories through the batch's
  escalation ladder (256 -> 2048 -> 8192): never False, definite
  verdicts agreeing with each member's own single search, and each
  member's result the same with the batch in reverse order;
- ``store_replay``: BASELINE config 5 through its own entry point, in a
  temporary store, the C EDN reader built first and its seconds printed
  apart: (a) batch_replay_100's histories saved as 100 runs
  (``store.save_1``) and replayed by ``cli.run(cli.replay_cmd(...),
  ["replay", "--store-root", root])`` (the exit code the in-memory verdicts
  imply, a ``rechecked.edn`` for every run agreeing with the host oracle
  wherever definite, and ``parallel.replay.replay`` at ``f`` 64 giving the
  in-memory batch's keys); (b) the eight 10k histories saved and replayed
  (each member's keys equal to an in-memory ``check_encoded_batch`` with
  replay's arguments), with the save, load-and-parse (and which EDN reader
  ran: ``edn_fast`` or the Python reader, and why), encode, decide and
  write walls (the replay's ``replay.*`` trace spans, as for (a)); (c) the refutation's ``linear.txt``/``linear.svg`` from the
  card equal to those the checker writes with ``device="cpu"``; (d) an
  anomalous append history's ``elle/<anomaly>.txt`` files from the card
  equal to the CPU's; (e) ``keyed_multi_register``'s history through
  ``independent.checker(linearizable)``: ``independent/<k>/`` for every
  key; each path's launch counts;
- ``model_kernels``: every other device model family's step in
  ``wgl_expand`` against the plain expand (the model's ``step_torch``) bit
  for bit, at the selected and unselected layouts, from a frontier warmed
  for 200 levels on a 2000-op history of the family; at state widths 2, 3,
  4 and 8 every downstream stage too;
- ``expand_scale``: ``wgl_expand`` at the north star's and the batch's
  warmed frontiers, bit for bit against the plain expand (each member's
  ``ctl[CTL_NEXP]`` its count of valid rows), with its ms, its ms with
  every member stopped, its bound and the device launches of one call,
  beside each family's ms from ``model_kernels``;
- ``mutex_5k``: BASELINE config 3, a 5000-op owner-aware-mutex history
  through the lock workload's checker (``workloads.lock.checker``), in
  agreement with the plain path, with wall, ms/level and idle share;
- ``models_2k``: a valid and a perturbed 2000-op history of each family
  through ``check_history(..., backend="device")``: valid ones ``True`` (or
  ``unknown`` through the top-rung beam, never ``False``, and then held
  against the plain path's whole search: rungs, levels, per-level rows),
  perturbed ones refuted in agreement with the plain path and the host
  oracle;
- ``keyed_multi_register``: 100 keys of multi-register ops through the
  keyed checker (the batch at ``S = 3``), agreeing with ``check_batch``,
  the plain path and the host oracle, and the ``compose`` wiring checked
  key by key with the same results;
- ``native``: the native C search (``jepsen_tpu_torch/native/wgl_native.c``,
  built with ``cc`` into ``jepsen_tpu_torch/_build/``; the phase fails
  without a compiler): the north star through
  ``check_history(..., backend="native")`` ``True``, its perturbed twin
  (``perturb_history(Random(7), ...)``, as ``bench.py:268``) decided with
  its witness and in agreement with the device search wherever that is
  definite; 3 timed runs of each (minimum and median) with
  ``configs_explored``, the C call's own wall and the seconds spent in
  Python's garbage collector, the host CPU and ``os.cpu_count()``;
- ``auto``: ``backend="auto"`` decides the north star (3 timed runs, as
  under ``native``) and mutex_5k's history on the C search, and runs the 2000-op valid history of each
  family with no step in it (multi-register, counter, set, bank) on the
  card: ``device`` and ``torch_device`` ``cuda``, every level kernel
  launched, one level of that search's own level program counted from a
  stream capture (``testing.device_work``), and the verdict of
  ``backend="device"`` (the oracle those unknowns fall back to is held to
  ``AUTO_HOST_CONFIGS``, and must end unknown on that budget); a history
  whose device search ends unknown is decided by the host oracle, with
  ``device_attempt``;
- ``competition``: ``backend="competition"`` on the north star: with
  ``native_max_configs=1`` the device side decides (final level 7256 and
  the main path's per-level rows, every kernel launched), at the default
  budgets a definite ``True`` (the winning engine and the race's wall
  beside the C side alone and the device search alone, in turns, with
  the device side's chunks and levels in each race: at least one chunk
  launched, and no error from either side), the first case again
  straight after the races, and the perturbed twin in agreement with the
  native verdict (no error from either side, at least one device chunk);
  then the device search alone and with the race's C side searching the
  twin beside it, in ``CONTENTION_TURNS`` pairs (walls, each pair's
  ratio, and the device's idle
  share under the profiler in the last pair);
- ``elle_append_8k``: an 8000-txn list-append history (reads lag up to
  16 txns) through ``elle.append.check`` with the process graph: one
  chunk of 6 masks at bucket 8192 on the closure kernels, the result map
  and the packed closures equal to the plain path's on the card;
- ``elle_kernels``: the three closure kernels against their plain
  versions bit for bit (nb = 3 at pad 128, 1024, 8192 and random graphs
  at pad 256, and the 8k history's six masks), with device times;
- ``elle_append_20k``: 20000 txns, above the bucket ceiling: the
  ``elle_bucket_ceiling`` cause, the host taxonomy, and ``SccReach``
  closing the lag window's component on the kernels;
- ``elle_lag_2k``, ``big_scc_4096``, ``elle_scc_batched`` and
  ``elle_wr_4k``: the device engine against the host path (or the plain
  path) on a lagged history, a 4096-ring, 32 co-batched graphs and a
  rw-register history;
- ``elle_sharded_8k``: the 8k history through ``elle.append.check(...,
  mesh=make_mesh(D))`` on 1, 2 and 8 shards (packed) and on 8 (dense):
  the bucketed result map, and every mask's closure equal to the bucketed
  kernels' and the plain path's;
- ``elle_sharded_20k``: the 20k history on 8 shards in both modes, every
  closure (pad 32768) on the sharded-closure kernels: no cause, the host
  taxonomy's result map, the two modes' closures equal;
- ``elle_sharded_kernels``: the sharded closure's four kernels against
  their plain versions bit for bit at pad 256, 8192 and 32768 (D = 8),
  with device times;
- ``elle_square_sweep``: the square kernel at every bucket pad, on an
  all-ones member at 8192 and on an all-ones 32768 block-square step, bit
  for bit against the plain version, with its ms, its share of the bf16
  bound and ``torch.matmul``'s ms on the same inputs;
- ``gather_scale``: ``elle_gather`` alone at pad 8192 and 32768 on 8
  shards, bit for bit against the plain gather, timed in turns with
  ``clone()`` (its recorded library call) and ``full.copy_(blocks)``;
- ``sharded_kernels``: the north-star frontier (800 beam levels at 4096)
  laid on 8 shards of 512 rows; one sharded level in each exchange mode,
  every stage (``wgl_route``: the owner routing and the all_to_all in one
  scatter; ``wgl_exchange``: the all_gather; the prune with the
  cross-shard reduce in its last block; the sharded finalize; and every
  other stage at the exchanged row count) against its plain version bit
  for bit; the route, the exchange, the sharded prune and the finalize
  timed, the route and the prune beside their parent designs (the route
  and the alltoall exchange, the prune and the reduce: two launches each,
  built from ``yardsticks/wgl_parent.cu`` and checked against the plain
  versions too; the sharded chunk start on the same frontier is
  ``chunk_start``'s); the allgather's stage 1 also without its keys (the
  alltoall's compaction), the parent's exchange without them, and the
  parent's hash of the received rows (the yardstick: the route and the
  exchange now write the keys with the rows); the device
  launches of a sharded level in each mode and of a chunk start
  (``testing.device_work``: 8 and 1 at KO = 1);
- ``exchange_scale``: the route (alltoall) and the exchange (allgather)
  alone at the shard geometry of a global capacity of 262144 (8 shards)
  on seeded rows with their keys, bit for bit against their plain
  versions, each timed beside its parent design (the route: the route and
  the alltoall exchange, then the hash; the exchange: the parent's
  exchange without keys, then the hash, and that exchange alone), and the
  exchange beside one PyTorch copy;
- ``regroup_scale``: the sharded escalation's grow (the regroup of the
  flattened global frontier) at f_total 4096 -> 16384, 16384 -> 65536 and
  65536 -> 262144, bit for bit against the plain version and beside the
  parent's five launches, with the kernel's device launches (one);
- ``sharded_10k``: the reference bench leg's 10,000-op history
  (``bench.py:1847-1849``) through ``parallel.frontier.check_encoded_sharded``
  on 8 shards at a global capacity of 4096 in both modes (same verdict;
  same level when both decide), again with a third x4 escalation in
  alltoall mode, on 1 and 2 shards (same verdict and level), each mode's first 100-level
  chunk against the plain path, wall,
  ms/level, the device's idle share and the launches of each kernel;
- ``sharded_refutation``: a perturbed copy refuted on the shards with the
  single search's ``max_linearized`` and the plain sharded path's witness;
- ``checker_sharded``: ``checker.linearizable`` with the sharded backend
  through the test map's mesh;
- ``offline_segmented`` (after the engine phases): the reference bench's
  offline leg (``bench.py:911-1000``: 8 keys of
  ``concurrent_register_history(n_writers=5)`` merged by time, a valid
  history and its twin with key 0 perturbed, 4 streams), cut from
  1,000,000 to 100,000 ops, each key's last round cut after its third
  write completes (an open terminal segment of every key), through ``offline.plan`` and ``drive`` under ``device`` (launches
  counted) and ``auto``, and the twin under ``auto``: ``True``, ``True``,
  ``False``, the valid history's result map the same under both engines,
  a round on the card with more than one oracle member, no retry and no
  failover; plan and decide walls, rounds on the card and their members,
  the oracle calls' wall; then the scheduler's budget-tripped rescue (256
  keys, about 10,000 ops, ``max_configs=64``: every key's first segment
  trips the enumerator and its members go to the card, 256 in one round
  or a few), its result map equal to the host engine's at the same budget,
  the members of each device round printed; then the three runs at 20,032
  ops against the host engine (equal result maps);
- ``segmented_entry``: ``check_history(parallel="segmented",
  backend="device")`` (launches counted), ``linearizable(
  backend="segmented")`` and ``python -m jepsen_tpu_torch.offline`` in a
  subprocess on the 20,032-op history: one verdict;
- ``resilience``: (a) one ``device.dispatch`` or ``host.stack`` fault in
  ``check_encoded_batch`` of batch_replay_100's histories (each member's
  result unchanged, one retry); (b) the sharded north star (8 shards,
  500-level chunks) with ``device.dispatch`` at its third chunk (the
  uninjected verdict and per-chunk rows, one retry), its walls with the
  chunk-start copy and under ``JEPSEN_NO_FAILOVER=1`` (no copy), in
  turns, and the copy alone; (c) three faults in a row open the
  ``"batch"`` breaker and the next ``drive`` under ``device`` is demoted
  to the host (the host's verdict, and the result's ``failover`` says so,
  cause ``circuit_open``); (d) a real ``torch.OutOfMemoryError``
  from capping this process's memory at what it holds, with batches at a
  capacity of 65536 that need new memory (transient, two retries, the
  drive failed over with cause ``OutOfMemoryError`` in its ``failover``;
  the same call decides on the card once the cap is lifted);
  (e) ``JEPSEN_NO_FAILOVER=1`` propagates the injected error; (f) Elle:
  one injected fault halves the 8k history's chunk, and a fault at every
  dispatch folds the 2k history to the host, typed ``elle_device_oom``;
- ``front_door`` (after ``keyed_multi_register``): a suite-shaped composed
  checker, ``independent.checker(compose({"linear": linearizable, "stats",
  "exceptions": unhandled_exceptions, "limited": concurrency_limit(1,
  linearizable(backend="host"))}))``, over the first two keys of that
  phase's history, the linear part on the card (launches counted) and
  with ``device="cpu"``: the same result maps; then ``set_full`` and
  ``counter`` timed on seeded 100,000-op histories;
- ``ingest`` (after the Elle phases): (a) bench.py's ingest_etcd_10k leg
  (``bench.py:1479-1543``, 10,000 etcd lines, ``--check segmented``):
  ``True``, 0 unmapped; (b) the offline leg's 100,000-op history and its
  twin as etcd proxy ndjson (connection = process, the cut tail left as
  unanswered requests) under ``--engine device`` and ``auto``: each map
  equal to ``check_offline`` on the same parsed ops (run in this process,
  the level kernels' launches counted, its device rounds and their
  members printed), the offline phase's verdicts (``True`` / ``False``,
  exit 0 / 2); (c) APPEND_8K's history as generic jsonl txns, ``--check
  elle``: elle_append_8k's map (txns compared by index, type, f and
  value), the closure kernels launched. Each CLI run is ``python -m
  jepsen_tpu_torch.ingest`` in a process of its own, all started together
  while this process parses and checks the same recordings (parse and
  check walls);
- ``runner`` (after ``ingest``): the test runner. (a) ``core.run`` of the
  demo's cas register, 10,000 ops over 10 workers at 1 ms a call, the
  20th reply lost, the monitor's device oracle and telemetry on: online,
  post-hoc and the C engine's verdicts ``True``, the launches of the
  monitor's rounds and of the analysis counted apart; (a') the same
  traffic with every reply, in a process of its own, the run and the
  monitor's drain bounded in time: the ops the run completed, the
  segments the host enumerator decided and left; (b) the
  lying client that the monitor aborts; (c) ``python -m jepsen_tpu_torch
  test`` then ``analyze`` as processes, exit 0 and 0, both on the card;
  (d) case (a) at 2,000 ops with ``profile?`` and ``live-port``: ``/live``
  shows the monitor's line while the run executes, ``profile.json`` has
  the device chunks, the utilization and one memory watermark a card, the
  ``torch.profiler`` trace holds every level kernel both paths launched,
  the ledger's gate exits 0 and the pages answer 200; the trace's size,
  its top kernels and the analysis wall with and without the profiler;
- ``service`` (after ``runner``): the multi-tenant checking service. (a)
  In process: four tenants of 2,500 ops (bench.py's service leg: the
  quiescence of each poisoned near its end, so its tail is a terminal
  segment for the device oracle; one tenant perturbed) through
  ``Service(engine="device", abort_on_violation=True, alerts=True)`` on
  the card, one ``InProcessServiceClient`` thread a tenant: each tenant's
  verdict that of the single device search of its history, the perturbed
  tenant aborted, a device round with members of two tenants or more,
  the rounds' launches counted (path ``service``), the wall, ops/s, p99
  decision latency, peak allocated memory and any failover. (b) As a
  process: ``python -m jepsen_tpu_torch.service --port 0 --port-file F
  --journal-dir D --engine device``, one tenant over HTTP with
  ``HttpServiceClient`` and one as an etcd recording through
  ``?adapter=etcd`` (its verdict ``ingest_check``'s), ``GET /tenants``,
  ``POST /drain`` and an interrupt: exit 0; then a restart on ``D``
  resumes every tenant from its journal with its watermark kept.
- ``router`` (after ``service``): the scale-out tenant router. (a)
  bench.py's ``service_router`` leg with ``engine="device"``, in a router
  process of its own: ``spawn_backends`` starts two backend processes on
  the card, four tenants of 1,250 ops (``Random(4200 + i)``, 4 processes,
  chunks of 60, each tail poisoned as the service phase's so that it
  reaches the card) go through ``HttpServiceClient(chunk_ops=64)``; the
  ``backend.process`` seam SIGKILLs one backend at 25% of the rows; once
  the respawn and re-adoption settle, each backend is drained (its tails
  decided on its card) and scraped again, then the router drains: each
  verdict the single device search's (or ``unknown`` with the seam's
  causes only), covered ops dropped on resume, the migration and respawn
  seconds, ops/s, p99 decision latency, the backends' device rounds and
  chunks from the router's federation, the card's used memory before and
  after (a CUDA context a backend), the alerts fired, and
  ``torch.cuda.is_initialized()`` false in the router process. (b)
  ``check_offline`` of the offline leg's history cut to 20,000 ops with
  ``backends=2`` (two backend processes behind the router) beside
  ``backends=0``: the same verdict and causes; its tenant rows equal
  ``fanout_services``'s (two services in process, launches counted as path
  ``fanout``). (c) The CLI as processes: ``python -m jepsen_tpu_torch.service
  --router --router-backends 2 --engine device``, one tenant over HTTP,
  ``--roll`` (exit 0, both backends rolled, zero unknown verdicts), an
  interrupt (exit 0, the tenant's verdict the single search's). No
  backend builds the kernel library again.

The last three lines are the card's ``nvidia-smi`` name and power limit,
the per-kernel JSON line, and ``{"ok": true, "device": {...}}``.
Any failed phase raises: the script then exits non-zero and prints no result.
Without CUDA it exits 2.
"""

import ast
import contextlib
import dataclasses
import json
import random
import re
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
NORTH_STAR = dict(n_ops=10000, n_procs=10, cas=True, crash_p=0.002, fail_p=0.02)
NORTH_STAR_SEED = 2026
REFUTE = dict(seed=2, n_ops=300, n_procs=6, crash_p=0.01, fail_p=0.02)
KERNEL_FS = (16, 1024, 4096, 32768)
TIMED_F = 4096  # the optimistic beam's capacity, where the main path spends its levels
# Levels run (as a beam at capacity F) before the comparisons and the
# steady-state window, so the frontier is as full as the main path's.
WARM_LEVELS = 800
PROFILE_LEVELS = 200
# Stage timing: BATCH back-to-back calls, each on its own copy of the
# inputs, timed with CUDA events and divided by BATCH; median of BATCHES.
BATCH = 20
BATCHES = 5
HOLD_CYCLES = 20_000_000  # first length of the sleep that holds the stream
# A search that takes every driver path at a small size: the optimistic
# beam truncates and is exhausted, the exhaustive fallback resumes from its
# checkpoint, escalates losslessly, de-escalates (64-level chunks leave
# room to), and ends in the top-rung beam, which reports unknown.
PATHS = dict(seed=0, n_ops=2500, n_procs=8, crash_p=0.02, fail_p=0.02)
PATHS_SEARCH = dict(f_schedule=(16, 64, 256), optimistic=True, levels_per_call=64)
# BASELINE config 5 as bench.py builds it: 100 histories of 100 ops, every
# 8th perturbed, at a shared capacity of 64.
REPLAY = dict(seed=3, n=100, n_ops=100, n_procs=4, crash_p=0.01, perturb_every=8, f=64)
REPLAY_PLAIN_MEMBERS = 16  # the plain path runs on this prefix of the members
# Eight north-star-shaped members through the batch ladder, as bench.py's
# smoke leg runs them.
BIG = dict(seed=17, n=8, f=256, f_schedule=(256, 2048, 8192))
BIG_KERNELS_F = 8192  # the ladder's top rung, where the batch spends its levels
# radix_sort_sweep: each size at 1, 3 and 8 members, each key family of
# testing.SORT_KEY_FAMILIES, against the plain sort and torch.sort; both
# paths at the sizes one block holds (the crossover), and the device
# launches of one call at each size.
SORT_SWEEP_SIZES = (1, 31, 2048, 16384, 16385, 32768, 32769, 131072, 1048576)
SORT_SWEEP_NB = (1, 3, 8)
SORT_CROSSOVER_SIZES = (2048, 4096, 8192, 16384)
SORT_SWEEP_REPS = dict(batch=10, batches=3)
# stage1_sweep: the two-stage compaction and hash alone at the card tests'
# sizes (M around the tile, the main path's 131072 and the batch's 262144)
# and each validity density of testing.STAGE1_DENSITIES, both arms, bit
# for bit against the plain version; every tile size at the main path's
# and the batch's shapes.
STAGE1_SWEEP_M = (2047, 2048, 2049, 1, 31, 131072, 262144)  # around the smallest tile
STAGE1_SWEEP_NB = (1, 3, 8)
STAGE1_SWEEP_NC = 5  # the north star's row: p, two window words, state, open word
STAGE1_TILE_SHAPES = ((131072, 1), (262144, 8))
STAGE1_SWEEP_REPS = dict(batch=10, batches=3)
# prune_sweep: the prune alone at the card tests' sizes (the main path's
# L 16384, the batch's 32768, the allgather arm's 1,048,576 at f_total
# 262144), 1, 3 and 8 members, each group family of
# testing.PRUNE_FAMILIES, bit for bit against the plain prune; every tile
# at the main path's and the batch's shapes.
PRUNE_SWEEP_L = (64, 2047, 16384, 32768, 131072, 1048576)
PRUNE_SWEEP_NB = (1, 3, 8)
PRUNE_SWEEP_NC = 5  # the north star's row: p, two window words, state, open word
PRUNE_TILE_SHAPES = ((16384, 1), (32768, 8))
PRUNE_SWEEP_REPS = dict(batch=10, batches=3)
# gather_scale: elle_gather alone at pad 8192 and 32768 on D = 8 shards,
# alternated in turns with clone() (its recorded library call) and
# full.copy_(blocks).
GATHER_SCALE_PADS = (8192, 32768)
GATHER_SCALE_TURNS = 3
# gather_sort_scale: the take-col sort alone at the sort sweep's sizes, 1
# and 8 members, random and all-equal keys in column 3 of 5-word rows (the
# north star's open word), both ident settings.
TAKE_SORT_SIZES = SORT_SWEEP_SIZES
TAKE_SORT_NB = (1, 8)
TAKE_SORT_SWEEP_FAMILIES = ("random", "equal")
TAKE_SORT_REPS = dict(batch=10, batches=3)
SOURCE = "jepsen_tpu_torch/csrc/wgl_level.cu"
REPLACES = {
    "wgl_chunk_init": "jepsen_tpu/ops/wgl.py:830",
    "wgl_expand": "jepsen_tpu/ops/wgl.py:363",
    "wgl_stage1_hash": "jepsen_tpu/ops/wgl.py:523",
    "wgl_take_col_sort": "jepsen_tpu/ops/wgl.py:647",
    "radix_sort_pairs": "jepsen_tpu/ops/wgl.py:647",
    "wgl_prune": "jepsen_tpu/ops/wgl.py:659",
    "wgl_gather_finalize": "jepsen_tpu/ops/wgl.py:741",
    "wgl_regroup": "jepsen_tpu/ops/wgl.py:1074",  # _pad_program: one member
}
# The batched forms: every level kernel replaces the reference's vmap of
# the level program, the regroup its re-batch program.
BATCH_REPLACES = {"level": "jepsen_tpu/ops/wgl.py:949",
                  "wgl_regroup": "jepsen_tpu/parallel/batch.py:95"}
# The kernels every level launches. A two-stage level (M above
# BIG_M_THRESHOLD, and every sharded level) also launches stage 1
# (wgl_stage1_hash); a single-stage level's expand writes its keys.
# launch_counts requires stage 1 where the path ran a two-stage level
# (LevelShapes) and refuses it where it ran none.
LEVEL_KERNELS = ("wgl_chunk_init", "wgl_expand", "wgl_take_col_sort", "radix_sort_pairs",
                 "wgl_prune", "wgl_gather_finalize")
STAGE1 = "wgl_stage1_hash"
# A single search's kernels, stage 1 aside.
SEARCH_KERNELS = tuple(k for k in REPLACES if k != STAGE1)
# Elle: lagged list-append / rw-register histories (8 keys, at most 5
# micro-ops a txn, 10 processes: the shape of bench.py's cockroachdb txn
# config), reads inside the lag window seeing up to `depth` txns back.
ELLE_SOURCE = "jepsen_tpu_torch/csrc/elle_closure.cu"
ELLE_REPLACES = {"elle_adjacency": "jepsen_tpu/elle/ops.py:237",
                 "elle_square": "jepsen_tpu/elle/ops.py:240",
                 "elle_labels_pack": "jepsen_tpu/elle/ops.py:187"}
APPEND_8K = dict(seed=11, n_txns=8000, lag=(0, 8000), depth=16)
APPEND_20K = dict(seed=11, n_txns=20000, lag=(8000, 11000), depth=16)
LAG_2K = dict(seed=5, n_txns=2000, lag=(600, 1100), depth=8)
WR_4K = dict(seed=7, n_txns=4000, lag=(1000, 2500), depth=16)
ELLE_KERNEL_PADS = (128, 1024, 8192)  # nb = 3 lagged-history masks at each
ELLE_RANDOM_PAD = 256
BF16_TFLOPS = 989e12  # H100 SXM dense bf16 tensor rate (NVIDIA data sheet)
# The mesh-sharded closure: every closure of a history on D = 8 shards of
# the card (the 8k history also on 1 and 2), in both exchange modes.
ELLE_SHARD_D = 8
ELLE_SHARD_20K_PAD = 32768  # closure_pad(20000): above the bucket ceiling
ELLE_SHARD_8K_MESHES = ((1, "packed"), (2, "packed"), (8, "packed"), (8, "dense"))
ELLE_SHARD_RANDOM_PAD = 256
SWEEP_NB = 3  # members at each bucket pad of elle_square_sweep
ELLE_SHARD_PROGRAM = "jepsen_tpu/elle/ops.py:296"
ELLE_SHARD_REPLACES = {"elle_unpack": "jepsen_tpu/elle/ops.py:199",
                       "elle_pack_rows": "jepsen_tpu/elle/ops.py:320",
                       "elle_gather": "jepsen_tpu/elle/ops.py:324",
                       "elle_block_square": "jepsen_tpu/elle/ops.py:325"}
# The kernels each exchange mode launches.
ELLE_SHARD_KERNELS = {"packed": ("elle_unpack", "elle_pack_rows", "elle_block_square"),
                      "dense": ("elle_unpack", "elle_gather", "elle_block_square",
                                "elle_pack_rows")}
# Every other device model: a valid and a perturbed 2000-op history of
# each (testing.random_model_history: 8 processes; the perturbed one
# without crashes and broken in its first tenth, so that the host oracle
# decides it), each family's expand kernel at a frontier warmed for 200
# levels, BASELINE config 3 (the hazelcast lock checker on a 5000-op
# owner-aware-mutex history, as bench.py:1557-1560 builds it), and 100
# keys of multi-register ops (yugabyte's registers 0, 1, 2) through the
# keyed checker.
MODELS_2K = dict(n_ops=2000, n_procs=8, crash_p=0.02, seed=2000)
MODELS_2K_BAD = dict(n_ops=2000, n_procs=8, crash_p=0.0, seed=2001, within=0.1)
MODEL_KERNELS_F = 4096  # the optimistic beam's capacity, as at TIMED_F
MODEL_WARM_LEVELS = 200
MODEL_PLAIN_REPS = dict(batch=3, batches=3)
MUTEX_5K = dict(seed=5, n_ops=5000, n_procs=8)
KEYED = dict(seed=3000, keys=100, n_ops=200, n_procs=4, crash_p=0.01, perturb_every=8,
             plain_keys=16, compose_keys=10)
# The host engines (native, auto, competition): timed runs of each case,
# the bench's perturbed twin of the north star (bench.py:268), the families
# with no step in the C engine, and the host oracle's budget when the auto
# path asks it about one of their 2000-op histories (held low to keep the
# phase short; the phase checks that the oracle ends unknown on it).
ENGINE_TURNS = 3
TWIN_SEED = 7
AUTO_FAMILIES = ("multi-register", "counter", "set", "bank")
AUTO_HOST_CONFIGS = 2000
# A history that a one-rung schedule of 16 leaves unknown and the oracle
# decides at once: auto's fallback to the oracle, on the card.
AUTO_FALLBACK = dict(model="counter", seed=2, n_ops=60, n_procs=8, crash_p=0.2,
                     f_schedule=(16,))
CONTENTION_TURNS = 7
# The frontier-sharded search: D = 8 shards of one card at a global
# capacity of 4096 (512 rows a shard), on the reference bench leg's
# history (bench.py:1847-1849), a perturbed copy refuted early, and the
# checker's sharded backend.
SHARD_D = 8
SHARD_F_TOTAL = 4096
SHARD_10K = dict(seed=2032, n_ops=10000, n_procs=10, cas=True, crash_p=20 / 10000,
                 fail_p=0.02)
SHARD_CHUNK_LEVELS = 100  # the first chunk held against the plain path
# The ladder runs on 8 shards with the reference's default of two x4
# escalations (to 65536) in both modes, and with SHARD_WIDE_ESCALATIONS (to
# 262144) in alltoall mode only (the allgather's took 32 s).
SHARD_WIDE_ESCALATIONS = 3
SHARD_REFUTE_SEED = 2033
SHARD_REFUTE_WITHIN = 0.02  # the broken read lies in the first 2% of the history
# The exchange alone at the shard geometry of f_total 262144 (the third
# escalation's rung: 32768 rows a shard, 131072 stage-1 rows, 1,048,576
# received rows a shard under allgather), on seeded rows.
SHARD_BIG_F_TOTAL = 262144
# The sharded escalation's grows (x4 steps of the global capacity on
# SHARD_D shards) the regroup is timed at, beside its parent design.
REGROUP_GROWS = ((4096, 16384), (16384, 65536), (65536, 262144))
REGROUP_SEED = 4
SHARD_PROGRAM = "jepsen_tpu/parallel/frontier.py:72"
# The sharded level's kernels (SHARD_KERNEL below) and what each replaces:
# the route the owner routing and the all_to_all (lines 551-611), the
# exchange the all_gather, the sharded prune the prune and the pmax / psum
# after it (lines 490, 612, 697-711), the sharded chunk start the chunk's
# stop test and its pmin / pmax / psum (lines 830-836, 877-890).
SHARD_REPLACES = {"wgl_route": "jepsen_tpu/ops/wgl.py:551",
                  "wgl_exchange": "jepsen_tpu/ops/wgl.py:592",
                  "wgl_prune_sharded": "jepsen_tpu/ops/wgl.py:697",
                  "wgl_chunk_init_sharded": "jepsen_tpu/ops/wgl.py:830",
                  "wgl_gather_finalize_sharded": "jepsen_tpu/ops/wgl.py:743"}
# The mode whose path a kernel's kernels-line entry reports (the other
# mode's figures beside it, where it runs there too).
SHARD_PRIMARY = {"wgl_exchange": "allgather"}
STEP_REPLACES = {  # each family's step_jax, which k_expand inlines
    "multi-register": "jepsen_tpu/models/register.py:162",
    "counter": "jepsen_tpu/models/counter.py:70",
    "set": "jepsen_tpu/models/sets.py:95",
    "bank": "jepsen_tpu/models/bank.py:110",
    "mutex": "jepsen_tpu/models/mutex.py:55",
    "owner-aware-mutex": "jepsen_tpu/models/mutex.py:92",
    "reentrant-mutex": "jepsen_tpu/models/mutex.py:148",
    "fenced-mutex": "jepsen_tpu/models/mutex.py:196",
    "reentrant-fenced-mutex": "jepsen_tpu/models/mutex.py:280",
    "semaphore": "jepsen_tpu/models/mutex.py:370",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def chunk_start_bytes(lv, nb, F) -> int:
    """A chunk start's bytes: the valid flags read, the control blocks and
    the stats rings written."""
    return nb * F + 4 * nb * (lv.CTL_SIZE + 4 * lv.LEVEL_STAT_ROWS)


def bound_fields(ms, nbytes, ops=0, library_ms=None) -> dict:
    """bound_ms (the larger of the bytes over HBM_BYTES_PER_S and the bf16
    operations over BF16_TFLOPS), what bounds it, the kernel's share of the
    bound, library_ms and the kernel's time over the library call's."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / BF16_TFLOPS
    bound = max(t_bytes, t_ops)
    return {"bound_ms": bound, "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_share": bound / ms, "library_ms": library_ms,
            "vs_library": ms / library_ms if library_ms else None}


def batch_ms(fn, inputs, hold=True, clone=True, batch=BATCH, batches=BATCHES) -> tuple:
    """(device ms, host ms) of one call of ``fn``.

    A batch is BATCH back-to-back calls, each on its own copy of
    ``inputs`` (copied before the batch, so no restore is timed). CUDA
    events around the batch, divided by BATCH, give the device ms; the
    median of BATCHES batches is returned. With ``hold``, a sleep kernel
    holds the stream while the host enqueues the batch, so the events
    time the card's work back to back and not the host's launch rate; a
    batch whose enqueue outlasted the sleep is taken again with a longer
    sleep. The host ms is the host's time to issue one call (the
    wrapper's own cost: checks, ctypes call, launches). Functions that
    read results back on the host (the plain versions) run without
    ``hold``: their time includes those waits. ``clone=False`` passes
    the same inputs to every call (for functions that do not write them)."""
    import torch

    dev_times, host_times = [], []
    cycles = HOLD_CYCLES
    while len(dev_times) < batches:
        copies = [tuple(t.clone() for t in inputs) if clone else inputs
                  for _ in range(batch)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t_issue = time.perf_counter()
        ev[0].record()
        if hold:
            torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for c in copies:
            fn(c)
        t1 = time.perf_counter()
        ev[2].record()
        torch.cuda.synchronize()
        if hold and 1e3 * (t1 - t_issue) >= ev[0].elapsed_time(ev[1]):
            if cycles >= 64 * HOLD_CYCLES:
                raise RuntimeError("the host could not enqueue a timing batch "
                                   "within the holding sleep")
            cycles *= 2
            continue
        dev_times.append(ev[1].elapsed_time(ev[2]) / batch)
        host_times.append(1e3 * (t1 - t0) / batch)
    return statistics.median(dev_times), statistics.median(host_times)


def warm_frontier(plan, F, lv, wgl, model, levels=WARM_LEVELS):
    """Stacked frontiers at capacity F after up to ``levels`` beam levels
    of the kernel path (at most half of each member's levels): (frontier,
    workspace, each member's level)."""
    g = wgl.level_geometry(plan, F)
    fr = wgl.initial_frontier_batch(F, g.W, g.KO, plan.init_state)
    ws = lv.BatchWorkspace(g, plan.nb, plan.device)
    budgets = [min(levels, t // 2) for t in plan.totals.tolist()]
    flags = lv.run_chunk_batch(lv.KERNELS, g, plan.tabs, fr, ws, [0] * plan.nb, budgets,
                               [1] * plan.nb, plan.nD.tolist(), plan.nO.tolist(), model)
    return fr, ws, [f[3] for f in flags]


def start_rows(lv, lvls, plan, lossy=1) -> list:
    """The chunk-start rows of one level from each member's level ``lvls``
    (a budget of one level, the beam flag ``lossy``)."""
    nb = len(lvls)
    return lv.chunk_rows(lvls, [x + 1 for x in lvls], [lossy] * nb, plan.nD.tolist(),
                         plan.nO.tolist())


def start_ctl(lv, ctl, fr, lvls, plan) -> None:
    """Control blocks ``ctl`` at the start of one level on ``fr`` (the plain
    chunk start of :func:`start_rows`)."""
    lv.chunk_init_plain(ctl, fr[4], None, start_rows(lv, lvls, plan))


class LevelShapes:
    """Whether the path run since the last :func:`reset_counts` ran a
    two-stage level: the single, batch and sharded drivers build every
    chunk's geometry through ``wgl.level_geometry`` or
    ``wgl.sharded_geometry``, which :meth:`install` wraps."""

    two_stage = False

    @classmethod
    def install(cls, wgl) -> None:
        for name in ("level_geometry", "sharded_geometry"):
            def wrapped(*a, _build=getattr(wgl, name), **kw):
                g = _build(*a, **kw)
                cls.two_stage = cls.two_stage or g.two_stage
                return g
            setattr(wgl, name, wrapped)


def reset_counts(lv) -> None:
    """Every launch count to 0, and no level seen (:class:`LevelShapes`)."""
    lv.reset_launches()
    LevelShapes.two_stage = False


def launch_counts(lv, where, required=None):
    """The launch counts since :func:`reset_counts`; every kernel of the
    path (``required``, default every kernel of the single search) must
    have run, stage 1 too where the path ran a two-stage level, and stage
    1 not at all where it ran none."""
    counts = dict(lv.LAUNCHES)
    required = tuple(required or SEARCH_KERNELS)
    if LevelShapes.two_stage:
        required += (STAGE1,)
    elif counts[STAGE1]:
        raise AssertionError(f"{where} ran no two-stage level but launched {STAGE1} "
                             f"{counts[STAGE1]} times")
    idle = [k for k in required if counts[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched in {where}: {idle}")
    return counts


def same_search(k, p) -> bool:
    """Kernel search and plain search agree: verdict, levels, per-level
    stats rows, rungs, and the refutation witness."""
    rungs = lambda r: [(a["F"], a["levels"]) for a in r.get("attempts") or []]
    return (k["valid"] == p["valid"] and k["levels"] == p["levels"]
            and k["level_stats"] == p["level_stats"] and rungs(k) == rungs(p)
            and rungs({"attempts": k.get("optimistic_attempts")})
            == rungs({"attempts": p.get("optimistic_attempts")})
            and k.get("stuck_configs") == p.get("stuck_configs"))


def same_member(a, b) -> bool:
    """Two batch results of one member agree: verdict, levels, frontier
    peak, rungs (by F, members, calls) and witness. A keyed history's ops
    keep their global indexes, so the witness is compared by row, state
    and reason, not by the op's printed index."""
    rungs = lambda r: [(x["F"], x["members"], x["calls"]) for x in r.get("rungs") or []]
    witness = lambda r: [(c["linearized"], c["state"],
                          [(q["row"], q["why"]) for q in c["pending"]])
                         for c in r.get("stuck_configs") or []]
    return (all(a.get(k) == b.get(k) for k in ("valid", "levels", "frontier_max"))
            and rungs(a) == rungs(b) and witness(a) == witness(b))


# The keys of a batch member's result that tests/test_torch_batch.py holds
# against the reference's.
MEMBER_KEYS = ("valid", "levels", "frontier_max", "escalated", "decided_at_F", "beam",
               "max_linearized", "stuck_configs", "batched", "op_count")


def same_keys(a, b) -> bool:
    """Two results of one member agree on :data:`MEMBER_KEYS` and their
    rungs (by F, members, calls)."""
    rungs = lambda r: [(x["F"], x["members"], x["calls"]) for x in r.get("rungs") or []]
    return all(a.get(k) == b.get(k) for k in MEMBER_KEYS) and rungs(a) == rungs(b)


def same_ladder(a, b) -> bool:
    """One member's results from two runs of the same batch agree, rungs
    (by F, members, calls) included."""
    keys = ("valid", "levels", "frontier_max", "decided_at_F", "beam", "escalated",
            "max_linearized", "stuck_configs")
    rungs = lambda r: [(x["F"], x["members"], x["calls"]) for x in r.get("rungs") or []]
    return all(a.get(k) == b.get(k) for k in keys) and rungs(a) == rungs(b)


def steady_state(plan, F, lv, wgl, model):
    """PROFILE_LEVELS beam levels of the kernel path from a warmed frontier
    (one member): host wall time, then the same window under
    torch.profiler for device time by CUDA kernel. The device's idle share
    is 1 - busy / wall, with the busy time from the profiled run and the
    wall from the run without the profiler (which slows the host, not the
    kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jepsen_tpu_torch.testing import device_work

    g = wgl.level_geometry(plan, F)
    fr, ws, (lvl0,) = warm_frontier(plan, F, lv, wgl, model)
    saved = tuple(t.clone() for t in fr)
    nDO = (plan.nD.tolist(), plan.nO.tolist())

    def window(reads=None):
        for t, s in zip(fr, saved):
            t.copy_(s)
        torch.cuda.synchronize()
        before = dict(lv.LAUNCHES)
        real_cpu = torch.Tensor.cpu
        if reads is not None:  # count the host's reads of the control blocks
            def cpu(t, *a, **k):
                reads[0] += t.data_ptr() == ws.ctl.data_ptr()
                return real_cpu(t, *a, **k)
            torch.Tensor.cpu = cpu
        try:
            t0 = time.perf_counter()
            (flags,) = lv.run_chunk_batch(lv.KERNELS, g, plan.tabs, fr, ws, [lvl0],
                                          [lvl0 + PROFILE_LEVELS], [1], *nDO, model)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.Tensor.cpu = real_cpu
        return flags[3] - lvl0, wall, {k: lv.LAUNCHES[k] - before[k] for k in before}

    window()  # warm-up
    reads = [0]
    levels, wall, launched = window(reads)
    # One level's device work, counted from a stream capture of the level
    # program (kernels, copies, memsets; packed inside the capture, so on
    # its stream), and the control-block reads the window made a level: the
    # device launches a level.
    before = dict(lv.LAUNCHES)
    level_work = device_work(lambda: lv._LevelProgram(g, plan.tabs, fr, ws, model)())
    for k in before:
        lv.LAUNCHES[k] = before[k]
    captured = sum(level_work.values()) + reads[0] / max(levels, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        p_levels, p_wall, _ = window()
    by_kernel, launches_by = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and getattr(e, "device_type", None) is not None \
                and "cuda" in str(e.device_type).lower():
            name = e.key.split("(")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3
            launches_by[name] = launches_by.get(name, 0) + e.count
    busy = sum(by_kernel.values())
    per = max(p_levels, 1)
    return {"phase": "steady_state", "F": F, "from_level": lvl0, "levels": levels,
            "frontier_configs": int(saved[4].sum()),
            "ms_per_level": 1e3 * wall / max(levels, 1),
            "launches_per_level": {k: v / max(levels, 1) for k, v in launched.items()},
            "device_launches_per_level": captured,
            "device_work_per_level": level_work,
            "control_block_reads_per_level": reads[0] / max(levels, 1),
            "profiled_launches_per_level": sum(launches_by.values()) / per if busy else None,
            "profiled_launches_per_level_by_kernel": {k: v / per for k, v in launches_by.items()},
            "profiled_ms_per_level": 1e3 * p_wall / max(p_levels, 1),
            "device_busy_ms_per_level": busy / max(p_levels, 1) if busy else None,
            "device_idle_share": (1 - (busy / max(p_levels, 1))
                                  / (1e3 * wall / max(levels, 1))) if busy else None,
            "profiled_idle_share": (1 - busy / (1e3 * p_wall)) if busy else None,
            "device_ms_by_cuda_kernel": by_kernel or None}


def _rows_err(a, b, counts) -> int:
    """max_abs_err over each member's first ``counts[m]`` rows."""
    return max((max_abs_err(a[m, :n], b[m, :n]) for m, n in enumerate(counts)), default=0)


class StageCheck:
    """Every stage of one level at capacity F over the plan's members, and
    the regroup: kernel against plain version on identical inputs (each
    stage's inputs come from the plain chain). ``expand_only`` stops after
    the expand stage; ``plain_reps`` sets how the plain versions are timed
    (``batch_ms``'s ``batch`` and ``batches``)."""

    def __init__(self, plan, F, lv, wgl, model, warm=WARM_LEVELS, expand_only=False,
                 plain_reps=None):
        import torch

        self.lv, self.F, self.model = lv, F, model
        self.expand_only = expand_only
        self.plain_reps = plain_reps or {}
        self.g = g = wgl.level_geometry(plan, F)
        self.nb = nb = plan.nb
        self.tabs = plan.tabs
        dev = plan.device
        fr, self.ws, lvls = warm_frontier(plan, F, lv, wgl, model, warm)
        self.fr = fr
        self.valid_configs = [int(x) for x in fr[4].sum(dim=1)]
        self.rows = start_rows(lv, lvls, plan)
        ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32, device=dev)
        lv.chunk_init_plain(ctl, fr[4], None, self.rows)
        self.ctl0 = ctl
        self.results = {}  # name -> dict(err, ms, plain_ms, call_ms, bytes, library_ms)

    def record(self, name, err, times, nbytes, library_ms=None):
        r = self.results.setdefault(name, {"err": 0, "ms": [], "plain_ms": [],
                                           "call_ms": [], "bytes": [], "library_ms": []})
        r["err"] = max(r["err"], err)
        for k, v in zip(("ms", "plain_ms", "call_ms"), times):
            r[k].append(v)
        r["bytes"].append(nbytes)
        if library_ms is not None:
            r["library_ms"].append(library_ms)

    def run(self):
        import torch

        lv, g, tabs, ws, nb = self.lv, self.g, self.tabs, self.ws, self.nb
        clone = lambda ts: tuple(t.clone() for t in ts)

        def measure(kernel, plain, inputs):
            """Run kernel and plain on clones of ``inputs``; return both
            output tuples and (ms, plain_ms, call_ms)."""
            ki, pi = clone(inputs), clone(inputs)
            kernel(ki)
            plain(pi)
            torch.cuda.synchronize()
            ms, call_ms = batch_ms(kernel, inputs)
            plain_ms, _ = batch_ms(plain, inputs, hold=False, **self.plain_reps)
            return ki, pi, (ms, plain_ms, call_ms)

        e4 = lambda *a: 4 * int(sum(a))
        dev = self.ctl0.device
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
        # chunk_init: the whole chunk start (control blocks, stats rings)
        rows = self.rows
        ins = (torch.ones_like(self.ctl0), self.fr[4], torch.ones_like(ws.stats))
        k, p, t = measure(lambda t: lv.chunk_init(t[0], t[1], t[2], rows),
                          lambda t: lv.chunk_init_plain(t[0], t[1], t[2], rows), ins)
        err = max(max_abs_err(k[0], p[0]), max_abs_err(k[2], p[2]),
                  max_abs_err(p[0], self.ctl0))
        self.record("wgl_chunk_init", err, t, chunk_start_bytes(lv, nb, g.F))
        ctl = p[0]
        # expand (a single-stage level's writes the keys: it has no stage 1)
        single = not g.two_stage
        rows = z(nb, g.M, g.NC)
        nval = torch.zeros((nb, g.M), dtype=torch.uint8, device=dev)
        ins = (ctl, rows, nval) + ((z(nb, g.M),) if single else ()) + tuple(self.fr)
        model = self.model
        fr_at = 4 if single else 3  # the keys at 3
        key_of = (lambda t: t[3]) if single else (lambda t: None)
        k, p, t = measure(
            lambda t: lv.expand(g, tabs, t[fr_at:], t[0], t[1], t[2], model, key_of(t)),
            lambda t: lv.expand_plain(g, tabs, t[fr_at:], t[0], t[1], t[2], model, key_of(t)),
            ins)
        vm = p[2].bool()
        err = max(max_abs_err(k[0], p[0]), max_abs_err(k[2], p[2]),
                  max_abs_err(k[1][vm], p[1][vm]))
        n_exp = [int(x) for x in vm.sum(dim=1)]
        fb = nb * g.F * (4 * g.NC + 1)
        self.record("wgl_expand", max(err, self.check_keys(k) if single else 0), t,
                    fb + min(4 * nb * g.ND * 8, e4(sum(self.valid_configs) * g.W * 5))
                    + e4(sum(n_exp) * g.NC) + nb * g.M + (e4(nb * g.M) if single else 0))
        self.n_exp = n_exp
        check_nexp(lv, k[0], k[2], "wgl_expand (kernel)")
        check_nexp(lv, p[0], p[2], "wgl_expand (plain)")
        if single:
            self.hash_fold(ins, k, p)
        if self.expand_only:
            return
        ctl, rows, nval = p[0], p[1], p[2]
        if single:
            drows, fkey = rows, p[3]
        else:  # stage-1 compaction + hash
            drows, fkey = z(nb, g.L, g.NC), z(nb, g.L)
            ins = (rows, nval, ctl, drows, fkey)
            k, p, t = measure(lambda t: lv.stage1_hash(g, *t, ws.s1),
                              lambda t: lv.stage1_hash_plain(g, *t, None), ins)
            nv = [min(n, g.P) for n in n_exp]
            err = max(_rows_err(k[4], p[4], nv), _rows_err(k[3], p[3], nv),
                      max_abs_err(k[4] < 0, p[4] < 0))
            self.record("wgl_stage1_hash", err, t,
                        nb * g.M + e4(sum(n_exp) * g.NC, sum(nv) * g.NC, nb * g.L))
            drows, fkey = p[3], p[4]
        # dedup order: a take-col sort per key (last open word first, from
        # the identity order)
        perm = z(nb, g.L)
        keys = z(nb, g.L)
        cols = ([(drows, g.NID + w) for w in reversed(range(g.KO1))] if g.KO else []) \
            + [(fkey, 0)]
        self.take_sorts = []  # each call's inputs, for gather_sort_scale
        for j, (src, col) in enumerate(cols):
            ident = j == 0
            ins = (keys, perm)
            self.take_sorts.append((src, col, keys, perm, ctl, ident))
            k, p, t = measure(
                lambda t, s=src, c=col, i=ident: lv.take_col_sort(s, c, t[0], t[1], ws.sort,
                                                                  ctl, i),
                lambda t, s=src, c=col, i=ident: lv.take_col_sort_plain(s, c, t[0], t[1], None,
                                                                        ctl, i), ins)
            self.record("wgl_take_col_sort",
                        max(max_abs_err(k[0], p[0]), max_abs_err(k[1], p[1])), t,
                        take_sort_bytes(nb, g.L, ident))
            keys, perm = p[0], p[1]
        # prune
        fprio = z(nb, g.L)
        ins = (ctl, fprio)
        k, p, t = measure(
            lambda t: lv.prune(g, drows, keys, perm, t[0], t[1], ws.pr),
            lambda t: lv.prune_plain(g, drows, keys, perm, t[0], t[1]), ins)
        self.record("wgl_prune", max(max_abs_err(k[0], p[0]), max_abs_err(k[1], p[1])),
                    t, e4(3 * nb * g.L, nb * g.L * g.NC))
        ctl, fprio = p[0], p[1]
        # compaction order: the sort carries the dedup order's rows
        ins = (fprio, perm)
        k, p, t = measure(lambda t: lv.radix_sort_pairs(t[0], t[1], ws.sort, ctl),
                          lambda t: lv.radix_sort_pairs_plain(t[0], t[1], None, ctl),
                          ins)
        self.record("radix_sort_pairs", max(max_abs_err(k[0], p[0]), max_abs_err(k[1], p[1])),
                    t, e4(4 * nb * g.L), library_sort_ms(fprio))
        perm = p[1]
        # gather + finalize
        stats = torch.zeros((nb, lv.LEVEL_STAT_ROWS, 4), dtype=torch.int32, device=dev)
        ins = (ctl, stats) + tuple(self.fr)
        self.gather = (drows, perm, ctl, stats)  # for gather_sort_scale
        k, p, t = measure(
            lambda t: lv.gather_finalize(g, drows, perm, t[0], t[1], t[2:], ws.gf),
            lambda t: lv.gather_finalize_plain(g, drows, perm, t[0], t[1], t[2:]),
            ins)
        self.record("wgl_gather_finalize", max(max_abs_err(a, b) for a, b in zip(k, p)),
                    t, gather_bytes(lv, g, ctl))
        # regroup: every member, a repeated one, into twice the capacity
        idx = [nb - 1] + list(range(nb)) if nb > 1 else [0]
        F_new = 2 * g.F
        ins = tuple(self.fr)
        k = lv.regroup(ins, idx, F_new)
        p = lv.regroup_reference(ins, idx, F_new)
        torch.cuda.synchronize()
        ms, call_ms = batch_ms(lambda t: lv.regroup(t, idx, F_new), ins)
        plain_ms, _ = batch_ms(lambda t: lv.regroup_reference(t, idx, F_new), ins, hold=False,
                               **self.plain_reps)
        row_bytes = 4 * (1 + g.KD + g.KO1 + g.S) + 1
        y = yard_regroup(lv, ins, idx, F_new)
        torch.cuda.synchronize()
        self.record("wgl_regroup", max(max_abs_err(a, b) for a, b in zip(k + y, p + p)),
                    (ms, plain_ms, call_ms), len(idx) * (g.F + F_new) * row_bytes)
        self.regroup = regroup_timing(lv, ins, idx, F_new, k)

    def check_keys(self, k) -> int:
        """A single-stage expand's keys (kernel outputs ``k``: ctl, rows,
        nvalid, fkey) under their contract: each valid row's equal to
        ``hash_rows_reference`` of the row, bit for bit, every invalid
        slot's KEY_INVALID alone. Returns the largest difference."""
        lv = self.lv
        vm = k[2].bool()
        want = k[3].clone()
        lv.vmap_members(lv.hash_rows_reference)(self.g, k[1], k[2], k[0], want)
        invalid = k[3][~vm]
        bad = int((invalid != lv.KEY_INVALID - 2**32).sum())  # as int32 bit patterns
        return max(max_abs_err(k[3][vm], want[vm]), bad)

    def hash_fold(self, ins, k, p) -> None:
        """What the expand's keys replace, at this single-stage level: the
        parent's k_hash launch (the yardstick) over the expand's rows,
        bit for bit against the plain hash; its ms beside the expand's ms
        without its keys (the expand's own ms with them is the stage's)."""
        import torch

        lv, g = self.lv, self.g
        y = k[3].clone()
        yard_hash(lv, k[1], k[2], k[0], y, g.NC, g.NID)
        q = k[3].clone()
        lv.vmap_members(lv.hash_rows_reference)(g, k[1], k[2], k[0], q)
        torch.cuda.synchronize()
        vm = k[2].bool()
        # the parent hashed every row; the valid rows' keys are the contract
        err = max(max_abs_err(y, q), max_abs_err(y[vm], k[3][vm]))
        if err:
            raise AssertionError(f"the parent hash (yardstick) disagrees at F {self.F}: {err}")
        hins = (k[1], k[2], k[0], y)
        ms = batch_ms(lambda t: yard_hash(lv, t[0], t[1], t[2], t[3], g.NC, g.NID), hins)[0]
        plain_ms = batch_ms(lambda t: lv.vmap_members(lv.hash_rows_reference)(g, *t), hins,
                            hold=False, batch=3, batches=3)[0]
        bare_ms = batch_ms(lambda t: lv.expand(g, self.tabs, t[3:], t[0], t[1], t[2],
                                               self.model), ins[:3] + ins[4:])[0]
        nbytes = self.nb * g.M * (4 * g.NID + 1 + 4)
        self.hash_parent = {"F": self.F, "L": g.M, "nb": self.nb, "ms": ms, "plain_ms": plain_ms,
                            "max_abs_err": err, "launches_per_level": 1,
                            "expand_without_keys_ms": bare_ms,
                            **bound_fields(ms, nbytes)}


def stage_summary(chk, lv):
    """{kernel: summary} of a StageCheck, failing on any disagreement."""
    out = {}
    for k, v in chk.results.items():
        if v["err"] != 0:
            raise AssertionError(f"{k} disagrees with its plain version at nb={chk.nb}, "
                                 f"F={chk.F}: max_abs_err {v['err']}")
        nbytes = sum(v["bytes"]) / len(v["bytes"])
        out[k] = {"max_abs_err": v["err"], "ms": statistics.mean(v["ms"]),
                  "plain_ms": statistics.mean(v["plain_ms"]),
                  "call_ms": statistics.mean(v["call_ms"]),
                  "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
                  "library_ms": statistics.mean(v["library_ms"]) if v["library_ms"] else None}
    return out


def take_sort_bytes(nb, n, ident) -> int:
    """Bytes of one take-col sort: the gathered key column and (unless
    ``ident``) the values read once, keys and values written once."""
    return 4 * nb * n * (3 if ident else 4)


def gather_bytes(lv, g, ctl) -> int:
    """Bytes of one gather_finalize call at the control blocks ``ctl`` it
    starts from: each kept row and its index read once, each live member's
    frontier (F rows of NC words and a validity byte) written once, its
    control block read and written and its stats row written."""
    total = 0
    for s_, c in enumerate(ctl.tolist()):
        if not c[lv.CTL_GO]:
            continue
        # (ovf_now, dead, stuck_now, kept[, offset])
        out = lv._sharded_outcome(g, c, s_) if g.exchange else lv._level_outcome(g, c)
        dead, kept = out[1], out[3]
        total += 8 * lv.CTL_SIZE + 16
        if not dead:
            total += 4 * kept * (g.NC + 1) + g.F * (4 * g.NC + 1)
    return total


def library_sort_ms(keys, **reps) -> float:
    """``torch.sort(dim=1, stable=True)`` of the same u32 keys (sign bit
    flipped so int32 order is u32 order), each member's row on its own:
    a yardstick only."""
    import torch

    flipped = keys ^ torch.tensor(-2**31, dtype=torch.int32, device=keys.device)
    return batch_ms(lambda t: torch.sort(t[0], dim=1, stable=True), (flipped,), **reps)[0]


def sort_device_launches(lv, keys, vals, scratch) -> int:
    """Device launches of one radix_sort_pairs call."""
    k, v = keys.clone(), vals.clone()
    return device_launches(lambda: lv.radix_sort_pairs(k, v, scratch))


def radix_sort_sweep(lv):
    """radix_sort_pairs at every SORT_SWEEP_SIZES x SORT_SWEEP_NB x key
    family, bit for bit against the plain sort, with its ms, torch.sort's
    ms, bound_ms (16 bytes a pair over HBM) and the path its default
    scratch takes; both paths at SORT_CROSSOVER_SIZES (each family, 1 and 8
    members); the device launches of one call at each size. Fails on any
    disagreement. Returns the random-key cases and the crossover rows."""
    import torch

    from jepsen_tpu_torch.testing import SORT_KEY_FAMILIES, sort_keys

    def case(n, nb, family, path=None):
        keys = torch.from_numpy(sort_keys(family, nb, n, seed=n + nb)).to("cuda")
        vals = torch.arange(n, dtype=torch.int32, device="cuda").repeat(nb, 1)
        scratch = lv.sort_scratch(n, "cuda", nb, path=path)
        k, v, kp, vp = keys.clone(), vals.clone(), keys.clone(), vals.clone()
        lv.radix_sort_pairs(k, v, scratch)
        lv.radix_sort_pairs_plain(kp, vp)
        torch.cuda.synchronize()
        err = max(max_abs_err(k, kp), max_abs_err(v, vp))
        if err:
            raise AssertionError(f"radix_sort_pairs disagrees with the plain sort: n {n}, "
                                 f"nb {nb}, {family}, path {lv.sort_path(scratch)}")
        ms, call_ms = batch_ms(lambda t: lv.radix_sort_pairs(t[0], t[1], scratch),
                               (keys, vals), **SORT_SWEEP_REPS)
        row = {"n": n, "nb": nb, "family": family, "path": lv.sort_path(scratch),
               "max_abs_err": err, "ms": ms, "call_ms": call_ms,
               "library_ms": library_sort_ms(keys, **SORT_SWEEP_REPS),
               "bound_ms": 1e3 * 16 * nb * n / HBM_BYTES_PER_S, "bound_by": "bytes"}
        row["vs_library"] = ms / row["library_ms"]
        return row, (keys, vals, scratch)

    random_rows = []
    for n in SORT_SWEEP_SIZES:
        rows, launches = [], None
        for nb in SORT_SWEEP_NB:
            for family in SORT_KEY_FAMILIES:
                row, inputs = case(n, nb, family)
                rows.append(row)
                if family == "random":
                    random_rows.append(row)
                    if nb == 1:
                        launches = sort_device_launches(lv, *inputs)
        emit({"phase": "radix_sort_sweep", "n": n, "path": rows[0]["path"],
              "device_launches": launches,
              "cases": [{k: r[k] for k in ("nb", "family", "ms", "library_ms", "bound_ms")}
                        for r in rows]})
        for r in random_rows[-len(SORT_SWEEP_NB):]:
            r["device_launches"] = launches
    crossover = []
    for n in SORT_CROSSOVER_SIZES:
        for nb in (1, 8):
            for family in SORT_KEY_FAMILIES:
                for path in lv.SORT_PATHS:
                    row, inputs = case(n, nb, family, path)
                    if family == "random":
                        row["device_launches"] = sort_device_launches(lv, *inputs)
                    crossover.append({k: row.get(k) for k in ("n", "nb", "family", "path", "ms",
                                                              "library_ms", "device_launches")})
    emit({"phase": "radix_sort_sweep", "one_block_max": lv._build.SORT_CTA_MAX,
          "both_paths": crossover})
    return random_rows, crossover


def _stage1_err(lv, g, ins, k, p, with_key) -> int:
    """max_abs_err of a stage-1 call under its contract: each member's
    valid prefix of drows (and fkey), the rest of drows as it was, and the
    sign bit of every key."""
    drows0, fkey0, ctl = ins[3], ins[4], ins[2]
    err = 0
    for b in range(ctl.shape[0]):
        n = min(int(ctl[b, lv.CTL_NEXP]), g.P)
        err = max(err, max_abs_err(k[0][b, :n], p[0][b, :n]),
                  max_abs_err(k[0][b, n:], drows0[b, n:]))
        if with_key:
            err = max(err, max_abs_err(k[1][b, :n], p[1][b, :n]),
                      max_abs_err(k[1][b] < 0, p[1][b] < 0))
        else:
            err = max(err, max_abs_err(k[1][b], fkey0[b]))
    return err


def check_nexp(lv, ctl, nvalid, where) -> None:
    """Each member's ``ctl[CTL_NEXP]`` is its count of nonzero ``nvalid``
    bytes: the stage-1 kernel's tail hash reads drows rows [n_cand, P)
    while other blocks write rows [0, min(n_cand, P)), race-free only
    then."""
    got = ctl[:, lv.CTL_NEXP].tolist()
    want = (nvalid != 0).sum(dim=1).tolist()
    if got != want:
        raise AssertionError(f"{where}: ctl[CTL_NEXP] {got} is not the count of valid rows "
                             f"{want}")


def device_launches(call) -> int:
    """Device launches (kernels, copies and memsets) one ``call()`` issues,
    counted exactly from a capture of the call (``testing.device_work``)."""
    from jepsen_tpu_torch.testing import device_work

    return sum(device_work(call).values())


def stage1_sweep(lv):
    """wgl_stage1_hash alone: every STAGE1_SWEEP_M x STAGE1_SWEEP_NB x
    density, both arms (the key, and the compaction alone), bit for bit
    under the contract against the plain version, with ms, bound_ms (the
    validity bytes, the surviving rows read and written, the keys written
    and the tail's identity words read) and the share of the bound; the
    device launches of one call of each arm; and every tile size at
    STAGE1_TILE_SHAPES. Fails on any disagreement. Returns the rows at the
    main path's and the batch's shapes."""
    import torch

    from jepsen_tpu_torch.testing import STAGE1_DENSITIES, stage1_case

    NC = STAGE1_SWEEP_NC

    def case(M, nb, density, tiles=(None,)):
        P = max(1, min(M, M // 8 + 3)) if M not in (131072, 262144) else M // 8
        g = lv.Geometry(F=M, W=64, KO=1, S=NC - 4, ND=64, NO=4, B=1, SEL=False,
                        two_stage=True, P=P)
        ins = tuple(torch.from_numpy(a).to("cuda")
                    for a in stage1_case(M + nb, nb, M, P, NC, density))
        scratch = lv.stage1_scratch(M, nb, "cuda")
        n_valid = [min(int(x), P) for x in ins[2][:, lv.CTL_NEXP]]
        out = {"M": M, "nb": nb, "density": density, "P": P, "n_valid": sum(n_valid)}
        check_nexp(lv, ins[2], ins[1], f"stage1_sweep M {M} nb {nb} {density}")
        auto = lv.stage1_tile
        for tile in tiles:
            if tile is not None:  # this call's tile, forced for the sweep
                lv.stage1_tile = lambda *a, tile=tile: tile
            try:
                for arm in ("key", "compact"):
                    wk = arm == "key"
                    call = (lambda t, wk=wk: lv.stage1_hash(g, t[0], t[1], t[2], t[3],
                                                             t[4] if wk else None, scratch))
                    k, p = tuple(t.clone() for t in ins), tuple(t.clone() for t in ins)
                    call(k)
                    lv.stage1_hash_plain(g, p[0], p[1], p[2], p[3], p[4] if wk else None)
                    torch.cuda.synchronize()
                    err = _stage1_err(lv, g, ins, (k[3], k[4]), (p[3], p[4]), wk)
                    if err or scratch[1:lv.STAGE1_HDR].abs().sum():
                        raise AssertionError(f"wgl_stage1_hash disagrees with plain: M {M}, "
                                             f"nb {nb}, {density}, {arm}, tile {tile}")
                    ms, call_ms = batch_ms(call, ins, **STAGE1_SWEEP_REPS)
                    rows = sum(n_valid) * NC
                    nbytes = nb * M + 4 * (2 * rows + (nb * P + sum(P - n for n in n_valid)
                                                       * g.NID if wk else 0))
                    label = arm if tile is None else f"{arm}_tile{tile}"
                    out[label] = {"ms": ms, "call_ms": call_ms, "max_abs_err": err,
                                  **bound_fields(ms, nbytes)}
            finally:
                lv.stage1_tile = auto
        return out, g, ins, scratch

    launches = {}
    for M in STAGE1_SWEEP_M:
        rows = []
        for nb in STAGE1_SWEEP_NB:
            for density in STAGE1_DENSITIES:
                row, g, ins, scratch = case(M, nb, density)
                rows.append(row)
                if M == 131072 and nb == 1 and density == "p05":
                    for wk in (True, False):
                        launches["key" if wk else "compact"] = device_launches(
                            lambda wk=wk: lv.stage1_hash(g, *ins[:4], ins[4] if wk else None,
                                                         scratch))
        emit({"phase": "stage1_sweep", "M": M, "NC": NC,
              "cases": [{"nb": r["nb"], "tile": lv.stage1_tile(M, r["nb"], "cuda"),
                         "density": r["density"], "P": r["P"],
                         "n_valid": r["n_valid"],
                         **{a: {k: r[a][k] for k in ("ms", "bound_ms", "bound_share")}
                            for a in ("key", "compact")}} for r in rows]})
    if launches != {"key": 1, "compact": 1}:
        raise AssertionError(f"wgl_stage1_hash: device launches a call {launches}, expected 1")
    tiles = []
    for M, nb in STAGE1_TILE_SHAPES:
        for density in ("p05", "p50"):
            row = case(M, nb, density, tiles=lv.STAGE1_TILES)[0]
            tiles.append(row)
    emit({"phase": "stage1_sweep", "device_launches": launches, "tiles": tiles})
    return {"device_launches": launches, "tiles": tiles}


def prune_sweep(lv):
    """wgl_prune alone: every PRUNE_SWEEP_L x PRUNE_SWEEP_NB x group family,
    bit for bit against the plain prune (fprio and every control block),
    with ms, bound_ms (keys, perm and rows read once, priorities written
    once) and the share of the bound; the device launches of one call at
    each size and member count (one expected); and every tile of
    lv.PRUNE_TILES at PRUNE_TILE_SHAPES. Fails on any disagreement or a
    call of more than one launch. Returns the rows at the main path's and
    the batch's shapes, the tiles and the launch counts."""
    import torch

    from jepsen_tpu_torch.testing import PRUNE_FAMILIES, prune_case

    NC = PRUNE_SWEEP_NC

    def case(L, nb, family, tile=None):
        g = lv.Geometry(F=L, W=32, KO=1, S=NC - 3, ND=64, NO=32, B=1, SEL=False,
                        two_stage=True, P=L)
        drows, skey, perm, ctl, fprio = (torch.from_numpy(a).to("cuda")
                                         for a in prune_case(L + nb, nb, L, NC, g.NID, family))
        scratch = lv.prune_scratch(L, nb, "cuda")
        auto = lv.prune_tile
        if tile is not None:  # this call's tile, forced for the sweep
            lv.prune_tile = lambda *a, tile=tile: tile
        try:
            used = lv.prune_tile(L, nb, g.NC, g.KO1, "cuda")
            call = lambda t: lv.prune(g, drows, skey, perm, t[0], t[1], scratch)  # noqa: E731
            k, p = (ctl.clone(), fprio.clone()), (ctl.clone(), fprio.clone())
            call(k)
            lv.prune_plain(g, drows, skey, perm, p[0], p[1])
            torch.cuda.synchronize()
            err = max(max_abs_err(k[0], p[0]), max_abs_err(k[1], p[1]))
            if err or scratch[1:lv.STAGE1_HDR].abs().sum():
                raise AssertionError(f"wgl_prune disagrees with plain: L {L}, nb {nb}, "
                                     f"{family}, tile {used}")
            ms, call_ms = batch_ms(call, (ctl, fprio), **PRUNE_SWEEP_REPS)
            launches = None
            if family == "straddle":
                c, f = ctl.clone(), fprio.clone()
                launches = device_launches(lambda: lv.prune(g, drows, skey, perm, c, f, scratch))
        finally:
            lv.prune_tile = auto
        nbytes = 4 * nb * L * (3 + NC)
        return {"L": L, "nb": nb, "family": family, "tile": used, "ms": ms, "call_ms": call_ms,
                "max_abs_err": err, "device_launches": launches,
                "kept": int(k[0][:, lv.CTL_COUNT].sum()), **bound_fields(ms, nbytes)}

    main, launches = [], {}
    for L in PRUNE_SWEEP_L:
        rows = [case(L, nb, family) for nb in PRUNE_SWEEP_NB for family in PRUNE_FAMILIES]
        for r in rows:
            if r["device_launches"] is not None:
                launches[f"{L}x{r['nb']}"] = r["device_launches"]
        main += [r for r in rows if (L, r["nb"]) in PRUNE_TILE_SHAPES]
        emit({"phase": "prune_sweep", "L": L, "NC": NC,
              "cases": [{k: r[k] for k in ("nb", "family", "tile", "kept", "ms", "bound_ms",
                                           "bound_share")} for r in rows]})
    if set(launches.values()) != {1}:
        raise AssertionError(f"wgl_prune: device launches a call {launches}, expected 1")
    tiles = [{k: r[k] for k in ("L", "nb", "family", "tile", "ms", "bound_share")}
             for L, nb in PRUNE_TILE_SHAPES for tile in lv.PRUNE_TILES
             for r in [case(L, nb, f, tile) for f in ("straddle", "distinct")]]
    emit({"phase": "prune_sweep", "device_launches": launches, "tiles": tiles})
    return {"main": main, "tiles": tiles, "device_launches": launches}


def expand_scale(lv, wgl, model, plan, bplan, families):
    """wgl_expand at the north star's (F TIMED_F) and the batch's (F
    BIG_KERNELS_F) warmed frontiers: bit for bit against the plain expand
    (control blocks, nvalid, the valid rows; each member's NEXP its count
    of valid rows), its ms, its ms with every member stopped, bound_ms and
    the device launches of one call (one expected); with each family's ms
    at its model_kernels frontier. Returns {shape: row}."""
    import torch

    out = {}
    for label, p, F in (("north_star", plan, TIMED_F), ("batch_8x8192", bplan, BIG_KERNELS_F)):
        g = wgl.level_geometry(p, F)
        fr, _ws, lvls = warm_frontier(p, F, lv, wgl, model)
        nb = p.nb
        ctl = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32, device="cuda")
        start_ctl(lv, ctl, fr, lvls, p)
        rows = torch.zeros((nb, g.M, g.NC), dtype=torch.int32, device="cuda")
        nval = torch.zeros((nb, g.M), dtype=torch.uint8, device="cuda")
        kernel = lambda t: lv.expand(g, p.tabs, fr, t[0], t[1], t[2], model)  # noqa: E731
        plain = lambda t: lv.expand_plain(g, p.tabs, fr, t[0], t[1], t[2], model)  # noqa: E731
        k, q = (ctl.clone(), rows.clone(), nval.clone()), (ctl.clone(), rows.clone(), nval.clone())
        kernel(k)
        plain(q)
        torch.cuda.synchronize()
        vm = q[2].bool()
        err = max(max_abs_err(k[0], q[0]), max_abs_err(k[2], q[2]),
                  max_abs_err(k[1][vm], q[1][vm]))
        check_nexp(lv, k[0], k[2], f"expand_scale {label}")
        if err:
            raise AssertionError(f"wgl_expand disagrees with plain at {label}: {err}")
        ms, call_ms = batch_ms(kernel, (ctl, rows, nval))
        plain_ms, _ = batch_ms(plain, (ctl, rows, nval), hold=False, batch=3, batches=3)
        stopped = ctl.clone()
        stopped[:, lv.CTL_GO] = 0
        stopped_ms, _ = batch_ms(kernel, (stopped, rows, nval))
        c, r, n = ctl.clone(), rows.clone(), nval.clone()
        launches = device_launches(lambda: lv.expand(g, p.tabs, fr, c, r, n, model))
        if launches != 1:
            raise AssertionError(f"wgl_expand: {launches} device launches a call")
        valid_configs = [int(x) for x in fr[4].sum(dim=1)]
        n_exp = [int(x) for x in vm.sum(dim=1)]
        nbytes = nb * g.F * (4 * g.NC + 1) + min(4 * nb * g.ND * 8,
                                                 4 * sum(valid_configs) * g.W * 5) \
            + 4 * sum(n_exp) * g.NC + nb * g.M
        out[label] = {"nb": nb, "F": F, "W": g.W, "B": g.B, "valid_configs": sum(valid_configs),
                      "expanded": sum(n_exp), "max_abs_err": err, "ms": ms, "call_ms": call_ms,
                      "plain_ms": plain_ms, "stopped_ms": stopped_ms,
                      "device_launches": launches, **bound_fields(ms, nbytes)}
    out["families"] = {name: f["ms"] for name, f in families.items()}
    emit({"phase": "expand_scale", **out})
    return out


def gather_scale():
    """elle_gather alone at GATHER_SCALE_PADS on D = 8 shards of random
    bf16 bits, bit for bit against the plain gather, timed in
    GATHER_SCALE_TURNS turns that alternate the kernel, clone() (the
    recorded library call) and full.copy_(blocks); medians of the turns.
    Returns {pad: row}."""
    import torch

    from jepsen_tpu_torch.elle import ops as eo

    out = {}
    for pad in GATHER_SCALE_PADS:
        gen = torch.Generator(device="cuda").manual_seed(pad)
        blocks = torch.randint(-2**15, 2**15, (pad, pad), generator=gen, device="cuda",
                               dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
        full = torch.zeros_like(blocks)
        eo.gather(blocks, ELLE_SHARD_D, full)
        want = eo.gather_plain(blocks, ELLE_SHARD_D)
        torch.cuda.synchronize()
        err = max_abs_err(full.view(torch.int16), want.view(torch.int16))
        del want
        if err:
            raise AssertionError(f"elle_gather disagrees with the plain gather at pad {pad}")
        reps = dict(batch=10, batches=3) if pad < 32768 else dict(batch=4, batches=3)
        turns = {"kernel": [], "clone": [], "copy": []}
        calls = {"kernel": lambda t: eo.gather(t[0], ELLE_SHARD_D, full),
                 "clone": lambda t: t[0].clone(), "copy": lambda t: full.copy_(t[0])}
        for _ in range(GATHER_SCALE_TURNS):
            for k, call in calls.items():
                turns[k].append(batch_ms(call, (blocks,), clone=False, **reps)[0])
        med = {k: statistics.median(v) for k, v in turns.items()}
        nbytes = 2 * pad * pad * 2
        row = {"pad": pad, "D": ELLE_SHARD_D, "bytes": nbytes, "max_abs_err": err,
               "ms": med["kernel"], "clone_ms": med["clone"], "copy_ms": med["copy"],
               **bound_fields(med["kernel"], nbytes, 0, med["clone"]),
               "vs_copy": med["kernel"] / med["copy"], "turns": turns}
        emit({"phase": "gather_scale", **row})
        out[pad] = row
        del blocks, full
        torch.cuda.empty_cache()
    return out


# The parent designs gather_sort_scale, sharded_kernels and exchange_scale
# time beside their replacements: built from yardsticks/wgl_parent.cu into
# a library of their own, never into the port's. Entry point -> ctypes
# argument kinds.
YARDSTICK_SRC = ("yardsticks", "wgl_parent.cu")
YARDSTICKS = {"yardstick_take_col": "PLIIPPIIPP",
              "yardstick_gather_finalize": "P" * 10 + "I" * 10 + "P",
              "yardstick_route_exchange": "P" * 6 + "I" * 5 + "P",
              "yardstick_gather": "PPPPIIIP",
              "yardstick_prune_reduce": "P" * 6 + "I" * 10 + "P",
              "yardstick_chunk_init_reduce": "PPIIP",
              "yardstick_chunk_init": "PPPIIP",
              "yardstick_hash": "PPPPIIIIP",
              "yardstick_regroup": "P" * 11 + "I" * 6 + "P"}
_YARD = {}  # the yardsticks' build: "proc", "lib", "log", "t0"; then "cdll"


def start_yardstick_build(_build) -> None:
    """Start the one ``nvcc`` of the yardsticks' source, beside the
    library's build; :func:`finish_yardstick_build` waits for it."""
    import os

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), *YARDSTICK_SRC)
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    _YARD.update(lib=_build.BUILD / "libwgl_parent_yardsticks.so",
                 log=_build.BUILD / "yardsticks.log", t0=time.perf_counter())
    with open(_YARD["log"], "w") as log:
        _YARD["proc"] = subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, *_build.FLAGS, "-shared", src, "-o", str(_YARD["lib"])],
            stdout=log, stderr=subprocess.STDOUT)


def finish_yardstick_build() -> float:
    """Wait for the yardsticks' build and load it; its seconds."""
    import ctypes

    proc = _YARD.get("proc")
    if proc is None:
        raise RuntimeError("the yardsticks' build was not started")
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc of the yardsticks failed:\n{_YARD['log'].read_text()[-4000:]}")
    lib = ctypes.CDLL(str(_YARD["lib"]))
    kinds = {"P": ctypes.c_void_p, "I": ctypes.c_int, "L": ctypes.c_long}
    for name, sig in YARDSTICKS.items():
        getattr(lib, name).argtypes = [kinds[k] for k in sig]
        getattr(lib, name).restype = ctypes.c_int
    _YARD["cdll"] = lib
    return time.perf_counter() - _YARD["t0"]


def _yard_call(name, *args) -> None:
    rc = getattr(_YARD["cdll"], name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def yard_take_sort(lv, src, col, keys, vals, scratch, ctl, ident) -> None:
    """The parent design of one take-col sort, the yardstick: the identity
    copied into vals (the first key only), a take_col launch, then
    radix_sort_pairs."""
    import ctypes

    import torch

    nb, n = keys.shape
    if ident:
        vals.copy_(torch.arange(n, dtype=torch.int32, device=vals.device).expand(nb, n))
    stride = src.shape[2] if src.dim() == 3 else 1
    ci = ctypes.c_int
    _yard_call("yardstick_take_col", lv._ptr(src), ctypes.c_long(src.stride(0)), ci(stride),
               ci(col), lv._ptr(vals), lv._ptr(keys), ci(n), ci(nb), lv._ptr(ctl), lv._stream())
    lv.radix_sort_pairs(keys, vals, scratch, ctl)


def yard_gather_finalize(lv, g, drows, perm, order, ctl, stats, fr) -> None:
    """The parent's gather (frontier slot k from perm[order[off + k]]) and
    finalize launches, the yardstick."""
    import ctypes

    ci = ctypes.c_int
    nb = ctl.shape[0]
    _yard_call("yardstick_gather_finalize", lv._ptr(drows), lv._ptr(perm), lv._ptr(order),
               lv._ptr(ctl), lv._ptr(stats), *(lv._ptr(a) for a in fr), ci(g.F), ci(g.L),
               ci(g.NC), ci(g.KD), ci(g.S), ci(g.KO1), ci(g.P if g.two_stage else 0),
               ci(lv.LEVEL_STAT_ROWS), ci(lv._EX_MODE[g.exchange]), ci(nb), lv._stream())


def yard_route_exchange(lv, g, crows, ctl, send, svalid, drows, rvalid) -> None:
    """The parent's sharded route into send buckets and its alltoall
    exchange of them into the receive rows (two launches), the
    yardstick."""
    import ctypes

    ci = ctypes.c_int
    _yard_call("yardstick_route_exchange", *(lv._ptr(t) for t in (crows, ctl, send, svalid,
                                                                   drows, rvalid)),
               ci(g.P), ci(g.NC), ci(g.NID), ci(g.D), ci(g.PBK), lv._stream())


def yard_gather(lv, g, crows, ctl, recv, rvalid) -> None:
    """The parent's allgather exchange of the stage-1 rows, without their
    keys (the yardstick)."""
    import ctypes

    ci = ctypes.c_int
    _yard_call("yardstick_gather", *(lv._ptr(t) for t in (crows, ctl, recv, rvalid)), ci(g.P),
               ci(g.NC), ci(g.D), lv._stream())


def yard_prune_reduce(lv, g, drows, skey, perm, ctl, fprio, scratch) -> None:
    """The parent's sharded prune: the single level's prune, then the
    one-thread reduce launch (the yardstick), on the prune's own
    arguments."""
    _yard_call("yardstick_prune_reduce", *lv._prune_args(g, drows, skey, perm, ctl, fprio,
                                                         scratch))


def yard_chunk_init(lv, ctl, valid, ticket=None) -> None:
    """The parent's count launch of the chunk start on control blocks
    already on the card (the yardstick); with ``ticket`` its last block
    runs the chunk-start reduce."""
    import ctypes

    nb, F = valid.shape
    _yard_call("yardstick_chunk_init", lv._ptr(ctl), lv._ptr(valid), lv._ptr(ticket),
               ctypes.c_int(F), ctypes.c_int(nb), lv._stream())


def parent_init(lv, nb, rows):
    """The control blocks the parent built on the host at a chunk's start
    (``_run_levels`` before this design): zeros, then each member's level,
    fmax 1, budget, beam flag and op counts, a column at a time."""
    import torch

    rows = rows if len(rows) == nb else rows * nb
    cols = list(zip(*rows))
    init = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32)
    init[:, lv.CTL_LVL] = torch.as_tensor(list(cols[0]), dtype=torch.int32)
    init[:, lv.CTL_FMAX] = 1
    init[:, lv.CTL_MAXLVL] = torch.as_tensor(list(cols[1]), dtype=torch.int32)
    init[:, lv.CTL_LOSSY] = torch.as_tensor([int(x) for x in cols[2]], dtype=torch.int32)
    init[:, lv.CTL_ND] = torch.as_tensor(list(cols[3]), dtype=torch.int32)
    init[:, lv.CTL_NO] = torch.as_tensor(list(cols[4]), dtype=torch.int32)
    return init


def parent_chunk_start(lv, ctl, valid, stats, ticket, lists):
    """The parent's whole chunk start, from the host's lists
    ``(lvl0, max_levels, lossy, nD, nO)`` to the host's read of the control
    blocks before the first level: the control blocks built on the host and
    copied from pageable memory (a copy that holds the host), a memset of
    the stats rings, the count launch (the yardstick) and the read."""
    rows = list(zip(*lists))
    ctl.copy_(parent_init(lv, ctl.shape[0], rows))
    stats.zero_()
    yard_chunk_init(lv, ctl, valid, ticket)
    return ctl.cpu()


def yard_chunk_init_reduce(lv, ctl, valid) -> None:
    """The parent's sharded chunk start: the chunk init, then the
    one-thread reduce launch (the yardstick)."""
    import ctypes

    nb, F = valid.shape
    _yard_call("yardstick_chunk_init_reduce", lv._ptr(ctl), lv._ptr(valid), ctypes.c_int(F),
               ctypes.c_int(nb), lv._stream())


def yard_hash(lv, drows, nvalid, ctl, fkey, NC, NID) -> None:
    """The parent's hash launch of a level's rows (``drows [nb, L, NC]``,
    validity ``nvalid [nb, L]``) into ``fkey [nb, L]``, the yardstick: what
    the expand, the route and the exchange now write with the rows."""
    import ctypes

    nb, L = fkey.shape
    ci = ctypes.c_int
    _yard_call("yardstick_hash", lv._ptr(drows), lv._ptr(nvalid), lv._ptr(ctl), lv._ptr(fkey),
               ci(L), ci(NC), ci(NID), ci(nb), lv._stream())


def yard_regroup(lv, fr, idx, F_new) -> tuple:
    """The parent's re-batch (five launches, one an array), the yardstick:
    ``lv.regroup``'s buffers and arguments."""
    import torch

    out = tuple(torch.empty((len(idx), F_new) + tuple(a.shape[2:]), dtype=a.dtype,
                            device=a.device) for a in fr)
    ix = torch.tensor(idx, dtype=torch.int32).pin_memory().to(fr[0].device, non_blocking=True)
    yard_regroup_launch(lv, fr, out, idx, ix)
    return out


def yard_regroup_launch(lv, fr, out, idx, ix) -> None:
    """The parent's five launches on ``lv.regroup``'s buffers, the index
    ``ix`` on the card (the parent passed no index in its parameters)."""
    args = lv._regroup_args(fr, out, idx, ix)
    _yard_call("yardstick_regroup", *args[:11], *args[12:])


def regroup_timing(lv, fr, idx, F_new, out) -> dict:
    """The regroup beside its parent design (five launches, the
    yardstick) on the same inputs: each wrapper's ms (the parent's with
    its index's copy to the card) and each one's launches alone (``out``
    the buffers, the parent's index already on the card), and the
    kernel's device launches (``testing.device_work``: one kernel, no
    copy: up to RG_INLINE indices go in its parameters)."""
    import torch

    from jepsen_tpu_torch.testing import device_work

    ix = torch.tensor(idx, dtype=torch.int32, device=fr[0].device)
    own = ix if len(idx) > lv._build.RG_INLINE else None
    kernel = lambda t: lv._launch("wgl_regroup", *lv._regroup_args(t, out, idx, own))  # noqa: E731
    parent = lambda t: yard_regroup_launch(lv, t, out, idx, ix)  # noqa: E731
    work = device_work(lambda: kernel(fr))
    if work["kernel"] != 1:
        raise AssertionError(f"wgl_regroup: {work} device launches a call")
    return {"launch_ms": batch_ms(kernel, fr, clone=False)[0],
            "parent_ms": batch_ms(lambda t: yard_regroup(lv, t, idx, F_new), fr, clone=False)[0],
            "parent_launch_ms": batch_ms(parent, fr, clone=False)[0],
            "device_launches": work}


def regroup_scale(lv, plan) -> list:
    """The sharded escalation's grow (``wgl.pad_sharded_frontier``: the
    regroup of one member over the flattened ``[D * F]`` frontier) at
    REGROUP_GROWS, on a seeded frontier of the plan's widths: the kernel,
    the parent's five launches (the yardstick) and the plain version bit
    for bit; the ms of each (``regroup_timing``), the plain ms and the
    bound (the old rows read once, the new rows written once)."""
    import torch

    W, KO, S = plan.dims[:3]
    widths = (1, W // 32, max(KO, 1), S)
    gen = torch.Generator(device="cuda").manual_seed(REGROUP_SEED)
    out = []
    for f_old, f_new in REGROUP_GROWS:
        fr = tuple(torch.randint(-2**31, 2**31 - 1, (1, f_old, w), generator=gen, device="cuda",
                                 dtype=torch.int64).to(torch.int32) for w in widths)
        fr = (fr[0][..., 0],) + fr[1:] + (torch.randint(0, 2, (1, f_old), generator=gen,
                                                        device="cuda").bool(),)
        k = lv.regroup(fr, [0], f_new)
        y = yard_regroup(lv, fr, [0], f_new)
        p = lv.regroup_reference(fr, [0], f_new)
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(k + y, p + p))
        if err:
            raise AssertionError(f"wgl_regroup (or its parent) disagrees with plain at the "
                                 f"sharded grow {f_old} -> {f_new}")
        ms, call_ms = batch_ms(lambda t: lv.regroup(t, [0], f_new), fr, clone=False)
        plain_ms = batch_ms(lambda t: lv.regroup_reference(t, [0], f_new), fr, hold=False,
                            clone=False, batch=3, batches=3)[0]
        row = 4 * sum(widths) + 1
        t = regroup_timing(lv, fr, [0], f_new, k)
        out.append({"f_total": f_old, "to": f_new, "D": SHARD_D, "max_abs_err": err, "ms": ms,
                    "call_ms": call_ms, "plain_ms": plain_ms, **t,
                    **bound_fields(t["launch_ms"], (f_old + f_new) * row)})
        del fr, k, y, p
    emit({"phase": "regroup_scale", "grows": out})
    return out


def take_sort_case(lv, src, col, keys, vals, scratch, ctl, ident, reps) -> dict:
    """One take-col sort: the kernel, the parent's take_col + sort and the
    plain version on copies of the same inputs, bit for bit; the kernel's
    ms beside the parent's, ``radix_sort_pairs`` alone on the gathered
    keys and ``index_select`` (``gather`` for a batch) + ``torch.sort`` of
    the same column; the device launches of one call."""
    import torch

    nb, n = keys.shape
    outs = {}
    for name, fn in (("kernel", lv.take_col_sort), ("parent", lambda *a: yard_take_sort(lv, *a)),
                     ("plain", lv.take_col_sort_plain)):
        k, v = keys.clone(), vals.clone()
        fn(src, col, k, v, scratch, ctl, ident)
        outs[name] = (k, v)
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for name in ("kernel", "parent")
              for a, b in zip(outs[name], outs["plain"]))
    if err:
        raise AssertionError(f"wgl_take_col_sort (or its yardstick) disagrees with plain: n {n}, "
                             f"nb {nb}, ident {ident}")
    # the gathered, unsorted pairs, for the sort alone
    gv = torch.arange(n, dtype=torch.int32, device="cuda").repeat(nb, 1) if ident else vals.clone()
    gk = keys.clone()
    lv.take_col_plain(src, col, gv, gk, ctl)
    column = (src[:, :, col] if src.dim() == 3 else src) ^ torch.tensor(
        -2**31, dtype=torch.int32, device="cuda")  # u32 order as int32 order
    column = column.contiguous()
    idx = gv.long()
    if nb == 1:
        library = lambda t: torch.sort(torch.index_select(column[0], 0, idx[0]),  # noqa: E731
                                       stable=True)
    else:
        library = lambda t: torch.sort(torch.gather(column, 1, idx), dim=1,  # noqa: E731
                                       stable=True)
    calls = {"ms": (lambda t: lv.take_col_sort(src, col, t[0], t[1], scratch, ctl, ident),
                    (keys, vals)),
             "parent_ms": (lambda t: yard_take_sort(lv, src, col, t[0], t[1], scratch, ctl,
                                                    ident), (keys, vals)),
             "sort_only_ms": (lambda t: lv.radix_sort_pairs(t[0], t[1], scratch, ctl), (gk, gv)),
             "index_select_sort_ms": (library, (gk,))}
    turns = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):  # in turns, then back
        for k in order:
            fn, ins = calls[k]
            turns[k].append(batch_ms(fn, ins, clone=k != "index_select_sort_ms", **reps)[0])
    row = {"n": n, "nb": nb, "ident": ident, "path": lv.sort_path(scratch), "max_abs_err": err,
           **{k: statistics.median(v) for k, v in turns.items()}}
    k, v = keys.clone(), vals.clone()
    row["device_launches"] = device_launches(
        lambda: lv.take_col_sort(src, col, k, v, scratch, ctl, ident))
    row["over_sort_ms"] = row["ms"] - row["sort_only_ms"]
    row.update(bound_fields(row["ms"], take_sort_bytes(nb, n, ident)))
    return row


def gather_sort_scale(lv, checks):
    """wgl_take_col_sort and the one-launch wgl_gather_finalize at the level
    inputs of ``checks`` ({label: StageCheck}: the north star's at TIMED_F,
    the batch's at BIG_KERNELS_F), each beside its parent design (the
    yardsticks of ``yardsticks/wgl_parent.cu``), bit for bit, and the
    take-col sort alone at TAKE_SORT_SIZES x TAKE_SORT_NB x
    TAKE_SORT_SWEEP_FAMILIES x both ident settings. Returns
    {"wgl_take_col_sort": {...}, "wgl_gather_finalize": {...}}."""
    import numpy as np
    import torch

    from jepsen_tpu_torch.testing import sort_keys

    out = {"wgl_take_col_sort": {}, "wgl_gather_finalize": {}}
    for label, chk in checks.items():
        g, nb, ws = chk.g, chk.nb, chk.ws
        rows = [take_sort_case(lv, src, col, keys, perm, ws.sort, ctl, ident, {})
                for src, col, keys, perm, ctl, ident in chk.take_sorts]
        out["wgl_take_col_sort"][label] = rows
        drows, perm, ctl, stats = chk.gather
        ins = (ctl, stats) + tuple(chk.fr)
        order = torch.arange(g.L, dtype=torch.int32, device="cuda").repeat(nb, 1)
        calls = {"kernel": lambda t: lv.gather_finalize(g, drows, perm, t[0], t[1], t[2:], ws.gf),
                 "parent": lambda t: yard_gather_finalize(lv, g, drows, perm, order, t[0], t[1],
                                                          t[2:]),
                 "plain": lambda t: lv.gather_finalize_plain(g, drows, perm, t[0], t[1], t[2:])}
        res = {}
        for name, fn in calls.items():
            t = tuple(x.clone() for x in ins)
            fn(t)
            res[name] = t
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for name in ("kernel", "parent")
                  for a, b in zip(res[name], res["plain"]))
        if err:
            raise AssertionError(f"wgl_gather_finalize (or its yardstick) disagrees with plain "
                                 f"at {label}")
        flat = (perm[:, :g.F].long() + g.L * torch.arange(nb, device="cuda")[:, None]).flatten()
        table = drows.view(nb * g.L, g.NC)
        timed = {"ms": (calls["kernel"], ins, True), "parent_ms": (calls["parent"], ins, True),
                 "index_select_ms": (lambda t: torch.index_select(table, 0, flat), (), False)}
        turns = {k: [] for k in timed}
        for order_ in (list(timed), list(timed)[::-1]):
            for k in order_:
                fn, i, clone = timed[k]
                turns[k].append(batch_ms(fn, i, clone=clone)[0])
        t = tuple(x.clone() for x in ins)
        launches = device_launches(lambda: lv.gather_finalize(g, drows, perm, t[0], t[1], t[2:],
                                                              ws.gf))
        if launches != 1:
            raise AssertionError(f"wgl_gather_finalize: {launches} device launches a call")
        row = {"nb": nb, "F": g.F, "L": g.L, "NC": g.NC, "max_abs_err": err,
               "kept": int(res["plain"][0][:, lv.CTL_FCOUNT].sum()), "device_launches": launches,
               **{k: statistics.median(v) for k, v in turns.items()}}
        row.update(bound_fields(row["ms"], gather_bytes(lv, g, ctl)))
        out["wgl_gather_finalize"][label] = row
        emit({"phase": "gather_sort_scale", "shape": label, "wgl_take_col_sort": rows,
              "wgl_gather_finalize": row})
    sweep = []
    col = 3
    for n in TAKE_SORT_SIZES:
        for nb in TAKE_SORT_NB:
            rng = np.random.default_rng(n + nb)
            vals = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(nb)])
                                    .astype(np.int32)).to("cuda")
            src = torch.randint(-2**31, 2**31 - 1, (nb, n, STAGE1_SWEEP_NC), device="cuda",
                                dtype=torch.int64).to(torch.int32)
            scratch = lv.sort_scratch(n, "cuda", nb)
            keys = torch.zeros((nb, n), dtype=torch.int32, device="cuda")
            for family in TAKE_SORT_SWEEP_FAMILIES:
                src[:, :, col] = torch.from_numpy(sort_keys(family, nb, n, seed=n + nb)).to("cuda")
                for ident in (True, False):
                    row = take_sort_case(lv, src, col, keys, vals, scratch, None, ident,
                                         TAKE_SORT_REPS)
                    sweep.append(dict(row, family=family))
            del src, vals, keys, scratch
            torch.cuda.empty_cache()
        emit({"phase": "gather_sort_scale", "n": n,
              "cases": [{k: r[k] for k in ("nb", "family", "ident", "path", "device_launches",
                                           "ms", "sort_only_ms", "parent_ms",
                                           "index_select_sort_ms", "bound_ms")}
                        for r in sweep if r["n"] == n]})
    bad = [r for r in sweep if r["path"] == "cta" and r["device_launches"] != 1]
    if bad:
        raise AssertionError(f"wgl_take_col_sort: more than one device launch on the one-block "
                             f"path: {bad[:2]}")
    out["wgl_take_col_sort"]["sweep"] = [
        {k: r[k] for k in ("n", "nb", "ident", "path", "device_launches", "ms", "sort_only_ms",
                           "parent_ms", "bound_ms")} for r in sweep if r["family"] == "random"]
    return out


def batch_plan(encs, wgl, dev="cuda"):
    """The encoded histories planned to common dims and stacked on ``dev``."""
    import numpy as np

    plans = [wgl.plan_device(e, device="cpu") for e in encs]
    if not all(p.ok for p in plans):
        raise RuntimeError("a batch member's plan was rejected")
    dims = np.array([p.dims for p in plans])
    pad = tuple(int(dims[:, k].max()) for k in (0, 1, 3, 4))
    return wgl.stack_plans([wgl.plan_device(e, pad_to=pad, device="cpu") for e in encs], dev)


def replay_histories(random_register_history, perturb_history):
    rng = random.Random(REPLAY["seed"])
    hists = [random_register_history(rng, n_ops=REPLAY["n_ops"], n_procs=REPLAY["n_procs"],
                                     cas=True, crash_p=REPLAY["crash_p"])
             for _ in range(REPLAY["n"])]
    for i in range(0, REPLAY["n"], REPLAY["perturb_every"]):
        hists[i] = perturb_history(rng, hists[i])
    return hists


def big_histories(random_register_history):
    return [random_register_history(random.Random(BIG["seed"] + i), **NORTH_STAR)
            for i in range(BIG["n"])]


class ClosureRecorder:
    """Records every ``elle.ops.batched_closure`` call of the engine (its
    inputs and outputs, on the card) and every ``closure_rows_packed``
    component size, while in a ``with`` block. ``plain=True`` also runs
    every such closure through the plain versions on the card, so the
    unchanged entry points drive the plain path."""

    def __init__(self, eo, plain=False):
        self.eo = eo
        self.plain = plain
        self.calls, self.components = [], []

    def __enter__(self):
        eo = self.eo
        self._bc, self._crp = eo.batched_closure, eo.closure_rows_packed

        def batched_closure(S, D, pad, torch_device=None):
            out = self._bc(S, D, pad, torch_device, plain=self.plain)
            self.calls.append({"S": S, "D": D, "pad": pad, "out": out})
            return out

        def closure_rows_packed(srcs, dsts, n, torch_device=None):
            self.components.append(n)
            return self._crp(srcs, dsts, n, torch_device)

        eo.batched_closure, eo.closure_rows_packed = batched_closure, closure_rows_packed
        return self

    def __exit__(self, *exc):
        self.eo.batched_closure, self.eo.closure_rows_packed = self._bc, self._crp


def elle_launches(eo, where):
    """The bucketed closure kernels' launch counts since the last reset;
    all three must have run."""
    counts = {k: eo.LAUNCHES[k] for k in ELLE_REPLACES}
    idle = [k for k, v in counts.items() if v == 0]
    if idle:
        raise AssertionError(f"closure kernels never launched in {where}: {idle}")
    return counts


def elle_history_masks(ea, eo, h, n_members, extra=()):
    """The (S, D, pad) of the first ``n_members`` masks the engine builds
    for history ``h``, through the plain path on the card."""
    with ClosureRecorder(eo, plain=True) as rec:
        ea.check(h, device=True, additional_graphs=extra)
    call = rec.calls[0]
    return call["S"][:n_members], call["D"][:n_members], call["pad"]


def random_masks(eo, pad, nb, seed):
    """nb random graphs at bucket pad (3 edges a node)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    members = []
    for _ in range(nb):
        n = int(rng.integers(pad // 2 + 1, pad + 1))
        members.append((rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)))
    epad = eo.edge_pad(max(len(a) for a, _ in members))
    padded = [eo.pad_edges(a, b, pad, epad) for a, b in members]
    return np.stack([x[0] for x in padded]), np.stack([x[1] for x in padded]), pad


def elle_kernel_check(eo, S, D, pad, label):
    """Each closure kernel against its plain version on the same inputs
    (each stage's input from the plain chain), bit for bit, with device
    times: {kernel: {max_abs_err, ms, plain_ms, call_ms, bound_ms,
    bound_by, library_ms}}."""
    import torch

    nb, epad = S.shape
    src = torch.as_tensor(S).cuda().contiguous()
    dst = torch.as_tensor(D).cuda().contiguous()
    big = pad * pad * nb >= 8192 * 8192
    # The plain versions at 8192 take tens of ms a call: time fewer.
    plain_reps = dict(batch=2, batches=3) if big else dict(batch=5, batches=3)
    out = {}

    def record(name, err, ms, plain_ms, call_ms, nbytes, ops=0, library_ms=None):
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
                     **bound_fields(ms, nbytes, ops, library_ms)}

    # adjacency
    a = eo.adjacency(src, dst, pad)
    ap = eo.adjacency_plain(src, dst, pad)
    torch.cuda.synchronize()
    err = int((a.float() - ap).abs().max())
    ms, call_ms = batch_ms(lambda t: eo.adjacency(*t, pad), (src, dst), clone=False)
    plain_ms, _ = batch_ms(lambda t: eo.adjacency_plain(*t, pad), (src, dst), hold=False,
                           clone=False, **plain_reps)
    record("elle_adjacency", err, ms, plain_ms, call_ms, nb * pad * pad * 2 + 2 * nb * epad * 4)
    # one squaring step, from the adjacency and from a half-closed matrix
    spare = torch.empty_like(a)
    err = 0
    x = ap.to(torch.bfloat16)
    for step in range(eo.closure_steps(pad)):
        y = eo.square(x, spare)
        yp = eo.square_plain(x)
        torch.cuda.synchronize()
        if step in (0, 3):
            err = max(err, int((y.float() - yp).abs().max()))
        x, spare = yp.to(torch.bfloat16), y
    half = ap.to(torch.bfloat16)
    for _ in range(3):
        half = eo.square_plain(half).to(torch.bfloat16)
    ms, call_ms = batch_ms(lambda t: eo.square(t[0], spare), (half,), clone=False)
    hf = half.float()
    plain_ms, _ = batch_ms(lambda t: eo.square_plain(t[0]), (hf,), hold=False, clone=False,
                           **plain_reps)
    del hf
    library_ms, _ = batch_ms(lambda t: torch.matmul(t[0], t[0]), (half,), clone=False)
    record("elle_square", err, ms, plain_ms, call_ms, 2 * nb * pad * pad * 2,
           ops=2 * pad ** 3 * nb, library_ms=library_ms)
    # labels and pack of the closed matrices
    pk, lb = eo.labels_pack(x)
    ppk, plb = eo.labels_pack_plain(x.float())
    torch.cuda.synchronize()
    err = max(max_abs_err(pk, ppk), max_abs_err(lb, plb))
    ms, call_ms = batch_ms(lambda t: eo.labels_pack(t[0]), (x,), clone=False)
    xf = x.float()
    plain_ms, _ = batch_ms(lambda t: eo.labels_pack_plain(t[0]), (xf,), hold=False,
                           clone=False, **plain_reps)
    del xf
    record("elle_labels_pack", err, ms, plain_ms, call_ms,
           nb * pad * pad * 2 + nb * pad * (pad // 32) * 4 + nb * pad * 4)
    # the whole wrapper against the whole plain chain
    got = eo.batched_closure(S, D, pad)
    want = eo.batched_closure(S, D, pad, plain=True)
    whole = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    mutual = int((want[1] != torch.arange(pad, device="cuda")).sum())
    emit({"phase": "elle_kernels", "shape": label, "nb": nb, "pad": pad, "epad": epad,
          "steps": eo.closure_steps(pad), "reach_bits": int(x.float().sum()),
          "nodes_labelled_below_self": mutual, "closure_max_abs_err": whole,
          "kernels": out})
    for k, v in out.items():
        if v["max_abs_err"] != 0 or whole != 0:
            raise AssertionError(f"{k} disagrees with its plain version at {label}")
    return out


def bench_graphs(P):
    """bench.py's elle graphs: the 4096-ring of WW with 16 RW chords
    (bench.py:1372-1380) and 32 random typed graphs of 48-220 nodes
    (bench.py:1418-1432)."""
    big = P.DepGraph(4096)
    for i in range(4095):
        big.add(i, i + 1, P.WW)
    big.add(4095, 0, P.WW)
    for i in range(0, 4096, 256):
        big.add((i + 7) % 4096, i, P.RW)
    rng = random.Random(19)
    sizes = [rng.choice((48, 72, 96, 120)) for _ in range(30)] + [160, 220]
    graphs = []
    for gn in sizes:
        g = P.DepGraph(gn)
        for _ in range(3 * gn):
            a, b = rng.randrange(gn), rng.randrange(gn)
            g.add(a, b, rng.choice((P.WW, P.WW, P.WR, P.RW)))
        graphs.append(g)
    return big, graphs


def unselected(plan, wgl):
    """The batch plan without row-wise selection: every slot stepped."""
    return wgl.BatchPlan(plan.dims, plan.tabs, plan.nD, plan.nO, plan.totals,
                         plan.init_state, None, plan.device)


def model_histories():
    """{model: (valid, perturbed)} 2000-op histories of every device model
    besides the registers."""
    from jepsen_tpu_torch.testing import HISTORY_MODELS, random_model_history

    out = {}
    for name in HISTORY_MODELS:
        v = {k: x for k, x in MODELS_2K.items() if k != "seed"}
        b = {k: x for k, x in MODELS_2K_BAD.items() if k != "seed"}
        out[name] = (random_model_history(random.Random(MODELS_2K["seed"]), name, **v),
                     random_model_history(random.Random(MODELS_2K_BAD["seed"]), name,
                                          perturb=True, **b))
    return out


def model_kernel_phase(lv, wgl, hists):
    """model_kernels: each family's wgl_expand against the plain expand
    (its step_torch) bit for bit, at the selected and the unselected
    layout, from a frontier warmed for MODEL_WARM_LEVELS beam levels on
    the family's valid history; at state widths above one, every
    downstream stage too. Returns ({family: expand summary at the selected
    layout}, {S: {stage: summary}}, max_abs_err by stage)."""
    from jepsen_tpu_torch.ops.encode import encode_history
    from jepsen_tpu_torch.testing import history_model

    families, widths, errs = {}, {}, {}
    for name, (h, _bad) in hists.items():
        model = history_model(name)
        plan = batch_plan([encode_history(model, h)], wgl)
        if plan.B is None:
            raise AssertionError(f"{name}: the history's plan has no row-wise selection")
        row = {"phase": "model_kernels", "model": name, "S": model.state_width,
               "W": plan.dims[0], "KO": plan.dims[1], "F": MODEL_KERNELS_F, "layouts": {}}
        for layout, p in (("selected", plan), ("unselected", unselected(plan, wgl))):
            full = model.state_width > 1 and layout == "selected"
            chk = StageCheck(p, MODEL_KERNELS_F, lv, wgl, model, warm=MODEL_WARM_LEVELS,
                             expand_only=not full, plain_reps=MODEL_PLAIN_REPS)
            chk.run()
            stages = stage_summary(chk, lv)
            row["layouts"][layout] = {"B": chk.g.B, "M": chk.g.M, "two_stage": chk.g.two_stage,
                                      "valid_configs": chk.valid_configs[0],
                                      "expanded": chk.n_exp[0], "stages": stages}
            for k, v in stages.items():
                errs[k] = max(errs.get(k, 0), v["max_abs_err"])
            if layout == "selected":
                families[name] = dict(stages["wgl_expand"], S=model.state_width,
                                      valid_configs=chk.valid_configs[0])
            if full:
                widths[model.state_width] = dict(stages, _model=name)
        emit(row)
    if sorted(widths) != [2, 3, 4, 8]:
        raise AssertionError(f"model_kernels ran the stages at widths {sorted(widths)}")
    return families, widths, errs


def mutex_5k_phase(lv, wgl):
    """BASELINE config 3 through the lock workload's checker on the card:
    True, with the stats entry; the same search on the plain path (verdict,
    levels, rungs, per-level rows); every level kernel launched; wall,
    ms/level and the device's idle share; and wgl_expand against the plain
    expand at this history's own capacity (16) after MODEL_WARM_LEVELS
    levels, with the parent's hash launch (the yardstick) that the
    single-stage expand's keys replace. Returns (the launch counts, that
    expand summary, the parent hash's summary or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jepsen_tpu_torch.ops.encode import encode_history
    from jepsen_tpu_torch.testing import history_model, random_lock_history
    from jepsen_tpu_torch.workloads import lock

    h = random_lock_history(random.Random(MUTEX_5K["seed"]), n_ops=MUTEX_5K["n_ops"],
                            n_procs=MUTEX_5K["n_procs"])
    chk = lock.checker({"model": "owner-aware-mutex"})
    chk.check({}, h, {})  # workspaces and first-call costs
    reset_counts(lv)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = chk.check({}, h, {})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts(lv, "mutex_5k", LEVEL_KERNELS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chk.check({}, h, {})
        torch.cuda.synchronize()
    busy = sum((getattr(e, "self_device_time_total", 0) or 0) / 1e3
               for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "cuda" in str(e.device_type).lower())
    model = history_model("owner-aware-mutex")
    k = wgl.check_history(model, h, backend="device", collect_stats=True)
    p = wgl.check_history(model, h, backend="device", collect_stats=True, plain=True)
    lin = res["linear"]
    same = same_search(k, p) and all(lin.get(x) == k.get(x)
                                     for x in ("valid", "levels", "frontier_max"))
    levels = max(lin["levels"], 1)
    F = lin["attempts"][-1]["F"]
    chk_k = StageCheck(batch_plan([encode_history(model, h)], wgl), F, lv, wgl, model,
                       warm=MODEL_WARM_LEVELS, expand_only=True, plain_reps=MODEL_PLAIN_REPS)
    chk_k.run()
    expand = dict(stage_summary(chk_k, lv)["wgl_expand"], F=F,
                  valid_configs=chk_k.valid_configs[0])
    emit({"phase": "mutex_5k", "ops": len(h), "valid": res["valid"],
          "linear_valid": lin["valid"], "stats": {x: res["stats"].get(x) for x in
                                                  ("valid", "count", "ok_count", "fail_count")},
          "levels": lin["levels"], "wall_s": wall, "ms_per_level": 1e3 * wall / levels,
          "device_busy_ms_per_level": busy / levels if busy else None,
          "device_idle_share": 1 - busy / (1e3 * wall) if busy else None,
          "attempts": [(a["F"], a["levels"]) for a in lin["attempts"]],
          "launches": launches, "same_as_plain": same, "wgl_expand_at_frontier": expand,
          "k_hash_parent": getattr(chk_k, "hash_parent", None)})
    if not (res["valid"] is True and lin["valid"] is True and "stats" in res and same):
        raise AssertionError("mutex_5k failed")
    return launches, expand, getattr(chk_k, "hash_parent", None)


def models_2k_phase(lv, wgl, wgl_host, hists):
    """Each model's valid history (True, or unknown through the top-rung
    beam only, never False, and then the same search as the plain path on
    the card, rung for rung and level for level) and perturbed history (agreeing with the plain
    path on the card, witness included, and with the host oracle) through
    check_history(..., backend="device"). Returns each family's launch
    counts."""
    import torch

    from jepsen_tpu_torch.testing import history_model

    launches = {}
    for name, (good, bad) in hists.items():
        model = history_model(name)
        reset_counts(lv)
        t = time.perf_counter()
        rg = wgl.check_history(model, good, backend="device")
        torch.cuda.synchronize()
        good_wall = time.perf_counter() - t
        t = time.perf_counter()
        rb = wgl.check_history(model, bad, backend="device", collect_stats=True)
        torch.cuda.synchronize()
        bad_wall = time.perf_counter() - t
        launches[name] = launch_counts(lv, f"models_2k {name}", LEVEL_KERNELS)
        # A valid history left unknown by the top-rung beam ran the widest
        # frontiers of the phase: its whole search, every rung and level,
        # is held against the plain path on the card.
        good_plain = None
        if rg["valid"] == "unknown":
            kg = wgl.check_history(model, good, backend="device", collect_stats=True)
            t = time.perf_counter()
            pg = wgl.check_history(model, good, backend="device", collect_stats=True,
                                   plain=True)
            torch.cuda.synchronize()
            good_plain = {"same_as_plain": same_search(kg, pg) and kg["valid"] == rg["valid"],
                          "plain_wall_s": time.perf_counter() - t}
        pb = wgl.check_history(model, bad, backend="device", collect_stats=True, plain=True)
        host = wgl_host.check_history_host(model, bad)
        ok = (rg["valid"] is True or (rg["valid"] == "unknown" and rg.get("beam")
                                      and good_plain["same_as_plain"])) and \
            rb["valid"] == host["valid"] is False and same_search(rb, pb) and \
            bool(rb.get("stuck_configs")) and rb["max_linearized"] == host["max_linearized"]
        emit({"phase": "models_2k", "model": name, "S": model.state_width,
              "valid": rg["valid"], "levels": rg.get("levels"), "wall_s": good_wall,
              "phase_name": rg.get("phase"), "beam": bool(rg.get("beam")),
              "attempts": [(a["F"], a["levels"]) for a in rg.get("attempts") or []],
              "perturbed_valid": rb["valid"], "perturbed_levels": rb.get("levels"),
              "perturbed_wall_s": bad_wall, "host_valid": host["valid"],
              "host_max_linearized": host.get("max_linearized"),
              "max_linearized": rb.get("max_linearized"), "same_as_plain": same_search(rb, pb),
              "valid_vs_plain": good_plain, "launches": launches[name]})
        if not ok:
            raise AssertionError(f"models_2k {name} failed")
    return launches


def keyed_mr_histories(independent, History, keys=KEYED["keys"]):
    """KEYED's model, its per-key histories (every ``perturb_every``-th
    perturbed) and the keyed history of ``[k v]`` values; the first
    ``keys`` keys."""
    from jepsen_tpu_torch.models import MultiRegister
    from jepsen_tpu_torch.testing import random_model_history

    model = MultiRegister({0: None, 1: None, 2: None})
    hists = [random_model_history(random.Random(KEYED["seed"] + k), "multi-register",
                                  n_ops=KEYED["n_ops"], n_procs=KEYED["n_procs"],
                                  crash_p=KEYED["crash_p"],
                                  perturb=k % KEYED["perturb_every"] == 0)
             for k in range(keys)]
    keyed_ops = []
    for k, h in enumerate(hists):
        for o in h:
            keyed_ops.append(o.with_(value=independent.KV(k, o.value), index=len(keyed_ops)))
    return model, hists, History(keyed_ops, reindex=False)


def keyed_multi_register_phase(lv, wgl_host, jchecker, independent, History):
    """100 keys of single-register ops over registers (0, 1, 2) through the
    keyed checker: every key batched (S = 3), the same launches as
    check_batch, agreeing with the plain path (a prefix of keys) and the
    host oracle; and the compose wiring on a few keys, key by key, with
    the batch's results. Returns the keyed checker's launch counts."""
    import torch

    from jepsen_tpu_torch.parallel import check_batch

    model, hists, keyed_h = keyed_mr_histories(independent, History)
    keyed_ops = keyed_h.ops
    check_batch(model, hists)  # workspaces and first-call costs
    reset_counts(lv)
    rb = check_batch(model, hists)
    torch.cuda.synchronize()
    batch_launches = launch_counts(lv, "check_batch of the keyed members", LEVEL_KERNELS)
    reset_counts(lv)
    t = time.perf_counter()
    keyed = independent.checker(jchecker.linearizable(model=model)).check({}, keyed_h, {})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts(lv, "keyed_multi_register", LEVEL_KERNELS)
    results = [keyed["results"][k] for k in range(len(hists))]
    n_plain = KEYED["plain_keys"]
    rp = check_batch(model, hists[:n_plain], plain=True)
    rk = check_batch(model, hists[:n_plain])
    host = [wgl_host.check_history_host(model, h)["valid"] for h in hists]
    n_comp = KEYED["compose_keys"]
    comp_ops = [o for o in keyed_ops if o.value.key < n_comp]
    comp = independent.checker(jchecker.compose({
        "linear": jchecker.linearizable(model=model), "stats": jchecker.stats()})).check(
        {}, History(comp_ops, reindex=False), {})
    agree = {
        "batched": all(r.get("batched") is True for r in results),
        "same_as_check_batch": all(same_member(a, b) for a, b in zip(rb, results)),
        "launches_as_check_batch": launches == batch_launches,
        "plain_prefix": all(same_member(a, b) for a, b in zip(rk, rp)),
        "host": [r["valid"] for r in results] == host,
        "compose_key_by_key": all("batched" not in comp["results"][k]["linear"]
                                  for k in range(n_comp)),
        "compose_as_batch": [(comp["results"][k]["linear"]["valid"],
                              comp["results"][k]["linear"].get("levels"))
                             for k in range(n_comp)]
        == [(r["valid"], r.get("levels")) for r in results[:n_comp]],
    }
    verdicts = [r["valid"] for r in results]
    emit({"phase": "keyed_multi_register", "keys": len(hists), "valid": verdicts.count(True),
          "invalid": verdicts.count(False), "unknown": verdicts.count("unknown"),
          "keyed_valid": keyed["valid"], "wall_s": wall, "launches": launches,
          "levels_enqueued": launches["wgl_expand"],
          "member_levels_sum": sum(r.get("levels", 0) for r in results),
          "plain_keys": n_plain, "compose_keys": n_comp, "agree": agree})
    if not all(agree.values()):
        raise AssertionError(f"keyed_multi_register disagrees: {agree}")
    return launches


# -- the frontier-sharded search ------------------------------------------


def sharded_setup(lv, wgl, enc, F_total, D, mode, model):
    """(plan, sharded geometry, tables repeated for each shard) of ``enc``
    on D shards of ``F_total // D`` rows."""
    plan = wgl.plan_device(enc, device="cuda")
    g = wgl.sharded_geometry(plan, F_total // D, D, mode)
    tabs = {k: v[None].expand((D,) + tuple(v.shape)).contiguous()
            for k, v in plan.tabs.items()}
    return plan, g, tabs


def shard_frontier(fr, D):
    """A one-member frontier ``[1, F, ...]`` laid on D shards ``[D, F/D,
    ...]`` in the global (shard-major) order, as the reference reshards."""
    return tuple(a.reshape((D, a.shape[1] // D) + tuple(a.shape[2:])).clone() for a in fr)


def sharded_ctl(lv, g, plan, fr, lvl, lossy):
    """Control blocks at a chunk's start on ``fr`` (plain chunk init and
    stage-0 reduce), for a one-level comparison."""
    import torch

    ctl = torch.zeros((g.D, lv.CTL_SIZE), dtype=torch.int32, device="cuda")
    lv.chunk_init_plain(ctl, fr[4], None, [(lvl, lvl + 1, int(lossy), plan.nD, plan.nO)])
    lv.shard_reduce_plain(g, ctl, 0)
    return ctl


def received_keys_err(lv, g, ctl, drows, rvalid, fkey) -> int:
    """The received rows' keys against ``hash_rows_reference`` of the same
    rows, every slot of every going shard, bit for bit."""
    want = fkey.clone()
    lv.vmap_members(lv.hash_rows_reference)(g, drows, rvalid, ctl, want)
    return max_abs_err(fkey, want)


def _stage_err(lv, name, ak, ap, wk, wp, fk, fp) -> int:
    """max_abs_err of what sharded stage ``name`` wrote, kernel against
    plain (rows nobody reads are left out: an unexpanded slot, a stage-1
    row past the survivors, and its key); the received keys also against
    the hash of the received rows."""
    if name == "expand":
        vm = wp.nvalid.bool()
        return max(max_abs_err(wk.ctl, wp.ctl), max_abs_err(wk.nvalid, wp.nvalid),
                   max_abs_err(wk.rows[vm], wp.rows[vm]))
    if name == "stage1_hash":
        n = wp.ctl[:, lv.CTL_NEXP].clamp(max=wp.crows.shape[1]).tolist()
        return max(_rows_err(wk.crows, wp.crows, n),
                   _rows_err(wk.ckey, wp.ckey, n) if wk.ckey is not None else 0)
    if name in ("route", "exchange"):
        return max(max_abs_err(wk.drows, wp.drows), max_abs_err(wk.rvalid, wp.rvalid),
                   max_abs_err(wk.ctl, wp.ctl), max_abs_err(wk.fkey, wp.fkey),
                   received_keys_err(lv, ak[0], wk.ctl, wk.drows, wk.rvalid, wk.fkey))
    if name == "take_col_sort":
        return max(max_abs_err(ak[2], ap[2]), max_abs_err(ak[3], ap[3]))
    if name == "radix_sort_pairs":
        return max(max_abs_err(ak[0], ap[0]), max_abs_err(ak[1], ap[1]))
    if name == "prune":  # the control blocks hold the cross-shard reduce's fields
        return max(max_abs_err(wk.fprio, wp.fprio), max_abs_err(wk.ctl, wp.ctl))
    if name == "gather_finalize":
        return max([max_abs_err(a, b) for a, b in zip(fk, fp)] + [max_abs_err(wk.ctl, wp.ctl)])
    raise KeyError(name)


# The kernels line's names of the sharded level's own launches (the prune,
# the chunk start and the finalize are listed apart from the single
# level's: their sharded arms run the cross-shard reduce or the shard's
# slice) and the LAUNCHES key each is counted under.
SHARD_KERNEL = {"route": "wgl_route", "exchange": "wgl_exchange", "prune": "wgl_prune_sharded",
                "gather_finalize": "wgl_gather_finalize_sharded"}
SHARD_COUNT = {"wgl_prune_sharded": "wgl_prune", "wgl_chunk_init_sharded": "wgl_chunk_init",
               "wgl_gather_finalize_sharded": "wgl_gather_finalize"}


def stage_kernel(lv, name) -> str:
    """The kernel name of a sharded stage (SHARD_KERNEL, else its entry
    point's)."""
    return SHARD_KERNEL.get(name) or lv._PACKERS[name][0]


def sharded_lockstep(lv, g, tabs, model, fr, ctl, on_stage=None):
    """One sharded level, stage by stage, through the kernels and through
    the plain versions on identical inputs (two workspaces, two frontiers
    from ``fr`` and control blocks from ``ctl``), each stage's output
    compared: {kernel: max_abs_err}. ``on_stage(name, kernel_args,
    plain_args)`` runs before each stage (timing)."""
    import torch

    wk, wp = lv.BatchWorkspace(g, g.D, "cuda"), lv.BatchWorkspace(g, g.D, "cuda")
    wk.ctl.copy_(ctl)
    wp.ctl.copy_(ctl)
    fk, fp = tuple(t.clone() for t in fr), tuple(t.clone() for t in fr)
    errs = {}
    for (name, ak), (_n, ap) in zip(lv._sharded_level_stages(g, tabs, fk, wk, model),
                                    lv._sharded_level_stages(g, tabs, fp, wp, model)):
        if on_stage is not None:
            on_stage(name, ak, ap)
        getattr(lv.KERNELS, name)(*ak)
        getattr(lv.PLAIN, name)(*ap)
        torch.cuda.synchronize()
        k = stage_kernel(lv, name)
        errs[k] = max(errs.get(k, 0), _stage_err(lv, name, ak, ap, wk, wp, fk, fp))
    return errs, wp


# Timed sharded stages: the index of each one's control blocks among its
# arguments.
SHARD_TIMED_CTL = {"stage1_hash": 3, "route": 2, "exchange": 2, "prune": 4,
                   "gather_finalize": 3}


def _sharded_call(lv, name, a, plain):
    """(fn, written inputs) of one sharded stage call for ``batch_ms``."""
    f = getattr(lv.PLAIN if plain else lv.KERNELS, name)
    if name == "stage1_hash":  # (g, rows, nvalid, ctl, crows, ckey, scratch)
        if a[5] is not None:
            return (lambda t: f(a[0], a[1], a[2], t[0], t[1], t[2], a[6])), (a[3], a[4], a[5])
        return (lambda t: f(a[0], a[1], a[2], t[0], t[1], None, a[6])), (a[3], a[4])
    if name == "route":  # (g, crows, ctl, drows, rvalid, scratch, fkey)
        return (lambda t: f(a[0], a[1], t[0], t[1], t[2], a[5], t[3])), (a[2], a[3], a[4], a[6])
    if name == "exchange":  # (g, crows, ctl, recv, rvalid, skey, fkey)
        return (lambda t: f(a[0], a[1], a[2], t[0], t[1], a[5], t[2])), (a[3], a[4], a[6])
    if name == "prune":  # (g, drows, skey, perm, ctl, fprio, scratch)
        return (lambda t: f(a[0], a[1], a[2], a[3], t[0], t[1], a[6])), (a[4], a[5])
    # gather_finalize (g, drows, perm, ctl, stats, fr, scratch)
    return (lambda t: f(a[0], a[1], a[2], t[0], t[1], t[2:], a[6])), (a[3], a[4]) + tuple(a[5])


def _parent_call(lv, name, a):
    """(fn, written inputs) of the parent design of a timed sharded stage
    (the yardsticks), or None: the route and the alltoall exchange (two
    launches) and the hash of the received rows, the allgather's exchange
    without keys and the hash, or the prune and the reduce (two
    launches)."""
    import torch

    g = a[0]
    if name == "route":  # (g, crows, ctl, drows, rvalid, scratch, fkey)
        sr = g.D * g.PBK
        send = torch.zeros((g.D, sr, g.NC), dtype=torch.int32, device="cuda")
        svalid = torch.zeros((g.D, sr), dtype=torch.uint8, device="cuda")

        def route(t):
            yard_route_exchange(lv, g, a[1], t[0], send, svalid, t[1], t[2])
            yard_hash(lv, t[1], t[2], t[0], t[3], g.NC, g.NID)
        return route, (a[2], a[3], a[4], a[6])
    if name == "exchange":  # (g, crows, ctl, recv, rvalid, skey, fkey)
        def gather(t):
            yard_gather(lv, g, a[1], a[2], t[0], t[1])
            yard_hash(lv, t[0], t[1], a[2], t[2], g.NC, g.NID)
        return gather, (a[3], a[4], a[6])
    if name == "prune":
        return ((lambda t: yard_prune_reduce(lv, g, a[1], a[2], a[3], t[0], t[1], a[6])),
                (a[4], a[5]))
    return None


def _gather_ms(lv, a) -> float:
    """ms of the parent's allgather exchange alone (the yardstick, no
    keys) on the exchange's arguments ``a``: the design before the keys
    went with the rows."""
    return batch_ms(lambda t: yard_gather(lv, a[0], a[1], a[2], t[0], t[1]), (a[3], a[4]))[0]


def sharded_bytes(lv, name, g, ctl_after) -> int:
    """Bytes a sharded stage must move (inputs read once, outputs written
    once) at this level's counts."""
    D, NC, L = g.D, g.NC, g.L
    row = 4 * NC
    ctl_b = 4 * D * lv.CTL_SIZE
    n = int(ctl_after[:, lv.CTL_NEXP].clamp(max=g.P).sum())  # stage-1 rows
    out = 2 * ctl_b + D * L * (row + 1 + 4)  # every received row, its byte and key written
    if name == "stage1_hash":  # the validity bytes, the survivors read and written
        key = 4 if g.exchange == "allgather" else 0  # (and their keys written)
        return D * g.M + n * (2 * row + key) + 2 * ctl_b
    if name == "route":  # the survivors read (their keys are hashed from them)
        return n * row + out
    if name == "exchange":  # the survivors and stage 1's keys of them read
        return n * (row + 4) + out
    if name == "prune":  # keys, perm and priorities, the rows gathered
        return D * L * (12 + row) + 2 * ctl_b
    if name == "chunk_init":
        return D * g.F + 2 * ctl_b
    kept = int(ctl_after[0, lv.CTL_NSUM])
    fr_row = 4 * (1 + g.KD + g.KO1 + g.S) + 1
    return kept * (row + 4) + 2 * ctl_b + D * g.F * fr_row


def _library_exchange(g, send):
    """One PyTorch call moving the same rows as the allgather (a yardstick
    only): a broadcast copy of the stage-1 rows to every shard."""
    return batch_ms(lambda t: t[0][None].expand((g.D,) + tuple(t[0].shape)).contiguous(),
                    (send,), clone=False)[0]


def _timed_summary(err, ms, call_ms, plain_ms, nbytes, library_ms=None, parent_ms=None) -> dict:
    out = {"max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
           "library_ms": library_ms}
    if parent_ms is not None:
        out.update(parent_ms=parent_ms, vs_parent=ms / parent_ms)
    return out


def exchange_scale_phase(lv, wgl, enc, model):
    """The route (alltoall) and the exchange (allgather) alone at the
    shard geometry of SHARD_BIG_F_TOTAL on SHARD_D shards, on seeded
    stage-1 rows (every source's n_cand between P / 2 and 9 P / 8), bit
    for bit against their plain versions; each timed beside its parent
    design (the yardsticks, checked too), the exchange also beside the
    parent's exchange alone (no keys) and ``_library_exchange``'s one
    copy. Returns {mode: summary}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SHARD_BIG_F_TOTAL)
    out = {}
    for mode in lv.EXCHANGES:
        plan, g, _tabs = sharded_setup(lv, wgl, enc, SHARD_BIG_F_TOTAL, SHARD_D, mode, model)
        D, NC, a2a = g.D, g.NC, mode == "alltoall"
        rint = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen,  # noqa: E731
                                                   device="cuda", dtype=torch.int64)
        crows = rint(-2**31, 2**31 - 1, (D, g.P, NC)).to(torch.int32)
        ctl = torch.zeros((D, lv.CTL_SIZE), dtype=torch.int32, device="cuda")
        ctl[:, lv.CTL_GO] = 1
        ctl[:, lv.CTL_NEXP] = rint(g.P // 2, g.P + g.P // 8, (D,)).to(torch.int32)
        recv = torch.zeros((D, g.L, NC), dtype=torch.int32, device="cuda")
        rvalid = torch.zeros((D, g.L), dtype=torch.uint8, device="cuda")
        fkey = torch.zeros((D, g.L), dtype=torch.int32, device="cuda")
        if a2a:
            name, args = "route", (g, crows, ctl, recv, rvalid, lv.route_scratch(g, "cuda"),
                                   fkey)
        else:  # stage 1's keys of the rows: their hash below each source's n_cand
            ckey = torch.zeros((D, g.P), dtype=torch.int32, device="cuda")
            below = torch.arange(g.P, device="cuda")[None] < ctl[:, lv.CTL_NEXP, None]
            lv.vmap_members(lv.hash_rows_reference)(g, crows, below, ctl, ckey)
            name, args = "exchange", (g, crows, ctl, recv, rvalid, ckey, fkey)
        fk, ins = _sharded_call(lv, name, args, plain=False)
        fp, _ = _sharded_call(lv, name, args, plain=True)
        ki, pi = tuple(t.clone() for t in ins), tuple(t.clone() for t in ins)
        fk(ki)
        fp(pi)
        parent = _parent_call(lv, name, args)
        if parent is not None:
            yi = tuple(t.clone() for t in ins)
            parent[0](yi)
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(ki, pi))
        perr = max(max_abs_err(a, b) for a, b in zip(yi, pi)) if parent else 0
        del ki, pi
        if err or perr:
            raise AssertionError(f"{SHARD_KERNEL[name]} (or its parent) disagrees with its plain "
                                 f"version at f_total {SHARD_BIG_F_TOTAL} ({mode})")
        ms, call_ms = batch_ms(fk, ins)
        plain_ms, _ = batch_ms(fp, ins, hold=False, batch=3, batches=3)
        parent_ms = batch_ms(*parent)[0] if parent else None
        lib = None if a2a else _library_exchange(g, crows)
        out[mode] = dict(_timed_summary(err, ms, call_ms, plain_ms,
                                        sharded_bytes(lv, name, g, ctl), lib, parent_ms),
                         kernel=SHARD_KERNEL[name],
                         tile=lv.route_tile(g.P, D, "cuda") if a2a else None)
        if not a2a:
            out[mode]["parent_gather_ms"] = _gather_ms(lv, args)
        emit({"phase": "exchange_scale", "exchange": mode, "f_total": SHARD_BIG_F_TOTAL,
              "D": D, "F": g.F, "P": g.P, "PBK": g.PBK, "L": g.L, "NC": NC, **out[mode]})
        del crows, recv, rvalid, fkey, args, ins
        torch.cuda.empty_cache()
    return out


def received_hash_parent(lv, g, wp, ctl) -> dict:
    """The parent's hash of the received rows (k_hash, the yardstick: what
    the route and the exchange now write with the rows) on a sharded
    level's received rows ``wp``, control blocks ``ctl`` (the level's,
    going): bit for bit against the plain hash and the received keys, its
    ms, plain ms and bound."""
    import torch

    hash_all = lv.vmap_members(lv.hash_rows_reference)
    ctl = ctl.to("cuda")
    y, q = wp.fkey.clone(), wp.fkey.clone()
    yard_hash(lv, wp.drows, wp.rvalid, ctl, y, g.NC, g.NID)
    hash_all(g, wp.drows, wp.rvalid, ctl, q)
    torch.cuda.synchronize()
    err = max(max_abs_err(y, q), max_abs_err(y, wp.fkey))
    ms = batch_ms(lambda t: yard_hash(lv, wp.drows, wp.rvalid, ctl, t[0], g.NC, g.NID),
                  (wp.fkey,))[0]
    plain_ms = batch_ms(lambda t: hash_all(g, wp.drows, wp.rvalid, ctl, t[0]), (wp.fkey,),
                        hold=False, batch=3, batches=3)[0]
    nbytes = g.D * g.L * (4 * g.NID + 1 + 4)
    return {"L": g.L, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            **bound_fields(ms, nbytes)}


def sharded_device_launches(lv, wgl, enc, model) -> dict:
    """Device launches of one sharded level (each mode, its level program)
    and of a sharded chunk start, counted from a stream capture
    (``testing.device_work``): 7 + KO1 and 1."""
    from jepsen_tpu_torch.testing import device_work

    out = {}
    for mode in lv.EXCHANGES:
        plan, g, tabs = sharded_setup(lv, wgl, enc, SHARD_F_TOTAL, SHARD_D, mode, model)
        fr = wgl.initial_frontier(SHARD_F_TOTAL, g.W, g.KO, g.S, plan.init_state, "cuda")
        fr = shard_frontier(tuple(a[None] for a in fr[:5]), SHARD_D)
        ws = lv.BatchWorkspace(g, SHARD_D, "cuda")
        lv._LevelProgram(g, tabs, fr, ws, model)()
        # packed inside the capture, so that the launches go to its stream
        out[mode] = device_work(lambda: lv._LevelProgram(g, tabs, fr, ws, model)())
        if mode == "alltoall":
            out["chunk_start"] = device_work(lambda: lv.chunk_init(
                ws.ctl, fr[4], ws.stats, [(0, 9, 0, plan.nD, plan.nO)], ws.gf))
        want = 7 + g.KO1
        if out[mode] != {"kernel": want, "memcpy": 0, "memset": 0, "other": 0}:
            raise AssertionError(f"a sharded level ({mode}) is not {want} launches: {out[mode]}")
    if out["chunk_start"]["kernel"] != 1 or sum(out["chunk_start"].values()) != 1:
        raise AssertionError(f"a sharded chunk start is not one launch: {out['chunk_start']}")
    return out


CHUNK_START_REPS = 200  # host-wall samples of each design, the two in turns
CHUNK_START_LADDER = 200  # members of the ladder-table case (above CS_INLINE)


def _median_wall_ms(fns, reps) -> list:
    """Median host ms of each of ``fns`` (each call after a synchronize, so
    the stream is idle as at a chunk's start), the calls in turns with the
    order flipped every sample."""
    import torch

    samples = [[] for _ in fns]
    for r in range(reps):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fns[i]()
            samples[i].append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    return [statistics.median(x) for x in samples]


def _span_ms(fn, reps=20) -> float:
    """Median device ms from an event before ``fn``'s work to one after it,
    with no holding sleep: the parent's pageable copy waits for the host,
    so its start is timed as the device sees it, host gaps included."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(out)


def chunk_start_case(lv, label, valid, sharded, seed) -> dict:
    """One chunk start of ``valid [nb, F]``'s members: the one launch bit
    for bit against its plain version (control blocks, stats rings, the
    ticket left zero) and the parent's whole start (which must agree;
    sharded, the earlier design's two launches too, the yardsticks),
    with some members stopped (a start with no budget, an empty frontier);
    the kernel's device ms beside the parent's count launch alone and the
    parent's whole start as the device sees it; the host wall from the
    first call to the point where the first level is enqueued (the parent
    read the control blocks there, the new start does not); the device
    operations of one start by stream capture."""
    import numpy as np
    import torch

    from jepsen_tpu_torch.testing import device_work

    nb, F = valid.shape
    rng = np.random.default_rng(seed)
    n = 1 if sharded else nb
    lvl0 = rng.integers(0, 7000, n)
    budget = lvl0 + rng.integers(1, 64, n)
    if n > 2:
        budget[::5] = lvl0[::5]  # no budget: stopped at the start
    lists = [x.tolist() * (nb // n) for x in (lvl0, budget, rng.integers(0, 2, n),
                                              rng.integers(1, 10001, n), rng.integers(0, 9, n))]
    valid = valid.clone()
    if nb > 2:
        valid[1::7] = 0  # empty frontiers
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda") if sharded else None
    ctl = torch.ones((nb, lv.CTL_SIZE), dtype=torch.int32, device="cuda")
    stats = torch.ones((nb, lv.LEVEL_STAT_ROWS, 4), dtype=torch.int32, device="cuda")
    rows = lv.chunk_rows(*lists)
    outs = []
    for fn in (lambda c, st: lv.chunk_init(c, valid, st, rows, ticket),
               lambda c, st: lv.chunk_init_plain(c, valid, st, rows, ticket),
               lambda c, st: parent_chunk_start(lv, c, valid, st, ticket, lists)):
        c, st = ctl.clone(), stats.clone()
        fn(c, st)
        outs.append((c, st))
    torch.cuda.synchronize()
    err = max(max_abs_err(outs[0][0], outs[1][0]), max_abs_err(outs[0][1], outs[1][1]))
    parent_err = max(max_abs_err(outs[2][0], outs[1][0]), max_abs_err(outs[2][1], outs[1][1]))
    go = outs[0][0][:, lv.CTL_GO]
    if err or parent_err or int(outs[0][1].abs().sum()) or (ticket is not None and int(ticket)):
        raise AssertionError(f"chunk start {label}: kernel {err}, parent {parent_err}")
    kernel = lambda t: lv.chunk_init(t[0], valid, t[1], rows, ticket)  # noqa: E731
    ms, call_ms = batch_ms(kernel, (ctl, stats))
    plain_ms, _ = batch_ms(lambda t: lv.chunk_init_plain(t[0], valid, t[1], rows, ticket),
                           (ctl, stats), hold=False, batch=3, batches=3)
    copied = parent_init(lv, nb, rows).to("cuda")
    parent_kernel_ms, _ = batch_ms(lambda t: yard_chunk_init(lv, t[0], valid, ticket),
                                   (copied,))

    def parent_device():
        ctl.copy_(parent_init(lv, nb, list(zip(*lists))))
        stats.zero_()
        yard_chunk_init(lv, ctl, valid, ticket)

    span_new = _span_ms(lambda: lv.chunk_init(ctl, valid, stats, lv.chunk_rows(*lists), ticket))
    span_parent = _span_ms(parent_device)
    wall_new, wall_parent = _median_wall_ms(
        [lambda: lv.chunk_init(ctl, valid, stats, lv.chunk_rows(*lists), ticket),
         lambda: parent_chunk_start(lv, ctl, valid, stats, ticket, lists)], CHUNK_START_REPS)
    work = device_work(lambda: lv.chunk_init(ctl, valid, stats, rows, ticket))
    if work != {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0}:
        raise AssertionError(f"chunk start {label} is not one launch: {work}")
    out = _timed_summary(err, ms, call_ms, plain_ms, chunk_start_bytes(lv, nb, F), None,
                         parent_kernel_ms)
    if sharded:  # the earlier design: the count launch, then a one-thread reduce
        pair = lambda t: yard_chunk_init_reduce(lv, t[0], valid)  # noqa: E731
        c = (copied.clone(),)
        pair(c)
        if max_abs_err(c[0], outs[1][0]):
            raise AssertionError(f"chunk start {label}: the two-launch parent disagrees")
        out["parent_two_launch_ms"] = batch_ms(pair, (copied,))[0]
    out.update(label=label, nb=nb, F=F, sharded=sharded, rows=len(rows),
               stopped=int((go == 0).sum()), parent_max_abs_err=parent_err,
               device_span_ms=span_new, parent_device_span_ms=span_parent,
               host_wall_ms=wall_new, parent_host_wall_ms=wall_parent, device_work=work)
    return out


def chunk_start_ladder(lv, F=64, chunks=3, lpc=7) -> dict:
    """A batch above CS_INLINE members: the chunk start reads the ladder
    table on the card. Three chunks of the ladder's rule (the rung's first,
    then from control blocks that levels left accepted, overflowed,
    stuck, emptied or at their total), bit for bit against the plain
    version, table included; one launch by capture."""
    import numpy as np
    import torch

    from jepsen_tpu_torch.testing import device_work

    nb = CHUNK_START_LADDER
    rng = np.random.default_rng(15)
    totals = rng.integers(1, 40, nb)
    kt = lv.ladder_table(np.minimum(rng.integers(0, 30, nb), totals), totals,
                         rng.integers(0, 2, nb), rng.integers(1, 99, nb), rng.integers(0, 9, nb),
                         "cuda")
    pt = kt.clone()
    kc = torch.zeros((nb, lv.CTL_SIZE), dtype=torch.int32, device="cuda")
    pc = kc.clone()
    ks = torch.ones((nb, lv.LEVEL_STAT_ROWS, 4), dtype=torch.int32, device="cuda")
    ps = ks.clone()
    err, active = 0, []
    for _ in range(chunks):
        valid = torch.from_numpy((rng.random((nb, F)) < 0.5).astype(np.uint8)).to("cuda")
        lv.chunk_init(kc, valid, ks, None, table=kt, lpc=lpc)
        lv.chunk_init_plain(pc, valid, ps, None, table=pt, lpc=lpc)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(kc, pc), max_abs_err(ks, ps), max_abs_err(kt, pt))
        active.append(int(kt[:, lv.CS_ACTIVE].sum()))
        step = torch.from_numpy(rng.integers(0, lpc + 1, nb).astype(np.int32)).to("cuda")
        kc[:, lv.CTL_LVL] = torch.minimum(kc[:, lv.CTL_LVL] + step, kc[:, lv.CTL_MAXLVL])
        for col in (lv.CTL_ACC, lv.CTL_OVF, lv.CTL_STUCK):
            kc[:, col] = torch.from_numpy((rng.random(nb) < 0.1).astype(np.int32)).to("cuda")
        pc.copy_(kc)
    work = device_work(lambda: lv.chunk_init(kc, valid, ks, None, table=kt, lpc=lpc))
    ms, _ = batch_ms(lambda t: lv.chunk_init(t[0], valid, t[1], None, None, t[2], lpc),
                     (kc, ks, kt))
    if err or work != {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0}:
        raise AssertionError(f"the ladder-table chunk start disagrees: {err}, {work}")
    return {"label": f"ladder_table_nb{nb}", "nb": nb, "F": F, "max_abs_err": err,
            "active_after_each_chunk": active, "ms": ms, "device_work": work}


def stopped_chunk_cost(lv, g, tabs, fr, ws, model) -> dict:
    """What a chunk that starts stopped (an empty frontier with levels left:
    a resumed finished search) costs now that the first run of levels is
    enqueued without reading the control blocks first: the whole chunk
    (the start, the first run's launches, which return at once, and the
    read), beside the start and a read alone (what reading first would
    cost), median host ms of 20 in turns."""
    fr0 = tuple(a.clone() for a in fr)
    fr0[4].zero_()
    nb = fr0[0].shape[0]
    lists = ([0] * nb, [100] * nb, [1] * nb, [9000] * nb, [0] * nb)
    whole, read_first = _median_wall_ms(
        [lambda: lv.run_chunk_batch(lv.KERNELS, g, tabs, fr0, ws, *lists, model),
         lambda: (lv.chunk_init(ws.ctl, fr0[4], ws.stats, lv.chunk_rows(*lists)),
                  ws.ctl.cpu())], 20)
    return {"stopped_chunk_ms": whole, "start_and_read_ms": read_first,
            "first_run_levels": 4}


def chunk_start_phase(lv, wgl, model, north_chk, batch_chk, replay_plan):
    """The chunk start at the main path's shapes (the north star at F 1024
    and 4096, nb 1; batch_8x10k's 8 x 8192; batch_replay_100's 100 x 64;
    sharded_10k's 8 shards of 512), the ladder table at 200 members, and
    what a chunk that starts stopped costs."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(15)
    rand = lambda nb, F: (torch.rand((nb, F), generator=gen, device="cuda")  # noqa: E731
                          < 0.3).to(torch.uint8)
    cases = [("north_star_F1024", rand(1, 1024), False),
             ("north_star_F4096", north_chk.fr[4], False),
             ("batch_8x8192", batch_chk.fr[4], False),
             ("replay_100x64", rand(replay_plan.nb, 64), False),
             ("sharded_D8", north_chk.fr[4].reshape(SHARD_D, -1), True)]
    out = {}
    for i, (label, valid, sharded) in enumerate(cases):
        out[label] = chunk_start_case(lv, label, valid.contiguous(), sharded, 100 + i)
        emit({"phase": "chunk_start", **out[label]})
    out["ladder"] = chunk_start_ladder(lv)
    emit({"phase": "chunk_start", **out["ladder"]})
    out["stopped"] = stopped_chunk_cost(lv, north_chk.g, north_chk.tabs, north_chk.fr,
                                        north_chk.ws, model)
    emit({"phase": "chunk_start", **out["stopped"]})
    return out


# The callbacks interrupt the north star after its first chunk at the
# beam's top capacity, and sharded_10k's alltoall search after its first
# chunk (at f_total SHARD_F_TOTAL). A resume starts a new rung at the
# saved level (both packages' checkpoints keep the frontier, not the
# driver's escalation state), so only a resume with no escalation or
# de-escalation ahead of it retraces the uninterrupted search row for
# row: at the top capacity, or before the first escalation.
TELEMETRY_TOP_F = 4096  # OPTIMISTIC_BEAM_F
TELEMETRY_TURNS = 3  # north-star runs with and without metrics, in turns


class Interrupted(Exception):
    """Raised by the telemetry phase's chunk callback to stop a search."""


def telemetry_phase(lv, wgl, model, hist, whole, frontier, make_mesh, encode_history,
                    random_register_history) -> dict:
    """The drivers' telemetry, chunk callbacks and checkpoints on the card.
    The north star with a Registry, a chunk callback and a checkpoint under
    a temporary directory, interrupted by the callback after its first
    chunk at TELEMETRY_TOP_F, then resumed: ``True`` at the main path's
    level with its per-level stats rows (the interrupted run's wgl_level
    events, then the resumed run's rows), the file gone. sharded_10k's
    first chunk saved under alltoall and resumed under allgather: the
    verdict and levels of an uninterrupted allgather search. The north
    star's wall with metrics and without, in turns."""
    import os
    import tempfile

    import numpy as np
    import torch

    from jepsen_tpu_torch.telemetry import Registry

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "north_star.npz")
        first, infos = Registry(), []

        def interrupt(info):
            infos.append(info)
            if info.get("F") == TELEMETRY_TOP_F or "global_capacity" in info:
                raise Interrupted

        try:
            wgl.check_history(model, hist, backend="device", metrics=first,
                              chunk_callback=interrupt, checkpoint_path=path)
            raise AssertionError("the north star was not interrupted")
        except Interrupted:
            pass
        saved = os.path.exists(path)
        reg = Registry()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = wgl.check_history(model, hist, backend="device", metrics=reg,
                                checkpoint_path=path, collect_stats=True)
        torch.cuda.synchronize()
        resumed_wall = time.perf_counter() - t
        rows = [[e["level"], e["frontier"], e["expanded"], int(e["overflow"])]
                for e in first.events("wgl_level")]
        same_rows = rows + res["level_stats"] == whole["level_stats"]
        out["north_star"] = {
            "valid": res["valid"], "levels": res["levels"], "saved": saved,
            "interrupted_at_level": infos[-1]["level"], "callback_keys": sorted(infos[-1]),
            "file_left": os.path.exists(path), "same_level_stats": same_rows,
            "resumed_wall_s": resumed_wall,
            "events": {k: len(first.events(k)) + len(reg.events(k))
                       for k in ("wgl_chunk", "wgl_level", "wgl_escalation")},
            "stages": sorted({e["stage"] for e in reg.events("wgl_chunk")}),
            "summary": {k: v for k, v in reg.summary().items()
                        if not k.startswith("wgl_kernel_seconds")}}
        first_chunk = reg.events("wgl_chunk")[0]["level0"] if reg.events("wgl_chunk") else None
        out["north_star"]["resumed_at_level"] = first_chunk
        if not (saved and res["valid"] is True and res["levels"] == whole["levels"]
                and same_rows and not out["north_star"]["file_left"]
                and first_chunk == infos[-1]["level"] > 0):
            raise AssertionError(f"the interrupted north star did not resume: {out}")

        h = random_register_history(random.Random(SHARD_10K["seed"]),
                                    **{k: v for k, v in SHARD_10K.items() if k != "seed"})
        enc = encode_history(model, h)
        kw = dict(mesh=make_mesh(SHARD_D), f_total=SHARD_F_TOTAL, max_escalations=2,
                  levels_per_call=SHARD_CHUNK_LEVELS)
        spath = os.path.join(tmp, "sharded_10k.npz")
        infos.clear()
        sreg = Registry()
        try:
            frontier.check_encoded_sharded(enc, exchange="alltoall", metrics=sreg,
                                           chunk_callback=interrupt, checkpoint_path=spath, **kw)
            raise AssertionError("sharded_10k was not interrupted")
        except Interrupted:
            pass
        saved_level = int(np.load(spath)["lvl"])
        wreg, rreg = Registry(), Registry()
        whole_ag = frontier.check_encoded_sharded(enc, exchange="allgather", metrics=wreg, **kw)
        resumed = frontier.check_encoded_sharded(enc, exchange="allgather", metrics=rreg,
                                                 checkpoint_path=spath, **kw)
        ran = lambda r: r.summary()["wgl_sharded_levels_total"]  # noqa: E731
        # an escalation_budget result has no levels: its attempts say where
        outcome = lambda r: (r["valid"], r.get("levels"),  # noqa: E731
                             [(a["F"], a["levels"]) for a in r["attempts"]],
                             [c["code"] for c in r.get("causes") or []])
        out["sharded_10k"] = {
            "saved_under": "alltoall", "resumed_under": "allgather",
            "resumed": outcome(resumed), "uninterrupted": outcome(whole_ag),
            "saved_level": saved_level, "levels_run": [ran(rreg), ran(wreg)],
            "chunk_events": len(sreg.events("wgl_sharded_chunk")),
            "imbalance": {k: v for k, v in sreg.summary().items() if "imbalance" in k}}
        # a resume runs the levels after the saved one, and no others
        if (outcome(resumed) != outcome(whole_ag) or saved_level <= 0
                or ran(rreg) + saved_level != ran(wreg)):
            raise AssertionError(f"sharded_10k did not resume across modes: {out}")

    walls = {"without": [], "with": []}
    for i in range(2 * TELEMETRY_TURNS):
        label = ("without", "with", "with", "without")[i % 4]
        reg = Registry() if label == "with" else None
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = wgl.check_history(model, hist, backend="device", metrics=reg)
        torch.cuda.synchronize()
        walls[label].append(time.perf_counter() - t)
        if r["valid"] is not True or r["levels"] != whole["levels"]:
            raise AssertionError("the north star changed under telemetry")
    out["north_star_wall_s"] = {k: sorted(v) for k, v in walls.items()}
    out["metrics_overhead"] = (statistics.median(walls["with"])
                               / statistics.median(walls["without"]) - 1)
    return out


def sharded_kernels_phase(lv, wgl, enc, model):
    """The north-star frontier warmed for WARM_LEVELS beam levels at
    SHARD_F_TOTAL, laid on SHARD_D shards; one sharded level in each mode,
    every stage kernel against plain bit for bit, the route, the
    exchange, the sharded prune and the sharded finalize timed (the route
    and the prune beside their parent designs, the yardsticks); the
    device launches of a level and of a chunk start (the sharded chunk
    start on the same frontier is ``chunk_start``'s ``sharded_D8``). The
    level runs as a beam (lossy) so that the gather runs. Returns ({mode:
    {kernel: summary}, "device_launches": counts}, {kernel:
    max_abs_err})."""
    import torch

    single = wgl.stack_plans([wgl.plan_device(enc, device="cpu")], "cuda")
    fr1, _ws, (lvl,) = warm_frontier(single, SHARD_F_TOTAL, lv, wgl, model)
    fr = shard_frontier(fr1, SHARD_D)
    out, errs = {}, {}
    for mode in lv.EXCHANGES:
        plan, g, tabs = sharded_setup(lv, wgl, enc, SHARD_F_TOTAL, SHARD_D, mode, model)
        ctl = sharded_ctl(lv, g, plan, fr, lvl, lossy=True)
        timed = {}

        def on_stage(name, ak, ap):
            if name not in SHARD_TIMED_CTL:
                return
            fk, ik = _sharded_call(lv, name, ak, plain=False)
            fp, ip = _sharded_call(lv, name, ap, plain=True)
            ms, call_ms = batch_ms(fk, ik)
            plain_ms, _ = batch_ms(fp, ip, hold=False, batch=3, batches=3)
            parent = _parent_call(lv, name, ak)
            perr, parent_ms = 0, None
            if parent is not None:  # the parent's outputs against the plain version's
                yi, pi = tuple(t.clone() for t in parent[1]), tuple(t.clone() for t in ip)
                parent[0](yi)
                fp(pi)
                torch.cuda.synchronize()
                perr = max(max_abs_err(a, b) for a, b in zip(yi, pi))
                parent_ms = batch_ms(*parent)[0]
            lib = _library_exchange(g, ak[1]) if name == "exchange" else None
            timed[stage_kernel(lv, name)] = {"ms": ms, "call_ms": call_ms,
                                             "plain_ms": plain_ms, "library_ms": lib,
                                             "parent_ms": parent_ms, "parent_err": perr,
                                             "name": name,
                                             "ctl": ap[SHARD_TIMED_CTL[name]].cpu()}
            if name == "stage1_hash" and ak[5] is not None:
                # the compaction alone, as the alltoall's stage 1 runs it
                timed[stage_kernel(lv, name)]["compaction_ms"] = batch_ms(
                    lambda t: lv.stage1_hash(ak[0], ak[1], ak[2], t[0], t[1], None, ak[6]),
                    (ak[3], ak[4]))[0]
            if name == "exchange":
                timed[stage_kernel(lv, name)]["parent_gather_ms"] = _gather_ms(lv, ak)
            if name == "prune":  # the single level's instantiation on the same rows
                alone = dataclasses.replace(g, exchange=None, D=1)
                timed[stage_kernel(lv, name)]["unsharded_ms"] = batch_ms(
                    lambda t: lv.prune(alone, ak[1], ak[2], ak[3], t[0], t[1], ak[6]), ik)[0]

        stage_errs, wp = sharded_lockstep(lv, g, tabs, model, fr, ctl, on_stage)
        for k, v in stage_errs.items():
            errs[k] = max(errs.get(k, 0), v)
        summary = {}
        for k, t in timed.items():
            summary[k] = _timed_summary(stage_errs[k], t["ms"], t["call_ms"], t["plain_ms"],
                                        sharded_bytes(lv, t["name"], g, t["ctl"]),
                                        t["library_ms"], t["parent_ms"])
            # the prune without its reduce, stage 1 without its keys, the
            # parent's exchange without them
            for extra in ("unsharded_ms", "compaction_ms", "parent_gather_ms"):
                if extra in t:
                    summary[k][extra] = t[extra]
        summary["k_hash_parent"] = received_hash_parent(
            lv, g, wp, timed[SHARD_KERNEL["route" if mode == "alltoall" else "exchange"]]["ctl"])
        out[mode] = summary
        emit({"phase": "sharded_kernels", "exchange": mode, "D": SHARD_D, "F": g.F,
              "from_level": lvl, "valid_configs": int(fr[4].sum()), "P": g.P, "L": g.L,
              "PBK": g.PBK, "NC": g.NC, "route_tile": lv.route_tile(g.P, SHARD_D, "cuda"),
              "kept": int(wp.ctl[0, lv.CTL_NSUM]), "stage_max_abs_err": stage_errs,
              "timed": summary,
              "exchange_bytes_per_level": wgl.exchange_bytes_per_level(plan, g.F, SHARD_D, mode)})
        bad = {k: v for k, v in stage_errs.items() if v}
        if summary["k_hash_parent"]["max_abs_err"]:
            bad["k_hash (parent)"] = summary["k_hash_parent"]["max_abs_err"]
        bad.update({f"{k} (parent)": t["parent_err"] for k, t in timed.items()
                    if t["parent_err"]})
        if bad:
            raise AssertionError(f"sharded stages disagree with their plain versions ({mode}): "
                                 f"{bad}")
    out["device_launches"] = sharded_device_launches(lv, wgl, enc, model)
    emit({"phase": "sharded_kernels", "device_launches": out["device_launches"]})
    return out, errs


def sharded_steady_state(lv, wgl, enc, model, mode):
    """PROFILE_LEVELS sharded beam levels from the warmed north-star
    frontier on SHARD_D shards: wall per level, then device busy per level
    under torch.profiler; the idle share is 1 - busy / wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    single = wgl.stack_plans([wgl.plan_device(enc, device="cpu")], "cuda")
    fr1, _ws, (lvl0,) = warm_frontier(single, SHARD_F_TOTAL, lv, wgl, model)
    saved = shard_frontier(fr1, SHARD_D)
    plan, g, tabs = sharded_setup(lv, wgl, enc, SHARD_F_TOTAL, SHARD_D, mode, model)
    ws = lv.BatchWorkspace(g, SHARD_D, "cuda")
    fr = tuple(t.clone() for t in saved)

    def window():
        for t, s_ in zip(fr, saved):
            t.copy_(s_)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flags = lv.run_chunk_sharded(lv.KERNELS, g, tabs, fr, ws, lvl0, lvl0 + PROFILE_LEVELS,
                                     True, plan.nD, plan.nO, model)
        torch.cuda.synchronize()
        return flags[3] - lvl0, time.perf_counter() - t0

    window()
    levels, wall = window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        p_levels, _p_wall = window()
    busy = sum((getattr(e, "self_device_time_total", 0) or 0) / 1e3
               for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and "cuda" in str(e.device_type).lower())
    ms_level = 1e3 * wall / max(levels, 1)
    busy_level = busy / max(p_levels, 1) if busy else None
    return {"steady_from_level": lvl0, "steady_levels": levels,
            "steady_ms_per_level": ms_level, "steady_device_busy_ms_per_level": busy_level,
            "steady_device_idle_share": 1 - busy_level / ms_level if busy else None}


def sharded_10k_phase(lv, wgl, model, frontier, make_mesh, encode_history,
                      random_register_history):
    """The reference bench leg's history through ``check_encoded_sharded``
    on SHARD_D shards in both modes (same verdict; same level when both
    decide), on 1 and 2 shards (same verdict and level), the first chunk
    of each mode held against the plain path, and the steady state.
    Returns the launch counts of the alltoall search and of the
    allgather's."""
    import torch

    h = random_register_history(random.Random(SHARD_10K["seed"]),
                                **{k: v for k, v in SHARD_10K.items() if k != "seed"})
    enc = encode_history(model, h)
    runs, launches = {}, {}
    legs = [(SHARD_D, m, 2) for m in lv.EXCHANGES] + [(1, "alltoall", 2), (2, "alltoall", 2)] \
        + [(SHARD_D, "alltoall", SHARD_WIDE_ESCALATIONS)]
    for D, mode, esc in legs:
        reset_counts(lv)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = frontier.check_encoded_sharded(enc, mesh=make_mesh(D), f_total=SHARD_F_TOTAL,
                                             exchange=mode, max_escalations=esc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        # the alltoall's exchange is the route's: no wgl_exchange launch
        own, other = ("wgl_route", "wgl_exchange")[::1 if mode == "alltoall" else -1]
        counts = launch_counts(lv, f"sharded_10k D={D} {mode}", LEVEL_KERNELS + (own,))
        if counts[other]:
            raise AssertionError(f"sharded_10k D={D} {mode} launched {other}")
        enqueued = counts["wgl_expand"]
        run = {"D": D, "exchange": mode, "max_escalations": esc, "valid": res["valid"],
               "levels": res.get("levels"),
               "attempts": [(a["F"], a["levels"], a["calls"]) for a in res["attempts"]],
               "frontier_max": res.get("frontier_max"), "causes": res.get("causes"),
               "wall_s": wall, "levels_enqueued": enqueued,
               "ms_per_enqueued_level": 1e3 * wall / max(enqueued, 1),
               "launches": counts,
               "launches_per_level": {k: v / max(enqueued, 1) for k, v in counts.items()}}
        if D == SHARD_D and esc == 2:
            run.update(sharded_steady_state(lv, wgl, enc, model, mode))
            launches[mode] = counts
        runs[(D, mode, esc)] = run
        emit(dict(phase="sharded_10k", ops=enc.n, **run))

    def agree(x, y):
        """Same verdict, and the same level when both decide."""
        return x["valid"] == y["valid"] and (
            x["levels"] == y["levels"] or "unknown" in (x["valid"], y["valid"]))

    a, b = runs[(SHARD_D, "alltoall", 2)], runs[(SHARD_D, "allgather", 2)]
    wa = runs[(SHARD_D, "alltoall", SHARD_WIDE_ESCALATIONS)]
    modes_agree = agree(a, b)
    shards_agree = all((r["valid"], r["levels"]) == (a["valid"], a["levels"])
                       for (D, _m, _e), r in runs.items() if D != SHARD_D)
    # The first chunk of each mode against the plain path.
    chunk_same = {}
    for mode in lv.EXCHANGES:
        plan, g, tabs = sharded_setup(lv, wgl, enc, SHARD_F_TOTAL, SHARD_D, mode, model)
        fr0 = wgl.initial_frontier(SHARD_F_TOTAL, *plan.dims[:3], plan.init_state, "cuda")
        flags, frs = [], []
        for ops in (lv.KERNELS, lv.PLAIN):
            fr = tuple(x.reshape((SHARD_D, g.F) + tuple(x.shape[1:])).clone() for x in fr0[:5])
            ws = lv.BatchWorkspace(g, SHARD_D, "cuda")
            flags.append(lv.run_chunk_sharded(ops, g, tabs, fr, ws, 0, SHARD_CHUNK_LEVELS,
                                              False, plan.nD, plan.nO, model))
            frs.append(fr)
        torch.cuda.synchronize()
        err = max(max_abs_err(x, y) for x, y in zip(*frs))
        chunk_same[mode] = {"flags": flags[0], "same_flags": flags[0] == flags[1],
                            "frontier_max_abs_err": err}
    emit({"phase": "sharded_10k", "modes_agree": modes_agree, "shards_agree": shards_agree,
          "decided": a["valid"] != "unknown", "decided_wide": wa["valid"] != "unknown",
          "first_chunk_vs_plain": chunk_same})
    if False in (a["valid"], wa["valid"]) or not (modes_agree and shards_agree) or not all(
            c["same_flags"] and c["frontier_max_abs_err"] == 0 for c in chunk_same.values()):
        raise AssertionError("sharded_10k failed")
    return launches


def sharded_refutation_phase(lv, wgl, model, frontier, make_mesh, encode_history,
                             random_register_history, perturb_history):
    """A perturbed history of the sharded_10k shape (the read broken in its
    first SHARD_REFUTE_WITHIN): refuted on the shards with the single
    search's max_linearized, and the witness of the plain sharded path."""
    import torch

    h = random_register_history(random.Random(SHARD_10K["seed"]),
                                **{k: v for k, v in SHARD_10K.items() if k != "seed"})
    bad = perturb_history(random.Random(SHARD_REFUTE_SEED), h, within=SHARD_REFUTE_WITHIN)
    enc = encode_history(model, bad)
    single = wgl.check_encoded_device(enc)
    out = {}
    reset_counts(lv)
    for mode in lv.EXCHANGES:
        k = frontier.check_encoded_sharded(enc, mesh=make_mesh(SHARD_D), f_total=SHARD_F_TOTAL,
                                           exchange=mode)
        p = frontier.check_encoded_sharded(enc, mesh=make_mesh(SHARD_D), f_total=SHARD_F_TOTAL,
                                           exchange=mode, plain=True)
        out[mode] = {"valid": k["valid"], "levels": k.get("levels"),
                     "max_linearized": k.get("max_linearized"),
                     "same_as_plain": all(k.get(x) == p.get(x) for x in
                                          ("valid", "levels", "max_linearized",
                                           "stuck_configs", "frontier_max")),
                     "stuck_configs": len(k.get("stuck_configs") or [])}
    torch.cuda.synchronize()
    counts = dict(lv.LAUNCHES)
    emit({"phase": "sharded_refutation", "single_valid": single["valid"],
          "single_max_linearized": single.get("max_linearized"), "runs": out,
          "launches": counts})
    if not (single["valid"] is False and all(
            r["valid"] is False and r["max_linearized"] == single["max_linearized"]
            and r["same_as_plain"] and r["stuck_configs"] for r in out.values())):
        raise AssertionError("sharded_refutation failed")
    return counts


def checker_sharded_phase(lv, model, jchecker, make_mesh, random_register_history,
                          perturb_history):
    """``checker.linearizable`` with the sharded backend through the test
    map's mesh, on the refutation phase's 300-op history and its valid
    original, in agreement with the device backend."""
    rng = random.Random(REFUTE["seed"])
    good = random_register_history(rng, **{k: v for k, v in REFUTE.items() if k != "seed"})
    bad = perturb_history(rng, good)
    lin = jchecker.linearizable(model=model)
    device = [lin.check({}, h, {}) for h in (good, bad)]
    reset_counts(lv)
    rows = []
    for h, d in zip((good, bad), device):
        r = lin.check({"checker_backend": "sharded", "mesh": make_mesh(SHARD_D)}, h, {})
        rows.append({"valid": r["valid"], "device_valid": d["valid"], "sharded": r.get("sharded"),
                     "n_shards": r.get("n_shards"), "exchange": r.get("exchange"),
                     "levels": r.get("levels"), "device_levels": d.get("levels")})
    counts = launch_counts(lv, "checker_sharded", ("wgl_route", "wgl_prune", "wgl_chunk_init"))
    if counts["wgl_exchange"]:
        raise AssertionError("checker_sharded (alltoall) launched wgl_exchange")
    emit({"phase": "checker_sharded", "runs": rows, "launches": counts})
    if not all(r["sharded"] is True and r["n_shards"] == SHARD_D and r["valid"] == r["device_valid"]
               for r in rows) or rows[0]["valid"] is not True or rows[1]["valid"] is not False:
        raise AssertionError("checker_sharded failed")
    return counts


def elle_phases():
    """The Elle slice on the card; returns (the kernels' summary at the
    8k history's shape, their launches on that path, max_abs_err over
    every shape, and for :func:`elle_sharded_phases` the 8k history's
    bucketed and plain closures and result and the 20k history's host
    result)."""
    import os

    import numpy as np
    import torch

    import jepsen_tpu_torch.elle as P
    from jepsen_tpu_torch.elle import append as ea
    from jepsen_tpu_torch.elle import ops as eo
    from jepsen_tpu_torch.elle import wr as ew
    from jepsen_tpu_torch.testing import lagged_append_history, lagged_wr_history

    for var in ("JEPSEN_ELLE_DEVICE", "JEPSEN_ELLE_EXCHANGE"):
        if os.environ.get(var, "").strip():
            raise AssertionError(f"{var} is set; the Elle phases need the engine's own "
                                 "choice")
    strip = lambda r: {k: v for k, v in r.items() if k != "engine"}

    # -- elle_append_8k: the main path of the slice ---------------------------
    h8 = lagged_append_history(**APPEND_8K)
    ea.check(lagged_append_history(**LAG_2K), device=True)  # first-call costs
    eo.reset_launches()
    torch.cuda.synchronize()
    with ClosureRecorder(eo) as rec:
        t = time.perf_counter()
        rep = {}
        res = ea.check(h8, device=None, additional_graphs=("process",), report=rep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = elle_launches(eo, "elle_append_8k")
    call = rec.calls[0]
    with ClosureRecorder(eo, plain=True) as prec:
        t = time.perf_counter()
        prep = {}
        pres = ea.check(h8, device=None, additional_graphs=("process",), report=prep)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t
    pcall = prec.calls[0]
    same_closures = all(max_abs_err(a, b) == 0 for a, b in zip(call["out"], pcall["out"]))
    emit({"phase": "elle_append_8k", "txns": res["txn_count"], "valid": res["valid"],
          "anomaly_types": res["anomaly_types"], "engine": rep, "wall_s": wall,
          "plain_wall_s": plain_wall, "dispatches": len(rec.calls), "pad": call["pad"],
          "members": int(call["S"].shape[0]), "epad": int(call["S"].shape[1]),
          "launches": launches, "same_result_as_plain": res == pres,
          "same_closures_as_plain": same_closures})
    if not (rep == {"engine": "device", "chunks": 1} and len(rec.calls) == 1
            and call["pad"] == 8192 and call["S"].shape[0] == 6 and res == pres
            and same_closures and res["valid"] is False and prep == rep):
        raise AssertionError("elle_append_8k failed")
    packed_rows = lambda c: list(c["out"][0].cpu().numpy().view(np.uint32))  # noqa: E731
    ctx = {"h8_bucketed": packed_rows(call), "h8_plain": packed_rows(pcall), "h8_result": res}

    # -- elle_kernels: each kernel against its plain version ------------------
    shapes = {}
    for pad in ELLE_KERNEL_PADS:
        if pad == 8192:
            S, D = call["S"][:3], call["D"][:3]
        else:
            S, D, got_pad = elle_history_masks(ea, eo, lagged_append_history(
                13, pad - pad // 16, (0, pad), 16), 3)
            assert got_pad == pad
        shapes[f"history_nb3_pad{pad}"] = elle_kernel_check(eo, S, D, pad,
                                                            f"history_nb3_pad{pad}")
    S, D, pad = random_masks(eo, ELLE_RANDOM_PAD, 3, seed=21)
    shapes["random_nb3_pad256"] = elle_kernel_check(eo, S, D, pad, "random_nb3_pad256")
    main = elle_kernel_check(eo, call["S"], call["D"], call["pad"], "elle_append_8k_nb6_pad8192")
    errs = {k: max(v[k]["max_abs_err"] for v in list(shapes.values()) + [main])
            for k in main}
    del rec, prec, call, pcall
    torch.cuda.empty_cache()

    # -- elle_append_20k: the bucket ceiling, SccReach on the kernels ---------
    h20 = lagged_append_history(**APPEND_20K)
    eo.reset_launches()
    with ClosureRecorder(eo) as rec:
        t = time.perf_counter()
        rep = {}
        res = ea.check(h20, report=rep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = dict(eo.LAUNCHES)
    codes = sorted({c["code"] for c in rep.get("causes", [])})
    emit({"phase": "elle_append_20k", "txns": res["txn_count"], "valid": res["valid"],
          "anomaly_types": res["anomaly_types"], "engine": rep.get("engine"),
          "cause_codes": codes, "causes": len(rep.get("causes", [])),
          "scc_reach_components": rec.components, "wall_s": wall, "launches": counts})
    if not (rep.get("engine") == "host" and codes == ["elle_bucket_ceiling"]
            and any(512 <= n <= 8192 for n in rec.components)
            and all(counts[k] > 0 for k in ELLE_REPLACES) and res["valid"] is False):
        raise AssertionError("elle_append_20k failed")
    ctx["h20_host"] = res

    # -- elle_lag_2k: the device engine against the host path -----------------
    h2 = lagged_append_history(**LAG_2K)
    with ClosureRecorder(eo) as rec:
        t = time.perf_counter()
        rep = {}
        res = ea.check(h2, device=True, report=rep)
        wall = time.perf_counter() - t
    t = time.perf_counter()
    host = ea.check(h2, device=False)
    host_wall = time.perf_counter() - t
    emit({"phase": "elle_lag_2k", "valid": res["valid"], "anomaly_types": res["anomaly_types"],
          "engine": rep, "pad": rec.calls[0]["pad"] if rec.calls else None, "wall_s": wall,
          "host_wall_s": host_wall, "same_as_host": strip(res) == host})
    if not (rep == {"engine": "device", "chunks": 1} and rec.calls[0]["pad"] == 2048
            and strip(res) == host):
        raise AssertionError("elle_lag_2k failed")

    # -- big_scc_4096 and elle_scc_batched: bench.py's graphs -----------------
    big, graphs = bench_graphs(P)
    with ClosureRecorder(eo) as rec:
        t = time.perf_counter()
        rep = {}
        got = P.cycle_anomalies(big, device=True, report=rep)
        wall = time.perf_counter() - t
    t = time.perf_counter()
    host = P.cycle_anomalies(big, device=False)
    host_wall = time.perf_counter() - t
    emit({"phase": "big_scc_4096", "anomalies": sorted(got), "engine": rep,
          "members": [int(c["S"].shape[0]) for c in rec.calls], "wall_s": wall,
          "host_wall_s": host_wall, "same_as_host": got == host})
    if not (rep == {"engine": "device", "chunks": 1}
            and [int(c["S"].shape[0]) for c in rec.calls] == [3] and got == host):
        raise AssertionError("big_scc_4096 failed")
    P.cycle_anomalies_batch(graphs, device=True)  # first-call costs at these buckets
    with ClosureRecorder(eo) as rec:
        t = time.perf_counter()
        rep = {}
        got = P.cycle_anomalies_batch(graphs, device=True, report=rep)
        wall = time.perf_counter() - t
    t = time.perf_counter()
    serial = [P.cycle_anomalies(g, device=True) for g in graphs]
    serial_wall = time.perf_counter() - t
    t = time.perf_counter()
    host = [P.cycle_anomalies(g, device=False) for g in graphs]
    host_wall = time.perf_counter() - t
    buckets = sorted({eo.bucket_for(g.n) for g in graphs})
    emit({"phase": "elle_scc_batched", "graphs": len(graphs), "txns": sum(g.n for g in graphs),
          "buckets": buckets, "chunks": rep.get("chunks"), "causes": rep.get("causes"),
          "members": [int(c["S"].shape[0]) for c in rec.calls], "wall_s": wall,
          "serial_device_wall_s": serial_wall, "serial_host_wall_s": host_wall,
          "invalid_graphs": sum(1 for a in got if a), "same_as_host": got == host,
          "same_as_serial": got == serial})
    if not (not rep.get("causes") and rep.get("chunks", 99) <= len(buckets)
            and got == host == serial):
        raise AssertionError("elle_scc_batched failed")

    # -- elle_wr_4k: a rw-register history at bucket 4096 ---------------------
    hw = lagged_wr_history(**WR_4K)
    with ClosureRecorder(eo) as rec:
        t = time.perf_counter()
        rep = {}
        res = ew.check(hw, wfr_keys=True, report=rep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    with ClosureRecorder(eo, plain=True):
        pres = ew.check(hw, wfr_keys=True, report={})
    emit({"phase": "elle_wr_4k", "txns": res["txn_count"], "valid": res["valid"],
          "anomaly_types": res["anomaly_types"], "engine": rep,
          "pad": rec.calls[0]["pad"] if rec.calls else None,
          "members": int(rec.calls[0]["S"].shape[0]) if rec.calls else 0, "wall_s": wall,
          "same_as_plain": res == pres})
    if not (rep.get("engine") == "device" and rec.calls and rec.calls[0]["pad"] == 4096
            and res == pres):
        raise AssertionError("elle_wr_4k failed")
    return main, launches, errs, ctx


def batch_mesh_phase(lv, model, check_batch, make_mesh, replay, rk):
    """batch_replay_100's histories through ``check_batch`` on a mesh of 8
    shards and on one of 3 (4 and 2 padding copies), each member's result
    equal to the no-mesh run ``rk`` except the fields the reference's mesh
    changes: the rungs' calls (its chunk length of ceil(Bk/dp) members)
    and members (it counts the copies that pad an escalated rung, rows of
    a real member), and the wall times. Returns each mesh's launch
    counts."""
    import torch

    changed = ("rungs[].calls", "rungs[].members", "rungs[].wall_s", "wall_s",
               "attempts[].wall_s")

    def fixed(r):
        out = {k: v for k, v in r.items() if k != "wall_s"}
        for key, drop in (("rungs", ("calls", "members", "wall_s")),
                          ("attempts", ("wall_s",))):
            if out.get(key):
                out[key] = [{k: v for k, v in x.items() if k not in drop} for x in out[key]]
        return out

    launches = {}
    for D, shape in ((8, None), (3, (3, 1))):
        reset_counts(lv)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = check_batch(model, replay, f=REPLAY["f"], mesh=make_mesh(D, shape=shape))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts(lv, f"batch_mesh D={D}", LEVEL_KERNELS)
        launches[f"D{D}"] = counts
        same = len(got) == len(rk) and all(fixed(a) == fixed(b) for a, b in zip(got, rk))
        emit({"phase": "batch_mesh", "D": D, "members": len(replay),
              "padding_copies": -len(replay) % D, "wall_s": wall,
              "valid": sum(r["valid"] is True for r in got),
              "invalid": sum(r["valid"] is False for r in got),
              "unknown": sum(r["valid"] == "unknown" for r in got),
              "rungs": next((r["rungs"] for r in got if r.get("rungs")), None),
              "same_as_no_mesh": same, "fields_the_mesh_changes": changed,
              "launches": counts})
        if not same:
            raise AssertionError(f"batch_mesh D={D} differs from the batch without a mesh")
    return launches


class ShardedRecorder:
    """Records every ``elle.ops.sharded_closure`` call of the engine (its
    edges, ``n``, mesh size, exchange, packed result and wall) while in a
    ``with`` block."""

    def __init__(self, eo):
        self.eo = eo
        self.calls = []

    def __enter__(self):
        self._sc = self.eo.sharded_closure

        def sharded_closure(srcs, dsts, n, mesh, exchange=None):
            t = time.perf_counter()
            out = self._sc(srcs, dsts, n, mesh, exchange)
            self.calls.append({"srcs": srcs, "dsts": dsts, "n": n, "exchange": exchange,
                               "D": mesh.shape[mesh.axis_names[0]], "out": out,
                               "wall_s": time.perf_counter() - t})
            return out

        self.eo.sharded_closure = sharded_closure
        return self

    def __exit__(self, *exc):
        self.eo.sharded_closure = self._sc


def sharded_launches(eo, where, mode):
    """The sharded closure kernels' launch counts since the last reset;
    every kernel of ``mode``'s path must have run."""
    counts = {k: eo.LAUNCHES[k] for k in ELLE_SHARD_REPLACES}
    idle = [k for k in ELLE_SHARD_KERNELS[mode] if counts[k] == 0]
    if idle:
        raise AssertionError(f"sharded closure kernels never launched in {where}: {idle}")
    return counts


def elle_sharded_kernel_check(eo, srcs, dsts, n, D, label):
    """Each sharded-closure kernel against its plain version on the same
    inputs, bit for bit, at the first step of one mask in both modes, with
    device times; below pad 32768 also the whole closure in both modes
    against the plain chain. Returns {kernel: {max_abs_err, ms, plain_ms,
    call_ms, bound_ms, bound_by, library_ms}}."""
    import numpy as np
    import torch

    pad = eo.sharded_pad(n, D)
    words = torch.from_numpy(eo.edge_words(srcs, dsts, pad).view(np.int32)).cuda()
    huge = pad >= 32768
    reps = dict(batch=2, batches=3) if huge else {}
    plain_reps = dict(batch=1, batches=1) if huge else (
        dict(batch=2, batches=3) if pad >= 8192 else dict(batch=5, batches=3))
    out = {}

    def record(name, err, ms, plain_ms, call_ms, nbytes, ops=0, library_ms=None):
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
                     **bound_fields(ms, nbytes, ops, library_ms)}

    def err_of(k, p):
        return int((k.float() - p.float()).abs().max())

    # unpack: the entry (and each packed step's gathered words)
    b = eo.unpack(words, pad)
    bp = eo.unpack_plain(words, pad)
    torch.cuda.synchronize()
    err = err_of(b, bp)
    del bp
    spare = torch.empty_like(b)
    ms, call_ms = batch_ms(lambda t: eo.unpack(t[0], pad, spare), (words,), clone=False, **reps)
    plain_ms, _ = batch_ms(lambda t: eo.unpack_plain(t[0], pad), (words,), hold=False,
                           clone=False, **plain_reps)
    record("elle_unpack", err, ms, plain_ms, call_ms, words.numel() * 4 + pad * pad * 2)
    # pack_rows: the packed gather (and the output)
    pk = eo.pack_rows(b)
    ppk = eo.pack_rows_plain(b.float())
    torch.cuda.synchronize()
    err = max_abs_err(pk, ppk)
    del ppk
    wbuf = torch.empty_like(words)
    ms, call_ms = batch_ms(lambda t: eo.pack_rows(t[0], wbuf), (b,), clone=False, **reps)
    plain_ms, _ = batch_ms(lambda t: eo.pack_rows_plain(t[0].float()), (b,), hold=False,
                           clone=False, **plain_reps)
    record("elle_pack_rows", err, ms, plain_ms, call_ms, pad * pad * 2 + words.numel() * 4)
    # gather: the dense exchange; its library call is one copy of the blocks
    g = eo.gather(b, D, spare)
    gp = eo.gather_plain(b, D)
    torch.cuda.synchronize()
    err = err_of(g, gp)
    del gp
    ms, call_ms = batch_ms(lambda t: eo.gather(t[0], D, spare), (b,), clone=False, **reps)
    plain_ms, _ = batch_ms(lambda t: eo.gather_plain(t[0], D), (b,), hold=False, clone=False,
                           **plain_reps)
    library_ms, _ = batch_ms(lambda t: t[0].clone(), (b,), clone=False, **reps)
    record("elle_gather", err, ms, plain_ms, call_ms, 2 * pad * pad * 2, library_ms=library_ms)
    # block_square: one step against the packed gather's full matrix
    full = eo.unpack(pk, pad)
    sq = eo.block_square(b, full, spare)
    sqp = eo.block_square_plain(b.float(), full.float())
    torch.cuda.synchronize()
    err = err_of(sq, sqp)
    reach_bits = int(sqp.sum())
    del sqp
    ms, call_ms = batch_ms(lambda t: eo.block_square(t[0], t[1], spare), (b, full),
                           clone=False, **reps)
    plain_ms, _ = batch_ms(lambda t: eo.block_square_plain(t[0].float(), t[1].float()),
                           (b, full), hold=False, clone=False, **plain_reps)
    library_ms, _ = batch_ms(lambda t: torch.matmul(t[0], t[1]), (b, full), clone=False,
                             **reps)
    record("elle_block_square", err, ms, plain_ms, call_ms, 3 * pad * pad * 2,
           ops=2 * pad ** 3, library_ms=library_ms)
    del b, full, sq, spare, wbuf, pk, g
    torch.cuda.empty_cache()
    whole = {}
    if not huge:  # the whole closure in both modes against the plain chain
        for mode in eo.EXCHANGES:
            got = eo.sharded_closure_words(words, D, mode)
            want = eo.sharded_closure_words(words, D, mode, plain=True)
            whole[mode] = max_abs_err(got, want)
    emit({"phase": "elle_sharded_kernels", "shape": label, "n": n, "pad": pad, "D": D,
          "P": pad // D, "edges": len(srcs), "steps": eo.closure_steps(pad),
          "first_step_reach_bits": reach_bits, "closure_max_abs_err": whole,
          "exchange_bytes_per_step": {m: eo.shard_exchange_bytes_per_step(n, D, m)
                                      for m in eo.EXCHANGES},
          "library_note": "no single PyTorch call computes elle_unpack or elle_pack_rows",
          "kernels": out})
    for k, v in out.items():
        if v["max_abs_err"] != 0 or any(whole.values()):
            raise AssertionError(f"{k} disagrees with its plain version at {label}")
    return out


def elle_square_sweep():
    """The square kernel at every bucket pad (nb = SWEEP_NB random masks, 2
    entries a row), on an all-ones member at 8192 and on an all-ones
    [32768, 32768] elle_block_square step (every count is 32768): each bit
    for bit against its plain version, with its ms beside bf16
    ``torch.matmul``'s on the same inputs. Returns {label: row}."""
    import torch

    from jepsen_tpu_torch.elle import ops as eo

    gen = torch.Generator(device="cuda").manual_seed(41)
    rows = {}

    def measure(label, kernel, plain, library, inputs, ops, nbytes, reps):
        got = kernel(*inputs)
        want = plain(*(t.float() for t in inputs))
        torch.cuda.synchronize()
        err = int((got.float() - want).abs().max())
        ones = int(want.sum())
        del got, want
        ms, call_ms = batch_ms(lambda t: kernel(*t), inputs, clone=False, **reps)
        library_ms, _ = batch_ms(lambda t: library(*t), inputs, clone=False, **reps)
        rows[label] = {"max_abs_err": err, "result_ones": ones, "ms": ms, "call_ms": call_ms,
                       **bound_fields(ms, nbytes, ops, library_ms)}
        torch.cuda.empty_cache()

    for pad in eo.BUCKETS:
        nb = SWEEP_NB
        a = (torch.rand((nb, pad, pad), generator=gen, device="cuda") < 2.0 / pad).to(
            torch.bfloat16)
        spare = torch.empty_like(a)
        measure(f"square_pad{pad}_nb{nb}", lambda x: eo.square(x, spare), eo.square_plain,
                lambda x: torch.matmul(x, x), (a,), 2 * pad ** 3 * nb, 2 * nb * pad * pad * 2,
                {})
    ones = torch.ones((1, 8192, 8192), dtype=torch.bfloat16, device="cuda")
    spare = torch.empty_like(ones)
    measure("square_all_ones_pad8192_nb1", lambda x: eo.square(x, spare), eo.square_plain,
            lambda x: torch.matmul(x, x), (ones,), 2 * 8192 ** 3, 2 * 8192 * 8192 * 2, {})
    del ones, spare
    pad = ELLE_SHARD_20K_PAD
    ones = torch.ones((pad, pad), dtype=torch.bfloat16, device="cuda")
    spare = torch.empty_like(ones)
    measure(f"block_square_all_ones_pad{pad}", lambda x, y: eo.block_square(x, y, spare),
            eo.block_square_plain, torch.matmul, (ones, ones), 2 * pad ** 3,
            3 * pad * pad * 2, dict(batch=2, batches=3))
    del ones, spare
    torch.cuda.empty_cache()
    emit({"phase": "elle_square_sweep", "random_density": "2 / pad", "rows": rows})
    bad = [k for k, r in rows.items() if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"the square kernel disagrees with its plain version: {bad}")
    return rows


def elle_sharded_phases(ctx):
    """The mesh-sharded closure on the card: elle_sharded_8k,
    elle_sharded_20k (its main path, both modes) and elle_sharded_kernels.
    ``ctx`` carries the bucketed and plain closures of the 8k history and
    the host result of the 20k one from :func:`elle_phases`. Returns (the
    kernels' summary at pad 32768 and at every pad, their launches per
    path, max_abs_err over every shape)."""
    import os

    import numpy as np
    import torch

    from jepsen_tpu_torch.elle import append as ea
    from jepsen_tpu_torch.elle import ops as eo
    from jepsen_tpu_torch.parallel import make_mesh
    from jepsen_tpu_torch.testing import lagged_append_history

    strip = lambda r: {k: v for k, v in r.items() if k != "engine"}  # noqa: E731

    def with_exchange(mode, fn):
        """Run ``fn`` under the exchange kill-switch, as a user selects the
        dense mode through the unchanged entry points."""
        os.environ["JEPSEN_ELLE_EXCHANGE"] = mode
        try:
            return fn()
        finally:
            del os.environ["JEPSEN_ELLE_EXCHANGE"]

    paths = {}
    # -- elle_sharded_8k: the 8k history's six masks on 1, 2 and 8 shards ------
    h8 = lagged_append_history(**APPEND_8K)
    bucketed, plain = ctx["h8_bucketed"], ctx["h8_plain"]
    first_8k = None
    for D, mode in ELLE_SHARD_8K_MESHES:
        eo.reset_launches()
        torch.cuda.synchronize()
        with ShardedRecorder(eo) as rec:
            t = time.perf_counter()
            rep = {}
            res = with_exchange(mode, lambda: ea.check(
                h8, additional_graphs=("process",), mesh=make_mesh(D), report=rep))
            wall = time.perf_counter() - t
        counts = sharded_launches(eo, f"elle_sharded_8k D={D} {mode}", mode)
        paths[f"elle_sharded_8k_D{D}_{mode}"] = counts
        pads = [c["out"].shape[0] for c in rec.calls]
        same_bucketed = len(rec.calls) == len(bucketed) and all(
            np.array_equal(c["out"], x) for c, x in zip(rec.calls, bucketed))
        same_plain = len(rec.calls) == len(plain) and all(
            np.array_equal(c["out"], x) for c, x in zip(rec.calls, plain))
        ok = (rep == {"engine": "device", "chunks": len(bucketed)}
              and set(pads) == {bucketed[0].shape[0]}
              and strip(res) == strip(ctx["h8_result"]) and same_bucketed and same_plain
              and all(c["exchange"] == mode for c in rec.calls))
        emit({"phase": "elle_sharded_8k", "D": D, "exchange": mode, "valid": res["valid"],
              "engine": rep, "masks": len(rec.calls), "pads": pads, "wall_s": wall,
              "closure_wall_s": [c["wall_s"] for c in rec.calls], "launches": counts,
              "same_result_as_bucketed": strip(res) == strip(ctx["h8_result"]),
              "same_closures_as_bucketed": same_bucketed,
              "same_closures_as_plain": same_plain})
        if not ok:
            raise AssertionError(f"elle_sharded_8k D={D} {mode} failed")
        if first_8k is None:
            first_8k = rec.calls[0]
    del rec

    # -- elle_sharded_20k: above the bucket ceiling, on the device ------------
    h20 = lagged_append_history(**APPEND_20K)
    outs, walls, launches = {}, {}, {}
    first_20k = None
    for mode in eo.EXCHANGES:
        eo.reset_launches()
        torch.cuda.synchronize()
        with ShardedRecorder(eo) as rec:
            t = time.perf_counter()
            rep = {}
            res = with_exchange(mode, lambda: ea.check(h20, mesh=make_mesh(ELLE_SHARD_D),
                                                       report=rep))
            wall = time.perf_counter() - t
        launches[mode] = sharded_launches(eo, f"elle_sharded_20k {mode}", mode)
        pads = [c["out"].shape[0] for c in rec.calls]
        steps = sum(eo.closure_steps(p) for p in pads)
        closure_wall = sum(c["wall_s"] for c in rec.calls)
        outs[mode] = [c["out"] for c in rec.calls]
        walls[mode] = wall
        same_host = strip(res) == strip(ctx["h20_host"])
        emit({"phase": "elle_sharded_20k", "exchange": mode, "txns": res["txn_count"],
              "valid": res["valid"], "anomaly_types": res["anomaly_types"], "engine": rep,
              "masks": len(rec.calls), "n": [c["n"] for c in rec.calls], "pads": pads,
              "edges": [len(c["srcs"]) for c in rec.calls], "D": ELLE_SHARD_D,
              "wall_s": wall, "closure_wall_s": closure_wall, "closure_steps": steps,
              "ms_per_step": 1e3 * closure_wall / max(steps, 1),
              "launches": launches[mode], "same_result_as_host": same_host})
        if not (rep.get("engine") == "device" and not rep.get("causes")
                and rep.get("chunks") == len(rec.calls) > 0 and res["valid"] is False
                and same_host and set(pads) == {ELLE_SHARD_20K_PAD}):
            raise AssertionError(f"elle_sharded_20k {mode} failed")
        if first_20k is None:
            first_20k = dict(rec.calls[0], out=None)
        del rec
    same_modes = len(outs["packed"]) == len(outs["dense"]) and all(
        np.array_equal(a, b) for a, b in zip(outs["packed"], outs["dense"]))
    emit({"phase": "elle_sharded_20k", "modes_agree": same_modes, "wall_s": walls})
    if not same_modes:
        raise AssertionError("elle_sharded_20k: the two exchange modes' closures differ")
    del outs
    paths.update({f"elle_sharded_20k_{m}": c for m, c in launches.items()})

    # -- elle_sharded_kernels: each kernel against its plain version -----------
    rng = np.random.default_rng(31)
    n = ELLE_SHARD_RANDOM_PAD - 9
    shapes = {
        f"random_pad{ELLE_SHARD_RANDOM_PAD}": (rng.integers(0, n, 3 * n).tolist(),
                                              rng.integers(0, n, 3 * n).tolist(), n),
        "elle_append_8k_mask0_pad8192": (first_8k["srcs"], first_8k["dsts"], first_8k["n"]),
        "elle_append_20k_mask0_pad32768": (first_20k["srcs"], first_20k["dsts"],
                                           first_20k["n"]),
    }
    results = {label: elle_sharded_kernel_check(eo, s_, d_, n_, ELLE_SHARD_D, label)
               for label, (s_, d_, n_) in shapes.items()}
    main = results["elle_append_20k_mask0_pad32768"]
    errs = {k: max(r[k]["max_abs_err"] for r in results.values()) for k in main}
    torch.cuda.empty_cache()
    return main, results, paths, errs


def host_cpu() -> str:
    """The host CPU's model name from ``/proc/cpuinfo``; where the machine
    reports none, its vendor, family and model numbers."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
                if not line.strip():
                    break
    except OSError:
        return "not read"
    name = fields.get("model name", "unknown")
    if name and name != "unknown":
        return name
    return (f"{fields.get('vendor_id', 'unknown')} family {fields.get('cpu family', '?')} "
            f"model {fields.get('model', '?')} (no model name reported)")


def host_line() -> dict:
    import os

    return {"host_cpu": host_cpu(), "cpu_count": os.cpu_count()}


def min_median(xs) -> dict:
    return {"min_s": min(xs), "median_s": statistics.median(xs), "n": len(xs),
            "runs_s": list(xs)}


class GcClock:
    """Seconds spent in Python's cyclic garbage collector inside the block."""

    def __enter__(self):
        import gc

        self.s, self._t = 0.0, None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.s += time.perf_counter() - self._t
            self._t = None

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._note)


def timed_engine_runs(wgl, model, h, backend) -> dict:
    """ENGINE_TURNS runs of check_history(backend=...) on the host engines:
    wall min/median, and for each run the C call's own wall (``wall_s`` of
    the result) and the seconds in the garbage collector, which together
    say where a slow run's time went."""
    walls, c_walls, gcs, res = [], [], [], None
    for _ in range(ENGINE_TURNS):
        with GcClock() as gc_clock:
            t = time.perf_counter()
            res = wgl.check_history(model, h, backend=backend)
            walls.append(time.perf_counter() - t)
        c_walls.append(res.get("wall_s"))
        gcs.append(gc_clock.s)
    return dict(min_median(walls), c_wall_s=c_walls, gc_s=gcs, valid=res["valid"],
                backend=res.get("backend"), configs_explored=res.get("configs_explored"),
                frontier_max=res.get("frontier_max"),
                max_linearized=res.get("max_linearized"),
                stuck_configs=len(res.get("stuck_configs") or []), result=res)


def profiled_busy_ms(prof) -> float:
    """Device busy ms in a ``torch.profiler`` trace, summed from the raw
    Kineto events with the filters ``events()`` applies (its FunctionEvent
    list, which ``key_averages`` needs too, takes 8-10 s to build for a
    north-star search's tens of thousands of kernels)."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name

    total = 0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_async() or _filter_name(e.name())
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        total += e.end_ns() - e.start_ns()
    return total / 1e6


class FirstChunk:
    """While installed, records the first chunk a single device search runs
    (its ``_Search`` and capacity), so that its level program can be
    captured afterwards: :meth:`level_work` counts the device work of one
    level of that program, on the search's own plan, tables and model, at
    that capacity, from a stream capture on a fresh workspace."""

    def __init__(self, wgl):
        self.wgl = wgl
        self.seen = None

    def __enter__(self):
        self.orig = orig = self.wgl._Search.chunk

        def chunk(search, fr, F, *a, **kw):
            if self.seen is None:
                self.seen = (search, F)
            return orig(search, fr, F, *a, **kw)

        self.wgl._Search.chunk = chunk
        return self

    def __exit__(self, *exc):
        self.wgl._Search.chunk = self.orig

    def level_work(self, lv) -> dict:
        from jepsen_tpu_torch.testing import device_work

        search, F = self.seen
        plan, wgl = search.plan, self.wgl
        g = wgl.level_geometry(plan, F)
        fr = tuple(a[None] for a in wgl.initial_frontier(F, g.W, g.KO, g.S, plan.init_state,
                                                         plan.device)[:5])
        tabs = {k: t[None] for k, t in plan.tabs.items()}
        ws = lv.BatchWorkspace(g, 1, plan.device)
        lv._LevelProgram(g, tabs, fr, ws, search.model)()
        # packed inside the capture, so that the launches go to its stream
        return dict(device_work(lambda: lv._LevelProgram(g, tabs, fr, ws, search.model)()),
                    F=F, two_stage=g.two_stage)


def native_phase(wgl, model, hist, twin):
    """The native C search built from the port's copy and the north star
    and its perturbed twin through check_history(backend="native"), timed
    (ENGINE_TURNS runs each); the twin's verdict held against the device
    search's wherever that is definite. Returns (the twin's native result,
    the twin's device result, the device search's wall on the twin)."""
    import torch

    from jepsen_tpu_torch import native

    t = time.perf_counter()
    lib = native.load()
    build_s = time.perf_counter() - t
    if lib is None:
        raise AssertionError("native: no C compiler on the PATH; load() gave None")
    rows = {label: timed_engine_runs(wgl, model, h, "native")
            for label, h in (("north_star", hist), ("twin", twin))}
    north, twin_res = rows["north_star"]["result"], rows["twin"]["result"]
    t = time.perf_counter()
    twin_dev = wgl.check_history(model, twin, backend="device")
    torch.cuda.synchronize()
    twin_dev_wall = time.perf_counter() - t
    agree = twin_dev["valid"] == "unknown" or twin_dev["valid"] == twin_res["valid"]
    emit({"phase": "native", "library": str(native.library_path()), "build_s": build_s,
          **host_line(), **{k: {x: y for x, y in v.items() if x != "result"}
                            for k, v in rows.items()},
          "twin_device": {"valid": twin_dev["valid"], "levels": twin_dev.get("levels"),
                          "wall_s": twin_dev_wall, "causes": twin_dev.get("causes")},
          "twin_agrees_with_device": agree})
    if not (north["valid"] is True and north["backend"] == "native"
            and twin_res["valid"] in (True, False) and twin_res["backend"] == "native"
            and (twin_res["valid"] is True or twin_res.get("stuck_configs")) and agree):
        raise AssertionError("native phase failed")
    return twin_res, twin_dev, twin_dev_wall


def auto_phase(lv, wgl, model, hist, hists):
    """backend="auto": the north star (ENGINE_TURNS timed runs) and
    mutex_5k's history on the C search; each family with no step in it (AUTO_FAMILIES, the 2000-op
    valid history of models_2k) on the card, with its kernels' launch
    counts, a stream capture of one level of its own level program, and
    the verdict of backend="device"; a history the device search leaves
    unknown decided by the host oracle, with device_attempt; for a family
    left unknown, the oracle held to AUTO_HOST_CONFIGS ending unknown on
    that budget (why auto has no oracle verdict there)."""
    import torch

    from jepsen_tpu_torch.ops import wgl_host
    from jepsen_tpu_torch.ops.encode import encode_history
    from jepsen_tpu_torch.testing import history_model, random_lock_history, \
        random_model_history

    out = {}
    mutex_h = random_lock_history(random.Random(MUTEX_5K["seed"]), n_ops=MUTEX_5K["n_ops"],
                                  n_procs=MUTEX_5K["n_procs"])
    for label, m, h in (("north_star", model, hist),
                        ("mutex_5k", history_model("owner-aware-mutex"), mutex_h)):
        row = timed_engine_runs(wgl, m, h, "auto")
        del row["result"]
        out[label] = row
        if not (row["valid"] is True and row["backend"] == "native"):
            raise AssertionError(f"auto: {label} was not decided by the C search: {row}")
    for name in AUTO_FAMILIES:
        good = hists[name][0]
        m = history_model(name)
        reset_counts(lv)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with FirstChunk(wgl) as first:
            r = wgl.check_history(m, good, backend="auto", host_max_configs=AUTO_HOST_CONFIGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = launch_counts(lv, f"auto {name}", LEVEL_KERNELS)
        work = first.level_work(lv)
        dev = wgl.check_history(m, good, backend="device")
        ran = r.get("device_attempt") or r
        out[name] = {"valid": r["valid"], "device_valid": dev["valid"], "wall_s": wall,
                     "device": ran.get("device"), "torch_device": ran.get("torch_device"),
                     "levels": ran.get("levels"), "oracle": "device_attempt" in r,
                     "level_device_work": work, "launches": launches}
        if not (ran.get("device") is True and ran.get("torch_device") == "cuda"
                and work["kernel"] > 0 and r["valid"] == dev["valid"]):
            raise AssertionError(f"auto {name} did not run on the card: {out[name]}")
        if r["valid"] == "unknown":
            # no oracle verdict: the oracle, asked the same, ends on its budget
            host = wgl_host.check_encoded(encode_history(m, good),
                                          max_configs=AUTO_HOST_CONFIGS)
            codes = [c.get("code") for c in host.get("causes") or []]
            out[name]["oracle_alone"] = {"valid": host["valid"], "causes": codes}
            if out[name]["oracle"] or host["valid"] != "unknown" or "max_configs" not in codes:
                raise AssertionError(f"auto {name}: the oracle's unknown is not its "
                                     f"budget's: {out[name]}")
    fb = dict(AUTO_FALLBACK)
    name = fb.pop("model")
    m = history_model(name)
    h = random_model_history(random.Random(fb.pop("seed")), name, n_ops=fb.pop("n_ops"),
                             n_procs=fb.pop("n_procs"), crash_p=fb.pop("crash_p"))
    reset_counts(lv)
    r = wgl.check_history(m, h, backend="auto", **fb)
    launches = launch_counts(lv, "auto's oracle fallback", LEVEL_KERNELS)
    att = r.get("device_attempt") or {}
    out["oracle_fallback"] = {"model": name, "valid": r["valid"],
                              "device_attempt": {k: att.get(k) for k in
                                                 ("valid", "levels", "torch_device", "causes")},
                              "launches": launches}
    if not (r["valid"] is True and "device" not in r and att.get("valid") == "unknown"
            and att.get("torch_device") == "cuda"):
        raise AssertionError(f"auto's oracle fallback failed: {out['oracle_fallback']}")
    emit({"phase": "auto", **out})
    return out


def clean_race(row) -> bool:
    """A race in which neither engine raised and the device side launched
    at least one chunk (it runs its first chunk before it can see a win)."""
    return (row["device_error"] is None and row["native_error"] is None
            and row["device_chunks"] >= 1)


def competition_phase(lv, wgl, model, hist, twin, main_res, twin_native, twin_dev_wall):
    """backend="competition" on the north star: (2) with native_max_configs=1
    the device side decides, the main path's final level and per-level rows,
    every level kernel launched; (1) at the default budgets a definite True,
    the race's wall beside the C side alone and the device search alone, in
    turns; (3) case 2 again straight after the last race; (4) the perturbed
    twin, agreeing with the native verdict. In cases 1 and 4 neither side
    may have raised (``device_error``, ``native_error``) and the device
    side must have launched at least one chunk. Then the device search
    alone and with the race's C side searching the twin on the host's
    cores beside it, in CONTENTION_TURNS pairs: walls, each pair's ratio,
    and the device's idle share in the last pair."""
    import ctypes
    import os
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from jepsen_tpu_torch.ops import wgl_c
    from jepsen_tpu_torch.ops.encode import encode_history

    enc = encode_history(model, hist)
    budget = 1_000_000 + 2_000 * enc.n
    strategy, n_thr = wgl_c.parallel_policy()

    def forced():
        reset_counts(lv)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = wgl.check_history(model, hist, backend="competition", native_max_configs=1,
                              collect_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        ok = (r.get("engine") == "device" and r["valid"] is True
              and r["levels"] == main_res["levels"]
              and r["level_stats"] == main_res["level_stats"])
        return r, {"engine": r.get("engine"), "valid": r["valid"], "levels": r.get("levels"),
                   "wall_s": wall, "same_as_main_path": ok,
                   "device_error": r.get("device_error"),
                   "native_error": r.get("native_error"),
                   "launches": launch_counts(lv, "competition with native_max_configs=1")}

    r2a, case2 = forced()
    races, natives, devices = [], [], []
    for _ in range(ENGINE_TURNS):
        t = time.perf_counter()
        nat = wgl_c.check_encoded_native(enc, max_configs=budget, strategy=strategy,
                                         n_threads=n_thr)
        natives.append(time.perf_counter() - t)
        t = time.perf_counter()
        dev = wgl.check_history(model, hist, backend="device")
        torch.cuda.synchronize()
        devices.append(time.perf_counter() - t)
        reset_counts(lv)
        torch.cuda.synchronize()
        t = time.perf_counter()
        race = wgl.check_history(model, hist, backend="competition")
        torch.cuda.synchronize()
        races.append(dict(wall_s=time.perf_counter() - t, engine=race.get("engine"),
                          valid=race["valid"],
                          device_chunks=lv.LAUNCHES["wgl_chunk_init"],
                          device_levels_enqueued=lv.LAUNCHES["wgl_expand"],
                          device_error=race.get("device_error"),
                          native_error=race.get("native_error")))
        if not (race["valid"] is True and nat["valid"] is True and dev["valid"] is True
                and clean_race(races[-1])):
            raise AssertionError(f"competition case 1 failed: {races[-1]}")
    r2b, case3 = forced()
    reset_counts(lv)
    torch.cuda.synchronize()
    t = time.perf_counter()
    tw = wgl.check_history(model, twin, backend="competition")
    torch.cuda.synchronize()
    case4 = {"valid": tw["valid"], "engine": tw.get("engine"),
             "wall_s": time.perf_counter() - t, "native_valid": twin_native["valid"],
             "native_wall_s": twin_native["wall_s"], "device_alone_wall_s": twin_dev_wall,
             "device_chunks": lv.LAUNCHES["wgl_chunk_init"],
             "device_levels_enqueued": lv.LAUNCHES["wgl_expand"],
             "device_error": tw.get("device_error"), "native_error": tw.get("native_error")}
    # The device search alone, and with the race's C side searching the
    # twin on the host beside it (the search restarts until the device
    # search ends), in turns; the last pair under the profiler, for the
    # device's idle share.
    twin_enc = encode_history(model, twin)
    load = []
    for turn in range(CONTENTION_TURNS):
        profiled = turn == CONTENTION_TURNS - 1
        for loaded in (False, True):
            stop = ctypes.c_int32(0)
            searches = [0]

            def c_side():
                while not stop.value:
                    wgl_c.check_encoded_native(twin_enc, max_configs=budget, cancel=stop,
                                               strategy=strategy, n_threads=n_thr)
                    searches[0] += 1

            th = threading.Thread(target=c_side, daemon=True) if loaded else None
            if th is not None:
                th.start()
            ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                   if profiled else contextlib.nullcontext())
            with ctx as prof:
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = wgl.check_history(model, hist, backend="device")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                stop.value = 1
                t_stop = time.perf_counter()
            if th is not None:
                th.join()
            row = {"loaded": loaded, "wall_s": wall, "c_searches": searches[0],
                   "valid": r["valid"]}
            if profiled:
                t = time.perf_counter()
                busy = profiled_busy_ms(prof)
                row.update(busy_ms=busy, idle_share=1 - busy / (1e3 * wall) if busy else None,
                           profiler_stop_s=t - t_stop, busy_sum_s=time.perf_counter() - t)
            load.append(row)
    alone = [x for x in load if not x["loaded"]]
    loaded_rows = [x for x in load if x["loaded"]]
    ratios = [b["wall_s"] / a["wall_s"] for a, b in zip(alone, loaded_rows)]
    same_forced = (r2b["levels"] == r2a["levels"] and r2b["level_stats"] == r2a["level_stats"]
                   and r2b["valid"] == r2a["valid"])
    out = {"strategy": strategy, "n_threads": n_thr, **host_line(),
           "case2_native_max_configs_1": case2, "case3_after_aborted_race": case3,
           "case3_same_as_case2": same_forced,
           "case1_races": races, "race": min_median([x["wall_s"] for x in races]),
           "native_alone": min_median(natives), "device_alone": min_median(devices),
           "engines": [x["engine"] for x in races], "case4_twin": case4,
           "contention": load,
           "device_alone_median_s": statistics.median(x["wall_s"] for x in alone),
           "device_loaded_median_s": statistics.median(x["wall_s"] for x in loaded_rows),
           "loaded_over_alone": ratios, "loaded_over_alone_median": statistics.median(ratios),
           "pairs_loaded_slower": sum(x > 1 for x in ratios)}
    emit({"phase": "competition", **out})
    if not (case2["same_as_main_path"] and case3["same_as_main_path"] and same_forced
            and case2["native_error"] is None and case3["native_error"] is None
            and tw["valid"] in (True, False) and tw["valid"] == twin_native["valid"]
            and clean_race(case4) and all(x["valid"] is True for x in load)):
        raise AssertionError("competition phase failed")
    return out


def engine_phases(lv, wgl, model, hist, main_res, hists) -> None:
    """The host engines: the native C search, auto, the competition."""
    from jepsen_tpu_torch.testing import perturb_history

    twin = perturb_history(random.Random(TWIN_SEED), hist)
    twin_native, _twin_dev, twin_dev_wall = native_phase(wgl, model, hist, twin)
    auto_phase(lv, wgl, model, hist, hists)
    competition_phase(lv, wgl, model, hist, twin, main_res, twin_native, twin_dev_wall)


# -- the offline segmented checker and the resilience layer -------------------

# bench.py's offline_segmented leg (bench.py:911-1000): OFFLINE["keys"] keys
# of concurrent_register_history(n_writers=5) merged by time as [k v]
# values, a valid history and its twin with key 0 perturbed, planned on 4
# streams. Cut from the leg's 1,000,000 ops to about OFFLINE["ops"] for the
# script's time limit, and each key's last round cut after its third write
# completes (the last 4 x keys ops: two write completions and the read of
# every key), so the history ends in an open terminal segment of every key
# with definite ops in it: the segments the engine's oracle decides (a
# history that ends quiescent is decided whole by the host enumerator, as
# the leg's is).
OFFLINE = dict(keys=8, n_writers=5, streams=4, seed=9200, twin_seed=9300,
               leg_ops=1_000_000, ops=100_000, host_ops=20_000)
SEGMENTED_ENTRY_OPS = 20_000
# The scheduler's budget-tripped rescue: RESCUE["keys"] keys of the same
# generator, about RESCUE["ops"] ops, and a stage-1 budget (max_configs) so
# small that the enumerator trips on every key's first segment: those
# non-terminal members of all four streams go to the device oracle, in one
# round or a few (as the submits and the worker interleave), while the
# host oracle still decides each of them within the same budget. The trip
# loses the carry, so both engines fold the later segments unknown
# (carry_lost): the run compares the rescue's verdicts, not a definite one.
RESCUE = dict(keys=256, ops=10_240, max_configs=64)
# The sharded north star of the resilience phase: levels a chunk (at least
# three chunks, so that the fault at the third lands inside the search),
# and the runs with and without the start copy, in turns.
RESILIENCE_SHARD_LPC = 500
RESILIENCE_COPY_TURNS = 2
# The capacity of the capped batch and of the capped drive's batches: the
# cap stops new segments of the caching allocator, so the batch must need
# more than the free space of the segments it already holds (tens of MB).
OOM_F = 65536
# store_replay: runs saved with store.save_1 under these test names, their
# start-times a second apart from STORE_T0 (2026-07-31T00:00:00Z), so the
# store's newest-first order is the reverse of the save order.
STORE_T0 = 1785456000.0
STORE_NAMES = {"replay": "batch-replay-100", "big": "batch-8x10k",
               "witness": "refutation", "elle": "elle-append", "keyed": "keyed-multi-register"}
ELLE_STORE = dict(seed=3, n_txns=600, lag=(100, 400), depth=8)  # anomalous: G-single, G2


def offline_history(seed, n, invalid=False, keys=OFFLINE["keys"]):
    """bench.py's ``_keyed_rec`` of ``n`` ops over ``keys`` keys, its last
    round cut (see OFFLINE)."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.testing import concurrent_register_history, perturb_history

    ops = []
    for i in range(keys):
        rng = random.Random(seed + i)
        hk = concurrent_register_history(rng, n_ops=n // keys,
                                         n_writers=OFFLINE["n_writers"])
        if invalid and i == 0:
            hk = perturb_history(rng, hk)
        ops.extend(op.with_(process=op.process + 1000 * i,
                            value=independent.KV(f"k{i}", op.value), index=-1) for op in hk)
    ops.sort(key=lambda o: o.time)
    return History(ops[:-4 * keys], reindex=True)


def without_keys(x, keys):
    """``x`` with every dict's ``keys`` left out, at any depth."""
    if isinstance(x, dict):
        return {k: without_keys(v, keys) for k, v in x.items() if k not in keys}
    if isinstance(x, (list, tuple)):
        return [without_keys(v, keys) for v in x]
    return x


def offline_map(r) -> dict:
    """An offline result map's verdict, segments_decided, per-stream folds,
    provenance and violation, without walls and engine names (at any
    depth: a stream's fold carries its violation's segment row)."""
    return without_keys({k: r.get(k) for k in ("valid", "segments_decided", "streams",
                                               "provenance", "violation", "failover")},
                        ("wall_s", "decide_s", "busy_pct", "engine"))


def resilience_counts(reg) -> dict:
    """The containment layer's counters in one registry."""
    return {"wgl_retry_total_batch": reg.counter(
                "wgl_retry_total", labelnames=("reason",)).labels(reason="batch").value,
            "wgl_retry_total_sharded": reg.counter(
                "wgl_retry_total", labelnames=("reason",)).labels(reason="sharded").value,
            "service_failovers_total": reg.counter(
                "service_failovers_total", labelnames=("engine",), aggregate=True).value}


def round_summary(reg) -> dict:
    """The scheduler's rounds: how many, which reached the card and with how
    many oracle members, and which failed over."""
    ev = [e for e in reg.events() if e["name"] == "online_round"]
    dev = [e for e in ev if e["engine"] == "device" and e["oracle_members"]]
    return {"rounds": len(ev), "oracle_rounds": sum(1 for e in ev if e["oracle_members"]),
            "device_rounds": len(dev), "device_round_members": [e["oracle_members"] for e in dev],
            "failover_rounds": sum(1 for e in ev if e["failover"])}


@contextlib.contextmanager
def oracle_timer():
    """The walls of the scheduler's device oracle calls (one batched search,
    and its single re-checks), each to the end of its device work."""
    import torch

    from jepsen_tpu_torch.online.scheduler import SegmentScheduler

    real = SegmentScheduler._decide_device
    walls = []

    def timed(self, encs):
        t = time.perf_counter()
        try:
            return real(self, encs)
        finally:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)

    SegmentScheduler._decide_device = timed
    try:
        yield walls
    finally:
        SegmentScheduler._decide_device = real


def offline_segmented_phase(lv, model) -> dict:
    """The offline leg: ``drive`` under ``device`` (counted) and ``auto`` on
    the valid history and ``auto`` on its twin at OFFLINE["ops"], then the
    same three runs at OFFLINE["host_ops"] against the host engine."""
    import torch

    from jepsen_tpu_torch import offline
    from jepsen_tpu_torch.parallel import resilience
    from jepsen_tpu_torch.telemetry import Registry

    resilience.reset_breakers()
    t = time.perf_counter()
    hv = offline_history(OFFLINE["seed"], OFFLINE["ops"])
    hi = offline_history(OFFLINE["twin_seed"], OFFLINE["ops"], invalid=True)
    gen_s = time.perf_counter() - t
    pv = offline.plan(hv, streams=OFFLINE["streams"])
    pi = offline.plan(hi, streams=OFFLINE["streams"])
    if not (pv.items[-1].segment.terminal and pi.items[-1].segment.terminal):
        raise AssertionError("the cut left no open tail: no segment reaches the oracle")
    emit({"phase": "offline_segmented", "cut": f"{OFFLINE['leg_ops']} -> {len(hv)} ops "
          "(the script's time limit); each key's last round cut after its third write "
          "completes: an open terminal segment of every key",
          "ops": len(hv), "twin_ops": len(hi), "generate_s": gen_s,
          "plan": pv.stats(), "twin_plan_seconds": pi.plan_seconds})
    runs, out = {}, {}
    for label, p, engine in (("device", pv, "device"), ("auto", pv, "auto"),
                             ("twin_auto", pi, "auto")):
        reg = Registry()
        if label == "device":
            reset_counts(lv)
        with oracle_timer() as walls:
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = offline.drive(p, model, engine=engine, metrics=reg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        row = {"run": label, "valid": r["valid"], "segments_decided": r["segments_decided"],
               "plan_seconds": p.plan_seconds, "decide_seconds": wall,
               "scheduler_decide_s": r.get("decide_s"), **round_summary(reg),
               "oracle_calls": len(walls), "oracle_wall_s": sum(walls),
               **resilience_counts(reg)}
        if label == "device":
            row["launches"] = launch_counts(lv, "offline_segmented", LEVEL_KERNELS)
        runs[label] = r
        out[label] = row
        emit({"phase": "offline_segmented", **row})
    dev = out["device"]
    ok = (runs["device"]["valid"] is True and runs["auto"]["valid"] is True
          and runs["twin_auto"]["valid"] is False
          and offline_map(runs["device"]) == offline_map(runs["auto"])
          and dev["device_rounds"] >= 1 and max(dev["device_round_members"]) > 1
          and dev["service_failovers_total"] == 0 and dev["wgl_retry_total_batch"] == 0
          and dev["failover_rounds"] == 0
          and not any("failover" in r for r in runs.values()))
    if not ok:
        raise AssertionError(f"offline_segmented failed: {out}")

    # the budget-tripped rescue: many non-terminal members in a device round
    hr = offline_history(OFFLINE["seed"], RESCUE["ops"], keys=RESCUE["keys"])
    pr = offline.plan(hr, streams=OFFLINE["streams"])
    rescue = {}
    for engine in ("device", "host"):
        reg = Registry()
        with oracle_timer() as walls:
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = offline.drive(pr, model, engine=engine, metrics=reg,
                              max_configs=RESCUE["max_configs"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        rescue[engine] = (r, {"valid": r["valid"], "segments_decided": r["segments_decided"],
                              "decide_seconds": wall, **round_summary(reg),
                              "oracle_calls": len(walls), "oracle_wall_s": sum(walls),
                              "causes": (r.get("provenance") or {}).get("causes"),
                              **resilience_counts(reg)})
    rd = rescue["device"][1]
    row = {"phase": "offline_segmented", "run": "rescue", "ops": len(hr),
           "keys": RESCUE["keys"], "max_configs": RESCUE["max_configs"],
           "plan_seconds": pr.plan_seconds, "device": rd, "host": rescue["host"][1],
           "same_as_host": offline_map(rescue["device"][0]) == offline_map(rescue["host"][0])}
    emit(row)
    if not (row["same_as_host"] and sum(rd["device_round_members"]) >= RESCUE["keys"]
            and max(rd["device_round_members"]) >= RESCUE["keys"] // OFFLINE["streams"]
            and rd["service_failovers_total"] == 0 and rd["failover_rounds"] == 0
            and rd["wgl_retry_total_batch"] == 0):
        raise AssertionError(f"offline_segmented rescue failed: {row}")
    out["rescue"] = row

    # the same three runs at OFFLINE["host_ops"], each beside the host engine
    h20 = offline_history(OFFLINE["seed"], OFFLINE["host_ops"])
    t20 = offline_history(OFFLINE["twin_seed"], OFFLINE["host_ops"], invalid=True)
    p20 = offline.plan(h20, streams=OFFLINE["streams"])
    q20 = offline.plan(t20, streams=OFFLINE["streams"])
    if not (p20.items[-1].segment.terminal and q20.items[-1].segment.terminal):
        raise AssertionError("the cut left no open tail: no segment reaches the oracle")
    small = {}
    for label, p, engine in (("device", p20, "device"), ("auto", p20, "auto"),
                             ("twin_auto", q20, "auto"), ("host", p20, "host"),
                             ("twin_host", q20, "host")):
        t = time.perf_counter()
        small[label] = offline.drive(p, model, engine=engine)
        small[label]["_wall"] = time.perf_counter() - t
    same = {"device_vs_host": offline_map(small["device"]) == offline_map(small["host"]),
            "auto_vs_host": offline_map(small["auto"]) == offline_map(small["host"]),
            "twin_auto_vs_host": offline_map(small["twin_auto"]) == offline_map(
                small["twin_host"])}
    emit({"phase": "offline_segmented", "run": "host_20k", "ops": len(h20),
          "valid": {k: v["valid"] for k, v in small.items()},
          "wall_s": {k: v["_wall"] for k, v in small.items()}, "same": same})
    if not (all(same.values()) and small["host"]["valid"] is True
            and small["twin_host"]["valid"] is False):
        raise AssertionError(f"offline_segmented at {OFFLINE['host_ops']} ops failed: {same}")
    return {"runs": out, "plan_20k": p20, "history_20k": h20, "history": hv, "twin": hi}


def segmented_entry_phase(lv, model, wgl, jchecker, h) -> dict:
    """``check_history(parallel="segmented", backend="device")`` (counted),
    ``linearizable(backend="segmented")`` and the CLI in a subprocess on one
    keyed history: one verdict."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch import independent

    reset_counts(lv)
    t = time.perf_counter()
    r1 = wgl.check_history(model, h, parallel="segmented", backend="device")
    torch.cuda.synchronize()
    w1 = time.perf_counter() - t
    launches = launch_counts(lv, "segmented_entry", LEVEL_KERNELS)
    t = time.perf_counter()
    r2 = jchecker.linearizable(model=model, backend="segmented").check({}, h, {})
    w2 = time.perf_counter() - t
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        path, out = Path(tmp) / "history.ndjson", Path(tmp) / "result.json"
        with open(path, "w") as f:
            for op in h:
                v = list(op.value) if isinstance(op.value, independent.KV) else op.value
                f.write(json.dumps({"type": op.type, "process": op.process, "f": op.f,
                                    "value": v, "time": op.time, "index": op.index}) + "\n")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root), os.environ.get("PYTHONPATH", "")]))
        t = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.offline", str(path),
                              "--keyed", "--engine", "device", "--streams",
                              str(OFFLINE["streams"]), "-o", str(out)],
                             cwd=root, env=env, capture_output=True, text=True, timeout=600)
        w3 = time.perf_counter() - t
        if run.returncode not in (0, 1, 2) or not out.exists():
            raise AssertionError(f"the offline CLI failed ({run.returncode}): "
                                 f"{run.stderr[-2000:]}")
        r3 = json.loads(out.read_text())
    row = {"phase": "segmented_entry", "ops": len(h),
           "check_history": {"valid": r1["valid"], "engine": r1["engine"], "wall_s": w1,
                             "segments_decided": r1["segments_decided"]},
           "linearizable": {"valid": r2["valid"], "wall_s": w2},
           "cli": {"valid": r3["valid"], "rc": run.returncode, "wall_s": w3},
           "launches": launches}
    emit(row)
    if not (r1["valid"] is True and r2["valid"] is True and r3["valid"] is True
            and run.returncode == 0 and r1["segments_decided"] == r2["segments_decided"]
            == r3["segments_decided"]):
        raise AssertionError(f"segmented_entry failed: {row}")
    return row


def _sharded_run(frontier, enc, mesh, **kw):
    import torch

    from jepsen_tpu_torch.telemetry import Registry

    rows, reg = [], Registry()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = frontier.check_encoded_sharded(
        enc, mesh=mesh, f_total=SHARD_F_TOTAL, levels_per_call=RESILIENCE_SHARD_LPC,
        metrics=reg, chunk_callback=lambda i: rows.append((i["level"], i["F"], i["count"])),
        **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    key = {k: res.get(k) for k in ("valid", "levels", "frontier_max", "frontier_total",
                                   "stuck_configs", "causes", "max_linearized")}
    key["attempts"] = [(a["F"], a["levels"], a["calls"]) for a in res.get("attempts") or []]
    return key, rows, wall, reg


def frontier_copy_ms(wgl, enc, FT, dev="cuda") -> dict:
    """The sharded chunk's start copy at global capacity ``FT``: the
    frontier's five arrays copied on the card (CUDA events, 50 copies)."""
    import torch

    plan = wgl.plan_device(enc, device=dev)
    W, KO, S, _nd, _no = plan.dims
    src = wgl.initial_frontier(FT, W, KO, S, plan.init_state, dev)[:5]
    dst = [torch.empty_like(a) for a in src]
    for _ in range(3):
        for d, s in zip(dst, src):
            d.copy_(s)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(50):
        for d, s in zip(dst, src):
            d.copy_(s)
    end.record()
    torch.cuda.synchronize()
    nbytes = sum(a.numel() * a.element_size() for a in src)
    ms = start.elapsed_time(end) / 50
    return {"F_total": FT, "bytes": nbytes, "ms": ms,
            "bound_ms": 1e3 * 2 * nbytes / HBM_BYTES_PER_S}


def resilience_phase(lv, model, wgl, frontier, make_mesh, encode_history, enc, replay,
                     p20, h20) -> dict:
    """The containment layer on the card: (a) one injected fault in the batch
    (``device.dispatch``, ``host.stack``): the batch's retry gives the
    results without it; (b) the sharded north star with ``device.dispatch``
    at its third chunk: the uninjected verdict and per-chunk rows, and the
    start copy's price; (c) three faults in a row: the ``"batch"`` breaker
    opens and the next device round is demoted to the host; (d) a real
    out-of-memory from capping this process's memory: transient, retried,
    failed over, and the same call decides on the card once the cap is
    lifted; (e) ``JEPSEN_NO_FAILOVER=1`` propagates; (f) Elle folds an
    injected dispatch fault."""
    import os

    import torch

    from jepsen_tpu_torch import offline
    from jepsen_tpu_torch.elle import append as ea
    from jepsen_tpu_torch.parallel import check_encoded_batch, resilience
    from jepsen_tpu_torch.telemetry import Registry
    from jepsen_tpu_torch.testing import chaos, lagged_append_history

    if os.environ.get("JEPSEN_NO_FAILOVER"):
        raise AssertionError("JEPSEN_NO_FAILOVER is set; the resilience phase needs the "
                             "retries armed")
    out = {}
    resilience.reset_breakers()
    chaos.reset()
    encs = [encode_history(model, h) for h in replay]
    clean = check_encoded_batch(encs, f=REPLAY["f"])

    # (a) one fault in the batch
    for point in ("device.dispatch", "host.stack"):
        reg = Registry()
        reset_counts(lv)
        with chaos.inject(point, on_call=1):
            got = check_encoded_batch(encs, f=REPLAY["f"], metrics=reg)
            fired = chaos.fired(point)
        launches = launch_counts(lv, f"resilience batch retry ({point})", LEVEL_KERNELS)
        row = {"fired": fired, "same_results": all(same_member(a, b)
                                                   for a, b in zip(got, clean)),
               **resilience_counts(reg), "breaker": resilience.breaker("batch").state,
               "launches": launches}
        out[f"a_batch_{point}"] = row
        if not (fired == 1 and row["same_results"] and row["wgl_retry_total_batch"] == 1
                and row["breaker"] == "closed"):
            raise AssertionError(f"resilience (a) {point} failed: {row}")

    # (b) the sharded north star, device.dispatch at its third chunk
    mesh = make_mesh(SHARD_D)
    base, base_rows, base_wall, _ = _sharded_run(frontier, enc, mesh)
    with chaos.inject("device.dispatch", on_call=3):
        got, rows, wall, reg = _sharded_run(frontier, enc, mesh)
        fired = chaos.fired("device.dispatch")
    walls = {"armed": [base_wall], "kill_switch": []}
    for turn in range(RESILIENCE_COPY_TURNS):
        for mode in (("kill_switch", "armed") if turn % 2 == 0 else ("armed", "kill_switch")):
            if mode == "kill_switch":
                os.environ["JEPSEN_NO_FAILOVER"] = "1"
            try:
                k, r, w, _ = _sharded_run(frontier, enc, mesh)
            finally:
                os.environ.pop("JEPSEN_NO_FAILOVER", None)
            if (k, r) != (base, base_rows):
                raise AssertionError("the sharded north star differs between runs")
            walls[mode].append(w)
    copy = frontier_copy_ms(wgl, enc, base["attempts"][-1][0])
    row = {"fired": fired, "chunks": len(base_rows), "valid": got["valid"],
           "levels": got["levels"], "attempts": got["attempts"],
           "same_verdict_and_rows": (got, rows) == (base, base_rows),
           **resilience_counts(reg), "wall_s": wall, "uninjected_wall_s": base_wall,
           "walls_armed_s": walls["armed"], "walls_kill_switch_s": walls["kill_switch"],
           "start_copy_at_final_capacity": copy,
           "start_copies_ms_est": copy["ms"] * len(base_rows)}
    out["b_sharded_north_star"] = row
    if not (fired == 1 and len(base_rows) >= 3 and row["same_verdict_and_rows"]
            and row["wgl_retry_total_sharded"] == 1):
        raise AssertionError(f"resilience (b) failed: {row}")

    # (c) three faults: the breaker opens, the next device round is demoted
    resilience.reset_breakers()
    reg = Registry()
    with chaos.inject("device.dispatch", times=3):
        try:
            check_encoded_batch(encs[:10], f=REPLAY["f"], metrics=reg)
            raised = None
        except chaos.ChaosError as e:
            raised = type(e).__name__
    state = resilience.breaker("batch").state
    gauge = reg.gauge("circuit_state", labelnames=("device",)).labels(device="batch").value
    reg2 = Registry()
    demoted = offline.drive(p20, model, engine="device", metrics=reg2)
    host = offline.drive(p20, model, engine="host")
    rs = round_summary(reg2)
    causes = set((demoted.get("provenance") or {}).get("causes") or {})
    row = {"raised": raised, "breaker": state, "circuit_state": gauge, **resilience_counts(reg),
           "next_drive": {"valid": demoted["valid"], "host_valid": host["valid"], **rs,
                          **resilience_counts(reg2), "causes": sorted(causes),
                          "failover": demoted.get("failover")}}
    out["c_breaker_open"] = row
    one_sided = (demoted["valid"] == host["valid"]
                 or (demoted["valid"] == "unknown"
                     and causes <= chaos.EXPECTED_UNKNOWN_CAUSES["device.dispatch"]))
    if not (raised == "ChaosError" and state == "open" and gauge == 2 and one_sided
            and rs["oracle_rounds"] >= 1 and rs["failover_rounds"] == rs["oracle_rounds"]
            and rs["device_rounds"] == 0
            and (demoted.get("failover") or {}).get("causes")
            == {"circuit_open": rs["failover_rounds"]}):
        raise AssertionError(f"resilience (c) failed: {row}")
    resilience.reset_breakers()

    # (d) a real out-of-memory: this process's memory capped at what it holds
    sub = encs[:10]
    before = check_encoded_batch(sub, f=OOM_F)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    fraction = torch.cuda.memory_reserved() / total
    reg, reg2 = Registry(), Registry()
    torch.cuda.set_per_process_memory_fraction(fraction)
    try:
        try:
            check_encoded_batch(sub, f=OOM_F, metrics=reg)
            oom = None
        except torch.OutOfMemoryError as e:
            oom = e
        resilience.reset_breakers()
        failed_over = offline.drive(p20, model, engine="device", metrics=reg2,
                                    batch_f=OOM_F)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    resilience.reset_breakers()
    after = check_encoded_batch(sub, f=OOM_F)
    rs = round_summary(reg2)
    row = {"cap_fraction": fraction, "f": OOM_F, "raised": type(oom).__name__ if oom else None,
           "error": str(oom).splitlines()[0][:200] if oom else None,
           "transient": bool(oom) and resilience.is_transient(oom), **resilience_counts(reg),
           "failover_drive": {"valid": failed_over["valid"], **rs, **resilience_counts(reg2),
                              "failover": failed_over.get("failover")},
           "after_cap_same_results": all(same_member(a, b) for a, b in zip(after, before))}
    out["d_real_oom"] = row
    if not (oom is not None and row["transient"] and row["wgl_retry_total_batch"] == 2
            and failed_over["valid"] == host["valid"] and rs["failover_rounds"] >= 1
            and "OutOfMemoryError" in (failed_over.get("failover") or {}).get("causes", {})
            and row["after_cap_same_results"]):
        raise AssertionError(f"resilience (d) failed: {row}")

    # (e) the kill switch propagates the injected error
    os.environ["JEPSEN_NO_FAILOVER"] = "1"
    try:
        with chaos.inject("device.dispatch", on_call=1):
            try:
                check_encoded_batch(sub, f=REPLAY["f"])
                propagated = False
            except chaos.ChaosError:
                propagated = True
    finally:
        os.environ.pop("JEPSEN_NO_FAILOVER", None)
    out["e_kill_switch"] = {"propagated": propagated,
                            "breaker": resilience.breaker("batch").state}
    if not (propagated and out["e_kill_switch"]["breaker"] == "closed"):
        raise AssertionError(f"resilience (e) failed: {out['e_kill_switch']}")

    # (f) Elle: one fault halves the chunk; every dispatch failing folds
    strip = lambda r: {k: v for k, v in r.items() if k != "engine"}  # noqa: E731
    h8 = lagged_append_history(**APPEND_8K)
    rep0, rep1 = {}, {}
    clean8 = ea.check(h8, device=True, report=rep0)
    with chaos.inject("device.dispatch", on_call=1):
        once = ea.check(h8, device=True, report=rep1)
    h2 = lagged_append_history(**LAG_2K)
    rep2, rep3 = {}, {}
    clean2 = ea.check(h2, device=True, report=rep2)
    with chaos.inject("device.dispatch", times=100):
        folded = ea.check(h2, device=True, report=rep3)
    row = {"once": {"same_result": strip(once) == strip(clean8), "report": rep1,
                    "uninjected_report": rep0},
           "every_dispatch": {"same_verdict": strip(folded) == strip(clean2),
                              "engine": rep3.get("engine"),
                              "causes": sorted({c["code"] for c in rep3.get("causes") or []})}}
    out["f_elle"] = row
    if not (row["once"]["same_result"] and rep1.get("engine") == "device"
            and not rep1.get("causes") and rep1.get("chunks", 0) > rep0.get("chunks", 0)
            and row["every_dispatch"]["same_verdict"]
            and row["every_dispatch"]["causes"] == ["elle_device_oom"]):
        raise AssertionError(f"resilience (f) failed: {row}")
    chaos.reset()
    resilience.reset_breakers()
    for k, v in out.items():
        emit({"phase": "resilience", "case": k, **v})
    return out


# -- the store and the batch replay of stored histories ----------------------


def stored_test(root, kind, i=0, **more) -> dict:
    """The test map of run ``i`` of ``kind`` in the store at ``root``."""
    from jepsen_tpu_torch import store

    return {"name": STORE_NAMES[kind], "start-time": store.time_str(STORE_T0 + i),
            "store-root": str(root), **more}


def save_runs(root, kind, hists) -> tuple:
    """Each history saved as its own run (``store.save_1``); returns the
    ``history.edn`` paths in the order of ``hists``, the seconds and the
    bytes written."""
    from jepsen_tpu_torch import store

    t = time.perf_counter()
    paths = []
    for i, h in enumerate(hists):
        test = stored_test(root, kind, i, history=h)
        store.save_1(test)
        paths.append(store.path(test, "history.edn"))
    return paths, time.perf_counter() - t, sum(p.stat().st_size for p in paths)


def stored_verdict(path):
    """The ``:valid?`` of an EDN results file, as a result map holds it."""
    from jepsen_tpu_torch import edn

    v = edn.read_string(path.read_text())[edn.K("valid?")]
    return v.name if isinstance(v, edn.Keyword) else v


def replay_steps(before: int) -> dict:
    """The seconds of each step of the replays since the default trace
    collector held ``before`` spans (``replay.load`` -> ``load_s``, ...),
    summed over the replays."""
    from jepsen_tpu_torch import trace

    out: dict = {}
    for sp in trace.default_collector().spans[before:]:
        if sp["name"].startswith("replay."):
            key = sp["name"].split(".", 1)[1] + "_s"
            out[key] = out.get(key, 0.0) + (sp["end_ns"] - sp["start_ns"]) / 1e9
    return out


def edn_reader(path) -> str:
    """Which EDN reader parses ``path``: ``edn_fast``, or ``python`` and why."""
    from jepsen_tpu_torch import native

    fast = native.load_edn_fast()
    if fast is None:
        return f"python ({native.edn_fast_missing})"
    try:
        fast.parse_all(path.read_text())
    except fast.FastParseError as e:
        return f"python (edn_fast refused the text: {e})"
    return "edn_fast"


def expected_exit(verdicts) -> int:
    """The replay command's exit code for these verdicts."""
    return 1 if False in verdicts else 2 if "unknown" in verdicts else 0


def store_replay_phase(lv, model, replay, rk, rk_default, host, big, bad, independent,
                       History) -> dict:
    """BASELINE config 5 through its own entry point, in a temporary store:
    (a) batch_replay_100's histories saved with ``store.save_1`` and
    replayed by ``cli.run(cli.replay_cmd(...), ["replay", ...])`` (the exit
    code the in-memory verdicts imply, every ``rechecked.edn`` the host
    oracle's definite verdict; ``parallel.replay.replay`` at ``f`` 64 the
    in-memory batch's keys); (b) the eight 10k histories replayed, against
    an in-memory ``check_encoded_batch`` with replay's arguments, the
    save, parse, encode, decide and write walls printed with the reader;
    (c) the refutation's ``linear.txt``/``linear.svg`` from the card equal
    to the CPU's; (d) an anomalous append history's ``elle/<anomaly>.txt``
    from the card equal to the CPU's; (e) the keyed multi-register history
    through ``independent.checker(linearizable)``, a store directory for
    every key. Returns each path's launch counts."""
    import tempfile
    from pathlib import Path

    import torch

    from jepsen_tpu_torch import cli, native, store, trace
    from jepsen_tpu_torch import checker as jchecker
    from jepsen_tpu_torch.elle import ops as eo
    from jepsen_tpu_torch.ops.encode import encode_history
    from jepsen_tpu_torch.parallel import check_encoded_batch
    from jepsen_tpu_torch.parallel import replay as pr
    from jepsen_tpu_torch.testing import lagged_append_history
    from jepsen_tpu_torch.workloads import append as wl_append

    launches, out = {}, {}
    with tempfile.TemporaryDirectory(prefix="store_replay_") as tmp:
        root = Path(tmp)
        # The C reader is built (or found built) before any timer starts:
        # nothing earlier in the script reads EDN.
        t = time.perf_counter()
        native.load_edn_fast()
        build_s = time.perf_counter() - t
        # (a) the 100-run store through the replay command
        paths, save_s, nbytes = save_runs(root, "replay", replay)
        code_want = expected_exit([r["valid"] for r in rk_default])
        reset_counts(lv)
        torch.cuda.synchronize()
        before = len(trace.default_collector().spans)
        t = time.perf_counter()
        code = cli.run(cli.replay_cmd(model_args={"init": 0}),
                       ["replay", "--store-root", str(root)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        steps = replay_steps(before)
        launches["store_replay_100"] = launch_counts(lv, "store_replay (a)", LEVEL_KERNELS)
        stored = [stored_verdict(p.parent / "rechecked.edn") for p in paths]
        again = pr.replay(model, paths, f=REPLAY["f"], write_results=False)
        agree = {
            "exit_code": code == code_want,
            "every_run_rechecked": len(list(root.rglob("rechecked.edn"))) == len(paths),
            "as_in_memory": stored == [r["valid"] for r in rk_default],
            "host": all(v == h for v, h in zip(stored, host) if v != "unknown"),
            "replay_f64_keys": all(same_keys(a, b) for a, b in zip(again, rk)),
        }
        out["a"] = {"runs": len(paths), "exit_code": code, "expected_exit_code": code_want,
                    "wall_s": wall, **steps, "edn_fast_build_s": build_s,
                    "reader": edn_reader(paths[0]), "save_s": save_s, "bytes": nbytes,
                    "valid": stored.count(True), "invalid": stored.count(False),
                    "unknown": stored.count("unknown"), "agree": agree}
        emit({"phase": "store_replay", "case": "a_replay_100", **out["a"],
              "launches": launches["store_replay_100"]})
        if not all(agree.values()):
            raise AssertionError(f"store_replay (a) disagrees: {agree}")

        # (b) the north star's width: eight 10k-op histories
        paths, save_s, nbytes = save_runs(root, "big", big)
        reader = edn_reader(paths[0])
        reset_counts(lv)
        torch.cuda.synchronize()
        before = len(trace.default_collector().spans)
        rb = pr.replay(model, paths)
        steps = replay_steps(before)
        launches["store_replay_8x10k"] = launch_counts(
            lv, "store_replay (b)", LEVEL_KERNELS + ("wgl_regroup",))
        t = time.perf_counter()
        mem = check_encoded_batch([encode_history(model, h.client_ops()) for h in big])
        torch.cuda.synchronize()
        mem_wall = time.perf_counter() - t
        stored = [stored_verdict(p.parent / "rechecked.edn") for p in paths]
        agree = {"keys": all(same_keys(a, b) for a, b in zip(rb, mem)),
                 "rechecked": stored == [r["valid"] for r in rb],
                 "never_false": False not in stored}
        out["b"] = {"members": len(paths), "save_s": save_s, "bytes": nbytes,
                    "reader": reader, **steps,
                    "parse_mb_per_s": nbytes / 1e6 / steps["load_s"],
                    "valid": [r["valid"] for r in rb], "levels": [r.get("levels") for r in rb],
                    "rungs": [(x["F"], x["members"], x["calls"], x["wall_s"])
                              for x in max((r.get("rungs") or [] for r in rb), key=len)],
                    "in_memory_decide_s": mem_wall, "agree": agree}
        emit({"phase": "store_replay", "case": "b_8x10k", **out["b"],
              "launches": launches["store_replay_8x10k"]})
        if not all(agree.values()):
            raise AssertionError(f"store_replay (b) disagrees: {agree}")

        # (c) the witness files of a refutation on the card and on the CPU
        files, res, walls = {}, {}, {}
        for dev in ("cuda", "cpu"):
            test = stored_test(root / dev, "witness")
            reset_counts(lv)
            t = time.perf_counter()
            res[dev] = jchecker.linearizable(model=model, device=dev).check(test, bad, {})
            if dev == "cuda":
                torch.cuda.synchronize()
                launches["store_witness"] = launch_counts(lv, "store_replay (c)")
            walls[dev] = time.perf_counter() - t
            files[dev] = {f: store.path(test, f).read_bytes()
                          for f in res[dev].get("witness_files") or []}
        agree = {"refuted": res["cuda"]["valid"] is False and res["cpu"]["valid"] is False,
                 "no_witness_error": not any("witness_error" in r for r in res.values()),
                 "files": sorted(files["cuda"]) == ["linear.svg", "linear.txt"],
                 "same_files": files["cuda"] == files["cpu"]}
        out["c"] = {"bytes": {f: len(b) for f, b in files["cuda"].items()},
                    "wall_s": walls["cuda"], "cpu_wall_s": walls["cpu"], "agree": agree}
        emit({"phase": "store_replay", "case": "c_witness", **out["c"],
              "launches": launches["store_witness"]})
        if not all(agree.values()):
            raise AssertionError(f"store_replay (c) disagrees: {agree}")

        # (d) Elle's explanation files on the card and on the CPU
        h = lagged_append_history(**ELLE_STORE)
        files, res, walls = {}, {}, {}
        for dev in ("cuda", "cpu"):
            test = stored_test(root / dev, "elle")
            eo.reset_launches()
            t = time.perf_counter()
            res[dev] = wl_append.checker({"device": True, "torch_device": dev}).check(
                test, h, {})
            if dev == "cuda":
                torch.cuda.synchronize()
                launches["store_explain"] = elle_launches(eo, "store_replay (d)")
            walls[dev] = time.perf_counter() - t
            d = store.path(test, "elle")
            files[dev] = {p.name: p.read_bytes() for p in sorted(d.iterdir())} \
                if d.exists() else {}
        agree = {"anomalous": res["cuda"]["valid"] is False,
                 "files": sorted(files["cuda"]) == sorted(
                     f"{a}.txt" for a in res["cuda"].get("anomalies") or {}),
                 "same_files": files["cuda"] == files["cpu"] != {},
                 "no_directory_error": not any("directory_error" in r for r in res.values())}
        out["d"] = {"txns": res["cuda"].get("txn_count"), "files": sorted(files["cuda"]),
                    "wall_s": walls["cuda"], "cpu_wall_s": walls["cpu"], "agree": agree}
        emit({"phase": "store_replay", "case": "d_explain", **out["d"],
              "launches": launches["store_explain"]})
        if not all(agree.values()):
            raise AssertionError(f"store_replay (d) disagrees: {agree}")

        # (e) the keyed checker's per-key store directories
        kmodel, khists, keyed_h = keyed_mr_histories(independent, History)
        test = stored_test(root, "keyed")
        reset_counts(lv)
        t = time.perf_counter()
        keyed = independent.checker(jchecker.linearizable(model=kmodel)).check(
            test, keyed_h, {})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches["store_keyed"] = launch_counts(lv, "store_replay (e)", LEVEL_KERNELS)
        d = store.path(test, "independent")
        keys = sorted(int(p.name) for p in d.iterdir()) if d.exists() else []
        agree = {"every_key": keys == list(range(len(khists))),
                 "both_files": all((d / str(k) / f).exists() for k in keys
                                   for f in ("history.edn", "results.edn")),
                 "verdicts": all(stored_verdict(d / str(k) / "results.edn")
                                 == keyed["results"][k]["valid"] for k in keys),
                 "batched": all(r.get("batched") is True for r in keyed["results"].values())}
        out["e"] = {"keys": len(keys), "wall_s": wall, "valid": keyed["valid"],
                    "failures": len(keyed["failures"]), "agree": agree}
        emit({"phase": "store_replay", "case": "e_independent", **out["e"],
              "launches": launches["store_keyed"]})
        if not all(agree.values()):
            raise AssertionError(f"store_replay (e) disagrees: {agree}")
    return launches


# -- the checker front door and trace ingestion ------------------------------

# front_door: the first FRONT_DOOR_KEYS keys of keyed_multi_register's
# history (key 0 perturbed, key 1 valid) through a suite-shaped composed
# checker, on the card and with ``device="cpu"`` (on one CPU thread: the
# plain search's small tensors run twice as fast so); then the invariant
# checkers set_full and counter on seeded histories of INVARIANTS_OPS ops
# (a set-full read every SET_FULL_READ_EVERY-th invocation, a counter read
# every third).
FRONT_DOOR_KEYS = 2
INVARIANTS_OPS = 100_000
SET_FULL_READ_EVERY = 250
# ingest: bench.py's ingest_etcd_10k leg (:1479-1543; INGEST_10K_ROUNDS
# rounds of a put and a range, 10,000 lines), the offline phase's history
# and twin as etcd proxy ndjson, and APPEND_8K's history as generic jsonl
# txns, each through ``python -m jepsen_tpu_torch.ingest`` in a process of
# its own, all started together (INGEST_CLI_TIMEOUT seconds each at most).
INGEST_10K_ROUNDS = 2500
INGEST_CLI_TIMEOUT = 300


def invariant_histories(seed, n_ops):
    """Seeded op maps of ``n_ops`` ops for set-full (adds of fresh elements,
    reads of the acknowledged set) and for a counter (adds, reads of the
    count), four processes, one op in flight a process."""
    rng = random.Random(seed)
    out = {}
    for kind in ("set", "counter"):
        rows, busy, state, t, nxt = [], {}, (set() if kind == "set" else [0]), 0, 0
        while len(rows) < n_ops:
            t += rng.randrange(1, 3_000_000)
            free = [p for p in range(4) if p not in busy]
            if free and (not busy or rng.random() < 0.5) and len(rows) + len(busy) < n_ops:
                p = rng.choice(free)
                nxt += 1
                if kind == "set":
                    f, v = ("read", None) if nxt % SET_FULL_READ_EVERY == 0 else ("add", nxt)
                else:
                    f, v = ("read", None) if nxt % 3 == 0 else ("add", rng.randrange(5))
                busy[p] = (f, v)
                rows.append({"type": "invoke", "process": p, "f": f, "value": v, "time": t})
                continue
            p = rng.choice(sorted(busy))
            f, v = busy.pop(p)
            if f == "add":
                if kind == "set":
                    state.add(v)
                else:
                    state[0] += v
            else:
                v = sorted(state) if kind == "set" else state[0]
            rows.append({"type": "ok", "process": p, "f": f, "value": v, "time": t})
        out[kind] = rows
    return out


def front_door_phase(lv, jchecker, independent, History) -> dict:
    """A suite-shaped composed checker, keyed: ``independent.checker(compose(
    {linear, stats, exceptions, limited}))``, the linear part on the card
    (launches counted) and with ``device="cpu"``: the same result maps. Then
    ``set_full`` and ``counter`` on INVARIANTS_OPS-op histories, timed on
    the card's host. Returns the composed check's launch counts."""
    import torch

    from jepsen_tpu_torch.history import Op

    model, _, h = keyed_mr_histories(independent, History, FRONT_DOOR_KEYS)

    def composed(device):
        return independent.checker(jchecker.compose({
            "linear": jchecker.linearizable(model=model, device=device),
            "stats": jchecker.stats(),
            "exceptions": jchecker.unhandled_exceptions(),
            "limited": jchecker.concurrency_limit(1, jchecker.linearizable(
                model=model, backend="host"))}))

    reset_counts(lv)
    torch.cuda.synchronize()
    t = time.perf_counter()
    card = composed(None).check({}, h, {})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts(lv, "front_door", LEVEL_KERNELS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t = time.perf_counter()
        cpu = composed("cpu").check({}, h, {})
        cpu_wall = time.perf_counter() - t
    finally:
        torch.set_num_threads(threads)
    results = card["results"]
    row = {"phase": "front_door", "keys": FRONT_DOOR_KEYS, "ops": len(h),
           "valid": card["valid"], "failures": card["failures"], "wall_s": wall,
           "cpu_wall_s": cpu_wall, "launches": launches,
           # what differs between the card's run and the CPU's: walls, device
           "same_as_cpu": (without_keys(card, ("wall_s", "torch_device"))
                           == without_keys(cpu, ("wall_s", "torch_device"))),
           "linear_on_card": all(r["linear"].get("torch_device") == "cuda"
                                 for r in results.values()),
           "linear_as_limited_host": all(r["linear"]["valid"] == r["limited"]["valid"]
                                         for r in results.values())}
    emit(row)
    if not (row["same_as_cpu"] and row["linear_on_card"] and row["linear_as_limited_host"]
            and card["valid"] is False and card["failures"] == [0]):
        raise AssertionError(f"front_door failed: {row}")

    hists = invariant_histories(KEYED["seed"], INVARIANTS_OPS)
    timed = {}
    for name, chk, rows in (("set_full", jchecker.set_full(), hists["set"]),
                            ("counter", jchecker.counter(), hists["counter"])):
        hh = History([Op.from_dict(r) for r in rows])
        t = time.perf_counter()
        r = chk.check({}, hh, {})
        timed[name] = {"ops": len(hh), "valid": r["valid"], "wall_s": time.perf_counter() - t}
    emit({"phase": "front_door", "invariants": timed, "host": host_line()})
    if not all(v["valid"] is True for v in timed.values()):
        raise AssertionError(f"front_door invariants failed: {timed}")
    return launches


def etcd_10k_lines() -> list:
    """bench.py's ingest_etcd_10k recording (:1493-1516): a put on one
    connection and a range of the value on another, each round, over four
    keys (valid by construction)."""
    lines, ts, iv = [], 1_000, 0
    for i in range(INGEST_10K_ROUNDS):
        key = f"r{i % 4}"
        for rec in ({"conn": "c-w", "id": i, "phase": "request", "op": "put", "key": key,
                     "value": iv},
                    {"conn": "c-w", "id": i, "phase": "response", "ok": True},
                    {"conn": "c-r", "id": 10_000 + i, "phase": "request", "op": "range",
                     "key": key},
                    {"conn": "c-r", "id": 10_000 + i, "phase": "response", "ok": True,
                     "value": iv}):
            lines.append(json.dumps({"ts": ts, **rec}))
            ts += 7
        if key == "r3":
            iv += 1
    return lines


def etcd_lines(h) -> list:
    """A keyed register history as etcd client-proxy ndjson: a request for
    each invoke (``put`` a write, ``range`` a read; the connection is the
    process), a response for each ok or fail, nothing for an info, and
    the invokes the cut left open stay unanswered requests."""
    lines, open_id = [], {}
    for i, op in enumerate(h):
        k, v = op.value.key, op.value.value
        if op.f not in ("write", "read"):
            raise AssertionError(f"etcd_lines: no etcd request for f {op.f!r}")
        if op.type == "invoke":
            open_id[op.process] = i
            rec = {"phase": "request", "op": "put" if op.f == "write" else "range", "key": k}
            if op.f == "write":
                rec["value"] = v
        elif op.type in ("ok", "fail"):
            rec = {"phase": "response", "ok": op.type == "ok"}
            if op.f == "read":
                rec["value"] = v
        else:
            open_id.pop(op.process, None)
            continue
        rid = i if op.type == "invoke" else open_id.pop(op.process)
        lines.append(json.dumps({"ts": op.time, "conn": f"c{op.process}", "id": rid, **rec}))
    return lines


def txn_jsonl_lines(h) -> list:
    """A txn history as generic jsonl: a request for each invoke, a
    response (``ok``) for each completion, paired by ``corr``, the
    connection the process."""
    lines, open_corr = [], {}
    for i, op in enumerate(h):
        rec = {"time": op.time, "conn": op.process, "f": op.f, "value": op.value}
        if op.type == "invoke":
            open_corr[op.process] = i
            rec.update(phase="request", corr=i)
        else:
            rec.update(phase="response", corr=open_corr.pop(op.process), ok=op.type == "ok")
        lines.append(json.dumps(rec))
    return lines


def jnorm(x):
    """A map as its JSON text reads back (what the CLI writes)."""
    return json.loads(json.dumps(x, sort_keys=True, default=str))


_OP_REPR = re.compile(r"^<(-?\d+) (\S+) (\S+) :(\S+) (.*)>$")


def txn_norm(x):
    """An Elle result map with each txn's text (an ``Op`` repr or an op
    map's) as (index, type, f, value text): the ingested ops are op maps
    whose process ids the adapter numbered by first appearance."""
    if isinstance(x, dict):
        return {k: txn_norm(v) for k, v in x.items() if k not in ("engine", "engine_name")}
    if isinstance(x, (list, tuple)):
        return [txn_norm(v) for v in x]
    if isinstance(x, str):
        m = _OP_REPR.match(x)
        if m:
            return [int(m.group(1)), m.group(3), m.group(4), m.group(5)]
        if x.startswith("{'type'"):
            d = ast.literal_eval(x)
            return [d["index"], d["type"], d["f"], repr(d["value"])]
    return x


def _wait_end(p, ends, run) -> None:
    p.wait()
    ends[run] = time.perf_counter()


def ingest_phase(lv, off, h8_result) -> dict:
    """Trace ingestion on the card. (a) ingest_etcd_10k, ``--check
    segmented``: True, 0 unmapped. (b) the offline phase's history and its
    twin (``off``: both, and the verdicts of that phase's drives) as etcd
    ndjson under ``--engine device`` and ``auto``: the maps
    ``check_offline``'s on the same parsed ops (run here, launches counted,
    the device rounds and their members), the verdicts the offline phase's
    own (True / False, exit 0 / 2). (c) APPEND_8K's history as jsonl txns,
    ``--check elle``: elle_append_8k's map, the closure kernels launched.
    The CLI runs are processes of their own, started together while this
    process parses and checks the same recordings."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from jepsen_tpu_torch import _build, offline
    from jepsen_tpu_torch.elle import ops as eo
    from jepsen_tpu_torch.ingest import adapters as ad
    from jepsen_tpu_torch.ingest import mapper
    from jepsen_tpu_torch.models import model_by_name
    from jepsen_tpu_torch.parallel import resilience
    from jepsen_tpu_torch.telemetry import Registry
    from jepsen_tpu_torch.testing import lagged_append_history

    resilience.reset_breakers()
    model = model_by_name(mapper.WORKLOADS["register"][0])  # the mapper's model
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), os.environ.get("PYTHONPATH", "")]))
    out, procs, waiters, ends = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        tmp = Path(tmp)
        runs = {"etcd_10k": ["--check", "segmented"],
                "etcd_100k": ["--check", "segmented", "--engine"],
                "etcd_100k_twin": ["--check", "segmented", "--engine"],
                "elle_8k": ["--check", "elle"]}
        recordings, write_s = {}, 0.0
        try:
            # each recording written, then its CLI runs started (both engines
            # for the 100k histories), while the next is made
            for name, make in (("etcd_10k", lambda: ("etcd", etcd_10k_lines())),
                               ("etcd_100k", lambda: ("etcd", etcd_lines(off["history"]))),
                               ("etcd_100k_twin", lambda: ("etcd", etcd_lines(off["twin"]))),
                               ("elle_8k", lambda: ("jsonl", txn_jsonl_lines(
                                   lagged_append_history(**APPEND_8K))))):
                t = time.perf_counter()
                recordings[name] = make()
                (tmp / f"{name}.trace").write_text("\n".join(recordings[name][1]) + "\n")
                write_s += time.perf_counter() - t
                args = runs[name]
                for run, a in ([(f"{name}_{e}", args + [e]) for e in ("device", "auto")]
                               if args[-1] == "--engine" else [(name, args)]):
                    err = open(tmp / f"{run}.err", "w")
                    cmd = [sys.executable, "-m", "jepsen_tpu_torch.ingest",
                           str(tmp / f"{name}.trace"), "--adapter", recordings[name][0], *a,
                           "-o", str(tmp / f"{run}.json")]
                    procs[run] = (subprocess.Popen(cmd, cwd=root, env=env,
                                                   stdout=subprocess.DEVNULL, stderr=err),
                                  time.perf_counter(), err)
                    # each run's own wall: a thread waits for it while this
                    # process works
                    waiters[run] = threading.Thread(target=_wait_end,
                                                    args=(procs[run][0], ends, run), daemon=True)
                    waiters[run].start()

            # -- in this process: parse and check, timed and counted --------
            def parse(name):
                adapter, lines = recordings[name]
                t = time.perf_counter()
                parsed = ad.parse_trace(lines, ad.by_name(adapter))
                return parsed, time.perf_counter() - t

            parsed, parse_s = parse("etcd_10k")
            t = time.perf_counter()
            r = mapper.check_ingested(parsed, check="segmented")
            torch.cuda.synchronize()
            check_s = time.perf_counter() - t
            out["a"] = {"lines": len(recordings["etcd_10k"][1]), "ops": r["n_ops"],
                        "valid": r["valid"], "unmapped": r["unmapped"],
                        "workload": r["workload"], "parse_s": parse_s, "check_s": check_s,
                        "ingest_ops_per_s": r["n_ops"] / (parse_s + check_s)}
            lib = {}
            for name in ("etcd_100k", "etcd_100k_twin"):
                parsed, parse_s = parse(name)
                reg = Registry()
                reset_counts(lv)
                with oracle_timer() as walls:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    r = offline.check_offline(model, parsed["ops"], engine="device",
                                              metrics=reg)
                    torch.cuda.synchronize()
                    check_s = time.perf_counter() - t
                lib[name] = r
                out[name] = {"lines": len(recordings[name][1]), "ops": len(parsed["ops"]),
                             "unmapped": parsed["unmapped"], "stats": parsed["stats"],
                             "valid": r["valid"], "parse_s": parse_s, "check_s": check_s,
                             "segments_decided": r["segments_decided"], **round_summary(reg),
                             "oracle_calls": len(walls), "oracle_wall_s": sum(walls),
                             **resilience_counts(reg),
                             "launches": launch_counts(lv, f"ingest {name}", LEVEL_KERNELS)}
            parsed, parse_s = parse("elle_8k")
            eo.reset_launches()
            rep = {}
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = mapper.check_ingested(parsed, check="elle", report=rep)
            torch.cuda.synchronize()
            check_s = time.perf_counter() - t
            lib["elle_8k"] = r
            out["c"] = {"lines": len(recordings["elle_8k"][1]), "txns": r["result"]["txn_count"],
                        "valid": r["valid"], "unmapped": r["unmapped"], "engine": rep,
                        "parse_s": parse_s, "check_s": check_s,
                        "launches": elle_launches(eo, "ingest (c)"),
                        "same_as_elle_append_8k": txn_norm(r["result"]) == txn_norm(h8_result)}

            # -- the CLI processes ------------------------------------------
            cli = {}
            for run, (p, t0, err) in procs.items():
                try:
                    rc = p.wait(timeout=max(1.0, INGEST_CLI_TIMEOUT - (time.perf_counter() - t0)))
                except subprocess.TimeoutExpired:
                    rc = None
                waiters[run].join(timeout=5)
                err.close()
                doc = tmp / f"{run}.json"
                end = ends.get(run)
                cli[run] = {"rc": rc, "wall_s": None if end is None else end - t0,
                            "doc": json.loads(doc.read_text()) if doc.exists() else None,
                            "stderr": (tmp / f"{run}.err").read_text()[-2000:]}
        finally:
            for p, _, err in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                err.close()
    bad = {run: c["stderr"] for run, c in cli.items() if c["rc"] not in (0, 1, 2) or not c["doc"]}
    if bad:
        raise AssertionError(f"ingest CLI runs failed: {bad}")
    doc = lambda run: cli[run]["doc"]  # noqa: E731
    walls = {run: c["wall_s"] for run, c in cli.items()}
    a = out["a"]
    a.update(cli_rc=cli["etcd_10k"]["rc"], cli_valid=doc("etcd_10k")["valid"],
             cli_unmapped=doc("etcd_10k")["unmapped"], cli_wall_s=walls["etcd_10k"])
    emit({"phase": "ingest", "case": "a_etcd_10k", **a})
    b_ok = True
    for name, want, rc in (("etcd_100k", True, 0), ("etcd_100k_twin", False, 2)):
        row = out[name]
        ref_map = offline_map(jnorm(lib[name]))
        row["cli"] = {e: {"rc": cli[f"{name}_{e}"]["rc"], "valid": doc(f"{name}_{e}")["valid"],
                          "unmapped": doc(f"{name}_{e}")["unmapped"],
                          "wall_s": walls[f"{name}_{e}"],
                          "same_map": offline_map(doc(f"{name}_{e}")["result"]) == ref_map}
                      for e in ("device", "auto")}
        row["offline_segmented_valid"] = want
        emit({"phase": "ingest", "case": f"b_{name}", **row})
        b_ok &= (row["valid"] is want and row["unmapped"] == 0 and row["device_rounds"] >= 1
                 and row["failover_rounds"] == 0 and row["service_failovers_total"] == 0
                 and all(c["rc"] == rc and c["valid"] is want and c["same_map"]
                         and c["unmapped"] == 0 for c in row["cli"].values()))
    c = out["c"]
    c.update(cli_rc=cli["elle_8k"]["rc"], cli_valid=doc("elle_8k")["valid"],
             cli_wall_s=walls["elle_8k"],
             cli_same_map=txn_norm(doc("elle_8k")["result"]) == txn_norm(jnorm(
                 lib["elle_8k"]["result"])))
    emit({"phase": "ingest", "case": "c_elle_8k", **c})
    ok = (a["valid"] is True and a["unmapped"] == 0 and a["cli_rc"] == 0
          and a["cli_valid"] is True and a["cli_unmapped"] == 0
          and off["verdicts"] == {"device": True, "auto": True, "twin_auto": False} and b_ok
          and c["same_as_elle_append_8k"] and c["cli_same_map"] and c["unmapped"] == 0
          and c["valid"] is h8_result["valid"] is False and c["cli_rc"] == 2
          and c["engine"].get("engine") == "device" and c["launches"]["elle_square"] > 0)
    emit({"phase": "ingest", "case": "done", "write_s": write_s, "ok": ok})
    if not ok:
        raise AssertionError("ingest failed")
    return {"launches": out["etcd_100k"]["launches"], "elle_launches": c["launches"]}


# The test runner on the card (runner phase): (a) an in-process core.run
# of the demo's cas-register test at the north star's size with the
# online monitor's device oracle and telemetry on, one reply lost; (a')
# the same traffic with every reply, in a process of its own, the run and
# the monitor's drain bounded in time; (b) the lying client that the monitor aborts
# (tests/test_online.py's case); (c) the CLI's test and analyze as
# processes; (d) the profiled run (:func:`runner_profiled`).
RUNNER = {"ops": 10_000, "concurrency": 10, "lost_reply_at": 20, "lie_at": 40,
          "lie_ops": 1500, "cli_time_limit": 5, "cli_rate": 200, "busy_run_s": 10,
          "busy_finish_s": 5}
RUNNER_FILES = ("history.edn", "results.edn", "online.json", "metrics.jsonl", "spans.jsonl")
# (d) the profiled run: its size, the pages it reads, and the kernels of each
# level wrapper as a trace names them (csrc/wgl_level.cu).
RUNNER_PROFILED = {"ops": 2_000, "top_kernels": 8}
PROFILED_PAGES = ("/profile", "/utilization", "/runs", "/online")
KERNEL_SYMBOLS = {"wgl_chunk_init": ("k_chunk_init",), "wgl_expand": ("k_expand",),
                  "wgl_stage1_hash": ("k_stage1",),
                  "wgl_take_col_sort": ("k_sort_cta", "k_sort_upsweep"),
                  "radix_sort_pairs": ("k_sort_cta", "k_sort_upsweep"),
                  "wgl_prune": ("k_prune",), "wgl_gather_finalize": ("k_gather_finalize",),
                  "wgl_regroup": ("k_regroup",)}
# The wrappers that launch exactly one kernel a call: the trace's count of
# that kernel against the launches made while the profiler ran, the
# monitor's worker thread's and the analysis's.
ONE_KERNEL = ("wgl_chunk_init", "wgl_expand", "wgl_stage1_hash", "wgl_prune",
              "wgl_gather_finalize", "wgl_regroup")


class FirstBatchRound:
    """While installed, records the first batched chunk a path runs (its
    geometry, tables, a copy of its starting frontier, members and model),
    so that one level of it can be captured afterwards (:meth:`level_work`),
    as :class:`FirstChunk` does for a single search."""

    def __init__(self, lv):
        self.lv = lv
        self.seen = None

    def __enter__(self):
        self.orig = orig = self.lv.run_chunk_batch

        def run_chunk_batch(ops, g, tabs, fr, ws, lvl0, *a, **kw):
            if self.seen is None:
                self.seen = (g, tabs, tuple(x.clone() for x in fr), len(lvl0), a[-1])
            return orig(ops, g, tabs, fr, ws, lvl0, *a, **kw)

        self.lv.run_chunk_batch = run_chunk_batch
        return self

    def __exit__(self, *exc):
        self.lv.run_chunk_batch = self.orig

    def level_work(self) -> dict:
        from jepsen_tpu_torch.testing import device_work

        lv = self.lv
        g, tabs, fr, nb, model = self.seen
        ws = lv.BatchWorkspace(g, nb, fr[0].device)
        before = dict(lv.LAUNCHES)
        lv._LevelProgram(g, tabs, fr, ws, model)()
        work = device_work(lambda: lv._LevelProgram(g, tabs, fr, ws, model)())
        lv.LAUNCHES.update(before)
        return dict(work, F=g.F, members=nb, two_stage=g.two_stage)


def lost_reply_client(AtomClient, state):
    """The atom register's client (1 ms a call), the ``lost_reply_at``-th
    reply of which is lost: the write took effect, the worker sees an
    exception and the op stays ``:info``, as a real client's timeout."""

    class LostReply(AtomClient):
        def __init__(self):
            super().__init__(state)
            self.n, self.lock = 0, threading.Lock()

        def invoke(self, test, op):
            res = super().invoke(test, op)
            with self.lock:
                self.n += 1
                lost = self.n == RUNNER["lost_reply_at"]
            if lost:
                raise TimeoutError("reply lost")
            return res

    return LostReply()


def runner_generator(gen, n):
    """The demo suite's cas-register mix (write, cas, read over 5 values),
    n ops across the clients."""
    return gen.clients(gen.limit(n, gen.mix([
        lambda: {"f": "write", "value": gen.rand_int(5)},
        lambda: {"f": "cas", "value": [gen.rand_int(5), gen.rand_int(5)]},
        lambda: {"f": "read"}])))


def runner_busy_child(store_root: str) -> None:
    """Case (a') of the runner phase, in a process of its own: the
    ``core.run`` of case (a) with every reply delivered. Ten workers with no
    think time rarely quiesce, so a closed segment can run to thousands of
    ops, decided by the host enumerator on the monitor's worker thread.
    While it enumerates it holds the GIL for the interpreter's 20 ms switch
    interval each time a client thread lets go of it, so the run is cut at
    ``busy_run_s`` (``time_limit`` around case (a)'s generator), and
    ``online.finish`` waits at most ``busy_finish_s`` (its own default is
    300 s); what is undecided then folds ``unknown``. The worker thread
    goes on enumerating after that, so the run's checker here is ``stats``
    alone and the caller decides the stored history on the card; the
    process ends without joining the thread, which is why it is a
    process. Prints one JSON line: the phase walls, the segments submitted
    (ops, terminal), those decided by engine and those left undecided at
    the bound, the online verdict, the run's directory and peak RSS."""
    import collections
    import faulthandler
    import json
    import os
    import resource

    from jepsen_tpu_torch import core, store
    from jepsen_tpu_torch import checker as jchecker
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch import online as jonline
    from jepsen_tpu_torch.models import CasRegister
    from jepsen_tpu_torch.workloads import AtomClient, AtomDB, AtomState, noop_test

    finish, of_test = jonline.OnlineMonitor.finish, jonline.of_test
    submitted: list = []

    def bounded_finish(self, timeout=None):
        return finish(self, timeout=RUNNER["busy_finish_s"])

    def recording_of_test(t):
        mon = of_test(t)
        submit = mon.scheduler.submit

        def record(segments, *a, **kw):
            submitted.extend((seg.n_ops, seg.terminal) for seg in segments)
            return submit(segments, *a, **kw)

        mon.scheduler.submit = record
        return mon

    jonline.OnlineMonitor.finish = bounded_finish
    jonline.of_test = recording_of_test
    # a hang shows as every thread's stack on stderr, not as the caller's timeout
    faulthandler.dump_traceback_later(
        RUNNER["busy_run_s"] + RUNNER["busy_finish_s"] + 90, exit=True)
    model = CasRegister(init=0)
    state = AtomState()
    test = dict(noop_test())
    test.update(
        name="cas-register-busy", db=AtomDB(state), model=model, client=AtomClient(state),
        concurrency=RUNNER["concurrency"], checker=jchecker.stats(),
        generator=gen.time_limit(RUNNER["busy_run_s"], runner_generator(gen, RUNNER["ops"])),
        **{"online?": True, "online-engine": "device", "telemetry?": True,
           "store-root": store_root})
    res = core.run(test)
    fin, reg = res["online-results"], res["telemetry-registry"]
    print(json.dumps({
        "history": len(res["history"]),
        "phase_walls_s": {s["labels"]["phase"]: s["value"] for s in reg.collect()
                          if s["name"] == "run_phase_seconds"},
        "submitted": [n for n, terminal in submitted if not terminal],
        "terminal": [n for n, terminal in submitted if terminal],
        "decided_by_engine": dict(collections.Counter(
            row["engine"] for row in fin["segments"])),
        "undecided_at_bound": len(submitted) - len(fin["segments"]),
        "device_rounds": len([e for e in reg.events("online_round")
                              if e.get("engine") == "device" and e.get("oracle_members")]),
        "online_valid": fin["valid"], "decided_through_index": fin["decided_through_index"],
        "run_dir": store.path(res).name,
        "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024},
        default=str), flush=True)
    # the monitor's worker may still be enumerating: end here, not at its join
    os._exit(0)


def runner_phase(lv, wgl) -> dict:
    """(a) ``core.run`` of 10,000 cas-register ops over 10 workers against
    the atom register (1 ms a call), ``online-engine device``, telemetry on,
    the composed checker on the card. One client reply, the 20th, is lost
    (the write took effect; the worker sees an exception and the op stays
    ``:info``), as a real client's timeout is: the :info poisons quiescence,
    so the rest of the run is one open tail that the monitor's device
    oracle decides, where a run that ends quiescent is decided by the host
    enumerator alone. Launches counted for the monitor's rounds and for the
    analysis, each path from counts set to 0 just before it, and one level
    of each captured. Both verdicts True and equal to the C engine's on the
    stored history. (a') the same run with every reply delivered
    (:func:`runner_busy_child`, a process of its own): the run bounded at
    ``busy_run_s`` and the monitor's drain at ``busy_finish_s``, its online verdict True or unknown, never
    False, the stored history decided on the card here True and equal to
    the C engine's; the segments the host enumerator decided, and those
    it left.
    (b) the lying client aborted by the monitor (device engine): aborted,
    False, detected, the generator not drained, the post-hoc analysis on
    the card False. (c) ``python -m jepsen_tpu_torch test`` then
    ``analyze`` as processes: exit 0 and 0, one verdict, decided on the
    card by both. (d) the profiled run (:func:`runner_profiled`)."""
    import json
    import os
    import tempfile
    from pathlib import Path

    import torch

    from jepsen_tpu_torch import _build, core, store
    from jepsen_tpu_torch import checker as jchecker
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.edn import K, read_string
    from jepsen_tpu_torch.models import CasRegister
    from jepsen_tpu_torch.parallel import resilience
    from jepsen_tpu_torch.workloads import AtomClient, AtomDB, AtomState, noop_test

    resilience.reset_breakers()
    model = CasRegister(init=0)
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        tmp = Path(tmp)

        # -- (a) ------------------------------------------------------------
        counted: dict = {}
        firsts = {"online": FirstBatchRound(lv), "analyze": FirstChunk(wgl)}
        composed = jchecker.compose({"linear": jchecker.linearizable(model=model),
                                     "stats": jchecker.stats()})

        def analysis(test, history, opts):
            # the monitor is finished: its rounds' counts, then the analysis's
            firsts["online"].__exit__(None, None, None)
            counted["online"] = launch_counts(lv, "runner_online", LEVEL_KERNELS)
            reset_counts(lv)
            with firsts["analyze"]:
                res = composed.check(test, history, opts)
            torch.cuda.synchronize()
            counted["analyze"] = launch_counts(lv, "runner_analyze")
            return res

        state = AtomState()
        test = dict(noop_test())
        test.update(
            name="cas-register", db=AtomDB(state), model=model,
            client=lost_reply_client(AtomClient, state),
            concurrency=RUNNER["concurrency"], checker=jchecker.checker_fn(analysis),
            generator=runner_generator(gen, RUNNER["ops"]),
            **{"online?": True, "online-engine": "device", "telemetry?": True,
               "store-root": str(tmp / "a")})
        reset_counts(lv)
        t = time.perf_counter()
        with firsts["online"]:
            res = core.run(test)
        wall = time.perf_counter() - t
        reg, fin = res["telemetry-registry"], res["online-results"]
        phases = {s["labels"]["phase"]: s["value"] for s in reg.collect()
                  if s["name"] == "run_phase_seconds"}
        rounds = [e for e in reg.events("online_round")
                  if e.get("engine") == "device" and e.get("oracle_members")]
        run_dir = store.path(res)
        stored = store.load_history(res["name"], res["start-time"], root=tmp / "a")
        native = wgl.check_history(model, stored, backend="native")
        files = sorted(p.name for p in run_dir.iterdir())
        ledger = (tmp / "a" / "ledger.jsonl").exists()
        row = {"phase": "runner", "case": "core_run", "ops": RUNNER["ops"],
               "concurrency": RUNNER["concurrency"], "history": len(res["history"]),
               "wall_s": wall, "phase_walls_s": phases,
               "valid": res["results"]["valid"], "online_valid": fin["valid"],
               "native_valid": native["valid"], "linear_device": res["results"]["linear"].get(
                   "torch_device"),
               "segments_decided": fin["segments_decided"],
               "decided_through_index": fin["decided_through_index"],
               "p99_decision_latency_s": fin["decision_latency"].get("p99_s"),
               "device_rounds": [{"members": e["members"], "oracle_members": e["oracle_members"],
                                  "segments": e.get("segments")} for e in rounds],
               "launches_online": counted["online"], "launches_analyze": counted["analyze"],
               "online_level_work": firsts["online"].level_work(),
               "analyze_level_work": firsts["analyze"].level_work(lv),
               "store_files": files, "ledger": ledger}
        emit(row)
        if not (row["valid"] is True and row["online_valid"] is True
                and row["native_valid"] is True and rounds and ledger
                and row["history"] == 2 * RUNNER["ops"]
                and set(RUNNER_FILES) <= set(files) and row["linear_device"] == "cuda"):
            raise AssertionError(f"runner core_run failed: {row}")
        out["core_run"] = {"online": counted["online"], "analyze": counted["analyze"]}

        # -- (a') -----------------------------------------------------------
        root = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root), os.environ.get("PYTHONPATH", "")]))
        t = time.perf_counter()
        with open(tmp / "busy.err", "w") as err:
            p = subprocess.run(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.runner_busy_child(sys.argv[1])", str(tmp / "busy")],
                cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=err, text=True,
                timeout=RUNNER["busy_run_s"] + RUNNER["busy_finish_s"] + 120)
        wall = time.perf_counter() - t
        if p.returncode != 0:
            raise AssertionError(f"runner busy exited {p.returncode}: "
                                 f"{(tmp / 'busy.err').read_text()[-6000:]}")
        busy = json.loads(p.stdout.strip().splitlines()[-1])
        stored = store.load_history("cas-register-busy", busy["run_dir"], root=tmp / "busy")
        t = time.perf_counter()
        linear = jchecker.linearizable(model=model).check({}, stored, {})
        torch.cuda.synchronize()
        analyze_s = time.perf_counter() - t
        closed = busy["submitted"]
        row = {"phase": "runner", "case": "busy", "ops": RUNNER["ops"],
               "run_bound_s": RUNNER["busy_run_s"], "finish_bound_s": RUNNER["busy_finish_s"],
               "process_wall_s": wall, "ops_completed": busy["history"] // 2,
               **busy, "submitted": len(closed), "submitted_ops": sum(closed),
               "largest_closed": max(closed, default=0),
               "enumerator_share": busy["decided_by_engine"].get("host", 0)
               / max(1, len(closed)),
               "valid": linear["valid"], "analyze_s": analyze_s,
               "linear_device": linear.get("torch_device"),
               "native_valid": wgl.check_history(model, stored, backend="native")["valid"]}
        emit(row)
        if not (row["valid"] is True and row["native_valid"] is True
                and row["online_valid"] in (True, "unknown")
                and 0 < row["history"] <= 2 * RUNNER["ops"] and row["history"] % 2 == 0
                and row["linear_device"] == "cuda"):
            raise AssertionError(f"runner busy failed: {row}")

        # -- (b) ------------------------------------------------------------
        lie_state, seen = AtomState(), {"n": 0}

        class LyingClient(AtomClient):
            """tests/test_online.py's liar: from the 40th call on, a read
            answers 93, a value nobody wrote."""

            def invoke(self, test, op):
                res = super().invoke(test, op)
                seen["n"] += 1
                if op.get("f") == "read" and seen["n"] >= RUNNER["lie_at"] \
                        and res.get("value") != 93:
                    return {**res, "value": 93}
                return res

        lie = dict(noop_test())
        lie.update(
            name="online-abort", model=model, db=AtomDB(lie_state),
            client=LyingClient(lie_state, latency=0.001), concurrency=2,
            checker=jchecker.linearizable(model=model),
            generator=gen.clients(gen.stagger(0.008, gen.limit(RUNNER["lie_ops"], gen.mix([
                lambda: {"f": "read"},
                lambda: {"f": "write", "value": gen.rand_int(5)}])))),
            **{"no-store?": True, "online?": True, "online-abort?": True,
               "online-engine": "device"})
        t = time.perf_counter()
        lres = core.run(lie)
        lfin = lres["online-results"]
        row = {"phase": "runner", "case": "lying_client", "wall_s": time.perf_counter() - t,
               "aborted": lfin["aborted"], "online_valid": lfin["valid"],
               "ops_to_detection": lfin.get("ops_to_detection"),
               "seconds_to_detection": lfin.get("seconds_to_detection"),
               "history": len(lres["history"]), "generator_ops": RUNNER["lie_ops"],
               "valid": lres["results"]["valid"],
               "linear_device": lres["results"].get("torch_device")}
        emit(row)
        if not (row["aborted"] is True and row["online_valid"] is False
                and (row["ops_to_detection"] or 0) > 0
                and row["history"] < RUNNER["lie_ops"] and row["valid"] is False
                and row["linear_device"] == "cuda"):
            raise AssertionError(f"runner lying_client failed: {row}")

        # -- (c) ------------------------------------------------------------
        cmd = [sys.executable, "-m", "jepsen_tpu_torch"]
        common = ["--workload", "cas-register", "--store-root", str(tmp / "c")]
        runs = {"test": [*cmd, "test", *common, "--time-limit", str(RUNNER["cli_time_limit"]),
                         "--rate", str(RUNNER["cli_rate"]), "--no-ssh", "--online",
                         "--online-engine", "device", "--telemetry"],
                "analyze": [*cmd, "analyze", *common]}
        cli: dict = {}
        for name, argv in runs.items():
            t = time.perf_counter()
            p = subprocess.run(argv, cwd=tmp, env=env, capture_output=True, text=True,
                               timeout=300)
            cli[name] = {"rc": p.returncode, "wall_s": time.perf_counter() - t}
            if p.returncode != 0:
                raise AssertionError(f"runner cli {name} exited {p.returncode}: "
                                     f"{p.stderr[-3000:]}")
            (results,) = (tmp / "c").glob("cas-register/2*/results.edn")
            results = read_string(results.read_text())
            cli[name]["valid"] = results[K("valid?")]
            cli[name]["linear_device"] = results[K("linear")][K("torch_device")]
        online = json.loads(next((tmp / "c").glob("cas-register/2*/online.json")).read_text())
        row = {"phase": "runner", "case": "cli", **cli, "online_valid": online["valid"]}
        emit(row)
        if not (cli["test"]["rc"] == 0 and cli["analyze"]["rc"] == 0
                and cli["test"]["valid"] is cli["analyze"]["valid"] is True
                and cli["test"]["linear_device"] == cli["analyze"]["linear_device"] == "cuda"
                and online["valid"] is True):
            raise AssertionError(f"runner cli failed: {row}")

        # -- (d) ------------------------------------------------------------
        out["profiled"] = runner_profiled(lv, tmp / "d", env)
    return out


# The multi-tenant service phase: (a) bench.py's service leg (four tenants,
# seeds 3100 + i, quiescence poisoned from 90% of the stream on) on the card,
# the last tenant perturbed in its first half; (b) the daemon as a process,
# two tenants of ``http_ops`` over HTTP (one as an etcd recording).
SERVICE = {"tenants": 4, "ops": 2500, "seed": 3100, "procs": 4, "chunk_ops": 60,
           "poison_at": 0.9, "perturbed": 3, "http_ops": 600, "wait_s": 120}


def service_history(History, chunked, i, n_ops, seed=SERVICE["seed"], **kw):
    """Tenant ``i``'s stream: a chunked register history whose first ok
    write from ``poison_at`` of the stream on turns ``:info`` (a write that
    took effect with its reply lost): no quiescent cut follows it, so the
    rest is one terminal segment, which the device oracle decides. ``kw``
    goes to the generator (``cas=False`` for an etcd recording: its adapter
    maps puts and ranges)."""
    base = list(chunked(random.Random(seed + i), n_ops=n_ops, n_procs=SERVICE["procs"],
                        chunk_ops=SERVICE["chunk_ops"], **kw))
    k = next(j for j in range(int(len(base) * SERVICE["poison_at"]), len(base))
             if base[j].is_ok and base[j].f == "write")
    base[k] = base[k].with_(type="info")
    return History(base, reindex=True)


def _wait_port(proc, port_file, err_path, timeout) -> int:
    """The daemon's bound port, once it has written it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"service daemon exited {proc.returncode}: "
                                 f"{err_path.read_text()[-4000:]}")
        try:
            return int(port_file.read_text())
        except (OSError, ValueError):
            time.sleep(0.05)
    raise AssertionError(f"service daemon wrote no port in {timeout} s")


def _http(url, data=None):
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=SERVICE["wait_s"]) as r:
        return json.loads(r.read().decode())


def _interrupt(proc, out_path, timeout) -> tuple:
    """SIGINT the daemon (it drains and prints its results document) and
    read that document back."""
    import signal

    proc.send_signal(signal.SIGINT)
    rc = proc.wait(timeout=timeout)
    text = out_path.read_text()
    return rc, json.loads(text[text.index("\n{") + 1:]) if "\n{" in text else None


def service_phase(lv, wgl, dev="cuda") -> dict:
    """(a) The service in process on the card, (b) the daemon as two
    processes over one journal directory (see the module docstring)."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from jepsen_tpu_torch import _build, independent
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.ingest import ingest_check
    from jepsen_tpu_torch.models import CasRegister
    from jepsen_tpu_torch.parallel import resilience
    from jepsen_tpu_torch.service import Service
    from jepsen_tpu_torch.service.client import HttpServiceClient, InProcessServiceClient
    from jepsen_tpu_torch.telemetry import Registry
    from jepsen_tpu_torch.testing import chunked_register_history, perturb_history

    resilience.reset_breakers()
    model = CasRegister(init=0)
    wait = SERVICE["wait_s"]
    hs = {}
    for i in range(SERVICE["tenants"]):
        h = service_history(History, chunked_register_history, i, SERVICE["ops"])
        if i == SERVICE["perturbed"]:
            h = perturb_history(random.Random(SERVICE["seed"] + 1000 + i), h, within=0.5)
        hs[f"tenant-{i}"] = h
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        tmp = Path(tmp)

        # -- (a) ------------------------------------------------------------
        reg = Registry()
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counts(lv)
        t = time.perf_counter()
        svc = Service(model, engine="device", abort_on_violation=True, alerts=True,
                      metrics=reg, device=dev, store_root=str(tmp / "a"),
                      name="smoke-service")
        reports: dict = {}

        def feed(name):
            reports[name] = InProcessServiceClient(svc, name).feed(hs[name])

        feeders = [threading.Thread(target=feed, args=(n,)) for n in hs]
        for th in feeders:
            th.start()
        for th in feeders:
            th.join(wait)
        if any(th.is_alive() for th in feeders) or not svc.flush(wait):
            raise AssertionError("service: the feeds did not settle")
        fin = svc.drain(timeout=wait)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts(lv, "service", LEVEL_KERNELS)
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
        rounds = [e for e in reg.events("online_round")
                  if e.get("engine") == "device" and e.get("oracle_members")]
        chunks = reg.events("wgl_batch_chunk")
        single = {n: wgl.check_history(model, h, backend="device", device=dev)["valid"]
                  for n, h in hs.items()}
        fired = sorted(svc.alert_engine.fired_rules())
        ops = sum(r["ops_observed"] for r in fin["tenants"].values())
        row = {"phase": "service", "case": "in_process", "tenants": len(hs),
               "ops_per_tenant": SERVICE["ops"], "wall_s": wall, "ops_observed": ops,
               "ops_per_s": ops / wall, "valid": fin["valid"],
               "tenant_valid": {n: r["valid"] for n, r in fin["tenants"].items()},
               "single_device_valid": single,
               "aborted": {n: r["aborted"] for n, r in fin["tenants"].items()},
               "decided_through_index": {n: r["decided_through_index"]
                                         for n, r in fin["tenants"].items()},
               "p99_decision_latency_s": fin["decision_latency"].get("p99_s"),
               "p50_decision_latency_s": fin["decision_latency"].get("p50_s"),
               "peak_allocated_bytes": peak,
               "failover": {n: r["failover"] for n, r in fin["tenants"].items()
                            if r.get("failover")},
               "device_rounds": [{"oracle_members": e["oracle_members"],
                                  "oracle_streams": e["oracle_streams"]} for e in rounds],
               "batch_chunks": len(chunks), "max_chunk_batch": max(
                   (e["batch"] for e in chunks), default=0),
               # the batched search's chunks (host clock around each, ending
               # in its control-block read): the rest of the wall is host work
               "batch_chunk_wall_s": sum(e["chunk_wall_s"] for e in chunks),
               "alerts_fired": fired, "client_errors": {n: r["error"]
                                                        for n, r in reports.items()},
               "launches": counts}
        emit(row)
        bad = f"tenant-{SERVICE['perturbed']}"
        if not (row["tenant_valid"] == single and single[bad] is False
                and all(v is True for n, v in single.items() if n != bad)
                and row["aborted"] == {n: n == bad for n in hs}
                and any(len(e["oracle_streams"]) >= 2 for e in rounds)
                and row["max_chunk_batch"] >= 2
                and "unattributed_causes" not in fired
                and all(row["decided_through_index"][n] == hs[n][-1].index
                        for n in hs if n != bad)):
            raise AssertionError(f"service in_process failed: {row}")
        out["launches"] = counts

        # -- (b) ------------------------------------------------------------
        root = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root), os.environ.get("PYTHONPATH", "")]))
        jdir = tmp / "journal"
        n_http = SERVICE["http_ops"]
        ha = service_history(History, chunked_register_history, 10, n_http)
        hb = service_history(History, chunked_register_history, 11, n_http, cas=False)
        hb = History([op.with_(value=independent.KV("r0", op.value)) for op in hb],
                     reindex=True)
        lines = etcd_lines(hb)
        want_b = ingest_check(lines, "etcd", device=dev)["valid"]
        want_a = wgl.check_history(model, ha, backend="device", device=dev)["valid"]

        def start(tag):
            port_file = tmp / f"{tag}.port"
            cmd = [sys.executable, "-m", "jepsen_tpu_torch.service", "--port", "0",
                   "--port-file", str(port_file), "--journal-dir", str(jdir),
                   "--engine", "device", "--store-root", str(tmp / "b"), "--name", "smoke-daemon",
                   *(["--device", dev] if dev != "cuda" else [])]
            o, e = tmp / f"{tag}.out", tmp / f"{tag}.err"
            with open(o, "w") as fo, open(e, "w") as fe:
                proc = subprocess.Popen(cmd, cwd=tmp, env=env, stdout=fo, stderr=fe)
            return proc, o, e, port_file

        procs = []
        try:
            t = time.perf_counter()
            proc, o, e, pf = start("first")
            procs.append(proc)
            url = f"http://127.0.0.1:{_wait_port(proc, pf, e, wait)}"
            ready_s = time.perf_counter() - t
            rep = HttpServiceClient(url, "http-a", timeout_s=wait).feed(ha)
            ing = _http(f"{url}/submit/http-b?adapter=etcd", ("\n".join(lines) + "\n").encode())
            tenants = _http(f"{url}/tenants")["tenants"]
            drained = _http(f"{url}/drain", b"")
            rc, printed = _interrupt(proc, o, wait)
            first_s = time.perf_counter() - t
            t = time.perf_counter()
            proc2, o2, e2, pf2 = start("restart")
            procs.append(proc2)
            url2 = f"http://127.0.0.1:{_wait_port(proc2, pf2, e2, wait)}"
            resumed = _http(f"{url2}/tenants")["tenants"]
            rc2, printed2 = _interrupt(proc2, o2, wait)
            restart_s = time.perf_counter() - t
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(30)
        dt = drained["tenants"]
        row = {"phase": "service", "case": "daemon", "ready_s": ready_s, "first_s": first_s,
               "restart_s": restart_s, "client": rep, "adapter": {
                   k: ing.get(k) for k in ("accepted", "unmapped", "hint")},
               "tenants_rows": sorted(tenants), "drain_valid": {
                   n: r["valid"] for n, r in dt.items()},
               "want": {"http-a": want_a, "http-b": want_b}, "rc": rc, "rc_restart": rc2,
               "printed_valid": (printed or {}).get("valid"),
               "watermarks": {n: r["decided_through_index"] for n, r in dt.items()},
               "resumed": {n: {"watermark": r.get("watermark"),
                               "resumed_from_journal": r.get("resumed_from_journal")}
                           for n, r in resumed.items()},
               "restart_valid": (printed2 or {}).get("valid")}
        emit(row)
        if not (rc == 0 and rep["error"] is None and rep["sent"] == len(ha)
                and ing.get("unmapped") == 0 and sorted(tenants) == ["http-a", "http-b"]
                and row["drain_valid"] == row["want"] and want_a is True and want_b is True
                and row["printed_valid"] is True
                and row["watermarks"]["http-a"] == ha[-1].index
                and all(row["resumed"][n]["resumed_from_journal"] is not None
                        and row["resumed"][n]["watermark"] == row["watermarks"][n]
                        and row["resumed"][n]["resumed_from_journal"]["watermark"]
                        == row["watermarks"][n] for n in dt)
                and rc2 in (0, 2)):
            raise AssertionError(f"service daemon failed: {row}")
    return out


ROUTER = {"backends": 2, "tenants": 4, "ops": 1250, "seed": 4200, "client_chunk": 64,
          "kill_at": 0.25, "probe_s": 0.1, "cli_ops": 600, "cli_seed": 4300, "wait_s": 180,
          "context_mib": 256}


def _smi_used_mib():
    """The card's used memory (MiB) as ``nvidia-smi`` reads it: every
    process's CUDA context and allocations, this process creating none."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    return float(out.stdout.strip().splitlines()[0]) if out.returncode == 0 else None


def router_histories(History, chunked):
    """bench.py's ``service_router`` tenants (``Random(4200 + i)``, 1,250
    ops, 4 processes, chunks of 60), each tail poisoned as the service
    phase's (``service_history``): without it every segment ends at a cut
    and the host enumerator decides them all, so no round would reach a
    backend's card."""
    return {f"tenant-{i}": service_history(History, chunked, i, ROUTER["ops"],
                                           seed=ROUTER["seed"])
            for i in range(ROUTER["tenants"])}


def router_fleet(out_path: str, dev: str) -> None:
    """Case (a) of the ``router`` phase, in a process of its own (the
    router's): bench.py's ``service_router`` leg with ``engine="device"``.
    Two spawned backends, four tenants over HTTP, one backend SIGKILLed by
    the ``backend.process`` seam at 25% of the rows; once the respawn and
    the re-adoption settle, each backend is drained (its tails decided on
    its card) and scraped once more, then the router drains. Writes its
    result to ``out_path``: nothing here touches the card."""
    import os
    import tempfile
    import urllib.request

    import torch

    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.service import router as jrouter
    from jepsen_tpu_torch.service.client import HttpServiceClient
    from jepsen_tpu_torch.telemetry import Registry
    from jepsen_tpu_torch.telemetry import alerts as jalerts
    from jepsen_tpu_torch.testing import chaos, chunked_register_history

    wait = ROUTER["wait_s"]
    hs = router_histories(History, chunked_register_history)
    total = sum(len(h) for h in hs.values())
    used0 = _smi_used_mib() if dev == "cuda" else None
    rreg = Registry()
    tmpd = tempfile.mkdtemp(prefix="router-fleet-", dir=os.path.dirname(out_path))
    t_spawn = time.perf_counter()
    backends = jrouter.spawn_backends(ROUTER["backends"], journal_root=tmpd, engine="device",
                                      metrics=rreg, failure_threshold=2, cooldown_s=60.0,
                                      device=None if dev == "cuda" else dev)
    spawn_s = time.perf_counter() - t_spawn
    cmdlines = [list(b.respawner.cmd) for b in backends]
    router = jrouter.Router(backends, metrics=rreg, name="smoke-router", register_live=False,
                            probe_interval_s=ROUTER["probe_s"], failure_threshold=2,
                            migrate_retry_after_s=0.1, rebalance=False, alerts=True)
    rsrv = jrouter.server(router, port=0)
    threading.Thread(target=rsrv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{rsrv.server_address[1]}"
    reports: dict = {}

    def feed(name):
        reports[name] = HttpServiceClient(url, name, chunk_ops=ROUTER["client_chunk"],
                                          max_retries=200, max_backoff_s=0.25).feed(hs[name])

    try:
        t0 = time.perf_counter()
        feeders = [threading.Thread(target=feed, args=(n,)) for n in hs]
        for th in feeders:
            th.start()
        arm_by = time.monotonic() + wait
        while time.monotonic() < arm_by:
            snap = router.tenants_snapshot()
            if sum((r or {}).get("ops_observed") or 0
                   for r in snap["tenants"].values()) >= total * ROUTER["kill_at"]:
                break
            time.sleep(0.05)
        with chaos.inject("backend.process", on_call=1):
            kill_by = time.monotonic() + 30
            while chaos.fired("backend.process") == 0 and time.monotonic() < kill_by:
                time.sleep(0.05)
        for th in feeders:
            th.join(wait)

        def settled():
            st = router.stats()
            fl = st["fleet"]
            down = {b.name for b in backends if b.down}
            return (fl["respawns"] >= 1 and fl["live_backends"] == fl["configured_backends"]
                    and all(b not in down or t in st["orphaned"]
                            for t, b in st["placement"].items()))

        settle_by = time.monotonic() + wait
        while time.monotonic() < settle_by and not settled():
            time.sleep(0.05)
        feed_s = time.perf_counter() - t0
        # The resume contract: a migration (lost, then re-adopted) hands
        # over the journal through its last cut, and the ops above it come
        # back only from the client. Every client resumes from its
        # tenant's journaled watermark, inclusive; the backends drop what
        # they already cover (resubmitted_ops_dropped).
        resumed: dict = {}

        def resume(name):
            rows = list(hs[name])
            wm = (router.tenants_snapshot()["tenants"].get(name) or {}).get("watermark")
            start = (next((k for k, op in enumerate(rows) if op.index >= wm), len(rows))
                     if isinstance(wm, int) and wm >= 0 else 0)
            resumed[name] = HttpServiceClient(url, name, chunk_ops=ROUTER["client_chunk"],
                                              max_retries=200,
                                              max_backoff_s=0.25).feed(rows[start:])

        resumers = [threading.Thread(target=resume, args=(n,)) for n in hs]
        for th in resumers:
            th.start()
        for th in resumers:
            th.join(wait)
        # Each backend decides its tenants' tails on its card now; the
        # router's next scrape carries the rounds into the federation.
        fed = router.federation
        t1 = time.perf_counter()
        for b in backends:
            req = urllib.request.Request(b.url + "/drain", data=b"", method="POST")
            with urllib.request.urlopen(req, timeout=wait) as r:
                r.read()
        # two scrapes after the last drain: the first may have started before it
        before = {b.name: (fed.meta().get(b.name) or {}).get("scrapes", 0) for b in backends}
        scrape_by = time.monotonic() + 30
        while time.monotonic() < scrape_by and not all(
                (fed.meta().get(n) or {}).get("scrapes", 0) >= k + 2 for n, k in before.items()):
            time.sleep(0.05)
        tails_s = time.perf_counter() - t1
        used1 = _smi_used_mib() if dev == "cuda" else None
        events = {b.name: fed.events(b.name) for b in backends}
        fin = router.drain(timeout=wait)
        wall = time.perf_counter() - t0
    finally:
        router.close()
        rsrv.shutdown()
        rsrv.server_close()
    st = router.stats()
    mig = [m for m in st["migrations"] if m.get("ok")]
    rounds = {n: [e for e in ev if e.get("name") == "online_round"] for n, ev in events.items()}
    chunks = {n: [e for e in ev if e.get("name") == "wgl_batch_chunk"] for n, ev in events.items()}
    fired = sorted(router.alert_engine.fired_rules())
    out = {
        "backends": ROUTER["backends"], "tenants": len(hs), "n_ops_total": total,
        "spawn_s": spawn_s, "feed_and_settle_s": feed_s, "tails_s": tails_s, "wall_s": wall,
        "ops_per_s": total / wall, "p99_decision_latency_s": fin.get("p99_decision_latency_s"),
        "fleet_p99_decision_latency_s": fin.get("fleet_p99_decision_latency_s"),
        "verdicts": {n: (fin["tenants"].get(n) or {}).get("valid") for n in hs},
        "causes": {n: sorted((((fin["tenants"].get(n) or {}).get("provenance") or {})
                              .get("causes") or {})) for n in hs},
        "resubmitted_ops_dropped": sum((fin["tenants"].get(n) or {}).get(
            "resubmitted_ops_dropped") or 0 for n in hs),
        "client_errors": {n: r.get("error") for n, r in reports.items()},
        "resume_errors": {n: r.get("error") for n, r in resumed.items()},
        "resumed_ops": {n: r.get("ops") for n, r in resumed.items()},
        "client_retries": sum(r.get("retries", 0) for r in reports.values()),
        "chaos_kills": chaos.fired("backend.process"),
        "migrations": [(m["tenant"], m["reason"]) for m in mig],
        "router_migration_seconds": max((m["seconds"] for m in mig), default=None),
        "router_respawn_seconds": st["fleet"]["respawn_seconds"],
        "respawns": st["fleet"]["respawns"], "orphaned": sorted(st["orphaned"]),
        "device_rounds": {n: [{"oracle_members": e["oracle_members"],
                               "oracle_streams": e["oracle_streams"], "engine": e["engine"]}
                              for e in r if e.get("oracle_members")]
                          for n, r in rounds.items()},
        "rounds": {n: len(r) for n, r in rounds.items()},
        "batch_chunks": {n: [{"F": e["F"], "batch": e["batch"], "level_max": e["level_max"],
                              "chunk_wall_s": e["chunk_wall_s"], "stage": e["stage"]}
                             for e in c] for n, c in chunks.items()},
        "backend_cmdlines": cmdlines,
        "card_used_mib": [used0, used1],
        "alerts_fired": fired,
        "alerts_unexpected": sorted(set(fired) - jalerts.EXPECTED_ALERTS["backend.process"]),
        "router_cuda_initialized": torch.cuda.is_initialized(),
    }
    with open(out_path, "w") as f:
        json.dump(out, f, default=str)


def router_phase(lv, wgl, dev="cuda") -> dict:
    """The scale-out router on the card: (a) bench.py's ``service_router``
    leg in a router process of its own, (b) ``check_offline(backends=2)``
    beside ``backends=0`` and ``fanout_services``, (c) the CLI as
    processes (see the module docstring)."""
    import os
    import signal
    import tempfile
    from pathlib import Path

    import torch

    from jepsen_tpu_torch import _build, offline
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import CasRegister
    from jepsen_tpu_torch.parallel import resilience
    from jepsen_tpu_torch.service.client import HttpServiceClient
    from jepsen_tpu_torch.testing import chaos, chunked_register_history

    resilience.reset_breakers()
    model = CasRegister(init=0)
    wait = ROUTER["wait_s"]
    allowed = set(chaos.EXPECTED_UNKNOWN_CAUSES["backend.process"])
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root),
                                                       os.environ.get("PYTHONPATH", "")]))
    out: dict = {}
    lib_mtime = _build.LIB.stat().st_mtime_ns if _build.LIB.exists() else None
    with tempfile.TemporaryDirectory(dir=_build.BUILD) as tmp:
        tmp = Path(tmp)
        env["JEPSEN_LEDGER_PATH"] = str(tmp / "ledger.jsonl")

        # -- (a) ------------------------------------------------------------
        hs = router_histories(History, chunked_register_history)
        single = {n: wgl.check_history(model, h, backend="device", device=dev)["valid"]
                  for n, h in hs.items()}
        res_path = tmp / "fleet.json"
        t = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                              "chip_smoke.router_fleet(sys.argv[1], sys.argv[2])",
                              str(res_path), dev], cwd=tmp, env=env, capture_output=True,
                             text=True, timeout=4 * wait)
        case_s = time.perf_counter() - t
        if run.returncode != 0 or not res_path.exists():
            raise AssertionError(f"router fleet process failed ({run.returncode}): "
                                 f"{run.stderr[-4000:]}")
        a = json.loads(res_path.read_text())
        dev_rounds = [r for rs in a["device_rounds"].values() for r in rs]
        chunks = [c for cs in a["batch_chunks"].values() for c in cs]
        used = a["card_used_mib"]
        row = {"phase": "router", "case": "fleet", "case_s": case_s, **a,
               "single_device_valid": single,
               "context_mib_each": (None if used[0] is None or used[1] is None
                                    else (used[1] - used[0]) / ROUTER["backends"])}
        emit(row)
        ok_verdicts = all(a["verdicts"][n] == single[n] or (
            a["verdicts"][n] == "unknown" and a["causes"][n] and set(a["causes"][n]) <= allowed)
            for n in hs)
        if not (ok_verdicts and all(v is True for v in single.values())
                and not any(a["client_errors"].values()) and not any(a["resume_errors"].values())
                and a["resubmitted_ops_dropped"] > 0 and a["chaos_kills"] == 1
                and a["respawns"] >= 1 and a["router_migration_seconds"] is not None
                and a["router_respawn_seconds"] is not None
                and all(any(r["engine"] == "device" for r in rs)
                        for rs in a["device_rounds"].values()) and chunks
                and not a["router_cuda_initialized"] and not a["alerts_unexpected"]
                and all(c[c.index("--device") + 1] == ("cuda" if dev == "cuda" else dev)
                        for c in a["backend_cmdlines"])
                and (dev != "cuda" or (row["context_mib_each"] or 0) >= ROUTER["context_mib"])):
            raise AssertionError(f"router fleet failed: {row}")

        # -- (b) ------------------------------------------------------------
        h20 = offline_history(OFFLINE["seed"], OFFLINE["host_ops"])
        t = time.perf_counter()
        inproc = offline.check_offline(model, h20, streams=OFFLINE["streams"], engine="device",
                                       device=dev)
        inproc_s = time.perf_counter() - t
        t = time.perf_counter()
        fleet = offline.check_offline(model, h20, streams=OFFLINE["streams"], engine="device",
                                      backends=ROUTER["backends"],
                                      device=None if dev == "cuda" else dev, env=env,
                                      journal_root=str(tmp / "offline-fleet"))
        fleet_s = time.perf_counter() - t
        p = offline.plan(h20, streams=OFFLINE["streams"])
        reset_counts(lv)
        t = time.perf_counter()
        svcs = offline.fanout_services(p, model, backends=ROUTER["backends"], engine="device",
                                       device=None if dev == "cuda" else dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        svcs_s = time.perf_counter() - t
        counts = launch_counts(lv, "fanout", LEVEL_KERNELS)
        # what a tenant's row decides (its latencies, backpressure
        # rejections and detection point move with the feeder's speed)
        decides = ("valid", "aborted", "decided_through_index", "segments_decided",
                   "ops_observed", "ops_ingested", "provenance", "violation")
        rows = {k: {t: {f: r.get(f) for f in decides} for t, r in v["tenants"].items()}
                for k, v in (("fleet", fleet), ("services", svcs))}
        causes = {k: (r.get("provenance") or {}).get("causes")
                  for k, r in (("in_process", inproc), ("fleet", fleet), ("services", svcs))}
        diff = sorted({f for t in rows["fleet"] for f in decides
                       if rows["fleet"][t][f] != rows["services"].get(t, {}).get(f)})
        row = {"phase": "router", "case": "offline_fanout", "ops": len(h20),
               "valid": {"in_process": inproc["valid"], "fleet": fleet["valid"],
                         "services": svcs["valid"]},
               "causes": causes, "same_tenant_rows": rows["fleet"] == rows["services"],
               "differing_fields": diff,
               "tenant_valid": {t: r["valid"] for t, r in fleet["tenants"].items()},
               "stream_valid": {s: r["valid"] for s, r in inproc["streams"].items()},
               "wall_s": {"in_process": inproc_s, "fleet": fleet_s, "services": svcs_s},
               "fleet_feed_s": fleet.get("feed_s"),
               "fleet_p99_decision_latency_s": fleet.get("p99_decision_latency_s"),
               "fleet_utilization": (fleet.get("fleet") or {}).get("utilization"),
               "launches": counts}
        emit(row)
        if not (inproc["valid"] is fleet["valid"] is svcs["valid"] is True
                and causes["fleet"] == causes["in_process"] == causes["services"]
                and row["same_tenant_rows"]
                and row["tenant_valid"] == {f"offline-{s}": v
                                            for s, v in row["stream_valid"].items()}):
            raise AssertionError(f"router offline_fanout failed: {row}")
        out["launches"] = counts

        # -- (c) ------------------------------------------------------------
        hc = service_history(History, chunked_register_history, 0, ROUTER["cli_ops"],
                             seed=ROUTER["cli_seed"])
        want = wgl.check_history(model, hc, backend="device", device=dev)["valid"]
        pf, o, e = tmp / "router.port", tmp / "router.out", tmp / "router.err"
        cmd = [sys.executable, "-m", "jepsen_tpu_torch.service", "--router",
               "--router-backends", str(ROUTER["backends"]), "--journal-dir", str(tmp / "cli"),
               "--port", "0", "--port-file", str(pf), "--engine", "device",
               "--probe-interval", "0.2", "--name", "smoke-router-cli",
               *(["--device", dev] if dev != "cuda" else [])]
        t = time.perf_counter()
        with open(o, "w") as fo, open(e, "w") as fe:
            proc = subprocess.Popen(cmd, cwd=tmp, env=env, stdout=fo, stderr=fe)
        try:
            url = f"http://127.0.0.1:{_wait_port(proc, pf, e, wait)}"
            ready_s = time.perf_counter() - t
            half = len(hc) // 2
            rep1 = HttpServiceClient(url, "cli", timeout_s=wait).feed(list(hc)[:half])
            t_roll = time.perf_counter()
            roll = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.service", "--roll",
                                   url], cwd=tmp, env=env, capture_output=True, text=True,
                                  timeout=4 * wait)
            roll_s = time.perf_counter() - t_roll
            rdoc = json.loads(roll.stdout) if roll.stdout.strip().startswith("{") else {}
            # the rolled tenant resumes from its journaled watermark
            wm = _http(f"{url}/tenants")["tenants"]["cli"]["watermark"]
            rest = [op for op in hc if op.index >= wm] if isinstance(wm, int) and wm >= 0 \
                else list(hc)
            rep2 = HttpServiceClient(url, "cli", timeout_s=wait).feed(rest)
            t_int = time.perf_counter()
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=wait)
            drain_s = time.perf_counter() - t_int
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        text = o.read_text()
        printed = json.loads(text[text.index("\n{") + 1:]) if "\n{" in text else {}
        row = {"phase": "router", "case": "cli", "ops": len(hc), "ready_s": ready_s,
               "roll_s": roll_s, "drain_s": drain_s, "roll_rc": roll.returncode,
               "rolled": [{k: b.get(k) for k in ("backend", "seconds", "drained", "readopted",
                                                 "error", "skipped")}
                          for b in rdoc.get("backends", [])],
               "client_errors": [rep1["error"], rep2["error"]], "rc": rc,
               "valid": (printed.get("tenants", {}).get("cli") or {}).get("valid"),
               "want": want, "printed_valid": printed.get("valid")}
        emit(row)
        if not (roll.returncode == 0 and rdoc.get("ok") is True
                and len(row["rolled"]) == ROUTER["backends"]
                and all(b["seconds"] is not None and not b["error"] and not b["skipped"]
                        for b in row["rolled"])
                and row["client_errors"] == [None, None] and rc == 0
                and row["valid"] is want is True and row["printed_valid"] is True):
            raise AssertionError(f"router cli failed: {row}; {e.read_text()[-3000:]}")
    if lib_mtime is not None and _build.LIB.stat().st_mtime_ns != lib_mtime:
        raise AssertionError("a backend process built the kernel library again")
    return out


def trace_kernels(path) -> dict:
    """The kernels a Chrome trace of ``torch.profiler`` holds: device ms and
    launches by kernel name (the name up to its template or argument
    list), the runtime calls, and the torch ops of the CPU side."""
    import collections

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ms, count = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = re.sub(r"^void ", "", e["name"]).split("(")[0].split("<")[0]
        ms[name] += e.get("dur", 0) / 1000
        count[name] += 1
    cats = collections.Counter(e.get("cat") for e in events)
    return {"ms": dict(ms), "count": dict(count), "runtime_calls": cats["cuda_runtime"],
            "cpu_ops": cats["cpu_op"], "events": len(events)}


def runner_profiled(lv, root, env) -> dict:
    """Case (d) of the runner phase: case (a)'s ``core.run`` at 2,000 ops
    (10 workers, 1 ms a call, the 20th reply lost, so both the monitor's
    device oracle and the analysis reach the card) with ``telemetry?``,
    ``profile?`` and ``live-port`` on a free port. While the run executes a
    thread GETs ``/live`` until the monitor's line is there; afterwards a
    server over the store answers ``/profile``, ``/utilization``, ``/runs``
    and ``/online``. Fails unless both verdicts are True on the card,
    ``profile.json`` has executing device chunks, a mean utilization in
    (0, 100] and one watermark per card with a positive peak, the trace
    names the level kernels the analysis launched and holds the monitor's
    worker thread's beside them (a wrapper that launches one kernel a
    call is counted against the trace; launches CUPTI did not record are
    emitted as ``untraced_launches``), the ledger record has
    ``utilization_pct``, ``python -m jepsen_tpu_torch.ledger --check`` over
    the store exits 0 and every page answers 200. Emits the trace's size,
    its top kernels by device ms, and the analysis wall with the profiler
    beside ``core.analyze`` of the same stored history without it (twice),
    and with a trace around it."""
    import socket
    import urllib.request

    import torch

    from jepsen_tpu_torch import checker as jchecker
    from jepsen_tpu_torch import core, store, telemetry, web
    from jepsen_tpu_torch import generator as gen
    from jepsen_tpu_torch.models import CasRegister
    from jepsen_tpu_torch.telemetry import ledger, trace_capture
    from jepsen_tpu_torch.workloads import AtomClient, AtomDB, AtomState, noop_test

    t_case = time.perf_counter()
    model = CasRegister(init=0)
    composed = jchecker.compose({"linear": jchecker.linearizable(model=model),
                                 "stats": jchecker.stats()})
    counted: dict = {}

    def analysis(test, history, opts):
        # the monitor is finished: its rounds' counts, then the analysis's
        counted["online"] = dict(lv.LAUNCHES)
        res = composed.check(test, history, opts)
        torch.cuda.synchronize()
        counted["analyze"] = {k: v - counted["online"][k] for k, v in lv.LAUNCHES.items()}
        return res

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    name = "cas-register-profiled"
    state = AtomState()
    test = dict(noop_test())
    test.update(
        name=name, db=AtomDB(state), model=model, client=lost_reply_client(AtomClient, state),
        concurrency=RUNNER["concurrency"], checker=jchecker.checker_fn(analysis),
        generator=runner_generator(gen, RUNNER_PROFILED["ops"]),
        **{"online?": True, "online-engine": "device", "telemetry?": True, "profile?": True,
           "live-port": port, "store-root": str(root)})
    live: dict = {}
    stop = threading.Event()

    def poll():
        t0 = time.perf_counter()
        while not stop.is_set():
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/live", timeout=5) as r:
                    lines = [json.loads(x) for x in r.read().decode().splitlines()]
                mine = [x for x in lines if x.get("run") == name and x.get("ops_observed")]
                if mine:
                    live.update(mine[0], seen_after_s=time.perf_counter() - t0)
                    return
            except OSError:
                pass
            stop.wait(0.02)

    window: dict = {}

    @contextlib.contextmanager
    def counted_capture(outdir):
        # the launch counts while the profiler runs, whatever thread launches
        with trace_capture(outdir) as d:
            window["start"] = dict(lv.LAUNCHES)
            try:
                yield d
            finally:
                window["stop"] = dict(lv.LAUNCHES)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(lv)
    poller = threading.Thread(target=poll, name="live-poll")
    poller.start()
    telemetry.trace_capture = counted_capture
    t = time.perf_counter()
    try:
        res = core.run(test)
    finally:
        telemetry.trace_capture = trace_capture
        stop.set()
        poller.join(timeout=30)
    run_wall = time.perf_counter() - t
    reg, run_dir = res["telemetry-registry"], store.path(res)
    phases = {s["labels"]["phase"]: s["value"] for s in reg.collect()
              if s["name"] == "run_phase_seconds"}
    doc = json.loads((run_dir / "profile.json").read_text())
    trace_path = run_dir / "profile_trace" / "trace.json"
    kern = trace_kernels(trace_path)
    util = doc["attribution"]["utilization"]["summary"]
    executing = [c for c in doc["attribution"].get("device", {}).get("chunks", [])
                 if c.get("stage") == "execute" and c.get("levels", 0) > 0]
    launched = {k: v for k, v in counted["analyze"].items() if v and k in KERNEL_SYMBOLS}
    missing = [k for k in launched if not any(sym in kern["count"] for sym in KERNEL_SYMBOLS[k])]
    # the trace against the launches made while the profiler ran: the
    # monitor's worker's kernels are there beside the analysis's, and a
    # launch CUPTI did not record shows as untraced
    both = {k: [kern["count"].get(KERNEL_SYMBOLS[k][0], 0),
                window["stop"][k] - window["start"][k]] for k in ONE_KERNEL}
    untraced = {k: b - a for k, (a, b) in both.items() if a != b}
    monitor_traced = all(a > counted["analyze"][k] for k, (a, _b) in both.items()
                         if counted["online"][k])
    record = ledger.load(root / "ledger.jsonl")[-1]
    gate = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.ledger", "--check",
                           str(root / "ledger.jsonl")], cwd=root, env=env, capture_output=True,
                          text=True, timeout=120)

    # the pages, from a server over the store
    srv = web.server(root=root, port=0, host="127.0.0.1")
    threading.Thread(target=lambda: srv.serve_forever(poll_interval=0.05), daemon=True).start()
    pages = {}
    try:
        for path in PROFILED_PAGES:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}{path}",
                                        timeout=30) as r:
                pages[path] = r.status
    finally:
        srv.shutdown()
        srv.server_close()

    # the same stored history analysed again: without the profiler (twice),
    # and inside a trace with profile.json written
    stored = store.load_test(name, res["start-time"], root=root)
    walls = {}
    for label in ("plain_1", "profiled", "plain_2"):
        again = {k: v for k, v in stored.items() if k != "results"}
        again.update(name=f"{name}-{label}", checker=composed, **{
            "telemetry?": True, "profile?": label == "profiled", "store-root": str(root)})
        cm = trace_capture(root / f"trace_{label}") if label == "profiled" \
            else contextlib.nullcontext()
        t = time.perf_counter()
        with cm:
            out_a = core.analyze(again)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t
        if out_a["results"]["valid"] is not True:
            raise AssertionError(f"runner profiled re-analysis {label}: {out_a['results']}")

    top = sorted(kern["ms"], key=kern["ms"].get, reverse=True)[:RUNNER_PROFILED["top_kernels"]]
    marks = doc["memory_watermarks"]
    row = {"phase": "runner", "case": "profiled", "ops": RUNNER_PROFILED["ops"],
           "concurrency": RUNNER["concurrency"], "history": len(res["history"]),
           "run_wall_s": run_wall, "phase_walls_s": phases,
           "valid": res["results"]["valid"], "online_valid": res["online-results"]["valid"],
           "linear_device": res["results"]["linear"].get("torch_device"),
           "live_line": {k: live.get(k) for k in ("run", "ops_observed", "decided_through_index",
                                                  "seen_after_s")},
           "trace_bytes": trace_path.stat().st_size, "trace_events": kern["events"],
           "trace_cpu_ops": kern["cpu_ops"], "trace_runtime_calls": kern["runtime_calls"],
           "trace_kernels": sum(kern["count"].values()),
           "top_kernels": [{"name": k, "ms": kern["ms"][k], "count": kern["count"][k]}
                           for k in top],
           "trace_against_launches": both, "untraced_launches": untraced,
           "monitor_kernels_traced": monitor_traced,
           "launches_online": counted["online"], "launches_analyze": counted["analyze"],
           "kernels_missing_from_trace": missing,
           "analyze_wall_s": {"in_run_profiled": phases.get("analyze"), **walls},
           "profile_json_bytes": (run_dir / "profile.json").stat().st_size,
           "executing_chunks": len(executing),
           "utilization": {k: util.get(k) for k in ("mean_utilization_pct", "makespan_s",
                                                    "busy_any_s", "gap_attribution_share")},
           "memory_watermarks": marks, "ledger_record": record, "ledger_check_rc": gate.returncode,
           "pages": pages, "case_wall_s": time.perf_counter() - t_case}
    emit(row)
    if not (row["valid"] is True and row["online_valid"] is True
            and row["linear_device"] == "cuda" and executing
            and 0 < util["mean_utilization_pct"] <= 100
            and len(marks) == torch.cuda.device_count()
            and all(m["peak_bytes_in_use"] > 0 for m in marks)
            and launched and not missing and counted["online"]["wgl_expand"] > 0
            and monitor_traced and "utilization_pct" in record
            and gate.returncode == 0 and live.get("ops_observed") is not None
            and all(v == 200 for v in pages.values()) and len(pages) == len(PROFILED_PAGES)):
        raise AssertionError(f"runner profiled failed: {row} {gate.stdout[-2000:]}")
    return {"trace_bytes": row["trace_bytes"], "analyze_wall_s": row["analyze_wall_s"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch import checker as jchecker
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import CasRegister
    from jepsen_tpu_torch.ops import wgl, wgl_host
    from jepsen_tpu_torch.ops import wgl_level as lv
    from jepsen_tpu_torch.ops.encode import encode_history
    from jepsen_tpu_torch.parallel import check_batch, frontier, make_mesh
    from jepsen_tpu_torch.testing import perturb_history, random_register_history

    LevelShapes.install(wgl)
    t_start = time.perf_counter()
    smi = card_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "device_name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    start_yardstick_build(_build)
    try:
        built = _build.build()
        _build.load()
    finally:
        yard_s = finish_yardstick_build()
    log = built["log"].splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln]
    # The square kernel's instances: registers, spills, barriers, static smem.
    square_ptxas = [x.strip() for i, ln in enumerate(log)
                    if "Compiling entry" in ln and "k_square" in ln for x in log[i:i + 4]]
    emit({"phase": "build", "built": built["built"], "seconds": time.perf_counter() - t0,
          "compile_seconds": built["compile_seconds"], "yardsticks_seconds": yard_s,
          "ptxas": ptxas, "square_ptxas": square_ptxas})
    model = CasRegister(init=0)

    # -- kernels against their plain versions on the card -------------------
    hist = random_register_history(random.Random(NORTH_STAR_SEED), **NORTH_STAR)
    enc = encode_history(model, hist)
    plan = wgl.stack_plans([wgl.plan_device(enc, device="cpu")], "cuda")
    W, KO, S, ND, NO = plan.dims
    timed = None
    errs = {}  # kernel -> max_abs_err over every F
    # the parent's k_hash at each single-stage level, and the regroup
    # beside its parent, by shape
    hash_parent, regroups = {}, {}
    for F in KERNEL_FS:
        chk = StageCheck(plan, F, lv, wgl, model)
        chk.run()
        g = chk.g
        stages = stage_summary(chk, lv)
        if not g.two_stage:
            hash_parent[f"north_star_F{F}"] = chk.hash_parent
        emit({"phase": "kernels", "F": F, "W": W, "KO": KO, "B": g.B, "M": g.M, "L": g.L,
              "two_stage": g.two_stage, "valid_configs": chk.valid_configs[0],
              "level_byte_floor": wgl.level_byte_floor(wgl.plan_device(enc, device="cpu"), F),
              "stages": stages, "k_hash_parent": getattr(chk, "hash_parent", None),
              "regroup": chk.regroup})
        if F == TIMED_F:
            regroups["north_star"] = dict(chk.regroup, F=F, to=2 * F, members=1)
        for k, v in stages.items():
            errs[k] = max(errs.get(k, 0), v["max_abs_err"])
        if F == TIMED_F:
            timed, north_chk = stages, chk
    # random keys for the radix sort at the largest L
    gen = torch.Generator(device="cuda").manual_seed(11)
    n = wgl.level_geometry(plan, KERNEL_FS[-1]).L
    keys = torch.randint(-2**31, 2**31 - 1, (1, n), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    vals = torch.arange(n, dtype=torch.int32, device="cuda")[None]
    k1, v1, k2, v2 = keys.clone(), vals.clone(), keys.clone(), vals.clone()
    lv.radix_sort_pairs(k1, v1, lv.sort_scratch(n, "cuda"))
    lv.radix_sort_pairs_plain(k2, v2)
    rerr = max(max_abs_err(k1, k2), max_abs_err(v1, v2))
    emit({"phase": "kernels", "random_sort_n": n, "max_abs_err": rerr})
    if rerr:
        raise AssertionError("radix_sort_pairs disagrees with the stable sort on random keys")
    sort_rows, sort_crossover = radix_sort_sweep(lv)
    stage1 = stage1_sweep(lv)
    prunes = prune_sweep(lv)

    emit(steady_state(plan, TIMED_F, lv, wgl, model))

    # -- the main path -------------------------------------------------------
    reset_counts(lv)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = wgl.check_history(model, hist, backend="device", collect_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts(lv, "the main path")
    emit({"phase": "main_path", "valid": res["valid"], "levels": res["levels"],
          "wall_s": wall, "ms_per_level": 1e3 * wall / max(res["levels"], 1),
          "phase_name": res.get("phase"), "frontier_max": res["frontier_max"],
          "window": res["window"], "attempts": res["attempts"],
          "optimistic_attempts": res.get("optimistic_attempts"),
          "launches": launches,
          "launches_per_level": {k: v / launches["wgl_expand"] for k, v in launches.items()}})
    if res["valid"] is not True:
        raise AssertionError(f"north-star history not accepted: {res.get('valid')}")
    t = time.perf_counter()
    plain = wgl.check_history(model, hist, backend="device", collect_stats=True, plain=True)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t
    same = same_search(res, plain)
    emit({"phase": "main_path_plain", "valid": plain["valid"], "levels": plain["levels"],
          "wall_s": plain_wall, "stats_rows": len(plain["level_stats"]),
          "same_as_kernels": same})
    if not same:
        raise AssertionError("plain search on the card differs from the kernel search")

    # -- telemetry, chunk callbacks and checkpoints ---------------------------
    telem = telemetry_phase(lv, wgl, model, hist, res, frontier, make_mesh, encode_history,
                            random_register_history)
    emit({"phase": "telemetry", **telem})

    # -- a refutation (exhaustive search, lossless escalation) ----------------
    rng = random.Random(REFUTE["seed"])
    bad = perturb_history(rng, random_register_history(
        rng, **{k: v for k, v in REFUTE.items() if k != "seed"}))
    reset_counts(lv)
    dev_res = wgl.check_history(model, bad, backend="device", collect_stats=True)
    torch.cuda.synchronize()
    ref_launches = launch_counts(lv, "the refutation")
    plain_res = wgl.check_history(model, bad, backend="device", collect_stats=True,
                                  plain=True)
    host_res = wgl_host.check_history_host(model, bad)
    same = same_search(dev_res, plain_res)
    emit({"phase": "refutation", "valid": dev_res["valid"], "levels": dev_res["levels"],
          "host_valid": host_res["valid"], "stuck_configs": len(dev_res.get("stuck_configs", [])),
          "attempts": [(a["F"], a["levels"]) for a in dev_res["attempts"]],
          "launches": ref_launches, "same_as_plain": same})
    if not (dev_res["valid"] is False and host_res["valid"] is False
            and dev_res.get("stuck_configs") and same):
        raise AssertionError("refutation phase failed")

    # -- every driver path: beam, fallback, escalation, de-escalation ---------
    path_hist = random_register_history(random.Random(PATHS["seed"]),
                                        **{k: v for k, v in PATHS.items() if k != "seed"})
    reset_counts(lv)
    dev_res = wgl.check_history(model, path_hist, backend="device", collect_stats=True,
                                **PATHS_SEARCH)
    torch.cuda.synchronize()
    path_launches = launch_counts(lv, "the driver-paths search")
    plain_res = wgl.check_history(model, path_hist, backend="device", collect_stats=True,
                                  plain=True, **PATHS_SEARCH)
    Fs = [a["F"] for a in dev_res["attempts"]]
    took = {"optimistic_beam": bool(dev_res.get("optimistic_attempts")),
            "escalation": any(b > a for a, b in zip(Fs, Fs[1:])),
            "de_escalation": any(b < a for a, b in zip(Fs, Fs[1:])),
            "top_rung_beam": bool(dev_res.get("beam"))}
    same = same_search(dev_res, plain_res)
    emit({"phase": "driver_paths", "valid": dev_res["valid"], "levels": dev_res["levels"],
          "attempts": [(a["F"], a["levels"]) for a in dev_res["attempts"]],
          "optimistic_attempts": [(a["F"], a["levels"])
                                  for a in dev_res.get("optimistic_attempts") or []],
          "took": took, "launches": path_launches, "same_as_plain": same})
    # The history is valid by construction: a truncating beam may say
    # unknown, never False.
    if dev_res["valid"] is False or not same or not all(took.values()):
        raise AssertionError("driver-paths phase failed")

    # -- the member axis: every batched stage and the regroup ---------------
    replay = replay_histories(random_register_history, perturb_history)
    big = big_histories(random_register_history)
    big_encs = [encode_history(model, h) for h in big]
    batch_stages = None
    for label, encs, F in (("8x10k", big_encs, BIG_KERNELS_F),
                           ("replay3", [encode_history(model, h) for h in replay[:3]],
                            REPLAY["f"])):
        bplan = batch_plan(encs, wgl)
        chk = StageCheck(bplan, F, lv, wgl, model)
        chk.run()
        g = chk.g
        stages = stage_summary(chk, lv)
        emit({"phase": "kernels_batch", "members": label, "nb": bplan.nb, "F": F,
              "W": g.W, "KO": g.KO, "B": g.B, "M": g.M, "L": g.L,
              "two_stage": g.two_stage, "valid_configs": chk.valid_configs,
              "library_note": "null where no single PyTorch call computes the stage",
              "stages": stages})
        for k, v in stages.items():
            errs[k] = max(errs.get(k, 0), v["max_abs_err"])
        if not g.two_stage:
            hash_parent[f"{label}_F{F}"] = chk.hash_parent
        if batch_stages is None:
            batch_stages, batch_chk = dict(stages, _nb=bplan.nb, _F=F), chk
            regroups["batch_8x8192"] = dict(chk.regroup, F=F, to=2 * F, members=bplan.nb + 1)
    scale = gather_sort_scale(lv, {"north_star": north_chk, "batch_8x8192": batch_chk})
    starts = chunk_start_phase(lv, wgl, model, north_chk, batch_chk,
                               batch_plan([encode_history(model, h) for h in replay], wgl))
    del north_chk, batch_chk

    # -- batch replay: 100 histories, four ways -------------------------------
    check_batch(model, replay, f=REPLAY["f"])  # workspaces and first-call costs
    reset_counts(lv)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rk = check_batch(model, replay, f=REPLAY["f"])
    torch.cuda.synchronize()
    replay_wall = time.perf_counter() - t
    replay_launches = launch_counts(lv, "batch_replay_100", LEVEL_KERNELS)
    keyed_ops = []
    for k, h in enumerate(replay):
        for o in h:
            keyed_ops.append(o.with_(value=independent.KV(k, o.value), index=len(keyed_ops)))
    # The keyed checker runs the batch at its default shared capacity, as
    # the reference's does; its launches and rungs are compared against
    # check_batch's there. Its per-key fallback must not have run.
    reset_counts(lv)
    t = time.perf_counter()
    rk_default = check_batch(model, replay)
    torch.cuda.synchronize()
    default_wall = time.perf_counter() - t
    default_launches = launch_counts(lv, "check_batch at the default f", LEVEL_KERNELS)
    reset_counts(lv)
    t = time.perf_counter()
    keyed = independent.checker(jchecker.linearizable(model=model)).check(
        {}, History(keyed_ops, reindex=False), {})
    torch.cuda.synchronize()
    keyed_wall = time.perf_counter() - t
    keyed_launches = launch_counts(lv, "the keyed checker", LEVEL_KERNELS)
    keyed_results = [keyed["results"][i] for i in range(len(replay))]
    # A launch per member would enqueue at least the members' summed levels.
    member_levels = sum(r.get("levels", 0) for r in rk_default)
    prefix = replay[:REPLAY_PLAIN_MEMBERS]
    rk_prefix = check_batch(model, prefix, f=REPLAY["f"])
    t = time.perf_counter()
    rp = check_batch(model, prefix, f=REPLAY["f"], plain=True)
    plain_wall = time.perf_counter() - t
    host = [wgl_host.check_history_host(model, h)["valid"] for h in replay]
    agree = {
        "keyed": all(same_member(a, b) for a, b in zip(rk_default, keyed_results)),
        "keyed_batched": all(r.get("batched") is True for r in keyed_results),
        "keyed_launches": keyed_launches == default_launches,
        "one_launch_per_level": keyed_launches["wgl_expand"] < member_levels,
        "keyed_vs_f64": all(same_member(dict(a, rungs=None), dict(keyed["results"][i],
                                                                  rungs=None))
                            for i, a in enumerate(rk)),
        "plain_prefix": all(same_member(a, b) for a, b in zip(rk_prefix, rp)),
        "prefix_vs_full": [r["valid"] for r in rk_prefix] == [r["valid"] for r in rk[:len(prefix)]],
        "host": [r["valid"] for r in rk] == host,
    }
    verdicts = [r["valid"] for r in rk]
    emit({"phase": "batch_replay_100", "valid": verdicts.count(True),
          "invalid": verdicts.count(False), "unknown": verdicts.count("unknown"),
          "wall_s": replay_wall, "default_f_wall_s": default_wall,
          "keyed_checker_wall_s": keyed_wall,
          "keyed_valid": keyed["valid"], "keyed_failures": len(keyed["failures"]),
          "plain_members": len(prefix), "plain_wall_s": plain_wall,
          "levels_max": max(r.get("levels", 0) for r in rk),
          "rungs": next((r["rungs"] for r in rk if r.get("rungs")), None),
          "escalated": sum(1 for r in rk if r.get("escalated")),
          "escalated_at_default_f": sum(1 for r in rk_default if r.get("escalated")),
          "agree": agree, "launches": replay_launches, "keyed_launches": keyed_launches,
          "keyed_levels_enqueued": keyed_launches["wgl_expand"],
          "keyed_member_levels_sum": member_levels})
    if not all(agree.values()):
        raise AssertionError(f"batch_replay_100 disagrees: {agree}")
    mesh_launches = batch_mesh_phase(lv, model, check_batch, make_mesh, replay, rk)

    # -- eight 10k-op members through the escalation ladder -------------------
    reset_counts(lv)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rb = check_batch(model, big, f=BIG["f"], f_schedule=BIG["f_schedule"], escalate=True)
    torch.cuda.synchronize()
    big_wall = time.perf_counter() - t
    big_launches = launch_counts(lv, "batch_8x10k")
    singles, single_wall = [], 0.0
    for h in big:
        t = time.perf_counter()
        singles.append(wgl.check_history(model, h, backend="device"))
        torch.cuda.synchronize()
        single_wall += time.perf_counter() - t
    # The same batch with its members in reverse order (same padded dims,
    # same shared B): the member axis must not let one member's search
    # depend on its neighbours or its row. (A member alone is padded to its
    # own dims, which can change a lossy beam's ties, in the reference too.)
    t = time.perf_counter()
    rev = check_batch(model, big[::-1], f=BIG["f"], f_schedule=BIG["f_schedule"],
                      escalate=True)[::-1]
    rev_wall = time.perf_counter() - t
    isolated = all(same_ladder(a, b) for a, b in zip(rb, rev))
    verdicts = [r["valid"] for r in rb] + [r["valid"] for r in singles]
    consistent = all(a["valid"] == b["valid"] for a, b in zip(rb, singles)
                     if "unknown" not in (a["valid"], b["valid"]))
    enqueued = big_launches["wgl_expand"]
    rungs = max((r.get("rungs") or [] for r in rb), key=len)
    emit({"phase": "batch_8x10k", "wall_s": big_wall, "serial_single_wall_s": single_wall,
          "valid": [r["valid"] for r in rb], "single_valid": [r["valid"] for r in singles],
          "decided": sum(r["valid"] is True for r in rb),
          "single_decided": sum(r["valid"] is True for r in singles),
          "same_in_reverse_order": isolated, "reverse_wall_s": rev_wall,
          "levels": [r.get("levels") for r in rb],
          "single_levels": [r.get("levels") for r in singles],
          "decided_at_F": [r.get("decided_at_F") for r in rb],
          "beam": [bool(r.get("beam")) for r in rb],
          "escalated": [r.get("escalated") for r in rb],
          "rungs": [(x["F"], x["members"], x["calls"], x["wall_s"]) for x in rungs],
          "levels_enqueued": enqueued,
          "member_levels_sum": sum(r.get("levels", 0) for r in rb),
          "ms_per_enqueued_level": 1e3 * big_wall / max(enqueued, 1),
          "launches": big_launches,
          "launches_per_level": {k: v / max(enqueued, 1) for k, v in big_launches.items()}})
    # The histories are valid by construction: a beam that truncated may
    # say unknown, never False, and definite verdicts must agree.
    if not (False not in verdicts and consistent and isolated
            and any(r["valid"] is True for r in rb) and big_launches["wgl_regroup"] > 1):
        raise AssertionError("batch_8x10k failed")

    # -- the store and the batch replay of stored histories -------------------
    t = time.perf_counter()
    store_launches = store_replay_phase(lv, model, replay, rk, rk_default, host, big, bad,
                                        independent, History)
    store_wall = time.perf_counter() - t
    emit({"phase": "store_replay", "case": "done", "wall_s": store_wall})

    # -- every other device model -------------------------------------------
    hists = model_histories()
    families, widths, model_errs = model_kernel_phase(lv, wgl, hists)
    for k, v in model_errs.items():
        errs[k] = max(errs.get(k, 0), v)
    expands = expand_scale(lv, wgl, model, plan, batch_plan(big_encs, wgl), families)
    mutex_launches, mutex_expand, hash_parent["mutex_5k"] = mutex_5k_phase(lv, wgl)
    errs["wgl_expand"] = max(errs["wgl_expand"], mutex_expand["max_abs_err"])
    family_launches = models_2k_phase(lv, wgl, wgl_host, hists)
    keyed_mr_launches = keyed_multi_register_phase(lv, wgl_host, jchecker, independent, History)
    t = time.perf_counter()
    front_launches = front_door_phase(lv, jchecker, independent, History)
    front_wall = time.perf_counter() - t
    engine_phases(lv, wgl, model, hist, res, hists)

    # -- the offline segmented checker and the device-fault containment ------
    new_walls = {"store_replay": store_wall, "front_door": front_wall}
    t = time.perf_counter()
    offline_run = offline_segmented_phase(lv, model)
    new_walls["offline_segmented"] = time.perf_counter() - t
    t = time.perf_counter()
    segmented_entry_phase(lv, model, wgl, jchecker, offline_run["history_20k"])
    new_walls["segmented_entry"] = time.perf_counter() - t
    t = time.perf_counter()
    resilience_phase(lv, model, wgl, frontier, make_mesh, encode_history, enc, replay,
                     offline_run["plan_20k"], offline_run["history_20k"])
    new_walls["resilience"] = time.perf_counter() - t
    offline_for_ingest = {
        "verdicts": {k: offline_run["runs"][k]["valid"] for k in ("device", "auto", "twin_auto")},
        "history": offline_run["history"], "twin": offline_run["twin"]}
    del offline_run

    # -- the frontier-sharded search on SHARD_D shards of the card ------------
    shard_stats, shard_errs = sharded_kernels_phase(lv, wgl, enc, model)
    # the sharded chunk start on the same warmed frontier (chunk_start)
    shard_stats["chunk_start"] = starts["sharded_D8"]
    shard_errs["wgl_chunk_init_sharded"] = starts["sharded_D8"]["max_abs_err"]
    exchange_big = exchange_scale_phase(lv, wgl, enc, model)
    regroups["sharded_grows"] = regroup_scale(lv, plan)
    shard_launches = sharded_10k_phase(lv, wgl, model, frontier, make_mesh, encode_history,
                                       random_register_history)
    shard_refute_launches = sharded_refutation_phase(
        lv, wgl, model, frontier, make_mesh, encode_history, random_register_history,
        perturb_history)
    checker_shard_launches = checker_sharded_phase(lv, model, jchecker, make_mesh,
                                                   random_register_history, perturb_history)

    elle_main, elle_launch, elle_errs, elle_ctx = elle_phases()
    closure_main, closure_shapes, closure_paths, closure_errs = elle_sharded_phases(elle_ctx)
    t = time.perf_counter()
    ingest = ingest_phase(lv, offline_for_ingest, elle_ctx["h8_result"])
    del offline_for_ingest
    new_walls["ingest"] = time.perf_counter() - t
    del elle_ctx
    t = time.perf_counter()
    runner = runner_phase(lv, wgl)
    new_walls["runner"] = time.perf_counter() - t
    t = time.perf_counter()
    service = service_phase(lv, wgl)
    new_walls["service"] = time.perf_counter() - t
    t = time.perf_counter()
    router = router_phase(lv, wgl)
    new_walls["router"] = time.perf_counter() - t
    sweep = elle_square_sweep()
    sweep_err = max(v["max_abs_err"] for v in sweep.values())
    gathers = gather_scale()

    kernels = []
    paths = {"main_path": launches, "batch_8x10k": big_launches, "mutex_5k": mutex_launches,
             "keyed_multi_register": keyed_mr_launches,
             "batch_mesh_D8": mesh_launches["D8"], "batch_mesh_D3": mesh_launches["D3"],
             "sharded_10k_alltoall": shard_launches["alltoall"],
             "sharded_10k_allgather": shard_launches["allgather"],
             **{k: v for k, v in store_launches.items() if k != "store_explain"},
             "front_door": front_launches, "ingest_etcd_100k": ingest["launches"],
             "runner_online": runner["core_run"]["online"],
             "runner_analyze": runner["core_run"]["analyze"], "service": service["launches"],
             "fanout": router["launches"]}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    summary = lambda r: {k: r[k] for k in keys}  # noqa: E731
    for kname in REPLACES:
        r, b = timed[kname], batch_stages[kname]
        entry = {
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max(errs[kname], rerr if kname == "radix_sort_pairs" else 0),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "launches_by_path": {k: v[kname] for k, v in paths.items()},
            "batch": {"replaces": BATCH_REPLACES.get(kname, BATCH_REPLACES["level"]),
                      "nb": batch_stages["_nb"], "F": batch_stages["_F"],
                      "launches": big_launches[kname], "max_abs_err": b["max_abs_err"],
                      "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
                      "bound_by": "bytes", "library_ms": b["library_ms"]},
        }
        # The downstream stages at state widths above one (model_kernels).
        at_widths = {f"S{S}": dict(summary(w[kname]), model=w["_model"])
                     for S, w in sorted(widths.items()) if kname in w}
        if at_widths:
            entry["state_widths"] = at_widths
        if kname == "wgl_expand":
            # Each family's step (model_kernels, selected layout, F 4096);
            # launches on its models_2k searches, mutex_5k and the keyed path.
            entry["families"] = [dict(
                summary(f), model=name, S=f["S"], replaces=STEP_REPLACES[name],
                valid_configs=f["valid_configs"],
                launches=family_launches[name]["wgl_expand"],
                launches_mutex_5k=mutex_launches[kname] if name == "owner-aware-mutex" else 0,
                **({"at_mutex_5k_frontier": summary(mutex_expand)}
                   if name == "owner-aware-mutex" else {}),
                launches_keyed=keyed_mr_launches[kname] if name == "multi-register" else 0)
                for name, f in families.items()]
        if kname == "radix_sort_pairs":  # random keys at every size (radix_sort_sweep)
            entry["one_block_max"] = lv._build.SORT_CTA_MAX
            entry["sweep"] = [{k: r[k] for k in ("n", "nb", "path", "device_launches", "ms",
                                                 "library_ms", "bound_ms")}
                              for r in sort_rows]
            entry["both_paths"] = sort_crossover
        if kname == "wgl_prune":  # the stage alone (prune_sweep)
            entry["device_launches"] = prunes["device_launches"]
            entry["sweep"] = [{k: r[k] for k in ("L", "nb", "family", "tile", "ms", "bound_ms")}
                              for r in prunes["main"]]
            entry["tiles"] = prunes["tiles"]
        if kname == "wgl_expand":  # the stage at both frontiers (expand_scale)
            entry["scale"] = {k: v for k, v in expands.items() if k != "families"}
            # the single-stage levels' keys, written with the rows: each such
            # level's parent launched k_hash once (the yardstick, timed here)
            entry["keys_single_stage_levels_by_path"] = {
                k: v["wgl_expand"] - v["wgl_stage1_hash"] for k, v in paths.items()
                if not k.startswith("sharded")}
            entry["k_hash_parent"] = hash_parent
        if kname == "wgl_chunk_init":  # the whole start beside the parent's (chunk_start)
            entry["chunk_start"] = starts
        if kname == "wgl_regroup":  # beside its parent design, and the sharded grows
            entry["parent"] = regroups
        if kname in scale:  # beside the parent design (gather_sort_scale)
            entry["scale"] = scale[kname]
        if kname == "wgl_stage1_hash":  # the stage alone (stage1_sweep)
            entry["device_launches"] = stage1["device_launches"]
            entry["tiles"] = stage1["tiles"]
            # a sharded level's (the allgather's with its keys)
            entry["sharded"] = {m: shard_stats[m][kname] for m in lv.EXCHANGES}
        if kname in shard_errs:  # every stage at the sharded L (sharded_kernels)
            entry["sharded_L_max_abs_err"] = shard_errs[kname]
            entry["max_abs_err"] = max(entry["max_abs_err"], shard_errs[kname])
        kernels.append(entry)
    shard_paths = {"sharded_10k_alltoall": shard_launches["alltoall"],
                   "sharded_10k_allgather": shard_launches["allgather"],
                   "sharded_refutation": shard_refute_launches,
                   "checker_sharded": checker_shard_launches}
    for kname, replaces in SHARD_REPLACES.items():
        mode = SHARD_PRIMARY.get(kname, "alltoall")
        other = lv.EXCHANGES[1 - lv.EXCHANGES.index(mode)]
        r = (shard_stats["chunk_start"] if kname == "wgl_chunk_init_sharded"
             else shard_stats[mode][kname])
        count = SHARD_COUNT.get(kname, kname)
        entry = {"name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
                 "program": SHARD_PROGRAM, "launches": shard_launches[mode][count],
                 **summary(r), "max_abs_err": shard_errs[kname],
                 "shape": f"sharded_kernels: D {SHARD_D}, F {SHARD_F_TOTAL // SHARD_D} a shard, "
                          + ("either mode" if kname == "wgl_chunk_init_sharded" else mode),
                 "launches_by_path": {k: v[count] for k, v in shard_paths.items()}}
        # the parent design and the prune without the reduce; the parent's
        # exchange without the keys
        for extra in ("parent_ms", "unsharded_ms", "parent_gather_ms"):
            if r.get(extra) is not None:
                entry[extra] = r[extra]
        if kname in ("wgl_route", "wgl_exchange"):  # a whole level of its mode, captured
            entry["level_device_launches"] = shard_stats["device_launches"][mode]
            # the received rows' keys: the parent hashed them in a launch of
            # its own (the yardstick, timed on the same rows)
            entry["k_hash_parent"] = shard_stats[mode]["k_hash_parent"]
        if kname in shard_stats[other]:
            entry[other] = summary(shard_stats[other][kname])
        for v in exchange_big.values():  # the route or the exchange at the largest rung
            if v["kernel"] == kname:
                entry[f"f_total_{SHARD_BIG_F_TOTAL}"] = v
                entry["max_abs_err"] = max(entry["max_abs_err"], v["max_abs_err"])
        if kname == "wgl_chunk_init_sharded":
            entry["device_launches"] = shard_stats["device_launches"]["chunk_start"]
        kernels.append(entry)
    for kname, r in elle_main.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": ELLE_SOURCE,
            "replaces": ELLE_REPLACES[kname], "launches": elle_launch[kname],
            "launches_by_path": {"elle_append_8k": elle_launch[kname],
                                 "store_explain": store_launches["store_explain"][kname],
                                 "ingest_elle_8k": ingest["elle_launches"][kname]},
            "max_abs_err": max(elle_errs[kname], sweep_err if kname == "elle_square" else 0),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bound_share": r["bound_share"],
            "vs_library": r["vs_library"], "shape": "elle_append_8k: nb 6, pad 8192",
            **({"at_pads": {k: v for k, v in sweep.items() if k.startswith("square")}}
               if kname == "elle_square" else {})})
    main_paths = ("elle_sharded_20k_packed", "elle_sharded_20k_dense")
    for kname, r in closure_main.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": ELLE_SOURCE,
            "replaces": ELLE_SHARD_REPLACES[kname], "program": ELLE_SHARD_PROGRAM,
            "launches": sum(closure_paths[p][kname] for p in main_paths),
            "launches_by_path": {p: c[kname] for p, c in closure_paths.items()},
            **summary(r),
            "max_abs_err": max(closure_errs[kname],
                               sweep_err if kname == "elle_block_square" else 0),
            "shape": f"elle_sharded_20k: one mask, pad 32768, D {ELLE_SHARD_D}",
            "bound_share": r["bound_share"], "vs_library": r["vs_library"],
            "at_shapes": {label: summary(v[kname]) for label, v in closure_shapes.items()},
            **({"all_ones": sweep[f"block_square_all_ones_pad{ELLE_SHARD_20K_PAD}"]}
               if kname == "elle_block_square" else {}),
            **({"gather_scale": gathers} if kname == "elle_gather" else {})})
    done_s = time.perf_counter() - t_start
    new_s = {k: new_walls[k] for k in ("front_door", "ingest", "runner", "service", "router")}
    emit({"phase": "done", "seconds": done_s, "new_phases_s": new_s,
          "new_phases_share": sum(new_s.values()) / done_s, "phase_walls_s": new_walls})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
