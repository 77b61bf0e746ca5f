"""PyTorch/CUDA port of the jepsen_tpu checker.

This package sits beside ``jepsen_tpu`` (the JAX reference) and imports
nothing from it: the host layers it needs are its own copies. It holds
the reference's fourteen models (``models``) and the WGL linearizability
search for each device model among them, for one history
(``ops.wgl.check_history``) or a batch (``parallel.check_batch``, and the
keyed ``independent.checker(checker.linearizable(...))`` on top of it),
with the lock and semaphore workloads' checkers (``workloads.lock``). The
BFS level program runs as hand-written CUDA kernels for Hopper on a member
axis (``csrc/wgl_level.cu``, the single search being the batch of one;
the expand kernel inlines every device model's step), with a plain
PyTorch version of every stage beside them (``ops.wgl_level``). The
host-only queue models run on the host oracle.
It also holds Elle's transactional cycle checker (``elle.append.check``,
``elle.wr.check``, the ``workloads.append``/``wr`` checkers), whose
closures run as the kernels of ``csrc/elle_closure.cu`` (plain versions
in ``elle.ops``).

It reads and writes a Jepsen store (``store``, with the EDN codec
``edn`` and its C reader ``native/edn_fast.c``): the checkers write their
witness and explanation files into a stored test's directory
(``checker.linear_viz``, ``elle.explain``, ``checker.timeline``, the keyed
checker's ``independent/<k>/``), and ``parallel.replay`` (``python -m
jepsen_tpu_torch replay``) decides every stored ``history.edn`` of a store
in one batch on the card and writes ``rechecked.edn`` beside each.

It checks recordings of real, unmodified systems (``ingest``: etcd,
redis, zookeeper, mongodb and generic jsonl traces; ``python -m
jepsen_tpu_torch.ingest``) through the offline segmented checker, whose
device oracle runs on the card, or Elle's cycle engine, and holds the
rest of the reference's checker front door: the invariant checkers
(``checker.invariants``), ``concurrency_limit``,
``unhandled_exceptions``, the bank, causal, long-fork and G2 workload
checkers and ``elle.monotonic_key_check``.

It runs tests, too: the generator DSL (``generator``, its seeded
simulator ``generator.sim`` and threaded interpreter), clients, nemeses,
control sessions, DB and OS protocols and ``core.run`` on the in-process
fake cluster of ``workloads``, with the live online monitor
(``online.OnlineMonitor``) deciding a run's segments while it executes
and the analysis on the card; ``python -m jepsen_tpu_torch
test|analyze|test-all`` is the reference's demo suite.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``torch_device="cpu"`` for the Elle entry points, whose ``device`` is the
engine flag).
"""

__version__ = "0.1.0"
