"""Batched dispatch driver of the device Elle cycle engine.

The port of the reference's ``jepsen_tpu/elle/engine.py``. The taxonomy
(:func:`jepsen_tpu_torch.elle.cycle_anomalies`) needs, per dependency
graph and per pass, the closures of up to three masked subgraphs (WW,
WW|WR, full, and their realtime/process unions). This driver plans every
mask of every pass of every pending graph as a member of a power-of-two
size bucket (:data:`ops.BUCKETS`) and runs each bucket through ONE batched
closure (:func:`ops.batched_closure`, the CUDA kernels of
``csrc/elle_closure.cu``). Results come back bit-packed (one transfer per
chunk) and every taxonomy query is then a host bit test.

Escalation ladder (one-sided, typed):

1. members co-batch at their bucket, chunked under a per-dispatch byte
   budget (``MEMBER_BYTE_BUDGET // (bucket² · 2)`` members);
2. a chunk that runs out of memory (``torch.OutOfMemoryError``) or meets
   an injected ``device.dispatch`` fault (``testing.chaos.ChaosError``,
   fired before each closure dispatch) halves and retries, up to
   :data:`MAX_ESCALATIONS` rungs. Any other exception (a build failure, a
   launch error) propagates: no kernel fault turns into a quiet host
   fallback;
3. a graph above :data:`ops.CEILING` degrades to the host Tarjan/BFS
   path with the typed cause ``elle_bucket_ceiling``. Past the rung
   budget, a chunk on the GPU that ran out of memory raises
   ``torch.OutOfMemoryError`` naming its bucket and members, so the
   card's work never moves to the host unseen; CPU tensors fold to the
   host, typed ``elle_device_oom``. An injected fault folds the same way
   on every device, as the reference folds any dispatch failure: it says
   nothing about the card's size, which is why a real out-of-memory
   raises there.

``mesh=`` sends every closure, one request at a time, to the block-row
sharded closure (:func:`ops.sharded_closure`) on the mesh's device, at
``pad = max(closure_pad(n), 32 D)`` and with no bucket ceiling. Its only
fold is the same: an out-of-memory on CPU tensors, or an injected fault on
any device, becomes ``elle_device_oom`` with ``sharded=True``; a real
out-of-memory on the GPU raises naming ``n``, the pad and ``D``, and any
other exception (a mesh axis that is not a power of two included)
propagates.

``report`` carries ``engine``, ``chunks`` and ``causes`` as in the
reference. ``metrics`` (a :class:`jepsen_tpu_torch.telemetry.Registry`)
records the reference's events and counters: an ``elle_batch_chunk``
event a chunk (bucket, members, walls, ``stage``, ``t0``/``t1``),
``elle_batch_occupancy{bucket}``, ``elle_closure_bytes_total`` and, on a
fold, ``elle_device_fallback_total{cause}`` and
``verdict_causes_total``. A chunk's ``stage`` is ``"compile"`` when it
paid the process's first load of the kernel library (its ``nvcc`` build
or load: the port's counterpart of the reference's first chunk after a
JIT build), else ``"execute"``. As in the reference, errors in this
observability code are swallowed; nothing of it wraps a launch.
"""

from __future__ import annotations

import time as _time
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from .. import trace as _trace
from ..checker import provenance as _prov
from ..devices import mesh_device
from ..devices import resolve_device as _torch_device
from ..testing import chaos as _chaos
from . import ops

MAX_ESCALATIONS = 4
MEMBER_BYTE_BUDGET = 1 << 31

_FALLBACK_HELP = ("Batched Elle engine degradations to the host "
                  "Tarjan/BFS path, by provenance cause "
                  "(docs/verdicts.md); the verdict is unchanged — the "
                  "fallback is one-sided")
_BYTES_HELP = ("Bit-packed closure bytes transferred device->host by "
               "the batched Elle engine (uint32 row blocks, 16x under "
               "bf16 dense)")
_OCC_HELP = ("Real nodes / padded node slots of the last Elle closure "
             "chunk at this bucket (how much of the padded batch was "
             "live work)")


class ClosureView:
    """Host-side view of one (graph, mask) closure: bit-packed rows and
    device SCC labels; every taxonomy query is a bit test."""

    __slots__ = ("packed", "labels", "n")

    def __init__(self, packed: np.ndarray, labels: Optional[np.ndarray], n: int):
        self.packed = packed
        self.labels = labels
        self.n = n

    def reach(self, a: int, b: int) -> bool:
        """Path a -> b of length >= 1 under this mask."""
        return ops.row_bit(self.packed[a], b)

    def diag_any(self) -> bool:
        """Any node on a cycle (closure diagonal nonzero)."""
        idx = np.arange(self.n)
        words = self.packed[idx, idx >> 5]
        return bool(((words >> (idx & 31)) & 1).any())

    def same_scc(self, a: int, b: int) -> bool:
        """Mutual reachability."""
        return self.reach(a, b) and self.reach(b, a)

    def sccs(self) -> list:
        """Nontrivial SCCs as sorted node lists."""
        if self.labels is None:
            reach = ops.unpack_bits_host(self.packed[: self.n], self.n)
            both = (reach & reach.T) | np.eye(self.n, dtype=bool)
            labels = np.argmax(both, axis=1)
        else:
            labels = self.labels
        return ops.sccs_from_labels(labels, self.packed, self.n)


class _EmptyView:
    """A mask with no edges: trivially closed, no device member."""

    __slots__ = ()

    def reach(self, a: int, b: int) -> bool:
        return False

    def diag_any(self) -> bool:
        return False

    def same_scc(self, a: int, b: int) -> bool:
        return False

    def sccs(self) -> list:
        return []


EMPTY_VIEW = _EmptyView()


def _mask_edges(edges: dict, mask: int):
    srcs, dsts = [], []
    for (s, d), k in edges.items():
        if k & mask:
            srcs.append(s)
            dsts.append(d)
    return srcs, dsts


def _fallback(ji: int, code: str, failed: dict, metrics, report, **params) -> None:
    cause = _prov.cause(code, **params)
    failed.setdefault(ji, []).append(cause)
    if metrics is not None:
        try:
            c = metrics.counter("elle_device_fallback_total", _FALLBACK_HELP,
                                labelnames=("cause",), aggregate=True)
            c.inc()  # the unlabeled total
            c.labels(cause=code).inc()
        except Exception:  # noqa: BLE001 - observability never degrades
            pass
        _prov.count_metric(metrics, [cause])
    if report is not None:
        report.setdefault("causes", []).append(cause)


def _note_chunk(metrics, report, *, bucket, members, chunk_wall, t_start, stage, occupancy,
                out_bytes, **extra) -> None:
    if report is not None:
        report["chunks"] = report.get("chunks", 0) + 1
    if metrics is None:
        return
    try:
        t1e = round(_time.time(), 6)
        metrics.event(
            "elle_batch_chunk", bucket=bucket, members=members,
            wall_s=round(_time.perf_counter() - t_start, 4),
            chunk_wall_s=round(chunk_wall, 6), stage=stage,
            t0=round(t1e - chunk_wall, 6), t1=t1e, **extra, **_trace.event_tags())
        metrics.gauge("elle_batch_occupancy", _OCC_HELP,
                      labelnames=("bucket",)).labels(bucket=bucket).set(round(occupancy, 4))
        metrics.counter("elle_closure_bytes_total", _BYTES_HELP).inc(out_bytes)
    except Exception:  # noqa: BLE001 - observability never degrades
        pass


def batch_closures(jobs: Sequence[Tuple[object, Iterable[int]]], metrics=None,
                   report: Optional[dict] = None, mesh=None,
                   min_bucket: Optional[int] = None, torch_device=None) -> list:
    """Compute every requested (graph, mask) closure in as few device
    dispatches as possible: one batched closure per populated size bucket
    (plus ladder rungs on out-of-memory).

    ``jobs``: (DepGraph-like with .n/.edges, iterable of edge-kind masks)
    per graph. Returns, per job, ``{mask: ClosureView}``, or None when that
    graph degraded to the host path (its typed cause is in
    ``report["causes"]``). ``mesh`` sends every closure to the sharded
    closure on the mesh's device; ``min_bucket`` pins a floor bucket.
    ``torch_device`` is the torch device (the GPU by default; with a mesh,
    the mesh's, and another raises ``ValueError``). ``metrics``: see the
    module docstring."""
    t_start = _time.perf_counter()
    if mesh is not None:
        torch_device = mesh_device(mesh, torch_device)
    views: list = [dict() for _ in jobs]
    failed: dict = {}
    requests = []  # (ji, mask, srcs, dsts, n)
    for ji, (g, masks) in enumerate(jobs):
        for mask in dict.fromkeys(masks):  # de-dup, keep order
            srcs, dsts = _mask_edges(g.edges, mask)
            if not srcs:
                views[ji][mask] = EMPTY_VIEW
            else:
                requests.append((ji, mask, srcs, dsts, g.n))
    if mesh is not None:
        _sharded_requests(requests, views, failed, metrics, report, mesh, torch_device,
                          t_start)
    else:
        _bucketed_requests(requests, views, failed, metrics, report, min_bucket,
                           torch_device, t_start)
    if report is not None and failed and "engine" not in report:
        report["engine"] = "host"
    return [None if ji in failed else views[ji] for ji in range(len(jobs))]


def _bucketed_requests(requests, views, failed, metrics, report, min_bucket,
                       torch_device, t_start) -> None:
    by_bucket: dict = {}
    for req in requests:
        ji, mask, srcs, dsts, n = req
        bucket = ops.bucket_for(max(n, min_bucket or 0))
        if bucket is None:
            _fallback(ji, "elle_bucket_ceiling", failed, metrics, report, n=n,
                      ceiling=ops.CEILING)
            continue
        by_bucket.setdefault(bucket, []).append(req)

    for bucket in sorted(by_bucket):
        members = [r for r in by_bucket[bucket] if r[0] not in failed]
        if not members:
            continue
        dev = _torch_device(torch_device)
        epad = ops.edge_pad(max(len(r[2]) for r in members))
        padded = [ops.pad_edges(r[2], r[3], bucket, epad) for r in members]
        S = np.stack([p[0] for p in padded])
        D = np.stack([p[1] for p in padded])
        B = len(members)
        chunk = max(1, min(B, MEMBER_BYTE_BUDGET // (bucket * bucket * 2)))
        esc = 0
        i = 0
        while i < B:
            m = min(chunk, B - i)
            was_loaded = _build.loaded()
            t0p = _time.perf_counter()
            try:
                _chaos.fire("device.dispatch")
                pk, lb = ops.batched_closure(S[i:i + m], D[i:i + m], bucket, dev)
                pk = pk.cpu().numpy().view(np.uint32)
                lb = lb.cpu().numpy()
            except (torch.OutOfMemoryError, _chaos.ChaosError) as e:
                esc += 1
                if esc > MAX_ESCALATIONS or chunk <= 1:
                    if dev.type != "cpu" and isinstance(e, torch.OutOfMemoryError):
                        raise torch.OutOfMemoryError(
                            f"elle closure at bucket {bucket}: a chunk of {m} of "
                            f"{B} member(s) is out of memory on {dev} after "
                            f"{esc - 1} halving(s): {e}") from e
                    for ji, _mask, *_rest in members[i:]:
                        _fallback(ji, "elle_device_oom", failed, metrics, report,
                                  bucket=bucket, members=m, error=f"{type(e).__name__}: {e}")
                    break
                chunk = max(1, chunk // 2)
                continue
            live = sum(r[4] for r in members[i:i + m])
            _note_chunk(metrics, report, bucket=bucket, members=m,
                        chunk_wall=_time.perf_counter() - t0p, t_start=t_start,
                        stage=_build.chunk_stage(was_loaded), occupancy=live / (m * bucket),
                        out_bytes=m * bucket * ops.packed_words(bucket) * 4, epad=epad)
            for j, (ji, mask, *_rest) in enumerate(members[i:i + m]):
                views[ji][mask] = ClosureView(pk[j], lb[j], members[i + j][4])
            i += m


def _sharded_requests(requests, views, failed, metrics, report, mesh, dev, t_start) -> None:
    exchange = ops.resolve_exchange(None)
    n_dev = int(mesh.shape[mesh.axis_names[0]])
    for ji, mask, srcs, dsts, n in requests:
        if ji in failed:
            continue
        pad = ops.sharded_pad(n, n_dev)
        was_loaded = _build.loaded()
        t0p = _time.perf_counter()
        try:
            _chaos.fire("device.dispatch")
            packed = ops.sharded_closure(srcs, dsts, n, mesh, exchange=exchange)
        except (torch.OutOfMemoryError, _chaos.ChaosError) as e:
            if dev.type != "cpu" and isinstance(e, torch.OutOfMemoryError):
                raise torch.OutOfMemoryError(
                    f"elle sharded closure of n={n} at pad {pad} on "
                    f"{n_dev} shard(s) is out of memory on {dev}: {e}") from e
            _fallback(ji, "elle_device_oom", failed, metrics, report, n=n, n_devices=n_dev,
                      sharded=True, error=f"{type(e).__name__}: {e}")
            continue
        _note_chunk(metrics, report, bucket=pad, members=1,
                    chunk_wall=_time.perf_counter() - t0p, t_start=t_start,
                    stage=_build.chunk_stage(was_loaded), occupancy=n / pad,
                    out_bytes=2 * pad * ops.packed_words(pad) * 4, mode="sharded",
                    n_devices=n_dev, exchange=exchange)
        views[ji][mask] = ClosureView(packed, None, n)


def graph_closures(g, masks: Iterable[int], metrics=None, report: Optional[dict] = None,
                   mesh=None, min_bucket: Optional[int] = None,
                   torch_device=None) -> Optional[dict]:
    """Single-graph front end of :func:`batch_closures`."""
    return batch_closures([(g, masks)], metrics=metrics, report=report, mesh=mesh,
                          min_bucket=min_bucket, torch_device=torch_device)[0]
