"""Batch replay of archived histories (BASELINE config 5).

The port of the reference's ``jepsen_tpu/parallel/replay.py``: load N
stored ``history.edn`` files (this package's or the reference's: the same
EDN format), encode them for one model, decide them all as one batched
search on the card (``parallel.batch.check_encoded_batch``), and write a
``rechecked.edn`` beside each history. The CLI exposes it as the
``replay`` command (``python -m jepsen_tpu_torch replay``).

Two differences from the reference: :func:`replay` and
:func:`replay_store` take ``device=`` (the card unless ``device="cpu"``),
and :func:`replay_store` passes no mesh: the reference shards the batch
over every local device when it sees more than one, the port decides it
on one card (the default meshes, ``ROADMAP.md``'s divergence 3). A member
that the batch leaves to its serial last resort carries the single
search's ``torch_device`` key, which the reference's result maps lack, so
its ``rechecked.edn`` names the device; the files are otherwise the
reference's but for the wall times (``wall_s``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Optional, Sequence

from .. import edn, native, store, trace
from ..checker import provenance as _prov
from ..devices import resolve_device
from ..history import History
from ..models import Model, model_by_name
from ..ops.encode import encode_history
from .batch import check_encoded_batch

LOG = logging.getLogger("jepsen.replay")

# What a missing or unreadable file, text that is not EDN, or a form that
# is not an op map raises. Anything else (a failed build of the C reader,
# say) is a fault of this machine, not of the run, and escapes.
_UNREADABLE = (OSError, ValueError, TypeError, KeyError, AttributeError,
               RecursionError)


def find_histories(root: Any = None, name: Optional[str] = None,
                   limit: Optional[int] = None) -> list[Path]:
    """Every ``history.edn`` under the store tree, the newest runs first
    across all tests (start-times sort as timestamps); ``limit`` keeps the
    newest N."""
    stamped: list[tuple[str, Path]] = []
    tests = store.tests(name=name, root=root)
    for tname in sorted(tests):
        for start, d in tests[tname].items():
            f = d / "history.edn"
            if f.exists():
                stamped.append((start, f))
    stamped.sort(key=lambda sf: sf[0], reverse=True)
    out = [f for _s, f in stamped]
    if limit is not None:
        out = out[:limit]
    return out


def load_histories(paths: Sequence[Path]) -> list[Optional[History]]:
    """Each stored history, or None where it cannot be read (logged). The
    C reader is built before the first file is read, so a failed build
    raises once instead of marking every history unreadable."""
    native.load_edn_fast()
    out: list[Optional[History]] = []
    for p in paths:
        try:
            out.append(History.load(p))
        except _UNREADABLE:
            LOG.warning("could not load %s", p, exc_info=True)
            out.append(None)
    return out


def encode_histories(model: Model, histories: Sequence[Optional[History]]
                     ) -> tuple[list, list, list]:
    """Encode each loaded history for ``model``. Returns the result slots
    (None for a history to decide; a result map with its
    ``encoding_unsupported`` cause for one that could not be read, that
    the model cannot interpret, or whose ops the model drops entirely,
    which would otherwise be vacuously valid), the indexes to decide and
    their encodings."""
    results: list[Optional[dict]] = []
    idx, encs = [], []
    for i, h in enumerate(histories):
        if h is None:
            results.append(_prov.attach(
                {"valid": "unknown", "info": "unreadable history"},
                "encoding_unsupported", reason="unreadable history"))
            continue
        client_ops = h.client_ops()
        try:
            enc = encode_history(model, client_ops)
        except Exception as e:  # the model cannot interpret these ops at all
            results.append(_prov.attach(
                {"valid": "unknown", "info": f"not a {model.name} history: {e}"},
                "encoding_unsupported", reason="model mismatch"))
            continue
        if len(client_ops) and enc.n == 0:
            results.append(_prov.attach(
                {"valid": "unknown",
                 "info": f"no ops matched model {model.name}; wrong "
                         "--model for this run?"},
                "encoding_unsupported", reason="no ops matched model"))
            continue
        results.append(None)
        idx.append(i)
        encs.append(enc)
    return results, idx, encs


def write_rechecked(paths: Sequence[Path], results: Sequence[dict]) -> None:
    """``rechecked.edn`` beside each history; a failed write is logged."""
    for p, res in zip(paths, results):
        try:
            out = p.parent / "rechecked.edn"
            out.write_text(edn.write_string(store.to_edn_value(res)) + "\n")
        except Exception:
            LOG.warning("could not write results next to %s", p, exc_info=True)


def replay(model: Model, paths: Sequence[Path], mesh=None, f: int = 256,
           write_results: bool = True, escalate=True, metrics=None,
           device=None) -> list[dict]:
    """Decide every stored history in one batched search on ``device``
    (the card unless ``device="cpu"``); returns one result map per path,
    in order. Members that overflow the shared capacity ``f`` re-batch up
    the frontier schedule (``escalate``, see
    ``parallel.batch.check_encoded_batch``); ``metrics`` takes a telemetry
    registry. Each step is a span of the default trace collector:
    ``replay.load`` (read and parse), ``replay.encode``, ``replay.decide``
    (the batch; its verdicts are host values, so the span ends after the
    card's work) and ``replay.write``."""
    paths = [Path(p) for p in paths]
    if mesh is None:
        device = resolve_device(device)
    with trace.span("replay.load", histories=len(paths)):
        histories = load_histories(paths)
    with trace.span("replay.encode"):
        results, idx, encs = encode_histories(model, histories)
    with trace.span("replay.decide", members=len(idx)):
        if idx:
            batch = check_encoded_batch(encs, mesh=mesh, f=f, escalate=escalate,
                                        metrics=metrics, device=device)
            for i, res in zip(idx, batch):
                results[i] = res
    if write_results:
        with trace.span("replay.write"):
            write_rechecked(paths, results)
    return results  # type: ignore[return-value]


def replay_store(model_name: str = "cas-register", root: Any = None,
                 name: Optional[str] = None, limit: Optional[int] = None,
                 mesh=None, model_args: Optional[dict] = None, device=None) -> dict:
    """The CLI's entry: replay every archived history in the store through
    the batched checker on ``device``. Returns a summary map."""
    model = model_by_name(model_name, **(model_args or {}))
    paths = find_histories(root=root, name=name, limit=limit)
    if not paths:
        return {"count": 0, "valid": 0, "invalid": 0, "unknown": 0}
    results = replay(model, paths, mesh=mesh, device=device)
    return {
        "count": len(results),
        "valid": sum(1 for r in results if r["valid"] is True),
        "invalid": sum(1 for r in results if r["valid"] is False),
        "unknown": sum(1 for r in results if r["valid"] == "unknown"),
        "escalated": sum(1 for r in results if r.get("escalated")),
        "runs": {str(p): r["valid"] for p, r in zip(paths, results)},
    }
