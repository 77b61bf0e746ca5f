"""Workload classification + dispatch: ingested ops → a verdict.

The port of the reference's ``jepsen_tpu/ingest/mapper.py``. The adapter
layer (:mod:`jepsen_tpu_torch.ingest.adapters`) turns a recording into
scheduler-shaped history ops plus an ``unmapped`` count; this module
decides WHICH checker explains them and folds the two together:

- register / cas / counter / set / bank shapes go through the WGL
  segmented pipeline (:func:`jepsen_tpu_torch.offline.check_offline` with
  the matching :mod:`jepsen_tpu_torch.models` model — keyed ops split per
  key via ``independent.KV`` exactly like native histories), whose
  scheduler co-batches the segments' members onto the card;
- txn-shaped ops (``f == "txn"`` with micro-op lists) go through the
  Elle graph checkers — list-append micro-ops to
  :mod:`jepsen_tpu_torch.elle.append`, w/r micro-ops to
  :mod:`jepsen_tpu_torch.elle.wr` — and their batched cycle engine on the
  card; ``check="elle"`` also lifts plain register ops into
  single-micro-op wr txns (sound only under the recorded-writes-unique
  discipline; duplicate writes surface as ``duplicate-writes``).

``device`` is the torch device of both: ``check_offline``'s ``device``
(the scheduler's device oracle) and the Elle checkers' ``torch_device``,
the card by default, ``"cpu"`` for the plain versions.

The unmapped contract is ONE-SIDED: any op the adapter or the workload
model could not explain means the checked history is incomplete, so
neither a definite True (a dropped write could be the anomaly) nor a
definite False (a dropped write could explain the "impossible" read)
may stand — ``unmapped > 0`` folds every definite verdict to
``unknown`` with the typed ``ingest_unmapped_op`` cause. Never a flip.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

from .. import independent as ind
from ..checker import provenance as prov
from ..elle import append as elle_append
from ..elle import wr as elle_wr
from ..models import model_by_name
from ..offline import check_offline

# workload -> (model name, model args thunk, f's the model explains)
WORKLOADS: dict = {
    "register": ("cas-register", lambda: (), {"read", "write", "cas"}),
    "counter": ("counter", lambda: (), {"read", "add"}),
    "set": ("set", lambda: (), {"read", "add", "remove"}),
    "bank": ("bank", None, {"read", "transfer"}),  # init required
}


def classify(ops: Iterable[dict], hint: Optional[str] = None) -> str:
    """The workload a parsed op stream looks like: the adapter's
    majority hint when the op shapes don't contradict it, else the
    smallest workload whose f-set covers the stream."""
    fs = {op.get("f") for op in ops}
    fs.discard(None)
    if "txn" in fs:
        for op in ops:
            if op.get("f") != "txn":
                continue
            for m in op.get("value") or []:
                if m and m[0] == "append":
                    return "append"
        return "wr"
    if "transfer" in fs:
        return "bank"
    if hint in WORKLOADS and fs <= WORKLOADS[hint][2]:
        return hint
    if "remove" in fs:
        return "set"
    if "add" in fs:
        return "counter"
    return "register"


def _lift_wr_txns(ops: list[dict]) -> list[dict]:
    """Plain register ops as single-micro-op wr txns (``check="elle"``
    over a register-shaped recording). Reads whose value never arrived
    stay observation-free (``v None`` is skipped by ext_reads)."""
    out = []
    for op in ops:
        f, v = op.get("f"), op.get("value")
        if f not in ("read", "write"):
            continue  # cas has no wr-txn analogue; caller counts it
        k, x = (v.key, v.value) if ind.is_tuple(v) else (0, v)
        mop = ["w", k, x] if f == "write" else ["r", k, x]
        out.append({**op, "f": "txn", "value": [mop]})
    return out


def check_ingested(ingested: dict, *, check: str = "auto",
                   model_init: Any = None, metrics=None,
                   tenant: str = "", engine: str = "auto",
                   streams: int = 0, device=None, **kw: Any) -> dict:
    """Decide an adapter-parsed recording (:func:`parse_trace` output).

    ``check``: ``"auto"`` picks by shape (txn ops → Elle, else WGL
    segmented), ``"segmented"`` forces the WGL pipeline,
    ``"elle"`` forces the graph path (lifting register ops to wr
    txns). ``model_init`` feeds workloads whose model needs
    construction data (bank's account map, a counter's initial
    value). ``engine`` is the segmented pipeline's (``auto``: the device
    oracle for rounds of more than one member). ``device`` is the torch
    device of both paths (the card by default). Extra ``kw`` flows to the
    underlying checker."""
    ops = list(ingested.get("ops") or [])
    unmapped = int(ingested.get("unmapped") or 0)
    adapter = ingested.get("adapter", "?")
    workload = classify(ops, ingested.get("hint"))

    if check == "auto":
        check = "elle" if workload in ("append", "wr") else "segmented"

    out: dict
    if check == "elle":
        if workload in ("append", "wr"):
            txns = ops
        else:
            txns = _lift_wr_txns(ops)
            dropped = sum(1 for op in ops
                          if op.get("type") == "invoke"
                          and op.get("f") not in ("read", "write"))
            unmapped += dropped
            workload = "wr"
        checker = elle_append if workload == "append" else elle_wr
        out = checker.check(txns, metrics=metrics, torch_device=device,
                            **{k: v for k, v in kw.items()
                               if k not in ("max_configs",)})
        out.setdefault("engine_name", "elle-" + workload)
    elif check == "segmented":
        if workload in ("append", "wr"):
            raise ValueError(
                f"workload {workload!r} is txn-shaped; the segmented "
                f"WGL pipeline cannot express it — use --check elle")
        name, args, fs = WORKLOADS[workload]
        # Ops the model can't explain are dropped — counted, not
        # guessed (the one-sided unmapped fold covers them).
        kept, dropped = [], 0
        open_dropped: set = set()
        for op in ops:
            f, p, t = op.get("f"), op.get("process"), op.get("type")
            if f in fs and (t != "invoke" or p not in open_dropped):
                open_dropped.discard(p)
                kept.append(op)
            elif t == "invoke":
                dropped += 1
                open_dropped.add(p)
        unmapped += dropped
        for i, op in enumerate(kept):  # keep index stamps monotone
            op = dict(op)
            op["index"] = i
            kept[i] = op
        if model_init is not None:
            model = model_by_name(name, model_init)
        elif args is None:
            raise ValueError(f"workload {workload!r} needs model_init "
                             f"(e.g. the bank's account map)")
        else:
            model = model_by_name(name, *args())
        out = check_offline(model, kept, engine=engine,
                            streams=streams, metrics=metrics, device=device, **kw)
    else:
        raise ValueError(f"unknown check {check!r}; "
                         f"use auto | segmented | elle")

    # --- the one-sided unmapped fold -----------------------------------
    causes = prov.of(out)
    if unmapped > 0:
        if out.get("valid") != "unknown":  # True AND False both fold
            out["valid"] = "unknown"
        causes = causes + [prov.cause("ingest_unmapped_op",
                                      count=unmapped, adapter=adapter)]
    counts = prov.merge_counts(
        (out.get("provenance") or {}).get("causes"),
        prov.add_counts({}, causes))
    if unmapped > 0:
        # The per-op count is the honest magnitude (add_counts saw one
        # cause dict); the advisor's share rule keys off it.
        counts["ingest_unmapped_op"] = max(
            counts.get("ingest_unmapped_op", 0), unmapped)
    result = {
        "valid": out.get("valid"),
        "workload": workload,
        "check": check,
        "adapter": adapter,
        "unmapped": unmapped,
        "n_ops": sum(1 for op in ops if op.get("type") != "invoke"),
        "result": out,
    }
    if causes:
        result["causes"] = causes
    blk = prov.block(counts)
    if blk:
        result["provenance"] = blk
    prov.count_metric(metrics, causes, tenant=tenant)
    return result
