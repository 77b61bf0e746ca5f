"""List-append txn workload (jepsen.tests.cycle.append equivalent).

The port of the checker of the reference's ``jepsen_tpu/workloads/append.py``.
Op shapes::

    invoke {"f": "txn", "value": [["r", 3, None], ["append", 3, 2]]}
    ok     {"f": "txn", "value": [["r", 3, [1]],  ["append", 3, 2]]}
"""

from __future__ import annotations

from typing import Optional

from ..checker import Checker, checker_fn
from ..elle import append as elle_append
from ..txn import GENERATORS_SLICE


STORE_SLICE = ("the test map asks for stored output; the elle/<anomaly>.txt "
               "explanation files come with a later slice of the port (the "
               "checker's store writes)")


def _asks_for_store(test) -> bool:
    test = test or {}
    return bool(test.get("name") and test.get("start-time") and not test.get("no-store?"))


def checker(opts: Optional[dict] = None) -> Checker:
    """Full checker for append/read histories; default anomalies [G1, G2]
    like the reference. ``opts`` also takes ``torch_device`` (the GPU by
    default). A test map with a store (``name`` and ``start-time``, and
    not ``no-store?``) raises ``ValueError`` before checking: the
    explanation files come with a later slice."""
    o = dict(opts or {})
    anomalies = o.get("anomalies", ["G1", "G2"])

    def chk(test, history, copts):
        if _asks_for_store(test):
            raise ValueError(STORE_SLICE)
        return elle_append.check(
            history, anomalies=anomalies,
            device=o.get("device"),
            additional_graphs=o.get("additional_graphs", ()),
            torch_device=o.get("torch_device"),
        )

    return checker_fn(chk, "append")


def gen(opts: Optional[dict] = None):
    raise ValueError(GENERATORS_SLICE)


def test(opts: Optional[dict] = None) -> dict:
    raise ValueError(GENERATORS_SLICE)
