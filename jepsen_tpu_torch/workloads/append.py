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
from ..elle import explain
from ..txn import GENERATORS_SLICE


def checker(opts: Optional[dict] = None) -> Checker:
    """Full checker for append/read histories; default anomalies [G1, G2]
    like the reference. ``opts`` also takes ``torch_device`` (the GPU by
    default). On a test with a store, a non-clean result leaves
    ``elle/<anomaly>.txt`` explanation files in it (``elle.explain``,
    cycle/append.clj:19-21) and names their directory in ``directory``."""
    o = dict(opts or {})
    anomalies = o.get("anomalies", ["G1", "G2"])

    def chk(test, history, copts):
        res = elle_append.check(
            history, anomalies=anomalies,
            device=o.get("device"),
            additional_graphs=o.get("additional_graphs", ()),
            torch_device=o.get("torch_device"),
        )
        explain.write_anomalies(test, res, subdirectory=(copts or {}).get("subdirectory"))
        return res

    return checker_fn(chk, "append")


def gen(opts: Optional[dict] = None):
    raise ValueError(GENERATORS_SLICE)


def test(opts: Optional[dict] = None) -> dict:
    raise ValueError(GENERATORS_SLICE)
