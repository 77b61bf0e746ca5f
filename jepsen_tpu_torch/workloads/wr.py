"""Write/read register txn workload (jepsen.tests.cycle.wr equivalent).

The port of the checker of the reference's ``jepsen_tpu/workloads/wr.py``;
writes are globally unique.
"""

from __future__ import annotations

from typing import Optional

from ..checker import Checker, checker_fn
from ..elle import explain
from ..elle import wr as elle_wr
from ..txn import GENERATORS_SLICE


def checker(opts: Optional[dict] = None) -> Checker:
    """Default anomalies [G2, G1a, G1b, internal], as the reference's.
    ``opts`` also takes ``torch_device``; a test with a store gets the
    explanation files, as in :mod:`.append`."""
    o = dict(opts or {})
    anomalies = o.get("anomalies", ["G2", "G1a", "G1b", "internal"])

    def chk(test, history, copts):
        res = elle_wr.check(
            history,
            anomalies=anomalies,
            linearizable_keys=o.get("linearizable_keys", False),
            sequential_keys=o.get("sequential_keys", False),
            wfr_keys=o.get("wfr_keys", False),
            device=o.get("device"),
            additional_graphs=o.get("additional_graphs", ()),
            torch_device=o.get("torch_device"),
        )
        explain.write_anomalies(test, res, subdirectory=(copts or {}).get("subdirectory"))
        return res

    return checker_fn(chk, "wr")


def gen(opts: Optional[dict] = None):
    raise ValueError(GENERATORS_SLICE)


def test(opts: Optional[dict] = None) -> dict:
    raise ValueError(GENERATORS_SLICE)
