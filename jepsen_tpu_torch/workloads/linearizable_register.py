"""Keyed CAS-register workload — the canonical linearizability test.

The port of the reference's ``jepsen_tpu/workloads/linearizable_register.py``,
which mirrors jepsen.tests.linearizable-register
(jepsen/src/jepsen/tests/linearizable_register.clj): an
independent/concurrent-generator lifts a single register to many keys
(2n threads per key, ~20 ops per key so each subhistory stays small), and
the checker is independent(compose(linearizable(cas-register),
timeline)). The per-key decisions run as one batched device search
through the independent checker's batch seam, on ``device`` (the GPU
unless the options say ``"cpu"``); ``backend`` picks another of
``checker.linearizable``'s engines.

Clients understand ``{"f": "write"|"read"|"cas", "value": [k, v]}``
tuples.
"""

from __future__ import annotations

from typing import Optional

from .. import checker as jchecker
from .. import generator as gen
from .. import independent
from ..checker.timeline import html as timeline_html
from ..models import CasRegister


def w(test=None, ctx=None):
    return {"type": "invoke", "f": "write", "value": gen.rand_int(5)}


def r(test=None, ctx=None):
    return {"type": "invoke", "f": "read", "value": None}


def cas(test=None, ctx=None):
    return {"type": "invoke", "f": "cas",
            "value": [gen.rand_int(5), gen.rand_int(5)]}


def _counter():
    k = 0
    while True:
        yield k
        k += 1


def test(opts: Optional[dict] = None) -> dict:
    """linearizable_register.clj:22-53. ``opts`` also takes ``device``
    and ``backend`` (``"device"`` by default, where the reference's is
    ``"auto"``)."""
    o = dict(opts or {})
    n = len(o.get("nodes") or [1])
    model = o.get("model") or CasRegister(init=None)
    per_key_limit = o.get("per-key-limit", 20)
    process_limit = o.get("process-limit", 20)

    def fgen(k):
        g = gen.reserve(n, r, gen.mix([w, cas, cas]))
        if per_key_limit:
            g = gen.limit(
                int((0.9 + gen.rand_float(0.1)) * per_key_limit), g)
        return gen.process_limit(process_limit, g)

    return {
        "checker": independent.checker(
            jchecker.compose({
                "linearizable": jchecker.linearizable(
                    model=model, backend=o.get("backend", "device"),
                    device=o.get("device")),
                "timeline": timeline_html(),
            })
        ),
        "generator": independent.concurrent_generator(
            2 * n, _counter(), fgen),
    }
