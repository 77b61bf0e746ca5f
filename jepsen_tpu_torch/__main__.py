"""Built-in demo suite: ``python -m jepsen_tpu_torch test|analyze|test-all|replay``.

The port of the reference's ``jepsen_tpu/__main__.py``. It runs the
in-process fake cluster (the atom register of ``workloads``, the
tests.clj:27-67 pattern) through the full lifecycle: generator -> threaded
interpreter -> history -> linearizability search on the card -> ``store/``.
The per-DB suites follow the same shape with real clients (cli.clj:342-418
usage)::

    python -m jepsen_tpu_torch test --workload cas-register --time-limit 5 --no-ssh
    python -m jepsen_tpu_torch test --workload cas-register --online --online-engine device
    python -m jepsen_tpu_torch analyze --workload cas-register
    python -m jepsen_tpu_torch test-all --time-limit 2
    python -m jepsen_tpu_torch replay --store-root store

The checkers and the online monitor run on the GPU; ``--device cpu`` runs
the plain PyTorch version, and without a GPU and without it the commands
exit 255. ``serve`` waits for the port's web pages.
"""

from __future__ import annotations

from . import checker as jchecker
from . import cli
from . import generator as gen
from .models import CasRegister
from .workloads import AtomClient, AtomDB, AtomState, noop_test


def cas_register_test(opts: dict) -> dict:
    state = AtomState()
    test = dict(noop_test())
    rate = float(opts.get("rate") or 50.0)
    test.update(
        name="cas-register",
        db=AtomDB(state),
        client=AtomClient(state),
        # The online monitor (--online) needs the model on the test map;
        # the demo DB resets the register to 0 in setup.
        model=CasRegister(init=0),
        checker=jchecker.compose({
            "linear": jchecker.linearizable(model=CasRegister(init=0),
                                            device=opts.get("device")),
            "stats": jchecker.stats(),
        }),
        generator=gen.clients(
            gen.time_limit(
                opts.get("time_limit", 10),
                gen.stagger(1.0 / rate, gen.mix([
                    lambda: {"f": "write", "value": gen.rand_int(5)},
                    lambda: {"f": "cas",
                             "value": [gen.rand_int(5), gen.rand_int(5)]},
                    lambda: {"f": "read"},
                ])),
            )
        ),
    )
    return test


def noop_suite(opts: dict) -> dict:
    from .workloads import atom_client

    test = dict(noop_test())
    test["generator"] = gen.clients(
        gen.limit(10, gen.repeat_({"f": "read", "value": None}))
    )
    st = AtomState()
    test["client"] = atom_client(st)
    test["db"] = AtomDB(st)
    return test


WORKLOADS = {
    "cas-register": cas_register_test,
    "noop": noop_suite,
}


def test_fn(opts: dict) -> dict:
    wl = opts.get("workload") or "cas-register"
    return WORKLOADS[wl](opts)


def _add_opts(p) -> None:
    p.add_argument("--workload", choices=sorted(WORKLOADS),
                   default="cas-register")
    p.add_argument("--rate", default="50",
                   help="target op rate (Hz) across all threads")


COMMANDS = {
    **cli.single_test_cmd(test_fn, add_opts=_add_opts),
    **cli.test_all_cmd({n: f for n, f in WORKLOADS.items()}),
    # The demo DB resets the register to 0 in setup, so replay must
    # check against an init=0 model (the generic default is nil-init).
    **cli.replay_cmd(model_args={"init": 0}),
}

if __name__ == "__main__":
    cli.main_exit(COMMANDS)
