"""``python -m jepsen_tpu_torch replay``: batch-recheck a store's histories.

The port of the ``replay`` command of the reference's demo suite
(``jepsen_tpu/__main__.py``). The demo's DB resets its register to 0 in
setup, so the replay checks against a register whose initial value is 0
(``--model-args`` overrides it)::

    python -m jepsen_tpu_torch replay --store-root store
    python -m jepsen_tpu_torch replay --device cpu --store-root store --limit 10

The suite's other commands (``test``, ``analyze``, ``test-all``,
``serve``) need the test runner and the web pages, which the port does
not hold yet.
"""

from __future__ import annotations

from . import cli

COMMANDS = {
    **cli.replay_cmd(model_args={"init": 0}),
}

if __name__ == "__main__":
    cli.main_exit(COMMANDS)
