"""CLI shim: ``python -m jepsen_tpu_torch.alerts`` — replay or tail a
durable ``alerts.jsonl`` (the alert plane's transition journal). The
port of the reference's ``jepsen_tpu/alerts.py``. The implementation
lives in ``jepsen_tpu_torch.telemetry.alerts`` (next to the
registry/fleet layers the rules evaluate over); this module only
provides the short ``-m`` entry point."""

from __future__ import annotations

import sys

from .telemetry.alerts import main  # noqa: F401 - re-exported entry

if __name__ == "__main__":
    sys.exit(main())
