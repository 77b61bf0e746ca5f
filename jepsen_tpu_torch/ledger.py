"""``python -m jepsen_tpu_torch.ledger``: the cross-run perf ledger's trend
table and regression gate. The implementation is
:mod:`jepsen_tpu_torch.telemetry.ledger`; this module is the short ``-m``
entry point."""

from __future__ import annotations

import sys

from .telemetry.ledger import main  # noqa: F401 - re-exported entry

if __name__ == "__main__":
    sys.exit(main())
