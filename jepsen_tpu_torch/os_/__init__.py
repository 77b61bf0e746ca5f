"""Operating-system provisioning protocol.

The port of the reference's ``jepsen_tpu/os_/__init__.py``, which mirrors
jepsen.os (jepsen/src/jepsen/os.clj:4-8): prepare a node's OS before
DB install (hostfiles, packages, users) and undo it after. The distro
implementations of the reference's ``os_`` submodules (debian, centos,
ubuntu, smartos) are not in the port yet.
"""

from __future__ import annotations

from typing import Any


class OS:
    def setup(self, test: dict, node: Any) -> None:
        pass

    def teardown(self, test: dict, node: Any) -> None:
        pass


class _Noop(OS):
    def __repr__(self):
        return "<os.noop>"


def noop() -> OS:
    return _Noop()
