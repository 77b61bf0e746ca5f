"""PN-counter model (grow/shrink counter with exact reads).

Ops are ``{:f :add :value delta}`` (signed) and ``{:f :read :value
observed}``. This is a *linearizable* counter: a read must observe
exactly the sum of the adds linearized before it.

State is the raw running total in one int32 lane (no interning: the
arithmetic needs the real value), so the default table-independent
``decode_state``/``encode_state`` carry is already correct. Each delta
is below 2**30, but the running total is not bounded: the device step
adds like int32 and wraps. ``step_torch`` is the plain version of
``counter_step`` in ``csrc/wgl_level.cu``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import EncodeError, Model, UNKNOWN, ValueTable, register_model
from ..history import OK

READ, ADD = 0, 1

# Raw lane arithmetic must stay inside int32 (and clear of UNKNOWN).
_LIMIT = 2**30


def _int(v, what: str) -> int:
    if not isinstance(v, int) or isinstance(v, bool) or abs(v) >= _LIMIT:
        raise EncodeError(f"counter: {what} must be an int32-safe "
                          f"integer, got {v!r}")
    return v


@register_model
class Counter(Model):
    """A linearizable add/read counter over one raw int lane."""

    name = "counter"
    state_width = 1
    n_opcodes = 2

    def __init__(self, init: int = 0):
        self.init = _int(init, "init")

    def cache_args(self):
        return (self.init,)

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        return (self.init,)

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        f = iv.f
        if f == "read":
            if iv.type != OK:
                return None  # indeterminate read constrains nothing
            v = iv.value_out
            return (READ, UNKNOWN if v is None else _int(v, "read"), 0)
        if f == "add":
            return (ADD, _int(iv.value_in, "delta"), 0)
        raise EncodeError(f"counter: unknown f {f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        (v,) = state
        if opcode == READ:
            return (a1 == UNKNOWN or v == a1, state)
        return (True, (v + a1,))

    def step_torch(self, states, opcodes, a1s, a2s):
        v = states[..., 0]
        is_read = opcodes == READ
        ok = ~is_read | (a1s == UNKNOWN) | (v == a1s)
        v2 = torch.where(is_read, v, v + a1s)
        return ok, v2[..., None]

    def describe_op(self, opcode, a1, a2, table):
        if opcode == READ:
            return f"read -> {None if a1 == UNKNOWN else a1}"
        return f"add {a1:+d}"
