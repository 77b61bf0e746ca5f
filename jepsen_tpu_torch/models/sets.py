"""Linearizable set model (add / remove / read-members).

Ops are ``{:f :add :value e}``, ``{:f :remove :value e}`` (ok iff the
element was present) and ``{:f :read :value [members...]}`` observing the
*exact* membership.

Encoding: membership is one int32 lane holding a bitmask over interned
element ids: bit ``i`` set iff the element with table id ``i`` is a
member. That keeps the device step a pure bitwise one, at the cost of a
closed element universe: a history touching more than
:data:`MAX_ELEMENTS` distinct elements (table ids of 31 and above would
collide with the int32 sign bit and the ``UNKNOWN`` sentinel) raises
:class:`EncodeError`. Reads encode their observed membership as the same
bitmask, so a read is one equality.

``decode_state``/``encode_state`` round-trip the mask through the
frozenset of members, so a carry survives re-interning. ``step_torch`` is
the plain version of ``set_step`` in ``csrc/wgl_level.cu``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import EncodeError, Model, UNKNOWN, ValueTable, register_model
from ..history import OK

ADD, REMOVE, READ = 0, 1, 2

# Bits 0..30: int32-safe, and a full mask can never equal UNKNOWN.
MAX_ELEMENTS = 31


@register_model
class LwSet(Model):
    """A linearizable set over a 31-element interned-id bitmask lane."""

    name = "set"
    state_width = 1
    n_opcodes = 3

    def __init__(self, init=()):
        self.init = frozenset(init)

    def cache_args(self):
        return (tuple(sorted(self.init, key=repr)),)

    @classmethod
    def _from_cache_key(cls, args):
        return cls(args[0])

    def _bit(self, e, table: ValueTable) -> int:
        i = table.intern(e)
        if i >= MAX_ELEMENTS:
            raise EncodeError(
                f"set: more than {MAX_ELEMENTS} distinct elements "
                f"(id {i} for {e!r}) — bitmask lane exhausted")
        return 1 << i

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        mask = 0
        for e in sorted(self.init, key=repr):
            mask |= self._bit(e, table)
        return (mask,)

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        f = iv.f
        if f == "add":
            return (ADD, self._bit(iv.value_in, table), 0)
        if f == "remove":
            return (REMOVE, self._bit(iv.value_in, table), 0)
        if f == "read":
            if iv.type != OK:
                return None  # indeterminate read constrains nothing
            v = iv.value_out
            if v is None:
                return (READ, UNKNOWN, 0)
            mask = 0
            for e in v:
                mask |= self._bit(e, table)
            return (READ, mask, 0)
        raise EncodeError(f"set: unknown f {f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        (m,) = state
        if opcode == ADD:
            return (True, (m | a1,))
        if opcode == REMOVE:
            return (bool(m & a1), (m & ~a1,))
        return (a1 == UNKNOWN or m == a1, state)

    def step_torch(self, states, opcodes, a1s, a2s):
        m = states[..., 0]
        is_add = opcodes == ADD
        is_remove = opcodes == REMOVE
        is_read = opcodes == READ
        ok = (is_add | (is_remove & ((m & a1s) != 0))
              | (is_read & ((a1s == UNKNOWN) | (m == a1s))))
        m2 = torch.where(is_add, m | a1s, torch.where(is_remove, m & ~a1s, m))
        return ok, m2[..., None]

    def decode_state(self, state, table):
        m = int(state[0])
        return (frozenset(table.lookup(i) for i in range(MAX_ELEMENTS)
                          if m & (1 << i) and i < len(table)),)

    def encode_state(self, decoded, table):
        mask = 0
        for e in sorted(decoded[0], key=repr):
            mask |= self._bit(e, table)
        return (mask,)

    def describe_op(self, opcode, a1, a2, table):
        if opcode == READ:
            if a1 == UNKNOWN:
                return "read -> ?"
            members = [table.lookup(i) for i in range(MAX_ELEMENTS)
                       if a1 & (1 << i) and i < len(table)]
            return f"read -> {members!r}"
        i = a1.bit_length() - 1
        e = table.lookup(i) if i < len(table) else f"bit{i}"
        return f"{'add' if opcode == ADD else 'remove'} {e!r}"
