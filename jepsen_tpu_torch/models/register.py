"""Register models: ``cas-register``, ``register`` and ``multi-register``.

Op shapes: read ``{:f :read :value nil}`` (the ok carries the observed
value), write ``{:f :write :value v}``, cas ``{:f :cas :value [old new]}``;
multi-register ``{:f :read|:write :value {reg v}}``, one register per op.
``step_torch`` is the plain version of ``cas_register_step`` and
``multi_register_step`` in ``csrc/wgl_level.cu``, which the expand kernel
inlines.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import EncodeError, Model, UNKNOWN, ValueTable, register_model
from ..history import OK

READ, WRITE, CAS = 0, 1, 2


@register_model
class CasRegister(Model):
    """A register supporting read/write/compare-and-set."""

    name = "cas-register"
    state_width = 1
    n_opcodes = 3

    def __init__(self, init=None):
        self.init = init

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        return (table.intern(self.init),)

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        f = iv.f
        if f == "read":
            if iv.type != OK:
                # indeterminate read: no state change, unknown result — drop
                return None
            return (READ, table.intern(iv.value_out), 0)
        if f == "write":
            return (WRITE, table.intern(iv.value_in), 0)
        if f == "cas":
            old, new = iv.value_in
            return (CAS, table.intern(old), table.intern(new))
        raise EncodeError(f"cas-register: unknown f {f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        (v,) = state
        if opcode == READ:
            return (a1 == UNKNOWN or v == a1, state)
        if opcode == WRITE:
            return (True, (a1,))
        # CAS
        return (v == a1, (a2,) if v == a1 else state)

    def step_torch(self, states, opcodes, a1s, a2s):
        v = states[..., 0]
        is_read = opcodes == READ
        is_write = opcodes == WRITE
        is_cas = opcodes == CAS
        cas_hit = v == a1s
        ok = (
            (is_read & ((a1s == UNKNOWN) | (v == a1s)))
            | is_write
            | (is_cas & cas_hit)
        )
        v2 = torch.where(is_write, a1s, torch.where(is_cas & cas_hit, a2s, v))
        return ok, v2[..., None]

    def decode_state(self, state, table):
        return (table.lookup(int(state[0])),)

    def encode_state(self, decoded, table):
        return (table.intern(decoded[0]),)

    def describe_op(self, opcode, a1, a2, table):
        if opcode == READ:
            return f"read -> {table.lookup(a1)!r}"
        if opcode == WRITE:
            return f"write {table.lookup(a1)!r}"
        return f"cas {table.lookup(a1)!r} -> {table.lookup(a2)!r}"


@register_model
class Register(CasRegister):
    """Read/write register (no cas)."""

    name = "register"
    n_opcodes = 2

    def encode_op(self, iv, table):
        if iv.f == "cas":
            raise EncodeError("register: cas not supported; use cas-register")
        return super().encode_op(iv, table)


@register_model
class MultiRegister(Model):
    """A fixed set of named registers, read or written one at a time.

    ``init``: dict register-name -> initial value. Op values are ``{reg
    value}`` maps of one register; ``a1`` is the register's lane, ``a2``
    the interned value. The state has one lane per register."""

    name = "multi-register"
    n_opcodes = 2

    def __init__(self, init: dict):
        if not init:
            raise ValueError("multi-register needs at least one register")
        self.init = dict(init)
        self.regs = sorted(self.init, key=repr)
        self.reg_ids = {r: i for i, r in enumerate(self.regs)}
        self.state_width = len(self.regs)

    def cache_key(self):
        return (self.name, self.state_width, self.n_opcodes)

    def cache_args(self):
        return (tuple(sorted(self.init.items(), key=repr)),)

    @classmethod
    def _from_cache_key(cls, args):
        return cls(dict(args[0]))

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        return tuple(table.intern(self.init[r]) for r in self.regs)

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        f = iv.f
        if f not in ("read", "write"):
            raise EncodeError(f"multi-register: unknown f {f!r}")
        value = iv.value_out if f == "read" else iv.value_in
        if f == "read" and iv.type != OK:
            return None
        if not isinstance(value, dict) or len(value) != 1:
            raise EncodeError("multi-register device path handles single-register ops")
        ((reg, v),) = value.items()
        if reg not in self.reg_ids:
            raise EncodeError(f"multi-register: unknown register {reg!r}")
        return (READ if f == "read" else WRITE, self.reg_ids[reg], table.intern(v))

    def step_scalar(self, state, opcode, a1, a2):
        cur = state[a1]
        if opcode == READ:
            return (a2 == UNKNOWN or cur == a2, state)
        new = list(state)
        new[a1] = a2
        return (True, tuple(new))

    def step_torch(self, states, opcodes, a1s, a2s):
        # A valid encoding gives every op a lane in [0, S); the read is
        # clamped so that a padding row cannot index outside the state.
        S = states.shape[-1]
        cur = torch.gather(states, -1, a1s.clamp(0, S - 1).long()[..., None])[..., 0]
        is_read = opcodes == READ
        ok = ~is_read | (a2s == UNKNOWN) | (cur == a2s)
        lane = torch.arange(S, dtype=states.dtype, device=states.device)
        write = (~is_read)[..., None] & (lane == a1s[..., None])
        return ok, torch.where(write, a2s[..., None], states)

    def decode_state(self, state, table):
        return tuple(table.lookup(int(x)) for x in state)

    def encode_state(self, decoded, table):
        return tuple(table.intern(v) for v in decoded)

    def describe_op(self, opcode, a1, a2, table):
        verb = "read" if opcode == READ else "write"
        return f"{verb} {self.regs[a1]!r} {table.lookup(a2)!r}"
