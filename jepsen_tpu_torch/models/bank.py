"""Bank model (the classic Jepsen total-balance workload).

A fixed set of named accounts; money moves but is never created or
destroyed. Ops:

- transfer: ``{:f :transfer :value {:from a :to b :amount n}}``, ok iff
  the source balance covers it (no overdrafts), atomically moving ``n``;
  encoded ``a1 = src * W + dst`` (``W`` accounts), ``a2 = n``.
- read: ``{:f :read :value {account balance}}`` observing ONE account's
  exact balance (the single-lane constraint, as for multi-register); a
  snapshot read of several accounts raises :class:`EncodeError`.

State is one raw int32 balance lane per account (no interning: transfers
are arithmetic, which the device step does like int32 and wraps), so the
default table-independent ``decode_state``/``encode_state`` carry is
already correct. Every expressible transition preserves the total, so a
history whose reads imply created or destroyed money has no witness and
refutes. ``step_torch`` is the plain version of ``bank_step`` in
``csrc/wgl_level.cu``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import EncodeError, Model, UNKNOWN, ValueTable, register_model
from ..history import OK

READ, TRANSFER = 0, 1

_LIMIT = 2**30


def _int(v, what: str) -> int:
    if not isinstance(v, int) or isinstance(v, bool) or abs(v) >= _LIMIT:
        raise EncodeError(f"bank: {what} must be an int32-safe "
                          f"integer, got {v!r}")
    return v


@register_model
class Bank(Model):
    """Fixed accounts, overdraft-refusing transfers, raw balance lanes."""

    name = "bank"
    n_opcodes = 2

    def __init__(self, init: dict):
        if not init:
            raise ValueError("bank needs at least one account")
        self.init = {a: _int(b, f"balance[{a!r}]")
                     for a, b in init.items()}
        self.accounts = sorted(self.init, key=repr)
        self.acct_ids = {a: i for i, a in enumerate(self.accounts)}
        self.state_width = len(self.accounts)

    def cache_key(self):
        return (self.name, self.state_width, self.n_opcodes)

    def cache_args(self):
        return (tuple(sorted(self.init.items(), key=repr)),)

    @classmethod
    def _from_cache_key(cls, args):
        return cls(dict(args[0]))

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        return tuple(self.init[a] for a in self.accounts)

    def _acct(self, a) -> int:
        i = self.acct_ids.get(a)
        if i is None:
            raise EncodeError(f"bank: unknown account {a!r}")
        return i

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        f = iv.f
        W = self.state_width
        if f == "transfer":
            v = iv.value_in or {}
            src = self._acct(v.get("from"))
            dst = self._acct(v.get("to"))
            return (TRANSFER, src * W + dst, _int(v.get("amount"), "amount"))
        if f == "read":
            if iv.type != OK:
                return None  # indeterminate read constrains nothing
            v = iv.value_out
            if not isinstance(v, dict) or len(v) != 1:
                raise EncodeError(
                    "bank device path handles single-account reads; "
                    "snapshot reads fall back to host")
            ((a, b),) = v.items()
            return (READ, self._acct(a),
                    UNKNOWN if b is None else _int(b, "balance"))
        raise EncodeError(f"bank: unknown f {f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        W = self.state_width
        if opcode == READ:
            return (a2 == UNKNOWN or state[a1] == a2, state)
        src, dst = divmod(a1, W)
        if state[src] < a2:
            return (False, state)
        new = list(state)
        new[src] -= a2
        new[dst] += a2
        return (True, tuple(new))

    def step_torch(self, states, opcodes, a1s, a2s):
        W = states.shape[-1]
        is_read = opcodes == READ
        # Reads: a1 = account lane, a2 = expected balance.
        cur = torch.gather(states, -1, (a1s % W).long()[..., None])[..., 0]
        read_ok = (a2s == UNKNOWN) | (cur == a2s)
        # Transfers: a1 = src*W + dst, a2 = amount. A valid encoding keeps
        # src in [0, W); the balance read is clamped so that a padding row
        # cannot index outside the state.
        src = torch.div(a1s, W, rounding_mode="floor")
        dst = a1s % W
        bal_src = torch.gather(states, -1, src.clamp(0, W - 1).long()[..., None])[..., 0]
        xfer_ok = bal_src >= a2s
        lane = torch.arange(W, dtype=states.dtype, device=states.device)
        move = (~is_read & xfer_ok)[..., None]
        delta = torch.where(lane == src[..., None], -a2s[..., None], 0) \
            + torch.where(lane == dst[..., None], a2s[..., None], 0)
        states2 = torch.where(move, states + delta, states)
        return torch.where(is_read, read_ok, xfer_ok), states2

    def describe_op(self, opcode, a1, a2, table):
        W = self.state_width
        if opcode == READ:
            return (f"read {self.accounts[a1]!r} -> "
                    f"{None if a2 == UNKNOWN else a2}")
        src, dst = divmod(a1, W)
        return (f"transfer {self.accounts[src]!r} -> "
                f"{self.accounts[dst]!r} amount {a2}")
