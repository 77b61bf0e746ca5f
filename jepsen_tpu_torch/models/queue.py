"""Queue models (host-only).

Equivalents of knossos ``model/unordered-queue`` / ``model/fifo-queue``.
Queue state is unbounded, so these models do not pack into fixed int32
lanes: they have no device step (``device_capable = False``) and run on
the host oracle only (``ops.wgl.check_history`` says so in its result).

Op shapes: ``{:f :enqueue :value v}``, ``{:f :dequeue :value v}`` (value
observed at completion).
"""

from __future__ import annotations

from typing import Optional

from . import EncodeError, Model, ValueTable, register_model
from ..history import OK

ENQUEUE, DEQUEUE = 0, 1


@register_model
class UnorderedQueue(Model):
    """A multiset queue: dequeue may return any enqueued element."""

    name = "unordered-queue"
    device_capable = False
    n_opcodes = 2

    def init_state(self, table: ValueTable) -> tuple:
        return ()

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        if iv.f == "enqueue":
            return (ENQUEUE, table.intern(iv.value_in), 0)
        if iv.f == "dequeue":
            if iv.type != OK:
                return None  # indeterminate dequeue observes nothing
            return (DEQUEUE, table.intern(iv.value_out), 0)
        raise EncodeError(f"queue: unknown f {iv.f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        if opcode == ENQUEUE:
            return (True, tuple(sorted(state + (a1,))))
        if a1 in state:
            out = list(state)
            out.remove(a1)
            return (True, tuple(out))
        return (False, state)

    def decode_state(self, state, table):
        return tuple(table.lookup(int(x)) for x in state)

    def encode_state(self, decoded, table):
        return tuple(table.intern(v) for v in decoded)

    def describe_op(self, opcode, a1, a2, table):
        verb = "enqueue" if opcode == ENQUEUE else "dequeue"
        return f"{verb} {table.lookup(a1)!r}"


@register_model
class FIFOQueue(UnorderedQueue):
    """A strict FIFO queue: dequeue must return the head."""

    name = "fifo-queue"

    def step_scalar(self, state, opcode, a1, a2):
        if opcode == ENQUEUE:
            return (True, state + (a1,))
        if state and state[0] == a1:
            return (True, state[1:])
        return (False, state)
