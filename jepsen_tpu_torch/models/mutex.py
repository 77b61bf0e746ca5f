"""Mutual-exclusion and semaphore models.

Equivalents of knossos ``model/mutex`` and of the hazelcast suite's
CP-subsystem models (hazelcast.clj:515-649): ReentrantMutex,
OwnerAwareMutex, FencedMutex, ReentrantFencedMutex and
AcquiredPermitsModel (here :class:`Semaphore`).

Op shapes: ``{:f :acquire}`` / ``{:f :release}``; fenced locks observe the
fence token as the ok acquire's value; semaphores carry the permit count
as the op value (default 1). Each ``step_torch`` is the plain version of
the step of the same name in ``csrc/wgl_level.cu`` (``mutex_step``,
``owner_aware_mutex_step``, ...), and like it treats every opcode other
than ACQUIRE as a release.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import EncodeError, Model, UNKNOWN, ValueTable, register_model
from ..history import OK

ACQUIRE, RELEASE = 0, 1


def _count(iv) -> int:
    v = iv.value_in if iv.value_in is not None else 1
    if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
        raise EncodeError(f"permit count must be a positive int, got {v!r}")
    return v


@register_model
class Mutex(Model):
    """knossos model/mutex: acquire fails when held, release fails when free."""

    name = "mutex"
    state_width = 1
    n_opcodes = 2

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        return (0,)

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        if iv.f == "acquire":
            return (ACQUIRE, 0, 0)
        if iv.f == "release":
            return (RELEASE, 0, 0)
        raise EncodeError(f"mutex: unknown f {iv.f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        (locked,) = state
        if opcode == ACQUIRE:
            return (locked == 0, (1,))
        return (locked == 1, (0,))

    def step_torch(self, states, opcodes, a1s, a2s):
        locked = states[..., 0]
        is_acq = opcodes == ACQUIRE
        ok = (is_acq & (locked == 0)) | (~is_acq & (locked == 1))
        return ok, is_acq.to(states.dtype)[..., None]

    def describe_op(self, opcode, a1, a2, table):
        return "acquire" if opcode == ACQUIRE else "release"


@register_model
class OwnerAwareMutex(Model):
    """Mutex whose release is only legal from the process holding it
    (hazelcast.clj:538-557). State lane = owner-id + 1, 0 when free."""

    name = "owner-aware-mutex"
    state_width = 1
    n_opcodes = 2

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        return (0,)

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        p = table.intern(("process", iv.process))
        if iv.f == "acquire":
            return (ACQUIRE, p, 0)
        if iv.f == "release":
            return (RELEASE, p, 0)
        raise EncodeError(f"owner-aware-mutex: unknown f {iv.f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        (owner,) = state
        if opcode == ACQUIRE:
            return (owner == 0, (a1 + 1,))
        return (owner == a1 + 1, (0,))

    def step_torch(self, states, opcodes, a1s, a2s):
        owner = states[..., 0]
        is_acq = opcodes == ACQUIRE
        client = a1s + 1
        ok = (is_acq & (owner == 0)) | (~is_acq & (owner == client))
        owner2 = torch.where(is_acq, client, 0)
        return ok, owner2[..., None]

    # The owner lane embeds an interned value id, so a carry across tables
    # round-trips through the semantic owner: None when free, the
    # ("process", p) tuple when held.
    def decode_state(self, state, table):
        owner = int(state[0])
        return (table.lookup(owner - 1) if owner else None,)

    def encode_state(self, decoded, table):
        (owner,) = decoded
        return (0 if owner is None else table.intern(owner) + 1,)

    def describe_op(self, opcode, a1, a2, table):
        verb = "acquire" if opcode == ACQUIRE else "release"
        return f"{verb} by {table.lookup(a1)!r}"


@register_model
class ReentrantMutex(Model):
    """A lock the same holder may take up to ``max_depth`` times
    (hazelcast.clj:515-534; hazelcast CP locks allow depth 2)."""

    name = "reentrant-mutex"
    state_width = 1
    n_opcodes = 2

    def __init__(self, max_depth: int = 2):
        self.max_depth = max_depth

    def cache_args(self):
        return (self.max_depth,)

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        return (0,)

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        if iv.f == "acquire":
            return (ACQUIRE, 0, 0)
        if iv.f == "release":
            return (RELEASE, 0, 0)
        raise EncodeError(f"reentrant-mutex: unknown f {iv.f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        (depth,) = state
        if opcode == ACQUIRE:
            return (depth < self.max_depth, (depth + 1,))
        return (depth > 0, (max(depth - 1, 0),))

    def step_torch(self, states, opcodes, a1s, a2s):
        depth = states[..., 0]
        is_acq = opcodes == ACQUIRE
        ok = (is_acq & (depth < self.max_depth)) | (~is_acq & (depth > 0))
        depth2 = torch.where(is_acq, depth + 1, (depth - 1).clamp(min=0))
        return ok, depth2[..., None]

    def describe_op(self, opcode, a1, a2, table):
        return "acquire" if opcode == ACQUIRE else "release"


@register_model
class FencedMutex(Model):
    """Owner-aware mutex whose successful acquires observe strictly
    increasing fence tokens (hazelcast.clj:565-586). State lanes:
    [owner+1, last-fence]. The fence is the raw int token from the ok
    acquire's value (UNKNOWN when unobserved)."""

    name = "fenced-mutex"
    state_width = 2
    n_opcodes = 2

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        return (0, -1)

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        p = table.intern(("process", iv.process))
        if iv.f == "acquire":
            fence = iv.value_out if iv.type == OK else None
            if fence is None:
                return (ACQUIRE, p, UNKNOWN)
            if not isinstance(fence, int) or isinstance(fence, bool) or fence < 0:
                raise EncodeError(f"fence token must be a non-negative int, got {fence!r}")
            return (ACQUIRE, p, fence)
        if iv.f == "release":
            return (RELEASE, p, 0)
        raise EncodeError(f"fenced-mutex: unknown f {iv.f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        owner, last = state
        if opcode == ACQUIRE:
            ok = owner == 0 and (a2 == UNKNOWN or a2 > last)
            new_last = last if a2 == UNKNOWN else a2
            return (ok, (a1 + 1, new_last))
        return (owner == a1 + 1, (0, last))

    def step_torch(self, states, opcodes, a1s, a2s):
        owner, last = states[..., 0], states[..., 1]
        is_acq = opcodes == ACQUIRE
        client = a1s + 1
        fence_ok = (a2s == UNKNOWN) | (a2s > last)
        ok = (is_acq & (owner == 0) & fence_ok) | (~is_acq & (owner == client))
        owner2 = torch.where(is_acq, client, 0)
        last2 = torch.where(is_acq & (a2s != UNKNOWN), a2s, last)
        return ok, torch.stack([owner2, last2], dim=-1)

    # Owner lane is an interned value id; the fence lane is a raw int.
    def decode_state(self, state, table):
        owner, last = (int(x) for x in state)
        return (table.lookup(owner - 1) if owner else None, last)

    def encode_state(self, decoded, table):
        owner, last = decoded
        return ((0 if owner is None else table.intern(owner) + 1),
                int(last))

    def describe_op(self, opcode, a1, a2, table):
        if opcode == ACQUIRE:
            fence = "?" if a2 == UNKNOWN else a2
            return f"acquire (fence {fence}) by {table.lookup(a1)!r}"
        return f"release by {table.lookup(a1)!r}"


@register_model
class ReentrantFencedMutex(Model):
    """Reentrant fenced mutex: up to ``LOCK_LIMIT`` holds by one owner,
    fences monotone over the highest observed fence (hazelcast.clj:590-626).
    State lanes: [owner+1, lock-count, current-fence,
    highest-observed-fence]; fences are raw ints with UNKNOWN for acquires
    whose token wasn't observed, and highest-observed starts at -1 so any
    real fence exceeds it."""

    name = "reentrant-fenced-mutex"
    state_width = 4
    n_opcodes = 2
    LOCK_LIMIT = 2

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        return (0, 0, UNKNOWN, -1)

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        p = table.intern(("process", iv.process))
        if iv.f == "acquire":
            fence = iv.value_out if iv.type == OK else None
            if fence is None:
                return (ACQUIRE, p, UNKNOWN)
            if not isinstance(fence, int) or isinstance(fence, bool) or fence < 0:
                raise EncodeError(
                    f"fence token must be a non-negative int, got {fence!r}")
            return (ACQUIRE, p, fence)
        if iv.f == "release":
            return (RELEASE, p, 0)
        raise EncodeError(f"reentrant-fenced-mutex: unknown f {iv.f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        owner, count, cur, hof = state
        client = a1 + 1
        f = a2
        if opcode == ACQUIRE:
            if owner == 0:
                ok = f == UNKNOWN or f > hof
                hof2 = hof if f == UNKNOWN else max(f, hof)
                return (ok, (client, 1, f, hof2))
            if owner != client or count >= self.LOCK_LIMIT:
                return (False, state)
            if cur == UNKNOWN:
                ok = f == UNKNOWN or f > hof
                hof2 = hof if f == UNKNOWN else max(f, hof)
                return (ok, (client, count + 1, f, hof2))
            if f == UNKNOWN or f == cur:
                return (True, (client, count + 1, cur, hof))
            return (False, state)
        # release
        if owner == 0 or owner != client:
            return (False, state)
        if count == 1:
            return (True, (0, 0, UNKNOWN, hof))
        return (True, (owner, count - 1, cur, hof))

    def step_torch(self, states, opcodes, a1s, a2s):
        owner, count, cur, hof = (states[..., i] for i in range(4))
        client = a1s + 1
        f = a2s
        is_acq = opcodes == ACQUIRE
        f_known = f != UNKNOWN
        fresh_ok = ~f_known | (f > hof)
        room = (owner == client) & (count < self.LOCK_LIMIT)
        # Case 1: unheld acquire. Case 2: reacquire with an unfenced
        # current hold. Case 3: reacquire with a fenced hold, same or
        # unknown fence.
        c1 = is_acq & (owner == 0)
        c2 = is_acq & room & (cur == UNKNOWN)
        c3 = is_acq & room & (cur != UNKNOWN) & (~f_known | (f == cur))
        rel_ok = ~is_acq & (owner == client) & (owner != 0)
        ok = (c1 & fresh_ok) | (c2 & fresh_ok) | c3 | rel_ok
        last_hold = count == 1
        hof2 = torch.where((c1 | c2) & f_known, torch.maximum(f, hof), hof)
        owner2 = torch.where(is_acq, client, torch.where(last_hold, 0, owner))
        count2 = torch.where(c1, 1, torch.where(c2 | c3, count + 1, (count - 1).clamp(min=0)))
        released = torch.where(last_hold, torch.full_like(cur, UNKNOWN), cur)
        cur2 = torch.where(c1 | c2, f, torch.where(c3, cur, released))
        return ok, torch.stack([owner2, count2, cur2, hof2], dim=-1)

    # Owner lane is an interned value id; count and both fence lanes are
    # raw ints (UNKNOWN/-1 sentinels included).
    def decode_state(self, state, table):
        owner, count, cur, hof = (int(x) for x in state)
        return (table.lookup(owner - 1) if owner else None, count, cur,
                hof)

    def encode_state(self, decoded, table):
        owner, count, cur, hof = decoded
        return ((0 if owner is None else table.intern(owner) + 1),
                int(count), int(cur), int(hof))

    def describe_op(self, opcode, a1, a2, table):
        if opcode == ACQUIRE:
            fence = "?" if a2 == UNKNOWN else a2
            return f"acquire (fence {fence}) by {table.lookup(a1)!r}"
        return f"release by {table.lookup(a1)!r}"


@register_model
class Semaphore(Model):
    """Counting semaphore with ``capacity`` permits (hazelcast
    AcquiredPermitsModel, hazelcast.clj:630-649). Op value = permit count."""

    name = "semaphore"
    state_width = 1
    n_opcodes = 2

    def __init__(self, capacity: int = 1):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity

    def cache_args(self):
        return (self.capacity,)

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        return (0,)

    def encode_op(self, iv, table: ValueTable) -> Optional[tuple[int, int, int]]:
        n = _count(iv)
        if iv.f == "acquire":
            return (ACQUIRE, n, 0)
        if iv.f == "release":
            return (RELEASE, n, 0)
        raise EncodeError(f"semaphore: unknown f {iv.f!r}")

    def step_scalar(self, state, opcode, a1, a2):
        (acquired,) = state
        if opcode == ACQUIRE:
            return (acquired + a1 <= self.capacity, (acquired + a1,))
        return (acquired >= a1, (max(acquired - a1, 0),))

    def step_torch(self, states, opcodes, a1s, a2s):
        acquired = states[..., 0]
        is_acq = opcodes == ACQUIRE
        total = acquired + a1s
        ok = (is_acq & (total <= self.capacity)) | (~is_acq & (acquired >= a1s))
        acq2 = torch.where(is_acq, total, (acquired - a1s).clamp(min=0))
        return ok, acq2[..., None]

    def describe_op(self, opcode, a1, a2, table):
        verb = "acquire" if opcode == ACQUIRE else "release"
        return f"{verb} {a1} permit(s)"
