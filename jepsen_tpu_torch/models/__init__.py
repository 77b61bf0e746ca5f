"""Consistency models.

Each model carries two step implementations over one integer encoding:

- ``step_scalar(state, opcode, a1, a2) -> (ok, state')`` — plain Python on
  tuples of ints; the trusted oracle used by the host checker.
- ``step_torch(states, opcodes, a1s, a2s) -> (ok, states')`` — the same
  transition over a batch of configurations with torch tensors; the plain
  version of the step the CUDA expand kernel inlines.

States are fixed-width int32 lane tuples. Op values are interned to dense
int ids by :class:`ValueTable` at encode time; models only ever see ints.
``UNKNOWN`` marks an unobserved value that matches anything.

Device steps wrap like int32 arithmetic (two's complement), as the
reference's do; ``step_torch`` keeps int32 tensors so that it wraps the
same way.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

# int32-safe sentinel: an interned value id can never equal it.
UNKNOWN = -(2**31)


class ValueTable:
    """Interns arbitrary hashable op values to dense non-negative int ids."""

    def __init__(self) -> None:
        self.ids: dict[Any, int] = {}
        self.values: list[Any] = []

    def intern(self, v: Any) -> int:
        v = _freeze(v)
        i = self.ids.get(v)
        if i is None:
            i = len(self.values)
            self.ids[v] = i
            self.values.append(v)
        return i

    def lookup(self, i: int) -> Any:
        if i == UNKNOWN:
            return None
        return self.values[i]

    def __len__(self) -> int:
        return len(self.values)


def _freeze(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_freeze(e) for e in v)
    if isinstance(v, dict):
        return tuple(sorted(((k, _freeze(x)) for k, x in v.items()), key=repr))
    if isinstance(v, set):
        return frozenset(_freeze(e) for e in v)
    return v


class EncodeError(Exception):
    """Raised when an op cannot be expressed in the model's encoding."""


class Model:
    """Base class. Subclasses define the encoding + transition function.

    ``name`` is the registry key, ``state_width`` the number of int32
    state lanes, ``n_opcodes`` the size of the opcode space.
    """

    name: str = "model"
    state_width: int = 1
    n_opcodes: int = 1
    device_capable: bool = True  # False: no device step (the host oracle runs it)

    def init_state(self, table: ValueTable) -> tuple[int, ...]:
        raise NotImplementedError

    def encode_op(self, interval, table: ValueTable) -> Optional[tuple[int, int, int]]:
        """Map a paired op to ``(opcode, a1, a2)`` ints, or ``None`` to drop
        it as irrelevant to the model."""
        raise NotImplementedError

    def step_scalar(
        self, state: tuple[int, ...], opcode: int, a1: int, a2: int
    ) -> tuple[bool, tuple[int, ...]]:
        raise NotImplementedError

    def step_torch(self, states, opcodes, a1s, a2s):
        """Batched transition. ``states``: int32 [N, state_width];
        ``opcodes``/``a1s``/``a2s``: int32 [N]. Returns (ok [N] bool,
        states' [N, state_width])."""
        raise NotImplementedError

    def decode_state(self, state: Sequence[int], table: ValueTable) -> tuple:
        return tuple(int(x) for x in state)

    def encode_state(self, decoded: tuple, table: ValueTable) -> tuple[int, ...]:
        return tuple(int(x) for x in decoded)

    # The identity of a model's behaviour: histories of one batch must
    # share it, since the batch runs one step function for every member.
    def cache_key(self) -> tuple:
        return (self.name, self.state_width, self.n_opcodes)

    def cache_args(self) -> tuple:
        """Hashable constructor args that affect the step's behaviour."""
        return ()

    @classmethod
    def _from_cache_key(cls, args: tuple) -> "Model":
        """An instance with the behaviour ``cache_args()`` names (plain
        Python values: this is how a model crosses from one package to
        the other)."""
        return cls(*args)

    def describe_op(self, opcode: int, a1: int, a2: int, table: ValueTable) -> str:
        return f"op{opcode}({a1}, {a2})"

    def __repr__(self) -> str:
        return f"<model {self.name}>"


_REGISTRY: dict[str, Callable[..., Model]] = {}


def register_model(cls):
    """Class decorator: adds the model to the by-name registry."""
    _REGISTRY[cls.name] = cls
    return cls


def model_class(name: str) -> Callable[..., Model]:
    """The registered class named ``name``."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}") from None


def model_by_name(name: str, *args: Any, **kw: Any) -> Model:
    return model_class(name)(*args, **kw)


def known_models() -> Sequence[str]:
    return sorted(_REGISTRY)


# Import concrete models for their registration side effects.
from .register import CasRegister, MultiRegister, Register  # noqa: E402,F401
from .counter import Counter  # noqa: E402,F401
from .sets import LwSet  # noqa: E402,F401
from .bank import Bank  # noqa: E402,F401
from .mutex import (  # noqa: E402,F401
    FencedMutex,
    Mutex,
    OwnerAwareMutex,
    ReentrantFencedMutex,
    ReentrantMutex,
    Semaphore,
)
from .queue import FIFOQueue, UnorderedQueue  # noqa: E402,F401
