"""The port's models against the reference's: ``step_torch`` against
``step_jax`` and ``step_scalar`` on seeded inputs, the host-only queues'
``step_scalar``, and the registry. Every comparison is exact (all values
are integers).

Each device model gets 4096 seeded rows of two kinds. *Plain* rows are
the defined inputs: states reached from the initial state by the model's
own steps, defined opcodes, op values of the model's op shapes (lanes
inside the state, positive permit counts, set bits of the 31-element
mask). *Edge* rows are anything: opcodes out of range, ``UNKNOWN`` in
states and arguments, and values near +-2**31 that make the int32
arithmetic wrap (lane indices stay those an encoding can give).
``step_torch`` must equal ``step_jax`` on both kinds; ``step_scalar``
(plain Python ints, no wrap) must agree with it on the plain rows, and for
the two single registers on the edge rows too."""

import random

import numpy as np
import pytest
import torch

import jepsen_tpu.models as ref_models
import jepsen_tpu_torch.models as port_models
from jepsen_tpu_torch.models import UNKNOWN

I32_MIN, I32_MAX = -2**31, 2**31 - 1

# id -> reference model; the port's is built from its cache args.
DEVICE_MODELS = {
    "cas-register": ref_models.CasRegister(init=0),
    "register": ref_models.Register(init=0),
    "multi-register": ref_models.MultiRegister({0: None, 1: None, 2: None}),
    "counter": ref_models.Counter(0),
    "set": ref_models.LwSet(),
    "bank": ref_models.Bank({i: 12 for i in range(8)}),
    "mutex": ref_models.Mutex(),
    "owner-aware-mutex": ref_models.OwnerAwareMutex(),
    "reentrant-mutex": ref_models.ReentrantMutex(2),
    "fenced-mutex": ref_models.FencedMutex(),
    "reentrant-fenced-mutex": ref_models.ReentrantFencedMutex(),
    "semaphore": ref_models.Semaphore(2),
}


def port_model(ref):
    """The port's counterpart of a reference model instance."""
    return port_models.model_class(ref.name)._from_cache_key(ref.cache_args())


def _maybe_unknown(rng, v, p=0.1):
    return UNKNOWN if rng.random() < p else v


def _plain_op(name, S, rng):
    """(opcode, a1, a2) of a defined op of model ``name``'s op shapes."""
    if name in ("cas-register", "register"):
        op = rng.randrange(3 if name == "cas-register" else 2)
        a1 = _maybe_unknown(rng, rng.randrange(5)) if op == 0 else rng.randrange(5)
        return op, a1, rng.randrange(5)
    if name == "multi-register":
        op = rng.randrange(2)
        v = rng.randrange(5)
        return op, rng.randrange(S), _maybe_unknown(rng, v) if op == 0 else v
    if name == "counter":
        op = rng.randrange(2)
        return (op, _maybe_unknown(rng, rng.randrange(-5, 20)), 0) if op == 0 else \
            (op, rng.randrange(-3, 4), 0)
    if name == "set":
        op = rng.randrange(3)
        if op == 2:
            return op, _maybe_unknown(rng, rng.randrange(32)), 0
        return op, 1 << rng.randrange(5), 0
    if name == "bank":
        if rng.random() < 0.5:
            return 0, rng.randrange(S), _maybe_unknown(rng, rng.randrange(30))
        return 1, rng.randrange(S) * S + rng.randrange(S), rng.randrange(1, 6)
    if name == "semaphore":
        return rng.randrange(2), rng.randrange(1, 3), 0
    op = rng.randrange(2)
    proc = rng.randrange(4) if name != "mutex" and name != "reentrant-mutex" else 0
    fence = _maybe_unknown(rng, rng.randrange(10), 0.3) if op == 0 else 0
    return op, proc, fence if "fenced" in name else 0


def _edge_value(rng):
    k = rng.randrange(4)
    if k == 0:
        return rng.randrange(-3, 8)
    if k == 1:
        return UNKNOWN
    if k == 2:
        return I32_MAX - rng.randrange(4)
    return I32_MIN + rng.randrange(1, 4)


def _edge_op(name, S, n_opcodes, rng):
    op = rng.randrange(-1, n_opcodes + 1)
    a1, a2 = _edge_value(rng), _edge_value(rng)
    if name == "multi-register":
        a1 = rng.randrange(S)
    elif name == "bank":
        a1 = rng.randrange(S * S)
    return op, a1, a2


def _reachable_states(model, rng, n):
    """``n`` states reached from the initial state by defined steps."""
    st = tuple(model.init_state(port_models.ValueTable()))
    out = []
    while len(out) < n:
        op = _plain_op(model.name, model.state_width, rng)
        ok, st2 = model.step_scalar(st, *op)
        if ok:
            st = st2
        if rng.random() < 0.02:
            st = tuple(model.init_state(port_models.ValueTable()))
        out.append(st)
    return out


def _inputs(model, seed, n=4096):
    """(states, opcodes, a1, a2, plain) int32 arrays; ``plain`` marks the
    rows of defined inputs."""
    rng = random.Random(seed)
    S = model.state_width
    n_plain = n // 2
    states = _reachable_states(model, rng, n_plain)
    ops = [_plain_op(model.name, S, rng) for _ in range(n_plain)]
    for _ in range(n - n_plain):
        states.append(tuple(_edge_value(rng) for _ in range(S)))
        ops.append(_edge_op(model.name, S, model.n_opcodes, rng))
    order = np.random.default_rng(seed).permutation(n)
    states = np.asarray(states, dtype=np.int32)[order]
    opcodes, a1, a2 = (np.asarray(c, dtype=np.int32)[order] for c in zip(*ops))
    plain = (np.arange(n) < n_plain)[order]
    return states, opcodes, a1, a2, plain


@pytest.mark.parametrize("models", [(r, port_model(r)) for r in DEVICE_MODELS.values()],
                         ids=list(DEVICE_MODELS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_torch_matches_reference(models, seed):
    import jax.numpy as jnp

    ref, port = models
    states, opcodes, a1, a2, plain = _inputs(port, seed)
    ok_j, st_j = ref.step_jax(jnp.asarray(states), jnp.asarray(opcodes),
                              jnp.asarray(a1), jnp.asarray(a2))
    ok_t, st_t = port.step_torch(torch.from_numpy(states), torch.from_numpy(opcodes),
                                 torch.from_numpy(a1), torch.from_numpy(a2))
    assert st_t.dtype == torch.int32 and st_t.shape == states.shape
    assert np.array_equal(np.asarray(ok_j), ok_t.numpy())
    assert np.array_equal(np.asarray(st_j), st_t.numpy())
    # and the scalar oracle, row by row, on the defined inputs; the single
    # registers' scalar step does no arithmetic, so it also takes the edge
    # rows' off-range states and arguments, at its three opcodes
    rows = plain
    if ref.name in ("cas-register", "register"):
        rows = plain | ((opcodes >= 0) & (opcodes <= 2))
    for i in np.flatnonzero(rows):
        st = tuple(int(x) for x in states[i])
        ok_s, st_s = port.step_scalar(st, int(opcodes[i]), int(a1[i]), int(a2[i]))
        assert ok_s == bool(ok_t[i]), i
        if ok_s:
            assert st_s == tuple(int(x) for x in st_t[i]), i


def test_edge_rows_wrap_like_int32():
    """The edge rows reach the wrap: a counter add and a semaphore acquire
    past int32's maximum come out negative, in both packages."""
    import jax.numpy as jnp

    for name, op in (("counter", 1), ("semaphore", 0)):
        ref = DEVICE_MODELS[name]
        st = np.array([[I32_MAX - 1]], dtype=np.int32)
        args = [np.array([v], dtype=np.int32) for v in (op, 3, 0)]
        ok_j, st_j = ref.step_jax(jnp.asarray(st), *map(jnp.asarray, args))
        ok_t, st_t = port_model(ref).step_torch(torch.from_numpy(st),
                                                *map(torch.from_numpy, args))
        assert int(st_t[0, 0]) == int(np.asarray(st_j)[0, 0]) == I32_MIN + 1
        assert bool(ok_t[0]) == bool(np.asarray(ok_j)[0])


@pytest.mark.parametrize("name", ["unordered-queue", "fifo-queue"])
@pytest.mark.parametrize("seed", [0, 1])
def test_queue_step_scalar_matches_reference(name, seed):
    ref, port = ref_models.model_by_name(name), port_models.model_by_name(name)
    assert port.device_capable is False and ref.device_capable is False
    rng = random.Random(seed)
    st_r = st_p = ()
    for _ in range(400):
        op, a1 = rng.randrange(2), rng.randrange(4)
        r, p = ref.step_scalar(st_r, op, a1, 0), port.step_scalar(st_p, op, a1, 0)
        assert r == p
        if r[0]:
            st_r, st_p = r[1], p[1]


def test_registry_matches_reference():
    assert list(port_models.known_models()) == list(ref_models.known_models())
    assert len(port_models.known_models()) == 14
    for name in ref_models.known_models():
        cls = port_models.model_class(name)
        assert cls.name == name
        assert cls.device_capable == ref_models._REGISTRY[name].device_capable
    with pytest.raises(KeyError, match="unknown model"):
        port_models.model_by_name("no-such-model")


@pytest.mark.parametrize("ref", list(DEVICE_MODELS.values())
                         + [ref_models.UnorderedQueue(), ref_models.FIFOQueue()],
                         ids=list(DEVICE_MODELS) + ["unordered-queue", "fifo-queue"])
def test_model_carries_across_by_cache_key(ref):
    port = port_model(ref)
    assert type(port).__name__ == type(ref).__name__
    assert port.cache_key() == ref.cache_key()
    assert port.cache_args() == ref.cache_args()
    assert port.device_capable == ref.device_capable
    if ref.name in ("cas-register", "register"):
        return  # the initial value is not part of a register's step identity
    rt, pt = ref_models.ValueTable(), port_models.ValueTable()
    assert tuple(port.init_state(pt)) == tuple(ref.init_state(rt))
    assert pt.values == rt.values


def test_every_device_model_has_a_kernel_step():
    """``step_spec`` names a ``STEP_*`` id of the expand kernel for every
    device model, with the id the CUDA source defines for it, and refuses
    a subclass (which may change the step) and the host-only queues."""
    import re
    from pathlib import Path

    from jepsen_tpu_torch.ops import wgl_level as lv

    src = (Path(lv.__file__).resolve().parent.parent / "csrc" / "wgl_level.cu").read_text()
    defined = {m[0]: int(m[1]) for m in re.findall(r"#define STEP_(\w+) (\d+)", src)}
    for ref in DEVICE_MODELS.values():
        port = port_model(ref)
        sid, prm = lv.step_spec(port)
        name = "CAS_REGISTER" if port.name == "register" else \
            port.name.upper().replace("-", "_")
        assert defined[name] == sid, port.name
    assert lv.step_spec(port_models.ReentrantMutex(3)) == (defined["REENTRANT_MUTEX"], 3)
    assert lv.step_spec(port_models.Semaphore(5)) == (defined["SEMAPHORE"], 5)
    assert lv.step_spec(port_models.ReentrantFencedMutex())[1] == 2

    class Sub(port_models.Mutex):
        pass

    for m in (Sub(), port_models.FIFOQueue(), port_models.UnorderedQueue()):
        with pytest.raises(ValueError, match="no step"):
            lv.step_spec(m)
