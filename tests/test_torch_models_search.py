"""The port's device search against the JAX reference's
``check_encoded_device`` for every device model besides the registers:
equal verdicts, levels, per-level ``[level, frontier, expanded,
overflow]`` rows, capacity attempts and refutation witnesses, all exact.
The port runs on the CPU (the plain version of every stage, so each
model's ``step_torch``); the reference's rows come from its telemetry
events. Also one BFS level at state widths 2, 3, 4 and 8 from the same
frontier, in the manner of ``tests/test_torch_wgl_level.py``.

Histories come from the port's ``random_model_history`` (an atomic
service of the model, linearizable unless perturbed) and, for the
owner-aware mutex, ``random_lock_history``; both packages get the same op
rows. Each port model is built from the reference model's cache args;
shapes are padded per model so the reference compiles few programs."""

import random

import numpy as np
import pytest

import jepsen_tpu.models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.telemetry import Registry
from jepsen_tpu.testing import random_lock_history as ref_random_lock
from jepsen_tpu_torch.ops import wgl, wgl_host
from jepsen_tpu_torch.ops import wgl_level as lv
from jepsen_tpu_torch.ops.encode import encode_history
from jepsen_tpu_torch.testing import (HISTORY_MODELS, history_model, random_lock_history,
                                      random_model_history)

SCHEDULE = (16, 64)
PAD_TO = (32, 1, 64, 32)  # (W, KO, ND, NO)
# (model, seed, n_ops, n_procs, crash_p, perturb): one valid and one
# perturbed history of each model, and one with many crashed (open) ops.
CASES = [(name, 10 + i, 30 + 4 * (i % 5), 4 + i % 3, 0.05, perturb)
         for i, name in enumerate(HISTORY_MODELS) for perturb in (False, True)] + \
    [(name, 40 + i, 36, 5, 0.3, i % 2 == 1) for i, name in enumerate(HISTORY_MODELS)]


def to_ref_history(h):
    return RefHistory([RefOp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                       for o in h], reindex=False)


def ref_model(port):
    """The reference's counterpart of a port model instance."""
    return ref_models._REGISTRY[port.name]._from_cache_key(port.cache_args())


def _attempts(res):
    return [(a["F"], a["levels"], a["calls"]) for a in res["attempts"]]


def compare(port_model, h, **kw):
    """Both searches of history ``h`` (the port's), compared; returns the
    port's result."""
    reg = Registry()
    ref = ref_wgl.check_encoded_device(ref_encode(ref_model(port_model), to_ref_history(h)),
                                       metrics=reg, **kw)
    port = wgl.check_encoded_device(encode_history(port_model, h), collect_stats=True,
                                    device="cpu", **kw)
    ref_rows = [[e["level"], e["frontier"], e["expanded"], int(e["overflow"])]
                for e in reg.events("wgl_level")]
    assert port["valid"] == ref["valid"]
    assert port["levels"] == ref["levels"]
    assert port["level_stats"] == ref_rows
    assert _attempts(port) == _attempts(ref)
    assert port.get("stuck_configs") == ref.get("stuck_configs")
    for k in ("frontier_max", "window", "beam", "max_linearized", "phase"):
        assert port.get(k) == ref.get(k), k
    return port


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'bad' if c[5] else 'ok'}"
                         f"{'-crashy' if c[4] > 0.1 else ''}")
def test_model_search_matches_reference(case):
    name, seed, n_ops, n_procs, crash_p, perturb = case
    h = random_model_history(random.Random(seed), name, n_ops=n_ops, n_procs=n_procs,
                             crash_p=crash_p, perturb=perturb)
    model = history_model(name)
    port = compare(model, h, f_schedule=SCHEDULE, pad_to=PAD_TO)
    host = wgl_host.check_history_host(model, h)
    if not perturb:
        assert port["valid"] is True
    if port["valid"] is False:
        assert port["stuck_configs"] and host["valid"] is False


def test_perturbed_histories_are_refuted():
    """Most perturbed cases above are refutations (checked on the port's
    host oracle alone, cheap), so the witnesses are compared."""
    refuted = 0
    for name, seed, n_ops, n_procs, crash_p, perturb in CASES:
        if perturb:
            h = random_model_history(random.Random(seed), name, n_ops=n_ops,
                                     n_procs=n_procs, crash_p=crash_p, perturb=True)
            refuted += wgl_host.check_history_host(history_model(name), h)["valid"] is False
    assert refuted >= 7


@pytest.mark.parametrize("seed", [0, 1])
def test_lock_history_search_matches_reference(seed):
    """``random_lock_history`` draws the same history in both packages;
    the owner-aware mutex's search on it matches."""
    h = random_lock_history(random.Random(seed), n_ops=40, n_procs=5)
    ref_h = ref_random_lock(random.Random(seed), n_ops=40, n_procs=5)
    assert [(o.type, o.process, o.f, o.value, o.time) for o in h] == \
        [(o.type, o.process, o.f, o.value, o.time) for o in ref_h]
    port = compare(history_model("owner-aware-mutex"), h, f_schedule=SCHEDULE, pad_to=PAD_TO)
    assert port["valid"] is True


def _rows(p, mD, mO, st, valid):
    v = np.asarray(valid).astype(bool)
    cols = [np.asarray(p)[:, None], np.asarray(mD).view(np.uint32).astype(np.int64),
            np.asarray(mO).view(np.uint32).astype(np.int64), np.asarray(st)]
    mat = np.concatenate([c.astype(np.int64) for c in cols], axis=1)[v]
    return sorted(map(tuple, mat.tolist()))


# (model, S, seed): one model of each state width above 1.
WIDTHS = [("fenced-mutex", 2, 4), ("multi-register", 3, 4), ("reentrant-fenced-mutex", 4, 4),
          ("bank", 8, 4)]


@pytest.mark.parametrize("name,S,seed", WIDTHS, ids=[f"S{w[1]}-{w[0]}" for w in WIDTHS])
def test_one_level_at_state_width_matches_reference(name, S, seed):
    """One level of the port from a frontier the reference walked to,
    carried across with ``plan_from_arrays``/``frontier_from_arrays``:
    the same flags, stats row and frontier rows, state lanes included."""
    model = history_model(name)
    assert model.state_width == S
    h = random_model_history(random.Random(seed), name, n_ops=40, n_procs=6, crash_p=0.1)
    enc = ref_encode(ref_model(model), to_ref_history(h))
    plan = ref_wgl.plan_device(enc, pad_to=PAD_TO)
    assert plan.ok, plan.reason
    W, KO, S_, ND, NO = plan.dims
    assert S_ == S
    F = 16
    _, kern = ref_wgl._build_kernel(ref_wgl._model_cache_key(enc.model), F, W, KO, S, ND, NO,
                                    B=plan.B, collect_stats=True)
    port_plan = wgl.plan_from_arrays(plan.dims, plan.args, plan.nD, plan.nO, plan.init_state,
                                     plan.B, device="cpu")
    g = wgl.level_geometry(port_plan, F)

    def ref_run(fr, max_levels):
        out = kern(*plan.args[:2], np.int32(max_levels), *plan.args[3:], *fr[:5],
                   np.int32(fr[5]), np.int32(1))
        return [int(x) for x in np.asarray(out[0])], np.asarray(out[1]), \
            tuple(np.asarray(a) for a in out[-5:])

    # Walk as a beam to the first level from level 4 on with more than one
    # config.
    fr0 = ref_wgl.initial_frontier(F, W, KO, S, plan.init_state)
    for k in range(4, 40):
        flags, _, front = ref_run(fr0, k)
        fr = front + (flags[3],)
        if flags[2] and int(np.asarray(fr[4]).sum()) > 1:
            break
    else:
        raise AssertionError("no level with more than one config")
    lvl0 = int(fr[5])
    ref_flags, ref_stats, ref_front = ref_run(fr, lvl0 + 1)
    port_fr = wgl.frontier_from_arrays(*fr, device="cpu")
    ws = lv.BatchWorkspace(g, 1, "cpu")
    flags = lv.run_chunk(lv.KERNELS, g, port_plan.tabs, port_fr[:5], ws, lvl0, lvl0 + 1,
                         True, port_plan.nD, port_plan.nO, model)
    assert flags == ref_flags
    slot = (lvl0 + 1) % lv.LEVEL_STAT_ROWS
    assert ws.stats[0, slot].tolist() == ref_stats[slot].tolist()
    assert _rows(*[a.numpy() for a in port_fr[:5]]) == _rows(*ref_front)
    assert port_fr[3].shape[-1] == S
