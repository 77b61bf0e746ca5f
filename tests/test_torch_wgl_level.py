"""One BFS level of the port against one level of the JAX reference's
level program, from the same frontier and tables (exact equality of the
flags, the stats row and the valid frontier rows).

The reference level is ``_build_kernel(..., collect_stats=True)`` run with
``max_levels = lvl0 + 1``; the port's tables and frontier are carried
across with ``plan_from_arrays`` / ``frontier_from_arrays``."""

import random

import numpy as np
import pytest

from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops import wgl_level as lv

# (id, crash_p, pad_to (W, KO, ND, NO), F, SEL, two_stage, lossy, want_ovf)
CASES = [
    ("sel0-ko0-kd1-lossless", 0.0, (32, 0, 64, 32), 16, False, False, False, True),
    ("sel1-ko1-kd1-lossless", 0.2, (32, 1, 64, 32), 16, True, False, False, True),
    ("sel1-ko1-kd1-fits", 0.2, (32, 1, 64, 32), 128, True, False, False, False),
    ("sel1-ko1-kd1-2stage-lossless", 0.2, (32, 1, 64, 32), 16, True, True, False, True),
    ("sel0-ko1-kd2-2stage-fits", 0.2, (64, 1, 64, 32), 128, False, True, False, False),
    ("sel1-ko2-kd2-lossless", 0.2, (64, 2, 64, 64), 16, True, False, False, True),
    ("sel0-ko2-kd1-lossy", 0.2, (32, 2, 64, 64), 16, False, False, True, True),
    ("sel1-ko0-kd2-2stage-lossy", 0.0, (64, 0, 64, 32), 16, True, True, True, True),
    ("sel1-ko1-kd1-lossy", 0.2, (32, 1, 64, 32), 16, True, False, True, True),
]


def _rows(p, mD, mO, st, valid):
    v = np.asarray(valid).astype(bool)
    cols = [np.asarray(p)[:, None], np.asarray(mD).view(np.uint32).astype(np.int64),
            np.asarray(mO).view(np.uint32).astype(np.int64), np.asarray(st)]
    mat = np.concatenate([c.astype(np.int64) for c in cols], axis=1)[v]
    return sorted(map(tuple, mat.tolist()))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_one_level_matches_reference(case, monkeypatch):
    _id, crash_p, pad_to, F, sel, two_stage, lossy, want_ovf = case
    if two_stage:
        monkeypatch.setattr(ref_wgl, "BIG_M_THRESHOLD", 64)
        monkeypatch.setattr(wgl, "BIG_M_THRESHOLD", 64)
        ref_wgl._build_kernel.cache_clear()
    try:
        _run(crash_p, pad_to, F, sel, two_stage, lossy, want_ovf)
    finally:
        if two_stage:
            ref_wgl._build_kernel.cache_clear()


def _run(crash_p, pad_to, F, sel, two_stage, lossy, want_ovf):
    h = ref_random(random.Random(7), n_ops=40, n_procs=10, crash_p=crash_p)
    enc = ref_encode(RefCas(init=0), h)
    plan = ref_wgl.plan_device(enc, pad_to=pad_to)
    assert plan.ok, plan.reason
    W, KO, S, ND, NO = plan.dims
    B = plan.B if sel else None
    if sel:
        assert B is not None and B < W + 32 * KO
    _, kern = ref_wgl._build_kernel(ref_wgl._model_cache_key(enc.model), F, W, KO,
                                    S, ND, NO, B=B, collect_stats=True)
    port_plan = wgl.plan_from_arrays(plan.dims, plan.args, plan.nD, plan.nO,
                                     plan.init_state, B, device="cpu")
    g = wgl.level_geometry(port_plan, F)
    assert (g.SEL, g.two_stage) == (sel, two_stage)

    def ref_run(fr, max_levels, lossy_):
        out = kern(*plan.args[:2], np.int32(max_levels), *plan.args[3:], *fr[:5],
                   np.int32(fr[5]), np.int32(lossy_))
        flags = [int(x) for x in np.asarray(out[0])]
        return flags, np.asarray(out[1]), tuple(np.asarray(a) for a in out[-5:])

    # Walk (as a beam, so overflow does not stop it) to a level whose next
    # step overflows or fits as the case asks.
    fr0 = ref_wgl.initial_frontier(F, W, KO, S, plan.init_state)
    chosen = None
    for k in range(1, 30):
        flags, _, front = ref_run(fr0, k, 1)
        fr = front + (flags[3],)
        if not flags[2]:
            break
        f1, stats1, _ = ref_run(fr, fr[5] + 1, int(lossy))
        if bool(f1[1]) == want_ovf and f1[3] > 0:
            chosen = fr
            break
    assert chosen is not None, "no level with the wanted overflow outcome"
    fr = chosen
    lvl0 = int(fr[5])
    ref_flags, ref_stats, ref_front = ref_run(fr, lvl0 + 1, int(lossy))

    port_fr = wgl.frontier_from_arrays(*fr, device="cpu")
    ws = lv.BatchWorkspace(g, 1, port_plan.device)
    nDO = (port_plan.nD, port_plan.nO)
    flags = lv.run_chunk(lv.KERNELS, g, port_plan.tabs, port_fr[:5], ws, lvl0,
                         lvl0 + 1, lossy, *nDO, CasRegister(init=0))
    assert flags == ref_flags
    slot = (lvl0 + 1) % lv.LEVEL_STAT_ROWS
    assert ws.stats[0, slot].tolist() == ref_stats[slot].tolist()
    assert _rows(*[a.numpy() for a in port_fr[:5]]) == _rows(*ref_front)
    # The plain stages called directly give the same level.
    port_fr2 = wgl.frontier_from_arrays(*fr, device="cpu")
    ws2 = lv.BatchWorkspace(g, 1, port_plan.device)
    assert lv.run_chunk(lv.PLAIN, g, port_plan.tabs, port_fr2[:5], ws2, lvl0,
                        lvl0 + 1, lossy, *nDO, CasRegister(init=0)) == ref_flags
