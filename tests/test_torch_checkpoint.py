"""Search checkpoints (``checkpoint_path=``) of the port's single and
sharded drivers, on the CPU: a search interrupted by its chunk callback
and resumed from its file ends with the verdict, levels and per-level
stats rows of an uninterrupted search; the file's arrays equal the JAX
reference's file at the same chunk (only the fingerprint differs: it
hashes the model's class, whose path differs between the packages); a
stale, corrupt or foreign file is ignored; the file goes on a definite
verdict and stays on ``unknown``; a sharded file resumes across exchange
modes and mesh sizes, and in the single driver."""

import os
import random

import numpy as np
import pytest
import torch

from jepsen_tpu.models import CasRegister as RefCas
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.parallel import frontier as ref_frontier
from jepsen_tpu.parallel import make_mesh as ref_make_mesh
from jepsen_tpu.testing import perturb_history as ref_perturb
from jepsen_tpu.testing import random_register_history as ref_random
from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.ops.encode import encode_history
from jepsen_tpu_torch.parallel import frontier, make_mesh
from jepsen_tpu_torch.testing import perturb_history, random_register_history


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain stages run many small ops: one intra-op thread each keeps
    a worker from oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_ambient_kill_switch(monkeypatch):
    monkeypatch.delenv("JEPSEN_WGL_EXCHANGE", raising=False)


class Interrupt(Exception):
    pass


def _stop_after(n):
    seen = []

    def cb(info):
        seen.append(info)
        if len(seen) == n:
            raise Interrupt

    return cb


def _histories(seed, n_ops=40, n_procs=5, crash_p=0.1, perturb=False):
    r1, r2 = random.Random(seed), random.Random(seed)
    kw = dict(n_ops=n_ops, n_procs=n_procs, crash_p=crash_p)
    h1, h2 = ref_random(r1, **kw), random_register_history(r2, **kw)
    if perturb:
        h1, h2 = ref_perturb(r1, h1), perturb_history(r2, h2)
    return h1, h2


def _rows(reg):
    return [[e["level"], e["frontier"], e["expanded"], int(e["overflow"])]
            for e in reg.events("wgl_level")]


# (seed, perturb, f_schedule, optimistic, levels_per_call, interrupt after chunk)
SINGLE = [
    (60, False, (16, 32, 64), True, 8, 2),     # the optimistic beam's phase
    (61, True, (16, 32, 64), True, 4, 1),
    (0, False, (16, 64), None, 8, 2),          # exhaustive
    (40, False, (2, 4096), None, 8, 3),        # across escalations
    (1, True, (16, 64), None, 4, 1),           # a refutation
]


def _single(h, tmp_path=None, cb=None, reg=None, case=None, **kw):
    seed, perturb, sched, optimistic, lpc, _k = case
    return wgl.check_encoded_device(
        encode_history(CasRegister(init=0), h), f_schedule=sched, optimistic=optimistic,
        levels_per_call=lpc, pad_to=(32, 1, 64, 32), device="cpu", chunk_callback=cb,
        metrics=reg, **kw)


@pytest.mark.parametrize("case", SINGLE, ids=lambda c: f"seed{c[0]}")
def test_interrupted_search_resumes_to_the_same_result(case, tmp_path):
    """Interrupted after chunk k and resumed: the verdict, the levels and
    the per-level stats rows (the interrupted run's and the resumed run's
    together) of the uninterrupted search; the file goes on a definite
    verdict."""
    _h1, h2 = _histories(case[0], perturb=case[1])
    whole = _single(h2, case=case, collect_stats=True)
    path = str(tmp_path / "ck.npz")
    first = telemetry.Registry()
    with pytest.raises(Interrupt):
        _single(h2, case=case, cb=_stop_after(case[5]), reg=first, checkpoint_path=path)
    assert os.path.exists(path)
    res = _single(h2, case=case, checkpoint_path=path, collect_stats=True)
    assert (res["valid"], res["levels"]) == (whole["valid"], whole["levels"])
    assert _rows(first) + res["level_stats"] == whole["level_stats"]
    assert os.path.exists(path) == (res["valid"] == "unknown")


@pytest.mark.parametrize("case", SINGLE[:4], ids=lambda c: f"seed{c[0]}")
def test_checkpoint_file_matches_reference(case, tmp_path):
    """Both packages interrupted at the same chunk: every array of the two
    npz files but the fingerprint is equal, dtype and shape included."""
    seed, perturb, sched, optimistic, lpc, k = case
    h1, h2 = _histories(seed, perturb=perturb)
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    with pytest.raises(Interrupt):
        ref_wgl.check_encoded_device(ref_encode(RefCas(init=0), h1), f_schedule=sched,
                                     optimistic=optimistic, levels_per_call=lpc,
                                     pad_to=(32, 1, 64, 32), checkpoint_path=ref_path,
                                     chunk_callback=_stop_after(k))
    with pytest.raises(Interrupt):
        _single(h2, case=case, cb=_stop_after(k), checkpoint_path=port_path)
    r, p = np.load(ref_path), np.load(port_path)
    assert sorted(r.files) == sorted(p.files)
    for name in r.files:
        if name == "fingerprint":
            continue
        assert r[name].dtype == p[name].dtype and r[name].shape == p[name].shape, name
        assert np.array_equal(r[name], p[name]), name
    assert str(r["fingerprint"]) != str(p["fingerprint"])


@pytest.mark.parametrize("kind", ["stale", "corrupt", "foreign"])
def test_unusable_checkpoint_is_ignored(kind, tmp_path):
    """Another history's file (a stale fingerprint), bytes that are no npz,
    and the reference's own file for this history (its fingerprint hashes
    its model class) are ignored: the search runs from level 0."""
    case = SINGLE[2]
    h1, h2 = _histories(case[0])
    path = str(tmp_path / "ck.npz")
    if kind == "stale":
        _o1, other = _histories(5)
        with pytest.raises(Interrupt):
            _single(other, case=case, cb=_stop_after(1), checkpoint_path=path)
    elif kind == "corrupt":
        with open(path, "wb") as fh:
            fh.write(b"not an npz" * 10)
    else:
        with pytest.raises(Interrupt):
            ref_wgl.check_encoded_device(ref_encode(RefCas(init=0), h1), f_schedule=case[2],
                                         levels_per_call=case[4], pad_to=(32, 1, 64, 32),
                                         checkpoint_path=path, chunk_callback=_stop_after(1))
    assert os.path.exists(path)
    whole = _single(h2, case=case, collect_stats=True)
    res = _single(h2, case=case, checkpoint_path=path, collect_stats=True)
    assert "resumed_from_level" not in res
    assert (res["valid"], res["levels"], res["level_stats"]) == \
        (whole["valid"], whole["levels"], whole["level_stats"])


def test_checkpoint_kept_on_unknown(tmp_path):
    """A search that ends ``unknown`` (a beam that ran out) keeps its file,
    in both packages."""
    path = str(tmp_path / "ck.npz")
    ref_path = str(tmp_path / "ref.npz")
    for seed in range(200, 260):
        h1, h2 = _histories(seed, n_ops=60, n_procs=8, crash_p=0.3)
        kw = dict(f_schedule=(2, 4), levels_per_call=8, pad_to=(32, 1, 64, 32))
        res = wgl.check_encoded_device(encode_history(CasRegister(init=0), h2), device="cpu",
                                       checkpoint_path=path, **kw)
        if res["valid"] == "unknown":
            break
        assert not os.path.exists(path)
    assert res["valid"] == "unknown" and os.path.exists(path)
    ref = ref_wgl.check_encoded_device(ref_encode(RefCas(init=0), h1), checkpoint_path=ref_path,
                                       **kw)
    assert ref["valid"] == "unknown" and os.path.exists(ref_path)


_REF_MESHES = {}


def _ref_mesh(D):
    if D not in _REF_MESHES:
        _REF_MESHES[D] = ref_make_mesh(D, shape=(D, 1))
    return _REF_MESHES[D]


def _sharded(h, mode, D, **kw):
    return frontier.check_history_sharded(CasRegister(init=0), h, mesh=make_mesh(D, device="cpu"),
                                          exchange=mode, levels_per_call=10, max_escalations=4,
                                          **kw)


@pytest.mark.parametrize("save,resume", [(("alltoall", 8), ("allgather", 8)),
                                         (("allgather", 8), ("alltoall", 2)),
                                         (("alltoall", 2), ("alltoall", 8)),
                                         (("alltoall", 8), ("allgather", 1))],
                         ids=lambda c: f"{c[0]}{c[1]}")
def test_sharded_checkpoint_resumes_across_modes_and_meshes(save, resume, tmp_path):
    """A sharded file holds the global row order: saved under one exchange
    mode and mesh, it resumes exactly under the other mode or another D
    (the width re-rounded to the new mesh's multiple), to the verdict and
    levels of an uninterrupted search on the resuming mesh, and of the
    reference's."""
    h1, h2 = _histories(77, n_ops=80, n_procs=6)
    path = str(tmp_path / "ck.npz")
    with pytest.raises(Interrupt):
        _sharded(h2, *save, f_total=16, checkpoint_path=path, chunk_callback=_stop_after(2))
    z = np.load(path)
    assert str(z["phase"]) == "sharded" and not bool(z["truncated"])
    level = int(z["lvl"])
    whole = _sharded(h2, *resume, f_total=16)
    res = _sharded(h2, *resume, f_total=16, checkpoint_path=path)
    assert (res["valid"], res["levels"]) == (whole["valid"], whole["levels"])
    assert res["resumed_from_level"] == level > 0
    ref = ref_frontier.check_history_sharded(RefCas(init=0), h1, mesh=_ref_mesh(resume[1]),
                                             exchange=resume[0], levels_per_call=10,
                                             max_escalations=4, f_total=16)
    assert (res["valid"], res["levels"]) == (ref["valid"], ref["levels"])
    assert os.path.exists(path) == (res["valid"] == "unknown")


def test_sharded_checkpoint_matches_reference(tmp_path):
    """The sharded file's arrays equal the reference's at the same chunk."""
    h1, h2 = _histories(77, n_ops=80, n_procs=6)
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    opts = dict(exchange="alltoall", levels_per_call=10, max_escalations=4, f_total=16)
    with pytest.raises(Interrupt):
        ref_frontier.check_history_sharded(RefCas(init=0), h1, mesh=_ref_mesh(8),
                                           checkpoint_path=ref_path,
                                           chunk_callback=_stop_after(3), **opts)
    with pytest.raises(Interrupt):
        frontier.check_history_sharded(CasRegister(init=0), h2, mesh=make_mesh(8, device="cpu"),
                                       checkpoint_path=port_path,
                                       chunk_callback=_stop_after(3), **opts)
    r, p = np.load(ref_path), np.load(port_path)
    assert sorted(r.files) == sorted(p.files)
    for name in r.files:
        if name != "fingerprint":
            assert r[name].dtype == p[name].dtype and np.array_equal(r[name], p[name]), name


def test_sharded_checkpoint_seeds_the_single_driver(tmp_path):
    """The formats are one: a lossless sharded file resumes the single
    driver's search, to the uninterrupted verdict and levels."""
    _h1, h2 = _histories(60)
    path = str(tmp_path / "ck.npz")
    with pytest.raises(Interrupt):
        _sharded(h2, "alltoall", 2, f_total=32, checkpoint_path=path,
                 chunk_callback=_stop_after(1))
    case = SINGLE[0]
    whole = _single(h2, case=case)
    res = _single(h2, case=case, checkpoint_path=path)
    assert (res["valid"], res["levels"]) == (whole["valid"], whole["levels"])


@pytest.mark.parametrize("case", SINGLE + [(40, False, (2, 4096), None, 8, 1),
                                           (60, False, (16, 32, 64), True, 8, 1)],
                         ids=lambda c: f"seed{c[0]}-k{c[5]}")
def test_resumed_search_matches_reference_resume(case, tmp_path):
    """Both packages interrupted after the same chunk and resumed from
    their own files: the resumed searches agree in verdict, levels,
    attempts and every per-level event. (A resume starts a rung at the
    saved level, in both packages: the checkpoint keeps the frontier,
    not the driver's escalation state, so a resume below the top capacity
    may take another capacity path than the uninterrupted search.)"""
    from jepsen_tpu.telemetry import Registry as RefRegistry

    seed, perturb, sched, optimistic, lpc, k = case
    h1, h2 = _histories(seed, perturb=perturb)
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_kw = dict(f_schedule=sched, optimistic=optimistic, levels_per_call=lpc,
                  pad_to=(32, 1, 64, 32))
    enc = ref_encode(RefCas(init=0), h1)
    with pytest.raises(Interrupt):
        ref_wgl.check_encoded_device(enc, checkpoint_path=ref_path,
                                     chunk_callback=_stop_after(k), **ref_kw)
    with pytest.raises(Interrupt):
        _single(h2, case=case, cb=_stop_after(k), checkpoint_path=port_path)
    ref_reg, port_reg = RefRegistry(), telemetry.Registry()
    ref = ref_wgl.check_encoded_device(enc, checkpoint_path=ref_path, metrics=ref_reg, **ref_kw)
    port = _single(h2, case=case, checkpoint_path=port_path, reg=port_reg)
    att = lambda r: [(a["F"], a["levels"], a["calls"]) for a in r["attempts"]]  # noqa: E731
    for key in ("valid", "levels", "phase", "beam", "resumed_from_level"):
        assert port.get(key) == ref.get(key), key
    assert att(port) == att(ref)
    assert port_reg.events("wgl_level") == ref_reg.events("wgl_level")
    assert os.path.exists(port_path) == os.path.exists(ref_path)


@pytest.mark.parametrize("seed,n_ops", [(0, 40), (61, 40), (7, 300)])
def test_fingerprint_hashes_the_reference_content(monkeypatch, seed, n_ops):
    """The fingerprint hashes what the reference's does (the model's
    identity, the dims, the plan's arrays in the reference's dtypes and
    order, not the port's widened tables): with the model identity made
    the same in both packages, the two fingerprints are equal."""
    h1, h2 = _histories(seed, n_ops=n_ops)
    monkeypatch.setattr(ref_wgl, "_model_cache_key", lambda m: ("cas-register", 0))
    monkeypatch.setattr(wgl, "_model_cache_key", lambda m: ("cas-register", 0))
    enc_r, enc_p = ref_encode(RefCas(init=0), h1), encode_history(CasRegister(init=0), h2)
    ref_fp = ref_wgl._enc_fingerprint(enc_r, ref_wgl.plan_device(enc_r))
    plan = wgl.plan_device(enc_p, device="cpu")
    assert wgl._enc_fingerprint(enc_p, plan) == ref_fp
    assert plan.args[3].dtype == (np.int16 if plan.tab16 else np.int32)
