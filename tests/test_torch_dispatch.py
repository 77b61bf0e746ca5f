"""The port's ``check_history`` dispatch against the reference's: the
``auto``, ``native``, ``competition`` and ``host`` backends give the same
``valid`` and ``backend`` on the same histories (register and lock models,
valid and perturbed); ``auto`` runs the device search for a model the C
engine has no step for and falls back to the host oracle after a device
``unknown``; the competition's device side wins when the C side is held to
a budget of one configuration, and its C side wins when the device side
cannot run; an aborted device search leaves nothing behind that changes
the next one; and a caller's ``chunk_callback`` is still called in a race.

The port runs on the CPU (``device="cpu"``: the plain version of every
stage) at small sizes; each history is drawn by the port's generator from
a seed and handed to the reference as the same op rows, and each port
model comes from the reference's."""

import random

import pytest
import torch

import jepsen_tpu.models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu_torch import models
from jepsen_tpu_torch.ops import wgl, wgl_c
from jepsen_tpu_torch.ops.encode import encode_history
from jepsen_tpu_torch.testing import (history_model, perturb_history, random_lock_history,
                                      random_model_history, random_register_history)

BACKENDS = ("auto", "native", "competition", "host")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain stages run many small ops: one intra-op thread keeps a
    worker from oversubscribing the cores the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_ref_history(h):
    return RefHistory([RefOp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                       for o in h], reindex=False)


def port_model(ref):
    if ref.name in ("cas-register", "register"):
        return models.model_class(ref.name)(init=ref.init)
    return models.model_class(ref.name)._from_cache_key(ref.cache_args())


def _register(seed, perturb):
    rng = random.Random(seed)
    h = random_register_history(rng, n_ops=80, n_procs=4, crash_p=0.0)
    return perturb_history(rng, h) if perturb else h


def _lock(seed, perturb):
    rng = random.Random(seed)
    if perturb:
        return random_model_history(rng, "owner-aware-mutex", n_ops=80, n_procs=4,
                                    crash_p=0.0, perturb=True, within=0.3)
    return random_lock_history(rng, n_ops=80, n_procs=4)


CASES = {
    "register-ok": (lambda: ref_models.CasRegister(init=0), lambda: _register(21, False)),
    "register-bad": (lambda: ref_models.CasRegister(init=0), lambda: _register(22, True)),
    "lock-ok": (lambda: ref_models.OwnerAwareMutex(), lambda: _lock(23, False)),
    "lock-bad": (lambda: ref_models.OwnerAwareMutex(), lambda: _lock(24, True)),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_backend_matches_reference(case, backend):
    make_model, make_history = CASES[case]
    ref_model = make_model()
    h = make_history()
    ref = ref_wgl.check_history(ref_model, to_ref_history(h), backend=backend)
    port = wgl.check_history(port_model(ref_model), h, backend=backend, device="cpu")
    assert port["valid"] == ref["valid"]
    assert port.get("backend") == ref.get("backend")
    assert port.get("engine", "device") in ("native", "device")
    assert port["valid"] is (not case.endswith("bad"))


def test_auto_runs_the_device_for_models_without_a_native_step():
    """A multi-register history: the C engine declines, the device search
    decides, as the reference's does."""
    name = "multi-register"
    h = random_model_history(random.Random(31), name, n_ops=60, n_procs=4)
    port_m = models.model_class(name)({0: None, 1: None, 2: None})
    assert wgl_c.check_history_native(port_m, h) is None
    ref_m = ref_models._REGISTRY[name]._from_cache_key(port_m.cache_args())
    ref = ref_wgl.check_history(ref_m, to_ref_history(h), backend="auto")
    port = wgl.check_history(port_m, h, backend="auto", device="cpu", collect_stats=True)
    dev = wgl.check_history(port_m, h, backend="device", device="cpu", collect_stats=True)
    assert port["valid"] == ref["valid"] is True
    assert port["device"] is True and port["torch_device"] == "cpu"
    assert "backend" not in port and "backend" not in ref
    assert port["levels"] == dev["levels"] and port["level_stats"] == dev["level_stats"]


def test_auto_falls_back_to_the_oracle_after_a_device_unknown():
    """A one-rung schedule of 16 whose beam runs dry: the device search
    says ``unknown`` and the host oracle decides, keeping the device's
    result under ``device_attempt``, in both packages."""
    name = "counter"
    port_m = history_model(name)
    ref_m = ref_models._REGISTRY[name]._from_cache_key(port_m.cache_args())
    h = random_model_history(random.Random(2), name, n_ops=60, n_procs=8, crash_p=0.2)
    ref = ref_wgl.check_history(ref_m, to_ref_history(h), backend="auto", f_schedule=(16,))
    port = wgl.check_history(port_m, h, backend="auto", device="cpu", f_schedule=(16,))
    assert port["valid"] == ref["valid"] is True
    att, ref_att = port["device_attempt"], ref["device_attempt"]
    assert att["valid"] == ref_att["valid"] == "unknown"
    assert att["levels"] == ref_att["levels"] and att["causes"] == ref_att["causes"]
    assert "device" not in port


def _north_star_small(n_ops=200, perturb=False):
    rng = random.Random(2026)
    h = random_register_history(rng, n_ops=n_ops, n_procs=10, cas=True, crash_p=0.002,
                                fail_p=0.02)
    return perturb_history(random.Random(7), h) if perturb else h


@pytest.fixture
def sequential_native(monkeypatch):
    """The competition's C side as the sequential search on one thread:
    it checks its budget at every configuration, so a budget of one trips
    at once (the parallel search checks every 1024 a thread)."""
    monkeypatch.setattr(wgl_c, "parallel_policy", lambda: ("dfs", 1))


@pytest.mark.parametrize("perturb", [False, True], ids=["ok", "bad"])
def test_competition_device_side_wins_when_native_cannot(sequential_native, perturb):
    model = models.CasRegister(init=0)
    h = _north_star_small(perturb=perturb)
    res = wgl.check_history(model, h, backend="competition", device="cpu",
                            native_max_configs=1, collect_stats=True)
    dev = wgl.check_history(model, h, backend="device", device="cpu", collect_stats=True)
    assert res["engine"] == "device" and res["backend"] == "competition"
    assert res["valid"] == dev["valid"] is (not perturb)
    assert res["levels"] == dev["levels"] and res["level_stats"] == dev["level_stats"]
    assert res.get("stuck_configs") == dev.get("stuck_configs")


def test_competition_native_side_wins_when_the_device_cannot():
    """An empty capacity schedule: the device side is ``unknown`` at once,
    and the C side's verdict comes back, with its own fields."""
    model = models.CasRegister(init=0)
    h = _north_star_small(perturb=True)
    res = wgl.check_history(model, h, backend="competition", device="cpu", f_schedule=())
    nat = wgl.check_history(model, h, backend="native")
    assert res["engine"] == "native" and res["backend"] == "competition"
    assert res["valid"] == nat["valid"] is False
    assert res["native"] is True and res["stuck_configs"]


def test_competition_neither_side_decides(sequential_native):
    """Both sides held back: ``unknown`` from the competition, each
    engine's cause kept; ``check_history`` then asks the host oracle."""
    model = models.CasRegister(init=0)
    enc = encode_history(model, _north_star_small(n_ops=60))
    res = wgl.check_encoded_competition(enc, native_max_configs=1, f_schedule=(),
                                        device="cpu")
    assert res["valid"] == "unknown" and res["backend"] == "competition"
    assert res["causes"] and res["info"]


@pytest.mark.parametrize("backend", ["auto", "native", "competition"])
def test_broken_build_raises_under_every_native_backend(monkeypatch, tmp_path, backend):
    """``cc`` present and the C source not compiling: each backend that
    runs the C search raises the build's error, and none of them quietly
    becomes another engine."""
    import functools

    from jepsen_tpu_torch import native

    src = tmp_path / "wgl_native.c"
    src.write_text(native.SRC.read_text().replace("int wgl_max_open(void)",
                                                  "int wgl_max_open(void) this is not C"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "compile_library",
                        functools.partial(native.compile_library, src))
    with pytest.raises(native.NativeBuildError):
        wgl.check_history(models.CasRegister(init=0), _north_star_small(n_ops=20),
                          backend=backend, device="cpu")


def test_competition_reports_a_failed_c_search(monkeypatch):
    """The C side raising mid-race: the device side's verdict comes back
    with the C side's error beside it."""

    def fail(*a, **k):
        raise RuntimeError("the C search failed")

    monkeypatch.setattr(wgl_c, "check_encoded_native", fail)
    model = models.CasRegister(init=0)
    h = _north_star_small(n_ops=60)
    res = wgl.check_history(model, h, backend="competition", device="cpu")
    assert res["engine"] == "device" and res["valid"] is True
    assert res["native_error"] == "RuntimeError: the C search failed"
    assert "device_error" not in res


def test_aborted_device_search_leaves_no_state():
    """A device search stopped by its callback after its first chunk, then
    a fresh search in the same process: the same result as one that was
    never interrupted (verdict, levels, per-level rows, rungs)."""

    class Stop(Exception):
        pass

    def stop(info):
        raise Stop()

    model = models.CasRegister(init=0)
    enc = encode_history(model, _north_star_small())
    kw = dict(device="cpu", collect_stats=True, levels_per_call=16, f_schedule=(16, 64))
    before = wgl.check_encoded_device(enc, **kw)
    with pytest.raises(Stop):
        wgl.check_encoded_device(enc, chunk_callback=stop, **kw)
    after = wgl.check_encoded_device(enc, **kw)
    for k in ("valid", "levels", "level_stats", "frontier_max", "window"):
        assert after[k] == before[k], k
    assert [(a["F"], a["levels"], a["calls"]) for a in after["attempts"]] == \
        [(a["F"], a["levels"], a["calls"]) for a in before["attempts"]]


def test_device_search_after_a_lost_race():
    """A race the C side wins (its device side aborted from the callback),
    then a device search of the same history: equal to one run before the
    race."""
    model = models.CasRegister(init=0)
    h = _north_star_small()
    kw = dict(device="cpu", collect_stats=True, levels_per_call=8)
    before = wgl.check_history(model, h, backend="device", **kw)
    race = wgl.check_history(model, h, backend="competition", **kw)
    assert race["valid"] is True
    after = wgl.check_history(model, h, backend="device", **kw)
    assert after["levels"] == before["levels"]
    assert after["level_stats"] == before["level_stats"]


def test_callers_chunk_callback_is_called_in_a_race(sequential_native):
    model = models.CasRegister(init=0)
    h = _north_star_small()
    seen, alone = [], []
    kw = dict(device="cpu", levels_per_call=16)
    res = wgl.check_history(model, h, backend="competition", native_max_configs=1,
                            chunk_callback=seen.append, **kw)
    wgl.check_history(model, h, backend="device", chunk_callback=alone.append, **kw)
    assert res["engine"] == "device"
    levels = lambda infos: [(i["level"], i["F"], i["count"]) for i in infos]  # noqa: E731
    assert seen and levels(seen) == levels(alone)


def test_unknown_backend_and_parallel_raise():
    h = _north_star_small(n_ops=20)
    with pytest.raises(ValueError, match="unknown backend"):
        wgl.check_history(models.CasRegister(init=0), h, backend="knossos")
    with pytest.raises(ValueError, match="unknown parallel mode"):
        wgl.check_history(models.CasRegister(init=0), h, backend="auto", parallel="bisect")
