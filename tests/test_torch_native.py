"""The port's native C search (``jepsen_tpu_torch.native`` and
``ops.wgl_c``) against the reference's (``jepsen_tpu.ops.wgl_c``) and the
reference's host oracle, on the same encoded inputs: register histories
(half of them perturbed) under every strategy, each lock model and the
semaphore, the golden corpus, refutation witnesses, open sets up to the
library's 256 ops, a budget trip, cancellation and the parallel search.
Under ``dfs`` and ``bfs`` every field of the result but the wall must equal
the reference's; under ``dfs-par``, whose order of exploration depends on
its threads, the verdict must. Also the build: one build reused, ``None``
without a compiler, a raise for a source that does not compile.

Each history is drawn by the port's generator from a seed and handed to
the reference as the same op rows; each port model comes from the
reference's (``model_class(name)._from_cache_key(cache_args())``; a
register's ``init`` is not in its cache args, so registers are built from
it)."""

import ctypes
import os
import random
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jepsen_tpu.models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.ops import wgl_c as ref_wgl_c
from jepsen_tpu.ops import wgl_host as ref_wgl_host
from jepsen_tpu.ops.encode import encode_history as ref_encode
from jepsen_tpu.telemetry import Registry as RefRegistry
from jepsen_tpu.testing import corpus as ref_corpus
from jepsen_tpu_torch import models, native
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.ops import wgl, wgl_c
from jepsen_tpu_torch.ops.encode import encode_history
from jepsen_tpu_torch.telemetry import Registry
from jepsen_tpu_torch.testing import (perturb_history, random_lock_history,
                                      random_model_history, random_register_history)

pytestmark = pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler (cc)")

ROOT = Path(__file__).resolve().parent.parent
# Result fields that must be equal under the deterministic strategies.
FIELDS = ("valid", "op_count", "native", "configs_explored", "frontier_max",
          "max_linearized", "stuck_configs", "info", "causes")
LOCK_MODELS = ("mutex", "owner-aware-mutex", "reentrant-mutex", "fenced-mutex",
               "reentrant-fenced-mutex")


def to_ref_history(h):
    return RefHistory([RefOp(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                       for o in h], reindex=False)


def port_model(ref):
    """The port's counterpart of a reference model instance."""
    if ref.name in ("cas-register", "register"):
        return models.model_class(ref.name)(init=ref.init)
    return models.model_class(ref.name)._from_cache_key(ref.cache_args())


def run_both(ref_model, h, **kw):
    """Both engines on port history ``h`` (the reference gets the same op
    rows) and the same encoding; returns (port, reference)."""
    enc = encode_history(port_model(ref_model), h)
    ref_enc = ref_encode(ref_model, to_ref_history(h))
    for a in ("inv", "ret", "opcode", "a1", "a2", "skippable", "init_state"):
        np.testing.assert_array_equal(getattr(enc, a), getattr(ref_enc, a), err_msg=a)
    return wgl_c.check_encoded_native(enc, **kw), ref_wgl_c.check_encoded_native(ref_enc, **kw)


def same(port, ref, fields=FIELDS):
    if ref is None:
        assert port is None
        return
    assert port is not None
    for k in fields:
        assert port.get(k) == ref.get(k), (k, port.get(k), ref.get(k))
    assert set(port) == set(ref)


def _register_histories():
    rng = random.Random(4)
    out = []
    for i in range(40):
        h = random_register_history(rng, n_ops=40, n_procs=4, cas=True, crash_p=0.08,
                                    fail_p=0.05)
        out.append(perturb_history(rng, h) if i % 2 else h)
    return out


@pytest.mark.parametrize("strategy", ["dfs", "bfs", "dfs-par"])
def test_register_histories(strategy):
    ref_model = ref_models.CasRegister(init=0)
    kw = {"strategy": strategy, **({"n_threads": 3} if strategy == "dfs-par" else {})}
    verdicts = []
    for i, h in enumerate(_register_histories()):
        port, ref = run_both(ref_model, h, **kw)
        host = ref_wgl_host.check_history_host(ref_model, to_ref_history(h))
        assert port["valid"] == host["valid"], (i, port, host)
        same(port, ref, FIELDS if strategy != "dfs-par" else ("valid",))
        verdicts.append(port["valid"])
    assert True in verdicts and False in verdicts


@pytest.mark.parametrize("name", LOCK_MODELS + ("semaphore",))
def test_lock_models(name):
    ref_model = ref_models._REGISTRY[name]._from_cache_key(
        {"reentrant-mutex": (2,), "semaphore": (2,)}.get(name, ()))
    rng = random.Random(9)
    for i in range(6):
        if name == "semaphore":
            h = random_model_history(rng, name, n_ops=60, n_procs=4, perturb=i % 2 == 1,
                                     within=0.3, crash_p=0.0)
        else:
            h = random_lock_history(rng, n_ops=60, n_procs=4)
        for strategy in ("dfs", "bfs"):
            port, ref = run_both(ref_model, h, strategy=strategy)
            same(port, ref)
        host = ref_wgl_host.check_history_host(ref_model, to_ref_history(h))
        assert port["valid"] == host["valid"], (name, i)
        par, _ = run_both(ref_model, h, strategy="dfs-par", n_threads=3)
        assert par["valid"] == host["valid"], (name, i)


def test_corpus():
    ran = 0
    for case in ref_corpus():
        h = History([Op(o.type, o.process, o.f, o.value, time=o.time, index=o.index)
                     for o in case.history], reindex=False)
        try:
            port_model(case.model)
        except (KeyError, TypeError, ValueError):
            continue  # no port counterpart of this model
        port, ref = run_both(case.model, h)
        same(port, ref)
        if port is not None:
            assert port["valid"] == case.valid, case.name
            ran += 1
    assert ran >= 5


def test_refutation_witness():
    """A refutation carries the reference's ``stuck_configs``: the deepest
    configurations, their states and the pending ops' reasons."""
    ref_model = ref_models.CasRegister(init=0)
    rng = random.Random(12)
    seen = 0
    for _ in range(40):
        h = perturb_history(rng, random_register_history(rng, n_ops=50, n_procs=4, cas=True,
                                                         crash_p=0.1))
        port, ref = run_both(ref_model, h)
        same(port, ref)
        if port["valid"] is not False:
            continue
        seen += 1
        assert port["stuck_configs"]
        enc = encode_history(port_model(ref_model), h)
        for cfg in port["stuck_configs"]:
            det = [r for r in cfg["linearized"] if not enc.skippable[r]]
            assert len(det) == port["max_linearized"]
            assert cfg["pending"]
        if seen >= 5:
            break
    assert seen >= 3


def _open_history(n_open):
    """``n_open`` writes that crash (each on its own process), then a read
    of the last one's value: ``n_open`` open ops."""
    ops = []
    for p in range(n_open):
        ops += [Op("invoke", p, "write", p + 1), Op("info", p, "write", p + 1)]
    q = n_open
    ops += [Op("invoke", q, "read", None), Op("ok", q, "read", n_open)]
    return History(ops, reindex=True)


@pytest.mark.parametrize("n_open", [1, 64, 65, 200, 256, 257])
def test_open_sets(n_open):
    """The open set spans up to 256 ops (four words); past it the engine
    declines (None), in both packages."""
    ref_model = ref_models.CasRegister(init=0)
    h = _open_history(n_open)
    assert wgl.det_tables(encode_history(port_model(ref_model), h))["nO"] == n_open
    for strategy in ("dfs", "bfs"):
        port, ref = run_both(ref_model, h, strategy=strategy)
        same(port, ref)
        if n_open > native.load().wgl_max_open():
            assert port is None
        else:
            assert port["valid"] is True


def test_wide_open_sets_crash_heavy():
    """Crash-heavy 300-op histories (open sets past one word): the DFS and
    the BFS agree with the reference's, field for field."""
    ref_model = ref_models.CasRegister(init=0)
    rng = random.Random(77)
    widened = 0
    for i in range(4):
        h = random_register_history(rng, n_ops=300, n_procs=4, cas=True, crash_p=0.35)
        if i % 2:
            h = perturb_history(rng, h)
        dfs, ref_dfs = run_both(ref_model, h, strategy="dfs", max_configs=2_000_000)
        bfs, ref_bfs = run_both(ref_model, h, strategy="bfs", max_configs=200_000)
        same(dfs, ref_dfs)
        same(bfs, ref_bfs)
        if dfs is not None and wgl.det_tables(
                encode_history(port_model(ref_model), h))["nO"] > 64:
            widened += 1
    assert widened


def _perturbed_2k(n_ops=2000):
    return perturb_history(random.Random(7), random_register_history(
        random.Random(2026), n_ops=n_ops, n_procs=10, cas=True, crash_p=0.002,
        fail_p=0.02))


@pytest.mark.parametrize("strategy", ["dfs", "bfs"])
def test_budget_trip(strategy):
    port, ref = run_both(ref_models.CasRegister(init=0), _perturbed_2k(), strategy=strategy,
                         max_configs=2000)
    same(port, ref)
    assert port["valid"] == "unknown"
    assert port["causes"] == [{"code": "max_configs", "layer": "host",
                               "params": {"budget": 2000, "engine": "native"}}]


def test_budget_trip_parallel():
    port, _ = run_both(ref_models.CasRegister(init=0), _perturbed_2k(), strategy="dfs-par",
                       n_threads=3, max_configs=2000)
    assert port["valid"] == "unknown"
    assert port["causes"][0]["code"] == "max_configs"


@pytest.mark.parametrize("strategy", ["dfs", "dfs-par"])
def test_cancel(strategy):
    """A cancel flag set before the search: ``unknown`` at once; without
    it the same search decides."""
    kw = {"strategy": strategy, **({"n_threads": 3} if strategy == "dfs-par" else {})}
    h = _perturbed_2k()
    port, ref = run_both(ref_models.CasRegister(init=0), h, cancel=ctypes.c_int32(1), **kw)
    assert port["valid"] == ref["valid"] == "unknown"
    decided, _ = run_both(ref_models.CasRegister(init=0), h, **kw)
    assert decided["valid"] in (True, False)


def test_parallel_matches_sequential():
    """dfs-par with 3 threads against the sequential search: the same
    verdicts on 200-op histories, witnesses on its refutations."""
    ref_model = ref_models.CasRegister(init=0)
    rng = random.Random(77)
    invalids = 0
    for i in range(20):
        h = random_register_history(rng, n_ops=200, n_procs=6, cas=True, crash_p=0.05,
                                    fail_p=0.05)
        if i % 2:
            h = perturb_history(rng, h)
        seq, ref_seq = run_both(ref_model, h, strategy="dfs")
        same(seq, ref_seq)
        par, ref_par = run_both(ref_model, h, strategy="dfs-par", n_threads=3)
        assert par["valid"] == ref_par["valid"] == seq["valid"], i
        if seq["valid"] is False:
            invalids += 1
            assert par.get("stuck_configs")
    assert invalids >= 3


def test_registry_counters():
    """The ``wgl_native_*`` counters in a port Registry, against the
    reference's in its own (walls aside)."""
    ref_model = ref_models.CasRegister(init=0)
    reg, ref_reg = Registry(), RefRegistry()
    for i, h in enumerate(_register_histories()[:6]):
        for strategy in ("dfs", "bfs"):
            enc = encode_history(port_model(ref_model), h)
            wgl_c.check_encoded_native(enc, strategy=strategy, metrics=reg)
            ref_wgl_c.check_encoded_native(ref_encode(ref_model, to_ref_history(h)),
                                           strategy=strategy, metrics=ref_reg)

    def samples(r):
        return sorted((s["name"], tuple(sorted(s["labels"].items())), s["value"])
                      for s in r.collect() if s["name"] != "wgl_native_wall_seconds_total")

    assert samples(reg) == samples(ref_reg)
    assert {s["name"] for s in reg.collect()} == {
        "wgl_native_nodes_total", "wgl_native_wall_seconds_total",
        "wgl_native_searches_total"}


def test_register_subclass_and_unsupported_models():
    """``Register`` matches by exact type (it subclasses ``CasRegister``);
    a model the C engine has no step for gives None."""
    h = random_register_history(random.Random(1), n_ops=20, n_procs=3, cas=False)
    for ref_model in (ref_models.Register(init=0), ref_models.CasRegister(init=0)):
        port, ref = run_both(ref_model, h)
        same(port, ref)
        assert port["valid"] is True
    mr = random_model_history(random.Random(2), "multi-register", n_ops=20)
    from jepsen_tpu_torch.testing import history_model

    assert wgl_c.check_history_native(history_model("multi-register"), mr) is None


def test_load_reuses_the_build(monkeypatch):
    lib = native.load()
    so = native.library_path()
    assert lib is not None and so.exists() and so.parent == native.BUILD
    assert so.parent == ROOT / "jepsen_tpu_torch" / "_build"

    def no_compiler(*a, **k):
        raise AssertionError("the build ran again")

    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert native.load() is lib
    assert native.compile_library() == so


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


def test_no_compiler_gives_none(tmp_path):
    """With no ``cc`` on the PATH, ``load()`` is None and the native
    backend runs the host oracle."""
    code = ("import random\n"
            "from jepsen_tpu_torch import native\n"
            "from jepsen_tpu_torch.models import CasRegister\n"
            "from jepsen_tpu_torch.ops import wgl\n"
            "from jepsen_tpu_torch.testing import random_register_history\n"
            "assert native.load() is None\n"
            "h = random_register_history(random.Random(3), n_ops=20, n_procs=3)\n"
            "r = wgl.check_history(CasRegister(init=0), h, backend='native')\n"
            "assert r['valid'] is True and r['backend'] == 'host', r\n"
            "print('NONE')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(PATH=str(tmp_path)), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "NONE" in out.stdout


def test_broken_source_raises(tmp_path):
    """``cc`` present and the build failing: a raise with the compiler's
    output, no library and no temporary file left."""
    src = tmp_path / "wgl_native.c"
    src.write_text(native.SRC.read_text().replace("int wgl_max_open(void)",
                                                  "int wgl_max_open(void) this is not C"))
    before = set(native.BUILD.iterdir())
    with pytest.raises(native.NativeBuildError, match="error"):
        native.compile_library(src)
    assert not native.library_path(src).exists()
    assert {p for p in native.BUILD.iterdir() if p.name.endswith(".tmp")} <= before


def test_source_is_the_reference_copy():
    """The port's C source is the reference's apart from the header line
    that names the module that compiles it."""
    ref = (ROOT / "jepsen_tpu" / "native" / "wgl_native.c").read_text().splitlines()
    port = native.SRC.read_text().splitlines()
    head = [i for i, ln in enumerate(ref) if "Compiled on demand" in ln][0]
    assert port[:head] == ref[:head]
    assert port[head + 2:] == ref[head + 1:]
