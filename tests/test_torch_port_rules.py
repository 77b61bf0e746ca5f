"""Rules the port keeps: it imports neither JAX nor the reference package,
its native build reads its own source and writes only into its build
directory, its entry points refuse to fall back to the CPU silently, and
the chip smoke script fails where there is no GPU or no package beside
it."""

import os
import pkgutil
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jepsen_tpu_torch
from jepsen_tpu_torch.models import CasRegister
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.testing import random_register_history

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "jepsen_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCK = ("jax", "jaxlib", "jepsen_tpu")
def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCK)
for m in [m for m in sys.modules if blocked(m)]:
    del sys.modules[m]
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"port must not import {name}")
        return None
sys.meta_path.insert(0, Blocker())
import jepsen_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__, "jepsen_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert not [m for m in sys.modules if blocked(m)]
print("IMPORTED", len(mods))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    return env


def test_port_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED" in out.stdout


OBSERVABILITY = ("jepsen_tpu_torch.telemetry.utilization", "jepsen_tpu_torch.telemetry.profile",
                 "jepsen_tpu_torch.telemetry.ledger", "jepsen_tpu_torch.benchcmp",
                 "jepsen_tpu_torch.ledger", "jepsen_tpu_torch.web")


def test_observability_modules_are_scanned():
    """The observability plane's modules are among those the import and
    source scans above walk, and none names JAX or the reference."""
    walked = {m.name for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__,
                                                     "jepsen_tpu_torch.")}
    assert set(OBSERVABILITY) <= walked
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|jepsen_tpu)(\s|\.|$)", re.M)
    for mod in OBSERVABILITY:
        src = ROOT / (mod.replace(".", "/") + ".py")
        assert src.exists() and not pat.search(src.read_text()), mod


def test_port_sources_name_no_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|jepsen_tpu)(\s|\.|$)", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert PORT / "native" / "__init__.py" in files
    for f in files:
        assert not pat.search(f.read_text()), f
    # The native C sources include system headers only.
    csrc = sorted((PORT / "native").glob("*.c"))
    assert [p.name for p in csrc] == ["edn_fast.c", "wgl_native.c"]
    for f in csrc:
        for inc in re.findall(r'^\s*#\s*include\s+(\S+)', f.read_text(), re.M):
            assert inc.startswith("<"), (f, inc)


_AUDITED_BUILD = r"""
import os, sys
REF = os.path.realpath(sys.argv[1])
events = []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        events.append(("open", os.path.realpath(os.fsdecode(args[0]))))
    elif event == "subprocess.Popen":
        events.append(("exec", " ".join(map(os.fsdecode, args[1]))))
sys.addaudithook(hook)
from jepsen_tpu_torch import native
lib = native.load()
assert lib is not None and lib.wgl_max_open() == 256
ref_opens = [p for kind, p in events if kind == "open" and p.startswith(REF)]
execs = [c for kind, c in events if kind == "exec"]
assert not ref_opens, ref_opens
assert len(execs) == 1 and execs[0].split()[-1] == str(native.SRC), execs
print("BUILT", native.library_path())
"""


@pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler (cc)")
def test_native_build_writes_only_into_its_build_dir(tmp_path):
    """A fresh build, from a copy of the port in an empty tree: every file
    it leaves is under ``jepsen_tpu_torch/_build/`` (``HOME`` and
    ``TMPDIR`` stay empty), its one compiler run compiles the port's
    source, and nothing under the reference's ``native/`` is opened."""
    tree = tmp_path / "tree"
    shutil.copytree(PORT, tree / "jepsen_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    home, tmpdir = tmp_path / "home", tmp_path / "tmp"
    home.mkdir()
    tmpdir.mkdir()
    before = {p for p in tree.rglob("*")}
    env = dict(os.environ, PYTHONPATH=str(tree), HOME=str(home), TMPDIR=str(tmpdir),
               PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", _AUDITED_BUILD,
                          str(ROOT / "jepsen_tpu" / "native")],
                         cwd=tree, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BUILT" in out.stdout
    new = {p for p in tree.rglob("*")} - before
    build = tree / "jepsen_tpu_torch" / "_build"
    assert new and all(p == build or build in p.parents for p in new), sorted(new)
    assert [p.suffix for p in build.iterdir()] == [".so"]
    assert not list(home.iterdir()) and not list(tmpdir.iterdir())


_AUDITED_EDN_BUILD = r"""
import os, sys
REF = os.path.realpath(sys.argv[1])
events = []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
        events.append(("open", os.path.realpath(os.fsdecode(args[0]))))
    elif event == "subprocess.Popen":
        events.append(("exec", " ".join(map(os.fsdecode, args[1]))))
sys.addaudithook(hook)
from jepsen_tpu_torch import edn, native
fast = native.load_edn_fast()
assert fast is not None, native.edn_fast_missing
assert edn.read_string("{:f :cas}") == {edn.K("f"): edn.K("cas")}
ref_opens = [p for kind, p in events if kind == "open" and p.startswith(REF)]
execs = [c for kind, c in events if kind == "exec"]
assert not ref_opens, ref_opens
assert len(execs) == 1 and execs[0].split()[-1] == str(native.EDN_SRC), execs
print("BUILT", fast.__file__)
"""


def _python_h() -> bool:
    import sysconfig

    return (Path(sysconfig.get_paths()["include"]) / "Python.h").exists()


@pytest.mark.skipif(shutil.which("cc") is None or not _python_h(),
                    reason="no C compiler (cc) or no Python.h")
def test_edn_fast_build_writes_only_into_its_build_dir(tmp_path):
    """A fresh build of the C EDN reader, from a copy of the port in an
    empty tree: every file it leaves is under ``jepsen_tpu_torch/_build/``
    (``HOME`` and ``TMPDIR`` stay empty), its one compiler run compiles the
    port's source, and nothing under the reference's ``native/`` is
    opened."""
    tree = tmp_path / "tree"
    shutil.copytree(PORT, tree / "jepsen_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    home, tmpdir = tmp_path / "home", tmp_path / "tmp"
    home.mkdir()
    tmpdir.mkdir()
    before = {p for p in tree.rglob("*")}
    env = dict(os.environ, PYTHONPATH=str(tree), HOME=str(home), TMPDIR=str(tmpdir),
               PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", _AUDITED_EDN_BUILD,
                          str(ROOT / "jepsen_tpu" / "native")],
                         cwd=tree, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BUILT" in out.stdout
    new = {p for p in tree.rglob("*")} - before
    build = tree / "jepsen_tpu_torch" / "_build"
    assert new and all(p == build or build in p.parents for p in new), sorted(new)
    assert [p.name.split("-")[0] for p in build.iterdir()] == ["edn_fast"]
    assert not list(home.iterdir()) and not list(tmpdir.iterdir())


def test_edn_fast_missing_toolchain_reads_with_python(monkeypatch):
    """Without ``cc`` the loader returns None and says why; the readers
    then parse with the Python reader alone."""
    from jepsen_tpu_torch import edn, native

    monkeypatch.setattr(native, "_edn_mod", None)
    monkeypatch.setattr(native, "edn_fast_missing", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.load_edn_fast() is None
    assert native.edn_fast_missing == "no C compiler (cc) on the PATH"
    assert list(edn.read_all("{:a 1}\n[1 2]")) == [{edn.K("a"): 1}, [1, 2]]


def test_every_port_module_is_walkable():
    mods = {m.name for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__,
                                                  "jepsen_tpu_torch.")}
    assert {"jepsen_tpu_torch.ops.wgl", "jepsen_tpu_torch.ops.wgl_level",
            "jepsen_tpu_torch._build", "jepsen_tpu_torch.devices",
            "jepsen_tpu_torch.elle", "jepsen_tpu_torch.elle.ops",
            "jepsen_tpu_torch.elle.graph", "jepsen_tpu_torch.elle.graphs",
            "jepsen_tpu_torch.elle.engine", "jepsen_tpu_torch.elle.append",
            "jepsen_tpu_torch.elle.wr", "jepsen_tpu_torch.txn",
            "jepsen_tpu_torch.workloads.append", "jepsen_tpu_torch.workloads.wr",
            "jepsen_tpu_torch.workloads.lock", "jepsen_tpu_torch.models.mutex",
            "jepsen_tpu_torch.models.bank", "jepsen_tpu_torch.models.counter",
            "jepsen_tpu_torch.models.sets", "jepsen_tpu_torch.models.queue",
            "jepsen_tpu_torch.native", "jepsen_tpu_torch.ops.wgl_c",
            "jepsen_tpu_torch.telemetry.heartbeat", "jepsen_tpu_torch.testing",
            "jepsen_tpu_torch.testing.chaos", "jepsen_tpu_torch.parallel.resilience",
            "jepsen_tpu_torch.telemetry.flight", "jepsen_tpu_torch.online",
            "jepsen_tpu_torch.online.segmenter", "jepsen_tpu_torch.online.scheduler",
            "jepsen_tpu_torch.offline", "jepsen_tpu_torch.offline.planner",
            "jepsen_tpu_torch.offline.driver",
            "jepsen_tpu_torch.offline.__main__", "jepsen_tpu_torch.store",
            "jepsen_tpu_torch.cli", "jepsen_tpu_torch.__main__",
            "jepsen_tpu_torch.parallel.replay", "jepsen_tpu_torch.checker.linear_viz",
            "jepsen_tpu_torch.checker.timeline", "jepsen_tpu_torch.elle.explain",
            "jepsen_tpu_torch.util", "jepsen_tpu_torch.checker.invariants",
            "jepsen_tpu_torch.workloads.bank", "jepsen_tpu_torch.workloads.causal",
            "jepsen_tpu_torch.workloads.long_fork", "jepsen_tpu_torch.workloads.adya",
            "jepsen_tpu_torch.ingest", "jepsen_tpu_torch.ingest.adapters",
            "jepsen_tpu_torch.ingest.mapper", "jepsen_tpu_torch.ingest.__main__",
            "jepsen_tpu_torch.generator", "jepsen_tpu_torch.generator.sim",
            "jepsen_tpu_torch.generator.interpreter", "jepsen_tpu_torch.client",
            "jepsen_tpu_torch.nemesis", "jepsen_tpu_torch.control", "jepsen_tpu_torch.os_",
            "jepsen_tpu_torch.db", "jepsen_tpu_torch.core", "jepsen_tpu_torch.trace",
            "jepsen_tpu_torch.telemetry.export", "jepsen_tpu_torch.telemetry.ledger",
            "jepsen_tpu_torch.online.monitor", "jepsen_tpu_torch.workloads",
            "jepsen_tpu_torch.workloads.linearizable_register"} <= mods


def test_every_kernel_entry_point_has_a_signature_and_a_source():
    """Each C entry point the wrappers launch is declared for ctypes and
    defined in a source that the build compiles."""
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.elle import ops as elle_ops
    from jepsen_tpu_torch.ops import wgl_level

    sources = "".join(p.read_text() for p in _build._sources())
    for name in list(wgl_level.LAUNCHES) + list(elle_ops.LAUNCHES):
        assert name in _build.SIGNATURES, name
        assert re.search(rf"\bint {name}\(", sources), name
    assert {p.name for p in _build._sources()} >= {"wgl_level.cu", "elle_closure.cu"}


@pytest.mark.parametrize("name,define", [("SORT_CTA_MAX", "RS_CTA_MAX"),
                                         ("SORT_HDR", "RS_HDR"), ("GF_ROWS", "GF_ROWS"),
                                         ("RG_INLINE", "RG_INLINE"),
                                         ("CS_INLINE", "CS_INLINE")])
def test_build_sizes_match_the_cuda_source(name, define):
    """The sizes the wrappers read from ``_build`` are the ones the CUDA
    source defines."""
    from jepsen_tpu_torch import _build

    src = (_build.CSRC / "wgl_level.cu").read_text()
    found = re.findall(rf"^#define {define} (\d+)\b", src, re.M)
    assert found == [str(getattr(_build, name))], (name, found)


def test_yardsticks_stay_out_of_the_library():
    """The parent designs that chip_smoke.py times are defined in its own
    source, which the library's build does not compile, and the port
    declares none of them."""
    import chip_smoke
    from jepsen_tpu_torch import _build

    library = "".join(p.read_text() for p in _build._sources())
    yard = ROOT.joinpath(*chip_smoke.YARDSTICK_SRC)
    assert yard not in _build._sources() and "k_yard" not in library
    for name in chip_smoke.YARDSTICKS:
        assert re.search(rf"\bint {name}\(", yard.read_text()), name
        assert name not in library and name not in _build.SIGNATURES, name


def _history():
    return random_register_history(random.Random(3), n_ops=20, n_procs=3)


def test_entry_point_without_device_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wgl.check_history(CasRegister(init=0), _history())


def test_entry_point_runs_on_cpu_when_asked():
    res = wgl.check_history(CasRegister(init=0), _history(), device="cpu")
    assert res["valid"] is True and res["torch_device"] == "cpu"


@pytest.mark.parametrize("kw", [dict(backend="auto"), dict(backend="native"),
                                dict(backend="competition"),
                                dict(parallel="segmented")])
def test_later_slice_backends_raise(kw):
    """The ``auto``, ``native`` and ``competition`` backends and
    ``parallel="segmented"`` run, with the host oracle's verdict (``auto``
    and ``native`` on the C search); without ``device="cpu"`` the
    segmented checker's device oracle raises where there is no GPU."""
    if "parallel" in kw:
        host = wgl.check_history(CasRegister(init=0), _history(), backend="host")
        res = wgl.check_history(CasRegister(init=0), _history(), device="cpu", **kw)
        assert res["valid"] == host["valid"] is True and res["parallel"] == "segmented"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                wgl.check_history(CasRegister(init=0), _history(), **kw)
        return
    host = wgl.check_history(CasRegister(init=0), _history(), backend="host")
    res = wgl.check_history(CasRegister(init=0), _history(), device="cpu", **kw)
    assert res["valid"] == host["valid"] is True
    assert res["backend"] == ("competition" if kw["backend"] == "competition" else "native")


def test_host_backend_runs():
    res = wgl.check_history(CasRegister(init=0), _history(), backend="host")
    assert res["valid"] is True and res["backend"] == "host"


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
