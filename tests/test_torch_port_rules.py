"""Rules the port keeps: it imports neither JAX nor the reference package,
its entry points refuse to fall back to the CPU silently, and the chip
smoke script fails where there is no GPU or no package beside it."""

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


def test_port_sources_name_no_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|jepsen_tpu)(\s|\.|$)", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        assert not pat.search(f.read_text()), f


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
            "jepsen_tpu_torch.models.sets", "jepsen_tpu_torch.models.queue"} <= mods


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
    with pytest.raises(ValueError, match="later slice|slice of the port"):
        wgl.check_history(CasRegister(init=0), _history(), device="cpu", **kw)


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
