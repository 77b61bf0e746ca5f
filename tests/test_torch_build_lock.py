"""The kernel library's build (``jepsen_tpu_torch._build``) across
processes: two processes that reach ``build()`` together, as the backends
of one router reach their first device round, build once. The compiler is
a stub that logs each call and writes its output, so the test runs where
there is no ``nvcc``."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_FAKE_NVCC = """#!{python}
import os, sys, time
with open({log!r}, "a") as f:
    f.write(f"{{os.getppid()}} {{' '.join(sys.argv[1:])}}\\n")
time.sleep(0.4)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"stub")
"""

_BUILDER = """
import json, sys, time
from pathlib import Path
from jepsen_tpu_torch import _build
tmp = Path(sys.argv[1])
_build.CSRC = tmp / "csrc"
_build.BUILD = tmp / "build"
_build.LIB = _build.BUILD / "libjepsen_kernels.so"
_build.nvcc = lambda: str(tmp / "nvcc")
while not (tmp / "go").exists():
    time.sleep(0.005)
print(json.dumps({"built": _build.build()["built"]}))
"""


def test_two_processes_build_the_library_once(tmp_path):
    (tmp_path / "csrc").mkdir()
    for name in ("a.cu", "b.cu"):
        (tmp_path / "csrc" / name).write_text(f"// {name}\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_BUILDER), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _ in range(2)]
    (tmp_path / "go").write_text("")
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _o, e in outs]
    built = sorted(o.strip().splitlines()[-1] for o, _e in outs)
    assert built == ['{"built": false}', '{"built": true}']
    calls = log.read_text().splitlines()
    # one process compiled both sources and linked; the other compiled nothing
    assert len(calls) == 3 and len({c.split()[0] for c in calls}) == 1
    assert sum("-shared" in c for c in calls) == 1
    assert (tmp_path / "build" / "libjepsen_kernels.so").read_bytes() == b"stub"
    assert (tmp_path / "build" / "build.lock").exists()
