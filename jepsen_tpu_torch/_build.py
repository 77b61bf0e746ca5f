"""Build and load the port's CUDA kernels.

``load()`` compiles each ``csrc/*.cu`` for ``sm_90a`` in its own ``nvcc``,
all started together (the build time is the slowest source's, not the
sum), links the objects with one ``nvcc -shared`` into
``jepsen_tpu_torch/_build/libjepsen_kernels.so`` at first use, and loads
it with ``ctypes``. The library has a plain C interface: pointers and the
stream are ``void*``, sizes are ``int`` (``long`` for a member stride), and
every entry point returns ``cudaGetLastError()``. A build is reused while
its sources are unchanged (a content hash is stored beside it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
LIB = BUILD / "libjepsen_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# The radix sort's sizes (csrc/wgl_level.cu): pairs one block sorts alone
# (RS_CTA_MAX), the Onesweep tile (RS_TILE) and the words of its per-member
# state header (RS_HDR).
SORT_CTA_MAX = 16384
SORT_TILE = 4096
SORT_HDR = 1040
# Frontier slots a block of the gather-finalize takes (GF_ROWS).
GF_ROWS = 128
# Member indices a regroup passes in its launch's parameters (RG_INLINE); a
# longer index goes to the card first.
RG_INLINE = 256
# Members whose initial control-block values a chunk start passes in its
# launch's parameters (CS_INLINE); a larger batch of the ladder keeps them in
# a table on the card.
CS_INLINE = 128

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# entry point -> argument types, in order (the C signatures).
SIGNATURES = {
    "wgl_chunk_init": [_P] * 6 + [_I] * 5 + [_P],
    "wgl_expand": [_P] * 15 + [_I] * 10 + [_P],
    "wgl_stage1_hash": [_P] * 6 + [_I] * 7 + [_P],
    "wgl_take_col_sort": [_P, _L, _I, _I, _I] + [_P] * 5 + [_I, _I, _P, _P],
    "radix_sort_pairs": [_P] * 5 + [_I, _I, _P, _P],
    "wgl_prune": [_P] * 6 + [_I] * 10 + [_P],
    "wgl_gather_finalize": [_P] * 10 + [_I] * 10 + [_P],
    "wgl_regroup": [_P] * 12 + [_I] * 6 + [_P],
    "wgl_route": [_P] * 6 + [_I] * 6 + [_P],
    "wgl_exchange": [_P] * 6 + [_I] * 4 + [_P],
    "elle_adjacency": [_P, _P, _P, _I, _I, _I, _P],
    "elle_square": [_P, _P, _I, _I, _P],
    "elle_labels_pack": [_P, _P, _P, _I, _I, _P],
    "elle_unpack": [_P, _P, _I, _I, _I, _P],
    "elle_pack_rows": [_P, _P, _I, _I, _P],
    "elle_gather": [_P, _P, _I, _I, _I, _P],
    "elle_block_square": [_P, _P, _P, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the GPU")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256()
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()


def _compile(exe: str, src: Path, obj: Path):
    t0 = time.perf_counter()
    out = subprocess.run([exe, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, time.perf_counter() - t0


def build() -> dict:
    """Compile the sources if the library is missing or stale. Returns
    ``{"built": bool, "seconds": float, "compile_seconds": {source:
    float}, "log": str}``."""
    srcs = _sources()
    digest = _digest(srcs)
    stamp = BUILD / "libjepsen_kernels.sha256"
    if LIB.exists() and stamp.exists() and stamp.read_text() == digest:
        return {"built": False, "seconds": 0.0, "compile_seconds": {}, "log": ""}
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        with ThreadPoolExecutor(len(srcs)) as pool:
            done = list(pool.map(lambda so: _compile(exe, *so), zip(srcs, objs)))
        log = "".join(f"== {src.name}\n{out.stdout}" for src, (out, _s) in zip(srcs, done))
        if any(out.returncode != 0 for out, _s in done):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp_lib = Path(tmp) / LIB.name
        out = subprocess.run([exe, *ARCH, "-shared", *map(str, objs), "-o", str(tmp_lib)],
                             capture_output=True, text=True)
        log += out.stdout + out.stderr
        if out.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log}")
        os.replace(tmp_lib, LIB)
    stamp.write_text(digest)
    (BUILD / "build.log").write_text(log)
    return {"built": True, "seconds": time.perf_counter() - t0,
            "compile_seconds": {src.name: s for src, (_out, s) in zip(srcs, done)},
            "log": log}


def loaded() -> bool:
    """Whether this process has loaded the kernel library."""
    return _lib is not None


def chunk_stage(was_loaded: bool) -> str:
    """A driver chunk's telemetry ``stage``: ``"compile"`` for the chunk
    that paid the process's first load of the kernel library (its ``nvcc``
    build or its load: the port's counterpart of the reference's first
    chunk after a fresh JIT build), ``"execute"`` after it and on the CPU.
    ``was_loaded`` is :func:`loaded` before the chunk."""
    return "compile" if not was_loaded and loaded() else "execute"


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.wgl_error_string.argtypes = [ctypes.c_int]
            lib.wgl_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(code: int) -> str:
    return load().wgl_error_string(int(code)).decode()
