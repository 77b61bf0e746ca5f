"""The native (C) host search and the C EDN reader, built at first use.

``wgl_native.c`` is the port's copy of the reference's C WGL search
(``jepsen_tpu/native/wgl_native.c``): a memoized depth-first search, its
shared-stack parallel variant and a level-synchronous search over the
device search's configuration encoding. :func:`load` compiles it with the
system ``cc -O2 -shared -fPIC -pthread`` into ``jepsen_tpu_torch/_build/``
(the file name carries the source's content hash; a build is written to a
temporary file and renamed, so concurrent builds never serve a
half-written library) and loads it with ``ctypes.CDLL``, which releases
the GIL for the length of every call: the competition backend runs this
search on a host thread beside the device search.

Without a compiler (``shutil.which("cc")`` finds none) :func:`load`
returns None and the callers fall back to the host oracle. With one, a
failed build raises with the compiler's output: it never quietly turns
the native backend into another engine.

``edn_fast.c`` is the port's copy of the reference's C EDN reader, a
CPython extension: :func:`load_edn_fast` builds it the same way, with the
running interpreter's headers (``sysconfig.get_paths()["include"]``), and
binds it to the port's ``Keyword``, ``Symbol``, ``EdnList`` and
``_hashable``. Without ``cc`` or without ``Python.h`` it returns None and
:data:`edn_fast_missing` says which was missing; ``edn.read_string`` and
``edn.read_all`` then run the Python reader alone. With both, a failed
build raises :class:`NativeBuildError`, and so does every later call in
the process, without running the compiler again.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "wgl_native.c"
EDN_SRC = Path(__file__).resolve().parent / "edn_fast.c"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ("-O2", "-shared", "-fPIC", "-pthread")
EDN_CFLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_edn_mod = None
# The failed edn_fast build, raised again by every later load_edn_fast().
_edn_error: Optional[BaseException] = None
# Why load_edn_fast() returned None (no cc, or no Python.h), else None.
edn_fast_missing: Optional[str] = None


class NativeBuildError(RuntimeError):
    """The C compiler is present but refused the source."""


def library_path(src: Path = SRC, salt: bytes = b"") -> Path:
    """Where the build of ``src`` lives: ``_build/<stem>-<sha256[:16]>.so``,
    the hash taken over the source and ``salt`` (what else the build
    depends on)."""
    digest = hashlib.sha256(src.read_bytes() + salt).hexdigest()[:16]
    return BUILD / f"{src.stem}-{digest}.so"


def compile_library(src: Path = SRC, flags: tuple = CFLAGS,
                    salt: bytes = b"") -> Optional[Path]:
    """Compile ``src`` with ``flags`` into :func:`library_path` unless that
    build exists; returns its path, or None when there is no ``cc``.
    Raises :class:`NativeBuildError` with the compiler's stderr when the
    build fails."""
    cc = shutil.which("cc")
    if cc is None:
        return None
    so = library_path(src, salt)
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cc, *flags, "-o", str(tmp), str(src)], capture_output=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"cc failed to build {src.name} "
                               f"(exit {proc.returncode}):\n"
                               + proc.stderr.decode(errors="replace"))
    tmp.replace(so)
    return so


def _bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.wgl_check.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, i32p,  # determinate tables
        i32p,  # sufret
        i32p, i32p, i32p, i32p,  # open tables
        i32p,  # initial state
        ctypes.c_int32, ctypes.c_int64,  # model id, its parameter
        ctypes.c_int64,  # max configs
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.wgl_check.restype = ctypes.c_int
    # The DFS also captures the deepest configurations it reached (the
    # refutation witness: buffer, capacity in entries, length out) and
    # polls an optional cancel flag (the competition race).
    lib.wgl_check_dfs.argtypes = lib.wgl_check.argtypes + [
        i32p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.wgl_check_dfs.restype = ctypes.c_int
    # The parallel DFS: the same, plus a thread count.
    lib.wgl_check_dfs_par.argtypes = lib.wgl_check_dfs.argtypes + [ctypes.c_int32]
    lib.wgl_check_dfs_par.restype = ctypes.c_int
    lib.wgl_witness_stride.argtypes = []
    lib.wgl_witness_stride.restype = ctypes.c_int
    lib.wgl_max_open.argtypes = []
    lib.wgl_max_open.restype = ctypes.c_int
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The compiled library, built on first use; None when no ``cc`` is on
    the ``PATH``. A failed build raises (and is tried again on the next
    call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = compile_library()
            if so is None:
                return None
            _lib = _bind(so)
    return _lib


def _edn_missing() -> Optional[str]:
    if shutil.which("cc") is None:
        return "no C compiler (cc) on the PATH"
    inc = sysconfig.get_paths()["include"]
    if not (Path(inc) / "Python.h").exists():
        return f"no Python.h under {inc}"
    return None


def load_edn_fast():
    """The ``edn_fast`` extension module, built on first use and bound to
    the port's EDN classes; None when ``cc`` or ``Python.h`` is missing
    (:data:`edn_fast_missing` says which). A failed build raises, and
    every later call raises the same error without building again."""
    global _edn_mod, _edn_error, edn_fast_missing
    if _edn_mod is not None or edn_fast_missing is not None:
        return _edn_mod
    with _lock:
        if _edn_error is not None:
            raise _edn_error
        if _edn_mod is None and edn_fast_missing is None:
            missing = _edn_missing()
            if missing is not None:
                edn_fast_missing = missing
                return None
            inc = sysconfig.get_paths()["include"]
            # An extension module is bound to its interpreter's ABI.
            salt = f"{inc}\0{sysconfig.get_config_var('EXT_SUFFIX')}".encode()
            try:
                so = compile_library(EDN_SRC, (*EDN_CFLAGS, f"-I{inc}"), salt)
            except NativeBuildError as e:
                _edn_error = e
                raise
            spec = importlib.util.spec_from_file_location("edn_fast", str(so))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            from .. import edn

            mod.configure(edn.K, edn.Symbol, edn.EdnList, edn._hashable)
            _edn_mod = mod
    return _edn_mod
