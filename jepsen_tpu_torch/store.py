"""Persistence: the ``store/`` directory tree.

The port of the reference's ``jepsen_tpu/store.py`` (jepsen.store,
jepsen/src/jepsen/store.clj), file for file and byte for byte. Each run
writes ``store/<test-name>/<timestamp>/`` containing:

- ``history.edn``: the full history as EDN (store.clj:345-362), with
  ``history.txt`` beside it; archived reference histories load back
  through the same codec, so either package's histories replay on either
  checker;
- ``results.edn``: the checker's output (store.clj:231-241,385-397);
- ``test.edn``: the serializable slice of the test map;
- ``jepsen.log``: the per-run log file (store.clj:411-439);

plus ``latest`` symlinks (store.clj:296-333) and two-phase saves:
:func:`save_1` before the analysis (the history is durable even if the
checker dies), :func:`save_2` after it (store.clj:372-397).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time as _time
from pathlib import Path
from typing import Any, Optional

from . import edn
from .edn import K
from .history import History, Op

LOG = logging.getLogger("jepsen.store")

BASE_DIR = "store"

_TIME_FORMAT = "%Y%m%dT%H%M%S"  # store.clj:118-124 (basic-date-time)


def time_str(t: Optional[float] = None) -> str:
    """Millisecond-resolution timestamp — the reference's basic-date-time
    carries millis, and runs started within the same second must not
    collide in the store tree."""
    now = _time.time() if t is None else t
    base = _time.strftime(_TIME_FORMAT, _time.gmtime(now))
    millis = int((now % 1) * 1000)
    return f"{base}.{millis:03d}Z"


def base(test_or_root: Any = None) -> Path:
    if isinstance(test_or_root, (str, Path)):
        return Path(test_or_root)
    if isinstance(test_or_root, dict) and test_or_root.get("store-root"):
        return Path(test_or_root["store-root"])
    return Path(BASE_DIR)


def wanted(test: Optional[dict]) -> bool:
    """Whether the run keeps a store directory: it has a ``name`` and a
    ``start-time`` and does not say ``no-store?``. The checkers write their
    witness, explanation and per-key files only for such a run."""
    test = test or {}
    return bool(test.get("name") and test.get("start-time")
                and not test.get("no-store?"))


def path(test: dict, *more: str) -> Path:
    """store/<name>/<start-time>/... (store.clj:126-143)."""
    name = test.get("name")
    assert name, "test must have a name to have a store path"
    start = test.get("start-time")
    assert start, "test must have a start-time to have a store path"
    return base(test).joinpath(name, start, *more)


def path_mk(test: dict, *more: str) -> Path:
    """path!, creating parents (store.clj:145-147)."""
    p = path(test, *more)
    (p if not more else p.parent).mkdir(parents=True, exist_ok=True)
    return p


# ---------------------------------------------------------------------------
# EDN conversion for results/test maps


def _str_keyword_vals(k: str, v: Any) -> Any:
    # :valid? values are keywords in the reference (true/false/:unknown).
    if k == "valid" and v == "unknown":
        return K("unknown")
    return v


def to_edn_value(x: Any) -> Any:
    """Convert a Python result/test structure to EDN-shaped values: string
    dict keys become keywords ("valid" → :valid?); sets/tuples/lists pass
    through; objects that aren't EDN-representable become their repr
    string."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if isinstance(k, str):
                kk = K("valid?") if k == "valid" else K(k)
            else:
                kk = to_edn_value(k)
            out[kk] = (
                _str_keyword_vals(k, to_edn_value(v)) if isinstance(k, str) else to_edn_value(v)
            )
        return out
    if isinstance(x, (list, tuple)):
        return [to_edn_value(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return {to_edn_value(v) for v in x}
    if x is None or isinstance(x, (bool, int, float, str, edn.Keyword, edn.Symbol)):
        return x
    if isinstance(x, History):
        return [op.to_edn() for op in x]
    if isinstance(x, Op):
        return x.to_edn()
    return repr(x)


_TEST_SKIP_KEYS = frozenset(
    # Live objects that don't serialize: protocols, generators, functions.
    ("client", "nemesis", "generator", "checker", "db", "os", "net", "remote",
     "barrier", "store", "history", "results",
     "telemetry-registry", "trace-collector")
)


def serializable_test(test: dict) -> dict:
    """The plain-data slice of a test map (the reference's Fressian
    write-handlers similarly elide live objects, store.clj:31-116)."""
    return {
        k: v for k, v in test.items()
        if k not in _TEST_SKIP_KEYS and not callable(v)
    }


# ---------------------------------------------------------------------------
# Writers (store.clj:345-397)


def write_history(test: dict) -> None:
    """history.edn + history.txt (store.clj:345-362)."""
    h = test.get("history")
    if h is None:
        return
    if not isinstance(h, History):
        h = History([Op.from_dict(o) if isinstance(o, dict) else o for o in h],
                    reindex=False)
    path_mk(test)
    h.save(path(test, "history.edn"))
    with open(path(test, "history.txt"), "w") as f:
        for op in h:
            f.write(f"{op.process}\t{op.type}\t{op.f}\t{op.value!r}"
                    + (f"\t{op.error!r}" if op.error is not None else "")
                    + "\n")


def write_results(test: dict) -> None:
    """results.edn (store.clj:231-241)."""
    res = test.get("results")
    if res is None:
        return
    with open(path_mk(test, "results.edn"), "w") as f:
        f.write(edn.write_string(to_edn_value(res)))
        f.write("\n")


def write_test(test: dict) -> None:
    with open(path_mk(test, "test.edn"), "w") as f:
        f.write(edn.write_string(to_edn_value(serializable_test(test))))
        f.write("\n")


def update_symlinks(test: dict) -> None:
    """store/latest + store/<name>/latest → this run (store.clj:307-333)."""
    target = path(test)
    for link in (base(test) / "latest", base(test) / test["name"] / "latest"):
        try:
            if link.is_symlink() or link.exists():
                link.unlink()
            link.symlink_to(os.path.relpath(target, link.parent))
        except OSError:
            LOG.warning("could not update symlink %s", link, exc_info=True)


def save_1(test: dict) -> dict:
    """Phase 1: history + test, before analysis (store.clj:372-383)."""
    write_test(test)
    write_history(test)
    update_symlinks(test)
    return test

def save_2(test: dict) -> dict:
    """Phase 2: results, after analysis (store.clj:385-397)."""
    write_results(test)
    write_test(test)
    return test


# ---------------------------------------------------------------------------
# Readers (store.clj:181-305)


def load_history(name: str, start: str, root=None) -> History:
    return History.load(base(root).joinpath(name, start, "history.edn"))


def load_results(name: str, start: str, root=None) -> Any:
    with open(base(root).joinpath(name, start, "results.edn")) as f:
        return edn.read_string(f.read())


def load_test(name: str, start: str, root=None) -> dict:
    """Reconstruct the stored slice of a test map (+ history when present).
    Keyword keys are normalised back to strings."""
    d = base(root).joinpath(name, start)
    out: dict = {}
    tf = d / "test.edn"
    if tf.exists():
        m = edn.read_string(tf.read_text())
        for k, v in m.items():
            out[k.name if isinstance(k, edn.Keyword) else k] = v
    hf = d / "history.edn"
    if hf.exists():
        out["history"] = History.load(hf)
    out.setdefault("name", name)
    out.setdefault("start-time", start)
    return out


def tests(name: Optional[str] = None, root=None) -> dict:
    """Map of test name -> start-time -> path (store.clj:275-294)."""
    b = base(root)
    out: dict = {}
    if not b.exists():
        return out
    names = [name] if name else [
        p.name for p in b.iterdir() if p.is_dir() and not p.is_symlink()
    ]
    for n in names:
        d = b / n
        if not d.is_dir():
            continue
        runs = {
            r.name: r for r in sorted(d.iterdir())
            if r.is_dir() and not r.is_symlink()
        }
        if runs:
            out[n] = runs
    return out


def latest(root=None) -> Optional[dict]:
    """The most recently started test, loaded (store.clj:296-305)."""
    best = None
    for n, runs in tests(root=root).items():
        for start in runs:
            if best is None or start > best[1]:
                best = (n, start)
    if best is None:
        return None
    return load_test(*best, root=root)


def delete(name: Optional[str] = None, root=None) -> None:
    """Delete stored runs for a test name, or everything (store.clj:450-458)."""
    b = base(root)
    target = b / name if name else b
    if target.exists():
        shutil.rmtree(target)


# ---------------------------------------------------------------------------
# Per-run logging (store.clj:411-439)


_log_handlers: dict = {}


class _JsonFormatter(logging.Formatter):
    """Structured log lines (the reference's --logging-json / unilog JSON
    appender, store.clj:399-439, cli.clj:89-90)."""

    def format(self, record):
        out = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "thread": record.threadName,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out)


def start_logging(test: dict) -> None:
    """Attach a jepsen.log file handler for this run (JSON lines when the
    test sets logging-json, cli --logging-json)."""
    f = path_mk(test, "jepsen.log")
    h = logging.FileHandler(f)
    if test.get("logging-json") or test.get("logging_json"):
        h.setFormatter(_JsonFormatter())
    else:
        h.setFormatter(logging.Formatter(
            "%(asctime)s{%(threadName)s} %(levelname)s %(name)s - %(message)s"
        ))
    root = logging.getLogger()
    if root.level > logging.INFO or root.level == logging.NOTSET:
        root.setLevel(logging.INFO)
    root.addHandler(h)
    _log_handlers[id(test)] = h


def stop_logging(test: dict) -> None:
    h = _log_handlers.pop(id(test), None)
    if h is not None:
        logging.getLogger().removeHandler(h)
        h.close()
