"""Clock-offset plot from :clock-offsets annotations. The port of the
reference's ``jepsen_tpu/checker/clock.py`` (host-only; it needs
matplotlib).

Mirrors jepsen.checker.clock (jepsen/src/jepsen/checker/clock.clj): the
clock nemesis annotates ops with ``clock-offsets`` maps (node ->
seconds); this renders one line per node (clock.clj:13-75) into
``clock-skew.png``.
"""

from __future__ import annotations

from typing import Optional

from . import Checker, checker_fn
from .perf import _mpl, _shade_nemesis, _store_path


def history_to_datasets(history) -> dict:
    """node -> [(t_s, offset_s)] (clock.clj:13-34)."""
    out: dict = {}
    for op in history:
        offsets = op.get("clock-offsets") if hasattr(op, "get") else None
        if not offsets:
            continue
        t = op.time / 1e9
        for node, off in (offsets.items() if isinstance(offsets, dict)
                          else []):
            out.setdefault(str(node), []).append((t, off))
    return out


def plot(test: dict, history, path) -> bool:
    datasets = history_to_datasets(history)
    if not datasets:
        return False
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 4))
    _shade_nemesis(ax, history)
    for node, pts in sorted(datasets.items()):
        xs, ys = zip(*pts)
        ax.plot(xs, ys, marker=".", label=node)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("clock offset (s)")
    ax.set_title(f"{test.get('name', 'test')} clock skew")
    ax.legend(fontsize=8)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return True


def clock_plot() -> Checker:
    """checker.clj:828-834."""

    def chk(test, history, opts):
        if not (test.get("name") and test.get("start-time")) or test.get(
            "no-store?"
        ):
            return {"valid": True}
        plot(test, history, _store_path(test, opts, "clock-skew.png"))
        return {"valid": True}

    return checker_fn(chk, "clock-plot")
