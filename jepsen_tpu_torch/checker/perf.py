"""Latency / rate plotting over histories. The port of the reference's
``jepsen_tpu/checker/perf.py`` (host-only; it needs matplotlib).

Mirrors jepsen.checker.perf (jepsen/src/jepsen/checker/perf.clj), with
matplotlib standing in for gnuplot (a rendering detail — the reference
drives a gnuplot subprocess, perf.clj:418-484): raw latency points per
(f, type) (:485-513), bucketed latency quantiles (:514-559), throughput
rate (:560-600), and nemesis activity shaded onto every plot
(:184-326).
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np

from . import Checker, checker_fn
from ..history import History
from ..util import nemesis_intervals

LOG = logging.getLogger("jepsen.checker.perf")

DT_S = 10.0  # quantile/rate bucket width, seconds (perf.clj:127-147)
QUANTILES = (0.5, 0.95, 0.99, 1.0)

_TYPE_COLORS = {"ok": "#81BFFC", "info": "#FFA400", "fail": "#FF1E90"}


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _shade_nemesis(ax, history: History, test: Optional[dict] = None
                   ) -> None:
    """perf.clj:184-326 — translucent spans while the nemesis is active.

    Honors the nemesis packages' perf specs (combined.clj perf entries:
    {"name", "start": fs, "stop": fs, "color"}) via
    ``test["plot"]["nemeses"]``; falls back to the default start/stop
    pairing."""
    try:
        t_end = max((op.time for op in history if op.time >= 0), default=0)
        specs = ((test or {}).get("plot") or {}).get("nemeses")
        if specs:
            def _fset(v, default):
                if v is None:
                    v = default
                if isinstance(v, str):
                    v = (v,)
                return frozenset(v)

            for spec in specs:
                stop_set = _fset(spec.get("stop"), ("stop",))
                pairing = {start_f: stop_set
                           for start_f in _fset(spec.get("start"), ())}
                if not pairing:
                    continue
                for start, stop in nemesis_intervals(history, pairing):
                    t0 = start.time / 1e9
                    t1 = (stop.time if stop is not None else t_end) / 1e9
                    ax.axvspan(t0, t1, color=spec.get("color", "#f3c3c3"),
                               alpha=0.35, lw=0)
        else:
            for start, stop in nemesis_intervals(history):
                t0 = start.time / 1e9
                t1 = (stop.time if stop is not None else t_end) / 1e9
                ax.axvspan(t0, t1, color="#f3c3c3", alpha=0.4, lw=0)
    except Exception:
        LOG.debug("nemesis shading failed", exc_info=True)


def point_graph(test: dict, history: History, path) -> None:
    """Raw latency scatter, colored by completion type, one series per f
    (perf.clj:485-513)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 5))
    _shade_nemesis(ax, history, test)
    by = {}
    for iv in history.pairs():
        if not isinstance(iv.process, int) or iv.inv_time < 0:
            continue
        end = iv.ret_time
        if end == float("inf"):
            continue
        by.setdefault((iv.f, iv.type), []).append(
            (iv.inv_time / 1e9, max(end - iv.inv_time, 1) / 1e6))
    for (f, typ), pts in sorted(by.items(), key=lambda kv: str(kv[0])):
        xs, ys = zip(*pts)
        ax.scatter(xs, ys, s=6, label=f"{f} {typ}",
                   color=_TYPE_COLORS.get(typ), alpha=0.6,
                   marker={"ok": "o", "info": "^", "fail": "x"}.get(typ, "o"))
    ax.set_yscale("log")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("latency (ms)")
    ax.set_title(f"{test.get('name', 'test')} latency (raw)")
    ax.legend(fontsize=7, ncol=2)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def quantiles_graph(test: dict, history: History, path) -> None:
    """Bucketed latency quantiles per f (perf.clj:514-559)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 5))
    _shade_nemesis(ax, history, test)
    by_f: dict = {}
    for iv in history.pairs():
        if not isinstance(iv.process, int) or iv.inv_time < 0:
            continue
        end = iv.ret_time
        if end == float("inf"):
            continue
        by_f.setdefault(iv.f, []).append(
            (iv.inv_time / 1e9, max(end - iv.inv_time, 1) / 1e6))
    for f, pts in sorted(by_f.items(), key=lambda kv: str(kv[0])):
        arr = np.array(pts)
        tmax = arr[:, 0].max() if len(arr) else 0
        for q in QUANTILES:
            xs, ys = [], []
            for lo in np.arange(0, tmax + DT_S, DT_S):
                sel = arr[(arr[:, 0] >= lo) & (arr[:, 0] < lo + DT_S)]
                if len(sel):
                    xs.append(lo + DT_S / 2)
                    ys.append(np.quantile(sel[:, 1], q))
            if xs:
                ax.plot(xs, ys, marker=".",
                        label=f"{f} q={q}", alpha=0.8)
    ax.set_yscale("log")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("latency (ms)")
    ax.set_title(f"{test.get('name', 'test')} latency quantiles")
    ax.legend(fontsize=7, ncol=2)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def rate_graph(test: dict, history: History, path) -> None:
    """Throughput per (f, type) in DT_S buckets (perf.clj:560-600)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 5))
    _shade_nemesis(ax, history, test)
    by: dict = {}
    tmax = 0.0
    for op in history:
        if op.is_invoke or not op.is_client:
            continue
        t = op.time / 1e9
        tmax = max(tmax, t)
        by.setdefault((op.f, op.type), []).append(t)
    for (f, typ), ts in sorted(by.items(), key=lambda kv: str(kv[0])):
        edges = np.arange(0, tmax + DT_S, DT_S)
        counts, _ = np.histogram(ts, bins=edges)
        ax.plot(edges[:-1] + DT_S / 2, counts / DT_S, marker=".",
                color=_TYPE_COLORS.get(typ), alpha=0.8,
                label=f"{f} {typ}")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("throughput (hz)")
    ax.set_title(f"{test.get('name', 'test')} rate")
    ax.legend(fontsize=7, ncol=2)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def _store_path(test: dict, opts: Optional[dict], fname: str):
    from .. import store

    sub = (opts or {}).get("subdirectory")
    parts = ([str(sub), fname] if sub else [fname])
    return store.path_mk(test, *parts)


def latency_graph() -> Checker:
    """checker.clj:794-806: latency-raw.png + latency-quantiles.png."""

    def chk(test, history, opts):
        if not (test.get("name") and test.get("start-time")) or test.get(
            "no-store?"
        ):
            return {"valid": True}
        point_graph(test, history,
                    _store_path(test, opts, "latency-raw.png"))
        quantiles_graph(test, history,
                        _store_path(test, opts, "latency-quantiles.png"))
        return {"valid": True}

    return checker_fn(chk, "latency-graph")


def rate_graph_checker() -> Checker:
    """checker.clj:807-818: rate.png."""

    def chk(test, history, opts):
        if not (test.get("name") and test.get("start-time")) or test.get(
            "no-store?"
        ):
            return {"valid": True}
        rate_graph(test, history, _store_path(test, opts, "rate.png"))
        return {"valid": True}

    return checker_fn(chk, "rate-graph")


def perf() -> Checker:
    """Composite of latency + rate graphs (checker.clj:819-826)."""
    from . import compose

    return compose({
        "latency-graph": latency_graph(),
        "rate-graph": rate_graph_checker(),
    })
