"""The port's latency, rate and clock plots (``jepsen_tpu_torch.checker.
perf`` and ``checker.clock``) against the reference's.

The same seeded histories (client ops over two functions with ok, info and
fail completions, nemesis windows, ``clock-offsets`` annotations) go
through both packages' plots; each figure is captured as it is saved and
its series are read back from its axes: every line's points, label and
colour, every scatter's offsets, the shaded nemesis spans, the titles,
labels and scales. They must be equal. The checkers write the same files
into a test's store directory, and skip a test without one."""

from __future__ import annotations

import random

import matplotlib
import matplotlib.figure
import numpy as np
import pytest

from jepsen_tpu.checker import clock as r_clock
from jepsen_tpu.checker import perf as r_perf
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.history import Op as ROp
from jepsen_tpu_torch.checker import clock as p_clock
from jepsen_tpu_torch.checker import perf as p_perf
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import Op as POp

matplotlib.use("Agg")

REF = dict(perf=r_perf, clock=r_clock, History=RHistory, Op=ROp)
PORT = dict(perf=p_perf, clock=p_clock, History=PHistory, Op=POp)


def rows(seed, n=240, nemesis=True, offsets=True):
    """One seeded history as op dicts: 4 clients over read/write with ok,
    info and fail completions over ~60 s, nemesis start/stop pairs and
    clock offsets on the nemesis ops."""
    rng = random.Random(seed)
    out, t = [], 0
    for i in range(n):
        t += rng.randint(50, 400) * 1_000_000
        p = i % 4
        f = rng.choice(["read", "write"])
        out.append({"type": "invoke", "process": p, "f": f, "value": None, "time": t})
        typ = rng.choices(["ok", "info", "fail"], weights=[8, 1, 1])[0]
        lat = int(rng.expovariate(1 / 20e6)) + 1
        out.append({"type": typ, "process": p, "f": f, "value": rng.randint(0, 4),
                    "time": t + lat})
        if nemesis and i % 60 == 20:
            nf = "start" if (i // 60) % 2 == 0 else "stop"
            op = {"type": "info", "process": "nemesis", "f": nf, "value": None,
                  "time": t + lat + 1}
            if offsets:
                op["clock-offsets"] = {"n1": rng.uniform(-1, 1), "n2": rng.uniform(-2, 2)}
            out.append(op)
    out.sort(key=lambda m: m["time"])
    return out


def history(pkg, seed, **kw):
    return pkg["History"]([pkg["Op"].from_dict(m) for m in rows(seed, **kw)], reindex=True)


def _arr(a):
    return np.asarray(a, dtype=float).round(9).tolist()


def read_figure(fig):
    out = []
    for ax in fig.axes:
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "yscale": ax.get_yscale(),
            "lines": [(ln.get_label(), matplotlib.colors.to_hex(ln.get_color()),
                       _arr(ln.get_xydata())) for ln in ax.lines],
            "scatters": [(c.get_label(), _arr(c.get_offsets()),
                          [matplotlib.colors.to_hex(x) for x in c.get_facecolors()[:1]])
                         for c in ax.collections],
            "spans": [(_arr(p.get_xy() if hasattr(p, "get_xy") else p.get_path().vertices),
                       matplotlib.colors.to_hex(p.get_facecolor()), round(p.get_alpha() or 1, 3))
                      for p in ax.patches],
            "legend": ([t.get_text() for t in ax.get_legend().get_texts()]
                       if ax.get_legend() else None),
        })
    return out


@pytest.fixture()
def captured(monkeypatch):
    figs = []

    def savefig(self, path, *a, **kw):
        figs.append((str(path).rsplit("/", 1)[-1], read_figure(self)))

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return figs


def _plot(pkg, fn, seed, test, tmp_path, captured, **kw):
    del captured[:]
    h = history(pkg, seed, **kw)
    mod = pkg["clock"] if fn == "clock" else pkg["perf"]
    call = mod.plot if fn == "clock" else getattr(mod, fn)
    ret = call(test, h, tmp_path / f"{fn}.png")
    return ret, list(captured)


PLOT_TESTS = [{"name": "reg"},
              {"name": "shaded", "plot": {"nemeses": [
                  {"name": "part", "start": "start", "stop": ["stop"], "color": "#a0c0ff"}]}}]


@pytest.mark.parametrize("test", range(len(PLOT_TESTS)))
@pytest.mark.parametrize("fn", ["point_graph", "quantiles_graph", "rate_graph", "clock"])
@pytest.mark.parametrize("seed", [1, 2])
def test_plot_series_match_reference(fn, seed, test, tmp_path, captured):
    t = PLOT_TESTS[test]
    ref = _plot(REF, fn, seed, t, tmp_path, captured)
    port = _plot(PORT, fn, seed, t, tmp_path, captured)
    assert port == ref
    figs = port[1]
    assert len(figs) == 1
    ax = figs[0][1][0]
    assert ax["lines"] or ax["scatters"]
    assert ax["spans"], "the nemesis windows are shaded"


def test_clock_datasets_and_empty_history(tmp_path, captured):
    for seed in (1, 2):
        hr, hp = history(REF, seed), history(PORT, seed)
        assert p_clock.history_to_datasets(hp) == r_clock.history_to_datasets(hr)
        assert sorted(p_clock.history_to_datasets(hp)) == ["n1", "n2"]
    hp = history(PORT, 3, offsets=False)
    assert p_clock.plot({"name": "x"}, hp, tmp_path / "c.png") is False
    assert r_clock.plot({"name": "x"}, history(REF, 3, offsets=False),
                        tmp_path / "c.png") is False
    assert captured == []


def _run_checker(pkg, chk, tmp_path, seed):
    import os

    test = {"name": "plots", "start-time": "20260101T000000.000Z",
            "store-root": str(tmp_path)}
    tmp_path.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        res = chk.check(test, history(pkg, seed), {"subdirectory": "sub"})
        skipped = chk.check({"name": "plots", "no-store?": True}, history(pkg, seed), {})
    finally:
        os.chdir(cwd)
    return res, skipped


@pytest.mark.parametrize("which", [pytest.param("perf", id="composite"), "latency_graph",
                                   "rate_graph_checker", "clock_plot"])
def test_checkers_write_the_references_files(which, tmp_path, captured):
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        mod = pkg["clock"] if which == "clock_plot" else pkg["perf"]
        del captured[:]
        res, skipped = _run_checker(pkg, getattr(mod, which)(), tmp_path / name, 5)
        # ``compose`` runs its checkers on threads: the figures in name order
        figs = sorted(captured, key=lambda c: c[0])
        out[name] = (res, skipped, [c[0] for c in figs], [c[1] for c in figs])
    assert out["port"] == out["ref"]
    assert out["port"][2], "no figure was saved"
