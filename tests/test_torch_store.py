"""The port's store (``jepsen_tpu_torch.store``) and its history file
format against the JAX reference's: one test map and history through both
packages' ``save_1``/``save_2`` into two roots give identical trees (file
names, the bytes of ``history.edn``, ``history.txt``, ``results.edn`` and
``test.edn``, the symlinks' targets); each package loads the other's
tree; ``time_str`` agrees; and a history in the reference's own textual
style (Clojure map printing, keyword ``f``s, a ``:nemesis`` ``:info``)
loads into equal ops and equal ``encode_history`` arrays."""

import os
import random
from pathlib import Path

import numpy as np
import pytest

from jepsen_tpu import store as R
from jepsen_tpu.history import History as RHistory
from jepsen_tpu.history import Op as ROp
from jepsen_tpu.models import CasRegister as RCas
from jepsen_tpu.ops.encode import encode_history as r_encode
from jepsen_tpu.testing import random_register_history as r_random
from jepsen_tpu_torch import store as P
from jepsen_tpu_torch.history import History as PHistory
from jepsen_tpu_torch.history import Op as POp
from jepsen_tpu_torch.models import CasRegister as PCas
from jepsen_tpu_torch.ops.encode import encode_history as p_encode
from jepsen_tpu_torch.testing import random_register_history as p_random

from test_torch_edn import graph

T0 = 1785456000.123  # a fixed start time
REFERENCE_STYLE = """\
{:type :invoke, :f :write, :value 3, :process 0, :time 10, :index 0}
{:type :info, :f :start, :value nil, :process :nemesis, :time 12, :index 1}
{:type :ok, :f :write, :value 3, :process 0, :time 20, :index 2}
{:type :invoke, :f :read, :value nil, :process 1, :time 30, :index 3}
{:type :ok, :f :read, :value 3, :process 1, :time 40, :index 4}
{:type :invoke, :f :cas, :value [3 4], :process 0, :time 50, :index 5}
{:type :ok, :f :cas, :value [3 4], :process 0, :time 60, :index 6}
{:type :invoke, :f :read, :value nil, :process 1, :time 70, :index 7}
{:type :ok, :f :read, :value 4, :process 1, :time 80, :index 8}
"""


def _history(random_history, History, Op, seed):
    """A seeded register history with a nemesis op, an op with an error
    and extra keys, and a non-keyword ``f``."""
    h = random_history(random.Random(seed), n_ops=30, n_procs=4, cas=True, crash_p=0.1)
    ops = list(h)
    ops.insert(3, Op("info", "nemesis", "start", None, time=ops[2].time + 1))
    ops.append(Op("fail", 0, "write", 7, time=ops[-1].time + 5, error="timeout",
                  extra=(("node", "n1"), ("retries", 2))))
    ops.append(Op("info", 1, 42, ("a", 1), time=ops[-1].time + 5, f_is_kw=False))
    return History(ops, reindex=True)


def _results(history):
    return {
        "valid": "unknown",
        "linear": {"valid": False, "op_count": 30, "attempts": [{"F": 4, "levels": 3}],
                   "stuck_configs": [{"state": [0], "linearized": [0, 1],
                                      "pending": [{"row": 2, "why": "model rejects"}]}]},
        "stats": {"valid": True, "by_f": {"read": {"count": 3}}, "rate": 1.5},
        "sets": frozenset({1, 2}), "pair": (1, "two"), "nothing": None,
        "history": history, "first": history[0], "weird": {1: "int key", None: "nil key"},
    }


def _test_map(mod, history, name="store-diff"):
    return {"name": name, "start-time": mod.time_str(T0), "store-root": "store",
            "nodes": ["n1", "n2"], "concurrency": 4, "time-limit": 5, "history": history,
            "client": object(), "checker": lambda: None, "flag?": True,
            "ssh": {"username": "root", "dummy?": True}}


def _tree(root: Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_symlink():
            out[rel] = ("link", os.readlink(p))
        elif p.is_file():
            out[rel] = ("file", p.read_bytes())
        else:
            out[rel] = ("dir",)
    return out


def _save_both(tmp_path, name="store-diff", seed=5):
    """Both packages save the same run, each from its own working
    directory (``tmp_path/ref``, ``tmp_path/port``) into ``store/``
    there, so the test maps, ``store-root`` included, are equal."""
    rh = _history(r_random, RHistory, ROp, seed)
    ph = _history(p_random, PHistory, POp, seed)
    rt, pt = _test_map(R, rh, name), _test_map(P, ph, name)
    cwd = os.getcwd()
    try:
        for mod, t, h, d in ((R, rt, rh, "ref"), (P, pt, ph, "port")):
            (tmp_path / d).mkdir(exist_ok=True)
            os.chdir(tmp_path / d)
            mod.save_1(t)
            t["results"] = _results(h)
            mod.save_2(t)
    finally:
        os.chdir(cwd)
    return rt, pt


def test_save_trees_are_identical(tmp_path):
    _save_both(tmp_path)
    ref, port = _tree(tmp_path / "ref" / "store"), _tree(tmp_path / "port" / "store")
    assert sorted(port) == sorted(ref)
    assert port == ref
    run = f"store-diff/{R.time_str(T0)}"
    assert {f"{run}/{n}" for n in ("history.edn", "history.txt", "results.edn",
                                   "test.edn")} <= set(port)
    assert port["latest"] == ("link", run) and port["store-diff/latest"][0] == "link"


def test_each_package_loads_the_others_tree(tmp_path):
    rt, _ = _save_both(tmp_path)
    start = rt["start-time"]
    for loader, other in ((P, tmp_path / "ref" / "store"), (R, tmp_path / "port" / "store")):
        mine = R if loader is P else P
        a = loader.load_test("store-diff", start, root=other)
        b = mine.load_test("store-diff", start, root=other)
        assert sorted(a) == sorted(b)
        assert [graph(o.to_edn()) for o in a.pop("history")] == \
            [graph(o.to_edn()) for o in b.pop("history")]
        assert graph(a) == graph(b)
        assert graph(loader.load_results("store-diff", start, root=other)) == \
            graph(mine.load_results("store-diff", start, root=other))
        assert [graph(o.to_edn()) for o in loader.load_history("store-diff", start, other)] \
            == [graph(o.to_edn()) for o in mine.load_history("store-diff", start, other)]


def test_tests_latest_and_delete_agree(tmp_path):
    _save_both(tmp_path, seed=5)
    _save_both(tmp_path, name="other", seed=6)
    for root in (tmp_path / "ref" / "store", tmp_path / "port" / "store"):
        assert {n: sorted(r) for n, r in P.tests(root=root).items()} == \
            {n: sorted(r) for n, r in R.tests(root=root).items()}
        assert P.latest(root=root)["name"] == R.latest(root=root)["name"]
    P.delete("other", root=tmp_path / "port" / "store")
    R.delete("other", root=tmp_path / "ref" / "store")
    assert sorted(_tree(tmp_path / "port")) == sorted(_tree(tmp_path / "ref"))
    assert "other" not in P.tests(root=tmp_path / "port" / "store")


@pytest.mark.parametrize("t", [0.0, 1.5, 59.999, T0, 1785456000.9995, 4102444799.001])
def test_time_str_agrees(t):
    assert P.time_str(t) == R.time_str(t)


def test_to_edn_value_agrees_on_odd_values():
    vals = [np.int64(3), np.float32(1.5), {"valid": "unknown", "x": [np.int32(2)]},
            {"k": {1, 2}}, object, 1 + 2j]
    for v in vals:
        assert P.edn.write_string(P.to_edn_value(v)) == R.edn.write_string(R.to_edn_value(v))


def test_reference_style_history_loads_alike():
    rh = RHistory.from_edn_string(REFERENCE_STYLE)
    ph = PHistory.from_edn_string(REFERENCE_STYLE)
    assert len(ph) == len(rh) == 9
    fields = ("type", "process", "f", "value", "time", "index", "error", "extra", "f_is_kw")
    for a, b in zip(ph, rh):
        assert [graph(getattr(a, k)) for k in fields] == [graph(getattr(b, k)) for k in fields]
    assert ph[1].process == "nemesis" and not ph[1].is_client
    assert ph[5].f == "cas" and ph[5].value == [3, 4]
    assert PHistory.from_edn_string(ph.to_edn_string()) == ph
    assert ph.to_edn_string() == rh.to_edn_string()
    pe, re_ = p_encode(PCas(init=0), ph.client_ops()), r_encode(RCas(init=0), rh.client_ops())
    for k in ("init_state", "inv", "ret", "opcode", "a1", "a2", "skippable"):
        np.testing.assert_array_equal(getattr(pe, k), getattr(re_, k), err_msg=k)


def test_history_txt_prints_reprs(tmp_path):
    """history.txt prints each op's process, type, f and value repr; the
    loaded reference-style history prints the same in both packages."""
    for mod, H in ((R, RHistory), (P, PHistory)):
        t = {"name": "txt", "start-time": "20180501T120000.000Z", "store-root":
             str(tmp_path / mod.__name__), "history": H.from_edn_string(REFERENCE_STYLE)}
        mod.write_history(t)
    a = (tmp_path / R.__name__ / "txt" / "20180501T120000.000Z" / "history.txt").read_text()
    b = (tmp_path / P.__name__ / "txt" / "20180501T120000.000Z" / "history.txt").read_text()
    assert a == b and "nemesis\tinfo\tstart\tNone" in b and "[3, 4]" in b


def test_per_run_log(tmp_path):
    t = {"name": "log", "start-time": P.time_str(T0), "store-root": str(tmp_path),
         "logging-json": True}
    P.start_logging(t)
    try:
        P.LOG.warning("hello %s", "store")
    finally:
        P.stop_logging(t)
    line = P.path(t, "jepsen.log").read_text().strip().splitlines()[-1]
    assert '"message": "hello store"' in line and '"level": "WARNING"' in line


def test_flight_record_goes_into_the_store(tmp_path):
    from jepsen_tpu_torch.telemetry import flight

    rec = flight.FlightRecorder()
    rec.note("stored", detail=1)
    t = {"name": "fr", "start-time": P.time_str(T0), "store-root": str(tmp_path)}
    path = flight.store_flight_record(t, rec, reason="test")
    assert Path(path) == P.path(t, "flightrecord.json")
    assert "stored" in Path(path).read_text()
    assert flight.store_flight_record(dict(t, **{"no-store?": True}), rec) is None
