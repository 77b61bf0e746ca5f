"""The port's workload checkers against the reference's: bank, causal,
causal-reverse, long fork, Adya G2 and Elle's ``monotonic_key_check``.

Each history is drawn from a numpy seed, once, as op maps; both packages
build their own ``History`` of the same ops, and the whole result maps must
be equal (the op reprs they carry are the same text in both packages)."""

from __future__ import annotations

import numpy as np
import pytest

import jepsen_tpu.elle as ref_elle
import jepsen_tpu_torch.elle as elle
from jepsen_tpu import independent as ref_ind
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.workloads import adya as ref_adya
from jepsen_tpu.workloads import bank as ref_bank
from jepsen_tpu.workloads import causal as ref_causal
from jepsen_tpu.workloads import long_fork as ref_long_fork
from jepsen_tpu_torch import independent as ind
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.workloads import adya, bank, causal, long_fork

SEEDS = (0, 1, 2)


def histories(rows, keyed=False):
    """The reference's and the port's History of the same op maps; with
    ``keyed``, two-element list values become each package's ``[k v]``."""
    def conv(KV, r):
        v = r.get("value")
        if keyed and isinstance(v, list) and len(v) == 2:
            r = dict(r, value=KV(*v))
        return r

    return (RefHistory([RefOp.from_dict(conv(ref_ind.KV, r)) for r in rows]),
            History([Op.from_dict(conv(ind.KV, r)) for r in rows]))


def same(ref_chk, port_chk, rows, test=None, keyed=False):
    rh, ph = histories(rows, keyed)
    ref = ref_chk.check(test or {}, rh, {})
    port = port_chk.check(test or {}, ph, {})
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# bank


BANK = {"accounts": list(range(5)), "total-amount": 50}


def bank_rows(seed, fault=None, n=80):
    """Reads of a five-account bank (and the transfers between them); a
    ``fault`` breaks some reads in one of bank.clj's ways."""
    rng = np.random.default_rng(seed)
    bal = [10] * 5
    rows = []
    for i in range(n):
        p = int(rng.integers(4))
        if rng.random() < 0.5:
            a, b = (int(x) for x in rng.choice(5, 2, replace=False))
            amt = int(rng.integers(1, 6))
            v = {"from": a, "to": b, "amount": amt}
            rows.append({"type": "invoke", "process": p, "f": "transfer", "value": v,
                         "time": 2 * i})
            ok = bal[a] >= amt
            if ok:
                bal[a] -= amt
                bal[b] += amt
            rows.append({"type": "ok" if ok else "fail", "process": p, "f": "transfer",
                         "value": v, "time": 2 * i + 1})
            continue
        read = dict(enumerate(bal))
        if fault and rng.random() < 0.3:
            if fault == "wrong-total":
                read[int(rng.integers(5))] += int(rng.integers(1, 9))
            elif fault == "negative-value":
                read[0] -= 60
                read[1] += 60
            elif fault == "nil-balance":
                read[2] = None
            elif fault == "unexpected-key":
                read[77] = 0
        rows.append({"type": "invoke", "process": p, "f": "read", "value": None,
                     "time": 2 * i})
        rows.append({"type": "ok", "process": p, "f": "read", "value": read,
                     "time": 2 * i + 1})
    return rows


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", [None, "wrong-total", "negative-value", "nil-balance",
                                   "unexpected-key"])
def test_bank(seed, fault):
    res = same(ref_bank.checker(), bank.checker(), bank_rows(seed, fault), BANK)
    assert res["valid"] is (fault is None)
    if fault:
        assert fault in res["errors"]


def test_bank_negative_balances_allowed():
    rows = bank_rows(5, "negative-value")
    res = same(ref_bank.checker({"negative-balances?": True}),
               bank.checker({"negative-balances?": True}), rows, BANK)
    assert res["valid"] is True


def test_bank_helpers_match_reference():
    test = {"accounts": [1, 2, 3], "total-amount": 10}
    assert bank.initial_balances(test) == ref_bank.initial_balances(test)
    assert bank.read_op() == ref_bank.read_op()
    for err in ({"type": "wrong-total", "total": 13}, {"type": "negative-value",
                                                        "negative": [-1, -4]},
                {"type": "nil-balance", "nils": {1: None}},
                {"type": "unexpected-key", "unexpected": [9, 8]}, {"type": "other"}):
        assert bank._err_badness(test, err) == ref_bank._err_badness(test, err)


# ---------------------------------------------------------------------------
# causal and causal-reverse


def causal_rows(fault=None, keys=3):
    """Per key the causal order [read-init, w1, read, w2, read], keyed."""
    rows, t = [], 0
    for k in range(keys):
        steps = [("read-init", 0), ("write", 1), ("read", 1), ("write", 2), ("read", 2)]
        link = "init"
        for pos, (f, v) in enumerate(steps, 1):
            if fault == "link" and k == 1 and pos == 3:
                link = 99
            if fault == "read" and k == 2 and pos == 5:
                v = 1
            if fault == "write" and k == 0 and pos == 4:
                v = 3
            for typ in ("invoke", "ok"):
                rows.append({"type": typ, "process": k, "f": f,
                             "value": [k, None if typ == "invoke" and f != "write" else v],
                             "link": link, "position": pos, "time": t})
                t += 1
            link = pos
    return rows


@pytest.mark.parametrize("fault", [None, "link", "read", "write"])
def test_causal_check_per_key(fault):
    rows = causal_rows(fault)
    res = same(ref_ind.checker(ref_causal.check()), ind.checker(causal.check()), rows,
               keyed=True)
    assert res["valid"] is (fault is None)


def test_causal_register_steps_match_reference():
    for f, v, link in (("read-init", 3, "init"), ("read", 5, "init"), ("bogus", 0, "init"),
                       ("write", 1, 7)):
        op = {"type": "ok", "process": 0, "f": f, "value": v, "link": link, "position": 1}
        a = ref_causal.CausalRegister().step(RefOp.from_dict(op))
        b = causal.CausalRegister().step(Op.from_dict(op))
        assert type(a).__name__ == type(b).__name__ and repr(a) == repr(b)
    assert causal.ri() == ref_causal.ri() and causal.cw2() == ref_causal.cw2()


def reverse_rows(seed, broken=False, n=60):
    """Concurrent writes of unique values and reads of the visible set; a
    ``broken`` read hides a write acknowledged before one it shows."""
    rng = np.random.default_rng(seed)
    rows, acked, t, nxt = [], [], 0, 0
    for i in range(n):
        p = int(rng.integers(4))
        if rng.random() < 0.5:
            nxt += 1
            rows.append({"type": "invoke", "process": p, "f": "write", "value": nxt, "time": t})
            rows.append({"type": "ok", "process": p, "f": "write", "value": nxt, "time": t + 1})
            acked.append(nxt)
        else:
            seen = list(acked)
            if broken and len(seen) > 3 and rng.random() < 0.4:
                del seen[int(rng.integers(len(seen) - 1))]
            rows.append({"type": "invoke", "process": p, "f": "read", "value": None, "time": t})
            rows.append({"type": "ok", "process": p, "f": "read", "value": seen, "time": t + 1})
        t += 2
    return rows


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("broken", [False, True])
def test_causal_reverse(seed, broken):
    rows = reverse_rows(seed, broken)
    res = same(ref_causal.reverse_checker(), causal.reverse_checker(), rows)
    assert res["valid"] is (not broken)
    rh, ph = histories(rows)
    assert causal.precedence_graph(ph) == ref_causal.precedence_graph(rh)


# ---------------------------------------------------------------------------
# long fork


def long_fork_rows(seed, fork=False, n=2, groups=4, multiple=False, uneven=False):
    """Single-key writes of each group's keys and group reads of what was
    written so far; ``fork`` adds two reads that saw different halves."""
    rng = np.random.default_rng(seed)
    rows, t = [], 0

    def txn(p, f, value):
        nonlocal t
        for typ in ("invoke", "ok"):
            rows.append({"type": typ, "process": p, "f": f, "value": value, "time": t})
            t += 1

    written = set()
    for g in range(groups):
        keys = long_fork.group_for(n, g * n)
        for k in keys:
            txn(int(rng.integers(4)), "write", [["w", k, 1]])
            written.add(k)
            order = list(rng.permutation(keys))
            txn(int(rng.integers(4)), "read",
                [["r", int(kk), 1 if kk in written else None] for kk in order])
    if fork:
        a, b = long_fork.group_for(n, 0)[:2]
        txn(0, "read", [["r", a, 1], ["r", b, None]] + [["r", k, 1] for k in
                                                           long_fork.group_for(n, 0)[2:]])
        txn(1, "read", [["r", a, None], ["r", b, 1]] + [["r", k, 1] for k in
                                                           long_fork.group_for(n, 0)[2:]])
    if multiple:
        txn(2, "write", [["w", 0, 1]])
    if uneven:
        txn(3, "read", [["r", 0, 1]])
    return rows


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("fork", [False, True])
def test_long_fork(seed, n, fork):
    res = same(ref_long_fork.checker(n), long_fork.checker(n), long_fork_rows(seed, fork, n))
    assert res["valid"] is (not fork)
    if fork:
        assert res["forks"]


@pytest.mark.parametrize("kind", ["multiple", "uneven"])
def test_long_fork_unknown(kind):
    rows = long_fork_rows(4, **{kind: True})
    res = same(ref_long_fork.checker(2), long_fork.checker(2), rows)
    assert res["valid"] == "unknown"


def test_long_fork_illegal_values_unknown():
    rows = long_fork_rows(5)
    rows.append({"type": "ok", "process": 0, "f": "read", "value": [["r", 0, 2], ["r", 1, 1]],
                 "time": 10_000})
    res = same(ref_long_fork.checker(2), long_fork.checker(2), rows)
    assert res["valid"] == "unknown" and long_fork.ILLEGAL in res["error"]


def test_long_fork_helpers():
    assert long_fork.group_for(3, 7) == ref_long_fork.group_for(3, 7) == [6, 7, 8]
    txn = long_fork.read_txn_for(4, 9)
    assert sorted(m[1] for m in txn) == [8, 9, 10, 11] and all(m[0] == "r" for m in txn)
    ops = [Op("ok", 0, "read", [["r", 0, 1], ["r", 1, None]]),
           Op("ok", 1, "read", [["r", 0, None], ["r", 1, 1]])]
    rops = [RefOp("ok", 0, "read", [["r", 0, 1], ["r", 1, None]]),
            RefOp("ok", 1, "read", [["r", 0, None], ["r", 1, 1]])]
    assert [[repr(x) for x in f] for f in long_fork.find_forks(ops)] == \
        [[repr(x) for x in f] for f in ref_long_fork.find_forks(rops)]


# ---------------------------------------------------------------------------
# Adya G2


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("broken", [False, True])
def test_g2(seed, broken):
    rng = np.random.default_rng(seed)
    rows, t, nid = [], 0, 0
    for k in range(12):
        winners = int(rng.integers(0, 2)) + (1 if broken and k % 5 == 1 else 0)
        for j in range(2):
            nid += 1
            v = [k, [None, nid] if j == 0 else [nid, None]]
            typ = "ok" if j < winners else ("fail" if rng.random() < 0.7 else "info")
            rows.append({"type": "invoke", "process": 2 * k + j, "f": "insert", "value": v,
                         "time": t})
            rows.append({"type": typ, "process": 2 * k + j, "f": "insert", "value": v,
                         "time": t + 1})
            t += 2
    rows.append({"type": "ok", "process": 99, "f": "insert", "value": [None, 1], "time": t})
    res = same(ref_adya.g2_checker(), adya.g2_checker(), rows, keyed=True)
    assert res["valid"] is (not broken)


# ---------------------------------------------------------------------------
# monotonic_key_check


def monotonic_rows(seed, broken=False, paired=True, n=40):
    """Reads of two monotone counters; a ``broken`` read sees one go back."""
    rng = np.random.default_rng(seed)
    x, y, rows, t = 0, 0, [], 0
    for i in range(n):
        x += int(rng.integers(0, 2))
        y += int(rng.integers(0, 3))
        seen = {"x": x, "y": y}
        if broken and i == n // 2:
            seen["x"] = max(0, x - 2)
            x += 1
        p = int(rng.integers(4))
        if paired:
            rows.append({"type": "invoke", "process": p, "f": "read", "value": None,
                         "time": t})
        rows.append({"type": "ok", "process": p, "f": "read", "value": seen, "time": t + 1})
        t += 2
    return rows


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("broken", [False, True])
def test_monotonic_key_check(seed, broken):
    rh, ph = histories(monotonic_rows(seed, broken))
    res = elle.monotonic_key_check(ph)
    assert res == ref_elle.monotonic_key_check(rh)
    assert res["valid"] is (not broken) and "realtime_unavailable" not in res
    if broken:
        assert res["cycles"][0]["ops"]
    assert elle.monotonic_key_check(ph, realtime=False) == \
        ref_elle.monotonic_key_check(rh, realtime=False)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("broken", [False, True])
def test_monotonic_key_check_without_pairs(seed, broken):
    """Completion maps alone: no realtime order, so the value order alone
    decides, and the result says the realtime graph was unavailable."""
    rows = monotonic_rows(seed, broken, paired=False)
    res = elle.monotonic_key_check(rows)
    assert res == ref_elle.monotonic_key_check(rows)
    assert res["realtime_unavailable"] is True


# ---------------------------------------------------------------------------
# the workloads' generators


def _plain(x):
    """Plain data of a simulated op: either package's ``[k v]`` tuple as
    ``("KV", k, v)``, sequences as lists."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if type(x).__name__ == "KV":
        return ("KV", _plain(x.key), _plain(x.value))
    return x


def _simulated(mod, fn_name, pkg):
    """30 ops of the workload function's generator through its package's
    simulator (every op ok after 10 ns, the RNG pinned), with the bank's
    test map where the generator reads one."""
    import importlib

    G = importlib.import_module(f"{pkg}.generator")
    S = importlib.import_module(f"{pkg}.generator.sim")
    fn = getattr(mod, fn_name)
    test = {"accounts": list(range(5)), "max-transfer": 5, "total-amount": 50}
    with G.fixed_rand(S.RAND_SEED):
        if fn_name == "transfer":
            g = fn
        elif fn_name in ("test", "reverse_workload", "workload", "g2"):
            built = fn({"nodes": ["n1", "n2"], "device": "cpu"}) if fn_name != "workload" \
                else fn()
            test = {**test, **{k: v for k, v in built.items()
                               if k not in ("checker", "generator")}}
            g = built["generator"]
        else:
            g = fn()
        g = G.limit(30, g)
    return S.simulate(g, lambda ctx, o: {**o, "type": "ok", "time": o["time"] + 10},
                      S.n_plus_nemesis_context(4), test)


@pytest.mark.parametrize("fn", [bank.transfer, bank.diff_transfer, bank.generator, bank.test,
                                causal.test, causal.reverse_workload, long_fork.generator,
                                long_fork.workload, adya.g2_gen, adya.g2])
def test_generators_raise_naming_the_runner_slice(fn):
    """Each workload generator simulates as the reference's, op for op."""
    import sys

    port_mod = sys.modules[fn.__module__]
    ref_mod = {bank: ref_bank, causal: ref_causal, long_fork: ref_long_fork,
               adya: ref_adya}[port_mod]
    got = _simulated(port_mod, fn.__name__, "jepsen_tpu_torch")
    want = _simulated(ref_mod, fn.__name__, "jepsen_tpu")
    assert _plain(got) == _plain(want) and got
