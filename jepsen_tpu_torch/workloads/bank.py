"""Bank workload: transfers between accounts, total-balance invariant
(snapshot-isolation probe). The port of the reference's
``jepsen_tpu/workloads/bank.py`` (jepsen.tests.bank,
jepsen/src/jepsen/tests/bank.clj).

Test-map options: ``accounts`` (ids), ``total-amount``, ``max-transfer``,
``negative-balances?``.
"""

from __future__ import annotations

from typing import Optional

from .. import generator as gen
from ..checker import Checker, checker_fn


def initial_balances(test: dict) -> list:
    """(account, balance) rows splitting test["total-amount"] across
    test["accounts"], remainder on the first account — the shared setup
    shape every SQL bank client renders into its INSERT."""
    accounts = list(test["accounts"])
    total = test["total-amount"]
    base = total // len(accounts)
    remainder = total - base * len(accounts)
    return [(a, base + (remainder if a == accounts[0] else 0))
            for a in accounts]


def read_op(test=None, ctx=None):
    """bank.clj:20-23."""
    return {"type": "invoke", "f": "read"}


def transfer(test, ctx):
    """Random transfer between two random accounts (bank.clj:25-33)."""
    accounts = test["accounts"]
    return {
        "type": "invoke",
        "f": "transfer",
        "value": {
            "from": accounts[gen.rand_int(len(accounts))],
            "to": accounts[gen.rand_int(len(accounts))],
            "amount": 1 + gen.rand_int(test["max-transfer"]),
        },
    }


def diff_transfer(test=None, ctx=None):
    """Transfers only between different accounts (bank.clj:35-39)."""
    return gen.filter_(
        lambda op: op["value"]["from"] != op["value"]["to"], transfer
    )


def generator():
    """Mix of reads and transfers (bank.clj:41-44)."""
    return gen.mix([diff_transfer(), read_op])


def _err_badness(test: dict, err: dict) -> float:
    """bank.clj:46-55 — bigger is worse."""
    t = err["type"]
    if t == "unexpected-key":
        return len(err["unexpected"])
    if t == "nil-balance":
        return len(err["nils"])
    if t == "wrong-total":
        return abs((err["total"] - test["total-amount"]) /
                   test["total-amount"])
    if t == "negative-value":
        return -sum(err["negative"])
    return 0.0


def _check_op(accts: set, total: int, negative_ok: bool, op) -> Optional[dict]:
    """bank.clj:57-81."""
    value = op.value or {}
    ks = list(value.keys())
    balances = list(value.values())
    if not all(k in accts for k in ks):
        return {"type": "unexpected-key",
                "unexpected": [k for k in ks if k not in accts],
                "op": repr(op)}
    if any(b is None for b in balances):
        return {"type": "nil-balance",
                "nils": {k: v for k, v in value.items() if v is None},
                "op": repr(op)}
    if sum(balances) != total:
        return {"type": "wrong-total", "total": sum(balances),
                "op": repr(op)}
    if not negative_ok and any(b < 0 for b in balances):
        return {"type": "negative-value",
                "negative": [b for b in balances if b < 0],
                "op": repr(op)}
    return None


def checker(checker_opts: Optional[dict] = None) -> Checker:
    """Reads sum to :total-amount; balances non-negative unless allowed
    (bank.clj:83-121)."""
    copts = dict(checker_opts or {})

    def chk(test, history, opts):
        accts = set(test["accounts"])
        total = test["total-amount"]
        negative_ok = copts.get("negative-balances?", False)
        reads = [op for op in history if op.is_ok and op.f == "read"]
        errors: dict = {}
        for op in reads:
            err = _check_op(accts, total, negative_ok, op)
            if err is not None:
                errors.setdefault(err["type"], []).append(err)
        out: dict = {
            "valid": not errors,
            "read_count": len(reads),
            "error_count": sum(len(v) for v in errors.values()),
        }
        if errors:
            out["errors"] = {
                t: {
                    "count": len(errs),
                    "first": errs[0],
                    "worst": max(errs, key=lambda e: _err_badness(test, e)),
                    "last": errs[-1],
                    **({"lowest": min(errs, key=lambda e: e["total"]),
                        "highest": max(errs, key=lambda e: e["total"])}
                       if t == "wrong-total" else {}),
                }
                for t, errs in errors.items()
            }
        return out

    return checker_fn(chk, "bank")


def test(opts: Optional[dict] = None) -> dict:
    """Partial test map (bank.clj:179-193 defaults: 8 accounts, total 100,
    max transfer 5)."""
    o = dict(opts or {})
    return {
        "max-transfer": o.get("max-transfer", 5),
        "total-amount": o.get("total-amount", 100),
        "accounts": o.get("accounts", list(range(8))),
        "checker": checker(o),
        "generator": generator(),
    }
