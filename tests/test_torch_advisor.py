"""The port's config advisor (``jepsen_tpu_torch.advisor``) against the
reference's.

Every input walk (``collect_*``) and every rule, through ``advise``, over
documents that make each rule fire and stay quiet (the reference's
closed-form cases), gives the reference's recommendations: the same ids,
severities, titles, evidence and order. The advice text is the
reference's but for the package's name and three rules the port words
otherwise (``prewarm_compiles`` names the kernel library's build directory
where the reference names the XLA compile cache, ``device_baseline_missing``
the GPU where it names TPU hardware, ``round_cadence`` a round with each
change). ``main`` over the committed
``BENCH_r*.json`` rounds (all of them, and those through r13), as text and
as JSON, prints the reference's output under the same normalisation."""

from __future__ import annotations

import glob
import json
import os
from pathlib import Path

import pytest

from jepsen_tpu import advisor as r_adv
from jepsen_tpu import benchcmp as r_bc
from jepsen_tpu_torch import advisor as p_adv

ROOT = Path(__file__).resolve().parent.parent

# The port's wording -> the reference's.
WORDING = [
    ("a large idle share is kernel builds: pre-warm", "a large idle share is jit compiles: pre-warm"),
    ("keep the kernel library's build directory (jepsen_tpu_torch/_build/) across runs",
     "keep the persistent XLA compile cache across runs"),
    ("run one round on the GPU with the guard unset", "run one round on TPU hardware with the "
                                                      "guard unset"),
    ("with each change so benchcmp and the ledger gate regressions at change granularity",
     "with each PR so benchcmp and the ledger gate regressions at PR granularity"),
    ("jepsen_tpu_torch", "jepsen_tpu"),
]


def as_reference(text: str) -> str:
    for port, ref in WORDING:
        text = text.replace(port, ref)
    return text


def _fleet(**kw):
    return {"service_router": {"fleet": dict({
        "configured_backends": 2, "live_backends": 2, "respawn_disabled": False,
        "respawn_gave_up": []}, **kw)}}


DOCS = {
    "empty": {},
    "capacity_bound": {"provenance": {"causes": {"overflow_top_rung": 8, "beam_loss": 2,
                                                 "max_configs": 3}}},
    "budget_bound": {"provenance": {"causes": {"max_configs": 2, "carry_lost": 9,
                                               "overflow_top_rung": 1}}},
    "faults": {"provenance": {"causes": {"worker_died": 3, "journal_gap": 1}}},
    "gaps": {"gap_share": {"host-stacking": 0.4, "starved": 0.3, "compiling": 0.26,
                           "no-work": 0.04}},
    "gap_edge": {"gap_share": {"starved": 0.25}},
    "nested": {"provenance": {"causes": {"max_configs": 2}},
               "service_streams": {"provenance": {"causes": {"max_configs": 1,
                                                             "carry_lost": 4}}},
               "device_gap_share": {"starved": 0.1},
               "batch_replay_large": {"smoke_8x10k": {"gap_share": {"starved": 0.6,
                                                                    "compiling": 0.2}}}},
    "tail": {"online_10k": {"p50_decision_latency_s": 0.01, "p99_decision_latency_s": 1.0}},
    "tail_ok": {"online_10k": {"p50_decision_latency_s": 0.01,
                               "p99_decision_latency_s": 0.05}},
    "rebalance": {"service_router": {"backend_loads": {"backend-0": {"load": 600.0},
                                                       "backend-1": {"load": 4.0}}}},
    "rebalance_small": {"service_router": {"backend_loads": {"b0": {"load": 100.0},
                                                             "b1": {"load": 1.0}}}},
    "loads_nested": {"service_router": {"backend_loads": {
        "backend-0": {"load": 520.0, "scheduler_backlog": 500}, "backend-1": {"load": 3.0}}},
        "nested": {"backend_loads": {"backend-0": 10.0}}},
    "plan_skew": {"offline_segmented": {"plan": {
        "largest_item_ops": 5000, "mean_worker_share_ops": 1000.0,
        "largest_item_key": "'k3'", "n_streams": 4}}},
    "plan_nested": {"offline_segmented": {"plan": {"largest_item_ops": 100,
                                                   "mean_worker_share_ops": 100.0},
                                          "scale_10m": {"plan": {
                                              "largest_item_ops": 900,
                                              "mean_worker_share_ops": 100.0}}}},
    "respawn_gave_up": _fleet(live_backends=1, respawn_gave_up=["backend-0"]),
    "respawn_disabled": _fleet(live_backends=1, respawn_disabled=True),
    "respawn_healing": _fleet(live_backends=1),
    "fleet_worst": {"service_router": _fleet()["service_router"],
                    "nested": {"fleet": {"configured_backends": 3, "live_backends": 1,
                                         "respawn_disabled": False,
                                         "respawn_gave_up": ["backend-2"]}}},
    "slo_hot": _fleet(slo={"availability_target": 0.999, "latency_target_s": 30.0,
                           "windows": {"fast": {"availability_burn_rate": 20.0,
                                                "latency_burn_rate": 0.0},
                                       "slow": {"availability_burn_rate": 2.0,
                                                "latency_burn_rate": 0.0}}}),
    "slo_slow_leak": _fleet(slo={"windows": {"fast": {"latency_burn_rate": 1.0},
                                             "slow": {"latency_burn_rate": 7.0}}}),
    "slo_ok": _fleet(slo={"windows": {"fast": {"availability_burn_rate": 13.0},
                                      "slow": {"latency_burn_rate": 5.0}}}),
    "underutilized": _fleet(utilization={"b0": {"utilization_pct": 91.0, "source": "backlog"},
                                         "b1": {"utilization_pct": 7.5, "source": "backlog"}}),
    "utilized": _fleet(utilization={"b0": {"utilization_pct": 80.0},
                                    "b1": {"utilization_pct": 75.0}}),
    "stale": _fleet(stale_backends=["backend-1"], federation={
        "backend-0": {"scrape_age_s": 0.1, "stale": False},
        "backend-1": {"scrape_age_s": 42.0, "stale": True}}),
    "skipped": {"mutex_5k": {"skipped": "device_slow_guard"}, "elle_txn": {"value_s": 1.0},
                "batch_replay_large": {"skipped": "budget"}},
    "elle": {"provenance": {"causes": {"elle_bucket_ceiling": 2, "elle_device_oom": 2,
                                       "beam_loss": 3, "max_configs": 3}}},
    "elle_quiet": {"provenance": {"causes": {"elle_device_oom": 2, "beam_loss": 4,
                                             "max_configs": 4}}},
    "ingest": {"provenance": {"causes": {"ingest_unmapped_op": 2, "beam_loss": 9,
                                         "max_configs": 9}}},
    "everything": {"provenance": {"causes": {"journal_gap": 1, "round_failed": 2}},
                   "gap_share": {"starved": 0.5, "compiling": 0.9},
                   "mutex_5k": {"skipped": "budget"}},
}
CONTEXT = {
    "none": {},
    "cadence": {"rounds": [{"label": "r05", "metrics": {}}, {"label": "r13", "metrics": {}}]},
    "no_gap": {"rounds": [{"label": "r04", "metrics": {}}, {"label": "r05", "metrics": {}}]},
    "trend": {"comparison": {"from": "r12", "to": "r13", "regressions": ["value_s"]}},
    "trend_quiet": {"comparison": {"from": "a", "to": "b", "regressions": []}},
}


def _normal(recs):
    return json.loads(as_reference(json.dumps(recs, sort_keys=True)))


@pytest.mark.parametrize("ctx", sorted(CONTEXT))
@pytest.mark.parametrize("doc", sorted(DOCS))
def test_advise_matches_reference(doc, ctx):
    d, kw = DOCS[doc], CONTEXT[ctx]
    got, want = p_adv.advise(d, **kw), r_adv.advise(d, **kw)
    assert _normal(got) == want
    assert as_reference(p_adv.render(got)) == r_adv.render(want)


@pytest.mark.parametrize("doc", sorted(DOCS))
def test_collectors_match_reference(doc):
    d = DOCS[doc]
    for name in ("collect_provenance", "collect_gap_shares", "collect_skipped_legs",
                 "collect_backend_loads", "collect_fleet", "collect_plan_skew",
                 "_latency_tails"):
        assert getattr(p_adv, name)(d) == getattr(r_adv, name)(d), name


def test_rules_thresholds_and_shared_predicates():
    assert [rid for rid, _ in p_adv.RULES] == [rid for rid, _ in r_adv.RULES]
    for name in ("GAP_SHARE_THRESHOLD", "CAUSE_SHARE_THRESHOLD",
                 "ELLE_FALLBACK_SHARE_THRESHOLD", "INGEST_UNMAPPED_SHARE_THRESHOLD",
                 "REBALANCE_MIN_LOAD", "REBALANCE_SKEW_RATIO", "UNDERUTILIZED_BACKEND_PCT",
                 "PLAN_SKEW_RATIO", "SLO_FAST_BURN_THRESHOLD", "SLO_SLOW_BURN_THRESHOLD",
                 "TAIL_RATIO_THRESHOLD"):
        assert getattr(p_adv, name) == getattr(r_adv, name), name
    from jepsen_tpu_torch.telemetry import alerts as p_alerts

    # one definition of "when": the advisor's thresholds are the alerting
    # plane's own objects
    assert p_adv.SLO_FAST_BURN_THRESHOLD is p_alerts.SLO_FAST_BURN_THRESHOLD
    assert p_adv.slo_hot_windows is p_alerts.slo_hot_windows
    fired = {r["id"] for d in DOCS.values() for c in CONTEXT.values()
             for r in p_adv.advise(d, **c)}
    assert fired == {rid for rid, _ in p_adv.RULES}  # every rule fired somewhere
    # the rules worded for the port
    recs = {r["id"]: r for r in p_adv.advise(DOCS["everything"])}
    assert "_build" in recs["prewarm_compiles"]["advice"]
    assert "XLA" not in recs["prewarm_compiles"]["advice"]
    assert "GPU" in recs["device_baseline_missing"]["advice"]


def _rounds():
    paths = sorted(glob.glob(os.path.join(ROOT, "BENCH_r*.json")), key=r_bc.round_sort_key)
    assert paths
    thru_r13 = [p for p in paths
                if r_bc.round_sort_key(p) <= r_bc.round_sort_key("BENCH_r13.json")]
    return {"all": paths, "thru_r13": thru_r13, "newest": paths[-1:]}


@pytest.mark.parametrize("json_mode", [False, True])
@pytest.mark.parametrize("which", ["all", "thru_r13", "newest"])
def test_main_over_committed_rounds_matches_reference(which, json_mode, tmp_path, capsys,
                                                      monkeypatch):
    monkeypatch.setenv("JEPSEN_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    argv = list(_rounds()[which]) + (["--json"] if json_mode else [])
    outs = []
    for mod in (r_adv, p_adv):
        code = mod.main(list(argv))
        cap = capsys.readouterr()
        outs.append((code, as_reference(cap.out) if mod is p_adv else cap.out, cap.err))
    assert outs[1] == outs[0]
    assert outs[1][0] == 0
    if which == "thru_r13" and not json_mode:
        ids = {ln.split("(id: ")[1].rstrip(")") for ln in outs[1][1].splitlines()
               if "(id: " in ln}
        assert len(ids) >= 3, ids


def test_main_defaults_and_refusals(tmp_path, capsys, monkeypatch):
    """With no arguments both read the repo's committed rounds; a missing
    or unreadable artifact exits 2."""
    monkeypatch.setenv("JEPSEN_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    outs = []
    for mod in (r_adv, p_adv):
        outs.append((mod.main([]), capsys.readouterr().out))
    assert outs[1][0] == outs[0][0] == 0
    assert as_reference(outs[1][1]) == outs[0][1]
    bad = tmp_path / "BENCH_r97.json"
    bad.write_text("{not json")
    for mod in (r_adv, p_adv):
        assert mod.main([str(tmp_path / "missing.json")]) == 2
        assert mod.main([str(bad)]) == 2
    capsys.readouterr()
    art = tmp_path / "BENCH_r98.json"
    art.write_text(json.dumps({"provenance": {"causes": {"overflow_top_rung": 10}},
                               "mutex_5k": {"skipped": "device_slow_guard"}}))
    ledger = tmp_path / "l.jsonl"
    ledger.write_text(json.dumps({"kind": "service", "workload": "service_stream",
                                  "engine": "device", "ts": 1, "dominant_cause": "max_configs"})
                      + "\n")
    outs = []
    for mod in (r_adv, p_adv):
        outs.append((mod.main([str(art), "--ledger", str(ledger)]), capsys.readouterr().out))
    assert outs[1][0] == 0 and as_reference(outs[1][1]) == outs[0][1]
    assert "extend_f_schedule" in outs[1][1]
