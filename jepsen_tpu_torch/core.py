"""Test lifecycle orchestration.

The port of the reference's ``jepsen_tpu/core.py``, which mirrors
jepsen.core (jepsen/src/jepsen/core.clj): bring up OS + DB on every
node, open clients and the nemesis, drive the generator through the threaded
interpreter to produce a history, run the checker, persist everything.

    run(test)                               core.clj:254-361
    ├ defaults: concurrency, start-time     core.clj:309-324
    ├ store.start_logging                   core.clj:325
    ├ control.with_remote sessions/node     core.clj:328-338
    ├ os.setup on nodes                     core.clj:340,93-100
    ├ db.cycle (teardown→setup, retries)    core.clj:341,170-179
    ├ with_relative_time                    core.clj:342
    ├ run_case: nemesis.setup ∥ client
    │   open+setup per node; interpreter    core.clj:181-220
    ├ store.save_1 (history durable)        core.clj:354
    ├ analyze: index, check_safe, save_2    core.clj:222-237
    └ log_results                           core.clj:239-252
    finally: client/nemesis teardown, DB teardown (unless
    leave-db-running?), OS teardown, session close

The *test map* is the configuration system (core.clj:255-277): plain keys,
defaults merged from workloads.noop_test. Key names keep the reference's
spelling minus the colon ("concurrency", "time-limit", "leave-db-running?").

The card: the test map's checkers carry their own device (a
``linearizable`` checker built without ``device="cpu"`` searches on the
GPU, and its construction raises where there is none), and the online
monitor takes ``test["device"]``. A checker that raises (a device it
cannot reach, a failed kernel build) leaves ``{"valid": "unknown",
"error": ...}`` in the results, as the reference's ``check_safe`` does,
never a verdict decided on the host; a deterministic device error of the
monitor's oracle is raised out of the run.

Observability: with ``online?`` the monitor's ``live_snapshot`` is a
``/live`` line of :mod:`.web` while the run executes, and ``live-port``
serves the results pages in-process for the run's duration (0 takes a
free port). ``profile?`` wraps the run from ``db.cycle`` to the analysis
in a ``torch.profiler`` trace written to ``profile_trace/`` in the run's
store directory, and writes ``profile.json`` (the roofline attribution,
the busy timelines, the memory watermarks) beside ``metrics.jsonl``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, Optional

from . import client as jclient
from . import db as jdb
from . import nemesis as jnemesis
from . import os_ as jos
from . import store
from . import telemetry as jtelemetry
from .checker import check_safe
from .generator import interpreter
from .history import History, Op
from .util import real_pmap, with_relative_time

LOG = logging.getLogger("jepsen.core")

def synchronize(test: dict, timeout_s: Optional[float] = None) -> None:
    """Block until all nodes reach this barrier (core.clj:44-57). The
    barrier is a threading.Barrier of #nodes parties, stored on the test."""
    b = test.get("barrier")
    if isinstance(b, threading.Barrier):
        b.wait(timeout=timeout_s)


def primary(test: dict) -> Any:
    """The node considered primary for setup purposes (core.clj:65-68)."""
    return test["nodes"][0]


def _with_sessions(test: dict):
    """Open a control session per node (core.clj:330-338); returns the
    sessions map (may be empty when no remote is configured — the
    in-process fake-cluster path)."""
    remote = test.get("remote")
    if remote is None and not test.get("ssh"):
        return None  # in-process fake cluster: no control plane at all
    from . import control

    return control.setup_sessions(test, remote)


def run_case(test: dict) -> list[dict]:
    """Spawn nemesis + clients, run the generator, return the history
    (core.clj:181-220)."""
    client = test.get("client") or jclient.noop()
    nemesis = jnemesis.validate(test.get("nemesis") or jnemesis.noop())

    # Nemesis setup runs concurrently with per-node client open+setup
    # (core.clj:187-196).
    nemesis_box: list = [None]

    def setup_nemesis():
        nemesis_box[0] = nemesis.setup(test)

    nt = threading.Thread(target=setup_nemesis, name="jepsen nemesis setup")
    nt.start()

    def open_setup(node):
        c = jclient.validate(client).open(test, node)
        c.setup(test)
        return c

    clients = real_pmap(open_setup, test.get("nodes") or [])
    nt.join()
    if nemesis_box[0] is None:
        raise RuntimeError("nemesis setup failed")

    test_for_run = dict(test)
    test_for_run["nemesis"] = nemesis_box[0]
    try:
        return interpreter.run(test_for_run)
    finally:
        def teardown_nemesis():
            nemesis_box[0].teardown(test)

        nt2 = threading.Thread(target=teardown_nemesis,
                               name="jepsen nemesis teardown")
        nt2.start()

        def teardown_close(cn):
            c, node = cn
            try:
                c.teardown(test)
            finally:
                c.close(test)

        real_pmap(teardown_close, list(zip(clients, test.get("nodes") or [])))
        nt2.join()


def analyze(test: dict) -> dict:
    """Index the history, run the checker, persist results
    (core.clj:222-237)."""
    LOG.info("Analyzing...")
    h = test.get("history")
    if not isinstance(h, History):
        h = History(
            [Op.from_dict(o) if isinstance(o, dict) else o for o in h or []],
            reindex=True,
        )
    else:
        h = h.reindex()
    test = dict(test)
    test["history"] = h
    reg = jtelemetry.of_test(test)
    checker = test.get("checker")
    # A test map loaded from the store (the CLI's analyze) carries the
    # stored run's flight recorder as the text test.edn holds; the
    # reference hands that string to timed_phase and the analysis dies.
    frec = test.get("flight-recorder")
    if not isinstance(frec, jtelemetry.FlightRecorder):
        frec = None
    with jtelemetry.timed_phase(reg, "analyze", recorder=frec):
        if checker is not None:
            test["results"] = check_safe(checker, test, h)
        else:
            test["results"] = {"valid": True}
    LOG.info("Analysis complete")
    if test.get("name") and test.get("start-time") and not test.get("no-store?"):
        store.save_2(test)
        if reg is not None:
            # Standalone `analyze` runs (no core.run around them) still
            # get their metrics persisted; core.run re-exports a more
            # complete snapshot at the end (atomic replace, last wins).
            jtelemetry.store_metrics(test)
            if test.get("profile?"):
                try:
                    jtelemetry.store_profile(test)
                except Exception:  # diagnostics never sink the run
                    LOG.warning("profile export failed", exc_info=True)
    return test


def log_results(test: dict) -> dict:
    """core.clj:239-252."""
    results = test.get("results") or {}
    valid = results.get("valid")
    tail = {
        False: "Analysis invalid! (ﾉಥ益ಥ）ﾉ ┻━┻",
        "unknown": "Errors occurred during analysis, but no anomalies found. ಠ~ಠ",
        True: "Everything looks good! ヽ(‘ー`)ノ",
    }.get(valid, f"Unknown validity: {valid!r}")
    LOG.info("%r\n\n%s", results, tail)
    return test


def snarf_logs(test: dict) -> None:
    """Download every node's DB log files into
    store/<name>/<time>/<node>/ (core.clj:102-136) — BEFORE DB teardown,
    which may destroy them (e.g. the tcpdump capture dir)."""
    db = test.get("db")
    if not isinstance(db, jdb.LogFiles):
        return
    if not (test.get("name") and test.get("start-time")) or test.get(
        "no-store?"
    ):
        return
    sessions = test.get("sessions")
    if not sessions:
        return
    from . import control

    def snarf(t, node):
        files = list(db.log_files(t, node) or [])
        if not files:
            return 0
        dest = store.path_mk(t, str(node), "x").parent
        dest.mkdir(parents=True, exist_ok=True)
        got = 0
        for f in files:
            try:
                control.download(f, dest / str(f).rsplit("/", 1)[-1])
                got += 1
            except Exception:
                LOG.warning("could not snarf %s from %s", f, node,
                            exc_info=True)
        return got

    try:
        control.on_nodes(test, snarf)
    except Exception:
        LOG.warning("log snarfing failed", exc_info=True)


def prepare_test(test: dict) -> dict:
    """Fill computed defaults (core.clj:309-324)."""
    test = dict(test)
    nodes = test.get("nodes") or []
    test.setdefault("concurrency", max(len(nodes), 1))
    test.setdefault("start-time", store.time_str())
    test["barrier"] = (
        threading.Barrier(len(nodes)) if nodes else threading.Barrier(1)
    )
    return test


def run(test: dict) -> dict:
    """Run a complete test; returns the test map with :history and
    :results. See module docstring for the phase diagram."""
    test = prepare_test(test)
    persist = bool(test.get("name")) and not test.get("no-store?")
    reg = jtelemetry.of_test(test)
    frec = None
    if reg is not None:
        # Flight recorder rides every telemetry run: phases mirror
        # run_phase_seconds, and a crash flushes flightrecord.json into
        # the store naming the phase that died (FDR semantics — cheap
        # to feed, only written when something goes wrong).
        frec = test["flight-recorder"] = jtelemetry.FlightRecorder()
    if reg is not None and persist and test.get("client") is not None:
        # Telemetry runs get the tracing client for free: every client
        # lifecycle call records a span (trace.clj's with-trace), and
        # spans.jsonl lands in the store next to metrics.jsonl below.
        from . import trace as jtrace

        collector = jtrace.Collector()
        test["trace-collector"] = collector
        test["client"] = jtrace.tracing(test["client"], collector)
    if persist:
        # Store setup BEFORE the monitor/live-source/server blocks: a
        # raising path_mk (unwritable store root) aborts the run before
        # anything is registered process-globally; the finally below
        # only covers failures past this point, so nothing started here
        # may outlive an exception it can't see.
        store.path_mk(test)
        store.start_logging(test)
    monitor = None
    live_key = None
    live_srv = None
    try:
        # The online/live setup sits INSIDE the try: a raising of_test
        # (bad engine opt, no card) after start_logging above must still
        # reach the finally, which stops the run's log handler and tears
        # down whatever of the monitor / live source / server did come
        # up (all its guards are None-safe).
        if test.get("online?"):
            # Online linearizability monitor (--online): tee ops from
            # the interpreter as they land, decide closed segments on a
            # worker thread while the workload runs, optionally abort
            # on the first violation. Built AFTER the collector/flight
            # recorder above so decision-latency spans and stall phases
            # land in the same spans.jsonl / flightrecord.json the run
            # already writes. With --online absent no monitor is built
            # (no thread, no metrics).
            from . import online as jonline

            monitor = jonline.of_test(test)
            if monitor is not None:
                test["online-monitor"] = monitor
                test["op-observer"] = monitor.observe
                test["stop-event"] = monitor.stop_event
        if monitor is not None:
            # Live operational view: the monitor's snapshot is one /live
            # line for the lifetime of the run (in-process servers only;
            # `serve` in another process reads the stored artifacts).
            from . import web as jweb

            live_key = f"{test.get('name') or 'run'}/{test['start-time']}"
            jweb.register_live_source(live_key, monitor.live_snapshot)
        if test.get("live-port") is not None:  # 0 = ephemeral port
            # live-port: an in-process results server for the run's
            # duration, so /live (and /metrics etc.) are reachable while
            # the workload executes. Best-effort: a taken port logs and
            # moves on; a dashboard must never sink the run.
            from . import web as jweb

            try:
                live_srv = jweb.server(root=test.get("store-root"),
                                       port=int(test["live-port"]))
                threading.Thread(target=live_srv.serve_forever,
                                 name="jepsen-live-web",
                                 daemon=True).start()
                LOG.info("Live dashboard on http://0.0.0.0:%d/live.html",
                         live_srv.server_address[1])
            except Exception:  # noqa: BLE001
                LOG.warning("could not start live web server",
                            exc_info=True)
                live_srv = None
        LOG.info("Running test: %s/%s", test.get("name"), test["start-time"])
        sessions = _with_sessions(test)
        osys: jos.OS = test.get("os") or jos.noop()
        nodes = test.get("nodes") or []
        # profile?: a torch.profiler trace of the run from db.cycle to
        # the analysis, into the store directory's profile_trace/.
        prof_cm = (
            jtelemetry.trace_capture(store.path_mk(test, "profile_trace"))
            if persist and test.get("profile?") else contextlib.nullcontext())
        try:
            jdb._on_nodes(test, osys.setup, nodes)
            try:
                with prof_cm:
                    with jtelemetry.timed_phase(reg, "db.cycle",
                                                recorder=frec):
                        jdb.cycle(test)
                    with with_relative_time():
                        with jtelemetry.timed_phase(reg, "run_case",
                                                    recorder=frec):
                            history = run_case(test)
                    test["history"] = history
                    if persist:
                        store.save_1(test)
                    if monitor is not None:
                        with jtelemetry.timed_phase(reg, "online.finish",
                                                    recorder=frec):
                            test["online-results"] = monitor.finish()
                        LOG.info("Online monitor: valid=%r decided "
                                 "through index %s%s",
                                 test["online-results"].get("valid"),
                                 test["online-results"].get(
                                     "decided_through_index"),
                                 " (run aborted on violation)"
                                 if test["online-results"].get("aborted")
                                 else "")
                        if persist:
                            jonline.store_online(test,
                                                 test["online-results"])
                    test = analyze(test)
                return log_results(test)
            finally:
                snarf_logs(test)
                if not test.get("leave-db-running?"):
                    try:
                        jdb.teardown_all(test)
                    except Exception:
                        LOG.warning("DB teardown failed", exc_info=True)
        finally:
            try:
                jdb._on_nodes(test, osys.teardown, nodes)
            except Exception:
                LOG.warning("OS teardown failed", exc_info=True)
            if sessions is not None:
                from . import control

                control.close_sessions(sessions)
    except BaseException:
        # The run died: flush the flight record into the store — the
        # post-mortem names the lifecycle phase that was open (FDR
        # semantics; the write itself never raises).
        if frec is not None and persist:
            jtelemetry.store_flight_record(test, frec, reason="exception",
                                           registry=reg)
        raise
    finally:
        if live_key is not None:
            from . import web as jweb

            jweb.unregister_live_source(live_key)
        if live_srv is not None:
            try:
                live_srv.shutdown()
                live_srv.server_close()
            except Exception:  # noqa: BLE001
                pass
        if monitor is not None and test.get("online-results") is None:
            # The run died before the success-path finish: shut the
            # scheduler worker down (bounded drain) so a failed run
            # leaks no thread, and keep whatever partial verdict the
            # stream reached next to the flight record.
            try:
                test["online-results"] = monitor.finish(timeout=15.0)
                if persist:
                    jonline.store_online(test, test["online-results"])
            except Exception:
                LOG.warning("online monitor shutdown failed",
                            exc_info=True)
        if persist and reg is not None:
            # Sinks go out even when a phase above threw: spans.jsonl +
            # metrics.jsonl/.prom next to the (phase-1-durable) history.
            try:
                from . import trace as jtrace

                if test.get("trace-collector") is not None:
                    jtrace.store_spans(test, test["trace-collector"])
                jtelemetry.store_metrics(test)
                if test.get("profile?"):
                    # profile.json: roofline attribution, busy timelines
                    # and memory watermarks, rendered by /profile and
                    # /utilization.
                    jtelemetry.store_profile(test)
            except Exception:
                LOG.warning("telemetry export failed", exc_info=True)
        if persist:
            # Cross-run perf ledger: one compact record per run (even a
            # crashed one — verdict None is itself a data point) into
            # <store root>/ledger.jsonl; `python -m jepsen_tpu_torch.ledger`
            # renders the trend and gates regressions between runs.
            try:
                from .telemetry import ledger as jledger

                jledger.append(
                    jledger.record_of_run(test),
                    path=jledger.default_path(test.get("store-root")))
            except Exception:  # noqa: BLE001 - the ledger never sinks
                LOG.warning("ledger append failed", exc_info=True)
            store.stop_logging(test)
