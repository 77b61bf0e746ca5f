"""``python -m jepsen_tpu_torch.service`` — run the multi-tenant checking
service. The port of the reference's ``jepsen_tpu/service/__main__.py``.

Four modes:

- **Daemon** (default): start the ndjson-over-HTTP ingestion server and
  run until interrupted; Ctrl-C drains gracefully and prints the
  per-tenant results document. ``--live-port`` additionally serves the
  results browser in-process so ``/live.html`` shows the per-tenant
  rows while the service runs. ``--journal-dir`` makes verdicts
  crash-safe: every decided segment is journaled, and a restarted
  daemon pointed at the same directory replays it — reconnecting
  tenants resume from their journaled watermark (reported under
  ``resumed_from_journal`` on ``GET /tenants``) instead of
  resubmitting history.
- **Simulation** (``--simulate N``): drive N synthetic tenant streams
  through the in-process ``Service.submit`` seam (the same seam the
  tests and bench use), drain, and print per-tenant results. Exit code
  follows the CLI convention: 0 all valid, 1 any invalid, 2 any
  unknown; 254 for invalid arguments and 255 when a deterministic
  device error left the service without a verdict.
- **Router** (``--router``): the scale-out front-end. It spawns
  ``--router-backends`` backend service processes (each with its own
  port and ``<journal-dir>/backend-i``) or attaches to ``--backend-urls``,
  places tenants on them, health-checks them, live-migrates tenants
  through their verdict journals, respawns a dead child and re-adopts
  toward it. Ctrl-C drains every backend and prints the merged results
  (exit 0/1/2 as above). The router itself never touches the card: each
  spawned backend gets this command's ``--device``.
- **Rolling restart** (``--roll ROUTER_URL``): ask a running router to
  drain, respawn and re-adopt one backend at a time, and print its
  report: exit 0 when every backend rolled, 1 for a partial roll, 2
  when the router is unreachable.

The device engines run on the card unless ``--device cpu`` is given;
without a card and without ``--device cpu`` the service does not start
(exit 255), and neither does a router whose backends do not.

    python -m jepsen_tpu_torch.service --port 8089 --model cas-register \\
        --max-tenants 16 --quota-ops 2000 --backpressure reject
    python -m jepsen_tpu_torch.service --simulate 4 --sim-ops 2000 \\
        --abort-on-violation
    python -m jepsen_tpu_torch.service --router --router-backends 2 \\
        --journal-dir /var/lib/jepsen/fleet --port 8088
    python -m jepsen_tpu_torch.service --roll http://127.0.0.1:8088
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import sys
import threading
from typing import Optional

from ..models import known_models, model_by_name
from ..telemetry import Registry
from . import Service, ServiceConfig
from . import http as shttp
from .client import InProcessServiceClient

LOG = logging.getLogger("jepsen.service")

EXIT_BAD_ARGS = 254
EXIT_ERROR = 255


def build_service(ns: argparse.Namespace,
                  metrics: Optional[Registry] = None) -> Service:
    model_args = json.loads(ns.model_args) if ns.model_args else {}
    if ns.model in ("register", "cas-register"):
        model_args.setdefault("init", 0)
    model = model_by_name(ns.model, **model_args)
    cfg = ServiceConfig(
        engine=ns.engine,
        max_tenants=ns.max_tenants,
        quota_ops_per_s=ns.quota_ops,
        queue_limit=ns.queue_limit,
        backpressure=ns.backpressure,
        block_timeout_s=ns.block_timeout,
        abort_on_violation=ns.abort_on_violation,
        max_configs=ns.max_configs,
        store_root=ns.store_root,
        journal_dir=ns.journal_dir,
        journal_fsync=ns.journal_fsync,
        alerts=ns.alerts,
        alerts_path=ns.alerts_path,
        alerts_sink=ns.alerts_sink,
        device=ns.device,
    )
    # Every daemon carries a span collector: the fleet's cross-process
    # traces are observed by scraping each backend's GET /trace — a
    # backend without a collector would be a hole in every trace that
    # crosses it.
    from .. import trace as _trace

    return Service(model, cfg, metrics=metrics,
                   collector=_trace.Collector(), name=ns.name)


def simulate(service: Service, n_tenants: int, n_ops: int,
             seed: int = 0, invalid_tenants: int = 0) -> dict:
    """Drive N synthetic tenant streams concurrently through the
    in-process submit seam (one thread per tenant — the simulated
    generator), then drain. ``invalid_tenants`` streams are seeded
    with a violation (demonstrating per-tenant abort isolation when
    abort_on_violation is armed)."""
    from ..testing import chunked_register_history, perturb_history

    def run_one(i: int):
        rng = random.Random(seed + i)
        h = chunked_register_history(rng, n_ops=n_ops, n_procs=4,
                                     chunk_ops=60)
        if i < invalid_tenants:
            h = perturb_history(random.Random(seed + 1000 + i), h,
                                within=0.5)
        name = f"tenant-{i}"
        # The resume-aware client replaces the old ad-hoc loop: typed
        # 429s are retried with the server's own Retry-After estimate,
        # terminal rejections (aborted tenant) stop the feed cleanly.
        rep = InProcessServiceClient(service, name).feed(h)
        if rep["error"]:
            LOG.info("tenant %s: stopped at op %d (%s)", name,
                     rep["sent"], rep["error"])

    threads = [threading.Thread(target=run_one, args=(i,))
               for i in range(n_tenants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return service.drain()


def _run_roll(router_url: str) -> int:
    """``--roll ROUTER_URL``: ask a running router for a rolling
    restart and report the per-backend outcome."""
    from urllib import error as _uerror
    from urllib import request as _urequest

    req = _urequest.Request(router_url.rstrip("/") + "/roll",
                            data=b"", method="POST")
    try:
        with _urequest.urlopen(req, timeout=600) as r:
            doc = json.loads(r.read().decode() or "{}")
    except _uerror.HTTPError as e:
        # A partial roll answers 409 WITH the structured per-backend
        # report (which backend failed to drain, which rolled) — the
        # operator needs that body, not just the status line.
        try:
            doc = json.loads(e.read().decode() or "{}")
        except ValueError:
            doc = {"ok": False, "error": f"http_{e.code}"}
    except Exception as e:  # noqa: BLE001 - router down / refused
        print(f"roll failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    print(json.dumps(doc, indent=1, sort_keys=True, default=str))
    return 0 if doc.get("ok") else 1


def _run_router(ns: argparse.Namespace, metrics: Registry) -> int:
    """``--router``: front a fleet of backend service processes."""
    from . import router as jrouter

    if ns.backend_urls:
        backends = []
        for i, spec in enumerate(ns.backend_urls.split(",")):
            url, _, jdir = spec.strip().partition("=")
            backends.append(jrouter.Backend(
                f"backend-{i}", url, journal_dir=jdir or None,
                metrics=metrics,
                failure_threshold=ns.failure_threshold))
    else:
        if not ns.journal_dir:
            print("--router needs --journal-dir (per-backend journal "
                  "roots) or --backend-urls", file=sys.stderr)
            return EXIT_BAD_ARGS
        try:
            backends = jrouter.spawn_backends(
                ns.router_backends, journal_root=ns.journal_dir,
                model=ns.model, engine=ns.engine,
                max_configs=ns.max_configs, metrics=metrics,
                failure_threshold=ns.failure_threshold,
                extra_args=(("--abort-on-violation",)
                            if ns.abort_on_violation else ()),
                device=ns.device)
        except (RuntimeError, TimeoutError) as e:
            # A backend exited before it bound (no card and no
            # --device cpu: exit 255) or never became healthy.
            print(f"router did not start: {e}", file=sys.stderr)
            return EXIT_ERROR
    router = jrouter.Router(
        backends, metrics=metrics, name=ns.name,
        probe_interval_s=ns.probe_interval,
        failure_threshold=ns.failure_threshold,
        state_path=ns.state_path,
        respawn=not ns.no_respawn,
        alerts=ns.alerts,
        alerts_path=ns.alerts_path,
        alerts_sink=ns.alerts_sink)
    web_srv = None
    if ns.live_port is not None:
        from .. import web

        web_srv = web.server(root=ns.store_root, port=ns.live_port)
        threading.Thread(target=web_srv.serve_forever,
                         name="jepsen-live-web", daemon=True).start()
        print(f"live dashboard on http://0.0.0.0:"
              f"{web_srv.server_address[1]}/live.html")
    try:
        try:
            jrouter.serve(router, port=ns.port, port_file=ns.port_file)
            fin = router.drain()
        except KeyboardInterrupt:
            print("draining backends…", file=sys.stderr)
            fin = router.drain()
    finally:
        router.close()
        if web_srv is not None:
            web_srv.shutdown()
            web_srv.server_close()
    print(json.dumps(fin, indent=1, sort_keys=True, default=str))
    valid = fin.get("valid")
    if valid is False:
        return 1
    if valid is not True:
        return 2
    return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.service",
        description="Always-on multi-tenant checking service: ndjson "
                    "ingestion, per-tenant online verdicts, cross-"
                    "tenant device co-batching.")
    p.add_argument("--port", type=int, default=8089,
                   help="ingestion port (POST /submit/<tenant>); 0 "
                        "binds an ephemeral port (see --port-file)")
    p.add_argument("--port-file", default=None,
                   help="write the BOUND port here (atomically, "
                        "after bind) — the spawned-backend readiness "
                        "protocol the router's respawn supervisor "
                        "reads; a router writes its own port")
    p.add_argument("--model", choices=known_models(),
                   default="cas-register")
    p.add_argument("--model-args", default=None,
                   help='JSON kwargs for the model, e.g. \'{"init": 0}\'')
    p.add_argument("--engine", choices=["auto", "device", "host"],
                   default="auto")
    p.add_argument("--device", default=None,
                   help="torch device of the device engines (default: "
                        "the GPU; 'cpu' runs their plain versions)")
    p.add_argument("--name", default="service")
    p.add_argument("--max-tenants", type=int, default=64)
    p.add_argument("--quota-ops", type=float, default=None,
                   help="per-tenant ops/s admission quota "
                        "(default: unlimited)")
    p.add_argument("--queue-limit", type=int, default=4096,
                   help="bounded per-tenant ingest queue size")
    p.add_argument("--backpressure", choices=["reject", "block"],
                   default="reject",
                   help="full-queue policy: 429-style reject or "
                        "blocking submit")
    p.add_argument("--block-timeout", type=float, default=30.0)
    p.add_argument("--abort-on-violation", action="store_true",
                   help="abort (only) the violating tenant's stream at "
                        "its first invalid segment")
    p.add_argument("--max-configs", type=int, default=500_000)
    p.add_argument("--store-root", default=None)
    p.add_argument("--journal-dir", default=None,
                   help="crash-safe per-tenant verdict journal "
                        "directory; a restart replays it and "
                        "reconnecting tenants resume from their "
                        "journaled watermark (GET /tenants reports "
                        "resumed_from_journal)")
    p.add_argument("--journal-fsync", action="store_true",
                   help="fsync every journal record (kill-safe, "
                        "slower)")
    p.add_argument("--live-port", type=int, default=None,
                   help="also serve the results browser (incl. the "
                        "/live per-tenant dashboard) on this port")
    p.add_argument("--router", action="store_true",
                   help="run as the scale-out FRONT-END instead of a "
                        "backend: place tenants across N backend "
                        "service processes, health-check them, and "
                        "live-migrate tenants via their verdict "
                        "journals")
    p.add_argument("--router-backends", type=int, default=2,
                   metavar="N",
                   help="spawn N backend processes (each gets its own "
                        "port and <journal-dir>/backend-i; requires "
                        "--journal-dir)")
    p.add_argument("--backend-urls", default=None,
                   help="attach to EXISTING backends instead of "
                        "spawning: comma-separated url[=journal_dir] "
                        "pairs")
    p.add_argument("--probe-interval", type=float, default=1.0,
                   help="router health-probe period (seconds)")
    p.add_argument("--failure-threshold", type=int, default=3,
                   help="consecutive failed probes before a backend "
                        "is declared lost and its tenants migrate")
    p.add_argument("--state-path", default=None,
                   help="router crash safety: append placement / "
                        "orphan records / the placement epoch to this "
                        "jsonl; a restarted router replays it and "
                        "reconciles against live backend reality")
    p.add_argument("--no-respawn", action="store_true",
                   help="disable the respawn supervisor (equivalent "
                        "to JEPSEN_NO_RESPAWN=1): dead spawned "
                        "backends stay dead, the fleet runs on the "
                        "survivors")
    p.add_argument("--roll", metavar="ROUTER_URL", default=None,
                   help="POST /roll to a RUNNING router (rolling "
                        "restart: drain-migrate, respawn and re-adopt "
                        "one backend at a time) and print the "
                        "result; exits 0 when every backend rolled")
    p.add_argument("--alerts", action="store_true",
                   help="evaluate the built-in alert rule catalogue "
                        "on the pump's cadence and serve GET /alerts")
    p.add_argument("--alerts-path", default=None,
                   help="durable alerts.jsonl (implies --alerts); a "
                        "restart replays it to the same firing set. "
                        "Routers default to an alerts.jsonl next to "
                        "--state-path when alerting is on")
    p.add_argument("--alerts-sink", default=None,
                   help="fan alert transitions out to an http(s):// "
                        "webhook (JSON POST per transition, bounded "
                        "retry) or an ndjson file (implies --alerts)")
    p.add_argument("--simulate", type=int, default=None, metavar="N",
                   help="run N synthetic tenant streams through the "
                        "in-process seam instead of serving HTTP")
    p.add_argument("--sim-ops", type=int, default=1000)
    p.add_argument("--sim-invalid", type=int, default=0,
                   help="seed this many simulated tenants with a "
                        "violation")
    p.add_argument("--seed", type=int, default=0)
    try:
        ns = p.parse_args(argv)
    except SystemExit as e:
        return EXIT_BAD_ARGS if e.code not in (0, None) else 0

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s{%(threadName)s} %(levelname)s %(name)s - "
               "%(message)s")
    if ns.roll:
        return _run_roll(ns.roll)
    metrics = Registry()
    if ns.router:
        return _run_router(ns, metrics)
    try:
        service = build_service(ns, metrics=metrics)
    except RuntimeError as e:
        # No card and no --device cpu (devices.resolve_device).
        print(f"service did not start: {e}", file=sys.stderr)
        return EXIT_ERROR

    web_srv = None
    if ns.live_port is not None:
        from .. import web

        web_srv = web.server(root=ns.store_root, port=ns.live_port)
        threading.Thread(target=web_srv.serve_forever,
                         name="jepsen-live-web", daemon=True).start()
        print(f"live dashboard on http://0.0.0.0:"
              f"{web_srv.server_address[1]}/live.html")

    try:
        if ns.simulate is not None:
            fin = simulate(service, ns.simulate, ns.sim_ops,
                           seed=ns.seed,
                           invalid_tenants=ns.sim_invalid)
        else:
            try:
                shttp.serve(service, port=ns.port,
                            port_file=ns.port_file)
                fin = service.drain()  # serve_forever returned
            except KeyboardInterrupt:
                print("draining…", file=sys.stderr)
                fin = service.drain()
    except Exception as e:  # noqa: BLE001 - a deterministic device error
        # A round's deterministic device error (service.drain raises
        # it): the folded results stand, but no verdict is given.
        if service.finished is not None:
            print(json.dumps(service.finished, indent=1, sort_keys=True,
                             default=str))
        print(f"service failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return EXIT_ERROR
    finally:
        if web_srv is not None:
            web_srv.shutdown()
            web_srv.server_close()
    print(json.dumps(fin, indent=1, sort_keys=True, default=str))
    valid = fin.get("valid")
    if valid is False:
        return 1
    if valid is not True:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
