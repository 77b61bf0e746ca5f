"""The always-on multi-tenant checking service and its scale-out router.
The port of the reference's ``jepsen_tpu/service/``.

A resident :class:`Service` ingests many concurrent tenant streams
(ndjson over HTTP through :mod:`jepsen_tpu_torch.service.http`, or the
in-process ``Service.submit(tenant, op)`` seam), segments each with one
``online`` segmenter per tenant, and co-batches the ready segments of all
tenants onto the batched device search through one
:class:`~jepsen_tpu_torch.online.scheduler.SegmentScheduler` on
``device`` (the card unless the caller passes ``device="cpu"``). Tenants
are one more independence axis beside keys, so a batch fills from
whoever has work while each tenant keeps its own verdict, carries and
watermark.

Production controls: admission (``max_tenants``, a per-tenant ops/s
quota), bounded per-tenant ingest queues with blocking or 429-style
backpressure, per-tenant round fairness, per-tenant abort on a
violation, a crash-safe verdict journal per tenant, and a graceful
``drain`` returning per-tenant partial verdicts.

Scale-out: :mod:`jepsen_tpu_torch.service.router` places tenants across N
backend service processes, health-checks them, live-migrates tenants
through their journals and, with :mod:`jepsen_tpu_torch.service.supervisor`,
respawns a dead backend, persists its placement and fences stale routers
by epoch; its :class:`~jepsen_tpu_torch.telemetry.fleet.FleetFederation`
merges the backends' registries into one fleet view. CLI: ``python -m
jepsen_tpu_torch.service`` (``--router``, ``--roll``).
"""

from __future__ import annotations

from .journal import (  # noqa: F401
    JournalError,
    JournalModelMismatchError,
)
from .service import (  # noqa: F401
    AdmissionError,
    AdoptUnsupportedError,
    IngestQueueFullError,
    QuotaExceededError,
    Service,
    ServiceClosedError,
    ServiceConfig,
    ServiceError,
    StaleEpochError,
    TenantAbortedError,
    TenantAdoptConflictError,
    TenantLimitError,
    TenantMigratedError,
    TenantMigratingError,
    UnknownTenantError,
)

__all__ = [
    "AdmissionError",
    "AdoptUnsupportedError",
    "IngestQueueFullError",
    "JournalError",
    "JournalModelMismatchError",
    "QuotaExceededError",
    "Service",
    "ServiceClosedError",
    "ServiceConfig",
    "ServiceError",
    "StaleEpochError",
    "TenantAbortedError",
    "TenantAdoptConflictError",
    "TenantLimitError",
    "TenantMigratedError",
    "TenantMigratingError",
    "UnknownTenantError",
]
