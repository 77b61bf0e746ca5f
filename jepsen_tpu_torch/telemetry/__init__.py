"""Telemetry of the port's drivers: the metrics :class:`Registry` that
``metrics=`` takes (``ops.wgl.check_encoded_device``,
``parallel.frontier.check_encoded_sharded``,
``parallel.batch.check_encoded_batch``, the Elle engine and its front
doors). A trimmed copy of the reference's ``jepsen_tpu/telemetry``: the
registry only; the sinks, heartbeats and readers stay in the reference,
and its readers take a port run's registry unchanged."""

from .registry import Counter, Gauge, Registry  # noqa: F401
