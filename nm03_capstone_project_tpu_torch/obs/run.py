"""RunContext: the one object a process wires observability through.

The port's copy of the JAX package's ``obs/run.py`` for the server: the
metrics registry, the span recorder and the structured event log of one
run, the ``run_started`` / ``run_finished`` envelope, an optional
periodic heartbeat, and the resilience records (``retry``, ``degraded``).
The drivers' per-patient outcome records come with their observability
flags, in a later slice.

Library callers get a sink-less context by default: metrics still
accumulate in memory, events are kept in the in-memory tail, nothing
touches disk.
"""

from __future__ import annotations

import threading
from typing import Optional

from nm03_capstone_project_tpu_torch.obs.events import EventLog, Heartbeat, LogBridge
from nm03_capstone_project_tpu_torch.obs.metrics import (
    PIPELINE_DEGRADED_TOTAL,
    RESILIENCE_RETRIES_TOTAL,
    MetricsRegistry,
)
from nm03_capstone_project_tpu_torch.obs.spans import SpanRecorder


class RunContext:
    """Shared observability state for one run."""

    def __init__(
        self,
        driver: str,
        registry: MetricsRegistry,
        events: EventLog,
        spans: SpanRecorder,
        metrics_out=None,
        heartbeat: Optional[Heartbeat] = None,
        log_bridge: Optional[LogBridge] = None,
    ):
        self.driver = driver
        self.registry = registry
        self.events = events
        self.spans = spans
        self.metrics_out = metrics_out
        self._heartbeat = heartbeat
        self._log_bridge = log_bridge
        self._lock = threading.RLock()  # signal-handler reentrancy
        self._closed = False

    @classmethod
    def create(
        cls,
        driver: str,
        metrics_out=None,
        log_json=None,
        heartbeat_s: float = 0.0,
        run_id: Optional[str] = None,
        argv=None,
        stream=None,
    ) -> "RunContext":
        """Build + start a context; emits ``run_started``.

        ``metrics_out``/``log_json`` are paths (or None); ``stream`` is an
        alternative writable for the event log (tests). A positive
        ``heartbeat_s`` starts the heartbeat thread only when the event log
        has a sink — a sink-less heartbeat would be pure overhead.
        """
        events = EventLog(path=log_json, stream=stream, run_id=run_id)
        registry = MetricsRegistry()
        spans = SpanRecorder(registry=registry)
        heartbeat = None
        if heartbeat_s and heartbeat_s > 0 and events.enabled:
            heartbeat = Heartbeat(events, heartbeat_s, registry=registry).start()
        log_bridge = None
        if events.enabled:
            # mirror the package logger's WARNING+ into the event stream
            import logging

            from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

            log_bridge = LogBridge(events, level=logging.WARNING)
            get_logger().addHandler(log_bridge)
        ctx = cls(
            driver,
            registry,
            events,
            spans,
            metrics_out=metrics_out,
            heartbeat=heartbeat,
            log_bridge=log_bridge,
        )
        started = {"driver": driver}
        if argv is not None:
            started["argv"] = list(argv)
        events.emit("run_started", **started)
        return ctx

    # -- resilience telemetry ----------------------------------------------

    def retry(self, cause: str, attempt: int = 1, **fields) -> dict:
        """One supervised retry: counter (per-cause label) + INFO event."""
        self.registry.counter(
            RESILIENCE_RETRIES_TOTAL,
            help="supervised retries by cause (resilience.RetryPolicy)",
            cause=str(cause),
        ).inc()
        return self.events.emit(
            "retry", cause=str(cause), attempt=int(attempt), **fields
        )

    def degraded(self, cause: str, **fields) -> dict:
        """The device path is gone (every serving lane quarantined): WARNING
        event + ``pipeline_degraded_total`` counter, once per transition.
        The port has no CPU fallback: from here on requests fail fast."""
        self.registry.counter(
            PIPELINE_DEGRADED_TOTAL,
            help="degradation transitions (dispatch deadline expiry or "
            "device lost; requests fail fast from then on)",
            cause=str(cause),
        ).inc()
        return self.events.emit(
            "degraded", level="WARNING", cause=str(cause), **fields
        )

    # -- export / teardown -------------------------------------------------

    def metrics_snapshot(self) -> dict:
        return self.registry.snapshot(
            run_id=self.events.run_id, git_sha=self.events.git_sha
        )

    def write_metrics(self, path=None) -> None:
        path = path or self.metrics_out
        if path:
            self.registry.write_snapshot(
                path, run_id=self.events.run_id, git_sha=self.events.git_sha
            )

    def close(self, status: str = "ok", **fields) -> None:
        """Stop the heartbeat, write the metrics snapshot, emit the final
        ``run_finished`` record (always the stream's last), close the log.
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._heartbeat is not None:
            self._heartbeat.stop()
        if self._log_bridge is not None:
            from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

            get_logger().removeHandler(self._log_bridge)
        try:
            self.write_metrics()
        except Exception as e:  # noqa: BLE001 — telemetry never costs the run
            import sys

            print(
                f"warning: metrics snapshot write failed: {e}", file=sys.stderr
            )
        finally:
            self.events.emit("run_finished", status=status, **fields)
            self.events.close()

    def __enter__(self) -> "RunContext":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(status="error" if exc_type else "ok")
