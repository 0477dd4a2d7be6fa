"""RunContext: the one object a process wires observability through.

The port's copy of the JAX package's ``obs/run.py``: the metrics
registry, the span recorder and the structured event log of one run, the
``run_started`` / ``run_finished`` envelope, an optional periodic
heartbeat, the resilience records (``retry``, ``fault_injected``,
``degraded``) and the drivers' per-patient protocol:

* exactly ONE terminal ``patient_outcome`` event per patient (a second
  emission for the same patient raises);
* ``grow_truncated`` WARNING events + the ``pipeline_grow_truncated_total``
  counter for patients whose region growing hit its iteration cap;
* :meth:`RunContext.record_pipeline_paths`, the info gauge that says which
  median and render paths the run took.

The drivers build one from ``--metrics-out``, ``--log-json`` and
``--heartbeat-s`` (:func:`..cli.common.make_run_context`).

Library callers get a sink-less context by default: metrics still
accumulate in memory, events are kept in the in-memory tail, nothing
touches disk.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from nm03_capstone_project_tpu_torch.obs.events import EventLog, Heartbeat, LogBridge
from nm03_capstone_project_tpu_torch.obs.metrics import (
    GROW_TRUNCATED_TOTAL,
    MEDIAN_COMPARATOR_OPS,
    PATIENT_OUTCOMES_TOTAL,
    PIPELINE_DEGRADED_TOTAL,
    PIPELINE_PATH_INFO,
    RESILIENCE_FAULTS_INJECTED_TOTAL,
    RESILIENCE_RETRIES_TOTAL,
    SLICES_TOTAL,
    MetricsRegistry,
)
from nm03_capstone_project_tpu_torch.obs.spans import SpanRecorder

PATIENT_STATUSES = ("ok", "failed")


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
        self._outcomes: Dict[str, str] = {}
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

    # -- per-patient telemetry ---------------------------------------------

    def patient_outcome(
        self,
        patient_id: str,
        status: str,
        *,
        slices_total: int = 0,
        slices_ok: int = 0,
        slices_failed: int = 0,
        slices_truncated: int = 0,
        grow_truncated: Optional[bool] = None,
        error_class: Optional[str] = None,
        retries: int = 0,
        **fields,
    ) -> dict:
        """The ONE terminal record of a patient's run.

        Increments the outcome counters and emits the ``patient_outcome``
        event (WARNING when the patient failed or its mask was truncated,
        INFO otherwise). Raises on a second emission for the same patient:
        the schema's exactly-once contract is enforced at the source.
        """
        if status not in PATIENT_STATUSES:
            raise ValueError(f"status {status!r} not in {PATIENT_STATUSES}")
        pid = str(patient_id)
        with self._lock:
            if pid in self._outcomes:
                raise RuntimeError(
                    f"duplicate patient_outcome for {pid!r} "
                    f"(already {self._outcomes[pid]!r})"
                )
            self._outcomes[pid] = status
        if grow_truncated is None:
            grow_truncated = slices_truncated > 0
        self.registry.counter(
            PATIENT_OUTCOMES_TOTAL,
            help="terminal patient outcomes by status",
            status=status,
        ).inc()
        for n, slice_status in (
            (slices_ok, "done"),
            (slices_failed, "failed"),
            (slices_truncated, "truncated"),
        ):
            if n:
                self.registry.counter(
                    SLICES_TOTAL,
                    help="slices by terminal status (truncated slices are "
                    "also counted done: the pair exists)",
                    status=slice_status,
                ).inc(n)
        level = "WARNING" if (status != "ok" or grow_truncated) else "INFO"
        return self.events.emit(
            "patient_outcome",
            level=level,
            patient_id=pid,
            status=status,
            slices_total=int(slices_total),
            slices_ok=int(slices_ok),
            slices_failed=int(slices_failed),
            slices_truncated=int(slices_truncated),
            grow_truncated=bool(grow_truncated),
            error_class=error_class,
            retries=int(retries),
            **fields,
        )

    def has_outcome(self, patient_id: str) -> bool:
        """True when a terminal outcome was already recorded: a failure
        after the ok outcome must not trip the exactly-once guard from
        inside the containment path."""
        with self._lock:
            return str(patient_id) in self._outcomes

    def grow_truncated(self, patient_id: str, count: int = 1, **fields) -> dict:
        """A capped region-growing fixpoint: WARNING event + counter.

        ``count`` is the number of truncated work items: slices in the 2D
        drivers, 1 (the whole volume) in the volume driver.
        """
        self.registry.counter(
            GROW_TRUNCATED_TOTAL,
            help="region-growing fixpoints that hit the iteration cap "
            "(masks under-cover; raise --grow-max-iters)",
        ).inc(count)
        return self.events.emit(
            "grow_truncated",
            level="WARNING",
            patient_id=str(patient_id),
            count=int(count),
            **fields,
        )

    # the comparator_counts() keys that are op counts ("window" is the
    # kernel size and must not be published under an ops-gauge name)
    _COMPARATOR_COUNT_KEYS = (
        "merge_minmax_full",
        "merge_minmax_pruned",
        "merge_minmax_pruned_shared",
        "presort_minmax",
    )

    def record_pipeline_paths(
        self,
        median_impl: str,
        render_fused: bool,
        fuse_preprocess: bool,
        use_kernels: bool,
        comparators: Optional[dict] = None,
        **extra_labels: str,
    ) -> None:
        """The info gauge naming the median, preprocess and render paths
        the run took, plus the median's comparator counts.

        ``use_kernels`` must already be resolved against the device (the
        CPU runs the plain ops whatever the flag says). When the kernels
        run, the median is their shared pruned plan, whatever
        ``median_impl`` says, so the label names that plan. The labels
        keep the JAX package's names: ``preprocess="fused_kernel"`` where
        it says ``fused_pallas``, ``use_kernels`` where it says
        ``use_pallas``.
        """
        if use_kernels:
            median_impl = "kernel_shared_pruned"
        self.registry.gauge(
            PIPELINE_PATH_INFO,
            help="pipeline implementation choices for this run (value is "
            "always 1; the labels carry the information)",
            median_impl=str(median_impl),
            render="fused" if render_fused else "unfused",
            preprocess="fused_kernel" if (use_kernels and fuse_preprocess) else "ops",
            use_kernels=str(bool(use_kernels)).lower(),
            **{k: str(v) for k, v in extra_labels.items()},
        ).set(1)
        for key in self._COMPARATOR_COUNT_KEYS:
            if key in (comparators or {}):
                self.registry.gauge(
                    MEDIAN_COMPARATOR_OPS,
                    help="min/max ops per pixel of the median merge phase by "
                    "network variant (ops.selection_network)",
                    variant=key,
                ).set(float(comparators[key]))

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

    def fault_injected(self, site: str, kind: str, **fields) -> dict:
        """One fired fault-plan rule: counter (site/kind labels) + event."""
        self.registry.counter(
            RESILIENCE_FAULTS_INJECTED_TOTAL,
            help="faults fired by the seeded fault plan "
            "(resilience.FaultPlan; zero outside chaos runs)",
            site=str(site),
            kind=str(kind),
        ).inc()
        return self.events.emit(
            "fault_injected", site=str(site), kind=str(kind), **fields
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
