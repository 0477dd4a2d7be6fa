"""Observability: metrics, spans, structured events, traces, flight recorder.

The port's copies of the JAX package's ``obs/`` modules that the server
runs on:

* :mod:`~nm03_capstone_project_tpu_torch.obs.metrics` — a thread-safe
  registry of counters, gauges and bucketed histograms, snapshot-able to
  JSON (``nm03.metrics.v1``) and to the Prometheus text format;
* :mod:`~nm03_capstone_project_tpu_torch.obs.spans` — nested named
  sections with per-stage latency histograms;
* :mod:`~nm03_capstone_project_tpu_torch.obs.events` — the JSON-lines
  event log (``nm03.events.v1``), heartbeat and log bridge;
* :mod:`~nm03_capstone_project_tpu_torch.obs.run` — :class:`RunContext`;
* :mod:`~nm03_capstone_project_tpu_torch.obs.trace` — request-scoped
  serving traces and the ``nm03-trace`` Perfetto exporter;
* :mod:`~nm03_capstone_project_tpu_torch.obs.flightrec` — the crash
  flight recorder;
* :mod:`~nm03_capstone_project_tpu_torch.obs.saturation`,
  :mod:`~nm03_capstone_project_tpu_torch.obs.ledger` and
  :mod:`~nm03_capstone_project_tpu_torch.obs.slo` — the saturation
  monitor (and the drivers' feed accounting), the device-time ledger and
  the SLO plane.

Stdlib only at import, apart from the spans' ``torch.profiler`` marks.
"""

from nm03_capstone_project_tpu_torch.obs import flightrec  # noqa: F401
from nm03_capstone_project_tpu_torch.obs.events import EventLog  # noqa: F401
from nm03_capstone_project_tpu_torch.obs.metrics import MetricsRegistry  # noqa: F401
from nm03_capstone_project_tpu_torch.obs.run import RunContext  # noqa: F401
from nm03_capstone_project_tpu_torch.obs.spans import SpanRecorder  # noqa: F401
from nm03_capstone_project_tpu_torch.obs.trace import (  # noqa: F401
    NULL_TRACE,
    SERVE_TRACE_EVENT,
    ChunkTrace,
    TraceContext,
)
