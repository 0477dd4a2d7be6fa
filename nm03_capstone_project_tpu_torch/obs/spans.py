"""Span API: nested, named sections with stage histograms.

The port's copy of the JAX package's ``obs/spans.py``. Each span

* accumulates its wall-clock seconds under its name (``sections``,
  ``report()``), re-entrant and thread-safe;
* shows on a ``torch.profiler`` timeline under its name
  (``torch.profiler.record_function``, the counterpart of the JAX
  package's ``jax.profiler.TraceAnnotation``; a no-op cost while no
  profiler runs);
* feeds a per-stage latency **histogram** in a
  :class:`~nm03_capstone_project_tpu_torch.obs.metrics.MetricsRegistry`
  under ``nm03_stage_latency_seconds{stage=...}``.

A span measures the host's clock: device work enqueued inside it is
charged to it only where the span waits for the result.

Stage-label cardinality stays bounded even for per-patient section names:
the histogram label is the FIRST ``/``-component of the span name
(``load/<patient>`` feeds one ``stage="load"`` histogram while
``report()`` keeps the per-patient keys).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

from nm03_capstone_project_tpu_torch.obs.metrics import STAGE_LATENCY_METRIC


class SpanRecorder:
    """Named wall-clock sections; re-entrant accumulation + histograms."""

    def __init__(self, registry=None, histogram_name: str = STAGE_LATENCY_METRIC):
        self.sections: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.registry = registry
        self.histogram_name = histogram_name
        self._lock = threading.RLock()  # signal-handler reentrancy
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @property
    def depth(self) -> int:
        """Current nesting depth on the calling thread."""
        return len(self._stack())

    def current_path(self) -> str:
        """``outer/inner`` span path on the calling thread ('' at top level)."""
        return "/".join(self._stack())

    @contextlib.contextmanager
    def span(self, name: str, stage: Optional[str] = None):
        """Time a named section.

        Args:
          name: section key accumulated in ``sections``/``report()``; may
            carry a ``/``-suffix for per-item detail (``load/<patient>``).
          stage: histogram ``stage`` label override; defaults to the first
            ``/``-component of ``name`` (bounded cardinality).
        """
        from torch.profiler import record_function

        stack = self._stack()
        stack.append(name)
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            with self._lock:
                self.sections[name] = self.sections.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1
            if self.registry is not None:
                label = stage if stage is not None else name.split("/", 1)[0]
                self.registry.histogram(
                    self.histogram_name,
                    help="wall-clock latency per pipeline stage",
                    stage=label,
                ).observe(dt)

    # the drivers' ``timer.section(...)`` spelling
    section = span

    def report(self) -> Dict[str, float]:
        with self._lock:
            return dict(sorted(self.sections.items()))
