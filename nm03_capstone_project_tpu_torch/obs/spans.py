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

:class:`StageRecorder` keeps the pipeline's stage spans themselves, each
with its start and end, and its counters, in memory for its caller to
read afterwards (:func:`..pipeline.stage_spans`): on the wall clock in
nanoseconds that ``torch.profiler``'s records carry, so a span lines up
with the device's activity in a trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

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


class StageRecorder:
    """The pipeline's stage spans and counters of one thread, in memory.

    ``spans`` holds ``(start_ns, end_ns, name, parent)`` in the order the
    spans began: ``time.time_ns()`` at each end, and ``parent`` the index
    in ``spans`` of the innermost span open when it began (-1 at the top),
    so a span's path is its parents' names and its own joined by ``/``,
    as :meth:`SpanRecorder.current_path` joins them. ``counters`` sums the
    values recorded under each name. A value may be a 0-d tensor that the
    device has yet to compute (the 3D grow kernel's steps): it is kept
    unread and read when ``counters`` is, so recording one never waits on
    the device inside the call that counts it. One thread records into a
    recorder at a time.
    """

    def __init__(self):
        self.spans: List[Tuple[int, int, str, int]] = []
        self._counts: Dict[str, int] = {}
        self._unread: Dict[str, list] = {}
        self._open: List[int] = []

    def span(self, name: str) -> "_StageSpan":
        return _StageSpan(self, name)

    def count(self, name: str, value=1) -> None:
        """Add ``value`` (an int, or a 0-d tensor read later) under ``name``."""
        if isinstance(value, int):
            self._counts[name] = self._counts.get(name, 0) + value
        else:
            self._counts.setdefault(name, 0)
            self._unread.setdefault(name, []).append(value)

    @property
    def counters(self) -> Dict[str, int]:
        """The sums by name, every tensor counted so far read into them."""
        for name, values in self._unread.items():
            self._counts[name] += sum(int(v) for v in values)
        self._unread.clear()
        return self._counts

    def path(self, i: int) -> str:
        """The ``/``-joined names from the outermost span down to span ``i``."""
        names = []
        while i >= 0:
            _, _, name, i = self.spans[i]
            names.append(name)
        return "/".join(reversed(names))


class _StageSpan:
    """One span of a :class:`StageRecorder`: the clock is read last on the
    way in and first on the way out, so sibling spans leave the least
    time between them."""

    __slots__ = ("_rec", "_name", "_i")

    def __init__(self, rec: StageRecorder, name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        rec = self._rec
        parent = rec._open[-1] if rec._open else -1
        self._i = len(rec.spans)
        rec._open.append(self._i)
        rec.spans.append((time.time_ns(), 0, self._name, parent))

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self._rec
        rec._open.pop()
        start, _, name, parent = rec.spans[self._i]
        rec.spans[self._i] = (start, end, name, parent)
        return False
