"""Request-scoped tracing for the serving path.

The port's copy of the JAX package's ``obs/trace.py`` (its ``nm03-trace``
Perfetto exporter is not ported yet): every ``POST /v1/segment`` gets a
**trace id** (an inbound ``X-Nm03-Request-Id`` header is honored after
sanitization, else one is minted) that travels on the
:class:`~..serving.queue.ServeRequest` through admission → coalescing →
the supervised executor → response, and is echoed back as the
``X-Nm03-Request-Id`` response header. Each hop records a **span**
(``queue_wait``, ``coalesce``, ``pad_stack``, ``device_dispatch`` per
supervised attempt, ``fetch``, ``encode``). Chunk-level spans are
*shared*: one record carries every rider's trace id. Completed requests
emit one ``serve_trace`` event (the span tree) into the JSONL event log,
in the JAX package's ``nm03.trace.v1`` span layout, and every span
begin/end also feeds the
:mod:`~nm03_capstone_project_tpu_torch.obs.flightrec` ring.

Stdlib only.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import re
import threading
import time
from typing import Iterable, List, Optional

from nm03_capstone_project_tpu_torch.obs import flightrec

# the JSONL event (one per completed request) carrying the span tree
SERVE_TRACE_EVENT = "serve_trace"
# the serving span vocabulary: the JAX package's names for the hops the
# port has (docs/OBSERVABILITY.md trace schema); the serving tests pin it
SERVE_SPAN_NAMES = (
    "queue_wait",       # admission -> popped by the batcher
    "coalesce",         # popped -> the batching window closed
    "pad_stack",        # chunk padded into its bucket canvas stack
    "device_dispatch",  # one supervised execute attempt on one lane
    "fetch",            # device -> host result fetch (inside the deadline)
    "requeue",          # chunk re-dispatched off a quarantined lane
    "probe",            # probation canary on a quarantined lane (off-path)
    "encode",           # host render + JPEG encode on the handler thread
)

# client-supplied trace ids: bounded charset/length so a hostile header
# cannot smuggle log-breaking bytes into the event stream or a filename
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:\-]{0,63}$")

_SPAN_SEQ = itertools.count(1)


def new_trace_id() -> str:
    import uuid

    return uuid.uuid4().hex[:16]


def sanitize_trace_id(raw: Optional[str]) -> Optional[str]:
    """A usable client-supplied trace id, or None (caller mints one)."""
    if not isinstance(raw, str):
        return None
    raw = raw.strip()
    return raw if _TRACE_ID_RE.match(raw) else None


def _new_span_id() -> str:
    # pid-salted: the exporter dedupes shared chunk spans by id, and a
    # concatenated event stream (two replicas' logs, or a restarted
    # server appending with ">>") must not let a second process's s1
    # collide with the first's and be silently dropped from the export
    return f"s{os.getpid():x}.{next(_SPAN_SEQ):x}"


def make_span(
    name: str,
    t0_s: float,
    t1_s: float,
    trace_ids: List[str],
    lane: Optional[int] = None,
    **fields,
) -> dict:
    """One span record (the unit both the event log and the exporter use).

    Times are ``time.monotonic()`` seconds — one process-wide timebase so
    spans from different threads line up on one timeline. ``riders`` > 1
    marks a shared (chunk-level) span: one dispatch, many requests.
    """
    rec = {
        "id": _new_span_id(),
        "name": str(name),
        "t0_s": round(t0_s, 6),
        "dur_s": round(max(t1_s - t0_s, 0.0), 6),
        "thread": threading.current_thread().name,
        "lane": lane,
        "riders": len(trace_ids),
        "trace_ids": list(trace_ids),
    }
    for k, v in fields.items():
        if k not in rec:
            rec[k] = v
    return rec


class TraceContext:
    """One request's span collection, carried on the ServeRequest.

    Appends happen from the handler, batcher, and lane-pool threads, but
    always sequenced by the request's own lifecycle handoffs (queue put,
    chunk dispatch, done-Event); the lock makes the container safe against
    a concurrent flight-recorder snapshot mid-append anyway.
    """

    __slots__ = ("trace_id", "spans", "_lock")

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self.spans: List[dict] = []
        self._lock = threading.Lock()

    def add(self, rec: dict) -> None:
        with self._lock:
            self.spans.append(rec)

    def add_span(
        self, name: str, t0_s: float, t1_s: float, lane: Optional[int] = None,
        **fields,
    ) -> dict:
        """Record a retrospective span (both endpoints already measured)."""
        rec = make_span(name, t0_s, t1_s, [self.trace_id], lane=lane, **fields)
        self.add(rec)
        flightrec.note(
            "span", name, trace_id=self.trace_id,
            dur_s=rec["dur_s"], lane=lane,
        )
        return rec

    @contextlib.contextmanager
    def span(self, name: str, lane: Optional[int] = None, **fields):
        """Time a section on this request's trace (e.g. ``encode``)."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add_span(name, t0, time.monotonic(), lane=lane, **fields)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self.spans)


class ChunkTrace:
    """Shared spans for one dispatched chunk: many riders, one lane.

    The batcher builds one per chunk; ``span()`` records ONE span carrying
    every rider's trace id and appends it to every rider's context, so a
    coalesced batch is a single dispatch block with ``riders`` requests.
    """

    __slots__ = ("contexts", "lane", "trace_ids", "device_busy_s")

    def __init__(self, contexts: Iterable, lane: Optional[int] = None):
        self.contexts = [c for c in contexts if c is not None]
        self.lane = lane
        self.trace_ids = [c.trace_id for c in self.contexts]
        # accumulated device-busy seconds across every dispatch ATTEMPT of
        # this chunk (requeues included): WarmExecutor.run_batch adds each
        # interval; the batcher prorates the total over the chunk's rows
        self.device_busy_s = 0.0

    def mark(self, name: str, **fields) -> None:
        """Flight-recorder-only marker (no span): the in-flight evidence a
        wedged dispatch leaves behind even when its span never closes."""
        flightrec.note(
            "mark", name, trace_ids=self.trace_ids, lane=self.lane, **fields
        )

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        if not self.contexts:
            yield
            return
        t0 = time.monotonic()
        flightrec.note(
            "span_begin", name, trace_ids=self.trace_ids, lane=self.lane,
            **fields,
        )
        try:
            yield
        finally:
            rec = make_span(
                name, t0, time.monotonic(), self.trace_ids, lane=self.lane,
                **fields,
            )
            for c in self.contexts:
                c.add(rec)
            flightrec.note(
                "span", name, trace_ids=self.trace_ids,
                dur_s=rec["dur_s"], lane=self.lane,
            )


class _NullTrace:
    """No-op stand-in so un-traced call paths cost nothing."""

    lane = None
    trace_ids: List[str] = []

    def mark(self, name: str, **fields) -> None:
        pass

    def span(self, name: str, **fields):
        return contextlib.nullcontext()


NULL_TRACE = _NullTrace()
