"""Bounded admission queue with load-shedding backpressure.

The port's copy of the JAX package's ``serving/queue.py``. The batch
drivers process a *fixed* cohort: work arrives all at once and
backpressure is meaningless. An online service faces the opposite regime —
arrival rate is set by clients, not capacity — so admission control is the
first line of defense: a bounded queue that REJECTS at the door (HTTP 503 +
``Retry-After``) instead of buffering unboundedly and timing every request
out. Shedding early is the serving-systems orthodoxy (bounded queues in
front of batched accelerators; see PAPERS.md on continuous batching): a
request that cannot be served inside its latency budget is cheapest to
refuse before any work is spent on it.

HTTP-free and stdlib-only by design: a data structure plus policy,
unit-testable without a device or a socket.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


class QueueFull(RuntimeError):
    """Admission refused: the bounded queue is at capacity (shed the load)."""


class QueueClosed(RuntimeError):
    """Admission refused: the server is draining (SIGTERM received)."""


@dataclass
class ServeRequest:
    """One in-flight segmentation request, from admission to response.

    ``pixels``/``dims`` are the decoded host-side inputs (the HTTP layer
    decodes before admission so a malformed body is a 400, never a wasted
    batch slot). The result travels back through ``done``: the batcher
    fills ``mask``/``converged``/``batch_size`` (or ``error``) and sets the
    event; the handler thread blocks on it with a timeout.
    """

    request_id: str
    pixels: object  # np.ndarray (h, w) float32, raw intensities
    dims: tuple  # (h, w)
    t_admitted: float = field(default_factory=time.monotonic)
    # request-scoped tracing: the obs.trace.TraceContext whose
    # trace id rode in on X-Nm03-Request-Id (or was minted at admission);
    # every hop appends its span here. None for trace-less callers (tests).
    trace: object = None
    # stamped by AdmissionQueue.get_batch when the batcher pops this
    # request — splits the queue_wait span from the coalesce span
    t_popped: float = 0.0
    # filled by the batcher
    mask: object = None  # np.ndarray (h, w) uint8, cropped to dims
    converged: bool = True
    batch_size: int = 0
    queue_wait_s: float = 0.0
    lane: Optional[int] = None  # the replica lane that served it
    # how many times this request's chunk was re-dispatched because its
    # lane quarantined mid-flight: 0 on the happy path; >0 means
    # the rider outlived a sick chip without ever seeing an error
    requeues: int = 0
    # a fleet probation canary (X-Nm03-Probe): served and traced
    # normally, but excluded from the request metrics —
    # the canary cadence must not pollute the request series
    probe: bool = False
    # the rider's prorated device cost: its row's share of the
    # chunk's accumulated device-busy seconds, stamped by the batcher and
    # echoed in the response payload as `device_seconds`
    device_seconds: float = 0.0
    # content-addressed result-key digest: identical digests in
    # one batch window ride a single dispatch — the batcher elects a leader
    # and fans its mask out to the dup riders. None = dedup not in play.
    digest: Optional[str] = None
    error: Optional[BaseException] = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    def fail(self, exc: BaseException) -> None:
        # the write is sequenced before done.set(); the waiter reads error
        # only after wait() returns
        # nm03-lint: disable=NM331 release ordering via the Event: the write is sequenced before done.set(), and the waiter reads error only after wait() returns
        self.error = exc
        self.done.set()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        return self.done.wait(timeout_s)


class AdmissionQueue:
    """Bounded FIFO between the HTTP handler threads and the batcher.

    * ``put`` never blocks: at capacity it raises :class:`QueueFull`
      immediately (the handler turns that into 503 + ``Retry-After``) —
      queueing delay is bounded by construction, not by hope.
    * ``get_batch`` is the batcher's coalescing pop: it blocks for the
      first request, then keeps collecting until ``max_batch`` items are
      in hand or ``max_wait_s`` has elapsed since the first one — the
      dynamic-batching window.
    * ``close`` flips the queue into drain mode: every later ``put`` is
      refused with :class:`QueueClosed`, while ``get_batch`` keeps
      returning the already-admitted tail until empty (an admitted request
      is a promise; drain finishes it).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._items: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def put(self, req: ServeRequest) -> None:
        with self._lock:
            if self._closed:
                raise QueueClosed("server is draining; not admitting")
            if len(self._items) >= self.capacity:
                raise QueueFull(
                    f"admission queue at capacity ({self.capacity})"
                )
            self._items.append(req)
            self._not_empty.notify()

    def get_batch(
        self,
        max_batch: int,
        max_wait_s: float,
        poll_s: float = 0.05,
    ) -> list:
        """Coalesce up to ``max_batch`` requests inside one wait window.

        Blocks (in ``poll_s`` slices, so ``close`` is noticed promptly) for
        the first request; once one is in hand, keeps popping until the
        batch is full or ``max_wait_s`` has passed since the first pop.
        Returns [] when the queue is closed AND empty — the batcher's exit
        signal.
        """
        def pop() -> ServeRequest:
            req = self._items.popleft()
            # the queue_wait/coalesce trace boundary: waited until HERE
            req.t_popped = time.monotonic()
            return req

        batch: list = []
        with self._not_empty:
            while not self._items:
                if self._closed:
                    return []
                self._not_empty.wait(timeout=poll_s)
            batch.append(pop())
            window_end = time.monotonic() + max_wait_s
            while len(batch) < max_batch:
                if self._items:
                    batch.append(pop())
                    continue
                remaining = window_end - time.monotonic()
                if remaining <= 0 or self._closed:
                    break
                self._not_empty.wait(timeout=min(remaining, poll_s))
        return batch

    def close(self) -> None:
        """Stop admissions; wake any batcher blocked on an empty queue."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    def drain_pending(self) -> list:
        """Pop everything (used on abort paths to fail pending requests)."""
        with self._lock:
            items = list(self._items)
            self._items.clear()
        return items
