"""The host→device ingest pipeline: decode ahead, stage ahead, never starve.

The port's copy of the JAX package's ``ingest/pipeline.py``, the one home
for getting decoded slices onto the card:

* a **decode pool** (``decode_workers`` threads) runs the caller's
  ``decode`` callable up to ``decode_workers`` work items ahead, results
  collected strictly in order;
* a bounded **staging ring** (:class:`.ring.StagingRing`, depth
  ``depth``) holds decoded host batches — its capacity is the
  backpressure contract: when device-side consumption stalls, the ring
  fills, the feeder blocks, and decode can never outrun the card;
* a **stager thread** runs the caller's ``stage`` callable (the pinned,
  non-blocking host→device copy of :mod:`.staging`) one-to-two batches
  ahead of compute, so batch N+1's copy overlaps batch N's kernels;
* the **consumer** (the driver loop) iterates staged batches;
* result fetch streams back through :meth:`submit` on the same pool,
  overlapped with the next batch's compute.

:meth:`stats` reports ring occupancy, decode queue depth, and the
upload↔compute overlap ratio; the drivers put the run's aggregate into the
results JSON as ``ingest``. The fault plan's ``ingest`` site fires here, as
in the JAX package: ``decode_error`` fails one work item on the decode pool
(an :class:`IngestFailure` the driver counts), ``stall`` wedges the stager
``hang_s`` seconds (decode blocks on the full ring; the run completes late,
never wrong). Not ported: the metrics gauges and the feed-stall accounting,
whose layers wait.

torch-free at import: torch enters only through the caller-supplied
``stage`` callable. Thread-shared state is lock-guarded.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import threading
import time
from typing import Callable, Iterable, Optional

from nm03_capstone_project_tpu_torch.ingest.ring import (
    RingClosed,
    RingFinished,
    StagingRing,
)

# default ring depth: one batch decoding, one staged, one in reserve —
# triple buffering without holding a whole cohort of host batches alive
DEFAULT_DEPTH = 3
# staged (device-side) lookahead: the upload queue. 2 = double buffering —
# batch N computing, batch N+1's upload enqueued; deeper holds more memory
# hostage for no additional overlap
DEFAULT_STAGED_DEPTH = 2
# bound on the interval evidence kept for the overlap ratio: past this the
# oldest intervals age out of the *detail* (the ratio then reflects the
# most recent window — bounded memory for arbitrarily long cohorts)
MAX_INTERVALS = 4096


class IngestFailure:
    """One work item that failed decode; rides the pipeline as a record so
    failure handling stays in item order (the drivers' containment
    contract: a bad batch is counted, never propagated)."""

    __slots__ = ("index", "item", "error")

    def __init__(self, index: int, item, error: BaseException):
        self.index = index
        self.item = item
        self.error = error

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"IngestFailure(index={self.index}, error={self.error!r})"


def _union(intervals) -> list:
    """Sorted disjoint union of (t0, t1) intervals."""
    out: list = []
    for t0, t1 in sorted(intervals):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def _intersection_seconds(a, b) -> float:
    """Total overlap between two interval sets (unions taken first)."""
    ua, ub = _union(a), _union(b)
    i = j = 0
    total = 0.0
    while i < len(ua) and j < len(ub):
        lo = max(ua[i][0], ub[j][0])
        hi = min(ua[i][1], ub[j][1])
        if hi > lo:
            total += hi - lo
        if ua[i][1] <= ub[j][1]:
            i += 1
        else:
            j += 1
    return total


class IngestPipeline:
    """Decode-pool → staging-ring → stager → consumer, with backpressure.

    Use as a context manager; iterate for staged records in source order::

        with IngestPipeline(source=batches, decode=dec, stage=stg) as pipe:
            for batch in pipe:          # staged, in order
                out = run(batch)        # dispatch (the caller's phase)
                pipe.submit(fetch, out) # result fetch off the feed path
        pipe.stats()                    # drained-at-exit snapshot

    ``decode(item)`` runs on pool threads (must be thread-safe across
    items); ``stage(decoded)`` runs on the single stager thread. A decode
    exception becomes an :class:`IngestFailure` record; a stage exception
    aborts the pipeline and is raised to the consumer (staging failures
    are device-path failures, not per-item noise).
    """

    def __init__(
        self,
        source: Iterable,
        decode: Callable,
        stage: Optional[Callable] = None,
        *,
        depth: int = DEFAULT_DEPTH,
        decode_workers: int = 4,
        staged_depth: int = DEFAULT_STAGED_DEPTH,
        spans=None,
        obs=None,
        fault_plan=None,
        fault_patient: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if decode_workers < 1:
            raise ValueError(
                f"decode_workers must be >= 1, got {decode_workers}"
            )
        if staged_depth < 1:
            raise ValueError(f"staged_depth must be >= 1, got {staged_depth}")
        self._source = source
        self._decode = decode
        self._stage = stage
        self.depth = int(depth)
        self.decode_workers = int(decode_workers)
        self._spans = spans
        self._obs = obs
        self._fault_plan = fault_plan
        self._fault_patient = fault_patient
        self._clock = clock
        self._ring = StagingRing(depth, clock=clock)
        self._staged = StagingRing(staged_depth, clock=clock)
        self._pool = cf.ThreadPoolExecutor(
            max_workers=self.decode_workers, thread_name_prefix="nm03-ingest"
        )
        self._cancel = threading.Event()
        self._lock = threading.Lock()
        self._started = False
        self._error: Optional[BaseException] = None
        self._feeder: Optional[threading.Thread] = None
        self._stager: Optional[threading.Thread] = None
        # telemetry (all guarded by _lock)
        self._decode_inflight = 0
        self._decode_inflight_peak = 0
        self._counts = {"decoded": 0, "failed": 0, "staged": 0, "yielded": 0}
        self._upload_intervals: collections.deque = collections.deque(
            maxlen=MAX_INTERVALS
        )
        self._consumer_intervals: collections.deque = collections.deque(
            maxlen=MAX_INTERVALS
        )
        self._drained: Optional[dict] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "IngestPipeline":
        with self._lock:
            if self._started:
                return self
            self._started = True
            self._feeder = threading.Thread(
                target=self._feed_loop, name="nm03-ingest-feed", daemon=True
            )
            self._stager = threading.Thread(
                target=self._stage_loop, name="nm03-ingest-stage", daemon=True
            )
        self._feeder.start()
        self._stager.start()
        return self

    def __enter__(self) -> "IngestPipeline":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        """Tear down: cancel threads, drain the pool, freeze stats().

        Idempotent; safe mid-iteration (a consumer exception must never
        leave the feeder parked on a full ring). Submitted result-fetch
        work is allowed to finish — the pool shutdown waits — so callers
        collect their futures before or after close() identically.
        """
        with self._lock:
            if self._drained is not None:
                return
            # freeze the snapshot BEFORE the rings close (close() clears
            # them): this is the drained-at-exit view stats() returns
            self._drained = self._stats_locked()
        self._cancel.set()
        self._ring.close()
        self._staged.close()
        for t in (self._feeder, self._stager):
            if t is not None and t.is_alive():
                t.join(timeout=10.0)
        self._pool.shutdown(wait=True)

    def submit(self, fn, *args, **kwargs) -> cf.Future:
        """Run ``fn`` on the ingest pool: the home for result fetch/export
        work that should stream back while the next batch computes."""
        return self._pool.submit(fn, *args, **kwargs)

    # -- the three stages --------------------------------------------------

    def _span(self, name: str):
        if self._spans is not None:
            return self._spans.section(name)
        import contextlib

        return contextlib.nullcontext()

    def _fire_fault(self, index: int, item):
        """Consult the ingest fault site for this work item (None when
        off). Returns the fired rule; the caller maps kind→action
        (``decode_error`` raises here, ``stall`` rides the record to the
        stager)."""
        plan = self._fault_plan
        if plan is None or not plan.has_site("ingest"):
            return None
        return plan.fire(
            "ingest",
            obs=self._obs,
            patient=self._fault_patient,
            stem=getattr(item, "stem", None),
            index=index,
        )

    def _decode_one(self, index: int, item):
        """Pool-side decode of one work item; containment built in."""
        stall_s = 0.0
        try:
            rule = self._fire_fault(index, item)
            if rule is not None:
                if rule.kind == "decode_error":
                    raise RuntimeError(f"injected ingest decode fault (item {index})")
                stall_s = rule.hang_s  # applied by the stager
            with self._span("decode"):
                payload = self._decode(item)
            return (index, payload, stall_s)
        except Exception as e:  # noqa: BLE001 - per-item containment
            return IngestFailure(index, item, e)

    def _feed_loop(self) -> None:
        """Submit decodes up to ``decode_workers`` ahead; collect strictly
        in order; push into the ring (a full ring blocks — backpressure)."""
        inflight: collections.deque = collections.deque()
        it = iter(enumerate(self._source))
        exhausted = False
        try:
            while not self._cancel.is_set():
                while not exhausted and len(inflight) < self.decode_workers:
                    try:
                        index, item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    inflight.append(self._pool.submit(self._decode_one, index, item))
                    with self._lock:
                        self._decode_inflight = len(inflight)
                        if len(inflight) > self._decode_inflight_peak:
                            self._decode_inflight_peak = len(inflight)
                if not inflight:
                    break
                rec = inflight.popleft().result()
                with self._lock:
                    self._decode_inflight = len(inflight)
                    self._counts[
                        "failed" if isinstance(rec, IngestFailure) else "decoded"
                    ] += 1
                self._ring.put(rec)
            self._ring.finish()
        except RingClosed:
            pass  # torn down mid-flight; close() owns the cleanup
        except BaseException as e:  # noqa: BLE001 - surfaced to the consumer
            self._abort(e)

    def _stage_loop(self) -> None:
        """Pop decoded batches in order, upload ahead of compute."""
        try:
            while not self._cancel.is_set():
                try:
                    rec = self._ring.get()
                except RingFinished:
                    break
                if isinstance(rec, IngestFailure):
                    self._staged.put(rec)
                    continue
                index, payload, stall_s = rec
                if stall_s > 0:
                    # injected stager wedge: cancel-aware, so close() is
                    # never held hostage by a drill
                    self._cancel.wait(timeout=stall_s)
                if self._stage is not None:
                    t0 = self._clock()
                    with self._span("stage"):
                        payload = self._stage(payload)
                    with self._lock:
                        self._upload_intervals.append((t0, self._clock()))
                with self._lock:
                    self._counts["staged"] += 1
                self._staged.put((index, payload))
            self._staged.finish()
        except RingClosed:
            pass
        except BaseException as e:  # noqa: BLE001 - surfaced to the consumer
            self._abort(e)

    def _abort(self, error: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = error
        self._cancel.set()
        self._ring.close()
        self._staged.close()

    # -- consumer ----------------------------------------------------------

    def __iter__(self):
        """Staged records in source order (:class:`IngestFailure` for
        contained decode failures). The time between a yield and the next
        request is accounted as the consumer's busy window — the
        denominator side of the upload-overlap ratio."""
        self.start()
        while True:
            try:
                rec = self._staged.get()
            except RingFinished:
                break
            except RingClosed:
                break
            t_yield = self._clock()
            try:
                with self._lock:
                    self._counts["yielded"] += 1
                if isinstance(rec, IngestFailure):
                    yield rec
                else:
                    # hand out the ONLY reference, so the staged device
                    # tensors are freed as soon as the consumer drops them
                    index, payload = rec
                    del rec
                    yield payload
            finally:
                with self._lock:
                    self._consumer_intervals.append((t_yield, self._clock()))
        with self._lock:
            err = self._error
        if err is not None:
            raise err

    # -- telemetry ---------------------------------------------------------

    def _stats_locked(self) -> dict:
        uploads = list(self._upload_intervals)
        consumer = list(self._consumer_intervals)
        upload_s = sum(t1 - t0 for t0, t1 in _union(uploads))
        consumer_s = sum(t1 - t0 for t0, t1 in _union(consumer))
        overlap = None
        if upload_s > 0:
            overlap = min(
                _intersection_seconds(uploads, consumer) / upload_s, 1.0
            )
        return {
            "ring": self._ring.stats(),
            "decode_queue_depth": self._decode_inflight,
            "decode_queue_peak": self._decode_inflight_peak,
            "upload_s": round(upload_s, 4),
            "consumer_busy_s": round(consumer_s, 4),
            # fraction of the staging-call wall that ran UNDER the
            # consumer's busy window: ~1.0 = staging never blocked the
            # consumer. On the CPU the stage call IS the copy; on the card
            # it is the enqueue of a non-blocking copy plus its event, so
            # this says "staging stayed off the critical path", not "the
            # DMA hid". None = the stage callable never ran
            "upload_overlap_ratio": (
                round(overlap, 4) if overlap is not None else None
            ),
            "counts": dict(self._counts),
        }

    def stats(self) -> dict:
        """Live view, or the frozen drained-at-exit snapshot after
        close() — so the driver's results JSON sees the run's true
        totals, not an emptied ring."""
        with self._lock:
            if self._drained is not None:
                return dict(self._drained)
            return self._stats_locked()
