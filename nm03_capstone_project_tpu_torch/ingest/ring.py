"""Bounded staging ring: the backpressure primitive of the ingest pipeline.

The port's copy of the JAX package's ``ingest/ring.py``. A
:class:`StagingRing` is an ordered, bounded, thread-safe hand-off between
one producer stage and one consumer stage of the host→device pipeline. It
is deliberately *small*: capacity IS the backpressure contract (decode can
never outrun the device), so a blocked ``put`` is the mechanism, not a
failure.

Beyond Queue semantics it accounts for itself: a time-weighted occupancy
integral (how full the ring sat, on average, over its lifetime — reported
in the drivers' results JSON under ``ingest``) plus peak depth and put/get
counts, all with an injectable monotonic clock so tests pin exact ratios.

Two terminal states, because "no more items" and "abandon ship" are
different facts:

* :meth:`finish` — the producer is done; ``get`` drains the remaining
  items, then raises :class:`RingFinished`;
* :meth:`close` — abort; both ends raise :class:`RingClosed` immediately
  (pending blockers wake), so a consumer exception can never leave a
  producer thread parked on a full ring.

stdlib-only: the ring is unit-testable without torch.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional


class RingClosed(RuntimeError):
    """The ring was aborted (:meth:`StagingRing.close`)."""


class RingFinished(RuntimeError):
    """The producer finished and every item has been drained."""


class StagingRing:
    """Ordered bounded hand-off with occupancy accounting.

    All mutable state is guarded by one lock; the condition variable
    shares it.
    """

    def __init__(
        self,
        capacity: int,
        clock: Callable[[], float] = time.monotonic,
    ):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items: collections.deque = collections.deque()
        self._closed = False
        self._finished = False
        # occupancy integral: sum(depth * dt) since construction, advanced
        # on every transition so occupancy_ratio() is exact at any instant
        self._t0 = clock()
        self._t_last = self._t0
        self._occ_integral = 0.0
        self._peak = 0
        self._puts = 0
        self._gets = 0

    # -- accounting (callers hold the lock) --------------------------------

    def _advance(self, now: float) -> None:
        if now > self._t_last:
            # every caller holds self._lock (put/get/close via the
            # condition, occupancy_ratio directly)
            self._occ_integral += len(self._items) * (now - self._t_last)
            self._t_last = now

    # -- producer side -----------------------------------------------------

    def put(self, item, timeout: Optional[float] = None) -> None:
        """Append ``item``; blocks while full (this IS the backpressure).

        Raises :class:`RingClosed` if the ring is aborted (before or while
        blocked) and TimeoutError when ``timeout`` elapses first.
        """
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                if self._closed:
                    raise RingClosed("staging ring closed")
                if self._finished:
                    raise RingClosed("staging ring already finished")
                if len(self._items) < self.capacity:
                    break
                remaining = None
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"staging ring full for {timeout}s "
                            f"(capacity {self.capacity})"
                        )
                self._cond.wait(remaining)
            self._advance(self._clock())
            self._items.append(item)
            self._puts += 1
            if len(self._items) > self._peak:
                self._peak = len(self._items)
            self._cond.notify_all()

    def finish(self) -> None:
        """Producer done: drain-then-:class:`RingFinished` for the consumer."""
        with self._cond:
            self._finished = True
            self._cond.notify_all()

    # -- consumer side -----------------------------------------------------

    def get(self, timeout: Optional[float] = None):
        """Pop the oldest item; blocks while empty.

        Raises :class:`RingFinished` once the producer finished and the
        ring drained, :class:`RingClosed` on abort, TimeoutError on a
        ``timeout``.
        """
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                if self._closed:
                    raise RingClosed("staging ring closed")
                if self._items:
                    break
                if self._finished:
                    raise RingFinished("staging ring drained")
                remaining = None
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        raise TimeoutError(f"staging ring empty for {timeout}s")
                self._cond.wait(remaining)
            self._advance(self._clock())
            item = self._items.popleft()
            self._gets += 1
            self._cond.notify_all()
            return item

    # -- teardown / introspection ------------------------------------------

    def close(self) -> None:
        """Abort: wake every blocked producer/consumer with RingClosed."""
        with self._cond:
            self._advance(self._clock())
            self._closed = True
            self._items.clear()
            self._cond.notify_all()

    def occupancy_ratio(self) -> float:
        """Time-weighted mean fill fraction since construction. ~1.0 = the
        consumer is the bottleneck (the device is saturated and
        backpressure holds the decoders); ~0.0 = the decoders can't keep
        the ring fed."""
        with self._lock:
            now = self._clock()
            self._advance(now)
            elapsed = now - self._t0
            if elapsed <= 0:
                return 0.0
            return min(self._occ_integral / (elapsed * self.capacity), 1.0)

    def stats(self) -> dict:
        with self._lock:
            depth, peak = len(self._items), self._peak
            puts, gets = self._puts, self._gets
        return {
            "capacity": self.capacity,
            "depth": depth,
            "peak": peak,
            "puts": puts,
            "gets": gets,
            "occupancy_ratio": round(self.occupancy_ratio(), 4),
        }
