"""Saturation & goodput telemetry: how much of the card a run used.

The port's copy of the JAX package's ``obs/saturation.py``. Every other
layer reports *that* it worked (requests served, batches dispatched,
retries survived); none of it can show a card sitting idle, a window
padded to waste, or a driver stalled on its feed. This module is that
efficiency layer:

* :class:`SaturationMonitor` — serving-side accounting fed by the
  executor's dispatch intervals and the batcher's chunk/window geometry,
  computed over a lock-guarded bounded sliding time window:
  per-lane busy/idle fractions + idle-gap histogram, padding waste
  (real vs dead rows), window occupancy vs fleet capacity, per-bucket
  fill, and MFU (achieved operations rate ÷ the card's peak);
* :class:`PhaseAccountant` — busy-interval accounting for a driver's
  decode→stage→dispatch→fetch→export feed, producing the ``feed_stall``
  report (the fraction of wall the device sat starved);
* :func:`peak_flops_for` — the roofline denominators: the H100 SXM's
  data-sheet peak for CUDA lanes, and the JAX package's documented
  order-of-magnitude estimate for CPU hosts (MFU on the CPU is a trend
  line, not a claim);
* :func:`bucket_flops` — the operations one serving batch of a bucket
  does, counted from the pipeline's arithmetic (the formula is below).

Stdlib only at import; thread-shared state is lock-guarded. Metric names
live in :mod:`.metrics`.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from nm03_capstone_project_tpu_torch.obs.metrics import (
    SERVING_BATCH_ROWS_TOTAL,
    SERVING_BUCKET_FILL_RATIO,
    SERVING_BUSY_FRACTION,
    SERVING_LANE_BUSY_FRACTION,
    SERVING_LANE_IDLE_GAP_SECONDS,
    SERVING_LANE_MFU,
    SERVING_LANE_PEAK_FLOPS,
    SERVING_MFU,
    SERVING_PADDING_WASTE_RATIO,
    SERVING_WINDOW_OCCUPANCY_RATIO,
)

# how far back the efficiency window looks: long enough to smooth batching
# jitter, short enough that a quarantined lane's idleness shows within a
# probe interval or two
DEFAULT_WINDOW_S = 60.0
# ring bound per lane / per sample stream — at one entry per device batch
# this covers minutes of saturated traffic; past it the oldest evidence
# ages out early (the window result is then conservative, never wrong)
DEFAULT_MAX_ENTRIES = 2048

# -- the roofline peak table --------------------------------------------------

# Per-card peak FLOP/s of the NVIDIA cards the port runs on, matched by
# substring of ``torch.cuda.get_device_name`` ("NVIDIA H100 80GB HBM3").
# A specification, not a measurement: NVIDIA's H100 data sheet, SXM part,
# 67 TFLOP/s in float32 outside the tensor cores (an FMA counted as two),
# at the card's full 700 W power limit. The serving pipeline is float32
# compares and arithmetic with no tensor-core work, so the float32 peak is
# its denominator, not the 989 TFLOP/s of bf16 on the tensor cores.
CUDA_PEAK_FLOPS: Dict[str, float] = {
    "H100": 67e12,
}

# CPU hosts: a DOCUMENTED ESTIMATE, not a measurement (the JAX package's
# number, so the two packages' CPU MFU agree) — a many-core server
# sustains O(1) TFLOP/s f32 with FMA/AVX; 2e12 keeps CPU MFU an
# order-of-magnitude trend line.
CPU_PEAK_FLOPS_ESTIMATE = 2e12


def peak_flops_for(platform: str, device_kind: str = "") -> Optional[float]:
    """Peak FLOP/s for one card of this platform/kind, or None (unknown).

    None means "no roofline denominator here" — MFU gauges are simply not
    published for such lanes rather than divided by a made-up number.
    """
    p = (platform or "").lower()
    if p == "cpu":
        return CPU_PEAK_FLOPS_ESTIMATE
    if p == "cuda":
        kind = (device_kind or "").upper()
        for key, peak in CUDA_PEAK_FLOPS.items():
            if key.upper() in kind:
                return peak
    return None


def bucket_flops(cfg, bucket: int, canvas: Optional[int] = None) -> float:
    """Operations one serving batch of ``bucket`` slices does on the canvas.

    Counted per canvas pixel the way ``chip_smoke.py`` counts the kernels'
    bounds (a min, max, compare, bitwise op, add or multiply is one
    operation; the pipeline has no FMA-heavy work):

    * fused preprocess: normalize 3, clip 2, the k x k vector median's
      pruned selection network (``comparator_counts``: the presort's and
      the shared pruned merge's min/max ops a pixel), two separable
      ``sharpen_kernel``-tap passes (ks products and ks - 1 sums each) and
      the unsharp update 3;
    * region growing: one convergence block of ``grow_block_iters`` steps
      (the least any slice runs), 9 ops a pixel a step (4 neighbour
      shifts/ORs, 2 carries, up/down, the band AND) on 1-bit words, so
      9/32 a pixel, plus the band test 2;
    * cast and the cross-3 dilation 1 + 4, the valid-mask multiply 1.

    The growth's further blocks depend on the data and are not counted,
    so MFU from this count is a lower bound.
    """
    from nm03_capstone_project_tpu_torch.ops.selection_network import comparator_counts

    c = int(canvas if canvas is not None else cfg.canvas)
    counts = comparator_counts(cfg.median_window)
    median = counts["presort_minmax"] + counts["merge_minmax_pruned_shared"]
    ks = cfg.sharpen_kernel
    preprocess = 3 + 2 + median + 2 * (2 * ks - 1) + 3
    grow = cfg.grow_block_iters * 9 / 32 + 2
    morph = 1 + 4 + 1
    return float(int(bucket) * c * c * (preprocess + grow + morph))


def _union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length of the union of (t0, t1) intervals (any order)."""
    total = 0.0
    end = None
    for t0, t1 in sorted(intervals):
        if t1 <= t0:
            continue
        if end is None or t0 >= end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


# fill-ratio buckets: fractions of a warm bucket actually carrying real
# rows — eighths resolve every fill level of the default bucket set
FILL_RATIO_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
# idle-gap buckets: sub-ms back-to-back dispatch up to probe-interval gaps
IDLE_GAP_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0,
)


class SaturationMonitor:
    """Serving-side efficiency accounting over a sliding time window.

    Fed by the executor (:meth:`record_dispatch`, per supervised device
    batch) and the batcher (:meth:`record_chunk` per padded chunk,
    :meth:`record_window` per coalescing window); read by
    :meth:`publish`/:meth:`snapshot` on every metrics scrape and
    ``/readyz`` probe. All state is lock-guarded and every ring is
    doubly bounded — by the time window and by a max entry count — so an
    arbitrarily long serving run holds O(window) evidence, never O(run).

    ``clock`` is injectable (tests pin a fake monotonic clock); everything
    else uses one process-wide ``time.monotonic`` timebase, the same one
    the trace spans ride.
    """

    def __init__(
        self,
        registry=None,
        window_s: float = DEFAULT_WINDOW_S,
        max_entries: int = DEFAULT_MAX_ENTRIES,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.registry = registry
        self.window_s = float(window_s)
        self.max_entries = int(max_entries)
        self._clock = clock
        self._lock = threading.Lock()
        self._epoch = clock()
        # lane -> deque[(t0, t1, flops)]; flops 0.0 for failed dispatches
        # (the card was occupied — busy — but achieved nothing)
        self._dispatches: Dict[int, collections.deque] = {}
        self._last_end: Dict[int, float] = {}
        # lane -> (platform, device_kind, peak_flops-or-None)
        self._lanes: List[Tuple[str, str, Optional[float]]] = []
        # lane -> the physical device it runs on: lanes that share a card
        # share its peak (the fleet MFU counts each card once)
        self._lane_device: List[object] = []
        # (lane, bucket) -> flops per dispatch (from bucket_flops)
        self._flops: Dict[Tuple[int, int], float] = {}
        # goodput rings: (t, real_rows, bucket_rows) / (t, riders, capacity)
        self._chunks: collections.deque = collections.deque(
            maxlen=self.max_entries
        )
        self._windows: collections.deque = collections.deque(
            maxlen=self.max_entries
        )

    # -- feeding (executor / batcher side) ---------------------------------

    def set_lanes(self, lanes: Sequence[Tuple]) -> None:
        """Declare the fleet: one (platform, device_kind) per lane, or
        (platform, device_kind, device) where lanes may share a device:
        such lanes share one card's peak in the fleet MFU.

        Publishes every lane's gauges at zero immediately, so "lane 3 was
        never busy" is a reported 0.0, distinguishable from "lane 3 was
        never resolved" (the same presence contract as
        ``serving_lane_state``).
        """
        rows = [
            (str(lane[0]), str(lane[1]), peak_flops_for(str(lane[0]), str(lane[1])))
            for lane in lanes
        ]
        with self._lock:
            self._lanes = rows
            self._lane_device = [lane[2] if len(lane) > 2 else ("lane", i)
                                 for i, lane in enumerate(lanes)]
            for lane in range(len(rows)):
                self._dispatches.setdefault(
                    lane, collections.deque(maxlen=self.max_entries)
                )
        self.publish()

    def set_lane_bucket_flops(
        self, lane: int, bucket: int, flops: Optional[float]
    ) -> None:
        """Pin the per-dispatch flops of one (lane, bucket) executable —
        :func:`bucket_flops`, recorded once at warmup."""
        if flops is None:
            return
        with self._lock:
            self._flops[(int(lane), int(bucket))] = float(flops)

    def record_dispatch(
        self,
        lane: int,
        t0: float,
        t1: float,
        bucket: Optional[int] = None,
        counted: bool = True,
    ) -> None:
        """One device-batch interval on one lane (success or failure).

        ``counted=False`` (a failed/quarantining dispatch) keeps the busy
        time — the card WAS occupied — but contributes zero achieved flops
        to MFU. The idle gap since the lane's previous dispatch feeds the
        idle-gap histogram.
        """
        lane = int(lane)
        t0, t1 = float(t0), float(t1)
        if t1 < t0:
            t0, t1 = t1, t0
        flops = 0.0
        if counted and bucket is not None:
            with self._lock:
                flops = self._flops.get((lane, int(bucket)), 0.0)
        gap = None
        with self._lock:
            ring = self._dispatches.setdefault(
                lane, collections.deque(maxlen=self.max_entries)
            )
            last = self._last_end.get(lane)
            if last is not None and t0 > last:
                gap = t0 - last
            self._last_end[lane] = max(last or t1, t1)
            ring.append((t0, t1, flops))
        if gap is not None and self.registry is not None:
            self.registry.histogram(
                SERVING_LANE_IDLE_GAP_SECONDS,
                help="gap between consecutive device dispatches on one "
                "replica lane (the shape of its idleness)",
                buckets=IDLE_GAP_BUCKETS,
                lane=str(lane),
            ).observe(gap)

    def record_chunk(self, real_rows: int, bucket_rows: int) -> None:
        """One padded chunk: ``real_rows`` riders in a ``bucket_rows``
        canvas stack; the difference is pure dead compute."""
        real, bucket = int(real_rows), int(bucket_rows)
        now = self._clock()
        with self._lock:
            self._chunks.append((now, real, bucket))
        if self.registry is not None:
            rows = self.registry.counter(
                SERVING_BATCH_ROWS_TOTAL,
                help="dispatched batch rows by kind: real riders vs padding "
                "(dead lanes of the bucket canvas)",
                kind="real",
            )
            rows.inc(real)
            self.registry.counter(
                SERVING_BATCH_ROWS_TOTAL,
                help="dispatched batch rows by kind: real riders vs padding "
                "(dead lanes of the bucket canvas)",
                kind="padded",
            ).inc(max(bucket - real, 0))
            if bucket > 0:
                self.registry.histogram(
                    SERVING_BUCKET_FILL_RATIO,
                    help="real rows / bucket size per dispatched chunk",
                    buckets=FILL_RATIO_BUCKETS,
                    bucket=str(bucket),
                ).observe(real / bucket)

    def record_window(self, riders: int, capacity: int) -> None:
        """One coalescing window: ``riders`` requests against the healthy
        fleet's row capacity at close time."""
        now = self._clock()
        with self._lock:
            self._windows.append((now, int(riders), max(int(capacity), 1)))

    # -- reading (scrape / readyz side) ------------------------------------

    def _window_start(self, now: float) -> float:
        # never reach before the monitor existed: a fresh server's first
        # scrape divides by its true uptime, not by a 60 s window it has
        # not lived yet
        return max(now - self.window_s, self._epoch)

    def _evict(self, now: float) -> None:
        """Drop entries that ended before the window (callers hold lock)."""
        horizon = now - self.window_s
        for ring in self._dispatches.values():
            while ring and ring[0][1] < horizon:
                ring.popleft()
        for ring in (self._chunks, self._windows):
            while ring and ring[0][0] < horizon:
                ring.popleft()

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The efficiency view over the current window (one lock hold).

        ``lanes[i].busy_fraction`` is the union of dispatch intervals
        clipped to the window over the window's span; ``mfu`` divides the
        achieved flops rate by the lane's peak (None where no peak is
        known or no flops were pinned). The process-wide ``mfu`` divides
        total achieved flops by the whole fleet's peak — the number that
        says what fraction of the machine the serving process used; lanes
        that share a card count its peak once.
        """
        now = self._clock() if now is None else float(now)
        with self._lock:
            self._evict(now)
            w0 = self._window_start(now)
            span = max(now - w0, 1e-9)
            lanes = []
            total_flops = 0.0
            total_peak = 0.0
            busy_sum = 0.0
            peaked = set()
            for lane, (platform, kind, peak) in enumerate(self._lanes):
                ring = self._dispatches.get(lane, ())
                clipped = [
                    (max(t0, w0), min(t1, now))
                    for t0, t1, _ in ring
                    if t1 > w0
                ]
                busy = _union_seconds(clipped)
                flops = sum(f for t0, t1, f in ring if t1 > w0)
                frac = min(busy / span, 1.0)
                busy_sum += frac
                mfu = None
                if peak is not None and peak > 0:
                    mfu = (flops / span) / peak
                    total_flops += flops
                    card = self._lane_device[lane]
                    if card not in peaked:
                        peaked.add(card)
                        total_peak += peak
                lanes.append(
                    {
                        "lane": lane,
                        "platform": platform,
                        "device_kind": kind,
                        "peak_flops": peak,
                        "busy_fraction": round(frac, 4),
                        "mfu": round(mfu, 6) if mfu is not None else None,
                    }
                )
            real = sum(r for _, r, _ in self._chunks)
            padded = sum(max(b - r, 0) for _, r, b in self._chunks)
            occ = [r / c for _, r, c in self._windows]
            total_rows = real + padded
        out = {
            "window_s": self.window_s,
            "lanes": lanes,
            "busy_fraction": (
                round(busy_sum / len(lanes), 4) if lanes else 0.0
            ),
            "mfu": (
                round((total_flops / span) / total_peak, 6)
                if total_peak > 0
                else None
            ),
            "padding_waste_ratio": (
                round(padded / total_rows, 4) if total_rows else 0.0
            ),
            "window_occupancy_ratio": (
                round(sum(occ) / len(occ), 4) if occ else 0.0
            ),
            "rows": {"real": real, "padded": padded},
        }
        return out

    def publish(self, now: Optional[float] = None) -> dict:
        """Refresh the saturation gauges from :meth:`snapshot`; returns it.

        Called on every ``/metrics``/``/metrics.json`` scrape and
        ``/readyz`` probe (gauges are pull-refreshed: the window slides
        whether or not traffic arrives) and once at drain so the final
        ``--metrics-out`` snapshot carries the run's last window.
        """
        snap = self.snapshot(now=now)
        reg = self.registry
        if reg is None:
            return snap
        for row in snap["lanes"]:
            lane = str(row["lane"])
            reg.gauge(
                SERVING_LANE_BUSY_FRACTION,
                help="fraction of the sliding window one replica lane spent "
                "executing device batches",
                lane=lane,
            ).set(row["busy_fraction"])
            if row["peak_flops"] is not None:
                reg.gauge(
                    SERVING_LANE_PEAK_FLOPS,
                    help="per-card peak FLOP/s used as the lane's MFU "
                    "denominator (CUDA: the card's data-sheet number; "
                    "CPU: documented order-of-magnitude estimate)",
                    lane=lane,
                ).set(row["peak_flops"])
            if row["mfu"] is not None:
                reg.gauge(
                    SERVING_LANE_MFU,
                    help="achieved flops rate / peak flops per replica lane "
                    "over the sliding window",
                    lane=lane,
                ).set(row["mfu"])
        reg.gauge(
            SERVING_BUSY_FRACTION,
            help="mean lane busy fraction over the sliding window",
        ).set(snap["busy_fraction"])
        if snap["mfu"] is not None:
            reg.gauge(
                SERVING_MFU,
                help="process-wide model flops utilization: achieved flops "
                "rate / whole-fleet peak over the sliding window",
            ).set(snap["mfu"])
        reg.gauge(
            SERVING_PADDING_WASTE_RATIO,
            help="dead (padded) rows / total dispatched rows over the "
            "sliding window — the goodput gap dynamic batching pays for "
            "fixed compile shapes",
        ).set(snap["padding_waste_ratio"])
        reg.gauge(
            SERVING_WINDOW_OCCUPANCY_RATIO,
            help="mean riders-per-window / healthy fleet row capacity over "
            "the sliding window",
        ).set(snap["window_occupancy_ratio"])
        return snap


# -- driver-side feed accounting ---------------------------------------------

# the feed phase vocabulary of the JAX package's feed_stall schema;
# "dispatch" is the device-occupied phase — everything else is the serial
# feed the ingest pipeline exists to overlap away
FEED_PHASES = ("decode", "stage", "dispatch", "fetch", "export")


class PhaseAccountant:
    """Bounded busy-interval accounting for the driver feed phases.

    Records (t0, t1) busy intervals per named phase from any thread (the
    parallel driver's IO pool fetches on workers) and reports per-phase
    union seconds plus the headline ``feed_stall_ratio``: the fraction of
    wall time NO ``dispatch`` interval was active — device starvation by
    the serial decode→stage→dispatch→fetch feed. Intervals are merged
    incrementally into disjoint runs, so memory is bounded by the number
    of *gaps*, with a hard ``max_intervals`` cap past which the oldest
    runs collapse into an exact closed-sum (the report stays correct, the
    per-interval detail ages out).
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        max_intervals: int = 4096,
    ):
        if max_intervals < 2:
            raise ValueError(f"max_intervals must be >= 2, got {max_intervals}")
        self._clock = clock
        self.max_intervals = int(max_intervals)
        self._lock = threading.Lock()
        # phase -> sorted disjoint [t0, t1] runs (lists: ends get extended)
        self._runs: Dict[str, List[List[float]]] = {}
        # phase -> busy seconds of collapsed (aged-out) runs, and the time
        # horizon that collapse covered: late out-of-order intervals are
        # clamped to it so already-closed busy time is never counted twice
        self._closed: Dict[str, float] = {}
        self._horizon: Dict[str, float] = {}
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    @contextlib.contextmanager
    def busy(self, phase: str):
        """Time one busy interval of ``phase`` (records even on a raise —
        the device/decoder was occupied either way)."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.record(phase, t0, self._clock())

    def record(self, phase: str, t0: float, t1: float) -> None:
        t0, t1 = float(t0), float(t1)
        if t1 < t0:
            t0, t1 = t1, t0
        key = str(phase)
        with self._lock:
            if self._t_first is None or t0 < self._t_first:
                self._t_first = t0
            if self._t_last is None or t1 > self._t_last:
                self._t_last = t1
            # a late arrival reaching into the collapsed prefix is clamped
            # to the horizon: its overlap with the closed runs must never
            # count twice. (Time falling in a GAP of the collapsed prefix
            # is forfeited — without the per-run detail it cannot be told
            # apart from a duplicate; busy is then conservative, which for
            # the stall report errs toward reporting MORE starvation.)
            horizon = self._horizon.get(key)
            if horizon is not None:
                if t1 <= horizon:
                    return  # wall extent recorded above; busy already closed
                t0 = max(t0, horizon)
            runs = self._runs.setdefault(key, [])
            # insert keeping runs sorted + disjoint: merge every run the
            # new interval touches (threads deliver out of order)
            i = bisect.bisect_left(runs, [t0, t1])
            if i > 0 and runs[i - 1][1] >= t0:
                i -= 1
            j = i
            while j < len(runs) and runs[j][0] <= t1:
                t0 = min(t0, runs[j][0])
                t1 = max(t1, runs[j][1])
                j += 1
            runs[i:j] = [[t0, t1]]
            if len(runs) > self.max_intervals:
                # collapse the oldest half into the exact closed sum: the
                # union is already disjoint, so the total stays correct
                cut = len(runs) // 2
                self._closed[key] = self._closed.get(key, 0.0) + sum(
                    b - a for a, b in runs[:cut]
                )
                self._horizon[key] = runs[cut - 1][1]
                del runs[:cut]

    def busy_seconds(self, phase: str) -> float:
        with self._lock:
            return self._closed.get(phase, 0.0) + sum(
                b - a for a, b in self._runs.get(phase, ())
            )

    def report(self) -> dict:
        """The ``feed_stall`` record (the JAX package's schema).

        ``feed_stall_ratio`` is None when no dispatch interval was ever
        recorded (an empty cohort measured nothing — a 0.0 there would
        read as a perfectly-fed device).
        """
        with self._lock:
            phases = sorted(set(self._runs) | set(self._closed))
            t0, t1 = self._t_first, self._t_last
        busy = {p: round(self.busy_seconds(p), 4) for p in phases}
        wall = max((t1 - t0), 0.0) if t0 is not None and t1 is not None else 0.0
        out = {
            "wall_s": round(wall, 4),
            "busy_s": busy,
            "busy_fraction": {
                p: round(s / wall, 4) if wall > 0 else 0.0
                for p, s in busy.items()
            },
        }
        dispatch = busy.get("dispatch")
        if dispatch is not None and wall > 0:
            out["feed_stall_ratio"] = round(
                max(1.0 - dispatch / wall, 0.0), 4
            )
            out["stall_s"] = round(max(wall - dispatch, 0.0), 4)
        else:
            out["feed_stall_ratio"] = None
            out["stall_s"] = None
        return out
