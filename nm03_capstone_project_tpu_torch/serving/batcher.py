"""Dynamic batcher: coalesce in-flight requests, fan out across lanes.

The port's copy of the JAX package's ``serving/batcher.py``. A
single-slice request uses a sliver of one card; requests that arrive
within one short wait window coalesce, are padded to the smallest warm
bucket (``pad_batch``: slices in the leading rows, dead rows zero with
``min_dim`` dims) and split into per-lane chunks that replay each lane's
CUDA graph. Under load the window fills to ``lanes x largest bucket``; at
low load a request waits at most ``max_wait_s`` before running alone —
the latency/throughput knob.

One batcher thread owns the admission queue (coalescing needs one
consumer). Each coalesced batch's chunks run on a lane-sized worker pool,
one supervised dispatch per lane; with one lane there is no pool and the
dispatch is inline.

A chunk whose lane quarantines mid-dispatch (``LaneQuarantined``) is
re-dispatched to a remaining healthy lane (span ``requeue``) instead of
failing its riders. Any other failure — a deterministic error, or the
degraded executor's ``DeadlineExceeded`` once every lane is quarantined —
fails every rider of the chunk with the same error.

Identical content-addressed requests (one result-key digest) in one
window ride a single dispatch: the first is the leader, the rest copy its
result.

The gang gate (:meth:`DynamicBatcher.gang_parked`) is one lock the batcher
holds around each window's dispatch, fetch included; the volume gang
holds it for a whole study, so a volume waits out the in-flight window
and new windows wait for the volume while admissions keep queueing.

Accounting, as the JAX batcher does it: each padded chunk's real and dead
rows go to the saturation monitor (``record_chunk``), each window's riders
against the healthy fleet's capacity (``record_window``), and each chunk's
device-busy seconds (every attempt, requeues included) to the device-time
ledger (``charge_chunk``): real rows to ``request``, probation canaries to
``probe``, dead rows to ``padding``; every served non-probe rider lands in
the per-request histogram (``observe_request``), a deduplicated rider at
zero. One difference: a chunk that fails is charged too (the JAX ledger
drops it), so the three accounts sum to the executor's recorded busy
seconds through a fault drill as well.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import itertools
import math
import threading
import time
from typing import TYPE_CHECKING, List, Optional

import numpy as np

from nm03_capstone_project_tpu_torch.obs.trace import ChunkTrace
from nm03_capstone_project_tpu_torch.serving.lanes import LaneQuarantined
from nm03_capstone_project_tpu_torch.serving.metrics import (
    BATCH_SIZE_BUCKETS,
    LATENCY_BUCKETS,
    SERVING_BATCH_SIZE,
    SERVING_BATCHES_TOTAL,
    SERVING_QUEUE_WAIT_SECONDS,
    SERVING_REQUEUES_TOTAL,
    SERVING_RESULT_CACHE_HIT_TOTAL,
)
from nm03_capstone_project_tpu_torch.serving.queue import AdmissionQueue, ServeRequest
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

if TYPE_CHECKING:  # the lock-order analysis resolves self.executor through it
    from nm03_capstone_project_tpu_torch.serving.executor import WarmExecutor

log = get_logger("serving")


class DynamicBatcher:
    """The single consumer of the admission queue.

    Lifecycle: ``start()`` spawns the daemon thread; ``join()`` (after the
    queue is closed) blocks until every admitted request has been answered
    — the graceful-drain contract: close the door, finish the room.
    """

    def __init__(
        self,
        queue: AdmissionQueue,
        executor: "WarmExecutor",
        max_wait_s: float = 0.01,
        max_batch: Optional[int] = None,
        obs=None,
    ):
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.queue = queue
        self.executor = executor
        self.max_wait_s = float(max_wait_s)
        # None = lane-unaware executor (tests' fakes): single-lane semantics
        self._lane_aware = hasattr(executor, "lane_count")
        self.max_batch = int(max_batch) if max_batch else None
        self._validate_max_batch()
        self.obs = obs
        self._thread = threading.Thread(
            target=self._run, name="nm03-serve-batcher", daemon=True
        )
        # lane worker pool, created on the first multi-chunk batch
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        # round-robin cursor spreading requeued chunks over healthy lanes
        self._requeue_seq = itertools.count()
        # written by the batcher thread, read by handler threads via stats()
        self._lock = threading.Lock()
        self._stats = {
            "batches": 0,
            "requests": 0,
            "max_coalesced": 0,
            "lane_batches": {},
        }
        # the gang gate: held around every window's dispatch and, by the
        # volume gang, around a whole study's program
        self._gang_lock = threading.Lock()
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    def _validate_max_batch(self) -> None:
        """Reject an explicit ``max_batch`` above the fleet's capacity; runs
        at construction and again at :meth:`start`, once lanes resolved."""
        if self.max_batch is None:
            return
        lanes_known = (
            getattr(self.executor, "lane_count", None) if self._lane_aware else 1
        )
        if not lanes_known:
            return  # lanes unresolved: start() re-validates
        fleet = self.executor.max_batch * lanes_known
        if self.max_batch > fleet:
            if lanes_known == 1 and not self._lane_aware:
                raise ValueError(
                    f"max_batch {self.max_batch} exceeds the largest warm "
                    f"bucket {self.executor.max_batch}"
                )
            raise ValueError(
                f"max_batch {self.max_batch} exceeds the fleet capacity "
                f"{fleet} ({lanes_known} lane(s) x largest warm bucket "
                f"{self.executor.max_batch})"
            )

    def start(self) -> "DynamicBatcher":
        self._validate_max_batch()  # lanes are resolved by now (warmup ran)
        # nm03-lint: disable=NM331 owner-thread write, sequenced before _thread.start(): the start() fence orders it for the batcher thread
        self._started = True
        self._thread.start()
        return self

    def join(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for the batcher to drain (queue must be closed first)."""
        if not self._started:
            return True
        self._thread.join(timeout=timeout_s)
        return not self._thread.is_alive()

    @contextlib.contextmanager
    def gang_parked(self):
        """Park the slice lanes for one volume program.

        Acquiring waits for the in-flight window's slowest chunk (the
        batcher holds the same lock around every window's dispatch and
        fetch) and holds new windows back until release. Admissions keep
        flowing into the bounded queue throughout, so slice traffic sheds
        only on the queue's own capacity, never because a volume ran.
        """
        with self._gang_lock:
            yield

    def lanes(self) -> int:
        """The lane count dispatch fans out over (1 until lanes resolve)."""
        if not self._lane_aware:
            return 1
        return self.executor.lane_count or 1

    def healthy_lanes(self) -> List[int]:
        """Lane ids currently taking traffic (the fan-out targets); every
        lane when the executor has no fault domains (tests' fakes) or when
        nothing is healthy (the degraded executor then fails the chunk)."""
        if self._lane_aware:
            healthy = getattr(self.executor, "healthy_lanes", None)
            if callable(healthy):
                ids = healthy()
                if ids:
                    return ids
        return list(range(self.lanes()))

    def effective_max_batch(self) -> int:
        """The coalescing window's cap: *healthy* fleet capacity, or the
        explicit ``max_batch`` when smaller."""
        fleet = self.executor.max_batch * len(self.healthy_lanes())
        if self.max_batch is not None:
            return min(self.max_batch, fleet)
        return fleet

    def stats(self) -> dict:
        """Cumulative dispatch accounting (batches, riders, max coalesce,
        per-lane device batches), served in ``/readyz``."""
        with self._lock:
            out = dict(self._stats)
            out["lane_batches"] = dict(self._stats["lane_batches"])
            return out

    def _run(self) -> None:
        while True:
            batch = self.queue.get_batch(self.effective_max_batch(), self.max_wait_s)
            if not batch:  # closed and empty: drain complete
                return
            try:
                # the gang gate: while a volume holds it, popped riders wait
                # here inside their request deadline
                with self._gang_lock:
                    self.execute(batch)
            except BaseException as e:  # noqa: BLE001 — the loop must survive
                # execute() already failed the requests; a raise escaping it
                # is a batcher bug — log, answer anything still waiting, and
                # keep serving
                log.warning("batcher: batch execution raised: %s", e)
                for r in batch:
                    if not r.done.is_set():
                        r.fail(e)

    # -- the batch path ----------------------------------------------------

    def pad_batch(self, reqs: List[ServeRequest]):
        """Pad ``reqs`` into the smallest warm bucket's canvas stack: slices
        in the leading rows, dead rows zero with ``min_dim`` dims (their
        outputs are never read back out)."""
        cfg = self.executor.cfg
        bucket = self.executor.bucket_for(len(reqs))
        c = cfg.canvas
        pixels = np.zeros((bucket, c, c), np.float32)
        dims = np.full((bucket, 2), cfg.min_dim, np.int32)
        for i, r in enumerate(reqs):
            h, w = r.dims
            pixels[i, :h, :w] = r.pixels
            dims[i] = (h, w)
        return pixels, dims

    def _chunk(self, reqs: List[ServeRequest], n_lanes: int) -> List[List[ServeRequest]]:
        """Split one coalesced window into per-lane chunks: the smallest
        warm bucket holding an even share (``ceil(len/n_lanes)``)."""
        per = max(1, math.ceil(len(reqs) / max(n_lanes, 1)))
        per = self.executor.bucket_for(min(per, self.executor.max_batch))
        return [reqs[i : i + per] for i in range(0, len(reqs), per)]

    def _dispatch(self, pixels, dims, lane: int, trace):
        """One dispatch attempt on one lane (trace-aware when supported)."""
        if self._lane_aware and getattr(self.executor, "supports_trace", False):
            # nm03-lint: disable=NM422 the gang gate parks the batcher ACROSS slice dispatch by design — a volume study must wait out the in-flight window, so the hold covers the device call
            return self.executor.run_batch(pixels, dims, lane=lane, trace=trace)
        with trace.span("device_dispatch"):
            if self._lane_aware:
                # nm03-lint: disable=NM422 same deliberate gang-gate hold as above: the dispatch IS the window the gate exists to cover
                return self.executor.run_batch(pixels, dims, lane=lane)
            # nm03-lint: disable=NM422 same deliberate gang-gate hold as above: the dispatch IS the window the gate exists to cover
            return self.executor.run_batch(pixels, dims)

    def _execute_chunk(self, reqs: List[ServeRequest], lane: int) -> None:
        """Run one chunk on one lane and answer its riders; re-dispatch it
        to a healthy lane when its lane quarantines mid-dispatch."""
        trace = ChunkTrace([r.trace for r in reqs], lane=lane)
        with trace.span("pad_stack"):
            pixels, dims = self.pad_batch(reqs)
        sat = getattr(self.executor, "saturation", None)
        if sat is not None:
            # goodput: real riders vs the bucket rows they were padded into
            sat.record_chunk(len(reqs), int(pixels.shape[0]))
        # flight-recorder marker BEFORE the dispatch that may wedge
        trace.mark("chunk_dispatch", batch=len(reqs), bucket=pixels.shape[0])
        # requeue budget: one hop per lane the fleet started with, plus one
        # for the degraded executor's fail-fast answer
        hops_left = self.lanes() + 1
        while True:
            try:
                mask_b, conv_b = self._dispatch(pixels, dims, lane, trace)
                break
            except LaneQuarantined as q:
                hops_left -= 1
                if hops_left <= 0:
                    log.warning(
                        "serve chunk exhausted its requeue budget "
                        "(%d riders, last lane %d)", len(reqs), q.lane,
                    )
                    err = RuntimeError(
                        f"request dispatched {self.lanes() + 1} times "
                        f"({self.lanes()} re-dispatches) across quarantining "
                        "lanes without completing; the replica's lanes are "
                        "flapping (see serving_lane_quarantines_total)"
                    )
                    err.__cause__ = q
                    self._charge(reqs, pixels, trace)
                    for r in reqs:
                        r.fail(err)
                    return
                # no healthy lane left: any lane id reaches the degraded
                # executor, which fails the chunk at once
                healthy = [ln for ln in self.healthy_lanes() if ln != q.lane] or [0]
                next_lane = healthy[next(self._requeue_seq) % len(healthy)]
                if self.obs is not None:
                    self.obs.registry.counter(
                        SERVING_REQUEUES_TOTAL,
                        help="chunks re-dispatched off a quarantined lane",
                    ).inc()
                with trace.span(
                    "requeue", from_lane=q.lane, to_lane=next_lane, cause=q.cause,
                ):
                    for r in reqs:
                        r.requeues += 1
                trace.lane = next_lane
                lane = next_lane
            except BaseException as e:  # noqa: BLE001 — per-chunk containment
                # every rider of THIS chunk fails with the same cause; the
                # HTTP layer maps it to a 500 (a 504 for DeadlineExceeded).
                # Sibling chunks on other lanes are unaffected.
                log.warning(
                    "serve dispatch failed for %d request(s) on lane %d: %s",
                    len(reqs), lane, e,
                )
                self._charge(reqs, pixels, trace)
                for r in reqs:
                    r.fail(e)
                return
        with self._lock:
            key = str(lane)
            self._stats["lane_batches"][key] = self._stats["lane_batches"].get(key, 0) + 1
        # the rider's prorated device cost: its row share of the chunk's
        # device-busy seconds (every attempt)
        share = self._charge(reqs, pixels, trace)
        ledger = getattr(self.executor, "ledger", None)
        for i, r in enumerate(reqs):
            h, w = r.dims
            # nm03-lint: disable=NM322 mask_b/conv_b are host ndarrays (fetched under supervision in WarmExecutor.run_batch); no device sync happens here
            r.mask = np.asarray(mask_b[i][:h, :w])
            # nm03-lint: disable=NM322 host ndarray, see above
            r.converged = bool(conv_b[i])
            r.batch_size = len(reqs)
            r.lane = lane
            r.device_seconds = share
            if ledger is not None and not getattr(r, "probe", False):
                ledger.observe_request(share)
            r.done.set()

    def _charge(self, reqs, pixels, trace) -> float:
        """Prorate the chunk's device-busy seconds into the ledger; the
        per-row share (without a ledger, the plain share)."""
        busy = getattr(trace, "device_busy_s", 0.0)
        rows = int(pixels.shape[0])
        ledger = getattr(self.executor, "ledger", None)
        if ledger is None:
            return busy / rows
        probes = sum(1 for r in reqs if getattr(r, "probe", False))
        return ledger.charge_chunk(busy, rows, len(reqs) - probes, probe_rows=probes)

    def execute(self, reqs: List[ServeRequest]) -> None:
        """Run one coalesced window — fanned across lanes — and answer it."""
        now = time.monotonic()
        reg = self.obs.registry if self.obs is not None else None
        for r in reqs:
            r.queue_wait_s = max(now - r.t_admitted, 0.0)
            if r.trace is not None:
                # retrospective spans from the stamps the queue left:
                # admission -> pop (queue_wait), pop -> window close (coalesce)
                popped = r.t_popped or now
                r.trace.add_span("queue_wait", r.t_admitted, popped)
                r.trace.add_span("coalesce", popped, now)
        # the in-flight dedup window: identical content-addressed slices in
        # one window ride a SINGLE dispatch
        leaders: List[ServeRequest] = []
        dup_riders: dict = {}
        leader_by_digest: dict = {}
        for r in reqs:
            d = getattr(r, "digest", None)
            if d is None or getattr(r, "probe", False):
                leaders.append(r)
                continue
            if d in leader_by_digest:
                dup_riders.setdefault(d, []).append(r)
            else:
                leader_by_digest[d] = r
                leaders.append(r)
        targets = self.healthy_lanes()
        chunks = self._chunk(leaders, len(targets))
        sat = getattr(self.executor, "saturation", None)
        if sat is not None:
            # occupancy: the rows this window dispatched (deduplicated
            # riders are capacity headroom) against what the HEALTHY fleet
            # could carry
            sat.record_window(len(leaders), self.executor.max_batch * len(targets))
        if reg is not None:
            wait_h = reg.histogram(
                SERVING_QUEUE_WAIT_SECONDS,
                help="admission-to-dispatch wait per request",
                buckets=LATENCY_BUCKETS,
            )
            for r in reqs:
                # probe riders are served and traced but never observed
                if not getattr(r, "probe", False):
                    wait_h.observe(r.queue_wait_s)
            reg.histogram(
                SERVING_BATCH_SIZE,
                help="coalesced (pre-padding) batch sizes",
                buckets=BATCH_SIZE_BUCKETS,
            ).observe(len(leaders))
            reg.counter(
                SERVING_BATCHES_TOTAL,
                help="device batches dispatched by the serving batcher",
            ).inc(len(chunks))
        # chunk ci rides HEALTHY lane targets[ci % len(targets)]
        assign = [targets[ci % len(targets)] for ci in range(len(chunks))]
        with self._lock:
            self._stats["batches"] += len(chunks)
            self._stats["requests"] += len(reqs)
            self._stats["max_coalesced"] = max(self._stats["max_coalesced"], len(reqs))
        if len(chunks) == 1:
            self._execute_chunk(chunks[0], assign[0])
        else:
            with self._lock:
                if self._pool is None:
                    # sized to the FULL fleet: reinstated lanes must not
                    # queue behind a pool sized during a quarantine dip
                    self._pool = cf.ThreadPoolExecutor(
                        max_workers=self.lanes(),
                        thread_name_prefix="nm03-serve-lane",
                    )
                pool = self._pool
            futures = [
                pool.submit(self._execute_chunk, chunk, assign[ci])
                for ci, chunk in enumerate(chunks)
            ]
            for f in futures:
                # nm03-lint: disable=NM422 the barrier IS the gang contract: gang_parked() must not return lanes until every in-flight chunk lands (_execute_chunk never raises)
                f.result()
        if dup_riders:
            self._fan_out_duplicates(leader_by_digest, dup_riders, reg)

    def _fan_out_duplicates(self, leader_by_digest, dup_riders, reg) -> None:
        """Answer dedup riders from their leader's result (after the
        window's dispatch barrier): its mask, verdict or error, and zero
        device-seconds of their own."""
        hit = None
        if reg is not None:
            hit = reg.counter(
                SERVING_RESULT_CACHE_HIT_TOTAL,
                help="result-tier lookups served from cache, by tier",
                tier="inflight",
            )
        ledger = getattr(self.executor, "ledger", None)
        for d, riders in dup_riders.items():
            leader = leader_by_digest[d]
            for r in riders:
                if leader.error is not None:
                    r.fail(leader.error)
                    continue
                r.mask = leader.mask
                r.converged = leader.converged
                r.batch_size = leader.batch_size
                r.lane = leader.lane
                r.requeues = leader.requeues
                r.device_seconds = 0.0
                if ledger is not None and not getattr(r, "probe", False):
                    ledger.observe_request(0.0)  # the dedup win, charged nothing
                if hit is not None:
                    hit.inc()
                r.done.set()
