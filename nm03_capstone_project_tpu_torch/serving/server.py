"""The online segmentation service: HTTP front end + lifecycle.

The port's counterpart of the JAX package's ``nm03-serve``::

    python -m nm03_capstone_project_tpu_torch.serving.server [--port N]

* ``POST /v1/segment`` — one slice in (a DICOM body, or a raw float32
  array described by ``X-Nm03-Height``/``X-Nm03-Width``), segmentation
  out: the JSON envelope of ``nm03-serve`` (shape, ``grow_converged``,
  ``mask_pixels``, ``mask_sha256`` with the result tier on, and the JPEG
  pair unless ``?output=mask``), with the result tier's ``ETag`` and
  ``If-None-Match`` 304s;
* ``POST /v1/segment-volume`` (with ``--volume-serving``) — one whole
  study in (a raw float32 (depth, height, width) stack described by
  ``X-Nm03-Depth/Height/Width``, a multi-frame ``application/dicom`` file,
  or ``application/x-nm03-dicom-parts``), the full uint8 mask volume out
  (``?output=mask|summary|mhd``), through the volume gang
  (:mod:`~.volumes`): its own queue, the batcher's gang gate, a z-mesh of
  the healthy lanes' devices. Identical in-flight studies and ``X-Nm03-Idempotency-Key``
  retries ride one dispatch (:mod:`~..cache.inflight`);
* ``GET /healthz`` — liveness;
* ``GET /readyz`` — readiness: 200 while warm, admitting and at least one
  lane healthy; 503 before warmup, while draining, and while every lane is
  quarantined (``degraded: true``, until the probe reinstates one). The
  body has the JAX package's key set: ``saturation`` (lane busy
  fractions, MFU and its peak, padding waste, window occupancy),
  ``ledger`` (device seconds by account, the sampled stage pie, each
  bucket's graph bytes) and ``slo`` (burn rates and budget, null without
  an objective) are refreshed on every probe; ``compile_hub`` names where
  each kernel library came from (``cache``, ``built`` or ``local``), its
  build and load seconds, the cache's counts under ``--compile-cache-dir``
  and each (lane, bucket) graph's capture seconds, ``cuda_graphs`` holds
  each bucket's capture seconds and replays, and ``volumes`` the gang's
  shape;
* ``GET /metrics`` (Prometheus text) and ``GET /metrics.json`` (the
  ``nm03.metrics.v1`` snapshot), the saturation, ledger and SLO gauges
  refreshed on every scrape and once more at drain;
* ``GET /debug/flightrec`` (the flight recorder's rings), ``GET
  /debug/profile?ms=N`` (a zipped ``torch.profiler`` Chrome trace; 409
  while another capture, such as the ledger's sampler, holds the
  profiler), ``GET /debug/result-cache`` (the result tier's entries) and
  ``POST /debug/result-cache/evict[?digest=D]``.

``--compile-cache-dir`` (or ``$NM03_COMPILE_CACHE_DIR``; the flag wins)
loads the three kernel libraries, verified, from an operator's directory
instead of running ``nvcc`` at warmup, and publishes those that had to be
built there (:mod:`..compilehub`); the ``compile_cache_*`` series appear
exactly when a cache is attached.

``--fault-plan`` (or ``NM03_FAULT_PLAN``) arms the seeded chaos plan of
:mod:`..resilience.faultinject` at the ``dispatch`` site (every lane's
supervised dispatch), the ``volume`` site (the gang), the result tier's
``cache``/``corrupt_entry`` site and the compile cache's
``cache``/``io_error`` site (an entry's publish aborted). ``--slo-availability`` /
``--slo-p99-ms`` declare an objective (:mod:`..obs.slo`), and
``--ledger-profile-interval-s`` turns on the ledger's profiler sampler
(off by default: the profiler slows eager launches).

On the card, warmup captures one CUDA graph per batch bucket
(:mod:`~.graphs`) before the listener starts, and every device batch is a
graph replay; then the volume gang runs each depth bucket once, eagerly
(its 3D growth syncs the host once a block, which a graph cannot hold). The server runs on ``cuda`` unless ``--device cpu`` asks for
the plain ops on the CPU; without a GPU and without that flag it exits
non-zero. There is no CPU fallback.

Stdlib HTTP (``ThreadingHTTPServer``): one thread per connection does the
decode, render and encode host work; device dispatch goes through the one
batcher thread. SIGTERM drains: admissions stop (503 + ``Retry-After``),
the batcher finishes every admitted batch, metrics and events flush, and
then the listener exits.
"""

from __future__ import annotations

import argparse
import base64
import errno
import hashlib
import json
import os
import signal
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import numpy as np

from nm03_capstone_project_tpu_torch.cache import (
    InflightIndex,
    ResultStore,
    etag_matches,
    parse_bytes,
    result_key,
    result_version,
)
from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.obs.ledger import DeviceTimeLedger, ProfileSampler
from nm03_capstone_project_tpu_torch.obs.saturation import SaturationMonitor
from nm03_capstone_project_tpu_torch.obs.slo import add_slo_args, objective_from_args
from nm03_capstone_project_tpu_torch.obs.trace import (
    SERVE_TRACE_EVENT,
    TraceContext,
    new_trace_id,
    sanitize_trace_id,
)
from nm03_capstone_project_tpu_torch.serving.batcher import DynamicBatcher
from nm03_capstone_project_tpu_torch.serving.executor import (
    DEFAULT_BUCKETS,
    DEFAULT_LANE_PROBE_INTERVAL_S,
    WarmExecutor,
)
from nm03_capstone_project_tpu_torch.serving.metrics import (
    COMPILE_CACHE_HITS_TOTAL,
    COMPILE_CACHE_LOAD_SECONDS,
    COMPILE_CACHE_MISSES_TOTAL,
    LATENCY_BUCKETS,
    SERVING_DEGRADED,
    SERVING_INFLIGHT,
    SERVING_READY,
    SERVING_REQUEST_SECONDS,
    SERVING_REQUESTS_TOTAL,
    SERVING_RESULT_CACHE_BYTES,
    SERVING_RESULT_CACHE_EVICT_TOTAL,
    SERVING_RESULT_CACHE_FILL_TOTAL,
    SERVING_RESULT_CACHE_HIT_TOTAL,
    SERVING_RESULT_CACHE_MISS_TOTAL,
    SERVING_SHED_TOTAL,
    SERVING_VOLUME_GANG_WAIT_SECONDS,
    SERVING_VOLUME_REQUESTS_TOTAL,
    SERVING_VOLUME_ZSHARDS,
)
from nm03_capstone_project_tpu_torch.serving.queue import (
    AdmissionQueue,
    QueueClosed,
    QueueFull,
    ServeRequest,
)
from nm03_capstone_project_tpu_torch.serving.volumes import (
    DEFAULT_VOLUME_DEPTH_BUCKETS,
    GangUnavailable,
    VolumeGang,
)
from nm03_capstone_project_tpu_torch.utils.exitcodes import ADDRESS_IN_USE_EXIT
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("serving")

# a cross-process volume request waits this much past --volume-timeout-s:
# the gang's own bound ends a stuck study at the timeout, with a 503 that
# must reach the client before the wait's 504 would
GANG_BOUND_SLACK_S = 2.0

RETRY_AFTER_S = 1  # the shed hint: capacity problems clear in ~one window

# the response fields a result entry stores: everything derived from the
# INPUT (and so covered by the content-addressed key), nothing
# per-execution — what keeps the ETag stable across evict/recompute, and
# equal to the JAX package's for equal results
_CACHEABLE_SEGMENT_FIELDS = (
    "shape",
    "grow_converged",
    "mask_pixels",
    "mask_sha256",
    "original_jpeg_b64",
    "processed_jpeg_b64",
)
_CACHEABLE_VOLUME_FIELDS = (
    "shape",
    "grow_converged",
    "mask_voxels",
    "mask_sha256",
    "mask_b64",
    "mhd_header_b64",
    "mhd_data_b64",
    "mhd_data_file",
)


def _cache_fault_hook(fault_plan, obs):
    """The compile cache's chaos hook (site ``cache``/``io_error``), or None.

    Fired with the entry's filename between the write of its tmp file and
    the rename that publishes it; a firing rule aborts the publish: the
    drill that proves a failed store leaves the process serving from its
    own build, a miss counted, and a tmp file for ``gc``, never a torn
    entry.
    """
    if fault_plan is None or not fault_plan.has_site("cache"):
        return None
    from nm03_capstone_project_tpu_torch.resilience import InjectedExportError

    def hook(entry_name: str) -> None:
        if fault_plan.fire("cache", obs=obs, stem=entry_name, kinds=("io_error",)) is not None:
            raise InjectedExportError(f"injected compile-cache io error ({entry_name})")

    return hook


def _result_corrupt_hook(fault_plan, obs):
    """The result store's chaos hook (site ``cache``/``corrupt_entry``).

    Consulted by ``ResultStore.lookup`` with the result-key digest; a
    firing rule hands the verifier a payload with one flipped byte: the
    drill that proves verify-on-read evicts and recomputes, so a corrupt
    entry is a miss, never a wrong mask.
    """
    if fault_plan is None or not fault_plan.has_site("cache"):
        return None

    def hook(digest: str) -> bool:
        return fault_plan.fire(
            "cache", obs=obs, stem=digest, kinds=("corrupt_entry",)
        ) is not None

    return hook


class RequestRejected(ValueError):
    """A request refused before admission; carries the HTTP status."""

    def __init__(self, http_status: int, message: str):
        super().__init__(message)
        self.http_status = http_status


class ServingApp:
    """Everything behind the HTTP handler: queue, batcher, executor, state.

    ``lane_devices`` (no CLI flag) hands the executor an explicit lane
    list, which may repeat a device: four CPU lanes in the tests, four
    lanes on one card in ``chip_smoke.py``; the volume gang's z-mesh spans
    them.
    """

    def __init__(
        self,
        cfg: PipelineConfig = None,
        queue_capacity: int = 64,
        buckets=DEFAULT_BUCKETS,
        max_wait_s: float = 0.01,
        request_timeout_s: float = 60.0,
        jpeg_quality: int = 90,
        resilience=None,
        obs=None,
        lanes: Optional[int] = None,
        lane_probe_interval_s: Optional[float] = None,
        lane_devices=None,
        result_cache_bytes: int = 0,
        device=None,
        volume_serving: bool = False,
        volume_depth_buckets=None,
        volume_queue_capacity: int = 4,
        volume_timeout_s: float = 300.0,
        fault_plan=None,
        slo=None,
        ledger_profile_interval_s: float = 0.0,
        ledger_profile_ms: int = 200,
        distributed_init: bool = False,
        compile_cache_dir: Optional[str] = None,
    ):
        from nm03_capstone_project_tpu_torch.obs import RunContext

        self.cfg = cfg if cfg is not None else PipelineConfig()
        self.obs = obs if obs is not None else RunContext.create(driver="serve")
        # efficiency telemetry (obs.saturation): lane busy/idle, padding
        # waste, occupancy and MFU over a sliding window, fed by the
        # executor and the batcher, pull-refreshed on every scrape
        self.saturation = SaturationMonitor(registry=self.obs.registry)
        # the device-time ledger (obs.ledger): per-request cost, the
        # sampled stage pie, each bucket's graph bytes. The sampler takes
        # short profiler captures on a cadence (0 = off) and never queues
        # behind a GET /debug/profile pull: it skips and counts
        self.ledger = DeviceTimeLedger(registry=self.obs.registry)
        self._ledger_sampler = ProfileSampler(
            self.ledger,
            interval_s=float(ledger_profile_interval_s),
            duration_ms=int(ledger_profile_ms),
        )
        # the SLO plane (obs.slo): only with a declared objective
        self.slo = None
        if slo is not None:
            from nm03_capstone_project_tpu_torch.obs.slo import SLOMonitor

            self.slo = SLOMonitor(
                self.obs.registry, slo, SERVING_REQUESTS_TOTAL, SERVING_REQUEST_SECONDS,
            )
        self.fault_plan = fault_plan
        # resolves the device: no GPU and no device="cpu" raises here
        self.executor = WarmExecutor(
            self.cfg,
            buckets=tuple(buckets),
            resilience=resilience,
            obs=self.obs,
            lanes=lanes,
            lane_probe_interval_s=(
                lane_probe_interval_s
                if lane_probe_interval_s is not None
                else DEFAULT_LANE_PROBE_INTERVAL_S
            ),
            device=device,
            fault_plan=fault_plan,
            saturation=self.saturation,
            ledger=self.ledger,
            lane_devices=lane_devices,
        )
        # the replica identity block: id is per-incarnation
        self.replica_identity = {
            "id": uuid.uuid4().hex[:12],
            "pid": os.getpid(),
            "start_unix": round(time.time(), 3),
        }
        self.queue = AdmissionQueue(queue_capacity)
        self.batcher = DynamicBatcher(
            self.queue,
            self.executor,
            max_wait_s=max_wait_s,
            obs=self.obs,
        )
        # whole-volume serving (opt-in): the gang lane behind
        # POST /v1/segment-volume, warmed after the executor's graphs
        self.volumes = None
        self.volume_timeout_s = float(volume_timeout_s)
        if volume_serving:
            self.volumes = VolumeGang(
                self.cfg,
                self.executor,
                self.batcher,
                queue_capacity=volume_queue_capacity,
                depth_buckets=(
                    tuple(volume_depth_buckets)
                    if volume_depth_buckets
                    else DEFAULT_VOLUME_DEPTH_BUCKETS
                ),
                fault_plan=fault_plan,
                obs=self.obs,
                distributed=distributed_init,
                bound_s=self.volume_timeout_s,
            )
        # the content-addressed result tier: a replica-side store in front
        # of the batcher, bounded by bytes (0 = disabled). The in-flight
        # index exists whenever the tier does: it lets an identical volume
        # or an idempotent retry ride a running gang dispatch
        self.result_store = None
        self.volume_inflight = None
        if result_cache_bytes and int(result_cache_bytes) > 0:
            self.result_store = ResultStore(
                int(result_cache_bytes),
                corrupt_hook=_result_corrupt_hook(fault_plan, self.obs),
                on_evict=self._on_result_evict,
            )
            self.volume_inflight = InflightIndex()
            self._publish_result_bytes()
        # the program-identity half of every result key (the port's
        # toolchain and this config), fixed for the process's lifetime
        self._rv_value = result_version(self.cfg)
        self.request_timeout_s = float(request_timeout_s)
        self.jpeg_quality = int(jpeg_quality)
        self.draining = False
        self._drain_lock = threading.Lock()
        self._drained = threading.Event()
        self._t0 = time.monotonic()
        self.registry = self.obs.registry
        self._attached_cache = None
        if compile_cache_dir:
            # attached last (after every fallible construction above, so a
            # raising __init__ cannot leave its fault hook on the process)
            # and before warmup, whose captures load the libraries
            from nm03_capstone_project_tpu_torch.compilehub import KernelCache
            from nm03_capstone_project_tpu_torch.kernels import build

            try:
                self._attached_cache = KernelCache(
                    compile_cache_dir, fault_hook=_cache_fault_hook(fault_plan, self.obs))
            except OSError as e:
                # an optimization, never a crash loop: one replica with a
                # bad mount builds privately and serves
                log.warning("compile cache dir %s unusable (%s); building the kernel "
                            "libraries privately", compile_cache_dir, e)
                build.attach_cache(None, private=True)
            else:
                build.attach_cache(self._attached_cache)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> dict:
        """Capture every bucket's graph, warm the volume gang, start the
        batcher; the timings (the gang's under ``"volume"``)."""
        timings = self.executor.warmup()
        if self.volumes is not None:
            # after every graph is captured: no gang work during a capture
            timings["volume"] = self.volumes.warmup()
            self.volumes.start()
            self.registry.gauge(
                SERVING_VOLUME_ZSHARDS,
                help="z-shards the last served volume spanned (the gang's z-mesh width)",
            ).set(self.volumes.z_shards)
        self.batcher.start()
        self.registry.gauge(SERVING_READY, help="1 = warmed and admitting, 0 otherwise").set(1)
        # warmup filled the ledger's HBM table and kernel sequences: publish
        # the per-bucket gauges now, then start the sampler (no-op at 0)
        self.ledger.publish()
        self._publish_compile_cache()
        self._ledger_sampler.start()
        self.obs.events.emit(
            "serving_ready",
            buckets=list(self.executor.buckets),
            lanes=self.executor.lane_count,
            warmup_s=timings,
        )
        return timings

    def _publish_compile_cache(self) -> None:
        """The cache's counts after warmup, zeros included, exactly when this
        app attached a cache (read from its own cache object), so a cold
        start (hits 0) is told apart from a run without the cache."""
        if self._attached_cache is None:
            return
        stats = self._attached_cache.readyz_stats()
        self.registry.counter(
            COMPILE_CACHE_HITS_TOTAL,
            help="kernel libraries loaded, verified, from --compile-cache-dir "
            "instead of built",
        ).inc(stats["cache_hits"])
        self.registry.counter(
            COMPILE_CACHE_MISSES_TOTAL,
            help="compile-cache lookups that fell through to an nvcc build "
            "(absent, stale, torn or corrupt entries)",
        ).inc(stats["cache_misses"])
        self.registry.gauge(
            COMPILE_CACHE_LOAD_SECONDS,
            help="total seconds reading and checking cache entries: what the "
            "warm start paid instead of nvcc",
        ).set(stats["cache_load_seconds"])

    def compile_hub(self) -> dict:
        """The ``/readyz`` ``compile_hub`` block: each kernel library's source
        (``cache``, ``built`` or ``local``) with its build and load seconds,
        the cache's counts when one is attached, and each (lane, bucket)
        graph's capture seconds in the place of the JAX per-spec
        ``compile_seconds``."""
        from nm03_capstone_project_tpu_torch.kernels import build

        libs = build.records()
        graphs = self.executor.graph_stats()["lanes"]
        out = {
            "libraries": libs,
            "builds": sum(1 for r in libs.values() if r["build_s"] is not None),
            "cache_loads": sum(1 for r in libs.values() if r["source"] == "cache"),
            # summed over libraries that compile in parallel, as the JAX
            # hub sums its specs
            "total_compile_seconds": round(
                sum(r["build_s"] or 0.0 for r in libs.values()), 4),
            "cache_dir": (
                str(self._attached_cache.root) if self._attached_cache is not None else None
            ),
            "capture_seconds": {
                f"lane{lane}/bucket{b}": g.get("capture_s")
                for lane, per in graphs.items() for b, g in per.items()
            },
        }
        if self._attached_cache is not None:
            out.update(self._attached_cache.readyz_stats())
        return out

    @property
    def ready(self) -> bool:
        """Warm, admitting, and not degraded (at least one lane healthy)."""
        return self.executor.warm and not self.draining and not self.executor.degraded

    def status(self) -> dict:
        lane_count = self.executor.lane_count
        hub = self.compile_hub()
        return {
            "ready": self.ready,
            # who is answering, and what its warmup loaded from the cache
            # (None without one): the rolling restart's report keys on it
            "replica": {**self.replica_identity, "compile_cache_hits": hub.get("cache_hits")},
            "warm": self.executor.warm,
            "draining": self.draining,
            "degraded": self.executor.degraded,
            "degraded_cause": self.executor.degraded_cause,
            "queue_depth": len(self.queue),
            "queue_capacity": self.queue.capacity,
            # the request-size guards a canary must fit inside
            "canvas": self.cfg.canvas,
            "min_dim": self.cfg.min_dim,
            "buckets": list(self.executor.buckets),
            "batcher": self.batcher.stats(),
            "lanes": {
                "count": lane_count,
                "ready": self.executor.lanes_ready,
                "quarantined": self.executor.quarantined_count,
                "per_lane": self.executor.lane_state(),
            },
            "capacity": self.executor.capacity,
            "mesh_shape": [lane_count] if lane_count else None,
            "volumes": (
                self.volumes.status() if self.volumes is not None else {"enabled": False}
            ),
            # program_version is published even with the tier off: it is
            # the replica's result-key identity
            "result_cache": {
                "program_version": self._rv_value if self.executor.warm else None,
                **(
                    {**self.result_store.stats(), "inflight": self.volume_inflight.stats()}
                    if self.result_store is not None
                    else {"enabled": False}
                ),
            },
            # each bucket's CUDA graph: capture seconds, replays, kernels
            "cuda_graphs": self.executor.graph_stats(),
            "compile_hub": hub,
            # publish() also refreshes the gauges, so a probe and a scrape
            # can never disagree
            "saturation": self.saturation.publish(),
            "ledger": self.ledger.publish(),
            "slo": self.slo.publish() if self.slo is not None else None,
            "clock": {
                "mono_s": round(time.monotonic(), 6),
                "ts_unix": round(time.time(), 6),
            },
            "uptime_s": round(time.monotonic() - self._t0, 3),
        }

    def begin_drain(self, reason: str = "sigterm", timeout_s: float = 120.0) -> bool:
        """Stop admissions, finish in-flight work, flush telemetry.

        Idempotent; safe from a signal-spawned thread. Returns True when
        the batcher fully drained inside ``timeout_s``.
        """
        with self._drain_lock:
            if self.draining:
                return self._drained.wait(timeout=timeout_s)
            self.draining = True
        self.registry.gauge(SERVING_READY, help="1 = warmed and admitting, 0 otherwise").set(0)
        self.obs.events.emit(
            "serving_drain", level="WARNING", reason=reason, queue_depth=len(self.queue),
        )
        self.queue.close()
        if self.volumes is not None:
            # the same contract for the gang: admitted studies finish
            self.volumes.queue.close()
        drained = self.batcher.join(timeout_s=timeout_s)
        if not drained:
            # a wedged drain still must answer whoever is parked on wait()
            for r in self.queue.drain_pending():
                r.fail(RuntimeError("server drain timed out"))
            log.warning("drain: batcher did not finish inside %.0fs", timeout_s)
        if self.volumes is not None:
            gang_drained = self.volumes.join(timeout_s=timeout_s)
            if not gang_drained:
                for r in self.volumes.queue.drain_pending():
                    r.fail(RuntimeError("server drain timed out"))
                log.warning("drain: volume gang did not finish inside %.0fs", timeout_s)
            drained = drained and gang_drained
        # final gauge refresh BEFORE the snapshot flush: the --metrics-out
        # artifact carries the run's last window, accounts, pie and verdict
        try:
            self.saturation.publish()
        except Exception as e:  # noqa: BLE001 — telemetry never blocks a drain
            log.warning("drain: saturation publish failed: %s", e)
        try:
            self._ledger_sampler.stop()  # a capture mid-drain would race teardown
            self.ledger.publish()
        except Exception as e:  # noqa: BLE001 — telemetry never blocks a drain
            log.warning("drain: ledger publish failed: %s", e)
        if self.slo is not None:
            try:
                self.slo.publish()
            except Exception as e:  # noqa: BLE001 — telemetry never blocks a drain
                log.warning("drain: SLO publish failed: %s", e)
        try:
            self.obs.write_metrics()
        except Exception as e:  # noqa: BLE001 — telemetry never blocks a drain
            log.warning("drain: metrics flush failed: %s", e)
        self._drained.set()
        return drained

    def close(self, status: str = "ok") -> None:
        cache, self._attached_cache = self._attached_cache, None
        if cache is not None:
            # detach OUR cache (and its fault hook, which closes over this
            # app's obs): a later app in this process starts clean.
            # Identity-checked: a cache attached after ours is not ours
            from nm03_capstone_project_tpu_torch.kernels import build

            if build.attached_cache() is cache:
                build.attach_cache(None)
        if self.volumes is not None:
            self.volumes.close()  # a cross-process gang's followers stop
        self.executor.close()
        self.obs.close(status=status)

    def refresh_gauges(self) -> None:
        """Pull-refresh the sliding-window, ledger and SLO gauges (every
        scrape: the window slides whether or not traffic arrives)."""
        self.saturation.publish()
        self.ledger.publish()
        if self.slo is not None:
            self.slo.publish()

    # -- request plumbing (HTTP-free, directly testable) -------------------

    def _count_request(self, status: str) -> None:
        self.registry.counter(
            SERVING_REQUESTS_TOTAL,
            help="terminal serving request outcomes by status",
            status=status,
        ).inc()

    def _observe_latency(self, t_start: float) -> None:
        self.registry.histogram(
            SERVING_REQUEST_SECONDS,
            help="end-to-end request latency (admission to payload built)",
            buckets=LATENCY_BUCKETS,
        ).observe(time.monotonic() - t_start)

    # -- the result tier (HTTP-free) ----------------------------------------

    def _on_result_evict(self, n: int) -> None:
        # fired from inside the store's lock: a counter bump only
        self.registry.counter(
            SERVING_RESULT_CACHE_EVICT_TOTAL,
            help="result-tier entries evicted by tier (LRU pressure, "
            "explicit evict, or a failed verify-on-read)",
            tier="replica",
        ).inc(n)

    def _publish_result_bytes(self) -> None:
        if self.result_store is not None:
            self.obs.registry.gauge(
                SERVING_RESULT_CACHE_BYTES,
                help="resident bytes in the replica result store",
            ).set(self.result_store.bytes)

    def result_digest(self, body: bytes, algo: str, params: dict):
        """ResultKey digest for one request body, or None (tier off)."""
        if self.result_store is None:
            return None
        return result_key(body, algo, params, self._rv_value).digest()

    def result_lookup(self, digest: str):
        """Replica-tier store lookup + hit/miss accounting."""
        entry = self.result_store.lookup(digest)
        hit = entry is not None
        self.registry.counter(
            SERVING_RESULT_CACHE_HIT_TOTAL if hit else SERVING_RESULT_CACHE_MISS_TOTAL,
            help="result-tier lookups served from cache, by tier" if hit
            else "result-tier lookups that fell through to compute, by tier",
            tier="replica",
        ).inc()
        return entry

    def result_fill(self, digest: str, payload: dict, algo: str, fields):
        """Store the cacheable subset of ``payload``; ('fill'|'miss', etag).

        'miss' is the honest ``X-Nm03-Cache`` value for computed-but-not-
        stored (an oversize payload).
        """
        stored = {k: payload[k] for k in fields if k in payload}
        raw = json.dumps(stored, sort_keys=True).encode()
        entry, created = self.result_store.fill(digest, raw, algo)
        if entry is None:
            return "miss", None
        if created:
            self.registry.counter(
                SERVING_RESULT_CACHE_FILL_TOTAL,
                help="computed results stored into the tier, by tier",
                tier="replica",
            ).inc()
            self._publish_result_bytes()
        return "fill", entry.etag

    def _payload_from_entry(self, entry, trace_id, volume: bool = False):
        """A served-from-store response: stored fields + fresh identity;
        batch 0, lane None, z_shards 0 and 0.0 device seconds for work the
        card never saw."""
        payload = dict(json.loads(entry.payload.decode()))
        payload.update(
            request_id=uuid.uuid4().hex[:12],
            trace_id=trace_id,
            queue_wait_s=0.0,
            requeues=0,
            device_seconds=0.0,
            cached=True,
        )
        if volume:
            payload.update(z_shards=0, gang_wait_s=0.0)
        else:
            payload.update(batch_size=0, lane=None, degraded=self.executor.degraded)
        return payload

    def _account_cached_hit(self, trace_id, request_id, t_start: float,
                            volume: bool = False) -> None:
        """A hit is a served request: counted and traced."""
        self.obs.events.emit(
            SERVE_TRACE_EVENT,
            trace_id=trace_id,
            request_id=request_id,
            lane=None,
            batch_size=0,
            queue_wait_s=0.0,
            probe=False,
            cached=True,
            spans=[],
            **({"volume": True, "z_shards": 0} if volume else {}),
        )
        if volume:
            self._count_volume_request("ok")
        else:
            self._observe_latency(t_start)
            self._count_request("ok")

    def segment_cached(
        self,
        body: bytes,
        pixels: np.ndarray,
        render: bool = True,
        trace_id: Optional[str] = None,
        probe: bool = False,
        if_none_match: Optional[str] = None,
    ):
        """:meth:`segment` behind the result tier; (payload, state, etag).

        ``state`` None = tier off or probe traffic (plain compute path);
        'hit' with payload None = 304 Not Modified; 'fill' = computed and
        stored; 'miss' = computed, not stored. Probes bypass the tier.
        """
        params = {"render": bool(render)}
        if render:
            params["jpeg_quality"] = self.jpeg_quality
        digest = None if probe else self.result_digest(body, "segment", params)
        if digest is None:
            return self.segment(pixels, render=render, trace_id=trace_id, probe=probe), None, None
        t_start = time.monotonic()
        entry = self.result_lookup(digest)
        if entry is not None:
            if etag_matches(if_none_match, entry.etag):
                self._account_cached_hit(trace_id, uuid.uuid4().hex[:12], t_start)
                return None, "hit", entry.etag
            payload = self._payload_from_entry(entry, trace_id)
            self._account_cached_hit(trace_id, payload["request_id"], t_start)
            return payload, "hit", entry.etag
        payload = self.segment(
            pixels, render=render, trace_id=trace_id, probe=probe, digest=digest,
        )
        state, etag = self.result_fill(digest, payload, "segment", _CACHEABLE_SEGMENT_FIELDS)
        return payload, state, etag

    def segment_volume_cached(
        self,
        body: bytes,
        volume: np.ndarray,
        trace_id: Optional[str] = None,
        mhd: bool = False,
        mhd_compressed: bool = False,
        include_mask: bool = True,
        if_none_match: Optional[str] = None,
        idempotency_key: Optional[str] = None,
    ):
        """:meth:`segment_volume` behind the tier; (payload, state, etag).

        The idempotency contract (``X-Nm03-Idempotency-Key``): the key is an
        alias for the first content digest it arrived with, kept in a map
        that outlives the in-flight window, so a retry either coalesces onto
        the still-running gang or finds the stored result ('hit' both ways);
        a study is never dispatched twice for a retry.
        """
        output = "mhd" if mhd else ("mask" if include_mask else "summary")
        params = {"output": output, "compressed": bool(mhd_compressed)}
        digest = self.result_digest(body, "segment-volume", params)
        if digest is None:
            return (
                self.segment_volume(
                    volume, trace_id=trace_id, mhd=mhd,
                    mhd_compressed=mhd_compressed, include_mask=include_mask,
                ),
                None,
                None,
            )
        alias = f"idem:{idempotency_key}" if idempotency_key else None
        lookup_digest = digest
        if alias is not None:
            aliased = self.volume_inflight.resolve(alias)
            if aliased is not None:
                lookup_digest = aliased
        t_start = time.monotonic()
        entry = self.result_lookup(lookup_digest)
        if entry is not None:
            if etag_matches(if_none_match, entry.etag):
                self._account_cached_hit(trace_id, uuid.uuid4().hex[:12], t_start, volume=True)
                return None, "hit", entry.etag
            payload = self._payload_from_entry(entry, trace_id, volume=True)
            self._account_cached_hit(trace_id, payload["request_id"], t_start, volume=True)
            return payload, "hit", entry.etag
        payload = self.segment_volume(
            volume, trace_id=trace_id, mhd=mhd, mhd_compressed=mhd_compressed,
            include_mask=include_mask, digest=digest, idem_alias=alias,
        )
        if payload.pop("_coalesced", False):
            # rode an in-flight gang: the leader's own fill stores the result
            return payload, "hit", None
        state, etag = self.result_fill(
            digest, payload, "segment-volume", _CACHEABLE_VOLUME_FIELDS
        )
        return payload, state, etag

    def _join_volume_leader(self, leader, trace_id, include_mask, mhd, mhd_compressed) -> dict:
        """Ride an identical in-flight volume: wait on its gang dispatch and
        answer from its mask, so both responses are built from one array.
        A rider shares the leader's error."""
        self.registry.counter(
            SERVING_RESULT_CACHE_HIT_TOTAL,
            help="result-tier lookups served from cache, by tier",
            tier="inflight",
        ).inc()
        inflight = self.registry.gauge(SERVING_INFLIGHT, help="admitted requests not yet responded")
        inflight.inc()
        try:
            if not leader.wait(self._volume_wait_s()):
                self._count_volume_request("timeout")
                raise TimeoutError(
                    f"coalesced volume request (leader {leader.request_id}) "
                    f"timed out after {self.volume_timeout_s:.0f}s"
                )
            if leader.error is not None:
                self._count_volume_request(
                    "shed" if isinstance(leader.error, GangUnavailable) else "error"
                )
                raise leader.error
        finally:
            inflight.dec()
        payload = {
            "request_id": uuid.uuid4().hex[:12],
            "trace_id": trace_id,
            "z_shards": leader.z_shards,
            "gang_wait_s": 0.0,
            "queue_wait_s": 0.0,
            "requeues": leader.requeues,
            "grow_converged": leader.converged,
            "cached": True,
            "_coalesced": True,
        }
        payload.update(self._volume_payload(leader.mask, include_mask, mhd, mhd_compressed))
        self._count_volume_request("ok")
        return payload

    def decode_request(self, body: bytes, content_type: str) -> np.ndarray:
        """Body -> float32 (h, w) raw-intensity slice, or RequestRejected.

        ``application/dicom`` bodies go through the port's DICOM reader
        (``data/dicomlite.py::read_dicom_bytes``); anything else is refused
        (raw bodies are described by X-Nm03-Height/Width instead).
        """
        ct = (content_type or "").split(";")[0].strip().lower()
        if ct == "application/dicom":
            from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom_bytes

            try:
                return np.asarray(read_dicom_bytes(body).pixels, np.float32)
            except Exception as e:  # noqa: BLE001 — parser rejection -> 400
                raise RequestRejected(400, f"DICOM parse failed: {e}") from e
        raise RequestRejected(
            415,
            f"unsupported content type {ct!r} (want application/dicom or "
            "application/octet-stream with X-Nm03-Height/X-Nm03-Width)",
        )

    def decode_raw(self, body: bytes, height: int, width: int) -> np.ndarray:
        expected = height * width * 4
        if len(body) != expected:
            raise RequestRejected(
                400,
                f"raw body is {len(body)} bytes; {height}x{width} float32 needs {expected}",
            )
        return np.frombuffer(body, dtype="<f4").reshape(height, width).astype(np.float32)

    def guard_pixels(self, pixels: np.ndarray) -> Tuple[int, int]:
        h, w = int(pixels.shape[0]), int(pixels.shape[1])
        if h < self.cfg.min_dim or w < self.cfg.min_dim:
            raise RequestRejected(
                400, f"image {w}x{h} below the minimum dimension {self.cfg.min_dim}"
            )
        if h > self.cfg.canvas or w > self.cfg.canvas:
            raise RequestRejected(
                413,
                f"image {w}x{h} exceeds the serving canvas {self.cfg.canvas} "
                "(start the server with a larger --canvas)",
            )
        return h, w

    def submit(
        self, pixels: np.ndarray, trace_id: Optional[str] = None,
        probe: bool = False, digest: Optional[str] = None,
    ) -> ServeRequest:
        """Admit one decoded slice; QueueFull/QueueClosed shed at the door."""
        h, w = self.guard_pixels(pixels)
        req = ServeRequest(
            request_id=uuid.uuid4().hex[:12],
            pixels=pixels,
            dims=(h, w),
            trace=TraceContext(trace_id or new_trace_id()),
            probe=bool(probe),
            digest=digest,
        )
        self.queue.put(req)  # raises QueueFull / QueueClosed
        self.registry.gauge(SERVING_INFLIGHT, help="admitted requests not yet responded").inc()
        return req

    def segment(
        self,
        pixels: np.ndarray,
        render: bool = True,
        trace_id: Optional[str] = None,
        probe: bool = False,
        digest: Optional[str] = None,
    ) -> dict:
        """The full request path minus HTTP: admit, wait, build the payload.

        Raises RequestRejected (guards), QueueFull/QueueClosed (shed),
        TimeoutError, or the dispatch's error as-is (``DeadlineExceeded``
        once every lane is quarantined). Always settles the inflight gauge
        and the status counter; a ``probe`` request counts under
        ``status="probe"`` and is kept out of the latency histogram.
        """

        def status_class(s: str) -> str:
            return "probe" if probe else s

        t_start = time.monotonic()
        try:
            req = self.submit(pixels, trace_id=trace_id, probe=probe, digest=digest)
        except (QueueFull, QueueClosed):
            if not probe:
                self.registry.counter(
                    SERVING_SHED_TOTAL,
                    help="admissions refused by backpressure (full or draining)",
                ).inc()
            self._count_request(status_class("shed"))
            raise
        except RequestRejected:
            self._count_request(status_class("invalid"))
            raise
        try:
            if not req.wait(self.request_timeout_s):
                self._count_request(status_class("timeout"))
                raise TimeoutError(
                    f"request {req.request_id} timed out after {self.request_timeout_s:.0f}s"
                )
            if req.error is not None:
                self._count_request(status_class("error"))
                raise req.error
        finally:
            self.registry.gauge(
                SERVING_INFLIGHT, help="admitted requests not yet responded"
            ).dec()
        payload = {
            "request_id": req.request_id,
            "trace_id": req.trace_id,
            "shape": [req.dims[0], req.dims[1]],
            "grow_converged": req.converged,
            "batch_size": req.batch_size,
            "queue_wait_s": round(req.queue_wait_s, 6),
            "lane": req.lane,
            # >0: the rider's chunk outlived a lane quarantine (re-dispatch)
            "requeues": req.requeues,
            # this request's row share of its batch's device-busy seconds
            "device_seconds": round(req.device_seconds, 9),
            "degraded": self.executor.degraded,
            "mask_pixels": int(np.count_nonzero(req.mask)),
        }
        if self.result_store is not None and not probe:
            payload["mask_sha256"] = hashlib.sha256(
                np.ascontiguousarray(req.mask).tobytes()
            ).hexdigest()
            payload["cached"] = False
        if render:
            from nm03_capstone_project_tpu_torch.render.export import encode_jpeg_bytes
            from nm03_capstone_project_tpu_torch.render.host_render import host_render_pair

            dims = np.asarray(req.dims, np.int32)
            with req.trace.span("encode"):
                gray, seg = host_render_pair(pixels, req.mask, dims, self.cfg)
                payload["original_jpeg_b64"] = base64.b64encode(
                    encode_jpeg_bytes(gray, self.jpeg_quality)
                ).decode("ascii")
                payload["processed_jpeg_b64"] = base64.b64encode(
                    encode_jpeg_bytes(seg, self.jpeg_quality)
                ).decode("ascii")
        self.obs.events.emit(
            SERVE_TRACE_EVENT,
            trace_id=req.trace_id,
            request_id=req.request_id,
            lane=req.lane,
            batch_size=req.batch_size,
            queue_wait_s=round(req.queue_wait_s, 6),
            probe=probe,
            spans=req.trace.snapshot(),
        )
        if not probe:
            self._observe_latency(t_start)
        self._count_request(status_class("ok"))
        self.registry.gauge(
            SERVING_DEGRADED, help="1 = every lane quarantined: requests fail fast"
        ).set(1 if self.executor.degraded else 0)
        return payload

    # -- whole-volume request plumbing (HTTP-free) --------------------------

    def _count_volume_request(self, status: str) -> None:
        self.registry.counter(
            SERVING_VOLUME_REQUESTS_TOTAL,
            help="terminal whole-volume request outcomes by status "
            "(POST /v1/segment-volume)",
            status=status,
        ).inc()

    def decode_volume_raw(self, body: bytes, depth: int, height: int, width: int) -> np.ndarray:
        """Raw stacked study: little-endian float32 (depth, height, width)."""
        if depth < 1:
            raise RequestRejected(400, f"depth must be >= 1, got {depth}")
        expected = depth * height * width * 4
        if len(body) != expected:
            raise RequestRejected(
                400,
                f"raw volume body is {len(body)} bytes; "
                f"{depth}x{height}x{width} float32 needs {expected}",
            )
        return np.frombuffer(body, dtype="<f4").reshape(depth, height, width).astype(np.float32)

    def decode_volume_dicom(self, body: bytes, content_type: str) -> np.ndarray:
        """DICOM study body -> (depth, h, w) float32 stack.

        ``application/dicom`` is ONE Part-10 file whose frames are the
        planes (``data/dicomlite.py::read_dicom_frames``, strict);
        ``application/x-nm03-dicom-parts`` is the concatenated form, each
        part a 4-byte little-endian length and one Part-10 file. Every
        plane must decode and share one in-plane size: a partial volume is
        never served.
        """
        import tempfile

        from nm03_capstone_project_tpu_torch.data.dicomlite import (
            read_dicom_bytes,
            read_dicom_frames,
        )

        ct = (content_type or "").split(";")[0].strip().lower()
        planes: list = []
        try:
            if ct == "application/x-nm03-dicom-parts":
                off = 0
                while off < len(body):
                    if off + 4 > len(body):
                        raise ValueError("truncated part length prefix")
                    n = int.from_bytes(body[off:off + 4], "little")
                    off += 4
                    if n <= 0 or off + n > len(body):
                        raise ValueError(f"part length {n} overruns the body")
                    planes.append(
                        np.asarray(read_dicom_bytes(body[off:off + n]).pixels, np.float32)
                    )
                    off += n
                if not planes:
                    raise ValueError("no DICOM parts in body")
            else:  # application/dicom: one (possibly multi-frame) file
                with tempfile.NamedTemporaryFile(suffix=".dcm") as f:
                    f.write(body)
                    f.flush()
                    slices = read_dicom_frames(f.name, strict=True)
                planes = [np.asarray(s.pixels, np.float32) for s in slices]
        except Exception as e:  # noqa: BLE001 — parser rejection -> 400
            raise RequestRejected(400, f"DICOM study parse failed: {e}") from e
        if not planes:
            raise RequestRejected(400, "DICOM study contains no image planes")
        hw = planes[0].shape
        if any(p.shape != hw for p in planes):
            raise RequestRejected(
                400,
                "study planes disagree on in-plane size "
                f"({sorted({p.shape for p in planes})})",
            )
        return np.stack(planes)

    def _volume_wait_s(self) -> float:
        """How long a volume request waits for its study: the volume
        timeout, and for a cross-process gang GANG_BOUND_SLACK_S more, since
        the gang itself ends a study at that bound (503, the gang down)."""
        in_job = self.volumes is not None and self.volumes.in_job
        return self.volume_timeout_s + (GANG_BOUND_SLACK_S if in_job else 0.0)

    def guard_volume(self, volume: np.ndarray) -> Tuple[int, int, int]:
        """Admission guards for one decoded study; (depth, h, w)."""
        if self.volumes is None:
            raise RequestRejected(
                404,
                "volume serving is not enabled on this replica "
                "(start nm03-serve with --volume-serving)",
            )
        d = int(volume.shape[0])
        h, w = self.guard_pixels(volume[0])
        if d > self.volumes.max_depth:
            raise RequestRejected(
                413,
                f"study of {d} planes exceeds the largest volume depth "
                f"bucket {self.volumes.max_depth} (start the server with "
                "deeper --volume-depth-buckets)",
            )
        return d, h, w

    def segment_volume(
        self,
        volume: np.ndarray,
        trace_id: Optional[str] = None,
        mhd: bool = False,
        mhd_compressed: bool = False,
        include_mask: bool = True,
        digest: Optional[str] = None,
        idem_alias: Optional[str] = None,
    ) -> dict:
        """The whole-volume request path minus HTTP.

        Admit to the gang's own queue, wait for its dispatch, build the
        payload carrying the full mask volume (base64 raw uint8, C order)
        and, with ``mhd``, the MetaImage pair the volume driver's
        ``--export-mhd`` writes. Raises RequestRejected (guards),
        QueueFull/QueueClosed (the volume queue's shed), GangUnavailable (no
        healthy lane), TimeoutError, or the dispatch's own error. Counts
        every outcome under ``serving_volume_requests_total``.
        """
        try:
            _, h, w = self.guard_volume(volume)
        except RequestRejected:
            self._count_volume_request("invalid")
            raise
        if digest is not None and self.volume_inflight is not None:
            # an identical volume already riding the gang answers this one
            leader = self.volume_inflight.claim(digest)
            if leader is not None:
                return self._join_volume_leader(leader, trace_id, include_mask, mhd,
                                                mhd_compressed)
        try:
            req = self.volumes.submit(volume, (h, w), trace_id=trace_id)
        except (QueueFull, QueueClosed):
            self.registry.counter(
                SERVING_SHED_TOTAL,
                help="admissions refused by backpressure (full or draining)",
            ).inc()
            self._count_volume_request("shed")
            raise
        except ValueError as e:  # the gang's own depth guard
            self._count_volume_request("invalid")
            raise RequestRejected(413, str(e)) from e
        registered = False
        if digest is not None and self.volume_inflight is not None:
            # first wins: a duplicate that registered between our claim and
            # here keeps the slot, and ours computes (the fill is idempotent)
            registered = self.volume_inflight.register(digest, req, alias=idem_alias) is req
        inflight = self.registry.gauge(SERVING_INFLIGHT, help="admitted requests not yet responded")
        inflight.inc()
        try:
            if not req.wait(self._volume_wait_s()):
                self._count_volume_request("timeout")
                raise TimeoutError(
                    f"volume request {req.request_id} timed out after "
                    f"{self.volume_timeout_s:.0f}s"
                )
            if req.error is not None:
                self._count_volume_request(
                    "shed" if isinstance(req.error, GangUnavailable) else "error"
                )
                raise req.error
        finally:
            if registered:
                # release only after done is set: a rider that claimed us
                # meanwhile finds the event fired
                self.volume_inflight.release(digest)
            inflight.dec()
        payload = {
            "request_id": req.request_id,
            "trace_id": req.trace_id,
            "z_shards": req.z_shards,
            "gang_wait_s": round(req.gang_wait_s, 6),
            "queue_wait_s": round(req.queue_wait_s, 6),
            # >0: the study was re-dispatched off a dead lane
            "requeues": req.requeues,
            "grow_converged": req.converged,
        }
        if self.result_store is not None:
            payload["cached"] = False
        with req.trace.span("encode"):
            payload.update(self._volume_payload(req.mask, include_mask, mhd, mhd_compressed))
        self.obs.events.emit(
            SERVE_TRACE_EVENT,
            trace_id=req.trace_id,
            request_id=req.request_id,
            lane=req.lane,
            batch_size=1,
            queue_wait_s=round(req.queue_wait_s, 6),
            probe=False,
            volume=True,
            z_shards=req.z_shards,
            spans=req.trace.snapshot(),
        )
        self.registry.gauge(
            SERVING_VOLUME_GANG_WAIT_SECONDS,
            help="gang wait of the last served volume: how long it waited for "
            "the slice batcher to park",
        ).set(round(req.gang_wait_s, 6))
        self.registry.gauge(
            SERVING_VOLUME_ZSHARDS,
            help="z-shards the last served volume spanned (the gang's z-mesh width)",
        ).set(req.z_shards)
        self._count_volume_request("ok")
        return payload

    def _volume_payload(self, mask: np.ndarray, include_mask: bool, mhd: bool,
                        mhd_compressed: bool) -> dict:
        """The fields a volume response derives from its (d, h, w) mask:
        ``shape``, ``mask_voxels``, ``mask_sha256`` with the result tier on,
        ``mask_b64`` (raw uint8, C order) and, with ``mhd``, the MetaImage
        pair."""
        mask = np.ascontiguousarray(mask)
        out = {
            "shape": [int(s) for s in mask.shape],
            "mask_voxels": int(np.count_nonzero(mask)),
        }
        if self.result_store is not None:
            out["mask_sha256"] = hashlib.sha256(mask.tobytes()).hexdigest()
        if include_mask:
            out["mask_b64"] = base64.b64encode(mask.tobytes()).decode("ascii")
        if mhd:
            out.update(self._mhd_payload(mask, mhd_compressed))
        return out

    def _mhd_payload(self, mask: np.ndarray, compressed: bool) -> dict:
        """The volume driver's ``--export-mhd`` pair, base64 over the wire."""
        import tempfile
        from pathlib import Path

        from nm03_capstone_project_tpu_torch.data.imageio import write_metaimage

        with tempfile.TemporaryDirectory() as td:
            write_metaimage(mask, Path(td) / "mask.mhd", compressed=compressed)
            header = (Path(td) / "mask.mhd").read_bytes()
            data_name = "mask.zraw" if compressed else "mask.raw"
            data = (Path(td) / data_name).read_bytes()
        return {
            "mhd_header_b64": base64.b64encode(header).decode("ascii"),
            "mhd_data_b64": base64.b64encode(data).decode("ascii"),
            "mhd_data_file": data_name,
        }


# -- the HTTP layer ---------------------------------------------------------


def make_handler(app: ServingApp):
    class Handler(BaseHTTPRequestHandler):
        server_version = "nm03-serve-torch/1.0"
        protocol_version = "HTTP/1.1"

        # per-request chatter to the package logger at DEBUG, not stderr
        def log_message(self, fmt, *args):  # noqa: A003
            log.debug("%s %s", self.address_string(), fmt % args)

        def _reply(self, status: int, body: dict, headers=()):
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _reply_not_modified(self, headers=()):
            # 304 carries no body (RFC 7232); the ETag rides along
            self.send_response(304)
            self.send_header("Content-Length", "0")
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()

        def _reply_text(self, status: int, text: str, content_type: str):
            data = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            path = urlsplit(self.path).path
            if path == "/healthz":
                self._reply(
                    200,
                    {"status": "alive", "uptime_s": round(time.monotonic() - app._t0, 3)},
                )
            elif path == "/readyz":
                st = app.status()
                self._reply(200 if st["ready"] else 503, st)
            elif path == "/metrics":
                app.refresh_gauges()
                self._reply_text(
                    200, app.registry.to_prometheus(), "text/plain; version=0.0.4"
                )
            elif path == "/metrics.json":
                app.refresh_gauges()
                self._reply_text(
                    200, json.dumps(app.obs.metrics_snapshot(), indent=1), "application/json"
                )
            elif path == "/debug/flightrec":
                # the flight recorder's rings over HTTP: a post-mortem
                # without shell access
                from nm03_capstone_project_tpu_torch.obs import flightrec

                snap = flightrec.get_recorder().snapshot(reason="debug_pull")
                self._reply_text(200, json.dumps(snap, default=str), "application/json")
            elif path == "/debug/profile":
                self._debug_profile()
            elif path == "/debug/result-cache":
                # the result tier's admin surface; {"enabled": false} when off
                if app.result_store is None:
                    self._reply(200, {"enabled": False})
                else:
                    self._reply(200, {
                        **app.result_store.stats(),
                        "program_version": app._rv_value if app.executor.warm else None,
                        "inflight": app.volume_inflight.stats(),
                        "ls": app.result_store.ls(),
                    })
            else:
                self._reply(404, {"error": f"unknown path {path}"})

        def _debug_profile(self):
            """``GET /debug/profile?ms=N``: an on-demand ``torch.profiler``
            capture (400 outside [10, 10000] ms) as a zipped Chrome trace,
            through the one profiler lock the ledger's sampler takes too
            (409 + ``Retry-After`` while it is held)."""
            from nm03_capstone_project_tpu_torch.utils.profiling import (
                ProfileBusy,
                capture_profile,
            )

            query = parse_qs(urlsplit(self.path).query)
            try:
                ms = int(query.get("ms", ["500"])[0])
            except ValueError:
                self._reply(400, {"error": "ms must be an integer"})
                return
            try:
                result = capture_profile(ms)
            except ProfileBusy as e:
                self._reply(409, {"error": str(e)}, headers=[("Retry-After", "1")])
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — profiler unavailable
                log.warning("debug profile capture failed: %s", e)
                self._reply(500, {"error": str(e), "error_class": type(e).__name__})
            else:
                self._reply(200, result)

        def do_POST(self):  # noqa: N802
            split = urlsplit(self.path)
            if split.path == "/v1/segment-volume":
                self._post_volume(split)
                return
            if split.path == "/debug/result-cache/evict":
                # admin evict (?digest=D for one entry, none for all)
                if app.result_store is None:
                    self._reply(404, {"error": "result tier not enabled"})
                    return
                digest = parse_qs(split.query).get("digest", [None])[0]
                dropped = app.result_store.evict(digest)
                app._publish_result_bytes()
                self._reply(200, {"evicted": dropped})
                return
            if split.path != "/v1/segment":
                self._reply(404, {"error": f"unknown path {split.path}"})
                return
            query = parse_qs(split.query)
            render = query.get("output", ["jpeg"])[0] != "mask"
            # request-scoped trace identity, echoed on EVERY response
            trace_id = sanitize_trace_id(self.headers.get("X-Nm03-Request-Id")) or new_trace_id()
            echo = [("X-Nm03-Request-Id", trace_id)]
            # a probation canary: served and traced, kept out of the
            # request metrics
            is_probe = self.headers.get("X-Nm03-Probe") == "1"
            # decode phase: every rejection here is counted "invalid" once
            try:
                length = int(self.headers.get("Content-Length", 0))
                cap = app.cfg.canvas * app.cfg.canvas * 4 + 65536
                if length <= 0:
                    raise RequestRejected(400, "empty body")
                if length > cap:
                    raise RequestRejected(413, f"body of {length} bytes exceeds the {cap} cap")
                body = self.rfile.read(length)
                h_hdr = self.headers.get("X-Nm03-Height")
                w_hdr = self.headers.get("X-Nm03-Width")
                if h_hdr is not None and w_hdr is not None:
                    pixels = app.decode_raw(body, int(h_hdr), int(w_hdr))
                else:
                    pixels = app.decode_request(body, self.headers.get("Content-Type", ""))
            except RequestRejected as e:
                app._count_request("probe" if is_probe else "invalid")
                self._reply(e.http_status, {"error": str(e)}, headers=echo)
                return
            except (ValueError, OverflowError) as e:  # bad int headers etc.
                app._count_request("probe" if is_probe else "invalid")
                self._reply(400, {"error": str(e)}, headers=echo)
                return
            try:
                payload, cache_state, etag = app.segment_cached(
                    body, pixels, render=render, trace_id=trace_id, probe=is_probe,
                    if_none_match=self.headers.get("If-None-Match"),
                )
            except RequestRejected as e:  # guard failures (counted inside)
                self._reply(e.http_status, {"error": str(e)}, headers=echo)
            except (QueueFull, QueueClosed) as e:
                self._reply(
                    503,
                    {"error": str(e), "draining": app.draining},
                    headers=[("Retry-After", str(RETRY_AFTER_S)), *echo],
                )
            except TimeoutError as e:  # a request timeout, or DeadlineExceeded
                self._reply(504, {"error": str(e), "error_class": type(e).__name__},
                            headers=echo)
            except Exception as e:  # noqa: BLE001 — per-request containment
                log.warning("request failed: %s", e)
                self._reply(
                    500, {"error": str(e), "error_class": type(e).__name__}, headers=echo,
                )
            else:
                cache_headers = []
                if cache_state is not None:
                    cache_headers.append(("X-Nm03-Cache", cache_state))
                if etag is not None:
                    cache_headers.append(("ETag", etag))
                if payload is None:  # If-None-Match matched: 304, no body
                    self._reply_not_modified(headers=[*cache_headers, *echo])
                    return
                self._reply(
                    200,
                    payload,
                    headers=[
                        ("X-Nm03-Batch-Size", str(payload["batch_size"])),
                        ("X-Nm03-Request-Id", payload["trace_id"]),
                        ("X-Nm03-Lane", str(payload["lane"])),
                        ("X-Nm03-Queue-Wait-Ms", f"{payload['queue_wait_s'] * 1e3:.3f}"),
                        *cache_headers,
                    ],
                )

        def _post_volume(self, split):
            """``POST /v1/segment-volume``: one whole study in, the full mask
            volume out, through the volume gang."""
            query = parse_qs(split.query)
            output = query.get("output", ["mask"])[0]
            trace_id = sanitize_trace_id(self.headers.get("X-Nm03-Request-Id")) or new_trace_id()
            echo = [("X-Nm03-Request-Id", trace_id)]
            try:
                length = int(self.headers.get("Content-Length", 0))
                max_depth = app.volumes.max_depth if app.volumes is not None else 1
                cap = max_depth * app.cfg.canvas * app.cfg.canvas * 4 + 65536
                if length <= 0:
                    raise RequestRejected(400, "empty body")
                if length > cap:
                    raise RequestRejected(
                        413, f"body of {length} bytes exceeds the {cap} volume cap"
                    )
                body = self.rfile.read(length)
                d_hdr = self.headers.get("X-Nm03-Depth")
                h_hdr = self.headers.get("X-Nm03-Height")
                w_hdr = self.headers.get("X-Nm03-Width")
                if d_hdr is not None and h_hdr is not None and w_hdr is not None:
                    volume = app.decode_volume_raw(body, int(d_hdr), int(h_hdr), int(w_hdr))
                else:
                    volume = app.decode_volume_dicom(body, self.headers.get("Content-Type", ""))
            except RequestRejected as e:
                app._count_volume_request("invalid")
                self._reply(e.http_status, {"error": str(e)}, headers=echo)
                return
            except (ValueError, OverflowError) as e:  # bad int headers etc.
                app._count_volume_request("invalid")
                self._reply(400, {"error": str(e)}, headers=echo)
                return
            try:
                payload, cache_state, etag = app.segment_volume_cached(
                    body,
                    volume,
                    trace_id=trace_id,
                    mhd=output == "mhd",
                    mhd_compressed=query.get("compressed", ["0"])[0] == "1",
                    include_mask=output != "summary",
                    if_none_match=self.headers.get("If-None-Match"),
                    idempotency_key=self.headers.get("X-Nm03-Idempotency-Key"),
                )
            except RequestRejected as e:  # guards (counted inside)
                self._reply(e.http_status, {"error": str(e)}, headers=echo)
            except (QueueFull, QueueClosed, GangUnavailable) as e:
                # the volume queue's backpressure, and no healthy lane: the
                # client retries; a mask is never guessed
                self._reply(
                    503,
                    {"error": str(e), "draining": app.draining},
                    headers=[("Retry-After", str(RETRY_AFTER_S)), *echo],
                )
            except TimeoutError as e:
                self._reply(504, {"error": str(e)}, headers=echo)
            except Exception as e:  # noqa: BLE001 — per-request containment
                log.warning("volume request failed: %s", e)
                self._reply(
                    500, {"error": str(e), "error_class": type(e).__name__}, headers=echo,
                )
            else:
                cache_headers = []
                if cache_state is not None:
                    cache_headers.append(("X-Nm03-Cache", cache_state))
                if etag is not None:
                    cache_headers.append(("ETag", etag))
                if payload is None:  # If-None-Match matched: 304, no body
                    self._reply_not_modified(headers=[*cache_headers, *echo])
                    return
                self._reply(
                    200,
                    payload,
                    headers=[
                        ("X-Nm03-Request-Id", payload["trace_id"]),
                        ("X-Nm03-Z-Shards", str(payload["z_shards"])),
                        ("X-Nm03-Gang-Wait-Ms", f"{payload['gang_wait_s'] * 1e3:.3f}"),
                        *cache_headers,
                    ],
                )

    return Handler


def make_http_server(app: ServingApp, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral); ``.server_address`` carries the real port."""
    httpd = ThreadingHTTPServer((host, port), make_handler(app))
    httpd.daemon_threads = True
    return httpd


def serve_in_thread(app: ServingApp, host: str = "127.0.0.1", port: int = 0):
    """Bind, warm (capture the graphs), then serve on a daemon thread;
    ``(httpd, thread, port)``. Warmup runs before the listener thread
    starts, so no handler touches CUDA during a capture."""
    httpd = make_http_server(app, host, port)
    app.start()
    t = threading.Thread(target=httpd.serve_forever, name="nm03-serve-http", daemon=True)
    t.start()
    return httpd, t, httpd.server_address[1]


# -- CLI ---------------------------------------------------------------------

# flags of the JAX package's nm03-serve whose layers the port does not have
# (yet), each with the reason it is refused
NOT_PORTED = {
    "--fallback-cpu": "the port has no CPU fallback",
    "--no-fallback-cpu": "the port has no CPU fallback; it always fails fast",
}


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string}: {NOT_PORTED[option_string]}")


def build_parser() -> argparse.ArgumentParser:
    from nm03_capstone_project_tpu_torch.cli import common
    from nm03_capstone_project_tpu_torch.resilience import ResilienceConfig

    p = argparse.ArgumentParser(
        prog="python -m nm03_capstone_project_tpu_torch.serving.server",
        description=__doc__.strip().splitlines()[0],
    )
    g = p.add_argument_group("serving", "online service knobs")
    g.add_argument("--host", default="127.0.0.1", help="bind address")
    g.add_argument("--port", type=int, default=8077, help="bind port (0 = ephemeral)")
    g.add_argument(
        "--port-file", default=None, metavar="PATH",
        help="write the bound port here once listening (written atomically)",
    )
    g.add_argument(
        "--queue-capacity", type=int, default=64,
        help="bounded admission queue; past this, requests shed with 503 + Retry-After",
    )
    g.add_argument(
        "--max-wait-ms", type=float, default=10.0,
        help="dynamic-batching window: how long the first request of a batch "
        "waits for riders",
    )
    g.add_argument(
        "--buckets", default=",".join(str(b) for b in DEFAULT_BUCKETS),
        help="comma list of warm batch-size buckets (one CUDA graph each; a "
        "coalesced batch pads to the smallest that fits)",
    )
    g.add_argument(
        "--lanes", type=int, default=0, metavar="N",
        help="replica lanes (CUDA devices) to serve across (0 = every visible device)",
    )
    g.add_argument(
        "--request-timeout-s", type=float, default=60.0,
        help="per-request wall budget from admission to response",
    )
    g.add_argument(
        "--lane-probe-interval-s", type=float, default=None, metavar="S",
        help="probation probe cadence for quarantined lanes (default 5s)",
    )
    g.add_argument(
        "--compile-cache-dir", default=None, metavar="DIR",
        help="persistent cache of the kernel libraries: warmup loads each one, "
        "verified, from here instead of running nvcc, and publishes those it had "
        "to build (default: $NM03_COMPILE_CACHE_DIR; unset = build beside the "
        "package; `python -m nm03_capstone_project_tpu_torch.compilehub.cache_cli` "
        "for ls/verify/gc)",
    )
    g.add_argument(
        "--result-cache-bytes", default="0", metavar="BYTES",
        help="content-addressed result tier budget (k/m/g suffixes; 0 disables)",
    )
    g.add_argument("--jpeg-quality", type=int, default=90, help="JPEG encoder quality")
    g.add_argument(
        "--volume-serving", action="store_true",
        help="serve POST /v1/segment-volume: whole studies in one request through "
        "the volume gang, z-sharded over the healthy lanes; warmup runs each depth "
        "bucket once",
    )
    g.add_argument(
        "--volume-depth-buckets", default=None, metavar="D1,D2,...",
        help="comma list of warm volume depth buckets (a study pads to the smallest "
        "that fits; default 8,16,32); the largest is the served depth cap",
    )
    g.add_argument(
        "--volume-queue-capacity", type=int, default=4,
        help="bounded volume admission queue, apart from the slice queue, so bulk "
        "volumes shed on their own capacity",
    )
    g.add_argument(
        "--volume-timeout-s", type=float, default=300.0,
        help="per-volume wall budget from admission to response",
    )
    g.add_argument(
        "--distributed-init", action="store_true",
        help="join a torch.distributed job before any backend work (torchrun's "
        "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK; nccl on the card, gloo with "
        "--device cpu), so the volume gang's z-mesh spans the job's ranks, one "
        "device a rank: rank 0 serves HTTP and the gang, the other ranks follow "
        "its dispatches (needs --volume-serving in a job of several processes); "
        "outside a job a no-op",
    )
    g.add_argument(
        "--flight-dir", default=None, metavar="DIR",
        help="flight-recorder dump directory (default: $NM03_FLIGHTREC_DIR or the cwd)",
    )
    g.add_argument("--verbose", action="store_true", help="enable INFO logging")
    common.add_device_arg(p)
    common.add_pipeline_args(p)
    d = ResilienceConfig()
    r = p.add_argument_group("resilience", "supervised dispatch")
    r.add_argument("--retry-max", type=int, default=d.retry_max,
                   help="retries per transient device error (0 disables)")
    r.add_argument("--retry-backoff-s", type=float, default=d.retry_backoff_s,
                   help="initial retry backoff; doubles per attempt")
    r.add_argument(
        "--dispatch-timeout-s", type=float, default=d.dispatch_timeout_s, metavar="SEC",
        help="wall-clock deadline per device batch (0 disables supervision); on "
        "expiry the lane is quarantined",
    )
    r.add_argument(
        "--fault-plan", default=None, metavar="SPEC",
        help="seeded deterministic fault plan: a JSON file path or inline JSON "
        "(resilience.faultinject), also honoured from $NM03_FAULT_PLAN; chaos "
        "drills only (dispatch, volume, cache/corrupt_entry and cache/io_error "
        "sites)",
    )
    o = p.add_argument_group("observability", "structured run telemetry")
    add_slo_args(o)
    o.add_argument(
        "--ledger-profile-interval-s", type=float, default=0.0, metavar="S",
        help="device-time ledger sampling cadence: every S seconds a short "
        "profiler capture is reduced into the serving_device_time_share{stage} "
        "pie; 0 (the default: the profiler slows eager launches) disables the "
        "sampler, per-request device-seconds attribution still runs",
    )
    o.add_argument(
        "--ledger-profile-ms", type=int, default=200, metavar="MS",
        help="duration of each ledger profile capture (short: the sampler shares "
        "the one-capture-at-a-time profiler lock with GET /debug/profile)",
    )
    o.add_argument("--metrics-out", default=None, metavar="JSON",
                   help="write the metrics snapshot here at drain (nm03.metrics.v1)")
    o.add_argument("--log-json", default=None, metavar="JSONL",
                   help="write structured JSON-lines events here (nm03.events.v1)")
    o.add_argument("--heartbeat-s", type=float, default=30.0, metavar="SEC",
                   help="heartbeat event period for --log-json streams (0 disables)")
    o.add_argument(
        "--sanitize", action="store_true",
        help="the runtime twins of the port's lint rules (docs/STATIC_ANALYSIS_TORCH.md): "
        "every stage's f32 output held finite (a graph replay's flags checked at its "
        "fetch), an upload guard around each dispatch, and a recompile watchdog "
        "(captures and library loads after warmup) feeding pipeline_recompiles_total",
    )
    for flag in NOT_PORTED:
        p.add_argument(flag, nargs="?", action=_NotPorted, help=argparse.SUPPRESS)
    return p


def app_from_args(args: argparse.Namespace, obs=None) -> ServingApp:
    from nm03_capstone_project_tpu_torch.cli import common
    from nm03_capstone_project_tpu_torch.compilehub import cache_dir_from_env
    from nm03_capstone_project_tpu_torch.resilience import FaultPlan, ResilienceConfig

    plan = FaultPlan.from_spec(args.fault_plan) or FaultPlan.from_env()
    buckets = tuple(int(b) for b in str(args.buckets).split(",") if b.strip())
    volume_buckets = None
    if args.volume_depth_buckets:
        volume_buckets = tuple(
            int(b) for b in str(args.volume_depth_buckets).split(",") if b.strip()
        )
    return ServingApp(
        cfg=common.pipeline_config_from_args(args),
        queue_capacity=args.queue_capacity,
        buckets=buckets,
        max_wait_s=args.max_wait_ms / 1000.0,
        request_timeout_s=args.request_timeout_s,
        jpeg_quality=args.jpeg_quality,
        resilience=ResilienceConfig(
            retry_max=args.retry_max,
            retry_backoff_s=args.retry_backoff_s,
            dispatch_timeout_s=args.dispatch_timeout_s,
        ),
        obs=obs,
        lanes=args.lanes or None,
        lane_probe_interval_s=args.lane_probe_interval_s,
        result_cache_bytes=parse_bytes(args.result_cache_bytes or "0"),
        device=args.device,
        volume_serving=args.volume_serving,
        volume_depth_buckets=volume_buckets,
        volume_queue_capacity=args.volume_queue_capacity,
        volume_timeout_s=args.volume_timeout_s,
        fault_plan=plan,
        slo=objective_from_args(args),
        ledger_profile_interval_s=args.ledger_profile_interval_s,
        ledger_profile_ms=args.ledger_profile_ms,
        distributed_init=args.distributed_init,
        compile_cache_dir=args.compile_cache_dir or cache_dir_from_env(),
    )


def _join_job(args: argparse.Namespace):
    """``--distributed-init``: join the job before any backend work; None
    on rank 0 and outside a job, else a follower rank's exit code (it ran
    :func:`.follower.follow` in place of the server)."""
    from nm03_capstone_project_tpu_torch.cli import common
    from nm03_capstone_project_tpu_torch.parallel import distributed

    if not distributed.initialize(device=args.device):
        print("nm03-serve: --distributed-init: no job detected; serving alone",
              file=sys.stderr)
        return None
    world, rank = distributed.process_count(), distributed.process_index()
    if world > 1 and not args.volume_serving:
        distributed.shutdown()
        raise ValueError(f"--distributed-init in a job of {world} processes needs "
                         "--volume-serving: the other ranks serve only the volume gang")
    # every rank, in the same place: the studies' group, bounded by the timeout
    distributed.open_data_plane(args.volume_timeout_s)
    if rank == 0:
        return None
    from nm03_capstone_project_tpu_torch.serving.follower import follow

    print(f"nm03-serve: rank {rank} of {world} follows the volume gang", file=sys.stderr,
          flush=True)
    try:
        rc = follow(common.pipeline_config_from_args(args), bound_s=args.volume_timeout_s)
    finally:
        distributed.shutdown()
    print(f"nm03-serve: rank {rank} stopped with the gang", file=sys.stderr, flush=True)
    return rc


def _write_port_file(path: str, port: int) -> None:
    from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_text

    atomic_write_text(path, f"{port}\n")


def _relaunch_recipe(effective_argv, port: int):
    """The ``-m``-form argv a fleet orchestrator relaunches this server with.

    The BOUND port replaces whatever ``--port`` said (an ephemeral
    ``--port 0`` republished verbatim would relaunch the replica on another
    random port, where the orchestrator's warm-wait could never find it),
    and is added when the flag was defaulted.
    """
    argv = list(effective_argv)
    out = []
    i = 0
    saw_port = False
    while i < len(argv):
        arg = argv[i]
        if arg == "--port":
            out += ["--port", str(port)]
            saw_port = True
            i += 2
        elif arg.startswith("--port="):
            out.append(f"--port={port}")
            saw_port = True
            i += 1
        else:
            out.append(arg)
            i += 1
    if not saw_port:
        out += ["--port", str(port)]
    return [sys.executable, "-m", "nm03_capstone_project_tpu_torch.serving.server", *out]


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        objective_from_args(args)  # a bad --slo-* is a usage error, not a traceback
    except ValueError as e:
        parser.error(str(e))
    from nm03_capstone_project_tpu_torch.parallel import distributed
    from nm03_capstone_project_tpu_torch.utils.reporter import configure_reporting

    configure_reporting(verbose=args.verbose)
    # NM03_LOCKDEP=1: instrument every lock the app is ABOUT to create
    # (docs/STATIC_ANALYSIS_TORCH.md, the NM421/NM422 runtime twin) — before
    # any serving object exists, since only locks created after install are
    # wrapped; a no-op (nothing patched) without the variable
    from nm03_capstone_project_tpu_torch.utils import lockdep

    lockdep.install_from_env()
    if args.distributed_init:
        try:
            rc = _join_job(args)
        except (RuntimeError, ValueError) as e:
            print(f"nm03-serve: {e}", file=sys.stderr)
            return 1
        if rc is not None:  # a follower rank: it served the gang, not HTTP
            return rc
    try:
        return _serve(args, argv)
    finally:
        distributed.shutdown()  # a no-op outside a job
        if args.sanitize:
            from nm03_capstone_project_tpu_torch.utils import sanitize

            sanitize.disable()


def _serve(args: argparse.Namespace, argv) -> int:
    from nm03_capstone_project_tpu_torch.obs import RunContext, flightrec
    from nm03_capstone_project_tpu_torch.utils import sanitize

    run_ctx = RunContext.create(
        "serve",
        metrics_out=args.metrics_out,
        log_json=args.log_json,
        heartbeat_s=args.heartbeat_s or 0.0,
        argv=argv,
    )
    if args.sanitize:
        sanitize.enable(run_ctx.registry)
    try:
        app = app_from_args(args, obs=run_ctx)
        httpd = make_http_server(app, args.host, args.port)
    except (RuntimeError, ValueError, OSError) as e:
        print(f"nm03-serve: {e}", file=sys.stderr)
        run_ctx.close(status="error")
        # a held port has its own exit code: the fleet's restart relaunches on it
        return ADDRESS_IN_USE_EXIT if getattr(e, "errno", None) == errno.EADDRINUSE else 1
    port = httpd.server_address[1]
    # the relaunch recipe for the fleet's rolling restart: the flags this
    # process was started with (the bound port substituted) and the cwd
    # they resolve against, published on /readyz
    effective_argv = list(argv) if argv is not None else list(sys.argv[1:])
    app.replica_identity["relaunch_argv"] = _relaunch_recipe(effective_argv, port)
    app.replica_identity["cwd"] = os.getcwd()
    # arm the flight recorder (SIGUSR2, quarantine and crash dumps) once the
    # server exists, before warmup: a process that could not even build
    # its app leaves no dump behind
    flightrec.install(dump_dir=args.flight_dir)
    try:
        timings = app.start()
        sanitize.mark_warm()  # captures and loads from here on count
    except Exception as e:  # noqa: BLE001 — a failed warmup (capture) ends the process
        print(f"nm03-serve: warmup failed: {type(e).__name__}: {e}", file=sys.stderr)
        httpd.server_close()
        app.close(status="error")
        return 1
    if args.port_file:
        _write_port_file(args.port_file, port)
    print(
        f"nm03-serve: listening on {args.host}:{port} (device {app.executor.device}, "
        f"lanes {app.executor.lane_count}, buckets {list(app.executor.buckets)}, "
        f"warmup {timings})",
        flush=True,
    )

    def _drain_and_stop(signum, frame):
        # the handler must return fast; drain on a helper thread, then
        # stop the accept loop so serve_forever returns on the main thread
        def work():
            app.begin_drain(reason=signal.Signals(signum).name.lower())
            httpd.shutdown()

        threading.Thread(target=work, name="nm03-serve-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _drain_and_stop)
    signal.signal(signal.SIGINT, _drain_and_stop)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        app.begin_drain(reason="exit")  # idempotent; no-op after a signal drain
        app.close(status="ok")
    print("nm03-serve: drained and stopped", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
