"""The online segmentation service: HTTP front end + lifecycle.

The port's counterpart of the JAX package's ``nm03-serve``::

    python -m nm03_capstone_project_tpu_torch.serving.server [--port N]

* ``POST /v1/segment`` — one slice in (a DICOM body, or a raw float32
  array described by ``X-Nm03-Height``/``X-Nm03-Width``), segmentation
  out: the JSON envelope of ``nm03-serve`` (shape, ``grow_converged``,
  ``mask_pixels``, ``mask_sha256`` with the result tier on, and the JPEG
  pair unless ``?output=mask``), with the result tier's ``ETag`` and
  ``If-None-Match`` 304s;
* ``GET /healthz`` — liveness;
* ``GET /readyz`` — readiness: 200 while warm, admitting and at least one
  lane healthy; 503 before warmup, while draining, and once every lane is
  quarantined (``degraded: true``). The body has the JAX package's key set;
  the blocks of layers not ported yet (``saturation``, ``ledger``,
  ``slo``, ``compile_hub``) are null, and ``cuda_graphs`` holds each
  bucket's capture seconds and replays;
* ``GET /metrics`` (Prometheus text) and ``GET /metrics.json`` (the
  ``nm03.metrics.v1`` snapshot).

On the card, warmup captures one CUDA graph per batch bucket
(:mod:`~.graphs`) before the listener starts, and every device batch is a
graph replay. The server runs on ``cuda`` unless ``--device cpu`` asks for
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
    ResultStore,
    etag_matches,
    parse_bytes,
    result_key,
    result_version,
)
from nm03_capstone_project_tpu_torch.config import PipelineConfig
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
)
from nm03_capstone_project_tpu_torch.serving.queue import (
    AdmissionQueue,
    QueueClosed,
    QueueFull,
    ServeRequest,
)
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("serving")

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


class RequestRejected(ValueError):
    """A request refused before admission; carries the HTTP status."""

    def __init__(self, http_status: int, message: str):
        super().__init__(message)
        self.http_status = http_status


class ServingApp:
    """Everything behind the HTTP handler: queue, batcher, executor, state."""

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
        result_cache_bytes: int = 0,
        device=None,
    ):
        from nm03_capstone_project_tpu_torch.obs import RunContext

        self.cfg = cfg if cfg is not None else PipelineConfig()
        self.obs = obs if obs is not None else RunContext.create(driver="serve")
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
        # the content-addressed result tier: a replica-side store in front
        # of the batcher, bounded by bytes (0 = disabled)
        self.result_store = None
        if result_cache_bytes and int(result_cache_bytes) > 0:
            self.result_store = ResultStore(
                int(result_cache_bytes), on_evict=self._on_result_evict
            )
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

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> dict:
        """Capture every bucket's graph, start the batcher; the timings."""
        timings = self.executor.warmup()
        self.batcher.start()
        self.registry.gauge(SERVING_READY, help="1 = warmed and admitting, 0 otherwise").set(1)
        self.obs.events.emit(
            "serving_ready",
            buckets=list(self.executor.buckets),
            lanes=self.executor.lane_count,
            warmup_s=timings,
        )
        return timings

    @property
    def ready(self) -> bool:
        """Warm, admitting, and not degraded (at least one lane healthy)."""
        return self.executor.warm and not self.draining and not self.executor.degraded

    def status(self) -> dict:
        lane_count = self.executor.lane_count
        return {
            "ready": self.ready,
            "replica": {**self.replica_identity, "compile_cache_hits": None},
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
            "volumes": {"enabled": False},
            # program_version is published even with the tier off: it is
            # the replica's result-key identity
            "result_cache": {
                "program_version": self._rv_value if self.executor.warm else None,
                **(
                    self.result_store.stats()
                    if self.result_store is not None
                    else {"enabled": False}
                ),
            },
            # each bucket's CUDA graph: capture seconds, replays, kernels
            "cuda_graphs": self.executor.graph_stats(),
            # blocks of layers not ported yet
            "compile_hub": None,
            "saturation": None,
            "ledger": None,
            "slo": None,
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
        drained = self.batcher.join(timeout_s=timeout_s)
        if not drained:
            # a wedged drain still must answer whoever is parked on wait()
            for r in self.queue.drain_pending():
                r.fail(RuntimeError("server drain timed out"))
            log.warning("drain: batcher did not finish inside %.0fs", timeout_s)
        try:
            self.obs.write_metrics()
        except Exception as e:  # noqa: BLE001 — telemetry never blocks a drain
            log.warning("drain: metrics flush failed: %s", e)
        self._drained.set()
        return drained

    def close(self, status: str = "ok") -> None:
        self.obs.close(status=status)

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

    def _payload_from_entry(self, entry, trace_id):
        """A served-from-store response: stored fields + fresh identity;
        batch 0, lane None and 0.0 device seconds for work the card never
        saw."""
        payload = dict(json.loads(entry.payload.decode()))
        payload.update(
            request_id=uuid.uuid4().hex[:12],
            trace_id=trace_id,
            queue_wait_s=0.0,
            requeues=0,
            device_seconds=0.0,
            cached=True,
            batch_size=0,
            lane=None,
            degraded=self.executor.degraded,
        )
        return payload

    def _account_cached_hit(self, trace_id, request_id, t_start: float) -> None:
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
        )
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
                self._reply_text(
                    200, app.registry.to_prometheus(), "text/plain; version=0.0.4"
                )
            elif path == "/metrics.json":
                self._reply_text(
                    200, json.dumps(app.obs.metrics_snapshot(), indent=1), "application/json"
                )
            else:
                self._reply(404, {"error": f"unknown path {path}"})

        def do_POST(self):  # noqa: N802
            split = urlsplit(self.path)
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
    "--volume-serving": "volume serving is not ported yet (ROADMAP A5/A6)",
    "--volume-depth-buckets": "volume serving is not ported yet (ROADMAP A5/A6)",
    "--volume-queue-capacity": "volume serving is not ported yet (ROADMAP A5/A6)",
    "--volume-timeout-s": "volume serving is not ported yet (ROADMAP A5/A6)",
    "--distributed-init": "multi-process serving is not ported yet (ROADMAP A6)",
    "--compile-cache-dir": "an XLA executable cache has no counterpart in eager "
                           "PyTorch (warmup captures CUDA graphs instead)",
    "--fault-plan": "fault plans are not ported yet (ROADMAP A4)",
    "--slo-availability": "the SLO plane is not ported yet (ROADMAP A4)",
    "--slo-p99-ms": "the SLO plane is not ported yet (ROADMAP A4)",
    "--slo-fast-window-s": "the SLO plane is not ported yet (ROADMAP A4)",
    "--slo-slow-window-s": "the SLO plane is not ported yet (ROADMAP A4)",
    "--ledger-profile-interval-s": "the device-time ledger is not ported yet (ROADMAP A4)",
    "--ledger-profile-ms": "the device-time ledger is not ported yet (ROADMAP A4)",
    "--fallback-cpu": "the port has no CPU fallback",
    "--no-fallback-cpu": "the port has no CPU fallback; it always fails fast",
    "--sanitize": "the JAX transfer guard has no counterpart in the port",
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
        "--result-cache-bytes", default="0", metavar="BYTES",
        help="content-addressed result tier budget (k/m/g suffixes; 0 disables)",
    )
    g.add_argument("--jpeg-quality", type=int, default=90, help="JPEG encoder quality")
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
    o = p.add_argument_group("observability", "structured run telemetry")
    o.add_argument("--metrics-out", default=None, metavar="JSON",
                   help="write the metrics snapshot here at drain (nm03.metrics.v1)")
    o.add_argument("--log-json", default=None, metavar="JSONL",
                   help="write structured JSON-lines events here (nm03.events.v1)")
    o.add_argument("--heartbeat-s", type=float, default=30.0, metavar="SEC",
                   help="heartbeat event period for --log-json streams (0 disables)")
    for flag in NOT_PORTED:
        p.add_argument(flag, nargs="?", action=_NotPorted, help=argparse.SUPPRESS)
    return p


def app_from_args(args: argparse.Namespace, obs=None) -> ServingApp:
    from nm03_capstone_project_tpu_torch.cli import common
    from nm03_capstone_project_tpu_torch.resilience import ResilienceConfig

    buckets = tuple(int(b) for b in str(args.buckets).split(",") if b.strip())
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
    )


def _write_port_file(path: str, port: int) -> None:
    from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_text

    atomic_write_text(path, f"{port}\n")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from nm03_capstone_project_tpu_torch.obs import RunContext, flightrec
    from nm03_capstone_project_tpu_torch.utils.reporter import configure_reporting

    configure_reporting(verbose=args.verbose)
    run_ctx = RunContext.create(
        "serve",
        metrics_out=args.metrics_out,
        log_json=args.log_json,
        heartbeat_s=args.heartbeat_s or 0.0,
        argv=argv,
    )
    try:
        app = app_from_args(args, obs=run_ctx)
        httpd = make_http_server(app, args.host, args.port)
    except (RuntimeError, ValueError, OSError) as e:
        print(f"nm03-serve: {e}", file=sys.stderr)
        run_ctx.close(status="error")
        return 1
    port = httpd.server_address[1]
    # arm the flight recorder (SIGUSR2, quarantine and crash dumps) once the
    # server exists, before warmup: a process that could not even build
    # its app leaves no dump behind
    flightrec.install(dump_dir=args.flight_dir)
    try:
        timings = app.start()
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
