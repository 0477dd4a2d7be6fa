"""The port's single-slice server held against the JAX package's, on the CPU.

Both apps are built in process as ``tests/test_serving.py`` builds the JAX
one — ``ServingApp(cfg=PipelineConfig(canvas=128), buckets=(1, 2, 4),
lanes=1)``, the port's with ``device="cpu"`` — with the result tier on, and
served over loopback HTTP. The same raw float32 bodies (phantoms and a
seeded random field, square and not) and the same DICOM bodies go to both:
``shape``, ``grow_converged``, ``mask_pixels``, ``mask_sha256``, both JPEG
base64 strings and the ``ETag`` must be byte-identical, and an
``If-None-Match`` repeat must give 304 on both. The JAX side runs its
default plain XLA path; the port's CPU executor runs the plain ops eagerly
(no CUDA graph on the CPU).

Also: the copied modules pinned to their originals (result keys, ETags,
the metrics snapshot schema, the ``/readyz`` key set), the admission
queue, the batcher, backpressure and drain (mirroring
``tests/test_serving.py``), and that the port never degrades to the CPU:
with its only lane quarantined ``/readyz`` answers 503 with
``degraded: true`` and requests fail without any plain-op call.
"""

import base64
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402,F401
import torch  # noqa: E402

from nm03_capstone_project_tpu import cache as jax_cache  # noqa: E402
from nm03_capstone_project_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from nm03_capstone_project_tpu.obs import trace as jax_trace  # noqa: E402
from nm03_capstone_project_tpu.serving import metrics as jax_metrics  # noqa: E402
from nm03_capstone_project_tpu.serving.server import ServingApp as JaxApp  # noqa: E402
from nm03_capstone_project_tpu.serving.server import (  # noqa: E402
    serve_in_thread as jax_serve_in_thread,
)
from nm03_capstone_project_tpu_torch import cache  # noqa: E402
from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.data.synthetic import (  # noqa: E402
    phantom_slice,
    write_synthetic_cohort,
)
from nm03_capstone_project_tpu_torch.obs import trace  # noqa: E402
from nm03_capstone_project_tpu_torch.resilience import (  # noqa: E402
    DeadlineExceeded,
    ResilienceConfig,
)
from nm03_capstone_project_tpu_torch.serving import executor as executor_mod  # noqa: E402
from nm03_capstone_project_tpu_torch.serving import metrics  # noqa: E402
from nm03_capstone_project_tpu_torch.serving.batcher import DynamicBatcher  # noqa: E402
from nm03_capstone_project_tpu_torch.serving.executor import WarmExecutor  # noqa: E402
from nm03_capstone_project_tpu_torch.serving.lanes import LaneFaultDomains  # noqa: E402
from nm03_capstone_project_tpu_torch.serving.queue import (  # noqa: E402
    AdmissionQueue,
    QueueClosed,
    QueueFull,
    ServeRequest,
)
from nm03_capstone_project_tpu_torch.serving.server import (  # noqa: E402
    ServingApp,
    make_http_server,
    serve_in_thread,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
CHECKER = REPO / "scripts" / "check_telemetry.py"
CANVAS = 128
BUCKETS = (1, 2, 4)
CACHE_BYTES = 1 << 24
PAYLOAD_FIELDS = ("shape", "grow_converged", "mask_pixels", "mask_sha256",
                  "original_jpeg_b64", "processed_jpeg_b64")
# /readyz blocks the port publishes as null; compile_hub was the last (ported
# with the kernel library cache, compilehub/)
NOT_PORTED_BLOCKS = ()
# the compile hub's rollups both packages publish: JAX counts executables,
# the port its kernel libraries (and the graphs' capture seconds where JAX
# has its per-spec compile seconds)
COMPILE_HUB_ROLLUPS = {"builds", "cache_loads", "total_compile_seconds"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _post(url: str, body: bytes, headers: dict, timeout=60.0):
    """POST; (status, parsed json or None, headers), without raising."""
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, json.loads(raw) if raw else None, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None, dict(e.headers)


def _get(url: str, timeout=30.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _raw_headers(h: int, w: int) -> dict:
    return {"Content-Type": "application/octet-stream",
            "X-Nm03-Height": str(h), "X-Nm03-Width": str(w)}


def _raw_body(case: str) -> tuple:
    """(body, h, w) of a named raw float32 case, made from a numpy seed."""
    if case == "random":
        rng = np.random.default_rng(5)
        h, w = 113, 128
        img = rng.uniform(0.0, 3000.0, size=(h, w)).astype(np.float32)
    else:
        h, w = {"square": (128, 128), "tall": (120, 104), "wide": (101, 127)}[case]
        img = phantom_slice(h, w, seed=h + w)
    return img.astype("<f4").tobytes(), h, w


def _run_checker(*argv):
    return subprocess.run([sys.executable, str(CHECKER), *map(str, argv)],
                          capture_output=True, text=True, timeout=60)


@pytest.fixture(scope="module")
def pair():
    """The JAX app and the port's, warm and served over loopback."""
    jax_app = JaxApp(cfg=JaxConfig(canvas=CANVAS), buckets=BUCKETS, lanes=1,
                     max_wait_s=0.02, result_cache_bytes=CACHE_BYTES)
    port_app = ServingApp(cfg=PipelineConfig(canvas=CANVAS), buckets=BUCKETS, lanes=1,
                          max_wait_s=0.02, result_cache_bytes=CACHE_BYTES, device="cpu")
    servers = []
    for app, serve in ((jax_app, jax_serve_in_thread), (port_app, serve_in_thread)):
        httpd, _, port = serve(app)
        servers.append((app, httpd, f"http://127.0.0.1:{port}"))
    yield SimpleNamespace(jax=servers[0][2], port=servers[1][2], jax_app=jax_app,
                          port_app=port_app)
    for app, httpd, _ in servers:
        app.begin_drain(reason="test_teardown")
        httpd.shutdown()
        httpd.server_close()
        app.close()


def _both(pair, path: str, body: bytes, headers: dict):
    return [_post(base + path, body, headers) for base in (pair.jax, pair.port)]


def _assert_identical(a, b):
    (sa, pa, ha), (sb, pb, hb) = a, b
    assert sa == sb == 200, (pa, pb)
    for k in PAYLOAD_FIELDS:
        assert pa[k] == pb[k], k
    assert ha["ETag"] == hb["ETag"]
    return ha["ETag"]


# -- parity with the JAX server ------------------------------------------------


class TestParity:
    @pytest.mark.parametrize("case", ["square", "tall", "wide", "random"])
    def test_raw_body_payload_and_etag(self, pair, case):
        body, h, w = _raw_body(case)
        a, b = _both(pair, "/v1/segment", body, _raw_headers(h, w))
        etag = _assert_identical(a, b)
        assert a[1]["shape"] == [h, w]
        for blob in (a[1]["original_jpeg_b64"], a[1]["processed_jpeg_b64"]):
            jpeg = base64.b64decode(blob)
            assert jpeg[:2] == b"\xff\xd8" and jpeg[-2:] == b"\xff\xd9"
        # a repeat with the ETag: 304 on both, no body
        for status, payload, headers in _both(
            pair, "/v1/segment", body, {**_raw_headers(h, w), "If-None-Match": etag}
        ):
            assert status == 304 and payload is None
            assert headers["ETag"] == etag and headers["X-Nm03-Cache"] == "hit"

    def test_dicom_bodies(self, pair, tmp_path):
        root = tmp_path / "cohort"
        write_synthetic_cohort(root, n_patients=1, n_slices=3, height=CANVAS, width=120)
        files = sorted(root.rglob("*.dcm"))
        assert len(files) == 3
        areas = []
        for f in files:
            a, b = _both(pair, "/v1/segment", f.read_bytes(),
                         {"Content-Type": "application/dicom"})
            _assert_identical(a, b)
            assert a[1]["shape"] == [CANVAS, 120]
            areas.append(a[1]["mask_pixels"])
        assert max(areas) > 0  # the cohort's lesion waxes and wanes

    def test_mask_only_output(self, pair):
        body, h, w = _raw_body("tall")
        (sa, pa, ha), (sb, pb, hb) = _both(pair, "/v1/segment?output=mask", body,
                                           _raw_headers(h, w))
        assert sa == sb == 200 and "original_jpeg_b64" not in pb
        assert {k: pa[k] for k in PAYLOAD_FIELDS[:4]} == {k: pb[k] for k in PAYLOAD_FIELDS[:4]}
        assert ha["ETag"] == hb["ETag"]

    def test_rejections_match(self, pair):
        cases = [
            (b"\0" * (40 * 40 * 4), _raw_headers(40, 40)),  # below min_dim: 400
            (b"\0" * (200 * 200 * 4), _raw_headers(200, 200)),  # past the canvas: 413
            (b"\0" * 100, _raw_headers(CANVAS, CANVAS)),  # wrong byte count: 400
            (b"\0" * 100, {"Content-Type": "text/plain"}),  # no dims, no DICOM: 415
            (b"not a dicom file", {"Content-Type": "application/dicom"}),  # 400
        ]
        for body, headers in cases:
            (sa, pa, _), (sb, pb, _) = _both(pair, "/v1/segment", body, headers)
            assert sa == sb and sa in (400, 413, 415), (sa, sb)
            assert pa["error"] == pb["error"]


# -- the copies, pinned to their originals -------------------------------------


class TestCopiesPinned:
    @pytest.mark.parametrize("params", [None, {}, {"render": True, "jpeg_quality": 90},
                                        {"render": False}])
    def test_result_key_digest(self, params):
        body, _, _ = _raw_body("wide")
        for version in ("0123456789abcdef", cache.result_version(PipelineConfig())):
            want = jax_cache.result_key(body, "segment", params, version)
            got = cache.result_key(body, "segment", params, version)
            assert got.digest() == want.digest() and got.to_json() == want.to_json()

    def test_etag_and_sizes(self):
        for payload in (b"", b"{}", json.dumps({"a": [1, 2]}).encode()):
            assert cache.content_etag(payload) == jax_cache.content_etag(payload)
        etag = cache.content_etag(b"x")
        for header in ("*", etag, f"W/{etag}", f'"zz", {etag}', '"zz"', None):
            assert cache.etag_matches(header, etag) == jax_cache.etag_matches(header, etag)
        for text in ("0", "512m", "2g", "1048576", "1.5k"):
            assert cache.parse_bytes(text) == jax_cache.parse_bytes(text)

    def test_program_version_is_the_ports_own(self, pair):
        st = json.loads(_get(pair.port + "/readyz")[1])
        version = st["result_cache"]["program_version"]
        assert version == cache.result_version(PipelineConfig(canvas=CANVAS))
        assert len(version) == 16
        assert version != json.loads(_get(pair.jax + "/readyz")[1])["result_cache"][
            "program_version"]

    def test_readyz_key_set(self, pair):
        (sj, bj), (sp, bp) = _get(pair.jax + "/readyz"), _get(pair.port + "/readyz")
        jst, pst = json.loads(bj), json.loads(bp)
        assert sj == sp == 200 and pst["ready"] and pst["warm"]
        assert set(pst) - {"cuda_graphs"} == set(jst)
        for block in NOT_PORTED_BLOCKS:
            assert pst[block] is None, block
        jhub, phub = jst["compile_hub"], pst["compile_hub"]
        assert COMPILE_HUB_ROLLUPS <= set(jhub) and COMPILE_HUB_ROLLUPS <= set(phub)
        assert {"libraries", "capture_seconds", "cache_dir"} <= set(phub)
        # no cache attached on either side: no cache fields, no hits
        assert phub["cache_dir"] is None and "cache_hits" not in phub
        assert "cache_hits" not in jhub
        assert pst["replica"]["compile_cache_hits"] is None
        assert jst["replica"]["compile_cache_hits"] is None
        # the CPU captures no graph
        assert phub["capture_seconds"] == {}
        # the saturation and ledger planes: the JAX key sets (no SLO declared)
        for block in ("saturation", "ledger"):
            assert set(pst[block]) == set(jst[block]), block
        assert pst["slo"] is None and jst["slo"] is None
        assert pst["volumes"] == {"enabled": False}
        assert set(pst["lanes"]) == set(jst["lanes"])
        assert set(pst["lanes"]["per_lane"][0]) == set(jst["lanes"]["per_lane"][0])
        assert set(pst["batcher"]) == set(jst["batcher"])
        assert set(pst["result_cache"]) - {"inflight"} <= set(jst["result_cache"])
        # the CPU runs the plain ops eagerly: no graphs to report
        assert pst["cuda_graphs"] == {"enabled": False, "lanes": {}}

    def test_metrics_snapshot_schema(self, pair, tmp_path):
        body, h, w = _raw_body("square")
        assert _post(pair.port + "/v1/segment?output=mask", body, _raw_headers(h, w))[0] == 200
        status, snap = _get(pair.port + "/metrics.json")
        assert status == 200
        path = tmp_path / "port_metrics.json"
        path.write_bytes(snap)
        res = _run_checker(
            "--metrics", path,
            "--expect-counter", "serving_requests_total=1",
            "--expect-counter", "serving_batches_total=1",
            "--expect-counter", "serving_lane_batches_total=1",
            "--expect-counter", "serving_graph_replays_total=1",
            "--expect-histogram", "serving_queue_wait_seconds=1",
            "--expect-histogram", "serving_batch_size=1",
            "--expect-histogram", "serving_request_seconds=1",
            "--expect-gauge", "serving_lanes_ready=1",
        )
        assert res.returncode == 0, res.stdout + res.stderr
        status, prom = _get(pair.port + "/metrics")
        assert status == 200 and b"serving_request_seconds_bucket" in prom

    def test_series_names_and_spans(self):
        for name in dir(metrics):
            if name.isupper() and hasattr(jax_metrics, name):
                assert getattr(metrics, name) == getattr(jax_metrics, name), name
        assert set(trace.SERVE_SPAN_NAMES) <= set(jax_trace.SERVE_SPAN_NAMES)
        assert trace.SERVE_TRACE_EVENT == jax_trace.SERVE_TRACE_EVENT
        for raw in ("abc-1.2:3", "", " x ", "bad id", "a" * 65, None):
            assert trace.sanitize_trace_id(raw) == jax_trace.sanitize_trace_id(raw)


class TestLoopback:
    def test_concurrent_requests_coalesce_and_crop(self, pair):
        cases = [_raw_body(c) for c in ("square", "tall", "wide", "random")] * 3
        results = [None] * len(cases)

        def one(i):
            body, h, w = cases[i]
            results[i] = _post(pair.port + "/v1/segment?output=mask", body,
                               {**_raw_headers(h, w), "X-Nm03-Request-Id": f"req-{i}"})

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(cases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(r is not None and r[0] == 200 for r in results)
        assert max(r[1]["batch_size"] for r in results) > 1  # coalescing happened
        for i, (status, payload, headers) in enumerate(results):
            assert payload["shape"] == [cases[i][1], cases[i][2]]
            assert headers["X-Nm03-Request-Id"] == f"req-{i}" == payload["trace_id"]
        # identical bodies give one mask, whichever batch carried them
        by_body = {}
        for (body, _, _), (_, payload, _) in zip(cases, results):
            by_body.setdefault(body, set()).add(payload["mask_sha256"])
        assert all(len(v) == 1 for v in by_body.values())

    def test_served_mask_equals_process_batch(self, pair):
        from nm03_capstone_project_tpu_torch.core import pad_to_canvas
        from nm03_capstone_project_tpu_torch.pipeline import process_batch

        body, h, w = _raw_body("tall")
        status, payload, _ = _post(pair.port + "/v1/segment?output=mask", body,
                                   _raw_headers(h, w))
        img = np.frombuffer(body, "<f4").reshape(h, w)
        b = pad_to_canvas([img], (CANVAS, CANVAS), device="cpu")
        mask = process_batch(b.pixels, b.dims, PipelineConfig(canvas=CANVAS), device="cpu")[
            "mask"][0, :h, :w].numpy()
        import hashlib

        assert status == 200
        assert payload["mask_sha256"] == hashlib.sha256(mask.tobytes()).hexdigest()
        assert payload["mask_pixels"] == int(mask.sum())


# -- admission queue -------------------------------------------------------------


def _req(i: int = 0) -> ServeRequest:
    return ServeRequest(request_id=f"r{i}", pixels=np.zeros((8, 8), np.float32), dims=(8, 8))


class TestAdmissionQueue:
    def test_capacity_bound_sheds(self):
        q = AdmissionQueue(2)
        q.put(_req(0))
        q.put(_req(1))
        with pytest.raises(QueueFull):
            q.put(_req(2))
        assert len(q) == 2

    def test_close_refuses_but_drains_tail(self):
        q = AdmissionQueue(4)
        q.put(_req(0))
        q.close()
        with pytest.raises(QueueClosed):
            q.put(_req(1))
        assert [r.request_id for r in q.get_batch(max_batch=4, max_wait_s=0.0)] == ["r0"]
        assert q.get_batch(max_batch=4, max_wait_s=0.0) == []

    def test_get_batch_coalesces_backlog(self):
        q = AdmissionQueue(8)
        for i in range(3):
            q.put(_req(i))
        assert [r.request_id for r in q.get_batch(8, 0.0)] == ["r0", "r1", "r2"]

    def test_get_batch_respects_max_batch(self):
        q = AdmissionQueue(8)
        for i in range(5):
            q.put(_req(i))
        assert len(q.get_batch(max_batch=2, max_wait_s=0.0)) == 2
        assert len(q) == 3

    def test_get_batch_window_waits_for_riders(self):
        q = AdmissionQueue(8)
        q.put(_req(0))

        def late_rider():
            time.sleep(0.05)
            q.put(_req(1))

        t = threading.Thread(target=late_rider)
        t.start()
        batch = q.get_batch(max_batch=8, max_wait_s=0.5)
        t.join(timeout=5)
        assert not t.is_alive() and len(batch) == 2

    def test_zero_capacity_rejected(self):
        with pytest.raises(ValueError):
            AdmissionQueue(0)


# -- the batcher against a fake executor ------------------------------------------


class FakeExecutor:
    """Executor stand-in recording the padded batches it was handed."""

    def __init__(self, buckets=(1, 2, 4), canvas=16, min_dim=4, fail=None):
        self.cfg = SimpleNamespace(canvas=canvas, min_dim=min_dim)
        self.buckets = tuple(buckets)
        self.fail = fail
        self.calls = []

    @property
    def max_batch(self):
        return self.buckets[-1]

    def bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(n)

    def run_batch(self, pixels, dims):
        self.calls.append((pixels.copy(), dims.copy()))
        if self.fail is not None:
            raise self.fail
        return (pixels > 0).astype(np.uint8), np.ones(pixels.shape[0], bool)


def _reqs(sizes):
    return [ServeRequest(request_id=f"r{i}", pixels=np.ones((h, w), np.float32), dims=(h, w))
            for i, (h, w) in enumerate(sizes)]


class TestDynamicBatcher:
    def test_pads_to_smallest_bucket(self):
        ex = FakeExecutor()
        DynamicBatcher(AdmissionQueue(8), ex, max_wait_s=0.0).execute(
            _reqs([(8, 8), (6, 10), (16, 16)]))
        (pixels, dims), = ex.calls
        assert pixels.shape == (4, 16, 16)  # 3 requests -> bucket 4
        assert dims.tolist()[:3] == [[8, 8], [6, 10], [16, 16]]
        assert pixels[3].sum() == 0 and dims[3].tolist() == [4, 4]

    def test_results_cropped_and_distributed(self):
        reqs = _reqs([(8, 8), (6, 10)])
        DynamicBatcher(AdmissionQueue(8), FakeExecutor(), max_wait_s=0.0).execute(reqs)
        for r in reqs:
            assert r.done.is_set() and r.error is None
            assert r.mask.shape == r.dims and r.mask.all()
            assert r.batch_size == 2

    def test_executor_failure_fails_every_rider(self):
        reqs = _reqs([(8, 8), (8, 8), (5, 5)])
        ex = FakeExecutor(fail=RuntimeError("boom"))
        DynamicBatcher(AdmissionQueue(8), ex, max_wait_s=0.0).execute(reqs)
        assert len(ex.calls) == 1
        for r in reqs:
            assert r.done.is_set() and isinstance(r.error, RuntimeError)

    def test_thread_coalesces_concurrent_submissions(self):
        ex = FakeExecutor(buckets=(1, 2, 4, 8))
        q = AdmissionQueue(16)
        b = DynamicBatcher(q, ex, max_wait_s=0.1).start()
        reqs = _reqs([(8, 8)] * 6)
        for r in reqs:
            q.put(r)
        for r in reqs:
            assert r.wait(5.0)
        q.close()
        assert b.join(5.0)
        assert max(r.batch_size for r in reqs) > 1

    def test_max_batch_above_buckets_rejected(self):
        with pytest.raises(ValueError, match="largest warm bucket"):
            DynamicBatcher(AdmissionQueue(4), FakeExecutor(buckets=(1, 2)), max_batch=8)

    def test_duplicate_digests_ride_one_row(self):
        ex = FakeExecutor()
        reqs = _reqs([(8, 8), (8, 8), (6, 6)])
        reqs[0].digest = reqs[1].digest = "d0"
        DynamicBatcher(AdmissionQueue(8), ex, max_wait_s=0.0).execute(reqs)
        (pixels, _), = ex.calls
        assert pixels.shape[0] == 2  # two leaders -> bucket 2
        assert reqs[1].mask is reqs[0].mask and reqs[1].device_seconds == 0.0


class TestExecutorBuckets:
    def test_bucket_for_and_validation(self):
        ex = WarmExecutor(PipelineConfig(canvas=CANVAS), buckets=(1, 2, 4), device="cpu")
        assert [ex.bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
        with pytest.raises(ValueError, match="exceeds the largest"):
            ex.bucket_for(5)
        with pytest.raises(ValueError, match="strictly increasing"):
            WarmExecutor(PipelineConfig(), buckets=(4, 2), device="cpu")
        with pytest.raises(ValueError, match=">= 1"):
            WarmExecutor(PipelineConfig(), buckets=(0, 1), device="cpu")

    def test_default_device_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            WarmExecutor(PipelineConfig(canvas=CANVAS), buckets=(1,))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingApp(cfg=PipelineConfig(canvas=CANVAS), buckets=(1,))


# -- shed and drain on an app whose batcher never starts ---------------------------


@pytest.fixture()
def stalled_server():
    """A bound server whose batcher never starts: every admitted request
    parks until its (short) timeout, so overload is deterministic."""
    app = ServingApp(cfg=PipelineConfig(canvas=CANVAS), queue_capacity=1, buckets=(1,),
                     max_wait_s=0.0, request_timeout_s=0.6, device="cpu")
    httpd = make_http_server(app)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield app, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    app.close()


class TestBackpressure:
    def test_readyz_not_warm(self, stalled_server):
        app, base = stalled_server
        status, body = _get(base + "/readyz")
        st = json.loads(body)
        assert status == 503 and not st["warm"] and not st["ready"]

    def test_shed_past_queue_bound(self, stalled_server):
        app, base = stalled_server
        body, h, w = _raw_body("square")
        first = {}

        def occupier():
            first["status"] = _post(base + "/v1/segment?output=mask", body,
                                    _raw_headers(h, w), timeout=10.0)[0]

        t = threading.Thread(target=occupier)
        t.start()
        deadline = time.monotonic() + 5.0
        while len(app.queue) == 0 and time.monotonic() < deadline:
            time.sleep(0.01)  # until the occupier holds the only slot
        status, payload, headers = _post(base + "/v1/segment?output=mask", body,
                                         _raw_headers(h, w))
        t.join(timeout=10)
        assert status == 503 and headers.get("Retry-After") == "1"
        assert first["status"] == 504  # the occupier timed out cleanly
        reg = app.registry
        assert reg.get("serving_shed_total").value >= 1
        assert reg.get("serving_requests_total", status="shed").value >= 1
        assert reg.get("serving_requests_total", status="timeout").value >= 1

    def test_drain_refuses_with_retry_after(self, stalled_server):
        app, base = stalled_server
        assert app.begin_drain(reason="test") is True
        body, h, w = _raw_body("square")
        status, payload, headers = _post(base + "/v1/segment?output=mask", body,
                                         _raw_headers(h, w))
        assert status == 503 and payload["draining"] is True
        assert headers.get("Retry-After") == "1"
        drain = [r for r in app.obs.events.tail if r["event"] == "serving_drain"]
        assert len(drain) == 1 and drain[0]["level"] == "WARNING"
        assert app.begin_drain(reason="again") is True  # idempotent
        status, body = _get(base + "/readyz")
        assert status == 503 and json.loads(body)["draining"] is True


# -- no CPU degradation ------------------------------------------------------------


@pytest.fixture()
def warm_app(monkeypatch):
    """A warm single-lane CPU app; counts the plain-op calls made after
    warmup (a degraded executor must make none)."""
    app = ServingApp(cfg=PipelineConfig(canvas=CANVAS), buckets=(1,), max_wait_s=0.0,
                     request_timeout_s=20.0, device="cpu",
                     resilience=ResilienceConfig(retry_max=0, dispatch_timeout_s=0.5))
    app.start()
    calls = []
    real = executor_mod._process
    monkeypatch.setattr(executor_mod, "_process",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    yield app, calls
    app.begin_drain(reason="test_teardown")
    app.close()


class TestNoCpuDegradation:
    def test_quarantined_last_lane_fails_fast(self, warm_app):
        app, calls = warm_app
        img = phantom_slice(CANVAS, CANVAS, seed=1)
        assert app.segment(img, render=False)["mask_pixels"] > 0 and len(calls) == 1
        app.executor.quarantine_lane(0, "deadline")
        assert not app.ready
        st = app.status()
        assert st["degraded"] is True and st["degraded_cause"] == "deadline"
        assert st["capacity"] == 0.0 and st["lanes"]["quarantined"] == 1
        with pytest.raises(DeadlineExceeded, match="no CPU fallback"):
            app.segment(img, render=False)
        assert len(calls) == 1  # nothing served it on the CPU
        assert app.registry.get("pipeline_degraded_total", cause="deadline").value == 1
        assert app.registry.get("serving_requests_total", status="error").value == 1

    def test_dispatch_past_its_deadline_quarantines(self, warm_app):
        app, calls = warm_app
        runner = app.executor._runners[0][1]
        launch = runner.launch

        def wedged(pixels, dims):
            time.sleep(3.0)  # outlives the 0.5 s dispatch deadline
            launch(pixels, dims)

        runner.launch = wedged
        with pytest.raises(DeadlineExceeded):
            app.segment(phantom_slice(CANVAS, CANVAS, seed=2), render=False)
        assert not app.ready and app.executor.degraded
        assert app.executor.degraded_cause == "deadline"
        reg = app.registry
        assert reg.get("serving_lane_quarantines_total", lane="0", cause="deadline").value == 1
        assert reg.get("serving_requeues_total").value == 1
        assert reg.get("serving_lane_state", lane="0").value == 2

    def test_readyz_503_with_degraded(self, warm_app):
        app, _ = warm_app
        httpd = make_http_server(app)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            assert _get(base + "/readyz")[0] == 200
            app.executor.quarantine_lane(0, "deadline")
            status, body = _get(base + "/readyz")
            assert status == 503 and json.loads(body)["degraded"] is True
            img_body, h, w = _raw_body("square")
            status, payload, _ = _post(base + "/v1/segment?output=mask", img_body,
                                       _raw_headers(h, w))
            assert status == 504 and payload["error_class"] == "DeadlineExceeded"
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_partial_quarantine_keeps_ready_at_reduced_capacity(self):
        app = ServingApp(cfg=PipelineConfig(canvas=CANVAS), buckets=(1,), device="cpu")
        ex = app.executor
        ex._resolve_lanes()
        ex.warm = True
        # a resolved 4-lane fleet, without devices
        ex._lane_devices = ["d0", "d1", "d2", "d3"]
        ex._lane_warm = [True] * 4
        ex._lane_inflight = [0] * 4
        ex._lane_batches = [0] * 4
        ex.fleet = LaneFaultDomains(4, obs=app.obs)
        assert app.status()["capacity"] == 1.0
        changed, healthy_left = ex.fleet.quarantine(2, "deadline")
        assert changed and healthy_left == 3
        assert app.ready
        st = app.status()
        assert st["capacity"] == 0.75 and st["lanes"]["quarantined"] == 1
        assert not st["degraded"]
        per_lane = {row["lane"]: row for row in st["lanes"]["per_lane"]}
        assert per_lane[2]["state"] == "quarantined" and per_lane[0]["state"] == "healthy"
        assert app.registry.get("serving_lane_state", lane="2").value == 2
        app.close()


# -- SIGTERM drain, a real process ---------------------------------------------------


class TestSigtermDrain:
    def test_sigterm_drains_and_flushes(self, tmp_path):
        port_file = tmp_path / "port"
        metrics_out = tmp_path / "metrics.json"
        events = tmp_path / "events.jsonl"
        env = dict(os.environ, OMP_NUM_THREADS="1")
        proc = subprocess.Popen(
            [sys.executable, "-m", "nm03_capstone_project_tpu_torch.serving.server",
             "--device", "cpu", "--port", "0", "--port-file", str(port_file),
             "--canvas", str(CANVAS), "--buckets", "1", "--max-wait-ms", "5",
             "--heartbeat-s", "0", "--result-cache-bytes", "16m",
             "--metrics-out", str(metrics_out), "--log-json", str(events)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO,
        )
        try:
            deadline = time.monotonic() + 120
            while not port_file.exists() and time.monotonic() < deadline:
                if proc.poll() is not None:
                    pytest.fail(f"server died: {proc.stdout.read()}")
                time.sleep(0.1)
            assert port_file.exists(), "server never became ready"
            base = f"http://127.0.0.1:{int(port_file.read_text())}"
            body, h, w = _raw_body("wide")
            status, payload, headers = _post(base + "/v1/segment", body, _raw_headers(h, w))
            assert status == 200 and payload["mask_pixels"] > 0
            assert headers["X-Nm03-Cache"] == "fill"
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert "drained and stopped" in out and "device cpu" in out
        res = _run_checker(
            "--events", events, "--metrics", metrics_out,
            "--expect-counter", "serving_requests_total=1",
            "--expect-counter", "serving_result_cache_fill_total=1",
            "--expect-histogram", "serving_request_seconds=1",
            "--expect-histogram", "serving_queue_wait_seconds=1",
        )
        assert res.returncode == 0, res.stdout + res.stderr
        records = [json.loads(line) for line in events.read_text().splitlines()]
        assert [r["event"] for r in records][-1] == "run_finished"
        traces = [r for r in records if r["event"] == "serve_trace"]
        assert len(traces) == 1
        names = {s["name"] for s in traces[0]["spans"]}
        assert {"queue_wait", "coalesce", "pad_stack", "device_dispatch", "fetch",
                "encode"} <= names <= set(trace.SERVE_SPAN_NAMES)
