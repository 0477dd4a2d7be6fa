"""The port's whole-volume serving held against the JAX package's, on the CPU.

Both apps are built in process at canvas 64 (``min_dim`` 16) with volume
depth buckets (4, 8), one lane and the result tier on, as
``tests/test_serving_volumes.py`` builds the JAX one, and served over
loopback: ``POST /v1/segment-volume`` with the same numpy-seeded phantom
studies (raw float32 stacks, ``application/x-nm03-dicom-parts`` and
multi-frame ``application/dicom`` bodies) must give byte-identical payload
fields, ``mask_b64``, MetaImage pair and ``ETag`` (the ids and waits
excepted), the same statuses, ``X-Nm03-Cache`` fill -> hit, 304s and
idempotency-key answers. The JAX gang runs its z-sharded program on a
one-device mesh; the port's gang runs ``process_volume`` on the dilate
schedule on its one lane.

Port-only: coalescing of identical in-flight studies (a slow stub
program), the shed when the only lane dies, a deterministic error's 500,
mixed slice and volume traffic, the gang's bucket math and its warmup
after the executor's graphs, and the gang as a z-mesh over four CPU lanes
given through the executor's explicit lane list (the counterpart of the
JAX tests' virtual devices): ``z_shards`` 4, the mask of a direct
``process_volume_zsharded`` and of ``nm03-volume --z-shard``, and a lane
death mid-volume re-meshing onto three lanes.
"""

import base64
import dataclasses
import json
import pathlib
import struct
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

from nm03_capstone_project_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from nm03_capstone_project_tpu.serving.server import ServingApp as JaxApp  # noqa: E402
from nm03_capstone_project_tpu.serving.server import (  # noqa: E402
    make_http_server as jax_make_http_server,
)
from nm03_capstone_project_tpu.serving.server import (  # noqa: E402
    serve_in_thread as jax_serve_in_thread,
)
from nm03_capstone_project_tpu.serving.volumes import VolumeGang as JaxGang  # noqa: E402
from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.data.dicomlite import (  # noqa: E402
    EXPLICIT_VR_LE,
    _element,
    read_dicom,
    write_dicom,
)
from nm03_capstone_project_tpu_torch.data.synthetic import (  # noqa: E402
    phantom_volume,
    write_synthetic_cohort,
)
from nm03_capstone_project_tpu_torch.pipeline import process_volume  # noqa: E402
from nm03_capstone_project_tpu_torch.resilience import (  # noqa: E402
    ResilienceConfig,
    TransientDeviceError,
)
from nm03_capstone_project_tpu_torch.serving import volumes  # noqa: E402
from nm03_capstone_project_tpu_torch.serving.server import (  # noqa: E402
    ServingApp,
    make_http_server,
    serve_in_thread,
)
from nm03_capstone_project_tpu_torch.serving.volumes import VolumeGang  # noqa: E402

CANVAS = 64
MIN_DIM = 16
VOLUME_BUCKETS = (4, 8)
CACHE_BYTES = 1 << 24
# per-execution fields, exempt from the byte comparison
EXEMPT = ("request_id", "trace_id", "queue_wait_s", "gang_wait_s")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _post(url: str, body: bytes, headers: dict, timeout=120.0):
    """POST; (status, parsed json or None, headers), without raising."""
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, json.loads(raw) if raw else None, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None, dict(e.headers)


def _raw_headers(d: int, h: int, w: int) -> dict:
    return {"Content-Type": "application/octet-stream", "X-Nm03-Depth": str(d),
            "X-Nm03-Height": str(h), "X-Nm03-Width": str(w)}


def _study(d: int, h: int, w: int, seed: int) -> np.ndarray:
    return phantom_volume(d, h, w, seed=seed).astype(np.float32)


def _raw(vol: np.ndarray):
    return vol.astype("<f4").tobytes(), _raw_headers(*vol.shape)


def _dicom_parts(planes: np.ndarray, tmp: pathlib.Path) -> bytes:
    parts = []
    for i, plane in enumerate(planes):
        p = tmp / f"part{i}.dcm"
        write_dicom(p, np.clip(plane, 0, 65535).astype(np.uint16))
        raw = p.read_bytes()
        parts.append(len(raw).to_bytes(4, "little") + raw)
    return b"".join(parts)


def _multiframe(planes: np.ndarray) -> bytes:
    """One native multi-frame Part-10 file holding ``planes`` as uint16."""
    d, rows, cols = planes.shape
    meta_elems = _element(0x0002, 0x0010, b"UI", EXPLICIT_VR_LE.encode())
    meta = _element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_elems))) + meta_elems
    u16 = lambda v: struct.pack("<H", v)  # noqa: E731
    ds = b"".join([
        _element(0x0008, 0x0016, b"UI", b"1.2.840.10008.5.1.4.1.1.4"),
        _element(0x0028, 0x0002, b"US", u16(1)),
        _element(0x0028, 0x0004, b"CS", b"MONOCHROME2"),
        _element(0x0028, 0x0008, b"IS", str(d).encode()),
        _element(0x0028, 0x0010, b"US", u16(rows)),
        _element(0x0028, 0x0011, b"US", u16(cols)),
        _element(0x0028, 0x0100, b"US", u16(16)),
        _element(0x0028, 0x0101, b"US", u16(16)),
        _element(0x0028, 0x0102, b"US", u16(15)),
        _element(0x0028, 0x0103, b"US", u16(0)),
        _element(0x7FE0, 0x0010, b"OW",
                 np.clip(planes, 0, 65535).astype("<u2").tobytes()),
    ])
    return b"\x00" * 128 + b"DICM" + meta + ds


def _mask_of(payload: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(payload["mask_b64"]), np.uint8).reshape(
        payload["shape"])


def _cfgs(**kw):
    return (PipelineConfig(canvas=CANVAS, min_dim=MIN_DIM, **kw),
            JaxConfig(canvas=CANVAS, min_dim=MIN_DIM, **kw))


@pytest.fixture(scope="module")
def pair():
    """The JAX app and the port's with volume serving, warm, over loopback."""
    pcfg, jcfg = _cfgs()
    common = dict(lanes=1, max_wait_s=0.005, result_cache_bytes=CACHE_BYTES,
                  volume_serving=True, volume_depth_buckets=VOLUME_BUCKETS)
    jax_app = JaxApp(cfg=jcfg, buckets=(1,), **common)
    port_app = ServingApp(cfg=pcfg, buckets=(1, 2), device="cpu", **common)
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


def _both(pair, query: str, body: bytes, headers: dict):
    return [_post(base + "/v1/segment-volume" + query, body, headers)
            for base in (pair.jax, pair.port)]


def _assert_identical(a, b) -> str:
    (sa, pa, ha), (sb, pb, hb) = a, b
    assert sa == sb == 200, (pa, pb)
    assert set(pa) == set(pb)
    for k in pa:
        if k not in EXEMPT:
            assert pa[k] == pb[k], k
    assert pa["z_shards"] == pb["z_shards"] == 1 or pa["cached"]
    assert ha["ETag"] == hb["ETag"]
    return ha["ETag"]


class TestParity:
    @pytest.mark.parametrize("shape,seed", [((3, 64, 64), 1), ((6, 50, 61), 2),
                                            ((8, 64, 40), 3), ((1, 33, 64), 4)])
    def test_raw_study_payload_and_etag(self, pair, shape, seed):
        vol = _study(*shape, seed)
        a, b = _both(pair, "", *_raw(vol))
        _assert_identical(a, b)
        assert b[1]["shape"] == list(shape) and b[2]["X-Nm03-Cache"] == "fill"
        assert _mask_of(b[1]).shape == shape

    @pytest.mark.parametrize("compressed", ["0", "1"])
    def test_mhd_output_equals_the_volume_cli(self, pair, tmp_path, compressed):
        from nm03_capstone_project_tpu_torch.cli import volume as volume_cli
        from nm03_capstone_project_tpu_torch.data.imageio import read_metaimage

        # slices at the full canvas: the CLI writes the canvas-wide mask, the
        # server the study's own extent
        root = tmp_path / "cohort"
        write_synthetic_cohort(root, n_patients=1, n_slices=5, height=CANVAS, width=CANVAS)
        out = tmp_path / "out"
        argv = ["--base-path", str(root), "--output", str(out), "--canvas", str(CANVAS),
                "--min-dim", str(MIN_DIM), "--device", "cpu", "--export-mhd"]
        assert volume_cli.main(argv + (["--mhd-compressed"] if compressed == "1" else [])) == 0
        files = sorted(root.rglob("*.dcm"))
        body = _dicom_parts(np.stack([read_dicom(f).pixels for f in files]), tmp_path)
        a, b = _both(pair, f"?output=mhd&compressed={compressed}", body,
                     {"Content-Type": "application/x-nm03-dicom-parts"})
        _assert_identical(a, b)
        payload = b[1]
        pid_dir = out / "PGBM-0001"
        data_file = "mask.zraw" if compressed == "1" else "mask.raw"
        assert payload["mhd_data_file"] == data_file
        assert base64.b64decode(payload["mhd_header_b64"]) == (pid_dir / "mask.mhd").read_bytes()
        assert base64.b64decode(payload["mhd_data_b64"]) == (pid_dir / data_file).read_bytes()
        assert np.array_equal(read_metaimage(pid_dir / "mask.mhd")[0], _mask_of(payload))
        assert payload["mask_voxels"] > 0

    def test_dicom_bodies_all_work(self, pair, tmp_path):
        vol = np.clip(_study(5, 60, 64, 7), 0, 65535).astype(np.uint16).astype(np.float32)
        raw = _both(pair, "", *_raw(vol))
        parts = _both(pair, "", _dicom_parts(vol, tmp_path),
                      {"Content-Type": "application/x-nm03-dicom-parts"})
        frames = _both(pair, "", _multiframe(vol), {"Content-Type": "application/dicom"})
        masks = []
        for a, b in (raw, parts, frames):
            _assert_identical(a, b)
            masks.append(b[1]["mask_sha256"])
        # three encodings of one study: one mask (each its own result key)
        assert len(set(masks)) == 1 and raw[1][1]["mask_voxels"] > 0

    def test_summary_output(self, pair):
        vol = _study(4, 64, 64, 8)
        a, b = _both(pair, "?output=summary", *_raw(vol))
        _assert_identical(a, b)
        assert "mask_b64" not in b[1] and "mhd_header_b64" not in b[1]
        assert b[1]["mask_voxels"] > 0

    def test_rejections_match(self, pair, tmp_path, monkeypatch):
        deep = np.zeros((9, 32, 32), np.float32)
        small = np.zeros((2, 32, 32), np.float32)
        plane = np.full((32, 32), 100, np.uint16)
        write_dicom(tmp_path / "a.dcm", plane)
        write_dicom(tmp_path / "b.dcm", np.full((32, 40), 100, np.uint16))
        mixed = b"".join(len(p.read_bytes()).to_bytes(4, "little") + p.read_bytes()
                         for p in (tmp_path / "a.dcm", tmp_path / "b.dcm"))
        cases = [
            (*_raw(deep), 413),  # deeper than the largest bucket
            # the body cap: the largest bucket's canvas stack plus 64 KiB
            (b"\0" * (8 * CANVAS * CANVAS * 4 + 65540), _raw_headers(1, CANVAS, CANVAS), 413),
            (small.tobytes()[:100], _raw_headers(2, 32, 32), 400),  # wrong byte count
            (*_raw(np.zeros((2, 8, 8), np.float32)), 400),  # below min_dim
            (*_raw(np.zeros((2, 80, 32), np.float32)), 413),  # past the canvas
            (mixed, {"Content-Type": "application/x-nm03-dicom-parts"}, 400),  # sizes differ
            (mixed[:-10], {"Content-Type": "application/x-nm03-dicom-parts"}, 400),  # truncated
            (b"not dicom", {"Content-Type": "application/dicom"}, 400),
        ]
        for body, headers, want in cases:
            (sa, pa, _), (sb, pb, _) = _both(pair, "", body, headers)
            assert sa == sb == want, (sa, sb, pb)
            assert pa["error"] == pb["error"]
        # a parseable study with no frames: 400 on both
        from nm03_capstone_project_tpu.data import dicomlite as jax_dicomlite
        from nm03_capstone_project_tpu_torch.data import dicomlite

        for mod in (jax_dicomlite, dicomlite):
            monkeypatch.setattr(mod, "read_dicom_frames", lambda path, strict=True: [])
        (sa, pa, _), (sb, pb, _) = _both(pair, "", _multiframe(small),
                                         {"Content-Type": "application/dicom"})
        assert sa == sb == 400 and pa["error"] == pb["error"] == (
            "DICOM study contains no image planes")

    def test_volume_serving_off_is_404(self):
        pcfg, jcfg = _cfgs()
        # never started: the 404 comes before anything touches a lane
        apps = [JaxApp(cfg=jcfg, buckets=(1,), lanes=1),
                ServingApp(cfg=pcfg, buckets=(1,), lanes=1, device="cpu")]
        got = []
        for app, make in zip(apps, (jax_make_http_server, make_http_server)):
            httpd = make(app)
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            try:
                got.append(_post(f"http://127.0.0.1:{httpd.server_address[1]}"
                                 "/v1/segment-volume", *_raw(_study(2, 32, 32, 1))))
            finally:
                httpd.shutdown()
                httpd.server_close()
                app.close()
        (sa, pa, _), (sb, pb, _) = got
        assert sa == sb == 404 and pa["error"] == pb["error"]
        assert "--volume-serving" in pb["error"]

    def test_cache_fill_hit_and_304(self, pair):
        body, headers = _raw(_study(7, 48, 64, 9))
        etag = _assert_identical(*_both(pair, "", body, headers))
        for a, b in [_both(pair, "", body, headers)]:
            assert a[2]["X-Nm03-Cache"] == b[2]["X-Nm03-Cache"] == "hit"
            _assert_identical(a, b)
            assert b[1]["cached"] is True and b[1]["z_shards"] == 0
        for status, payload, hdrs in _both(pair, "", body, {**headers, "If-None-Match": etag}):
            assert status == 304 and payload is None
            assert hdrs["ETag"] == etag and hdrs["X-Nm03-Cache"] == "hit"

    def test_idempotency_key_retry_is_answered_from_the_store(self, pair, monkeypatch):
        first, headers = _raw(_study(3, 64, 56, 10))
        key = {"X-Nm03-Idempotency-Key": "study-10-attempt"}
        etag = _assert_identical(*_both(pair, "", first, {**headers, **key}))
        reg = pair.port_app.registry
        before = reg.get("serving_volume_requests_total", status="ok").value
        real, dispatched = volumes.gang_program, []
        monkeypatch.setattr(volumes, "gang_program", lambda px, dm, cfg: (
            dispatched.append(tuple(px.shape)), real(px, dm, cfg))[1])
        # the retry carries the key (and, here, another body): the key names
        # the first result, which comes from the store, no gang dispatch
        other, oheaders = _raw(_study(3, 64, 56, 11))
        a, b = _both(pair, "", other, {**oheaders, **key})
        _assert_identical(a, b)
        assert b[2]["ETag"] == etag and b[2]["X-Nm03-Cache"] == "hit"
        assert reg.get("serving_volume_requests_total", status="ok").value == before + 1
        assert dispatched == []


class TestPortOnly:
    def test_identical_in_flight_studies_coalesce(self, pair, monkeypatch):
        entered, calls = threading.Event(), []

        def slow(px, dm, cfg):
            # px: the study's z-slabs, one a lane of the gang's mesh
            calls.append((sum(s.shape[0] for s in px),) + tuple(px[0].shape[1:]))
            entered.set()
            time.sleep(0.5)
            return gang_program(px, dm, cfg)

        gang_program = volumes.gang_program
        monkeypatch.setattr(volumes, "gang_program", slow)
        body, headers = _raw(_study(5, 64, 64, 12))
        url = pair.port + "/v1/segment-volume"
        out = [None, None]

        def send(i):
            out[i] = _post(url, body, headers)

        first = threading.Thread(target=send, args=(0,))
        first.start()
        assert entered.wait(30)
        second = threading.Thread(target=send, args=(1,))
        second.start()
        for t in (first, second):
            t.join(timeout=60)
            assert not t.is_alive()
        assert calls == [(8, CANVAS, CANVAS)]  # one dispatch, at bucket 8
        (s0, p0, h0), (s1, p1, h1) = out
        assert s0 == s1 == 200 and p0["mask_b64"] == p1["mask_b64"]
        assert (h0["X-Nm03-Cache"], h1["X-Nm03-Cache"]) == ("fill", "hit")
        assert p1["cached"] is True
        st = json.loads(urllib.request.urlopen(pair.port + "/readyz").read())
        assert st["result_cache"]["inflight"]["coalesced"] >= 1
        assert st["result_cache"]["inflight"]["in_flight"] == 0

    def test_mixed_slice_and_volume_traffic_fails_no_slice(self, pair):
        from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice

        slices = [phantom_slice(60, 52, seed=s).astype("<f4").tobytes() for s in range(12)]
        vols = [_raw(_study(6, 64, 64, 20 + s)) for s in range(3)]
        out = {}

        def slice_req(i):
            out[("s", i)] = _post(pair.port + "/v1/segment?output=mask", slices[i],
                                  {"Content-Type": "application/octet-stream",
                                   "X-Nm03-Height": "60", "X-Nm03-Width": "52"})

        def vol_req(i):
            out[("v", i)] = _post(pair.port + "/v1/segment-volume?output=summary", *vols[i])

        threads = ([threading.Thread(target=slice_req, args=(i,)) for i in range(12)]
                   + [threading.Thread(target=vol_req, args=(i,)) for i in range(3)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert len(out) == 15 and all(r[0] == 200 for r in out.values()), {
            k: r[0] for k, r in out.items()}

    def test_gang_runs_the_dilate_schedule_as_the_jax_gang(self):
        """zshard grows by dilation whatever ``grow_algorithm`` says: a server
        started with the jump schedule serves the dilate masks in both
        packages (a truncating cap makes the two schedules differ)."""
        kw = dict(grow_algorithm="jump", grow_block_iters=1, grow_max_iters=3)
        pcfg, jcfg = _cfgs(**kw)
        vol = _study(4, 64, 64, 5)
        japp = JaxApp(cfg=jcfg, buckets=(1,), lanes=1, volume_serving=True,
                      volume_depth_buckets=(4,))
        papp = ServingApp(cfg=pcfg, buckets=(1,), lanes=1, device="cpu", volume_serving=True,
                          volume_depth_buckets=(4,))
        try:
            japp.volumes.start()  # the gang alone: its program compiles on first use
            papp.start()
            jp, pp = japp.segment_volume(vol.copy()), papp.segment_volume(vol.copy())
        finally:
            for app in (japp, papp):
                app.begin_drain(reason="test")
                app.close()
        assert jp["mask_b64"] == pp["mask_b64"] and jp["grow_converged"] is False
        assert jp["grow_converged"] == pp["grow_converged"]
        dims = np.asarray([64, 64], np.int32)
        dilate = process_volume(vol, dims, dataclasses.replace(pcfg, grow_algorithm="dilate"),
                                device="cpu")
        jump = process_volume(vol, dims, pcfg, device="cpu")
        assert np.array_equal(_mask_of(pp), dilate["mask"].numpy())
        assert not np.array_equal(_mask_of(pp), jump["mask"].numpy())


def _one_lane_app(**kw):
    pcfg, _ = _cfgs()
    return ServingApp(cfg=pcfg, buckets=(1,), lanes=1, device="cpu", volume_serving=True,
                      volume_depth_buckets=(4,),
                      resilience=ResilienceConfig(retry_max=0), **kw)


class TestGangFailures:
    def test_errors_are_responses_never_a_fallback(self, monkeypatch):
        app = _one_lane_app()
        httpd, _, port = serve_in_thread(app)
        url = f"http://127.0.0.1:{port}/v1/segment-volume"
        body, headers = _raw(_study(2, 64, 64, 3))
        try:
            # a deterministic error goes back to the requester; the lane stays
            def broken(px, dm, cfg):
                raise ValueError("a bug in the program")

            monkeypatch.setattr(volumes, "gang_program", broken)
            status, payload, _ = _post(url, body, headers)
            assert status == 500 and payload["error_class"] == "ValueError"
            assert app.executor.healthy_lanes() == [0]

            # a lane fault on the only lane: quarantined, then 503 + Retry-After
            def lost(px, dm, cfg):
                raise TransientDeviceError("the card fell off the bus")

            monkeypatch.setattr(volumes, "gang_program", lost)
            status, payload, hdrs = _post(url, body, headers)
            assert status == 503 and hdrs["Retry-After"] == "1"
            assert "no healthy lane" in payload["error"]
            assert app.executor.healthy_lanes() == []
            reg = app.registry
            assert reg.get("serving_lane_quarantines_total", lane="0",
                           cause="device_lost").value == 1
            assert reg.get("serving_volume_requests_total", status="shed").value == 1
            assert reg.get("serving_volume_requests_total", status="error").value == 1
            st = json.loads(urllib.request.urlopen(
                url.replace("/v1/segment-volume", "/healthz")).read())
            assert st["status"] == "alive"
        finally:
            app.begin_drain(reason="test")
            httpd.shutdown()
            httpd.server_close()
            app.close()

    def test_lane_fault_requeues_onto_the_next_lane(self, monkeypatch):
        """Two lanes (both the CPU here): the study runs over a mesh of both;
        a fault while the fleet books lane 0's death re-meshes the study
        onto lane 1, with a volume_requeue span and the same mask."""
        app = _one_lane_app()
        app.start()
        try:
            dev = app.executor.healthy_lane_devices()[0][1]
            # the fleet's own view of dead lanes, apart from what the gang books
            fleet_dead, booked = [], []
            monkeypatch.setattr(app.executor, "healthy_lane_devices", lambda: [
                (ln, dev) for ln in (0, 1) if ln not in fleet_dead])
            monkeypatch.setattr(app.executor, "quarantine_lane",
                                lambda lane, cause: booked.append(lane))
            vol = _study(3, 64, 64, 4)
            want = app.segment_volume(vol.copy())
            real, fired = volumes.gang_program, []

            def once(px, dm, cfg):
                if not fired:
                    fired.append(1)
                    fleet_dead.append(0)  # the fleet sees lane 0 die
                    raise TransientDeviceError("lost")
                return real(px, dm, cfg)

            monkeypatch.setattr(volumes, "gang_program", once)
            req = app.volumes.submit(vol.copy(), (64, 64))
            assert req.wait(60) and req.error is None
            assert want["z_shards"] == 2 and req.z_shards == 1
            # the fleet booked the death; the gang only re-meshed, blaming no lane
            assert booked == [] and req.lane == 1 and req.requeues == 1
            assert "volume_requeue" in [s["name"] for s in req.trace.snapshot()]
            assert base64.b64encode(req.mask.tobytes()).decode() == want["mask_b64"]
        finally:
            app.begin_drain(reason="test")
            app.close()

    def test_a_failed_bucket_warmup_fails_start(self, monkeypatch):
        def broken(px, dm, cfg):
            raise RuntimeError("warmup broke")

        monkeypatch.setattr(volumes, "gang_program", broken)
        app = _one_lane_app()
        try:
            with pytest.raises(RuntimeError, match="warmup broke"):
                app.start()
            assert not app.batcher._started and not app.volumes._started
        finally:
            app.close()

    def test_no_gpu_and_no_cpu_request_refuses_to_start(self, monkeypatch, capsys, tmp_path):
        from nm03_capstone_project_tpu_torch.serving import server

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        port_file = tmp_path / "port"
        argv = ["--port", "0", "--port-file", str(port_file), "--heartbeat-s", "0",
                "--volume-serving", "--volume-depth-buckets", "4"]
        assert server.main(argv) == 1
        assert "CUDA is not available" in capsys.readouterr().err
        assert not port_file.exists()


class TestGang:
    @pytest.mark.parametrize("depth,want", [(1, 8), (8, 8), (9, 16), (25, 32), (32, 32)])
    def test_padded_depth_as_the_jax_gang(self, depth, want):
        pcfg, jcfg = _cfgs()
        port, ref = VolumeGang(pcfg, None, None), JaxGang(jcfg, None, None)
        assert port.padded_depth(depth) == ref.padded_depth(depth, 1) == want

    def test_too_deep_and_bad_buckets_raise_as_the_jax_gang(self):
        pcfg, jcfg = _cfgs()
        with pytest.raises(ValueError, match="exceeds the largest"):
            VolumeGang(pcfg, None, None).padded_depth(33)
        with pytest.raises(ValueError, match="exceeds the largest"):
            JaxGang(jcfg, None, None).padded_depth(33, 1)
        for bad in ((), (8, 8), (16, 8), (0, 4)):
            for cls, cfg in ((VolumeGang, pcfg), (JaxGang, jcfg)):
                with pytest.raises(ValueError):
                    cls(cfg, None, None, depth_buckets=bad)

    def test_one_lane_wide_until_the_mesh_is_ported(self, monkeypatch):
        """The mesh is ported: a pool of three lanes warms every bucket over
        all three, at the bucket rounded up to a multiple of the width."""
        pcfg, _ = _cfgs()
        pool = [(2, torch.device("cpu")), (5, torch.device("cpu")), (7, torch.device("cpu"))]
        gang = VolumeGang(pcfg, SimpleNamespace(healthy_lane_devices=lambda: pool), None)
        assert gang.z_shards == 0 and gang.default_cost == 8 and gang.max_depth == 32
        ran = []
        monkeypatch.setattr(gang, "_run_program", lambda stack, dims, lanes, devices, trace=None:
                            ran.append((stack.shape[0], tuple(lanes))))
        assert set(gang.warmup()) == {8, 16, 32}
        assert ran == [(9, (2, 5, 7)), (18, (2, 5, 7)), (33, (2, 5, 7))]
        assert gang.z_shards == 3
        # the fault-plan seam is ported: the gang keeps the plan for its
        # `volume` site (tests/test_torch_serving_ops.py drives it)
        from nm03_capstone_project_tpu_torch.resilience import FaultPlan

        plan = FaultPlan.from_spec({"faults": [{"site": "volume", "kind": "dispatch_error"}]})
        assert VolumeGang(pcfg, None, None, fault_plan=plan).fault_plan is plan

    def test_gang_warms_up_after_the_executor(self, monkeypatch):
        app = _one_lane_app()
        order = []
        for name, obj in (("executor", app.executor), ("gang", app.volumes),
                          ("batcher", app.batcher)):
            meth = "start" if name == "batcher" else "warmup"
            real = getattr(obj, meth)
            monkeypatch.setattr(obj, meth, lambda real=real, name=name: (
                order.append(name), real())[1])
        try:
            timings = app.start()
            assert order == ["executor", "gang", "batcher"]
            assert set(timings["volume"]) == {4}
            st = app.status()
            assert st["volumes"]["enabled"] and st["volumes"]["z_shards"] == 1
            assert st["volumes"]["depth_buckets"] == [4]
        finally:
            app.begin_drain(reason="test")
            app.close()


def _four_lane_app(**kw):
    pcfg, _ = _cfgs()
    return ServingApp(cfg=pcfg, buckets=(1,), device="cpu", lane_devices=["cpu"] * 4,
                      volume_serving=True, volume_depth_buckets=(4, 8, 16),
                      resilience=ResilienceConfig(retry_max=0), **kw)


class TestFourLaneGang:
    def test_z_shards_four_and_the_masks_of_the_driver(self, tmp_path, monkeypatch):
        from nm03_capstone_project_tpu_torch.cli import volume as volume_cli
        from nm03_capstone_project_tpu_torch.data.imageio import read_metaimage
        from nm03_capstone_project_tpu_torch.parallel import make_mesh, mesh
        from nm03_capstone_project_tpu_torch.parallel import process_volume_zsharded

        root = tmp_path / "cohort"
        write_synthetic_cohort(root, n_patients=1, n_slices=10, height=CANVAS, width=CANVAS)
        out = tmp_path / "out"
        monkeypatch.setattr(mesh, "local_devices",
                            lambda device=None: [torch.device("cpu")] * 4)
        argv = ["--base-path", str(root), "--output", str(out), "--canvas", str(CANVAS),
                "--min-dim", str(MIN_DIM), "--device", "cpu", "--export-mhd", "--z-shard"]
        assert volume_cli.main(argv) == 0
        driver_mask = read_metaimage(out / "PGBM-0001" / "mask.mhd")[0]
        vol = np.stack([read_dicom(f).pixels for f in sorted(root.rglob("*.dcm"))])
        app = _four_lane_app()
        try:
            httpd, _, port = serve_in_thread(app)  # warms the gang at width 4
            assert app.volumes.z_shards == 4 and app.status()["volumes"]["z_shards"] == 4
            try:
                status, payload, hdrs = _post(f"http://127.0.0.1:{port}/v1/segment-volume",
                                              *_raw(vol))
            finally:
                httpd.shutdown()
                httpd.server_close()
            assert status == 200 and payload["z_shards"] == 4
            assert hdrs["X-Nm03-Z-Shards"] == "4"
            assert app.registry.get("serving_volume_zshards").value == 4
        finally:
            app.begin_drain(reason="test")
            app.close()
        served = _mask_of(payload)
        assert served.shape == (10, CANVAS, CANVAS) and served.sum() > 0
        np.testing.assert_array_equal(served, driver_mask)
        stack = np.zeros((16, CANVAS, CANVAS), np.float32)
        stack[:10] = vol
        direct = process_volume_zsharded(stack, np.asarray([CANVAS, CANVAS], np.int32),
                                         _cfgs()[0], make_mesh(devices=["cpu"] * 4,
                                                               axis_names=("z",)))
        np.testing.assert_array_equal(served, direct["mask"][:10].numpy())
        assert payload["grow_converged"] == bool(direct["grow_converged"])

    @pytest.mark.parametrize("depth,n,want", [
        (1, 4, 4), (4, 4, 4), (5, 3, 9), (8, 3, 9), (9, 4, 16), (16, 3, 18), (3, 2, 4)])
    def test_padded_depth_rounds_to_the_mesh_as_the_jax_gang(self, depth, n, want):
        pcfg, jcfg = _cfgs()
        buckets = (4, 8, 16)
        port = VolumeGang(pcfg, None, None, depth_buckets=buckets)
        ref = JaxGang(jcfg, None, None, depth_buckets=buckets)
        assert port.padded_depth(depth, n) == ref.padded_depth(depth, n) == want

    @pytest.mark.parametrize("morph,pool,depth,want", [
        (3, 4, 4, 4), (5, 4, 4, 3), (5, 4, 8, 4), (7, 4, 4, 1), (7, 3, 16, 3), (1, 4, 4, 4)])
    def test_usable_shards_respects_the_halo_as_the_jax_gang(self, morph, pool, depth, want):
        pcfg, jcfg = _cfgs(morph_size=morph)
        buckets = (4, 8, 16)
        port = VolumeGang(pcfg, None, None, depth_buckets=buckets)
        ref = JaxGang(jcfg, None, None, depth_buckets=buckets)
        assert port._usable_shards(pool, depth) == ref._usable_shards(pool, depth) == want

    def test_warmup_runs_each_bucket_at_its_dispatch_width(self, monkeypatch):
        pcfg, _ = _cfgs(morph_size=5)
        pool = [(i, torch.device("cpu")) for i in range(4)]
        gang = VolumeGang(pcfg, SimpleNamespace(healthy_lane_devices=lambda: pool), None,
                          depth_buckets=(4, 8, 16))
        ran = []
        monkeypatch.setattr(gang, "_run_program", lambda stack, dims, lanes, devices,
                            trace=None: ran.append((stack.shape[0], len(lanes))))
        gang.warmup()
        # halo 2: the 4-plane bucket pads to 6 over three lanes, the deeper
        # ones split four ways
        assert ran == [(6, 3), (8, 4), (16, 4)] and gang.z_shards == 4

    def test_lane_death_mid_volume_remeshes_onto_three_lanes(self):
        from nm03_capstone_project_tpu_torch.resilience import FaultPlan

        plan = FaultPlan.from_spec({"faults": [
            {"site": "volume", "kind": "dispatch_error", "lane": 2, "index": 1}]})
        app = _four_lane_app(fault_plan=plan, lane_probe_interval_s=60.0)
        vol = _study(7, 64, 60, 9)
        try:
            app.start()
            first = app.segment_volume(vol.copy())
            req = app.volumes.submit(vol.copy(), (64, 60))
            assert req.wait(60) and req.error is None
        finally:
            app.begin_drain(reason="test")
            app.close()
        assert first["z_shards"] == 4 and first["requeues"] == 0
        assert req.z_shards == 3 and req.lanes == [0, 1, 3] and req.requeues == 1
        assert base64.b64encode(req.mask.tobytes()).decode() == first["mask_b64"]
        assert "volume_requeue" in [s["name"] for s in req.trace.snapshot()]
        reg = app.registry
        assert reg.get("serving_lane_quarantines_total", lane="2",
                       cause="device_lost").value == 1
        assert reg.get("resilience_faults_injected_total", site="volume",
                       kind="dispatch_error").value == 1
        assert app.executor.healthy_lanes() == [0, 1, 3]

    def test_a_mesh_fault_with_the_fleet_unchanged_is_shed(self, monkeypatch):
        """A lane fault over the four-lane mesh that the fleet does not
        attribute to a lane: 503 + Retry-After, and no lane is blamed."""
        app = _four_lane_app()
        httpd, _, port = serve_in_thread(app)
        fired = []

        def lost(px, dm, cfg):
            fired.append(len(px))
            raise TransientDeviceError("an NCCL peer went away")

        monkeypatch.setattr(volumes, "gang_program", lost)
        try:
            status, payload, hdrs = _post(f"http://127.0.0.1:{port}/v1/segment-volume",
                                          *_raw(_study(5, 64, 64, 8)))
            assert status == 503 and hdrs["Retry-After"] == "1"
            assert "no attributable lane" in payload["error"]
            assert fired == [4]
            assert app.executor.healthy_lanes() == [0, 1, 2, 3]
            assert app.registry.get("serving_volume_requests_total", status="shed").value == 1
        finally:
            app.begin_drain(reason="test")
            httpd.shutdown()
            httpd.server_close()
            app.close()

    def test_lanes_that_share_a_device_share_its_peak(self):
        from nm03_capstone_project_tpu_torch.obs.saturation import SaturationMonitor

        clock = [0.0]
        mon = SaturationMonitor(clock=lambda: clock[0])
        clock[0] = 100.0  # a full window after the monitor started
        kind = "NVIDIA H100 80GB HBM3"
        mon.set_lanes([("cuda", kind, "cuda:0")] * 4)
        for lane in range(4):
            mon.set_lane_bucket_flops(lane, 1, 1e12)
            mon.record_dispatch(lane, 99.0, 100.0, bucket=1)
        snap = mon.snapshot()
        peak = snap["lanes"][0]["peak_flops"]
        # four lanes of one card: their flops over ONE card's peak
        assert snap["mfu"] == round((4e12 / snap["window_s"]) / peak, 6)
        assert all(row["mfu"] == round((1e12 / snap["window_s"]) / peak, 6)
                   for row in snap["lanes"])
        mon.set_lanes([("cuda", kind, f"cuda:{i}") for i in range(4)])
        assert mon.snapshot()["mfu"] == round((4e12 / snap["window_s"]) / (4 * peak), 6)


class TestGangAcrossAJob:
    """``--distributed-init``: the gang's z-mesh is the job's process group.
    A world of 1 (gloo) runs every broadcast and collective of the
    cross-process dispatch in this process; ``tests/test_torch_distributed.py``
    runs two ranks."""

    LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                    "SLURM_STEP_NODELIST", "OMPI_COMM_WORLD_SIZE")

    @pytest.fixture
    def world_of_one(self, monkeypatch):
        import socket

        from nm03_capstone_project_tpu_torch.parallel import distributed

        for var in self.LAUNCHER_ENV:
            monkeypatch.delenv(var, raising=False)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        assert distributed.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu")
        try:
            yield distributed
        finally:
            distributed.shutdown()

    def test_a_world_of_one_serves_the_jax_gangs_mask(self, pair, world_of_one, monkeypatch):
        broadcasts = []
        real = world_of_one.broadcast_study

        def counted(op=world_of_one.OP_STUDY, stack=None, dims=None):
            broadcasts.append(op)
            return real(op, stack, dims)

        monkeypatch.setattr(world_of_one, "broadcast_study", counted)
        app = _one_lane_app(distributed_init=True)
        httpd, _, port = serve_in_thread(app)
        try:
            vols = app.status()["volumes"]
            assert (vols["distributed"], vols["processes"], vols["z_shards"], vols["ready"],
                    vols["down_cause"]) == (True, 1, 1, True, None)
            assert broadcasts == [world_of_one.OP_STUDY]  # the warmup of bucket 4
            body, headers = _raw(_study(3, 64, 60, 5))
            got = _post(f"http://127.0.0.1:{port}/v1/segment-volume", body, headers)
            want = _post(pair.jax + "/v1/segment-volume", body, headers)
            assert got[0] == want[0] == 200 and got[1]["z_shards"] == 1
            assert got[1]["mask_b64"] == want[1]["mask_b64"]
            assert got[1]["grow_converged"] == want[1]["grow_converged"]
        finally:
            app.begin_drain(reason="test")
            httpd.shutdown()
            httpd.server_close()
            app.close()
        # the drain's close sent the followers' stop, once
        assert broadcasts == [world_of_one.OP_STUDY] * 2 + [world_of_one.OP_STOP]

    def test_a_failed_cross_process_dispatch_marks_the_gang_down(self, world_of_one,
                                                                 monkeypatch):
        app = _one_lane_app(distributed_init=True)
        httpd, _, port = serve_in_thread(app)
        base = f"http://127.0.0.1:{port}"
        try:
            def lost(stack, dims, cfg):
                raise RuntimeError("Connection closed by peer")

            monkeypatch.setattr(volumes, "distributed_gang_program", lost)
            body, headers = _raw(_study(2, 64, 64, 3))
            for _ in range(2):  # the failure, then every later study at once
                status, payload, hdrs = _post(base + "/v1/segment-volume", body, headers)
                assert status == 503 and hdrs["Retry-After"] == "1", payload
            vols = app.status()["volumes"]
            assert vols["ready"] is False and "Connection closed by peer" in vols["down_cause"]
            assert app.registry.get("serving_volume_requests_total", status="shed").value == 2
            # no lane is blamed, and slices keep serving
            assert app.executor.healthy_lanes() == [0]
            status, sl, _ = _post(base + "/v1/segment", body[: 64 * 64 * 4],
                                  {"Content-Type": "application/octet-stream",
                                   "X-Nm03-Height": "64", "X-Nm03-Width": "64"})
            assert status == 200 and "mask_pixels" in sl
        finally:
            app.begin_drain(reason="test")
            httpd.shutdown()
            httpd.server_close()
            app.close()

    def test_an_idle_gang_keeps_its_followers_waiting(self, world_of_one, monkeypatch):
        """An idle cross-process gang broadcasts keepalives (well inside
        the process group's timeout in service; shortened here), and a
        keepalive that fails marks the gang down as a dispatch does."""
        sent, fail = [], []
        real = world_of_one.broadcast_study

        def counted(op=world_of_one.OP_STUDY, stack=None, dims=None):
            if fail and op == world_of_one.OP_KEEPALIVE:
                raise RuntimeError("Connection closed by peer")
            sent.append(op)
            return real(op, stack, dims)

        monkeypatch.setattr(world_of_one, "broadcast_study", counted)
        monkeypatch.setattr(volumes, "KEEPALIVE_S", 0.05)
        app = _one_lane_app(distributed_init=True)
        try:
            app.start()
            deadline = time.monotonic() + 30
            while sent.count(world_of_one.OP_KEEPALIVE) < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert sent.count(world_of_one.OP_KEEPALIVE) >= 3
            fail.append(True)
            while app.status()["volumes"]["ready"] and time.monotonic() < deadline:
                time.sleep(0.01)
            vols = app.status()["volumes"]
            assert vols["ready"] is False and vols["down_cause"].startswith("keepalive")
        finally:
            app.begin_drain(reason="test")
            app.close()
        assert world_of_one.OP_STOP not in sent  # a gang that is down sends no stop

    def test_outside_a_job_the_gang_is_the_lanes(self):
        app = _one_lane_app(distributed_init=True)
        try:
            app.start()
            vols = app.status()["volumes"]
            assert (vols["distributed"], vols["processes"], vols["z_shards"]) == (False, 1, 1)
        finally:
            app.begin_drain(reason="test")
            app.close()
