"""The port's server under load and under faults, held against the JAX one.

Both servers are built in process at canvas 128 (one lane, the result tier
on), each with the same fault plan and the same SLO, and served over
loopback:

* two ``dispatch``/``transient`` fires are retried and answered 200, with
  masks equal to the JAX server's; a ``cache``/``corrupt_entry`` fire makes
  the store evict and recompute on both;
* ``/readyz`` carries ``saturation``, ``ledger`` and ``slo`` blocks with the
  JAX key sets, and the port's ledger accounts sum to its executor's busy
  seconds;
* the four ``/debug`` routes answer with the JAX status codes and schemas;
* the volume gang's ``volume`` site blames the dispatching lane as the JAX
  gang does (quarantine, 503 with ``Retry-After`` when no lane is left) and
  sheds an unattributable failure without blaming one;
* the load generators cross: the port's against the JAX server, the JAX
  package's against the port's, with the same status mix and schema.

What only the port does: a ``dispatch``/``hang`` under a shorter
``dispatch_timeout_s`` quarantines the one lane (``/readyz`` 503
``degraded``) and the probation probe reinstates it (the JAX server falls
back to the CPU instead).
"""

import json
import math
import pathlib
import sys
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402,F401
import torch  # noqa: E402

from nm03_capstone_project_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from nm03_capstone_project_tpu.obs.slo import SLOObjective as JaxObjective  # noqa: E402
from nm03_capstone_project_tpu.resilience import FaultPlan as JaxPlan  # noqa: E402
from nm03_capstone_project_tpu.serving import loadgen as jax_loadgen  # noqa: E402
from nm03_capstone_project_tpu.serving.server import ServingApp as JaxApp  # noqa: E402
from nm03_capstone_project_tpu.serving.server import (  # noqa: E402
    serve_in_thread as jax_serve_in_thread,
)
from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.data.synthetic import (  # noqa: E402
    phantom_slice,
    phantom_volume,
)
from nm03_capstone_project_tpu_torch.obs.slo import SLOObjective  # noqa: E402
from nm03_capstone_project_tpu_torch.resilience import FaultPlan, ResilienceConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.serving import loadgen  # noqa: E402
from nm03_capstone_project_tpu_torch.serving.server import (  # noqa: E402
    ServingApp,
    serve_in_thread,
)
from nm03_capstone_project_tpu_torch.utils import profiling  # noqa: E402

CANVAS = 128
BUCKETS = (1, 2)
CACHE_BYTES = 1 << 24
PLAN = {"seed": 4, "faults": [
    {"site": "dispatch", "kind": "transient", "count": 2},
    {"site": "cache", "kind": "corrupt_entry", "count": 1},
]}
SLO = {"availability_pct": 99.0, "latency_target_s": 1.0}
FIELDS = ("shape", "grow_converged", "mask_pixels", "mask_sha256")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _post(url: str, body: bytes, headers: dict, timeout=120.0):
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, json.loads(raw) if raw else None, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None, dict(e.headers)


def _get(url: str, timeout=60.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _slice(seed: int, h=CANVAS, w=120):
    return phantom_slice(h, w, seed=seed).astype("<f4").tobytes(), {
        "Content-Type": "application/octet-stream",
        "X-Nm03-Height": str(h), "X-Nm03-Width": str(w)}


def _serve(apps):
    servers = []
    for app, serve in apps:
        httpd, _, port = serve(app)
        servers.append((app, httpd, f"http://127.0.0.1:{port}"))
    return servers


def _stop(servers):
    for app, httpd, _ in servers:
        app.begin_drain(reason="test_teardown")
        httpd.shutdown()
        httpd.server_close()
        app.close()


def _counter(app, name, **labels):
    m = app.registry.get(name, **labels)
    return None if m is None else m.value


@pytest.fixture(scope="module")
def pair():
    """The JAX app and the port's, one fault plan and one SLO each."""
    common = dict(buckets=BUCKETS, lanes=1, max_wait_s=0.005, result_cache_bytes=CACHE_BYTES)
    jax_app = JaxApp(cfg=JaxConfig(canvas=CANVAS), fault_plan=JaxPlan.from_spec(PLAN),
                     slo=JaxObjective(**SLO), **common)
    port_app = ServingApp(cfg=PipelineConfig(canvas=CANVAS), fault_plan=FaultPlan.from_spec(PLAN),
                          slo=SLOObjective(**SLO), device="cpu", **common)
    servers = _serve([(jax_app, jax_serve_in_thread), (port_app, serve_in_thread)])
    yield SimpleNamespace(jax=servers[0][2], port=servers[1][2], jax_app=jax_app,
                          port_app=port_app)
    _stop(servers)


# -- the fault plan on both servers ----------------------------------------------


def test_transient_dispatch_faults_are_retried_and_masks_equal(pair):
    for seed in range(4):
        body, headers = _slice(seed)
        (sj, pj, _), (sp, pp, _) = (_post(base + "/v1/segment?output=mask", body, headers)
                                    for base in (pair.jax, pair.port))
        assert sj == sp == 200
        assert {k: pp[k] for k in FIELDS} == {k: pj[k] for k in FIELDS}
    for app in (pair.jax_app, pair.port_app):
        assert _counter(app, "resilience_faults_injected_total", site="dispatch",
                        kind="transient") == 2
        assert _counter(app, "resilience_retries_total", cause="serve_dispatch") == 2
        assert _counter(app, "serving_requests_total", status="ok") >= 4


def test_corrupt_entry_is_evicted_and_recomputed(pair):
    body, headers = _slice(40)
    states = {}
    for name, base in (("jax", pair.jax), ("port", pair.port)):
        seen = []
        for _ in range(3):
            status, payload, h = _post(base + "/v1/segment?output=mask", body, headers)
            assert status == 200
            seen.append((h.get("X-Nm03-Cache"), payload["mask_sha256"]))
        states[name] = seen
    assert states["port"] == states["jax"]
    assert [s for s, _ in states["port"]] == ["fill", "fill", "hit"]
    for app in (pair.jax_app, pair.port_app):
        assert _counter(app, "resilience_faults_injected_total", site="cache",
                        kind="corrupt_entry") == 1
        assert app.result_store.stats()["corrupt_evictions"] == 1


def _traffic(pair, seed: int):
    body, headers = _slice(seed)
    for base in (pair.jax, pair.port):
        assert _post(base + "/v1/segment?output=mask", body, headers)[0] == 200


def test_readyz_blocks_have_the_jax_key_sets(pair):
    _traffic(pair, 70)
    (sj, bj), (sp, bp) = _get(pair.jax + "/readyz"), _get(pair.port + "/readyz")
    jst, pst = json.loads(bj), json.loads(bp)
    assert sj == sp == 200
    for block in ("saturation", "ledger", "slo"):
        assert pst[block] is not None and set(pst[block]) == set(jst[block]), block
    assert set(pst["saturation"]["lanes"][0]) == set(jst["saturation"]["lanes"][0])
    assert set(pst["saturation"]["rows"]) == set(jst["saturation"]["rows"])
    assert set(pst["slo"]["objective"]) == set(jst["slo"]["objective"])
    assert pst["slo"]["objective"] == jst["slo"]["objective"]
    assert set(pst["ledger"]["accounts"]) == set(jst["ledger"]["accounts"])
    assert set(pst["ledger"]["requests"]) == set(jst["ledger"]["requests"])
    assert set(pst["ledger"]["hbm_bytes"]) == {str(b) for b in BUCKETS}
    sat = pst["saturation"]
    assert 0.0 < sat["busy_fraction"] <= 1.0
    assert sat["lanes"][0]["peak_flops"] == 2e12  # the CPU estimate both packages use
    assert pst["slo"]["error_budget_remaining"] <= 1.0


def test_ledger_accounts_sum_to_the_executors_busy_seconds(pair):
    body, headers = _slice(60)
    assert _post(pair.port + "/v1/segment?output=mask", body, headers)[0] == 200
    snap = json.loads(_get(pair.port + "/readyz")[1])["ledger"]
    busy = pair.port_app.executor.busy_seconds
    assert busy > 0
    assert math.isclose(snap["device_seconds_total"], busy, rel_tol=1e-8, abs_tol=1e-8)
    assert math.isclose(sum(snap["accounts"].values()), busy, rel_tol=1e-8, abs_tol=1e-8)
    assert snap["requests"]["count"] >= 1


def test_metrics_scrapes_refresh_the_planes(pair):
    _traffic(pair, 75)
    text = _get(pair.port + "/metrics")[1].decode()
    for name in ("serving_busy_fraction", "serving_lane_peak_flops", "serving_mfu",
                 "serving_padding_waste_ratio", "serving_device_seconds_total",
                 "serving_executable_hbm_bytes", "slo_burn_rate_fast",
                 "slo_error_budget_remaining", "resilience_faults_injected_total"):
        assert name in text, name
    snap = json.loads(_get(pair.port + "/metrics.json")[1])
    assert any(m["name"] == "slo_objective_info" for m in snap["metrics"])


# -- the /debug routes -------------------------------------------------------------


def test_debug_flightrec_and_result_cache(pair):
    _traffic(pair, 80)
    for path in ("/debug/flightrec", "/debug/result-cache"):
        (sj, bj), (sp, bp) = _get(pair.jax + path), _get(pair.port + path)
        assert sj == sp == 200, path
        jb, pb = json.loads(bj), json.loads(bp)
        assert set(pb) == set(jb), path
    rc = json.loads(_get(pair.port + "/debug/result-cache")[1])
    assert rc["entries"] == len(rc["ls"]) > 0
    assert set(rc["ls"][0]) == set(json.loads(_get(pair.jax + "/debug/result-cache")[1])["ls"][0])
    for base in (pair.jax, pair.port):
        assert _post(base + "/debug/result-cache/evict?digest=0000", b"", {})[1] == {"evicted": 0}
    assert _get(pair.port + "/debug/nowhere")[0] == _get(pair.jax + "/debug/nowhere")[0] == 404


def test_debug_profile(pair):
    status, body = _get(pair.port + "/debug/profile?ms=50")
    assert status == 200
    cap = json.loads(body)
    jstatus, jbody = _get(pair.jax + "/debug/profile?ms=50")
    assert jstatus == 200 and set(cap) == set(json.loads(jbody))
    assert cap["duration_ms"] == 50 and cap["files"][0]["name"].endswith(".trace.json")
    for bad in ("ms=5", "ms=20000", "ms=abc"):
        assert _get(pair.port + f"/debug/profile?{bad}")[0] == 400
        assert _get(pair.jax + f"/debug/profile?{bad}")[0] == 400
    # the ledger sampler's lock: a held profiler is a 409, never a queue
    with profiling.exclusive_profiler():
        req = urllib.request.Request(pair.port + "/debug/profile?ms=50")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 409 and exc.value.headers["Retry-After"] == "1"


def test_evict_all_and_a_tierless_server():
    app = ServingApp(cfg=PipelineConfig(canvas=CANVAS), buckets=(1,), device="cpu",
                     result_cache_bytes=CACHE_BYTES)
    bare = ServingApp(cfg=PipelineConfig(canvas=CANVAS), buckets=(1,), device="cpu")
    servers = _serve([(app, serve_in_thread), (bare, serve_in_thread)])
    try:
        base, bare_base = servers[0][2], servers[1][2]
        for seed in (1, 2):
            assert _post(base + "/v1/segment?output=mask", *_slice(seed))[0] == 200
        assert _post(base + "/debug/result-cache/evict", b"", {})[1] == {"evicted": 2}
        assert json.loads(_get(base + "/debug/result-cache")[1])["entries"] == 0
        assert app.registry.get("serving_result_cache_bytes").value == 0
        assert _post(bare_base + "/debug/result-cache/evict", b"", {})[0] == 404
        assert json.loads(_get(bare_base + "/debug/result-cache")[1]) == {"enabled": False}
    finally:
        _stop(servers)


# -- what only the port does: the one lane comes back ---------------------------


def test_hang_past_the_deadline_quarantines_and_the_probe_reinstates():
    plan = {"faults": [{"site": "dispatch", "kind": "hang", "index": 2, "hang_s": 30.0}]}
    app = ServingApp(cfg=PipelineConfig(canvas=CANVAS), buckets=(1,), device="cpu",
                     max_wait_s=0.0, fault_plan=FaultPlan.from_spec(plan),
                     resilience=ResilienceConfig(dispatch_timeout_s=1.0),
                     lane_probe_interval_s=0.3, slo=SLOObjective(**SLO))
    servers = _serve([(app, serve_in_thread)])
    base = servers[0][2]
    try:
        statuses = [_post(base + "/v1/segment?output=mask", *_slice(s))[0] for s in range(3)]
        assert statuses == [200, 200, 504]  # dispatch 2 hung past its 1 s deadline
        status, body = _get(base + "/readyz")
        if status == 503:  # the window before the probe's first pass
            st = json.loads(body)
            assert st["degraded"] is True and st["degraded_cause"] == "deadline"
        deadline = time.monotonic() + 20
        while _get(base + "/readyz")[0] != 200 and time.monotonic() < deadline:
            time.sleep(0.1)
        st = json.loads(_get(base + "/readyz")[1])
        assert st["ready"] and not st["degraded"] and st["capacity"] == 1.0
        assert _post(base + "/v1/segment?output=mask", *_slice(7))[0] == 200
        assert _counter(app, "resilience_faults_injected_total", site="dispatch",
                        kind="hang") == 1
        assert _counter(app, "serving_lane_quarantines_total", lane="0", cause="deadline") == 1
        assert _counter(app, "serving_lane_reinstated_total", lane="0") == 1
        assert _counter(app, "pipeline_degraded_total", cause="deadline") == 1
        # the failed chunk's busy seconds (its hang) are charged too
        st = json.loads(_get(base + "/readyz")[1])
        led = st["ledger"]
        assert math.isclose(led["device_seconds_total"], app.executor.busy_seconds,
                            rel_tol=1e-8, abs_tol=1e-8)
        assert app.executor.busy_seconds >= 1.0
        assert st["slo"]["burn_rate_fast"] > 0
    finally:
        _stop(servers)


# -- the volume gang's fault site --------------------------------------------------


VOLUME_PLANS = [
    pytest.param({"faults": [{"site": "volume", "kind": "dispatch_error", "lane": 0,
                               "count": 1}]}, True, id="lane"),
    pytest.param({"faults": [{"site": "volume", "kind": "dispatch_error", "index": 0}]},
                 False, id="unattributable"),
]


@pytest.mark.parametrize("plan,blames", VOLUME_PLANS)
def test_volume_site_blames_the_lane_as_the_jax_gang_does(plan, blames):
    common = dict(buckets=(1,), lanes=1, max_wait_s=0.005, volume_serving=True,
                  volume_depth_buckets=(4,))
    jax_app = JaxApp(cfg=JaxConfig(canvas=64, min_dim=16), fault_plan=JaxPlan.from_spec(plan),
                     **common)
    port_app = ServingApp(cfg=PipelineConfig(canvas=64, min_dim=16), device="cpu",
                          fault_plan=FaultPlan.from_spec(plan), lane_probe_interval_s=0.3,
                          **common)
    servers = _serve([(jax_app, jax_serve_in_thread), (port_app, serve_in_thread)])
    try:
        vol = phantom_volume(3, 64, 60, seed=2).astype("<f4")
        headers = {"Content-Type": "application/octet-stream", "X-Nm03-Depth": "3",
                   "X-Nm03-Height": "64", "X-Nm03-Width": "60"}
        results = [_post(base + "/v1/segment-volume?output=summary", vol.tobytes(), headers)
                   for _, _, base in servers]
        (sj, _, hj), (sp, _, hp) = results
        assert sj == sp == 503 and hp.get("Retry-After") == hj.get("Retry-After") == "1"
        for app in (jax_app, port_app):
            assert _counter(app, "resilience_faults_injected_total", site="volume",
                            kind="dispatch_error") == 1
            quarantines = _counter(app, "serving_lane_quarantines_total", lane="0",
                                   cause="device_lost")
            assert (quarantines == 1) if blames else (quarantines is None)
        # the port's lane comes back through the probe, and the next study runs
        deadline = time.monotonic() + 20
        while not port_app.ready and time.monotonic() < deadline:
            time.sleep(0.1)
        assert port_app.ready
        status, payload, _ = _post(servers[1][2] + "/v1/segment-volume?output=summary",
                                   vol.tobytes(), headers)
        assert status == 200 and payload["shape"] == [3, 64, 60]
    finally:
        _stop(servers)


# -- the load generators cross ------------------------------------------------------


@pytest.fixture(scope="module")
def clean_pair():
    common = dict(buckets=BUCKETS, lanes=1, max_wait_s=0.005)
    jax_app = JaxApp(cfg=JaxConfig(canvas=CANVAS), **common)
    port_app = ServingApp(cfg=PipelineConfig(canvas=CANVAS), device="cpu", **common)
    servers = _serve([(jax_app, jax_serve_in_thread), (port_app, serve_in_thread)])
    yield SimpleNamespace(jax=servers[0][2], port=servers[1][2])
    _stop(servers)


@pytest.mark.parametrize("dicom", [False, True])
@pytest.mark.parametrize("rate", [0.0, 20.0])
def test_loadgens_cross(clean_pair, dicom, rate):
    runs = {}
    for name, gen, target in (("port_on_jax", loadgen, clean_pair.jax),
                              ("jax_on_port", jax_loadgen, clean_pair.port)):
        payloads = gen._make_payloads(CANVAS, 120, 2, dicom)
        summary = gen.run_load([target + "/v1/segment?output=mask"], payloads, 8, 4, rate,
                               60.0, gen.LoadResult())
        runs[name] = summary
    a, b = runs["port_on_jax"], runs["jax_on_port"]
    assert set(a) == set(b)
    assert a["statuses"] == b["statuses"] == {"ok": 8}
    assert a["schema"] == b["schema"] == "nm03.loadgen.v1"
    assert a["requests_ok"] == b["requests_ok"] == 8


def test_the_ports_loadgen_cli_self_serves_on_the_cpu(tmp_path):
    out = tmp_path / "lg.json"
    rc = loadgen.main(["--self-serve", "--device", "cpu", "--requests", "6", "--concurrency",
                       "3", "--warmup", "0", "--height", "64", "--width", "60",
                       "--self-serve-args", "--canvas 64 --min-dim 16 --buckets 1,2",
                       "--results-json", str(out), "--expect-slo", "availability=50"])
    assert rc == 0
    summary = json.loads(out.read_text())
    assert summary["requests_ok"] == 6 and summary["slo_gate"]["pass"]
    assert summary["server_status"]["saturation"]["busy_fraction"] > 0
    assert len(summary["requests"]) == 6
    assert loadgen.build_parser().parse_args([]).device == "cuda"
