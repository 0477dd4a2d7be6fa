"""The port's replica fleet, held against the JAX package's.

``tests/test_fleet.py`` is the JAX package's suite for ``fleet/``; this
file runs the same classes against the port's copies, cheapest first:

* units: the HEALTHY → EJECTED → PROBATION → HEALTHY state machine, the
  smooth-WRR picker, the ``fleet`` fault site;
* router drills against fake stdlib replicas: routing spread, payload
  truth fields, transport-death failover, 503 backpressure rerouting and
  Retry-After propagation, application verdicts, health-poll ejection and
  probation reinstatement, the fault-site drills, tracing, the fleet SLO;
* ``nm03-top --fleet`` rendering, the loadgen's multi-target mode and the
  check_telemetry fleet gates;
* the rolling restart against dummy replicas, and the drills on real port
  servers on the CPU (``--device cpu``): SIGKILL one of three replicas
  mid-run (zero failed requests, every mask equal to the JAX package's
  ``process_slice`` mask, probation heals it) and, marked slow as its JAX
  twin is, the rolling restart under load.

What only the port has: parity tests that send the same ``/readyz`` and
``/metrics.json`` samples, and the same proxied traffic, through both
packages' code and require equal results. Every comparison is exact.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from nm03_capstone_project_tpu_torch.fleet.replicas import (
    EJECTED,
    HEALTHY,
    PROBATION,
    ReplicaStates,
    normalize_target,
    target_label,
)
from nm03_capstone_project_tpu_torch.fleet.router import FleetApp, serve_in_thread
from nm03_capstone_project_tpu_torch.resilience import FaultPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKER = os.path.join(REPO, "scripts", "check_telemetry.py")
CANVAS = 128


class _Events:
    def __init__(self):
        self.records = []
        self._lock = threading.Lock()

    def emit(self, event, level="INFO", **fields):
        with self._lock:
            self.records.append({"event": event, "level": level, **fields})

    def of(self, event):
        with self._lock:
            return [r for r in self.records if r["event"] == event]


class _Obs:
    """Minimal RunContext stand-in: real registry, recorded events."""

    def __init__(self):
        from nm03_capstone_project_tpu_torch.obs.metrics import MetricsRegistry

        self.registry = MetricsRegistry()
        self.events = _Events()
        self.faults = []

    def fault_injected(self, **kw):
        self.faults.append(kw)
        self.registry.counter(
            "resilience_faults_injected_total",
            site=kw.get("site", ""), kind=kw.get("kind", ""),
        ).inc()

    def metrics_snapshot(self):
        return self.registry.snapshot(run_id="t", git_sha="t")

    def write_metrics(self, path=None):
        pass

    def close(self, status="ok", **kw):
        pass


# -- the state machine -------------------------------------------------------


class TestReplicaStates:
    def _mk(self, n=3, obs=None):
        return ReplicaStates(
            [f"127.0.0.1:{9000 + i}" for i in range(n)], obs=obs
        )

    def test_initial_all_healthy_with_gauges(self):
        obs = _Obs()
        rs = self._mk(3, obs)
        assert rs.healthy_count() == 3 and rs.ejected_count() == 0
        for i in range(3):
            g = obs.registry.get(
                "fleet_replica_state", replica=f"127.0.0.1:{9000 + i}"
            )
            assert g is not None and g.value == 0

    def test_normalization_and_labels(self):
        assert normalize_target("h:1/") == "http://h:1"
        assert normalize_target("https://h:1") == "https://h:1"
        assert target_label("http://127.0.0.1:8123") == "127.0.0.1:8123"
        with pytest.raises(ValueError):
            ReplicaStates([])
        with pytest.raises(ValueError):
            ReplicaStates(["h:1", "http://h:1"])  # duplicates post-normalize

    def test_eject_transition_and_telemetry(self):
        obs = _Obs()
        rs = self._mk(3, obs)
        t = rs.targets[1]
        changed, left = rs.eject(t, "refused")
        assert changed and left == 2
        assert rs.state(t) == EJECTED and rs.cause(t) == "refused"
        assert rs.healthy_targets() == [rs.targets[0], rs.targets[2]]
        assert obs.registry.get(
            "fleet_replica_state", replica=target_label(t)
        ).value == 2
        assert obs.registry.get(
            "fleet_replica_ejections_total",
            replica=target_label(t), cause="refused",
        ).value == 1
        ev = obs.events.of("replica_ejected")
        assert len(ev) == 1 and ev[0]["level"] == "WARNING"
        assert ev[0]["healthy_remaining"] == 2

    def test_eject_idempotent_for_non_healthy(self):
        obs = _Obs()
        rs = self._mk(2, obs)
        t = rs.targets[0]
        assert rs.eject(t, "timeout") == (True, 1)
        # a proxy failure on an already-ejected replica: same incident
        assert rs.eject(t, "proxy_error") == (False, 1)
        assert rs.cause(t) == "timeout"  # the first verdict stands
        rs.begin_probation(t)
        # a stale failure cannot steal the canary claim either
        assert rs.eject(t, "proxy_error") == (False, 1)
        assert rs.state(t) == PROBATION
        assert obs.registry.get(
            "fleet_replica_ejections_total",
            replica=target_label(t), cause="timeout",
        ).value == 1

    def test_probation_claim_exclusive_and_reinstate(self):
        obs = _Obs()
        rs = self._mk(2, obs)
        t = rs.targets[0]
        assert not rs.begin_probation(t)  # healthy: nothing to probe
        rs.eject(t, "refused")
        assert rs.begin_probation(t)
        assert not rs.begin_probation(t)  # second prober bounced
        assert not rs.reinstate(rs.targets[1])  # healthy: no-op
        assert rs.reinstate(t)
        assert rs.state(t) == HEALTHY and rs.cause(t) is None
        assert rs.healthy_count() == 2
        assert obs.registry.get(
            "fleet_replica_reinstated_total", replica=target_label(t)
        ).value == 1

    def test_fail_probation_recounts_as_fresh_ejection(self):
        obs = _Obs()
        rs = self._mk(2, obs)
        t = rs.targets[1]
        rs.eject(t, "http_503")
        rs.begin_probation(t)
        assert rs.fail_probation(t)
        assert rs.state(t) == EJECTED and rs.cause(t) == "probe_failed"
        assert obs.registry.get(
            "fleet_replica_ejections_total",
            replica=target_label(t), cause="probe_failed",
        ).value == 1

    def test_signals_feed_weight_and_capacity(self):
        rs = self._mk(3)
        a, b, c = rs.targets
        rs.update_signals(a, capacity=1.0, queue_depth=0, queue_capacity=64)
        rs.update_signals(b, capacity=0.5, queue_depth=32, queue_capacity=64)
        rs.update_signals(c, capacity=0.75)
        assert rs.weight(a) == 1.0
        assert rs.weight(b) == pytest.approx(0.25)  # 0.5 cap x 0.5 headroom
        assert rs.weight(c) == 0.75  # no queue signals -> full headroom
        assert rs.capacity_fraction() == pytest.approx((1.0 + 0.5 + 0.75) / 3)
        rs.eject(b, "refused")
        assert rs.capacity_fraction() == pytest.approx((1.0 + 0.75) / 3)

    def test_snapshot_carries_the_router_table(self):
        rs = self._mk(2)
        rs.update_signals(
            rs.targets[0], capacity=1.0, identity={"id": "abc", "pid": 7}
        )
        rs.eject(rs.targets[1], "timeout")
        snap = rs.snapshot()
        assert [r["state"] for r in snap] == [HEALTHY, EJECTED]
        assert snap[0]["identity"] == {"id": "abc", "pid": 7}
        assert snap[1]["cause"] == "timeout" and snap[1]["ejections"] == 1

    def test_obs_none_is_fine(self):
        rs = self._mk(2, obs=None)
        rs.eject(rs.targets[0], "refused")
        rs.begin_probation(rs.targets[0])
        rs.reinstate(rs.targets[0])
        assert rs.healthy_count() == 2


# -- the picker --------------------------------------------------------------


class TestWeightedPick:
    def _app(self, n=3, obs=None):
        app = FleetApp(
            [f"127.0.0.1:{9100 + i}" for i in range(n)],
            obs=obs or _Obs(), health_interval_s=3600,
        )
        return app

    def test_spread_is_proportional_to_weights(self):
        app = self._app(3)
        a, b, c = app.replicas.targets
        app.replicas.update_signals(a, capacity=1.0)
        app.replicas.update_signals(b, capacity=1.0)
        app.replicas.update_signals(c, capacity=0.5)
        picks = [app.pick() for _ in range(100)]
        counts = {t: picks.count(t) for t in (a, b, c)}
        assert counts[a] == pytest.approx(40, abs=3)
        assert counts[b] == pytest.approx(40, abs=3)
        assert counts[c] == pytest.approx(20, abs=3)

    def test_excludes_ejected_and_tried(self):
        app = self._app(3)
        a, b, c = app.replicas.targets
        app.replicas.eject(b, "refused")
        picks = {app.pick() for _ in range(10)}
        assert b not in picks and picks == {a, c}
        assert app.pick(exclude=frozenset({a, c})) is None

    def test_zero_weight_healthy_replica_still_pickable(self):
        app = self._app(1)
        (a,) = app.replicas.targets
        app.replicas.update_signals(
            a, capacity=1.0, queue_depth=64, queue_capacity=64
        )
        assert app.pick() == a  # the floor: full queue != unroutable


# -- fake replicas for router drills ----------------------------------------


class FakeReplica:
    """A stdlib stand-in for nm03-serve: /readyz + /v1/segment, mutable
    behavior (capacity, shed, drop-connection) and a request log."""

    def __init__(self, name, capacity=1.0):
        self.name = name
        self.capacity = capacity
        self.shed = False
        self.drop = False  # abort POST connections without a response
        self.canvas = None  # published request-size guards (None = omit)
        self.min_dim = None
        self.volumes = None  # the volumes block (None = omit)
        self.requests = []
        self._lock = threading.Lock()
        fake = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _j(self, status, body, headers=()):
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/readyz":
                    self._j(200, {
                        "ready": True, "capacity": fake.capacity,
                        "queue_depth": 0, "queue_capacity": 64,
                        "canvas": fake.canvas, "min_dim": fake.min_dim,
                        "volumes": fake.volumes,
                        "replica": {"id": fake.name, "pid": os.getpid()},
                        # the clock handshake: a fixed fake pair
                        # whose implied offset the router must record
                        "clock": {"mono_s": 5.0, "ts_unix": 1005.0},
                    })
                else:
                    self._j(200, {"status": "alive"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                with fake._lock:
                    fake.requests.append({
                        "path": self.path, "bytes": len(body),
                        "id": self.headers.get("X-Nm03-Request-Id"),
                        "probe": self.headers.get("X-Nm03-Probe"),
                    })
                if fake.drop:
                    # die mid-response: the transport failure the
                    # failover ladder exists for
                    self.wfile.flush()
                    self.connection.close()
                    return
                if fake.shed:
                    self._j(503, {"error": "queue full"},
                            [("Retry-After", "7")])
                    return
                if body and body[:1] == b"\xff":
                    self._j(400, {"error": "bad body"})
                    return
                self._j(200, {
                    "mask_pixels": 5, "lane": 0, "batch_size": 1,
                    "trace_id": self.headers.get("X-Nm03-Request-Id", "t"),
                    "queue_wait_s": 0.001,
                }, [("X-Nm03-Batch-Size", "1"), ("X-Nm03-Lane", "0"),
                    ("X-Nm03-Request-Id",
                     self.headers.get("X-Nm03-Request-Id", "t")),
                    ("X-Nm03-Queue-Wait-Ms", "1.0")])

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    @property
    def label(self):
        return f"127.0.0.1:{self.port}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _wait_state(app, target, state, timeout_s=15.0):
    """Wait for the (async, thread-spawned) probation canary's verdict."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if app.replicas.state(target) == state:
            return True
        time.sleep(0.02)
    return False


def _segment_body(hw=16):
    return bytes(hw * hw * 4), {
        "Content-Type": "application/octet-stream",
        "X-Nm03-Height": str(hw), "X-Nm03-Width": str(hw),
    }


@pytest.fixture
def two_fakes():
    a, b = FakeReplica("ra"), FakeReplica("rb")
    yield a, b
    a.stop()
    b.stop()


class TestRouterProxy:
    def _app(self, fakes, obs=None, **kw):
        kw.setdefault("health_interval_s", 3600)  # drills sweep by hand
        app = FleetApp([f.url for f in fakes], obs=obs or _Obs(), **kw)
        app._sweep()  # one informed pass, no background thread
        return app

    def test_routes_and_tells_the_truth(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        body, hdrs = _segment_body()
        seen = set()
        for _ in range(4):
            status, data, headers = app.proxy_segment(body, hdrs)
            assert status == 200
            p = json.loads(data)
            assert p["replica_hops"] == 0
            assert p["replica"] in (a.label, b.label)
            assert p["replica_id"] in ("ra", "rb")
            seen.add(p["replica"])
            hmap = dict(headers)
            assert hmap["X-Nm03-Replica"] == p["replica"]
            assert hmap["X-Nm03-Replica-Hops"] == "0"
            assert hmap["X-Nm03-Lane"] == "0"  # replica headers forwarded
        assert seen == {a.label, b.label}  # both replicas took traffic
        routed = [
            m for m in obs.registry.series()
            if m.name == "fleet_requests_routed_total"
        ]
        assert sum(m.value for m in routed) == 4 and len(routed) == 2

    def test_transport_death_fails_over_and_ejects(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        a.drop = True
        body, hdrs = _segment_body()
        status, data, headers = app.proxy_segment(body, hdrs)
        assert status == 200
        p = json.loads(data)
        assert p["replica"] == b.label and p["replica_hops"] == 1
        assert app.replicas.state(a.url) == EJECTED
        assert app.replicas.cause(a.url) == "proxy_error"
        assert obs.registry.get(
            "fleet_failovers_total", replica=a.label, cause="io_error"
        ).value == 1
        # the survivor keeps serving with no further hops
        status, data, _ = app.proxy_segment(body, hdrs)
        assert json.loads(data)["replica_hops"] == 0

    def test_shed_reroutes_while_alternative_exists(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        a.shed = True
        b.shed = False
        body, hdrs = _segment_body()
        for _ in range(3):
            status, data, _ = app.proxy_segment(body, hdrs)
            assert status == 200  # the healthy replica absorbs it
        # a shed is a reroute, not an ejection: backpressure != sickness
        assert app.replicas.state(a.url) == HEALTHY
        assert obs.registry.get("fleet_shed_total").value == 0

    def test_volume_request_weighs_its_depth_in_wrr(self, two_fakes):
        """A /v1/segment-volume proxy debits the picked replica
        its declared depth's worth of WRR rounds — the following slice
        picks all land on the OTHER replica until the debt amortizes."""
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        vol_body = bytes(4 * 16 * 16 * 4)
        vol_hdrs = {
            "Content-Type": "application/octet-stream",
            "X-Nm03-Depth": "4", "X-Nm03-Height": "16",
            "X-Nm03-Width": "16",
        }
        assert app.volume_request_cost(vol_hdrs) == 4.0
        status, data, _ = app.proxy_segment(
            vol_body, vol_hdrs, path="/v1/segment-volume", cost=4.0
        )
        assert status == 200
        volume_replica = json.loads(data)["replica"]
        fakes = {a.label: a, b.label: b}
        served_by = fakes[volume_replica]
        other = b if served_by is a else a
        # the volume reached the replica on the VOLUME endpoint
        assert any(
            r["path"].startswith("/v1/segment-volume")
            for r in served_by.requests
        )
        # cost 4: the next 3 slice picks amortize the debt elsewhere
        body, hdrs = _segment_body()
        for _ in range(3):
            _s, d2, _h = app.proxy_segment(body, hdrs)
            assert json.loads(d2)["replica"] == other.label
        # debt paid: traffic spreads again
        picked = {
            json.loads(app.proxy_segment(body, hdrs)[1])["replica"]
            for _ in range(4)
        }
        assert volume_replica in picked

    def test_unsized_volume_uses_published_cost(self, two_fakes):
        """No X-Nm03-Depth: the WRR weighs the request by the largest
        volume cost any replica published on /readyz (its smallest depth
        bucket), floor 1.0 when nobody serves volumes."""
        a, b = two_fakes
        app = self._app([a, b])
        assert app.volume_request_cost({}) == 1.0  # nobody publishes
        a.volumes = {"enabled": True, "default_cost": 16,
                     "depth_buckets": [16, 32]}
        app._sweep()
        assert app.volume_request_cost({}) == 16.0
        assert app.volume_request_cost({"X-Nm03-Depth": "nonsense"}) == 16.0

    def test_fleet_wide_shed_propagates_retry_after(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        a.shed = b.shed = True
        body, hdrs = _segment_body()
        status, data, headers = app.proxy_segment(body, hdrs)
        assert status == 503
        assert dict(headers)["Retry-After"] == "7"  # the replica's own
        assert obs.registry.get("fleet_shed_total").value == 1

    def test_application_verdicts_propagate_without_failover(self, two_fakes):
        a, b = two_fakes
        app = self._app([a, b])
        status, data, _ = app.proxy_segment(
            b"\xff" + bytes(15), _segment_body()[1]
        )
        assert status == 400
        assert json.loads(data)["error"] == "bad body"
        # a deterministic rejection must not burn the other replica
        assert len(a.requests) + len(b.requests) == 1
        assert app.replicas.healthy_count() == 2

    def test_no_healthy_replica_is_a_503_with_hint(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        a.drop = b.drop = True
        body, hdrs = _segment_body()
        status, data, headers = app.proxy_segment(body, hdrs)
        assert status == 503
        assert "no healthy replica" in json.loads(data)["error"]
        assert dict(headers)["Retry-After"] == "1"
        assert app.replicas.healthy_count() == 0
        assert obs.registry.get("fleet_shed_total").value == 1


class TestRouterHealthLoop:
    def test_dead_replica_ejected_and_probation_reinstates(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = FleetApp(
            [a.url, b.url], obs=obs,
            health_interval_s=3600, probe_interval_s=0.0, canary_timeout_s=5.0,
        )
        app._sweep()
        assert app.replicas.healthy_count() == 2
        # kill a: next sweep ejects (refused), readyz stays informative
        a.stop()
        app._sweep()
        assert app.replicas.state(a.url) == EJECTED
        st = app.status()
        assert st["ready"] is True and st["capacity"] == 0.5
        assert st["replicas"]["ready"] == 1 and st["replicas"]["ejected"] == 1
        # bring a back on the SAME port: poll ok -> canary -> reinstated
        b2 = _fresh_fake_on_port("ra2", a.port)
        try:
            app._sweep()
            assert _wait_state(app, a.url, HEALTHY)
            assert obs.registry.get(
                "fleet_probes_total", replica=a.label, outcome="passed"
            ).value == 1
            assert obs.registry.get(
                "fleet_replica_reinstated_total", replica=a.label
            ).value == 1
            assert app.status()["capacity"] == 1.0
        finally:
            b2.stop()

    def test_zero_capacity_and_503_eject(self, two_fakes):
        a, b = two_fakes
        app = FleetApp(
            [a.url, b.url], obs=_Obs(),
            health_interval_s=3600, probe_interval_s=3600,
        )
        a.capacity = 0.0
        app._sweep()
        assert app.replicas.state(a.url) == EJECTED
        assert app.replicas.cause(a.url) == "zero_capacity"

    def test_canary_sizes_itself_inside_the_replica_guards(self, two_fakes):
        """The live-drill regression: a replica publishing min_dim=100
        must get a >=100x100 canary, not the 32x32 default its guards
        would 400 — an ejection that can never heal."""
        a, b = two_fakes
        a.min_dim, a.canvas = 100, 128  # published on /readyz (below)
        obs = _Obs()
        app = FleetApp(
            [a.url, b.url], obs=obs,
            health_interval_s=3600, probe_interval_s=0.0, canary_timeout_s=5.0,
        )
        app._sweep()
        app.replicas.eject(a.url, "proxy_error")
        app._sweep()  # poll ok -> canary sized 100x100 -> reinstated
        assert _wait_state(app, a.url, HEALTHY)
        canaries = [r for r in a.requests if (r["id"] or "").startswith(
            "fleet-probe-")]
        assert canaries and canaries[-1]["bytes"] == 100 * 100 * 4

    def test_failed_canary_returns_to_ejected(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = FleetApp(
            [a.url, b.url], obs=obs,
            health_interval_s=3600, probe_interval_s=0.0, canary_timeout_s=5.0,
        )
        app._sweep()
        app.replicas.eject(a.url, "proxy_error")
        a.shed = True  # readyz fine, canary POST 503s -> probe fails
        app._sweep()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not (
            app.replicas.state(a.url) == EJECTED
            and app.replicas.cause(a.url) == "probe_failed"
        ):
            time.sleep(0.02)
        assert app.replicas.state(a.url) == EJECTED
        assert app.replicas.cause(a.url) == "probe_failed"
        assert obs.registry.get(
            "fleet_probes_total", replica=a.label, outcome="failed"
        ).value == 1


def _fresh_fake_on_port(name: str, port: int) -> FakeReplica:
    """A FakeReplica bound to a SPECIFIC port (a revived replica —
    retries through the closed listener's TIME_WAIT window)."""
    fake = object.__new__(FakeReplica)
    fake.name = name
    fake.capacity = 1.0
    fake.shed = False
    fake.drop = False
    fake.requests = []
    fake._lock = threading.Lock()

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _j(self, status, body, headers=()):
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/readyz":
                self._j(200, {
                    "ready": True, "capacity": fake.capacity,
                    "queue_depth": 0, "queue_capacity": 64,
                    "replica": {"id": name, "pid": os.getpid()},
                })
            else:
                self._j(200, {"status": "alive"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            self.rfile.read(n)
            if fake.shed:
                self._j(503, {"error": "full"}, [("Retry-After", "7")])
            else:
                self._j(200, {"mask_pixels": 5, "lane": 0, "batch_size": 1,
                              "trace_id": "t", "queue_wait_s": 0.0})

    deadline = time.monotonic() + 10
    while True:
        try:
            fake.httpd = ThreadingHTTPServer(("127.0.0.1", port), H)
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    fake.httpd.daemon_threads = True
    fake.port = port
    fake.url = f"http://127.0.0.1:{port}"
    threading.Thread(target=fake.httpd.serve_forever, daemon=True).start()
    return fake


# -- router-side tracing + probe tagging + fleet SLO --------------


class TestRouterTracing:
    def _app(self, fakes, obs=None, **kw):
        kw.setdefault("health_interval_s", 3600)
        app = FleetApp([f.url for f in fakes], obs=obs or _Obs(), **kw)
        app._sweep()
        return app

    def test_minted_id_forwarded_and_fleet_trace_emitted(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        body, hdrs = _segment_body()
        status, data, headers = app.proxy_segment(body, hdrs)
        assert status == 200
        recs = obs.events.of("fleet_trace")
        assert len(recs) == 1
        rec = recs[0]
        assert rec["status"] == 200 and rec["replica_hops"] == 0
        assert rec["request_id"].startswith("fl-")
        names = [s["name"] for s in rec["spans"]]
        assert names == ["route_pick", "proxy_hop"]
        hop = rec["spans"][1]
        assert hop["outcome"] == "ok" and hop["replica"] == rec["replica"]
        # the minted id went replica-ward: the serving fake saw it
        served = a.requests + b.requests
        assert served and served[-1]["id"] == rec["trace_id"]
        # the SLO status class landed
        assert obs.registry.get(
            "fleet_requests_total", status="ok"
        ).value == 1
        assert obs.registry.get("fleet_request_seconds").count == 1

    def test_client_probe_header_is_stripped(self, two_fakes):
        """A client smuggling X-Nm03-Probe through the fleet must NOT get
        its traffic excluded from the replica's request metrics — only
        the router's own canary path may set the tag (review fix)."""
        a, b = two_fakes
        app = self._app([a, b])
        body, hdrs = _segment_body()
        status, _, _ = app.proxy_segment(
            body, {**hdrs, "X-Nm03-Probe": "1"}
        )
        assert status == 200
        served = (a.requests + b.requests)[-1]
        assert served["probe"] is None  # stripped before the forward

    def test_honored_client_id_shared_with_replica(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        body, hdrs = _segment_body()
        status, _, _ = app.proxy_segment(
            body, {**hdrs, "x-nm03-request-id": "ignored-case-variant"},
            trace_id="client-42",
        )
        assert status == 200
        rec = obs.events.of("fleet_trace")[0]
        assert rec["trace_id"] == "client-42"
        served = a.requests + b.requests
        # the canonical id replaced any case variant of the client's
        assert served[-1]["id"] == "client-42"

    def test_failover_chain_in_spans(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        a.drop = True
        body, hdrs = _segment_body()
        status, data, _ = app.proxy_segment(body, hdrs)
        assert status == 200
        rec = obs.events.of("fleet_trace")[0]
        names = [s["name"] for s in rec["spans"]]
        # the acceptance chain: pick -> hop(A, died) -> failover -> pick
        # -> hop(B, ok), one trace id throughout
        assert names == [
            "route_pick", "proxy_hop", "failover", "route_pick", "proxy_hop",
        ]
        hops = [s for s in rec["spans"] if s["name"] == "proxy_hop"]
        assert hops[0]["outcome"] == "io_error"
        assert hops[0]["replica"] == a.label
        assert hops[1]["outcome"] == "ok" and hops[1]["replica"] == b.label
        assert {s["trace_ids"][0] for s in rec["spans"]} == {rec["trace_id"]}
        fail = next(s for s in rec["spans"] if s["name"] == "failover")
        assert fail["cause"] == "io_error" and fail["replica"] == a.label
        assert rec["replica_hops"] == 1 and rec["replica"] == b.label

    def test_fleet_wide_shed_is_traced_and_echoed(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        a.shed = b.shed = True
        body, hdrs = _segment_body()
        status, _, headers = app.proxy_segment(
            body, hdrs, trace_id="shed-1"
        )
        assert status == 503
        assert dict(headers)["X-Nm03-Request-Id"] == "shed-1"
        rec = obs.events.of("fleet_trace")[0]
        assert rec["status"] == 503 and rec["replica"] is None
        hops = [s for s in rec["spans"] if s["name"] == "proxy_hop"]
        assert len(hops) == 2
        assert {h["outcome"] for h in hops} == {"shed"}
        assert obs.registry.get(
            "fleet_requests_total", status="shed"
        ).value == 1

    def test_application_4xx_counts_invalid(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        body = b"\xff" + bytes(1023)  # the fakes 400 this
        status, _, _ = app.proxy_segment(body, _segment_body()[1])
        assert status == 400
        assert obs.registry.get(
            "fleet_requests_total", status="invalid"
        ).value == 1
        rec = obs.events.of("fleet_trace")[0]
        assert rec["spans"][-1]["outcome"] == "http_400"

    def test_request_classes_exist_at_zero_from_startup(self, two_fakes):
        obs = _Obs()
        self._app(list(two_fakes), obs)
        for cls in ("ok", "error", "shed"):
            m = obs.registry.get("fleet_requests_total", status=cls)
            assert m is not None and m.value == 0

    def test_canary_probe_tagged_and_traced(self, two_fakes):
        a, b = two_fakes
        obs = _Obs()
        app = self._app([a, b], obs)
        app.replicas.eject(b.url, "refused")
        app._probe_one(b.url, 7)  # the canary, synchronously
        assert app.replicas.state(b.url) == HEALTHY
        # the replica saw the probe TAG — the metrics-exclusion satellite
        probe_req = b.requests[-1]
        assert probe_req["probe"] == "1"
        assert probe_req["id"].startswith("fleet-probe-")
        recs = [r for r in obs.events.of("fleet_trace") if r.get("probe")]
        assert len(recs) == 1
        span = recs[0]["spans"][0]
        assert span["name"] == "canary_probe"
        assert span["outcome"] == "passed" and span["replica"] == b.label
        # probes never count as fleet requests
        assert obs.registry.get(
            "fleet_requests_total", status="ok"
        ).value == 0

    def test_clock_offset_recorded_from_handshake(self, two_fakes):
        a, b = two_fakes
        app = self._app([a, b])
        # the fakes publish clock {mono_s: 5, ts_unix: 1005} -> offset 1000
        assert app.replicas.signals(a.url)["clock_offset_s"] == 1000.0
        snap = app.status()["replicas"]["per_replica"]
        assert all(r["clock_offset_s"] == 1000.0 for r in snap)


class TestFleetSLO:
    def test_burn_gauges_and_readyz_block(self, two_fakes):
        from nm03_capstone_project_tpu_torch.obs.slo import SLOObjective

        a, b = two_fakes
        obs = _Obs()
        app = FleetApp(
            [a.url, b.url], obs=obs, health_interval_s=3600,
            slo=SLOObjective(99.0, latency_target_s=30.0,
                             window_fast_s=30.0, window_slow_s=600.0),
        )
        app._sweep()
        body, hdrs = _segment_body()
        for _ in range(4):
            assert app.proxy_segment(body, hdrs)[0] == 200
        app.publish_gauges()
        assert obs.registry.get("slo_burn_rate_fast").value == 0.0
        assert obs.registry.get("slo_error_budget_remaining").value == 1.0
        st = app.status()
        assert st["slo"]["objective"]["availability_pct"] == 99.0
        assert st["slo"]["error_budget_remaining"] == 1.0
        # now burn: every replica sheds -> fleet-wide 503s are bad
        a.shed = b.shed = True
        for _ in range(4):
            assert app.proxy_segment(body, hdrs)[0] == 503
        block = app.slo.publish()
        assert block["burn_rate_fast"] > 1.0
        assert block["error_budget_remaining"] < 1.0

    def test_no_objective_no_gauges(self, two_fakes):
        obs = _Obs()
        app = FleetApp(
            [f.url for f in two_fakes], obs=obs, health_interval_s=3600,
        )
        app._sweep()
        app.publish_gauges()
        assert obs.registry.get("slo_burn_rate_fast") is None
        assert app.status()["slo"] is None


# -- nm03-top --fleet rendering (canned payloads) ---------------------------


class TestFleetTopRender:
    """The fleet console path, rendered from canned fleet
    /metrics.json + /readyz payloads -> build_fleet_view/render_fleet_text,
    including the SLO row."""

    def _fleet_sample(self, ts=100.0, routed=40.0, with_slo=True, top=None):
        from nm03_capstone_project_tpu_torch.serving.top import Sample

        Sample = top.Sample if top is not None else Sample  # noqa: N806

        metrics = [
            {"name": "fleet_requests_routed_total", "type": "counter",
             "labels": {"replica": "127.0.0.1:8081"}, "value": routed},
            {"name": "fleet_failovers_total", "type": "counter",
             "labels": {"replica": "127.0.0.1:8082", "cause": "io_error"},
             "value": 2.0},
            {"name": "fleet_shed_total", "type": "counter", "labels": {},
             "value": 0.0},
        ]
        if with_slo:
            metrics += [
                {"name": "slo_burn_rate_fast", "type": "gauge",
                 "labels": {}, "value": 0.25},
                {"name": "slo_burn_rate_slow", "type": "gauge",
                 "labels": {}, "value": 0.1},
                {"name": "slo_error_budget_remaining", "type": "gauge",
                 "labels": {}, "value": 0.9},
            ]
        readyz = {
            "ready": True, "draining": False, "capacity": 0.833,
            "uptime_s": 12.5,
            "replicas": {
                "count": 2, "ready": 2, "ejected": 0,
                "per_replica": [
                    {"target": "http://127.0.0.1:8081",
                     "replica": "127.0.0.1:8081", "state": "healthy",
                     "cause": None, "ejections": 0, "capacity": 1.0,
                     "identity": {"id": "aaa", "pid": 11}},
                    {"target": "http://127.0.0.1:8082",
                     "replica": "127.0.0.1:8082", "state": "ejected",
                     "cause": "refused", "ejections": 2, "capacity": 0.667,
                     "identity": {"id": "bbb", "pid": 22}},
                ],
            },
        }
        return Sample({"metrics": metrics}, readyz, ts)

    def _replica_sample(self, ts=100.0, requests=10.0, top=None):
        from nm03_capstone_project_tpu_torch.serving.top import Sample

        Sample = top.Sample if top is not None else Sample  # noqa: N806

        metrics = [
            {"name": "serving_busy_fraction", "type": "gauge", "labels": {},
             "value": 0.42},
            {"name": "serving_mfu", "type": "gauge", "labels": {},
             "value": 0.001},
            {"name": "serving_requests_total", "type": "counter",
             "labels": {"status": "ok"}, "value": requests},
        ]
        readyz = {"queue_depth": 3, "lanes": {"ready": 4}}
        return Sample({"metrics": metrics}, readyz, ts)

    def test_build_fleet_view_rows_and_slo(self):
        from nm03_capstone_project_tpu_torch.serving.top import build_fleet_view

        fleet = self._fleet_sample()
        per = {
            "http://127.0.0.1:8081": self._replica_sample(),
            "http://127.0.0.1:8082": None,  # dead replica -> null row
        }
        view = build_fleet_view(fleet, per)
        assert view["schema"] == "nm03.fleettop.v1"
        assert view["replicas_ready"] == 2 and len(view["replicas"]) == 2
        live, dead = view["replicas"]
        assert live["replica"] == "127.0.0.1:8081"
        assert live["busy_fraction"] == 0.42
        assert live["lanes_ready"] == 4 and live["queue_depth"] == 3
        assert dead["state"] == "ejected" and dead["busy_fraction"] is None
        assert view["slo"] == {
            "error_budget_remaining": 0.9,
            "burn_rate_fast": 0.25,
            "burn_rate_slow": 0.1,
        }

    def test_rates_from_counter_deltas(self):
        from nm03_capstone_project_tpu_torch.serving.top import build_fleet_view

        prev_fleet = self._fleet_sample(ts=100.0, routed=40.0)
        cur_fleet = self._fleet_sample(ts=110.0, routed=60.0)
        prev_per = {"http://127.0.0.1:8081": self._replica_sample(100.0, 10)}
        cur_per = {"http://127.0.0.1:8081": self._replica_sample(110.0, 30)}
        view = build_fleet_view(cur_fleet, cur_per, prev_fleet, prev_per)
        assert view["rates_per_s"]["routed"] == pytest.approx(2.0)
        assert view["replicas"][0]["requests_per_s"] == pytest.approx(2.0)

    def test_render_text_carries_rows_and_slo_line(self):
        from nm03_capstone_project_tpu_torch.serving.top import (
            build_fleet_view,
            render_fleet_text,
        )

        view = build_fleet_view(
            self._fleet_sample(),
            {"http://127.0.0.1:8081": self._replica_sample()},
        )
        screen = render_fleet_text(view, "http://fleet:8070")
        assert "127.0.0.1:8081" in screen and "127.0.0.1:8082" in screen
        assert "ejected" in screen
        assert "slo burn fast 0.25" in screen
        assert "slow 0.1" in screen and "budget 90% left" in screen
        # the replica row carries its live busy fraction
        assert "42%" in screen

    def test_no_slo_no_row(self):
        from nm03_capstone_project_tpu_torch.serving.top import (
            build_fleet_view,
            render_fleet_text,
        )

        view = build_fleet_view(self._fleet_sample(with_slo=False), {})
        assert view["slo"] is None
        assert "slo burn" not in render_fleet_text(view, "u")


# -- the fleet fault site ----------------------------------------------------


class TestFleetFaultSite:
    def test_kinds_are_validated(self):
        with pytest.raises(ValueError):
            FaultPlan.from_spec(
                {"faults": [{"site": "fleet", "kind": "bogus"}]}
            )
        plan = FaultPlan.from_spec({"faults": [
            {"site": "fleet", "kind": "replica_unreachable", "stem": "h:1"},
            {"site": "fleet", "kind": "proxy_io_error", "index": 2},
        ]})
        assert plan.has_site("fleet")

    def test_kinds_filter_isolates_budgets(self):
        """The new fire(kinds=...) contract: a proxy_io_error rule must
        not fire at — or spend its count budget on — a health-poll check
        that only consults replica_unreachable rules."""
        plan = FaultPlan.from_spec({"faults": [
            {"site": "fleet", "kind": "proxy_io_error", "count": 1},
        ]})
        # ten health-poll-shaped checks: skipped entirely, budget intact
        for _ in range(10):
            assert plan.fire(
                "fleet", stem="h:1", kinds=("replica_unreachable",)
            ) is None
        hit = plan.fire("fleet", stem="h:1", index=1, kinds=("proxy_io_error",))
        assert hit is not None and hit.kind == "proxy_io_error"
        assert plan.fire(
            "fleet", stem="h:1", index=2, kinds=("proxy_io_error",)
        ) is None  # count=1 spent on the real proxy check, not the polls

    def test_replica_unreachable_drill(self, two_fakes):
        """Deterministic ejection: the health poll for ONE chosen replica
        behaves as refused for `count` polls, then the replica heals
        through probation — no process was harmed."""
        a, b = two_fakes
        obs = _Obs()
        plan = FaultPlan.from_spec({"faults": [{
            "site": "fleet", "kind": "replica_unreachable",
            "stem": a.label, "count": 2,
        }]})
        app = FleetApp(
            [a.url, b.url], obs=obs, fault_plan=plan,
            health_interval_s=3600, probe_interval_s=0.0, canary_timeout_s=5.0,
        )
        app._sweep()  # poll 1: injected refusal -> ejected
        assert app.replicas.state(a.url) == EJECTED
        assert app.replicas.cause(a.url) == "refused"
        assert app.replicas.state(b.url) == HEALTHY
        app._sweep()  # poll 2: still injected -> stays out (idempotent)
        assert app.replicas.state(a.url) == EJECTED
        app._sweep()  # budget spent: poll passes -> canary -> reinstated
        assert _wait_state(app, a.url, HEALTHY)
        assert len(obs.faults) == 2
        assert all(f["kind"] == "replica_unreachable" for f in obs.faults)

    def test_proxy_io_error_drill(self, two_fakes):
        """Deterministic failover: one proxied request aborts mid-body;
        the rider lands on the other replica with hops=1 and the fault
        is counted."""
        a, b = two_fakes
        obs = _Obs()
        plan = FaultPlan.from_spec({"faults": [{
            "site": "fleet", "kind": "proxy_io_error", "count": 1,
        }]})
        app = FleetApp(
            [a.url, b.url], obs=obs, fault_plan=plan,
            health_interval_s=3600,
        )
        app._sweep()
        body, hdrs = _segment_body()
        status, data, _ = app.proxy_segment(body, hdrs)
        assert status == 200
        p = json.loads(data)
        assert p["replica_hops"] == 1
        assert obs.registry.get(
            "fleet_failovers_total",
            replica=target_label(
                a.url if p["replica"] == b.label else b.url
            ),
            cause="io_error",
        ).value == 1
        assert [f["kind"] for f in obs.faults] == ["proxy_io_error"]
        # budget spent: the next request routes clean
        status, data, _ = app.proxy_segment(body, hdrs)
        assert json.loads(data)["replica_hops"] == 0


# -- loadgen --targets + the fleet gates -------------------------------------


class TestLoadgenMultiTarget:
    def test_run_load_spreads_over_urls_and_records_attribution(
        self, two_fakes
    ):
        from nm03_capstone_project_tpu_torch.serving.loadgen import (
            LoadResult,
            run_load,
        )

        a, b = two_fakes
        result = LoadResult()
        body_urls = [f"{a.url}/v1/segment", f"{b.url}/v1/segment"]
        summary = run_load(
            body_urls, [(_segment_body()[0], _segment_body()[1])],
            n_requests=8, concurrency=2, rate_rps=0.0, timeout_s=10.0,
            result=result,
        )
        assert summary["requests_ok"] == 8
        assert len(a.requests) == 4 and len(b.requests) == 4
        # no fleet in front: attribution falls back to the TARGET's
        # host:port, so a direct multi-replica run still shows its spread
        assert summary["replicas_observed"] == {a.label: 4, b.label: 4}
        assert summary["failovers_observed"] == 0

    def test_loadgen_reads_fleet_truth_fields(self, two_fakes):
        from nm03_capstone_project_tpu_torch.serving.loadgen import (
            LoadResult,
            run_load,
        )

        a, b = two_fakes
        app = FleetApp([a.url, b.url], obs=_Obs(), health_interval_s=3600)
        httpd, _, port = serve_in_thread(app)
        try:
            a.drop = True  # first hit on a fails over: hops=1 for a rider
            result = LoadResult()
            summary = run_load(
                f"http://127.0.0.1:{port}/v1/segment",
                [(_segment_body()[0], _segment_body()[1])],
                n_requests=6, concurrency=2, rate_rps=0.0, timeout_s=10.0,
                result=result,
            )
            assert summary["requests_ok"] == 6
            assert set(summary["replicas_observed"]) <= {a.label, b.label}
            assert b.label in summary["replicas_observed"]
            assert summary["failovers_observed"] >= 1
            hops = [r.get("replica_hops") for r in result.requests]
            assert any(h and h >= 1 for h in hops)
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_capacity_watch_tracks_fleet_floor(self, two_fakes):
        from nm03_capstone_project_tpu_torch.serving.loadgen import (
            CapacityWatch,
            probe_server_topology,
        )

        a, b = two_fakes
        app = FleetApp([a.url, b.url], obs=_Obs(), health_interval_s=3600)
        httpd, _, port = serve_in_thread(app)
        base = f"http://127.0.0.1:{port}"
        try:
            topo = probe_server_topology(base)
            assert topo["is_fleet"] and topo["replicas"] == 2
            assert topo["capacity"] == 1.0
            watch = CapacityWatch(base, interval_s=0.05).start()
            time.sleep(0.12)
            app.replicas.eject(a.url, "refused")
            time.sleep(0.2)
            watch.stop()
            assert watch.min_fleet_capacity == 0.5
            assert watch.max_replicas_ejected == 1
        finally:
            httpd.shutdown()
            httpd.server_close()


class TestFleetTelemetryGates:
    """The check_telemetry fleet-gate battery: labeled selectors whose
    replica values carry ':' (host:port) — red and green."""

    def _snapshot(self, tmp_path):
        snap = {
            "schema": "nm03.metrics.v1", "run_id": "r", "git_sha": "g",
            "created_unix": 1.0,
            "metrics": [
                {"name": "fleet_replica_state", "type": "gauge",
                 "labels": {"replica": "127.0.0.1:8081"}, "value": 0},
                {"name": "fleet_replica_state", "type": "gauge",
                 "labels": {"replica": "127.0.0.1:8082"}, "value": 2},
                {"name": "fleet_failovers_total", "type": "counter",
                 "labels": {"replica": "127.0.0.1:8082",
                            "cause": "io_error"}, "value": 2},
                {"name": "fleet_shed_total", "type": "counter",
                 "labels": {}, "value": 0},
                {"name": "fleet_routed_capacity", "type": "gauge",
                 "labels": {}, "value": 0.667},
            ],
        }
        p = tmp_path / "m.json"
        p.write_text(json.dumps(snap))
        return p

    def _run(self, p, *args):
        return subprocess.run(
            [sys.executable, CHECKER, "--metrics", str(p), *args],
            capture_output=True, text=True, timeout=60,
        )

    def test_green_gates(self, tmp_path):
        p = self._snapshot(tmp_path)
        r = self._run(
            p,
            "--expect-gauge", "fleet_replica_state{replica=127.0.0.1:8081}=0",
            "--expect-gauge", "fleet_replica_state{replica=127.0.0.1:8082}=2",
            "--expect-counter", "fleet_failovers_total=1",
            "--expect-counter",
            "fleet_failovers_total{replica=127.0.0.1:8082,cause=io_error}=2",
            "--expect-counter", "fleet_shed_total==0",
            "--expect-gauge-range", "fleet_routed_capacity=(0..1]",
        )
        assert r.returncode == 0, r.stderr

    def test_unhealed_replica_red(self, tmp_path):
        p = self._snapshot(tmp_path)
        r = self._run(
            p, "--expect-gauge",
            "fleet_replica_state{replica=127.0.0.1:8082}=0",
        )
        assert r.returncode == 1 and "expected == 0" in r.stderr

    def test_never_reported_replica_red(self, tmp_path):
        p = self._snapshot(tmp_path)
        r = self._run(
            p, "--expect-gauge",
            "fleet_replica_state{replica=127.0.0.1:9999}=0",
        )
        assert r.returncode == 1 and "no series matches" in r.stderr

    def test_missing_failovers_red(self, tmp_path):
        p = self._snapshot(tmp_path)
        r = self._run(
            p, "--expect-counter",
            "fleet_failovers_total{replica=127.0.0.1:8081}=1",
        )
        assert r.returncode == 1 and "no series matches" in r.stderr

    def test_capacity_range_red(self, tmp_path):
        p = self._snapshot(tmp_path)
        r = self._run(
            p, "--expect-gauge-range", "fleet_routed_capacity=(0.9..1]",
        )
        assert r.returncode == 1 and "expected in" in r.stderr


# -- rolling restart (dummy replicas) ---------------------------------------


_DUMMY = """
import json, os, signal, sys
from http.server import BaseHTTPRequestHandler, HTTPServer

port, gen = int(sys.argv[1]), int(sys.argv[2])
script = os.path.abspath(__file__)

class H(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *a): pass
    def do_GET(self):
        body = json.dumps({
            "ready": True, "capacity": 1.0,
            "queue_depth": 0, "queue_capacity": 8,
            "replica": {
                "id": f"gen{gen}-{os.getpid()}", "pid": os.getpid(),
                "start_unix": 0.0,
                "relaunch_argv": [sys.executable, script, str(port),
                                  str(gen + 1)],
                "cwd": os.getcwd(),
            },
        }).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

srv = HTTPServer(("127.0.0.1", port), H)
signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
print("ready", flush=True)
srv.serve_forever()
"""


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _wait_http(url, timeout_s=30):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                r.read()
                return True
        except Exception:  # noqa: BLE001
            time.sleep(0.1)
    return False


class TestRollingRestart:
    def test_rolls_through_dummies_one_at_a_time(self, tmp_path):
        from nm03_capstone_project_tpu_torch.fleet.manager import rolling_restart

        script = tmp_path / "dummy.py"
        script.write_text(_DUMMY)
        ports = _free_ports(2)
        procs = [
            subprocess.Popen([sys.executable, str(script), str(p), "1"])
            for p in ports
        ]
        spawned = []

        def spawn(argv, **kw):
            kw.pop("stdout", None)
            kw.pop("stderr", None)
            kw.pop("start_new_session", None)
            proc = subprocess.Popen(argv, **kw)
            spawned.append(proc)
            return proc

        try:
            targets = [f"127.0.0.1:{p}" for p in ports]
            for p in ports:
                assert _wait_http(f"http://127.0.0.1:{p}/readyz")
            report = rolling_restart(
                targets, drain_timeout_s=30, warm_timeout_s=30,
                poll_s=0.05, spawn=spawn, emit=lambda m: None,
            )
            assert report["ok"] is True
            assert len(report["replicas"]) == 2
            old_pids = [p.pid for p in procs]
            for entry, old in zip(report["replicas"], old_pids):
                assert entry["ok"] and entry["old_pid"] == old
                assert entry["new_pid"] != old
                # a replica without CUDA graphs reports no capture time,
                # one without a compile cache no cache hits
                assert entry["capture_s"] is None
                assert entry["compile_cache_hits"] is None and entry["builds"] is None
                assert entry["drain_s"] >= 0 and entry["warm_s"] >= 0
                assert entry["new_id"].startswith("gen2-")
            # the originals really died, the spawns really live
            for p in procs:
                assert p.wait(timeout=10) == 0
            for p in ports:
                _, st = _readyz(f"http://127.0.0.1:{p}")
                assert st["replica"]["id"].startswith("gen2-")
        finally:
            for p in procs + spawned:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)

    def test_relaunch_recipe_substitutes_the_bound_port(self):
        """The /readyz relaunch recipe must be reproducible: an ephemeral
        `--port 0` republished verbatim would relaunch the replica on a
        DIFFERENT random port and the orchestrator's warm-wait against
        the old address could never succeed."""
        from nm03_capstone_project_tpu.serving.server import _relaunch_recipe as jax_recipe
        from nm03_capstone_project_tpu_torch.serving.server import _relaunch_recipe

        rec = _relaunch_recipe(["--port", "0", "--lanes", "2"], 18081)
        assert rec[:3] == [
            sys.executable, "-m",
            "nm03_capstone_project_tpu_torch.serving.server",
        ]
        # the flags are the JAX server's recipe, flag for flag
        for argv in (["--port", "0", "--lanes", "2"], ["--port=0"], ["--lanes", "1"]):
            assert _relaunch_recipe(argv, 8077)[3:] == jax_recipe(argv, 8077)[3:]
        assert rec[3:] == ["--port", "18081", "--lanes", "2"]
        # --port=0 spelling
        assert "--port=18081" in _relaunch_recipe(["--port=0"], 18081)
        # defaulted port becomes explicit — the recipe stands alone
        assert _relaunch_recipe(["--lanes", "1"], 8077)[3:] == [
            "--lanes", "1", "--port", "8077",
        ]

    def test_relaunch_is_the_published_argv_verbatim(self, tmp_path):
        """Without a compile cache dir the relaunch adds nothing to the
        recipe the replica published: no --device, so a replica started on
        the card comes back on the card."""
        self._relaunch(tmp_path, None)

    def test_relaunch_carries_the_compile_cache_dir(self, tmp_path):
        """With one, the recipe gains exactly ``--compile-cache-dir DIR``
        (``fleet/manager.py::_relaunch_argv``, the JAX package's rule)."""
        self._relaunch(tmp_path, "/shared/nm03-cache")

    def _relaunch(self, tmp_path, cache_dir):
        from nm03_capstone_project_tpu_torch.fleet.manager import rolling_restart

        script = tmp_path / "dummy.py"
        script.write_text(_DUMMY)
        (port,) = _free_ports(1)
        procs = [subprocess.Popen([sys.executable, str(script), str(port), "1"])]
        launched = []

        def spawn(argv, **kw):
            launched.append(list(argv))
            kw.pop("stdout", None)
            kw.pop("stderr", None)
            kw.pop("start_new_session", None)
            procs.append(subprocess.Popen(argv, **kw))
            return procs[-1]

        try:
            assert _wait_http(f"http://127.0.0.1:{port}/readyz")
            _, st = _readyz(f"http://127.0.0.1:{port}")
            published = st["replica"]["relaunch_argv"]
            rolling_restart([f"127.0.0.1:{port}"], compile_cache_dir=cache_dir,
                            drain_timeout_s=30, warm_timeout_s=30,
                            poll_s=0.05, spawn=spawn, emit=lambda m: None)
            extra = ["--compile-cache-dir", cache_dir] if cache_dir else []
            assert launched == [published + extra]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)

    @pytest.mark.parametrize("case", ["held_then_released", "held_throughout", "exits"])
    def test_a_relaunch_on_a_held_port_retries_or_fails_at_once(self, tmp_path, case):
        """A bound, connected client socket holds the replica's port when
        the relaunch binds (what a connect() that took the freed port as its
        source port does): the relaunched server exits with
        ADDRESS_IN_USE_EXIT, and the walk relaunches until the holder closes
        (or fails with the bind error at the warm deadline). A relaunch that
        exits for another reason fails at once with its exit code. None of
        them waits out warm_timeout_s past its deadline."""
        from nm03_capstone_project_tpu_torch.fleet import manager

        # the dummy lets each client close first and then resets the
        # connection, so that no TIME_WAIT of its own holds the port after it
        # exits, and exits as nm03-serve does on a held port
        script = tmp_path / "dummy.py"
        script.write_text(_DUMMY.replace(
            'srv = HTTPServer(("127.0.0.1", port), H)',
            'import socket, struct\n'
            'def _handle(self):\n'
            '    BaseHTTPRequestHandler.handle(self)\n'
            '    self.connection.settimeout(5)\n'
            '    try:\n'
            '        self.rfile.read()\n'
            '    except OSError:\n'
            '        pass\n'
            '    self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,\n'
            '                               struct.pack("ii", 1, 0))\n'
            'H.handle = _handle\n'
            'def _drain(*a):  # after the request in hand, whose client closes first\n'
            '    import threading\n'
            '    threading.Thread(target=srv.shutdown).start()\n'
            'try:\n'
            '    srv = HTTPServer(("127.0.0.1", port), H)\n'
            'except OSError as e:\n'
            '    print(f"nm03-serve: {e}", file=sys.stderr)\n'
            f'    sys.exit({manager.ADDRESS_IN_USE_EXIT} if e.errno == 98 else 1)').replace(
            "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))",
            "signal.signal(signal.SIGTERM, _drain)").replace(
            "srv.serve_forever()", "srv.serve_forever()\nsrv.server_close()"))
        (port,) = _free_ports(1)
        procs = [subprocess.Popen([sys.executable, str(script), str(port), "1"])]
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(4)
        holder = []

        def spawn(argv, **kw):
            if not holder:  # the first relaunch finds its port held
                s = socket.socket()
                # closed with a reset: no TIME_WAIT of the holder's own after it
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
                s.bind(("127.0.0.1", port))
                s.connect(listener.getsockname())
                holder.append(s)
                if case == "held_then_released":
                    threading.Timer(1.5, s.close).start()
            if case == "exits":
                argv = [sys.executable, "-c", "import sys; sys.exit(3)"]
            kw.pop("stdout", None)
            kw.pop("stderr", None)
            kw.pop("start_new_session", None)
            procs.append(subprocess.Popen(argv, **kw))
            return procs[-1]

        warm = 600.0 if case != "held_throughout" else 4.0
        said = []
        try:
            assert _wait_http(f"http://127.0.0.1:{port}/readyz")
            t0 = time.monotonic()
            if case == "held_then_released":
                report = manager.rolling_restart(
                    [f"127.0.0.1:{port}"], drain_timeout_s=30, warm_timeout_s=warm,
                    poll_s=0.05, spawn=spawn, emit=said.append)
                entry = report["replicas"][0]
                assert report["ok"] and entry["relaunch_attempts"] >= 2
                assert entry["new_id"].startswith("gen2-")
                assert any("EADDRINUSE" in m and f"local :{port}" in m for m in said), said
            else:
                with pytest.raises(manager.RestartError) as err:
                    manager.rolling_restart(
                        [f"127.0.0.1:{port}"], drain_timeout_s=30, warm_timeout_s=warm,
                        poll_s=0.05, spawn=spawn, emit=said.append)
                if case == "exits":
                    assert "exited with code 3" in str(err.value)
                    assert err.value.report["replicas"][0]["relaunch_attempts"] == 1
                else:
                    assert "EADDRINUSE" in str(err.value) and f"local :{port}" in str(err.value)
            assert time.monotonic() - t0 < min(warm, 60.0) + 5
        finally:
            for s in holder:
                s.close()
            listener.close()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)

    def test_restart_refuses_identityless_replica(self, two_fakes):
        """A replica whose /readyz has no relaunch recipe (an embedded
        ServingApp, an old build) stops the walk with a clear error —
        never a blind SIGTERM of a pid it cannot bring back."""
        from nm03_capstone_project_tpu_torch.fleet.manager import (
            RestartError,
            rolling_restart,
        )

        a, _ = two_fakes  # FakeReplica reports id/pid but no relaunch_argv
        with pytest.raises(RestartError, match="relaunch_argv"):
            rolling_restart([a.url], emit=lambda m: None)


def _readyz(url, timeout=5.0):
    req = urllib.request.Request(f"{url}/readyz", method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# -- subprocess acceptance drills (real port servers on the CPU) -------------


def _spawn_replica(port, tmp_path, tag, extra=(), env=None):
    """One real port server on a fixed port, on the CPU; returns (proc,
    url). Its output goes to a log file (a full pipe would stall it) and
    its flight dumps to ``tmp_path``."""
    log = open(tmp_path / f"replica_{tag}.log", "w")
    proc = subprocess.Popen(
        [
            sys.executable, "-m",
            "nm03_capstone_project_tpu_torch.serving.server",
            "--device", "cpu", "--port", str(port),
            "--canvas", str(CANVAS), "--buckets", "1", "--lanes", "1",
            "--max-wait-ms", "10", "--heartbeat-s", "0",
            "--queue-capacity", "64", "--flight-dir", str(tmp_path),
            *extra,
        ],
        stdout=log, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO,
    )
    log.close()
    proc.log_path = tmp_path / f"replica_{tag}.log"
    return proc, f"http://127.0.0.1:{port}"


def _cpu_env():
    # one torch thread a replica: three replicas and the test share the host
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("NM03_FAULT_PLAN", None)
    return env


def _wait_replicas_ready(procs_urls, timeout_s=300):
    deadline = time.monotonic() + timeout_s
    pending = {u for _, u in procs_urls}
    while pending and time.monotonic() < deadline:
        for proc, url in procs_urls:
            if url not in pending:
                continue
            if proc.poll() is not None:
                pytest.fail(f"replica {url} died: {proc.log_path.read_text()}")
            try:
                status, st = _readyz(url, timeout=2.0)
                if status == 200 and st.get("ready"):
                    pending.discard(url)
            except Exception:  # noqa: BLE001
                pass
        time.sleep(0.2)
    assert not pending, f"replicas never ready: {pending}"


def _expected_mask_pixels(img) -> int:
    """The JAX package's mask for one slice (in-process): what every mask
    the port's fleet serves must equal."""
    import jax.numpy as jnp
    import numpy as np

    from nm03_capstone_project_tpu.config import PipelineConfig
    from nm03_capstone_project_tpu.pipeline.slice_pipeline import process_slice

    out = process_slice(
        jnp.asarray(img.astype(np.float32)),
        jnp.asarray([img.shape[0], img.shape[1]], jnp.int32),
        PipelineConfig(canvas=CANVAS),
    )
    return int(np.count_nonzero(np.asarray(out["mask"])))


def _post(url, body, headers, timeout=120.0):
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class _FleetReadyzPoller:
    """Samples the fleet /readyz through a drill: statuses + payloads."""

    def __init__(self, base):
        self.base = base
        self.samples = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.1):
            try:
                status, st = _readyz(self.base, timeout=5.0)
                with self._lock:
                    self.samples.append((status, st))
            except Exception:  # noqa: BLE001 — transient socket noise
                pass

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        with self._lock:
            return list(self.samples)


class TestFleetChaosAcceptanceDrill:
    def test_sigkill_one_replica_mid_run_zero_failed_requests(self, tmp_path):
        """The acceptance bar, end to end with real processes: the port's
        fleet CLI over three port servers on the CPU under a 32-req/8-way
        loadgen --targets run; SIGKILL one replica mid-run — zero failed
        client requests (in-flight riders fail over; every mask equal to
        the JAX package's), fleet /readyz never leaves 200 with the
        ⅔-capacity plateau observed live; restarting the replica
        reinstates it to 3/3 through probation; gated by the labeled fleet
        metrics via check_telemetry and by the merged trace."""
        from nm03_capstone_project_tpu.data.synthetic import phantom_slice
        from nm03_capstone_project_tpu_torch.serving import loadgen

        env = _cpu_env()
        ports = _free_ports(4)
        victim_port = ports[2]
        victim_label = f"127.0.0.1:{victim_port}"
        # the victim's first dispatch hangs (long deadline: no lane
        # quarantine) so requests are parked in-flight on it when the
        # SIGKILL lands — the deterministic "dying replica" window
        hang_plan = json.dumps({"seed": 3, "faults": [{
            "site": "dispatch", "kind": "hang", "count": 1, "hang_s": 120.0,
        }]})
        replicas = []
        replica_logs = []
        for i, port in enumerate(ports[:3]):
            # every replica writes its own event stream: the
            # multi-log merge stitches them — the victim's torn,
            # SIGKILLed log included — into one fleet timeline
            log_path = tmp_path / f"r{i}_events.jsonl"
            replica_logs.append(log_path)
            extra = ["--request-timeout-s", "300",
                     "--log-json", str(log_path)]
            if port == victim_port:
                extra += ["--fault-plan", hang_plan,
                          "--dispatch-timeout-s", "240"]
            replicas.append(_spawn_replica(port, tmp_path, i, extra, env))
        fleet_metrics = tmp_path / "fleet_metrics.json"
        fleet_events = tmp_path / "fleet_events.jsonl"
        fleet_proc = None
        poller = None
        relaunched = None
        try:
            _wait_replicas_ready(replicas)
            targets = ",".join(f"127.0.0.1:{p}" for p in ports[:3])
            fleet_proc = subprocess.Popen(
                [
                    sys.executable, "-m",
                    "nm03_capstone_project_tpu_torch.fleet.cli", "serve",
                    "--replicas", targets,
                    "--port", str(ports[3]),
                    "--health-interval-s", "0.25",
                    "--probe-interval-s", "0.5",
                    "--health-timeout-s", "2.0",
                    "--proxy-timeout-s", "240",
                    "--canary-hw", "32",
                    "--metrics-out", str(fleet_metrics),
                    "--log-json", str(fleet_events),
                    # the declared SLO: zero failed client
                    # requests is the drill's bar, so the budget must
                    # survive intact — gated below on the snapshot
                    "--slo-availability", "99.0",
                    "--slo-p99-ms", "300000",
                    "--slo-fast-window-s", "60",
                    "--slo-slow-window-s", "600",
                ],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=REPO,
            )
            fleet_url = f"http://127.0.0.1:{ports[3]}"
            assert _wait_http(f"{fleet_url}/readyz", 60), "fleet never up"
            status, st = _readyz(fleet_url)
            assert status == 200 and st["replicas"]["ready"] == 3
            # reference mask from ONE replica directly (single-replica
            # truth the fleet-served masks must be bit-identical to)
            img = phantom_slice(CANVAS, CANVAS, seed=1)
            want = _expected_mask_pixels(img)
            body = img.astype("<f4").tobytes()
            hdrs = {
                "Content-Type": "application/octet-stream",
                "X-Nm03-Height": str(CANVAS), "X-Nm03-Width": str(CANVAS),
            }
            s, p = _post(replicas[0][1] + "/v1/segment?output=mask", body, hdrs)
            assert s == 200 and p["mask_pixels"] == want

            poller = _FleetReadyzPoller(fleet_url).start()
            results_json = tmp_path / "loadgen.json"
            lg_rc = []

            def run_loadgen():
                lg_rc.append(loadgen.main([
                    "--targets", fleet_url,
                    "--requests", "32", "--concurrency", "8",
                    "--timeout-s", "240", "--warmup", "0",
                    "--height", str(CANVAS), "--width", str(CANVAS),
                    "--results-json", str(results_json),
                    # the client-side SLO gate: the kill must
                    # not cost availability; failing it fails main()
                    "--expect-slo", "availability=99.0,p99_ms=240000",
                ]))

            lg = threading.Thread(target=run_loadgen, daemon=True)
            lg.start()
            # SIGKILL the victim once riders are parked on its hung lane
            victim_proc = replicas[2][0]
            victim_url = replicas[2][1]
            deadline = time.monotonic() + 60
            parked = False
            while time.monotonic() < deadline and not parked:
                try:
                    with urllib.request.urlopen(
                        f"{victim_url}/metrics.json", timeout=2
                    ) as r:
                        snap = json.loads(r.read())
                    for m in snap.get("metrics", []):
                        if (m["name"] == "serving_inflight"
                                and m.get("value", 0) >= 1):
                            parked = True
                except Exception:  # noqa: BLE001
                    pass
                time.sleep(0.05)
            assert parked, "no rider ever parked on the victim"
            victim_proc.kill()
            victim_proc.wait(timeout=30)
            lg.join(timeout=300)
            assert lg_rc == [0]
            summary = json.loads(results_json.read_text())
            # THE bar: zero failed client requests through the kill
            assert summary["statuses"] == {"ok": 32}, summary["statuses"]
            # the client-side SLO verdict rides the artifact
            assert summary["slo_gate"]["pass"] is True, summary["slo_gate"]
            assert summary["failovers_observed"] >= 1, summary
            assert set(summary["replicas_observed"]) <= {
                f"127.0.0.1:{p}" for p in ports[:3]
            }
            surviving = {f"127.0.0.1:{p}" for p in (ports[0], ports[1])}
            assert surviving <= set(summary["replicas_observed"]), summary
            # the ⅔ plateau, observed live by the loadgen capacity watch
            assert summary["fleet_capacity_min_observed"] is not None
            assert summary["fleet_capacity_min_observed"] <= 2 / 3 + 1e-6
            assert summary["replicas_ejected_max_observed"] >= 1
            # masks through the fleet are bit-identical to single-replica
            wave = [
                _post(fleet_url + "/v1/segment?output=mask", body, hdrs)
                for _ in range(4)
            ]
            assert all(s == 200 and p["mask_pixels"] == want for s, p in wave)
            # restart the victim (no fault plan: the hang was its outage)
            relaunched, _ = _spawn_replica(
                victim_port, tmp_path, "revived",
                ["--request-timeout-s", "300"], env,
            )
            deadline = time.monotonic() + 300
            healed = False
            while time.monotonic() < deadline and not healed:
                status, st = _readyz(fleet_url)
                healed = (
                    status == 200 and st["replicas"]["ready"] == 3
                    and st["capacity"] == 1.0
                )
                time.sleep(0.2)
            assert healed, st
            samples = poller.stop()
            poller = None
            # fleet /readyz NEVER left 200, and the plateau was visible
            assert samples, "no /readyz samples"
            assert {s for s, _ in samples} == {200}
            dips = [
                st for _, st in samples
                if st.get("replicas", {}).get("ejected", 0) >= 1
            ]
            assert dips, "ejection window never observed on fleet /readyz"
            assert any(
                abs(st["capacity"] - 2 / 3) < 1e-3 for st in dips
            ), sorted({st["capacity"] for st in dips})
            # nm03-top --fleet aggregates the healed fleet in one view
            top = subprocess.run(
                [
                    sys.executable, "-m",
                    "nm03_capstone_project_tpu_torch.serving.top",
                    "--fleet", "--url", fleet_url,
                    "--once", "--format", "json",
                ],
                capture_output=True, text=True, timeout=120, env=env,
                cwd=REPO,
            )
            assert top.returncode == 0, top.stderr
            view = json.loads(top.stdout)
            assert view["schema"] == "nm03.fleettop.v1"
            assert view["replicas_ready"] == 3
            assert len(view["replicas"]) == 3
            assert all(r["state"] == "healthy" for r in view["replicas"])
            assert any(r["busy_fraction"] is not None
                       for r in view["replicas"])
            # drain the fleet; its snapshot carries the labeled evidence
            fleet_proc.send_signal(signal.SIGTERM)
            out, _ = fleet_proc.communicate(timeout=120)
            assert fleet_proc.returncode == 0, out
            res = subprocess.run(
                [
                    sys.executable, CHECKER,
                    "--metrics", str(fleet_metrics),
                    "--events", str(fleet_events),
                    "--expect-gauge", "fleet_replicas_ready=3",
                    "--expect-gauge",
                    f"fleet_replica_state{{replica={victim_label}}}=0",
                    "--expect-counter",
                    f"fleet_replica_ejections_total{{replica={victim_label}}}=1",
                    "--expect-counter",
                    f"fleet_replica_reinstated_total{{replica={victim_label}}}=1",
                    "--expect-counter", "fleet_failovers_total=1",
                    "--expect-counter", "fleet_shed_total==0",
                    "--expect-gauge-range", "fleet_routed_capacity=(0..1]",
                    # the SLO plane's verdict on the same run:
                    # zero failed requests = nothing burned, budget intact
                    "--expect-gauge-range", "slo_burn_rate_fast=[0..1)",
                    "--expect-gauge-range", "slo_burn_rate_slow=[0..1)",
                    "--expect-gauge-range",
                    "slo_error_budget_remaining=(0.5..1]",
                    "--expect-counter", "fleet_requests_total{status=ok}=32",
                ],
                capture_output=True, text=True, timeout=60,
            )
            assert res.returncode == 0, res.stderr
            # ONE merged timeline across the whole fleet: the
            # router's log plus every replica's — the SIGKILLed victim's
            # torn stream included — validated by --expect-fleet-trace:
            # every proxy_hop trace id resolves to a replica-side span
            # tree, and the failed-over request's chain is visible
            merged = tmp_path / "fleet.trace.json"
            res = subprocess.run(
                [
                    sys.executable, "-m",
                    "nm03_capstone_project_tpu_torch.obs.trace",
                    str(fleet_events), *[str(p) for p in replica_logs],
                    "-o", str(merged),
                ],
                capture_output=True, text=True, timeout=120, cwd=REPO,
            )
            assert res.returncode == 0, res.stderr + res.stdout
            res = subprocess.run(
                [sys.executable, CHECKER,
                 "--expect-fleet-trace", str(merged)],
                capture_output=True, text=True, timeout=60,
            )
            assert res.returncode == 0, res.stderr
            events = json.loads(merged.read_text())["traceEvents"]
            b_events = [e for e in events if e.get("ph") == "B"]
            # the acceptance chain is in the artifact: a proxy_hop that
            # DIED on the victim, a failover span, and the same trace id
            # answered by a surviving replica's span tree
            died = [
                e for e in b_events
                if e["name"] == "proxy_hop"
                and e["args"].get("replica") == victim_label
                and e["args"].get("outcome") == "io_error"
            ]
            assert died, "no io_error proxy_hop on the killed replica"
            assert any(e["name"] == "failover" for e in b_events)
            failed_over_ids = set(died[0]["args"]["trace_ids"])
            router_pid = died[0]["pid"]
            assert any(
                e["pid"] != router_pid
                and failed_over_ids & set(e["args"].get("trace_ids") or [])
                for e in b_events
            ), "the failed-over trace id never resolved on a replica track"
            # >= 3 processes merged: the router + the two survivors (the
            # victim's stream may carry no completed span trees)
            pids = {e["pid"] for e in b_events}
            assert len(pids) >= 3, pids
        finally:
            if poller is not None:
                poller.stop()
            procs = [p for p, _ in replicas] + (
                [relaunched] if relaunched else []
            ) + ([fleet_proc] if fleet_proc else [])
            for proc in procs:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    try:
                        proc.communicate(timeout=30)
                    except subprocess.TimeoutExpired:
                        pass


class TestRollingRestartAcceptanceDrill:
    @pytest.mark.slow
    def test_rolling_restart_under_load(self, tmp_path):
        """The second acceptance bar: the rolling restart across three port
        servers completes with fleet capacity never below ⅔, every replica
        back under a new pid (its graphs captured anew: the port has no
        executable cache), and a concurrent loadgen run finishing with
        zero errors."""
        from nm03_capstone_project_tpu_torch.fleet.manager import rolling_restart
        from nm03_capstone_project_tpu_torch.serving import loadgen

        env = _cpu_env()
        ports = _free_ports(4)
        replicas = [
            _spawn_replica(port, tmp_path, i, ["--request-timeout-s", "300"], env)
            for i, port in enumerate(ports[:3])
        ]
        fleet_proc = None
        spawned = []
        try:
            _wait_replicas_ready(replicas)
            targets = [f"127.0.0.1:{p}" for p in ports[:3]]
            fleet_proc = subprocess.Popen(
                [
                    sys.executable, "-m",
                    "nm03_capstone_project_tpu_torch.fleet.cli", "serve",
                    "--replicas", ",".join(targets),
                    "--port", str(ports[3]),
                    "--health-interval-s", "0.25",
                    "--probe-interval-s", "0.4",
                    "--proxy-timeout-s", "240",
                ],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=REPO,
            )
            fleet_url = f"http://127.0.0.1:{ports[3]}"
            assert _wait_http(f"{fleet_url}/readyz", 60)

            results_json = tmp_path / "loadgen.json"
            lg_rc = []

            def run_loadgen():
                lg_rc.append(loadgen.main([
                    "--targets", fleet_url,
                    "--requests", "60", "--rate", "3",
                    "--timeout-s", "240", "--warmup", "2",
                    "--height", str(CANVAS), "--width", str(CANVAS),
                    "--results-json", str(results_json),
                ]))

            lg = threading.Thread(target=run_loadgen, daemon=True)
            lg.start()
            time.sleep(0.5)  # a little traffic before the first drain

            def spawn(argv, **kw):
                proc = subprocess.Popen(
                    argv, cwd=kw.get("cwd"), env=env,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                    start_new_session=True,
                )
                spawned.append(proc)
                return proc

            report = rolling_restart(
                targets,
                drain_timeout_s=120, warm_timeout_s=300, poll_s=0.1,
                fleet_url=fleet_url, spawn=spawn, emit=lambda m: None,
            )
            assert report["ok"] is True
            assert len(report["replicas"]) == 3
            for entry in report["replicas"]:
                assert entry["ok"], entry
                assert entry["new_pid"] != entry["old_pid"]
                assert entry["new_id"] != entry["old_id"]
                assert entry["drain_s"] >= 0 and entry["warm_s"] > 0
                assert "--device" in entry["argv"]  # the published recipe, verbatim
            lg.join(timeout=400)
            assert lg_rc == [0]
            summary = json.loads(results_json.read_text())
            # zero errors through three consecutive replica restarts
            bad = {
                k: v for k, v in summary["statuses"].items() if k != "ok"
            }
            assert not bad, summary["statuses"]
            assert summary["requests_ok"] == 60
            # capacity never dropped below the (N-1)/N floor
            assert summary["fleet_capacity_min_observed"] is not None
            assert summary["fleet_capacity_min_observed"] >= 2 / 3 - 1e-6, (
                summary["fleet_capacity_min_observed"]
            )
            status, st = _readyz(fleet_url)
            assert status == 200 and st["replicas"]["ready"] == 3
        finally:
            if fleet_proc is not None and fleet_proc.poll() is None:
                fleet_proc.send_signal(signal.SIGTERM)
                try:
                    fleet_proc.communicate(timeout=60)
                except subprocess.TimeoutExpired:
                    fleet_proc.kill()
            for proc, _ in replicas:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
            for proc in spawned:
                if proc.poll() is None:
                    proc.kill()
                    try:
                        proc.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        pass


# -- parity with the JAX package ---------------------------------------------


class TestParityWithJax:
    """The same samples, transitions and traffic through both packages'
    fleet code give equal results (exact)."""

    @pytest.mark.parametrize("with_slo", [True, False])
    def test_build_fleet_view_and_render_equal(self, with_slo):
        from nm03_capstone_project_tpu.serving import top as jax_top
        from nm03_capstone_project_tpu_torch.serving import top

        canned = TestFleetTopRender()

        def views(mod):
            cur = canned._fleet_sample(ts=110.0, routed=60.0, with_slo=with_slo, top=mod)
            prev = canned._fleet_sample(ts=100.0, routed=40.0, with_slo=with_slo, top=mod)
            per = {"http://127.0.0.1:8081": canned._replica_sample(110.0, 30, top=mod),
                   "http://127.0.0.1:8082": None}
            prev_per = {"http://127.0.0.1:8081": canned._replica_sample(100.0, 10, top=mod)}
            view = mod.build_fleet_view(cur, per, prev, prev_per)
            return view, mod.render_fleet_text(view, "http://fleet:8070")

        assert views(top) == views(jax_top)

    def test_build_view_and_render_text_equal(self):
        from nm03_capstone_project_tpu.serving import top as jax_top
        from nm03_capstone_project_tpu_torch.serving import top

        metrics = {"metrics": [
            {"name": "serving_lane_busy_fraction", "type": "gauge",
             "labels": {"lane": "0"}, "value": 0.31},
            {"name": "serving_busy_fraction", "type": "gauge", "labels": {}, "value": 0.31},
            {"name": "serving_padding_waste_ratio", "type": "gauge", "labels": {},
             "value": 0.2},
            {"name": "serving_result_cache_bytes", "type": "gauge", "labels": {},
             "value": 4096},
            {"name": "serving_result_cache_hit_total", "type": "counter",
             "labels": {"tier": "replica"}, "value": 3},
            {"name": "serving_result_cache_miss_total", "type": "counter",
             "labels": {"tier": "replica"}, "value": 1},
            {"name": "serving_device_time_share", "type": "gauge",
             "labels": {"stage": "grow"}, "value": 0.6},
            {"name": "serving_requests_total", "type": "counter",
             "labels": {"status": "ok"}, "value": 12},
        ]}
        readyz = {"ready": True, "capacity": 1.0, "queue_depth": 0, "queue_capacity": 64,
                  "uptime_s": 3.0, "lanes": {"per_lane": [
                      {"lane": 0, "state": "healthy", "inflight": 0, "batches": 5,
                       "quarantines": 0}]}}

        def render(mod):
            view = mod.build_view(mod.Sample(metrics, readyz, 1.0))
            return view, mod.render_text(view, "http://r:1")

        assert render(top) == render(jax_top)

    def test_state_machine_and_pick_sequence_equal(self):
        from nm03_capstone_project_tpu.fleet.replicas import ReplicaStates as JaxStates
        from nm03_capstone_project_tpu.fleet.router import FleetApp as JaxFleetApp

        targets = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]

        def drive(states_cls, app_cls):
            st = states_cls(targets)
            st.update_signals("http://127.0.0.1:2", capacity=0.5, queue_depth=8,
                              queue_capacity=16)
            trail = [st.eject("http://127.0.0.1:1", "refused"),
                     st.eject("http://127.0.0.1:1", "timeout"),
                     st.begin_probation("http://127.0.0.1:1"),
                     st.fail_probation("http://127.0.0.1:1"),
                     st.begin_probation("http://127.0.0.1:1"),
                     st.reinstate("http://127.0.0.1:1"),
                     st.capacity_fraction()]
            app = app_cls(targets, health_interval_s=3600)
            app.replicas.update_signals("http://127.0.0.1:3", capacity=0.25)
            picks = [app.pick() for _ in range(12)]
            picks.append(app.pick(cost=4.0))
            picks += [app.pick(exclude=frozenset({"http://127.0.0.1:1"})) for _ in range(4)]
            return trail, st.snapshot(), picks, app.status()["replicas"]

        mine, theirs = drive(ReplicaStates, FleetApp), drive(JaxStates, JaxFleetApp)
        assert mine == theirs

    def test_proxied_traffic_equal_over_the_same_fakes(self, two_fakes):
        from nm03_capstone_project_tpu.fleet.router import FleetApp as JaxFleetApp

        a, b = two_fakes
        body, headers = _segment_body()

        def run(app_cls):
            app = app_cls([a.url, b.url], health_interval_s=3600)
            app._sweep()
            out = []
            for i in range(4):
                status, data, hdrs = app.proxy_segment(body, headers, trace_id=f"t-{i}")
                payload = json.loads(data)
                out.append((status, payload["replica"], payload["replica_hops"],
                            payload["mask_pixels"],
                            sorted(k for k, _ in hdrs if k.startswith("X-Nm03"))))
            a.drop = True
            status, data, _ = app.proxy_segment(body, headers, trace_id="t-drop")
            a.drop = False
            out.append((status, json.loads(data)["replica_hops"], app.replicas.state(a.url)))
            return out

        assert run(FleetApp) == run(JaxFleetApp)

